"""type:: conversion & predicate functions, object:: and record:: families."""

from __future__ import annotations

from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.expr.ast import Kind
from surrealdb_tpu_torch.fnc import _arr, _str, register
from surrealdb_tpu_torch.val import (
    NONE,
    SSet,
    Datetime,
    Duration,
    File,
    Geometry,
    Range,
    RecordId,
    Regex,
    Table,
    Uuid,
)


def _cast_to(name):
    from surrealdb_tpu_torch.exec.coerce import cast

    def fn(args, ctx):
        return cast(args[0], Kind(name))

    return fn


for _n in ("bool", "bytes", "datetime", "decimal", "duration", "float", "int",
           "number", "string", "uuid", "regex", "array", "geometry"):
    register(f"type::{_n}")(_cast_to(_n))


@register("type::set")
def _type_set(args, ctx):
    from surrealdb_tpu_torch.exec.coerce import cast

    try:
        return cast(args[0], Kind("set"))
    except SdbError:
        # the FUNCTION's failure names `set` (functions/type/set.surql),
        # unlike the <set> cast which converts through `array`
        from surrealdb_tpu_torch.val import render

        raise SdbError(
            f"Could not cast into `set` using input `{render(args[0])}`"
        )


@register("type::string_lossy")
def _string_lossy(args, ctx):
    from surrealdb_tpu_torch.exec.coerce import cast

    return cast(args[0], Kind("string"))


@register("type::point")
def _point(args, ctx):
    if len(args) == 2:
        return Geometry("Point", (float(args[0]), float(args[1])))
    v = args[0]
    if isinstance(v, Geometry) and v.kind == "Point":
        return v
    if isinstance(v, list) and len(v) == 2:
        return Geometry("Point", (float(v[0]), float(v[1])))
    raise SdbError("Incorrect arguments for function type::point()")


@register("type::table")
def _table(args, ctx):
    v = args[0]
    if isinstance(v, Table):
        return v
    if isinstance(v, RecordId):
        return Table(v.tb)
    from surrealdb_tpu_torch.exec.operators import to_string

    return Table(to_string(v))


def _thing(args, ctx):
    """2.x type::thing — kept callable for internal use; the parser
    rejects the path with a `type::record` hint (path_hints suite)."""
    tb = args[0]
    tbname = tb.name if isinstance(tb, Table) else tb
    if isinstance(tb, RecordId) and len(args) == 1:
        return tb
    if len(args) == 1:
        if isinstance(tb, str):
            from surrealdb_tpu_torch.exec.static_eval import static_value
            from surrealdb_tpu_torch.syn.parser import parse_record_literal

            return static_value(parse_record_literal(tb))
        raise SdbError("Incorrect arguments for function type::thing()")
    idv = args[1]
    if isinstance(idv, RecordId):
        idv = idv.id
    if isinstance(idv, float) and idv.is_integer():
        idv = int(idv)
    return RecordId(str(tbname), idv)


@register("type::record")
def _record(args, ctx):
    """type::record(value) parses; type::record(tb, key) builds
    (reference fnc/type.rs:139)."""
    v = args[0]
    if len(args) > 1:
        tb = v.name if isinstance(v, Table) else v
        if not isinstance(tb, str) or not tb:
            raise SdbError("Incorrect arguments for function type::record()")
        key = args[1]
        if isinstance(key, RecordId):
            key = key.id
        elif isinstance(key, float):
            key = str(key) if not key.is_integer() else int(key)
        from surrealdb_tpu_torch.exec.document import record_id_key

        return RecordId(tb, record_id_key(key))
    if isinstance(v, RecordId):
        return v
    if isinstance(v, str):
        from surrealdb_tpu_torch.exec.static_eval import static_value
        from surrealdb_tpu_torch.syn.parser import parse_record_literal

        return static_value(parse_record_literal(v))
    raise SdbError("Incorrect arguments for function type::record()")


@register("type::range")
def _range(args, ctx):
    v = args[0]
    if isinstance(v, Range):
        return v
    if isinstance(v, list):
        if len(v) == 2:
            return Range(v[0], v[1], True, False)
    raise SdbError("Incorrect arguments for function type::range()")


@register("type::field")
def _field(args, ctx):
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.syn.parser import Parser

    path = _str(args[0], "type::field", 1)
    node = Parser(path).parse_expr()
    return evaluate(node, ctx)


@register("type::fields")
def _fields(args, ctx):
    return [_field([p], ctx) for p in _arr(args[0], "type::fields", 1)]


@register("type::file")
def _file(args, ctx):
    return File(_str(args[0], "f", 1), _str(args[1], "f", 2) if len(args) > 1 else "")


# -- predicates ---------------------------------------------------------------

_PRED = {
    "array": lambda v: isinstance(v, list),
    "bool": lambda v: isinstance(v, bool),
    "bytes": lambda v: isinstance(v, (bytes, bytearray)),
    "collection": lambda v: isinstance(v, Geometry) and v.kind == "GeometryCollection",
    "datetime": lambda v: isinstance(v, Datetime),
    "decimal": lambda v: isinstance(v, Decimal),
    "duration": lambda v: isinstance(v, Duration),
    "float": lambda v: isinstance(v, float),
    "geometry": lambda v: isinstance(v, Geometry),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "line": lambda v: isinstance(v, Geometry) and v.kind == "LineString",
    "none": lambda v: v is NONE,
    "null": lambda v: v is None,
    "multiline": lambda v: isinstance(v, Geometry) and v.kind == "MultiLineString",
    "multipoint": lambda v: isinstance(v, Geometry) and v.kind == "MultiPoint",
    "multipolygon": lambda v: isinstance(v, Geometry) and v.kind == "MultiPolygon",
    "number": lambda v: isinstance(v, (int, float, Decimal)) and not isinstance(v, bool),
    "object": lambda v: isinstance(v, dict),
    "point": lambda v: isinstance(v, Geometry) and v.kind == "Point",
    "polygon": lambda v: isinstance(v, Geometry) and v.kind == "Polygon",
    "string": lambda v: isinstance(v, str),
    "uuid": lambda v: isinstance(v, Uuid),
    "range": lambda v: isinstance(v, Range),
    "set": lambda v: isinstance(v, SSet),
}

for _name, _fn in _PRED.items():
    def _mk(fn):
        def g(args, ctx):
            return fn(args[0])

        return g

    register(f"type::is::{_name}")(_mk(_fn))


@register("type::is::record")
def _is_record(args, ctx):
    v = args[0]
    if not isinstance(v, RecordId):
        return False
    if len(args) > 1:
        want = args[1]
        tbname = want.name if isinstance(want, Table) else want
        return v.tb == tbname
    return True


@register("type::of")
def _type_of(args, ctx):
    from surrealdb_tpu_torch.exec.coerce import _type_name

    return _type_name(args[0])


# -- object:: -----------------------------------------------------------------


def _obj(v, fname, idx=1):
    if not isinstance(v, dict):
        from surrealdb_tpu_torch.val import render

        raise SdbError(
            f"Incorrect arguments for function {fname}(). Argument {idx} "
            f"was the wrong type. Expected `object` but found `{render(v)}`"
        )
    return v


@register("object::entries")
def _entries(args, ctx):
    return [[k, v] for k, v in _obj(args[0], "object::entries").items()]


@register("object::from_entries")
def _from_entries(args, ctx):
    out = {}
    for it in _arr(args[0], "object::from_entries", 1):
        if isinstance(it, list) and len(it) == 2:
            out[str(it[0])] = it[1]
    return out


@register("object::keys")
def _keys(args, ctx):
    return list(_obj(args[0], "object::keys").keys())


@register("object::values")
def _values(args, ctx):
    return list(_obj(args[0], "object::values").values())


@register("object::len")
def _olen(args, ctx):
    return len(_obj(args[0], "object::len"))


@register("object::is_empty")
def _oempty(args, ctx):
    return len(_obj(args[0], "object::is_empty")) == 0


@register("object::extend")
def _oextend(args, ctx):
    out = dict(_obj(args[0], "object::extend"))
    out.update(_obj(args[1], "object::extend"))
    return out


@register("object::remove")
def _oremove(args, ctx):
    from surrealdb_tpu_torch.val import render

    out = dict(_obj(args[0], "object::remove"))
    keys = args[1] if isinstance(args[1], list) else [args[1]]
    for k in keys:
        if not isinstance(k, str):
            raise SdbError(
                f"Incorrect arguments for function object::remove(). "
                f"{render(k)!r} cannot be used as a key. "
                f"Please use a string instead.".replace('"', "'")
            )
        out.pop(k, None)
    return out


# -- record:: -----------------------------------------------------------------


@register("record::is_edge")
def _ris_edge(args, ctx):
    from surrealdb_tpu_torch.exec.eval import fetch_record
    from surrealdb_tpu_torch.val import NONE as _N

    v = args[0]
    if isinstance(v, str):
        # string record ids coerce (reference fnc/record.rs is_edge takes
        # a Thing conversion)
        from surrealdb_tpu_torch.exec.eval import evaluate
        from surrealdb_tpu_torch.syn.parser import parse_record_literal

        try:
            v = evaluate(parse_record_literal(v), ctx)
        except (SdbError, ValueError):
            v = None
    if not isinstance(v, RecordId):
        raise SdbError(
            "Incorrect arguments for function record::is_edge(). "
            "Expected a record ID"
        )
    doc = fetch_record(ctx, v)
    return (
        isinstance(doc, dict)
        and isinstance(doc.get("in"), RecordId)
        and isinstance(doc.get("out"), RecordId)
    )


@register("schema::table::exists")
def _schema_tb_exists(args, ctx):
    from surrealdb_tpu_torch import key as K2

    tb = args[0]
    if not isinstance(tb, str):
        raise SdbError(
            "Incorrect arguments for function schema::table::exists(). "
            "Expected a string"
        )
    ns, db = ctx.need_ns_db()
    return ctx.txn.get(K2.tb_def(ns, db, tb)) is not None


@register("record::exists")
def _rexists(args, ctx):
    from surrealdb_tpu_torch.exec.eval import fetch_record

    v = args[0]
    if not isinstance(v, RecordId):
        raise SdbError("Incorrect arguments for function record::exists(). Expected a record")
    return fetch_record(ctx, v) is not NONE


@register("record::id")
def _rid(args, ctx):
    v = args[0]
    if not isinstance(v, RecordId):
        raise SdbError("Incorrect arguments for function record::id(). Expected a record")
    return v.id


@register("record::tb")
def _rtb(args, ctx):
    v = args[0]
    if not isinstance(v, RecordId):
        raise SdbError("Incorrect arguments for function record::tb(). Expected a record")
    return v.tb


from surrealdb_tpu_torch.fnc import FUNCS as _F  # noqa: E402

_F["record::table"] = _F["record::tb"]
_F["meta::id"] = _F["record::id"]
_F["meta::tb"] = _F["record::tb"]


@register("record::refs")
def _refs(args, ctx):
    """Records referencing this one (reverse record-link lookup)."""
    v = args[0]
    if not isinstance(v, RecordId):
        raise SdbError("Incorrect arguments for function record::refs(). Expected a record")
    from surrealdb_tpu_torch.graph import find_references

    tb = args[1] if len(args) > 1 else None
    ff = args[2] if len(args) > 2 else None
    return find_references(v, ctx, tb, ff)
