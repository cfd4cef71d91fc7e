"""GraphQL endpoint (the reference package's `gql.py`; reference:
core/src/gql/ + server gql/ — a schema GENERATED from the table/field
catalog; queries compile onto SELECTs, mutations onto
CREATE/UPDATE/DELETE).

Surface:
- `query { table(limit, start, order, desc, id, filter) { ... } }` where
  `filter` supports {field: value} shorthand and operator objects
  {field: {eq|ne|gt|gte|lt|lte|contains: v}}
- record links resolve through nested selection sets
- `mutation { create_table(data) / update_table(id, data) /
  delete_table(id) }`
- full __schema/__type introspection built from the catalog: one OBJECT
  type per table with fields typed from the DEFINE FIELD kinds
  (reference core/src/gql/schema.rs kind->GraphQL type mapping)
"""

from __future__ import annotations

import re as _re

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, RecordId, to_json

_TOKEN_RX = _re.compile(
    r"""\s*(?:(?P<punct>[{}():,\[\]!=])|(?P<name>[_A-Za-z][_0-9A-Za-z]*)"""
    r"""|(?P<string>"(?:[^"\\]|\\.)*")|(?P<num>-?\d+(?:\.\d+)?)"""
    r"""|(?P<var>\$[_A-Za-z][_0-9A-Za-z]*))""",
)


_COMMENT_RX = _re.compile(r"\s*#[^\n]*")


def _tokenize(src: str):
    pos = 0
    out = []
    while pos < len(src):
        # comments strip at token boundaries — never inside strings
        cm = _COMMENT_RX.match(src, pos)
        if cm:
            pos = cm.end()
            continue
        m = _TOKEN_RX.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            raise SdbError(f"GraphQL parse error at {pos}")
        pos = m.end()
        if m.group("punct"):
            out.append(("punct", m.group("punct")))
        elif m.group("name"):
            out.append(("name", m.group("name")))
        elif m.group("string"):
            out.append(("string", m.group("string")[1:-1]))
        elif m.group("num"):
            n = m.group("num")
            out.append(("num", float(n) if "." in n else int(n)))
        elif m.group("var"):
            out.append(("var", m.group("var")[1:]))
    return out


class _P:
    def __init__(self, toks, variables):
        self.toks = toks
        self.i = 0
        self.variables = variables

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def eat(self, kind, val=None):
        t = self.peek()
        if t[0] == kind and (val is None or t[1] == val):
            self.i += 1
            return t
        return None

    def parse_value(self):
        t = self.next()
        if t[0] == "var":
            return self.variables.get(t[1])
        if t[0] in ("string", "num"):
            return t[1]
        if t[0] == "name":
            if t[1] == "true":
                return True
            if t[1] == "false":
                return False
            if t[1] == "null":
                return None
            return t[1]
        if t == ("punct", "["):
            out = []
            while not self.eat("punct", "]"):
                out.append(self.parse_value())
                self.eat("punct", ",")
            return out
        if t == ("punct", "{"):
            obj = {}
            while not self.eat("punct", "}"):
                k = self.next()[1]
                self.eat("punct", ":")
                obj[k] = self.parse_value()
                self.eat("punct", ",")
            return obj
        raise SdbError("GraphQL parse error in value")

    def parse_selection_set(self):
        if not self.eat("punct", "{"):
            raise SdbError("GraphQL: expected selection set")
        fields = []
        while not self.eat("punct", "}"):
            name = self.next()
            if name[0] != "name":
                raise SdbError("GraphQL: expected field name")
            alias = None
            if self.eat("punct", ":"):
                alias = name[1]
                name = self.next()
            args = {}
            if self.eat("punct", "("):
                while not self.eat("punct", ")"):
                    an = self.next()[1]
                    self.eat("punct", ":")
                    args[an] = self.parse_value()
                    self.eat("punct", ",")
            sub = None
            if self.peek() == ("punct", "{"):
                sub = self.parse_selection_set()
            fields.append((alias or name[1], name[1], args, sub))
        return fields


def execute_graphql(ds, session, query: str, variables=None) -> dict:
    variables = variables or {}
    toks = _tokenize(query)
    p = _P(toks, variables)
    op = "query"
    if p.peek() in (("name", "query"), ("name", "mutation")):
        op = p.next()[1]
        if p.peek()[0] == "name":
            p.next()
        if p.eat("punct", "("):
            depth = 1
            while depth:
                t = p.next()
                if t == ("punct", "("):
                    depth += 1
                elif t == ("punct", ")"):
                    depth -= 1
    sels = p.parse_selection_set()
    # DEFINE CONFIG GRAPHQL DEPTH/COMPLEXITY limits (reference core/src/gql
    # schema guards): depth counts selection nesting, complexity counts
    # every field selection
    cfg = _gql_config(ds, session)
    limits_err = _check_limits(sels, cfg)
    if limits_err is not None:
        return {"data": None, "errors": [{"message": limits_err}]}
    data = {}
    errors = []
    for out_name, name, args, sub in sels:
        fname = _function_field(cfg, name, ds, session)
        if fname is not None:
            try:
                data[out_name] = _resolve_function(
                    ds, session, fname, args
                )
            except SdbError as e:
                errors.append({"message": str(e)})
                data[out_name] = None
            continue
        if name == "__schema":
            data[out_name] = _schema_introspection(ds, session, sub)
            continue
        if name == "__type":
            data[out_name] = _type_introspection(
                ds, session, args.get("name", ""), sub
            )
            continue
        if name == "__typename":
            data[out_name] = "Mutation" if op == "mutation" else "Query"
            continue
        try:
            if op == "mutation":
                data[out_name] = _resolve_mutation(
                    ds, session, name, args, sub
                )
            else:
                data[out_name] = _resolve_table(ds, session, name, args, sub)
        except SdbError as e:
            errors.append({"message": str(e)})
            data[out_name] = None
    out = {"data": data}
    if errors:
        out["errors"] = errors
    return out


_IDENT_RE = _re.compile(r"^[_A-Za-z][_0-9A-Za-z]*$")


def _require_ident(name) -> None:
    if not isinstance(name, str) or not _IDENT_RE.match(name):
        raise SdbError(f"Invalid field name '{name}'")


_FILTER_OPS = {
    "eq": "=", "ne": "!=", "gt": ">", "gte": ">=", "lt": "<", "lte": "<=",
    "contains": "CONTAINS",
}


def _gql_config(ds, session):
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import ConfigDef

    if not (session.ns and session.db):
        return None
    txn = ds.transaction(write=False)
    try:
        d = txn.get_val(K.cfg_def(session.ns, session.db, "GRAPHQL"))
    finally:
        txn.cancel()
    return d if isinstance(d, ConfigDef) else None


def _measure(sels, depth=1):
    """(max_depth, field_count) of a parsed selection tree."""
    count = 0
    deepest = depth
    for _o, _n, _a, sub in sels:
        count += 1
        if sub:
            d2, c2 = _measure(sub, depth + 1)
            deepest = max(deepest, d2)
            count += c2
    return deepest, count


def _check_limits(sels, cfg):
    if cfg is None:
        return None
    depth, count = _measure(sels)
    if cfg.depth is not None and depth > int(cfg.depth):
        return (
            f"Query is nested too deep: depth {depth} exceeds the "
            f"configured maximum of {int(cfg.depth)}"
        )
    if cfg.complexity is not None and count > int(cfg.complexity):
        return (
            f"Query is too complex: {count} fields exceed the configured "
            f"maximum of {int(cfg.complexity)}"
        )
    return None


def _function_field(cfg, name: str, ds, session):
    """GraphQL field -> fn:: function name when the GRAPHQL config
    exposes functions (AUTO or INCLUDE list; `::` maps to `_`). Fields
    that don't name an EXISTING function fall through to the table
    resolver — a table called my_table must not shadow-miss."""
    if cfg is None:
        return None
    mode = cfg.functions
    if mode in (None, "NONE"):
        return None

    def _exists(fn):
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch.catalog import FunctionDef

        txn = ds.transaction(write=False)
        try:
            return isinstance(
                txn.get_val(K.fc_def(session.ns, session.db, fn)),
                FunctionDef,
            )
        finally:
            txn.cancel()

    candidates = [name]
    if "_" in name:
        candidates.append(name.replace("_", "::"))
    for fname in candidates:
        if mode == "AUTO":
            if _exists(fname):
                return fname
            continue
        if isinstance(mode, tuple):
            kind, names = mode
            listed = fname in names
            if (kind == "INCLUDE") == listed and _exists(fname):
                return fname
    return None


def _resolve_function(ds, session, fname: str, args: dict):
    """Run fn::name with named GraphQL args bound positionally (catalog
    argument order)."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import FunctionDef
    from surrealdb_tpu_torch.exec.context import Ctx
    from surrealdb_tpu_torch.fnc import call_custom

    txn = ds.transaction(write=True)
    try:
        fd = txn.get_val(K.fc_def(session.ns, session.db, fname))
        if not isinstance(fd, FunctionDef):
            raise SdbError(f"Unknown query field '{fname}'")
        ordered = [args.get(pname, None) for pname, _k in fd.args]
        while ordered and ordered[-1] is None:
            ordered.pop()
        ctx = Ctx(ds, session, txn)
        # GraphQL function calls honour the edge deadline/cancel budget
        # like any other query path (inflight.py)
        from surrealdb_tpu_torch.inflight import current as _q_current

        h = _q_current()
        if h is not None:
            ctx.deadline = h.deadline
            ctx.cancel = h.cancel
            ctx.inflight = h
        out = call_custom(fname, ordered, ctx)
        txn.commit()
    except BaseException:
        txn.cancel()
        raise
    return to_json(out)


def _gql_rid(tb: str, idv) -> str:
    sid = str(idv)
    return sid if sid.startswith(f"{tb}:") else f"{tb}:{sid}"


def _build_where(filters: dict, vars: dict) -> list:
    conds = []
    for k, v in dict(filters or {}).items():
        _require_ident(k)
        if isinstance(v, dict) and v and all(op in _FILTER_OPS for op in v):
            for opname, operand in v.items():
                slot = f"f{len(vars)}"
                vars[slot] = operand
                conds.append(f"{k} {_FILTER_OPS[opname]} ${slot}")
        else:
            slot = f"f{len(vars)}"
            vars[slot] = v
            conds.append(f"{k} = ${slot}")
    return conds


def _resolve_table(ds, session, tb, args, sub):
    limit = int(args.get("limit", 100))
    start = int(args.get("start", 0))
    order = args.get("order")
    idv = args.get("id")
    vars = {}
    if idv is not None:
        vars["_rid"] = _gql_rid(tb, idv)
        sql = "SELECT * FROM (type::record($_rid))"
    else:
        sql = f"SELECT * FROM {tb}"
        conds = _build_where(args.get("filter"), vars)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        if order:
            # interpolated into the statement — restrict to a bare field
            # identifier or SurrealQL injection rides in via this arg
            _require_ident(order)
            sql += f" ORDER BY {order}"
            if args.get("desc"):
                sql += " DESC"
        sql += f" LIMIT {limit} START {start}"
    res = ds.execute(sql, session=session, vars=vars)
    last = res[-1]
    if last.error:
        raise SdbError(last.error)
    rows = last.result if isinstance(last.result, list) else [last.result]
    out = []
    for row in rows:
        if not isinstance(row, dict):
            continue
        out.append(_project(ds, session, row, sub))
    return out


def _resolve_mutation(ds, session, name, args, sub):
    """create_<tb>(data) / update_<tb>(id, data) / delete_<tb>(id)
    (reference core/src/gql mutations generated per table)."""
    for prefix, stmt in (("create_", "CREATE"), ("update_", "UPDATE"),
                         ("delete_", "DELETE")):
        if name.startswith(prefix):
            tb = name[len(prefix):]
            break
    else:
        raise SdbError(f"Unknown mutation '{name}'")
    vars = {}
    idv = args.get("id")
    target = tb
    if idv is not None:
        # ids bind as variables — raw interpolation would let a GraphQL
        # client smuggle extra SurrealQL statements; type::record parses
        # the ONE bound id (an injected statement fails to parse)
        vars["_rid"] = _gql_rid(tb, idv)
        target = "(type::record($_rid))"
    if stmt == "CREATE":
        sql = f"CREATE {target} CONTENT $data"
        vars["data"] = args.get("data") or {}
    elif stmt == "UPDATE":
        if idv is None:
            raise SdbError("update mutation requires an id argument")
        sql = f"UPDATE {target} MERGE $data"
        vars["data"] = args.get("data") or {}
    else:
        if idv is None:
            raise SdbError("delete mutation requires an id argument")
        sql = f"DELETE {target} RETURN BEFORE"
    res = ds.execute(sql, session=session, vars=vars)
    last = res[-1]
    if last.error:
        raise SdbError(last.error)
    rows = last.result if isinstance(last.result, list) else [last.result]
    out = [
        _project(ds, session, r, sub) for r in rows if isinstance(r, dict)
    ]
    return out


def _project(ds, session, row: dict, sub):
    if not sub:
        return to_json(row)
    out = {}
    for out_name, name, _args, nested in sub:
        if name == "__typename":
            out[out_name] = "Object"
            continue
        v = row.get(name, NONE)
        if nested and isinstance(v, RecordId):
            # record links resolve through nested selections
            res = ds.execute("SELECT * FROM ONLY $r", session=session,
                             vars={"r": v})
            doc = res[-1].result if res[-1].error is None else None
            v = _project(ds, session, doc, nested) \
                if isinstance(doc, dict) else to_json(v)
        elif nested and isinstance(v, dict):
            v = _project(ds, session, v, nested)
        elif nested and isinstance(v, list):
            v = [
                _project(ds, session, x, nested) if isinstance(x, dict)
                else to_json(x)
                for x in v
            ]
        else:
            v = to_json(v)
        out[out_name] = v
    return out


# ---------------------------------------------------------------------------
# introspection — schema generated from the catalog
# ---------------------------------------------------------------------------

_SCALARS = ("String", "Int", "Float", "Boolean", "ID")


def _kind_to_gql(kind) -> dict:
    """DEFINE FIELD kind -> GraphQL type ref (reference gql/schema.rs)."""
    if kind is None:
        return {"kind": "SCALAR", "name": "String", "ofType": None}
    n = kind.name
    if n in ("int",):
        return {"kind": "SCALAR", "name": "Int", "ofType": None}
    if n in ("float", "number", "decimal"):
        return {"kind": "SCALAR", "name": "Float", "ofType": None}
    if n == "bool":
        return {"kind": "SCALAR", "name": "Boolean", "ofType": None}
    if n == "record" and kind.inner:
        return {"kind": "OBJECT", "name": kind.inner[0], "ofType": None}
    if n in ("array", "set"):
        inner = _kind_to_gql(kind.inner[0]) if kind.inner else \
            {"kind": "SCALAR", "name": "String", "ofType": None}
        return {"kind": "LIST", "name": None, "ofType": inner}
    if n == "option" and kind.inner:
        return _kind_to_gql(kind.inner[0])
    return {"kind": "SCALAR", "name": "String", "ofType": None}


def _table_types(ds, session):
    """[(table, [(field, typeref)])] from the catalog."""
    from surrealdb_tpu_torch import key as K

    out = []
    if not (session.ns and session.db):
        return out
    txn = ds.transaction(write=False)
    try:
        for _k, tdef in txn.scan_vals(
            *K.prefix_range(K.tb_prefix(session.ns, session.db))
        ):
            fields = [("id", {"kind": "SCALAR", "name": "ID",
                              "ofType": None})]
            for _k2, fd in txn.scan_vals(*K.prefix_range(
                K.fd_prefix(session.ns, session.db, tdef.name)
            )):
                if "." in fd.name_str or "[" in fd.name_str:
                    continue  # nested paths flatten into the parent value
                fields.append((fd.name_str, _kind_to_gql(fd.kind)))
            out.append((tdef.name, fields))
    finally:
        txn.cancel()
    return out


def _schema_introspection(ds, session, sub=None):
    tables = _table_types(ds, session)
    types = [
        {"kind": "SCALAR", "name": s, "fields": None} for s in _SCALARS
    ]
    for tb, fields in tables:
        types.append({
            "kind": "OBJECT",
            "name": tb,
            "fields": [
                {"name": fn, "type": ft, "args": []} for fn, ft in fields
            ],
        })
    # the root Query type: one field per table
    types.append({
        "kind": "OBJECT",
        "name": "Query",
        "fields": [
            {
                "name": tb,
                "type": {"kind": "LIST", "name": None,
                         "ofType": {"kind": "OBJECT", "name": tb,
                                    "ofType": None}},
                "args": [
                    {"name": a, "type": {"kind": "SCALAR", "name": t,
                                         "ofType": None}}
                    for a, t in (("limit", "Int"), ("start", "Int"),
                                 ("order", "String"), ("desc", "Boolean"),
                                 ("id", "ID"), ("filter", "String"))
                ],
            }
            for tb, _f in tables
        ],
    })
    types.append({
        "kind": "OBJECT",
        "name": "Mutation",
        "fields": [
            {"name": f"{op}_{tb}",
             "type": {"kind": "LIST", "name": None,
                      "ofType": {"kind": "OBJECT", "name": tb,
                                 "ofType": None}},
             "args": []}
            for tb, _f in tables
            for op in ("create", "update", "delete")
        ],
    })
    return {
        "queryType": {"name": "Query"},
        "mutationType": {"name": "Mutation"},
        "types": types,
    }


def _type_introspection(ds, session, name, sub=None):
    for t in _schema_introspection(ds, session)["types"]:
        if t.get("name") == name:
            return t
    return None
