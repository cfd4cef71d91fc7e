"""Kind coercion & casting (reference: expr/kind.rs + val coercion).

`coerce` implements TYPE-clause semantics (DEFINE FIELD TYPE / LET $x: kind);
`cast` implements `<kind> value` expressions (more lenient conversions).
"""

from __future__ import annotations

import math
from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.expr.ast import Kind
from surrealdb_tpu_torch.val import (
    NONE,
    Datetime,
    Duration,
    File,
    Geometry,
    Range,
    RecordId,
    Regex,
    Table,
    Uuid,
    render,
    value_eq,
)


def kind_name(kind: Kind) -> str:
    if kind.name == "either":
        return " | ".join(kind_name(k) for k in kind.inner)
    if kind.name == "option":
        # option<X> renders as `none | X` (reference kind display)
        if kind.inner:
            return f"none | {kind_name(kind.inner[0])}"
        return "none"
    if kind.name == "record" and kind.inner:
        return f"record<{' | '.join(kind.inner)}>"
    if kind.name in ("table", "geometry") and kind.inner:
        return f"{kind.name}<{'|'.join(str(x) for x in kind.inner)}>"
    if kind.name == "object_literal":
        inner = ", ".join(
            f"{k}: {kind_name(kk)}"
            for k, kk in sorted(kind.inner, key=lambda p: p[0])
        )
        return "{ " + inner + " }"
    if kind.name == "array_literal":
        return "[" + ", ".join(kind_name(k) for k in kind.inner) + "]"
    if kind.name == "literal":
        from surrealdb_tpu_torch.exec.static_eval import static_value_maybe
        from surrealdb_tpu_torch.val import render

        try:
            return render(static_value_maybe(kind.literal))
        except Exception:
            return "literal"
    if kind.inner:
        # array<any> / set<any> normalize to the bare container kind
        if (
            kind.name in ("array", "set")
            and len(kind.inner) == 1
            and isinstance(kind.inner[0], Kind)
            and kind.inner[0].name == "any"
            and kind.size is None
        ):
            return kind.name
        inner = ", ".join(
            kind_name(k) if isinstance(k, Kind) else str(k) for k in kind.inner
        )
        if kind.size is not None:
            inner += f", {kind.size}"
        return f"{kind.name}<{inner}>"
    return kind.name


def _type_name(v) -> str:
    if v is NONE:
        return "none"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, Decimal):
        return "decimal"
    if isinstance(v, str):
        return "string"
    if isinstance(v, Duration):
        return "duration"
    if isinstance(v, Datetime):
        return "datetime"
    if isinstance(v, Uuid):
        return "uuid"
    from surrealdb_tpu_torch.val import SSet as _SS

    if isinstance(v, _SS):
        return "set"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    if isinstance(v, Geometry):
        sub = v.kind.lower()
        sub = {
            "geometrycollection": "collection",
            "linestring": "line",
            "multilinestring": "multiline",
        }.get(sub, sub)
        return f"geometry<{sub}>"
    if isinstance(v, (bytes, bytearray)):
        return "bytes"
    if isinstance(v, RecordId):
        return "record"
    if isinstance(v, Range):
        return "range"
    if isinstance(v, Regex):
        return "regex"
    if isinstance(v, File):
        return "file"
    if isinstance(v, Table):
        return "table"
    from surrealdb_tpu_torch.val import Closure as _Clo

    if isinstance(v, _Clo):
        return "function"
    return type(v).__name__


def coerce_err(v, kind: Kind):
    # reference format: val/value/convert/coerce.rs CoerceError::InvalidKind
    return SdbError(
        f"Expected `{kind_name(kind)}` but found `{render(v)}`"
    )


def coerce(v, kind: Kind):
    """Coerce a value to a kind; raises SdbError on mismatch."""
    n = kind.name
    if n == "any":
        return v
    if n == "option":
        if v is NONE:
            return NONE
        if v is None:
            # NULL is NOT none: option<string> rejects it unless the
            # inner kind admits null (language/types/field_none_null)
            if kind.inner:
                try:
                    return coerce(v, kind.inner[0])
                except SdbError:
                    raise coerce_err(v, kind)
            raise coerce_err(v, kind)
        return coerce(v, kind.inner[0]) if kind.inner else v
    if n == "either":
        for k in kind.inner:
            try:
                return coerce(v, k)
            except SdbError:
                continue
        raise coerce_err(v, kind)
    if n == "literal":
        lit = kind.literal
        from surrealdb_tpu_torch.expr.ast import ArrayExpr as _AE

        if isinstance(lit, _AE):
            # array-shaped literal kind: elements are kinds/literals
            if not isinstance(v, list) or len(v) != len(lit.items):
                raise coerce_err(v, kind)
            out = []
            for x, spec in zip(v, lit.items):
                out.append(coerce(x, _as_kind(spec)))
            return out
        from surrealdb_tpu_torch.exec.static_eval import static_value_maybe

        litv = static_value_maybe(lit)
        if value_eq(v, litv):
            return v
        raise coerce_err(v, kind)
    if n == "null":
        if v is None:
            return v
        raise coerce_err(v, kind)
    if n == "none":
        if v is NONE:
            return v
        raise coerce_err(v, kind)
    if n == "bool":
        if isinstance(v, bool):
            return v
        raise coerce_err(v, kind)
    if n == "int":
        if isinstance(v, bool):
            raise coerce_err(v, kind)
        if isinstance(v, int):
            return v
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, Decimal) and v == v.to_integral_value():
            return int(v)
        raise coerce_err(v, kind)
    if n == "float":
        if isinstance(v, bool):
            raise coerce_err(v, kind)
        if isinstance(v, float):
            return v
        if isinstance(v, (int, Decimal)):
            return float(v)
        raise coerce_err(v, kind)
    if n == "decimal":
        if isinstance(v, bool):
            raise coerce_err(v, kind)
        if isinstance(v, Decimal):
            return v
        if isinstance(v, int):
            return Decimal(v)
        if isinstance(v, float):
            return Decimal(str(v))
        raise coerce_err(v, kind)
    if n == "number":
        if isinstance(v, bool):
            raise coerce_err(v, kind)
        if isinstance(v, (int, float, Decimal)):
            return v
        raise coerce_err(v, kind)
    if n == "string":
        if isinstance(v, str):
            return v
        if isinstance(v, Table):
            return v.name
        raise coerce_err(v, kind)
    if n == "duration":
        if isinstance(v, Duration):
            return v
        raise coerce_err(v, kind)
    if n == "datetime":
        if isinstance(v, Datetime):
            return v
        if isinstance(v, str):
            try:
                return Datetime.parse(v)
            except ValueError:
                pass
        raise coerce_err(v, kind)
    if n == "uuid":
        if isinstance(v, Uuid):
            return v
        if isinstance(v, str):
            try:
                return Uuid(v)
            except ValueError:
                pass
        raise coerce_err(v, kind)
    if n == "array":
        if not isinstance(v, list):
            raise coerce_err(v, kind)
        if kind.inner:
            v = [coerce(x, kind.inner[0]) for x in v]
        if kind.size is not None and len(v) != kind.size:
            # sized collections demand the exact length (reference
            # coerce.rs: array<T, N> is a fixed size)
            inner_n = kind_name(kind.inner[0]) if kind.inner else "any"
            raise SdbError(
                f"Expected `array<{inner_n},{kind.size}>` but found a "
                f"collection of length `{len(v)}`"
            )
        return v
    if n == "set":
        from surrealdb_tpu_torch.val import SSet

        if isinstance(v, SSet):
            items = v.items
        elif isinstance(v, list):
            items = v
        else:
            raise coerce_err(v, kind)
        if kind.inner:
            items = [coerce(x, kind.inner[0]) for x in items]
        out = SSet(items)
        if kind.size is not None and len(out) != kind.size:
            inner_n = kind_name(kind.inner[0]) if kind.inner else "any"
            raise SdbError(
                f"Expected `set<{inner_n},{kind.size}>` but found a "
                f"collection of length `{len(out)}`"
            )
        return out
    if n == "object":
        if isinstance(v, dict):
            return v
        raise coerce_err(v, kind)
    if n == "array_literal":
        if not isinstance(v, list) or len(v) != len(kind.inner):
            raise coerce_err(v, kind)
        return [coerce(x, kk) for x, kk in zip(v, kind.inner)]
    if n == "object_literal":
        if not isinstance(v, dict):
            raise coerce_err(v, kind)
        declared = dict(kind.inner)
        out = {}
        for k in v:
            if k not in declared:
                raise coerce_err(v, kind)
        for k, kk in declared.items():
            try:
                sub = coerce(v.get(k, NONE), kk)
            except SdbError:
                # sub-field mismatches report at the object level, with the
                # full declared kind and the full offending value
                raise coerce_err(v, kind)
            if sub is not NONE:
                out[k] = sub
        return out
    if n == "record":
        if isinstance(v, RecordId):
            if kind.inner and v.tb not in kind.inner:
                raise coerce_err(v, kind)
            return v
        raise coerce_err(v, kind)
    if n == "geometry":
        if isinstance(v, Geometry):
            if kind.inner and v.kind.lower() not in [
                x.lower() for x in kind.inner
            ] and not (
                "collection" in kind.inner
                and v.kind == "GeometryCollection"
            ):
                raise coerce_err(v, kind)
            return v
        if isinstance(v, dict) and "type" in v and (
            "coordinates" in v or "geometries" in v
        ):
            g = object_to_geometry(v)
            if g is not None:
                return coerce(g, kind)
        raise coerce_err(v, kind)
    if n == "point":
        if isinstance(v, Geometry) and v.kind == "Point":
            return v
        raise coerce_err(v, kind)
    if n == "bytes":
        if isinstance(v, (bytes, bytearray)):
            return bytes(v)
        raise coerce_err(v, kind)
    if n == "regex":
        if isinstance(v, Regex):
            return v
        raise coerce_err(v, kind)
    if n == "range":
        if isinstance(v, Range):
            return v
        raise coerce_err(v, kind)
    if n == "function":
        from surrealdb_tpu_torch.val import Closure

        if isinstance(v, Closure):
            return v
        raise coerce_err(v, kind)
    if n == "file":
        if isinstance(v, File):
            return v
        raise coerce_err(v, kind)
    if n == "table":
        if isinstance(v, Table):
            t = v
        elif isinstance(v, str):
            t = Table(v)
        else:
            raise coerce_err(v, kind)
        if kind.inner and t.name not in kind.inner:
            raise coerce_err(v, kind)
        return t
    if n == "references":
        # computed references fields — value is filled by the executor
        return v if isinstance(v, list) else []
    raise SdbError(f"unknown kind {n!r}")


def _as_kind(spec):
    """A literal-kind element: already a Kind, or a literal value/AST."""
    if isinstance(spec, Kind):
        return spec
    from surrealdb_tpu_torch.expr.ast import Idiom as _Idiom, Literal as _Lit, PField as _PF

    if isinstance(spec, _Idiom) and len(spec.parts) == 1 and isinstance(
        spec.parts[0], _PF
    ) and spec.parts[0].name.lower() in (
        "any", "bool", "int", "float", "number", "string", "datetime",
        "duration", "uuid", "object", "array", "bytes", "decimal",
        "record", "geometry", "point", "set", "null", "none", "regex",
        "range", "table",
    ):
        return Kind(spec.parts[0].name.lower())
    return Kind("literal", literal=spec)


def object_to_geometry(v: dict):
    t = v.get("type")
    if t == "GeometryCollection":
        geoms = v.get("geometries")
        if isinstance(geoms, list):
            inner = [
                g if isinstance(g, Geometry) else object_to_geometry(g)
                for g in geoms
            ]
            if all(inner):
                return Geometry(t, inner)
        return None
    coords = v.get("coordinates")
    if t in ("Point", "LineString", "Polygon", "MultiPoint",
             "MultiLineString", "MultiPolygon") and coords is not None:
        tc = _tupled(coords)
        # polygon rings auto-close (reference geo semantics: the first
        # point is appended when the ring is open)
        if t == "Polygon":
            tc = tuple(_close_ring(r) for r in tc)
        elif t == "MultiPolygon":
            tc = tuple(
                tuple(_close_ring(r) for r in poly) for poly in tc
            )
        return Geometry(t, tc)
    return None


def _close_ring(ring):
    if isinstance(ring, tuple) and len(ring) >= 2 and ring[0] != ring[-1]:
        return ring + (ring[0],)
    return ring


def _tupled(c):
    if isinstance(c, list):
        return tuple(_tupled(x) for x in c)
    return float(c) if isinstance(c, (int, float, Decimal)) else c


def cast_err(v, kind: Kind):
    # reference format: "Could not cast into `k` using input `v`"
    return SdbError(
        f"Could not cast into `{kind_name(kind)}` using input `{render(v)}`"
    )


def cast(v, kind: Kind):
    """`<kind> value` — lenient conversion (reference expr/cast.rs)."""
    n = kind.name
    if n in ("set", "array") and kind.size is not None:
        # sized casts demand the EXACT length (type/set.surql:
        # <set<int,5>>[1,2,1] errors), unlike field coercion's upper bound
        pass
    else:
        try:
            return coerce(v, kind)
        except SdbError:
            pass
    if n == "int":
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    f = float(v)
                    return int(f)
                except ValueError:
                    pass
        if isinstance(v, (float, Decimal)):
            if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
                raise SdbError(f"Cannot convert {render(v)} to an int")
            return int(v)
        if isinstance(v, bool):
            return 1 if v else 0
        if isinstance(v, Datetime):
            return v.epoch_ns() // 1_000_000_000
    elif n == "float":
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                pass
        if isinstance(v, (int, Decimal)):
            return float(v)
        if isinstance(v, bool):
            return 1.0 if v else 0.0
    elif n == "decimal":
        if isinstance(v, str):
            try:
                return Decimal(v)
            except Exception:
                pass
        if isinstance(v, (int, float)):
            return Decimal(str(v))
        if isinstance(v, bool):
            return Decimal(1 if v else 0)
    elif n == "number":
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    pass
    elif n == "string":
        if isinstance(v, (bytes, bytearray)):
            return bytes(v).decode("utf-8", "replace")
        from surrealdb_tpu_torch.exec.operators import to_string

        return to_string(v)  # <string> NONE renders "NONE" (reference)
    elif n == "bool":
        if isinstance(v, str):
            if v.lower() == "true":
                return True
            if v.lower() == "false":
                return False
    elif n == "datetime":
        if isinstance(v, str):
            try:
                return Datetime.parse(v)
            except ValueError:
                raise cast_err(v, kind)
        if isinstance(v, int):
            import datetime as _dt

            return Datetime(_dt.datetime.fromtimestamp(v, _dt.timezone.utc))
    elif n == "duration":
        if isinstance(v, str):
            return Duration.parse(v)
    elif n == "uuid":
        if isinstance(v, str):
            try:
                return Uuid(v)
            except ValueError:
                raise cast_err(v, kind)
    elif n == "record":
        if isinstance(v, str):
            from surrealdb_tpu_torch.syn.parser import parse_record_literal
            from surrealdb_tpu_torch.exec.static_eval import static_value

            try:
                rid2 = static_value(parse_record_literal(v))
            except Exception:
                raise cast_err(v, kind)
            if kind.inner and rid2.tb not in kind.inner:
                raise cast_err(v, kind)
            return rid2
    elif n == "array":
        from surrealdb_tpu_torch.val import SSet as _SSet

        def _len_check(out):
            if kind.size is not None and len(out) != int(kind.size):
                inner_n = kind_name(kind.inner[0]) if kind.inner else "any"
                raise SdbError(
                    f"Expected `array<{inner_n},{kind.size}>` but found a "
                    f"collection of length `{len(out)}`"
                )
            return out

        if isinstance(v, list):
            return _len_check(
                [cast(x, kind.inner[0]) for x in v] if kind.inner else v
            )
        if isinstance(v, _SSet):
            items = list(v.items)
            return _len_check(
                [cast(x, kind.inner[0]) for x in items]
                if kind.inner else items
            )
        if isinstance(v, Range):
            try:
                items = list(v.iter_ints())
            except TypeError:
                raise cast_err(v, kind)
            return _len_check(
                [cast(x, kind.inner[0]) for x in items]
                if kind.inner else items
            )
        if isinstance(v, (bytes, bytearray)):
            return _len_check(
                [cast(x, kind.inner[0]) for x in list(v)]
                if kind.inner else list(v)
            )
        raise cast_err(v, kind)
    elif n == "set":
        from surrealdb_tpu_torch.val import SSet

        if isinstance(v, SSet):
            base = v.items
        elif isinstance(v, list):
            base = v
        elif isinstance(v, (bytes, bytearray)):
            base = list(v)
        elif isinstance(v, Range):
            try:
                base = list(v.iter_ints())
            except TypeError:
                raise cast_err(v, Kind("array"))
        else:
            # set casts convert through array first: failures name `array`
            # (casting/decimal.surql)
            raise cast_err(v, Kind("array"))
        if kind.inner:
            base = [cast(x, kind.inner[0]) for x in base]
        out = SSet(base)
        if kind.size is not None and len(out.items) != int(kind.size):
            inner_n = kind_name(kind.inner[0]) if kind.inner else "any"
            raise SdbError(
                f"Expected `set<{inner_n},{kind.size}>` but found a "
                f"collection of length `{len(out.items)}`"
            )
        return out
    elif n == "bytes":
        if isinstance(v, str):
            return v.encode("utf-8")
        if isinstance(v, list) and all(
            isinstance(x, int) and not isinstance(x, bool) and 0 <= x < 256
            for x in v
        ):
            return bytes(v)
    elif n == "regex":
        if isinstance(v, str):
            return Regex(v)
    elif n == "geometry" or n == "point":
        g = None
        if isinstance(v, dict):
            g = object_to_geometry(v)
        elif isinstance(v, (list, tuple)) and len(v) == 2 and all(
            isinstance(x, (int, float, Decimal)) and not isinstance(x, bool)
            for x in v
        ):
            g = Geometry("Point", (float(v[0]), float(v[1])))
        if g is not None:
            try:
                return coerce(g, kind)
            except SdbError:
                raise cast_err(v, Kind("geometry"))
        # geometry cast failures always name the bare kind (reference
        # val/convert/cast.rs: the error drops the parameterization)
        raise cast_err(v, Kind("geometry"))
    raise cast_err(v, kind)
