"""Binary / unary operator semantics (reference: expr/operator.rs + val ops)."""

from __future__ import annotations

import math
from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import (
    NONE,
    Datetime,
    Duration,
    Geometry,
    Range,
    RecordId,
    Regex,
    Table,
    Uuid,
    is_truthy,
    render,
    value_cmp,
    value_eq,
)

_NUM = (int, float, Decimal)


def to_string(v) -> str:
    """String conversion used by <string> cast and string concat."""
    if isinstance(v, str):
        return v
    if v is NONE:
        return "NONE"
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 1e15:
            return f"{int(v)}"
        return repr(v)
    if isinstance(v, Decimal):
        return str(v)
    if isinstance(v, Duration):
        return v.render()
    if isinstance(v, Datetime):
        return v.render()
    if isinstance(v, Uuid):
        return str(v.u)
    if isinstance(v, RecordId):
        return v.render()
    if isinstance(v, Table):
        return v.name
    return render(v)


def _num2(a, b):
    """Promote a pair of numbers: int+int->int, any decimal->decimal, else float."""
    if isinstance(a, bool) or isinstance(b, bool):
        raise SdbError("cannot perform arithmetic on booleans")
    if isinstance(a, Decimal) or isinstance(b, Decimal):
        return (
            a if isinstance(a, Decimal) else Decimal(str(a)),
            b if isinstance(b, Decimal) else Decimal(str(b)),
        )
    return a, b


def add(a, b):
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, SSet):
        if not isinstance(b, (SSet, list)):
            # {1,} + 1 errors like [1] + 1 (set_array_common_behaviour)
            raise SdbError(
                f"Cannot perform addition with '{_disp(a)}' and '{_disp(b)}'"
            )
        return SSet(a.items + list(b))
    if isinstance(b, SSet) and isinstance(a, list):
        return a + b.items
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        return a + b
    if isinstance(a, str) and isinstance(b, str):
        return a + b
    if isinstance(a, Datetime) and isinstance(b, Duration):
        import datetime as _dt

        total = a.epoch_ns() + b.ns
        secs, frac = divmod(total, 1_000_000_000)
        return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac)
    if isinstance(a, Duration) and isinstance(b, Datetime):
        return add(b, a)
    if isinstance(a, Duration) and isinstance(b, Duration):
        if a.ns + b.ns > Duration.MAX_NS:
            raise SdbError(
                f'Failed to compute: "{a.render()} + {b.render()}", as the '
                "operation results in an arithmetic overflow."
            )
        return a + b
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        out.update(b)
        return out
    raise SdbError(f"Cannot perform addition with '{_disp(a)}' and '{_disp(b)}'")


def sub(a, b):
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        return a - b
    if isinstance(a, Datetime) and isinstance(b, Duration):
        import datetime as _dt

        total = a.epoch_ns() - b.ns
        secs, frac = divmod(total, 1_000_000_000)
        return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac)
    if isinstance(a, Datetime) and isinstance(b, Datetime):
        return Duration(abs(a.epoch_ns() - b.epoch_ns()))
    if isinstance(a, Duration) and isinstance(b, Duration):
        if b.ns > a.ns:
            raise SdbError(
                f'Failed to compute: "{a.render()} - {b.render()}", as '
                "the operation results in a negative value."
            )
        return a - b
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, list) and isinstance(b, (list, SSet)):
        return [x for x in a if not any(value_eq(x, y) for y in b)]
    if isinstance(a, SSet) and isinstance(b, (list, SSet)):
        return SSet(
            [x for x in a.items if not any(value_eq(x, y) for y in b)]
        )
    # array/set - scalar is an ERROR in binary position (only the -=
    # assignment removes by value; set_array_common_behaviour.surql)
    raise SdbError(f"Cannot perform subtraction with '{_disp(a)}' and '{_disp(b)}'")


def mul(a, b):
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        return a * b
    # duration scaling (reference val/duration.rs Mul<Number>): dur * n
    # and n * dur; duration * duration is an error
    if isinstance(b, Duration) and isinstance(a, _NUM) and not isinstance(a, bool):
        a, b = b, a
    if isinstance(a, Duration) and isinstance(b, _NUM) and not isinstance(b, bool):
        prod = a.ns * b
        if not isinstance(prod, int) and not math.isfinite(float(prod)):
            raise SdbError(
                f'Failed to compute: "{a.render()} * {_disp(b)}", as the '
                "operation results in an arithmetic overflow."
            )
        ns = int(prod)
        if ns > Duration.MAX_NS or ns < 0:
            raise SdbError(
                f'Failed to compute: "{a.render()} * {_disp(b)}", as the '
                "operation results in an arithmetic overflow."
            )
        return Duration(ns)
    raise SdbError(f"Cannot perform multiplication with '{_disp(a)}' and '{_disp(b)}'")


def div(a, b):
    # duration division (reference val/duration.rs): dur / number scales;
    # anything else involving durations is NaN
    if isinstance(a, Duration) and isinstance(b, Duration):
        return float("nan")
    if isinstance(a, Duration) and isinstance(b, _NUM) and not isinstance(b, bool):
        if b == 0:
            return float("nan")
        return Duration(int(a.ns // b))
    if isinstance(b, Duration) and isinstance(a, _NUM) and not isinstance(a, bool):
        return float("nan")
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        try:
            if isinstance(a, int) and isinstance(b, int):
                if b == 0:
                    return float("nan")  # reference: try_div.unwrap_or(NaN)
                # reference try_div(Int, Int) = checked_div: truncating
                q = abs(a) // abs(b)
                return q if (a >= 0) == (b >= 0) else -q
            if isinstance(a, Decimal):
                if b == 0:
                    return float("nan")
                return a / b
            if b == 0:
                if a == 0:
                    return float("nan")
                return float("inf") if a > 0 else float("-inf")
            return a / b
        except (ZeroDivisionError, ArithmeticError):
            return NONE
    # non-numeric division is NaN, not an error (primitive/array
    # arithmic_operations.surql: [1,2,3] / 1 -> NaN)
    return float("nan")


def float_div(a, b):
    """reference try_float_div: Int/Int stays Int when exact, else Float
    (used by math::mean and aggregate means, NOT the `/` operator)."""
    if isinstance(a, int) and not isinstance(a, bool) and \
            isinstance(b, int) and not isinstance(b, bool):
        if b == 0:
            return float("nan")
        if a % b == 0:
            return a // b
        return a / b
    return div(a, b)


def _disp(v):
    """Operands in arithmetic error texts display raw strings without
    quotes (reference Value Display, not ToSql)."""
    return v if isinstance(v, str) else render(v)


def rem(a, b):
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        try:
            if b == 0:
                raise SdbError(
                    f"Cannot perform remainder with '{_disp(a)}' and '{_disp(b)}'"
                )
            if isinstance(a, int) and isinstance(b, int):
                # exact truncated remainder (Rust %): sign of the dividend
                r = abs(a) % abs(b)
                return -r if a < 0 else r
            return math.fmod(a, b)
        except (ZeroDivisionError, ArithmeticError):
            return NONE
    raise SdbError(f"Cannot perform remainder with '{_disp(a)}' and '{_disp(b)}'")


def pow_(a, b):
    if isinstance(a, _NUM) and not isinstance(a, bool) and isinstance(b, _NUM) and not isinstance(b, bool):
        a, b = _num2(a, b)
        try:
            if isinstance(a, int) and isinstance(b, int) and b > 0 \
                    and abs(a) > 1 and b * (abs(a).bit_length() - 1) > 64:
                # overflow is guaranteed: refuse before materializing a
                # huge arbitrary-precision integer (reference checked_pow)
                raise SdbError(
                    f"Cannot raise the value '{render(a)}' with "
                    f"'{render(b)}'"
                )
            r = a ** b
            if isinstance(r, complex):
                return float("nan")
            if isinstance(a, int) and isinstance(b, int) and not (
                -(1 << 63) <= r < (1 << 63)
            ):
                # reference i64 checked_pow
                raise SdbError(
                    f"Cannot raise the value '{render(a)}' with "
                    f"'{render(b)}'"
                )
            return r
        except (OverflowError, ArithmeticError):
            return float("inf")
    raise SdbError(
        f"Cannot raise the value '{_disp(a)}' with '{_disp(b)}'"
    )


def neg(a):
    if isinstance(a, _NUM) and not isinstance(a, bool):
        if isinstance(a, int) and -a > (1 << 63) - 1:
            # i64 overflow: -(i64::MIN) is unrepresentable
            raise SdbError(f"Cannot negate the value '{_disp(a)}'")
        return -a
    raise SdbError(f"Cannot negate the value '{_disp(a)}'")


# -- equality / fuzzy matching ----------------------------------------------


def exact_eq(a, b) -> bool:
    return value_eq(a, b)


def fuzzy_match(a, b) -> bool:
    """~ operator: fuzzy string match (reference uses a fuzzy matcher)."""
    if isinstance(a, str) and isinstance(b, str):
        return _fuzzy(b.lower(), a.lower())
    if isinstance(a, Regex) and isinstance(b, str):
        return a.rx.search(b) is not None
    if isinstance(b, Regex) and isinstance(a, str):
        return b.rx.search(a) is not None
    return value_eq(a, b)


def _fuzzy(needle: str, hay: str) -> bool:
    i = 0
    for c in hay:
        if i < len(needle) and needle[i] == c:
            i += 1
    return i == len(needle)


def equal(a, b) -> bool:
    if isinstance(a, Regex) and isinstance(b, str):
        return a.rx.search(b) is not None
    if isinstance(b, Regex) and isinstance(a, str):
        return b.rx.search(a) is not None
    return value_eq(a, b)


def all_equal(a, b) -> bool:  # *=
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, SSet):
        a = a.items
    if isinstance(a, list):
        return all(equal(x, b) for x in a)
    return equal(a, b)


def any_equal(a, b) -> bool:  # ?=
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, SSet):
        a = a.items
    if isinstance(a, list):
        return any(equal(x, b) for x in a)
    return equal(a, b)


def contains(a, b) -> bool:
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, SSet):
        a = a.items
    if isinstance(a, list):
        return any(value_eq(x, b) for x in a)
    if isinstance(a, str):
        return isinstance(b, str) and b in a
    if isinstance(a, dict):
        return isinstance(b, str) and b in a
    if isinstance(a, Range):
        c1 = value_cmp(a.beg, b) if a.beg is not NONE else -1
        c2 = value_cmp(b, a.end) if a.end is not NONE else -1
        lo = c1 < 0 or (c1 == 0 and a.beg_incl)
        hi = c2 < 0 or (c2 == 0 and a.end_incl)
        return lo and hi
    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return geo_contains(a, b)
    return False


def contains_all(a, b) -> bool:
    b = _elems(b)
    from surrealdb_tpu_torch.val import SSet as _S

    if isinstance(a, (list, str, dict, Range, _S)) and isinstance(b, list):
        return all(contains(a, x) for x in b)
    if isinstance(a, Geometry) and isinstance(b, list):
        return all(isinstance(x, Geometry) and geo_contains(a, x) for x in b)
    return False


def contains_any(a, b) -> bool:
    b = _elems(b)
    from surrealdb_tpu_torch.val import SSet as _S

    if isinstance(a, (list, str, dict, Range, _S)) and isinstance(b, list):
        return any(contains(a, x) for x in b)
    if isinstance(a, Geometry) and isinstance(b, list):
        return any(isinstance(x, Geometry) and geo_contains(a, x) for x in b)
    return False


def contains_none(a, b) -> bool:
    b = _elems(b)
    from surrealdb_tpu_torch.val import SSet as _S

    if isinstance(a, (list, str, dict, Range, _S)) and isinstance(b, list):
        return not any(contains(a, x) for x in b)
    return True


def inside(a, b) -> bool:
    if isinstance(b, Geometry) and isinstance(a, Geometry):
        return geo_contains(b, a)
    return contains(b, a)


def _elems(a):
    from surrealdb_tpu_torch.val import SSet

    if isinstance(a, SSet):
        return a.items
    return a


def all_inside(a, b) -> bool:
    a = _elems(a)
    if isinstance(a, list):
        return all(inside(x, b) for x in a)
    return inside(a, b)


def any_inside(a, b) -> bool:
    a = _elems(a)
    if isinstance(a, list):
        return any(inside(x, b) for x in a)
    return inside(a, b)


def none_inside(a, b) -> bool:
    a = _elems(a)
    if isinstance(a, list):
        return not any(inside(x, b) for x in a)
    return not inside(a, b)


def outside(a, b) -> bool:
    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return not geo_intersects(a, b)
    return not inside(a, b)


def intersects(a, b) -> bool:
    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return geo_intersects(a, b)
    return False


# -- geometry predicates (pure-python; small shapes) -------------------------


def _points_of(g: Geometry):
    k = g.kind
    c = g.coords
    if k == "Point":
        return [c]
    if k in ("LineString", "MultiPoint"):
        return list(c)
    if k in ("Polygon", "MultiLineString"):
        return [p for ring in c for p in ring]
    if k == "MultiPolygon":
        return [p for poly in c for ring in poly for p in ring]
    if k == "GeometryCollection":
        return [p for g2 in c for p in _points_of(g2)]
    return []


def _point_in_ring(pt, ring) -> bool:
    x, y = float(pt[0]), float(pt[1])
    inside_flag = False
    n = len(ring)
    j = n - 1
    for i in range(n):
        xi, yi = float(ring[i][0]), float(ring[i][1])
        xj, yj = float(ring[j][0]), float(ring[j][1])
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside_flag = not inside_flag
        j = i
    return inside_flag


def _point_in_polygon(pt, poly) -> bool:
    if not poly:
        return False
    if not _point_in_ring(pt, poly[0]):
        return False
    for hole in poly[1:]:
        if _point_in_ring(pt, hole):
            return False
    return True


def geo_contains(a: Geometry, b: Geometry) -> bool:
    pts = _points_of(b)
    if not pts:
        return False
    if a.kind == "Polygon":
        return all(_point_in_polygon(p, a.coords) for p in pts)
    if a.kind == "MultiPolygon":
        return all(
            any(_point_in_polygon(p, poly) for poly in a.coords) for p in pts
        )
    if a.kind == "Point":
        return b.kind == "Point" and tuple(map(float, a.coords)) == tuple(
            map(float, b.coords)
        )
    return False


def geo_intersects(a: Geometry, b: Geometry) -> bool:
    apolys = a.kind in ("Polygon", "MultiPolygon")
    bpolys = b.kind in ("Polygon", "MultiPolygon")
    if apolys:
        polys = [a.coords] if a.kind == "Polygon" else list(a.coords)
        if any(
            any(_point_in_polygon(p, poly) for poly in polys)
            for p in _points_of(b)
        ):
            return True
    if bpolys:
        polys = [b.coords] if b.kind == "Polygon" else list(b.coords)
        if any(
            any(_point_in_polygon(p, poly) for poly in polys)
            for p in _points_of(a)
        ):
            return True
    if not apolys and not bpolys:
        pa = {tuple(map(float, p)) for p in _points_of(a)}
        pb = {tuple(map(float, p)) for p in _points_of(b)}
        return bool(pa & pb)
    return False


# -- dispatch ----------------------------------------------------------------


def binary_op(op: str, a, b):
    if op == "=" or op == "==":
        if op == "==":
            return exact_eq(a, b)
        return equal(a, b)
    if op == "!=":
        return not equal(a, b)
    if op == "?=":
        return any_equal(a, b)
    if op == "*=":
        return all_equal(a, b)
    if op == "~":
        return fuzzy_match(b, a) if isinstance(b, (str, Regex)) else fuzzy_match(a, b)
    if op == "!~":
        return not binary_op("~", a, b)
    if op == "?~":
        if isinstance(a, list):
            return any(binary_op("~", x, b) for x in a)
        return binary_op("~", a, b)
    if op == "*~":
        if isinstance(a, list):
            return all(binary_op("~", x, b) for x in a)
        return binary_op("~", a, b)
    if op == "<":
        return value_cmp(a, b) < 0
    if op == "<=":
        return value_cmp(a, b) <= 0
    if op == ">":
        return value_cmp(a, b) > 0
    if op == ">=":
        return value_cmp(a, b) >= 0
    if op == "+":
        return add(a, b)
    if op == "-":
        return sub(a, b)
    if op == "*":
        return mul(a, b)
    if op == "/":
        return div(a, b)
    if op == "%":
        return rem(a, b)
    if op == "**":
        return pow_(a, b)
    if op == "∋":
        return contains(a, b)
    if op == "∌":
        return not contains(a, b)
    if op == "⊇":
        return contains_all(a, b)
    if op == "containsany":
        return contains_any(a, b)
    if op == "containsnone":
        return contains_none(a, b)
    if op == "∈":
        return inside(a, b)
    if op == "∉":
        return not inside(a, b)
    if op == "⊆":
        return all_inside(a, b)
    if op == "anyinside":
        return any_inside(a, b)
    if op == "noneinside":
        return none_inside(a, b)
    if op == "outside":
        return outside(a, b)
    if op == "intersects":
        return intersects(a, b)
    raise SdbError(f"unknown operator {op!r}")
