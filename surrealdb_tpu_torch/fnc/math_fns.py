"""math:: functions incl. stats (reference: core/src/fnc/math.rs + util/math)."""

from __future__ import annotations

import math
from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _arr, _num, register
from surrealdb_tpu_torch.val import NONE, sort_key


def _nums(a, fname, keep=False):
    out = []
    for x in _arr(a, fname):
        if isinstance(x, bool) or not isinstance(x, (int, float, Decimal)):
            continue
        out.append(x if keep else float(x))
    return out


def _num_elems(a, fname):
    """Array argument coerced to numbers; non-numeric elements error
    (reference Vec<Number> argument coercion)."""
    from surrealdb_tpu_torch.val import render

    out = []
    for x in _arr(a, fname, 1):
        if isinstance(x, bool) or not isinstance(x, (int, float, Decimal)):
            raise SdbError(
                f"Incorrect arguments for function {fname}(). Argument 1 "
                f"was the wrong type. Expected `number` but found "
                f"`{render(x)}` when coercing an element of `array<number>`"
            )
        out.append(x)
    return out


class _RustHeap:
    """Rust std BinaryHeap layout emulation (push sift-up; pop moves the
    last element to the root, walks the hole to the bottom along greatest
    children, then sifts up) so into_vec order matches the reference."""

    def __init__(self, gt):
        self.a = []
        self.gt = gt  # strict greater-than in heap order

    def push(self, v):
        a = self.a
        a.append(v)
        i = len(a) - 1
        while i > 0:
            p = (i - 1) // 2
            if self.gt(a[i], a[p]):
                a[i], a[p] = a[p], a[i]
                i = p
            else:
                break

    def pop(self):
        a = self.a
        if not a:
            return None
        top = a[0]
        last = a.pop()
        if not a:
            return top
        # hole starts at root and descends along greatest children
        hole = 0
        n = len(a)
        while 2 * hole + 1 < n:
            c = 2 * hole + 1
            if c + 1 < n and self.gt(a[c + 1], a[c]):
                c += 1
            a[hole] = a[c]
            hole = c
        # place the displaced element and sift it up
        i = hole
        a[i] = last
        while i > 0:
            p = (i - 1) // 2
            if self.gt(a[i], a[p]):
                a[i], a[p] = a[p], a[i]
                i = p
            else:
                break
        return top


def _unary(name, fn):
    @register(f"math::{name}")
    def _f(args, ctx, fn=fn, name=name):
        v = _num(args[0], f"math::{name}")
        try:
            return fn(v)
        except (ValueError, OverflowError):
            return float("nan")


def _abs_checked(v):
    if isinstance(v, int) and v == -(1 << 63):
        raise SdbError(
            'Failed to compute: "math::abs(-9223372036854775808)", as the '
            "operation results in an arithmetic overflow."
        )
    return abs(v)


_unary("abs", _abs_checked)
_unary("acos", lambda v: math.acos(v))
_unary("acot", lambda v: math.atan(1 / v) if v != 0 else math.pi / 2)
_unary("asin", lambda v: math.asin(v))
_unary("atan", lambda v: math.atan(v))
_unary("cos", lambda v: math.cos(v))
_unary("cot", lambda v: 1 / math.tan(v))
_unary("deg2rad", lambda v: math.radians(v))
def _logf(fn):
    def inner(v):
        v = float(v)
        if v == 0.0:
            return float("-inf")
        if v < 0.0:
            return float("nan")
        return fn(v)

    return inner


_unary("ln", _logf(math.log))
_unary("log10", _logf(math.log10))
_unary("log2", _logf(math.log2))
_unary("rad2deg", lambda v: math.degrees(v))
def _signum(v):
    # floats use f64::signum (reference Number::sign): +-0.0 keep their
    # sign bit, NaN stays NaN
    if isinstance(v, float):
        if math.isnan(v):
            return v
        return math.copysign(1.0, v)
    return (v > 0) - (v < 0)


_unary("sign", _signum)
_unary("sin", lambda v: math.sin(v))
_unary("sqrt", lambda v: math.sqrt(v))
_unary("tan", lambda v: math.tan(v))


@register("math::ceil")
def _ceil(args, ctx):
    v = _num(args[0], "math::ceil", 1)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return v
    if isinstance(v, Decimal):
        return v.to_integral_value(rounding="ROUND_CEILING")
    return float(math.ceil(v))


@register("math::floor")
def _floor(args, ctx):
    v = _num(args[0], "math::floor", 1)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return v
    if isinstance(v, Decimal):
        return v.to_integral_value(rounding="ROUND_FLOOR")
    return float(math.floor(v))


@register("math::round")
def _round(args, ctx):
    v = _num(args[0], "math::round", 1)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return v
    # half-away-from-zero like Rust's round(); floats stay floats
    r = math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)
    return float(r) if isinstance(v, float) else r


@register("math::fixed")
def _fixed(args, ctx):
    v = _num(args[0], "math::fixed", 1)
    p = int(_num(args[1], "math::fixed", 2))
    if p <= 0:
        raise SdbError("Incorrect arguments for function math::fixed(). The second argument must be an integer greater than 0.")
    if isinstance(v, int):
        return v
    return round(float(v), p)


@register("math::clamp")
def _clamp(args, ctx):
    v = _num(args[0], "math::clamp", 1)
    lo = _num(args[1], "math::clamp", 2)
    hi = _num(args[2], "math::clamp", 3)
    if lo > hi:
        raise SdbError(
            "Incorrect arguments for function math::clamp(). Lowerbound "
            "for clamp must be smaller than the upperbound"
        )
    out = max(lo, min(hi, v))
    if isinstance(v, float) and not isinstance(out, float):
        return float(out)
    return out


@register("math::lerp")
def _lerp(args, ctx):
    a = float(_num(args[0], "math::lerp", 1))
    b = float(_num(args[1], "math::lerp", 2))
    t = float(_num(args[2], "math::lerp", 3))
    return a + (b - a) * t


@register("math::lerpangle")
def _lerpangle(args, ctx):
    a = float(_num(args[0], "math::lerpangle", 1))
    b = float(_num(args[1], "math::lerpangle", 2))
    t = float(_num(args[2], "math::lerpangle", 3))
    d = (b - a) % 360.0
    if d > 180.0:
        d -= 360.0
    return a + d * t


@register("math::log")
def _log(args, ctx):
    v = float(_num(args[0], "math::log", 1))
    base = float(_num(args[1], "math::log", 2))
    if v == 0.0:
        return float("-inf")
    try:
        return math.log(v, base)
    except (ValueError, ZeroDivisionError):
        return float("nan")


@register("math::pow")
def _pow(args, ctx):
    from surrealdb_tpu_torch.exec.operators import pow_

    return pow_(args[0], args[1])


@register("math::max")
def _mmax(args, ctx):
    a = _num_elems(args[0], "math::max")
    return max(a, key=sort_key) if a else float("-inf")


@register("math::min")
def _mmin(args, ctx):
    a = _num_elems(args[0], "math::min")
    return min(a, key=sort_key) if a else float("inf")


@register("math::sum")
def _sum(args, ctx):
    total = 0
    for x in _arr(args[0], "math::sum", 1):
        if isinstance(x, bool) or not isinstance(x, (int, float, Decimal)):
            continue
        if isinstance(x, Decimal) and not isinstance(total, Decimal):
            total = Decimal(str(total))
        total = total + x
    return total


@register("math::product")
def _product(args, ctx):
    total = 1
    for x in _arr(args[0], "math::product", 1):
        if isinstance(x, bool) or not isinstance(x, (int, float, Decimal)):
            continue
        total = total * x
    return total


@register("math::mean")
def _mean(args, ctx):
    ns = _nums(args[0], "math::mean", keep=True)
    if not ns:
        return float("nan")
    # try_float_div semantics: int sum / int count stays int when exact
    # (reference fnc/util/math/mean — view rolling means surface this)
    from surrealdb_tpu_torch.exec.operators import float_div

    return float_div(sum(ns), len(ns))


@register("math::median")
def _median(args, ctx):
    ns = sorted(_nums(args[0], "math::median"))
    if not ns:
        return NONE
    n = len(ns)
    if n % 2:
        return float(ns[n // 2])
    return (ns[n // 2 - 1] + ns[n // 2]) / 2


@register("math::mode")
def _mode(args, ctx):
    ns = _nums(args[0], "math::mode")
    if not ns:
        return float("nan")
    from collections import Counter

    c = Counter(ns)
    best = max(c.items(), key=lambda kv: (kv[1], kv[0]))
    v = best[0]
    return int(v) if v == int(v) else v


@register("math::variance")
def _variance(args, ctx):
    ns = _nums(args[0], "math::variance")
    if len(ns) < 2:
        return float("nan")
    m = sum(ns) / len(ns)
    return sum((x - m) ** 2 for x in ns) / (len(ns) - 1)


@register("math::stddev")
def _stddev(args, ctx):
    v = _variance(args, ctx)
    return math.sqrt(v) if not math.isnan(v) else v


@register("math::spread")
def _spread(args, ctx):
    ns = _nums(args[0], "math::spread", keep=True)
    if not ns:
        return float("nan")
    from surrealdb_tpu_torch.exec.operators import sub

    return sub(max(ns), min(ns))


@register("math::percentile")
def _percentile(args, ctx):
    ns = sorted(_nums(args[0], "math::percentile"))
    p = float(_num(args[1], "math::percentile", 2))
    if not ns or p < 0.0 or p > 100.0:
        return float("nan")
    if len(ns) == 1:
        return ns[0]
    rank = (p / 100.0) * (len(ns) - 1)
    lo = int(math.floor(rank))
    hi = int(math.ceil(rank))
    if lo == hi:
        return ns[lo]
    return ns[lo] + (ns[hi] - ns[lo]) * (rank - lo)


@register("math::nearestrank")
def _nearestrank(args, ctx):
    ns = sorted(_nums(args[0], "math::nearestrank", keep=True))
    p = float(_num(args[1], "math::nearestrank", 2))
    if not ns:
        return float("nan")
    rank = int(math.ceil((p / 100.0) * len(ns)))
    rank = max(1, min(rank, len(ns)))
    return ns[rank - 1]


@register("math::interquartile")
def _interquartile(args, ctx):
    return _percentile([args[0], 75], ctx) - _percentile([args[0], 25], ctx)


@register("math::midhinge")
def _midhinge(args, ctx):
    return (_percentile([args[0], 75], ctx) + _percentile([args[0], 25], ctx)) / 2


@register("math::trimean")
def _trimean(args, ctx):
    return (
        _percentile([args[0], 25], ctx)
        + 2 * _percentile([args[0], 50], ctx)
        + _percentile([args[0], 75], ctx)
    ) / 4


@register("math::top")
def _top(args, ctx):
    n = int(_num(args[1], "math::top", 2))
    if n < 1:
        raise SdbError("Incorrect arguments for function math::top(). The second argument must be an integer greater than 0.")
    a = _num_elems(args[0], "math::top")
    # min-heap of the k largest (Reverse ordering), reference heap layout
    h = _RustHeap(lambda x, y: sort_key(x) < sort_key(y))
    for i, v in enumerate(a):
        h.push(v)
        if i >= n:
            h.pop()
    return h.a


@register("math::bottom")
def _bottom(args, ctx):
    n = int(_num(args[1], "math::bottom", 2))
    if n < 1:
        raise SdbError("Incorrect arguments for function math::bottom(). The second argument must be an integer greater than 0.")
    a = _num_elems(args[0], "math::bottom")
    h = _RustHeap(lambda x, y: sort_key(x) > sort_key(y))
    for i, v in enumerate(a):
        h.push(v)
        if i >= n:
            h.pop()
    return h.a
