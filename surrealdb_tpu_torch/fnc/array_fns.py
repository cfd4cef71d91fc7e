"""array:: and set:: functions (reference: core/src/fnc/array.rs)."""

from __future__ import annotations

import random as _random

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _arr, _num, register
from surrealdb_tpu_torch.val import (
    NONE,
    Closure,
    Range,
    is_truthy,
    sort_key,
    value_cmp,
    value_eq,
)


def _call(clo, args, ctx):
    from surrealdb_tpu_torch.exec.eval import call_closure

    if not isinstance(clo, Closure):
        raise SdbError("Expected a closure argument")
    return call_closure(clo, args, ctx)


def _dedup(items):
    out = []
    for x in items:
        if not any(value_eq(x, y) for y in out):
            out.append(x)
    return out


@register("array::add")
def _add(args, ctx):
    a = _arr(args[0], "array::add", 1)[:]
    v = args[1]
    vs = v if isinstance(v, list) else [v]
    for x in vs:
        if not any(value_eq(x, y) for y in a):
            a.append(x)
    return a


@register("array::all")
def _all(args, ctx):
    a = _arr(args[0], "array::all", 1)
    if len(args) > 1:
        if isinstance(args[1], Closure):
            return all(is_truthy(_call(args[1], [x], ctx)) for x in a)
        return all(value_eq(x, args[1]) for x in a)
    return all(is_truthy(x) for x in a)


@register("array::any")
def _any(args, ctx):
    a = _arr(args[0], "array::any", 1)
    if len(args) > 1:
        if isinstance(args[1], Closure):
            return any(is_truthy(_call(args[1], [x], ctx)) for x in a)
        return any(value_eq(x, args[1]) for x in a)
    return any(is_truthy(x) for x in a)


@register("array::append")
def _append(args, ctx):
    return _arr(args[0], "array::append", 1)[:] + [args[1]]


@register("array::at")
def _at(args, ctx):
    from surrealdb_tpu_torch.fnc import _int

    a = _arr(args[0], "array::at", 1)
    i = _int(args[1], "array::at", 2)
    if -len(a) <= i < len(a):
        return a[i]
    return NONE


@register("array::boolean_and")
def _band(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    ga = a + [NONE] * (n - len(a))
    gb = b + [NONE] * (n - len(b))
    return [is_truthy(x) and is_truthy(y) for x, y in zip(ga, gb)]


@register("array::boolean_or")
def _bor(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    ga = a + [NONE] * (n - len(a))
    gb = b + [NONE] * (n - len(b))
    return [is_truthy(x) or is_truthy(y) for x, y in zip(ga, gb)]


@register("array::boolean_xor")
def _bxor(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    ga = a + [NONE] * (n - len(a))
    gb = b + [NONE] * (n - len(b))
    return [is_truthy(x) != is_truthy(y) for x, y in zip(ga, gb)]


@register("array::boolean_not")
def _bnot(args, ctx):
    return [not is_truthy(x) for x in _arr(args[0], "f", 1)]


@register("array::clump")
def _clump(args, ctx):
    a = _arr(args[0], "array::clump", 1)
    n = int(_num(args[1], "array::clump", 2))
    if n < 1:
        raise SdbError("Incorrect arguments for function array::clump(). The second argument must be an integer greater than 0")
    return [a[i : i + n] for i in range(0, len(a), n)]


@register("array::combine")
def _combine(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    return [[x, y] for x in a for y in b]


@register("array::complement")
def _complement(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    return [x for x in a if not any(value_eq(x, y) for y in b)]


@register("array::concat")
def _concat(args, ctx):
    out = []
    for i, a in enumerate(args):
        out.extend(_arr(a, "array::concat", i + 1))
    return out


@register("array::difference")
def _difference(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    out = [x for x in a if not any(value_eq(x, y) for y in b)]
    out += [y for y in b if not any(value_eq(y, x) for x in a)]
    return out


@register("array::distinct")
def _distinct(args, ctx):
    return _dedup(_arr(args[0], "array::distinct", 1))


@register("array::fill")
def _fill(args, ctx):
    a = _arr(args[0], "array::fill", 1)[:]
    v = args[1]
    n = len(a)
    beg = int(args[2]) if len(args) > 2 else 0
    end = int(args[3]) if len(args) > 3 else n
    if beg < 0:
        beg += n
    if len(args) > 3 and end < 0:
        end += n
    for i in range(max(beg, 0), min(end, n)):
        a[i] = v
    return a


@register("array::filter")
def _filter(args, ctx):
    a = _arr(args[0], "array::filter", 1)
    p = args[1]
    if isinstance(p, Closure):
        return [x for x in a if is_truthy(_call(p, [x], ctx))]
    return [x for x in a if value_eq(x, p)]


@register("array::filter_index")
def _filter_index(args, ctx):
    a = _arr(args[0], "array::filter_index", 1)
    p = args[1]
    if isinstance(p, Closure):
        return [i for i, x in enumerate(a) if is_truthy(_call(p, [x], ctx))]
    return [i for i, x in enumerate(a) if value_eq(x, p)]


@register("array::find")
def _find(args, ctx):
    a = _arr(args[0], "array::find", 1)
    p = args[1]
    if isinstance(p, Closure):
        for x in a:
            if is_truthy(_call(p, [x], ctx)):
                return x
        return NONE
    for x in a:
        if value_eq(x, p):
            return x
    return NONE


@register("array::find_index")
def _find_index(args, ctx):
    a = _arr(args[0], "array::find_index", 1)
    p = args[1]
    for i, x in enumerate(a):
        if isinstance(p, Closure):
            if is_truthy(_call(p, [x], ctx)):
                return i
        elif value_eq(x, p):
            return i
    return NONE


@register("array::first")
def _first(args, ctx):
    a = _arr(args[0], "array::first", 1)
    return a[0] if a else NONE


@register("array::flatten")
def _flatten(args, ctx):
    out = []
    for x in _arr(args[0], "array::flatten", 1):
        if isinstance(x, list):
            out.extend(x)
        else:
            out.append(x)
    return out


@register("array::fold")
def _fold(args, ctx):
    a = _arr(args[0], "array::fold", 1)
    acc = args[1]
    clo = args[2]
    for i, x in enumerate(a):
        acc = _call(clo, [acc, x, i], ctx)
    return acc


@register("array::group")
def _group(args, ctx):
    out = []
    for x in _arr(args[0], "array::group", 1):
        items = x if isinstance(x, list) else [x]
        for y in items:
            if not any(value_eq(y, z) for z in out):
                out.append(y)
    return out


@register("array::insert")
def _insert(args, ctx):
    a = _arr(args[0], "array::insert", 1)[:]
    v = args[1]
    i = int(args[2]) if len(args) > 2 else len(a)
    if i < 0:
        i += len(a)
    if not 0 <= i <= len(a):
        return a  # out-of-bounds insert is a no-op (reference)
    a.insert(i, v)
    return a


@register("array::intersect")
def _intersect(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    return [x for x in _dedup(a) if any(value_eq(x, y) for y in b)]


@register("array::is_empty")
def _is_empty(args, ctx):
    return len(_arr(args[0], "array::is_empty", 1)) == 0


@register("array::join")
def _join(args, ctx):
    from surrealdb_tpu_torch.exec.operators import to_string

    sep = args[1] if len(args) > 1 else ""
    return sep.join(to_string(x) for x in _arr(args[0], "array::join", 1))


@register("array::last")
def _last(args, ctx):
    a = _arr(args[0], "array::last", 1)
    return a[-1] if a else NONE


@register("array::len")
def _len(args, ctx):
    return len(_arr(args[0], "array::len", 1))


@register("array::logical_and")
def _land(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        out.append(y if is_truthy(x) else x)
    return out


@register("array::logical_or")
def _lor(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        out.append(x if is_truthy(x) else y)
    return out


@register("array::logical_xor")
def _lxor(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    n = max(len(a), len(b))
    out = []
    # xor: exactly one truthy -> that value; both truthy -> false;
    # both falsy -> the first operand's value; a missing side yields
    # the other side's value (reference logical_xor)
    for i in range(n):
        if i >= len(a):
            y = b[i]
            out.append(y if is_truthy(y) else None)
            continue
        if i >= len(b):
            out.append(a[i])
            continue
        x, y = a[i], b[i]
        tx, ty = is_truthy(x), is_truthy(y)
        if tx and not ty:
            out.append(x)
        elif ty and not tx:
            out.append(y)
        elif tx and ty:
            out.append(False)
        else:
            out.append(x)
    return out


@register("array::map")
def _map(args, ctx):
    a = _arr(args[0], "array::map", 1)
    clo = args[1]
    return [_call(clo, [x, i], ctx) for i, x in enumerate(a)]


@register("array::matches")
def _matches(args, ctx):
    a = _arr(args[0], "array::matches", 1)
    return [value_eq(x, args[1]) for x in a]


@register("array::max")
def _max(args, ctx):
    a = _arr(args[0], "array::max", 1)
    return max(a, key=sort_key) if a else NONE


@register("array::min")
def _min(args, ctx):
    a = _arr(args[0], "array::min", 1)
    return min(a, key=sort_key) if a else NONE


@register("array::pop")
def _pop(args, ctx):
    a = _arr(args[0], "array::pop", 1)
    return a[-1] if a else NONE


@register("array::prepend")
def _prepend(args, ctx):
    return [args[1]] + _arr(args[0], "array::prepend", 1)


@register("array::push")
def _push(args, ctx):
    return _arr(args[0], "array::push", 1)[:] + [args[1]]


@register("array::range")
def _range(args, ctx):
    from surrealdb_tpu_torch.val import Range as _Rng

    if len(args) == 1 and isinstance(args[0], _Rng):
        r = args[0]
        if not isinstance(r.beg, int) or not isinstance(r.end, int) or \
                isinstance(r.beg, bool) or isinstance(r.end, bool):
            from surrealdb_tpu_torch.val import render as _r2

            raise SdbError(
                "Incorrect arguments for function array::range(). "
                "Argument 1 was the wrong type. Expected `range<int>` "
                f"but found `{_r2(r)}`"
            )
        beg = int(r.beg) + (0 if r.beg_incl else 1)
        end = int(r.end) + (1 if r.end_incl else 0)
        if end - beg > 1048576:
            raise SdbError(
                "Incorrect arguments for function array::range(). Output "
                "must not exceed 1048576 bytes."
            )
        return list(range(beg, end))
    beg = int(_num(args[0], "array::range", 1))
    end = int(_num(args[1], "array::range", 2))
    if end - beg > 1048576:
        raise SdbError(
            "Incorrect arguments for function array::range(). Output "
            "must not exceed 1048576 bytes."
        )
    return list(range(beg, end))


@register("array::reduce")
def _reduce(args, ctx):
    a = _arr(args[0], "array::reduce", 1)
    clo = args[1]
    if not a:
        return NONE
    acc = a[0]
    for i, x in enumerate(a[1:]):
        acc = _call(clo, [acc, x, i], ctx)
    return acc


@register("array::remove")
def _remove(args, ctx):
    a = _arr(args[0], "array::remove", 1)[:]
    i = int(_num(args[1], "array::remove", 2))
    if -len(a) <= i < len(a):
        a.pop(i)
    return a


@register("array::repeat")
def _repeat(args, ctx):
    n = int(_num(args[1], "array::repeat", 2))
    if n < 0:
        raise SdbError(
            "Incorrect arguments for function array::repeat(). Expected "
            "argument 2 to be a positive number"
        )
    if n > 1048576:
        raise SdbError(
            "Incorrect arguments for function array::repeat(). Output "
            "must not exceed 1048576 bytes."
        )
    return [args[0]] * n


@register("array::sequence")
def _sequence(args, ctx):
    if len(args) > 1:
        beg = int(_num(args[0], "array::sequence", 1))
        cnt = int(_num(args[1], "array::sequence", 2))
    else:
        beg = 0
        cnt = int(_num(args[0], "array::sequence", 1))
    if cnt <= 0:
        return []
    if cnt > 1048576:
        raise SdbError(
            "Incorrect arguments for function array::sequence(). Output "
            "must not exceed 1048576 bytes."
        )
    return list(range(beg, beg + cnt))


@register("array::reverse")
def _reverse(args, ctx):
    return list(reversed(_arr(args[0], "array::reverse", 1)))


@register("array::shuffle")
def _shuffle(args, ctx):
    a = _arr(args[0], "array::shuffle", 1)[:]
    _random.shuffle(a)
    return a


@register("array::slice")
def _slice(args, ctx):
    a = _arr(args[0], "array::slice", 1)
    if len(args) > 1 and isinstance(args[1], Range):
        # range syntax: slice(a, 1..4) / slice(a, 1..=4)
        rg = args[1]
        beg = int(rg.beg) if rg.beg is not NONE and rg.beg is not None else 0
        if rg.end is NONE or rg.end is None:
            return a[beg:]
        end = int(rg.end) + (1 if rg.end_incl else 0)
        return a[beg:end]
    beg = int(args[1]) if len(args) > 1 else 0
    n = int(args[2]) if len(args) > 2 else None
    if beg < 0:
        beg = max(len(a) + beg, 0)
    if beg > len(a):
        return []
    if n is None:
        return a[beg:]
    if n < 0:
        return a[beg : len(a) + n]
    return a[beg:n]


@register("array::sort")
def _sort(args, ctx):
    a = _arr(args[0], "array::sort", 1)[:]
    asc = True
    if len(args) > 1:
        v = args[1]
        if v is False or (isinstance(v, str) and v.lower() == "desc"):
            asc = False
    a.sort(key=sort_key, reverse=not asc)
    return a


@register("array::sort::asc")
def _sort_asc(args, ctx):
    return _sort([args[0]], ctx)


@register("array::sort::desc")
def _sort_desc(args, ctx):
    return _sort([args[0], False], ctx)


def _natural_key(s):
    """Numeric-aware segmentation: '11' sorts after '2'."""
    import re as _re

    return [
        (0, int(t)) if t.isdigit() else (1, t)
        for t in _re.split(r"(\d+)", s)
        if t != ""
    ]


def _lexical_fold(s):
    """Case/accent-insensitive collation (lexical_sort crate)."""
    import unicodedata

    return "".join(
        c for c in unicodedata.normalize("NFD", s.casefold())
        if not unicodedata.combining(c)
    )


def _sort_variant(args, ctx, keyfn, name):
    a = _arr(args[0], name, 1)[:]
    asc = True
    if len(args) > 1:
        v = args[1]
        if v is False or (isinstance(v, str) and v.lower() == "desc"):
            asc = False
    import functools

    from surrealdb_tpu_torch.val import value_cmp

    def cmp(x, y):
        # string pairs use the variant collation; any other pair falls
        # back to value order (reference natural_cmp partial_cmp)
        if isinstance(x, str) and isinstance(y, str):
            kx, ky = keyfn(x), keyfn(y)
            return -1 if kx < ky else (1 if kx > ky else 0)
        return value_cmp(x, y)

    a.sort(key=functools.cmp_to_key(cmp), reverse=not asc)
    return a


@register("array::sort_natural")
def _sort_natural(args, ctx):
    return _sort_variant(args, ctx, _natural_key, "array::sort_natural")


@register("array::sort_lexical")
def _sort_lexical(args, ctx):
    return _sort_variant(args, ctx, _lexical_fold, "array::sort_lexical")


@register("array::sort_natural_lexical")
def _sort_nl(args, ctx):
    return _sort_variant(
        args, ctx,
        lambda x: _natural_key(_lexical_fold(x)),
        "array::sort_natural_lexical",
    )


@register("array::swap")
def _swap(args, ctx):
    a = _arr(args[0], "array::swap", 1)[:]
    i, j = int(args[1]), int(args[2])
    n = len(a)
    i0, j0 = i, j
    if i < 0:
        i += n
    if j < 0:
        j += n
    if not 0 <= i < n:
        raise SdbError(
            "Incorrect arguments for function array::swap(). Argument 1 "
            f"is out of range. Expected a number between -{n} and {n}"
        )
    if not 0 <= j < n:
        raise SdbError(
            "Incorrect arguments for function array::swap(). Argument 2 "
            f"is out of range. Expected a number between -{n} and {n}"
        )
    a[i], a[j] = a[j], a[i]
    return a


@register("array::transpose")
def _transpose(args, ctx):
    a = _arr(args[0], "array::transpose", 1)
    if not a:
        return []
    n = max(len(x) if isinstance(x, list) else 1 for x in a)
    out = []
    for i in range(n):
        row = []
        for x in a:
            if isinstance(x, list):
                row.append(x[i] if i < len(x) else NONE)
            else:
                row.append(x if i == 0 else NONE)
        out.append(row)
    return out


@register("array::union")
def _union(args, ctx):
    a, b = _arr(args[0], "f", 1), _arr(args[1], "f", 2)
    return _dedup(a + b)


@register("array::windows")
def _windows(args, ctx):
    a = _arr(args[0], "array::windows", 1)
    n = int(_num(args[1], "array::windows", 2))
    if n < 1:
        raise SdbError("Incorrect arguments for function array::windows(). The second argument must be an integer greater than 0")
    return [a[i : i + n] for i in range(0, len(a) - n + 1)]


# ---------------------------------------------------------------------------
# set:: family — SSet in, SSet out where the reference returns a set
# (reference fnc/set.rs over val/set.rs BTreeSet)
# ---------------------------------------------------------------------------

from surrealdb_tpu_torch.fnc import ARITY, FUNCS as _F, ArgError  # noqa: E402
from surrealdb_tpu_torch.val import SSet  # noqa: E402


def _set(v, idx=1):
    if not isinstance(v, SSet):
        raise ArgError(idx, "set", v)
    return v


def _set_wrap(arr_name, returns_set=True, set_args=(1,), value_args=()):
    inner = _F[arr_name]

    def fn(args, ctx):
        conv = list(args)
        for i in set_args:
            if i <= len(conv):
                conv[i - 1] = list(_set(conv[i - 1], i))
        # second set/array arguments are accepted as arrays too — except
        # value positions (set::all's needle compares as a VALUE: a set
        # element that IS a set must equal a set, not a list)
        for i, v in enumerate(conv):
            if isinstance(v, SSet) and (i + 1) not in set_args                     and (i + 1) not in value_args:
                conv[i] = list(v)
        out = inner(conv, ctx)
        if returns_set and isinstance(out, list):
            return SSet(out)
        return out

    return fn


_SET_FNS = {
    # name -> (array impl, returns_set[, value-arg positions])
    "add": ("array::add", True), "all": ("array::all", False, (2,)),
    "any": ("array::any", False, (2,)), "at": ("array::at", False),
    "complement": ("array::complement", True),
    "difference": ("array::difference", True),
    "filter": ("array::filter", True),
    "find": ("array::find", False, (2,)),
    "first": ("array::first", False), "flatten": ("array::flatten", True),
    "fold": ("array::fold", False), "intersect": ("array::intersect", True),
    "is_empty": ("array::is_empty", False), "join": ("array::join", False),
    "last": ("array::last", False), "len": ("array::len", False),
    "map": ("array::map", True), "max": ("array::max", False),
    "min": ("array::min", False), "reduce": ("array::reduce", False),
    "remove": ("array::remove", True), "slice": ("array::slice", True),
    "union": ("array::union", True),
}

for _n, _spec in _SET_FNS.items():
    _impl, _ret = _spec[0], _spec[1]
    _vargs = _spec[2] if len(_spec) > 2 else ()
    _F[f"set::{_n}"] = _set_wrap(_impl, _ret, value_args=_vargs)
    if _impl in ARITY:
        ARITY[f"set::{_n}"] = ARITY[_impl]


def _set_contains(args, ctx):
    return args[1] in _set(args[0], 1)


_F["set::contains"] = _set_contains


def _set_insert(args, ctx):
    s = _set(args[0], 1)
    return SSet(s.items + [args[1]])


_F["set::insert"] = _set_insert


def _set_remove(args, ctx):
    """set::remove removes by VALUE (reference fnc/set.rs), unlike
    array::remove's index semantics; an array/set argument removes each
    of its members."""
    s = _set(args[0], 1)
    v = args[1]
    gone = list(v) if isinstance(v, (list, SSet)) else [v]
    return SSet([
        x for x in s.items if not any(value_eq(x, g) for g in gone)
    ])


_F["set::remove"] = _set_remove


def _set_flatten(args, ctx):
    s = _set(args[0], 1)
    out = []
    for x in s:
        if isinstance(x, (SSet, list)):
            out.extend(list(x))
        else:
            out.append(x)
    return SSet(out)


_F["set::flatten"] = _set_flatten
