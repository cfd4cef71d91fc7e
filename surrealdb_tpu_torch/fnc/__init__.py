"""Builtin function library (reference: core/src/fnc/, 14.9k LoC).

Registry maps "family::name" -> callable(args, ctx). The vector:: family's
batched forms live in surrealdb_tpu_torch.ops (CUDA); the scalar forms here are the
per-row fallback the executor uses outside index scans.
"""

from __future__ import annotations

import hashlib
import math
import random as _random
import secrets
from decimal import Decimal

from surrealdb_tpu_torch.err import NotPorted, SdbError
from surrealdb_tpu_torch.val import (
    NONE,
    Closure,
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
    sort_key,
    value_cmp,
    value_eq,
)

FUNCS: dict = {}
ARITY: dict = {}  # name -> (lo, hi|None) or (lo1, lo2) exact alternatives
_NUM = (int, float, Decimal)


class ArgError(Exception):
    """Wrong-typed argument; formatted with the function name by the
    dispatcher (reference fnc/args.rs: 'Argument {idx} was the wrong
    type. Expected `{kind}` but found `{value}`')."""

    def __init__(self, idx, kind, value):
        self.idx = idx
        self.kind = kind
        self.value = value


def register(name, arity=None):
    def deco(fn):
        FUNCS[name] = fn
        if arity is not None:
            ARITY[name] = arity
        return fn

    return deco


def _arity_msg(spec) -> str:
    lo, hi = spec
    if hi is None:
        return f"Expected {lo} or more arguments"
    if lo == hi:
        if lo == 0:
            return "Expected no arguments"
        if lo == 1:
            return "Expected 1 argument"
        return f"Expected {lo} arguments"
    return f"Expected {lo} to {hi} arguments"


def check_args(name: str, args: list):
    spec = ARITY.get(name)
    if spec is None:
        return
    lo, hi = spec
    if len(args) < lo or (hi is not None and len(args) > hi):
        raise SdbError(
            f"Incorrect arguments for function {name}(). {_arity_msg(spec)}"
        )


def _num(v, fname=None, idx=1):
    if isinstance(v, bool) or not isinstance(v, _NUM):
        raise ArgError(idx, "number", v)
    return v


def _int(v, fname=None, idx=1):
    from decimal import Decimal as _D

    if isinstance(v, bool) or not isinstance(v, int):
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, _D) and v == v.to_integral_value():
            return int(v)
        raise ArgError(idx, "int", v)
    return v


def _arr(v, fname=None, idx=1):
    if not isinstance(v, list):
        raise ArgError(idx, "array", v)
    return v


def _str(v, fname=None, idx=1):
    if not isinstance(v, str):
        raise ArgError(idx, "string", v)
    return v


def _f(v):
    return float(v)


# ---------------------------------------------------------------------------
# dispatch entry points
# ---------------------------------------------------------------------------


def call_function(node, ctx):
    """Evaluate a FunctionCall AST node."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    name = node.name.lower()
    if name.startswith("fn::"):
        return call_custom(node.name[4:], [evaluate(a, ctx) for a in node.args], ctx)
    if name.startswith("mod::"):
        raise NotPorted(f"function {node.name}() is not ported "
                        f"(module functions)")
    if name.startswith("ml::"):
        caps = getattr(ctx.ds, "capabilities", None)
        if caps is None or not caps.allows_experimental("ml"):
            # the reference's default build compiles without the `ml`
            # feature: the language suite expects this exact error
            raise SdbError(
                "Problem with machine learning computation. "
                "Machine learning computation is not enabled."
            )
        from surrealdb_tpu_torch.ml import compute_model

        version = getattr(node, "version", None)
        if not version:
            raise SdbError(
                f"Incorrect arguments for function {name}(). "
                f"A model version is required: {name}<1.0.0>(...)"
            )
        # model names are case-sensitive (unlike builtin fn paths)
        return compute_model(
            node.name[4:], version,
            [evaluate(a, ctx) for a in node.args], ctx,
        )
    if name == "__future__":
        # futures evaluate lazily; this build evaluates at read time
        return evaluate(node.args[0], ctx)
    if name == "__point__":
        a = evaluate(node.args[0], ctx)
        b = evaluate(node.args[1], ctx)
        return Geometry("Point", (float(a), float(b)))
    fn = FUNCS.get(name)
    if fn is None:
        raise SdbError(f"The function '{node.name}' does not exist")
    caps = getattr(ctx.ds, "capabilities", None)
    if caps is not None and not caps.allows_function(name):
        raise SdbError(f"Function '{name}' is not allowed to be executed")
    args = [evaluate(a, ctx) for a in node.args]
    return invoke(name, fn, args, ctx)


def invoke(name, fn, args, ctx):
    check_args(name, args)
    try:
        return fn(args, ctx)
    except ArgError as e:
        from surrealdb_tpu_torch.val import render as _render

        raise SdbError(
            f"Incorrect arguments for function {name}(). Argument {e.idx} "
            f"was the wrong type. Expected `{e.kind}` but found `{_render(e.value)}`"
        )
    except IndexError:
        spec = ARITY.get(name)
        if spec is not None:
            raise SdbError(
                f"Incorrect arguments for function {name}(). {_arity_msg(spec)}"
            )
        raise SdbError(
            f"Incorrect arguments for function {name}(). Not enough arguments"
        )


def call_custom(name, args, ctx):
    """fn::name(...) — user-defined function from the catalog."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import FunctionDef
    from surrealdb_tpu_torch.exec.coerce import coerce
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.err import ReturnException

    ns, db = ctx.need_ns_db()
    fd = ctx.txn.get_val(K.fc_def(ns, db, name))
    if not isinstance(fd, FunctionDef):
        raise SdbError(f"The function 'fn::{name}' does not exist")
    # PERMISSIONS gate record/anonymous sessions (reference fnc/mod.rs
    # checks the function permission before invocation)
    if getattr(ctx.session, "auth_level", "owner") in ("record", "none"):
        perm = getattr(fd, "permissions", True)
        # no PERMISSIONS clause defaults to FULL (reference define/function)
        allowed = perm is True or perm is None
        if perm not in (True, False, None):
            from surrealdb_tpu_torch.val import is_truthy

            # the clause evaluates with row permissions disabled, like
            # table PERMISSIONS (reference new_with_perms(false)); real
            # evaluation errors propagate rather than read as denials
            c0 = ctx.child()
            c0.vars["auth"] = getattr(ctx.session, "rid", None) or NONE
            c0._in_perm_check = True
            allowed = is_truthy(evaluate(perm, c0))
        if not allowed:
            raise SdbError(
                f"You don't have permission to run the fn::{name} function"
            )
    # arity: trailing option<>/any params are optional (reference fnc
    # custom: custom_optional_args.surql — a middle optional still makes
    # every later position mandatory)
    total = len(fd.args)
    required = total
    for _pname, pkind in reversed(fd.args):
        if pkind is not None and getattr(pkind, "name", None) in (
                "option", "any"):
            required -= 1
        else:
            break
    if len(args) > total or len(args) < required:
        if required == total:
            expects = (
                f"{total} argument" if total == 1 else f"{total} arguments"
            )
        else:
            expects = f"{required} to {total} arguments"
        raise SdbError(
            f"Incorrect arguments for function fn::{name}(). "
            f"The function expects {expects}."
        )
    c = ctx.child()
    for i, (pname, pkind) in enumerate(fd.args):
        v = args[i] if i < len(args) else NONE
        if pkind is not None:
            try:
                v = coerce(v, pkind)
            except SdbError as e:
                raise SdbError(
                    f"Incorrect arguments for function fn::{name}(). "
                    f"Failed to coerce argument `${pname}`: {e}"
                )
        c.vars[pname] = v
    try:
        out = evaluate(fd.block, c)
    except ReturnException as r:
        out = r.value
    except Exception as e:
        from surrealdb_tpu_torch.err import BreakException, ContinueException

        if isinstance(e, (BreakException, ContinueException)):
            raise SdbError(
                "Invalid control flow statement, break or continue "
                "statement found outside of loop."
            )
        raise
    if fd.returns is not None:
        try:
            out = coerce(out, fd.returns)
        except SdbError as e:
            raise SdbError(
                f"Couldn't coerce return value from function `fn::{name}`: {e}"
            )
    return out


from surrealdb_tpu_torch.val import SSet as _SSet  # noqa: E402

from surrealdb_tpu_torch.val import File as _File  # noqa: E402

_METHOD_FAMILIES = [
    (_File, "file"),
    (_SSet, "set"),
    (list, "array"),
    (str, "string"),
    (dict, "object"),
    (RecordId, "record"),
    ((bytes, bytearray), "bytes"),
    (Duration, "duration"),
    (Datetime, "time"),
    (Geometry, "geo"),
    ((int, float, Decimal), "math"),
    (Uuid, "string"),
    (Range, "range"),
    (Closure, "function"),
]


_METHOD_ALIASES = {
    # reference exec/function/method.rs register_alias
    "every": "all", "includes": "any", "some": "any",
    "index_of": "find_index",
}


def method_call(val, name, args, ctx):
    """value.method(args) — resolve to family::method(val, ...)."""
    name = name.lower()
    name = _METHOD_ALIASES.get(name, name)
    candidates = []
    for typ, fam in _METHOD_FAMILIES:
        if isinstance(val, typ):
            candidates.append(f"{fam}::{name}")
            if "_" in name:
                # nested families: .distance_damerau_levenshtein() ->
                # string::distance::damerau_levenshtein, .semver_inc_major()
                # -> string::semver::inc::major (reference method
                # registration maps leading '_'s to submodules)
                candidates.append(f"{fam}::{name.replace('_', '::', 1)}")
                candidates.append(f"{fam}::{name.replace('_', '::', 2)}")
            break
    candidates += [f"type::{name}", f"value::{name}", name]
    if "_" in name:
        # bare namespaced methods: .vector_add() -> vector::add
        candidates.append(name.replace("_", "::", 1))
        candidates.append(name.replace("_", "::", 2))
    if name == "type_of":
        candidates.insert(0, "type::of")
    # .is_string() style -> type::is::string
    if name.startswith("is_"):
        candidates.insert(0, f"type::is::{name[3:]}")
    if name.startswith("to_"):
        candidates.insert(0, f"type::{name[3:]}")
    for cand in candidates:
        fn = FUNCS.get(cand)
        if fn is not None:
            return invoke(cand, fn, [val] + args, ctx)
    # ranges materialize to arrays for array methods: (0..10).map(...)
    if isinstance(val, Range):
        try:
            items = list(val.iter_ints())
        except TypeError:
            items = None
        if items is not None:
            fn = FUNCS.get(f"array::{name}")
            if fn is not None:
                return invoke(f"array::{name}", fn, [items] + args, ctx)
    if isinstance(val, _SSet):
        fn = FUNCS.get(f"array::{name}")
        if fn is not None:
            out = invoke(f"array::{name}", fn, [list(val)] + args, ctx)
            return _SSet(out) if isinstance(out, list) else out
    # chained custom function: .fn::foo()
    raise SdbError(f"The method '{name}' does not exist for {render(val)}")


# ---------------------------------------------------------------------------
# count / not / sleep / rand
# ---------------------------------------------------------------------------


@register("count")
def _count(args, ctx):
    if not args:
        return 1
    v = args[0]
    if isinstance(v, list):
        return len(v)
    from surrealdb_tpu_torch.val import Range as _Rng, SSet as _SS

    if isinstance(v, _SS):
        return len(v)
    # every other value counts by truthiness — a Range is NOT expanded
    # (reference fnc count.rs: only Array/Set have cardinality)
    return 1 if is_truthy(v) else 0


@register("not")
def _not(args, ctx):
    return not is_truthy(args[0])


@register("sleep")
def _sleep(args, ctx):
    import time as _t

    d = args[0]
    if isinstance(d, Duration):
        _t.sleep(min(d.to_seconds(), 30))
    return NONE


@register("rand")
def _rand(args, ctx):
    return _random.random()


@register("rand::bool")
def _rand_bool(args, ctx):
    return _random.random() < 0.5


@register("rand::enum")
def _rand_enum(args, ctx):
    if len(args) == 1 and isinstance(args[0], list):
        return _random.choice(args[0]) if args[0] else NONE
    return _random.choice(args) if args else NONE


@register("rand::float")
def _rand_float(args, ctx):
    if len(args) == 2:
        return _random.uniform(_f(args[0]), _f(args[1]))
    return _random.random()


@register("rand::guid")
def _rand_guid(args, ctx):
    n = args[0] if args else 20
    return "".join(_random.choices("0123456789abcdefghijklmnopqrstuvwxyz", k=int(n)))


@register("rand::int")
def _rand_int(args, ctx):
    if len(args) == 1:
        raise SdbError(
            "Incorrect arguments for function rand::int(). Expected 0 or "
            "2 arguments"
        )
    if len(args) == 2:
        lo = _int(args[0], "rand::int", 1)
        hi = _int(args[1], "rand::int", 2)
        if lo > hi:
            lo, hi = hi, lo
        return _random.randint(lo, hi)
    return _random.randint(-(2**63), 2**63 - 1)


@register("rand::string")
def _rand_string(args, ctx):
    import string as _s

    chars = _s.ascii_letters + _s.digits
    if len(args) == 2:
        lo = _int(args[0], "rand::string", 1)
        hi = _int(args[1], "rand::string", 2)
        if lo > hi:
            raise SdbError(
                "Incorrect arguments for function rand::string(). "
                "Lowerbound of number of characters must be less then "
                "the upperbound."
            )
        n = _random.randint(lo, hi)
    elif len(args) == 1:
        n = _int(args[0], "rand::string", 1)
    else:
        n = 32
    if n > 65536:
        raise SdbError(
            "Incorrect arguments for function rand::string(). Number of "
            "characters must not exceed 65536."
        )
    return "".join(_random.choices(chars, k=max(n, 0)))


@register("rand::time")
def _rand_time(args, ctx):
    import datetime as _dt

    def secs(v, i):
        if isinstance(v, Datetime):
            return v.epoch_ns() // 10**9
        return _int(v, "rand::time", i)

    if len(args) == 2:
        lo, hi = secs(args[0], 1), secs(args[1], 2)
        if lo > hi:
            lo, hi = hi, lo
    else:
        # reference default spans years 0000-9999
        lo, hi = -62167219200, 253402300799
    s2 = _random.randint(lo, hi)
    return Datetime(_dt.datetime.fromtimestamp(s2, _dt.timezone.utc))


@register("rand::uuid")
def _rand_uuid(args, ctx):
    return Uuid.new_v4()


@register("rand::uuid::v4")
def _rand_uuid4(args, ctx):
    return Uuid.new_v4()


@register("rand::uuid::v7", arity=(0, 1))
def _rand_uuid7(args, ctx):
    if args and isinstance(args[0], Datetime):
        import os as _os
        import uuid as _uuid

        ts = args[0].epoch_ns() // 1_000_000
        b = bytearray(ts.to_bytes(6, "big") + _os.urandom(10))
        b[6] = (b[6] & 0x0F) | 0x70
        b[8] = (b[8] & 0x3F) | 0x80
        return Uuid(_uuid.UUID(bytes=bytes(b)))
    return Uuid.new_v7()


@register("rand::duration", arity=(0, 2))
def _rand_duration(args, ctx):
    from surrealdb_tpu_torch.val import Duration as _D

    if len(args) == 2:
        for i, a in enumerate(args):
            if not isinstance(a, _D):
                raise ArgError(i + 1, "duration", a)
        lo, hi = args[0].ns, args[1].ns
    else:
        lo, hi = 0, 10**12
    return _D(_random.randint(min(lo, hi), max(lo, hi)))


@register("rand::id", arity=(0, 2))
def _rand_id(args, ctx):
    """rand::id() / rand::id(len) / rand::id(lo, hi) (reference fnc/rand.rs:85)."""
    if len(args) == 2:
        lo, hi = _int(args[0], idx=1), _int(args[1], idx=2)
        if lo > hi:
            lo, hi = hi, lo
        n = _random.randint(lo, min(hi, 64))
    elif len(args) == 1:
        n = min(_int(args[0], idx=1), 64)
    else:
        n = 20
    return "".join(
        _random.choices("0123456789abcdefghijklmnopqrstuvwxyz", k=max(n, 0))
    )


@register("rand::ulid")
def _rand_ulid(args, ctx):
    from surrealdb_tpu_torch.exec.eval import generate_record_key

    if args and isinstance(args[0], Datetime):
        import os as _os

        t = args[0].epoch_ns() // 1_000_000
        rand = int.from_bytes(_os.urandom(10), "big")
        alph = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"
        out = []
        for shift in range(45, -5, -5):
            out.append(alph[(t >> shift) & 31])
        for shift in range(75, -5, -5):
            out.append(alph[(rand >> shift) & 31])
        return "".join(out)
    return generate_record_key("__gen_ulid__")


# family modules register themselves on import
from surrealdb_tpu_torch.fnc import (  # noqa: E402,F401
    array_fns,
    misc_fns,
    math_fns,
    string_fns,
    time_fns,
    type_fns,
    vector_fns,
)

# underscore aliases: family::is_X / family::from_X mirror family::is::X /
# family::from::X (both spellings exist in the reference surface)
for _pname in list(FUNCS):
    if "::is::" in _pname:
        FUNCS[_pname.replace("::is::", "::is_")] = FUNCS[_pname]
    if "::from::" in _pname:
        FUNCS[_pname.replace("::from::", "::from_")] = FUNCS[_pname]

# arity table (reference fnc signatures; (lo, hi) with hi=None = unbounded)
ARITY.update({
    "count": (0, 1), "not": (1, 1), "sleep": (1, 1), "rand": (0, 0),
    # array
    "array::add": (2, 2), "array::all": (1, 2), "array::any": (1, 2),
    "array::append": (2, 2), "array::at": (2, 2),
    "array::boolean_and": (2, 2), "array::boolean_or": (2, 2),
    "array::boolean_xor": (2, 2), "array::boolean_not": (1, 1),
    "array::clump": (2, 2), "array::combine": (2, 2),
    "array::complement": (2, 2), "array::concat": (0, None),
    "array::difference": (2, 2), "array::distinct": (1, 1),
    "array::fill": (2, 4), "array::filter": (2, 2),
    "array::filter_index": (2, 2), "array::find": (2, 2),
    "array::find_index": (2, 2), "array::first": (1, 1),
    "array::flatten": (1, 1), "array::fold": (3, 3), "array::group": (1, 1),
    "array::insert": (2, 3), "array::intersect": (2, 2),
    "array::is_empty": (1, 1), "array::join": (2, 2), "array::last": (1, 1),
    "array::len": (1, 1), "array::logical_and": (2, 2),
    "array::logical_or": (2, 2), "array::logical_xor": (2, 2),
    "array::map": (2, 2), "array::matches": (2, 2), "array::max": (1, 1),
    "array::min": (1, 1), "array::pop": (1, 1), "array::prepend": (2, 2),
    "array::push": (2, 2), "array::range": (1, 2), "array::reduce": (2, 2),
    "array::remove": (2, 2), "array::repeat": (2, 2),
    "array::reverse": (1, 1), "array::shuffle": (1, 1),
    "array::slice": (1, 3), "array::sort": (1, 2),
    "array::sort::asc": (1, 1), "array::sort::desc": (1, 1),
    "array::swap": (3, 3), "array::transpose": (1, 1),
    "array::union": (2, 2), "array::windows": (2, 2),
    # set
    "set::add": (2, 2), "set::complement": (2, 2), "set::contains": (2, 2),
    "set::difference": (2, 2), "set::intersect": (2, 2), "set::len": (1, 1),
    "set::union": (2, 2),
    # string
    "string::contains": (2, 2), "string::ends_with": (2, 2),
    "string::len": (1, 1), "string::lowercase": (1, 1),
    "string::matches": (2, 2), "string::repeat": (2, 2),
    "string::replace": (3, 3), "string::reverse": (1, 1),
    "string::slice": (1, 3), "string::slug": (1, 1),
    "string::split": (2, 2), "string::starts_with": (2, 2),
    "string::trim": (1, 1), "string::uppercase": (1, 1),
    "string::words": (1, 1),
    "string::distance::hamming": (2, 2),
    "string::distance::levenshtein": (2, 2),
    "string::distance::damerau_levenshtein": (2, 2),
    "string::similarity::fuzzy": (2, 2), "string::similarity::jaro": (2, 2),
    "string::similarity::jaro_winkler": (2, 2),
    "string::similarity::smithwaterman": (2, 2),
    # math
    "math::abs": (1, 1), "math::acos": (1, 1), "math::asin": (1, 1),
    "math::atan": (1, 1), "math::ceil": (1, 1), "math::cos": (1, 1),
    "math::fixed": (2, 2), "math::floor": (1, 1), "math::ln": (1, 1),
    "math::log": (2, 2), "math::log10": (1, 1), "math::log2": (1, 1),
    "math::max": (1, 1), "math::mean": (1, 1), "math::median": (1, 1),
    "math::min": (1, 1), "math::mode": (1, 1), "math::pow": (2, 2),
    "math::product": (1, 1), "math::round": (1, 1), "math::sign": (1, 1),
    "math::sin": (1, 1), "math::sqrt": (1, 1), "math::stddev": (1, 1),
    "math::sum": (1, 1), "math::tan": (1, 1), "math::variance": (1, 1),
    "math::spread": (1, 1), "math::percentile": (2, 2),
    "math::nearestrank": (2, 2), "math::top": (2, 2), "math::bottom": (2, 2),
    "math::interquartile": (1, 1), "math::midhinge": (1, 1),
    "math::trimean": (1, 1), "math::clamp": (3, 3), "math::lerp": (3, 3),
    "math::lerpangle": (3, 3), "math::deg2rad": (1, 1),
    "math::rad2deg": (1, 1),
    # time / duration
    "time::now": (0, 0), "time::floor": (2, 2), "time::ceil": (2, 2),
    "time::round": (2, 2), "time::group": (2, 2), "time::format": (2, 2),
    # type
    "type::bool": (1, 1), "type::datetime": (1, 1), "type::decimal": (1, 1),
    "type::duration": (1, 1), "type::float": (1, 1), "type::int": (1, 1),
    "type::number": (1, 1), "type::string": (1, 1), "type::table": (1, 1),
    "type::record": (1, 2), "type::uuid": (1, 1),
    "type::point": (1, 2), "type::field": (1, 1), "type::fields": (1, 1),
    "type::range": (1, 1), "type::array": (1, 1), "type::bytes": (1, 1),
    # vector
    "vector::add": (2, 2), "vector::subtract": (2, 2),
    "vector::multiply": (2, 2), "vector::divide": (2, 2),
    "vector::cross": (2, 2), "vector::dot": (2, 2), "vector::scale": (2, 2),
    "vector::magnitude": (1, 1), "vector::normalize": (1, 1),
    "vector::project": (2, 2), "vector::angle": (2, 2),
    "vector::distance::euclidean": (2, 2),
    "vector::distance::manhattan": (2, 2),
    "vector::distance::chebyshev": (2, 2),
    "vector::distance::hamming": (2, 2),
    "vector::distance::minkowski": (3, 3),
    "vector::distance::knn": (0, 1),
    "vector::similarity::cosine": (2, 2),
    "vector::similarity::jaccard": (2, 2),
    "vector::similarity::pearson": (2, 2),
    "vector::similarity::spearman": (2, 2),
    # crypto / parse / encoding
    "crypto::md5": (1, 1), "crypto::sha1": (1, 1), "crypto::sha256": (1, 1),
    "crypto::sha512": (1, 1),
    "parse::email::host": (1, 1), "parse::email::user": (1, 1),
    "encoding::base64::encode": (1, 2), "encoding::base64::decode": (1, 1),
    # rand
    "rand::bool": (0, 0), "rand::float": (0, 2), "rand::guid": (0, 2),
    "rand::int": (0, 2), "rand::string": (0, 2), "rand::time": (0, 2),
    "rand::uuid": (0, 1), "rand::ulid": (0, 1), "rand::enum": (1, None),
    # record
    "record::exists": (1, 1), "record::id": (1, 1), "record::tb": (1, 1),
    "record::table": (1, 1), "record::refs": (1, 3),
})
