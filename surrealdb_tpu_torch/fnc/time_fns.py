"""time:: and duration:: functions (reference: core/src/fnc/time.rs)."""

from __future__ import annotations

import datetime as _dt

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _arr, _num, register
from surrealdb_tpu_torch.val import NONE, Datetime, Duration, sort_key


def _dtm(v, fname) -> Datetime:
    if not isinstance(v, Datetime):
        raise SdbError(f"Incorrect arguments for function {fname}(). Expected a datetime")
    return v


@register("time::now")
def _now(args, ctx):
    return Datetime.now()


@register("time::day")
def _day(args, ctx):
    d = _dtm(args[0], "time::day") if args else Datetime.now()
    return d.dt.day


@register("time::hour")
def _hour(args, ctx):
    d = _dtm(args[0], "time::hour") if args else Datetime.now()
    return d.dt.hour

@register("time::minute")
def _minute(args, ctx):
    d = _dtm(args[0], "time::minute") if args else Datetime.now()
    return d.dt.minute


@register("time::second")
def _second(args, ctx):
    d = _dtm(args[0], "time::second") if args else Datetime.now()
    return d.dt.second


@register("time::month")
def _month(args, ctx):
    d = _dtm(args[0], "time::month") if args else Datetime.now()
    return d.dt.month


@register("time::year")
def _year(args, ctx):
    d = _dtm(args[0], "time::year") if args else Datetime.now()
    return d.year


@register("time::wday")
def _wday(args, ctx):
    d = _dtm(args[0], "time::wday") if args else Datetime.now()
    return d.dt.isoweekday()


@register("time::week")
def _week(args, ctx):
    d = _dtm(args[0], "time::week") if args else Datetime.now()
    return d.dt.isocalendar()[1]


@register("time::yday")
def _yday(args, ctx):
    d = _dtm(args[0], "time::yday") if args else Datetime.now()
    return d.dt.timetuple().tm_yday


@register("time::unix")
def _unix(args, ctx):
    d = _dtm(args[0], "time::unix") if args else Datetime.now()
    return d.epoch_ns() // 1_000_000_000


@register("time::micros")
def _micros(args, ctx):
    d = _dtm(args[0], "time::micros") if args else Datetime.now()
    return d.epoch_ns() // 1_000


@register("time::millis")
def _millis(args, ctx):
    d = _dtm(args[0], "time::millis") if args else Datetime.now()
    return d.epoch_ns() // 1_000_000


@register("time::nano")
def _nano(args, ctx):
    d = _dtm(args[0], "time::nano") if args else Datetime.now()
    return d.epoch_ns()


def _set_component(args, which, fname):
    d = _dtm(args[0], fname)
    v = int(args[1])
    if which == "year":
        # chrono's settable year range (MIN_UTC..=MAX_UTC years)
        if not -262143 <= v <= 262142:
            raise SdbError(f"Unable to set datetime to year {v}")
        try:
            return Datetime.from_parts(
                v, d.dt.month, d.dt.day, d.dt.hour, d.dt.minute,
                d.dt.second, d.ns_frac,
            )
        except ValueError:
            raise SdbError(f"Unable to set datetime to year {v}")
    if not 0 <= v < (1 << 32):
        # reference converts through u32 before chrono sees the value
        raise SdbError("out of range integral type conversion attempted")
    try:
        return Datetime(d.dt.replace(**{which: v}), d.ns_frac,
                        d.year_shift)
    except ValueError:
        raise SdbError(f"Unable to set datetime to {which} {v}")


for _comp in ("year", "month", "day", "hour", "minute", "second"):
    def _mk_set(comp):
        @register(f"time::set_{comp}", arity=(2, 2))
        def _f(args, ctx):
            return _set_component(args, comp, f"time::set_{comp}")

    _mk_set(_comp)


@register("time::set_nanosecond", arity=(2, 2))
def _set_nanosecond(args, ctx):
    """Replace the sub-second component (reference time.rs set_nanosecond:
    whole-second part kept, fraction replaced by `nanos`)."""
    d = _dtm(args[0], "time::set_nanosecond")
    v = int(args[1])
    if v < 0 or v >= (1 << 32):
        raise SdbError("out of range integral type conversion attempted")
    if v >= 1_000_000_000:
        raise SdbError(f"Unable to set datetime to nanosecond {v}")
    return Datetime(d.dt.replace(microsecond=0), v, d.year_shift)


@register("time::timezone")
def _timezone(args, ctx):
    return "UTC"


@register("time::max")
def _tmax(args, ctx):
    a = _arr(args[0], "time::max", 1)
    return max(a, key=sort_key) if a else NONE


@register("time::min")
def _tmin(args, ctx):
    a = _arr(args[0], "time::min", 1)
    return min(a, key=sort_key) if a else NONE


def _floor_to(d: Datetime, dur: Duration) -> Datetime:
    if dur.ns <= 0:
        raise SdbError("Incorrect arguments for function time::floor(). Expected a positive duration")
    ns = d.epoch_ns()
    f = (ns // dur.ns) * dur.ns
    # rebuild inside Python's year range, re-attaching the cycle shift
    # (shifted years would otherwise crash fromtimestamp)
    from surrealdb_tpu_torch.val import _GREGORIAN_CYCLE_NS

    f -= (d.year_shift // 400) * _GREGORIAN_CYCLE_NS
    secs, frac = divmod(f, 1_000_000_000)
    return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc),
                    frac, d.year_shift)


@register("time::floor")
def _floor(args, ctx):
    return _floor_to(_dtm(args[0], "time::floor"), args[1])


@register("time::ceil")
def _ceil(args, ctx):
    d = _dtm(args[0], "time::ceil")
    dur = args[1]
    f = _floor_to(d, dur)
    if f.epoch_ns() == d.epoch_ns():
        return f
    secs, frac = divmod(f.epoch_ns() + dur.ns, 1_000_000_000)
    return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac)


@register("time::round")
def _round(args, ctx):
    d = _dtm(args[0], "time::round")
    dur = args[1]
    f = _floor_to(d, dur)
    if d.epoch_ns() - f.epoch_ns() >= dur.ns / 2:
        secs, frac = divmod(f.epoch_ns() + dur.ns, 1_000_000_000)
        return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac)
    return f


@register("time::group")
def _group(args, ctx):
    d = _dtm(args[0], "time::group")
    unit = args[1]
    units = {
        "year": Duration.UNITS["y"], "month": None, "day": Duration.UNITS["d"],
        "hour": Duration.UNITS["h"], "minute": Duration.UNITS["m"],
        "second": Duration.UNITS["s"], "week": Duration.UNITS["w"],
    }
    if unit not in units:
        raise SdbError("Incorrect arguments for function time::group(). Expected a unit")
    if unit == "year":
        return Datetime.from_parts(d.year, 1, 1)
    if unit == "month":
        return Datetime.from_parts(d.year, d.dt.month, 1)
    return _floor_to(d, Duration(units[unit]))


# chrono strftime specifiers (reference uses chrono::format; Python's
# strftime silently passes unknown sequences through, chrono errors)
_CHRONO_SPECS = set("YCyqmbBhdeaAwuUWGgVjDxFvHkIlPpMSfRTXrZzstn%c+")


def _validate_chrono_fmt(fmt: str, fname: str):
    i, n = 0, len(fmt)
    while i < n:
        if fmt[i] != "%":
            i += 1
            continue
        i += 1
        if i < n and fmt[i] in "-_0":  # padding modifiers
            i += 1
        if i < n and fmt[i] == ".":
            i += 1
            if i < n and fmt[i] in "369":
                i += 1
        elif i < n and fmt[i] in "369" and i + 1 < n and fmt[i + 1] == "f":
            i += 1
        if i < n and fmt[i] == ":":
            while i < n and fmt[i] == ":":
                i += 1
            if i < n and fmt[i] == "z":
                i += 1
                continue
            i -= 1
        if i >= n or fmt[i] not in _CHRONO_SPECS:
            raise SdbError(
                f"Incorrect arguments for method {fname}(). `{fmt}` is "
                f"not a valid time formatting string"
            )
        i += 1


@register("time::format")
def _format(args, ctx):
    d = _dtm(args[0], "time::format")
    fmt = args[1]
    _validate_chrono_fmt(fmt, "time::format")
    if d.year_shift:
        # logical-year directives can't ride the shifted proxy datetime
        y = d.year
        fmt = (fmt.replace("%Y", str(y))
                  .replace("%y", f"{y % 100:02d}")
                  .replace("%C", str(y // 100)))
    return d.dt.strftime(fmt)


@register("time::is::leap_year")
def _leap(args, ctx):
    d = _dtm(args[0], "time::is::leap_year") if args else Datetime.now()
    y = d.year
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


def _from_epoch(v, scale):
    ns = int(v) * scale
    secs, frac = divmod(ns, 1_000_000_000)
    return Datetime(_dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac)


@register("time::from::nanos")
def _from_nanos(args, ctx):
    return _from_epoch(args[0], 1)


@register("time::from::micros")
def _from_micros(args, ctx):
    return _from_epoch(args[0], 1_000)


@register("time::from::millis")
def _from_millis(args, ctx):
    return _from_epoch(args[0], 1_000_000)


@register("time::from::secs")
def _from_secs(args, ctx):
    return _from_epoch(args[0], 1_000_000_000)


@register("time::from::unix")
def _from_unix(args, ctx):
    return _from_epoch(args[0], 1_000_000_000)


@register("time::from::ulid")
def _from_ulid(args, ctx):
    s = args[0]
    alph = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"
    t = 0
    for c in s[:10]:
        t = t * 32 + alph.index(c)
    return _from_epoch(t, 1_000_000)


@register("time::from::uuid")
def _from_uuid(args, ctx):
    u = args[0]
    b = u.u.bytes
    if (b[6] >> 4) == 7:
        ms = int.from_bytes(b[:6], "big")
        return _from_epoch(ms, 1_000_000)
    raise SdbError("Incorrect arguments for function time::from::uuid(). Expected a version 7 UUID")


# -- duration:: ----------------------------------------------------------------


def _dur(v, fname) -> Duration:
    if not isinstance(v, Duration):
        raise SdbError(f"Incorrect arguments for function {fname}(). Expected a duration")
    return v


_U64 = 1 << 64
_I64 = 1 << 63
_MAX_DUR_NS = (_U64 - 1) * 1_000_000_000 + 999_999_999


def _wrap_i64(v: int) -> int:
    """Reference getters cast through `as i64`: two's-complement wrap."""
    return ((v + _I64) % _U64) - _I64


for _name, _unit in (
    ("nanos", 1), ("micros", 1_000), ("millis", 1_000_000),
    ("secs", 1_000_000_000), ("mins", 60 * 1_000_000_000),
    ("hours", 3600 * 1_000_000_000), ("days", 86400 * 1_000_000_000),
    ("weeks", 7 * 86400 * 1_000_000_000), ("years", 365 * 86400 * 1_000_000_000),
):
    def _mk(unit, name):
        @register(f"duration::{name}")
        def _g(args, ctx):
            return _wrap_i64(_dur(args[0], f"duration::{name}").ns // unit)

        @register(f"duration::from::{name}")
        def _h(args, ctx):
            # argument coerces through u64 (negative ints wrap); the
            # resulting duration must fit u64 seconds
            v = int(args[0]) % _U64
            ns = v * unit
            if ns > _MAX_DUR_NS:
                raise SdbError(
                    f'Failed to compute: "duration::from_{name}({v})", as '
                    "the operation results in an arithmetic overflow."
                )
            return Duration(ns)

    _mk(_unit, _name)
