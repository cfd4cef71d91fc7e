"""Internal value model.

Mirrors the semantics of the reference's internal ``Value`` enum
(surrealdb core/src/val/mod.rs:73-94) — the closed set of
runtime values a SurrealQL program manipulates — but is designed as plain
Python data with a total order and a canonical SurrealQL rendering, so the
host-side executor stays simple and the numeric hot paths hand off to numpy
arrays at the index boundary.

Type order (for sorting & key encoding) follows the reference enum order:
None < Null < Bool < Number < String < Duration < Datetime < Uuid < Array
< Object < Geometry < Bytes < RecordId < File < Regex < Range < Closure.

Representation choices:
- NONE  -> the `NONE` singleton (absence of a value)
- NULL  -> Python ``None``
- Bool  -> Python ``bool``
- Number-> ``int`` | ``float`` | ``decimal.Decimal``
- String-> ``str``
- Array -> ``list``
- Object-> ``dict`` (insertion ordered; canonical render sorts keys)
- Bytes -> ``bytes``
- the rest are small classes below.
"""

from __future__ import annotations

import datetime as _dt
import math
import re as _re
import uuid as _uuid
from decimal import Decimal, ROUND_HALF_UP
from functools import total_ordering


# ---------------------------------------------------------------------------
# Sentinels
# ---------------------------------------------------------------------------


class _NoneType:
    """The SurrealQL NONE value (absence); distinct from NULL (Python None)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "NONE"

    def __bool__(self):
        return False

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


NONE = _NoneType()


# ---------------------------------------------------------------------------
# Scalar wrapper types
# ---------------------------------------------------------------------------


@total_ordering
class Duration:
    """A duration with nanosecond precision (reference: val/duration.rs).
    Max = u64::MAX seconds + 999_999_999 ns, like the reference's
    std::time::Duration backing store."""

    __slots__ = ("ns",)

    MAX_NS = 18446744073709551615 * 1_000_000_000 + 999_999_999

    UNITS = {
        "ns": 1,
        "us": 1_000,
        "µs": 1_000,
        "ms": 1_000_000,
        "s": 1_000_000_000,
        "m": 60 * 1_000_000_000,
        "h": 3600 * 1_000_000_000,
        "d": 86400 * 1_000_000_000,
        "w": 7 * 86400 * 1_000_000_000,
        "y": 365 * 86400 * 1_000_000_000,
    }

    def __init__(self, ns: int = 0):
        self.ns = int(ns)

    @classmethod
    def parse(cls, text: str) -> "Duration":
        total = 0
        for num, unit in _re.findall(r"(\d+)(ns|us|µs|ms|s|m|h|d|w|y)", text):
            total += int(num) * cls.UNITS[unit]
        return cls(total)

    def __eq__(self, other):
        return isinstance(other, Duration) and self.ns == other.ns

    def __lt__(self, other):
        return self.ns < other.ns

    def __hash__(self):
        return hash(("Duration", self.ns))

    def __add__(self, other):
        if isinstance(other, Duration):
            return Duration(self.ns + other.ns)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Duration):
            return Duration(max(self.ns - other.ns, 0))
        return NotImplemented

    def to_seconds(self) -> float:
        return self.ns / 1e9

    def __repr__(self):
        return f"Duration({self.render()})"

    def render(self) -> str:
        # Largest-unit-first canonical form, e.g. 1h30m  (duration.rs Display)
        if self.ns == 0:
            return "0ns"
        out = []
        rem = self.ns
        for unit in ("y", "w", "d", "h", "m", "s", "ms", "µs", "ns"):
            size = self.UNITS[unit]
            if rem >= size:
                n, rem = divmod(rem, size)
                out.append(f"{n}{unit}")
        return "".join(out)


# one 400-year Gregorian cycle (days are identical across cycles, so
# shifting by whole cycles preserves weekday, leap pattern, and calendar)
_GREGORIAN_CYCLE_NS = 146_097 * 86_400 * 1_000_000_000


@total_ordering
class Datetime:
    """UTC datetime with nanosecond precision. Years outside Python's
    1..9999 (the reference's chrono supports ±262143) are carried via
    `year_shift` — a multiple of 400 added to dt.year to obtain the
    logical year; 400-year shifts keep the calendar identical."""

    __slots__ = ("dt", "ns_frac", "year_shift")

    def __init__(self, dt: _dt.datetime, ns_frac: int | None = None,
                 year_shift: int = 0):
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        else:
            dt = dt.astimezone(_dt.timezone.utc)
        # ns_frac: full sub-second nanoseconds (supersedes dt.microsecond)
        self.ns_frac = dt.microsecond * 1000 if ns_frac is None else ns_frac
        self.dt = dt.replace(microsecond=0)
        self.year_shift = year_shift

    @classmethod
    def now(cls) -> "Datetime":
        return cls(_dt.datetime.now(_dt.timezone.utc))

    @staticmethod
    def _shift_year(y: int):
        """Map a logical year into Python's range; returns (year, shift)."""
        if 1 <= y <= 9999:
            return y, 0
        # land in [2000, 2399] — same leap/weekday cycle
        k = (2000 - y) // 400 if y < 2000 else -((y - 2399) // 400)
        yp = y + 400 * k
        if not 1 <= yp <= 9999:
            yp = y % 400 + 2000
            k = (yp - y) // 400
        return yp, -400 * k

    @classmethod
    def from_parts(cls, y, mo, d, h=0, mi=0, s=0, ns=0, tzinfo=None) -> "Datetime":
        yp, shift = cls._shift_year(y)
        return cls(
            _dt.datetime(yp, mo, d, h, mi, s,
                         tzinfo=tzinfo or _dt.timezone.utc),
            ns, shift,
        )

    @classmethod
    def parse(cls, text: str) -> "Datetime":
        m = _re.match(
            r"^([+-]?\d{4,6})-(\d{2})-(\d{2})"
            r"(?:[Tt ](\d{2}):(\d{2}):(\d{2})(?:\.(\d+))?"
            r"(Z|z|[+-]\d{2}:\d{2})?)?$",
            text,
        )
        if not m:
            raise ValueError(f"invalid datetime: {text!r}")
        y, mo, d = int(m[1]), int(m[2]), int(m[3])
        h = int(m[4] or 0)
        mi = int(m[5] or 0)
        s = int(m[6] or 0)
        digits = m[7] or ""
        if len(digits) <= 9:
            ns = int(digits.ljust(9, "0")) if digits else 0
        else:
            # sub-nanosecond digits round half-up (chrono parse behavior)
            ns = int(digits[:9])
            if digits[9] >= "5":
                ns += 1
        extra_s = 0
        if ns >= 1_000_000_000:
            ns -= 1_000_000_000
            extra_s = 1
        tz = m[8]
        if tz and tz not in ("Z", "z"):
            sign = 1 if tz[0] == "+" else -1
            off = _dt.timedelta(hours=int(tz[1:3]), minutes=int(tz[4:6])) * sign
            tzinfo = _dt.timezone(off)
        else:
            tzinfo = _dt.timezone.utc
        out = cls.from_parts(y, mo, d, h, mi, s, ns, tzinfo)
        if extra_s:
            out = cls(out.dt + _dt.timedelta(seconds=1), out.ns_frac,
                      out.year_shift)
        return out

    @property
    def year(self) -> int:
        return self.dt.year + self.year_shift

    def epoch_ns(self) -> int:
        base = int(self.dt.timestamp()) * 1_000_000_000 + self.ns_frac
        return base + (self.year_shift // 400) * _GREGORIAN_CYCLE_NS

    def __eq__(self, other):
        return isinstance(other, Datetime) and self.epoch_ns() == other.epoch_ns()

    def __lt__(self, other):
        return self.epoch_ns() < other.epoch_ns()

    def __hash__(self):
        return hash(("Datetime", self.epoch_ns()))

    def __repr__(self):
        return f"Datetime({self.render()})"

    def render(self) -> str:
        y = self.year
        if 0 <= y <= 9999:
            ys = f"{y:04d}"
        else:
            ys = f"{y:+05d}"  # chrono renders out-of-range years signed
        base = ys + self.dt.strftime("-%m-%dT%H:%M:%S")
        if self.ns_frac:
            frac = f"{self.ns_frac:09d}".rstrip("0")
            # pad to 3/6/9 places like chrono's SecondsFormat::AutoSi
            for width in (3, 6, 9):
                if len(frac) <= width:
                    frac = frac.ljust(width, "0")
                    break
            base += f".{frac}"
        return base + "Z"


@total_ordering
class Uuid:
    __slots__ = ("u",)

    def __init__(self, u):
        self.u = u if isinstance(u, _uuid.UUID) else _uuid.UUID(str(u))

    @classmethod
    def new_v4(cls) -> "Uuid":
        return cls(_uuid.uuid4())

    @classmethod
    def new_v7(cls) -> "Uuid":
        # stdlib has no uuid7; construct per RFC 9562
        import os
        import time

        ts = time.time_ns() // 1_000_000
        rand = os.urandom(10)
        b = ts.to_bytes(6, "big") + rand
        b = bytearray(b)
        b[6] = (b[6] & 0x0F) | 0x70
        b[8] = (b[8] & 0x3F) | 0x80
        return cls(_uuid.UUID(bytes=bytes(b)))

    def __eq__(self, other):
        return isinstance(other, Uuid) and self.u == other.u

    def __lt__(self, other):
        return self.u.bytes < other.u.bytes

    def __hash__(self):
        return hash(("Uuid", self.u))

    def __repr__(self):
        return f"Uuid({self.u})"

    def render(self) -> str:
        return f"u'{self.u}'"


class Table:
    """A table name used as a value (e.g. `SELECT * FROM person` scans Table)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, other):
        return isinstance(other, Table) and self.name == other.name

    def __lt__(self, other):
        return self.name < other.name

    def __hash__(self):
        return hash(("Table", self.name))

    def __repr__(self):
        return f"Table({self.name})"


class RecordId:
    """A record pointer `table:id`. id may be int, str, Uuid, list or dict."""

    __slots__ = ("tb", "id")

    def __init__(self, tb: str, id):
        self.tb = tb
        self.id = id

    def __eq__(self, other):
        return (
            isinstance(other, RecordId)
            and self.tb == other.tb
            and value_eq(self.id, other.id)
        )

    def __hash__(self):
        return hash(("RecordId", self.tb, _hashable(self.id)))

    def __repr__(self):
        return f"RecordId({self.render()})"

    def render(self) -> str:
        return f"{escape_rid_table(self.tb)}:{render_record_id_key(self.id)}"


class Range:
    """A value range beg..end (inclusive flags per bound)."""

    __slots__ = ("beg", "end", "beg_incl", "end_incl")

    def __init__(self, beg=NONE, end=NONE, beg_incl=True, end_incl=False):
        self.beg = beg  # NONE = unbounded
        self.end = end
        self.beg_incl = beg_incl
        self.end_incl = end_incl

    def __eq__(self, other):
        return (
            isinstance(other, Range)
            and value_eq(self.beg, other.beg)
            and value_eq(self.end, other.end)
            and self.beg_incl == other.beg_incl
            and self.end_incl == other.end_incl
        )

    def __hash__(self):
        return hash(("Range", _hashable(self.beg), _hashable(self.end),
                     self.beg_incl, self.end_incl))

    def __repr__(self):
        return f"Range({self.render()})"

    def render(self) -> str:
        beg = "" if self.beg is NONE else render(self.beg)
        end = "" if self.end is NONE else render(self.end)
        op = ".." if self.end_incl is False else "..="
        if not self.beg_incl:
            beg += ">"
        return f"{beg}{op}{end}"

    def iter_ints(self):
        """Iterate when both bounds are ints (FOR loops, array ranges)."""
        if not isinstance(self.beg, int) or not isinstance(self.end, int):
            raise TypeError("range bounds are not integers")
        beg = self.beg if self.beg_incl else self.beg + 1
        end = self.end + 1 if self.end_incl else self.end
        return range(beg, end)


class SSet:
    """A set value: unique elements in sorted order (reference val/set.rs
    wraps a BTreeSet). Renders `{1, 2, 3}`; empty renders `{,}`."""

    __slots__ = ("items",)

    def __init__(self, items=None):
        out = []
        for x in items or []:
            lo, hi = 0, len(out)
            # binary insert by value order, skipping duplicates
            # lint: deadline(binary search: hi-lo halves every iteration)
            while lo < hi:
                mid = (lo + hi) // 2
                c = value_cmp(out[mid], x)
                if c < 0:
                    lo = mid + 1
                elif c > 0:
                    hi = mid
                else:
                    lo = -1
                    break
            if lo >= 0:
                out.insert(lo, x)
        self.items = out

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __contains__(self, v):
        return any(value_eq(x, v) for x in self.items)

    def __eq__(self, other):
        return (
            isinstance(other, SSet)
            and len(self.items) == len(other.items)
            and all(value_eq(a, b) for a, b in zip(self.items, other.items))
        )

    def __hash__(self):
        return hash(("SSet", tuple(_hashable(x) for x in self.items)))

    def __repr__(self):
        return f"SSet({self.items!r})"

    def render(self) -> str:
        if not self.items:
            return "{,}"
        if len(self.items) == 1:
            # single-element sets keep the trailing comma (they would
            # otherwise parse back as blocks/objects)
            return "{" + render(self.items[0]) + ",}"
        return "{" + ", ".join(render(x) for x in self.items) + "}"


class Geometry:
    """GeoJSON-style geometry. kind in {Point, LineString, Polygon, MultiPoint,
    MultiLineString, MultiPolygon, GeometryCollection}; coords nested tuples."""

    __slots__ = ("kind", "coords")

    def __init__(self, kind: str, coords):
        self.kind = kind
        self.coords = coords

    def __eq__(self, other):
        return (
            isinstance(other, Geometry)
            and self.kind == other.kind
            and self.coords == other.coords
        )

    def __hash__(self):
        return hash(("Geometry", self.kind, _hashable(self.coords)))

    def __repr__(self):
        return f"Geometry({self.render()})"

    def to_object(self) -> dict:
        if self.kind == "GeometryCollection":
            return {
                "type": self.kind,
                "geometries": [g.to_object() for g in self.coords],
            }
        return {"type": self.kind, "coordinates": _coords_list(self.coords)}

    def render(self) -> str:
        if self.kind == "Point":
            def c(v):
                # geometry coordinates render without the float suffix
                f = float(v)
                if not math.isfinite(f):
                    return repr(f)
                return str(int(f)) if f == int(f) else repr(f)

            x, y = self.coords
            return f"({c(x)}, {c(y)})"
        return render(self.to_object())


def _coords_list(c):
    if isinstance(c, (list, tuple)):
        return [_coords_list(x) for x in c]
    return c


class Regex:
    __slots__ = ("pattern", "rx")

    def __init__(self, pattern: str):
        self.pattern = pattern
        self.rx = _re.compile(pattern)

    def __eq__(self, other):
        return isinstance(other, Regex) and self.pattern == other.pattern

    def __hash__(self):
        return hash(("Regex", self.pattern))

    def render(self) -> str:
        return f"/{self.pattern}/"


class File:
    """A file pointer into an object-storage bucket: f"bucket:/path"."""

    __slots__ = ("bucket", "key")

    def __init__(self, bucket: str, key: str):
        self.bucket = bucket
        self.key = key

    def __eq__(self, other):
        return (
            isinstance(other, File)
            and self.bucket == other.bucket
            and self.key == other.key
        )

    def __hash__(self):
        return hash(("File", self.bucket, self.key))

    def render(self) -> str:
        return f"f\"{self.bucket}:{self.key}\""


class Closure:
    """An anonymous function value |$a: int| -> int { $a + 1 }."""

    __slots__ = ("params", "body", "returns")

    def __init__(self, params, body, returns=None):
        self.params = params  # [(name, kind|None)]
        self.body = body  # expr AST
        self.returns = returns

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def render(self) -> str:
        from surrealdb_tpu_torch.exec.coerce import kind_name
        from surrealdb_tpu_torch.exec.render_def import _expr_sql
        from surrealdb_tpu_torch.expr.ast import BlockExpr, Subquery

        ps = ", ".join(
            f"${n}: " + (kind_name(k) if k is not None else "any")
            for n, k in self.params
        )
        ret = f" -> {kind_name(self.returns)}" if self.returns else ""
        body = self.body
        if isinstance(body, Subquery) and isinstance(body.stmt, BlockExpr):
            body = body.stmt
        return f"|{ps}|{ret} {_expr_sql(body)}"


# ---------------------------------------------------------------------------
# Type ordering / comparison
# ---------------------------------------------------------------------------

_NUM = (int, float, Decimal)


def type_rank(v) -> int:
    if v is NONE:
        return 0
    if v is None:
        return 1
    if isinstance(v, bool):
        return 2
    if isinstance(v, _NUM):
        return 3
    if isinstance(v, str):
        return 4
    if isinstance(v, Duration):
        return 5
    if isinstance(v, Datetime):
        return 6
    if isinstance(v, Uuid):
        return 7
    if isinstance(v, list):
        return 8
    if isinstance(v, SSet):
        return 9
    if isinstance(v, dict):
        return 10
    if isinstance(v, Geometry):
        return 11
    if isinstance(v, (bytes, bytearray)):
        return 12
    if isinstance(v, Table):
        return 13
    if isinstance(v, RecordId):
        return 14
    if isinstance(v, File):
        return 15
    if isinstance(v, Regex):
        return 16
    if isinstance(v, Range):
        return 17
    if isinstance(v, Closure):
        return 18
    return 19


def _num_cmp(a, b) -> int:
    # ints/floats/decimals compare numerically; NaN sorts last among numbers
    try:
        af = float(a) if isinstance(a, Decimal) else a
        bf = float(b) if isinstance(b, Decimal) else b
        a_nan = isinstance(af, float) and math.isnan(af)
        b_nan = isinstance(bf, float) and math.isnan(bf)
        if a_nan and b_nan:
            return 0
        if a_nan:
            return 1
        if b_nan:
            return -1
        if af < bf:
            return -1
        if af > bf:
            return 1
        return 0
    except (TypeError, OverflowError):
        return 0


_GEOM_RANK = {
    "Point": 0, "LineString": 1, "Polygon": 2, "MultiPoint": 3,
    "MultiLineString": 4, "MultiPolygon": 5, "GeometryCollection": 6,
}


def _geom_flat(g):
    """Flattened (x, y) sequence (reference val/geometry.rs PartialOrd);
    polygons chain interior rings before the exterior."""
    k, c = g.kind, g.coords
    if k == "Point":
        return [tuple(c)]
    if k in ("LineString", "MultiPoint"):
        return [tuple(p) for p in c]
    if k == "Polygon":
        rings = list(c[1:]) + list(c[:1])
        return [tuple(p) for ring in rings for p in ring]
    if k == "MultiLineString":
        return [tuple(p) for line in c for p in line]
    if k == "MultiPolygon":
        out = []
        for poly in c:
            rings = list(poly[1:]) + list(poly[:1])
            out.extend(tuple(p) for ring in rings for p in ring)
        return out
    return []


def _geometry_cmp(a, b) -> int:
    ra, rb = _GEOM_RANK.get(a.kind, 7), _GEOM_RANK.get(b.kind, 7)
    if ra != rb:
        return -1 if ra < rb else 1
    if a.kind == "GeometryCollection":
        for x, y in zip(a.coords, b.coords):
            c = _geometry_cmp(x, y)
            if c:
                return c
        return (len(a.coords) > len(b.coords)) - (
            len(a.coords) < len(b.coords))
    fa, fb = _geom_flat(a), _geom_flat(b)
    return (fa > fb) - (fa < fb)


def value_cmp(a, b) -> int:
    """Total order over all values (reference val/mod.rs Ord)."""
    ra, rb = type_rank(a), type_rank(b)
    if ra != rb:
        return -1 if ra < rb else 1
    if ra == 0 or ra == 1:
        return 0
    if ra == 2:
        return (a > b) - (a < b)
    if ra == 3:
        return _num_cmp(a, b)
    if ra == 4:
        return (a > b) - (a < b)
    if ra in (5, 6, 7):
        return (a > b) - (a < b)
    if ra == 8:
        for x, y in zip(a, b):
            c = value_cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    if ra == 9:
        for x, y in zip(a.items, b.items):
            c = value_cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    if ra == 10:
        ka, kb = sorted(a.keys()), sorted(b.keys())
        for x, y in zip(ka, kb):
            if x != y:
                return -1 if x < y else 1
            c = value_cmp(a[x], b[y])
            if c:
                return c
        return (len(ka) > len(kb)) - (len(ka) < len(kb))
    if ra == 11:
        return _geometry_cmp(a, b)
    if ra == 12:
        return (bytes(a) > bytes(b)) - (bytes(a) < bytes(b))
    if ra == 13:
        return (a.name > b.name) - (a.name < b.name)
    if ra == 14:
        if a.tb != b.tb:
            return -1 if a.tb < b.tb else 1
        return record_id_key_cmp(a.id, b.id)
    if ra == 15:
        ka, kb = (a.bucket, a.key), (b.bucket, b.key)
        return (ka > kb) - (ka < kb)
    if ra == 16:
        return (a.pattern > b.pattern) - (a.pattern < b.pattern)
    if ra == 17:
        c = value_cmp(a.beg, b.beg)
        if c:
            return c
        return value_cmp(a.end, b.end)
    return 0


def record_id_key_cmp(a, b) -> int:
    """Record-id key ordering: Number < String < Uuid < Array < Object < Range."""

    def rk(v):
        if isinstance(v, bool):
            return 5
        if isinstance(v, _NUM):
            return 0
        if isinstance(v, str):
            return 1
        if isinstance(v, Uuid):
            return 2
        if isinstance(v, list):
            return 3
        if isinstance(v, dict):
            return 4
        if isinstance(v, Range):
            return 6
        return 7

    ra, rb = rk(a), rk(b)
    if ra != rb:
        return -1 if ra < rb else 1
    return value_cmp(a, b)


def value_eq(a, b) -> bool:
    """SurrealQL equality: same type-ish and equal (int 1 == float 1.0)."""
    ra, rb = type_rank(a), type_rank(b)
    if ra != rb:
        return False
    return value_cmp(a, b) == 0


class _SortKey:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return value_cmp(self.v, other.v) < 0

    def __eq__(self, other):
        return value_cmp(self.v, other.v) == 0


def sort_key(v) -> "_SortKey":
    return _SortKey(v)


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, SSet):
        return ("SSet", tuple(_hashable(x) for x in v.items))
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (bytearray,)):
        return bytes(v)
    return v


def hashable(v):
    """A hashable token for a value (GROUP BY / DISTINCT keys)."""
    return (type_rank(v), _hashable(v))


# ---------------------------------------------------------------------------
# Truthiness (reference val/mod.rs is_truthy)
# ---------------------------------------------------------------------------


def is_truthy(v) -> bool:
    if v is NONE or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, _NUM):
        return v != 0
    if isinstance(v, str):
        return len(v) > 0
    if isinstance(v, (list, dict, SSet)):
        return len(v) > 0
    if isinstance(v, Duration):
        return v.ns != 0
    if isinstance(v, (bytes, bytearray)):
        return len(v) > 0
    if isinstance(v, (Uuid, RecordId, Geometry, Datetime, Closure, SSet)):
        # sets follow array truthiness; the rest are truthy by identity
        if isinstance(v, SSet):
            return len(v) > 0
        return True
    # everything else (Regex, Range, File, Table, ...) is not truthy
    return False


# ---------------------------------------------------------------------------
# Rendering (canonical SurrealQL text; reference ToSql impls)
# ---------------------------------------------------------------------------

_IDENT_RX = _re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_DIGITS_RX = _re.compile(r"^[0-9]+$")


def escape_object_key(s: str) -> str:
    """Object keys: bare when alphanumeric (digits-only included), else
    double-quoted (reference object key escaping)."""
    if _re.match(r"^[A-Za-z0-9_]+$", s):
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


# identifiers that could be mistaken for keywords get backticks
# (reference syn/lexer/keywords.rs RESERVED_KEYWORD)
RESERVED_IDENTS = {
    "ALTER", "BEGIN", "BREAK", "CANCEL", "COMMIT", "CONTINUE", "CREATE",
    "DEFINE", "DELETE", "FOR", "IF", "INFO", "INSERT", "KILL", "LIVE",
    "OPTION", "REBUILD", "RETURN", "RELATE", "REMOVE", "SELECT", "LET",
    "SHOW", "SLEEP", "THROW", "UPDATE", "UPSERT", "USE", "DIFF", "RAND",
    "NONE", "NULL", "AFTER", "BEFORE", "VALUE", "BY", "ALL", "TRUE",
    "FALSE", "WHERE", "TABLE", "TB", "SEQUENCE", "FUNCTION",
}


def _escape_ident_body(s: str) -> str:
    # control characters render as backslash sequences inside backticks
    # (reference EscapeIdent)
    return (
        s.replace("\\", "\\\\").replace("`", "\\`").replace("\0", "\\0")
        .replace("\t", "\\t").replace("\n", "\\n").replace("\f", "\\f")
        .replace("\r", "\\r")
    )


def escape_ident(s: str) -> str:
    if _IDENT_RX.match(s) and s.upper() not in RESERVED_IDENTS:
        return s
    return "`" + _escape_ident_body(s) + "`"


def escape_rid_table(s: str) -> str:
    """Record-id table rendering (reference EscapeRid): escapes only
    lexically-invalid idents — keywords stay bare since the `tb:key`
    position is unambiguous."""
    if _IDENT_RX.match(s):
        return s
    return "`" + _escape_ident_body(s) + "`"


def render_record_id_key(id) -> str:
    if isinstance(id, bool):
        return "`true`" if id else "`false`"
    if isinstance(id, int):
        return str(id)
    if isinstance(id, str):
        if _IDENT_RX.match(id) and not _DIGITS_RX.match(id):
            return id
        if _re.match(r"^[A-Za-z0-9_]+$", id) and not _DIGITS_RX.match(id):
            return id  # alnum keys (ulids) render bare
        return "`" + id.replace("\\", "\\\\").replace("`", "\\`") + "`"
    if isinstance(id, Uuid):
        return f"u'{id.u}'"
    if isinstance(id, (list, dict, Range)):
        return render(id)
    return render(id)


def _render_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v)}f"
    return f"{repr(v)}f"


def escape_string(s: str) -> str:
    return "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'"


def render(v, pretty: bool = False, _depth: int = 0) -> str:
    """Canonical SurrealQL rendering of a value (matches reference ToSql)."""
    if v is NONE:
        return "NONE"
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _render_float(v)
    if isinstance(v, Decimal):
        return f"{v}dec"
    if isinstance(v, str):
        return escape_string(v)
    if isinstance(v, Duration):
        return v.render()
    if isinstance(v, Datetime):
        return f"d'{v.render()}'"
    if isinstance(v, Uuid):
        return v.render()
    if isinstance(v, list):
        inner = ", ".join(render(x, pretty, _depth + 1) for x in v)
        return f"[{inner}]"
    if isinstance(v, SSet):
        return v.render()
    if isinstance(v, dict):
        if not v:
            return "{  }"
        # object keys render in sorted order (reference objects are BTreeMaps)
        items = ", ".join(
            f"{escape_object_key(k)}: {render(v[k], pretty, _depth + 1)}"
            for k in sorted(v.keys())
        )
        return "{ " + items + " }"
    if isinstance(v, Geometry):
        return v.render()
    if isinstance(v, (bytes, bytearray)):
        return "b\"" + bytes(v).hex().upper() + "\""
    if isinstance(v, Table):
        return escape_ident(v.name)
    if isinstance(v, RecordId):
        return v.render()
    if isinstance(v, (Range, Regex, File, Closure)):
        return v.render()
    raise TypeError(f"cannot render value of type {type(v)!r}")


# ---------------------------------------------------------------------------
# JSON conversion (for the RPC surface)
# ---------------------------------------------------------------------------


def to_json(v):
    if v is NONE:
        return None
    if v is None:
        return None
    if isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v
    if isinstance(v, Decimal):
        return str(v)
    if isinstance(v, Duration):
        return v.render()
    if isinstance(v, Datetime):
        return v.render()
    if isinstance(v, Uuid):
        return str(v.u)
    if isinstance(v, list):
        return [to_json(x) for x in v]
    if isinstance(v, SSet):
        return [to_json(x) for x in v.items]
    if isinstance(v, dict):
        return {k: to_json(x) for k, x in v.items()}
    if isinstance(v, Geometry):
        return to_json(v.to_object())
    if isinstance(v, (bytes, bytearray)):
        import base64

        return base64.b64encode(bytes(v)).decode()
    if isinstance(v, RecordId):
        return v.render()
    if isinstance(v, Table):
        return v.name
    if isinstance(v, (Range, Regex, File)):
        return v.render()
    if isinstance(v, Closure):
        return None
    raise TypeError(f"cannot jsonify {type(v)!r}")


_FLAT_TYPES = frozenset((float, int, str, bool))


def copy_value(v):
    """Deep copy of a value (records are mutated in the doc pipeline).
    Exact-type fast paths: scalar elements copy by shallow list/dict copy
    without a per-element call (numeric vectors are the hot shape)."""
    t = type(v)
    if t is list:
        out = list(v)
        if len(out) > 8 and set(map(type, out)) <= _FLAT_TYPES:
            return out  # a vector of scalars: one C-level type scan
        for i, x in enumerate(out):
            if isinstance(x, (list, dict, SSet)):
                out[i] = copy_value(x)
        return out
    if t is dict:
        out = dict(v)
        for k, x in out.items():
            if isinstance(x, (list, dict, SSet)):
                out[k] = copy_value(x)
        return out
    if isinstance(v, SSet):
        s = SSet.__new__(SSet)
        s.items = [copy_value(x) for x in v.items]
        return s
    if isinstance(v, list):  # subclasses — generic path
        return [copy_value(x) for x in v]
    if isinstance(v, dict):
        return {k: copy_value(x) for k, x in v.items()}
    return v
