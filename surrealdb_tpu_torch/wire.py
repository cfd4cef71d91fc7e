"""CBOR wire format for SurrealQL values (reference: core/src/rpc/format/
cbor/convert.rs — same semantic tag numbers, so SDKs speaking the
reference's CBOR dialect interoperate).

Pure-Python RFC 8949 subset codec plus the SurrealDB value tags:
NONE(6), Table(7), RecordId(8), string-decimal(10), custom-datetime(12
[secs, nanos]), custom-duration(14 [secs, nanos]), UUID(37 bytes),
Range(49) with Included(50)/Excluded(51) bounds, File(55), Set(56), and
the geometry tags 88-94.
"""

from __future__ import annotations

import functools
import struct
from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import (
    NONE,
    Datetime,
    Duration,
    File,
    Geometry,
    Range,
    RecordId,
    SSet,
    Table,
    Uuid,
)


class CborError(SdbError, ValueError):
    """Malformed or unencodable CBOR: a statement error, and a
    ValueError to a caller decoding bytes by hand."""

TAG_NONE = 6
TAG_TABLE = 7
TAG_RECORDID = 8
TAG_STRING_DECIMAL = 10
TAG_CUSTOM_DATETIME = 12
TAG_STRING_DURATION = 13
TAG_CUSTOM_DURATION = 14
TAG_SPEC_UUID = 37
TAG_RANGE = 49
TAG_BOUND_INCLUDED = 50
TAG_BOUND_EXCLUDED = 51
TAG_FILE = 55
TAG_SET = 56
TAG_GEOMETRY = {
    "Point": 88, "LineString": 89, "Polygon": 90, "MultiPoint": 91,
    "MultiLineString": 92, "MultiPolygon": 93, "GeometryCollection": 94,
}
_GEO_BY_TAG = {v: k for k, v in TAG_GEOMETRY.items()}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _head(out: bytearray, major: int, arg: int):
    if arg < 24:
        out.append((major << 5) | arg)
    elif arg < 0x100:
        out.append((major << 5) | 24)
        out.append(arg)
    elif arg < 0x10000:
        out.append((major << 5) | 25)
        out += arg.to_bytes(2, "big")
    elif arg < 0x100000000:
        out.append((major << 5) | 26)
        out += arg.to_bytes(4, "big")
    else:
        out.append((major << 5) | 27)
        out += arg.to_bytes(8, "big")


# a float array (an embedding) packs and unpacks in one struct call: the
# same bytes as item by item (0xFB + the big-endian double, each item)
_FLOAT_RUN_MIN = 16


@functools.lru_cache(maxsize=64)
def _float_run(n: int) -> struct.Struct:
    return struct.Struct(">" + "Bd" * n)


def _encode(v, out: bytearray):
    if v is NONE:
        _head(out, 6, TAG_NONE)
        out.append(0xF6)  # null
        return
    if v is None:
        out.append(0xF6)
        return
    if isinstance(v, bool):
        out.append(0xF5 if v else 0xF4)
        return
    if isinstance(v, int):
        if v >= 0:
            _head(out, 0, v)
        else:
            _head(out, 1, -1 - v)
        return
    if isinstance(v, float):
        out.append(0xFB)
        out += struct.pack(">d", v)
        return
    if isinstance(v, Decimal):
        _head(out, 6, TAG_STRING_DECIMAL)
        _encode(str(v), out)
        return
    if isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, 3, len(b))
        out += b
        return
    if isinstance(v, (bytes, bytearray)):
        _head(out, 2, len(v))
        out += bytes(v)
        return
    if isinstance(v, Datetime):
        _head(out, 6, TAG_CUSTOM_DATETIME)
        total = v.epoch_ns()
        secs, nanos = divmod(total, 1_000_000_000)
        _encode([secs, nanos], out)
        return
    if isinstance(v, Duration):
        _head(out, 6, TAG_CUSTOM_DURATION)
        secs, nanos = divmod(v.ns, 1_000_000_000)
        _encode([secs, nanos], out)
        return
    if isinstance(v, Uuid):
        _head(out, 6, TAG_SPEC_UUID)
        _encode(v.u.bytes, out)
        return
    if isinstance(v, RecordId):
        _head(out, 6, TAG_RECORDID)
        _encode([v.tb, v.id], out)
        return
    if isinstance(v, Table):
        _head(out, 6, TAG_TABLE)
        _encode(v.name, out)
        return
    if isinstance(v, File):
        _head(out, 6, TAG_FILE)
        _encode([v.bucket, v.key], out)
        return
    if isinstance(v, Range):
        _head(out, 6, TAG_RANGE)
        beg = _bound(v.beg, v.beg_incl, out=None)
        end = _bound(v.end, v.end_incl, out=None)
        _encode([beg, end], out)
        return
    if isinstance(v, _Bound):
        _head(out, 6, TAG_BOUND_INCLUDED if v.incl else TAG_BOUND_EXCLUDED)
        _encode(v.value, out)
        return
    if isinstance(v, SSet):
        _head(out, 6, TAG_SET)
        _encode(list(v), out)
        return
    if isinstance(v, Geometry):
        _head(out, 6, TAG_GEOMETRY[v.kind])
        if v.kind == "GeometryCollection":
            _encode(list(v.coords), out)
        else:
            _encode(_coords_to_lists(v.coords), out)
        return
    if isinstance(v, list):
        _head(out, 4, len(v))
        if len(v) >= _FLOAT_RUN_MIN and set(map(type, v)) == {float}:
            args = [0xFB] * (2 * len(v))
            args[1::2] = v
            out += _float_run(len(v)).pack(*args)
            return
        for x in v:
            _encode(x, out)
        return
    if isinstance(v, dict):
        _head(out, 5, len(v))
        for k, x in v.items():
            _encode(str(k), out)
            _encode(x, out)
        return
    raise CborError(f"Cannot encode value of type {type(v).__name__} as CBOR")


class _Bound:
    __slots__ = ("value", "incl")

    def __init__(self, value, incl):
        self.value = value
        self.incl = incl


def _bound(value, incl, out):
    if value is NONE or value is None:
        return None
    return _Bound(value, incl)


def _coords_to_lists(c):
    if isinstance(c, tuple):
        return [_coords_to_lists(x) for x in c]
    return c


def encode(v) -> bytes:
    out = bytearray()
    _encode(v, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class _Dec:
    def __init__(self, data: bytes):
        self.b = data
        self.i = 0

    def u8(self):
        if self.i >= len(self.b):
            raise CborError("truncated CBOR input")
        v = self.b[self.i]
        self.i += 1
        return v

    def take(self, n):
        v = self.b[self.i : self.i + n]
        if len(v) < n:
            raise CborError("truncated CBOR input")
        self.i += n
        return v

    def arg(self, info):
        if info < 24:
            return info
        if info == 24:
            return self.u8()
        if info == 25:
            return int.from_bytes(self.take(2), "big")
        if info == 26:
            return int.from_bytes(self.take(4), "big")
        if info == 27:
            return int.from_bytes(self.take(8), "big")
        raise CborError("unsupported CBOR length encoding")

    def value(self):
        ib = self.u8()
        major, info = ib >> 5, ib & 0x1F
        if major == 0:
            return self.arg(info)
        if major == 1:
            return -1 - self.arg(info)
        if major == 2:
            return bytes(self.take(self.arg(info)))
        if major == 3:
            return self.take(self.arg(info)).decode("utf-8")
        if major == 4:
            n = self.arg(info)
            if n >= _FLOAT_RUN_MIN and self.i < len(self.b) \
                    and self.b[self.i] == 0xFB and len(self.b) - self.i >= 9 * n:
                # aligned 0xFB heads at every 9th byte are exactly a run
                # of n doubles: the first item of another kind breaks it
                run = _float_run(n).unpack_from(self.b, self.i)
                if run[0::2].count(0xFB) == n:
                    self.i += 9 * n
                    return list(run[1::2])
            return [self.value() for _ in range(n)]
        if major == 5:
            n = self.arg(info)
            out = {}
            for _ in range(n):
                k = self.value()
                out[k if isinstance(k, str) else str(k)] = self.value()
            return out
        if major == 6:
            return self.tagged(self.arg(info))
        # major 7: simple / floats
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 23:
            return NONE  # undefined maps to NONE
        if info == 25:
            raw = self.take(2)
            return _half_to_float(int.from_bytes(raw, "big"))
        if info == 26:
            return struct.unpack(">f", self.take(4))[0]
        if info == 27:
            return struct.unpack(">d", self.take(8))[0]
        raise CborError(f"unsupported CBOR simple value {info}")

    def tagged(self, tag):
        v = self.value()
        if tag == TAG_NONE:
            return NONE
        if tag == TAG_TABLE:
            return Table(v)
        if tag == TAG_RECORDID:
            if isinstance(v, list) and len(v) == 2:
                return RecordId(v[0], v[1])
            if isinstance(v, str) and ":" in v:
                tb, idv = v.split(":", 1)
                return RecordId(tb, idv)
            raise CborError("invalid CBOR record id")
        if tag == TAG_STRING_DECIMAL:
            return Decimal(v)
        if tag in (TAG_CUSTOM_DATETIME, 0):
            if isinstance(v, list) and len(v) == 2:
                import datetime as _dt

                secs, nanos = v
                return Datetime(
                    _dt.datetime.fromtimestamp(secs, _dt.timezone.utc), nanos
                )
            return Datetime.parse(v)
        if tag == TAG_STRING_DURATION:
            return Duration.parse(v)
        if tag == TAG_CUSTOM_DURATION:
            secs = v[0] if len(v) > 0 else 0
            nanos = v[1] if len(v) > 1 else 0
            return Duration(secs * 1_000_000_000 + nanos)
        if tag in (TAG_SPEC_UUID, 9):
            if isinstance(v, bytes):
                import uuid as _uuid

                return Uuid(_uuid.UUID(bytes=v))
            return Uuid(v)
        if tag == TAG_FILE:
            return File(v[0], v[1])
        if tag == TAG_SET:
            return SSet(v)
        if tag == TAG_BOUND_INCLUDED:
            return _Bound(v, True)
        if tag == TAG_BOUND_EXCLUDED:
            return _Bound(v, False)
        if tag == TAG_RANGE:
            beg, end = v
            bv = beg.value if isinstance(beg, _Bound) else NONE
            ev = end.value if isinstance(end, _Bound) else NONE
            return Range(
                bv, ev,
                beg.incl if isinstance(beg, _Bound) else True,
                end.incl if isinstance(end, _Bound) else False,
            )
        if tag in _GEO_BY_TAG:
            kind = _GEO_BY_TAG[tag]
            if kind == "GeometryCollection":
                return Geometry(kind, list(v))
            return Geometry(kind, _lists_to_coords(v))
        # unknown tags pass the inner value through
        return v


def _lists_to_coords(c):
    if isinstance(c, list):
        return tuple(_lists_to_coords(x) for x in c)
    return float(c) if isinstance(c, (int, float, Decimal)) else c


def _half_to_float(h: int) -> float:
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0 ** -24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)


def decode(data: bytes):
    d = _Dec(data)
    v = d.value()
    if d.i != len(data):
        raise CborError("trailing bytes after CBOR value")
    return v


# ---------------------------------------------------------------------------
# partial decode — project named top-level fields without materializing
# the rest of the record (exec/batch.py column extraction: an analytics
# scan over wide documents decodes only the columns it needs)
# ---------------------------------------------------------------------------


def _skip(d: _Dec):
    """Advance the cursor past one encoded value without building it."""
    ib = d.u8()
    major, info = ib >> 5, ib & 0x1F
    if major in (0, 1):
        d.arg(info)
        return
    if major in (2, 3):
        d.take(d.arg(info))
        return
    if major == 4:
        for _ in range(d.arg(info)):
            _skip(d)
        return
    if major == 5:
        for _ in range(d.arg(info)):
            _skip(d)
            _skip(d)
        return
    if major == 6:
        d.arg(info)
        _skip(d)
        return
    # major 7: simple values / floats — fail closed exactly where the
    # full decoder would (info 24 and 28+ are rejected by value() too),
    # never desynchronize the cursor on foreign bytes
    if info == 25:
        d.take(2)
    elif info == 26:
        d.take(4)
    elif info == 27:
        d.take(8)
    elif info == 24 or info >= 28:
        raise CborError(f"unsupported CBOR simple value {info}")


def decode_fields(data: bytes, wanted) -> "dict | None":
    """Decode only the `wanted` top-level keys of an encoded map; values
    of other keys are length-skipped, never materialized. Returns None
    when the top-level value is not a plain map (tagged/object-like
    records fall back to a full decode at the caller)."""
    d = _Dec(data)
    ib = d.u8()
    major, info = ib >> 5, ib & 0x1F
    if major != 5:
        return None
    out = {}
    remaining = len(wanted)
    for _ in range(d.arg(info)):
        kb = d.u8()
        kmajor, kinfo = kb >> 5, kb & 0x1F
        if kmajor != 3:
            return None  # non-string key: not a record-shaped map
        k = d.take(d.arg(kinfo)).decode("utf-8")
        if remaining and k in wanted and k not in out:
            out[k] = d.value()
            remaining -= 1
        else:
            _skip(d)
    return out
