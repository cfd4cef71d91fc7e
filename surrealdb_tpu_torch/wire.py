"""CBOR codec for device frame headers and stored values (RFC 8949
subset).

A trimmed copy of the reference package's `wire.py` encoder/decoder.
Device frame headers carry None, bool, int, f64 float, str, bytes, list
and dict, plus half/single floats on decode; a tagged item in a header
decodes to its inner value. Stored values (`encode` / `decode_value`,
the `0x01` storage encoding of `kvs/api.py`) add the SurrealDB value
tags the index engines hold: NONE(6), RecordId(8) and
string-decimal(10); any other value tag raises `NotPorted`. Tuples are
refused in both, as the reference refuses them (the storage layer
falls back to pickle). For all of these the bytes equal the
reference's.
"""

from __future__ import annotations

import struct
from decimal import Decimal

from surrealdb_tpu_torch.err import NotPorted
from surrealdb_tpu_torch.val import NONE, RecordId

TAG_NONE = 6
TAG_RECORDID = 8
TAG_STRING_DECIMAL = 10


class CborError(ValueError):
    """Malformed or unsupported CBOR input/value."""


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
    if isinstance(v, RecordId):
        _head(out, 6, TAG_RECORDID)
        _encode([v.tb, v.id], out)
        return
    if isinstance(v, list):
        _head(out, 4, len(v))
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


def encode(v) -> bytes:
    """A device frame header or a stored value, byte-identical to the
    reference's `wire.encode`. Tuples are refused, as the reference
    refuses them: its storage layer pickles those."""
    out = bytearray()
    _encode(v, out)
    return bytes(out)


def _half_to_float(h: int) -> float:
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0 ** -24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)


class _Dec:
    def __init__(self, data: bytes, values: bool = False):
        self.b = data
        self.i = 0
        self.values = values

    def u8(self):
        if self.i >= len(self.b):
            raise CborError("truncated CBOR input")
        v = self.b[self.i]
        self.i += 1
        return v

    def take(self, n):
        v = self.b[self.i:self.i + n]
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
            return [self.value() for _ in range(self.arg(info))]
        if major == 5:
            out = {}
            for _ in range(self.arg(info)):
                k = self.value()
                out[k if isinstance(k, str) else str(k)] = self.value()
            return out
        if major == 6:
            tag = self.arg(info)
            if self.values:
                return self._tagged(tag, self.value())
            return self.value()  # value tags never ride a frame header
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 23:
            return NONE if self.values else None  # undefined
        if info == 25:
            return _half_to_float(int.from_bytes(self.take(2), "big"))
        if info == 26:
            return struct.unpack(">f", self.take(4))[0]
        if info == 27:
            return struct.unpack(">d", self.take(8))[0]
        raise CborError(f"unsupported CBOR simple value {info}")


    @staticmethod
    def _tagged(tag, v):
        if tag == TAG_NONE:
            return NONE
        if tag == TAG_RECORDID:
            if isinstance(v, list) and len(v) == 2:
                return RecordId(v[0], v[1])
            if isinstance(v, str) and ":" in v:
                tb, idv = v.split(":", 1)
                return RecordId(tb, idv)
            raise CborError("invalid CBOR record id")
        if tag == TAG_STRING_DECIMAL:
            return Decimal(v)
        raise NotPorted(f"CBOR value tag {tag} is not ported")


def decode(data: bytes):
    """A device frame header."""
    d = _Dec(data)
    v = d.value()
    if d.i != len(data):
        raise CborError("trailing bytes after CBOR value")
    return v


def decode_value(data: bytes):
    """A stored value (the reference's `wire.decode` over the ported
    value types)."""
    d = _Dec(data, values=True)
    v = d.value()
    if d.i != len(data):
        raise CborError("trailing bytes after CBOR value")
    return v
