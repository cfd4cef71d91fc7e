"""CBOR codec for device frame headers (RFC 8949 subset).

A trimmed copy of the reference package's `wire.py` encoder/decoder,
limited to what a device frame header carries: None, bool, int, f64
float, str, bytes, list and dict, plus half/single floats on decode.
For those types the encoding is byte-identical to the reference, so a
port runner and a reference supervisor (or the reverse) understand each
other's frames. SurrealQL value tags (record ids, datetimes, ...) never
ride a device header; a tagged item decodes to its inner value.
"""

from __future__ import annotations

import struct


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
    if isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, 3, len(b))
        out += b
        return
    if isinstance(v, (bytes, bytearray)):
        _head(out, 2, len(v))
        out += bytes(v)
        return
    if isinstance(v, (list, tuple)):
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
            self.arg(info)  # value tags never ride a frame header
            return self.value()
        if info == 20:
            return False
        if info == 21:
            return True
        if info in (22, 23):
            return None
        if info == 25:
            return _half_to_float(int.from_bytes(self.take(2), "big"))
        if info == 26:
            return struct.unpack(">f", self.take(4))[0]
        if info == 27:
            return struct.unpack(">d", self.take(8))[0]
        raise CborError(f"unsupported CBOR simple value {info}")


def decode(data: bytes):
    d = _Dec(data)
    v = d.value()
    if d.i != len(data):
        raise CborError("trailing bytes after CBOR value")
    return v
