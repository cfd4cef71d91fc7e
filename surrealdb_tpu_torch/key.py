"""Order-preserving key codec (the reference package's `key/__init__.py`,
trimmed to the keys the index engines read and write).

- record:       /*{ns}*{db}*{tb}*{id}
- graph edge:   /*{ns}*{db}*{tb}~{id}{dir}{ft}{fk}
- index state:  /!ia{ns}{db}{tb}{ix}{kind}{suffix}

Encoding rules (order-preserving, byte-identical to the reference):
- str: UTF-8 with 0x00 -> 0x00 0x01, terminated by 0x00 0x00
- i64: sign-flipped 8-byte big-endian
- f64: IEEE-754 bits, sign-managed so byte order == numeric order
- values (record-id keys): 1 type tag byte + payload, tag order ==
  value type order, so every int id sorts before every str id.

The scan order is the row numbering of a vector index, and the ANN
graph's ids are row numbers: a different order would change every
answer. Value types the reference also encodes (durations, datetimes,
uuids, sets, geometries, tables, ranges) raise `NotPorted`.
"""

from __future__ import annotations

import struct
from decimal import Decimal

from surrealdb_tpu_torch.err import NotPorted
from surrealdb_tpu_torch.val import NONE, RecordId

# ---------------------------------------------------------------------------
# Primitive encoders
# ---------------------------------------------------------------------------


def enc_str(s: str) -> bytes:
    return s.encode("utf-8").replace(b"\x00", b"\x00\x01") + b"\x00\x00"


def enc_bytes(b: bytes) -> bytes:
    return bytes(b).replace(b"\x00", b"\x00\x01") + b"\x00\x00"


def dec_str(buf: bytes, pos: int) -> tuple[str, int]:
    b, p = dec_bytes(buf, pos)
    return b.decode("utf-8"), p


def dec_bytes(buf: bytes, pos: int) -> tuple[bytes, int]:
    n = len(buf)
    out2 = None
    cur = pos
    while True:
        i = buf.find(0, cur)
        if i < 0:
            raise ValueError("unterminated bytes in key")
        if i + 1 < n and buf[i + 1] == 1:
            if out2 is None:
                out2 = bytearray(buf[pos:i])
            else:
                out2 += buf[cur:i]
            out2.append(0)
            cur = i + 2
            continue
        if out2 is None:
            return bytes(buf[pos:i]), i + 2
        out2 += buf[cur:i]
        return bytes(out2), i + 2


def enc_i64(v: int) -> bytes:
    return struct.pack(">Q", (v + (1 << 63)) & ((1 << 64) - 1))


def dec_i64(buf: bytes, pos: int) -> tuple[int, int]:
    (u,) = struct.unpack_from(">Q", buf, pos)
    return u - (1 << 63), pos + 8


def enc_u64(v: int) -> bytes:
    return struct.pack(">Q", v)


def enc_f64(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)  # negative: flip all
    else:
        bits |= 1 << 63  # positive: flip the sign bit
    return struct.pack(">Q", bits)


def dec_f64(buf: bytes, pos: int) -> tuple[float, int]:
    (bits,) = struct.unpack_from(">Q", buf, pos)
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0], pos + 8


# ---------------------------------------------------------------------------
# Value encoding (record-id keys). Tag bytes follow the value-type order,
# so encoded order == value order.
# ---------------------------------------------------------------------------

TAG_NONE = 0x01
TAG_NULL = 0x02
TAG_FALSE = 0x03
TAG_TRUE = 0x04
TAG_NUMBER = 0x05
TAG_STRING = 0x06
TAG_ARRAY = 0x0A
TAG_OBJECT = 0x0C
TAG_BYTES = 0x0E
TAG_RECORDID = 0x10
TAG_END = 0x00  # array/object terminator (sorts before any element)
# the reference's tags for value types this package does not hold
_UNPORTED_TAGS = {0x07: "duration", 0x08: "datetime", 0x09: "uuid",
                  0x0B: "set", 0x0D: "geometry", 0x0F: "table",
                  0x11: "range"}


def enc_value(v) -> bytes:
    """Order-preserving encoding of a value usable inside keys."""
    if v is NONE:
        return bytes([TAG_NONE])
    if v is None:
        return bytes([TAG_NULL])
    if isinstance(v, bool):
        return bytes([TAG_TRUE if v else TAG_FALSE])
    if isinstance(v, (int, float, Decimal)):
        # all numbers in one ordered space: f64 (+ an i64 tiebreak for
        # ints past 2^53)
        f = float(v)
        if isinstance(v, int) and abs(v) >= (1 << 53):
            return bytes([TAG_NUMBER]) + enc_f64(f) + enc_i64(v)
        return bytes([TAG_NUMBER]) + enc_f64(f) + enc_i64(0)
    if isinstance(v, str):
        return bytes([TAG_STRING]) + enc_str(v)
    if isinstance(v, list):
        return (bytes([TAG_ARRAY]) + b"".join(enc_value(x) for x in v)
                + bytes([TAG_END]))
    if isinstance(v, dict):
        inner = b"".join(enc_str(k) + enc_value(v[k]) for k in sorted(v))
        return bytes([TAG_OBJECT]) + inner + bytes([TAG_END])
    if isinstance(v, (bytes, bytearray)):
        return bytes([TAG_BYTES]) + enc_bytes(bytes(v))
    if isinstance(v, RecordId):
        return bytes([TAG_RECORDID]) + enc_str(v.tb) + enc_value(v.id)
    raise NotPorted(f"key encoding of {type(v).__name__} is not ported")


def dec_value(buf: bytes, pos: int = 0):
    tag = buf[pos]
    pos += 1
    if tag == TAG_NONE:
        return NONE, pos
    if tag == TAG_NULL:
        return None, pos
    if tag == TAG_FALSE:
        return False, pos
    if tag == TAG_TRUE:
        return True, pos
    if tag == TAG_NUMBER:
        f, pos = dec_f64(buf, pos)
        i, pos = dec_i64(buf, pos)
        if i != 0:
            return i, pos
        if f == int(f) and abs(f) < (1 << 53):
            return int(f), pos
        return f, pos
    if tag == TAG_STRING:
        return dec_str(buf, pos)
    if tag == TAG_ARRAY:
        out = []
        while buf[pos] != TAG_END:
            v, pos = dec_value(buf, pos)
            out.append(v)
        return out, pos + 1
    if tag == TAG_OBJECT:
        obj = {}
        while buf[pos] != TAG_END:
            k, pos = dec_str(buf, pos)
            v, pos = dec_value(buf, pos)
            obj[k] = v
        return obj, pos + 1
    if tag == TAG_BYTES:
        return dec_bytes(buf, pos)
    if tag == TAG_RECORDID:
        tb, pos = dec_str(buf, pos)
        idv, pos = dec_value(buf, pos)
        return RecordId(tb, idv), pos
    if tag in _UNPORTED_TAGS:
        raise NotPorted(f"key decoding of a {_UNPORTED_TAGS[tag]} value "
                        f"is not ported")
    raise ValueError(f"bad value tag {tag:#x} at {pos - 1}")


# ---------------------------------------------------------------------------
# Key constructors
# ---------------------------------------------------------------------------


def _base(ns: str, db: str) -> bytes:
    return b"/*" + enc_str(ns) + b"*" + enc_str(db)


def _tb(ns: str, db: str, tb: str) -> bytes:
    return _base(ns, db) + b"*" + enc_str(tb)


def record(ns: str, db: str, tb: str, id) -> bytes:
    return _tb(ns, db, tb) + b"*" + enc_value(id)


def record_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"*"


DIR_IN = b"\x01"   # incoming edges (<-)
DIR_OUT = b"\x02"  # outgoing edges (->)


def graph(ns, db, tb, id, direction: bytes, ft: str, fk) -> bytes:
    """Edge key: node (tb, id) --direction--> edge table ft, record fk."""
    return (_tb(ns, db, tb) + b"~" + enc_value(id) + direction
            + enc_str(ft) + enc_value(fk))


def graph_tb_prefix(ns, db, tb) -> bytes:
    """All graph (`~`) keys of every record in `tb`: one scan covers a
    whole table's adjacency."""
    return _tb(ns, db, tb) + b"~"


def ix_state(ns, db, tb, ix, kind: bytes, suffix: bytes = b"") -> bytes:
    """Auxiliary per-index state: kind b'he' elements (id -> vector),
    b'hl' the op log (u64 version -> op), b'vn' the mutation version."""
    return (b"/!ia" + enc_str(ns) + enc_str(db) + enc_str(tb) + enc_str(ix)
            + kind + suffix)


def prefix_range(prefix: bytes) -> tuple[bytes, bytes]:
    """(begin, end) byte range covering every key with this prefix."""
    return prefix, prefix + b"\xff\xff\xff\xff\xff\xff\xff\xff"
