"""Order-preserving key codec.

Single ordered keyspace shared by every subsystem, mirroring the reference's
key grammar (surrealdb core/src/key/mod.rs:1-107) and its
`storekey` order-preserving serialization:

- record:      /*{ns}*{db}*{tb}*{id}
- graph edge:  /*{ns}*{db}*{tb}~{id}{dir}{ft}{fk}
- index entry: /*{ns}*{db}*{tb}+{ix}{fd...}{id}
- changefeed:  /*{ns}*{db}#{versionstamp}*{tb}
- catalog:     /!... prefixes (ns/db/tb/fd/ix/ev/pa/us/lq/sq defs)

Key order IS row order for the vector engine: streaming `(doc_id, vector)`
blocks to device-resident arrays walks this keyspace in order.

Encoding rules (order-preserving):
- str: UTF-8 with 0x00 -> 0x00 0x01, terminated by 0x00 0x00
- i64: sign-flipped 8-byte big-endian
- f64: IEEE-754 bits, sign-managed so byte order == numeric order
- values (record-id keys, index field values): 1 type tag byte + payload,
  tag order == value type order.
"""

from __future__ import annotations

import struct
from decimal import Decimal

from surrealdb_tpu_torch.val import (
    NONE,
    Datetime,
    Duration,
    Geometry,
    RecordId,
    Range,
    SSet,
    Table,
    Uuid,
)

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
    # bytes.find runs at memchr speed; embedded \x00\x01 escapes are
    # rare (a literal zero byte inside the value)
    n = len(buf)
    out2 = None
    cur = pos
    # lint: deadline(cursor-bounded codec loop: find advances cur monotonically over an in-memory buffer or raises)
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


def enc_u32(v: int) -> bytes:
    return struct.pack(">I", v)


def enc_f64(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)  # negative: flip all
    else:
        bits |= 1 << 63  # positive: flip sign bit
    return struct.pack(">Q", bits)


def dec_f64(buf: bytes, pos: int) -> tuple[float, int]:
    (bits,) = struct.unpack_from(">Q", buf, pos)
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0], pos + 8


# ---------------------------------------------------------------------------
# Value encoding (record-id keys / index field values)
# Tag bytes ordered by value-type order so encoded order == value_cmp order.
# ---------------------------------------------------------------------------

TAG_NONE = 0x01
TAG_NULL = 0x02
TAG_FALSE = 0x03
TAG_TRUE = 0x04
TAG_NUMBER = 0x05
TAG_STRING = 0x06
TAG_DURATION = 0x07
TAG_DATETIME = 0x08
TAG_UUID = 0x09
TAG_ARRAY = 0x0A
TAG_SET = 0x0B
TAG_OBJECT = 0x0C
TAG_GEOMETRY = 0x0D
TAG_BYTES = 0x0E
TAG_TABLE = 0x0F
TAG_RECORDID = 0x10
TAG_RANGE = 0x11
TAG_END = 0x00  # array/object terminator (sorts before any element)


def enc_value(v) -> bytes:
    """Order-preserving encoding of a value usable inside keys."""
    if v is NONE:
        return bytes([TAG_NONE])
    if v is None:
        return bytes([TAG_NULL])
    if isinstance(v, bool):
        return bytes([TAG_TRUE if v else TAG_FALSE])
    if isinstance(v, (int, float, Decimal)):
        # all numbers in one ordered space: encode as f64 (+ i64 tiebreak)
        f = float(v)
        if isinstance(v, int) and abs(v) < (1 << 53):
            return bytes([TAG_NUMBER]) + enc_f64(f) + enc_i64(0)
        if isinstance(v, int):
            return bytes([TAG_NUMBER]) + enc_f64(f) + enc_i64(v)
        return bytes([TAG_NUMBER]) + enc_f64(f) + enc_i64(0)
    if isinstance(v, str):
        return bytes([TAG_STRING]) + enc_str(v)
    if isinstance(v, Duration):
        return bytes([TAG_DURATION]) + enc_i64(v.ns)
    if isinstance(v, Datetime):
        return bytes([TAG_DATETIME]) + enc_i64(v.epoch_ns())
    if isinstance(v, Uuid):
        return bytes([TAG_UUID]) + v.u.bytes
    if isinstance(v, list):
        return (
            bytes([TAG_ARRAY])
            + b"".join(enc_value(x) for x in v)
            + bytes([TAG_END])
        )
    if isinstance(v, SSet):
        return (
            bytes([TAG_SET])
            + b"".join(enc_value(x) for x in v.items)
            + bytes([TAG_END])
        )
    if isinstance(v, dict):
        inner = b"".join(
            enc_str(k) + enc_value(v[k]) for k in sorted(v.keys())
        )
        return bytes([TAG_OBJECT]) + inner + bytes([TAG_END])
    if isinstance(v, Geometry):
        return bytes([TAG_GEOMETRY]) + enc_str(v.render())
    if isinstance(v, (bytes, bytearray)):
        return bytes([TAG_BYTES]) + enc_bytes(bytes(v))
    if isinstance(v, Table):
        return bytes([TAG_TABLE]) + enc_str(v.name)
    if isinstance(v, RecordId):
        return bytes([TAG_RECORDID]) + enc_str(v.tb) + enc_value(v.id)
    if isinstance(v, Range):
        return bytes([TAG_RANGE]) + enc_value(v.beg) + enc_value(v.end)
    raise TypeError(f"cannot key-encode value of type {type(v)!r}")


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
    if tag == TAG_DURATION:
        ns, pos = dec_i64(buf, pos)
        return Duration(ns), pos
    if tag == TAG_DATETIME:
        ns, pos = dec_i64(buf, pos)
        import datetime as _dt

        secs, frac = divmod(ns, 1_000_000_000)
        return (
            Datetime(
                _dt.datetime.fromtimestamp(secs, _dt.timezone.utc), frac
            ),
            pos,
        )
    if tag == TAG_UUID:
        import uuid as _uuid

        return Uuid(_uuid.UUID(bytes=buf[pos : pos + 16])), pos + 16
    if tag == TAG_ARRAY:
        out = []
        # lint: deadline(cursor-bounded codec loop: each dec_* advances pos over an in-memory buffer or raises on corrupt input)
        while buf[pos] != TAG_END:
            v, pos = dec_value(buf, pos)
            out.append(v)
        return out, pos + 1
    if tag == TAG_SET:
        out = []
        # lint: deadline(cursor-bounded codec loop: each dec_* advances pos over an in-memory buffer or raises on corrupt input)
        while buf[pos] != TAG_END:
            v, pos = dec_value(buf, pos)
            out.append(v)
        return SSet(out), pos + 1
    if tag == TAG_OBJECT:
        out = {}
        # lint: deadline(cursor-bounded codec loop: each dec_* advances pos over an in-memory buffer or raises on corrupt input)
        while buf[pos] != TAG_END:
            k, pos = dec_str(buf, pos)
            v, pos = dec_value(buf, pos)
            out[k] = v
        return out, pos + 1
    if tag == TAG_GEOMETRY:
        s, pos = dec_str(buf, pos)
        return s, pos  # opaque; geometry ids are rare
    if tag == TAG_BYTES:
        return dec_bytes(buf, pos)
    if tag == TAG_TABLE:
        s, pos = dec_str(buf, pos)
        return Table(s), pos
    if tag == TAG_RECORDID:
        tb, pos = dec_str(buf, pos)
        idv, pos = dec_value(buf, pos)
        return RecordId(tb, idv), pos
    if tag == TAG_RANGE:
        b, pos = dec_value(buf, pos)
        e, pos = dec_value(buf, pos)
        return Range(b, e), pos
    raise ValueError(f"bad value tag {tag:#x} at {pos - 1}")


# ---------------------------------------------------------------------------
# Key constructors. Each returns bytes; *_prefix / *_range helpers for scans.
# ---------------------------------------------------------------------------


def _base(ns: str, db: str) -> bytes:
    return b"/*" + enc_str(ns) + b"*" + enc_str(db)


def _tb(ns: str, db: str, tb: str) -> bytes:
    return _base(ns, db) + b"*" + enc_str(tb)


# --- records ---------------------------------------------------------------


def record(ns: str, db: str, tb: str, id) -> bytes:
    return _tb(ns, db, tb) + b"*" + enc_value(id)


def record_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"*"


# --- record version history (VERSION clause time-travel) -------------------


def hist(ns: str, db: str, tb: str, id, ts: int) -> bytes:
    return _tb(ns, db, tb) + b"%" + enc_value(id) + ts.to_bytes(8, "big")


def hist_record_prefix(ns: str, db: str, tb: str, id) -> bytes:
    return _tb(ns, db, tb) + b"%" + enc_value(id)


def hist_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"%"


def cat_hist(key: bytes, ts: int) -> bytes:
    """History slot for a catalog definition key (INFO ... VERSION)."""
    return b"/%" + key + ts.to_bytes(8, "big")


def cat_hist_prefix(key: bytes) -> bytes:
    return b"/%" + key


def decode_record_id(key: bytes):
    """Decode `(ns, db, tb, id)` from a record key."""
    pos = 2
    ns, pos = dec_str(key, pos)
    pos += 1
    db, pos = dec_str(key, pos)
    pos += 1
    tb, pos = dec_str(key, pos)
    pos += 1
    idv, pos = dec_value(key, pos)
    return ns, db, tb, idv


# --- graph edges -----------------------------------------------------------

DIR_IN = b"\x01"   # incoming edges (<-)
DIR_OUT = b"\x02"  # outgoing edges (->)


def graph(ns, db, tb, id, direction: bytes, ft: str, fk) -> bytes:
    """Edge key: node (tb,id) --direction--> edge table ft, edge record fk."""
    return (
        _tb(ns, db, tb)
        + b"~"
        + enc_value(id)
        + direction
        + enc_str(ft)
        + enc_value(fk)
    )


def graph_tb_prefix(ns, db, tb) -> bytes:
    """All graph (`~`) keys of every record in `tb` — one scan covers a
    whole table's adjacency (CSR builds read keys, not edge docs)."""
    return _tb(ns, db, tb) + b"~"


def graph_node_prefix(ns, db, tb, id) -> bytes:
    return _tb(ns, db, tb) + b"~" + enc_value(id)


def graph_dir_prefix(ns, db, tb, id, direction: bytes) -> bytes:
    return graph_node_prefix(ns, db, tb, id) + direction


def graph_ft_prefix(ns, db, tb, id, direction: bytes, ft: str) -> bytes:
    return graph_dir_prefix(ns, db, tb, id, direction) + enc_str(ft)


def decode_graph(key: bytes):
    pos = 2
    ns, pos = dec_str(key, pos)
    pos += 1
    db, pos = dec_str(key, pos)
    pos += 1
    tb, pos = dec_str(key, pos)
    pos += 1  # skip '~'
    idv, pos = dec_value(key, pos)
    direction = key[pos : pos + 1]
    pos += 1
    ft, pos = dec_str(key, pos)
    fk, pos = dec_value(key, pos)
    return ns, db, tb, idv, direction, ft, fk


# --- record references (`&` keys: target -> referencing field) -------------


def ref(ns, db, tb, id, ft: str, ff: str, fk) -> bytes:
    """Reference key: record (tb,id) is referenced by (ft,fk) via field ff."""
    return (
        _tb(ns, db, tb)
        + b"&"
        + enc_value(id)
        + enc_str(ft)
        + enc_str(ff)
        + enc_value(fk)
    )


def ref_prefix(ns, db, tb, id) -> bytes:
    return _tb(ns, db, tb) + b"&" + enc_value(id)


def ref_ft_prefix(ns, db, tb, id, ft: str) -> bytes:
    return ref_prefix(ns, db, tb, id) + enc_str(ft)


def decode_ref(key: bytes):
    pos = 2
    ns, pos = dec_str(key, pos)
    pos += 1
    db, pos = dec_str(key, pos)
    pos += 1
    tb, pos = dec_str(key, pos)
    pos += 1  # '&'
    idv, pos = dec_value(key, pos)
    ft, pos = dec_str(key, pos)
    ff, pos = dec_str(key, pos)
    fk, pos = dec_value(key, pos)
    return ns, db, tb, idv, ft, ff, fk


# --- index entries ---------------------------------------------------------


def index_fields_enc(fields: list) -> bytes:
    """Concatenated per-column encodings — prefixes of this encoding are
    valid scan prefixes, which is what makes composite-index lookups
    (equality on leading columns + range on the next) plain range scans."""
    return b"".join(enc_value(f) for f in fields)


def index(ns, db, tb, ix: str, fields: list, id=None) -> bytes:
    """Non-unique index entry: fields then record id (id=None for prefix)."""
    k = _tb(ns, db, tb) + b"+" + enc_str(ix) + index_fields_enc(fields)
    if id is not None:
        k += enc_value(id)
    return k


def index_unique(ns, db, tb, ix: str, fields: list) -> bytes:
    """Unique index entry key (value holds the record id)."""
    return _tb(ns, db, tb) + b"!u" + enc_str(ix) + index_fields_enc(fields)


def index_prefix(ns, db, tb, ix: str) -> bytes:
    return _tb(ns, db, tb) + b"+" + enc_str(ix)


def index_unique_prefix(ns, db, tb, ix: str) -> bytes:
    return _tb(ns, db, tb) + b"!u" + enc_str(ix)


def decode_index(key: bytes, ns, db, tb, ix, ncols: int = 1):
    """Decode (fields, id) from a non-unique index entry key."""
    pre = index_prefix(ns, db, tb, ix)
    pos = len(pre)
    fields = []
    for _ in range(ncols):
        f, pos = dec_value(key, pos)
        fields.append(f)
    idv, pos = dec_value(key, pos)
    return fields, idv


# --- changefeeds -----------------------------------------------------------


def changefeed(ns, db, versionstamp: int, tb: str, seq: int) -> bytes:
    return _base(ns, db) + b"#" + enc_u64(versionstamp) + enc_str(tb) + enc_u32(seq)


def changefeed_prefix(ns, db) -> bytes:
    return _base(ns, db) + b"#"


def changefeed_from(ns, db, versionstamp: int) -> bytes:
    return _base(ns, db) + b"#" + enc_u64(versionstamp)


# --- catalog ---------------------------------------------------------------


def sys_cfg() -> bytes:
    """Root system configuration (ALTER SYSTEM QUERY_TIMEOUT ...)."""
    return b"/!sc"


def ns_def(ns: str) -> bytes:
    return b"/!ns" + enc_str(ns)


def ns_prefix() -> bytes:
    return b"/!ns"


def db_def(ns: str, db: str) -> bytes:
    return b"/!db" + enc_str(ns) + enc_str(db)


def db_prefix(ns: str) -> bytes:
    return b"/!db" + enc_str(ns)


def tb_def(ns, db, tb) -> bytes:
    return b"/!tb" + enc_str(ns) + enc_str(db) + enc_str(tb)


def tb_prefix(ns, db) -> bytes:
    return b"/!tb" + enc_str(ns) + enc_str(db)


def _tbsub(kind: bytes, ns, db, tb, name=None) -> bytes:
    k = b"/!" + kind + enc_str(ns) + enc_str(db) + enc_str(tb)
    if name is not None:
        k += enc_str(name)
    return k


def fd_def(ns, db, tb, fd) -> bytes:
    return _tbsub(b"fd", ns, db, tb, fd)


def fd_prefix(ns, db, tb) -> bytes:
    return _tbsub(b"fd", ns, db, tb)


def ix_def(ns, db, tb, ix) -> bytes:
    return _tbsub(b"ix", ns, db, tb, ix)


def ix_prefix(ns, db, tb) -> bytes:
    return _tbsub(b"ix", ns, db, tb)


def ev_def(ns, db, tb, ev) -> bytes:
    return _tbsub(b"ev", ns, db, tb, ev)


def ev_prefix(ns, db, tb) -> bytes:
    return _tbsub(b"ev", ns, db, tb)


def lq_def(ns, db, tb, lqid) -> bytes:
    return _tbsub(b"lq", ns, db, tb, lqid)


def lq_prefix(ns, db, tb) -> bytes:
    return _tbsub(b"lq", ns, db, tb)


def pa_def(ns, db, name) -> bytes:  # DEFINE PARAM
    return b"/!pa" + enc_str(ns) + enc_str(db) + enc_str(name)


def pa_prefix(ns, db) -> bytes:
    return b"/!pa" + enc_str(ns) + enc_str(db)


def fc_def(ns, db, name) -> bytes:  # DEFINE FUNCTION
    return b"/!fc" + enc_str(ns) + enc_str(db) + enc_str(name)


def fc_prefix(ns, db) -> bytes:
    return b"/!fc" + enc_str(ns) + enc_str(db)


def az_def(ns, db, name) -> bytes:  # DEFINE ANALYZER
    return b"/!az" + enc_str(ns) + enc_str(db) + enc_str(name)


def az_prefix(ns, db) -> bytes:
    return b"/!az" + enc_str(ns) + enc_str(db)


def us_def(level: str, ns, db, name) -> bytes:  # DEFINE USER (root/ns/db)
    return b"/!us" + enc_str(level) + enc_str(ns or "") + enc_str(db or "") + enc_str(name)


def us_prefix(level: str, ns=None, db=None) -> bytes:
    return b"/!us" + enc_str(level) + enc_str(ns or "") + enc_str(db or "")


def ac_def(level: str, ns, db, name) -> bytes:  # DEFINE ACCESS
    return b"/!ac" + enc_str(level) + enc_str(ns or "") + enc_str(db or "") + enc_str(name)


def ac_prefix(level: str, ns=None, db=None) -> bytes:
    return b"/!ac" + enc_str(level) + enc_str(ns or "") + enc_str(db or "")


def ac_grant(level: str, ns, db, ac, gid: str) -> bytes:  # ACCESS grants
    return (b"/!ag" + enc_str(level) + enc_str(ns or "") + enc_str(db or "")
            + enc_str(ac) + enc_str(gid))


def ac_grant_prefix(level: str, ns, db, ac) -> bytes:
    return (b"/!ag" + enc_str(level) + enc_str(ns or "") + enc_str(db or "")
            + enc_str(ac))


def ml_def(ns, db, name, version) -> bytes:  # ML model definition
    return (b"/!ml" + enc_str(ns) + enc_str(db) + enc_str(name)
            + enc_str(version))


def ml_prefix(ns, db) -> bytes:
    return b"/!ml" + enc_str(ns) + enc_str(db)


def ml_blob(ns, db, name, version) -> bytes:  # ML model payload bytes
    return (b"/!mb" + enc_str(ns) + enc_str(db) + enc_str(name)
            + enc_str(version))


def storage_version() -> bytes:  # on-disk format marker (kvs/version/)
    return b"/!vx"


def mod_def(ns, db, name) -> bytes:  # DEFINE MODULE definition
    return b"/!md" + enc_str(ns) + enc_str(db) + enc_str(name)


def mod_prefix(ns, db) -> bytes:
    return b"/!md" + enc_str(ns) + enc_str(db)


def mod_blob(ns, db, name) -> bytes:  # module wasm payload
    return b"/!mw" + enc_str(ns) + enc_str(db) + enc_str(name)


def tb_idseq(ns, db) -> bytes:  # monotonic table-id allocator
    return b"/!ti" + enc_str(ns) + enc_str(db)


def seq_state(ns, db, name) -> bytes:  # sequence state
    return b"/!sq" + enc_str(ns) + enc_str(db) + enc_str(name)


def node(nid: str) -> bytes:  # cluster node registry (reference /${nd})
    return b"/$nd" + enc_str(nid)


def node_prefix() -> bytes:
    return b"/$nd"


def task_lease(name: str) -> bytes:  # cluster task lease (tasklease.rs:44)
    return b"/$tl" + enc_str(name)


def api_def(ns, db, path) -> bytes:  # DEFINE API
    return b"/!ap" + enc_str(ns) + enc_str(db) + enc_str(path)


def api_prefix(ns, db) -> bytes:
    return b"/!ap" + enc_str(ns) + enc_str(db)


def cfg_def(ns, db, what) -> bytes:  # DEFINE CONFIG
    return b"/!cg" + enc_str(ns) + enc_str(db) + enc_str(what)


def cfg_prefix(ns, db) -> bytes:
    return b"/!cg" + enc_str(ns) + enc_str(db)


def bucket_def(ns, db, name) -> bytes:  # DEFINE BUCKET
    return b"/!bk" + enc_str(ns) + enc_str(db) + enc_str(name)


def bucket_prefix(ns, db) -> bytes:
    return b"/!bk" + enc_str(ns) + enc_str(db)


# --- index auxiliary state (vector / fulltext) -----------------------------


def ix_state(ns, db, tb, ix, kind: bytes, suffix: bytes = b"") -> bytes:
    """Auxiliary per-index state, e.g. kind=b'hs' HNSW state, b'he' elements,
    b'hp' pendings, b'bd' doc-ids, b'bf' postings (reference IndexKeyBase)."""
    return _tbsub(b"ia", ns, db, tb) + enc_str(ix) + kind + suffix


def prefix_range(prefix: bytes) -> tuple[bytes, bytes]:
    """(begin, end) byte range covering every key with this prefix."""
    return prefix, prefix + b"\xff\xff\xff\xff\xff\xff\xff\xff"


def view_meta(ns, db, tb, keybytes: bytes = b"") -> bytes:
    """Per-view-row aggregation metadata (reference: Record.metadata
    aggregation_stats, doc/table.rs) — stored beside the view record.
    Deliberately outside the `/!` catalog space so per-write metadata
    updates don't generate catalog history entries."""
    return b"/^vm" + enc_str(ns) + enc_str(db) + enc_str(tb) + keybytes
