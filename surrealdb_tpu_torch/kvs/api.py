"""Transaction contract (reference: core/src/kvs/api.rs `Transactable`)."""

from __future__ import annotations

import pickle
import threading
import time
from typing import Iterator, Optional

from surrealdb_tpu_torch import cnf, wire
from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import copy_value


class BackendTx:
    """A single transaction against an ordered keyspace."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, val: bytes) -> None:
        raise NotImplementedError

    def put(self, key: bytes, val: bytes) -> None:
        """Set only if the key does not exist (api.rs put)."""
        if self.get(key) is not None:
            raise SdbError(f"key already exists")
        self.set(key, val)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def exists(self, key: bytes) -> bool:
        return self.get(key) is not None

    def scan(
        self,
        beg: bytes,
        end: bytes,
        limit: Optional[int] = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Iterate (key, value) for beg <= key < end in key order."""
        raise NotImplementedError

    def keys(self, beg, end, limit=None, reverse=False):
        for k, _v in self.scan(beg, end, limit, reverse):
            yield k

    def count(self, beg: bytes, end: bytes) -> int:
        return sum(1 for _ in self.scan(beg, end))

    def delete_range(self, beg: bytes, end: bytes) -> None:
        for k in list(self.keys(beg, end)):
            self.delete(k)

    # savepoints (api.rs:462-468) — statement-level rollback
    def new_save_point(self) -> None:
        raise NotImplementedError

    def rollback_to_save_point(self) -> None:
        raise NotImplementedError

    def release_last_save_point(self) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        raise NotImplementedError


class Backend:
    """A storage engine: a factory of transactions over one keyspace."""

    def transaction(self, write: bool) -> BackendTx:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def topology(self):
        """Shard topology of this backend, or None for an unsharded
        store. The range-sharded router (kvs/shard.py) overrides this;
        INFO FOR SYSTEM and the /kv/topology route surface it."""
        return None


# ---------------------------------------------------------------------------
# Value (de)serialization for stored records & catalog structs.
# ---------------------------------------------------------------------------


# Storage encoding: versioned, self-describing. Header byte 0x01 = the
# CBOR value encoding (wire.py — portable, the format SDKs speak); header
# 0x00 = pickle for internal structs that aren't plain values (catalog
# definitions carry ASTs). Legacy headerless pickle (0x80...) still reads.


def serialize(v) -> bytes:
    try:
        return b"\x01" + wire.encode(v)
    except (SdbError, ValueError, KeyError, TypeError):
        return b"\x00" + pickle.dumps(v, protocol=5)


_dec_cache: dict = {}  # raw bytes -> pristine decoded value
_dec_cache_bytes = 0
_dec_cache_lock = threading.Lock()
_DEC_MISS = object()  # stored NULL decodes to None — need a real sentinel


def _decode_cached(b: bytes):
    """Pristine decode of a wire-framed value through the decode cache:
    returns (value, shared). `shared` means the value is (now) the
    cache's pristine copy and MUST NOT be mutated by the caller."""
    global _dec_cache_bytes
    v = _dec_cache.get(b, _DEC_MISS)
    if v is not _DEC_MISS:
        return v, True
    v = wire.decode(b[1:])
    cap = cnf.DECODE_CACHE_BYTES
    if cap and len(b) <= (1 << 20):
        # decoded Python values are ~8× their CBOR encoding resident;
        # charge that multiple against the cap so the knob bounds RSS
        charge = len(b) * 8
        with _dec_cache_lock:
            if b not in _dec_cache:
                if _dec_cache_bytes + charge > cap:
                    _dec_cache.clear()
                    _dec_cache_bytes = 0
                _dec_cache[bytes(b)] = v
                _dec_cache_bytes += charge
        return v, True
    return v, False


def deserialize(b: bytes):
    if b[:1] == b"\x01":
        # content-keyed decode cache: identical bytes always decode to the
        # same value, so this is snapshot/MVCC-safe by construction. The
        # cached value stays pristine — callers get a deep copy (the doc
        # pipeline mutates records), which is ~25× cheaper than re-decoding
        # (repeated analytic scans re-read the same values every query).
        v, shared = _decode_cached(b)
        return copy_value(v) if shared else v
    if b[:1] == b"\x00":
        return _restricted_loads(b[1:])
    return _restricted_loads(b)


def deserialize_once(b: bytes):
    """Decode a value a whole-table pass reads once (an index build): no
    decode-cache entry, whose insert would cost the pass a copy of every
    record and evict the cache's hot values, and no copy (the value is
    fresh: the caller owns it)."""
    if b[:1] == b"\x01":
        return wire.decode(b[1:])
    return deserialize(b)


def deserialize_fields(b: bytes, wanted):
    """Project `wanted` top-level fields out of a stored record without
    materializing the rest (exec/batch.py columnar extraction). Exact:
    any shape the partial decoder can't serve — pickle-framed rows,
    non-map top values — takes the full shared decode instead. The
    returned dict/values are SHARED with nothing (partial path) or with
    the decode cache (fallback path): callers must not mutate them."""
    if b[:1] == b"\x01" and b not in _dec_cache:
        try:
            out = wire.decode_fields(b[1:], wanted)
        except Exception:
            out = None
        if out is not None:
            return out
    v = deserialize_shared(b)
    if not isinstance(v, dict):
        return None
    return v


def deserialize_shared(b: bytes):
    """Decode WITHOUT the fresh-copy contract: returns the decode
    cache's shared value when available — callers MUST NOT mutate the
    result. Read-only hot paths (full-text posting reads, which pay a
    300-entry copy_value per query through `deserialize`) use this via
    `Txn.peek_val`."""
    if b[:1] == b"\x01":
        return _decode_cached(b)[0]  # no fresh-copy tax either way
    return deserialize(b)


# module prefix of the reference package's pickled types
_REFERENCE_PREFIX = "surrealdb_tpu."


class _RestrictedUnpickler(pickle.Unpickler):
    """The pickle fallback codec only ever stores this package's own
    types (AST-bearing catalog structs) plus stdlib value types. In
    cluster mode stored bytes arrive from OTHER nodes over the KV
    service, so arbitrary-import unpickling would be a remote-code
    channel — restrict global lookups to an allowlist."""

    _ALLOWED_MODULES = ("surrealdb_tpu_torch.",)
    _ALLOWED_EXACT = {
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "complex"), ("builtins", "bytearray"),
        ("collections", "OrderedDict"), ("collections", "defaultdict"),
        ("datetime", "datetime"), ("datetime", "timedelta"),
        ("datetime", "timezone"), ("datetime", "date"), ("datetime", "time"),
        ("decimal", "Decimal"), ("uuid", "UUID"), ("re", "_compile"),
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
    }

    def find_class(self, module, name):
        mapped = module.startswith(_REFERENCE_PREFIX)
        if mapped:
            # a store the reference package wrote: its catalog structs
            # and AST nodes have counterparts of the same module path and
            # name here (a `file://` directory opens in either package)
            module = "surrealdb_tpu_torch." + module[len(_REFERENCE_PREFIX):]
        if module.startswith(self._ALLOWED_MODULES) or (
            module, name
        ) in self._ALLOWED_EXACT:
            try:
                found = super().find_class(module, name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f"stored value references unknown type {module}.{name}"
                ) from None
            if mapped and not isinstance(found, type):
                # only the reference's classes have counterparts here
                raise pickle.UnpicklingError(
                    f"stored value references {module}.{name}, not a type")
            return found
        raise pickle.UnpicklingError(
            f"stored value references disallowed type {module}.{name}"
        )


def _restricted_loads(b: bytes):
    import io

    return _RestrictedUnpickler(io.BytesIO(b)).load()


class Transaction:
    """Caching transaction wrapper (reference: kvs/tx.rs).

    Adds record/catalog (de)serialization and version-stamp allocation on top
    of a raw `BackendTx`.
    """

    def __init__(self, btx: BackendTx, write: bool):
        self.btx = btx
        self.write = write
        self.closed = False
        # datastore-level shared catalog cache (local backends only): a
        # pristine decoded-def dict valid for one catalog version; any
        # committed catalog write bumps the version and clears it
        self._shared_cat = None  # (version:int, dict) | None
        self._ds = None
        self._wrote_catalog = False
        self._cat_overlay: set = set()  # /! keys written in THIS txn
        # per-transaction catalog cache (reference kvs/tx.rs CachePolicy):
        # definition reads repeat constantly inside one statement loop;
        # snapshot isolation makes the cache safe for the txn lifetime,
        # and catalog writes through THIS txn invalidate their key
        self._cat_cache: dict = {}
        self._cat_copies: dict = {}  # per-txn memoized fresh copies

    # raw ops -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        return self.btx.get(key)

    def set(self, key: bytes, val: bytes) -> None:
        if key[:2] == b"/!":
            self._cat_cache.pop(key, None)
            self._cat_copies.pop(key, None)
            self._wrote_catalog = True
            self._cat_overlay.add(key)
        self.btx.set(key, val)

    def put(self, key: bytes, val: bytes) -> None:
        if key[:2] == b"/!":
            self._cat_cache.pop(key, None)
            self._cat_copies.pop(key, None)
            self._wrote_catalog = True
            self._cat_overlay.add(key)
        self.btx.put(key, val)

    def delete(self, key: bytes) -> None:
        self.btx.delete(key)
        if key.startswith(b"/!"):
            self._cat_cache.pop(key, None)
            self._cat_copies.pop(key, None)
            self._wrote_catalog = True
            self._cat_overlay.add(key)
            self.btx.set(K.cat_hist(key, time.time_ns()), b"")

    def exists(self, key: bytes) -> bool:
        return self.btx.exists(key)

    def scan(self, beg, end, limit=None, reverse=False):
        return self.btx.scan(beg, end, limit, reverse)

    def keys(self, beg, end, limit=None, reverse=False):
        return self.btx.keys(beg, end, limit, reverse)

    def count(self, beg, end):
        return self.btx.count(beg, end)

    def delete_range(self, beg, end):
        if beg.startswith(b"/!"):
            self._cat_cache.clear()
            self._cat_copies.clear()
            self._wrote_catalog = True
            self._cat_overlay.add(b"*")
            ts = time.time_ns()
            for k in list(self.btx.keys(beg, end)):
                self.btx.set(K.cat_hist(k, ts), b"")
        return self.btx.delete_range(beg, end)

    # typed ops ------------------------------------------------------------
    _CAT_MISS = object()

    def get_val(self, key: bytes):
        if key[:2] == b"/!":
            import copy as _copy

            hit = self._cat_cache.get(key, self._CAT_MISS)
            if hit is not self._CAT_MISS:
                if hit is None:
                    return None
                # DEEP copy preserves the fresh-object contract — ALTER
                # handlers mutate nested containers (d.actions.append)
                # of the returned def before writing back. The copy is
                # memoized per transaction: within one txn every reader
                # sees the same object (a txn observes its own catalog
                # consistently), so the deepcopy cost is paid once per
                # key per txn, not once per read.
                c = self._cat_copies.get(key)
                if c is None:
                    c = self._cat_copies[key] = _copy.deepcopy(hit)
                return c
            shared = self._shared_cat
            if shared is not None and key not in self._cat_overlay \
                    and b"*" not in self._cat_overlay:
                sv = shared[1].get(key, self._CAT_MISS)
                if sv is not self._CAT_MISS:
                    if sv is None:
                        return None
                    c = self._cat_copies.get(key)
                    if c is None:
                        c = self._cat_copies[key] = _copy.deepcopy(sv)
                    return c
            raw = self.btx.get(key)
            v = None if raw is None else deserialize(raw)
            if shared is not None and key not in self._cat_overlay \
                    and b"*" not in self._cat_overlay \
                    and len(shared[1]) < cnf.TRANSACTION_CACHE_SIZE:
                shared[1][key] = v
            if len(self._cat_cache) < cnf.TRANSACTION_CACHE_SIZE:
                self._cat_cache[key] = v
                # a second decode is the caller's fresh copy: for a
                # full-text posting dict it costs a twentieth of a
                # deepcopy, and every indexed write reads its postings
                return deserialize(raw) if v is not None else None
            return v  # not cached: the fresh object is already private
        raw = self.btx.get(key)
        return None if raw is None else deserialize(raw)

    def take_val(self, key: bytes):
        """A PRIVATE fresh copy for mutate-then-write-back flows (ALTER
        handlers): never left in the per-txn memo, so an aborted mutation
        can't leak phantom state into later reads of the same txn."""
        self._cat_copies.pop(key, None)
        v = self.get_val(key)
        self._cat_copies.pop(key, None)
        return v

    def peek_val(self, key: bytes):
        """Read-only catalog lookup: returns the SHARED decoded def
        without the fresh-copy contract — callers must not mutate.
        Serves the hottest guard-style reads (table kind checks, field
        lists) without paying a deepcopy per transaction."""
        if key[:2] == b"/!":
            if key not in self._cat_overlay and \
                    b"*" not in self._cat_overlay:
                hit = self._cat_cache.get(key, self._CAT_MISS)
                if hit is not self._CAT_MISS:
                    return hit
                shared = self._shared_cat
                if shared is not None:
                    sv = shared[1].get(key, self._CAT_MISS)
                    if sv is not self._CAT_MISS:
                        return sv
            return self.get_val(key)
        raw = self.btx.get(key)
        return None if raw is None else deserialize_shared(raw)

    def set_val(self, key: bytes, v) -> None:
        raw = serialize(v)
        self.btx.set(key, raw)
        if key.startswith(b"/!"):
            self._cat_cache.pop(key, None)
            self._cat_copies.pop(key, None)
            self._wrote_catalog = True
            self._cat_overlay.add(key)
            # catalog definitions keep history for INFO ... VERSION
            self.btx.set(K.cat_hist(key, time.time_ns()), raw)

    def scan_vals(self, beg, end, limit=None, reverse=False):
        for k, raw in self.btx.scan(beg, end, limit, reverse):
            yield k, deserialize(raw)

    # versioned catalog reads (INFO ... VERSION) ---------------------------
    def get_val_at(self, key: bytes, ts: int):
        best = None
        for k, raw in self.btx.scan(*K.prefix_range(K.cat_hist_prefix(key))):
            if int.from_bytes(k[-8:], "big") <= ts:
                best = raw
            else:
                break
        return None if best is None or best == b"" else deserialize(best)

    def scan_vals_at(self, beg, end, ts: int):
        cur = None
        best = None
        for k, raw in self.btx.scan(
            K.cat_hist_prefix(beg), K.cat_hist_prefix(end)
        ):
            okey = k[2:-8]
            if okey != cur:
                if cur is not None and best is not None and best != b"":
                    yield cur, deserialize(best)
                cur, best = okey, None
            if int.from_bytes(k[-8:], "big") <= ts:
                best = raw
        if cur is not None and best is not None and best != b"":
            yield cur, deserialize(best)

    # savepoints -----------------------------------------------------------
    def new_save_point(self):
        self.btx.new_save_point()

    def rollback_to_save_point(self):
        self.btx.rollback_to_save_point()
        # undone writes may include catalog keys cached above
        self._cat_cache.clear()

    def release_last_save_point(self):
        self.btx.release_last_save_point()

    # lifecycle ------------------------------------------------------------
    def on_commit(self, fn):
        """Run `fn()` after a successful commit (datastore-level cache
        invalidation must track COMMITTED state, not in-flight writes)."""
        if not hasattr(self, "_commit_hooks"):
            self._commit_hooks = []
        self._commit_hooks.append(fn)

    def commit(self):
        if not self.closed:
            if self._wrote_catalog and self._ds is not None:
                # the backend publish and the shared-cache bump happen
                # under ONE lock hold, and Datastore.transaction() takes
                # the same lock to grab the shared dict — no window where
                # a new txn pairs a post-commit snapshot with the
                # pre-commit catalog cache
                ds = self._ds
                with ds.lock:
                    self.btx.commit()
                    self.closed = True
                    ds._catalog_ver += 1
                    ds._catalog_shared = (ds._catalog_ver, {})
            else:
                self.btx.commit()
                self.closed = True
            for fn in getattr(self, "_commit_hooks", ()):  # post-commit
                try:
                    fn()
                except Exception:
                    pass

    def cancel(self):
        if not self.closed:
            self.btx.cancel()
            self.closed = True
            if hasattr(self, "_commit_hooks"):
                self._commit_hooks = []
