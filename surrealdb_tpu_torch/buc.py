"""Object-storage buckets (the reference package's `buc.py`; reference:
core/src/buc/ — DEFINE BUCKET, `file:///` values, file::* operations
over memory/file backends).

The memory backend holds per-(ns,db,bucket) key→(bytes, updated) maps on
the datastore. File/S3 backends are denied by default ("File access
denied"), mirroring the reference's capability gate on bucket backends.
"""

from __future__ import annotations

import threading

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import Datetime, File


class MemoryBucket:
    def __init__(self, name: str, readonly: bool = False):
        self.name = name
        self.readonly = readonly
        self.files: dict[str, tuple[bytes, Datetime]] = {}
        self.lock = threading.RLock()

    # -- helpers ------------------------------------------------------------
    def _check_write(self):
        if self.readonly:
            raise SdbError(
                f"Write operation is not supported, as bucket "
                f"`{self.name}` is in read-only mode"
            )

    def _missing_source(self, key: str):
        raise SdbError(
            f"Operation for bucket `{self.name}` failed: "
            f"Source key does not exist: {key}"
        )

    # -- operations ---------------------------------------------------------
    def put(self, key: str, data: bytes):
        self._check_write()
        with self.lock:
            self.files[key] = (bytes(data), Datetime.now())

    def put_if_not_exists(self, key: str, data: bytes):
        self._check_write()
        with self.lock:
            if key not in self.files:
                self.files[key] = (bytes(data), Datetime.now())

    def get(self, key: str):
        with self.lock:
            hit = self.files.get(key)
            return hit[0] if hit is not None else None

    def head(self, key: str):
        with self.lock:
            hit = self.files.get(key)
            if hit is None:
                return None
            return {
                "file": File(self.name, key),
                "size": len(hit[0]),
                "updated": hit[1],
            }

    def exists(self, key: str) -> bool:
        with self.lock:
            return key in self.files

    def copy(self, src: str, dst: str, if_not_exists: bool = False,
             idempotent_missing: bool = False):
        self._check_write()
        with self.lock:
            hit = self.files.get(src)
            if hit is None:
                if idempotent_missing:
                    return
                self._missing_source(src)
            if if_not_exists and dst in self.files:
                return
            self.files[dst] = (hit[0], Datetime.now())

    def rename(self, src: str, dst: str, if_not_exists: bool = False):
        self._check_write()
        with self.lock:
            hit = self.files.get(src)
            if hit is None:
                self._missing_source(src)
            if if_not_exists and dst in self.files:
                return
            del self.files[src]
            self.files[dst] = (hit[0], Datetime.now())

    def delete(self, key: str):
        self._check_write()
        with self.lock:
            self.files.pop(key, None)  # idempotent

    def list(self, opts: dict | None = None):
        opts = opts or {}
        with self.lock:
            keys = sorted(self.files)
            prefix = opts.get("prefix")
            if isinstance(prefix, str):
                keys = [k for k in keys if k.startswith(prefix)]
            start = opts.get("start")
            if isinstance(start, str):
                keys = [k for k in keys if k >= start]
            limit = opts.get("limit")
            if isinstance(limit, int):
                keys = keys[:limit]
            return [
                {
                    "file": File(self.name, k),
                    "size": len(self.files[k][0]),
                    "updated": self.files[k][1],
                }
                for k in keys
            ]


def check_backend_allowed(backend):
    """Non-memory backends hit the filesystem/network — denied unless
    explicitly allowed (reference bucket backend capability)."""
    if backend is None or backend == "memory":
        return
    b = str(backend)
    if b.startswith("file:"):
        raise SdbError(f"File access denied: {b[len('file:'):]}")
    raise SdbError(f"Backend not supported: {b}")


def get_bucket(name: str, ctx, for_write: bool = False) -> MemoryBucket:
    """Resolve a DEFINE'd bucket to its live store."""
    ns, db = ctx.need_ns_db()
    bdef = ctx.txn.get_val(K.bucket_def(ns, db, name))
    if bdef is None:
        raise SdbError(f"The bucket '{name}' does not exist")
    stores = getattr(ctx.ds, "bucket_stores", None)
    if stores is None:
        stores = {}
        ctx.ds.bucket_stores = stores
    key = (ns, db, name)
    b = stores.get(key)
    if b is None:
        b = MemoryBucket(name, readonly=bool(getattr(bdef, "readonly", False)))
        stores[key] = b
    return b
