"""Persistent per-table vector column store.

Reference role: the compiled scan/decode path of the reference executor
(core/src/exec/operators/scan) — brute-force vector scoring over a table
should not deserialize every document in the host language per query.
This module keeps an (ids, float32 matrix) column extracted from a
table's records, built by the native C++ kernel
(native/memtable.cpp sdb_scan_extract_f32) when the datastore runs on
the native memtable, or by a Python scan otherwise. Columns are cached
on the Datastore keyed by the table's write version (the same
post-commit counter the graph CSR cache rides), so repeat queries skip
extraction entirely and any committed write invalidates the cache.
"""

from __future__ import annotations

import numpy as np

from surrealdb_tpu_torch import key as K

class VectorColumn:
    __slots__ = ("version", "ids", "mat", "bad_ids", "ids_enc",
                 "_norms")

    def __init__(self, version, ids, mat, bad_ids, ids_enc=None):
        self.version = version
        self.ids = ids          # decoded record-id keys, row-aligned
        self.mat = mat          # (n, dim) float32
        self.bad_ids = bad_ids  # record ids whose field didn't conform
        # encoded id key suffixes (key order) — the row-alignment token
        # shared with exec/batch.py TableColumns for fused filtered KNN
        self.ids_enc = ids_enc
        self._norms = None

    def norms(self):
        """Per-row L2 norms, computed once per version — the cosine
        scoring path's dominant recompute (bit-identical: the cached
        array IS np.linalg.norm(mat, axis=1))."""
        if self._norms is None:
            self._norms = np.linalg.norm(self.mat, axis=1)
        return self._norms


def _cache(ds) -> dict:
    c = getattr(ds, "_vector_columns", None)
    if c is None:
        c = ds._vector_columns = {}
    return c


def get_vector_column(ctx, tb: str, field: str, dim: int):
    """The (ids, matrix, bad_ids) column for `tb.field`, or None when the
    shape can't be served (dirty txn overlay, nested field, no backend
    support). Commit-consistent: keyed by the table write version."""
    ns, db = ctx.need_ns_db()
    gk = (ns, db, tb)
    # uncommitted writes to this table in the current txn would be
    # invisible to the committed-state column; fail CLOSED on write
    # buffers we cannot see (ShardTx per-shard subs, unknown engines)
    if gk in getattr(ctx.txn, "_graph_dirty", ()):
        return None
    pre = K.record_prefix(ns, db, tb)
    beg, end = K.prefix_range(pre)
    from surrealdb_tpu_torch.exec.batch import txn_range_clean

    if not txn_range_clean(ctx.txn, beg, end):
        return None
    # version is read BEFORE the build's fresh transaction opens: the
    # built state can only be newer than the stamp, so a concurrent
    # commit in between costs one rebuild next query — never staleness
    version = ctx.ds.graph_versions.get(gk, 0)
    ck = (ns, db, tb, field, dim)
    cache = _cache(ctx.ds)
    hit = cache.get(ck)
    if hit is not None and hit.version == version:
        return hit
    # build from a FRESH transaction (committed state only) — the
    # caller's snapshot may predate commits already counted in `version`
    # (same pattern as graph/csr.py build())
    txn = ctx.ds.transaction(write=False)
    try:
        col = _build(ctx, txn, tb, field, dim, beg, end, pre)
    finally:
        txn.cancel()
    if col is None:
        return None
    col.version = version
    cache[ck] = col
    return col


def _build(ctx, txn, tb, field, dim, beg, end, pre):
    btx = getattr(txn, "btx", None)
    table = getattr(getattr(btx, "store", None), "table", None)
    snap = getattr(btx, "snap", None)
    if table is not None and snap is not None and hasattr(
        table, "scan_extract_f32"
    ):
        est = table.count_range_at(beg, end, snap)
        mat, key_sfx, bad_sfx = table.scan_extract_f32(
            beg, end, snap, field.encode(), dim, len(pre), est
        )
        ids = [K.dec_value(s)[0] for s in key_sfx]
        bad = [K.dec_value(s)[0] for s in bad_sfx]
        return VectorColumn(0, ids, mat, bad, ids_enc=list(key_sfx))
    # portable fallback: Python scan + decode (still cached by version)
    from surrealdb_tpu_torch.kvs.api import deserialize

    ids, rows, bad, ids_enc = [], [], [], []
    for k, raw in txn.scan(beg, end):
        doc = deserialize(raw)
        v = doc.get(field) if isinstance(doc, dict) else None
        ok = isinstance(v, list) and len(v) == dim
        if ok:
            try:
                arr = np.asarray(v, np.float32)
            except (TypeError, ValueError):
                ok = False
        if ok and arr.ndim == 1 and arr.dtype.kind in ("i", "f"):
            ids.append(K.dec_value(k[len(pre):])[0])
            ids_enc.append(k[len(pre):])
            rows.append(arr)
        else:
            bad.append(K.dec_value(k[len(pre):])[0])
    mat = (
        np.stack(rows).astype(np.float32)
        if rows else np.empty((0, dim), np.float32)
    )
    return VectorColumn(0, ids, mat, bad, ids_enc=ids_enc)
