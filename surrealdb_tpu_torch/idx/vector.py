"""Device-resident vector index: the serving engine over one vector
index (the reference package's `idx/vector.py`, unsharded).

The KV `he` keys (id -> vector) written inside the caller's transaction
are the source of truth; the engine's host arrays are an overlay
rebuilt or extended when a search observes a newer `vn` version (small
gaps replay the `hl` op log, big gaps or heavy fragmentation repack),
and the runner's device blocks are a cache of those arrays, re-shipped
whenever their (version, epoch) tag changes.

Search: stores below `KNN_DEVICE_MIN_ROWS` take the exact numpy ladder;
the rest ride the cross-query batcher (`_Coalescer`) into `knn_batch`,
which routes to the segment fan-out (`idx/segments.py`, once a store
past `KNN_SEG_MIN_ROWS` has sealed a segment), the device runner (bf16
rank + f32 rescore, or the int8 store's candidates rescored here
exactly in f64), the batched BLAS host path, or, for a store with a
built CAGRA graph, the int8 descent plus an exact re-rank of its
candidates merged with the rows the graph cannot see. With a
`snapshot_dir` (a file-backed datastore's `.ann-cache`), a built graph
persists as an `SKVANN01` artifact and a restart reloads it instead of
rebuilding.

This module imports neither torch nor CUDA: the card is reached through
the port's supervisor (`device/supervisor.py`) only, and the host paths
are numpy, byte for byte the reference's (its degrade and small-store
paths, and the conformance oracle's).

A `cond` predicate on `knn` (a KNN operator ANDed with other
predicates) oversamples, checks each candidate on the host and refills.
The sharded router is not ported (`idx/shardvec.py` holds only
`merge_topk`).
"""

from __future__ import annotations

import threading
import uuid

import numpy as np

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch import resource
from surrealdb_tpu_torch.device.batcher import DeviceBatcher
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.idx import segments
from surrealdb_tpu_torch.kvs.api import deserialize
from surrealdb_tpu_torch.utils.rwlock import RWLock
from surrealdb_tpu_torch.val import NONE, RecordId, is_truthy

# device-search threshold: below this, numpy on host beats dispatch overhead
DEVICE_MIN_ROWS = cnf.KNN_DEVICE_MIN_ROWS


def _vec_dtype(params) -> type:
    # the index vector type governs storage precision; the reference's
    # parser defaults to F32 (syn define.rs:1107 VectorType::F32)
    vt = (params or {}).get("vector_type", "f32")
    return np.float32 if str(vt).lower() in ("f32", "i16", "i32") else np.float64


def _as_vector(v, dim, what, dtype=np.float64):
    if not isinstance(v, (list, tuple)):
        raise SdbError(f"Incorrect vector value for {what}")
    try:
        arr = np.asarray(v, dtype=dtype)
    except (TypeError, ValueError):
        raise SdbError(f"Incorrect vector value for {what}")
    if arr.ndim != 1 or arr.shape[0] != dim:
        raise SdbError(
            f"Incorrect vector dimension ({arr.shape[0] if arr.ndim == 1 else '?'}). Expected a vector of {dim} dimension."
        )
    return arr


def vector_index_update(idef, rid: RecordId, before, after, ctx):
    """Write-side maintenance inside the caller's transaction: persist
    rid -> vector under the `he` key, append the `hl` op-log entry and
    bump `vn`. `before` / `after` are the old and new documents (NONE
    where there is none); the indexed column is evaluated on each."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    ns, db = ctx.need_ns_db()
    ix = idef.name
    dim = idef.hnsw["dimension"]
    col = idef.cols[0]
    dtype = _vec_dtype(idef.hnsw)
    key = K.ix_state(ns, db, rid.tb, ix, b"he", K.enc_value(rid.id))
    vkey = K.ix_state(ns, db, rid.tb, ix, b"vn")
    old_vec = None
    new_vec = None
    if isinstance(before, dict):
        v = evaluate(col, ctx.with_doc(before, rid))
        if v is not NONE and v is not None:
            old_vec = v
    if isinstance(after, dict):
        v = evaluate(col, ctx.with_doc(after, rid))
        if v is not NONE and v is not None:
            new_vec = _as_vector(v, dim, f"index {ix}", dtype)
    if new_vec is None and old_vec is None:
        return
    # version allocation is process-atomic (ds.lock): concurrent writers
    # can't collide on a log slot; a cancelled txn burns a version, which
    # sync() detects as a log gap and resolves with a rebuild. The KV
    # read happens before the lock
    stored = ctx.txn.get_val(vkey) or 0
    with ctx.ds.lock:
        counters = getattr(ctx.ds, "_ix_versions", None)
        if counters is None:
            counters = {}
            ctx.ds._ix_versions = counters
        ckey = (ns, db, rid.tb, ix)
        ver = max(counters.get(ckey, 0), stored) + 1
        counters[ckey] = ver
    log_key = K.ix_state(ns, db, rid.tb, ix, b"hl", K.enc_u64(ver))
    if new_vec is not None:
        ctx.txn.set_val(key, new_vec.tobytes())
        ctx.txn.set_val(log_key, ("set", rid.id, new_vec.tobytes()))
    else:
        ctx.txn.delete(key)
        ctx.txn.set_val(log_key, ("del", rid.id, None))
    ctx.txn.set_val(vkey, ver)


def _exact_mxu_distances(metric: str, xs, q):
    """Exact f64 distances for the device-rankable metrics, shared by the
    single-query host path and the batched rescore. `xs` is [..., D] and
    `q` broadcasts against it; reduction is over the last axis. The
    reference computes distances in f64 regardless of stored type
    (trees/vector.rs)."""
    if metric == "euclidean":
        return np.linalg.norm(xs - q, axis=-1)
    if metric == "cosine":
        dots = (xs * q).sum(axis=-1)
        denom = np.maximum(
            np.linalg.norm(xs, axis=-1) * np.linalg.norm(q, axis=-1), 1e-300
        )
        return 1.0 - dots / denom
    if metric == "dot":
        return -(xs * q).sum(axis=-1)
    raise SdbError(f"unsupported device metric {metric}")


class _Coalescer(DeviceBatcher):
    """Self-clocking cross-query dynamic batcher over one vector index.

    The first searcher dispatches immediately (no added latency when
    idle); searches arriving while a device call is in flight queue up
    and ride the NEXT dispatch as one batched kernel call — so device
    batch size grows with client concurrency, inference-server style.
    This is how concurrent `SELECT … <|k|>` statements (e.g. from the
    threaded HTTP/WS server) share device work instead of serializing
    per-query dispatches. Reference contrast: hnsw/index.rs walks the
    graph per query under an RwLock; here concurrency *increases*
    device efficiency.

    The batching mechanics (pipelined dispatch, deadline withdrawal,
    per-rider attribution) live in `device/batcher.py`; this class
    binds them to one index's engine entry: batch kernel =
    `index.knn_batch` (device or batched host, routed by platform),
    first fallback = the SAME batched host kernel, last-resort
    fallback = per-rider host single search (one poisoned rider can
    never fail its batchmates)."""

    def __init__(self, index):
        from surrealdb_tpu_torch.device import (
            DeviceOpError, DeviceUnavailable,
        )

        self.index = index
        super().__init__(
            dispatch=self._dispatch,
            fallback_batch=self._fallback_batch,
            fallback=self._fallback_one,
            retryable=(DeviceUnavailable, DeviceOpError),
        )

    def search(self, qv: np.ndarray, k: int):
        return self.submit((qv, k))

    def _read_lock(self):
        # the index's reader-writer lock: pipelined dispatches score
        # concurrently while cache sync stays exclusive
        return self.index.rw.read()

    def _dispatch(self, payloads):
        kmax = max(k for _q, k in payloads)
        qvs = np.stack([q for q, _k in payloads])
        with self._read_lock():
            results = self.index.knn_batch(qvs, kmax)
        return [pairs[:k] for (_q, k), pairs in zip(payloads, results)]

    def _fallback_batch(self, payloads):
        # the device couldn't serve this batch: answer the WHOLE batch
        # from one batched exact host kernel (a [B, N] BLAS pass still
        # beats B single passes — the degraded path batches too)
        from surrealdb_tpu_torch.device import get_supervisor

        get_supervisor().note_fallback()
        kmax = max(k for _q, k in payloads)
        qvs = np.stack([q for q, _k in payloads])
        with self._read_lock():
            results = self.index._host_knn_multi(qvs, kmax)
        return [pairs[:k] for (_q, k), pairs in zip(payloads, results)]

    def _fallback_one(self, payload):
        q, k = payload
        with self._read_lock():
            return self.index._host_knn_single(q, k)


class TpuVectorIndex:
    """Per-(ns,db,tb,ix) device block cache + search engine."""

    def __init__(self, ns, db, tb, ix, params: dict, key_range=None,
                 label: str = ""):
        self.key = (ns, db, tb, ix)
        self.params = params
        self.dim = params["dimension"]
        # optional [lo, hi) clamp over the `he` element keyspace: a
        # shard-partitioned index (idx/shardvec.py) builds one engine
        # per shard range, each covering only its slice of the rows
        self.key_range = (
            None if key_range is None
            else (bytes(key_range[0]), bytes(key_range[1]))
        )
        self.label = label  # display name for residency/partial reports
        from surrealdb_tpu_torch.ops.metrics import normalize_metric

        self.metric, self.mink_p = normalize_metric(
            params.get("distance", "euclidean")
        )
        self.dtype = _vec_dtype(params)
        self.lock = threading.RLock()
        # reader-writer lock over the host arrays: pipelined dispatches
        # score concurrently under read; cache sync mutates under write
        self.rw = RWLock()
        self.version = -1
        self.rids: list = []  # row -> RecordId
        self.row_index: dict = {}  # enc(id) -> row
        self.vecs = np.zeros((0, self.dim), dtype=self.dtype)
        self.valid = np.zeros(0, dtype=bool)  # tombstone mask
        # device blocks live in the supervised DeviceRunner, addressed
        # by (cache key, [version, epoch]); a runner restart or an epoch
        # bump re-ships them from the host arrays (KV truth)
        self._dev_key = f"vec/{uuid.uuid4().hex[:16]}"
        self._dev_epoch = 0
        self.rank_mode = None  # last runner-reported ranking mode
        # widest mesh the runner reported serving this engine's blocks
        # on (device/mesh.py; 1 or 0 = single-device stores)
        self._dev_mesh = 0
        self._dev_mesh_ann = 0
        # per-epoch host scoring stats (row norms / squared norms) for
        # the batched BLAS host path; rebuilt lazily after cache sync
        self._host_stats = None
        # quantized graph-ANN overlay (idx/cagra.py): built from a host
        # snapshot for stores past cnf.KNN_ANN_MIN_ROWS, searched by
        # int8 greedy descent + exact re-rank. The flat graph + int8
        # arrays ship to the runner under their own (key, tag) blocks.
        self._ann = None           # built cagra.AnnIndex
        self._ann_state = "idle"   # idle | building | ready
        # rows overwritten since the graph snapshot, stamped with the
        # mutation counter at overwrite time: a build only un-dirties
        # rows whose stamp predates its snapshot (a row overwritten
        # AGAIN mid-build keeps brute-merging)
        self._ann_dirty: dict = {}
        self._ann_mut = 0          # overwrite stamp counter
        # tombstones since the snapshot: deletions poison graph slots
        # (the re-rank filters them), so they count toward staleness
        # like appends/overwrites do
        self._ann_dead = 0
        self._ann_dead_base = 0
        self._ann_gen = 0          # bumped on full repack (row remap)
        self._ann_seq = 0          # device block tag for shipped builds
        self._ann_lock = threading.Lock()
        self._ann_dev_key = f"ann/{uuid.uuid4().hex[:16]}"
        # segmented LSM-style serving (idx/segments.py): created on
        # first touch once the store crosses the segmentation floor;
        # None until then (smaller stores keep the whole-store graph)
        self._segs = None
        # where built graphs persist (get_vector_index sets it from a
        # file-backed datastore's ann_snapshot_dir); None: never saved
        self.snapshot_dir = None
        # whole-index ANN rebuilds this engine scheduled (graph drift);
        # a module aggregate lives in idx/segments.py
        self.ann_full_rebuilds = 0
        # whole-store graphs this engine built, and reloaded from a
        # persisted artifact instead
        self.ann_builds = 0
        self.ann_reloads = 0
        # ANN searches answered by the numpy descent (the device could
        # not serve, or routing chose the host), whole-store or segment
        self.ann_host_descents = 0
        self.coalescer = _Coalescer(self)
        # queries in flight on this engine (between sync and the end of
        # their scoring pass): a pinned engine's host arrays are not
        # evictable — freeing state out from under an active search
        # would silently change its answer, the one degradation the
        # governance layer must never produce
        self._pins = 0
        # resource governance: every byte this engine derives from KV
        # truth is a tracked, evictable account — the host rows
        # (rebuild = one range scan on the next sync), the CAGRA
        # build (rebuilt in the background; brute force serves
        # meanwhile), and the per-epoch
        # rank stats (a trivial recompute). Bound methods: the
        # accountant holds them weakly, so a discarded engine is
        # pruned, never pinned.
        acct_label = f"{tb}.{ix}" + (f"[{label}]" if label else "")
        # shard-part engines (key_range set) are TRACKED but their host
        # rows are not byte-evictable: the scatter router syncs and
        # searches a part in separate steps, and a background eviction
        # between them could merge a silently short answer. Their
        # ann/rank-stats overlays (safe to drop mid-flight) stay
        # evictable.
        self._mem_vec = resource.register(
            "vec", acct_label, self._vec_mem_bytes,
            evict=self._mem_evict_vec if key_range is None else None,
            owner=self,
        )
        self._mem_ann = resource.register(
            "ann", acct_label, self._ann_mem_bytes,
            evict=self._mem_evict_ann, owner=self,
        )
        self._mem_stats = resource.register(
            "rank_stats", acct_label, self._stats_mem_bytes,
            evict=self._mem_evict_stats, owner=self,
        )

    # -- resource accounting ------------------------------------------------

    def _vec_mem_bytes(self) -> int:
        return int(self.vecs.nbytes) + int(self.valid.nbytes)

    def _ann_mem_bytes(self) -> int:
        ann = self._ann
        return int(ann.nbytes()) if ann is not None else 0

    def _stats_mem_bytes(self) -> int:
        st = self._host_stats
        if st is None:
            return 0
        return sum(int(a.nbytes) for a in st
                   if a is not None and hasattr(a, "nbytes"))

    def _mem_evict_stats(self):
        # per-epoch scoring stats: recomputed lazily by the next BLAS
        # ranking pass — the cheapest possible degrade
        self._host_stats = None

    def _mem_evict_ann(self):
        # drop the built graph; brute force serves (exactly) until the
        # background build returns.
        # The dirty-row map survives: an in-flight query that captured
        # the old AnnIndex still needs it for its exact tail merge, and
        # row numbers stay valid until a repack.
        with self._ann_lock:
            self._ann = None
            self._ann_gen += 1  # voids a build racing this eviction
            if self._ann_state == "ready":
                self._ann_state = "idle"

    def _mem_evict_vec(self):
        # degrade the host arrays to rebuild-on-touch: version -1 makes
        # the next sync() re-scan this engine's KV range (the exact
        # PR-9 fresh-node discipline); the ANN snapshot's row numbering
        # dies with the arrays. PINNED engines are skipped: a query
        # between its sync() and its read-locked scoring pass must
        # never observe the arrays vanish — eviction degrades speed,
        # NEVER answers. Called only from checkpoint sites that hold
        # none of this engine's locks.
        with self.lock:
            if self._pins > 0:
                return  # actively serving: not evictable right now
            with self.rw.write():
                self.version = -1
                self.rids = []
                self.row_index = {}
                self.vecs = np.zeros((0, self.dim), dtype=self.dtype)
                self.valid = np.zeros(0, dtype=bool)
                self._drop_device()
                with self._ann_lock:
                    self._ann = None
                    self._ann_dirty = {}
                    self._ann_dead = 0
                    self._ann_dead_base = 0
                    self._ann_gen += 1
                    if self._ann_state == "ready":
                        self._ann_state = "idle"
                if self._segs is not None:
                    self._segs.reset()

    # -- cache sync ---------------------------------------------------------
    def sync(self, ctx):
        """Bring the device block cache up to the KV truth: small gaps apply
        the op log incrementally (append + tombstone); big gaps or heavy
        fragmentation trigger a full repack (SurrealDB's two-phase
        pending/compaction design). A store that crossed
        the ANN threshold (or whose graph went stale) kicks a background
        graph build afterwards — brute force serves until it lands."""
        # pressure checkpoint BEFORE taking any index lock: past the
        # soft watermark this may evict cold accounts (possibly this
        # engine's own — the rebuild below then runs from KV truth)
        self._mem_vec.touch()
        resource.checkpoint()
        ver0 = self.version
        try:
            self._sync_impl(ctx)
        finally:
            if self.version != ver0:
                # the sync grew state (log apply / rebuild): settle
                # with a fresh poll, same step-jump rationale as the
                # ANN install
                resource.checkpoint(fresh=True)
            self._maybe_maintain()

    def _sync_impl(self, ctx):
        ns, db, tb, ix = self.key
        vkey = K.ix_state(ns, db, tb, ix, b"vn")
        ver = ctx.txn.get_val(vkey) or 0
        if ver == self.version:
            return
        with self.lock, self.rw.write():
            if ver == self.version:
                return
            gap = ver - self.version
            n = len(self.rids)
            if self.version >= 0 and 0 < gap <= max(4096, n // 4):
                if self._apply_log(ctx, self.version, ver):
                    self.version = ver
                    frag = (
                        1.0 - (self.valid.sum() / max(len(self.valid), 1))
                        if len(self.valid)
                        else 0.0
                    )
                    if frag <= 0.25:
                        return
            self._rebuild(ctx)
            self.version = ver

    def _apply_log(self, ctx, from_ver, to_ver) -> bool:
        ns, db, tb, ix = self.key
        beg = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(from_ver + 1))
        end = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(to_ver)) + b"\x00"
        entries = list(ctx.txn.scan_vals(beg, end))
        if len(entries) != to_ver - from_ver:
            return False  # log incomplete (e.g. trimmed) — rebuild instead
        self._apply_entries([e for _k, e in entries])
        return True

    def _apply_entries(self, entries):
        """Apply pre-fetched op-log entries [(op, idv, raw), ...] to the
        host arrays. Pure in-memory — the caller holds the index locks
        and has already fetched the log slice (the shard router fetches
        ONCE and fans the ops out to its parts by key range)."""
        tb = self.key[2]
        add_rows = []
        add_rids = []
        add_valid = []
        for op, idv, raw in entries:
            h = K.enc_value(idv)
            row = self.row_index.get(h)
            if op == "del":
                if row is None:
                    continue
                if row < len(self.valid):
                    if self.valid[row]:
                        self._ann_dead += 1
                    self.valid[row] = False
                else:
                    # the row was appended EARLIER IN THIS BATCH and is
                    # still in the pending buffers — dropping the
                    # tombstone here would resurrect it forever
                    ai = row - len(self.rids)
                    if 0 <= ai < len(add_valid):
                        add_valid[ai] = False
                continue
            vec = np.frombuffer(raw, dtype=self.dtype)
            if row is not None and row < len(self.vecs):
                self.vecs[row] = vec
                self.valid[row] = True
                # the ANN graph/int8 snapshot no longer matches this
                # row: brute-merge it at query time until a rebuild
                self._ann_mut += 1
                self._ann_dirty[row] = self._ann_mut
            elif row is not None:
                # overwrite of a same-batch append: update the pending
                # buffer in place (a second append would leave a stale
                # duplicate row permanently valid)
                ai = row - len(self.rids)
                add_rows[ai] = vec
                add_valid[ai] = True
            else:
                self.row_index[h] = len(self.rids) + len(add_rids)
                add_rids.append(RecordId(tb, idv))
                add_rows.append(vec)
                add_valid.append(True)
        if add_rows:
            self.vecs = (
                np.vstack([self.vecs, np.stack(add_rows)])
                if len(self.vecs)
                else np.stack(add_rows)
            )
            self.valid = np.concatenate(
                [self.valid, np.asarray(add_valid, bool)]
            )
            self.rids.extend(add_rids)
        self._drop_device()

    def release_device(self):
        """Free this engine's device blocks for good: its index was
        removed or rebuilt, and the engine that replaces it ships its
        rows under keys of its own. Best-effort, and only while the
        runner is serving: a cold supervisor holds nothing, and the
        runner's LRU and byte budget reclaim whatever this misses."""
        from surrealdb_tpu_torch.device import get_supervisor

        drops = [("vec_drop", self._dev_key), ("ann_drop", self._ann_dev_key)]
        segs = self._segs
        if segs is not None:
            drops += [("ann_drop", s.dev_key) for s in list(segs.segs)]
            segs.close(timeout_s=0.0)
        try:
            sup = get_supervisor()
            if sup.mode != "inline" and sup.state != "ready":
                return
            for op, key in drops:
                sup.forget(key)
                try:
                    sup.call(op, {"key": key, "tag": []}, [])
                except Exception:
                    pass
        except Exception:
            pass

    def _drop_device(self):
        """Invalidate the device-resident cache (host arrays are truth):
        bumping the epoch makes the runner's copy stale, so the next
        dispatch re-ships the blocks. The host scoring stats are derived
        from the same arrays and invalidate with it."""
        self._dev_epoch += 1
        self.rank_mode = None
        self._host_stats = None

    def _he_range(self) -> tuple[bytes, bytes, bytes]:
        """(prefix, begin, end) of this engine's element keyspace —
        clamped to `key_range` for a shard part."""
        ns, db, tb, ix = self.key
        pre = K.ix_state(ns, db, tb, ix, b"he")
        beg, end = K.prefix_range(pre)
        if self.key_range is not None:
            beg = max(beg, self.key_range[0])
            end = min(end, self.key_range[1])
        return pre, beg, end

    def _scan_rows(self, ctx):
        """Read this engine's rows from KV truth (range-clamped). Pure
        I/O, no index locks, so the scatter paths can park on a remote
        scan without wedging concurrent searchers; the caller installs
        the snapshot under the write lock."""
        pre, beg, end = self._he_range()
        tb = self.key[2]
        rids = []
        rows = []
        index = {}
        plen = len(pre)
        for k, raw in ctx.txn.scan(beg, end):
            idv, _pos = K.dec_value(k, plen)
            index[K.enc_value(idv)] = len(rids)
            rids.append(RecordId(tb, idv))
            rows.append(np.frombuffer(deserialize(raw), dtype=self.dtype))
            if len(rids) % 65536 == 0:
                # chunk-boundary pause point: a rebuild under memory
                # pressure evicts colder state before allocating more
                resource.throttle("index_rebuild")
        return rids, rows, index

    def _install_rows(self, rids, rows, index):
        """Install a freshly scanned snapshot (caller holds the locks)."""
        self.rids = rids
        self.row_index = index
        self.vecs = (
            np.stack(rows) if rows else np.zeros((0, self.dim), self.dtype)
        )
        self.valid = np.ones(len(rids), dtype=bool)
        self._drop_device()
        # a repack remaps row ids: the ANN snapshot (graph ids, dirty
        # rows, any build in flight) is void — discard and re-trigger;
        # the segment table (spans of the old numbering) dies with it
        with self._ann_lock:
            self._ann = None
            self._ann_dirty = {}
            self._ann_dead = 0
            self._ann_dead_base = 0
            self._ann_gen += 1
            if self._ann_state == "ready":
                self._ann_state = "idle"
        if self._segs is not None:
            self._segs.reset()

    def _rebuild(self, ctx):
        ns, db, tb, ix = self.key
        self._install_rows(*self._scan_rows(ctx))
        # trim the consumed op log when we can write (bounds log growth);
        # shard parts never trim: the router owns the shared log
        if self.key_range is None and getattr(ctx.txn, "write", False):
            ver = ctx.txn.get_val(K.ix_state(ns, db, tb, ix, b"vn")) or 0
            beg = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(0))
            end = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(ver)) + b"\x00"
            ctx.txn.delete_range(beg, end)

    # -- shard-part serving (driven by idx/shardvec.py) ---------------------

    def part_sync(self, ctx, ver: int, entries):
        """Bring ONE shard part up to global mutation version `ver`.

        The router read `vn` once and fetched the shared op log once;
        `entries` is this part's share — ascending `(gver, op, idv,
        raw)` tuples — or None when the log cannot cover the gap (full
        range rebuild). Lock discipline differs from the unsharded
        `sync`: all KV I/O (the rebuild scan) runs OUTSIDE the index
        locks, so a scatter attempt parked on a sick shard's scan never
        wedges searchers of the healthy parts; installs re-check the
        version under the lock, so two racing syncs converge instead of
        regressing."""
        if ver <= self.version:
            return
        if entries is not None and self.version >= 0:
            frag = 0.0
            with self.lock, self.rw.write():
                if ver > self.version:
                    self._apply_entries([
                        (op, idv, raw) for g, op, idv, raw in entries
                        if g > self.version
                    ])
                    self.version = ver
                if len(self.valid):
                    frag = 1.0 - (self.valid.sum() / len(self.valid))
            if frag <= 0.25:
                self._maybe_maintain()
                return
        rids, rows, index = self._scan_rows(ctx)  # KV I/O: no locks held
        with self.lock, self.rw.write():
            if ver >= self.version:
                self._install_rows(rids, rows, index)
                self.version = ver
        self._maybe_maintain()

    def search_topk(self, qv: np.ndarray, k: int):
        """Per-part scatter entry: top-k over this part's (already
        synced) rows — exact, or graph descent + exact re-rank when the
        part grew past the ANN floor. Pure compute: by the lock
        discipline above it can never block on a remote shard.

        Routing: device-bound parts ride the cross-query coalescer
        (concurrent queries share one batched kernel per part block);
        host-routed parts call the batched engine entry directly."""
        with self.lock:
            self._pins += 1  # pin: eviction must not race this search
        try:
            n = int(self.valid.sum()) if len(self.valid) else 0
            if n == 0:
                return []
            k = min(k, n)
            if len(self.rids) < DEVICE_MIN_ROWS:
                # tiny part: the exact host ladder, bit for bit the
                # unsharded small-store path
                with self.rw.read():
                    return self._host_knn_single(qv, k)
            if self._use_device():
                return self.coalescer.search(qv, k)
            with self.rw.read():
                return self.knn_batch(np.asarray(qv)[None, :], k)[0]
        finally:
            with self.lock:
                self._pins -= 1

    def residency(self) -> dict:
        """Index-serving residency (rows, bytes, the ANN state, on a
        segmented engine its segments and mutable tail, and on a shard
        part its range)."""
        out = {
            "rows": int(self.valid.sum()) if len(self.valid) else 0,
            "bytes": int(self.vecs.nbytes),
            "version": int(self.version),
            "ann": self._ann_state,
        }
        ann = self._ann
        if ann is not None:
            out["ann_bytes"] = ann.nbytes()
        mesh_nd = max(int(self._dev_mesh), int(self._dev_mesh_ann))
        if mesh_nd > 1:
            # devices this engine's runner blocks actually served on
            # (device/mesh.py row-sharding); absent = single-device
            out["device_sharded"] = mesh_nd
        segs = self._segs
        if segs is not None and segs.active():
            st = segs.status()
            out["ann"] = "segmented"
            out["segments"] = st["segments"]
            out["segments_ready"] = st["ready"]
            out["tail_rows"] = st["tail_rows"]
        if self.label:
            out["range"] = self.label
        return out

    # -- segmented LSM-style serving (idx/segments.py) ----------------------

    def _segments(self):
        """The segment coordinator, created on first touch."""
        if self._segs is None:
            with self.lock:
                if self._segs is None:
                    self._segs = segments.SegmentedAnn(self)
        return self._segs

    def _seg_engaged(self) -> bool:
        """True when segmented serving governs this engine (mode +
        metric + size gates, idx/segments.py policy)."""
        segs = self._segs
        if segs is not None:
            return segs.engaged()
        if str(cnf.KNN_SEG_MODE).lower() == "off":
            return False
        return self._segments().engaged()

    def _maybe_maintain(self):
        """Post-sync index maintenance: segmented engines seal / build
        / merge in the background (idx/segments.py); everything else
        keeps the whole-store graph schedule."""
        if self._seg_engaged():
            self._segments().maybe_maintain()
            return
        self._maybe_build_ann()

    # -- quantized graph-ANN overlay (idx/cagra.py) -------------------------

    def _ann_floor(self):
        """Row floor above which a graph build is scheduled, or None
        when the ANN path is disabled for this index (mode off, or a
        metric the int8 scoring recipe does not cover)."""
        mode = cnf.KNN_ANN_MODE
        if mode == "off" or self.metric not in (
            "euclidean", "cosine", "dot"
        ):
            return None
        if mode == "force":
            return 256
        return cnf.KNN_ANN_MIN_ROWS

    def _ann_stale(self, ann, n) -> bool:
        """Appended-tail + overwritten-row fraction past which the
        graph is rebuilt. Until the rebuild lands those rows are
        brute-ranked and merged per query, so results stay exact-
        re-ranked either way — staleness is a throughput concern."""
        drift = (n - ann.built_n) + len(self._ann_dirty) \
            + max(self._ann_dead - self._ann_dead_base, 0)
        return drift / max(n, 1) > cnf.KNN_ANN_TAIL_FRAC

    def _maybe_build_ann(self):
        floor = self._ann_floor()
        if floor is None:
            return
        n = len(self.rids)
        if n < floor:
            return
        ann = self._ann
        if ann is not None and not self._ann_stale(ann, n):
            return
        with self._ann_lock:
            if self._ann_state == "building":
                return
            self._ann_state = "building"
        if ann is not None:
            # drift past KNN_ANN_TAIL_FRAC re-derives the WHOLE graph:
            # the treadmill the segmented path exists to remove, counted
            # so a churn run can hold it at 0 there
            self.ann_full_rebuilds += 1
            segments.count("ann_full_rebuilds")
        threading.Thread(target=self._build_ann, daemon=True,
                         name="ann-build").start()

    def ensure_ann(self) -> bool:
        """Synchronous build entry (benchmarks, tests): returns True
        when a ready, non-stale graph (or, on a segmented engine, a
        fully built segment set) serves searches of this store."""
        import time as _time

        if self._seg_engaged():
            return self._segments().drain()
        floor = self._ann_floor()
        n = len(self.rids)
        if floor is None or n < floor:
            return False
        while True:
            ann = self._ann
            if ann is not None and not self._ann_stale(ann, n):
                return True
            with self._ann_lock:
                if self._ann_state != "building":
                    if ann is not None:
                        self.ann_full_rebuilds += 1
                        segments.count("ann_full_rebuilds")
                    self._ann_state = "building"
                    break
            _time.sleep(0.05)  # a background build is running: wait
        self._build_ann()
        ann = self._ann
        # honest answer: a failed rebuild leaves the old (stale) graph
        # serving, which is NOT the fresh build this entry promises
        return ann is not None and not self._ann_stale(ann, len(self.rids))

    def _build_ann(self):
        """Build the CAGRA graph + int8 arrays from a host snapshot.
        Runs WITHOUT the index lock held through the build: the host
        arrays are append-stable (the log applier grows them by
        reallocation, so a captured reference keeps its length), and a
        concurrent in-place overwrite lands in `_ann_dirty`, whose rows
        are brute-merged at query time — a torn snapshot can never
        surface a wrong distance, only a slightly worse candidate set.
        A full repack bumps `_ann_gen`; a build that raced one is
        discarded.

        With a `snapshot_dir`, a persisted artifact whose mutation stamp
        (the `vn` version) AND row-identity digest match the current
        snapshot loads instead of the build (`ann_reloads`); a fresh
        build (`ann_builds`) persists on the way out."""
        from surrealdb_tpu_torch.idx import cagra

        with self.rw.read():
            gen = self._ann_gen
            xs = self.vecs
            rids = self.rids
            version, epoch = self.version, self._dev_epoch
            mut_cut = self._ann_mut
            dead0 = self._ann_dead
        ann = self._load_ann_snapshot(xs, rids, version)
        loaded = ann is not None
        if ann is None:
            try:
                ann = cagra.build_index(xs, self.metric, version, epoch)
            except Exception:
                with self._ann_lock:
                    self._ann_state = "idle"
                return
            self.ann_builds += 1
        else:
            self.ann_reloads += 1
        installed = False
        with self._ann_lock:
            if self._ann_gen != gen:
                self._ann_state = "idle"  # repack raced: discard
                return
            installed = True
            self._ann = ann
            self._ann_seq += 1
            # rows dirtied BEFORE the snapshot hold their new values in
            # xs (writers exclude the capture via the rw lock, so the
            # build covered them); rows stamped after — overwritten
            # DURING the build, possibly half-captured — stay dirty and
            # keep brute-merging
            self._ann_dirty = {
                r: g for r, g in self._ann_dirty.items() if g > mut_cut
            }
            # deletions known at snapshot time are as absorbed as an
            # ANN rebuild can make them (the rows leave the arrays only
            # at the next full repack) — stop counting them as drift
            self._ann_dead_base = dead0
            self._ann_state = "ready"
        if installed:
            self._mem_ann.touch()
            # the install just grew accounted bytes by a step: settle
            # pressure NOW with a fresh poll — the gated hot-path
            # checkpoint could reuse a stale low reading
            resource.checkpoint(fresh=True)
        if installed and not loaded:
            self._save_ann_snapshot(ann, xs, rids)

    # -- persisted build artifacts ------------------------------------------

    def _ann_snap_path(self):
        if not self.snapshot_dir:
            return None
        import hashlib
        import os

        ns, db, tb, ix = self.key
        # filename: readable stem + a collision-proof tag (names may
        # contain bytes a filesystem rejects; parts add their range, and
        # the ident is the reference's, so both packages name the same
        # file)
        ident = repr((ns, db, tb, ix, self.label))
        tag = hashlib.sha256(ident.encode()).hexdigest()[:16]
        stem = "".join(
            c if c.isalnum() else "_" for c in f"{ns}.{db}.{tb}.{ix}"
        )[:48]
        return os.path.join(self.snapshot_dir, f"{stem}-{tag}.annsnap")

    @staticmethod
    def _row_digest(rids, n: int) -> str:
        """Row-identity digest over the first `n` rows IN ORDER: graph
        node ids are row numbers, so a reloaded artifact is only valid
        when the numbering — not just the row set — matches."""
        import hashlib

        h = hashlib.sha256()
        for r in rids[:n]:
            h.update(K.enc_value(r.id))
            h.update(b";")
        return h.hexdigest()

    def _load_ann_snapshot(self, xs, rids, version):
        path = self._ann_snap_path()
        if path is None or not len(xs):
            return None
        import os
        import sys

        from surrealdb_tpu_torch.idx import cagra

        try:
            ann, meta = cagra.load_index(path)
        except OSError:
            return None  # no snapshot (or unreadable dir): just build
        except Exception as e:
            # corrupt/torn snapshot: warn + rebuild, NEVER serve it
            print(
                f"[surrealdb-tpu] ann snapshot {path} rejected "
                f"({e}); rebuilding from rows",
                file=sys.stderr, flush=True,
            )
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        if (ann.metric != self.metric
                or ann.built_n != len(xs)
                or ann.built_version != int(version)
                or meta.get("dim") != int(xs.shape[1])
                or meta.get("rows") != self._row_digest(rids, len(xs))):
            return None  # stale stamp: rows changed since the save
        return ann

    def _save_ann_snapshot(self, ann, xs, rids):
        path = self._ann_snap_path()
        if path is None:
            return
        import os
        import sys

        from surrealdb_tpu_torch.idx import cagra

        try:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            cagra.save_index(ann, path, extra={
                "dim": int(xs.shape[1]),
                "rows": self._row_digest(rids, ann.built_n),
            })
        except OSError as e:
            print(
                f"[surrealdb-tpu] ann snapshot save failed ({path}): "
                f"{e}", file=sys.stderr, flush=True,
            )

    def _ann_route(self, k: int):
        """The ready AnnIndex when a k-NN search of `k` should ride the
        graph path, else None (brute force — bit-for-bit the legacy
        results). A stale-but-built graph keeps serving while its
        replacement builds; the tail merge keeps results exact."""
        if cnf.KNN_ANN_MODE == "off" or k > cnf.KNN_ANN_MAX_K:
            return None
        return self._ann

    def _seg_route(self, k: int):
        """The segment coordinator when a k-NN search of `k` should fan
        over sealed segments, else None. Same k gate as the graph
        route; exact-only segment sets still fan out (each span scans
        exactly — the merge stays byte-identical to brute)."""
        if k > cnf.KNN_ANN_MAX_K:
            return None
        segs = self._segs
        if segs is not None and segs.active():
            return segs
        return None

    def ann_plan(self, k: int):
        """EXPLAIN surface: how a k-NN of `k` over this engine is
        served: None (brute scan), {"ann": "graph"} (the whole-store
        graph), or {"ann": "segmented", ...} with the segment fan-out
        shape."""
        segs = self._seg_route(k)
        if segs is not None:
            st = segs.status()
            return {
                "ann": "segmented",
                "segments": st["segments"],
                "ready": st["ready"],
                "tail_rows": st["tail_rows"],
            }
        if self._ann_route(k) is not None:
            return {"ann": "graph"}
        return None

    def _ann_device_search(self, ann, qs32: np.ndarray, kc: int,
                           dev_key=None, tag=None):
        """Descent candidates from the runner's AnnStore blocks; ships
        the build snapshot on first use / after a runner restart via
        the same (key, tag) protocol as the vector blocks: a crash or
        a drop re-ships, and the post-ship prewarm applies unchanged.
        Segmented engines pass a per-SEGMENT `dev_key`/`tag`
        (idx/segments.py), so every sealed segment is a runner block
        of its own. The mesh width the runner served on is recorded."""
        from surrealdb_tpu_torch.device import get_supervisor

        sup = get_supervisor()
        if dev_key is None:
            dev_key = self._ann_dev_key
        if tag is None:
            tag = [int(self._ann_seq), int(ann.built_version),
                   int(ann.built_epoch)]

        def loader():
            return "ann_load", {
                "metric": ann.metric,
                "cfg": cnf.ann_search_cfg(),
            }, [
                np.ascontiguousarray(ann.graph),
                np.ascontiguousarray(ann.x8),
                np.ascontiguousarray(ann.arow),
                np.ascontiguousarray(ann.x2),
            ]

        for _attempt in (0, 1):
            sup.ensure_loaded(dev_key, tag, loader)
            t, meta, bufs = sup.call(
                "ann_search",
                {"key": dev_key, "tag": tag, "kc": int(kc)},
                [qs32],
            )
            if t == "stale":
                sup.forget(dev_key)
                continue
            break
        else:
            raise sup.unavailable("ann cache thrashing")
        nd = int(meta.get("mesh_ndev", 1) or 1)
        if nd > self._dev_mesh_ann:
            self._dev_mesh_ann = nd
        return bufs[0]

    def _ann_extra_topk(self, ann, qvs, k: int, n: int):
        """Per-query top-k ids over rows the graph snapshot can't see
        (appended tail + overwritten rows), exact-scored; None when the
        snapshot covers the store. Bounded by KNN_ANN_TAIL_FRAC — past
        it `_ann_stale` schedules a rebuild."""
        dirty = [r for r in list(self._ann_dirty) if r < ann.built_n]
        if n <= ann.built_n and not dirty:
            return None
        extra = np.arange(ann.built_n, n, dtype=np.int64)
        if dirty:
            extra = np.concatenate(
                [np.asarray(sorted(dirty), np.int64), extra]
            )
        # tombstoned rows must not crowd valid ones out of the top-k
        # (the final re-rank would drop them, silently shrinking the
        # exact tail coverage)
        extra = extra[self.valid[extra]]
        if not len(extra):
            return None
        rows = self.vecs[extra]
        k_eff = min(k, len(extra))
        out = []
        for qv in qvs:
            d = self._host_distances(qv, xs=rows)
            if k_eff < len(extra):
                sel = np.argpartition(d, k_eff - 1)[:k_eff]
            else:
                sel = np.arange(len(extra))
            out.append(extra[sel])
        return out

    def _ann_knn_batch(self, ann, qvs: np.ndarray, k: int):
        """Graph-ANN search: int8 greedy descent (the runner's CUDA
        kernel, or its numpy mirror when the device is cold/degraded/
        host-routed) proposes an oversampled candidate set per query;
        rows outside the build snapshot are brute-ranked and merged;
        the final top-k comes from the exact `_host_distances` ladder
        over the union — every reported distance is exact, and the
        quantized descent only decides which kc candidates get
        considered (the AQR-style multi-stage re-rank)."""
        from surrealdb_tpu_torch.device import (
            DeviceOpError, DeviceUnavailable, get_supervisor,
        )
        from surrealdb_tpu_torch.idx import cagra

        n = len(self.rids)
        b = len(qvs)
        kc = min(ann.built_n, max(cnf.KNN_ANN_OVERSAMPLE * k, 32))
        qs32 = np.ascontiguousarray(np.asarray(qvs, np.float32))
        cand = None
        if self._use_device():
            try:
                cand = self._ann_device_search(ann, qs32, kc)
            except (DeviceUnavailable, DeviceOpError):
                # degrade to the numpy descent below
                get_supervisor().note_fallback()
        if cand is None:
            self.ann_host_descents += 1
            cfg = cnf.ann_search_cfg()
            width = min(max(cfg["width"], kc), ann.built_n)
            fn, probe_fn = cagra.int8_score_fn(ann, qs32)
            cand = cagra.descend(
                ann.graph, ann.built_n, fn, b, width, cfg["iters"],
                min(cfg["expand"], width), kc, probe_fn=probe_fn,
            )
        extra_top = self._ann_extra_topk(ann, qvs, k, n)
        out = []
        for i in range(b):
            ids_b = cand[i].astype(np.int64)
            ids_b = ids_b[(ids_b >= 0) & (ids_b < n)]
            if extra_top is not None:
                ids_b = np.concatenate([ids_b, extra_top[i]])
            ids_b = np.unique(ids_b)
            d = self._host_distances(qvs[i], xs=self.vecs[ids_b])
            d = np.where(self.valid[ids_b], d, np.inf)
            k_eff = min(k, len(ids_b))
            if k_eff == 0:
                out.append([])
                continue
            sel = np.argpartition(d, k_eff - 1)[:k_eff]
            sel = sel[np.argsort(d[sel], kind="stable")]
            res_i = [
                (self.rids[int(ids_b[j])], float(d[j]))
                for j in sel
                if np.isfinite(d[j])
            ]
            if len(res_i) < k:
                # tombstone-dense neighborhood (e.g. a fully deleted
                # cluster): graph candidates can underfill k while the
                # store still holds enough valid rows — answer that
                # query exactly rather than short (rare path; the
                # staleness counter is already scheduling a rebuild
                # when deletions accumulate)
                if len(res_i) < min(k, int(self.valid.sum())):
                    res_i = self._host_knn_single(qvs[i], k)
            out.append(res_i)
        return out

    # -- search -------------------------------------------------------------
    def knn(self, q, k: int, ctx, ef=None, cond=None, cond_ctx=None):
        """Top-k nearest records as (RecordId, distance) pairs. `cond`:
        an optional per-record predicate, served by oversampling, a host
        truthiness check of each candidate and refill rounds."""
        import time as _time

        from surrealdb_tpu_torch.telemetry import stage_record

        t0 = _time.perf_counter_ns()
        with self.lock:
            self._pins += 1  # pin: eviction must not race this query
        try:
            return self._knn(q, k, ctx, cond=cond, cond_ctx=cond_ctx)
        finally:
            with self.lock:
                self._pins -= 1
            # wall time inside the index: cache sync + batcher wait +
            # kernel (device RPC time shows separately as device_rpc)
            stage_record("index_knn", _time.perf_counter_ns() - t0)

    def _knn(self, q, k: int, ctx, cond=None, cond_ctx=None):
        self.sync(ctx)
        n = int(self.valid.sum())
        if n == 0:
            return []
        qv = _as_vector(q, self.dim, "knn query", self.dtype)
        if cond is None:
            pairs = self._raw_knn(qv, min(k, n))
            return pairs[:k]
        # predicate pushdown: oversample, check, refill with 4x the rows
        want = k
        fetch = min(max(4 * k, 64), n)
        checked: set = set()
        out = []
        while True:
            pairs = self._raw_knn(qv, min(fetch, n))
            for rid, dist in pairs:
                hkey = K.enc_value(rid.id)
                if hkey in checked:
                    continue
                checked.add(hkey)
                if self._check_cond(rid, cond, cond_ctx):
                    out.append((rid, dist))
                    if len(out) >= want:
                        return out
            if fetch >= n:
                return out
            fetch = min(fetch * 4, n)

    def _check_cond(self, rid, cond, ctx):
        from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record

        doc = fetch_record(ctx, rid)
        if doc is NONE:
            return False
        c = ctx.with_doc(doc, rid)
        return is_truthy(evaluate(cond, c))

    def _raw_knn(self, qv: np.ndarray, k: int):
        n = len(self.rids)
        if n < DEVICE_MIN_ROWS:
            # tiny store: a single exact pass beats any batching overhead
            return self._host_knn_single(qv, k)
        # Everything else rides the cross-query batcher — including the
        # degraded/CPU-only paths, which coalesce into one batched host
        # kernel instead of N single passes (PR 6: the batcher must win
        # on CPU-only boxes too).
        return self.coalescer.search(qv, k)

    def _use_device(self) -> bool:
        """Routing policy for the scoring engine (SURREAL_KNN_HOST_BATCH):
        dispatch to the device runner on real accelerators; when the
        "device" IS this host's CPU, the batched BLAS host path wins —
        offloading numpy-speed kernels through the runner only adds dispatch
        overhead. `device` forces the old always-dispatch behavior,
        `host` forces host scoring."""
        from surrealdb_tpu_torch.device import get_supervisor

        mode = cnf.KNN_HOST_BATCH
        if mode == "host":
            return False
        sup = get_supervisor()
        if not sup.fast_path():
            if sup.mode != "off":
                # device wanted but cold/degraded/disabled: host serves
                sup.note_fallback()
            return False
        if mode == "device":
            return True
        if sup.platform == "cpu":
            # the "accelerator" is this host's own CPU (inline debug
            # mode or a CPU-platform runner): one BLAS pass here beats
            # shipping numpy-speed work through the runner
            sup.counters["device_host_routed"] = (
                sup.counters.get("device_host_routed", 0) + 1
            )
            return False
        return True

    def knn_batch(self, qvs: np.ndarray, k: int):
        """The raw batched engine entry: [B, D] queries -> per-query
        (rid, dist) lists. A store with a built CAGRA graph routes
        through int8 descent + exact re-rank (`_ann_knn_batch`);
        everything else goes to the device runner or the batched exact
        host kernel by `_use_device`. This is the path the cross-query
        batcher dispatches AND what bench.py measures as
        `index_engine_qps` — the serving stack above it is pure tax.
        Device trouble raises DeviceUnavailable/DeviceOpError for the
        batcher's per-rider degrade ladder (the ANN path degrades
        internally to its numpy descent instead — falling back to a
        brute scan would forfeit the graph's 10× at the worst moment)."""
        segs = self._seg_route(k)
        if segs is not None:
            return segs.knn_batch(qvs, k)
        ann = self._ann_route(k)
        if ann is not None:
            return self._ann_knn_batch(ann, qvs, k)
        if self._use_device():
            return self._device_knn_batch(qvs, k)
        return self._host_knn_multi(qvs, k)

    def _host_knn_single(self, qv: np.ndarray, k: int):
        """Exact numpy top-k over the host arrays — the degraded path
        and the small-store fast path (identical results to device).
        Delegates to the batched kernel so sequential and batched
        results are byte-identical by construction."""
        return self._host_knn_multi(
            np.asarray(qv)[None, :], k
        )[0]

    def _host_knn_multi(self, qvs: np.ndarray, k: int):
        """Batched exact host KNN: [B, D] queries -> per-query
        (rid, dist) lists. Large stores with product metrics run the same
        two-stage discipline as the device kernels — ONE gemm ranking
        pass over the whole store in store precision, then an exact
        distance-ladder rescore of the oversampled candidates — so the
        [B, N] block is touched once, in f32, and every reported
        distance comes from the same per-metric ladder the legacy host
        path used. Small stores and exotic metrics keep the legacy
        per-query ladder bit-for-bit (the conformance oracle's path)."""
        n = len(self.rids)
        if n == 0:
            return [[] for _ in range(len(qvs))]
        if n < DEVICE_MIN_ROWS or self.metric not in (
            "euclidean", "cosine", "dot"
        ):
            return self._host_knn_multi_exact(qvs, k)
        return self._host_knn_multi_blas(qvs, k)

    def _host_knn_multi_exact(self, qvs: np.ndarray, k: int):
        """Legacy full-ladder search, one query at a time — byte-
        identical to the pre-batcher `_host_knn_single`."""
        n = len(self.rids)
        k_eff = min(k, n)
        out = []
        for qv in qvs:
            d = self._host_distances(qv)
            d = np.where(self.valid, d, np.inf)
            idx = np.argpartition(d, k_eff - 1)[:k_eff]
            idx = idx[np.argsort(d[idx], kind="stable")]
            out.append([
                (self.rids[i], float(d[i]))
                for i in idx
                if np.isfinite(d[i])
            ])
        return out

    def _host_stats_cached(self):
        """Per-epoch ranking stats for the BLAS path: f32 squared row
        norms (euclidean scores), f32 inverse row norms (cosine
        scores), and the invalid-row index list (None when the store
        has no tombstones — the common case skips the mask pass).
        Computed blockwise; never materializes an [N, D] copy."""
        st = self._host_stats
        if st is not None:
            return st
        xs = self.vecs
        n = xs.shape[0]
        x2 = np.empty(n, np.float64)
        step = max(1, (64 << 20) // max(xs.shape[1] * 8, 1))
        for s in range(0, n, step):
            blk = xs[s:s + step].astype(np.float64)
            x2[s:s + step] = (blk * blk).sum(axis=1)
        inv_norms = (
            1.0 / np.maximum(np.sqrt(x2), 1e-300)
        ).astype(np.float32)
        invalid = None
        if not self.valid.all():
            invalid = np.nonzero(~self.valid)[0]
        st = (x2.astype(np.float32), inv_norms, invalid)
        self._host_stats = st
        return st

    def _host_knn_multi_blas(self, qvs: np.ndarray, k: int):
        """Stage 1: rank every query against the whole store with one
        gemm per chunk (store precision; per-row results are bitwise
        stable across batch sizes >= 2, single queries pad to 2 rows —
        so batched and sequential searches return identical bytes).
        Stage 2: exact rescore of the kc oversampled candidates through
        `_host_distances` — the reported distances use the SAME ladder
        (and the same f32-cosine specialization) as the legacy path."""
        xs = self.vecs
        n = xs.shape[0]
        m = self.metric
        x2_32, inv_norms32, invalid = self._host_stats_cached()
        k_eff = min(k, n)
        kc = min(n, max(2 * k, k + 16))
        # bound the [chunk, N] f32 score block
        step = max(1, (cnf.KNN_SCORE_BUDGET_ELEMS // 2) // max(n, 1))
        out = []
        for s in range(0, len(qvs), step):
            qc = qvs[s:s + step]
            qb = np.ascontiguousarray(np.asarray(qc, dtype=xs.dtype))
            pad1 = qb.shape[0] == 1
            if pad1:
                # gemv and gemm round differently; a 2-row gemm keeps
                # single-query results bit-identical to batched ones
                qb = np.concatenate([qb, qb], axis=0)
            dots = qb @ xs.T  # [B, N] store precision
            if pad1:
                dots = dots[:1]
            if m == "euclidean":
                score = x2_32[None, :] - 2.0 * dots
            elif m == "cosine":
                score = dots * inv_norms32[None, :]
                np.negative(score, out=score)
            else:  # dot
                score = -dots
            if invalid is not None and len(invalid):
                score[:, invalid] = np.inf
            cand = np.argpartition(score, kc - 1, axis=1)[:, :kc]
            for b in range(cand.shape[0]):
                ids_b = cand[b]
                rows = xs[ids_b]
                d = self._host_distances(qc[b], xs=rows)
                d = np.where(self.valid[ids_b], d, np.inf)
                sel = np.argpartition(d, min(k_eff, kc) - 1)[:k_eff]
                sel = sel[np.argsort(d[sel], kind="stable")]
                out.append([
                    (self.rids[int(ids_b[j])], float(d[j]))
                    for j in sel
                    if np.isfinite(d[j])
                ])
        return out

    def _device_knn_batch(self, qvs: np.ndarray, k: int):
        """Batched search through the device supervisor: [B, D] queries
        -> per-query (rid, dist) lists. The runner ranks (bf16/int8/
        sharded) and rescores where it holds f32 rows; the int8 path
        returns candidates that are EXACTLY rescored here from the
        full-precision host rows. Raises DeviceUnavailable for the
        coalescer to degrade to the host path."""
        from surrealdb_tpu_torch.device import get_supervisor

        sup = get_supervisor()
        n = len(self.rids)
        tag = [int(self.version), int(self._dev_epoch)]

        def loader():
            return "vec_load", {
                "metric": self.metric,
                "mink_p": self.mink_p,
                "cfg": cnf.device_cfg(),
            }, [
                np.ascontiguousarray(self.vecs),
                np.ascontiguousarray(self.valid.astype(np.uint8)),
            ]

        qs32 = np.ascontiguousarray(qvs, dtype=np.float32)
        meta = bufs = None
        for _attempt in (0, 1):
            sup.ensure_loaded(self._dev_key, tag, loader)
            t, meta, bufs = sup.call(
                "vec_knn",
                {"key": self._dev_key, "tag": tag, "k": int(k)},
                [qs32],
            )
            if t == "stale":
                # runner evicted/restarted between load and query
                sup.forget(self._dev_key)
                continue
            break
        else:
            # sup.unavailable: SdbError in require mode (the query must
            # fail loudly), DeviceUnavailable (degrade to host) in auto
            raise sup.unavailable("vec cache thrashing")
        self.rank_mode = meta.get("rank_mode")
        nd = int(meta.get("mesh_ndev", 1) or 1)
        if nd > self._dev_mesh:
            self._dev_mesh = nd
        if meta.get("mode") == "cand":
            # int8 ranking candidates: exact host rescore from the
            # full-precision rows (kc rows per query — tiny next to the
            # store); per-query loop bounds the gather to [kc, D]
            cand = bufs[0]
            out = []
            for b in range(cand.shape[0]):
                ids_b = cand[b]
                ids_b = ids_b[(ids_b >= 0) & (ids_b < n)]
                rows = self.vecs[ids_b]
                d = self._host_distances(qvs[b], xs=rows)
                d = np.where(self.valid[ids_b], d, np.inf)
                k_eff = min(k, len(ids_b))
                if k_eff == 0:
                    out.append([])
                    continue
                sel = np.argpartition(d, k_eff - 1)[:k_eff]
                sel = sel[np.argsort(d[sel], kind="stable")]
                out.append([
                    (self.rids[int(ids_b[j])], float(d[j]))
                    for j in sel
                    if np.isfinite(d[j])
                ])
            return out
        dists, ids = bufs
        return [
            [
                (self.rids[int(i)], float(d))
                for d, i in zip(drow, irow)
                if 0 <= i < n and np.isfinite(d)
            ]
            for drow, irow in zip(dists, ids)
        ]

    def _host_distances(self, qv, xs=None):
        # the reference accumulates in f64 for most metrics regardless of
        # stored type (trees/vector.rs generic impls use to_float), but
        # cosine has an F32 specialization (cosine_distance_f32): f32
        # dot/norm sums combined in f64 — match it for TYPE F32 stores
        raw = self.vecs if xs is None else xs
        m = self.metric
        if m == "cosine" and raw.dtype == np.float32:
            x32 = raw
            q32 = np.asarray(qv, dtype=np.float32)
            dots = (x32 * q32[None, :]).sum(axis=1).astype(np.float64)
            na = np.sqrt((x32 * x32).sum(axis=1).astype(np.float64))
            nb = np.sqrt(np.float64((q32 * q32).sum()))
            return 1.0 - dots / np.maximum(na * nb, 1e-300)
        xs = raw.astype(np.float64)
        qv = np.asarray(qv, dtype=np.float64)
        if m in ("euclidean", "cosine", "dot"):
            return _exact_mxu_distances(m, xs, qv[None, :])
        if m == "manhattan":
            return np.abs(xs - qv[None, :]).sum(axis=1)
        if m == "chebyshev":
            return np.abs(xs - qv[None, :]).max(axis=1) if xs.size else np.zeros(0)
        if m == "hamming":
            return (xs != qv[None, :]).sum(axis=1).astype(np.float64)
        if m == "minkowski":
            return np.power(
                np.power(np.abs(xs - qv[None, :]), self.mink_p).sum(axis=1),
                1.0 / self.mink_p,
            )
        if m == "pearson":
            xc = xs - xs.mean(axis=1, keepdims=True)
            qc = qv - qv.mean()
            xn = xc / np.maximum(np.linalg.norm(xc, axis=1, keepdims=True), 1e-30)
            qn = qc / max(np.linalg.norm(qc), 1e-30)
            return 1.0 - xn @ qn
        if m == "jaccard":
            mn = np.minimum(xs, qv[None, :]).sum(axis=1)
            mx = np.maximum(xs, qv[None, :]).sum(axis=1)
            return 1.0 - mn / np.maximum(mx, 1e-30)
        raise SdbError(f"unsupported metric {m}")


def get_vector_index(idef, ctx):
    """The serving engine for one vector index (an `IndexDef` with an
    HNSW definition: `dimension`, `distance`, `vector_type`), cached on
    the datastore: a node-local TpuVectorIndex, or — on a range-sharded
    store — the scatter-gather router (idx/shardvec.py) that partitions
    the index along the shard map and merges per-shard top-k."""
    ns, db = ctx.need_ns_db()
    key = (ns, db, idef.tb, idef.name)
    eng = ctx.ds.vector_indexes.get(key)
    if eng is None:
        from surrealdb_tpu_torch.kvs.shard import ShardedBackend

        if isinstance(ctx.ds.backend, ShardedBackend):
            from surrealdb_tpu_torch.idx.shardvec import ShardedVectorIndex

            eng = ShardedVectorIndex(ns, db, idef.tb, idef.name,
                                     idef.hnsw, ctx.ds.backend,
                                     telemetry=ctx.ds.telemetry)
        else:
            eng = TpuVectorIndex(ns, db, idef.tb, idef.name, idef.hnsw)
        eng.snapshot_dir = getattr(ctx.ds, "ann_snapshot_dir", None)
        ctx.ds.vector_indexes[key] = eng
    return eng
