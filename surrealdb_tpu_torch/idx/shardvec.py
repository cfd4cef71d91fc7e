"""Shard-partitioned vector serving: failure-tolerant scatter-gather KNN
(the reference package's `idx/shardvec.py`).

On a range-sharded store (kvs/shard.py) the vector index is no longer
one node-local blob: the element keyspace (`he` state keys) is cut
along the SAME shard map that partitions the data, and each shard range
gets its own part engine — a `TpuVectorIndex` clamped to that range.
Every part owns its slice end to end: host arrays rebuilt from ITS
range, device blocks shipped to the card's runner under the existing
`(key, tag)` protocol (a part past `KNN_DEVICE_MIN_ROWS` rides its own
cross-query coalescer to the bf16 rank store's kernels), a CAGRA graph once the part crosses the ANN
floor — and, past the segmentation floor, its own LSM-style sealed
segments (idx/segments.py): segment fan-out nests INSIDE the shard
scatter-gather, so a part under continuous ingest seals/merges in the
background while the router's exact k-way merge stays exact (each
part's list is exact over its rows whether it came from one graph, a
segment fan-out, or a brute scan). Index size and query fan-out both
scale with shard count.

A query scatter-gathers: one `vn` read establishes the freshness
point, the shared op log is fetched ONCE and routed to stale parts by
key range (or a part range-rebuilds), every part answers its local
top-k (oversampled by SURREAL_KNN_SHARD_OVERSAMPLE), and the
coordinator k-way merges — mirroring the cross-shard scan stitching
the router already does for ordered scans.

The robustness spine is the point (failure-first):

- **Per-shard budgets.** Each scatter attempt runs under a budget
  carved from the query's remaining inflight deadline
  (SURREAL_KNN_SHARD_TIMEOUT_S, enforced through the inflight
  thread-local so the KV retry policy inherits it) — one sick shard
  can burn its slice of the query, never the whole deadline.
- **Bounded hedged retry.** A failed part gets up to
  SURREAL_KNN_SHARD_HEDGES re-dispatches against a refreshed shard
  map, through the group's failover-following pool — a promoted
  replica answers the hedge (`knn_hedged_dispatches`).
- **Typed partial results.** What still fails is governed by
  SURREAL_KNN_PARTIAL: `error` (default) raises KnnShardUnavailable
  naming the missing shard(s); `partial` answers from the healthy
  parts, flags the response (QueryResult.partial) with the missing
  shard names, and counts `knn_partial_results`. Never silently wrong.
- **Splits behind the epoch fence.** A shard split re-cuts the
  partition table at the next query; the moved slice's fresh part
  rebuilds from KV truth and serves brute-exact until its graph
  rebuilds — a mid-split query is answered exactly.
- **Crash/promotion recovery for free.** Parts sync from KV truth
  through the routing client, so a promoted replica repopulates
  index-serving state exactly like a runner crash and reship.
- **Follower reads ride through.** Every KV read here goes through the
  query's transaction (`ctx.txn`), so a `SELECT ... <|k|> ... READ AT
  <bound>` statement scatter-gathers over each group's REPLICAS via
  the closed-timestamp proof (kvs/remote.py): the freshness `vn` read,
  the op-log fetch, and every part's range sync all serve from a
  provably-bounded-stale snapshot, and KNN read capacity scales with
  replicas instead of serializing on each group's primary.

Lock discipline: `scatter_gather`
and `merge_topk` check the query deadline, and NO lock is held across
a remote dispatch — the partition lock guards pure bookkeeping, and
part engines do their KV I/O outside their index locks (`part_sync`).
"""

from __future__ import annotations

import threading

import numpy as np

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import (
    KnnShardUnavailable,
    QueryCancelled,
    QueryTimeout,
    RetryableKvError,
    SdbError,
)
from surrealdb_tpu_torch.idx.vector import TpuVectorIndex, _as_vector, _vec_dtype
from surrealdb_tpu_torch.kvs import net
from surrealdb_tpu_torch.val import NONE, is_truthy

# exceptions a scatter attempt absorbs into a per-shard failure record;
# query-lifecycle signals (cancel/timeout) always propagate
_SHARD_ERRS = (RetryableKvError, SdbError, OSError)

# consumed op-log entries that must accumulate before the router trims
# the shared log (bursty trims keep the steady-state query free of
# delete traffic; the log shard pays one range delete per burst)
TRIM_LOG_ENTRIES = 1024


class _NeverCancel:
    __slots__ = ()

    def is_set(self) -> bool:
        return False


_NEVER_CANCEL = _NeverCancel()


class _ShardBudget:
    """Duck-typed inflight handle activated around ONE per-shard
    scatter attempt: `remaining()` is the per-shard budget capped by
    the real query budget, so the KV retry policy
    (`RetryPolicy.effective_deadline_s`) — which reads the thread-local
    — bounds its retries to the SHARD's slice of the deadline without
    any plumbing. The clock is the seam's (`kvs/net.py`), so the
    a deterministic simulator virtualizes these budgets too."""

    __slots__ = ("cancel", "_end", "_parent")

    def __init__(self, parent, budget_s: float):
        self._parent = parent
        self.cancel = parent.cancel if parent is not None \
            else _NEVER_CANCEL
        self._end = net.mono() + budget_s

    def remaining(self) -> float:
        rem = self._end - net.mono()
        if self._parent is not None:
            p = self._parent.remaining()
            if p is not None:
                rem = min(rem, p)
        return rem

    def mark_timed_out(self):
        # a shard attempt running out its budget is NOT the query
        # timing out — the hedge/partial machinery owns what follows
        pass

    def mark_cancelled(self):
        if self._parent is not None:
            self._parent.mark_cancelled()


class _Part:
    """One contiguous slice of the element keyspace: the shard range
    serving it and the range-clamped engine holding its rows."""

    __slots__ = ("lo", "hi", "addrs", "label", "engine")

    def __init__(self, parent: "ShardedVectorIndex", lo: bytes,
                 hi: bytes, addrs):
        self.lo = bytes(lo)
        self.hi = bytes(hi)
        self.addrs = tuple(addrs)
        self.label = parent.range_label(self.lo, self.hi)
        ns, db, tb, ix = parent.key
        self.engine = TpuVectorIndex(
            ns, db, tb, ix, parent.params,
            key_range=(self.lo, self.hi), label=self.label,
        )
        self.engine.snapshot_dir = parent.snapshot_dir

    def span(self) -> tuple[bytes, bytes]:
        return (self.lo, self.hi)

    def shard_name(self) -> str:
        """How a partial answer / typed error names this shard: the
        range label plus the replica addresses an operator can act on."""
        return f"{self.label}@{','.join(self.addrs)}"


class ShardedVectorIndex:
    """Scatter-gather router for one vector index over a sharded store.

    Implements the same `knn(q, k, ctx, ...)` contract as
    TpuVectorIndex (the planner cannot tell them apart); internally it
    maintains one part engine per shard range intersecting the index's
    element keyspace and re-cuts that partition whenever the shard map
    epoch moves."""

    def __init__(self, ns, db, tb, ix, params: dict, backend,
                 telemetry=None):
        from surrealdb_tpu_torch.ops.metrics import normalize_metric

        self.key = (ns, db, tb, ix)
        self.params = params
        self.dim = params["dimension"]
        self.backend = backend
        self.telemetry = telemetry
        self.metric, self.mink_p = normalize_metric(
            params.get("distance", "euclidean")
        )
        self.dtype = _vec_dtype(params)
        self.snapshot_dir = None
        pre = K.ix_state(ns, db, tb, ix, b"he")
        self.he_pre = pre
        self.he_beg, self.he_end = K.prefix_range(pre)
        self.vn_key = K.ix_state(ns, db, tb, ix, b"vn")
        # partition-table lock: pure in-memory bookkeeping ONLY — the lock discipline
        # forbids holding it across any remote dispatch
        self.lock = threading.Lock()
        self.parts: list[_Part] = []
        self.map_epoch = -1
        # version below which the shared op log was last trimmed (this
        # node's view); the router trims in bursts — see _maybe_trim_log
        self._trimmed_ver = 0

    # -- bookkeeping --------------------------------------------------------

    def _count(self, name: str, by: int = 1):
        if self.telemetry is not None:
            self.telemetry.inc(name, by)

    def range_label(self, lo: bytes, hi: bytes) -> str:
        """Short printable label for a slice of the element keyspace
        (the he prefix stripped, boundaries hex-trimmed)."""

        def _p(b):
            if b <= self.he_beg:
                return "-inf"
            if b >= self.he_end:
                return "+inf"
            return b[len(self.he_pre):][:8].hex() or "-inf"

        return f"[{_p(lo)}..{_p(hi)})"

    def refresh_parts(self) -> list:
        """The partition table synced to the backend's CURRENT shard
        map. `shard_map()` may refresh over the network when marked
        stale — called BEFORE the partition lock is taken."""
        m = self.backend.shard_map()
        with self.lock:
            if m.epoch != self.map_epoch or not self.parts:
                self._repartition(m)
            return list(self.parts)

    def _repartition(self, m):
        """Re-cut the partition along shard map `m` (caller holds the
        partition lock; in-memory only). Engines whose range is
        unchanged are kept — their device blocks and ANN graphs stay
        warm; a changed range (split/merge) gets a fresh engine that
        rebuilds from KV truth behind the epoch fence and serves
        brute-exact until its graph rebuilds."""
        old = {p.span(): p for p in self.parts}
        parts = []
        for i in m.covering(self.he_beg, self.he_end):
            s = m.shards[i]
            lo = max(self.he_beg, s.beg)
            hi = self.he_end if s.end is None else min(self.he_end, s.end)
            if lo >= hi:
                continue
            p = old.get((lo, hi))
            if p is None:
                p = _Part(self, lo, hi, s.addrs)
            else:
                # same range, possibly new replica set (failover/move):
                # the warm engine survives, only the address book moves
                p.addrs = tuple(s.addrs)
            parts.append(p)
        self.parts = parts
        self.map_epoch = m.epoch

    def shards_status(self) -> list[dict]:
        """Per-shard index residency (INFO FOR SYSTEM / /metrics):
        rows, host bytes, ANN state, sync version, replica addresses.
        `device_sharded` (device/mesh.py mesh width) rides through each
        part's engine residency when its blocks served on >1 device."""
        with self.lock:
            parts = list(self.parts)
        out = []
        for p in parts:
            d = p.engine.residency()
            d["addrs"] = list(p.addrs)
            out.append(d)
        return out

    def _ann_route(self, k: int):
        """EXPLAIN support: non-None when ANY part serves k-NN of `k`
        from its CAGRA graph (mirrors TpuVectorIndex._ann_route)."""
        with self.lock:
            parts = list(self.parts)
        for p in parts:
            r = p.engine._ann_route(k)
            if r is not None:
                return r
        return None

    def ann_plan(self, k: int):
        """EXPLAIN surface across the parts: segmented wins over the
        legacy graph marker when any part fans over sealed segments
        (each part engine runs its own seal/build/merge lifecycle —
        segment fan-out nests inside the shard scatter-gather)."""
        with self.lock:
            parts = list(self.parts)
        plan = None
        seg_total = ready_total = 0
        for p in parts:
            pp = p.engine.ann_plan(k)
            if pp is None:
                continue
            if pp.get("ann") == "segmented":
                seg_total += pp.get("segments", 0)
                ready_total += pp.get("ready", 0)
                plan = "segmented"
            elif plan is None:
                plan = "graph"
        if plan == "segmented":
            return {"ann": "segmented", "segments": seg_total,
                    "ready": ready_total}
        if plan == "graph":
            return {"ann": "graph"}
        return None

    def ensure_ann(self) -> bool:
        """Synchronous per-part graph builds (benchmarks and tests)."""
        with self.lock:
            parts = list(self.parts)
        return bool(parts) and all(p.engine.ensure_ann() for p in parts)

    def release_device(self):
        """Free every part's device blocks (REMOVE / REBUILD INDEX drops
        the router; its parts' rows would otherwise wait for the
        runner's LRU)."""
        with self.lock:
            parts, self.parts = list(self.parts), []
            self.map_epoch = -1
        for p in parts:
            p.engine.release_device()

    # -- search -------------------------------------------------------------

    def knn(self, q, k: int, ctx, ef=None, cond=None, cond_ctx=None):
        """Top-k nearest records across every shard part (same contract
        as TpuVectorIndex.knn; `ef` is advisory, as there)."""
        import time as _time

        from surrealdb_tpu_torch.telemetry import stage_record

        t0 = _time.perf_counter_ns()
        try:
            return self._knn(q, k, ctx, cond=cond, cond_ctx=cond_ctx)
        finally:
            stage_record("index_knn", _time.perf_counter_ns() - t0)

    def _knn(self, q, k: int, ctx, cond=None, cond_ctx=None):
        # pressure checkpoint before the scatter (no router/part locks
        # held here): part engines register their own vec/ann
        # accounts, so eviction degrades a cold part to rebuild-on-touch
        from surrealdb_tpu_torch import resource as _resource

        _resource.checkpoint()
        qv = _as_vector(q, self.dim, "knn query", self.dtype)
        over = max(float(cnf.KNN_SHARD_OVERSAMPLE), 1.0)
        fetch0 = max(k, int(np.ceil(k * over)))
        # per-query memo: shards that failed once in this query are not
        # re-dispatched by cond-refill rounds (each re-attempt would
        # burn another budget x hedges against a known-dead shard), and
        # a partial answer is counted ONCE per query however many
        # refill rounds flag it
        memo = {"failed": None, "counted": False}
        if cond is None:
            return self._search(qv, fetch0, ctx, memo)[:k]
        # predicate pushdown: oversample + refill (mirrors the
        # node-local engine's cond loop)
        want = k
        fetch = max(4 * k, 64, fetch0)
        checked: set = set()
        out = []
        while True:
            pairs = self._search(qv, fetch, ctx, memo)
            exhausted = len(pairs) < fetch  # every part fully drained
            for rid, dist in pairs:
                h = K.enc_value(rid.id)
                if h in checked:
                    continue
                checked.add(h)
                if self._check_cond(rid, cond, cond_ctx):
                    out.append((rid, dist))
                    if len(out) >= want:
                        return out
            if exhausted:
                return out
            fetch *= 4

    def _check_cond(self, rid, cond, ctx):
        from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record

        doc = fetch_record(ctx, rid)
        if doc is NONE:
            return False
        c = ctx.with_doc(doc, rid)
        return is_truthy(evaluate(cond, c))

    def _search(self, qv: np.ndarray, fetch: int, ctx, memo=None):
        """One scatter-gather round trip, with the partial-result
        policy applied: `error` raises the typed KnnShardUnavailable;
        `partial` serves the healthy parts' merge, flags the statement
        response (executor mailbox -> QueryResult.partial) and counts
        knn_partial_results (once per query — `memo` carries the
        failed-shard set and the counted flag across refill rounds)."""
        known = memo.get("failed") if memo else None
        pairs, failures = scatter_gather(self, qv, fetch, ctx,
                                         known_failed=known)
        if memo is not None:
            memo["failed"] = {f["span"] for f in failures}
        if failures:
            names = sorted({f["shard"] for f in failures})
            detail = "; ".join(
                f"{f['shard']}: {f['error']}" for f in failures
            )
            if str(cnf.KNN_PARTIAL).lower() != "partial":
                raise KnnShardUnavailable(
                    f"knn shard(s) unavailable "
                    f"(SURREAL_KNN_PARTIAL=error): {detail}",
                    shards=names,
                )
            if memo is None or not memo.get("counted"):
                self._count("knn_partial_results")
                if memo is not None:
                    memo["counted"] = True
            ex = getattr(ctx, "executor", None)
            if ex is not None:
                prev = getattr(ex, "_knn_partial", None) or []
                ex._knn_partial = sorted(set(prev) | set(names))
        return pairs


# ---------------------------------------------------------------------------
# scatter / gather (free functions: they call check_deadline, and never
# hold a lock across a remote dispatch)
# ---------------------------------------------------------------------------


def scatter_gather(idx: ShardedVectorIndex, qv: np.ndarray, fetch: int,
                   ctx, known_failed=None):
    """Scatter one KNN query across the index's shard parts, gather
    per-part top-`fetch`, and k-way merge. Returns
    `(pairs, failures)` where `failures` is a list of
    `{"span", "shard", "error"}` records for parts that could not be
    brought to the query's freshness point within their budgets — the
    caller applies the partial policy. Parts whose span is in
    `known_failed` (they already failed earlier in THIS query) are
    not re-dispatched — a cond-refill round must not burn another
    budget x hedges against a known-dead shard. Every pair in `pairs`
    carries an exact distance computed from full-precision rows."""
    from surrealdb_tpu_torch import inflight

    ctx.check_deadline()
    # 1. freshness point: ONE vn read through the query's transaction
    # (per-shard MVCC snapshot — the same consistency the unsharded
    # engine gets from its sync). Budgeted like any shard attempt; if
    # even this is unreachable, no part can prove freshness: fail them
    # all, naming the state shard.
    budget = max(float(cnf.KNN_SHARD_TIMEOUT_S), 0.05)
    try:
        with inflight.activate(_ShardBudget(inflight.current(), budget)):
            ver = ctx.txn.get_val(idx.vn_key) or 0
    except (QueryCancelled, QueryTimeout):
        raise
    except _SHARD_ERRS as e:
        idx._count("knn_shard_fanout")
        shard = _state_shard_name(idx)
        # no part's span: the record still carries the key every caller
        # reads (the reference's omits it, and its caller's KeyError
        # became the query's "Internal error" instead of this failure)
        return [], [{"span": None, "shard": shard, "error": str(e)[:160]}]
    # 2. partition table against the current shard map (in-memory)
    parts = idx.refresh_parts()
    idx._count("knn_shard_fanout", max(len(parts), 1))
    known_failed = known_failed or set()
    skipped = [p for p in parts if p.span() in known_failed]
    live = [p for p in parts if p.span() not in known_failed]
    # 3. sync plan: fetch the shared op log ONCE, route ops per part
    pending = [p for p in live if p.engine.version < ver]
    synced_any = bool(pending)
    routed = _route_log(idx, ctx, ver, pending) if pending else {}
    failures: list[dict] = []
    hedges = max(int(cnf.KNN_SHARD_HEDGES), 0)
    for round_i in range(1 + hedges):
        ctx.check_deadline()
        if round_i > 0:
            if not pending:
                break
            # bounded hedged retry: the failure may be a failover or a
            # split — refresh the map, re-cut the partition, and
            # re-dispatch only what is still stale. The group pool
            # follows promotions, so a promoted replica answers this.
            # The map refresh runs under a shard budget too — a sick
            # meta shard must not eat the query either.
            idx._count("knn_hedged_dispatches", len(pending))
            try:
                with inflight.activate(
                    _ShardBudget(inflight.current(), budget)
                ):
                    idx.backend.refresh_map()
            except _SHARD_ERRS:
                pass  # hedge against the stale map, better than nothing
            parts = idx.refresh_parts()
            skipped = [p for p in parts if p.span() in known_failed]
            live = [p for p in parts if p.span() not in known_failed]
            pending = [p for p in live if p.engine.version < ver]
            routed = _route_log(idx, ctx, ver, pending) if pending else {}
        failures = _scatter_round(idx, ctx, ver, pending, routed)
        pending = [p for p in live
                   if any(f["span"] == p.span() for f in failures)]
        if not pending:
            break
    for p in skipped:
        failures.append(_failure(
            p, "unavailable earlier in this query (not re-dispatched)"
        ))
    if not failures and synced_any:
        _maybe_trim_log(idx, ctx, parts, ver)
    # 4. per-part local top-k (pure compute — by part_sync's lock
    # discipline nothing here can block on a remote shard)
    failed_spans = {f["span"] for f in failures}
    serving = [p for p in parts if p.span() not in failed_spans]
    ctx.check_deadline()
    lists = _search_parts(idx, ctx, serving, qv, fetch)
    pairs = merge_topk(ctx, lists, fetch)
    return pairs, failures


def _search_parts(idx, ctx, serving, qv, fetch):
    """Per-part top-k, in part order. Sequential by default: the
    local searches are one BLAS/kernel call each, and on a GIL-bound
    host extra worker threads per query measurably LOSE to the
    straight loop (concurrency comes from the per-part cross-query
    batchers instead). SURREAL_KNN_SCATTER=threads opts into a
    thread fan-out for many-core hosts where each part's gemm
    genuinely parallelizes."""
    mode = str(cnf.KNN_SCATTER).lower()
    parallel = len(serving) > 1 and mode == "threads"
    if not parallel:
        out = []
        for p in serving:
            ctx.check_deadline()
            out.append(p.engine.search_topk(qv, fetch))
        return out
    slots = [None] * len(serving)
    errs = []

    def work(i, p):
        try:
            slots[i] = p.engine.search_topk(qv, fetch)
        except BaseException as e:
            # a local-search crash is a BUG, not a shard failure —
            # swallowing it would be exactly the silent loss this
            # module exists to forbid: surface it to the query
            errs.append(e)

    threads = [
        threading.Thread(target=work, args=(i, p), daemon=True,
                         name=f"knn-search-{i}")
        for i, p in enumerate(serving[1:], start=1)
    ]
    for t in threads:
        t.start()
    work(0, serving[0])  # this thread takes the first part
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return [s if s is not None else [] for s in slots]


def merge_topk(ctx, lists: list, k: int):
    """K-way merge of per-shard ascending `(rid, dist)` lists into the
    global top-k. Exact parts make the merge exact: each list is that
    part's true top-k, the parts partition the rows, so the k smallest
    of the union ARE the global top-k. Ties keep shard order (stable)."""
    import heapq

    ctx.check_deadline()
    out = []
    for item in heapq.merge(*lists, key=lambda pair: pair[1]):
        out.append(item)
        if len(out) >= k:
            break
    return out


def _scatter_round(idx, ctx, ver, pending, routed) -> list[dict]:
    """Dispatch one sync round over the stale parts; returns the
    failure records (span + shard name + error). Parallel worker
    threads on real transports for read-only queries; sequential
    otherwise (the deterministic simulator must own all interleaving)."""
    if not pending:
        return []
    failures = []
    mode = str(cnf.KNN_SCATTER).lower()
    parallel = len(pending) > 1 and mode != "seq" and (
        mode == "threads"
        or (mode == "auto" and idx.backend.transport is None)
    )
    if parallel:
        # shared-transaction safety: lazy sub-txn creation and
        # wrong-shard re-routing both mutate ShardTx state — pre-pin
        # every involved shard from THIS thread, and only fan out when
        # the transaction holds no writes (a write txn re-routes by
        # aborting, which must stay single-threaded)
        shard_tx = getattr(ctx.txn, "btx", None)
        prepin = getattr(shard_tx, "prepin", None)
        if prepin is None or shard_tx._any_writes():
            parallel = False
        else:
            pinned = []
            for p in pending:
                try:
                    prepin(p.lo)
                    pinned.append(p)
                except (QueryCancelled, QueryTimeout):
                    raise
                except _SHARD_ERRS as e:
                    failures.append(_failure(p, e))
            pending = pinned
    if parallel and len(pending) > 1:
        slots: dict = {}

        def work(p):
            try:
                slots[p.span()] = _sync_part(
                    idx, ctx, p, ver, routed.get(p.span())
                )
            except (QueryCancelled, QueryTimeout):
                slots[p.span()] = "query cancelled/timed out mid-scatter"
            except BaseException as e:
                slots[p.span()] = f"{type(e).__name__}: {e}"[:160]

        threads = [
            threading.Thread(target=work, args=(p,), daemon=True,
                             name=f"knn-scatter-{i}")
            for i, p in enumerate(pending)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()  # bounded: every KV op inside runs under the
            #           part's _ShardBudget via the inflight seam
        for p in pending:
            err = slots.get(p.span())
            if err is not None:
                failures.append(_failure(p, err))
        return failures
    for p in pending:
        ctx.check_deadline()
        try:
            err = _sync_part(idx, ctx, p, ver, routed.get(p.span()))
        except (QueryCancelled, QueryTimeout):
            raise
        if err is not None:
            failures.append(_failure(p, err))
    return failures


def _failure(part, err) -> dict:
    return {
        "span": part.span(),
        "shard": part.shard_name(),
        "error": str(err)[:160],
    }


def _sync_part(idx, ctx, part, ver, entries):
    """One per-shard scatter attempt: bring `part` to version `ver`
    under its own budget (carved from the query's remaining deadline
    through the inflight thread-local — the KV retry policy then
    bounds itself to the shard's slice). Returns None on success, the
    error string on failure."""
    from surrealdb_tpu_torch import inflight

    budget = max(float(cnf.KNN_SHARD_TIMEOUT_S), 0.05)
    try:
        with inflight.activate(
            _ShardBudget(inflight.current(), budget)
        ):
            part.engine.part_sync(ctx, ver, entries)
        return None
    except (QueryCancelled, QueryTimeout):
        raise
    except _SHARD_ERRS as e:
        return str(e)[:160]


def _route_log(idx, ctx, ver, pending) -> dict:
    """Fetch the shared op log once and route its entries to the stale
    parts by element-key range. Returns `{span: entries | None}` —
    None means that part must range-rebuild (fresh part, or the log
    no longer covers its gap). Log trouble is NOT a failure here:
    every part just falls back to its own range rebuild."""
    out: dict = {p.span(): None for p in pending}
    floors = [p.engine.version for p in pending if p.engine.version >= 0]
    if not floors:
        return out
    base = min(floors)
    gap = ver - base
    total = sum(len(p.engine.rids) for p in pending)
    if gap <= 0 or gap > max(4096, total // 4):
        return out
    from surrealdb_tpu_torch import inflight

    ns, db, tb, ix = idx.key
    beg = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(base + 1))
    end = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(ver)) + b"\x00"
    try:
        # budgeted like every other shard attempt: a sick log shard
        # burns at most one shard budget here, then the parts fall
        # back to their own (individually budgeted) range rebuilds
        with inflight.activate(_ShardBudget(
            inflight.current(), max(float(cnf.KNN_SHARD_TIMEOUT_S),
                                    0.05)
        )):
            entries = list(ctx.txn.scan_vals(beg, end))
    except (QueryCancelled, QueryTimeout):
        raise
    except _SHARD_ERRS:
        return out
    if len(entries) != gap:
        return out  # trimmed/gappy log: rebuild instead
    routed: dict = {
        p.span(): [] for p in pending if p.engine.version >= 0
    }
    spans = [(p.span(), p.lo, p.hi) for p in pending
             if p.engine.version >= 0]
    for i, (_k, (op, idv, raw)) in enumerate(entries):
        gver = base + 1 + i
        hk = idx.he_pre + K.enc_value(idv)
        for span, lo, hi in spans:
            if lo <= hk < hi:
                routed[span].append((gver, op, idv, raw))
                break
    out.update(routed)
    return out


def _maybe_trim_log(idx, ctx, parts, ver):
    """Trim the shared op log once every part has consumed it. Part
    engines never trim (idx/vector.py gates the unsharded trim on
    `key_range is None`), so the ROUTER owns log growth: when every
    part reached `ver`, the query's transaction can write, and at
    least 1024 entries accumulated since the last trim, buffer a
    delete of the consumed range into this transaction (TRIM_LOG_
    ENTRIES bounds the burst size). Another serving node mid-catch-up
    simply finds the gap and range-rebuilds — the same discipline as
    the unsharded multi-node trim."""
    if not getattr(ctx.txn, "write", False):
        return
    if ver - idx._trimmed_ver < TRIM_LOG_ENTRIES:
        return
    if any(p.engine.version < ver for p in parts):
        return
    ns, db, tb, ix = idx.key
    beg = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(0))
    end = K.ix_state(ns, db, tb, ix, b"hl", K.enc_u64(ver)) + b"\x00"
    try:
        ctx.txn.delete_range(beg, end)
    except (QueryCancelled, QueryTimeout):
        raise
    except _SHARD_ERRS:
        return  # trimming is best-effort; the next burst retries
    idx._trimmed_ver = ver


def _state_shard_name(idx) -> str:
    """Name the shard holding the index's version/log state keys (what
    a partial answer blames when even freshness is unprovable)."""
    try:
        m = idx.backend.shard_map()
        s = m.shards[m.locate(idx.vn_key)]
        return (f"{idx.range_label(max(idx.he_beg, s.beg), idx.he_end)}"
                f"@{','.join(s.addrs)}")
    except _SHARD_ERRS:
        return "index-state shard (map unavailable)"
