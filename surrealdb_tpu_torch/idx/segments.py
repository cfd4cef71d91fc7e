"""Segmented LSM-style ANN: continuous ingest without rebuild stalls
(the reference package's `idx/segments.py`).

The whole-store graph overlay (idx/vector.py + idx/cagra.py) rebuilds
the WHOLE index once drift passes KNN_ANN_TAIL_FRAC and brute-merges
the dirty tail per query: under sustained writes that is a rebuild
treadmill with a growing exact-scan tax. This module splits the
overlay over the engine's host arrays:

- **Mutable tail.** Writes land in the un-sealed suffix of the host
  arrays (rows `[sealed_hi, n)`), served exactly: a committed row is
  searchable on the very next sync, no build in the ingest path.
- **Sealed segments.** A seal policy (row count / byte size / age,
  `SURREAL_KNN_SEG_*`) freezes the tail into an immutable row span; a
  background job builds that span's own CAGRA graph, pausing at chunk
  boundaries through `resource.throttle`. A segment's graph covers the
  rows VALID at its snapshot (`row_map`), so sealing already compacts
  tombstones out of the graph.
- **Tiered merges.** When `KNN_SEG_FANOUT` adjacent segments share a
  geometric size tier, a background job builds one graph over their
  combined span and splices it in: the segment count stays O(log n)
  and merges are where tombstones leave the graphs.
- **Per-segment staleness.** Deletes flip the engine's `valid` slice;
  a segment whose dead + overwritten fraction passes
  `KNN_SEG_TOMB_FRAC` gets ITS graph rebuilt (bounded work), so
  `ann_full_rebuilds` stays 0.
- **Exact fan-out.** A query runs a per-segment top-k (graph descent +
  exact re-rank where a graph is ready, an exact scan otherwise, with
  oversampling scaled by the segment's tombstone density so a dense
  segment cannot underfill k) and k-way merges the lists through
  `idx/shardvec.py merge_topk`: the segments partition the rows and
  every list is exact over its rows, so the merge is exact.

Each sealed graph persists as an `SKVANN01` file keyed by the content
hash of its rows (a sealed span is immutable), ships to the runner as
a device block of its own (`dev_key` "ann/seg-<uuid>", through the
supervisor's (key, tag) protocol, so each segment is shipped and
evicted on its own), and registers an `ann` account with the port's
accountant (the tail is covered by the engine's `vec` account).

This module imports neither torch nor CUDA: a descent reaches the card
through the engine's supervisor entry. Where the device cannot serve a
descent, the numpy descent answers, the supervisor counts the fallback
and the engine counts `ann_host_descents`, as on the whole-store path.

Lock order: engine locks (lock / rw / _ann_lock) are always taken
BEFORE the segment-table lock, never after it; maintenance jobs
capture array snapshots under `rw.read()`, release, and only then
touch the table lock, so a seal or a merge can never wedge a searcher.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np

from surrealdb_tpu_torch import cnf, resource

# process-wide AGGREGATE counters (fixed keys, trivially bounded).
# Gates that must be isolated from other engines/datastores in the
# process assert on the ENGINE-scoped views instead: SegmentedAnn.stats
# (per coordinator) and TpuVectorIndex.ann_full_rebuilds.
_COUNTERS = {
    "ann_full_rebuilds": 0,
    "seg_seals": 0,
    "seg_builds": 0,
    "seg_merges": 0,
    "seg_rebuilds": 0,
}
_COUNTER_LOCK = threading.Lock()


def count(name: str, by: int = 1):
    with _COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + by


def counters() -> dict:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def reset_counters():
    with _COUNTER_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


class _NoDeadline:
    """merge_topk ctx shim for engine-internal merges (the statement
    deadline is enforced by the serving layers above knn_batch)."""

    __slots__ = ()

    def check_deadline(self):
        pass


_NOCTX = _NoDeadline()


def _seg_mode() -> str:
    return str(cnf.KNN_SEG_MODE).lower()


class SealedSegment:
    """One immutable row span `[lo, hi)` of the engine's host arrays,
    plus the CAGRA graph built over the rows valid at its snapshot.

    The built graph lives in `graph`, ONE tuple `(ann, row_map)`
    assigned atomically (a searcher captures the pair together — a
    concurrent rebuild installing a new graph can never tear a query
    into old node ids against a new row map). `row_map` maps graph
    node ids to GLOBAL row numbers; None means the identity
    `lo + node` (the all-valid fast path — the graph was built straight
    over the array slice, no gather copy). `state`: `pending` (no
    graph yet — served exact), `ready` (graph serving), `empty` (no
    valid rows at snapshot — skipped). A segment never mutates rows;
    engine-side tombstones/overwrites are observed through `valid` /
    `_ann_dirty` at query time."""

    __slots__ = ("lo", "hi", "sid", "state", "graph", "_tlock",
                 "dev_key", "seq", "acct", "__weakref__")

    def __init__(self, lo: int, hi: int, sid: int, label: str,
                 tlock: threading.Lock):
        self.lo = int(lo)
        self.hi = int(hi)
        self.sid = int(sid)
        self.state = "pending"
        self.graph = None  # (AnnIndex, row_map | None), set atomically
        # the coordinator's table lock: graph installs happen under it,
        # so the accountant's evict callback takes it too — an eviction
        # can never discard a graph installed concurrently (or report
        # bytes freed for an install that landed just after)
        self._tlock = tlock
        # one independently shippable/evictable device block per
        # segment, through the supervisor's (key, tag) protocol
        self.dev_key = f"ann/seg-{uuid.uuid4().hex[:16]}"
        self.seq = 0
        # accounting: the sealed graph is ann-class derived
        # state; eviction degrades this ONE segment to exact scans
        # until the background rebuild returns
        self.acct = resource.register(
            "ann", f"{label}/seg{self.sid}", self._ann_bytes,
            evict=self._evict_graph, owner=self,
        )

    def span(self) -> int:
        return self.hi - self.lo

    def _ann_bytes(self) -> int:
        g = self.graph
        if g is None:
            return 0
        ann, rm = g
        b = int(ann.nbytes())
        if rm is not None:
            b += int(rm.nbytes)
        return b

    def _evict_graph(self):
        # drop this segment's graph only: exact scans serve the span
        # (answers stay exact, just slower) until a rebuild lands.
        # Under the table lock so a concurrent install can't be
        # discarded the instant it lands (evict callbacks run from
        # checkpoint sites that hold no segment/engine locks)
        with self._tlock:
            if self.state == "ready":
                self.graph = None
                self.state = "pending"

    def close(self):
        with self._tlock:
            self.graph = None
            self.state = "closed"
        self.acct.close()

    def status(self) -> dict:
        out = {"lo": self.lo, "hi": self.hi, "state": self.state}
        g = self.graph
        if g is not None:
            out["graph_rows"] = int(g[0].built_n)
            out["bytes"] = int(g[0].nbytes())
        return out


class SegmentedAnn:
    """Segment coordinator for one TpuVectorIndex: the seal / build /
    merge policies, the background maintenance worker, and the
    per-segment search fan-out. Created lazily by the engine; `reset()`
    voids everything on a repack/eviction (row numbering died)."""

    def __init__(self, engine):
        self.engine = engine
        # segment-table lock: pure bookkeeping — never held across a
        # build, a KV op, or any engine-lock acquisition (lock order:
        # engine locks strictly before this one)
        self.lock = threading.Lock()
        # ascending, contiguous-from-0 sealed spans
        self.segs: list[SealedSegment] = []
        self.gen = 0            # bumped on reset: voids in-flight jobs
        self._sid = 0
        self._maint_running = False
        self._closed = False    # close(): no job starts any more
        # engine-scoped counter view (same keys as the module
        # aggregate): what the churn gates assert on — counts from
        # OTHER engines/datastores in the process can never leak in
        self.stats = {k: 0 for k in _COUNTERS}
        self._tail_born = None  # monotonic stamp for the age seal
        # change detection so per-sync maintenance stays O(1) when idle
        self._seen_mut = -1
        self._seen_dead = -1

    def _count(self, name: str, by: int = 1):
        # single-writer per key in practice (seals under the table
        # lock, installs on the one maintenance worker); the module
        # aggregate keeps its own lock
        self.stats[name] = self.stats.get(name, 0) + by
        count(name, by)

    # -- policy -------------------------------------------------------------

    def engaged(self) -> bool:
        """Whether segmented serving governs this engine right now."""
        mode = _seg_mode()
        if mode == "off":
            return False
        eng = self.engine
        if cnf.KNN_ANN_MODE == "off" or eng.metric not in (
            "euclidean", "cosine", "dot"
        ):
            return False
        if self.segs:
            return True
        n = len(eng.rids)
        if mode == "force":
            return n >= 16
        return n >= int(cnf.KNN_SEG_MIN_ROWS)

    def active(self) -> bool:
        """Whether queries should fan over segments (at least one
        sealed span exists and the mode still allows it)."""
        return bool(self.segs) and _seg_mode() != "off"

    def _seal_rows(self) -> int:
        return max(int(cnf.KNN_SEG_ROWS), 16)

    def _sealed_hi(self) -> int:
        return self.segs[-1].hi if self.segs else 0

    def _tier(self, rows: int) -> int:
        f = max(int(cnf.KNN_SEG_FANOUT), 2)
        base = self._seal_rows()
        t = 0
        while rows >= base * (f ** (t + 1)) and t < 32:
            t += 1
        return t

    # -- maintenance entry (post-sync, no engine locks held) ----------------

    def maybe_maintain(self):
        """Cheap per-sync policy check; kicks the background worker
        when there is sealing, building, or merging to do."""
        if not self.engaged():
            return
        self._adopt_legacy()
        dirty = self._dirty_snapshot()  # engine lock BEFORE table lock
        with self.lock:
            work = self._seal_locked() or self._has_jobs_locked(dirty)
        if work:
            self._kick()

    def _adopt_legacy(self):
        """An engine crossing into segmented mode with a legacy
        whole-store graph already built keeps serving it: the graph
        becomes the first sealed segment (rows it covered), and the
        leftover suffix becomes the mutable tail — no rebuild, no
        serving gap."""
        eng = self.engine
        if self.segs or eng._ann is None:
            return
        with eng._ann_lock:
            ann = eng._ann
            if ann is None or ann.metric != eng.metric:
                return
            if ann.built_n <= 0 or ann.built_n > len(eng.rids):
                return
            eng._ann = None  # the segment's account covers it now
            if eng._ann_state == "ready":
                eng._ann_state = "idle"
        with self.lock:
            if self.segs:
                return
            seg = self._new_seg_locked(0, ann.built_n)
            # the legacy graph includes rows already dead at its build;
            # counting them all as staleness just schedules one bounded
            # segment rebuild that compacts them out — never a stall
            seg.graph = (ann, None)
            seg.seq = 1
            seg.state = "ready"
            self.segs.append(seg)
        # the whole-store block the legacy path shipped is orphaned
        # now (the segment ships under its own key on first use)
        self._drop_dev_blocks([eng._ann_dev_key])

    def _new_seg_locked(self, lo: int, hi: int) -> SealedSegment:
        self._sid += 1
        eng = self.engine
        label = f"{eng.key[2]}.{eng.key[3]}"
        return SealedSegment(lo, hi, self._sid, label, self.lock)

    def _seal_locked(self) -> bool:
        """Apply the seal policy (caller holds the table lock). The
        FIRST seal takes the whole tail as one segment (a bulk load
        builds one big graph, exactly like the legacy path); steady
        ingest afterwards seals in `KNN_SEG_ROWS` chunks."""
        eng = self.engine
        n = len(eng.rids)
        hi = self._sealed_hi()
        tail = n - hi
        if tail <= 0:
            self._tail_born = None
            return False
        if self._tail_born is None:
            self._tail_born = time.monotonic()
        rows_floor = self._seal_rows()
        itemsize = np.dtype(eng.dtype).itemsize
        bytes_hit = tail * eng.dim * itemsize >= max(
            int(cnf.KNN_SEG_BYTES), 1 << 20
        )
        age = float(cnf.KNN_SEG_AGE_S)
        age_hit = age > 0 and (time.monotonic() - self._tail_born) >= age
        sealed = False
        if not self.segs and (tail >= rows_floor or bytes_hit or age_hit):
            self.segs.append(self._new_seg_locked(0, n))
            sealed = True
        else:
            while self.segs and n - self._sealed_hi() >= rows_floor:
                lo = self._sealed_hi()
                self.segs.append(
                    self._new_seg_locked(lo, lo + rows_floor)
                )
                sealed = True
            if self.segs and (bytes_hit or age_hit) \
                    and n > self._sealed_hi():
                lo = self._sealed_hi()
                self.segs.append(self._new_seg_locked(lo, n))
                sealed = True
        if sealed:
            self._count("seg_seals")
            self._tail_born = None if n == self._sealed_hi() else \
                time.monotonic()
        return sealed

    def _dirty_snapshot(self) -> list:
        """Stable copy of the engine's dirty-row keys, taken under the
        engine's ann lock and BEFORE any table-lock acquisition — the
        log applier mutates the dict concurrently, and the module's
        lock order forbids taking engine locks inside the table lock."""
        with self.engine._ann_lock:
            return list(self.engine._ann_dirty)

    def _stale_locked(self, seg: SealedSegment, dirty_keys) -> bool:
        """Segment-local staleness: dead graph rows + overwritten rows
        in the span, over the graph size — past KNN_SEG_TOMB_FRAC the
        segment's graph is rebuilt (and its dead rows compacted out)."""
        g = seg.graph
        if g is None or seg.state != "ready":
            return False
        ann, row_map = g
        eng = self.engine
        valid = eng.valid
        if seg.hi > len(valid):
            return False  # racing a reset; the next pass re-checks
        if row_map is not None:
            dead = int(np.count_nonzero(~valid[row_map]))
        else:
            # identity graphs are only built over all-valid spans (and
            # the adopted legacy graph counts its build-time dead rows
            # as staleness on purpose — one bounded rebuild compacts
            # them out), so every invalid row in the span is drift
            dead = int(np.count_nonzero(~valid[seg.lo:seg.hi]))
        dirty = sum(1 for r in dirty_keys if seg.lo <= r < seg.hi)
        frac = max(float(cnf.KNN_SEG_TOMB_FRAC), 0.01)
        return (max(dead, 0) + dirty) / max(ann.built_n, 1) > frac

    def _merge_run_locked(self):
        """First adjacent same-tier run of KNN_SEG_FANOUT ready/pending
        segments, lowest tier preferred (cheapest compaction first)."""
        f = max(int(cnf.KNN_SEG_FANOUT), 2)
        best = None
        tiers = [self._tier(s.span()) for s in self.segs]
        i = 0
        while i < len(self.segs):
            j = i
            while (
                j < len(self.segs)
                and tiers[j] == tiers[i]
                and self.segs[j].state in ("pending", "ready", "empty")
            ):
                j += 1
            if j - i >= f and (best is None or tiers[i] < best[0]):
                best = (tiers[i], i, i + f)
            i = max(j, i + 1)
        if best is None:
            return None
        _t, a, b = best
        return list(self.segs[a:b])

    def _has_jobs_locked(self, dirty_keys) -> bool:
        if any(s.state == "pending" for s in self.segs):
            return True
        eng = self.engine
        # capture the counters BEFORE the sweep: a mutation landing
        # mid-sweep must leave them unequal so the next sync re-checks
        # the staleness it may have just created
        mut, dead = eng._ann_mut, eng._ann_dead
        if (mut, dead) == (self._seen_mut, self._seen_dead):
            # nothing mutated since the last staleness sweep and no
            # pending builds: the only remaining job source is a merge
            return self._merge_run_locked() is not None
        if any(self._stale_locked(s, dirty_keys) for s in self.segs):
            # do NOT advance the seen counters: if this kick races the
            # worker's exit, the next sync re-detects the stale segment
            # instead of stranding it until the next mutation
            return True
        self._seen_mut, self._seen_dead = mut, dead
        return self._merge_run_locked() is not None

    # -- background worker --------------------------------------------------

    def _kick(self):
        with self.lock:
            if self._maint_running:
                return
            self._maint_running = True
        threading.Thread(
            target=self._maint_loop, daemon=True, name="seg-maint"
        ).start()

    def _maint_loop(self):
        try:
            while True:
                job = self._next_job()
                if job is None:
                    return
                if not self._run_job(job):
                    # a failed job (build error, snapshot race) is
                    # retried at SYNC cadence, not in a hot loop: exit
                    # and let the next maybe_maintain re-kick — exact
                    # scans serve the span meanwhile
                    return
        finally:
            with self.lock:
                self._maint_running = False

    def _next_job(self):
        """(kind, payload, gen) or None; picked under the table lock.
        Seal-builds first (ingest freshness), then stale-segment
        rebuilds, then tier merges (throughput)."""
        dirty = self._dirty_snapshot()  # engine lock BEFORE table lock
        with self.lock:
            if self._closed:
                return None
            gen = self.gen
            for s in self.segs:
                if s.state == "pending":
                    return ("build", s, gen)
            for s in self.segs:
                if self._stale_locked(s, dirty):
                    return ("rebuild", s, gen)
            run = self._merge_run_locked()
            if run is not None:
                return ("merge", run, gen)
        return None

    def _run_job(self, job) -> bool:
        """Run one job; False = it failed (caller stops draining the
        queue — the next sync retries instead of a hot loop)."""
        kind, payload, gen = job
        if kind in ("build", "rebuild"):
            return self._build_segment(payload, gen,
                                       rebuild=(kind == "rebuild"))
        return self._merge_segments(payload, gen)

    # -- builds -------------------------------------------------------------

    def _capture(self, lo: int, hi: int):
        """Snapshot the span under the read lock: the arrays are
        append-stable (a captured reference keeps its length) and the
        valid slice is copied, so the build never observes a torn
        bitmap; rows overwritten after `mut_cut` stay dirty and keep
        brute-merging (the legacy snapshot discipline, per segment)."""
        eng = self.engine
        with eng.rw.read():
            if hi > len(eng.rids):
                return None
            xs = eng.vecs
            vmask = eng.valid[lo:hi].copy()
            mut_cut = eng._ann_mut
        return xs, vmask, mut_cut

    def _build_ann_for(self, xs, vmask, lo: int, hi: int):
        """(ann, row_map) over the span's valid rows. All-valid spans
        build straight over the array slice (no copy); otherwise the
        valid rows gather through an explicit row_map — which is
        exactly how tombstones compact out of a graph."""
        from surrealdb_tpu_torch.idx import cagra

        span = hi - lo
        live = int(np.count_nonzero(vmask))
        if live == 0:
            return None, None
        if live == span:
            row_map = None
            xs_b = xs[lo:hi]
        else:
            row_map = (np.flatnonzero(vmask) + lo).astype(np.int64)
            resource.throttle("seg_build")  # before the gather copy
            xs_b = np.ascontiguousarray(xs[row_map])
        # hash the span bytes ONCE: load and save share the path
        path = self._snap_path(xs_b)
        ann = self._load_snapshot(path, xs_b)
        if ann is None:
            ann = cagra.build_index(xs_b, self.engine.metric, 0, 0)
            self._save_snapshot(path, ann, xs_b)
        return ann, row_map

    def _build_segment(self, seg: SealedSegment, gen: int,
                       rebuild: bool = False) -> bool:
        cap = self._capture(seg.lo, seg.hi)
        if cap is None:
            return False  # reset raced the job: retry at sync cadence
        xs, vmask, mut_cut = cap
        try:
            ann, row_map = self._build_ann_for(
                xs, vmask, seg.lo, seg.hi
            )
        except Exception:
            # exact scans keep serving; the next sync retries (the
            # worker exits rather than hot-looping on a sick build)
            return False
        with self.lock:
            if self.gen != gen or seg not in self.segs \
                    or seg.state == "closed":
                return True  # obsolete job, not a failure
            if ann is None:
                seg.graph = None
                seg.state = "empty"
            else:
                seg.graph = (ann, row_map)
                seg.seq += 1
                seg.state = "ready"
        self._prune_dirty(seg.lo, seg.hi, mut_cut)
        self._count("seg_rebuilds" if rebuild else "seg_builds")
        seg.acct.touch()
        # the install grew accounted bytes by a step: settle pressure
        # NOW with a fresh poll (the legacy ANN-install discipline)
        resource.checkpoint(fresh=True)
        return True

    def _merge_segments(self, run: list, gen: int) -> bool:
        lo, hi = run[0].lo, run[-1].hi
        cap = self._capture(lo, hi)
        if cap is None:
            return False
        xs, vmask, mut_cut = cap
        try:
            ann, row_map = self._build_ann_for(xs, vmask, lo, hi)
        except Exception:
            return False
        with self.lock:
            if self.gen != gen:
                return True  # obsolete job, not a failure
            try:
                a = self.segs.index(run[0])
            except ValueError:
                return True  # the run was re-cut under us: drop it
            if self.segs[a:a + len(run)] != run:
                return True
            merged = self._new_seg_locked(lo, hi)
            merged.graph = (ann, row_map) if ann is not None else None
            merged.seq = 1
            merged.state = "ready" if ann is not None else "empty"
            self.segs[a:a + len(run)] = [merged]
        # in-flight queries hold their captured segment list: the old
        # graphs stay alive (and correct) until those queries finish
        for s in run:
            s.close()
        # the retired segments' runner blocks are dead weight now:
        # release them (best-effort, worker thread, no engine locks)
        self._drop_dev_blocks([s.dev_key for s in run])
        self._prune_dirty(lo, hi, mut_cut)
        self._count("seg_merges")
        merged.acct.touch()
        resource.checkpoint(fresh=True)
        return True

    def _drop_dev_blocks(self, keys):
        """Best-effort release of retired segments' device blocks so
        dead graphs stop competing with live ones for runner memory.
        Only when the runner is actively serving — a cold/degraded
        supervisor holds no blocks worth a spawn, and the runner's own
        LRU + byte budget reclaims anything this misses."""
        from surrealdb_tpu_torch.device import get_supervisor

        try:
            sup = get_supervisor()
            if not sup.fast_path():
                return
            for k in keys:
                sup.forget(k)
                try:
                    sup.call("ann_drop", {"key": k, "tag": []}, [])
                except Exception:
                    pass  # reclaimed by the runner budget eventually
        except Exception:
            pass

    def _prune_dirty(self, lo: int, hi: int, mut_cut: int):
        """Rows in the span overwritten BEFORE the snapshot hold their
        new values in the build (writers exclude the capture via the
        rw lock); rows stamped after stay dirty and keep brute-merging."""
        eng = self.engine
        with eng._ann_lock:
            eng._ann_dirty = {
                r: g for r, g in eng._ann_dirty.items()
                if g > mut_cut or not (lo <= r < hi)
            }

    # -- lifecycle ----------------------------------------------------------

    def reset(self):
        """Void every segment (repack / vec eviction: the global row
        numbering died). Caller may hold engine locks — this only takes
        the table lock (engine-before-table order)."""
        with self.lock:
            self.gen += 1
            old, self.segs = self.segs, []
            self._tail_born = None
            self._seen_mut = -1
            self._seen_dead = -1
        for s in old:
            s.close()

    def close(self, timeout_s: float = 60.0):
        """Stop maintenance for good (the datastore is closing): no
        further job starts, every segment is voided, and a job in
        flight is waited for up to `timeout_s` (its result is
        discarded: the generation moved on)."""
        with self.lock:
            self._closed = True
        self.reset()
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self.lock:
                if not self._maint_running:
                    return
            time.sleep(0.01)

    def drain(self, timeout_s: float = 600.0) -> bool:
        """Synchronous maintenance to quiescence (bench/tests): run
        jobs inline until none remain, then report whether every
        segment serves from a graph."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self.lock:
                busy = self._maint_running
                if not busy:
                    self._maint_running = True
            if busy:
                time.sleep(0.01)
                continue
            try:
                with self.lock:
                    self._seal_locked()
                job = self._next_job()
                if job is None:
                    break
                if not self._run_job(job):
                    break  # sick job: report un-drained, don't spin
            finally:
                with self.lock:
                    self._maint_running = False
        with self.lock:
            return bool(self.segs) and all(
                s.state in ("ready", "empty") for s in self.segs
            )

    def status(self) -> dict:
        with self.lock:
            segs = list(self.segs)
        n = len(self.engine.rids)
        hi = segs[-1].hi if segs else 0
        out = {
            "segments": len(segs),
            "ready": sum(1 for s in segs if s.state == "ready"),
            "tail_rows": max(n - hi, 0),
            "stats": dict(self.stats),
            "spans": [s.status() for s in segs],
        }
        # segment descents ride the engine's ann blocks, so the mesh
        # width the runner reported for them is the segment truth too
        nd = int(getattr(self.engine, "_dev_mesh_ann", 0) or 0)
        if nd > 1:
            out["device_sharded"] = nd
        return out

    # -- search fan-out -----------------------------------------------------

    def knn_batch(self, qvs: np.ndarray, k: int):
        """Per-query top-k over the segment fan-out: one exact list per
        sealed span (graph descent + exact re-rank when ready, exact
        scan otherwise), one for the mutable tail, k-way merged through
        `merge_topk`. Caller holds the engine read lock (the
        knn_batch contract), so the arrays are stable throughout."""
        from surrealdb_tpu_torch.idx.shardvec import merge_topk

        eng = self.engine
        with self.lock:
            segs = list(self.segs)
        n = len(eng.rids)
        b = len(qvs)
        with eng._ann_lock:
            dirty = list(eng._ann_dirty)
        lists = []  # one [per-query results] entry per span
        for seg in segs:
            lo, hi = seg.lo, min(seg.hi, n)
            if lo >= hi:
                continue
            g = seg.graph  # atomic capture: (ann, row_map) together
            if g is None:
                if seg.state == "empty" and not any(
                    lo <= r < hi for r in dirty
                ):
                    continue
                lists.append(self._exact_span(qvs, k, lo, hi))
            else:
                lists.append(
                    self._graph_span(qvs, k, seg, g[0], g[1], dirty)
                )
        hi = segs[-1].hi if segs else 0
        if hi < n:
            lists.append(self._exact_span(qvs, k, hi, n))
        out = []
        for i in range(b):
            out.append(merge_topk(_NOCTX, [l[i] for l in lists], k))
        return out

    def _exact_span(self, qvs, k: int, lo: int, hi: int):
        """Exact per-span top-k. Reported distances always come from
        the engine's f64 ladder; big product-metric spans rank through the
        engine's two-stage BLAS discipline first (one f32 gemm over
        the slice, exact rescore of the oversampled candidates) —
        exactly how the whole-store brute path serves them — while
        small spans and exotic metrics run the ladder directly."""
        eng = self.engine
        from surrealdb_tpu_torch.idx import vector as _vector

        span = hi - lo
        vmask = eng.valid[lo:hi]
        nvalid = int(np.count_nonzero(vmask))
        if nvalid == 0:
            return [[] for _ in range(len(qvs))]
        k_eff = min(k, nvalid)
        if span >= _vector.DEVICE_MIN_ROWS and eng.metric in (
            "euclidean", "cosine", "dot"
        ):
            return self._exact_span_blas(qvs, k_eff, lo, hi, vmask)
        xs = eng.vecs[lo:hi]
        out = []
        for qv in qvs:
            d = eng._host_distances(qv, xs=xs)
            d = np.where(vmask, d, np.inf)
            sel = np.argpartition(d, k_eff - 1)[:k_eff]
            sel = sel[np.argsort(d[sel], kind="stable")]
            out.append([
                (eng.rids[lo + int(j)], float(d[j]))
                for j in sel
                if np.isfinite(d[j])
            ])
        return out

    def _exact_span_blas(self, qvs, k_eff: int, lo: int, hi: int,
                         vmask):
        """Two-stage exact scan of one span: stage 1 ranks the slice
        with one f32 gemm per query chunk (the engine's per-epoch rank
        stats, sliced); stage 2 rescores the kc oversampled candidates
        through the exact f64 ladder — the same discipline (and the
        same single-query 2-row-gemm padding for bitwise stability) as
        `_host_knn_multi_blas`, scoped to the span."""
        eng = self.engine
        xs = eng.vecs
        m = eng.metric
        x2_32, inv_norms32, _invalid = eng._host_stats_cached()
        span = hi - lo
        kc = min(span, max(2 * k_eff, k_eff + 16))
        invalid = None
        if not vmask.all():
            invalid = np.flatnonzero(~vmask)
        xs_s = xs[lo:hi]
        step = max(1, (cnf.KNN_SCORE_BUDGET_ELEMS // 2) // max(span, 1))
        out = []
        for s in range(0, len(qvs), step):
            qc = qvs[s:s + step]
            qb = np.ascontiguousarray(np.asarray(qc, dtype=xs.dtype))
            pad1 = qb.shape[0] == 1
            if pad1:
                qb = np.concatenate([qb, qb], axis=0)
            dots = qb @ xs_s.T
            if pad1:
                dots = dots[:1]
            if m == "euclidean":
                score = x2_32[lo:hi][None, :] - 2.0 * dots
            elif m == "cosine":
                score = dots * inv_norms32[lo:hi][None, :]
                np.negative(score, out=score)
            else:  # dot
                score = -dots
            if invalid is not None and len(invalid):
                score[:, invalid] = np.inf
            cand = np.argpartition(score, kc - 1, axis=1)[:, :kc]
            for b in range(cand.shape[0]):
                ids_b = cand[b]
                d = eng._host_distances(qc[b], xs=xs_s[ids_b])
                d = np.where(vmask[ids_b], d, np.inf)
                sel = np.argpartition(d, min(k_eff, kc) - 1)[:k_eff]
                sel = sel[np.argsort(d[sel], kind="stable")]
                out.append([
                    (eng.rids[lo + int(ids_b[j])], float(d[j]))
                    for j in sel
                    if np.isfinite(d[j])
                ])
        return out

    def _graph_span(self, qvs, k: int, seg: SealedSegment, ann,
                    row_map, dirty):
        """Graph-served span: int8 descent (the runner's kernel against
        this segment's own block, or the numpy descent) proposes
        candidates, dirty/overwritten rows in the span brute-merge in,
        the final list is exact-re-ranked from the f32 host rows.
        Oversampling scales with the span's tombstone density so a
        delete-heavy segment cannot underfill k; if it still would
        (pathological), the span is answered exactly."""
        from surrealdb_tpu_torch.device import (
            DeviceOpError, DeviceUnavailable, get_supervisor,
        )
        from surrealdb_tpu_torch.idx import cagra

        eng = self.engine
        lo, hi = seg.lo, seg.hi
        valid = eng.valid
        m = ann.built_n
        if row_map is not None:
            live_graph = int(np.count_nonzero(valid[row_map]))
        else:
            live_graph = int(np.count_nonzero(valid[lo:lo + m]))
        valid_span = int(np.count_nonzero(valid[lo:hi]))
        if valid_span == 0:
            return [[] for _ in range(len(qvs))]
        # per-segment oversampling: a tombstone-dense graph must
        # propose enough live candidates to fill k after the mask
        density = max(live_graph, 1) / max(m, 1)
        factor = min(int(np.ceil(1.0 / max(density, 1.0 / 64))), 64)
        kc = min(m, max(int(cnf.KNN_ANN_OVERSAMPLE) * k * factor, 32))
        qs32 = np.ascontiguousarray(np.asarray(qvs, np.float32))
        b = len(qvs)
        cand = None
        if eng._use_device():
            try:
                cand = eng._ann_device_search(
                    ann, qs32, kc, dev_key=seg.dev_key,
                    tag=[int(seg.seq), int(lo), int(hi)],
                )
            except (DeviceUnavailable, DeviceOpError):
                # degrade to the numpy descent below, counted as the
                # whole-store overlay counts it
                get_supervisor().note_fallback()
        if cand is None:
            eng.ann_host_descents += 1
            cfg = cnf.ann_search_cfg()
            width = min(max(cfg["width"], kc), m)
            fn, probe_fn = cagra.int8_score_fn(ann, qs32)
            cand = cagra.descend(
                ann.graph, m, fn, b, width, cfg["iters"],
                min(cfg["expand"], width), kc, probe_fn=probe_fn,
            )
        extra = np.asarray(
            sorted(r for r in dirty if lo <= r < hi), np.int64
        )
        if len(extra):
            extra = extra[valid[extra]]
        out = []
        for i in range(b):
            ids = cand[i].astype(np.int64)
            ids = ids[(ids >= 0) & (ids < m)]
            if row_map is not None:
                ids = row_map[ids]
            else:
                ids = ids + lo
            if len(extra):
                ids = np.concatenate([ids, extra])
            ids = np.unique(ids)
            d = eng._host_distances(qvs[i], xs=eng.vecs[ids])
            d = np.where(valid[ids], d, np.inf)
            k_eff = min(k, len(ids))
            if k_eff == 0:
                out.append([])
                continue
            sel = np.argpartition(d, k_eff - 1)[:k_eff]
            sel = sel[np.argsort(d[sel], kind="stable")]
            res = [
                (eng.rids[int(ids[j])], float(d[j]))
                for j in sel
                if np.isfinite(d[j])
            ]
            if len(res) < min(k, valid_span):
                # tombstone-dense neighborhood underfilled even after
                # oversampling: answer THIS span exactly (bounded by
                # the segment size, never the store)
                res = self._exact_span(
                    qvs[i:i + 1], k, lo, min(hi, len(eng.rids))
                )[0]
            out.append(res)
        return out

    # -- persisted per-segment artifacts ------------------------------------

    def _snap_path(self, xs_b: np.ndarray):
        """Artifact path keyed by SEGMENT IDENTITY: the content hash of
        the exact rows the graph covers (a sealed span is immutable, so
        the hash — not a version stamp — proves validity; an overwrite
        since the save changes the bytes and misses the artifact)."""
        eng = self.engine
        if not eng.snapshot_dir:
            return None
        import hashlib
        import os

        h = hashlib.sha256()
        # "": the reference's label of an unsharded engine (the same
        # rows hash to the same file in both packages)
        h.update(repr((eng.key, "", eng.metric,
                       xs_b.shape, str(xs_b.dtype))).encode())
        # zero-copy: xs_b is contiguous on both _build_ann_for branches
        # (a row slice of the C-order store, or an explicit gather) —
        # tobytes() would clone gigabytes mid-merge just to hash them
        h.update(memoryview(np.ascontiguousarray(xs_b)).cast("B"))
        ns, db, tb, ix = eng.key
        stem = "".join(
            c if c.isalnum() else "_" for c in f"{tb}.{ix}"
        )[:32]
        return os.path.join(
            eng.snapshot_dir, f"{stem}-seg-{h.hexdigest()[:24]}.annsnap"
        )

    def _load_snapshot(self, path, xs_b: np.ndarray):
        if path is None:
            return None
        import os
        import sys

        from surrealdb_tpu_torch.idx import cagra

        try:
            ann, meta = cagra.load_index(path)
        except OSError:
            return None
        except Exception as e:
            print(
                f"[surrealdb-tpu] seg snapshot {path} rejected ({e}); "
                f"rebuilding from rows", file=sys.stderr, flush=True,
            )
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        if (ann.metric != self.engine.metric
                or ann.built_n != len(xs_b)
                or meta.get("dim") != int(xs_b.shape[1])):
            return None
        return ann

    def _save_snapshot(self, path, ann, xs_b: np.ndarray):
        if path is None:
            return
        import os
        import sys

        from surrealdb_tpu_torch.idx import cagra

        try:
            os.makedirs(self.engine.snapshot_dir, exist_ok=True)
            cagra.save_index(ann, path, extra={
                "dim": int(xs_b.shape[1]), "segment": True,
            })
        except OSError as e:
            print(
                f"[surrealdb-tpu] seg snapshot save failed ({path}): "
                f"{e}", file=sys.stderr, flush=True,
            )
