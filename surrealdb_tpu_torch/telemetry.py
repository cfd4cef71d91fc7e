"""Telemetry (the reference package's `telemetry.py`): per-stage query
timing, counters, gauges, per-query span trees and their Prometheus
rendering (the server's `/metrics`).

- `stage_record(name, ns)`: a process-wide table of stage name -> count,
  total, max and last nanoseconds. The datastore records `parse` and
  `txn_open`, the executor `stmt_eval` and `stmt_envelope`, the planner
  `plan`, the vector engine `index_knn` (cache sync, batcher wait,
  kernel), and a serving stack binds `stage_record` into the supervisor
  (`bind_serving`) for its `device_rpc` stage. `stage_snapshot()` reads
  the table (INFO FOR SYSTEM's `stages`).
- `Telemetry`: a datastore's counters and gauges and the ring of recent
  span trees (`start`/`end`/`span`); `SURREAL_TELEMETRY_FILE` exports one
  span tree per completed query as JSONL; `prometheus(ds)` renders the
  counters, gauges, stage table and query-duration histogram as
  Prometheus text.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

_BUCKETS_MS = (0.1, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
               2500, 5000, 10000)


class StageStat:
    """One query stage's accumulated timing. Updates are deliberately
    lock-free: under the GIL a lost increment during a race skews a
    metric by one sample, which is acceptable for observability — a
    per-stage lock would put two atomic ops on every query's hot path
    for data nobody reads at that granularity."""

    __slots__ = ("count", "total_ns", "max_ns", "last_ns")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.max_ns = 0
        self.last_ns = 0

    def add(self, ns: int):
        self.count += 1
        self.total_ns += ns
        self.last_ns = ns
        if ns > self.max_ns:
            self.max_ns = ns

    def to_dict(self) -> dict:
        c = self.count
        return {
            "count": c,
            "total_ms": round(self.total_ns / 1e6, 3),
            "avg_us": round(self.total_ns / max(c, 1) / 1e3, 1),
            "max_us": round(self.max_ns / 1e3, 1),
            "last_us": round(self.last_ns / 1e3, 1),
        }


# Per-stage query timing (the serving overhead measurement hook):
# process-wide so the serving edge (admission), the datastore (parse,
# txn open), the executor (envelope, eval) and the device layer
# (batcher wait, supervisor RPC) all land in ONE table regardless of
# which Datastore/Telemetry instance they hang off. Stages surface in
# /metrics, `INFO FOR SYSTEM` and tools/profile_query.py.
_STAGES: dict[str, StageStat] = {}


def stage_record(name: str, ns: int):
    """Record `ns` nanoseconds spent in query stage `name`."""
    st = _STAGES.get(name)
    if st is None:
        # dict set is atomic under the GIL; a racing first-record for
        # the same stage leaves one winner and loses one sample
        st = _STAGES.setdefault(name, StageStat())
    st.add(ns)


def stage_snapshot() -> dict:
    """{stage: {count, total_ms, avg_us, max_us, last_us}} sorted by
    total time descending."""
    items = sorted(_STAGES.items(), key=lambda kv: -kv[1].total_ns)
    return {k: v.to_dict() for k, v in items}


class Span:
    __slots__ = ("name", "start_ns", "dur_ns", "attrs", "children")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = time.time_ns()
        self.dur_ns = 0
        self.attrs: dict = {}
        self.children: list[Span] = []

    def to_dict(self):
        d = {
            "name": self.name,
            "start_ns": self.start_ns,
            "dur_us": round(self.dur_ns / 1000, 1),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Telemetry:
    """Per-datastore telemetry hub (counters + histogram + trace ring)."""

    def __init__(self, ring_size: int = 256):
        self.lock = threading.Lock()
        self.ring_size = ring_size
        self.traces: list[Span] = []  # rendered lazily by recent_traces
        self.counters: dict[str, int] = {}
        # query duration histogram (cumulative bucket counts, Prometheus
        # `le` semantics) + sum/count
        self.hist = [0] * (len(_BUCKETS_MS) + 1)
        self.hist_sum_ms = 0.0
        self.hist_count = 0
        self._local = threading.local()
        self._export_path = os.environ.get("SURREAL_TELEMETRY_FILE") or None
        self._export_lock = threading.Lock()
        # gauges: name -> zero-arg callable sampled at scrape time (the
        # admission controller and in-flight registry register theirs)
        self.gauges: dict = {}
        # counter providers: like gauges but rendered as counters
        self.counter_providers: dict = {}

    def register_gauge(self, name: str, fn):
        with self.lock:
            self.gauges[name] = fn

    def register_counter(self, name: str, fn):
        """A monotonically increasing counter whose value lives with its
        owner (sampled at scrape, rendered as `surreal_<name>_total`).
        Lets hot paths count under a lock they already hold instead of
        taking the telemetry lock per event."""
        with self.lock:
            self.counter_providers[name] = fn

    def unregister_gauge(self, name: str):
        """Drop a gauge provider (a closed sharded backend must not
        leave a dangling closure behind for the next scrape)."""
        with self.lock:
            self.gauges.pop(name, None)

    # -- counters -----------------------------------------------------------
    # The remote-KV client records its resilience counters here:
    # kv_retries (transport retries), kv_failovers (primary changes
    # observed), kv_txn_failovers (read-only txns transparently
    # re-pinned), kv_deadline_exhausted (ops that ran out their retry
    # deadline). The shard router adds kv_shard_map_refreshes (stale-map
    # recoveries), kv_2pc_commits / kv_2pc_aborts (cross-shard
    # transaction outcomes), kv_2pc_decide_deferred (phase-2 deliveries
    # left to a participant's resolver), plus gauges kv_shards /
    # kv_shard_map_epoch. All surface through `prometheus()` as
    # surreal_<name>_total (counters) / surreal_<name> (gauges).
    def inc(self, name: str, by: int = 1):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def get(self, name: str) -> int:
        with self.lock:
            v = self.counters.get(name, 0)
            fn = self.counter_providers.get(name)
        if fn is not None:
            try:
                v += fn()
            except Exception:
                pass
        return v

    # -- spans --------------------------------------------------------------
    def start(self, name: str, **attrs) -> Span:
        """Open a span nested under the thread's current span."""
        s = Span(name)
        s.attrs.update(attrs)
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        if stack:
            stack[-1].children.append(s)
        stack.append(s)
        s.dur_ns = -time.perf_counter_ns()  # closed in end()
        return s

    def end(self, s: Span):
        s.dur_ns += time.perf_counter_ns()
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is s:
            stack.pop()
        if not stack:
            self._finish_trace(s)

    @contextmanager
    def span(self, name: str, **attrs):
        """Nested span context; completing the outermost span records the
        trace into the ring (and the JSONL export, when configured)."""
        s = self.start(name, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def _finish_trace(self, s: Span):
        ms = s.dur_ns / 1e6
        with self.lock:
            self.hist_count += 1
            self.hist_sum_ms += ms
            for i, edge in enumerate(_BUCKETS_MS):
                if ms <= edge:
                    self.hist[i] += 1
                    break
            else:
                self.hist[-1] += 1
            # ring holds the finished Span OBJECTS; the dict/json render
            # happens lazily at read time (recent_traces) — serializing
            # every query's span tree was measurable dict churn on the
            # serving hot path and the ring overwrites most of them
            # unread anyway
            self.traces.append(s)
            if len(self.traces) > self.ring_size:
                del self.traces[: self.ring_size // 2]
        if self._export_path:
            try:
                with self._export_lock, open(self._export_path, "a") as f:
                    f.write(json.dumps(s.to_dict()) + "\n")
            except OSError:
                pass

    def recent_traces(self, limit: int = 64):
        with self.lock:
            spans = list(self.traces[-limit:])
        return [s.to_dict() for s in spans]

    # -- prometheus ---------------------------------------------------------
    def prometheus(self, ds=None) -> str:
        """Render Prometheus text-format metrics (server /metrics)."""
        lines = []

        def counter(name, value, help_=None):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {value}")

        with self.lock:
            counters = dict(self.counters)
            hist = list(self.hist)
            hsum, hcount = self.hist_sum_ms, self.hist_count
            gauges = dict(self.gauges)
            cprov = dict(self.counter_providers)
        for k, fn in sorted(cprov.items()):
            try:
                counters.setdefault(k, 0)
                counters[k] += fn()
            except Exception:
                continue
        if ds is not None:
            for k, v in ds.metrics.items():
                counter(f"surreal_ds_{k}_total", v,
                        "datastore counter (kvs::Metrics analog)")
            lines.append("# TYPE surreal_live_queries gauge")
            lines.append(f"surreal_live_queries {len(ds.live_queries)}")
            lines.append("# TYPE surreal_vector_indexes gauge")
            lines.append(f"surreal_vector_indexes {len(ds.vector_indexes)}")
        for k in sorted(counters):
            counter(f"surreal_{k}_total", counters[k])
        for k in sorted(gauges):
            try:
                v = gauges[k]()
            except Exception:
                continue  # a dying provider must not poison the scrape
            lines.append(f"# TYPE surreal_{k} gauge")
            lines.append(f"surreal_{k} {v}")
        lines.append("# TYPE surreal_query_stage_us summary")
        for sname, st in stage_snapshot().items():
            lines.append(
                f'surreal_query_stage_us{{stage="{sname}",stat="avg"}} '
                f'{st["avg_us"]}'
            )
            lines.append(
                f'surreal_query_stage_us{{stage="{sname}",stat="max"}} '
                f'{st["max_us"]}'
            )
            lines.append(
                f'surreal_query_stage_count{{stage="{sname}"}} '
                f'{st["count"]}'
            )
        lines.append("# TYPE surreal_query_duration_ms histogram")
        acc = 0
        for i, edge in enumerate(_BUCKETS_MS):
            acc += hist[i]
            lines.append(
                f'surreal_query_duration_ms_bucket{{le="{edge}"}} {acc}'
            )
        lines.append(
            f'surreal_query_duration_ms_bucket{{le="+Inf"}} {hcount}'
        )
        lines.append(f"surreal_query_duration_ms_sum {round(hsum, 3)}")
        lines.append(f"surreal_query_duration_ms_count {hcount}")
        return "\n".join(lines) + "\n"
