"""Admission control for the serving edge.

A bounded worker-slot pool with a bounded wait queue in front of query
execution (reference role: the tokio task budget + tower load-shed
layers the reference's axum router gets from its runtime; SHINE
arXiv:2507.17647 treats the same shapes — bounded in-flight work,
deadline-aware shedding — as prerequisites for scale-out serving).

Semantics:

- at most `max_inflight` queries execute concurrently;
- at most `queue_depth` requests WAIT for a slot; the next one sheds
  immediately with a typed `ShedError` (HTTP 503 + Retry-After) — the
  work never starts, so the client can always retry;
- **deadline-aware shedding**: a request whose remaining deadline
  cannot cover the estimated queue wait (EWMA of recent service times
  scaled by queue position) is rejected at the door rather than timing
  out deep in the executor after burning a worker slot;
- a waiter whose deadline expires IN the queue sheds (it never ran);
- `drain()` stops admission (every new request sheds with a retryable
  503) and waits for in-flight work to finish — the SIGTERM path.

Everything is a plain Condition + counters: no unbounded thread growth,
no polling.
"""

from __future__ import annotations

import threading
import time

from surrealdb_tpu_torch.err import ShedError


class AdmissionController:
    """Bounded concurrency + bounded queue + deadline-aware shedding."""

    def __init__(self, max_inflight: int, queue_depth: int,
                 telemetry=None):
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self.telemetry = telemetry
        self.cond = threading.Condition()
        self.active = 0
        self.waiting = 0
        self.admitted = 0
        self.draining = False
        # EWMA of recent service times (seconds) for queue-wait estimates;
        # seeded small so an idle server never sheds on the estimate alone
        self._ewma_s = 0.005
        if telemetry is not None:
            telemetry.register_gauge(
                "admission_queue_depth", lambda: self.waiting
            )
            telemetry.register_gauge(
                "admission_active", lambda: self.active
            )
            # admitted is counted under the admission condition the hot
            # path already holds — no telemetry-lock hit per query
            telemetry.register_counter(
                "queries_admitted", lambda: self.admitted
            )

    # -- helpers ------------------------------------------------------------
    def _shed(self, reason: str, retry_after_s: float):
        if self.telemetry is not None:
            self.telemetry.inc("queries_shed")
        raise ShedError(
            f"The server is overloaded and the request was not started "
            f"({reason})", retry_after_s=retry_after_s,
        )

    def estimated_wait_s(self, position: int) -> float:
        """Expected queue wait at 0-based queue `position`: slots free up
        roughly every ewma/max_inflight seconds under saturation."""
        return self._ewma_s * (position + 1) / self.max_inflight

    # -- admission ----------------------------------------------------------
    def admit(self, deadline=None) -> "_Ticket":
        """Block until a worker slot is free (within the queue bound and
        the caller's deadline) or raise ShedError. Returns a ticket whose
        release() MUST run when the request finishes. Queue time lands
        in the `admission_wait` stage stat."""
        from surrealdb_tpu_torch.telemetry import stage_record

        t0 = time.perf_counter_ns()
        # node-wide memory governance (resource.py): over the HARD
        # watermark — after an eviction pass failed to bring accounted
        # bytes back under it — new work sheds with the same typed 503
        # as a full queue. The check runs outside self.cond: admit_ok
        # may run eviction callbacks that take holder locks, and
        # nothing here touches admission state.
        from surrealdb_tpu_torch import resource

        if not resource.get_accountant().admit_ok():
            if self.telemetry is not None:
                self.telemetry.inc("queries_shed_memory")
            self._shed("memory pressure: accounted bytes over the "
                       "hard watermark", 1.0)
        with self.cond:
            if self.draining:
                self._shed("draining", 1.0)
            if self.active < self.max_inflight and self.waiting == 0:
                self.active += 1
                self.admitted += 1
                stage_record("admission_wait",
                             time.perf_counter_ns() - t0)
                return _Ticket(self)
            if self.waiting >= self.queue_depth:
                self._shed(
                    "queue full",
                    max(self.estimated_wait_s(self.queue_depth), 0.05),
                )
            if deadline is not None:
                remaining = deadline - time.monotonic()
                est = self.estimated_wait_s(self.waiting)
                if remaining <= 0 or remaining < est:
                    # the deadline cannot cover the queue wait: reject
                    # NOW instead of timing out deep in the executor
                    self._shed("deadline cannot cover queue wait",
                               max(est, 0.05))
            self.waiting += 1
            try:
                while True:
                    if self.draining:
                        self._shed("draining", 1.0)
                    if self.active < self.max_inflight:
                        self.active += 1
                        self.admitted += 1
                        stage_record("admission_wait",
                                     time.perf_counter_ns() - t0)
                        return _Ticket(self)
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            self._shed("deadline expired in queue", 0.05)
                    self.cond.wait(timeout)
            finally:
                self.waiting -= 1

    def release(self, service_time_s: float):
        with self.cond:
            self.active -= 1
            # EWMA(1/8) — smooth enough to ride bursts, fresh enough to
            # track a workload shift
            self._ewma_s += (max(service_time_s, 0.0) - self._ewma_s) / 8.0
            self.cond.notify()

    # -- drain --------------------------------------------------------------
    def drain(self, timeout_s: float) -> bool:
        """Stop admitting and wait up to `timeout_s` for in-flight work.
        Returns True when everything finished inside the budget."""
        with self.cond:
            self.draining = True
            self.cond.notify_all()  # queued waiters shed immediately
            end = time.monotonic() + max(timeout_s, 0.0)
            while self.active > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
            return True


class _Ticket:
    """An admitted request's slot; context-manager friendly."""

    __slots__ = ("ctrl", "t0", "_done")

    def __init__(self, ctrl: AdmissionController):
        self.ctrl = ctrl
        self.t0 = time.monotonic()
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self.ctrl.release(time.monotonic() - self.t0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False
