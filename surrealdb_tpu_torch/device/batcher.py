"""Cross-query scoring batcher (the reference's `device/batcher.py`).

The inference-server recipe: the first rider dispatches immediately (no
added latency when idle); riders arriving while a dispatch is in flight
queue up and ride the NEXT dispatch as ONE batched kernel call, so the
device batch size grows with client concurrency instead of paying a
per-query dispatch. The shape serves every device workload (brute/flat
KNN, rescore, multi-hop graph expansion) and the batched HOST fallback
paths: on a CPU-only box the batcher still wins, because a [B, N] BLAS
call beats B separate [1, N] passes.

- **Pipelined dispatch** (`SURREAL_DEVICE_BATCH_PIPELINE`, default 2):
  a second batch may launch while the first is inside its kernel (the
  kernel or the runner round trip releases the GIL), so the new batch's
  Python half overlaps with the old batch's compute. To keep maximal
  coalescing under light traffic, the overlapped launch only happens
  once `SURREAL_DEVICE_BATCH_PIPELINE_MIN` riders are queued.
- **Deadline-aware withdrawal**: a rider whose query budget expires (or
  is cancelled) while parked withdraws from the queue and unwinds typed
  (`QueryTimeout` / `QueryCancelled`); it never holds a batch hostage
  and a late result is simply dropped. Budget, cancellation and the
  query handle come from the serving stack through the supervisor's
  `bind_serving` seam.
- **Per-rider error attribution**: a batch-level device failure degrades
  each rider INDIVIDUALLY through the single-payload fallback, so one
  poisoned rider can never fail its batchmates.
- **Batching telemetry**: every dispatch records its size into a
  process-wide stats block (`BATCH_STATS`), surfaced as the supervisor's
  `device_batch_size_last/avg/max` gauges and its `status()["batching"]`.

This module imports no torch.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device import supervisor as _sup


class BatchStats:
    """Process-wide dispatch-size accounting (GIL-atomic enough: a lost
    sample under a race skews a gauge by one dispatch)."""

    __slots__ = ("dispatches", "riders", "last", "max")

    def __init__(self):
        self.dispatches = 0
        self.riders = 0
        self.last = 0
        self.max = 0

    def record(self, size: int):
        self.dispatches += 1
        self.riders += size
        self.last = size
        if size > self.max:
            self.max = size

    def to_dict(self) -> dict:
        d = self.dispatches
        return {
            "dispatches": d,
            "riders": self.riders,
            "last": self.last,
            "avg": round(self.riders / max(d, 1), 2),
            "max": self.max,
        }


BATCH_STATS = BatchStats()


class DeviceBatcher:
    """Self-clocking dynamic batcher over an arbitrary batch kernel.

    `dispatch(payloads) -> list[result]` runs one coalesced batch (same
    order and length as `payloads`); raising fails the batch as a whole.
    `fallback(payload) -> result`, when given, answers riders one by one
    after a batch-level failure classified retryable by `retryable(exc)`
    — the per-rider degrade path. Non-retryable batch failures are
    attributed to every rider verbatim.

    Waiters are signalled at batch completion, woken by their deadline
    expiry, or woken through the query handle's cancel waker
    (`handle.cancel.add_waker`) on cancellation: nothing polls while
    parked.
    """

    def __init__(self, dispatch: Callable, fallback: Optional[Callable] = None,
                 fallback_batch: Optional[Callable] = None,
                 retryable: Optional[tuple] = None,
                 stats: Optional[BatchStats] = None):
        self.dispatch = dispatch
        self.fallback = fallback
        self.fallback_batch = fallback_batch
        self.retryable = retryable
        self.stats = BATCH_STATS if stats is None else stats
        self.cond = threading.Condition()
        self.queue: list = []
        self.inflight = 0
        # EWMA of recent dispatch sizes — the overlapped-launch gate
        # adapts to the observed concurrency, so batches keep growing
        # toward the client count instead of stalling at a fixed floor
        self._size_ewma = 0.0

    @property
    def running(self) -> bool:
        """At least one dispatch in flight."""
        return self.inflight > 0

    def _can_dispatch(self) -> bool:
        # caller holds self.cond
        if not self.queue:
            return False
        if self.inflight == 0:
            return True
        # An overlapped (pipelined) launch needs enough riders queued
        # to be worth a kernel pass: at least the configured floor, and
        # MORE than the recent dispatch size (×1.5) — launching at the
        # recent average would pin batches there forever, while
        # requiring growth ratchets them toward the client count
        # (bigger gemms amortize better). When the queue can no longer
        # outgrow the average before the kernel drains, dispatches fall
        # back to full-queue grabs at inflight==0, which is what lets
        # the average track a DROP in concurrency back down.
        gate = max(1, cnf.DEVICE_BATCH_PIPELINE_MIN,
                   int(self._size_ewma * 1.5))
        return (self.inflight < max(1, cnf.DEVICE_BATCH_PIPELINE)
                and len(self.queue) >= gate)

    def submit(self, payload):
        """Run `payload` through a coalesced dispatch; returns its result
        or raises its attributed error. Honors the calling query's
        deadline and cancel flag while parked."""
        slot = [None, None, False]  # [result, exception, done]
        entry = (payload, slot)
        batch = None
        handle = _sup._query_current()
        waker = None
        if handle is not None and hasattr(handle.cancel, "add_waker"):
            # a KILL/disconnect/drain wakes this rider THROUGH the
            # handle's cancel event — no cancel polling,
            # so a parked rider costs zero wakeups until its batch
            # completes, its deadline lands, or it is cancelled
            cond = self.cond

            def waker():
                with cond:
                    cond.notify_all()

            handle.cancel.add_waker(waker)
        try:
            with self.cond:
                self.queue.append(entry)
                while not slot[2]:
                    if self._can_dispatch():
                        # THIS thread becomes the dispatcher for
                        # everything queued so far (including itself)
                        batch, self.queue = self.queue, []
                        self.inflight += 1
                        break
                    if _sup._query_cancelled():
                        # withdraw and unwind typed
                        try:
                            self.queue.remove(entry)
                        except ValueError:
                            pass
                        if handle is not None:
                            handle.mark_cancelled()
                        raise _sup.QueryCancelled("The query was cancelled")
                    budget = _sup._query_remaining()
                    if budget is not None and budget <= 0:
                        # expired while queued: withdraw if the batch
                        # hasn't picked us up; either way stop waiting —
                        # a late result written into the slot is simply
                        # discarded
                        try:
                            self.queue.remove(entry)
                        except ValueError:
                            pass
                        if handle is not None:
                            handle.mark_timed_out()
                        raise _sup.QueryTimeout(
                            "The query was not executed because it "
                            "exceeded the timeout"
                        )
                    # event-driven wait: completion notify_all, cancel
                    # waker, or deadline expiry wake this rider —
                    # nothing polls
                    self.cond.wait(budget)
        finally:
            if waker is not None:
                handle.cancel.remove_waker(waker)
        if batch is None:
            # our payload rode someone else's dispatch
            if slot[1] is not None:
                raise slot[1]
            return slot[0]
        try:
            self._run(batch)
        finally:
            with self.cond:
                self.inflight -= 1
                self.cond.notify_all()
        if not slot[2]:
            # pipelined corner: this thread dispatched a NEWER batch
            # while its own entry rode an older, still-running one —
            # wait for that dispatch to attribute our slot
            with self.cond:
                while not slot[2]:
                    self.cond.wait(0.05)
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

    def _run(self, batch):
        self.stats.record(len(batch))
        # EWMA(1/4): tracks the workload's achievable batch size fast
        # enough to ride load shifts (read without the lock — a torn
        # sample only nudges the launch gate by one dispatch)
        self._size_ewma += (len(batch) - self._size_ewma) / 4.0
        try:
            results = self.dispatch([p for p, _s in batch])
            for (_p, slot), res in zip(batch, results):
                slot[0] = res
                slot[2] = True
            return
        except BaseException as e:
            degradable = (self.retryable is not None
                          and isinstance(e, self.retryable)
                          and (self.fallback is not None
                               or self.fallback_batch is not None))
            if not degradable:
                # a shared non-degradable failure (OOM, bug): attribute
                # it to every rider still waiting
                for _p, slot in batch:
                    if not slot[2]:
                        slot[1] = e
                        slot[2] = True
                return
        # Degrade tier 1: answer the WHOLE batch through the batched
        # fallback kernel (the host paths batch too — a [B, N] pass
        # still beats B single passes on a CPU-only box).
        if self.fallback_batch is not None:
            try:
                results = self.fallback_batch([p for p, _s in batch])
                for (_p, slot), res in zip(batch, results):
                    if not slot[2]:
                        slot[0] = res
                        slot[2] = True
                return
            except BaseException as e3:
                if self.fallback is None:
                    # no per-rider tier: attribute the failure — a slot
                    # left unfilled would park its rider forever
                    for _p, slot in batch:
                        if not slot[2]:
                            slot[1] = e3
                            slot[2] = True
                    return
                # fall through to per-rider isolation
        # Degrade tier 2: every rider answered INDIVIDUALLY, so one
        # poisoned rider can never fail its batchmates.
        for p, slot in batch:
            if slot[2]:
                continue
            try:
                slot[0] = self.fallback(p)
            except BaseException as e2:
                slot[1] = e2
            slot[2] = True
