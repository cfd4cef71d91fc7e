"""In-flight query registry + per-thread query lifecycle state.

The robustness spine for normal (non-LIVE) queries: every
`Datastore.execute` call registers a `QueryHandle` carrying the query's
id, session scope, start time, statement digest, edge deadline, and a
cooperative cancel flag. The handle is:

- **thread-local while running** — deep layers (the remote-KV retry
  policy in `kvs/remote.py`, the vector coalescer in `idx/vector.py`)
  read `remaining()` without any plumbing through their call chains, so
  a nearly-expired query never burns its budget on KV backoff or a
  batched kernel wait;
- **globally visible while registered** — `INFO FOR SYSTEM` lists it,
  `KILL <query-id>` from any other connection sets its cancel flag, and
  the server's drain path cancels whatever is still running.

Cancellation is cooperative: the flag is checked at the existing
`Ctx.check_deadline()` sites (per row in scans, per iteration in eval
loops), which bounds reaction latency to one row/batch of work.

Reference: the tokio task budget + per-query `Context` cancellation the
reference gets for free from its async runtime (SURVEY §2.6/§2.13).
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from typing import Optional

_tls = threading.local()


class CancelEvent(threading.Event):
    """A cancel flag that can WAKE sleepers parked on other primitives.

    The cross-query batcher parks riders on a Condition that nothing
    signals on KILL/disconnect/drain — they used to poll the flag every
    50ms, which at high concurrency is thousands of wakeups per second
    of pure GIL churn. A waker registered here fires inside `set()`, so
    a parked rider is notified the instant the flag flips and can wait
    event-driven otherwise. Fired wakers must be cheap and non-raising
    (they run on the killer's thread)."""

    def __init__(self):
        super().__init__()
        self._wakers: list = []

    def add_waker(self, fn):
        self._wakers.append(fn)

    def remove_waker(self, fn):
        try:
            self._wakers.remove(fn)
        except ValueError:
            pass

    def set(self):
        super().set()
        for fn in list(self._wakers):
            try:
                fn()
            except Exception:
                pass


class QueryHandle:
    """One registered query's lifecycle state. Instances are POOLED by
    the registry (the serving hot path opens one per query — the
    allocation, uuid, and Event construction were measurable tax), so
    all lifecycle state must be reset in `_reset`."""

    __slots__ = ("id", "ns", "db", "_digest", "started", "deadline",
                 "cancel", "timed_out", "cancelled", "sql_head", "edge",
                 "registry")

    def __init__(self, ns, db, sql: str, deadline: Optional[float] = None):
        self.cancel = CancelEvent()
        self.registry: Optional["InflightRegistry"] = None
        self._reset(str(uuid.uuid4()), ns, db, sql, deadline)

    def _reset(self, qid: str, ns, db, sql: str,
               deadline: Optional[float]):
        self.cancel._wakers.clear()  # no waker may outlive its query
        self.id = qid
        self.ns = ns
        self.db = db
        sql = sql or ""
        # digest is lazy: only INFO FOR SYSTEM snapshots read it, and
        # every embedded ds.execute passes through here — the hot path
        # must not pay a sha256 per query
        self._digest: Optional[str] = None
        self.sql_head = sql[:80]
        self.started = time.time()
        # monotonic-clock absolute deadline (None = unbounded)
        self.deadline = deadline
        self.timed_out = False  # set by the site that raised QueryTimeout
        self.cancelled = False  # set by the site that raised QueryCancelled
        # an edge-opened handle (server route, pre-SQL): the first
        # ds.execute underneath refines digest/ns/db to the real query
        self.edge = False

    @property
    def digest(self) -> str:
        if self._digest is None:
            self._digest = hashlib.sha256(
                self.sql_head.encode()
            ).hexdigest()[:16]
        return self._digest

    def refine(self, ns, db, sql: str):
        self.edge = False
        self.ns = ns
        self.db = db
        sql = sql or ""
        self._digest = None
        self.sql_head = sql[:80]

    def mark_timed_out(self):
        """Record (once) that this query died on its deadline. Called at
        the raise site so the counter is visible BEFORE the client sees
        the response — counting at registry-close time races the test's
        (and any monitor's) read of the counter."""
        if not self.timed_out:
            self.timed_out = True
            reg = self.registry
            if reg is not None and reg.telemetry is not None:
                reg.telemetry.inc("queries_timed_out")

    def mark_cancelled(self):
        """Record (once) that this query died cancelled (KILL /
        disconnect / drain)."""
        if not self.cancelled:
            self.cancelled = True
            reg = self.registry
            if reg is not None and reg.telemetry is not None:
                reg.telemetry.inc("queries_killed")

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def to_dict(self) -> dict:
        d = {
            "id": self.id,
            "ns": self.ns,
            "db": self.db,
            "digest": self.digest,
            "statement": self.sql_head,
            "elapsed_ms": round((time.time() - self.started) * 1000, 3),
        }
        rem = self.remaining()
        if rem is not None:
            d["remaining_ms"] = round(rem * 1000, 3)
        return d


def current() -> Optional[QueryHandle]:
    """The query handle active on THIS thread, if any."""
    return getattr(_tls, "handle", None)


def remaining() -> Optional[float]:
    """Seconds left in the current thread's query budget (None when no
    query is active or the query has no deadline). May be <= 0."""
    h = current()
    return None if h is None else h.remaining()


def cancelled() -> bool:
    """True when the current thread's query has been cancelled."""
    h = current()
    return h is not None and h.cancel.is_set()


class _Activation:
    """Context manager binding a handle to the executing thread."""

    __slots__ = ("handle", "_prev")

    def __init__(self, handle: QueryHandle):
        self.handle = handle
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "handle", None)
        _tls.handle = self.handle
        return self.handle

    def __exit__(self, *exc):
        _tls.handle = self._prev
        return False


def activate(handle: QueryHandle) -> _Activation:
    return _Activation(handle)


class InflightRegistry:
    """Per-node registry of running (non-LIVE) queries.

    Exposed via `INFO FOR SYSTEM` (the `queries` list) and the
    `inflight_queries` gauge; `KILL <query-id>` resolves against it."""

    # pooled handles kept per registry; caps allocation churn without
    # pinning memory on burst peaks
    POOL_MAX = 256

    def __init__(self, telemetry=None):
        self.lock = threading.Lock()
        self.queries: dict[str, QueryHandle] = {}
        self.telemetry = telemetry
        # registry-scoped id space: one uuid prefix + a counter beats a
        # fresh uuid4 per query, stays globally unique, and KILL-by-id
        # still resolves (string equality)
        self._id_prefix = f"q{uuid.uuid4().hex[:12]}-"
        self._id_seq = 0
        self._pool: list[QueryHandle] = []
        if telemetry is not None:
            telemetry.register_gauge("inflight_queries", self.count)

    def count(self) -> int:
        with self.lock:
            return len(self.queries)

    def open(self, ns, db, sql: str,
             deadline: Optional[float] = None) -> QueryHandle:
        with self.lock:
            self._id_seq += 1
            qid = f"{self._id_prefix}{self._id_seq}"
            h = self._pool.pop() if self._pool else None
            if h is not None:
                h._reset(qid, ns, db, sql, deadline)
            else:
                h = QueryHandle.__new__(QueryHandle)
                h.cancel = CancelEvent()
                h._reset(qid, ns, db, sql, deadline)
                h.registry = self
            self.queries[qid] = h
        return h

    def close(self, handle: QueryHandle):
        with self.lock:
            self.queries.pop(handle.id, None)
            # recycle only a handle nobody can still legitimately
            # cancel: kill()/cancel_all() flip the flag UNDER this
            # lock, so a clean flag here means no set can race the
            # reuse; a tripped handle is simply dropped
            if (len(self._pool) < self.POOL_MAX
                    and not handle.cancel.is_set()
                    and not handle.timed_out):
                self._pool.append(handle)

    def kill(self, qid: str) -> bool:
        """Set the cancel flag on a running query. True when found.
        The set happens under the registry lock so it can never land on
        a handle that close() already recycled."""
        with self.lock:
            h = self.queries.get(qid)
            if h is None:
                return False
            h.cancel.set()
        return True

    def cancel_all(self):
        """Drain path: cancel every registered query (cooperative — the
        queries notice at their next check_deadline site)."""
        with self.lock:
            handles = list(self.queries.values())
            for h in handles:
                h.cancel.set()
        return len(handles)

    def snapshot(self) -> list[dict]:
        with self.lock:
            handles = sorted(self.queries.values(),
                             key=lambda h: h.started)
        return [h.to_dict() for h in handles]
