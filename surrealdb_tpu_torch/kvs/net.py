"""The clock and runtime seam (the reference package's `kvs/net.py`,
without its transport: the remote KV engines are not ported).

- ``Clock``   — ``monotonic()`` (deadlines, idle timers), ``wall()``
                (lease rows and heartbeats: values that land in the
                keyspace and must be comparable between nodes),
                ``sleep()``.
- ``Runtime`` — owns background execution: ``every()`` runs a
                cancellable periodic *tick* (the live fan-out's
                dead-session sweep), ``spawn()`` a one-shot task,
                ``rlock()`` the locks that may be held across blocking
                calls.

The default implementations are the real ones (``time``, daemon
threads). A simulator installs a virtual clock for the extent of a run
with ``use_clock`` and hands its own ``Runtime`` to the objects that
take one (`server.fanout.FanoutHub(runtime=...)`).

The AMBIENT clock: free functions that coordinate through the KV but
have no object to hang a clock on (`node.py`'s lease and heartbeat
helpers) read the process-wide ambient clock via ``wall()`` / ``mono()``
/ ``sleep_s()``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable

#: sentinel a periodic tick returns to stop its loop for good
STOP = object()


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------


class Clock:
    """Time source. ``monotonic`` feeds deadlines/idle timers (never
    compared across processes); ``wall`` feeds values that land in the
    keyspace and must be comparable between nodes (lease expiries,
    heartbeats)."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def wall(self) -> float:
        raise NotImplementedError

    def sleep(self, s: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def monotonic(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    def sleep(self, s: float) -> None:
        time.sleep(s)


REAL_CLOCK = RealClock()
_ambient: Clock = REAL_CLOCK


def ambient_clock() -> Clock:
    return _ambient


def wall() -> float:
    return _ambient.wall()


def mono() -> float:
    return _ambient.monotonic()


def sleep_s(s: float) -> None:
    _ambient.sleep(s)


@contextmanager
def use_clock(clock: Clock):
    """Install `clock` as the process ambient clock for the dynamic
    extent of the block."""
    global _ambient
    prev = _ambient
    _ambient = clock
    try:
        yield clock
    finally:
        _ambient = prev


# ---------------------------------------------------------------------------
# runtime (background loops + seam-aware locks)
# ---------------------------------------------------------------------------


class LoopHandle:
    """Cancellation handle for a ``Runtime.every`` loop."""

    def cancel(self) -> None:
        raise NotImplementedError


class Runtime:
    """Owns background execution and the locks that may be held across
    blocking calls."""

    def every(self, interval_s: float, tick: Callable[[], object],
              name: str = "tick", immediate: bool = False) -> LoopHandle:
        """Run ``tick()`` every ``interval_s``. The tick may return a
        float to override the delay before the NEXT tick (attach
        backoff), or ``net.STOP`` to end the loop. With ``immediate``
        the first tick runs before the first wait."""
        raise NotImplementedError

    def spawn(self, fn: Callable[[], None], name: str = "task") -> None:
        raise NotImplementedError

    def rlock(self):
        raise NotImplementedError


class _RealLoopHandle(LoopHandle):
    def __init__(self, stop: threading.Event):
        self._stop = stop

    def cancel(self) -> None:
        self._stop.set()


class RealRuntime(Runtime):
    """Daemon threads + Event waits."""

    def every(self, interval_s, tick, name="tick", immediate=False):
        stop = threading.Event()

        def loop():
            delay = 0.0 if immediate else interval_s
            while True:
                if delay and stop.wait(delay):
                    return
                if stop.is_set():
                    return
                try:
                    out = tick()
                except Exception:
                    out = None  # ticks guard themselves; never die here
                if out is STOP:
                    return
                delay = out if isinstance(out, (int, float)) else interval_s

        threading.Thread(target=loop, daemon=True, name=name).start()
        return _RealLoopHandle(stop)

    def spawn(self, fn, name="task"):
        threading.Thread(target=fn, daemon=True, name=name).start()

    def rlock(self):
        return threading.RLock()


REAL_RUNTIME = RealRuntime()
