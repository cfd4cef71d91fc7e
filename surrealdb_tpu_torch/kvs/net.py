"""The clock, runtime and transport seam of the distributed KV stack
(the reference package's `kvs/net.py`).

- ``Clock``     — ``monotonic()`` (deadlines, idle timers), ``wall()``
                  (lease rows, TSO stamps, heartbeats: values that land
                  in the keyspace or cross the wire and must be
                  comparable between nodes), ``sleep()``.
- ``Runtime``   — owns background execution: ``every()`` runs a
                  cancellable periodic *tick* (replication heartbeats,
                  lease renewal, the live fan-out's dead-session sweep),
                  ``spawn()`` a one-shot task, ``rlock()`` the locks
                  that may be held across blocking transport calls.
- ``Transport`` — outbound connections (``connect`` → a channel with
                  ``call``/``close``) and the ``status_of`` probe, over
                  4-byte length-prefixed CBOR frames (``send_frame`` /
                  ``recv_frame``), byte for byte the reference's.

The default implementations are the real ones (``time``, daemon
threads, TCP sockets). A simulator installs a virtual clock for the
extent of a run with ``use_clock`` and hands its own ``Runtime`` and
``Transport`` to the objects that take one (`kvs/remote.py`,
`kvs/shard.py`, `server.fanout.FanoutHub(runtime=...)`).

This module is the only place in the distributed stack that calls
``time.time()``, ``time.sleep()`` or makes sockets itself.

The AMBIENT clock: free functions that coordinate through the KV but
have no object to hang a clock on (`node.py`'s lease, TSO and heartbeat
helpers) read the process-wide ambient clock via ``wall()`` / ``mono()``
/ ``sleep_s()``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from surrealdb_tpu_torch.err import SdbError

_HDR = struct.Struct(">I")
MAX_FRAME = 256 << 20

#: sentinel a periodic tick returns to stop its loop for good
STOP = object()


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------


class Clock:
    """Time source. ``monotonic`` feeds deadlines/idle timers (never
    compared across processes); ``wall`` feeds values that land in the
    keyspace and must be comparable between nodes (lease expiries, TSO
    stamps)."""

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
    extent of the block (a simulator wraps every run in this)."""
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
    blocking transport calls."""

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
    """Daemon threads + Event waits — exactly the loops kvs/remote.py
    used to hand-roll, factored behind the seam."""

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


# ---------------------------------------------------------------------------
# transport (real TCP implementation)
# ---------------------------------------------------------------------------


def parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise SdbError(f"kv address must be host:port, got {addr!r}")
    return host, int(port)


def send_frame(sock, payload: bytes):
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kv peer closed")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock) -> bytes:
    (n,) = _HDR.unpack(recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise SdbError(f"kv frame too large: {n}")
    return recv_exact(sock, n)


def _encode(msg) -> bytes:
    from surrealdb_tpu_torch import wire

    return wire.encode(msg)


def _decode(b: bytes):
    from surrealdb_tpu_torch import wire

    return wire.decode(b)


class _Conn:
    """One authenticated client connection to a KV server (real TCP)."""

    def __init__(self, addr, secret: Optional[str],
                 timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None):
        from surrealdb_tpu_torch import cnf

        op_timeout = cnf.KV_OP_TIMEOUT_S if timeout is None else timeout
        # connect under the (short) connect timeout — a SYN-black-holed
        # peer must not eat the whole op timeout before discovery can
        # even run — then widen to the op timeout for the data path
        self.sock = socket.create_connection(
            addr,
            timeout=op_timeout if connect_timeout is None
            else connect_timeout,
        )
        self.sock.settimeout(op_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.epoch = -1  # pool failover epoch tag
        if secret:
            self.call(["auth", secret])

    def call(self, msg):
        send_frame(self.sock, _encode(msg))
        resp = _decode(recv_frame(self.sock))
        if resp[0] == "err":
            raise SdbError(resp[1])
        return resp[1]

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Transport:
    """Outbound-connection factory. ``connect`` returns a channel with
    ``call(msg)`` / ``close()`` / a writable ``epoch`` attribute."""

    def connect(self, addr, secret: Optional[str] = None,
                timeout: Optional[float] = None,
                connect_timeout: Optional[float] = None):
        raise NotImplementedError

    def status_of(self, addr, secret,
                  timeout: float = 1.0) -> Optional[dict]:
        """Probe one server's status; None when unreachable/sick."""
        try:
            c = self.connect(addr, secret, timeout=timeout)
        except (OSError, SdbError):
            return None
        try:
            st = c.call(["status"])
            return st if isinstance(st, dict) else None
        except Exception:
            return None
        finally:
            c.close()

    def make_lock(self):
        """Lock factory for client-side locks that may be held across
        blocking calls on this transport (the pool's discovery lock)."""
        return threading.Lock()

    def queue_get(self, q, timeout: float):
        """Dequeue with a bounded wait (raises queue.Empty on expiry).
        The real implementation blocks event-driven — a release wakes
        the waiter immediately; a simulator overrides it to park in
        virtual time (a real block would freeze the kernel)."""
        return q.get(timeout=timeout)


class RealTransport(Transport):
    def connect(self, addr, secret=None, timeout=None,
                connect_timeout=None):
        return _Conn(addr, secret, timeout=timeout,
                     connect_timeout=connect_timeout)


REAL_TRANSPORT = RealTransport()
