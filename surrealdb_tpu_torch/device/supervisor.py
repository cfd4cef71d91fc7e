"""DeviceSupervisor: health-checked dispatch to the torch device runner
(the reference's `device/supervisor.py`, with the port's runner).

State machine:

    off ──(mode=off)───────────────────────────────► stays off
    cold ──first use──► probing ──ready frame──► ready
    ready ──crash / dispatch timeout──► degraded
    degraded ──probe streak ≥ promote threshold──► ready

While degraded (or still cold/probing) every dispatch raises
`DeviceUnavailable` and the callers serve from their host paths: the
circuit breaker. A background probe thread respawns and pings the
runner every `SURREAL_DEVICE_PROBE_INTERVAL_S`; promotion back to ready
takes `SURREAL_DEVICE_PROMOTE_SUCCESSES` consecutive healthy probes
(hysteresis: one lucky ping after a crash loop must not flap traffic
back onto a sick device).

Dispatch is pipelined: a send thread writes the frames of every caller
in turn, a receive thread hands each reply to the caller waiting on its
`seq`, so callers never wait in line for another's round trip (the
runner itself serves one frame at a time).

Deadlines: every dispatch waits at most min(op timeout, the calling
query's remaining budget). A wait that exhausts the FULL op timeout is
a wedge: the runner is SIGKILLed and the state degrades; a wait cut
short by the query's budget only orphans that one request (its late
reply is dropped by `seq`).

Modes (`SURREAL_DEVICE`): `off` (host paths only), `auto` (default:
supervised subprocess, degrade-and-recover), `require` (failures raise
`DeviceRequired` instead of degrading), `inline` (no subprocess; the
port's `DeviceHost` runs in-process, forfeiting isolation).

The serving stack around the supervisor (its query budgets, its
cancellation and its stage timers) plugs in through `bind_serving`;
unbound, a dispatch has no budget, is never cancelled and is not timed.
This module imports no torch: only the runner (and inline mode) does.
"""

from __future__ import annotations

import os
import queue
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device import proto
from surrealdb_tpu_torch.err import QueryCancelled, QueryTimeout, SdbError

_MODES = ("off", "auto", "require", "inline")


class DeviceUnavailable(Exception):
    """The device can't serve this dispatch (not started, degraded, died
    or timed out): fall back to the host path."""


class DeviceOpError(Exception):
    """The runner rejected ONE op (bad input, kernel error). Not a
    health event: callers degrade that query to host without tripping
    the circuit breaker."""


class DeviceOutOfMemory(DeviceUnavailable):
    """The runner refused a store that cannot fit its device byte budget
    (SURREAL_DEVICE_MEM_BUDGET_MB) even after evicting every other
    store. The supervisor remembers the (key, tag), so later ships of
    that store fail fast until its tag changes. Never a circuit-breaker
    event."""


class DeviceRequired(SdbError):
    """Mode `require`: the device could not serve, and the caller must
    fail loudly instead of answering from a host path (a statement
    error, as the reference's)."""


# QueryTimeout (the calling query ran past its budget while waiting on
# the device) and QueryCancelled (it was cancelled meanwhile) are the
# statement errors of `err.py`, re-exported here.


# -- the serving stack's seam ------------------------------------------------

_SERVING: dict = {"remaining": None, "cancelled": None, "stage_record": None,
                  "current": None}


def bind_serving(remaining: Optional[Callable[[], Optional[float]]] = None,
                 cancelled: Optional[Callable[[], bool]] = None,
                 stage_record: Optional[Callable[[str, int], None]] = None,
                 current: Optional[Callable[[], object]] = None):
    """Plug the serving stack in: `remaining()` gives the calling
    query's remaining budget in seconds (None: unbounded),
    `cancelled()` whether it was cancelled, `stage_record(name, ns)`
    times each dispatch as the `device_rpc` stage, and `current()` gives
    the calling query's handle (None: none), which the batcher wakes
    through `handle.cancel.add_waker(fn)` / `remove_waker(fn)` and marks
    with `mark_cancelled()` / `mark_timed_out()`. Each one left None
    takes its default: no budget, never cancelled, no timer, no
    handle."""
    _SERVING.update(remaining=remaining, cancelled=cancelled,
                    stage_record=stage_record, current=current)


def serving_bound() -> bool:
    """Whether any part of a serving stack is bound."""
    return any(fn is not None for fn in _SERVING.values())


def _query_remaining() -> Optional[float]:
    fn = _SERVING["remaining"]
    return None if fn is None else fn()


def _query_cancelled() -> bool:
    fn = _SERVING["cancelled"]
    return False if fn is None else bool(fn())


def _query_current():
    fn = _SERVING["current"]
    return None if fn is None else fn()


def _stage_record(name: str, ns: int):
    fn = _SERVING["stage_record"]
    if fn is not None:
        fn(name, ns)


def _required(what: str) -> DeviceRequired:
    return DeviceRequired(
        f"device required (SURREAL_DEVICE=require) but {what}")


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class DeviceSupervisor:
    # single-frame ship cap: bigger stores go begin/part.../end so no
    # frame (and no transient copy) has to hold the whole store
    LOAD_PART_BYTES = 256 << 20

    def __init__(self, mode: Optional[str] = None,
                 dispatch_timeout_s: Optional[float] = None,
                 load_timeout_s: Optional[float] = None,
                 init_timeout_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 promote_successes: Optional[int] = None,
                 device: str = "cuda",
                 mesh_devices: Optional[int] = None):
        # the environment is read at construction (not import) so tests
        # and embedded servers can configure each instance
        self.mode = (mode or os.environ.get("SURREAL_DEVICE", "")
                     or cnf.DEVICE_MODE).lower()
        if self.mode not in _MODES:
            raise ValueError(f"SURREAL_DEVICE must be off|auto|require|"
                             f"inline, got {self.mode!r}")
        # the runner's --device and --mesh-devices (the inline host's)
        self.device = device
        self.mesh_devices = mesh_devices
        self.dispatch_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_DISPATCH_TIMEOUT_S",
                          cnf.DEVICE_DISPATCH_TIMEOUT_S)
            if dispatch_timeout_s is None else dispatch_timeout_s)
        self.load_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_LOAD_TIMEOUT_S",
                          cnf.DEVICE_LOAD_TIMEOUT_S)
            if load_timeout_s is None else load_timeout_s)
        # init watchdog: torch + CUDA contexts + the kernels' build
        self.init_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_INIT_TIMEOUT_S",
                          cnf.BACKEND_INIT_TIMEOUT_S)
            if init_timeout_s is None else init_timeout_s)
        self.probe_interval_s = (
            cnf.env_float("SURREAL_DEVICE_PROBE_INTERVAL_S",
                          cnf.DEVICE_PROBE_INTERVAL_S)
            if probe_interval_s is None else probe_interval_s)
        self.promote_successes = (
            cnf.env_int("SURREAL_DEVICE_PROMOTE_SUCCESSES",
                        cnf.DEVICE_PROMOTE_SUCCESSES)
            if promote_successes is None else promote_successes)
        self.state = "off" if self.mode == "off" else "cold"
        self.platform: Optional[str] = None
        self.device_count = 0
        self.last_error: Optional[str] = None
        # the current runner's ready frame
        self.ready_meta: Optional[dict] = None
        self.counters = {
            "device_spawns": 0, "device_restarts": 0,
            "device_dispatch_timeouts": 0, "device_dispatch_errors": 0,
            "device_fallbacks": 0, "device_host_routed": 0,
            "device_oom_refusals": 0,
        }
        # stores the runner refused under its byte budget: key -> tag;
        # ensure_loaded fails these fast until the store's tag changes
        self._oom_keys: dict = {}
        # the runner's compile counters (piggybacked on every reply) and
        # its build cache
        self.compile_counts = {"hits": 0, "misses": 0}
        self.compile_cache_info: Optional[dict] = None
        # mesh topology from the runner's ready frame
        self.mesh_info: Optional[dict] = None
        self._lock = threading.RLock()
        self._ready = threading.Event()
        self._gen = 0
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._send_q: Optional[queue.Queue] = None
        self._pending: dict = {}  # seq -> [Event, reply|None]
        self._seq = 0
        self._loaded: dict = {}  # cache key -> tag (current runner gen)
        self._probe_thread: Optional[threading.Thread] = None
        self._spawn_thread: Optional[threading.Thread] = None
        # (proc, sock) of a runner still in its init handshake, so
        # shutdown() can kill it (it may hold the card for up to
        # init_timeout_s otherwise)
        self._spawning: Optional[tuple] = None
        self._stop = threading.Event()
        self._inline_host = None
        if self.mode == "inline":
            self.state = "ready"
            self._ready.set()

    # -- public surface ------------------------------------------------------

    def start(self) -> dict:
        """Start the runner and wait for it (at most `init_timeout_s`).
        Returns the ready frame's meta. On failure it shuts the
        supervisor down (no probe thread keeps respawning runners) and
        raises DeviceUnavailable with the cause."""
        if self.mode in ("off", "inline"):
            raise DeviceUnavailable(f"no runner in mode {self.mode}")
        self.ensure_started()
        if self.wait_ready(self.init_timeout_s):
            return self.ready_meta
        reason = self.last_error or f"device {self.state}"
        self.shutdown()
        raise DeviceUnavailable(reason)

    def fast_path(self) -> bool:
        """True when callers should route this dispatch to the device.
        A cold supervisor kicks off the async spawn and answers False:
        the first queries serve from host while the runner starts."""
        if self.mode == "off" or self._stop.is_set():
            return False
        if self.mode in ("inline", "require"):
            return True
        if self.state == "ready":
            return True
        if self.state == "cold":
            self.ensure_started()
        return False

    def unavailable(self, reason: str) -> Exception:
        """The exception a CALLER raises when it gives up on the device
        (cache thrashing, repeated stale replies): DeviceRequired in
        require mode, else the degrade signal."""
        if self.mode == "require":
            return _required(f"unavailable: {reason}")
        return DeviceUnavailable(reason)

    def note_fallback(self):
        """A caller served from the host path because the device was
        unavailable (counted once per degraded dispatch)."""
        if self.mode != "off":
            self.counters["device_fallbacks"] += 1

    def ensure_started(self):
        """Kick the async first spawn (idempotent, never blocks)."""
        if self.mode in ("off", "inline") or self._stop.is_set():
            return
        with self._lock:
            if self.state != "cold" or self._spawn_thread is not None:
                return
            self.state = "probing"
            stop = self._stop
            t = threading.Thread(target=self._first_spawn, args=(stop,),
                                 daemon=True, name="device-spawn")
            self._spawn_thread = t
        t.start()

    def wait_ready(self, timeout_s: float) -> bool:
        """Block until the runner is serving. Returns False EARLY when
        init fails (state degraded): a backend that errors fast must
        fail fast, not eat the whole watchdog window while the probe
        loop respawns it."""
        if self.mode == "off":
            return False
        self.ensure_started()
        end = time.monotonic() + timeout_s
        while True:
            left = end - time.monotonic()
            if left <= 0:
                return self._ready.is_set()
            if self._ready.wait(min(left, 0.05)):
                return True
            if self.state == "degraded":
                return False

    def call(self, op: str, meta: dict, bufs=(),
             timeout_s: Optional[float] = None):
        """One dispatch -> (tag, meta, bufs). Raises DeviceUnavailable
        (degrade to host), DeviceOpError (this op failed) or
        DeviceRequired (mode require, the device can't serve). Wall time
        goes to the bound `device_rpc` stage timer."""
        if self.mode == "off" or self._stop.is_set():
            raise DeviceUnavailable("device disabled")
        if self.mode == "inline":
            t0 = time.perf_counter_ns()
            try:
                return self._call_inline(op, meta, bufs)
            finally:
                _stage_record("device_rpc", time.perf_counter_ns() - t0)
        base = self.dispatch_timeout_s if timeout_s is None else timeout_s
        if not self._ready.is_set():
            self.ensure_started()
            if self.mode != "require":
                raise DeviceUnavailable(f"device {self.state}")
            # wait at most one dispatch window (capped by the query's
            # budget) for readiness, then fail the query; even for
            # loads, since this is a health gate, not an op
            budget = _query_remaining()
            wait = self.dispatch_timeout_s if budget is None \
                else min(self.dispatch_timeout_s, max(budget, 0.0))
            if not self._ready.wait(wait):
                raise _required(f"unavailable: state={self.state}, "
                                f"last error: {self.last_error}")
        try:
            t0 = time.perf_counter_ns()
            try:
                return self._call_live(op, meta, bufs, base)
            finally:
                _stage_record("device_rpc", time.perf_counter_ns() - t0)
        except DeviceUnavailable:
            if self.mode == "require":
                raise _required(
                    f"dispatch failed: {self.last_error}") from None
            raise
        except DeviceOpError as e:
            if self.mode == "require":
                # require means the device path IS the contract
                raise DeviceRequired(
                    f"device op failed (SURREAL_DEVICE=require): {e}"
                ) from None
            raise

    # -- cache bookkeeping ---------------------------------------------------

    def ensure_loaded(self, key: str, tag, loader):
        """Ship a block cache unless (key, tag) is already resident on
        the CURRENT runner. `loader() -> (op, meta, bufs)` builds the
        payload only when a ship is needed."""
        tag = list(tag)
        with self._lock:
            if self._loaded.get(key) == tag:
                return
            if self._oom_keys.get(key) == tag:
                # the runner already refused this exact store under its
                # byte budget: fail fast instead of shipping it again
                if self.mode == "require":
                    raise _required(
                        f"store {key} exceeds the device byte budget")
                raise DeviceOutOfMemory(
                    f"store {key} over device budget (cached refusal)")
        op, meta, bufs = loader()
        meta = dict(meta)
        meta["key"] = key
        meta["tag"] = tag
        # a refusal is recorded where its reply is read (_call_live,
        # _call_inline): require mode rewraps the exception first
        if op == "vec_load" and bufs[0].nbytes > self.LOAD_PART_BYTES:
            self._multipart_vec_load(key, tag, meta, bufs[0], bufs[1])
        elif (op == "ann_load"
                and sum(b.nbytes for b in bufs) > self.LOAD_PART_BYTES):
            self._multipart_ann_load(key, tag, meta, bufs)
        else:
            self.call(op, meta, bufs, timeout_s=self.load_timeout_s)
        with self._lock:
            self._loaded[key] = tag
            self._oom_keys.pop(key, None)
        if self.mode != "inline":
            kind = {"vec_load": "vec", "ann_load": "ann",
                    "csr_load": "csr"}.get(op)
            if kind is not None:
                self._prewarm_async(key, tag, kind)

    def _multipart_vec_load(self, key, tag, meta, vecs, valid):
        begin = dict(meta)
        begin["shape"] = list(vecs.shape)
        begin["dtype"] = vecs.dtype.str
        self.call("vec_load_begin", begin, [valid],
                  timeout_s=self.load_timeout_s)
        row_bytes = max(1, vecs.shape[1] * vecs.dtype.itemsize)
        step = max(1, self.LOAD_PART_BYTES // row_bytes)
        for off in range(0, vecs.shape[0], step):
            t, _m, _b = self.call(
                "vec_load_part", {"key": key, "off": off},
                [vecs[off:off + step]], timeout_s=self.load_timeout_s,
            )
            if t == "stale":  # runner restarted mid-ship
                raise self.unavailable("runner lost mid-load")
        t, _m, _b = self.call("vec_load_end", {"key": key, "tag": tag},
                              timeout_s=self.load_timeout_s)
        if t == "stale":
            raise self.unavailable("runner lost mid-load")

    def _multipart_ann_load(self, key, tag, meta, bufs):
        """Chunked ship of a quantized ANN index: begin carries the
        small per-row arrays and the shapes, the graph and the int8 rows
        stream as named row-chunked parts (no single frame, and no
        transient copy, holds a large index whole)."""
        graph, x8, arow, x2q = bufs
        begin = dict(meta)
        begin["d_out"] = int(graph.shape[1])
        begin["dim"] = int(x8.shape[1])
        self.call("ann_load_begin", begin, [arow, x2q],
                  timeout_s=self.load_timeout_s)
        for name, arr in (("graph", graph), ("x8", x8)):
            row_bytes = max(1, arr.shape[1] * arr.dtype.itemsize)
            step = max(1, self.LOAD_PART_BYTES // row_bytes)
            for off in range(0, arr.shape[0], step):
                t, _m, _b = self.call(
                    "ann_load_part", {"key": key, "buf": name, "off": off},
                    [arr[off:off + step]], timeout_s=self.load_timeout_s,
                )
                if t == "stale":  # runner restarted mid-ship
                    raise self.unavailable("runner lost mid-load")
        t, _m, _b = self.call("ann_load_end", {"key": key, "tag": tag},
                              timeout_s=self.load_timeout_s)
        if t == "stale":
            raise self.unavailable("runner lost mid-load")

    def _prewarm_async(self, key: str, tag, kind: str = "vec"):
        """Fire-and-forget warm-up of a freshly shipped store: the
        query-bucket ladder for vector and ANN stores
        (SURREAL_DEVICE_PREWARM_BUCKETS), the hop-depth ladder for CSR
        graphs (SURREAL_DEVICE_PREWARM_HOPS), on a daemon thread so the
        shipping query isn't held. Best-effort: a failure only costs
        warmth."""
        if kind == "csr":
            op, field = "csr_prewarm", "hops"
            raw = cnf.env_str("SURREAL_DEVICE_PREWARM_HOPS",
                              cnf.DEVICE_PREWARM_HOPS)
        else:
            op = "ann_prewarm" if kind == "ann" else "vec_prewarm"
            field = "buckets"
            raw = cnf.env_str("SURREAL_DEVICE_PREWARM_BUCKETS",
                              cnf.DEVICE_PREWARM_BUCKETS)
        try:
            steps = [int(x) for x in raw.split(",") if x.strip()]
        except ValueError:
            steps = []
        if not steps:
            return
        stop = self._stop

        def warm():
            # one shape per dispatch, smallest first: each call stays
            # well inside the load window
            for b in sorted(set(steps)):
                if stop.is_set():
                    return  # shut down: a call now would spawn a runner
                try:
                    t, _m, _b = self.call(
                        op, {"key": key, "tag": list(tag), field: [b]},
                        timeout_s=self.load_timeout_s)
                except Exception:
                    return
                if t != "ok":
                    return

        threading.Thread(target=warm, daemon=True,
                         name="device-prewarm").start()

    def forget(self, key: str):
        with self._lock:
            self._loaded.pop(key, None)
            self._oom_keys.pop(key, None)

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """The reference's status keys; `batching` is the process's
        cross-query batcher accounting (device/batcher.py)."""
        host = self._inline_host
        if self.mode == "inline" and host is not None \
                and self.mesh_info is None:
            from surrealdb_tpu_torch.device import mesh as devmesh

            self.mesh_info = devmesh.describe(host.device_count())
        with self._lock:
            loaded = list(self._loaded)
        out = {
            "state": self.state,
            "mode": self.mode,
            "platform": self.platform,
            "device_count": self.device_count,
            "restarts": self.counters["device_restarts"],
            "dispatch_timeouts": self.counters["device_dispatch_timeouts"],
            "dispatch_errors": self.counters["device_dispatch_errors"],
            "fallbacks": self.counters["device_fallbacks"],
            "host_routed": self.counters["device_host_routed"],
            "oom_refusals": self.counters["device_oom_refusals"],
            "last_error": self.last_error,
            "vec_blocks": sum(1 for k in loaded if k.startswith("vec/")),
            "csr_blocks": sum(1 for k in loaded if k.startswith("csr/")),
            "ann_blocks": sum(1 for k in loaded if k.startswith("ann/")),
            "compile_cache": self.compile_counts_now(),
        }
        if self.compile_cache_info is not None:
            out["compile_cache_dir"] = self.compile_cache_info
        if self.mesh_info is not None:
            out["mesh"] = dict(self.mesh_info)
        from surrealdb_tpu_torch.device.batcher import BATCH_STATS

        out["batching"] = BATCH_STATS.to_dict()
        if self.mode == "inline" and host is not None:
            out["vec_blocks"] = len(host.vec)
            out["csr_blocks"] = len(host.csr)
            out["ann_blocks"] = len(host.ann)
        return out

    def compile_counts_now(self) -> dict:
        """Kernel compile hit/miss counters: in-process (inline mode)
        or the last snapshot a runner reply carried."""
        if self.mode == "inline":
            from surrealdb_tpu_torch.device import kernelstats

            return kernelstats.snapshot()
        return dict(self.compile_counts)

    def runner_pid(self) -> Optional[int]:
        p = self._proc
        return p.pid if p is not None else None

    def shutdown(self):
        """Stop the runner and every background thread. The supervisor
        returns to `cold`: a later dispatch may respawn (processes
        share the singleton across server lifecycles)."""
        with self._lock:
            self._stop.set()
            # background threads captured the OLD stop event; a fresh
            # one re-arms the supervisor
            self._stop = threading.Event()
            proc, self._proc = self._proc, None
            sock, self._sock = self._sock, None
            spawning, self._spawning = self._spawning, None
            # stale threads exit on their captured token
            self._probe_thread = None
            self._spawn_thread = None
            self._ready.clear()
            self._send_q = None
            self._gen += 1  # orphan any surviving send/recv loops
            if self.state != "off":
                self.state = "cold"
            self._fail_pending("device supervisor shut down")
            self._loaded.clear()
            self._oom_keys.clear()
            self._inline_host = None
        _close_sock(sock)
        if spawning is not None:
            # a runner still in its init handshake holds the card: kill
            # it, and close its socket so the handshake recv unwinds
            _reap(spawning[0])
            _close_sock(spawning[1])
        if proc is not None:
            proc.kill()
            try:
                proc.wait(timeout=5)
            except (subprocess.TimeoutExpired, OSError):
                pass

    # -- inline mode ---------------------------------------------------------

    def _call_inline(self, op, meta, bufs):
        from surrealdb_tpu_torch.device.handlers import (
            DeviceBudgetError, DeviceHost,
        )

        with self._lock:
            if self._inline_host is None:
                self._inline_host = DeviceHost(self.device,
                                               self.mesh_devices)
                self.platform = self._inline_host.platform()
                self.device_count = self._inline_host.device_count()
            host = self._inline_host
        try:
            return host.handle(op, dict(meta), list(bufs))
        except (KeyboardInterrupt, SystemExit):
            raise
        except DeviceBudgetError as e:
            self._note_oom(meta)
            raise DeviceOutOfMemory(str(e)) from e
        except BaseException as e:
            self.counters["device_dispatch_errors"] += 1
            raise DeviceOpError(f"{e.__class__.__name__}: {e}") from e

    def inline_store(self, key: str):
        """Test/debug hook: the in-process store behind a cache key
        (inline mode only; None when absent)."""
        host = self._inline_host
        if host is None:
            return None
        ent = host.vec.get(key) or host.csr.get(key) or host.ann.get(key)
        return ent[1] if ent is not None else None

    # -- subprocess lifecycle ------------------------------------------------

    def _spawn_runner(self, stop) -> bool:
        """Spawn + handshake one runner under the init watchdog. Returns
        True when it answered ready. `stop` is the lifecycle token the
        calling thread captured: a shutdown re-arms the supervisor with
        a fresh token, so a stale spawn aborts instead of registering a
        zombie runner."""
        parent, child = socket.socketpair()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_pkg_root(), env.get("PYTHONPATH", "")) if p)
        mesh = ([] if self.mesh_devices is None else
                ["--mesh-devices", str(int(self.mesh_devices))])
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "surrealdb_tpu_torch.device.runner",
                 "--fd", str(child.fileno()), "--device", self.device,
                 *mesh],
                pass_fds=(child.fileno(),), env=env,
            )
        except OSError as e:
            _close_sock(parent)
            child.close()
            self.last_error = f"spawn failed: {e}"
            return False
        # plain close (no shutdown): the child inherited this fd, and a
        # SHUT_RDWR here would sever ITS end of the socket
        child.close()
        self.counters["device_spawns"] += 1
        with self._lock:
            if stop.is_set() or stop is not self._stop:
                _reap(proc)
                _close_sock(parent)
                return False
            self._spawning = (proc, parent)
        parent.settimeout(self.init_timeout_s)
        try:
            tag, meta, _bufs = proto.recv_msg(parent)
        except socket.timeout:
            self.last_error = (f"init watchdog: runner init exceeded "
                               f"{self.init_timeout_s:.0f}s")
            self._abort_spawn(proc, parent)
            return False
        except (ConnectionError, OSError) as e:
            self.last_error = f"runner died during init: {e}"
            self._abort_spawn(proc, parent)
            return False
        if tag != "ready":
            self.last_error = (f"runner init failed: "
                               f"{meta.get('error', tag)}")
            self._abort_spawn(proc, parent)
            return False
        parent.settimeout(None)
        with self._lock:
            self._spawning = None
            if stop.is_set() or stop is not self._stop:
                _reap(proc)
                _close_sock(parent)
                return False
            self._gen += 1
            gen = self._gen
            self._proc = proc
            self._sock = parent
            self._loaded.clear()
            self.ready_meta = meta
            self.platform = meta.get("platform")
            self.device_count = int(meta.get("device_count", 0))
            if meta.get("compile_cache") is not None:
                self.compile_cache_info = meta["compile_cache"]
            if meta.get("mesh") is not None:
                self.mesh_info = meta["mesh"]
            self._send_q = queue.Queue()
        threading.Thread(target=self._send_loop, args=(parent, gen),
                         daemon=True, name="device-send").start()
        threading.Thread(target=self._recv_loop, args=(parent, gen),
                         daemon=True, name="device-recv").start()
        return True

    def _abort_spawn(self, proc, sock):
        with self._lock:
            self._spawning = None
        _reap(proc)
        _close_sock(sock)

    def _first_spawn(self, stop):
        ok = self._spawn_runner(stop)
        with self._lock:
            if self._spawn_thread is threading.current_thread():
                self._spawn_thread = None
            if stop.is_set() or stop is not self._stop:
                return
            if ok:
                self.state = "ready"
                self._ready.set()
                return
        self._mark_degraded(self.last_error or "init failed", kill=False)

    def _mark_degraded(self, reason: str, kill: bool = True):
        """Circuit-break: kill the runner (crash-only: its stores are
        re-shipped from the serving side's data), fail every in-flight
        dispatch, and start the background re-probe."""
        with self._lock:
            if self._stop.is_set() or self.state == "off":
                return
            if self.state != "degraded":
                # only the TRANSITION records the cause: the socket
                # teardown that follows a wedge-kill must not overwrite
                # the wedge as "runner died"
                self.last_error = reason
            self.state = "degraded"
            self._ready.clear()
            proc, self._proc = self._proc, None
            sock, self._sock = self._sock, None
            self._send_q = None
            self._loaded.clear()
            self._fail_pending(reason)
            start_probe = self._probe_thread is None
            if start_probe:
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, args=(self._stop,),
                    daemon=True, name="device-probe",
                )
        _close_sock(sock)
        if kill:
            _reap(proc)
        if start_probe:
            self._probe_thread.start()

    def _fail_pending(self, reason: str):
        # caller holds the lock
        for slot in self._pending.values():
            slot[1] = ("err", {"error": reason, "_unavail": True}, [])
            slot[0].set()
        self._pending.clear()

    def _probe_loop(self, stop):
        """Background re-probe with hysteresis: a recovered device is
        re-promoted without a server restart."""
        streak = 0
        while not stop.wait(self.probe_interval_s):
            with self._lock:
                if self.state != "degraded" or stop is not self._stop:
                    break
                have_runner = self._proc is not None
            try:
                if not have_runner:
                    if not self._spawn_runner(stop):
                        streak = 0
                        continue
                    self.counters["device_restarts"] += 1
                t, m, _b = self._call_live("ping", {}, (),
                                           self.dispatch_timeout_s,
                                           health_check=True)
                if t != "ok":
                    raise DeviceUnavailable(str(m))
                streak += 1
            except (DeviceUnavailable, DeviceOpError):
                streak = 0
                with self._lock:
                    proc, self._proc = self._proc, None
                    sock, self._sock = self._sock, None
                    self._send_q = None
                    self._loaded.clear()
                # last_error keeps the original degradation cause (or
                # the spawn failure _spawn_runner just recorded)
                _close_sock(sock)
                _reap(proc)
                continue
            if streak >= max(1, self.promote_successes):
                with self._lock:
                    if self.state == "degraded":
                        self.state = "ready"
                        self._ready.set()
                break
        with self._lock:
            if self._probe_thread is threading.current_thread():
                self._probe_thread = None
            # re-arm if we raced a fresh degradation
            if (self.state == "degraded" and stop is self._stop
                    and not stop.is_set()
                    and self._probe_thread is None):
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, args=(stop,),
                    daemon=True, name="device-probe",
                )
                self._probe_thread.start()

    # -- live dispatch -------------------------------------------------------

    def _call_live(self, op, meta, bufs, base_timeout,
                   health_check=False):
        budget = None if health_check else _query_remaining()
        eff = base_timeout if budget is None \
            else min(base_timeout, max(budget, 0.0))
        if eff <= 0:
            raise DeviceUnavailable("query budget exhausted")
        with self._lock:
            if not health_check and self.state != "ready":
                raise DeviceUnavailable(f"device {self.state}")
            sock = self._sock
            sq = self._send_q
            if sock is None or sq is None:
                raise DeviceUnavailable("no runner")
            self._seq += 1
            seq = self._seq
            ev = threading.Event()
            slot = [ev, None]
            self._pending[seq] = slot
        meta = dict(meta)
        meta["seq"] = seq
        sq.put((op, meta, bufs))
        end = time.monotonic() + eff
        cancelled = False
        while not ev.is_set():
            left = end - time.monotonic()
            if left <= 0:
                break
            ev.wait(min(left, 0.05))
            if not health_check and _query_cancelled():
                cancelled = True
                break
        if not ev.is_set():
            with self._lock:
                self._pending.pop(seq, None)
            if cancelled:
                raise DeviceUnavailable("query cancelled mid-dispatch")
            self.counters["device_dispatch_timeouts"] += 1
            if eff >= base_timeout - 1e-9:
                # the FULL op window elapsed: a wedged runner, killed and
                # degraded (a short-budget query only orphans its call)
                self._mark_degraded(
                    f"dispatch timeout: {op} exceeded {base_timeout}s "
                    f"(runner wedged)")
            raise DeviceUnavailable(f"dispatch timed out ({op})")
        tag, rmeta, rbufs = slot[1]
        if tag == "err":
            if rmeta.get("_unavail"):
                raise DeviceUnavailable(rmeta.get("error", "runner died"))
            if rmeta.get("oom"):
                # a typed budget refusal: this store goes to host, the
                # circuit stays closed
                self._note_oom(meta)
                raise DeviceOutOfMemory(
                    rmeta.get("error", "device store over budget"))
            self.counters["device_dispatch_errors"] += 1
            raise DeviceOpError(rmeta.get("error", "device op failed"))
        return tag, rmeta, rbufs

    def _note_oom(self, meta: dict):
        """Record a budget refusal of the store named in `meta`: the
        counter and the per-(key, tag) fail-fast cache ensure_loaded
        reads, here so it happens in every mode (require rewraps the
        exception before callers could record it)."""
        self.counters["device_oom_refusals"] += 1
        key, tag = meta.get("key"), meta.get("tag")
        if key and tag is not None:
            with self._lock:
                self._oom_keys[key] = list(tag)

    def _send_loop(self, sock, gen):
        while True:
            with self._lock:
                sq = self._send_q if gen == self._gen else None
            if sq is None:
                return
            try:
                item = sq.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                proto.send_msg(sock, *item)
            except (OSError, ValueError) as e:
                if self._is_current(gen):
                    self._mark_degraded(f"runner link lost (send): {e}")
                return

    def _recv_loop(self, sock, gen):
        while True:
            try:
                tag, meta, bufs = proto.recv_msg(sock)
            except (ConnectionError, OSError) as e:
                if self._is_current(gen):
                    self._mark_degraded(f"runner died: {e}")
                return
            cc = meta.get("cc")
            if isinstance(cc, dict):
                self.compile_counts = cc
            with self._lock:
                # an orphaned request's late reply finds no slot
                slot = self._pending.pop(meta.get("seq"), None)
            if slot is not None:
                slot[1] = (tag, meta, bufs)
                slot[0].set()

    def _is_current(self, gen) -> bool:
        with self._lock:
            return gen == self._gen and not self._stop.is_set() \
                and self.state in ("ready", "degraded", "probing")


def _reap(proc):
    """SIGKILL + reap a runner without blocking the caller (a zombie per
    restart would pile up in a long-lived serving process)."""
    if proc is None:
        return
    try:
        proc.kill()
    except OSError:
        pass
    threading.Thread(target=proc.wait, daemon=True,
                     name="device-reap").start()


def _close_sock(sock):
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# -- process-wide singleton --------------------------------------------------
# Device memory is a process-wide resource: every caller in the process
# shares ONE supervised runner. Tests swap instances via set_supervisor.

_SUP: Optional[DeviceSupervisor] = None
_SUP_LOCK = threading.Lock()


def get_supervisor() -> DeviceSupervisor:
    global _SUP
    with _SUP_LOCK:
        if _SUP is None:
            _SUP = DeviceSupervisor()
        return _SUP


def set_supervisor(sup: Optional[DeviceSupervisor]):
    """Install a supervisor instance; returns the previous one (tests
    restore it). Does NOT shut the old one down."""
    global _SUP
    with _SUP_LOCK:
        old, _SUP = _SUP, sup
        return old


def reset_supervisor():
    """Shut down and drop the singleton (the next get_ re-reads the
    environment)."""
    global _SUP
    with _SUP_LOCK:
        old, _SUP = _SUP, None
    if old is not None:
        old.shutdown()


def attach_telemetry(telemetry):
    """Register the device gauges on any object with
    `register_gauge(name, fn)`. The closures read the CURRENT singleton,
    so a swapped supervisor keeps reporting."""
    telemetry.register_gauge(
        "device_degraded",
        lambda: 1 if get_supervisor().state == "degraded" else 0,
    )
    for name in ("device_restarts", "device_dispatch_timeouts",
                 "device_fallbacks", "device_host_routed",
                 "device_oom_refusals"):
        telemetry.register_gauge(
            name, lambda n=name: get_supervisor().counters.get(n, 0)
        )
    # cross-query batching efficiency (device/batcher.py): dispatch-size
    # last/avg/max say whether concurrency is actually coalescing
    from surrealdb_tpu_torch.device.batcher import BATCH_STATS

    telemetry.register_gauge(
        "device_batch_size_last", lambda: BATCH_STATS.last
    )
    telemetry.register_gauge(
        "device_batch_size_max", lambda: BATCH_STATS.max
    )
    telemetry.register_gauge(
        "device_batch_size_avg",
        lambda: round(BATCH_STATS.riders / max(BATCH_STATS.dispatches, 1),
                      2),
    )
    telemetry.register_gauge(
        "device_batch_dispatches", lambda: BATCH_STATS.dispatches
    )
    # kernel library accounting: a miss is a build paid by a runner
    telemetry.register_gauge(
        "device_compile_cache_hits",
        lambda: get_supervisor().compile_counts_now()["hits"],
    )
    telemetry.register_gauge(
        "device_compile_cache_misses",
        lambda: get_supervisor().compile_counts_now()["misses"],
    )
