"""Client of the torch device runner (the reference's
`device/supervisor.py`, the client subset).

`DeviceSupervisor` spawns `python -m surrealdb_tpu_torch.device.runner`
with one end of a socketpair, waits for its ready frame under the init
watchdog, sends one op at a time with a timeout (a timeout or a lost
runner kills it and raises `DeviceUnavailable`), ships vector and
graph-ANN stores in parts above `LOAD_PART_BYTES` and shuts the runner
down. The reference's
background re-probe, degrade/promote state machine and cross-query
batching are not part of this client.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
from typing import Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device import proto


class DeviceUnavailable(Exception):
    """The runner cannot serve: it failed to start, died, or timed out."""


class DeviceOpError(Exception):
    """The runner rejected ONE op (bad input, kernel error, not ported)."""


class DeviceOutOfMemory(DeviceUnavailable):
    """The runner refused a store over its device byte budget."""


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class DeviceSupervisor:
    # single-frame ship cap: bigger vector stores go begin/part.../end so
    # no frame (and no transient copy) has to hold the whole store
    LOAD_PART_BYTES = 256 << 20

    def __init__(self, device: str = "cuda",
                 init_timeout_s: Optional[float] = None,
                 dispatch_timeout_s: Optional[float] = None,
                 load_timeout_s: Optional[float] = None,
                 mesh_devices: Optional[int] = None):
        self.device = device
        # the runner's --mesh-devices (device/mesh.py device_list)
        self.mesh_devices = mesh_devices
        self.init_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_INIT_TIMEOUT_S",
                          cnf.BACKEND_INIT_TIMEOUT_S)
            if init_timeout_s is None else init_timeout_s)
        self.dispatch_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_DISPATCH_TIMEOUT_S",
                          cnf.DEVICE_DISPATCH_TIMEOUT_S)
            if dispatch_timeout_s is None else dispatch_timeout_s)
        self.load_timeout_s = (
            cnf.env_float("SURREAL_DEVICE_LOAD_TIMEOUT_S",
                          cnf.DEVICE_LOAD_TIMEOUT_S)
            if load_timeout_s is None else load_timeout_s)
        self.ready: Optional[dict] = None
        self.platform: Optional[str] = None
        self.last_error: Optional[str] = None
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._loaded: dict = {}  # cache key -> tag on the current runner

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> dict:
        """Spawn the runner and wait for its ready frame (at most
        `init_timeout_s`). Returns the ready meta; raises
        DeviceUnavailable when init fails or the watchdog fires."""
        with self._lock:
            if self._proc is not None:
                return self.ready
            parent, child = socket.socketpair()
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_pkg_root(), env.get("PYTHONPATH", "")) if p)
            try:
                mesh = ([] if self.mesh_devices is None else
                        ["--mesh-devices", str(int(self.mesh_devices))])
                proc = subprocess.Popen(
                    [sys.executable, "-m", "surrealdb_tpu_torch.device.runner",
                     "--fd", str(child.fileno()), "--device", self.device,
                     *mesh],
                    pass_fds=(child.fileno(),), env=env,
                )
            except OSError as e:
                parent.close()
                raise DeviceUnavailable(f"spawn failed: {e}") from e
            finally:
                child.close()
            parent.settimeout(self.init_timeout_s)
            try:
                tag, meta, _bufs = proto.recv_msg(parent)
            except socket.timeout:
                _kill(proc, parent)
                raise DeviceUnavailable(
                    f"init watchdog: runner init exceeded "
                    f"{self.init_timeout_s:.0f}s") from None
            except (ConnectionError, OSError) as e:
                _kill(proc, parent)
                raise DeviceUnavailable(
                    f"runner died during init: {e}") from e
            if tag != "ready":
                _kill(proc, parent)
                raise DeviceUnavailable(
                    f"runner init failed: {meta.get('error', tag)}")
            self._proc, self._sock = proc, parent
            self.ready = meta
            self.platform = meta.get("platform")
            self._loaded.clear()
            return meta

    def shutdown(self):
        """Ask the runner to exit, then make sure it has."""
        with self._lock:
            proc, sock = self._proc, self._sock
            self._proc = self._sock = None
            self._loaded.clear()
        if proc is None:
            return
        try:
            sock.settimeout(5.0)
            proto.send_msg(sock, "shutdown", {"seq": 0})
            proto.recv_msg(sock)
        except (OSError, ConnectionError):
            pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        _kill(proc, sock)

    def runner_pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    # -- dispatch ------------------------------------------------------------

    def call(self, op: str, meta: dict, bufs=(),
             timeout_s: Optional[float] = None):
        """One dispatch -> (tag, meta, bufs). Raises DeviceUnavailable
        (no runner, runner died, or the timeout elapsed: the runner is
        killed), DeviceOutOfMemory (budget refusal) or DeviceOpError
        (the runner rejected this op)."""
        timeout = self.dispatch_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            sock = self._sock
            if sock is None:
                raise DeviceUnavailable("no runner (call start() first)")
            self._seq += 1
            meta = dict(meta)
            meta["seq"] = self._seq
            try:
                sock.settimeout(timeout)
                proto.send_msg(sock, op, meta, bufs)
                tag, rmeta, rbufs = proto.recv_msg(sock)
            except socket.timeout:
                self._lose(f"dispatch timeout: {op} exceeded {timeout}s")
                raise DeviceUnavailable(f"dispatch timed out ({op})") \
                    from None
            except (ConnectionError, OSError) as e:
                self._lose(f"runner died: {e}")
                raise DeviceUnavailable(f"runner died: {e}") from e
        if tag == "err":
            if rmeta.get("oom"):
                raise DeviceOutOfMemory(rmeta.get("error", "over budget"))
            raise DeviceOpError(rmeta.get("error", "device op failed"))
        return tag, rmeta, rbufs

    def _lose(self, reason: str):
        # caller holds the lock: kill the runner, forget what it held
        proc, sock = self._proc, self._sock
        self._proc = self._sock = None
        self._loaded.clear()
        self.last_error = reason
        _kill(proc, sock)

    def ensure_loaded(self, key: str, tag, loader):
        """Ship a block cache unless (key, tag) is already resident on
        the current runner. `loader() -> (op, meta, bufs)` builds the
        payload only when a ship is needed."""
        tag = list(tag)
        if self._loaded.get(key) == tag:
            return
        op, meta, bufs = loader()
        meta = dict(meta)
        meta["key"] = key
        meta["tag"] = tag
        if op == "vec_load" and bufs[0].nbytes > self.LOAD_PART_BYTES:
            self._multipart_vec_load(key, tag, meta, bufs[0], bufs[1])
        elif (op == "ann_load"
                and sum(b.nbytes for b in bufs) > self.LOAD_PART_BYTES):
            self._multipart_ann_load(key, tag, meta, bufs)
        else:
            self.call(op, meta, bufs, timeout_s=self.load_timeout_s)
        self._loaded[key] = tag

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
            if t == "stale":
                raise DeviceUnavailable("runner lost mid-load")
        t, _m, _b = self.call("vec_load_end", {"key": key, "tag": tag},
                              timeout_s=self.load_timeout_s)
        if t == "stale":
            raise DeviceUnavailable("runner lost mid-load")

    def _multipart_ann_load(self, key, tag, meta, bufs):
        """Chunked ship of a quantized ANN index: begin carries the
        small per-row arrays + shapes, the graph and the int8 rows
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
                if t == "stale":
                    raise DeviceUnavailable("runner lost mid-load")
        t, _m, _b = self.call("ann_load_end", {"key": key, "tag": tag},
                              timeout_s=self.load_timeout_s)
        if t == "stale":
            raise DeviceUnavailable("runner lost mid-load")

    def forget(self, key: str):
        self._loaded.pop(key, None)


def _kill(proc, sock):
    if sock is not None:
        try:
            sock.close()
        except OSError:
            pass
    if proc is None:
        return
    try:
        proc.kill()
    except OSError:
        pass
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass
