"""The port's DeviceSupervisor (surrealdb_tpu_torch/device/supervisor.py)
on a runner subprocess with device="cpu": its modes and states,
pipelined dispatch, query budgets, degrade and re-promotion, refusals
and lifecycle; the runner's answer to an op that raises a
BaseException; then the reference's chaos contract
(tests/test_device_chaos.py, its own test bodies and assertions) and
SurrealQL KNN and 3-hop queries through the reference's serving stack
with a port runner subprocess underneath.

Plugging the port under the reference's stack happens here only:
`MappedSupervisor` re-raises the port's exceptions as the reference's
classes (the callers' `except` clauses and the batcher's `retryable=`
name those) and `DeviceRequired` as the reference's `SdbError`;
`bind_serving` takes the reference's query budget, cancellation and
stage timer.
"""

import os
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest

import test_device_chaos as chaos
import test_torch_sql as tsql
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.err import SdbError
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device import proto, runner
from surrealdb_tpu_torch.device import supervisor as S
from test_device_chaos import chaos_ds  # noqa: F401  (fixture)
from test_torch_sql import port_and_ref  # noqa: F401  (fixture)

CFG = {"hbm_budget": 12 << 30, "score_budget": 1 << 29, "query_chunk": 512,
       "int8_oversample": 128, "block_rows": 262144}
META = {"metric": "euclidean", "cfg": CFG}
KEY = "vec/s"
RUNNER = b"surrealdb_tpu_torch.device.runner"


# -- the port under the reference's serving stack ------------------------------

_PORT_ERRORS = (S.DeviceUnavailable, S.DeviceOpError, S.DeviceRequired)


def _ref_exc(e):
    """The reference's class for a port exception."""
    if isinstance(e, S.DeviceRequired):
        return SdbError(str(e))
    if isinstance(e, S.DeviceOutOfMemory):
        return refsup.DeviceOutOfMemory(str(e))
    if isinstance(e, S.DeviceUnavailable):
        return refsup.DeviceUnavailable(str(e))
    if isinstance(e, S.DeviceOpError):
        return refsup.DeviceOpError(str(e))
    return e


class MappedSupervisor(S.DeviceSupervisor):
    """The port's supervisor as the reference's callers catch it."""

    def call(self, op, meta, bufs=(), timeout_s=None):
        try:
            return super().call(op, meta, bufs, timeout_s=timeout_s)
        except _PORT_ERRORS as e:
            raise _ref_exc(e) from e

    def ensure_loaded(self, key, tag, loader):
        try:
            return super().ensure_loaded(key, tag, loader)
        except _PORT_ERRORS as e:
            raise _ref_exc(e) from e

    def unavailable(self, reason):
        return _ref_exc(super().unavailable(reason))


def _bind_reference_serving():
    from surrealdb_tpu import inflight, telemetry

    S.bind_serving(remaining=inflight.remaining,
                   cancelled=inflight.cancelled,
                   stage_record=telemetry.stage_record)


@pytest.fixture()
def sub_sup():
    """tests/test_device_chaos.py's fixture, over a port runner."""
    sup = MappedSupervisor(
        mode="auto", dispatch_timeout_s=1.0, load_timeout_s=10.0,
        init_timeout_s=120.0, probe_interval_s=0.2, promote_successes=1,
        device="cpu",
    )
    old = refsup.set_supervisor(sup)
    _bind_reference_serving()
    try:
        yield sup
    finally:
        refsup.set_supervisor(old)
        sup.shutdown()
        S.bind_serving()


# -- helpers -----------------------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread_runners(monkeypatch):
    """Runners spawned here compute on one CPU thread: the suite runs
    files side by side, and the reference's chaos tests time their own
    runner against a 1 s dispatch window."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture()
def unbound():
    """Every test leaves the serving seam at its defaults."""
    S.bind_serving()
    yield
    S.bind_serving()


def _start(**kw):
    kw.setdefault("init_timeout_s", 120.0)
    sup = S.DeviceSupervisor(kw.pop("mode", "auto"), device="cpu", **kw)
    return sup, sup.start()


def _store(n=1200, d=16, seed=3):
    xs = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return xs, np.ones(n, np.uint8)


def _queries(n, d=16, seed=5):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _knn(tag=(1,), k=5):
    return {"key": KEY, "tag": list(tag), "k": k}


def _ship(sup, xs, valid, tag=(1,), loads=None):
    def loader():
        if loads is not None:
            loads.append(tag)
        return "vec_load", META, [xs, valid]

    sup.ensure_loaded(KEY, list(tag), loader)


def _inline_answer(xs, valid, qs, tag=(1,), k=5):
    host = port_handlers.DeviceHost("cpu")
    host.handle("vec_load", dict(META, key=KEY, tag=list(tag)), [xs, valid])
    return host.handle("vec_knn", _knn(tag, k), [qs])[2]


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)


def _live_runners():
    """pids of this process's live (not zombie) runner children."""
    me, out = os.getpid(), set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z" and RUNNER in cmd:
            out.add(int(pid))
    return out


def _wait(cond, timeout):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.02)
    return cond()


# -- the runner's repair -----------------------------------------------------------

def test_runner_answers_err_to_a_base_exception(monkeypatch):
    """An op raising SystemExit gets an `err` reply and the runner serves
    the next frame, as the reference runner does."""
    def boom(self, meta, bufs):
        raise SystemExit("op exits")

    monkeypatch.setattr(port_handlers.DeviceHost, "op_boom", boom,
                        raising=False)
    ours, theirs = socket.socketpair()
    t = threading.Thread(target=runner.serve, args=(theirs, "cpu"),
                         daemon=True)
    t.start()
    try:
        ours.settimeout(60)
        tag, ready, _ = proto.recv_msg(ours)
        assert tag == "ready" and ready["platform"] == "cpu"
        assert set(ready["init_s"]) == {"import", "kernels", "context"}
        proto.send_msg(ours, "boom", {"seq": 1})
        tag, meta, _ = proto.recv_msg(ours)
        assert tag == "err" and meta["seq"] == 1
        assert meta["error"] == "SystemExit: op exits"
        proto.send_msg(ours, "ping", {"seq": 2})
        tag, meta, _ = proto.recv_msg(ours)
        assert (tag, meta["seq"]) == ("ok", 2)
        proto.send_msg(ours, "shutdown", {"seq": 3})
        assert proto.recv_msg(ours)[0] == "ok"
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        ours.close()
        theirs.close()


# -- modes and states --------------------------------------------------------------

def test_off_mode_never_dispatches(unbound):
    sup = S.DeviceSupervisor("off", device="cpu")
    assert sup.state == "off" and not sup.fast_path()
    assert not sup.wait_ready(0.1)
    sup.ensure_started()
    with pytest.raises(S.DeviceUnavailable, match="device disabled"):
        sup.call("ping", {})
    with pytest.raises(S.DeviceUnavailable, match="mode off"):
        sup.start()
    sup.note_fallback()
    assert sup.counters["device_fallbacks"] == 0
    assert sup.status()["state"] == "off" and sup.runner_pid() is None
    sup.shutdown()
    assert sup.state == "off"
    with pytest.raises(ValueError, match="off|auto|require|inline"):
        S.DeviceSupervisor("sometimes")


def test_inline_mode_runs_the_port_host(unbound, monkeypatch):
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")
    sup = S.DeviceSupervisor("inline", device="cpu")
    assert sup.state == "ready" and sup.fast_path()
    stages = []
    S.bind_serving(stage_record=lambda name, ns: stages.append(name))
    xs, valid = _store()
    qs = _queries(4)
    _ship(sup, xs, valid)
    _, meta, bufs = sup.call("vec_knn", _knn(), [qs])
    _same(bufs, _inline_answer(xs, valid, qs))
    assert stages == ["device_rpc", "device_rpc"]
    assert sup.inline_store(KEY) is not None
    st = sup.status()
    assert st["platform"] == "cpu" and st["vec_blocks"] == 1
    assert st["mesh"]["n_devices"] == 1
    assert {"hits", "misses"} <= set(sup.compile_counts_now())
    with pytest.raises(S.DeviceOpError, match="unknown device op"):
        sup.call("no_such_op", {})
    assert sup.counters["device_dispatch_errors"] == 1
    # a refusal under the 1 MiB budget is typed, and cached
    big, bvalid = _store(n=4000, d=64)
    with pytest.raises(S.DeviceOutOfMemory):
        sup.ensure_loaded("vec/big", [1], lambda: (
            "vec_load", META, [big, bvalid]))
    assert sup.counters["device_oom_refusals"] == 1
    with pytest.raises(S.DeviceOutOfMemory, match="cached refusal"):
        sup.ensure_loaded("vec/big", [1], lambda: 1 / 0)
    with pytest.raises(S.DeviceUnavailable, match="no runner in mode"):
        sup.start()


def test_auto_mode_goes_cold_probing_ready(unbound):
    sup = S.DeviceSupervisor("auto", device="cpu", init_timeout_s=120.0)
    try:
        assert sup.state == "cold"
        # the first use kicks the spawn and serves from host meanwhile
        assert not sup.fast_path()
        assert sup.state == "probing"
        with pytest.raises(S.DeviceUnavailable, match="device probing"):
            sup.call("ping", {})
        assert sup.wait_ready(120) and sup.state == "ready"
        assert sup.fast_path()
        assert sup.call("ping", {})[0] == "ok"
        assert sup.ready_meta["platform"] == sup.platform == "cpu"
        assert sup.start() is sup.ready_meta  # started: no second runner
        assert sup.counters["device_spawns"] == 1
        proc = sup._proc
    finally:
        sup.shutdown()
    assert sup.state == "cold" and sup.runner_pid() is None
    assert proc.poll() is not None


def test_require_raises_device_required(unbound):
    sup = S.DeviceSupervisor("require", device="cpu", init_timeout_s=120.0,
                             dispatch_timeout_s=1.0, probe_interval_s=30.0)
    try:
        assert sup.fast_path()  # require routes to the device even cold
        e = sup.unavailable("cache thrash")
        assert isinstance(e, S.DeviceRequired) and str(e) == (
            "device required (SURREAL_DEVICE=require) but unavailable: "
            "cache thrash")
        sup.start()
        with pytest.raises(S.DeviceRequired,
                           match=r"^device op failed \(SURREAL_DEVICE="
                                 r"require\): ValueError"):
            sup.call("no_such_op", {})
        os.kill(sup.runner_pid(), signal.SIGKILL)
        assert _wait(lambda: sup.state == "degraded", 10)
        with pytest.raises(S.DeviceRequired) as got:
            sup.call("ping", {})
        assert str(got.value).startswith(
            "device required (SURREAL_DEVICE=require) but unavailable: "
            "state=degraded, last error: runner died")
    finally:
        sup.shutdown()


def test_failed_start_leaves_no_probe_thread_or_child(unbound):
    """A runner whose init fails: start() raises the cause and leaves
    nothing behind that would respawn runners."""
    before = _live_runners()
    # --mesh-devices 0 is refused by the runner's init on any machine
    sup = S.DeviceSupervisor("auto", device="cpu", mesh_devices=0,
                             init_timeout_s=120.0, probe_interval_s=0.05)
    with pytest.raises(S.DeviceUnavailable,
                       match="runner init failed: ValueError: mesh devices 0"):
        sup.start()
    assert sup.state == "cold"
    assert sup._probe_thread is None and sup._spawn_thread is None
    spawns = sup.counters["device_spawns"]
    time.sleep(0.5)  # ten probe intervals
    assert sup.counters["device_spawns"] == spawns
    assert _wait(lambda: not (_live_runners() - before), 10)


def test_concurrent_calls_get_their_own_replies(unbound):
    """16 threads dispatch at once through the send and receive threads;
    each gets the reply to its own frame."""
    xs, valid = _store()
    qs = _queries(64)
    want = [_inline_answer(xs, valid, qs[i * 4:(i + 1) * 4])
            for i in range(16)]
    sup, _ = _start()
    errors, done = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _ship(sup, xs, valid)

        def client(i):
            try:
                for _ in range(6):
                    _, _, bufs = sup.call("vec_knn", _knn(),
                                          [qs[i * 4:(i + 1) * 4]])
                    _same(bufs, want[i])
                done.append(i)
            except Exception as e:  # noqa: BLE001 — collected, asserted
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert sorted(done) == list(range(16))
        assert sup._pending == {} and sup.state == "ready"
    finally:
        sys.setswitchinterval(switch)
        sup.shutdown()


def test_oom_refusal_cached_until_the_tag_changes(unbound, monkeypatch):
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")  # the runner's
    sup, _ = _start()
    try:
        loads = []
        big, bvalid = _store(n=4000, d=64)
        with pytest.raises(S.DeviceOutOfMemory, match="MiB"):
            _ship(sup, big, bvalid, tag=(1,), loads=loads)
        assert sup.counters["device_oom_refusals"] == 1
        assert sup.state == "ready"  # a refusal is no health event
        with pytest.raises(S.DeviceOutOfMemory, match="cached refusal"):
            _ship(sup, big, bvalid, tag=(1,), loads=loads)
        assert loads == [(1,)] and sup.counters["device_oom_refusals"] == 1
        # a new tag (a rebuilt, smaller store) gets a fresh attempt
        xs, valid = _store(n=200)
        _ship(sup, xs, valid, tag=(2,), loads=loads)
        assert loads == [(1,), (2,)] and KEY not in sup._oom_keys
        qs = _queries(3)
        _same(sup.call("vec_knn", _knn((2,)), [qs])[2],
              _inline_answer(xs, valid, qs, tag=(2,)))
    finally:
        sup.shutdown()


def test_sigkill_degrades_then_promotes_after_a_probe_streak(unbound):
    sup, _ = _start(probe_interval_s=0.1, promote_successes=3)
    pings = []
    live = sup._call_live

    def spy(op, meta, bufs, base, health_check=False):
        out = live(op, meta, bufs, base, health_check=health_check)
        if health_check:
            pings.append(sup.state)
        return out

    sup._call_live = spy
    try:
        xs, valid = _store()
        qs = _queries(4)
        loads = []
        _ship(sup, xs, valid, loads=loads)
        before = sup.call("vec_knn", _knn(), [qs])[2]
        proc = sup._proc
        os.kill(proc.pid, signal.SIGKILL)
        assert _wait(lambda: sup.state == "degraded", 10), sup.status()
        assert sup._loaded == {} and not sup.fast_path()
        with pytest.raises(S.DeviceUnavailable):
            sup.call("vec_knn", _knn(), [qs])
        assert "runner died" in sup.last_error
        assert _wait(lambda: sup.state == "ready", 60), sup.status()
        # promoted only after three healthy probes in a row
        assert len(pings) >= 3 and set(pings) == {"degraded"}
        assert sup.counters["device_restarts"] >= 1
        assert sup._proc.pid != proc.pid
        # the new runner holds nothing: ensure_loaded ships again
        assert sup.call("vec_knn", _knn(), [qs])[0] == "stale"
        _ship(sup, xs, valid, loads=loads)
        assert len(loads) == 2
        _same(sup.call("vec_knn", _knn(), [qs])[2], before)
    finally:
        sup.shutdown()


def test_sigstop_full_window_timeout_kills_the_runner(unbound):
    sup, _ = _start(dispatch_timeout_s=1.0, probe_interval_s=0.1,
                    promote_successes=1)
    try:
        xs, valid = _store()
        qs = _queries(4)
        _ship(sup, xs, valid)
        want = sup.call("vec_knn", _knn(), [qs])[2]
        proc = sup._proc
        os.kill(proc.pid, signal.SIGSTOP)
        t0 = time.monotonic()
        with pytest.raises(S.DeviceUnavailable, match="timed out"):
            sup.call("vec_knn", _knn(), [qs])
        waited = time.monotonic() - t0
        assert 1.0 <= waited < 3.0
        assert sup.counters["device_dispatch_timeouts"] == 1
        assert sup.state == "degraded" and "wedged" in sup.last_error
        assert proc.wait(timeout=10) == -signal.SIGKILL
        assert _wait(lambda: sup.state == "ready", 60), sup.status()
        assert sup.counters["device_restarts"] >= 1
        _ship(sup, xs, valid)
        _same(sup.call("vec_knn", _knn(), [qs])[2], want)
    finally:
        sup.shutdown()


def test_query_budget_orphans_without_degrading(unbound):
    """A wait cut short by the query's budget (or its cancellation)
    orphans that request only: the runner stays, and its late reply is
    dropped by seq."""
    sup, _ = _start(dispatch_timeout_s=30.0)
    pid = sup.runner_pid()
    try:
        xs, valid = _store()
        qs = _queries(4)
        _ship(sup, xs, valid)
        want = sup.call("vec_knn", _knn(), [qs])[2]
        os.kill(pid, signal.SIGSTOP)
        S.bind_serving(remaining=lambda: 0.2)
        t0 = time.monotonic()
        with pytest.raises(S.DeviceUnavailable, match="timed out"):
            sup.call("vec_knn", _knn(), [qs])
        assert time.monotonic() - t0 < 1.0
        assert sup.state == "ready" and sup.runner_pid() == pid
        assert sup.counters["device_dispatch_timeouts"] == 1
        S.bind_serving(remaining=lambda: 0.0)
        with pytest.raises(S.DeviceUnavailable, match="budget exhausted"):
            sup.call("vec_knn", _knn(), [qs])
        S.bind_serving(cancelled=lambda: True)
        t0 = time.monotonic()
        with pytest.raises(S.DeviceUnavailable, match="cancelled"):
            sup.call("vec_knn", _knn(), [qs])
        assert time.monotonic() - t0 < 1.0
        assert sup._pending == {}
        S.bind_serving()
        os.kill(pid, signal.SIGCONT)
        # the two orphans' replies arrive first and find no slot
        _same(sup.call("vec_knn", _knn(), [qs])[2], want)
        assert sup.state == "ready" and sup.counters["device_restarts"] == 0
        assert sup.counters["device_dispatch_timeouts"] == 1
    finally:
        try:
            os.kill(pid, signal.SIGCONT)
        except ProcessLookupError:
            pass
        sup.shutdown()


def test_shutdown_kills_a_runner_mid_init(unbound, tmp_path, monkeypatch):
    # the runner's interpreter sleeps before it imports anything
    (tmp_path / "sitecustomize.py").write_text("import time\n"
                                                "time.sleep(60)\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    sup = S.DeviceSupervisor("auto", device="cpu", init_timeout_s=120.0,
                             probe_interval_s=0.05)
    try:
        sup.ensure_started()
        assert _wait(lambda: sup._spawning is not None, 10)
        proc = sup._spawning[0]
        assert proc.poll() is None and sup.state == "probing"
    finally:
        sup.shutdown()
    assert proc.wait(timeout=10) == -signal.SIGKILL
    assert sup.state == "cold" and sup._spawning is None
    time.sleep(0.3)  # the spawn thread unwinds: no degrade, no probe
    assert sup.state == "cold" and sup._probe_thread is None
    assert sup.counters["device_spawns"] == 1 and sup.runner_pid() is None


def test_shutdown_stops_the_prewarm_ladder(unbound, monkeypatch):
    """A shutdown between two prewarm steps ends the ladder: its next
    call would otherwise spawn a runner nobody shuts down."""
    monkeypatch.setenv("SURREAL_DEVICE_PREWARM_BUCKETS", "1,2,4,8")
    sup, _ = _start()
    call, steps = sup.call, []

    def shut_after_first_step(op, meta, bufs=(), timeout_s=None):
        out = call(op, meta, bufs, timeout_s=timeout_s)
        if op == "vec_prewarm":
            steps.append(meta["buckets"])
            sup.shutdown()
        return out

    sup.call = shut_after_first_step
    try:
        xs, valid = _store()
        _ship(sup, xs, valid)
        assert _wait(lambda: steps, 10)
        time.sleep(0.5)
        assert steps == [[1]]
        assert sup.state == "cold" and sup.counters["device_spawns"] == 1
    finally:
        sup.shutdown()


def test_status_has_the_reference_keys(unbound):
    ref = refsup.DeviceSupervisor(mode="off")
    want_off = set(ref.status()) - {"batching"}
    ref.compile_cache_info, ref.mesh_info = {}, {}
    want = set(ref.status()) - {"batching"}
    assert set(S.DeviceSupervisor("off").status()) == want_off
    sup, ready = _start()
    try:
        xs, valid = _store()
        _ship(sup, xs, valid)
        st = sup.status()
        assert set(st) == want
        assert (st["state"], st["mode"], st["platform"]) == (
            "ready", "auto", "cpu")
        assert st["vec_blocks"] == 1 and st["mesh"] == ready["mesh"]
        assert st["compile_cache_dir"] == ready["compile_cache"]
        assert {"hits", "misses"} <= set(st["compile_cache"])
    finally:
        sup.shutdown()


def test_singleton_and_telemetry(unbound):
    class Hub:
        def __init__(self):
            self.gauges = {}

        def register_gauge(self, name, fn):
            self.gauges[name] = fn

    old = S.set_supervisor(None)
    try:
        first = S.get_supervisor()
        assert S.get_supervisor() is first
        sup = S.DeviceSupervisor("off")
        assert S.set_supervisor(sup) is first
        hub = Hub()
        S.attach_telemetry(hub)
        sup.counters["device_restarts"] = 3
        sup.state = "degraded"
        read = {name: fn() for name, fn in hub.gauges.items()}
        assert read == {
            "device_degraded": 1, "device_restarts": 3,
            "device_dispatch_timeouts": 0, "device_fallbacks": 0,
            "device_host_routed": 0, "device_oom_refusals": 0,
            "device_compile_cache_hits": 0,
            "device_compile_cache_misses": 0,
        }
        S.reset_supervisor()
        assert sup.state == "cold"  # shut down: back to cold
        assert S.get_supervisor() is not sup
    finally:
        S.reset_supervisor()
        S.set_supervisor(old)


# -- the reference's chaos contract over a port runner -----------------------------

def test_sigkill_runner_under_load(sub_sup, chaos_ds):  # noqa: F811
    chaos.test_sigkill_runner_under_load(sub_sup, chaos_ds)


def test_sigstop_wedge_under_load(sub_sup, chaos_ds):  # noqa: F811
    chaos.test_sigstop_wedge_under_load(sub_sup, chaos_ds)


def test_query_budget_bounds_wedged_dispatch(sub_sup, chaos_ds):  # noqa: F811
    chaos.test_query_budget_bounds_wedged_dispatch(sub_sup, chaos_ds)


def test_require_mode_surfaces_device_loss(chaos_ds,  # noqa: F811
                                           monkeypatch):
    def port_require(**kw):
        return MappedSupervisor(device="cpu", **kw)

    monkeypatch.setattr(chaos, "DeviceSupervisor", port_require)
    _bind_reference_serving()
    try:
        chaos.test_require_mode_surfaces_device_loss(chaos_ds)
    finally:
        S.bind_serving()


def test_ann_reship_after_sigkill_midload(sub_sup, chaos_ds,  # noqa: F811
                                          monkeypatch):
    chaos.test_ann_reship_after_sigkill_midload(sub_sup, chaos_ds,
                                                monkeypatch)


# -- SurrealQL through a port runner subprocess ------------------------------------

def test_sql_knn_and_hops_through_a_port_runner(port_and_ref,  # noqa: F811
                                                monkeypatch):
    """`<|10|>` KNN and 3-hop queries through the reference's serving
    stack give the same ids over a port runner subprocess as over the
    reference's own DeviceHost."""
    import surrealdb_tpu.idx.vector as V
    from surrealdb_tpu import Datastore

    monkeypatch.setattr(V, "DEVICE_MIN_ROWS", 32)
    rng = np.random.default_rng(23)
    xs = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(4, 32)).astype(np.float32)
    ds = Datastore("memory")
    ds.query("DEFINE TABLE tbl; DEFINE INDEX ix ON tbl FIELDS emb HNSW "
             "DIMENSION 32 DIST COSINE TYPE F32; DEFINE TABLE person; "
             "DEFINE TABLE knows TYPE RELATION", ns="b", db="b")
    tsql._ingest(ds, "tbl", xs, ix="ix")
    n = 60
    stmts = [f"CREATE person:{i};" for i in range(n)]
    for a in range(n):
        for b in rng.integers(0, n, size=3):
            stmts.append(f"RELATE person:{a}->knows->person:{int(b)};")
    ds.query("".join(stmts), ns="b", db="b")
    knn = "SELECT id FROM tbl WHERE emb <|10|> $q"
    hop3 = ("SELECT ->knows->person->knows->person->knows->person "
            "FROM ONLY person:1")

    def answers():
        return ([tsql._ids(ds.query_one(knn, ns="b", db="b",
                                        vars={"q": q.tolist()}))
                 for q in qs],
                ds.query_one(hop3, ns="b", db="b"),
                tsql._csr_hops(ds, "frontier"), tsql._csr_hops(ds, "union"))

    tsql._use(None)
    want = answers()
    sup = MappedSupervisor("auto", device="cpu", init_timeout_s=120.0)
    refsup.set_supervisor(sup)
    _bind_reference_serving()
    try:
        assert sup.wait_ready(120), sup.status()
        got = answers()
        _, st, _ = sup.call("status", {})
        assert sup.state == "ready"
        assert sup.counters["device_fallbacks"] == 0
    finally:
        sup.shutdown()
        S.bind_serving()
        ds.close()
    assert got == want
    assert all(len(a) == 10 for a in got[0])
    # the runner subprocess held the index and the graph
    assert st["platform"] == "cpu"
    assert st["vec_blocks"] == 1 and st["csr_blocks"] == 1
