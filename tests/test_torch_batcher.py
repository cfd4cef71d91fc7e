"""The port's cross-query batcher (`surrealdb_tpu_torch/device/batcher.py`)
against the reference's (`surrealdb_tpu/device/batcher.py`): the cases
of tests/test_batcher.py that hold the batcher itself (coalescing with
answers equal to the sequential ones, the pipeline gate, withdrawal on
a deadline and on a cancel, per-rider errors through the degrade
ladder, the batched host fallback, stats), and the supervisor's
`status()["batching"]` and `device_batch_*` gauges.

The serving stack is the reference's: its `inflight` registry is bound
to the port through `bind_serving(remaining=, cancelled=, current=)`,
so a parked rider is woken through the reference's `CancelEvent` waker.
The port raises its own `QueryTimeout` / `QueryCancelled`, mapped here
to the reference's classes with the same messages.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from surrealdb_tpu import err as ref_err
from surrealdb_tpu import inflight
from surrealdb_tpu.device import batcher as ref_batcher
from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device import batcher as port_batcher
from surrealdb_tpu_torch.device import supervisor as S
from surrealdb_tpu_torch.device.batcher import BatchStats, DeviceBatcher
from surrealdb_tpu_torch.ops.topk import knn_search


def _ref_exc(e):
    """The reference's class for a port query error (same message)."""
    if isinstance(e, S.QueryTimeout):
        return ref_err.QueryTimeout(str(e))
    if isinstance(e, S.QueryCancelled):
        return ref_err.QueryCancelled(str(e))
    return e


@pytest.fixture()
def serving():
    """The reference's in-flight registry bound to the port's seam."""
    S.bind_serving(remaining=inflight.remaining,
                   cancelled=inflight.cancelled, current=inflight.current)
    reg = inflight.InflightRegistry()
    try:
        yield reg
    finally:
        S.bind_serving()


def _gated(dispatch):
    """`dispatch` whose first call blocks until `gate` is set."""
    gate = threading.Event()
    first = threading.Event()

    def run(payloads):
        if not first.is_set():
            first.set()
            assert gate.wait(10)
        return dispatch(payloads)

    return run, gate, first


def _pile_up(b, payloads, first, gate, out):
    """Submit payloads[0], wait until its dispatch blocks, pile the
    rest up behind it, open the gate; out[i] gets each answer."""
    def go(i):
        out[i] = b.submit(payloads[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(payloads))]
    threads[0].start()
    assert first.wait(10)
    for t in threads[1:]:
        t.start()
    time.sleep(0.2)  # the riders enqueue behind the gated dispatch
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


# -- coalescing ------------------------------------------------------------------

def test_batch_grows_with_concurrency_and_answers_equal_sequential(
        monkeypatch):
    """64 single-query KNN riders on the port's kernels (the plain
    versions here) coalesce behind a gated dispatch, and each answer is
    byte-identical to the query run alone (manhattan: every distance is
    its own row's sum, whatever the batch)."""
    monkeypatch.setattr(cnf, "DEVICE_BATCH_PIPELINE", 1)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32))
    qs = rng.normal(size=(64, 32)).astype(np.float32)

    def knn(batch):
        d, i = knn_search(xs, torch.from_numpy(np.stack(batch)), 10,
                          "manhattan")
        return list(zip(d.numpy(), i.numpy()))

    sequential = [knn([q])[0] for q in qs]
    sizes = []

    def spy(payloads):
        sizes.append(len(payloads))
        return knn(payloads)

    run, gate, first = _gated(spy)
    b = DeviceBatcher(dispatch=run, stats=BatchStats())
    out = {}
    _pile_up(b, list(qs), first, gate, out)
    assert max(sizes) >= 32, f"riders did not coalesce: {sizes}"
    assert sum(sizes) == 64 and b.stats.dispatches == len(sizes)
    for i in range(64):
        assert np.array_equal(out[i][1], sequential[i][1])
        assert out[i][0].tobytes() == sequential[i][0].tobytes()


def test_same_dispatches_and_stats_as_the_reference(monkeypatch):
    """The same gated pile-up through both batchers: the same batch
    sizes, answers and stats."""
    monkeypatch.setattr(cnf, "DEVICE_BATCH_PIPELINE", 1)
    from surrealdb_tpu import cnf as ref_cnf

    monkeypatch.setattr(ref_cnf, "DEVICE_BATCH_PIPELINE", 1)
    seen = {}
    for name, mod in (("port", port_batcher), ("ref", ref_batcher)):
        sizes = []

        def double(payloads, sizes=sizes):
            sizes.append(len(payloads))
            return [p * 2 for p in payloads]

        run, gate, first = _gated(double)
        b = mod.DeviceBatcher(dispatch=run, stats=mod.BatchStats())
        out = {}
        _pile_up(b, list(range(12)), first, gate, out)
        b.submit(100)
        seen[name] = (sizes, out, b.stats.to_dict())
    assert seen["port"][0] == seen["ref"][0] == [1, 11, 1]
    assert seen["port"][1] == seen["ref"][1] == {i: 2 * i
                                                 for i in range(12)}
    assert seen["port"][2] == seen["ref"][2]


# -- pipelined dispatch ----------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 1])
def test_pipelined_second_dispatch_overlaps(monkeypatch, depth):
    """With pipeline depth 2, a second batch launches while the first is
    still inside its kernel once PIPELINE_MIN riders are queued; with
    depth 1 it waits for the first."""
    monkeypatch.setattr(cnf, "DEVICE_BATCH_PIPELINE", depth)
    monkeypatch.setattr(cnf, "DEVICE_BATCH_PIPELINE_MIN", 4)
    gate = threading.Event()
    in_flight = []
    overlap = threading.Event()

    def dispatch(payloads):
        in_flight.append(len(payloads))
        if len(in_flight) == 1:
            assert gate.wait(10)
        else:
            overlap.set()
        return list(payloads)

    b = DeviceBatcher(dispatch=dispatch, stats=BatchStats())
    ts = [threading.Thread(target=b.submit, args=(i,), daemon=True)
          for i in range(8)]
    ts[0].start()
    deadline = time.monotonic() + 5
    while not in_flight and time.monotonic() < deadline:
        time.sleep(0.002)
    for t in ts[1:]:
        t.start()
    try:
        if depth == 2:
            assert overlap.wait(5), "second dispatch never overlapped"
            assert b.stats.max >= 4  # launched at the gate, not before
        else:
            assert not overlap.wait(0.5), "depth 1 launched a second batch"
            with b.cond:
                assert len(b.queue) == 7 and b.inflight == 1
    finally:
        gate.set()
        for t in ts:
            t.join(timeout=5)
    assert b.stats.riders == 8


# -- withdrawal ----------------------------------------------------------------

def _parked_rider(b, handle, payload, errors):
    def rider():
        with inflight.activate(handle):
            try:
                b.submit(payload)
            except (S.QueryTimeout, S.QueryCancelled) as e:
                errors["e"] = e

    t = threading.Thread(target=rider, daemon=True)
    t.start()
    return t


def test_expired_rider_withdraws_from_queued_batch(serving):
    """A rider whose budget expires while parked behind an in-flight
    dispatch raises QueryTimeout promptly and withdraws its entry."""
    gate = threading.Event()
    started = threading.Event()

    def dispatch(payloads):
        started.set()
        assert gate.wait(10)
        return [p * 2 for p in payloads]

    b = DeviceBatcher(dispatch=dispatch, stats=BatchStats())
    res = {}
    t1 = threading.Thread(target=lambda: res.setdefault("a", b.submit(1)),
                          daemon=True)
    t1.start()
    assert started.wait(5)
    h = serving.open("t", "t", "knn", deadline=time.monotonic() + 0.15)
    err = {}
    t0 = time.monotonic()
    t2 = _parked_rider(b, h, 2, err)
    t2.join(timeout=3)
    try:
        assert not t2.is_alive(), "expired rider still parked"
        assert isinstance(err.get("e"), S.QueryTimeout)
        assert time.monotonic() - t0 < 1.0
        assert h.timed_out
        mapped = _ref_exc(err["e"])
        assert isinstance(mapped, ref_err.QueryTimeout)
        assert str(mapped) == ("The query was not executed because it "
                               "exceeded the timeout")
        with b.cond:
            assert not b.queue, "timed-out rider left its queue entry"
    finally:
        gate.set()
        t1.join(timeout=5)
        serving.close(h)
    assert res["a"] == 2


def test_cancelled_rider_is_woken_and_withdraws(serving):
    """A parked rider with no deadline is woken through the handle's
    cancel waker (no polling) when its query is cancelled: it raises
    QueryCancelled, marks the handle and leaves the queue."""
    gate = threading.Event()
    started = threading.Event()

    def dispatch(payloads):
        started.set()
        assert gate.wait(10)
        return list(payloads)

    b = DeviceBatcher(dispatch=dispatch, stats=BatchStats())
    t1 = threading.Thread(target=b.submit, args=("a",), daemon=True)
    t1.start()
    assert started.wait(5)
    h = serving.open("t", "t", "knn")
    err = {}
    t2 = _parked_rider(b, h, "b", err)
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with b.cond:
                if b.queue:
                    break
            time.sleep(0.002)
        assert h.cancel._wakers, "the rider registered no waker"
        t0 = time.monotonic()
        h.cancel.set()
        t2.join(timeout=3)
        assert not t2.is_alive(), "cancelled rider still parked"
        assert time.monotonic() - t0 < 1.0
        assert isinstance(err.get("e"), S.QueryCancelled)
        assert h.cancelled and not h.cancel._wakers
        mapped = _ref_exc(err["e"])
        assert isinstance(mapped, ref_err.QueryCancelled)
        assert str(mapped) == "The query was cancelled"
        with b.cond:
            assert not b.queue
    finally:
        gate.set()
        t1.join(timeout=5)
        serving.close(h)


# -- per-rider errors ------------------------------------------------------------

def test_per_rider_isolation_through_degrade_ladder():
    """The batch kernel fails retryably and the batched fallback fails
    too: every rider is answered on its own; the poisoned rider gets its
    own error, its batchmates succeed."""

    class Boom(Exception):
        pass

    def dispatch(payloads):
        raise Boom("device down")

    def fallback_batch(payloads):
        raise RuntimeError("host batch kernel exploded")

    def fallback_one(p):
        if p == "poison":
            raise ValueError("bad rider")
        return f"ok-{p}"

    run, gate, first = _gated(dispatch)
    b = DeviceBatcher(dispatch=run, fallback_batch=fallback_batch,
                      fallback=fallback_one, retryable=(Boom,),
                      stats=BatchStats())
    results, errors = {}, {}

    def go(p):
        try:
            results[p] = b.submit(p)
        except Exception as e:
            errors[p] = e

    ts = [threading.Thread(target=go, args=(p,))
          for p in ("a", "poison", "b", "c")]
    ts[0].start()
    assert first.wait(5)
    for t in ts[1:]:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in ts:
        t.join(timeout=5)
    assert results == {"a": "ok-a", "b": "ok-b", "c": "ok-c"}
    assert isinstance(errors["poison"], ValueError)
    assert b.stats.dispatches == 2  # "a" alone, then the other three


def test_non_retryable_failure_goes_to_every_rider():
    class Oom(Exception):
        pass

    def dispatch(payloads):
        raise Oom("out of memory")

    b = DeviceBatcher(dispatch=dispatch, fallback=lambda p: p,
                      retryable=(KeyError,), stats=BatchStats())
    with pytest.raises(Oom):
        b.submit(1)


def test_batched_host_fallback_serves_whole_batch():
    class Down(Exception):
        pass

    calls = []

    def dispatch(payloads):
        raise Down()

    def fallback_batch(payloads):
        calls.append(len(payloads))
        return [p + 100 for p in payloads]

    b = DeviceBatcher(dispatch=dispatch, fallback_batch=fallback_batch,
                      retryable=(Down,), stats=BatchStats())
    assert b.submit(1) == 101
    assert calls == [1]


# -- stats and the supervisor's view of them ---------------------------------

def test_batch_stats_recorded():
    stats = BatchStats()
    b = DeviceBatcher(dispatch=lambda ps: list(ps), stats=stats)
    b.submit(1)
    b.submit(2)
    d = stats.to_dict()
    assert d == {"dispatches": 2, "riders": 2, "last": 1, "avg": 1.0,
                 "max": 1}
    ref = ref_batcher.BatchStats()
    for size in (3, 1, 7, 2):
        ref.record(size)
        stats.record(size)
    assert stats.to_dict() == dict(ref.to_dict(), dispatches=6, riders=15,
                                   avg=2.5)


class _Gauges:
    def __init__(self):
        self.fns = {}

    def register_gauge(self, name, fn):
        self.fns[name] = fn


def test_supervisor_status_and_gauges_report_batching():
    sup = S.DeviceSupervisor(mode="off")
    old = S.set_supervisor(sup)
    try:
        b = DeviceBatcher(dispatch=lambda ps: list(ps))  # BATCH_STATS
        b.submit("x")
        st = port_batcher.BATCH_STATS
        assert sup.status()["batching"] == st.to_dict()
        assert st.last == 1 and st.dispatches >= 1
        tel = _Gauges()
        S.attach_telemetry(tel)
        want = {"device_batch_size_last": st.last,
                "device_batch_size_max": st.max,
                "device_batch_size_avg": round(
                    st.riders / max(st.dispatches, 1), 2),
                "device_batch_dispatches": st.dispatches}
        assert {k: tel.fns[k]() for k in want} == want
        from surrealdb_tpu.device import supervisor as refsup

        ref_tel = _Gauges()
        refsup.attach_telemetry(ref_tel)
        assert set(tel.fns) == set(ref_tel.fns)
        assert set(sup.status()) == set(
            refsup.DeviceSupervisor(mode="off").status())
    finally:
        S.set_supervisor(old)
        sup.shutdown()
