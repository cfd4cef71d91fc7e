"""The port's DeviceHost, runner subprocess, supervisor client and state
carry, frame for frame against the reference DeviceHost.

The reference host runs under the suite's 8 virtual JAX devices; like
tests/test_tpu_ops.py's int8 test, `jax.device_count` is patched to 1 so
it takes its single-device (legacy) branches, the ones the port has.
The port's host runs with device="cpu" (its plain PyTorch versions).
Distances are compared within atol=1e-4, rtol=1e-5 (f32 sums in another
order), ids wherever the reference separates neighbours by more.
"""

import jax
import numpy as np
import pytest

from surrealdb_tpu.device import handlers as ref_handlers
from surrealdb_tpu.device.vecstore import VecStore as RefVecStore
from surrealdb_tpu_torch.carry import host_from_snapshot
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device.supervisor import (
    DeviceOpError,
    DeviceSupervisor,
)
from surrealdb_tpu_torch.device.vecstore import VecStore as PortVecStore

from test_torch_ops import assert_knn_match

CFG = {"hbm_budget": 12 << 30, "score_budget": 1 << 29, "query_chunk": 512,
       "int8_oversample": 128, "block_rows": 262144}


@pytest.fixture()
def hosts(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    return ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu")


def _same(ref_reply, port_reply, k=None):
    """Tags equal, meta keys equal, buffers equal (f32 within tolerance,
    a (dists, ids) pair by the KNN rule)."""
    (rt, rm, rb), (pt, pm, pb) = ref_reply, port_reply
    assert pt == rt
    assert sorted(pm) == sorted(rm), (pm, rm)
    for key in rm:
        if key != "cc":
            assert pm[key] == rm[key], key
    assert len(pb) == len(rb)
    for a, b in zip(pb, rb):
        assert a.dtype == b.dtype and a.shape == b.shape
    if k is not None and len(rb) == 2:
        assert_knn_match(rb[0], rb[1], pb[0], pb[1], k)
    else:
        for a, b in zip(pb, rb):
            np.testing.assert_array_equal(a, b)


def both(hosts, op, meta, bufs=()):
    ref, port = hosts
    return (ref.handle(op, dict(meta), list(bufs)),
            port.handle(op, dict(meta), list(bufs)))


def _vecs(n, d, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    valid = (rng.random(n) > 0.05).astype(np.uint8)
    return xs, valid


def test_vec_ops_answer_like_the_reference(hosts):
    rng = np.random.default_rng(1)
    _same(*both(hosts, "ping", {}))
    for i, metric in enumerate(["euclidean", "cosine", "dot", "manhattan",
                                "minkowski"]):
        key, tag = f"vec/{metric}", [3, i]
        xs, valid = _vecs(3000, 16, i)
        meta = {"key": key, "tag": tag, "metric": metric, "mink_p": 2.5,
                "cfg": CFG}
        _same(*both(hosts, "vec_load", meta, [xs, valid]))
        qs = rng.normal(size=(5, 16)).astype(np.float32)
        r, p = both(hosts, "vec_knn", {"key": key, "tag": tag, "k": 10},
                    [qs])
        _same(r, p, k=10)
        # a wrong tag is stale
        _same(*both(hosts, "vec_knn", {"key": key, "tag": [9, 9], "k": 10},
                    [qs]))
    # the blocked exact scan above block_rows
    xs, valid = _vecs(1200, 8, 7)
    cfg = dict(CFG, block_rows=500)
    meta = {"key": "vec/blk", "tag": [1], "metric": "chebyshev",
            "cfg": cfg}
    _same(*both(hosts, "vec_load", meta, [xs, valid]))
    qs = rng.normal(size=(3, 8)).astype(np.float32)
    _same(*both(hosts, "vec_knn", {"key": "vec/blk", "tag": [1], "k": 7},
                [qs]), k=7)
    _same(*both(hosts, "vec_drop", {"key": "vec/blk"}))
    _same(*both(hosts, "vec_knn", {"key": "vec/blk", "tag": [1], "k": 7},
                [qs]))
    _same(*both(hosts, "vec_prewarm", {"key": "vec/cosine", "tag": [3, 1],
                                       "buckets": [1, 4]}))


def test_multipart_load_and_stale_parts(hosts):
    xs, valid = _vecs(2000, 16, 4)
    begin = {"key": "vec/mp", "tag": [2, 0], "metric": "cosine",
             "mink_p": 3.0, "cfg": CFG, "shape": list(xs.shape),
             "dtype": xs.dtype.str}
    _same(*both(hosts, "vec_load_begin", begin, [valid]))
    for off in range(0, 2000, 700):
        _same(*both(hosts, "vec_load_part", {"key": "vec/mp", "off": off},
                    [xs[off:off + 700]]))
    _same(*both(hosts, "vec_load_end", {"key": "vec/mp", "tag": [2, 0]}))
    qs = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)
    _same(*both(hosts, "vec_knn", {"key": "vec/mp", "tag": [2, 0], "k": 5},
                [qs]), k=5)
    _same(*both(hosts, "vec_load_part", {"key": "nope", "off": 0}, [xs]))
    _same(*both(hosts, "vec_load_end", {"key": "nope", "tag": [1]}))


def test_csr_and_brute_ops(hosts):
    rng = np.random.default_rng(2)
    n = 500
    rows = rng.integers(0, n, 4000).astype(np.int32)
    cols = rng.integers(0, n, 4000).astype(np.int32)
    _same(*both(hosts, "csr_load", {"key": "csr/g", "tag": [4],
                                    "n_nodes": n}, [rows, cols]))
    start = np.zeros((3, n), np.uint8)
    start[0, 1] = start[1, 7] = start[2, [3, 4]] = 1
    for hops in (1, 2, 3):
        for union in (False, True):
            _same(*both(hosts, "csr_hop", {"key": "csr/g", "tag": [4],
                                           "hops": hops, "union": union},
                        [start]))
    _same(*both(hosts, "csr_hop", {"key": "csr/g", "tag": [4], "hops": 2,
                                   "union": False}, [start[1]]))
    _same(*both(hosts, "csr_hop", {"key": "csr/g", "tag": [5], "hops": 2,
                                   "union": False}, [start]))
    _same(*both(hosts, "csr_prewarm", {"key": "csr/g", "tag": [4],
                                       "hops": [1, 3]}))
    _same(*both(hosts, "csr_drop", {"key": "csr/g"}))
    for metric in ("cosine", "pearson", "jaccard", "hamming"):
        xs = np.abs(rng.normal(size=(2500, 12)))  # f64 rows, as planners ship
        qs = np.abs(rng.normal(size=(2, 12))).astype(np.float32)
        if metric == "hamming":
            xs, qs = np.round(xs), np.round(qs)
        _same(*both(hosts, "brute_knn", {"k": 10, "metric": metric,
                                         "p": 3.0}, [xs, qs]), k=10)


def test_status_and_lru_eviction(hosts, monkeypatch):
    monkeypatch.setattr(ref_handlers, "MAX_CSR_STORES", 2)
    monkeypatch.setattr(port_handlers, "MAX_CSR_STORES", 2)
    rows = np.arange(10, dtype=np.int32)
    for i in range(3):
        _same(*both(hosts, "csr_load", {"key": f"csr/{i}", "tag": [i],
                                        "n_nodes": 10}, [rows, rows]))
    start = np.ones((1, 10), np.uint8)
    _same(*both(hosts, "csr_hop", {"key": "csr/0", "tag": [0], "hops": 1,
                                   "union": False}, [start]))
    _same(*both(hosts, "csr_hop", {"key": "csr/2", "tag": [2], "hops": 1,
                                   "union": False}, [start]))
    xs, valid = _vecs(700, 8, 3)
    _same(*both(hosts, "vec_load", {"key": "vec/s", "tag": [1],
                                    "metric": "euclidean", "cfg": CFG},
                [xs, valid]))
    (_, rs, _), (_, ps, _) = both(hosts, "status", {})
    assert set(rs) <= set(ps)
    for key in ("vec_blocks", "csr_blocks", "ann_blocks", "vec_bytes",
                "csr_bytes", "mem_used", "mem_used_device0", "mem_budget",
                "oom_refusals", "budget_evictions"):
        assert ps[key] == rs[key], key
    assert ps["platform"] == "cpu"


def test_byte_budget_evicts_then_refuses(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")
    hosts = (ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu"))
    xs, valid = _vecs(20_000, 4, 6)  # exact store, ~340 KB
    for i in range(4):
        _same(*both(hosts, "vec_load", {"key": f"vec/{i}", "tag": [i],
                                        "metric": "manhattan", "cfg": CFG},
                    [xs, valid]))
    assert hosts[1].budget_evictions == hosts[0].budget_evictions > 0
    _same(*both(hosts, "vec_knn", {"key": "vec/0", "tag": [0], "k": 3},
                [xs[:2]]))  # evicted: stale in both
    big, bvalid = _vecs(60_000, 8, 6)
    for host in hosts:
        with pytest.raises(Exception) as ei:
            host.handle("vec_load", {"key": "vec/big", "tag": [1],
                                     "metric": "manhattan", "cfg": CFG},
                        [big, bvalid])
        assert type(ei.value).__name__ == "DeviceBudgetError"
    assert hosts[1].oom_refusals == hosts[0].oom_refusals == 1


@pytest.mark.parametrize("n,dim,metric,budget", [
    (1000, 16, "euclidean", 12 << 30), (1000, 16, "cosine", 1000),
    (5000, 64, "dot", 6 * 5000 * 64), (5000, 64, "dot", 6 * 5000 * 64 - 1),
    (300, 8, "manhattan", 10), (1_000_000, 768, "cosine", 12 << 30),
    (10_000_000, 768, "cosine", 12 << 30),
])
def test_estimate_picks_the_reference_branch(monkeypatch, n, dim, metric,
                                             budget):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    cfg = dict(CFG, hbm_budget=budget)
    assert (PortVecStore.estimate_device_bytes(n, dim, 4, metric, cfg)
            == RefVecStore.estimate_device_bytes(n, dim, 4, metric, cfg))


def test_int8_branch_answers_not_ported(hosts):
    """The int8 branch (once answered `NotPorted`) now answers like the
    reference: the same rank mode and the same candidate reply; an
    unknown ANN store is `stale`, as in the reference."""
    xs, valid = _vecs(2000, 16, 9)
    meta = {"key": "vec/i8", "tag": [1], "metric": "cosine",
            "cfg": dict(CFG, hbm_budget=2000 * 16)}
    (rt, rmeta, _), (pt, pmeta, _) = both(hosts, "vec_load", meta,
                                          [xs, valid])
    assert rt == pt == "ok" and rmeta["rank_mode"] == "int8"
    assert pmeta == rmeta
    qs = np.random.default_rng(9).normal(size=(3, 16)).astype(np.float32)
    _same(*both(hosts, "vec_knn", {"key": "vec/i8", "tag": [1], "k": 4},
                [qs]))
    _same(*both(hosts, "ann_search", {"key": "a", "tag": [1], "kc": 4},
                [xs]))


def test_host_from_snapshot_answers_like_the_reference(hosts):
    ref, _ = hosts
    xs, valid = _vecs(2500, 16, 12)
    ref.handle("vec_load", {"key": "vec/c", "tag": [7, 1], "metric": "dot",
                            "cfg": CFG}, [xs, valid])
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 300, 2000).astype(np.int32)
    cols = rng.integers(0, 300, 2000).astype(np.int32)
    ref.handle("csr_load", {"key": "csr/c", "tag": [2], "n_nodes": 300},
               [rows, cols])
    snap = {
        "vec": {k: {"tag": t, "vecs": st.vecs, "valid": st.valid,
                    "metric": st.metric, "mink_p": st.mink_p,
                    "cfg": st.cfg} for k, (t, st) in ref.vec.items()},
        "csr": {k: {"tag": t, "rows": st.rows, "cols": st.cols,
                    "n_nodes": st.n_nodes} for k, (t, st) in ref.csr.items()},
    }
    port = host_from_snapshot(snap, "cpu")
    pair = (ref, port)
    qs = rng.normal(size=(3, 16)).astype(np.float32)
    _same(*both(pair, "vec_knn", {"key": "vec/c", "tag": [7, 1], "k": 10},
                [qs]), k=10)
    start = np.zeros((2, 300), np.uint8)
    start[0, 5] = start[1, 9] = 1
    _same(*both(pair, "csr_hop", {"key": "csr/c", "tag": [2], "hops": 3,
                                  "union": True}, [start]))


def test_runner_subprocess_answers_like_the_inline_host():
    inline = port_handlers.DeviceHost("cpu")
    sup = DeviceSupervisor("auto", device="cpu", init_timeout_s=120)
    sup.LOAD_PART_BYTES = 20_000  # force a multipart ship
    try:
        ready = sup.start()
        assert ready["platform"] == "cpu"
        # the reference's describe() of a one-device runner
        assert ready["mesh"] == {"mode": "auto", "n_devices": 1,
                                 "mesh_shape": [1], "axis": "mesh"}
        assert ready["device_count"] == 1
        xs, valid = _vecs(1500, 16, 21)
        meta = {"metric": "euclidean", "cfg": CFG}
        sup.ensure_loaded("vec/r", [1, 0],
                          lambda: ("vec_load", meta, [xs, valid]))
        inline.handle("vec_load", dict(meta, key="vec/r", tag=[1, 0]),
                      [xs, valid])
        qs = np.random.default_rng(1).normal(size=(6, 16)).astype(
            np.float32)
        knn = {"key": "vec/r", "tag": [1, 0], "k": 10}
        t, m, b = sup.call("vec_knn", knn, [qs])
        it, im, ib = inline.handle("vec_knn", dict(knn), [qs])
        # an evicted store answers stale; forget + ensure_loaded re-ships
        sup.call("vec_drop", {"key": "vec/r"})
        assert sup.call("vec_knn", knn, [qs])[0] == "stale"
        sup.forget("vec/r")
        sup.ensure_loaded("vec/r", [1, 0],
                          lambda: ("vec_load", meta, [xs, valid]))
        assert sup.call("vec_knn", knn, [qs])[0] == "ok"
        assert t == it == "ok" and m["rank_mode"] == im["rank_mode"]
        np.testing.assert_array_equal(b[1], ib[1])
        np.testing.assert_array_equal(b[0], ib[0])
        rows = np.arange(100, dtype=np.int32)
        cols = (rows * 7 + 3) % 100
        sup.ensure_loaded("csr/r", [1], lambda: (
            "csr_load", {"n_nodes": 100}, [rows, cols]))
        start = np.zeros((2, 100), np.uint8)
        start[0, 0] = start[1, 50] = 1
        _, _, hb = sup.call("csr_hop", {"key": "csr/r", "tag": [1],
                                        "hops": 3, "union": True}, [start])
        want = np.zeros((2, 100), np.uint8)
        for r, s in ((0, 0), (1, 50)):
            for _ in range(3):
                s = (s * 7 + 3) % 100
                want[r, s] = 1
        np.testing.assert_array_equal(hb[0], want)
        _, _, bb = sup.call("brute_knn", {"k": 4, "metric": "manhattan"},
                            [xs, qs])
        _, _, ibb = inline.handle("brute_knn",
                                  {"k": 4, "metric": "manhattan"}, [xs, qs])
        np.testing.assert_array_equal(bb[1], ibb[1])
        assert sup.call("ann_search", {"key": "a", "tag": [1], "kc": 4},
                        [qs])[0] == "stale"
        with pytest.raises(DeviceOpError):
            sup.call("no_such_op", {})
        t, counts, _ = sup.call("launch_counts", {"reset": True})
        assert t == "ok" and set(counts["launches"]) >= {
            "distance_tile", "csr_hop_step"}
        proc = sup._proc
    finally:
        sup.shutdown()
    assert proc.poll() is not None


def test_cuda_is_the_default_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_handlers.DeviceHost()
    sup = DeviceSupervisor("auto", init_timeout_s=120)
    from surrealdb_tpu_torch.device.supervisor import DeviceUnavailable

    with pytest.raises(DeviceUnavailable, match="CUDA is not available"):
        sup.start()


def test_stores_default_to_the_card():
    """A store built without a device lives on the card, as the host and
    the runner do; the CPU is only ever asked for."""
    from surrealdb_tpu_torch.device.annstore import AnnStore
    from surrealdb_tpu_torch.device.csrstore import CsrStore

    xs, valid = _vecs(10, 4, 0)
    idx = np.zeros((10, 2), np.int32)
    stores = (
        PortVecStore("k", xs, valid, "pearson", 3.0, CFG),
        CsrStore("k", idx[:, 0], idx[:, 1], 10),
        AnnStore("k", idx, xs.astype(np.int8), xs[:, 0], xs[:, 0], "cosine",
                 {}),
    )
    for st in stores:
        assert st.device.type == "cuda"
