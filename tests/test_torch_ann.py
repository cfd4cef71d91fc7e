"""The port's graph-ANN path against the JAX package on the same inputs:
its copy of the CAGRA builder (byte-equal arrays), the descent
(`AnnStore.search` ids and the scored variant's int8 scores), and the
`ann_*` ops through the DeviceHost, a runner subprocess and the
supervisor's multipart ship.

On the CPU the port runs its plain PyTorch versions (the probe's
`rank_scores_int8_plain` + stable selection, `ann_descent_plain`).
Ids must be equal wherever the reference's descent scores separate
neighbours by more than rtol=1e-5; the scores agree within rtol=1e-5
(the reference's XLA product and dequantisation may differ from an
IEEE round of each operation by an ulp at some batch shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surrealdb_tpu.device import handlers as ref_handlers
from surrealdb_tpu.device.annstore import AnnStore as RefAnnStore
from surrealdb_tpu.device.annstore import _descent_jit
from surrealdb_tpu.graph.csr import pack_csr as ref_pack_csr
from surrealdb_tpu.idx import cagra as rcagra
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device.annstore import AnnStore as PortAnnStore
from surrealdb_tpu_torch.device.supervisor import DeviceSupervisor
from surrealdb_tpu_torch.idx import cagra as pcagra

from test_torch_device import _same, both

METRICS = ["euclidean", "cosine", "dot"]
RTOL = 1e-5
CFG = {"width": 64, "iters": 24, "expand": 2}


def _clustered(n=5000, d=64, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(n // 100, 2), d)).astype(np.float32)
    xs = centers[rng.integers(0, len(centers), n)]
    xs += 0.15 * rng.normal(size=(n, d)).astype(np.float32)
    return xs, rng


_BUILT: dict = {}


def _built(metric):
    """The reference's build of the 5k x 64 clustered store (cached per
    metric for the module)."""
    if metric not in _BUILT:
        xs, _ = _clustered()
        _BUILT[metric] = (xs, rcagra.build_index(xs, metric, 0, 0))
    return _BUILT[metric]


def assert_ids_match(ref_d, ref_i, got_i):
    ref_d = np.asarray(ref_d, np.float64)
    tol = RTOL * np.maximum(np.abs(ref_d), 1e-30)
    gap = np.abs(np.diff(ref_d, axis=1))
    for r in range(ref_d.shape[0]):
        for j in range(ref_d.shape[1]):
            lo = j == 0 or gap[r, j - 1] > tol[r, j]
            hi = j + 1 >= ref_d.shape[1] or gap[r, j] > tol[r, j]
            if lo and hi:
                assert got_i[r, j] == ref_i[r, j], (r, j)


@pytest.mark.parametrize("metric", METRICS)
def test_cagra_copy_is_byte_equal(metric):
    xs, ann = _built(metric)
    x2, norms = pcagra.row_stats(xs)
    rx2, rnorms = rcagra.row_stats(xs)
    np.testing.assert_array_equal(x2, rx2)
    np.testing.assert_array_equal(norms, rnorms)
    graph = pcagra.build_graph(xs, metric, x2=x2, norms=norms)
    assert graph.dtype == np.int32 and graph.shape == (5000, 32)
    np.testing.assert_array_equal(graph, ann.graph)
    x8, arow = pcagra.quantize_int8(xs, metric, norms=norms)
    np.testing.assert_array_equal(x8, ann.x8)
    np.testing.assert_array_equal(arow, ann.arow)
    for clip_q in (1.0, 0.9):
        a = pcagra.quantize_int8(xs[:300], metric, clip_q=clip_q)
        b = rcagra.quantize_int8(xs[:300], metric, clip_q=clip_q)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_cagra_builder_knobs_and_probe_are_byte_equal():
    xs, _ = _clustered(n=1500, d=24, seed=9)
    for kw in ({"d_out": 8, "leaf": 64, "trees": 1, "refine": 2},
               {"d_out": 16, "refine": 0, "seed": 3}):
        np.testing.assert_array_equal(
            pcagra.build_graph(xs, "euclidean", **kw),
            rcagra.build_graph(xs, "euclidean", **kw))
    for n, w in ((10, 64), (5000, 64), (250_000, 64), (10_000_000, 128)):
        assert pcagra.probe_count(n, w) == rcagra.probe_count(n, w)
        p = pcagra.probe_count(n, w)
        np.testing.assert_array_equal(pcagra.entry_ids(n, p),
                                      rcagra.entry_ids(n, p))
    rows = np.array([3, 1, 3, 0, 1, 3], np.int64)
    cols = np.arange(6, dtype=np.int64)
    for a, b in zip(pcagra.pack_csr(rows, cols, 5),
                    ref_pack_csr(rows, cols, 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("metric", METRICS)
def test_ann_search_matches_reference(metric, b):
    xs, ann = _built(metric)
    ref = RefAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, metric, CFG)
    port = PortAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, metric,
                        CFG, "cpu")
    rng = np.random.default_rng(100 + b)
    qs = xs[rng.integers(0, len(xs), b)] + 0.075 * rng.normal(
        size=(b, xs.shape[1])).astype(np.float32)
    kc = 40
    ref_ids = ref.search(qs, kc)
    got_ids, got_d = port.search_scored(qs, kc)
    assert got_ids.shape == (b, kc) and got_ids.dtype == np.int32
    np.testing.assert_array_equal(port.search(qs, kc), got_ids)
    bucket = 1 << (b - 1).bit_length()
    qsb = np.concatenate([qs, np.zeros((bucket - b, qs.shape[1]),
                                       np.float32)])
    rid, rd = _descent_jit(ref._ensure() + (jnp.asarray(qsb),),
                           (metric, 64, 24, 2, kc), scored=True)
    rid, rd = np.asarray(rid)[:b], np.asarray(rd)[:b]
    np.testing.assert_array_equal(rid, ref_ids)
    np.testing.assert_allclose(got_d, rd, rtol=RTOL, atol=0)
    assert_ids_match(rd, ref_ids, got_ids)
    assert all(len(set(r)) == kc for r in got_ids.tolist())


def test_ann_search_clamps_like_the_reference():
    """kc above the width widens the frontier; width is capped by the
    probe; an all-zero (padding) query yields no NaN."""
    xs, ann = _built("cosine")
    cfg = {"width": 16, "iters": 3, "expand": 4}
    ref = RefAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, "cosine",
                      cfg)
    port = PortAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, "cosine",
                        cfg, "cpu")
    qs = np.concatenate([xs[:2], np.zeros((1, xs.shape[1]), np.float32)])
    for kc in (5, 70):
        r = ref.search(qs, kc)
        g, d = port.search_scored(qs, kc)
        assert g.shape == r.shape == (3, kc)
        assert np.isfinite(d).all()
        np.testing.assert_array_equal(g[2], r[2])  # all-tie row: by position
    assert port.device_nbytes() == ref.device_nbytes()
    assert (PortAnnStore.estimate_device_bytes(5000, 64, 32)
            == RefAnnStore.estimate_device_bytes(5000, 64, 32))


def test_ann_search_odd_width_pads_with_zero_columns():
    """A 37-wide store: the port's device rows are padded to 48 zero
    columns (the kernels' 16-byte rows); the ids are the reference's."""
    xs, rng = _clustered(n=1200, d=37, seed=13)
    ann = rcagra.build_index(xs, "euclidean", 0, 0)
    ref = RefAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, "euclidean",
                      CFG)
    port = PortAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2,
                        "euclidean", CFG, "cpu")
    qs = xs[:3] + 0.05 * rng.normal(size=(3, 37)).astype(np.float32)
    assert port._ensure()["x8"].shape == (1200, 48)
    rid, rd = _descent_jit(ref._ensure() + (jnp.asarray(np.concatenate(
        [qs, np.zeros((1, 37), np.float32)])),), ("euclidean", 64, 24, 2,
                                                  40), scored=True)
    got_ids, got_d = port.search_scored(qs, 40)
    np.testing.assert_allclose(got_d, np.asarray(rd)[:3], rtol=RTOL, atol=0)
    assert_ids_match(np.asarray(rd)[:3], np.asarray(rid)[:3], got_ids)


@pytest.mark.parametrize("metric", METRICS)
def test_ann_search_wide_rows_match_reference(metric):
    """3072-wide rows, past the 2048 columns the int8 kernels hold of a
    query tile at once: the probe and the descent give the reference's
    scores and ids."""
    xs, rng = _clustered(n=600, d=3072, seed=21)
    ann = rcagra.build_index(xs, metric, 0, 0)
    ref = RefAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, metric, CFG)
    port = PortAnnStore("k", ann.graph, ann.x8, ann.arow, ann.x2, metric,
                        CFG, "cpu")
    qs = xs[:4] + 0.05 * rng.normal(size=(4, 3072)).astype(np.float32)
    rid, rd = _descent_jit(ref._ensure() + (jnp.asarray(qs),),
                           (metric, 64, 24, 2, 40), scored=True)
    got_ids, got_d = port.search_scored(qs, 40)
    np.testing.assert_array_equal(np.asarray(rid), ref.search(qs, 40))
    np.testing.assert_allclose(got_d, np.asarray(rd), rtol=RTOL, atol=0)
    assert_ids_match(np.asarray(rd), np.asarray(rid), got_ids)


@pytest.fixture()
def hosts(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    return ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu")


def _load_meta(metric, key="ann/k", tag=(1, 0, 0)):
    return {"key": key, "tag": list(tag), "metric": metric, "cfg": CFG}


def test_ann_ops_answer_like_the_reference(hosts):
    xs, ann = _built("euclidean")
    bufs = [ann.graph, ann.x8, ann.arow, ann.x2]
    meta = _load_meta("euclidean")
    _same(*both(hosts, "ann_load", meta, bufs))
    rng = np.random.default_rng(2)
    qs = xs[:5] + 0.05 * rng.normal(size=(5, 64)).astype(np.float32)
    search = {"key": "ann/k", "tag": [1, 0, 0], "kc": 40}
    (rt, rm, rb), (pt, pm, pb) = both(hosts, "ann_search", search, [qs])
    assert rt == pt == "ok" and pm == rm == {"mode": "cand", "mesh_ndev": 1}
    assert pb[0].shape == rb[0].shape == (5, 40)
    assert (pb[0] == rb[0]).mean() >= 0.99
    # a stale tag, prewarm, status, drop
    _same(*both(hosts, "ann_search", dict(search, tag=[2, 0, 0]), [qs]))
    _same(*both(hosts, "ann_prewarm", {"key": "ann/k", "tag": [1, 0, 0],
                                       "buckets": [1, 2], "kc": 40}))
    _same(*both(hosts, "ann_prewarm", {"key": "ann/x", "tag": [1]}))
    (_, rs, _), (_, ps, _) = both(hosts, "status", {})
    for key in ("ann_blocks", "ann_bytes", "mem_used", "vec_blocks"):
        assert ps[key] == rs[key], key
    assert ps["ann_blocks"] == 1
    _same(*both(hosts, "ann_drop", {"key": "ann/k"}))
    _same(*both(hosts, "ann_search", search, [qs]))
    (_, rs, _), (_, ps, _) = both(hosts, "status", {})
    assert ps["ann_blocks"] == rs["ann_blocks"] == 0


def test_ann_multipart_load_and_stale_parts(hosts):
    xs, ann = _built("cosine")
    begin = dict(_load_meta("cosine", key="ann/mp", tag=(4, 1, 1)),
                 d_out=int(ann.graph.shape[1]), dim=int(ann.x8.shape[1]))
    _same(*both(hosts, "ann_load_begin", begin, [ann.arow, ann.x2]))
    (_, rs, _), (_, ps, _) = both(hosts, "status", {})
    assert ps["mem_used"] == rs["mem_used"]
    for name, arr in (("graph", ann.graph), ("x8", ann.x8)):
        for off in range(0, len(arr), 1700):
            _same(*both(hosts, "ann_load_part",
                        {"key": "ann/mp", "buf": name, "off": off},
                        [arr[off:off + 1700]]))
    _same(*both(hosts, "ann_load_end", {"key": "ann/mp", "tag": [4, 1, 1]}))
    qs = xs[10:13]
    search = {"key": "ann/mp", "tag": [4, 1, 1], "kc": 40}
    (rt, _, rb), (pt, _, pb) = both(hosts, "ann_search", search, [qs])
    assert rt == pt == "ok" and (pb[0] == rb[0]).mean() >= 0.99
    _same(*both(hosts, "ann_load_part", {"key": "nope", "buf": "x8",
                                         "off": 0}, [ann.x8[:5]]))
    _same(*both(hosts, "ann_load_end", {"key": "nope", "tag": [1]}))


def test_ann_budget_and_lru(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(ref_handlers, "MAX_ANN_STORES", 2)
    monkeypatch.setattr(port_handlers, "MAX_ANN_STORES", 2)
    hosts = (ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu"))
    xs, ann = _built("dot")
    bufs = [ann.graph, ann.x8, ann.arow, ann.x2]
    for i in range(3):
        _same(*both(hosts, "ann_load",
                    _load_meta("dot", key=f"ann/{i}", tag=(i,)), bufs))
    assert list(hosts[1].ann) == list(hosts[0].ann) == ["ann/1", "ann/2"]
    _same(*both(hosts, "ann_search", {"key": "ann/0", "tag": [0],
                                      "kc": 8}, [xs[:1]]))  # evicted
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")
    small = (ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu"))
    for host in small:
        with pytest.raises(Exception) as ei:
            host.handle("ann_load", _load_meta("dot", key="ann/big"),
                        list(bufs))
        assert type(ei.value).__name__ == "DeviceBudgetError"
    assert small[1].oom_refusals == small[0].oom_refusals == 1


def test_supervisor_ships_ann_in_parts():
    """The runner subprocess (device="cpu") through the supervisor's
    multipart ANN ship answers like the in-process host, and again
    after a drop and a reship."""
    xs, ann = _built("cosine")
    bufs = [ann.graph, ann.x8, ann.arow, ann.x2]
    inline = port_handlers.DeviceHost("cpu")
    inline.handle("ann_load", _load_meta("cosine"), list(bufs))
    qs = xs[20:26]
    search = {"key": "ann/k", "tag": [1, 0, 0], "kc": 40}
    want = inline.handle("ann_search", dict(search), [qs])[2][0]
    sup = DeviceSupervisor(device="cpu", init_timeout_s=120)
    sup.LOAD_PART_BYTES = 100_000  # force the multipart ship
    loader = (lambda: ("ann_load", {"metric": "cosine", "cfg": CFG}, bufs))
    try:
        sup.start()
        sup.ensure_loaded("ann/k", [1, 0, 0], loader)
        t, m, b = sup.call("ann_search", search, [qs])
        assert t == "ok" and m["mode"] == "cand"
        np.testing.assert_array_equal(b[0], want)
        sup.call("ann_drop", {"key": "ann/k"})
        assert sup.call("ann_search", search, [qs])[0] == "stale"
        sup.forget("ann/k")
        sup.ensure_loaded("ann/k", [1, 0, 0], loader)
        np.testing.assert_array_equal(sup.call("ann_search", search,
                                               [qs])[2][0], want)
        _, stat, _ = sup.call("status", {})
        assert stat["ann_blocks"] == 1 and stat["ann_bytes"] > 0
    finally:
        sup.shutdown()

