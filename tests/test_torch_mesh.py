"""The port's mesh execution against the JAX package's on the same
inputs: `MeshVecStore` (exact and int8), `MeshAnnStore`,
`MeshCsrStore`, the legacy `sharded_knn` / `sharded_rank_rescore`, the
placement math, a `DeviceHost` on 4 mesh devices op for op, and the
plain merges against numpy.

The reference runs on the 8 virtual CPU devices tests/conftest.py
forces; the port on `device="cpu"` shard lists, where every kernel
wrapper runs its plain version. Every store is swept over device counts
{1, 2, 4, 8} and an even and a random contiguous split. Tolerances:
manhattan ids equal and distances within rtol=1e-6 (the f32 sum of
|x - q| in another order than XLA's); euclidean/cosine distances within
atol=1e-4, rtol=1e-5 (f32 sums in another order) and ids wherever the
reference separates neighbours by more; int8 candidates equal wherever
their scores are not tied within rtol=1e-6; the partitioned descent
equal to the reference's own oracle `search_seq` within the ulp rule of
tests/test_torch_ann.py; CSR masks bit for bit. The reference's
euclidean byte-identity across splits is not used as an oracle: it is
not byte-stable there (ROADMAP, known failures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.device import handlers as ref_handlers
from surrealdb_tpu.device import mesh as ref_mesh
from surrealdb_tpu.device.annstore import _descent_jit
from surrealdb_tpu.parallel import mesh as ref_pmesh
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device import mesh as port_mesh
from surrealdb_tpu_torch.ops import merge as M
from surrealdb_tpu_torch.ops import topk as ttopk
from surrealdb_tpu_torch.parallel import mesh as port_pmesh

from test_torch_ann import assert_ids_match
from test_torch_int8 import assert_ids_match_except_ties
from test_torch_ops import assert_knn_match

COUNTS = [1, 2, 4, 8]
SPLITS = ["even", "random"]
CPU = torch.device("cpu")
N, DIM, K, NQ = 257, 16, 10, 5
CFG = {"hbm_budget": 1 << 62, "score_budget": 1 << 22, "query_chunk": 64,
       "int8_oversample": 4, "block_rows": 1 << 20}


def _offsets(n, ndev, split, seed=0):
    if split == "even" or ndev == 1:
        return port_mesh.even_splits(n, ndev)
    rng = np.random.default_rng(1000 * ndev + seed)
    cut = np.sort(rng.choice(np.arange(1, n), size=ndev - 1, replace=False))
    return [0] + [int(c) for c in cut] + [n]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, DIM)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[rng.choice(N, 20, replace=False)] = False
    qs = (xs[rng.integers(0, N, NQ)]
          + 0.1 * rng.normal(size=(NQ, DIM))).astype(np.float32)
    return xs, valid, qs, rng


def _cpus(n):
    return [CPU] * n


# -- the mesh stores ----------------------------------------------------------

def _vec_case(metric, ndev, split, cfg):
    xs, valid, qs, _ = _data()
    offs = _offsets(N, ndev, split)
    ref = ref_mesh.MeshVecStore("k", xs, valid, metric, 3.0, cfg, ndev,
                                offs)
    port = port_mesh.MeshVecStore("k", xs, valid, metric, 3.0, cfg, ndev,
                                  offs, devices=_cpus(ndev))
    assert port.device_nbytes() == ref.device_nbytes()
    assert port.rank_mode == ref.rank_mode
    return xs, valid, qs, ref.knn(qs, K), port.knn(qs, K)


def _check_exact(metric, ndev, split):
    _, _, _, (rm, rb), (pm, pb) = _vec_case(metric, ndev, split, CFG)
    assert pm == rm == {"mode": "pairs", "rank_mode": None,
                        "mesh_ndev": ndev}
    assert [b.dtype for b in pb] == [b.dtype for b in rb]
    if metric == "manhattan":
        # ids equal; |x - q| sums differ from XLA's by their f32 order
        np.testing.assert_array_equal(pb[1], rb[1])
        np.testing.assert_allclose(pb[0], rb[0], rtol=1e-6, atol=0)
    else:
        assert_knn_match(rb[0], rb[1], pb[0], pb[1], K)


def _check_int8(metric, ndev, split):
    xs, valid, qs, (rm, rb), (pm, pb) = _vec_case(
        metric, ndev, split, dict(CFG, hbm_budget=0))
    assert pm == rm and pm["mode"] == "cand" and pm["mesh_ndev"] == ndev
    assert pb[0].shape == rb[0].shape and pb[0].dtype == np.int32
    x8, arow, x2 = ttopk.quantize_rows_plain(torch.from_numpy(xs), metric,
                                             ttopk.int8_width(DIM))
    scores = ttopk.rank_int8(x8, torch.from_numpy(qs), metric, arow, x2,
                             torch.from_numpy(valid)).numpy()
    assert_ids_match_except_ties(scores, rb[0], pb[0])


def _ann_arrays(rng):
    xs, _, qs, _ = _data(3)
    x8 = np.clip(np.rint(xs * 32), -127, 127).astype(np.int8)
    arow = np.full(N, 1 / 32.0, np.float32)
    x2q = (xs.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    graph = rng.integers(0, N, size=(N, 8)).astype(np.int32)
    return graph, x8, arow, x2q, qs


def _ref_seq_scored(st, qs, kc):
    """The reference's `search_seq` with its merged scores: the same
    slice-by-slice descent and (dist, position) merge."""
    st._ensure()
    ndev = st.mesh_ndev
    width_l, iters, expand_l, kc_l, kc_out = st._clamps(kc)
    qsb, b = st._bucket(qs)
    graph_l, x8_p, arow_p, x2q_p, x8p, arowp, x2qp, pids, base = st._host
    nloc, plen = st._nloc, st._plen
    d_parts, i_parts = [], []
    for s in range(ndev):
        rows, probe = slice(s * nloc, (s + 1) * nloc), \
            slice(s * plen, (s + 1) * plen)
        args = tuple(jnp.asarray(a) for a in (
            graph_l[rows], x8_p[rows], arow_p[rows], x2q_p[rows],
            x8p[probe], arowp[probe], x2qp[probe], pids[probe], qsb))
        ids_l, dist_l = _descent_jit(
            args, (st.metric, width_l, iters, expand_l, kc_l), scored=True)
        i_parts.append(np.minimum(np.asarray(ids_l).astype(np.int64)
                                  + base[s], st.x8.shape[0] - 1))
        d_parts.append(np.asarray(dist_l))
    dist = np.concatenate(d_parts, axis=1)
    gids = np.concatenate(i_parts, axis=1)
    order = np.argsort(dist, axis=1, kind="stable")[:, :kc_out]
    return (np.take_along_axis(dist, order, axis=1)[:b],
            np.take_along_axis(gids, order, axis=1)[:b].astype(np.int32))


def _check_ann(metric, ndev, split):
    rng = np.random.default_rng(7)
    graph, x8, arow, x2q, qs = _ann_arrays(rng)
    offs = _offsets(N, ndev, split)
    cfg = {"width": 32, "iters": 6, "expand": 2}
    ref = ref_mesh.MeshAnnStore("a", graph, x8, arow, x2q, metric, cfg,
                                ndev, offs)
    port = port_mesh.MeshAnnStore("a", graph, x8, arow, x2q, metric, cfg,
                                  ndev, offs, devices=_cpus(ndev))
    assert port.device_nbytes() == ref.device_nbytes()
    rd, ri = _ref_seq_scored(ref, qs, 16)
    np.testing.assert_array_equal(ri, ref.search_seq(qs, 16))
    got = port.search(qs, 16)
    assert got.shape == ri.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, port.search_seq(qs, 16))
    assert_ids_match(rd, ri, got)
    port._ensure()
    assert port._clamps(16) == ref._clamps(16)


def _check_csr(union, ndev, split):
    rng = np.random.default_rng(11)
    n_nodes, n_edges = 64, 400
    rows = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    cols = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    starts = np.zeros((3, n_nodes), np.uint8)
    starts[np.arange(3), rng.integers(0, n_nodes, 3)] = 1
    offs = _offsets(n_edges, ndev, split)
    ref = ref_mesh.MeshCsrStore("c", rows, cols, n_nodes, ndev, offs)
    port = port_mesh.MeshCsrStore("c", rows, cols, n_nodes, ndev, offs,
                                  devices=_cpus(ndev))
    assert port.device_nbytes() == ref.device_nbytes()
    for hops in (1, 3):
        want = ref.multi_hop(starts, hops, union)
        got = port.multi_hop(starts, hops, union)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.multi_hop(starts[0], 2, union),
                                  ref.multi_hop(starts[0], 2, union))


CASES = {
    "exact_manhattan": lambda d, s: _check_exact("manhattan", d, s),
    "exact_euclidean": lambda d, s: _check_exact("euclidean", d, s),
    "exact_cosine": lambda d, s: _check_exact("cosine", d, s),
    "int8_euclidean": lambda d, s: _check_int8("euclidean", d, s),
    "int8_cosine": lambda d, s: _check_int8("cosine", d, s),
    "ann_euclidean": lambda d, s: _check_ann("euclidean", d, s),
    "ann_dot": lambda d, s: _check_ann("dot", d, s),
    "csr_frontier": lambda d, s: _check_csr(False, d, s),
    "csr_union": lambda d, s: _check_csr(True, d, s),
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ndev", COUNTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_store_matches_reference(case, ndev, split):
    CASES[case](ndev, split)


# -- the legacy self-sharded kernels (parallel/mesh.py) -----------------------

def _legacy_inputs(ndev, metric):
    xs, valid, qs, _ = _data(5)
    mesh = ref_pmesh.default_mesh(jax.devices()[:ndev])
    pm = port_pmesh.default_mesh(_cpus(ndev))
    return xs, valid, qs, mesh, pm


@pytest.mark.parametrize("ndev", COUNTS)
@pytest.mark.parametrize("metric", ["manhattan", "chebyshev"])
def test_sharded_knn_matches_reference(metric, ndev):
    xs, valid, qs, mesh, pm = _legacy_inputs(ndev, metric)
    xs_r, pad = ref_pmesh.shard_rows(mesh, xs)
    rd, ri = ref_pmesh.sharded_knn(mesh, xs_r, qs,
                                   ref_pmesh.shard_vec(mesh, valid, pad),
                                   K, metric, 3.0)
    gd, gi = port_pmesh.sharded_knn(
        pm, port_pmesh.shard_rows(pm, xs), torch.from_numpy(qs),
        port_pmesh.shard_rows(pm, valid), K, metric, 3.0)
    assert_knn_match(np.asarray(rd), np.asarray(ri), gd.numpy(),
                     gi.numpy(), K)


@pytest.mark.parametrize("ndev", COUNTS)
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_sharded_rank_rescore_matches_reference(metric, ndev):
    """The legacy bf16 store's sharded path: the reference's row-padded
    shards against the port's per-device rows; k above the kc of a
    shard exercises the padding columns."""
    xs, valid, qs, mesh, pm = _legacy_inputs(ndev, metric)
    x64 = xs.astype(np.float64)
    x2 = (x64 ** 2).sum(1).astype(np.float32)
    norms = np.maximum(np.linalg.norm(x64, axis=1), 1e-30).astype(
        np.float32)
    rank = xs / norms[:, None] if metric == "cosine" else xs
    sh = lambda a: ref_pmesh.shard_rows(mesh, a)[0]  # noqa: E731
    pad = ref_pmesh.shard_rows(mesh, xs)[1]
    for k, kc in ((K, 26), (40, 64)):
        rd, ri = ref_pmesh.sharded_rank_rescore(
            mesh, sh(jnp.asarray(rank).astype(jnp.bfloat16)), sh(xs), qs, k,
            kc, metric, ref_pmesh.shard_vec(mesh, x2, pad),
            ref_pmesh.shard_vec(mesh, norms, pad, 1.0),
            ref_pmesh.shard_vec(mesh, valid, pad))
        gd, gi = port_pmesh.sharded_rank_rescore(
            pm, port_pmesh.shard_rows(pm, rank, torch.bfloat16),
            port_pmesh.shard_rows(pm, xs), torch.from_numpy(qs), k, kc,
            metric,
            port_pmesh.shard_rows(pm, x2), port_pmesh.shard_rows(pm, norms),
            port_pmesh.shard_rows(pm, valid))
        assert gd.shape == np.asarray(rd).shape
        assert_knn_match(np.asarray(rd), np.asarray(ri), gd.numpy(),
                         gi.numpy(), gd.shape[1])


# -- placement ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "force", "off", "2"])
def test_placement_math_matches_reference(monkeypatch, mode):
    monkeypatch.setenv("SURREAL_DEVICE_MESH", mode)
    for width in (1, 2, 4, 8):
        monkeypatch.setattr(ref_mesh, "mesh_size",
                            lambda w=width: (1 if mode == "off" else
                                             min(w, 2) if mode == "2"
                                             else w))
        assert port_mesh.mesh_size(width) == ref_mesh.mesh_size()
        assert port_mesh.mesh_mode() == ref_mesh.mesh_mode()
        for n in (0, 1, 3, 257, 10_000, 1_000_000):
            for ndev in (1, 2, 3, 4, 8):
                assert port_mesh.even_splits(n, ndev) == \
                    ref_mesh.even_splits(n, ndev)
                for metric in ("cosine", "manhattan"):
                    for cfg in (CFG, dict(CFG, hbm_budget=1 << 20)):
                        assert port_mesh.MeshVecStore.estimate_device_bytes(
                            n, 768, 4, metric, cfg, ndev) == \
                            ref_mesh.MeshVecStore.estimate_device_bytes(
                                n, 768, 4, metric, cfg, ndev)
                assert port_mesh.MeshAnnStore.estimate_device_bytes(
                    n, 768, 32, ndev) == \
                    ref_mesh.MeshAnnStore.estimate_device_bytes(
                        n, 768, 32, ndev)
                assert port_mesh.MeshCsrStore.estimate_device_bytes(
                    n, ndev) == ref_mesh.MeshCsrStore.estimate_device_bytes(
                        n, ndev)
            for budget in (0, 1 << 20, 64 << 20, 1 << 30):
                est = (lambda d, n=n: ref_mesh.MeshVecStore
                       .estimate_device_bytes(n, 768, 4, "cosine", CFG, d))
                assert port_mesh.pick_ndev(
                    est, budget, max(n, 1), n_devices=width) == \
                    ref_mesh.pick_ndev(est, budget, max(n, 1))
        assert port_mesh.describe(width) == {
            "mode": mode, "n_devices": ref_mesh.mesh_size(),
            "mesh_shape": [ref_mesh.mesh_size()], "axis": "mesh"}


def test_device_list():
    assert port_mesh.device_list(None, "cpu") == [CPU]
    assert port_mesh.device_list(4, "cpu") == _cpus(4)
    assert port_mesh.physical_devices(_cpus(4)) == 1
    with pytest.raises(ValueError):
        port_mesh.device_list(M.MAX_PARTS + 1, "cpu")
    for bad in ([0, 3], [0, 5, 4, 6], [0, 2, 7]):
        with pytest.raises(ValueError):
            port_mesh._check_offsets(bad, 6, len(bad) - 1)


# -- a DeviceHost on 4 mesh devices, op for op --------------------------------

@pytest.fixture()
def mesh4(monkeypatch):
    """The reference host sees 4 of the suite's 8 virtual devices; the
    port's host a list of 4 CPU devices."""
    devs = jax.devices()[:4]
    monkeypatch.setattr(jax, "device_count", lambda: 4)
    monkeypatch.setattr(jax, "devices", lambda *a: list(devs))

    def make():
        return (ref_handlers.DeviceHost(),
                port_handlers.DeviceHost("cpu", mesh_devices=4))

    yield make


def test_hosts_place_by_their_own_device_lists(monkeypatch):
    """Two hosts in one process: each places by its own list, whichever
    was made last (a 4-device host made before a 1-device host still
    shards, and the 1-device host still refuses)."""
    monkeypatch.setenv("SURREAL_DEVICE_MESH", "auto")
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")
    wide = port_handlers.DeviceHost("cpu", mesh_devices=4)
    narrow = port_handlers.DeviceHost("cpu", mesh_devices=1)
    xs, valid, meta = port_mesh._budget_store()
    tag, lmeta, _ = wide.handle("vec_load", dict(meta), [xs, valid])
    assert tag == "ok" and lmeta["mesh_ndev"] == 4
    assert wide.handle("status", {}, [])[1]["mesh"]["n_devices"] == 4
    assert narrow.handle("status", {}, [])[1]["mesh"]["n_devices"] == 1
    with pytest.raises(port_handlers.DeviceBudgetError):
        narrow.handle("vec_load", dict(meta), [xs, valid])


def _both(hosts, op, meta, bufs=()):
    ref, port = hosts
    return (ref.handle(op, dict(meta), list(bufs)),
            port.handle(op, dict(meta), list(bufs)))


def _status_same(hosts):
    (_, rs, _), (_, ps, _) = _both(hosts, "status", {})
    for key in ("platform", "device_count", "mesh", "mem_used_device0",
                "mem_used", "vec_blocks", "csr_blocks", "ann_blocks",
                "vec_bytes", "csr_bytes", "ann_bytes", "mem_budget",
                "oom_refusals", "budget_evictions"):
        assert ps[key] == rs[key], key
    return ps


def _drive_host(hosts, expect_ndev):
    """vec (exact, bf16, int8), ANN and CSR ships and queries on both
    hosts; replies compared by the rules of the module docstring."""
    xs, valid, qs, rng = _data(9)
    for metric, cfg, key in (("manhattan", CFG, "vec/m"),
                             ("cosine", CFG, "vec/c"),
                             ("euclidean", dict(CFG, hbm_budget=0),
                              "vec/i8")):
        meta = {"key": key, "tag": [1, 0], "metric": metric,
                "mink_p": 3.0, "cfg": cfg}
        (rt, rm, _), (pt, pm, _) = _both(hosts, "vec_load", meta,
                                         [xs, valid.astype(np.uint8)])
        assert rt == pt == "ok" and pm == rm, (pm, rm)
        assert pm["mesh_ndev"] == expect_ndev.get(key, 1)
        (rt, rm, rb), (pt, pm, pb) = _both(
            hosts, "vec_knn", {"key": key, "tag": [1, 0], "k": K}, [qs])
        assert rt == pt == "ok" and pm == rm, (pm, rm)
        if pm["mode"] == "pairs":
            assert_knn_match(rb[0], rb[1], pb[0], pb[1], K)
        else:
            x8, arow, x2 = ttopk.quantize_rows_plain(
                torch.from_numpy(xs), metric, ttopk.int8_width(DIM))
            scores = ttopk.rank_int8(x8, torch.from_numpy(qs), metric, arow,
                                     x2, torch.from_numpy(valid)).numpy()
            assert_ids_match_except_ties(scores, rb[0], pb[0])
    graph, x8, arow, x2q, aq = _ann_arrays(np.random.default_rng(7))
    ameta = {"key": "ann/k", "tag": [1], "metric": "euclidean",
             "cfg": {"width": 32, "iters": 6, "expand": 2}}
    (rt, rm, _), (pt, pm, _) = _both(hosts, "ann_load", ameta,
                                     [graph, x8, arow, x2q])
    assert rt == pt == "ok" and pm == rm
    assert pm["mesh_ndev"] == expect_ndev.get("ann/k", 1)
    (rt, rm, rb), (pt, pm, pb) = _both(
        hosts, "ann_search", {"key": "ann/k", "tag": [1], "kc": 16}, [aq])
    assert rt == pt == "ok" and pm == rm
    assert pb[0].shape == rb[0].shape
    assert (pb[0] == rb[0]).mean() >= 0.99
    rows = rng.integers(0, 64, 400).astype(np.int32)
    cols = rng.integers(0, 64, 400).astype(np.int32)
    (rt, _, _), (pt, _, _) = _both(hosts, "csr_load",
                                   {"key": "csr/k", "tag": [1],
                                    "n_nodes": 64}, [rows, cols])
    assert rt == pt == "ok"
    start = np.zeros((2, 64), np.uint8)
    start[0, 3] = start[1, 7] = 1
    for union in (False, True):
        (rt, rm, rb), (pt, pm, pb) = _both(
            hosts, "csr_hop", {"key": "csr/k", "tag": [1], "hops": 3,
                               "union": union}, [start])
        assert rt == pt == "ok" and pm == rm
        assert pm["mesh_ndev"] == expect_ndev.get("csr/k", 1)
        np.testing.assert_array_equal(pb[0], rb[0])
    return _status_same(hosts)


def test_device_host_force_places_like_the_reference(mesh4, monkeypatch):
    monkeypatch.setenv("SURREAL_DEVICE_MESH", "force")
    hosts = mesh4()
    st = _drive_host(hosts, {"vec/m": 4, "vec/c": 4, "vec/i8": 4,
                             "ann/k": 4, "csr/k": 4})
    assert st["mesh"] == {"mode": "force", "n_devices": 4,
                          "mesh_shape": [4], "axis": "mesh",
                          "sharded_vec": 3, "sharded_ann": 1,
                          "sharded_csr": 1}
    # the counters are the process's: the widest mesh so far
    assert st["cc"]["sharded"] > 0 and st["cc"]["mesh_ndev"] >= 4
    # a multipart ship carries its placement from begin to end
    xs, valid, qs, _ = _data(13)
    meta = {"key": "vec/mp", "tag": [2], "metric": "cosine",
            "mink_p": 3.0, "cfg": CFG}
    begin = dict(meta, shape=list(xs.shape), dtype=xs.dtype.str)
    (rt, _, _), (pt, _, _) = _both(hosts, "vec_load_begin", begin,
                                   [valid.astype(np.uint8)])
    assert rt == pt == "ok"
    _status_same(hosts)
    for off in range(0, len(xs), 100):
        _both(hosts, "vec_load_part", {"key": "vec/mp", "off": off},
              [xs[off:off + 100]])
    (rt, rm, _), (pt, pm, _) = _both(hosts, "vec_load_end",
                                     {"key": "vec/mp", "tag": [2]})
    assert pm == rm == {"rank_mode": None, "mesh_ndev": 4}
    (_, rm, rb), (_, pm, pb) = _both(
        hosts, "vec_knn", {"key": "vec/mp", "tag": [2], "k": K}, [qs])
    assert pm == rm
    assert_knn_match(rb[0], rb[1], pb[0], pb[1], K)
    _status_same(hosts)


def test_device_host_auto_places_like_the_reference(mesh4, monkeypatch):
    """auto without a budget: every store unsharded (the vec stores
    shard themselves over the device list, as the reference's do)."""
    monkeypatch.setenv("SURREAL_DEVICE_MESH", "auto")
    hosts = mesh4()
    st = _drive_host(hosts, {})
    assert st["mesh"]["mode"] == "auto" and st["mesh"]["sharded_vec"] == 0


def test_device_host_auto_shards_past_the_budget(mesh4, monkeypatch):
    """auto with a 1 MiB per-device budget: the 2.1 MB store serves on
    4 devices in both hosts; four times its rows are refused."""
    monkeypatch.setenv("SURREAL_DEVICE_MESH", "auto")
    monkeypatch.setenv("SURREAL_DEVICE_MEM_BUDGET_MB", "1")
    hosts = mesh4()
    xs, valid, meta = port_mesh._budget_store()
    (rt, rm, _), (pt, pm, _) = _both(hosts, "vec_load", meta, [xs, valid])
    assert rt == pt == "ok" and pm == rm == {"rank_mode": None,
                                             "mesh_ndev": 4}
    qs = xs[:3] + 0.1
    knn = {"key": meta["key"], "tag": meta["tag"], "k": 5}
    (rt, rm, rb), (pt, pm, pb) = _both(hosts, "vec_knn", knn, [qs])
    assert pm == rm and pm["mesh_ndev"] == 4
    assert_knn_match(rb[0], rb[1], pb[0], pb[1], 5)
    _status_same(hosts)
    # past the budget even on the mesh: refused by both
    big = dict(meta, key="budget/big")
    for host in hosts:
        with pytest.raises(Exception) as ei:
            host.handle("vec_load", dict(big),
                        [np.concatenate([xs] * 4), np.ones(4 * len(xs),
                                                            bool)])
        assert type(ei.value).__name__ == "DeviceBudgetError"
    _status_same(hosts)


# -- the plain merges against numpy -------------------------------------------

def _np_merge(dists, ids, bases, w, k_out, id_max):
    d_all, i_all = [], []
    for d, i, base in zip(dists, ids, bases):
        b, ws = d.shape
        d_all.append(np.concatenate([d, np.full((b, w - ws), np.inf,
                                                np.float32)], axis=1))
        loc = np.concatenate([i, np.broadcast_to(np.arange(ws, w),
                                                 (b, w - ws))], axis=1)
        i_all.append(np.minimum(loc.astype(np.int64) + base, id_max))
    d_all = np.concatenate(d_all, axis=1)
    i_all = np.concatenate(i_all, axis=1)
    order = np.argsort(d_all, axis=1, kind="stable")[:, :k_out]
    return (np.take_along_axis(d_all, order, axis=1),
            np.take_along_axis(i_all, order, axis=1).astype(np.int32))


@pytest.mark.parametrize("shape", [
    # (B, widths of the parts, w, k_out): S.w > k_out, S.w < k_out of
    # real entries (padding surfaces), a single part, an empty part
    (4, (10, 10, 10, 10), 10, 10),
    (3, (3, 0, 5), 8, 20),
    (2, (7,), 7, 7),
    (5, (6, 2, 6, 6, 6, 6, 6, 6), 6, 30),
    # k_out far under S.w with ties across the threshold (values on a
    # 0.1 grid), short shards beside full ones, every part of 32 used
    (4, (500, 500, 500, 500), 500, 40),
    (3, (700, 120, 700), 700, 90),
    (2, (64,) * 32, 64, 100),
])
def test_plain_merge_matches_numpy(shape):
    b, widths, w, k_out = shape
    rng = np.random.default_rng(sum(widths))
    dists, ids = [], []
    for ws in widths:
        d = np.round(rng.normal(size=(b, ws)), 1).astype(np.float32)
        d[:, ::3] = np.inf  # masked rows
        if ws and rng.random() < 0.5:
            d = np.sort(d, axis=1)  # sorted and unsorted partials
        dists.append(d)
        ids.append(rng.integers(0, 50, (b, ws)).astype(np.int32))
    bases = [100 * s for s in range(len(widths))]
    id_max = 100 * len(widths) - 7
    want = _np_merge(dists, ids, bases, w, k_out, id_max)
    got = M.merge_partials([torch.from_numpy(d) for d in dists],
                           [torch.from_numpy(i) for i in ids], bases, w,
                           k_out, id_max)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    nc = M.merge_partials_plain([torch.from_numpy(d) for d in dists],
                                [torch.from_numpy(i) for i in ids], bases,
                                w, k_out)  # no clamp
    np.testing.assert_array_equal(
        nc[1].numpy(), _np_merge(dists, ids, bases, w, k_out, 1 << 40)[1])


def test_plain_mask_or_matches_numpy():
    rng = np.random.default_rng(3)
    parts = [(rng.random((3, 1001)) > 0.8).astype(np.uint8)
             for _ in range(4)]
    acc = (rng.random((3, 1001)) > 0.9).astype(np.uint8)
    want = np.bitwise_or.reduce(np.stack(parts), axis=0)
    acc_t = torch.from_numpy(acc.copy())
    got = M.mask_or([torch.from_numpy(p) for p in parts], acc_t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(acc_t.numpy(), acc | want)
    np.testing.assert_array_equal(
        M.mask_or([torch.from_numpy(parts[0])]).numpy(), parts[0])


def test_selfcheck_and_budget_check_on_the_cpu_list():
    """The module's own sweep (device counts 1/2/4/8, even and random
    splits) and its budget placement proof, on 8 CPU devices."""
    rep = port_mesh.selfcheck(port_mesh.device_list(8, "cpu"),
                              max_devices=8, seed=1)
    assert rep["ok"] and rep["counts"] == COUNTS, rep
    assert rep["sharded_kernel_ran"]
    bud = port_mesh.budget_check(device="cpu", ndev=8)
    assert bud["ok"] and bud["mesh_ndev"] == 4, bud
    assert bud["single_device_refused"]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_mesh_int8_one_pass_matches_reference(metric, ndev, split):
    """A store large enough that shards take the one-pass path (sample
    threshold, candidates pass, select of pairs; a short random slice may
    take the chunked path beside them): the merged candidates equal the
    reference mesh's, id for id, duplicated rows (ties across shards)
    included."""
    n, dim = 90_000, 16
    rng = np.random.default_rng(40 + ndev)
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    xs[[50, 3000, 6001, 11_999]] = xs[7]
    valid = rng.random(n) > 0.05
    qs = rng.normal(size=(NQ, dim)).astype(np.float32)
    qs[0] = xs[7]
    offs = _offsets(n, ndev, split, seed=3)
    cfg = dict(CFG, hbm_budget=0)
    kc = max(cfg["int8_oversample"] * K, K + 16)
    assert any(ttopk.int8_candidate_plan(b - a, NQ, min(kc, b - a),
                                         cfg["score_budget"] // 2)
               for a, b in zip(offs, offs[1:]))
    ref = ref_mesh.MeshVecStore("k", xs, valid, metric, 3.0, cfg, ndev, offs)
    port = port_mesh.MeshVecStore("k", xs, valid, metric, 3.0, cfg, ndev,
                                  offs, devices=_cpus(ndev))
    (rm, rb), (pm, pb) = ref.knn(qs, K), port.knn(qs, K)
    assert pm == rm and pm["mode"] == "cand" and pm["kc"] == kc
    np.testing.assert_array_equal(pb[0], rb[0])
