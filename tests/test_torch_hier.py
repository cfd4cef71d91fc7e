"""The port's two-level (dcn x data) mesh and `knn_rank_approx` against
the JAX package's on the same inputs.

The reference runs `sharded_rank_rescore_hier` on tests/conftest.py's
8 virtual CPU devices, split into 2 simulated hosts; the port on a
`device="cpu"` list of the same shape, where every kernel wrapper runs
its plain version. Tolerances: distances atol=1e-4, rtol=1e-5 (f32
sums in another order); ids equal wherever the reference separates
neighbours by more, and at exact ties (duplicated rows) equal in order:
within a host to the lower position in the data-axis concatenation,
across hosts to the lower host. Only finite slots are compared: the
reference pads N up to the shard count with masked rows whose ids lie
past N, the port's shards hold only real rows. `knn_rank_approx`'s
bf16 rank scores (768-deep or not) are held to atol=1e-3, rtol=1e-5,
and its ids wherever the reference's scores are separated by more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.ops import topk as jtopk
from surrealdb_tpu.parallel import mesh as ref_pmesh
from surrealdb_tpu_torch.ops import topk as ttopk
from surrealdb_tpu_torch.parallel import mesh as port_pmesh

from test_torch_ops import assert_knn_match

CPU = torch.device("cpu")
DIM, NQ = 16, 6
# rows that hold copies of row 3, spread over both hosts at 4 and 8
# devices (N = 257: nloc 65 / 33)
COPIES = (40, 100, 140, 200, 250)


def _data(n, seed=0, tombstones=True):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, DIM)).astype(np.float32)
    for r in COPIES:
        if r < n:
            xs[r] = xs[3]
    valid = np.ones(n, bool)
    if tombstones:
        valid[rng.choice(n, n // 12, replace=False)] = False
        valid[[3] + [r for r in COPIES if r < n]] = True
        if n > 140:
            valid[140] = False  # one copy tombstoned
    qs = (xs[rng.integers(0, n, NQ)]
          + 0.1 * rng.normal(size=(NQ, DIM))).astype(np.float32)
    qs[0] = xs[3]  # every copy ties with it
    qs[1] = xs[3] + 1e-3
    return xs, valid, qs


def _stats(xs, metric):
    x64 = xs.astype(np.float64)
    x2 = (x64 ** 2).sum(1).astype(np.float32)
    norms = np.maximum(np.linalg.norm(x64, axis=1), 1e-30).astype(
        np.float32)
    rank = xs / norms[:, None] if metric == "cosine" else xs
    return rank, x2, norms


def assert_ties_in_order(ref_d, ref_i, got_d, got_i):
    """Where the reference's distances tie exactly (finite), over a run
    whose ends the reference separates from its neighbours, the port's
    ids in that run are the reference's, in order."""
    ref_d = np.asarray(ref_d, np.float64)
    tol = 1e-4 + 1e-5 * np.abs(ref_d)
    for r in range(ref_d.shape[0]):
        row = ref_d[r]
        j = 0
        while j < len(row):
            e = j
            while e + 1 < len(row) and row[e + 1] == row[j]:
                e += 1
            sep = ((j == 0 or row[j] - row[j - 1] > tol[r, j])
                   and (e + 1 == len(row) or row[e + 1] - row[e] > tol[r, e]))
            if e > j and sep and np.isfinite(row[j]):
                assert list(got_i[r, j:e + 1]) == list(ref_i[r, j:e + 1]), (
                    r, j, e)
                assert len(set(np.asarray(got_d)[r, j:e + 1].tolist())) == 1
            j = e + 1


def _ref_hier(ndev, hosts, xs, rank, x2, norms, valid, qs, k, kc, metric):
    hmesh = ref_pmesh.multihost_mesh(jax.devices()[:ndev], hosts=hosts)
    full, pad = ref_pmesh.shard_rows_hier(hmesh, xs)
    rank_r = ref_pmesh.shard_rows_hier(hmesh, rank)[0].astype(jnp.bfloat16)
    rd, ri = ref_pmesh.sharded_rank_rescore_hier(
        hmesh, rank_r, full, qs, k, kc, metric,
        ref_pmesh.shard_vec_hier(hmesh, x2, pad),
        ref_pmesh.shard_vec_hier(hmesh, norms, pad, 1.0),
        ref_pmesh.shard_vec_hier(hmesh, valid, pad, fill=False))
    return np.asarray(rd), np.asarray(ri)


def _port_hier(ndev, hosts, xs, rank, x2, norms, valid, qs, k, kc, metric):
    pm = port_pmesh.multihost_mesh([CPU] * ndev, hosts=hosts)
    gd, gi = port_pmesh.sharded_rank_rescore_hier(
        pm, port_pmesh.shard_rows_hier(pm, rank, torch.bfloat16),
        port_pmesh.shard_rows_hier(pm, xs), torch.from_numpy(qs), k, kc,
        metric, port_pmesh.shard_vec_hier(pm, x2),
        port_pmesh.shard_vec_hier(pm, norms),
        port_pmesh.shard_vec_hier(pm, valid))
    return gd.numpy(), gi.numpy()


@pytest.mark.parametrize("n", [257, 13], ids=["N257", "N13"])
@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_hier_matches_reference(metric, ndev, n):
    """N not a multiple of the devices; N = 13 leaves a host with fewer
    real rows than k (padding slots, +inf, compared as the +inf
    pattern only); tombstones; copies of one row on both hosts."""
    xs, valid, qs = _data(n)
    rank, x2, norms = _stats(xs, metric)
    for k, kc in ((10, 26), (40, 64), (5, 3)):
        rd, ri = _ref_hier(ndev, 2, xs, rank, x2, norms, valid, qs, k, kc,
                           metric)
        gd, gi = _port_hier(ndev, 2, xs, rank, x2, norms, valid, qs, k, kc,
                            metric)
        assert gd.shape == rd.shape and gi.dtype == np.int32
        assert np.array_equal(np.isinf(gd), np.isinf(rd))
        assert_knn_match(rd, ri, gd, gi, gd.shape[1])
        assert_ties_in_order(rd, ri, gd, gi)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_hier_one_host_is_the_single_level_mesh(metric):
    """hosts=1 (and a mesh of one host a device): the same answers as
    the single-level `sharded_rank_rescore` over the same shards, ties
    included."""
    xs, valid, qs = _data(257, seed=3)
    rank, x2, norms = _stats(xs, metric)
    pm = port_pmesh.default_mesh([CPU] * 4)
    args = (port_pmesh.shard_rows(pm, rank, torch.bfloat16),
            port_pmesh.shard_rows(pm, xs), torch.from_numpy(qs), 10, 26,
            metric, port_pmesh.shard_rows(pm, x2),
            port_pmesh.shard_rows(pm, norms),
            port_pmesh.shard_rows(pm, valid))
    sd, si = port_pmesh.sharded_rank_rescore(pm, *args)
    for hosts in (None, 1):
        hm = port_pmesh.multihost_mesh([CPU] * 4, hosts=hosts)
        assert len(hm) == 1 and len(hm[0]) == 4
        hd, hi = port_pmesh.sharded_rank_rescore_hier(hm, *args)
        assert torch.equal(sd, hd) and torch.equal(si, hi)
    hm = port_pmesh.multihost_mesh([CPU] * 4, hosts=4)
    hd, hi = port_pmesh.sharded_rank_rescore_hier(hm, *args)
    rd, ri = _ref_hier(4, 4, xs, rank, x2, norms, valid, qs, 10, 26, metric)
    assert_knn_match(rd, ri, hd.numpy(), hi.numpy(), 10)
    assert_ties_in_order(rd, ri, hd.numpy(), hi.numpy())


def test_hier_mesh_shape_and_error():
    hm = port_pmesh.multihost_mesh(["cpu"] * 8, hosts=2)
    assert [len(h) for h in hm] == [4, 4]
    assert all(d == CPU for h in hm for d in h)
    with pytest.raises(ValueError) as port_err:
        port_pmesh.multihost_mesh([CPU] * 6, hosts=4)
    with pytest.raises(ValueError) as ref_err:
        ref_pmesh.multihost_mesh(jax.devices()[:6], hosts=4)
    assert str(port_err.value) == str(ref_err.value)


def _approx_inputs(metric, n=5003, r=3, b=7, d=32, seed=11):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    xs[[10, 2000, 4999]] = xs[7]  # ties in the scores
    valid = rng.random(n) > 0.1
    valid[[7, 10, 2000, 4999]] = True
    rank, x2, _ = _stats(xs, metric)
    qs_r = rng.normal(size=(r, b, d)).astype(np.float32)
    qs_r[0, 0] = xs[7]
    return rank, x2, valid, qs_r


def _ref_scores(jr, q, metric, x2, valid):
    dots = np.asarray(jnp.einsum(
        "nd,bd->bn", jr, jnp.asarray(q).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32), np.float64)
    s = x2[None, :] - 2.0 * dots if metric == "euclidean" else -dots
    return np.where(valid[None, :], s, np.inf)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_knn_rank_approx_matches_reference(metric):
    k = 26
    rank, x2, valid, qs_r = _approx_inputs(metric)
    jr = jnp.asarray(rank).astype(jnp.bfloat16)
    ri = np.asarray(jtopk.knn_rank_approx(
        jr, jnp.asarray(qs_r), k, metric, jnp.asarray(x2),
        jnp.asarray(valid)))
    gi = ttopk.knn_rank_approx(
        torch.from_numpy(rank).to(torch.bfloat16), torch.from_numpy(qs_r), k,
        metric, torch.from_numpy(x2), torch.from_numpy(valid))
    assert gi.shape == ri.shape == (3, 7, k) and gi.dtype == torch.int32
    gi = gi.numpy()
    for r in range(qs_r.shape[0]):
        s = _ref_scores(jr, qs_r[r], metric, x2, valid)
        order = np.argsort(s, axis=1, kind="stable")[:, :k + 1]
        sd = np.take_along_axis(s, order, 1)
        # the reference's ids are its scores' stable order (ties to the
        # lower row), up to sums in another order than this einsum's
        tol = 1e-3 + 1e-5 * np.abs(sd)
        gap = np.diff(sd, axis=1)
        for b in range(sd.shape[0]):
            for j in range(k):
                lo = j == 0 or gap[b, j - 1] > tol[b, j]
                hi = gap[b, j] > tol[b, j]
                if lo and hi:
                    assert gi[r, b, j] == ri[r, b, j] == order[b, j], (r, b, j)
        # the duplicated rows tie exactly in both: lower row first
        if r == 0:
            dup = [j for j in range(k) if ri[0, 0, j] in (7, 10, 2000, 4999)]
            assert list(gi[0, 0, dup]) == list(ri[0, 0, dup]) \
                == [7, 10, 2000, 4999]


def test_knn_rank_approx_is_the_rank_and_select_of_each_batch():
    rank, x2, valid, qs_r = _approx_inputs("euclidean", seed=2)
    tr = torch.from_numpy(rank).to(torch.bfloat16)
    got = ttopk.knn_rank_approx(tr, torch.from_numpy(qs_r), 9, "euclidean",
                                torch.from_numpy(x2), torch.from_numpy(valid))
    for r in range(qs_r.shape[0]):
        s = ttopk.rank_scores_plain(tr, torch.from_numpy(qs_r[r]),
                                    "euclidean", torch.from_numpy(x2),
                                    torch.from_numpy(valid))
        assert torch.equal(got[r], ttopk.top_k_smallest_plain(s, 9)[1])
