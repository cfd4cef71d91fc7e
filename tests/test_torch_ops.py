"""The port's kernel modules (surrealdb_tpu_torch.ops and the CSR hop)
against the JAX package on the same inputs.

On the CPU every wrapper runs its plain PyTorch version, so these tests
hold the algorithms (formulas, masks, tie order, the blocked merge, the
rank + rescore stages) to the reference; the CUDA kernels are held to
the same plain versions on the card by chip_smoke.py.

Tolerances: distances atol=1e-4, rtol=1e-5 -- f32 sums taken in another
order, on N(0, 1) inputs at D <= 128. Ids must be equal wherever the
reference's neighbouring distances (the k-th against the (k+1)-th
included) differ by more than that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.device.csrstore import _multi_hop_impl
from surrealdb_tpu.graph.csr import CsrGraph
from surrealdb_tpu.ops import distance as jdist
from surrealdb_tpu.ops import metrics as jmetrics
from surrealdb_tpu.ops import topk as jtopk
from surrealdb_tpu_torch.device.csrstore import (
    CsrStore,
    hop_words,
    multi_hop_plain,
)
from surrealdb_tpu_torch.ops import distance as tdist
from surrealdb_tpu_torch.ops import metrics as tmetrics
from surrealdb_tpu_torch.ops import topk as ttopk

ATOL, RTOL = 1e-4, 1e-5
METRICS = ["euclidean", "cosine", "dot", "manhattan", "chebyshev",
           "hamming", "minkowski", "pearson", "jaccard"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(seed, b, n, d, metric):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    if metric == "hamming":
        # coarse values so some coordinates are equal
        xs = np.round(xs)
        qs = np.round(qs)
    if metric == "jaccard":
        xs, qs = np.abs(xs), np.abs(qs)
    valid = rng.random(n) > 0.1
    return xs, qs, valid


def assert_knn_match(ref_d, ref_i, got_d, got_i, k):
    """Sorted distances equal within tolerance; ids equal at every
    position the reference separates from its neighbours. `ref_*` hold
    k + 1 columns when N allows, so the k-th is checked against the
    (k+1)-th."""
    ref_d = np.asarray(ref_d, np.float64)
    ref_i = np.asarray(ref_i)
    got_d = np.asarray(got_d, np.float64)
    got_i = np.asarray(got_i)
    assert got_d.shape == got_i.shape == (ref_d.shape[0], k)
    np.testing.assert_allclose(got_d, ref_d[:, :k], atol=ATOL, rtol=RTOL)
    tol = ATOL + RTOL * np.abs(ref_d)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(ref_d, axis=1))
    for r in range(ref_d.shape[0]):
        for j in range(k):
            lo = j == 0 or gap[r, j - 1] > tol[r, j]
            hi = j + 1 >= ref_d.shape[1] or gap[r, j] > tol[r, j]
            if lo and hi and np.isfinite(ref_d[r, j]):
                assert got_i[r, j] == ref_i[r, j], (r, j)


@pytest.mark.parametrize("spec", METRICS + ["COSINE", ("minkowski", 2),
                                            "mahalanobis"])
def test_metric_specs_normalize_like_the_reference(spec):
    try:
        want = jmetrics.normalize_metric(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tmetrics.normalize_metric(spec)
        return
    assert tmetrics.normalize_metric(spec) == want


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_matches_reference(metric):
    for seed, (b, n, d) in enumerate([(1, 1000, 3), (5, 1000, 32),
                                      (8, 1000, 128)]):
        xs, qs, valid = _data(seed, b, n, d, metric)
        want = np.asarray(jdist.distance_matrix(jnp.asarray(xs),
                                                jnp.asarray(qs), metric, 3.0))
        got = tdist.distance_matrix(_t(xs), _t(qs), metric, 3.0).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        masked = tdist.distance_matrix(_t(xs), _t(qs), metric, 3.0,
                                       _t(valid)).numpy()
        assert np.isinf(masked[:, ~valid]).all()
        np.testing.assert_array_equal(masked[:, valid], got[:, valid])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_knn_search_matches_reference(metric, k):
    b, n, d = (5, 1000, 32) if k != 10 else (8, 1000, 128)
    xs, qs, valid = _data(11 + k, b, n, d, metric)
    for mask in (None, valid):
        jmask = None if mask is None else jnp.asarray(mask)
        rd, ri = jtopk.knn_search(jnp.asarray(xs), jnp.asarray(qs), k + 1,
                                  metric, 3.0, jmask)
        gd, gi = ttopk.knn_search(_t(xs), _t(qs), k, metric, 3.0,
                                  None if mask is None else _t(mask))
        assert gi.dtype == torch.int32
        assert_knn_match(rd, ri, gd.numpy(), gi.numpy(), k)


@pytest.mark.parametrize("metric,b,d,k", [
    ("euclidean", 8, 32, 10), ("cosine", 5, 3, 64), ("manhattan", 1, 32, 1),
    ("dot", 8, 128, 64),
])
def test_knn_search_blocked_crosses_a_block(metric, b, d, k):
    """N = 70_000 crosses the reference's 65536-row block."""
    n = 70_000
    xs, qs, valid = _data(3, b, n, d, metric)
    rd, ri = jtopk.knn_search(jnp.asarray(xs), jnp.asarray(qs), k + 1,
                              metric, 3.0, jnp.asarray(valid))
    bd, bi = jtopk.knn_search_blocked(jnp.asarray(xs), jnp.asarray(qs), k,
                                      metric, 3.0, jnp.asarray(valid))
    gd, gi = ttopk.knn_search_blocked(_t(xs), _t(qs), k, metric, 3.0,
                                      _t(valid))
    assert_knn_match(rd, ri, gd.numpy(), gi.numpy(), k)
    assert_knn_match(np.concatenate([bd, rd[:, k:]], 1),
                     np.concatenate([bi, ri[:, k:]], 1),
                     gd.numpy(), gi.numpy(), k)
    # masked-out rows never appear
    assert valid[gi.numpy()].all()


def test_blocked_running_best_keeps_minus_one_for_unfilled_slots():
    """Fewer valid rows than k: the reference's running best keeps its
    (+inf, -1) initial slots ahead of masked candidates."""
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(300, 8)).astype(np.float32)
    qs = rng.normal(size=(2, 8)).astype(np.float32)
    valid = np.zeros(300, bool)
    valid[[7, 250]] = True
    bd, bi = jtopk.knn_search_blocked(jnp.asarray(xs), jnp.asarray(qs), 5,
                                      "euclidean", 3.0, jnp.asarray(valid),
                                      block=128)
    gd, gi = ttopk.knn_search_blocked(_t(xs), _t(qs), 5, "euclidean", 3.0,
                                      _t(valid), block=128)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(bi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(bd), atol=ATOL,
                               rtol=RTOL)


def test_ties_go_to_the_lower_index():
    vals = np.zeros((2, 100_000), np.float32)
    vals[1, ::3] = -1.0  # a second tie level
    rv, ri = jtopk.top_k_smallest(jnp.asarray(vals), 64)
    gv, gi = ttopk.top_k_smallest(_t(vals), 64)
    np.testing.assert_array_equal(gi[0].numpy(), np.arange(64))
    np.testing.assert_array_equal(gi[1].numpy(), np.arange(64) * 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    # -0.0 and +0.0 compare equal, so index order still decides
    vals = np.zeros((1, 8), np.float32)
    vals[0, 1::2] = -0.0
    _, gi = ttopk.top_k_smallest(_t(vals), 8)
    np.testing.assert_array_equal(gi[0].numpy(), np.arange(8))


def test_top_k_through_an_id_map():
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(3, 40)).astype(np.float32)
    ids = rng.integers(0, 1 << 20, size=(3, 40)).astype(np.int32)
    gv, gi = ttopk.top_k_smallest(_t(vals), 7, ids=_t(ids))
    order = np.argsort(vals, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(gi.numpy(),
                                  np.take_along_axis(ids, order, 1))
    np.testing.assert_array_equal(gv.numpy(),
                                  np.take_along_axis(vals, order, 1))


def _rank_inputs(metric, n=20_000, d=64, seed=29, c=4):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::41] = False
    x2 = (xs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms = np.maximum(np.linalg.norm(xs.astype(np.float64), axis=1),
                       1e-30).astype(np.float32)
    rank = xs / norms[:, None] if metric == "cosine" else xs
    qs_r = rng.normal(size=(2, c, d)).astype(np.float32)
    return xs, rank, x2, norms, valid, qs_r


def _oracle(xs, valid, q, metric, k):
    x = xs.astype(np.float64)
    q = q.astype(np.float64)
    if metric == "euclidean":
        d = np.sqrt(((x - q) ** 2).sum(1))
    elif metric == "cosine":
        d = 1 - x @ q / (np.linalg.norm(x, axis=1) * np.linalg.norm(q))
    else:
        d = -(x @ q)
    d = np.where(valid, d, np.inf)
    return np.argsort(d, kind="stable")[:k]


def test_reference_candidate_stage_is_exact_on_cpu():
    """approx_max_k lowers to an exact selection on the CPU, so the
    reference's candidates are the port's exact ones."""
    rng = np.random.default_rng(3)
    s = rng.normal(size=(4, 20_000)).astype(np.float32)
    _, approx = jax.lax.approx_max_k(jnp.asarray(-s), 26,
                                     recall_target=0.95)
    _, exact = jax.lax.top_k(jnp.asarray(-s), 26)
    np.testing.assert_array_equal(np.asarray(approx), np.asarray(exact))


# (metric, queries a chunk, store rows): the three metrics at 4 queries
# over 20k rows, then query counts on both sides of the rank kernel's
# 64-query tile over a row count that is no multiple of its row tile
RANK_CASES = [pytest.param(m, 4, 20_000, id=m)
              for m in ("euclidean", "cosine", "dot")] + [
    pytest.param(m, c, 5_003, id=f"{m}-C{c}")
    for m in ("euclidean", "cosine", "dot") for c in (1, 63, 65, 130)]


@pytest.mark.parametrize("metric,c,n", RANK_CASES)
def test_knn_rank_rescore_matches_reference(metric, c, n):
    k = 10
    kc = max(2 * k, k + 16)
    xs, rank, x2, norms, valid, qs_r = _rank_inputs(metric, n=n, c=c)
    rows = 2 * c
    jr = jnp.asarray(rank).astype(jnp.bfloat16)
    rd, ri = jtopk.knn_rank_rescore(
        jr, jnp.asarray(xs), jnp.asarray(qs_r), k, kc, metric,
        jnp.asarray(x2), jnp.asarray(norms), jnp.asarray(valid))
    tr = _t(rank).to(torch.bfloat16)
    gd, gi = ttopk.knn_rank_rescore(
        tr, _t(xs), _t(qs_r), k, kc, metric, _t(x2), _t(norms), _t(valid))
    assert gd.shape == (2, c, k) and gi.dtype == torch.int32
    assert_knn_match(np.asarray(rd).reshape(rows, k),
                     np.asarray(ri).reshape(rows, k),
                     gd.reshape(rows, k).numpy(),
                     gi.reshape(rows, k).numpy(), k)
    # the candidate stages agree too (the reference's is exact on CPU)
    q0 = qs_r[0]
    js = np.asarray(
        (jnp.asarray(x2)[None, :] if metric == "euclidean" else 0)
        - (2.0 if metric == "euclidean" else 1.0) * jnp.einsum(
            "nd,bd->bn", jr, jnp.asarray(q0).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32))
    js = np.where(valid[None, :], js, np.inf)
    ts = ttopk.rank_scores(tr, _t(q0), metric, _t(x2), _t(valid)).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-3, rtol=1e-5)
    _, jc = jax.lax.top_k(jnp.asarray(-js), kc)
    _, tc = ttopk.top_k_smallest(_t(ts), kc)
    overlap = np.mean([len(set(a) & set(b)) / kc
                       for a, b in zip(np.asarray(jc), tc.numpy())])
    assert overlap >= 0.99, overlap
    # recall@10 against the exact f64 oracle
    hits = 0
    for r in range(2):
        for j in range(c):
            want = set(_oracle(xs, valid, qs_r[r, j], metric, k).tolist())
            hits += len(want & set(gi[r, j].tolist()))
    assert hits / (rows * k) >= 0.99
    assert valid[gi.numpy()].all()


def _graph(n=2000, e=20_000, seed=19):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=e).astype(np.int32)
    cols = rng.integers(0, n, size=e).astype(np.int32)
    return rows, cols


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("b", [1, 3, 8, 40])
def test_csr_multi_hop_bit_equal(hops, union, b):
    """Batches of 1 to 40 rows (40 buckets to 64: two words a node of the
    kernel's packed frontier on the card)."""
    n = 2000
    rows, cols = _graph(n)
    rng = np.random.default_rng(hops * 10 + b)
    start = np.zeros((b, n), bool)
    for r in range(b):
        start[r, rng.integers(0, n, size=3)] = True
    want = np.asarray(_multi_hop_impl(jnp.asarray(rows), jnp.asarray(cols),
                                      jnp.asarray(start), n, hops, union))
    got = multi_hop_plain(_t(rows), _t(cols), _t(start), hops, union).numpy()
    np.testing.assert_array_equal(got, want)
    store = CsrStore("g", rows, cols, n, "cpu")
    np.testing.assert_array_equal(store.multi_hop(start.astype(np.uint8),
                                                  hops, union),
                                  want.astype(np.uint8))
    # the serving side's numpy mirror (legacy 1-D masks)
    host = CsrGraph("t", "t", "n", "e", "out")
    host.rows, host.cols = rows, cols
    for r in range(b):
        np.testing.assert_array_equal(
            host._host_multi_hop(start[r], hops, union), want[r])
        np.testing.assert_array_equal(
            store.multi_hop(start[r].astype(np.uint8), hops, union),
            want[r].astype(np.uint8))


@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("b", [1, 3, 8, 40])
def test_csr_multi_hop_duplicate_edges_and_self_loops(union, b):
    """A graph with repeated edges (the same (row, col) many times, as the
    packed kernel's atomics meet them) and self-loops, through
    CsrStore.multi_hop, bit for bit with the reference's _multi_hop_impl
    over 1 to 3 hops."""
    n = 700
    rows, cols = _graph(n, 6000, seed=23)
    rows[1::5], cols[1::5] = rows[::5][:len(rows[1::5])], \
        cols[::5][:len(cols[1::5])]
    cols[::11] = rows[::11]
    rng = np.random.default_rng(b)
    start = rng.random((b, n)) > 0.995
    start[0, rows[0]] = True
    store = CsrStore("g", rows, cols, n, "cpu")
    for hops in (1, 2, 3):
        want = np.asarray(_multi_hop_impl(
            jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(start), n,
            hops, union))
        np.testing.assert_array_equal(
            store.multi_hop(start.astype(np.uint8), hops, union),
            want.astype(np.uint8))


def test_csr_hop_words():
    """The packed frontier's words a node: one up to 32 batch rows."""
    assert [hop_words(b) for b in (1, 8, 32, 33, 64, 65)] == [1, 1, 1, 2, 2,
                                                              3]


def test_blocked_merge_keeps_ties_in_id_order():
    """The running merge selects over [best, block] through an id map
    with ties by column: the best ids precede the block's, so that is
    id order, as the reference's lax.top_k over the concatenation. Exact
    duplicates across blocks come back lowest id first."""
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(700, 8)).astype(np.float32)
    xs[[150, 300, 420, 690]] = xs[20]
    qs = np.stack([xs[20], rng.normal(size=8).astype(np.float32)])
    for metric in ("euclidean", "manhattan"):
        bd, bi = jtopk.knn_search_blocked(jnp.asarray(xs), jnp.asarray(qs), 7,
                                          metric, 3.0, block=128)
        gd, gi = ttopk.knn_search_blocked(_t(xs), _t(qs), 7, metric, 3.0,
                                          block=128)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(bi))
        assert gi[0, :5].tolist() == [20, 150, 300, 420, 690]
