"""The port's rescore with the final top k fused in, the JAX gather rule
it indexes rows by, and the launch plans of the rescore and of the pair
select, against the JAX package.

On the CPU `gather_rescore_topk` runs its plain version
(`gather_rescore_topk_plain`: `gather_rescore_plain`, then
`top_k_smallest_plain` over the kc distances with the candidate ids);
on the card `chip_smoke.py` holds the kernel to that and, bit for bit,
to the [C, kc] rescore followed by `select_topk_rows`. Here the stage is
held to the reference's `knn_rank_rescore` (whose candidate stage is
exact on the CPU) with every row a candidate (kc = N), so both sides
rescore the same rows: three metrics, masked rows, duplicated rows
(ties, ordered by column), a zero row (a dot distance of -0.0, kept
-0.0) and k = kc. Distances atol=1e-4, rtol=1e-5; ids equal wherever the
reference's neighbouring distances differ by more than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.ops import topk as jtopk
from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops import topk as ttopk

from test_torch_ops import ATOL, RTOL, assert_knn_match

N, DIM, C = 96, 24, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(metric, seed=5):
    """96 x 24 rows with rows 10 and 30 copies of row 3, a zero row 20
    and every 9th row masked; two chunks of three queries."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, DIM)).astype(np.float32)
    xs[10] = xs[3]
    xs[30] = xs[3]
    xs[20] = 0.0
    valid = np.ones(N, bool)
    valid[::9] = False
    x2 = (xs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms = np.maximum(np.linalg.norm(xs.astype(np.float64), axis=1),
                       1e-30).astype(np.float32)
    rank = xs / norms[:, None] if metric == "cosine" else xs
    qs_r = rng.normal(size=(2, C, DIM)).astype(np.float32)
    return xs, rank, x2, norms, valid, qs_r


@pytest.mark.parametrize("k", [10, N])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_fused_rescore_matches_reference(metric, k):
    kc = N
    xs, rank, x2, norms, valid, qs_r = _inputs(metric)
    jr = jnp.asarray(rank).astype(jnp.bfloat16)
    rd, ri = (np.asarray(a).reshape(2 * C, k) for a in jtopk.knn_rank_rescore(
        jr, jnp.asarray(xs), jnp.asarray(qs_r), k, kc, metric,
        jnp.asarray(x2), jnp.asarray(norms), jnp.asarray(valid)))
    tr = _t(rank).to(torch.bfloat16)
    parts = []
    for qs in _t(qs_r):
        score = ttopk.rank_scores(tr, qs, metric, _t(x2), _t(valid))
        cand = ttopk.top_k_smallest(score, kc)[1]
        fv, fi = ttopk.gather_rescore_topk_plain(_t(xs), qs, cand, metric, k,
                                                 _t(norms), _t(valid))
        # the fused step is the [C, kc] rescore and the select of it
        d = ttopk.gather_rescore_plain(_t(xs), qs, cand, metric, _t(norms),
                                       _t(valid))
        sv, si = ttopk.top_k_smallest_plain(d, k, ids=cand)
        assert torch.equal(fv.view(torch.int32), sv.view(torch.int32))
        assert torch.equal(fi, si) and fi.dtype == torch.int32
        parts.append((fv, fi))
    gd = torch.cat([p[0] for p in parts]).numpy()
    gi = torch.cat([p[1] for p in parts]).numpy()
    assert_knn_match(rd, ri, gd, gi, k)
    # masked rows last (+inf), in candidate order (the reference's
    # candidate stage orders its +inf ties otherwise)
    assert np.array_equal(np.isinf(gd), np.isinf(rd))
    assert valid[gi[~np.isinf(gd)]].all()
    assert not valid[gi[np.isinf(gd)]].any()
    # a zero distance keeps its sign (dot with the zero row: -0.0)
    zero = rd == 0
    np.testing.assert_array_equal(np.signbit(gd[zero]), np.signbit(rd[zero]))
    if metric == "dot" and k == kc:  # the zero row is among the k
        assert zero.any() and np.signbit(gd[zero]).all()
    # the duplicated rows tie: they follow one another by column
    for r in range(2 * C):
        pos = [int(np.flatnonzero(gi[r] == j)[0]) for j in (3, 10, 30)
               if j in gi[r]]
        assert pos == sorted(pos)
    # and the store's path gives the same (the fused route)
    pd, pi = ttopk.knn_rank_rescore(tr, _t(xs), _t(qs_r), k, kc, metric,
                                    _t(x2), _t(norms), _t(valid))
    assert torch.equal(pi.reshape(2 * C, k), torch.from_numpy(gi))
    assert torch.equal(pd.reshape(2 * C, k).view(torch.int32),
                       torch.from_numpy(gd).view(torch.int32))


def test_jax_rows_is_jaxs_gather_rule():
    """An id in [-n, 0) wraps to id + n; every other id is clamped."""
    ids = np.array([-1, -5, -6, -100, 5, 7, 2, 0, 4, -3], np.int32)
    x = jnp.arange(0, 50, 10)
    want = np.asarray(jax.jit(lambda a, i: a[i])(x, jnp.asarray(ids)))
    np.testing.assert_array_equal(ttopk.jax_rows(_t(ids), 5).numpy() * 10,
                                  want)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_rescore_wraps_and_clamps_ids_like_the_reference(metric):
    """The reference's `xs_full[cand]` (and `norms[cand]`,
    `valid[cand]`) on ids past either end: wrapped or clamped, never
    +inf for the id alone; the answer's ids stay as given."""
    xs, _, _, norms, valid, qs_r = _inputs(metric)
    cand = np.array([[-1, -N, -(N + 3), N, N + 40, 3, 10, 7]] * C, np.int32)
    jx, jc = jnp.asarray(xs), jnp.asarray(cand)
    rows = np.asarray(jx[jc], np.float64)  # JAX's gather
    q = qs_r[0].astype(np.float64)
    if metric == "euclidean":
        want = np.sqrt(((rows - q[:, None, :]) ** 2).sum(-1))
    else:
        dd = np.einsum("bkd,bd->bk", rows, q)
        if metric == "cosine":
            nr = np.asarray(jnp.asarray(norms)[jc], np.float64)
            want = 1 - dd / np.maximum(nr * np.linalg.norm(q, axis=1)[:, None],
                                       1e-30)
        else:
            want = -dd
    want = np.where(np.asarray(jnp.asarray(valid)[jc]), want, np.inf)
    got = ttopk.gather_rescore_plain(_t(xs), _t(qs_r[0]), _t(cand), metric,
                                     _t(norms), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    fv, fi = ttopk.gather_rescore_topk(_t(xs), _t(qs_r[0]), _t(cand), metric,
                                       8, _t(norms), _t(valid))
    order = np.argsort(got, axis=1, kind="stable")
    np.testing.assert_array_equal(fi.numpy(),
                                  np.take_along_axis(cand, order, axis=1))


def test_rescore_route_past_the_fused_limit():
    """kc up to RESCORE_TOPK_MAX_KC takes the fused step; one past it the
    [C, kc] rescore and a select, counted as rescore_select_route; both
    give the plain answer."""
    rng = np.random.default_rng(8)
    xs = _t(rng.normal(size=(3000, 8)).astype(np.float32))
    qs = _t(rng.normal(size=(2, 8)).astype(np.float32))
    for kc in (ttopk.RESCORE_TOPK_MAX_KC, ttopk.RESCORE_TOPK_MAX_KC + 1):
        cand = _t(rng.integers(0, 3000, (2, kc)).astype(np.int32))
        before = kernelstats.events()["rescore_select_route"]
        got = ttopk.gather_rescore_topk(xs, qs, cand, "dot", 10)
        routed = kernelstats.events()["rescore_select_route"] - before
        assert routed == int(kc > ttopk.RESCORE_TOPK_MAX_KC)
        want = ttopk.gather_rescore_topk_plain(xs, qs, cand, "dot", 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rescore_plan_for_every_query_count():
    """Blocks a query: about two blocks an SM while the queries alone do
    not fill the card, at most eight, each with at least eight columns
    (two for each of a block's four warps)."""
    sms = 132
    for c in range(1, 513):
        for kc in (1, 8, 9, 26, 64, ttopk.RESCORE_TOPK_MAX_KC,
                   ttopk.RESCORE_TOPK_MAX_KC + 1):
            g = ttopk.rescore_plan(c, kc, sms)
            assert 1 <= g <= ttopk.RESCORE_MAX_CLUSTER
            assert g <= max(1, -(-kc // ttopk.RESCORE_BLOCK_ROWS))
            assert g == 1 or c * (g - 1) < 2 * sms
            if c >= 2 * sms:
                assert g == 1
    assert [ttopk.rescore_plan(c, 26, sms) for c in (1, 7, 128, 512)] == [
        4, 4, 3, 1]
    assert ttopk.rescore_plan(1, 2048, sms) == 8
    assert ttopk.rescore_plan(1, 8, sms) == ttopk.rescore_plan(7, 1, sms) == 1


def test_pair_select_plan_for_every_row_count():
    """The plan is the same at every row count (one block a row): a
    power-of-two key buffer of at least 1.25 k and 64 keys, in shared
    memory up to 8192 keys, past that a device scratch row."""
    for k in range(1, 10_001):
        buf, scratch = ttopk.pair_select_plan(k)
        want = max(64, k + k // 4)
        assert buf & (buf - 1) == 0 and want <= buf < 2 * want
        assert scratch == (0 if buf <= ttopk.PAIR_SMEM_KEYS else buf)
    # knn10m's kc: a 2048-key buffer in shared memory
    assert ttopk.pair_select_plan(1280) == (2048, 0)
    assert ttopk.pair_select_plan(6554) == (8192, 0)
    assert ttopk.pair_select_plan(6555) == (16384, 16384)


@pytest.mark.parametrize("kind", ["ties", "equal", "signed", "dup"])
def test_top_k_pairs_plain_orders_by_value_then_id(kind):
    """The plain version the pair kernel is held to: per row the k
    smallest (value, id) of the first min(count, cap) pairs, (+inf, -1)
    for a row short of k."""
    rng = np.random.default_rng(4)
    rows, cap, k = 6, 500, 40
    if kind == "ties":
        v = np.round(rng.normal(size=(rows, cap)) * 8) / 8
    elif kind == "equal":
        v = np.full((rows, cap), 0.75)
    else:
        v = rng.normal(size=(rows, cap)) * 4
    ids = np.argsort(rng.random((rows, cap)), axis=1)
    if kind == "dup":
        v[0], ids[0] = 0.25, 7
    v = v.astype(np.float32)
    counts = np.array([cap + 5, k - 1, k, 0, 300, 450], np.int32)
    pairs = ttopk.pack_pairs_plain(ttopk.order_key_plain(_t(v)), _t(ids))
    gv, gi = ttopk.top_k_pairs_plain(pairs, _t(counts), k)
    for r in range(rows):
        m = min(int(counts[r]), cap)
        if m < k:
            assert np.isinf(gv[r].numpy()).all() and (gi[r] == -1).all()
            continue
        order = np.lexsort((ids[r, :m], v[r, :m]))[:k]
        np.testing.assert_array_equal(gi[r].numpy(), ids[r, order])
        np.testing.assert_array_equal(gv[r].numpy(), v[r, order])


def test_new_wrappers_refuse_cpu_tensors():
    pairs = torch.zeros((2, 100), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.select_topk_pairs(pairs, torch.zeros(2, dtype=torch.int32), 10)
    xs, qs = torch.rand(50, 8), torch.rand(2, 8)
    cand = torch.zeros((2, 26), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.gather_rescore_cuda(xs, qs, cand, "dot")
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.gather_rescore_topk_cuda(xs, qs, cand, "dot", 10)
