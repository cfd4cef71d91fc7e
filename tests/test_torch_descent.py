"""The port's graph-ANN descent and the int8 candidates pass's launch
plan.

`ann_descent_plain` (the plain version the card's `ann_descent` kernel
is held to bit for bit) against the reference's `_descent_scored` on the
same inputs, over frontier widths W 16 / 64 / 128, expansions E 1 / 2 /
4 and 0 / 1 / 24 iterations, both metrics, on a graph whose lists repeat
ids and hold ids past the last row (both sides clamp those in their
gathers); and on a graph whose lists hold ids -1, -N and -(N + 3)
(JAX's gathers wrap an id in [-N, 0) to id + N and clamp the rest, and
so does the port). The seed is each side's probe. Ids must be equal wherever the
reference's scores separate neighbours by more than rtol=1e-5, and the
scores agree within rtol=1e-5 (the reference's XLA product and
dequantisation may differ from an IEEE round of each operation by an
ulp), as in tests/test_torch_ann.py.

On the CPU the kernels' wrappers refuse CPU tensors (the plain
versions serve them), and the candidates pass's plan (cluster blocks,
query halves, ring stages) is checked for every query count of a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.device.annstore import AnnStore as RefAnnStore
from surrealdb_tpu.device.annstore import _descent_jit
from surrealdb_tpu.idx import cagra as rcagra
from surrealdb_tpu_torch.device import annstore as pann
from surrealdb_tpu_torch.ops import topk as ttopk

from test_torch_ann import RTOL, _clustered, assert_ids_match

N, DIM, B = 700, 32, 5
_STORES: dict = {}


def _store(metric):
    """A 700 x 32 clustered store built by the reference, its graph
    with repeated ids and ids past the last row, and five queries near
    its rows (cached per metric)."""
    if metric not in _STORES:
        xs, rng = _clustered(n=N, d=DIM, seed=41)
        ann = rcagra.build_index(xs, metric, 0, 0)
        graph = ann.graph.copy()
        graph[::5, 1] = N + 7
        graph[::7, 3] = 1 << 30
        graph[::3, 2] = graph[::3, 0]
        graph[::4, 5] = graph[::4, 4]
        qs = xs[rng.integers(0, N, B)] + 0.075 * rng.normal(
            size=(B, DIM)).astype(np.float32)
        _STORES[metric] = (ann, graph, qs)
    return _STORES[metric]


_NEG_STORES: dict = {}


def _neg_store(metric):
    """`_store`'s rows and queries with a graph whose lists hold ids -1,
    -N and -(N + 3), and repeat ids (cached per metric)."""
    if metric not in _NEG_STORES:
        ann, _, qs = _store(metric)
        graph = ann.graph.copy()
        graph[::5, 1] = -1
        graph[::7, 3] = -N
        graph[::6, 2] = -(N + 3)
        graph[::4, 5] = graph[::4, 4]
        _NEG_STORES[metric] = (ann, graph, qs)
    return _NEG_STORES[metric]


def _descend_both(ann, graph, qs, metric, width, expand, iters, trace=None):
    """(reference ids, dists), (port ids, dists) of one descent."""
    kc = min(40, width)
    cfg = {"width": width, "iters": max(iters, 1), "expand": expand}
    ref = RefAnnStore("k", graph, ann.x8, ann.arow, ann.x2, metric, cfg)
    rid, rd = _descent_jit(ref._ensure() + (jnp.asarray(qs),),
                           (metric, width, iters, expand, kc), scored=True)
    rid, rd = np.asarray(rid), np.asarray(rd)
    port = pann.AnnStore("k", graph, ann.x8, ann.arow, ann.x2, metric, cfg,
                         "cpu")
    dv = port._ensure()
    q = torch.from_numpy(qs)
    ids0, d0 = pann.probe_seed(dv, q, metric, width)
    got_i, got_d = pann.ann_descent_plain(dv["graph"], dv["x8"], dv["arow"],
                                          dv["x2q"], q, ids0, d0, metric,
                                          iters, expand, kc, trace=trace)
    return (rid, rd), (got_i, got_d)


@pytest.mark.parametrize("iters", [0, 1, 24])
@pytest.mark.parametrize("expand", [1, 2, 4])
@pytest.mark.parametrize("width", [16, 64, 128])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_descent_plain_matches_reference(metric, width, expand, iters):
    ann, graph, qs = _store(metric)
    (rid, rd), (got_i, got_d) = _descend_both(ann, graph, qs, metric, width,
                                              expand, iters)
    assert got_i.shape == (B, min(40, width)) and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_d.numpy(), rd, rtol=RTOL, atol=0)
    assert_ids_match(rd, rid, got_i.numpy())


@pytest.mark.parametrize("iters", [1, 24])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_descent_plain_matches_reference_negative_ids(metric, width, expand,
                                                      iters):
    """Negative graph ids: scored and expanded as rows id + N (or row 0
    past -N), kept raw in the frontier and the answer, as the
    reference keeps them."""
    ann, graph, qs = _neg_store(metric)
    trace = {}
    (rid, rd), (got_i, got_d) = _descend_both(ann, graph, qs, metric, width,
                                              expand, iters, trace)
    np.testing.assert_allclose(got_d.numpy(), rd, rtol=RTOL, atol=0)
    assert_ids_match(rd, rid, got_i.numpy())
    if iters == 24:  # the walk reached the negative ids
        scored = torch.cat(trace["scored"])
        assert {-1, -N, -(N + 3)} <= set(scored.tolist())


def test_descent_seed_sorted_stably_gives_the_same_answer():
    """The kernel sorts the seed stably by dist before its first round:
    the plain version on an unsorted seed with ties gives what it gives
    on that seed sorted stably."""
    ann, graph, qs = _store("cosine")
    port = pann.AnnStore("k", graph, ann.x8, ann.arow, ann.x2, "cosine",
                         {"width": 64}, "cpu")
    dv = port._ensure()
    q = torch.from_numpy(qs)
    ids0, d0 = pann.probe_seed(dv, q, "cosine", 64)
    perm = torch.argsort(torch.rand(d0.shape, generator=torch.Generator()
                                    .manual_seed(3)), dim=1)
    seed_i = torch.gather(ids0, 1, perm)
    seed_d = torch.round(torch.gather(d0, 1, perm) * 4) / 4  # ties
    order = torch.sort(seed_d, dim=1, stable=True).indices
    args = (dv["graph"], dv["x8"], dv["arow"], dv["x2q"], q)
    for it in (0, 3, 24):
        a_i, a_d = pann.ann_descent_plain(*args, seed_i, seed_d, "cosine",
                                          it, 2, 40)
        b_i, b_d = pann.ann_descent_plain(
            *args, torch.gather(seed_i, 1, order),
            torch.gather(seed_d, 1, order), "cosine", it, 2, 40)
        assert torch.equal(a_i, b_i) and torch.equal(a_d, b_d)


def test_candidates_plan_sizes_each_launch():
    """A block holds 128 queries (64 when a launch has at most 64), a
    cluster ceil(C / 128) blocks; the ring gets what shared memory holds
    beside the queries, 3 to 8 stages, else the streamed route."""
    limit = ttopk.CAND_SMEM_BYTES
    for c in range(1, ttopk.CAND_LAUNCH + 1):
        cl, halves, stages = ttopk.candidates_plan(c, 768)
        assert cl == -(-c // 128) and halves == (1 if c <= 64 else 2)
        # every block of the cluster holds at least one query
        assert (cl - 1) * 128 < c <= (cl - 1) * 128 + 64 * halves
        assert stages == (8 if c <= 64 else 5)
        assert (ttopk.CAND_FIXED_BYTES + 6 * halves * 64 * 128
                + stages * ttopk.CAND_STAGE_BYTES) <= limit
    assert ttopk.candidates_plan(512, 1024) == (4, 2, 3)
    assert ttopk.candidates_plan(129, 48) == (2, 2, 8)
    # past 1024 columns a 128-query slab leaves too little ring
    assert ttopk.candidates_plan(65, 1040) == (1, 0, 0)
    assert ttopk.candidates_plan(64, 1040) == (1, 1, 6)
    assert ttopk.candidates_plan(16, 3072) == (1, 0, 0)
    for c in (0, ttopk.CAND_LAUNCH + 1):
        with pytest.raises(ValueError):
            ttopk.candidates_plan(c, 768)


def test_kernel_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(2)
    x8 = torch.from_numpy(rng.integers(-127, 128, (300, 32)).astype(np.int8))
    arow = torch.rand(300) / 127
    q8 = torch.from_numpy(rng.integers(-127, 128, (4, 32)).astype(np.int8))
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.rank_candidates_int8(x8, q8, torch.ones(4), "cosine", arow,
                                   None, None, torch.zeros(4), 64)
    graph = torch.from_numpy(rng.integers(0, 300, (300, 8)).astype(np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pann.ann_descent_cuda(graph, x8, arow, torch.zeros(300),
                              torch.rand(4, 32),
                              torch.zeros((4, 16), dtype=torch.int32),
                              torch.zeros(4, 16), "cosine", 3, 2, 10)
