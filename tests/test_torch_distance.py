"""The distance kernel's tensor-core route and the cached row statistics,
against the JAX package on the CPU.

`csrc/distance.cu` computes the product metrics (euclidean, cosine, dot,
pearson) on the tensor cores in 3xTF32: each operand, normalised first,
is split into hi = round-to-nearest TF32 (`cvt.rna`) and lo = v - hi,
the tensor core reads an operand with its low 13 bits dropped, and the
product is lo.hi + hi.lo + hi.hi. A numpy model of that arithmetic is
held here to the reference's `distance_matrix` within the port's f32
tolerance (atol 1e-4, rtol 1e-5; ids equal wherever the reference's
neighbouring distances differ by more), and one TF32 product is shown
to miss it, so that the split cannot be dropped unnoticed. The card
holds the kernel itself to the plain version (chip_smoke.py).

The stores compute their rows' statistics once (`row_stats`) and hand
them to every distance call; on the CPU the plain version takes them
the same way. The exact, blocked and mesh stores are held to the
reference with a zero row (the 1e-30 clamp) and tombstones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.device import handlers as ref_handlers
from surrealdb_tpu.device import mesh as ref_mesh
from surrealdb_tpu.ops import distance as jdist
from surrealdb_tpu.ops import topk as jtopk
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device import mesh as port_mesh
from surrealdb_tpu_torch.ops import distance as tdist

from test_torch_ops import assert_knn_match

ATOL, RTOL = 1e-4, 1e-5
PRODUCT = ["euclidean", "cosine", "dot", "pearson"]
CFG = {"hbm_budget": 1 << 62, "score_budget": 1 << 22, "query_chunk": 64,
       "int8_oversample": 4, "block_rows": 1 << 20}


# -- the 3xTF32 model ---------------------------------------------------------

def _tf32_rna(v):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
    (add half of the dropped range to the magnitude, then drop it)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_read(v):
    """What the tensor core reads of an f32 register: the low 13 bits
    dropped."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _stats(x, metric):
    """The kernel's row statistics, f32 (as csrc/distance.cu's row_stats
    and the plain row_stats_plain compute them)."""
    x64 = x.astype(np.float64)
    if metric == "euclidean":
        return (x64 * x64).sum(1).astype(np.float32), None
    if metric == "cosine":
        return (np.zeros(len(x), np.float32),
                np.maximum(np.linalg.norm(x64, axis=1), 1e-30).astype(
                    np.float32))
    mean = x64.mean(1)
    return (mean.astype(np.float32),
            np.maximum(np.linalg.norm(x64 - mean[:, None], axis=1),
                       1e-30).astype(np.float32))


def _model(xs, qs, metric, split=True):
    """The tensor-core route's arithmetic: store rows normalised as
    (x - shift) * (1 / scale), queries as (q - shift) / scale, both in
    f32; then 3xTF32 (split) or one TF32 product, summed exactly here
    (the f32 accumulation is the plain product's concern); the f32
    epilogue."""
    xs = xs.astype(np.float32)
    qs = qs.astype(np.float32)
    xn, qn = xs, qs
    if metric in ("cosine", "pearson"):
        xa, xb = _stats(xs, metric)
        qa, qb = _stats(qs, metric)
        xn = (xs - xa[:, None]) * (np.float32(1) / xb)[:, None]
        qn = (qs - qa[:, None]) / qb[:, None]
    if split:
        xh, qh = _tf32_rna(xn), _tf32_rna(qn)
        xl, ql = _tf32_read(xn - xh), _tf32_read(qn - qh)
        xh, xl, qh, ql = (a.astype(np.float64) for a in (xh, xl, qh, ql))
        dot = (ql @ xh.T + qh @ xl.T + qh @ xh.T).astype(np.float32)
    else:
        dot = (_tf32_rna(qn).astype(np.float64)
               @ _tf32_rna(xn).astype(np.float64).T).astype(np.float32)
    if metric == "euclidean":
        x2 = _stats(xs, metric)[0][None, :]
        q2 = _stats(qs, metric)[0][:, None]
        return np.sqrt(np.maximum(x2 + q2 - np.float32(2) * dot, 0))
    if metric == "dot":
        return -dot
    return np.float32(1) - dot


def _rows(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(16, d)).astype(np.float32))


def _reference(xs, qs, metric):
    return np.asarray(jdist.distance_matrix(jnp.asarray(xs), jnp.asarray(qs),
                                            metric))


@pytest.mark.parametrize("metric", PRODUCT)
@pytest.mark.parametrize("d", [37, 128, 768])
def test_3xtf32_model_meets_the_f32_tolerance(metric, d):
    xs, qs = _rows(2000, d, d)
    xs[11] = 0.0  # a zero row: the 1e-30 clamp
    want = _reference(xs, qs, metric)
    got = _model(xs, qs, metric)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # ids: the k nearest in the same order wherever the reference
    # separates neighbours by more than the tolerance
    k = 11
    order = np.argsort(want, axis=1, kind="stable")[:, :k + 1]
    ref_d = np.take_along_axis(want, order, 1)
    got_i = np.argsort(got, axis=1, kind="stable")[:, :k]
    assert_knn_match(ref_d, order, np.take_along_axis(got, got_i, 1), got_i,
                     k)


def test_one_tf32_product_misses_the_tolerance():
    """Without the split the euclidean distances at D = 768 leave the f32
    tolerance: the kernel must keep all three products."""
    xs, qs = _rows(2000, 768, 768)
    want = _reference(xs, qs, "euclidean")
    err = np.abs(_model(xs, qs, "euclidean", split=False) - want)
    assert (err > ATOL + RTOL * np.abs(want)).any()


def test_tf32_rounding_model():
    """cvt.rna keeps 10 mantissa bits and rounds half away from zero; the
    split's lo is exact in f32 and below half a TF32 ulp of hi."""
    one_ulp = np.float32(2.0 ** -10)
    v = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                  1.0 + one_ulp / 4, 3.0e-3], np.float32)
    hi = _tf32_rna(v)
    assert hi[0] == np.float32(1.0)
    assert hi[1] == np.float32(1.0 + one_ulp)
    assert hi[2] == -np.float32(1.0 + one_ulp)
    assert hi[3] == np.float32(1.0)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    lo = v - hi
    np.testing.assert_array_equal(hi + lo, v)
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()


# -- cached row statistics ----------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine", "pearson"])
def test_cached_stats_leave_the_plain_distance_unchanged(metric):
    xs, qs = _rows(500, 40, 3)
    xs[5] = 0.0
    x, q = torch.from_numpy(xs), torch.from_numpy(qs)
    st = tdist.row_stats(x, metric)
    assert st.shape == (500, 2) and st.dtype == torch.float32
    assert torch.equal(tdist.distance_matrix(x, q, metric, xstats=st),
                       tdist.distance_matrix(x, q, metric))
    np.testing.assert_allclose(tdist.distance_matrix(x, q, metric).numpy(),
                               _reference(xs, qs, metric), atol=ATOL,
                               rtol=RTOL)
    # a block's slice of the statistics is that block's
    assert torch.equal(tdist.row_stats(x[100:300], metric), st[100:300])


def test_row_stats_only_for_the_metrics_that_read_them():
    x = torch.zeros(3, 4)
    for metric in ("dot", "manhattan", "chebyshev", "hamming", "jaccard"):
        assert tdist.row_stats(x, metric) is None
    with pytest.raises(ValueError):
        tdist.row_stats_plain(x, "dot")


def _store_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    xs[3] = 0.0  # a zero row
    valid = np.ones(n, np.uint8)
    valid[rng.choice(n, n // 20, replace=False)] = 0  # tombstones
    valid[3] = 1
    qs = (xs[rng.integers(0, n, 6)]
          + 0.1 * rng.normal(size=(6, d))).astype(np.float32)
    qs[0] = xs[3] + 0.01  # near the zero row
    return xs, valid, qs


@pytest.fixture()
def hosts(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    return ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu")


@pytest.mark.parametrize("metric,block_rows", [
    ("pearson", 1 << 20), ("pearson", 300), ("manhattan", 300)])
def test_exact_and_blocked_stores_with_cached_stats(hosts, metric,
                                                    block_rows):
    ref, port = hosts
    xs, valid, qs = _store_rows(1000, 24, 11)
    cfg = dict(CFG, block_rows=block_rows)
    meta = {"key": "vec/x", "tag": [1], "metric": metric, "mink_p": 3.0,
            "cfg": cfg}
    for h in hosts:
        assert h.handle("vec_load", dict(meta), [xs, valid])[0] == "ok"
    k = 8
    (rt, rm, rb) = ref.handle("vec_knn", {"key": "vec/x", "tag": [1],
                                          "k": k + 1}, [qs])
    (pt, pm, pb) = port.handle("vec_knn", {"key": "vec/x", "tag": [1],
                                           "k": k}, [qs])
    assert rt == pt == "ok"
    assert_knn_match(rb[0], rb[1], pb[0], pb[1], k)
    assert valid[pb[1]].all()
    store = port.vec["vec/x"][1]
    if metric == "pearson":
        assert store.device_xstats is not None
        assert torch.equal(store.device_xstats,
                           tdist.row_stats_plain(store.device_vecs, metric))
    else:
        assert store.device_xstats is None


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "pearson"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_mesh_exact_store_with_cached_stats(metric, ndev):
    xs, valid, qs = _store_rows(257, 16, 5)
    valid = valid.astype(bool)
    k = 10
    port = port_mesh.MeshVecStore("k", xs, valid, metric, 3.0, CFG, ndev,
                                  devices=[torch.device("cpu")] * ndev)
    pm, pb = port.knn(qs, k)
    assert pm == {"mode": "pairs", "rank_mode": None, "mesh_ndev": ndev}
    for sh in port._dev:
        assert torch.equal(sh["xstats"],
                           tdist.row_stats_plain(sh["rows"], metric))
    if metric == "pearson":
        # the reference's mesh store serves the MXU metrics only: pearson
        # is held to its distance_matrix + top_k
        d = _reference(xs, qs, metric)
        d = np.where(valid[None, :], d, np.inf)
        rd, ri = (np.asarray(a) for a in jtopk.top_k_smallest(
            jnp.asarray(d), k + 1))
    else:
        ref = ref_mesh.MeshVecStore("k", xs, valid, metric, 3.0, CFG, ndev)
        rm, (rd, ri) = ref.knn(qs, k + 1)
    assert_knn_match(rd, ri, pb[0], pb[1], k)
