"""The port's int8 ranking store against the JAX package on the same
inputs: the quantisation (bit for bit), `knn_rank_int8` (scores and
candidate ids), the int8 `VecStore` arrays and its `vec_knn` candidate
replies, and the large-k case of the exact select.

On the CPU every wrapper runs its plain PyTorch version. The reference
runs with `jax.device_count` patched to 1 (its single-device branches,
the ones the port has), and its `approx_max_k` lowers to an exact
selection on the CPU (tests/test_torch_ops.py checks that), so the
candidates must agree exactly wherever their scores are not tied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu.device import handlers as ref_handlers
from surrealdb_tpu.device.vecstore import VecStore as RefVecStore
from surrealdb_tpu.ops import topk as jtopk
from surrealdb_tpu_torch.device import handlers as port_handlers
from surrealdb_tpu_torch.device.vecstore import VecStore as PortVecStore
from surrealdb_tpu_torch.ops import topk as ttopk

from test_torch_device import CFG, _same, both

METRICS = ["euclidean", "cosine", "dot"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _store(metric, n=3000, d=96, seed=11, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(dtype)
    valid = rng.random(n) > 0.05  # tombstones
    return xs, valid, rng


def _ref_int8(xs, metric):
    """The reference's int8 store arrays (its VecStore, forced to int8
    by a small hbm budget)."""
    st = RefVecStore("k", xs, np.ones(len(xs), bool), metric, 3.0,
                     dict(CFG, hbm_budget=1))
    st.ensure()
    assert st.rank_mode == "int8"
    return (np.asarray(st.device_rank), np.asarray(st.device_arow),
            np.asarray(st.device_x2))


def _ref_scores(x8, arow, x2, valid, qs, metric):
    """knn_rank_int8's scores before its candidate stage, in jnp, with
    the reference's formulas (ops/topk.py:161-175)."""
    qs = jnp.asarray(qs)
    sq = 127.0 / jnp.maximum(jnp.abs(qs).max(axis=1), 1e-30)
    q8 = jnp.round(qs * sq[:, None]).astype(jnp.int8)
    dots = jnp.einsum("nd,bd->bn", jnp.asarray(x8), q8,
                      preferred_element_type=jnp.int32)
    approx = dots.astype(jnp.float32) * (jnp.asarray(arow)[None, :]
                                         / sq[:, None])
    score = (jnp.asarray(x2)[None, :] - 2.0 * approx
             if metric == "euclidean" else -approx)
    return np.asarray(jnp.where(jnp.asarray(valid)[None, :], score,
                                jnp.inf))


def assert_ids_match_except_ties(scores, ref_ids, got_ids, rtol=1e-6):
    """Ids equal at every position whose score differs from both of its
    neighbours' (scores [R, N] from which the candidates came)."""
    ref_ids = np.asarray(ref_ids)
    got_ids = np.asarray(got_ids)
    assert ref_ids.shape == got_ids.shape
    for r in range(ref_ids.shape[0]):
        s = np.sort(scores[r])[: ref_ids.shape[1] + 1].astype(np.float64)
        tol = rtol * np.maximum(np.abs(s), 1e-30)
        gap = np.diff(s)
        for j in range(ref_ids.shape[1]):
            lo = j == 0 or gap[j - 1] > tol[j]
            hi = j + 1 >= len(s) or gap[j] > tol[j]
            if lo and hi:
                assert got_ids[r, j] == ref_ids[r, j], (r, j)


@pytest.fixture()
def one_device(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("metric", METRICS)
def test_int8_store_arrays_bit_equal(one_device, metric, dtype):
    xs, valid, _ = _store(metric, dtype=dtype)
    rx8, rarow, rx2 = _ref_int8(xs, metric)
    st = PortVecStore("k", xs, valid.astype(np.uint8), metric, 3.0,
                      dict(CFG, hbm_budget=1), "cpu")
    st.ensure()
    assert st.rank_mode == "int8"
    x8 = st.device_rank.numpy()
    assert x8.shape == (3000, ttopk.int8_width(96))
    np.testing.assert_array_equal(x8[:, :96], rx8)
    assert not x8[:, 96:].any()
    np.testing.assert_array_equal(st.device_arow.numpy(), rarow)
    np.testing.assert_array_equal(st.device_x2.numpy(), rx2)


def test_quantize_odd_width_pads_with_zero_columns():
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(50, 37)).astype(np.float32)
    xs[3] = 0.0  # a zero row: scale floors at 1e-30, no NaN
    x8, arow, x2 = ttopk.quantize_rows_plain(_t(xs), "cosine", 48)
    assert x8.shape == (50, 48) and not x8[:, 37:].any()
    assert torch.isfinite(arow).all() and not x8[3].any()
    assert not x2.any()


@pytest.mark.parametrize("metric", METRICS)
def test_knn_rank_int8_matches_reference(one_device, metric):
    xs, valid, rng = _store(metric)
    x8, arow, x2 = _ref_int8(xs, metric)
    qs_r = rng.normal(size=(2, 4, 96)).astype(np.float32)
    kc = 64
    ref = np.asarray(jtopk.knn_rank_int8(
        jnp.asarray(x8), jnp.asarray(arow), jnp.asarray(x2),
        jnp.asarray(valid), jnp.asarray(qs_r), kc, metric))
    x8p = torch.nn.functional.pad(_t(x8), (0, ttopk.int8_width(96) - 96))
    got = ttopk.knn_rank_int8(x8p, _t(arow), _t(x2), _t(valid),
                              _t(qs_r), kc, metric).numpy()
    assert got.shape == ref.shape == (2, 4, kc) and got.dtype == np.int32
    for r in range(2):
        scores = _ref_scores(x8, arow, x2, valid, qs_r[r], metric)
        port = ttopk.rank_int8(x8p, _t(qs_r[r]), metric, _t(arow), _t(x2),
                               _t(valid)).numpy()
        np.testing.assert_allclose(port, scores, rtol=1e-6, atol=0)
        assert_ids_match_except_ties(scores, ref[r], got[r])
    assert valid[got].all()


@pytest.mark.parametrize("metric", METRICS)
def test_probe_order_is_the_descent_probes(metric):
    """probe_order=True dequantises as the ANN probe does:
    dots * (arow * (1 / sq))."""
    xs, _valid, rng = _store(metric, n=500, d=32)
    x8, arow = (np.rint(xs * 20).clip(-127, 127).astype(np.int8),
                rng.random(500).astype(np.float32) + 0.5)
    x2 = rng.random(500).astype(np.float32) * 10
    qs = rng.normal(size=(5, 32)).astype(np.float32)
    jq = jnp.asarray(qs)
    sq = 127.0 / jnp.maximum(jnp.abs(jq).max(axis=1), 1e-30)
    q8 = jnp.round(jq * sq[:, None]).astype(jnp.int8)
    pd = jnp.einsum("pd,bd->bp", jnp.asarray(x8), q8,
                    preferred_element_type=jnp.int32).astype(jnp.float32) \
        * (jnp.asarray(arow)[None, :] * (1.0 / sq)[:, None])
    want = np.asarray(jnp.asarray(x2)[None, :] - 2.0 * pd
                      if metric == "euclidean" else -pd)
    got = ttopk.rank_int8(_t(x8), _t(qs), metric, _t(arow), _t(x2),
                          probe_order=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dim", [48, 37, 3072])
@pytest.mark.parametrize("metric", METRICS)
def test_vec_knn_cand_replies_match(one_device, metric, dim):
    hosts = (ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu"))
    xs, valid, rng = _store(metric, n=2500, d=dim, seed=3)
    meta = {"key": f"vec/{metric}", "tag": [1, 2], "metric": metric,
            "cfg": dict(CFG, hbm_budget=2500 * dim)}
    _same(*both(hosts, "vec_load", meta, [xs, valid.astype(np.uint8)]))
    for b, k in ((1, 1), (5, 3)):
        qs = rng.normal(size=(b, dim)).astype(np.float32)
        (rt, rm, rb), (pt, pm, pb) = both(
            hosts, "vec_knn", {"key": meta["key"], "tag": [1, 2], "k": k},
            [qs])
        assert rt == pt == "ok" and pm == rm
        assert rm == {"mode": "cand", "rank_mode": "int8", "mesh_ndev": 1,
                      "kc": max(128 * k, k + 16)}
        assert pb[0].dtype == np.int32 and pb[0].shape == rb[0].shape
        st = hosts[1].vec[meta["key"]][1]
        scores = ttopk.rank_int8(st.device_rank, _t(qs), metric,
                                 st.device_arow, st.device_x2,
                                 st.device_valid).numpy()
        assert_ids_match_except_ties(scores, rb[0], pb[0])
    (_, rs, _), (_, ps, _) = both(hosts, "status", {})
    for key in ("vec_blocks", "vec_bytes", "mem_used"):
        assert ps[key] == rs[key], key


def test_large_k_select_matches_reference():
    """k = 5000 is past the select kernel's shared-memory buffer; the
    selection (the plain version on the CPU) still equals lax.top_k,
    ties to the lower index."""
    rng = np.random.default_rng(17)
    vals = rng.normal(size=(3, 20_000)).astype(np.float32)
    vals[1, ::7] = 0.25  # a block of ties across the k-th position
    vals[2] = np.round(vals[2], 1)
    rv, ri = jtopk.top_k_smallest(jnp.asarray(vals), 5000)
    gv, gi = ttopk.top_k_smallest(_t(vals), 5000)
    assert ttopk.SELECT_MAX_K < 5000
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
