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


# -- one pass over the store for a whole frame (int8_candidates) -------------

def _frame_case(metric, n=20_000, d=48, seed=21):
    """A store with duplicated rows (ties at the kc-th score: query 0 is
    one of them), tombstones, and 9 queries."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    xs[100:180] = xs[7]
    valid = rng.random(n) > 0.05
    qs = rng.normal(size=(9, d)).astype(np.float32)
    qs[0] = xs[7]
    x8, arow, x2 = ttopk.quantize_rows_plain(_t(xs), metric,
                                             ttopk.int8_width(d))
    return x8, arow, x2, valid, qs


def _ref_candidates(x8, arow, x2, valid, qs, kc, metric):
    d = qs.shape[1]
    return np.asarray(jtopk.knn_rank_int8(
        jnp.asarray(x8[:, :d].numpy()), jnp.asarray(arow.numpy()),
        jnp.asarray(x2.numpy()), jnp.asarray(valid), jnp.asarray(qs[None]),
        kc, metric))[0]


FRAME_CASES = {
    # (store rows, rows kept valid, cap): what the stats must show
    "threshold": (40_000, None, None),
    "overflow": (40_000, None, 100),
    "no_finite_threshold": (40_000, (256, 356), None),
    "small_store": (20_000, None, None),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
@pytest.mark.parametrize("metric", METRICS)
def test_int8_candidates_match_reference(one_device, metric, case):
    """int8_candidates equals the reference's knn_rank_int8 id for id:
    through the sample threshold and the candidates pass, with a small
    cap that forces the overflow path, with every valid row outside
    the sample (T = +inf: the count overflows), and on a store too small
    for the sample (the chunked path)."""
    n, keep, cap = FRAME_CASES[case]
    x8, arow, x2, valid, qs = _frame_case(metric, n=n)
    if keep is not None:
        valid[:] = False
        valid[keep[0]:keep[1]] = True
    kc = 64
    st = {}
    got = ttopk.int8_candidates(x8, arow, x2, _t(valid), _t(qs), kc, metric,
                                cap=cap, stats=st).numpy()
    ref = _ref_candidates(x8, arow, x2, valid, qs, kc, metric)
    assert got.dtype == np.int32 and got.shape == (9, kc)
    np.testing.assert_array_equal(got, ref)
    plain = ttopk.int8_candidates_plain(x8, arow, x2, _t(valid), _t(qs), kc,
                                        metric, cap=cap).numpy()
    np.testing.assert_array_equal(plain, got)
    counts = st["counts"].numpy()
    if case == "small_store":
        assert st["chunked"] == 9 and st["S"] == 0
        return
    assert st["chunked"] == 0 and st["S"] >= ttopk.INT8_SAMPLE_PER_KC * kc
    assert st["S"] % ttopk.INT8_TILE == 0 and (counts >= kc).all()
    if case == "threshold":
        assert st["overflow"] == 0 and (counts <= st["cap"]).all()
    elif case == "overflow":
        assert st["cap"] == 100
        assert st["overflow"] == int((counts > 100).sum()) > 0
    else:
        assert st["overflow"] == 9 and (counts == n).all()


@pytest.mark.parametrize("metric", METRICS)
def test_int8_one_pass_equals_chunked_path(monkeypatch, metric):
    """The one-pass path and the chunked path give the same candidates,
    id for id, on one store: the shape rule (INT8_SAMPLE_PER_KC, which
    `trace_mesh.py --sample-per-kc` moves to time either path) picks a
    path, never an answer."""
    x8, arow, x2, valid, qs = _frame_case(metric, n=40_000)
    st = {}
    one = ttopk.int8_candidates(x8, arow, x2, _t(valid), _t(qs), 64, metric,
                                stats=st)
    assert st["chunked"] == 0 and st["S"] > 0
    monkeypatch.setattr(ttopk, "INT8_SAMPLE_PER_KC", 1 << 30)
    st = {}
    chunked = ttopk.int8_candidates(x8, arow, x2, _t(valid), _t(qs), 64,
                                    metric, stats=st)
    assert st["chunked"] == 9 and st["S"] == 0
    np.testing.assert_array_equal(one.numpy(), chunked.numpy())


def test_int8_candidate_plan_sizes():
    """The threshold sample and buffer at the north-star frame: S = 2^19
    rows for 512 queries over 10M, a 2^17 buffer (4x the expected 24.4k
    survivors), 512 MiB of pairs under the chunked path's 2 GiB."""
    s, step, cap = ttopk.int8_candidate_plan(10_000_000, 512, 1280, 1 << 28)
    assert (s, cap) == (1 << 19, 1 << 17) and step == 19
    assert ttopk.int8_query_group(10_000_000, 512, 1280, 1 << 28) == 512
    # 2048 queries would need an 8 GiB buffer: two groups of 1024 (2 GiB
    # each, the chunked path's f32 scores and int32 dots)
    assert ttopk.int8_query_group(10_000_000, 2048, 1280, 1 << 28) == 1024
    # B = 1: S = N / 8 in whole tiles
    s1, _, _ = ttopk.int8_candidate_plan(10_000_000, 1, 1280, 1 << 28)
    assert s1 == (10_000_000 // 8) // 256 * 256
    # a 250k-row mesh shard: S = 31,232 < 64 kc, the chunked path for
    # the whole batch at once (it chunks by the budget itself)
    assert ttopk.int8_candidate_plan(250_000, 512, 1280, 1 << 28) is None
    assert ttopk.int8_candidate_plan(250_000, 1, 1280, 1 << 28) is None
    assert ttopk.int8_query_group(250_000, 512, 1280, 1 << 28) == 512
    rows = ttopk.int8_sample_rows(3 * 256, 5)
    assert rows[255] == 255 and rows[256] == 5 * 256 and len(rows) == 768


@pytest.mark.parametrize("metric", METRICS)
def test_vec_knn_frame_matches_reference(one_device, metric):
    """vec_knn "cand" replies of the int8 store through DeviceHost("cpu")
    equal the reference's, id for id, at batch sizes whose old query
    chunks differed, with the threshold path engaged."""
    hosts = (ref_handlers.DeviceHost(), port_handlers.DeviceHost("cpu"))
    n, dim = 70_000, 48
    xs, valid, rng = _store(metric, n=n, d=dim, seed=8)
    xs[300:360] = xs[11]
    meta = {"key": f"vec/{metric}", "tag": [1, 2], "metric": metric,
            "cfg": dict(CFG, hbm_budget=n * dim)}
    _same(*both(hosts, "vec_load", meta, [xs, valid.astype(np.uint8)]))
    for b in (1, 17, 64):
        qs = rng.normal(size=(b, dim)).astype(np.float32)
        qs[0] = xs[11]
        assert ttopk.int8_candidate_plan(n, b, 128,
                                         CFG["score_budget"] // 2)
        (rt, rm, rb), (pt, pm, pb) = both(
            hosts, "vec_knn", {"key": meta["key"], "tag": [1, 2], "k": 1},
            [qs])
        assert rt == pt == "ok" and pm == rm and pm["kc"] == 128
        np.testing.assert_array_equal(pb[0], rb[0])


def test_pair_select_plain_orders_by_value_then_id():
    """The pair helpers: order keys round-trip, packed pairs select by
    (value, id) whatever their order in the row, short rows give
    (+inf, -1)."""
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(np.round(rng.normal(size=(3, 500)), 1)
                            .astype(np.float32))
    vals[0, :3] = torch.tensor([-0.0, 0.0, float("inf")])
    keys = ttopk.order_key_plain(vals)
    back = ttopk.key_value_plain(keys)
    assert torch.equal(back, torch.where(vals == 0, 0.0, vals))
    ids = torch.from_numpy(rng.permutation(500)).repeat(3, 1)
    pairs = ttopk.pack_pairs_plain(keys, ids)
    counts = torch.tensor([500, 400, 20], dtype=torch.int32)
    gv, gi = ttopk.top_k_pairs_plain(pairs, counts, 30)
    for r in range(2):
        m = int(counts[r])
        order = np.lexsort((ids[r, :m].numpy(), vals[r, :m].numpy()))[:30]
        np.testing.assert_array_equal(gi[r].numpy(), ids[r, :m][order])
        np.testing.assert_array_equal(gv[r].numpy(), vals[r, :m][order])
    assert (gi[2] == -1).all() and torch.isinf(gv[2]).all()


def test_select_plan_splits_few_rows():
    """Few rows over many entries split over blocks (about two per SM);
    rows that fill the card, or short rows, take one block each."""
    assert ttopk.select_plan(132, 10_000_000, 1280, 132) == (1, 0)
    assert ttopk.select_plan(16, 20_000, 1280, 132) == (1, 0)
    assert ttopk.select_plan(1, 250_000, 1280, 132) == (1, 0)
    g, cap = ttopk.select_plan(16, 10_000_000, 1280, 132)
    assert g == 17 and cap == ttopk.SELECT_GATHER_MIN
    g, cap = ttopk.select_plan(1, 1_250_000, 5120, 132)
    assert g == 1_250_000 // ttopk.SELECT_BLOCK_MIN and cap == 65536
    assert ttopk.select_plan(2, 1_000_000, 26, 132)[0] == 61
