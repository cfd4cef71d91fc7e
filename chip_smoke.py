#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (a phase that fails raises and the script
exits non-zero):

1. card    -- the `nvidia-smi` name and power limit of the card;
2. build   -- builds the CUDA kernels (csrc/*.cu, one nvcc each, in
              parallel) into build/torch_kernels/;
3. kernels -- every kernel of the path against its plain PyTorch version
              on the card, at a small shape and at the shape the path
              gives it, with the stated tolerance; times the kernel, the
              plain version and, where one exists, a single PyTorch call
              computing the same function (a yardstick the port never
              calls);
4. runner  -- spawns `python -m surrealdb_tpu_torch.device.runner` (CUDA)
              through the port's supervisor client and sends it frames:
              knn1m (1M x 768 cosine rows, bf16 rank + f32 rescore store,
              vec_knn at B in 1/128/512, recall@10 against an exact f64
              oracle), brute (brute_knn over 20k x 128 cosine rows) and
              graph3hop (1M nodes / 10M edges, 3-hop csr_hop at B in 1/8,
              frontier and union, bit-equal to the plain version). Each
              path runs with the runner's launch counts set to 0 just
              before it and read just after.

It then prints the card line again, one JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core
# and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

KNN1M = dict(n=1_000_000, dim=768, seed=13, batches=(1, 128, 512), k=10)
BRUTE = dict(n=20_000, dim=128, seed=17, k=10)
GRAPH = dict(nodes=1_000_000, edges=10_000_000, seed=19, batches=(1, 8),
             hops=3)

SOURCES = {
    "distance_tile": ("surrealdb_tpu_torch/csrc/distance.cu",
                      "surrealdb_tpu/ops/distance.py:35"),
    "select_topk_rows": ("surrealdb_tpu_torch/csrc/select.cu",
                         "surrealdb_tpu/ops/topk.py:13"),
    "rank_scores_bf16": ("surrealdb_tpu_torch/csrc/rank_rescore.cu",
                         "surrealdb_tpu/ops/topk.py:78"),
    "gather_rescore": ("surrealdb_tpu_torch/csrc/rank_rescore.cu",
                       "surrealdb_tpu/ops/topk.py:78"),
    "csr_hop_step": ("surrealdb_tpu_torch/csrc/csr_hop.cu",
                     "surrealdb_tpu/device/csrstore.py:14"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, ops, peak):
    """Least time (ms) the card could take: the larger of bytes over
    the HBM rate and operations over the peak rate of their type."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.device import compile_cache, kernelstats
    from surrealdb_tpu_torch.device.csrstore import (
        csr_hop_step, multi_hop_masks, multi_hop_plain,
    )
    from surrealdb_tpu_torch.device.supervisor import DeviceSupervisor
    from surrealdb_tpu_torch.ops import distance as D
    from surrealdb_tpu_torch.ops import topk as T

    # the plain versions are the references: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def cuda_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def max_err(a, b, atol, rtol, what):
        """Max |a - b| over finite entries; the +inf pattern must match
        and every entry lie within atol + rtol*|b|."""
        a, b = a.float(), b.float()
        inf_a, inf_b = torch.isinf(a), torch.isinf(b)
        check(torch.equal(inf_a, inf_b), f"{what}: +inf pattern differs")
        fin = ~inf_b
        diff = (a[fin] - b[fin]).abs()
        if diff.numel() == 0:
            return 0.0
        ok = bool((diff <= atol + rtol * b[fin].abs()).all())
        err = float(diff.max())
        check(ok, f"{what}: max error {err} over atol={atol} rtol={rtol}")
        return err

    def check_ids(ref_d, ref_i, got_i, what, atol=1e-4):
        """Ids equal wherever the reference's neighbouring distances
        differ by more than atol (near-ties may swap)."""
        ref_d = np.asarray(ref_d, np.float64)
        with np.errstate(invalid="ignore"):
            gap = np.diff(ref_d, axis=1) > atol
        sep = np.isfinite(ref_d)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        check((np.asarray(got_i) == np.asarray(ref_i))[sep].all(),
              f"{what}: ids differ")

    kern = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": 0.0}
            for name, (src, rep) in SOURCES.items()}

    def note(name, err=None, **fields):
        k = kern[name]
        if err is not None:
            k["max_abs_err"] = max(k["max_abs_err"], err)
        k.update(fields)

    # -- 1. card ----------------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    emit("card", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    st = compile_cache.ensure_built()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=st["build_s"], dir=st["dir"], built=st["built"])

    # -- 3. kernels against their plain versions ---------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    # distance_tile: nine metrics at a small shape, then the brute path's
    tol_d = (1e-4, 1e-5)
    for metric in D.METRIC_CODE:
        xs = torch.randn(3000, 37, generator=g)
        qs = torch.randn(5, 37, generator=g)
        if metric == "jaccard":
            xs, qs = xs.abs(), qs.abs()
        if metric == "hamming":
            xs, qs = xs.round(), qs.round()
        valid = (torch.rand(3000, generator=g) > 0.1).to(dev)
        xs, qs = xs.to(dev), qs.to(dev)
        err = max_err(D.distance_tile(xs, qs, metric, 2.5, valid),
                      D.distance_matrix_plain(xs, qs, metric, 2.5, valid),
                      *tol_d, f"distance_tile {metric}")
        note("distance_tile", err)
    # the blocked exact scan: the same two kernels over 65536-row blocks
    xs = torch.randn(150_000, 24, generator=g).to(dev)
    qs = torch.randn(6, 24, generator=g).to(dev)
    valid = (torch.rand(150_000, generator=g) > 0.1).to(dev)
    bd, bi = T.knn_search_blocked(xs, qs, 64, "manhattan", 3.0, valid)
    pd, pi = T.top_k_smallest_plain(
        D.distance_matrix_plain(xs, qs, "manhattan", 3.0, valid), 64)
    note("distance_tile", max_err(bd, pd, *tol_d, "knn_search_blocked"))
    check_ids(pd.cpu().numpy(), pi.cpu().numpy(), bi.cpu().numpy(),
              "knn_search_blocked")
    rng = np.random.default_rng(BRUTE["seed"])
    bxs_np = rng.normal(size=(BRUTE["n"], BRUTE["dim"])).astype(np.float32)
    bq_np = rng.normal(size=(1, BRUTE["dim"])).astype(np.float32)
    bxs, bq = torch.from_numpy(bxs_np).to(dev), torch.from_numpy(bq_np).to(dev)
    err = max_err(D.distance_tile(bxs, bq, "cosine"),
                  D.distance_matrix_plain(bxs, bq, "cosine"), *tol_d,
                  "distance_tile cosine 1x20000x128")
    b_, n_, d_ = 1, BRUTE["n"], BRUTE["dim"]
    bms, bby = bound(4 * (n_ * d_ + b_ * d_ + b_ * n_), 2 * b_ * n_ * d_,
                     PEAK_F32)
    note("distance_tile", err,
         ms=cuda_ms(lambda: D.distance_tile(bxs, bq, "cosine"), 50),
         plain_ms=cuda_ms(
             lambda: D.distance_matrix_plain(bxs, bq, "cosine"), 50),
         library_ms=cuda_ms(lambda: torch.nn.functional.cosine_similarity(
             bxs, bq, dim=1), 50),
         bound_ms=bms, bound_by=bby,
         shape=f"B={b_} N={n_} D={d_} cosine")
    emit("kernel", name="distance_tile", tol=tol_d,
         max_abs_err=kern["distance_tile"]["max_abs_err"],
         ms=kern["distance_tile"]["ms"])

    # select_topk_rows: ties, k up to 1280, exact equality with the
    # stable-sort plain version
    ties = torch.zeros(3, 100_000, device=dev)
    ties[1, ::3] = -1.0
    for k in (1, 26, 1280):
        v, i = T.select_topk_rows(ties, k)
        pv, pi = T.top_k_smallest_plain(ties, k)
        check(torch.equal(i, pi) and torch.equal(v, pv),
              f"select_topk_rows ties k={k}")
    check(torch.equal(T.select_topk_rows(ties, 1280)[1][0].cpu(),
                      torch.arange(1280, dtype=torch.int32)),
          "select_topk_rows: ties must go to the lower index")
    for k in (1, 10, 64, 1280):
        vals = torch.randn(4, 5000, generator=g).to(dev)
        v, i = T.select_topk_rows(vals, k)
        pv, pi = T.top_k_smallest_plain(vals, k)
        check(torch.equal(i, pi) and torch.equal(v, pv),
              f"select_topk_rows k={k}")

    # the knn1m store (also shipped to the runner below)
    n, dim = KNN1M["n"], KNN1M["dim"]
    rng = np.random.default_rng(KNN1M["seed"])
    t0 = time.perf_counter()
    xs_np = rng.standard_normal((n, dim), dtype=np.float32)
    qs_np = rng.standard_normal((max(KNN1M["batches"]), dim),
                                dtype=np.float32)
    gen_s = time.perf_counter() - t0
    full = torch.from_numpy(xs_np).to(dev)
    norms = torch.cat([torch.linalg.norm(full[s:s + 65536].double(), dim=1)
                       for s in range(0, n, 65536)]).float().clamp_min(1e-30)
    rank = (full / norms[:, None]).to(torch.bfloat16)
    qs = torch.from_numpy(qs_np).to(dev)
    c = qs.shape[0]
    k = KNN1M["k"]
    kc = max(2 * k, k + 16)

    # rank_scores_bf16 at the path's shape (C=512 queries over 1M x 768)
    tol_r = (1e-3, 1e-5)  # f32 sums of 768 exact bf16 products, reordered
    score = T.rank_scores_bf16(rank, qs, "cosine")
    plain = T.rank_scores_plain(rank, qs, "cosine")
    err = max_err(score, plain, *tol_r, "rank_scores_bf16 512x1Mx768")
    del plain
    small_x = torch.randn(3000, 64, generator=g).to(dev)
    small_q = torch.randn(70, 64, generator=g).to(dev)
    small_v = (torch.rand(3000, generator=g) > 0.1).to(dev)
    small_x2 = (small_x * small_x).sum(1)
    for metric in ("euclidean", "dot"):
        e2 = max_err(T.rank_scores_bf16(small_x.bfloat16(), small_q, metric,
                                        small_x2, small_v),
                     T.rank_scores_plain(small_x.bfloat16(), small_q,
                                         metric, small_x2, small_v),
                     *tol_r, f"rank_scores_bf16 {metric} small")
        err = max(err, e2)
    rms, rby = bound(2 * n * dim + 4 * c * dim + n + 4 * c * n,
                     2 * c * n * dim, PEAK_BF16)
    qb = qs.to(torch.bfloat16)
    note("rank_scores_bf16", err,
         ms=cuda_ms(lambda: T.rank_scores_bf16(rank, qs, "cosine"), 5),
         plain_ms=cuda_ms(lambda: T.rank_scores_plain(rank, qs, "cosine"),
                          3),
         library_ms=cuda_ms(lambda: torch.mm(qb, rank.T), 5),
         bound_ms=rms, bound_by=rby, shape=f"C={c} N={n} D={dim} cosine")
    emit("kernel", name="rank_scores_bf16", tol=tol_r, max_abs_err=err,
         ms=kern["rank_scores_bf16"]["ms"])

    # select_topk_rows at the path's candidate stage: kc of 1M per query
    cv, cand = T.select_topk_rows(score, kc)
    pv, pcand = T.top_k_smallest_plain(score, kc)
    check(torch.equal(cand, pcand) and torch.equal(cv, pv),
          "select_topk_rows 512x1M kc=26")
    sms, sby = bound(4 * c * n + 8 * c * kc, c * n, PEAK_F32)
    note("select_topk_rows", 0.0,
         ms=cuda_ms(lambda: T.select_topk_rows(score, kc), 5),
         plain_ms=cuda_ms(lambda: T.top_k_smallest_plain(score, kc), 3),
         library_ms=cuda_ms(lambda: torch.topk(score, kc, dim=1,
                                                largest=False), 5),
         bound_ms=sms, bound_by=sby, shape=f"R={c} N={n} k={kc}")
    emit("kernel", name="select_topk_rows", tol=[0, 0], max_abs_err=0.0,
         ms=kern["select_topk_rows"]["ms"])
    del score, pv, pcand

    # gather_rescore at the path's shape, with a mask
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[::41] = False
    tol_g = (1e-4, 1e-5)
    err = max_err(T.gather_rescore_cuda(full, qs, cand, "cosine", norms,
                                        valid),
                  T.gather_rescore_plain(full, qs, cand, "cosine", norms,
                                         valid),
                  *tol_g, "gather_rescore cosine 512x26x768")
    for metric in ("euclidean", "dot"):
        e2 = max_err(T.gather_rescore_cuda(full, qs, cand, metric, norms),
                     T.gather_rescore_plain(full, qs, cand, metric, norms),
                     *tol_g, f"gather_rescore {metric}")
        err = max(err, e2)
    gms, gby = bound(4 * c * kc * dim + 4 * c * dim + 4 * c * kc * 3
                     + c * kc, 2 * c * kc * dim, PEAK_F32)
    note("gather_rescore", err,
         ms=cuda_ms(lambda: T.gather_rescore_cuda(full, qs, cand, "cosine",
                                                  norms, valid), 20),
         plain_ms=cuda_ms(lambda: T.gather_rescore_plain(
             full, qs, cand, "cosine", norms, valid), 20),
         library_ms=None, bound_ms=gms, bound_by=gby,
         shape=f"C={c} kc={kc} D={dim} cosine")
    emit("kernel", name="gather_rescore", tol=tol_g, max_abs_err=err,
         ms=kern["gather_rescore"]["ms"])
    del cand, cv, valid

    # csr_hop_step on the 1M-node / 10M-edge graph
    nn_, ne = GRAPH["nodes"], GRAPH["edges"]
    rng = np.random.default_rng(GRAPH["seed"])
    src_np = rng.integers(0, nn_, size=ne).astype(np.int32)
    dst_np = rng.integers(0, nn_, size=ne).astype(np.int32)
    rows, cols = torch.from_numpy(src_np).to(dev), torch.from_numpy(
        dst_np).to(dev)
    starts = {}
    for b in GRAPH["batches"]:
        s = torch.zeros(b, nn_, dtype=torch.bool, device=dev)
        s[torch.arange(b), torch.arange(b)] = True
        starts[b] = s
        for union in (False, True):
            check(torch.equal(
                multi_hop_masks(rows, cols, s, GRAPH["hops"], union),
                multi_hop_plain(rows, cols, s, GRAPH["hops"], union)),
                f"csr multi-hop B={b} union={union} not bit-equal")
    b = max(GRAPH["batches"])
    front = multi_hop_plain(rows, cols, starts[b], 2, False).to(torch.uint8)
    nxt = torch.zeros_like(front)
    csr_hop_step(rows, cols, front, nxt)
    want = multi_hop_plain(rows, cols, front, 1, False)
    check(torch.equal(nxt.bool(), want), "csr_hop_step not bit-equal")
    contrib = front.bool()[:, rows.long()].to(torch.int32)
    cols_l = cols.long()

    def hop_kernel():
        out = torch.zeros_like(front)
        csr_hop_step(rows, cols, front, out)

    hms, hby = bound(8 * ne + 2 * b * nn_, b * ne, PEAK_F32)
    note("csr_hop_step", 0.0,
         ms=cuda_ms(hop_kernel, 20),
         plain_ms=cuda_ms(lambda: multi_hop_plain(rows, cols, front, 1,
                                                  False), 10),
         library_ms=cuda_ms(lambda: torch.zeros(
             (b, nn_), dtype=torch.int32, device=dev).index_add_(
                 1, cols_l, contrib), 10),
         bound_ms=hms, bound_by=hby, shape=f"B={b} n={nn_} E={ne}")
    emit("kernel", name="csr_hop_step", tol=[0, 0], max_abs_err=0.0,
         ms=kern["csr_hop_step"]["ms"])
    del contrib, cols_l, front, nxt, want
    torch.cuda.empty_cache()

    # -- 4. the runner as a server ----------------------------------------------
    sup = DeviceSupervisor(device="cuda")
    try:
        ready = sup.start()
        check(ready["platform"] == "cuda", f"runner platform {ready}")
        emit("runner", ready=ready, pid=sup.runner_pid())
        launches = {name: 0 for name in kernelstats.KERNELS}

        def drive(name, fn):
            sup.call("launch_counts", {"reset": True})
            out = fn()
            _, m, _ = sup.call("launch_counts", {})
            for kname, v in m["launches"].items():
                launches[kname] += v
            emit(name, **out, launches=m["launches"])

        def knn1m():
            cfg = cnf.device_cfg()
            key, tag = "vec/b/b/tbl/ix", [1, 0]
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, lambda: (
                "vec_load", {"metric": "cosine", "mink_p": 3.0, "cfg": cfg},
                [xs_np, np.ones(n, np.uint8)]))
            out = {"rows": n, "dim": dim, "gen_s": round(gen_s, 3),
                   "load_s": round(time.perf_counter() - t0, 3)}
            results = {}
            for bsz in KNN1M["batches"]:
                meta = {"key": key, "tag": tag, "k": k}
                t, m, bufs = sup.call("vec_knn", meta, [qs_np[:bsz]])
                check(t == "ok" and m["rank_mode"] == "bf16",
                      f"vec_knn {t} {m}")
                iters = 5
                t0 = time.perf_counter()
                for _ in range(iters):
                    _, _, bufs = sup.call("vec_knn", meta, [qs_np[:bsz]])
                ms = (time.perf_counter() - t0) * 1e3 / iters
                d, ids = bufs
                check(d.shape == ids.shape == (bsz, k)
                      and np.isfinite(d).all()
                      and ((ids >= 0) & (ids < n)).all(),
                      f"vec_knn B={bsz} result shape/values")
                results[bsz] = (d, ids)
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
            # recall@10 of the first 16 queries against an exact f64 oracle
            nq = 16
            q64 = qs[:nq].double()
            sims = torch.cat([
                (full[s:s + 65536].double() @ q64.T)
                / norms[s:s + 65536, None].double()
                for s in range(0, n, 65536)])
            oracle = torch.topk(sims, k, dim=0).indices.T.cpu().numpy()
            got = results[max(KNN1M["batches"])][1][:nq]
            recall = np.mean([len(set(a) & set(b)) / k
                              for a, b in zip(oracle, got)])
            check(recall >= 0.99, f"knn1m recall@10 {recall} < 0.99")
            # the same 16 queries through the plain versions on the card
            ps = T.rank_scores_plain(rank, qs[:nq], "cosine")
            _, pc = T.top_k_smallest_plain(ps, kc)
            pdd = T.gather_rescore_plain(full, qs[:nq], pc, "cosine", norms)
            pd, pi = T.top_k_smallest_plain(pdd, k, ids=pc)
            d16, i16 = results[max(KNN1M["batches"])]
            pd, pi = pd.cpu().numpy(), pi.cpu().numpy()
            check(np.allclose(d16[:nq], pd, atol=1e-4, rtol=1e-5),
                  "knn1m distances differ from the plain pipeline")
            check_ids(pd, pi, i16[:nq], "knn1m vs the plain pipeline")
            out["recall_at_10"] = float(recall)
            return out

        def brute():
            meta = {"k": BRUTE["k"], "metric": "cosine", "p": 3.0}
            _, _, bufs = sup.call("brute_knn", meta, [bxs_np, bq_np])
            iters = 20
            t0 = time.perf_counter()
            for _ in range(iters):
                _, _, bufs = sup.call("brute_knn", meta, [bxs_np, bq_np])
            ms = (time.perf_counter() - t0) * 1e3 / iters
            pd, pi = T.knn_search(bxs, bq, BRUTE["k"], "cosine")
            check(np.array_equal(bufs[1], pi.cpu().numpy()),
                  "brute ids differ from the kernel path in-process")
            dd, ii = T.top_k_smallest_plain(
                D.distance_matrix_plain(bxs, bq, "cosine"), BRUTE["k"])
            check(np.allclose(bufs[0], dd.cpu().numpy(), atol=1e-4,
                              rtol=1e-5), "brute distances vs plain")
            return {"rows": BRUTE["n"], "dim": BRUTE["dim"], "ms": ms,
                    "ids_equal_plain": bool(np.array_equal(
                        bufs[1], ii.cpu().numpy()))}

        def graph3hop():
            key, tag = "csr/b/b/person/knows/out", [1]
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, lambda: (
                "csr_load", {"n_nodes": nn_}, [src_np, dst_np]))
            out = {"nodes": nn_, "edges": ne,
                   "load_s": round(time.perf_counter() - t0, 3)}
            for bsz in GRAPH["batches"]:
                start = starts[bsz].to(torch.uint8).cpu().numpy()
                for union in (False, True):
                    meta = {"key": key, "tag": tag, "hops": GRAPH["hops"],
                            "union": union}
                    sup.call("csr_hop", meta, [start])
                    iters = 3
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        _, _, bufs = sup.call("csr_hop", meta, [start])
                    ms = (time.perf_counter() - t0) * 1e3 / iters
                    want = multi_hop_plain(rows, cols, starts[bsz],
                                           GRAPH["hops"], union)
                    check(np.array_equal(bufs[0], want.to(
                        torch.uint8).cpu().numpy()),
                        f"graph3hop B={bsz} union={union} not bit-equal")
                    tagn = "union" if union else "frontier"
                    out[f"B{bsz}_{tagn}_ms"] = ms
                    out[f"B{bsz}_{tagn}_reached"] = int(bufs[0].sum())
            return out

        drive("knn1m", knn1m)
        drive("brute", brute)
        drive("graph3hop", graph3hop)
        _, stat, _ = sup.call("status", {})
        check(stat["platform"] == "cuda", "status platform")
        emit("status", platform=stat["platform"],
             mem_used=stat["mem_used"], vec_bytes=stat["vec_bytes"],
             csr_bytes=stat["csr_bytes"], vec_blocks=stat["vec_blocks"],
             csr_blocks=stat["csr_blocks"],
             compile_cache=stat["compile_cache"])
    finally:
        sup.shutdown()
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the path")
        kern[name]["launches"] = count
    emit("done", seconds=round(time.perf_counter() - t_start, 3))

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    print(card, flush=True)
    print(json.dumps({"kernels": [{key: kern[n][key] for key in keys}
                                  for n in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
