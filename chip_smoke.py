#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (a phase that fails raises and the script
exits non-zero):

1. card    -- the `nvidia-smi` name and power limit of the card;
2. build   -- builds the CUDA kernels (csrc/*.cu, one nvcc each, in
              parallel) into build/torch_kernels/;
3. kernels -- every kernel of the path against its plain PyTorch version
              on the card, at edge shapes (ragged, odd, tied, short)
              and at the shape the path gives it, with the stated
              tolerance; times the kernel, the
              plain version and, where one exists, a single PyTorch call
              computing the same function (a yardstick the port never
              calls). The int8 store's one pass for a whole frame
              (int8_candidates: threshold sample, candidates pass, final
              select of pairs) is held id-equal to its plain version,
              with duplicated rows, tombstones and a sorted store whose
              small buffer forces the overflow path, and for all 512
              queries over the 10M store to the chunked path; its S, cap,
              overflow count and survivor counts are printed;
4. runner  -- spawns `python -m surrealdb_tpu_torch.device.runner` (CUDA)
              through the port's supervisor client and sends it frames:
              knn1m (1M x 768 cosine rows, bf16 rank + f32 rescore store,
              vec_knn at B in 1/128/512, recall@10 against an exact f64
              oracle, one rank, one candidate select and one fused
              rescore a query chunk), brute (brute_knn over 20k x 128 cosine rows),
              graph3hop (1M nodes / 10M edges, 3-hop csr_hop at B in 1/8,
              frontier and union, bit-equal to the plain version), knn10m
              (10M x 768 cosine rows: the int8 rank store, vec_knn at B in
              1/128/512 answering kc = 1280 candidates, equal to the
              chunked path's for every query, one candidates pass a B=512
              frame and no overflow, rescored exactly here, recall@10
              against an exact f64 oracle) and ann (the
              graph-ANN store over 250k x 768 clustered cosine rows, built
              here, shipped in parts, ann_search at B in 1/128/512,
              recall@10, ids equal to the plain descent and unchanged after
              a drop and a reship). Each path runs with the runner's
              launch counts set to 0 just before it and read just after;
5. supervisor -- after that runner has shut down, a supervisor in mode
              auto (5 s dispatch window, probes every 0.5 s, promotion
              after 2) starts a runner and ships the knn1m store in
              parts: 8 threads' 64-query vec_knn frames equal the
              sequential answers (frames/s printed for both); a 50 ms
              query budget on a SIGSTOPped runner unwinds in under 0.2 s
              and leaves it serving; a SIGSTOP with no budget is a wedge
              (the call raises after the window, the runner is killed,
              the state degrades and comes back ready); a SIGKILL under
              the 8-thread load gives each frame its answer or
              DeviceUnavailable, the state degrades and recovers, the
              store ships again and answers as before (recovery_s,
              reship_s, wedge_detect_s, budget_unwind_s);
6. mesh    -- after those runners have shut down, runners started with
              `--mesh-devices 4` (four logical devices: shard s on
              cuda:(s % device_count), all four on one card when there is
              one, so the times measure partition and merge, not
              scaling), SURREAL_DEVICE_MESH set per runner: mesh_knn1m
              (auto: the knn1m store self-shards through
              sharded_rank_rescore; ids as knn1m's, recall@10 1.0),
              then under force mesh_exact (the same rows as a MeshVecStore,
              exact pairs; ids as one device's exact scan, recall@10
              1.0), mesh_int8 (the same rows, int8 candidates equal to a
              one-device int8 store's wherever scores are not tied,
              recall@10 >= 0.95 after an exact rescore), mesh_ann (the ann
              index in 4 slices; ids equal to `search_seq`, also after a
              drop and a reship; recall@10 printed) and mesh_graph3hop
              (the graph in 4 edge slices; masks bit-equal to graph3hop's).

It then prints the card line again, one JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, it exits non-zero before printing any result.

    python3 chip_smoke.py --only distance,csr,cand,ann,pairs,rescore,supervisor

runs the card and build phases and only the named checks of the
kernels phase (distance: distance_tile on both routes, its invariances
and its times at the exact stores' shapes; csr: csr_hop_step; cand:
rank_candidates_int8 at edge shapes and its times at a knn10m frame's
shapes, over a 10M-row store made on the card; ann: ann_descent bit for
bit at edge shapes and its times on the ann store, whose host build is
kept under $CHIP_SMOKE_CACHE, default build/, for the next run; pairs:
select_topk_pairs bit for bit at edge shapes and on the pairs of a
knn10m frame's candidates pass at B = 1, 128 and 512 over such a store,
with its times; rescore: gather_rescore in both modes at edge shapes,
its times at a knn1m frame's shapes, and the knn1m store's B = 512
answers, saved under $CHIP_SMOKE_CACHE or held to the saved ones;
supervisor: phase 5 alone, over knn1m's rows made here), then stops
without a result line. Each kernel row gives the time by CUDA
events over back-to-back calls and, for the pair select and the
rescore, the profiler's device time alone. It also runs from an older
checkout's root (copied there), whose distance_tile takes no row
statistics, whose candidates pass has one route and whose rescore has
no fused top k, to time that checkout's kernels at the same shapes.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core
# and bf16 / int8 / TF32 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_TF32 = 495e12

KNN1M = dict(n=1_000_000, dim=768, seed=13, batches=(1, 128, 512), k=10)
BRUTE = dict(n=20_000, dim=128, seed=17, k=10)
GRAPH = dict(nodes=1_000_000, edges=10_000_000, seed=19, batches=(1, 8),
             hops=3)
# BASELINE config 3 (bench.py:613 bench_knn10m): the int8 rank store
KNN10M = dict(n=10_000_000, dim=768, seed=31, batches=(1, 128, 512), k=10,
              recall_q=8)
# bench.py:750 bench_ann10m at that function's own reduced size: the
# graph is built here by the port's numpy builder on the host
ANN = dict(n=250_000, dim=768, seed=31, std=0.15, noise=0.075,
           batches=(1, 128, 512), k=10, recall_q=16)

# the supervisor phase: a runner in mode auto over the knn1m store,
# `threads` clients of `frame`-query vec_knn frames, `rounds` frames each
SUP = dict(threads=8, frame=64, rounds=8, window_s=5.0, probe_s=0.5,
           promote=2, budget_s=0.05, unwind_limit_s=0.2, kill_after_s=0.5)

SOURCES = {
    "distance_tile": ("surrealdb_tpu_torch/csrc/distance.cu",
                      "surrealdb_tpu/ops/distance.py:35"),
    # distance_tile's two routes and the stores' row statistics
    "distance_tile_tf32": ("surrealdb_tpu_torch/csrc/distance.cu",
                           "surrealdb_tpu/ops/distance.py:35"),
    "distance_tile_simt": ("surrealdb_tpu_torch/csrc/distance.cu",
                           "surrealdb_tpu/ops/distance.py:35"),
    "distance_row_stats": ("surrealdb_tpu_torch/csrc/distance.cu",
                           "surrealdb_tpu/ops/distance.py:35"),
    "select_topk_rows": ("surrealdb_tpu_torch/csrc/select.cu",
                         "surrealdb_tpu/ops/topk.py:13"),
    "rank_scores_bf16": ("surrealdb_tpu_torch/csrc/rank_rescore.cu",
                         "surrealdb_tpu/ops/topk.py:78"),
    "gather_rescore": ("surrealdb_tpu_torch/csrc/rank_rescore.cu",
                       "surrealdb_tpu/ops/topk.py:78"),
    # its launches with the reference's final top k fused in
    "gather_rescore_topk": ("surrealdb_tpu_torch/csrc/rank_rescore.cu",
                            "surrealdb_tpu/ops/topk.py:120"),
    "csr_hop_step": ("surrealdb_tpu_torch/csrc/csr_hop.cu",
                     "surrealdb_tpu/device/csrstore.py:14"),
    "quantize_rows_int8": ("surrealdb_tpu_torch/csrc/rank_int8.cu",
                           "surrealdb_tpu/device/vecstore.py:150"),
    "rank_scores_int8": ("surrealdb_tpu_torch/csrc/rank_int8.cu",
                         "surrealdb_tpu/ops/topk.py:145"),
    "rank_candidates_int8": ("surrealdb_tpu_torch/csrc/rank_int8.cu",
                             "surrealdb_tpu/ops/topk.py:145"),
    "select_topk_pairs": ("surrealdb_tpu_torch/csrc/select.cu",
                          "surrealdb_tpu/ops/topk.py:174"),
    "ann_descent": ("surrealdb_tpu_torch/csrc/ann_descent.cu",
                    "surrealdb_tpu/device/annstore.py:29"),
    "merge_partials_topk": ("surrealdb_tpu_torch/csrc/mesh_merge.cu",
                            "surrealdb_tpu/device/mesh.py:203"),
    "mask_or_reduce": ("surrealdb_tpu_torch/csrc/mesh_merge.cu",
                       "surrealdb_tpu/device/mesh.py:733"),
}
# the mesh phases: four logical devices, shards of the stores above
MESH = dict(ndev=4, int8_budget=512 << 20)
# int8 rows wider than the 2048 columns a query tile holds at once
WIDE = dict(n=200_000, dim=3072, c=16)
# a mesh_exact shard (knn1m's rows over four devices) and the one-device
# exact store's largest unblocked scan (cnf KNN_BLOCK_ROWS)
MESH_EXACT_SHARD = (250_000, 768)
BLOCK_ROWS = 262_144


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


def normal_rows(n, dim, seed, threads=8):
    """i.i.d. N(0, 1) f32 rows [n, dim] from `threads` independent
    streams of SeedSequence(seed); numpy fills without the GIL, so the
    streams run in parallel (a 30 GB store in seconds, not minutes)."""
    out = np.empty((n, dim), np.float32)
    gens = [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(threads)]
    step = -(-n // threads)

    def fill(i):
        gens[i].standard_normal(out=out[i * step:(i + 1) * step],
                                dtype=np.float32)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(fill, range(threads)))
    return out


def clustered_rows(n, dim, nc, std, seed, chunk=1_000_000):
    """bench.py's `_clustered_rows`: `nc` gaussian clusters (the low
    intrinsic dimension of real embeddings)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(nc, dim)).astype(np.float32)
    xs = np.empty((n, dim), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        xs[s:e] = centers[rng.integers(0, nc, e - s)]
        xs[s:e] += std * rng.normal(size=(e - s, dim)).astype(np.float32)
    return xs, rng


def build_ann_index(cache=None):
    """The ann phase's store, built on the host as the serving side
    builds it: clustered rows, queries near them, the port's CAGRA
    graph and int8 rows (cosine: x2q is zeros). With `cache` (a file
    path) the index without its f32 rows is read from there, or built
    and written there."""
    from surrealdb_tpu_torch.idx import cagra

    if cache is not None and os.path.exists(cache):
        with np.load(cache) as z:
            return dict({k: z[k] for k in z.files}, gen_s=0.0, build_s=0.0)
    t0 = time.perf_counter()
    xs, rng = clustered_rows(ANN["n"], ANN["dim"], ANN["n"] // 100,
                             ANN["std"], ANN["seed"])
    qi = rng.integers(0, ANN["n"], max(ANN["batches"]))
    qs = xs[qi] + ANN["noise"] * rng.normal(
        size=(len(qi), ANN["dim"])).astype(np.float32)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x2, norms = cagra.row_stats(xs)
    graph = cagra.build_graph(xs, "cosine", x2=x2, norms=norms)
    x8, arow = cagra.quantize_int8(xs, "cosine", norms=norms)
    out = {"xs": xs, "qs": qs, "graph": graph, "x8": x8, "arow": arow,
           "x2q": np.zeros(ANN["n"], np.float32), "gen_s": gen_s,
           "build_s": time.perf_counter() - t0}
    if cache is not None:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, **{k: out[k] for k in ("qs", "graph", "x8", "arow",
                                               "x2q")})
    return out


def port_source_hash() -> str:
    """sha256 (16 hex digits) of the port's sources beside this script
    (surrealdb_tpu_torch/**/*.py, .cu, .cuh, .h): which tree wrote a
    saved answer."""
    import hashlib

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "surrealdb_tpu_torch")
    h = hashlib.sha256()
    for base, dirs, files in sorted(os.walk(root)):
        dirs.sort()
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh", ".h")):
                full = os.path.join(base, name)
                h.update(os.path.relpath(full, root).encode())
                with open(full, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def bound(nbytes, ops, peak):
    """Least time (ms) the card could take: the larger of bytes over
    the HBM rate and operations over the peak rate of their type."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    checks = ("distance", "csr", "cand", "ann", "pairs", "rescore",
              "supervisor")
    ap.add_argument("--only", default=None,
                    help="comma list of kernels-phase checks to run alone "
                         f"({', '.join(checks)})")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    if only and set(only) - set(checks):
        ap.error(f"unknown checks {only}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.device import annstore as A
    from surrealdb_tpu_torch.device import compile_cache, kernelstats
    from surrealdb_tpu_torch.device import mesh as DM
    from surrealdb_tpu_torch.device.csrstore import (
        csr_hop_step, multi_hop_masks, multi_hop_plain,
    )
    from surrealdb_tpu_torch.device.supervisor import DeviceSupervisor
    from surrealdb_tpu_torch.device.vecstore import VecStore
    from surrealdb_tpu_torch.ops import distance as D
    from surrealdb_tpu_torch.ops import merge as MG
    from surrealdb_tpu_torch.ops import topk as T

    # the runner phases time frames with no warm-up frames queued
    # beside them: only the supervisor phase keeps the serving prewarm
    prewarm = cnf.DEVICE_PREWARM_BUCKETS, cnf.DEVICE_PREWARM_HOPS
    cnf.DEVICE_PREWARM_BUCKETS = cnf.DEVICE_PREWARM_HOPS = ""
    # the plain versions are the references: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # the serving side's descent knobs and candidate count for k
    # (idx/vector.py _ann_search_cfg, _ann_knn_batch) at the defaults
    ann_cfg = cnf.ann_search_cfg()
    ann_kc = min(ANN["n"], max(cnf.KNN_ANN_OVERSAMPLE * ANN["k"], 32))

    def cuda_ms(fn, iters=10, keep=None):
        """ms a call (CUDA events over `iters` calls after a warm one);
        `keep`, a list, receives the warm call's result."""
        out = fn()
        if keep is not None:
            keep.append(out)
            # the kept output's memory is not the allocator's to hand
            # out again: a second warm call caches a block for the timed
            # calls, which would otherwise time a cudaMalloc
            fn()
        del out
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

    def check_ids(ref_d, ref_i, got_i, what, atol=1e-4, rtol=0.0):
        """Ids equal wherever the reference's neighbouring distances
        differ by more than atol + rtol*|d| (near-ties may swap)."""
        ref_d = np.asarray(ref_d, np.float64)
        with np.errstate(invalid="ignore"):
            gap = np.diff(ref_d, axis=1) > (
                atol + rtol * np.abs(ref_d[:, 1:]))
        sep = np.isfinite(ref_d)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        check((np.asarray(got_i) == np.asarray(ref_i))[sep].all(),
              f"{what}: ids differ")

    def check_pairs(kp, kn, pp, pn, what):
        """A candidates pass against its plain version: equal counts,
        and per query whose count fits the buffer the same set of
        (order key, row) pairs (the kernel appends them in no order)."""
        check(torch.equal(kn, pn), f"{what}: counts differ")
        cap_ = kp.shape[1]
        fit = pn <= cap_
        used = (torch.arange(cap_, device=kp.device)[None, :]
                < pn.clamp(max=cap_)[:, None])
        for s0 in range(0, kp.shape[0], 64):
            f_, u_ = fit[s0:s0 + 64], used[s0:s0 + 64]
            a = torch.sort(torch.where(u_, kp[s0:s0 + 64], -1)).values
            b = torch.sort(torch.where(u_, pp[s0:s0 + 64], -1)).values
            check(torch.equal(a[f_], b[f_]),
                  f"{what}: pairs differ in queries {s0}..{s0 + 63}")

    kern = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": 0.0}
            for name, (src, rep) in SOURCES.items()}

    def note(name, err=None, **fields):
        k = kern[name]
        if err is not None:
            k["max_abs_err"] = max(k["max_abs_err"], err)
        k.update(fields)

    # -- the distance and hop kernels' checks (also `--only`) -------------------
    tol_d = (1e-4, 1e-5)
    # a parent checkout's distance_tile takes no row statistics and has
    # one route (its `--only` runs time it at the same shapes)
    has_stats = hasattr(D, "row_stats")

    def dist(xs, qs, metric, p=3.0, valid=None, st=None):
        if has_stats:
            return D.distance_tile(xs, qs, metric, p, valid, st)
        return D.distance_tile(xs, qs, metric, p, valid)

    def gemm_bound(b_, n_, d_):
        """An f32-accurate product on the tensor cores: the 4(ND + BD +
        BN) bytes against 3 x 2BND TF32 operations (3xTF32)."""
        return bound(4 * (n_ * d_ + b_ * d_ + b_ * n_), 6 * b_ * n_ * d_,
                     PEAK_TF32)

    def lib_ms(fn, iters):
        # the yardsticks are full f32 products
        check(torch.backends.cuda.matmul.allow_tf32 is False,
              "allow_tf32 must be False for the library times")
        return cuda_ms(fn, iters)

    def distance_checks():
        g = torch.Generator(device="cpu").manual_seed(0)
        # (rows, dim, queries): D = 37 on the CUDA cores only; 4, 40, 100
        # and 768 on the tensor cores for the product metrics (ragged k
        # steps, 1 to 3 query tiles of 8..128, rows past a 256-row tile)
        n_small = 0
        for n_, d_, b_ in ((3000, 37, 5), (1000, 4, 1), (3001, 40, 9),
                           (700, 100, 300), (2999, 768, 130)):
            for metric in D.METRIC_CODE:
                xs = torch.randn(n_, d_, generator=g)
                qs = torch.randn(b_, d_, generator=g)
                xs[7] = 0.0  # a zero row: the 1e-30 clamp
                if metric == "jaccard":
                    xs, qs = xs.abs(), qs.abs()
                if metric == "hamming":
                    xs, qs = xs.round(), qs.round()
                valid = (torch.rand(n_, generator=g) > 0.1).to(dev)
                xs, qs = xs.to(dev), qs.to(dev)
                want = D.distance_matrix_plain(xs, qs, metric, 2.5, valid)
                what = f"distance_tile {metric} {n_}x{d_} B={b_}"
                note("distance_tile", max_err(dist(xs, qs, metric, 2.5,
                                                   valid), want, *tol_d,
                                              what))
                if has_stats and metric in D.STAT_METRICS:
                    st = D.row_stats(xs, metric)
                    max_err(st, D.row_stats_plain(xs, metric), 1e-4, 1e-5,
                            f"distance_row_stats {metric} {n_}x{d_}")
                    note("distance_tile", max_err(
                        dist(xs, qs, metric, 2.5, valid, st), want, *tol_d,
                        what + " cached stats"))
                n_small += 1
        # a shard's distances are the whole store's columns, and a query's
        # do not depend on the batch around it: bit for bit, both routes
        n_inv = 0
        for metric, d_ in (("cosine", 768), ("euclidean", 768),
                           ("pearson", 768), ("dot", 128), ("cosine", 37),
                           ("manhattan", 128)):
            xs = torch.randn(20_000, d_, generator=g).to(dev)
            qs = torch.randn(140, d_, generator=g).to(dev)
            st = D.row_stats(xs, metric) if has_stats else None
            whole = dist(xs, qs, metric, st=st)
            for a_, b_ in ((0, 256), (1, 19_999), (4_321, 12_345),
                           (19_000, 20_000)):
                part = dist(xs[a_:b_], qs, metric,
                            st=None if st is None else st[a_:b_])
                check(torch.equal(part, whole[:, a_:b_]),
                      f"distance_tile {metric} D={d_}: rows {a_}:{b_} "
                      f"differ from the whole store's")
                if st is not None:
                    check(torch.equal(dist(xs[a_:b_], qs, metric),
                                      whole[:, a_:b_]),
                          f"distance_tile {metric} D={d_}: per-call stats")
                n_inv += 1
            for bq_ in (1, 8, 9, 64, 100):
                check(torch.equal(dist(xs, qs[:bq_], metric, st=st),
                                  whole[:bq_]),
                      f"distance_tile {metric} D={d_}: B={bq_} differs "
                      f"from B=140")
                n_inv += 1
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
        # the blocked scan is a host loop over the two kernels (no cell of
        # this script reaches it through the runner): its time at this
        # shape
        nb_, bb_, db_ = xs.shape[0], qs.shape[0], xs.shape[1]
        emit("kernel", name="knn_search_blocked",
             shape=f"B={bb_} N={nb_} D={db_} k=64 manhattan block=65536",
             ms=cuda_ms(lambda: T.knn_search_blocked(xs, qs, 64, "manhattan",
                                                     3.0, valid), 5),
             plain_ms=cuda_ms(lambda: T.top_k_smallest_plain(
                 D.distance_matrix_plain(xs, qs, "manhattan", 3.0, valid),
                 64), 5),
             bound_ms=bound(4 * nb_ * db_ + nb_ + 4 * bb_ * db_
                            + 8 * bb_ * 64, 3 * bb_ * nb_ * db_,
                            PEAK_F32)[0])
        # the brute path's shape (B=1 N=20000 D=128 cosine)
        rng = np.random.default_rng(BRUTE["seed"])
        bxs_np = rng.normal(size=(BRUTE["n"], BRUTE["dim"])).astype(
            np.float32)
        bq_np = rng.normal(size=(1, BRUTE["dim"])).astype(np.float32)
        bxs = torch.from_numpy(bxs_np).to(dev)
        bq = torch.from_numpy(bq_np).to(dev)
        err = max_err(dist(bxs, bq, "cosine"),
                      D.distance_matrix_plain(bxs, bq, "cosine"), *tol_d,
                      "distance_tile cosine 1x20000x128")
        b_, n_, d_ = 1, BRUTE["n"], BRUTE["dim"]
        bms, bby = gemm_bound(b_, n_, d_)
        note("distance_tile", err,
             ms=cuda_ms(lambda: dist(bxs, bq, "cosine"), 50),
             plain_ms=cuda_ms(
                 lambda: D.distance_matrix_plain(bxs, bq, "cosine"), 50),
             library_ms=cuda_ms(
                 lambda: torch.nn.functional.cosine_similarity(
                     bxs, bq, dim=1), 50),
             bound_ms=bms, bound_by=bby,
             shape=f"B={b_} N={n_} D={d_} cosine")
        emit("kernel", name="distance_tile", tol=tol_d,
             max_abs_err=kern["distance_tile"]["max_abs_err"],
             ms=kern["distance_tile"]["ms"], small_shapes_checked=n_small,
             invariance_checked=n_inv)

        # the exact stores' shapes: a mesh_exact shard (250k rows) at the
        # frames' batches, the one-device exact store at block_rows
        gd = torch.Generator(device=dev).manual_seed(5)

        def timed_row(metric, n_, d_, b_, library, label, entry=None):
            xs = torch.randn(n_, d_, generator=gd, device=dev)
            qs = torch.randn(b_, d_, generator=gd, device=dev)
            valid = torch.ones(n_, dtype=torch.bool, device=dev)
            valid[::97] = False
            st = D.row_stats(xs, metric) if has_stats else None
            err = max_err(dist(xs, qs, metric, 3.0, valid, st),
                          D.distance_matrix_plain(xs, qs, metric, 3.0,
                                                  valid),
                          *tol_d, f"distance_tile {metric} B={b_} N={n_} "
                                  f"D={d_}")
            iters = 5 if b_ >= 128 else 20
            if metric in ("euclidean", "cosine", "dot", "pearson"):
                bms, bby = gemm_bound(b_, n_, d_)
            else:
                bms, bby = bound(4 * (n_ * d_ + b_ * d_ + b_ * n_),
                                 3 * b_ * n_ * d_, PEAK_F32)
            lib = library(xs, qs)
            row = dict(
                shape=f"B={b_} N={n_} D={d_} {metric}", max_abs_err=err,
                ms=cuda_ms(lambda: dist(xs, qs, metric, 3.0, valid, st),
                           iters),
                plain_ms=cuda_ms(lambda: D.distance_matrix_plain(
                    xs, qs, metric, 3.0, valid), 3),
                library_ms=lib_ms(lib, iters), library=label,
                bound_ms=bms, bound_by=bby,
                route=D.tile_route(xs, metric) if has_stats else "cuda")
            emit("kernel", name="distance_tile", **row)
            if entry is not None and has_stats:
                note(entry, err, **{k_: row[k_] for k_ in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")})
            return xs

        def normalised(x, centre=False):
            if centre:
                x = x - x.mean(1, keepdim=True)
            return x / x.norm(dim=1, keepdim=True).clamp_min(1e-30)

        def mm_normalised(centre):
            def make(xs, qs):
                xn, qn = normalised(xs, centre), normalised(qs, centre)
                return lambda: torch.mm(qn, xn.T)
            return make

        n0, d0 = MESH_EXACT_SHARD
        for b_ in KNN1M["batches"]:
            xs = timed_row("cosine", n0, d0, b_, mm_normalised(False),
                           "torch.mm f32 over normalised rows, product only",
                           "distance_tile_tf32" if b_ == 512 else None)
        timed_row("euclidean", n0, d0, 512,
                  lambda xs, qs: lambda: torch.cdist(qs, xs),
                  "torch.cdist")
        timed_row("dot", n0, d0, 128,
                  lambda xs, qs: lambda: torch.mm(qs, xs.T), "torch.mm f32")
        timed_row("pearson", BLOCK_ROWS, d0, 128, mm_normalised(True),
                  "torch.mm f32 over centred normalised rows, product only")
        timed_row("manhattan", BLOCK_ROWS, 128, 128,
                  lambda xs, qs: lambda: torch.cdist(qs, xs, p=1),
                  "torch.cdist p=1", "distance_tile_simt")
        if has_stats:
            # the store's row statistics, once a store
            st = D.row_stats(xs, "cosine")
            note("distance_row_stats",
                 max_err(st, D.row_stats_plain(xs, "cosine"), 1e-4, 1e-5,
                         "distance_row_stats cosine"),
                 shape=f"N={n0} D={d0} cosine",
                 ms=cuda_ms(lambda: D.row_stats(xs, "cosine"), 20),
                 plain_ms=cuda_ms(lambda: D.row_stats_plain(xs, "cosine"),
                                  5),
                 library_ms=cuda_ms(lambda: torch.linalg.norm(xs, dim=1),
                                    20),
                 **dict(zip(("bound_ms", "bound_by"), bound(
                     4 * n0 * d0 + 8 * n0, 2 * n0 * d0, PEAK_F32))))
            emit("kernel", **{k_: kern["distance_row_stats"][k_] for k_ in (
                "name", "shape", "ms", "plain_ms", "library_ms",
                "bound_ms")})
        del xs
        torch.cuda.empty_cache()
        return bxs_np, bq_np, bxs, bq

    def csr_checks():
        """csr_hop_step bit-equal to the plain hops: the 1M-node / 10M-edge
        graph at B = 1, 8 and 64 (two words a node), a small graph with
        duplicate edges and self-loops at B = 1..64, union on and off;
        then the time of one hop at B = 8 (the path's) and 64."""
        g = torch.Generator(device="cpu").manual_seed(3)
        nn_, ne = GRAPH["nodes"], GRAPH["edges"]
        rng = np.random.default_rng(GRAPH["seed"])
        src_np = rng.integers(0, nn_, size=ne).astype(np.int32)
        dst_np = rng.integers(0, nn_, size=ne).astype(np.int32)
        rows, cols = torch.from_numpy(src_np).to(dev), torch.from_numpy(
            dst_np).to(dev)
        starts = {}
        for b in GRAPH["batches"] + (64,):
            s = torch.zeros(b, nn_, dtype=torch.bool, device=dev)
            s[torch.arange(b), torch.arange(b)] = True
            starts[b] = s
            for union in (False, True):
                check(torch.equal(
                    multi_hop_masks(rows, cols, s, GRAPH["hops"], union),
                    multi_hop_plain(rows, cols, s, GRAPH["hops"], union)),
                    f"csr multi-hop B={b} union={union} not bit-equal")
        sr = np.random.default_rng(7)
        sn, se = 5000, 40_000
        srows = sr.integers(0, sn, se).astype(np.int32)
        scols = sr.integers(0, sn, se).astype(np.int32)
        srows[1::9], scols[1::9] = srows[::9][:len(srows[1::9])], \
            scols[::9][:len(scols[1::9])]  # duplicate edges
        scols[::13] = srows[::13]  # self-loops
        srows_t, scols_t = (torch.from_numpy(a_).to(dev)
                            for a_ in (srows, scols))
        n_small = 0
        for b in (1, 3, 8, 40, 64):
            s = torch.rand(b, sn, generator=g) > 0.998
            s = s.to(dev)
            for hops in (1, 3):
                for union in (False, True):
                    check(torch.equal(
                        multi_hop_masks(srows_t, scols_t, s, hops, union),
                        multi_hop_plain(srows_t, scols_t, s, hops, union)),
                        f"csr small graph B={b} hops={hops} union={union}")
                    n_small += 1
        b = max(GRAPH["batches"])
        front = multi_hop_plain(rows, cols, starts[b], 2, False).to(
            torch.uint8)
        nxt = torch.zeros_like(front)
        csr_hop_step(rows, cols, front, nxt)
        want = multi_hop_plain(rows, cols, front, 1, False)
        check(torch.equal(nxt.bool(), want), "csr_hop_step not bit-equal")
        cols_l = cols.long()
        for b_ in (b, 64):
            fr = multi_hop_plain(rows, cols, starts[b_], 2, False).to(
                torch.uint8)
            contrib = fr.bool()[:, rows.long()].to(torch.int32)

            def hop_kernel():
                out = torch.zeros_like(fr)
                csr_hop_step(rows, cols, fr, out)

            hms, hby = bound(8 * ne + 2 * b_ * nn_, b_ * ne, PEAK_F32)
            row = dict(
                ms=cuda_ms(hop_kernel, 20),
                plain_ms=cuda_ms(lambda: multi_hop_plain(rows, cols, fr, 1,
                                                         False), 5),
                library_ms=cuda_ms(lambda: torch.zeros(
                    (b_, nn_), dtype=torch.int32, device=dev).index_add_(
                        1, cols_l, contrib), 5),
                bound_ms=hms, bound_by=hby,
                shape=f"B={b_} n={nn_} E={ne}",
                frontier_nodes=int(fr.sum()))
            if b_ == b:
                note("csr_hop_step", 0.0, **{k_: v_ for k_, v_ in row.items()
                                             if k_ != "frontier_nodes"})
            emit("kernel", name="csr_hop_step", tol=[0, 0], max_abs_err=0.0,
                 small_graph_cases=n_small, **row)
            del contrib, fr
        del cols_l, front, nxt, want
        starts.pop(64)
        torch.cuda.empty_cache()
        return nn_, ne, src_np, dst_np, rows, cols, starts

    # -- the candidates pass's and the descent's checks (also `--only`) -------
    # what an `--only` run keeps for the next (an index built on the
    # host, a parent checkout's answers)
    cache_dir = os.environ.get("CHIP_SMOKE_CACHE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    # a parent checkout (copied there) has no candidates_plan: one route
    cand_plan = getattr(T, "candidates_plan", None)

    def cand_inputs(x8, arow, valid, qs, kc):
        """A frame's candidates-pass inputs as int8_topk makes them: the
        quantised queries, each query's kc-th score of the threshold
        sample, the buffer size."""
        s_rows, s_step, cap_ = T.int8_candidate_plan(x8.shape[0],
                                                     qs.shape[0], kc, 1 << 28)
        q8, qsc = T.int8_query_scratch(qs.shape[0], x8.shape[1], dev)
        ss = T.rank_scores_int8(x8, qs, "cosine", arow, None, valid,
                                sample=(s_rows, s_step), q8=q8, qscale=qsc)
        thr = T.select_topk_rows(ss, kc)[0][:, kc - 1].contiguous()
        return q8, qsc, thr, cap_

    def cand_edge_checks():
        """rank_candidates_int8 against its plain version (check_pairs):
        C = 1..512 (clusters of 1 to 4 blocks, a partial last slab) over
        100,003 rows (no whole number of 128- or 256-row tiles) with
        masked rows, both metrics, T at the 64th or 16th score, one
        query's T +inf (every row survives: the inline path, and a count
        past the buffer), one -inf, and a buffer that only the 16th-score
        queries fit; then the other widths' routes (48: one k-step,
        1024: four stages, 3072: the streamed route)."""
        gc = torch.Generator(device=dev).manual_seed(11)
        n_chk = 0
        for d_, n_, cs in ((768, 100_003, (1, 16, 65, 128, 129, 257, 512)),
                           (48, 20_011, (1, 65, 300)),
                           (1024, 20_011, (64, 200)),
                           (3072, 20_011, (16, 65))):
            xs = torch.randn(n_, d_, generator=gc, device=dev)
            valid = torch.rand(n_, generator=gc, device=dev) > 0.05
            for metric in ("cosine", "euclidean"):
                x8 = torch.empty((n_, d_), dtype=torch.int8, device=dev)
                a8 = torch.empty((n_,), dtype=torch.float32, device=dev)
                x2 = torch.zeros((n_,), dtype=torch.float32, device=dev)
                T.quantize_rows_int8(xs, metric, x8, a8, x2)
                for c_ in cs:
                    qs = torch.randn(c_, d_, generator=gc, device=dev)
                    q8, qsc = T.int8_query_scratch(c_, d_, dev)
                    sc = T.rank_scores_int8(x8, qs, metric, a8, x2, valid,
                                            q8=q8, qscale=qsc)
                    top = T.top_k_smallest_plain(sc, 64)[0]
                    thr = torch.where(torch.arange(c_, device=dev) % 2 == 0,
                                      top[:, 63], top[:, 15]).contiguous()
                    del sc, top
                    if c_ > 2:
                        thr[c_ // 2] = float("inf")
                        thr[1] = float("-inf")
                    for cap_ in (4096, 40):
                        kp, kn = T.rank_candidates_int8(
                            x8, q8, qsc, metric, a8, x2, valid, thr, cap_)
                        pp, pn = T.rank_candidates_plain(
                            x8, qs, metric, a8, x2, valid, thr, cap_)
                        plan = cand_plan(c_, d_) if cand_plan else None
                        check_pairs(kp, kn, pp, pn,
                                    f"rank_candidates_int8 {metric} C={c_} "
                                    f"N={n_} D={d_} cap={cap_} plan={plan}")
                        n_chk += 1
                del x8, a8, x2
        emit("kernel", name="rank_candidates_int8", tol=[0, 0],
             edge_shapes_checked=n_chk)
        torch.cuda.empty_cache()

    def cand_path_rows(x8, arow, valid, qs, kc):
        """The candidates pass at a knn10m frame's shapes (B = 1, 128 and
        512, inputs as int8_topk makes them): its time and bound, its
        plain version (check_pairs) and the int8 product alone
        (torch._int_mm over 1M-row blocks; the queries padded with zero
        columns to a multiple of 8, which _int_mm requires). Returns each
        pass's {queries: (pairs, counts, cap)}."""
        n_, w_ = x8.shape
        out = {}
        for c_ in (1, 128, qs.shape[0]):
            q8c, qsc, thr, cap_ = cand_inputs(x8, arow, valid, qs[:c_], kc)
            kept = []
            ms = cuda_ms(lambda: T.rank_candidates_int8(
                x8, q8c, qsc, "cosine", arow, None, valid, thr, cap_),
                10 if c_ == 1 else 5, kept)
            pairs, counts = kept[0]
            surv = int(counts.sum())
            # the store and its scales read, the pairs written; the int8
            # products
            bms, bby = bound(n_ * w_ + 5 * n_ + c_ * w_ + 8 * c_ + 8 * surv,
                             2 * c_ * n_ * w_, PEAK_INT8)
            shape = f"C={c_} N={n_} D={w_} cosine cap={cap_}"
            plain_ms = cuda_ms(lambda: T.rank_candidates_plain(
                x8, qs[:c_], "cosine", arow, None, valid, thr, cap_), 1,
                kept)
            pp, pn = kept[-1]
            check_pairs(pairs, counts, pp, pn, f"rank_candidates_int8 {shape}")
            del pp, pn, kept
            pad = -c_ % 8
            q8t = torch.nn.functional.pad(q8c, (0, 0, 0, pad)).t()

            def int_mm_blocks():  # the product alone, in 1M-row blocks
                for s0 in range(0, n_, 1 << 20):
                    torch._int_mm(x8[s0:s0 + (1 << 20)], q8t)

            try:
                lib = cuda_ms(int_mm_blocks, 3)
            except RuntimeError as e:  # a yardstick only
                print(f"torch._int_mm refused the {c_}-query blocks: {e}",
                      file=sys.stderr)
                lib = None
            row = dict(shape=shape, ms=ms, bound_ms=bms, bound_by=bby,
                       plain_ms=plain_ms, library_ms=lib,
                       library_queries_padded_to=c_ + pad, survivors=surv,
                       plan=cand_plan(c_, w_) if cand_plan else None)
            if c_ == qs.shape[0]:
                note("rank_candidates_int8", 0.0, ms=ms, plain_ms=plain_ms,
                     library_ms=lib, bound_ms=bms, bound_by=bby, shape=shape)
            emit("kernel", name="rank_candidates_int8", tol=[0, 0],
                 max_abs_err=0.0, **row)
            out[c_] = (pairs, counts, cap_)
        return out

    def knn10m_like_store():
        """A 10M x 768 cosine int8 store quantised on the card from its
        own normal rows, with the knn10m queries and kc."""
        n_, d_ = KNN10M["n"], KNN10M["dim"]
        w_ = T.int8_width(d_)
        gc = torch.Generator(device=dev).manual_seed(KNN10M["seed"])
        x8 = torch.empty((n_, w_), dtype=torch.int8, device=dev)
        a8 = torch.empty((n_,), dtype=torch.float32, device=dev)
        x2 = torch.zeros((n_,), dtype=torch.float32, device=dev)
        for s0 in range(0, n_, 1 << 20):
            e0 = min(s0 + (1 << 20), n_)
            T.quantize_rows_int8(torch.randn(e0 - s0, d_, generator=gc,
                                             device=dev), "cosine",
                                 x8[s0:e0], a8[s0:e0], x2[s0:e0])
        qs = torch.from_numpy(normal_rows(max(KNN10M["batches"]), d_,
                                          KNN10M["seed"] + 1)).to(dev)
        kc = min(n_, max(cnf.KNN_INT8_OVERSAMPLE * KNN10M["k"],
                         KNN10M["k"] + 16))
        return x8, a8, torch.ones(n_, dtype=torch.bool, device=dev), qs, kc

    def cand_only():
        """`--only cand`: the edge checks, then the frame rows over a
        10M-row store made on the card."""
        cand_edge_checks()
        x8, a8, ones, qs, kc = knn10m_like_store()
        cand_path_rows(x8, a8, ones, qs, kc)
        del x8, a8, ones
        torch.cuda.empty_cache()

    def pairs_only():
        """`--only pairs`: the edge checks, then the knn10m path's pairs
        (the candidates pass of B = 1, 128 and 512 over a 10M-row store
        made on the card)."""
        pair_edge_checks()
        x8, a8, ones, qs, kc = knn10m_like_store()
        path = {}
        for c_ in (1, 128, qs.shape[0]):
            q8c, qsc, thr, cap_ = cand_inputs(x8, a8, ones, qs[:c_], kc)
            path[c_] = T.rank_candidates_int8(x8, q8c, qsc, "cosine", a8,
                                              None, ones, thr, cap_) + (cap_,)
        del x8, a8, ones
        torch.cuda.empty_cache()
        pair_path_rows(path, kc)

    def rescore_only():
        """`--only rescore`: the edge checks (where this checkout has the
        fused rescore), then the knn1m store as a VecStore on the card:
        the rescore held to its plain versions and timed at B = 1, 128
        and 512, and the answers of a B = 512 frame, written to
        $CHIP_SMOKE_CACHE/knn1m_answers.npz with the writing tree's
        source hash when that file is absent, else held to it (ids equal
        wherever its neighbouring distances differ by more than 1e-4,
        distances within atol 1e-4, rtol 1e-5; the line says `"against":
        "self"` when this tree wrote the file): run it in a parent
        checkout first."""
        if fused_rescore is not None:
            rescore_edge_checks()
        n_, d_, k_ = KNN1M["n"], KNN1M["dim"], KNN1M["k"]
        rng_ = np.random.default_rng(KNN1M["seed"])
        xs_ = rng_.standard_normal((n_, d_), dtype=np.float32)
        qs_np_ = rng_.standard_normal((max(KNN1M["batches"]), d_),
                                      dtype=np.float32)
        st_ = VecStore("rescore", xs_, np.ones(n_, np.uint8), "cosine", 3.0,
                       cnf.device_cfg(), dev)
        st_.ensure()
        check(st_.rank_mode == "bf16", f"knn1m rank mode {st_.rank_mode}")
        q_ = torch.from_numpy(qs_np_).to(dev)
        kc_ = max(2 * k_, k_ + 16)
        rescore_path_rows(st_.device_full, st_.device_norms, q_, {
            c_: T.select_topk_rows(T.rank_scores_bf16(
                st_.device_rank, q_[:c_], "cosine"), kc_)[1]
            for c_ in KNN1M["batches"]}, k_)
        _, (ad, ai) = st_.knn(qs_np_, k_)
        path = os.path.join(cache_dir, "knn1m_answers.npz")
        tree = port_source_hash()
        if os.path.exists(path):
            with np.load(path) as z:
                writer = str(z["tree"]) if "tree" in z else "unknown"
                check(np.allclose(ad, z["d"], atol=1e-4, rtol=1e-5),
                      "knn1m distances differ from the saved answers")
                check_ids(z["d"], z["i"], ai, "knn1m vs the saved answers")
                same = int((ai == z["i"]).sum())
            # answers this tree wrote itself compare nothing
            emit("knn1m_answers", compared=path, writer=writer, tree=tree,
                 against="self" if writer == tree else "another tree",
                 ids_equal=same, ids=int(ai.size))
        else:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(path, d=ad, i=ai, tree=np.array(tree))
            emit("knn1m_answers", written=path, tree=tree)
        del st_, q_
        torch.cuda.empty_cache()

    def check_ann_descent(only=False):
        """ann_descent on the ann phase's store against its plain version
        on the card, ids and dists bit for bit: B = 1, 7 and 512, both
        metrics (euclidean with random x2q), W = 32 and 64, the graph and
        a copy with repeated and out-of-range ids; the probe seed against
        its plain version; the times at B = 512 and 1. Returns the built
        index, the plain descent's candidates and (not `only`) the exact
        f64 top 10 of the recall queries."""
        # built here, when no other path is measured: the build keeps the
        # host's cores busy for tens of seconds
        cache = os.path.join(cache_dir, f"ann_index_{ANN['n']}_"
                             f"{ANN['seed']}.npz") if only else None
        a = build_ann_index(cache)
        st = A.AnnStore("check", a["graph"], a["x8"], a["arow"], a["x2q"],
                        "cosine", ann_cfg, dev)
        dv = st._ensure()
        width, iters, expand, kc = st._clamped(ann_kc)
        qa = torch.from_numpy(a["qs"]).to(dev)
        ids0, d0 = A.probe_seed(dv, qa, "cosine", width)
        pscore = T.rank_scores_int8_plain(dv["x8p"], qa, "cosine",
                                          dv["arowp"], dv["x2qp"],
                                          probe_order=True)
        pd0, psel = T.top_k_smallest_plain(pscore, width)
        check(torch.equal(pd0, d0)
              and torch.equal(dv["probe_ids"][psel.long()], ids0),
              "ann probe seed differs from the plain version")
        del pscore
        na = dv["graph"].shape[0]
        ga = torch.Generator(device=dev).manual_seed(23)
        x2e = torch.rand(na, generator=ga, device=dev) * 4
        bad = dv["graph"].clone()
        bad[::7, 3] = -5
        bad[::11, 5] = na + 3
        bad[::13, 6] = bad[::13, 7]
        n_ann = 0
        for metric in ("cosine", "euclidean"):
            x2m = dv["x2q"] if metric == "cosine" else x2e
            for w_ in (32, 64):
                i0, dd0 = A.probe_seed(dv, qa, metric, w_)
                for gname, g_ in (("graph", dv["graph"]), ("bad ids", bad)):
                    for b_ in (1, 7, 512):
                        ar = (g_, dv["x8"], dv["arow"], x2m, qa[:b_],
                              i0[:b_], dd0[:b_], metric, iters, expand,
                              min(kc, w_))
                        ki, kd = A.ann_descent_cuda(*ar)
                        pi, pd = A.ann_descent_plain(*ar)
                        check(torch.equal(ki, pi) and torch.equal(kd, pd),
                              f"ann_descent {metric} W={w_} B={b_} {gname}: "
                              f"not bit-equal to the plain version")
                        n_ann += 1
        del bad, x2e
        w10_ = dv["x8"].shape[1]
        d_out = dv["graph"].shape[1]
        plain_ids = None
        for b in (qa.shape[0], 1):
            args = (dv["graph"], dv["x8"], dv["arow"], dv["x2q"], qa[:b],
                    ids0[:b], d0[:b], "cosine", iters, expand, kc)
            ki, kd = A.ann_descent_cuda(*args)
            trace = {}
            pi, pd = A.ann_descent_plain(*args, trace=trace)
            check(torch.equal(ki, pi) and torch.equal(kd, pd),
                  f"ann_descent B={b}: not bit-equal to the plain version")
            scored = torch.cat(trace["scored"])
            expanded = torch.cat(trace["expanded"])
            # the bound counts each unique row once (perfect reuse across
            # queries); beside it the bytes of a walk with no reuse
            rest = 4 * b * w10_ + 8 * b * width + 8 * b * kc
            nbytes = (int(torch.unique(scored).numel()) * (w10_ + 8)
                      + int(torch.unique(expanded).numel()) * 4 * d_out
                      + rest)
            no_reuse = (int(scored.numel()) * (w10_ + 8)
                        + int(expanded.numel()) * 4 * d_out + rest)
            ams, aby = bound(nbytes, 2 * int(scored.numel()) * w10_,
                             PEAK_INT8)
            row = dict(
                ms=cuda_ms(lambda: A.ann_descent_cuda(*args),
                           10 if b > 1 else 50),
                plain_ms=cuda_ms(lambda: A.ann_descent_plain(*args), 2),
                library_ms=None, bound_ms=ams, bound_by=aby,
                shape=f"B={b} N={ANN['n']} D={ANN['dim']} W={width} "
                      f"E={expand} iters={iters} kc={kc} cosine")
            if b > 1:
                note("ann_descent", 0.0, **row)
                plain_ids = pi.cpu().numpy()
            emit("kernel", name="ann_descent", tol=[0, 0], max_abs_err=0.0,
                 rows_scored=int(scored.numel()), no_reuse_bytes=no_reuse,
                 no_reuse_bound_ms=no_reuse / PEAK_BYTES_S * 1e3,
                 edge_shapes_checked=n_ann, **row)
            del scored, expanded, trace
        oracle = None
        if not only:
            # the exact f64 cosine top 10 of the recall queries
            x64 = torch.from_numpy(a["xs"]).to(dev).double()
            q64 = qa[:ANN["recall_q"]].double()
            sims = (x64 @ q64.T) / x64.norm(dim=1).clamp_min(1e-30)[:, None]
            oracle = torch.topk(sims, ANN["k"], dim=0).indices.T.cpu().numpy()
            del x64, sims
        del st, dv
        torch.cuda.empty_cache()
        return a, plain_ids, oracle

    # -- the pair select's and the rescore's checks (also `--only`) ----------
    # a parent checkout (copied there) has no fused rescore
    fused_rescore = getattr(T, "gather_rescore_topk_cuda", None)

    def device_ms(fn, iters=20, name=None):
        """Device time (ms) of one call, from torch.profiler: the CUDA
        kernels whose names hold `name` (all of them when None), summed
        over `iters` calls after a warm one; None when the profiler saw
        no such kernel."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and (name is None or name in e.name))
        return us / 1e3 / iters if us else None

    def bits_equal(a, b):
        """Equal bit for bit (-0.0 is not +0.0)."""
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)

    def pair_rows(rows, cap, k, kind, gen):
        """Packed (order key << 32 | id) rows of one kind, ids a
        permutation in each row, and counts: row 0 past cap, rows 1, 2
        and 3 (where there are) at k - 1, k and 0, the rest in [k, cap]."""
        shape = (rows, cap)
        if kind == "binade":  # distances within one binade
            v = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=dev)
        elif kind == "signed":  # negative and positive values
            v = torch.randn(shape, generator=gen, device=dev) * 4
        elif kind == "equal":  # min key = max key in every row
            v = torch.full(shape, 0.75, device=dev)
        else:  # ties: values on a 1/64 grid, the first half of row 0 one
            v = torch.round(torch.randn(shape, generator=gen,
                                        device=dev) * 64) / 64
            v[0, :cap // 2] = v[0, 0]
        ids = torch.argsort(torch.rand(shape, generator=gen, device=dev),
                            dim=1)
        if kind == "dup":  # every pair of row 0 the same (key, id)
            v = torch.rand(shape, generator=gen, device=dev)
            v[0] = 0.25
            ids[0] = 7
        counts = torch.randint(k, cap + 1, (rows,), generator=gen,
                               device=dev, dtype=torch.int32)
        counts[0] = cap + 5
        for r, cnt in ((1, k - 1), (2, k), (3, 0)):
            if r < rows:
                counts[r] = cnt
        return T.pack_pairs_plain(T.order_key_plain(v), ids), counts

    def pair_edge_checks():
        """select_topk_pairs bit for bit against top_k_pairs_plain: R 1 /
        16 / 128 / 131 / 132 / 512, k 1 / 26 / 1280 / 4096 / 5000 (the
        buffer in shared memory up to 8192 keys, then in scratch), rows
        with ties, all-equal keys, identical pairs, one binade, negative
        and positive values, counts 0, k - 1, k and past cap."""
        gen = torch.Generator(device=dev).manual_seed(5)
        n_chk = 0
        for rows_, cap_, k_, kind in (
                (1, 70_000, 1280, "ties"), (16, 131_072, 1280, "ties"),
                (128, 65_536, 1280, "binade"), (131, 40_000, 26, "signed"),
                (132, 50_000, 4096, "ties"), (512, 24_576, 1280, "binade"),
                (512, 8192, 1280, "ties"), (512, 40_000, 26, "equal"),
                (16, 30_000, 1, "signed"), (3, 50_000, 5000, "signed"),
                (4, 20_000, 1280, "dup"), (16, 9000, 7000, "ties"),
                (16, 2000, 1280, "binade")):
            pairs_, counts_ = pair_rows(rows_, cap_, k_, kind, gen)
            kv, ki = T.select_topk_pairs(pairs_, counts_, k_)
            pv, pi = T.top_k_pairs_plain(pairs_, counts_, k_)
            check(bits_equal(kv, pv) and torch.equal(ki, pi),
                  f"select_topk_pairs R={rows_} cap={cap_} k={k_} {kind}: "
                  "not bit-equal to the plain version")
            n_chk += 1
        emit("kernel", name="select_topk_pairs", tol=[0, 0],
             edge_shapes_checked=n_chk)
        torch.cuda.empty_cache()

    def pair_path_rows(path, kc_):
        """select_topk_pairs on the candidates pass's own pairs of a
        knn10m frame (`path`: {queries: (pairs, counts, cap)}) at B = 1,
        128 and 512: bit-equal to the plain version, its time (CUDA
        events and the profiler's device time), the plain version's, and
        torch.topk over the same keys made signed-order-preserving (the
        sign bit flipped, entries past the count the int64 maximum,
        prepared outside the timed call)."""
        for c_, (pairs_, counts_, cap_) in sorted(path.items()):
            kv, ki = T.select_topk_pairs(pairs_, counts_, kc_)
            pv, pi = T.top_k_pairs_plain(pairs_, counts_, kc_)
            check(bits_equal(kv, pv) and torch.equal(ki, pi),
                  f"select_topk_pairs R={c_} cap={cap_} k={kc_} (the "
                  "knn10m path's pairs) not bit-equal to the plain version")
            del kv, ki, pv, pi
            surv = int(counts_.clamp(max=cap_).sum())
            live = (torch.arange(cap_, device=dev)[None, :]
                    < counts_.clamp(max=cap_)[:, None])
            signed = torch.where(live, pairs_ ^ (-(1 << 63)),
                                 torch.iinfo(torch.int64).max)
            fms, fby = bound(8 * surv + 4 * c_ + 8 * c_ * kc_, surv,
                             PEAK_F32)
            iters = 20 if c_ < 512 else 10
            row = dict(
                shape=f"R={c_} cap={cap_} k={kc_} ({surv} pairs)",
                ms=cuda_ms(lambda: T.select_topk_pairs(pairs_, counts_,
                                                       kc_), iters),
                device_ms=device_ms(lambda: T.select_topk_pairs(
                    pairs_, counts_, kc_), iters, "select"),
                plain_ms=cuda_ms(lambda: T.top_k_pairs_plain(
                    pairs_, counts_, kc_), 1),
                library_ms=cuda_ms(lambda: torch.topk(
                    signed, kc_, dim=1, largest=False), iters),
                bound_ms=fms, bound_by=fby)
            del signed, live
            if c_ == max(path):
                note("select_topk_pairs", 0.0, **row)
            emit("kernel", name="select_topk_pairs", tol=[0, 0],
                 max_abs_err=0.0, **row)

    def rescore_edge_checks():
        """gather_rescore in both modes on C 1 / 7 / 128 / 200 / 512 (a
        query's columns over clusters of 8 to 1 blocks: at kc 26 on 132
        SMs 4, 4, 3, 2, 1), kc 1 / 26 / RESCORE_TOPK_MAX_KC and one past it, D 8 / 24 / 37 / 768 / 772,
        three metrics, masked rows, zero rows (dot: -0.0) and duplicate,
        wrapped and clamped ids: the [C, kc] distances within atol 1e-4,
        rtol 1e-5 of the plain version; the fused top k bit-equal to the
        [C, kc] mode followed by select_topk_rows(d, k, ids=cand), and
        its ids the plain version's where distances are apart; past the
        largest kc, the select route (the event rescore_select_route)."""
        gen = torch.Generator(device=dev).manual_seed(7)
        kmax = T.RESCORE_TOPK_MAX_KC
        n_ = 50_003
        n_chk, err = 0, 0.0
        for d_ in (8, 24, 37, 768, 772):
            xs = torch.randn(n_, d_, generator=gen, device=dev)
            xs[::97] = 0.0
            norms_ = xs.norm(dim=1).clamp_min(1e-30)
            valid_ = torch.rand(n_, generator=gen, device=dev) > 0.1
            for c_ in (1, 7, 128, 200, 512):
                qs_ = torch.randn(c_, d_, generator=gen, device=dev)
                for kc_ in (1, 26, kmax, kmax + 1):
                    if c_ * kc_ * d_ > 200_000_000:
                        continue
                    cand_ = torch.randint(-n_ - 3, n_ + 3, (c_, kc_),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
                    if kc_ > 4:
                        cand_[:, 3] = cand_[:, 1]  # ties by column
                    for metric in ("euclidean", "cosine", "dot"):
                        for vm in (None, valid_):
                            what = (f"gather_rescore C={c_} kc={kc_} "
                                    f"D={d_} {metric} "
                                    f"masked={vm is not None}")
                            d = T.gather_rescore_cuda(xs, qs_, cand_, metric,
                                                      norms_, vm)
                            pd = T.gather_rescore_plain(xs, qs_, cand_,
                                                        metric, norms_, vm)
                            err = max(err, max_err(d, pd, 1e-4, 1e-5, what))
                            for k_ in sorted({1, min(10, kc_), kc_}):
                                if kc_ > kmax:
                                    ev0 = kernelstats.events()
                                    fv, fi = T.gather_rescore_topk(
                                        xs, qs_, cand_, metric, k_, norms_,
                                        vm)
                                    check(kernelstats.events()[
                                        "rescore_select_route"]
                                        == ev0["rescore_select_route"] + 1,
                                        f"{what}: kc past the fused "
                                        "limit must take the select route")
                                else:
                                    fv, fi = T.gather_rescore_topk_cuda(
                                        xs, qs_, cand_, metric, k_, norms_,
                                        vm)
                                sv, si = T.select_topk_rows(d, k_, ids=cand_)
                                check(bits_equal(fv, sv)
                                      and torch.equal(fi, si),
                                      f"{what} k={k_}: the fused top k is "
                                      "not the [C, kc] mode + "
                                      "select_topk_rows bit for bit")
                                pv, pi = T.gather_rescore_topk_plain(
                                    xs, qs_, cand_, metric, k_, norms_, vm)
                                err = max(err, max_err(fv, pv, 1e-4, 1e-5,
                                                       f"{what} k={k_}"))
                                check_ids(pv.cpu().numpy(), pi.cpu().numpy(),
                                          fi.cpu().numpy(),
                                          f"{what} k={k_}")
                            n_chk += 1
        # -0.0 stays -0.0: a dot with a zero row
        zc = torch.tensor([[0, 97, 5]], dtype=torch.int32, device=dev)
        zq = torch.randn(1, 8, generator=gen, device=dev)
        zx = torch.randn(200, 8, generator=gen, device=dev)
        zx[0] = 0.0
        zx[97] = 0.0
        zv, zi = T.gather_rescore_topk_cuda(zx, zq, zc, "dot", 3)
        zs = T.select_topk_rows(T.gather_rescore_cuda(zx, zq, zc, "dot"), 3,
                                ids=zc)
        check(bits_equal(zv, zs[0]) and torch.equal(zi, zs[1])
              and bool(torch.signbit(zv[zv == 0]).all()),
              "gather_rescore_topk: a -0.0 distance must stay -0.0")
        emit("kernel", name="gather_rescore", tol=[1e-4, 1e-5],
             max_abs_err=err, edge_shapes_checked=n_chk,
             largest_fused_kc=kmax)
        torch.cuda.empty_cache()
        return err

    def rescore_path_rows(full_, norms_, qs_, cand_by_c, kk):
        """The rescore at a knn1m frame's shapes (C = 1, 128, 512; kc
        candidates of the bf16 rank), each held first to its plain
        versions: the [C, kc] distances within atol 1e-4, rtol 1e-5 of
        gather_rescore_plain; where this checkout has the fused step,
        its top k bit-equal to the [C, kc] mode + select_topk_rows(d, k,
        ids=cand), within the tolerance of gather_rescore_topk_plain and
        its ids the plain version's where distances are apart. Then the
        [C, kc] kernel's time (CUDA events and the profiler's device
        time), its bound and plain version; and the step that ends a
        query chunk, this tree's fused rescore against the parent's
        rescore + select_topk_rows, each timed on its own. Returns the
        C = 512 row and the largest error."""
        out, err = {}, 0.0
        dim_ = full_.shape[1]
        plan = getattr(T, "rescore_plan", None)
        for c_, cand_ in sorted(cand_by_c.items()):
            q_ = qs_[:c_]
            kc_ = cand_.shape[1]
            cl_ = (plan(c_, kc_, torch.cuda.get_device_properties(
                dev).multi_processor_count) if plan else None)
            what = (f"gather_rescore C={c_} kc={kc_} D={dim_} cosine "
                    f"(a knn1m frame's candidates, cluster {cl_})")
            d = T.gather_rescore_cuda(full_, q_, cand_, "cosine", norms_)
            e_ = max_err(d, T.gather_rescore_plain(
                full_, q_, cand_, "cosine", norms_), 1e-4, 1e-5, what)
            if fused_rescore is not None:
                fv, fi = fused_rescore(full_, q_, cand_, "cosine", kk,
                                       norms_)
                sv, si = T.select_topk_rows(d, kk, ids=cand_)
                check(bits_equal(fv, sv) and torch.equal(fi, si),
                      f"{what} k={kk}: the fused top k is not the [C, kc] "
                      "mode + select_topk_rows bit for bit")
                pv, pi = T.gather_rescore_topk_plain(
                    full_, q_, cand_, "cosine", kk, norms_)
                e_ = max(e_, max_err(fv, pv, 1e-4, 1e-5, f"{what} k={kk}"))
                check_ids(pv.cpu().numpy(), pi.cpu().numpy(),
                          fi.cpu().numpy(), f"{what} k={kk}")
                del fv, fi, sv, si, pv, pi
            del d
            err = max(err, e_)
            gms, gby = bound(4 * c_ * kc_ * dim_ + 4 * c_ * dim_
                             + 4 * c_ * kc_ * 2, 2 * c_ * kc_ * dim_,
                             PEAK_F32)
            iters = 50
            row = dict(
                shape=f"C={c_} kc={kc_} D={dim_} cosine",
                ms=cuda_ms(lambda: T.gather_rescore_cuda(
                    full_, q_, cand_, "cosine", norms_), iters),
                device_ms=device_ms(lambda: T.gather_rescore_cuda(
                    full_, q_, cand_, "cosine", norms_), iters,
                    "gather_rescore"),
                plain_ms=cuda_ms(lambda: T.gather_rescore_plain(
                    full_, q_, cand_, "cosine", norms_), 5),
                library_ms=None, bound_ms=gms, bound_by=gby,
                max_abs_err=e_, cluster=cl_)

            def parent_step():
                return T.select_topk_rows(T.gather_rescore_cuda(
                    full_, q_, cand_, "cosine", norms_), kk, ids=cand_)

            steps = {"rescore_then_select": parent_step}
            if fused_rescore is not None:
                steps["fused"] = lambda: fused_rescore(
                    full_, q_, cand_, "cosine", kk, norms_)
            for sname, fn in steps.items():
                row[f"{sname}_ms"] = cuda_ms(fn, iters)
                row[f"{sname}_device_ms"] = device_ms(fn, iters)
            if fused_rescore is not None:  # the fused step's plain version
                row["fused_plain_ms"] = cuda_ms(
                    lambda: T.gather_rescore_topk_plain(
                        full_, q_, cand_, "cosine", kk, norms_), 5)
            # with the final k written: the bound of the fused step
            row["fused_bound_ms"] = bound(
                4 * c_ * kc_ * dim_ + 4 * c_ * dim_ + 4 * c_ * kc_
                + 8 * c_ * kk, 2 * c_ * kc_ * dim_, PEAK_F32)[0]
            out[c_] = row
            emit("kernel", name="gather_rescore", tol=[1e-4, 1e-5], **row)
        return out[max(out)], err

    # -- the supervisor's serving half (also `--only`) --------------------------
    def supervisor_phase(xs_, qs_, counts=None):
        """A supervised runner (mode auto) over the knn1m store: frames
        from 8 threads at once against one at a time, a query budget on
        a stopped runner, a wedge, and a SIGKILL under the 8-thread
        load, each with its recovery. `counts` receives the launch
        counts read from each runner before it is stopped or killed."""
        import signal
        import threading

        from surrealdb_tpu_torch.device import supervisor as SV

        key, tag, kk = "vec/b/b/tbl/ix", [1, 0], KNN1M["k"]
        meta = {"key": key, "tag": tag, "k": kk}
        nt, fb, rounds = SUP["threads"], SUP["frame"], SUP["rounds"]
        qsets = [qs_[i * fb:(i + 1) * fb] for i in range(nt)]
        loads, got = [], {}

        def loader():
            loads.append(key)
            return ("vec_load", {"metric": "cosine", "mink_p": 3.0,
                                 "cfg": cnf.device_cfg()},
                    [xs_, np.ones(xs_.shape[0], np.uint8)])

        def matches(bufs, i):
            d, ids = bufs
            return (np.array_equal(ids, want[i][1])
                    and np.allclose(d, want[i][0], atol=1e-4, rtol=1e-5))

        def answers(what):
            for i, q in enumerate(qsets):
                check(matches(sup.call("vec_knn", meta, [q])[2], i),
                      f"supervisor {what}: frame {i} differs from the "
                      "answers before")

        def read_counts():
            _, m, _ = sup.call("launch_counts", {"reset": True})
            for kname, v in m["launches"].items():
                got[kname] = got.get(kname, 0) + v

        def wait_state(state, timeout):
            end = time.perf_counter() + timeout
            while sup.state != state and time.perf_counter() < end:
                time.sleep(0.001)
            return sup.state == state

        def gone(pid, timeout=10.0):
            end = time.perf_counter() + timeout
            while time.perf_counter() < end:
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    return True
                time.sleep(0.01)
            return False

        def stopped_call():
            """One frame to a stopped runner: (raised, seconds)."""
            t0 = time.perf_counter()
            try:
                sup.call("vec_knn", meta, [qsets[0]])
            except SV.DeviceUnavailable:
                return True, time.perf_counter() - t0
            return False, time.perf_counter() - t0

        # the serving defaults warm each shipped store (the runner
        # phases above run without)
        cnf.DEVICE_PREWARM_BUCKETS, cnf.DEVICE_PREWARM_HOPS = prewarm
        sup = DeviceSupervisor(
            "auto", device="cuda", dispatch_timeout_s=SUP["window_s"],
            probe_interval_s=SUP["probe_s"],
            promote_successes=SUP["promote"])
        out = {"rows": xs_.shape[0], "dim": xs_.shape[1], "threads": nt,
               "frame_queries": fb, "window_s": SUP["window_s"],
               "probe_interval_s": SUP["probe_s"],
               "promote_successes": SUP["promote"]}
        try:
            t0 = time.perf_counter()
            sup.ensure_started()
            check(sup.wait_ready(sup.init_timeout_s)
                  and sup.platform == "cuda",
                  f"supervisor: no runner on cuda: {sup.status()}")
            out["start_s"] = time.perf_counter() - t0
            out["init_s"] = sup.ready_meta["init_s"]
            sup.call("launch_counts", {"reset": True})
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, loader)
            out["load_s"] = time.perf_counter() - t0
            want = [sup.call("vec_knn", meta, [q])[2] for q in qsets]
            for d, ids in want:
                check(d.shape == ids.shape == (fb, kk)
                      and np.isfinite(d).all()
                      and ((ids >= 0) & (ids < xs_.shape[0])).all(),
                      "supervisor: vec_knn result shape/values")
            # 8 x rounds frames one at a time, then from 8 threads
            t0 = time.perf_counter()
            for _ in range(rounds):
                answers("sequential")
            seq_s = time.perf_counter() - t0
            errors = []

            def client(i):
                try:
                    for _ in range(rounds):
                        if not matches(sup.call("vec_knn", meta,
                                                [qsets[i]])[2], i):
                            errors.append(f"thread {i}: wrong answer")
                except Exception as e:  # collected, then checked
                    errors.append(f"thread {i}: {e!r}")

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(nt)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            conc_s = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"supervisor concurrency: {errors[:3]}")
            out["sequential_frames_s"] = nt * rounds / seq_s
            out["concurrent_frames_s"] = nt * rounds / conc_s
            # a query's budget on a stopped runner: the call unwinds,
            # the runner stays; its late reply is dropped by seq
            pid = sup.runner_pid()
            os.kill(pid, signal.SIGSTOP)
            try:
                SV.bind_serving(remaining=lambda: SUP["budget_s"])
                raised, out["budget_unwind_s"] = stopped_call()
            finally:
                SV.bind_serving()
                os.kill(pid, signal.SIGCONT)
            check(raised and out["budget_unwind_s"] < SUP["unwind_limit_s"]
                  and sup.state == "ready" and sup.runner_pid() == pid,
                  f"supervisor budget: raised {raised} after "
                  f"{out['budget_unwind_s']} s, {sup.status()}")
            answers("after the orphaned frame")
            read_counts()
            # a wedge: stopped, no budget; the full window kills it
            timeouts0 = sup.counters["device_dispatch_timeouts"]
            os.kill(pid, signal.SIGSTOP)
            raised, out["wedge_detect_s"] = stopped_call()
            t_wedge = time.perf_counter()
            out["dispatch_timeouts"] = [
                timeouts0, sup.counters["device_dispatch_timeouts"]]
            check(raised and sup.state == "degraded"
                  and out["dispatch_timeouts"][1] == timeouts0 + 1
                  and SUP["window_s"] <= out["wedge_detect_s"]
                  < SUP["window_s"] + 1.0,
                  f"supervisor wedge: raised {raised} after "
                  f"{out['wedge_detect_s']} s, {sup.status()}")
            check(gone(pid), "supervisor: the wedged runner lives on")
            check(wait_state("ready", 300),
                  f"supervisor: no recovery after the wedge "
                  f"{sup.status()}")
            out["wedge_recovery_s"] = time.perf_counter() - t_wedge
            check(sup.counters["device_restarts"] >= 1,
                  "supervisor: no restart counted after the wedge")
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, loader)
            out["wedge_reship_s"] = time.perf_counter() - t0
            check(len(loads) == 2, "supervisor: no reship after the wedge")
            answers("after the wedge")
            read_counts()
            # SIGKILL under the 8-thread load: each frame answers right
            # or raises DeviceUnavailable, nothing else
            outcomes = [[] for _ in range(nt)]
            deadline = time.perf_counter() + 120

            def loaded(i):
                while time.perf_counter() < deadline:
                    try:
                        bufs = sup.call("vec_knn", meta, [qsets[i]])[2]
                    except SV.DeviceUnavailable:
                        outcomes[i].append("unavailable")
                        return
                    except Exception as e:  # collected, then checked
                        outcomes[i].append(f"error {e!r}")
                        return
                    outcomes[i].append("ok" if matches(bufs, i)
                                       else "wrong")

            threads = [threading.Thread(target=loaded, args=(i,))
                       for i in range(nt)]
            for t in threads:
                t.start()
            time.sleep(SUP["kill_after_s"])
            pid = sup.runner_pid()
            t_kill = time.perf_counter()
            os.kill(pid, signal.SIGKILL)
            seen_degraded = wait_state("degraded", 10)
            for t in threads:
                t.join(timeout=130)
            bad = [o for per in outcomes for o in per
                   if o not in ("ok", "unavailable")]
            check(not any(t.is_alive() for t in threads) and not bad
                  and all(per and per[-1] == "unavailable"
                          for per in outcomes),
                  f"supervisor kill under load: {bad[:3]}")
            check(seen_degraded, "supervisor: never degraded after a kill")
            check(wait_state("ready", 300),
                  f"supervisor: no recovery after the kill "
                  f"{sup.status()}")
            out["recovery_s"] = time.perf_counter() - t_kill
            out["respawn_init_s"] = sup.ready_meta["init_s"]
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, loader)
            out["reship_s"] = time.perf_counter() - t0
            check(len(loads) == 3, "supervisor: no reship after the kill")
            answers("after the kill")
            read_counts()
            out["frames_ok_before_kill"] = sum(
                per.count("ok") for per in outcomes)
            out["spawns"] = sup.counters["device_spawns"]
            out["restarts"] = sup.counters["device_restarts"]
            out["state"] = sup.state
        finally:
            sup.shutdown()
            SV.bind_serving()
            cnf.DEVICE_PREWARM_BUCKETS = cnf.DEVICE_PREWARM_HOPS = ""
        for kname in ("rank_scores_bf16", "select_topk_rows",
                      "gather_rescore", "gather_rescore_topk"):
            check(got.get(kname, 0) > 0,
                  f"supervisor: kernel {kname} was not launched")
        if counts is not None:
            for kname, v in got.items():
                counts[kname] += v
        emit("supervisor", **out, launches=got)
        return out

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
    if only:
        if "distance" in only:
            distance_checks()
        if "csr" in only:
            csr_checks()
        if "cand" in only:
            cand_only()
        if "ann" in only:
            check_ann_descent(only=True)
        if "pairs" in only:
            pairs_only()
        if "rescore" in only:
            rescore_only()
        if "supervisor" in only:
            rng = np.random.default_rng(KNN1M["seed"])  # knn1m's rows
            xs_np = rng.standard_normal((KNN1M["n"], KNN1M["dim"]),
                                        dtype=np.float32)
            supervisor_phase(xs_np, rng.standard_normal(
                (max(KNN1M["batches"]), KNN1M["dim"]), dtype=np.float32))
            xs_np = None
        emit("only", checks=only,
             seconds=round(time.perf_counter() - t_start, 3))
        return 0

    # -- 3. kernels against their plain versions ---------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    # distance_tile: nine metrics at ragged shapes on both routes (the
    # product metrics on the tensor cores where D % 4 == 0, the rest and
    # D = 37 on the CUDA cores), shard and batch invariance bit for bit,
    # the blocked scan, then the path's shapes with times
    bxs_np, bq_np, bxs, bq = distance_checks()

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
    # row counts around the SM count (few rows split over blocks, many a
    # block each), planted ties, all-tie rows, shuffled id maps, k in and
    # past the shared buffer: equal to the plain version bit for bit
    gd = torch.Generator(device=dev).manual_seed(1)
    n_sel = 0
    for rows_ in (1, 2, 16, 131, 132, 512):
        for n_, k_ in ((100_000, 26), (300_000, 1280), (70_000, 5000)):
            if rows_ * n_ > 40_000_000:
                continue
            v_ = torch.randn(rows_, n_, generator=gd, device=dev)
            v_[0, ::3] = 0.5
            if rows_ > 1:
                v_[1] = 0.25  # a row of ties only
            ids_ = torch.argsort(torch.rand(rows_, n_, generator=gd,
                                            device=dev), dim=1).to(torch.int32)
            for im in (None, ids_):
                kv, ki = T.select_topk_rows(v_, k_, im)
                pv, pi = T.top_k_smallest_plain(v_, k_, im)
                check(torch.equal(ki, pi) and torch.equal(kv, pv),
                      f"select_topk_rows R={rows_} N={n_} k={k_} "
                      f"ids={im is not None}")
                n_sel += 1
    del v_, ids_, kv, ki, pv, pi
    emit("kernel", name="select_topk_rows", edge_shapes_checked=n_sel)
    # select_topk_pairs at its edge shapes, bit for bit
    pair_edge_checks()

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
    # edge shapes: query counts around the 64-query tile (C <= 64 splits
    # the store rows between the consumers), store rows ragged against
    # the 256-row tile and odd or not a multiple of 4 (the store path),
    # widths under, across and past the 64-column k-step (the tensor
    # maps' zero fill), every metric, masked and unmasked
    rank_c = (1, 7, 64, 65, 512)
    n_edge = 0
    for n_e in (3000, 4097, 4098):
        for d_e in (8, 64, 136, 768):
            ex = torch.randn(n_e, d_e, generator=g).to(dev)
            ex2 = (ex * ex).sum(1)
            ev = (torch.rand(n_e, generator=g) > 0.1).to(dev)
            exb = ex.to(torch.bfloat16)
            for c_e in rank_c:
                eq = torch.randn(c_e, d_e, generator=g).to(dev)
                for metric in ("euclidean", "cosine", "dot"):
                    for vm in (None, ev):
                        e2 = max_err(
                            T.rank_scores_bf16(exb, eq, metric, ex2, vm),
                            T.rank_scores_plain(exb, eq, metric, ex2, vm),
                            *tol_r, f"rank_scores_bf16 C={c_e} N={n_e} "
                            f"D={d_e} {metric} masked={vm is not None}")
                        err = max(err, e2)
                        n_edge += 1
    # and over the knn1m store itself, at every query count
    rank_x2 = torch.cat([rank[s0:s0 + 65536].float().square().sum(1)
                         for s0 in range(0, n, 65536)])
    rank_v = torch.rand(n, generator=g).to(dev) > 0.1
    for c_e in rank_c:
        for metric in ("euclidean", "cosine", "dot"):
            for vm in (None, rank_v):
                e2 = max_err(
                    T.rank_scores_bf16(rank, qs[:c_e], metric, rank_x2, vm),
                    T.rank_scores_plain(rank, qs[:c_e], metric, rank_x2, vm),
                    *tol_r, f"rank_scores_bf16 C={c_e} N={n} D={dim} "
                    f"{metric} masked={vm is not None}")
                err = max(err, e2)
                n_edge += 1
    del rank_x2, rank_v
    torch.cuda.empty_cache()

    def rank_bounds(c_):
        """The kernel's bound (bf16 store and queries read, f32 [C, N]
        written) and torch.mm's own (the same reads, bf16 [C, N]
        written: half the kernel's output bytes)."""
        ops = 2 * c_ * n * dim
        return (bound(2 * n * dim + 4 * c_ * dim + 4 * c_ * n, ops,
                      PEAK_BF16),
                bound(2 * n * dim + 2 * c_ * dim + 2 * c_ * n, ops,
                      PEAK_BF16)[0])

    (rms, rby), mm_bound = rank_bounds(c)
    qb = qs.to(torch.bfloat16)
    note("rank_scores_bf16", err,
         ms=cuda_ms(lambda: T.rank_scores_bf16(rank, qs, "cosine"), 5),
         plain_ms=cuda_ms(lambda: T.rank_scores_plain(rank, qs, "cosine"),
                          3),
         library_ms=cuda_ms(lambda: torch.mm(qb, rank.T), 5),
         bound_ms=rms, bound_by=rby, shape=f"C={c} N={n} D={dim} cosine")
    emit("kernel", name="rank_scores_bf16", tol=tol_r, max_abs_err=err,
         ms=kern["rank_scores_bf16"]["ms"],
         library_ms=kern["rank_scores_bf16"]["library_ms"],
         library_bound_ms=mm_bound, edge_shapes_checked=n_edge)
    # the path's other query counts (B = 1 and 128 frames)
    for c_e in (1, 128):
        (bms, bby), mmb = rank_bounds(c_e)
        qe, qeb = qs[:c_e], qb[:c_e]
        emit("kernel", name="rank_scores_bf16",
             shape=f"C={c_e} N={n} D={dim} cosine",
             ms=cuda_ms(lambda: T.rank_scores_bf16(rank, qe, "cosine"), 10),
             plain_ms=cuda_ms(lambda: T.rank_scores_plain(rank, qe,
                                                          "cosine"), 3),
             library_ms=cuda_ms(lambda: torch.mm(qeb, rank.T), 10),
             bound_ms=bms, bound_by=bby, library_bound_ms=mmb)

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

    # gather_rescore: both modes at edge shapes; at the path's shape
    # with a mask; then its times at the kc candidates of B = 1, 128 and
    # 512 frames
    err = rescore_edge_checks()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[::41] = False
    tol_g = (1e-4, 1e-5)
    d512 = T.gather_rescore_cuda(full, qs, cand, "cosine", norms, valid)
    err = max(err, max_err(d512, T.gather_rescore_plain(
        full, qs, cand, "cosine", norms, valid), *tol_g,
        "gather_rescore cosine 512x26x768 masked"))
    fv, fi = T.gather_rescore_topk_cuda(full, qs, cand, "cosine", k, norms,
                                        valid)
    sv, si = T.select_topk_rows(d512, k, ids=cand)
    check(bits_equal(fv, sv) and torch.equal(fi, si),
          "gather_rescore_topk 512x26x768 masked: not the [C, kc] mode + "
          "select_topk_rows bit for bit")
    pv, pi = T.gather_rescore_topk_plain(full, qs, cand, "cosine", k, norms,
                                         valid)
    err = max(err, max_err(fv, pv, *tol_g, "gather_rescore_topk 512x26x768"))
    check_ids(pv.cpu().numpy(), pi.cpu().numpy(), fi.cpu().numpy(),
              "gather_rescore_topk 512x26x768")
    del d512, fv, fi, sv, si, pv, pi, valid
    cand_by_c = {c: cand}
    for c_e in (1, 128):
        cand_by_c[c_e] = T.select_topk_rows(
            T.rank_scores_bf16(rank, qs[:c_e], "cosine"), kc)[1]
    grow, gerr = rescore_path_rows(full, norms, qs, cand_by_c, k)
    err = max(err, gerr)
    note("gather_rescore", err, **{key: grow[key] for key in (
        "shape", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")})
    note("gather_rescore_topk", err, shape=f"C={c} kc={kc} k={k} D={dim} "
         "cosine", ms=grow["fused_ms"], device_ms=grow["fused_device_ms"],
         plain_ms=cuda_ms(lambda: T.gather_rescore_topk_plain(
             full, qs, cand, "cosine", k, norms), 5),
         library_ms=None, bound_ms=grow["fused_bound_ms"],
         bound_by=grow["bound_by"])
    emit("kernel", name="gather_rescore_topk", tol=tol_g, max_abs_err=err,
         ms=kern["gather_rescore_topk"]["ms"],
         device_ms=kern["gather_rescore_topk"]["device_ms"])
    del cand, cv, cand_by_c

    nn_, ne, src_np, dst_np, rows, cols, starts = csr_checks()
    b = max(GRAPH["batches"])

    # mask_or_reduce: the OR of 4 hop masks [8, 1M] (+ the union
    # accumulator), bit-equal to the plain version
    mparts = [(torch.rand(b, nn_, generator=g) > 0.999).to(torch.uint8).to(
        dev) for _ in range(MESH["ndev"])]
    macc = (torch.rand(b, nn_, generator=g) > 0.999).to(torch.uint8).to(dev)
    pacc = macc.clone()
    check(torch.equal(MG.mask_or_reduce(mparts, macc),
                      MG.mask_or_plain(mparts, pacc))
          and torch.equal(macc, pacc), "mask_or_reduce not bit-equal")
    check(torch.equal(MG.mask_or_reduce(mparts),
                      torch.stack(mparts).amax(0)), "mask_or_reduce no acc")
    nb_ = MESH["ndev"] * b * nn_
    oms, oby = bound(nb_ + 3 * b * nn_, nb_, PEAK_F32)
    note("mask_or_reduce", 0.0,
         ms=cuda_ms(lambda: MG.mask_or_reduce(mparts, macc), 20),
         device_ms=device_ms(lambda: MG.mask_or_reduce(mparts, macc), 20,
                             "mask_or_kernel"),
         plain_ms=cuda_ms(lambda: MG.mask_or_plain(mparts, pacc), 10),
         library_ms=cuda_ms(lambda: torch.stack(mparts).amax(0), 10),
         bound_ms=oms, bound_by=oby,
         shape=f"S={MESH['ndev']} B={b} n={nn_} acc")
    emit("kernel", name="mask_or_reduce", tol=[0, 0], max_abs_err=0.0,
         ms=kern["mask_or_reduce"]["ms"],
         device_ms=kern["mask_or_reduce"]["device_ms"])
    del mparts, macc, pacc

    # merge_partials_topk: partial top-k tiles with planted ties, +inf
    # (masked rows), short parts (padding columns) and all-tie rows,
    # sorted and unsorted, against the plain stable sort over the
    # concatenation, bit for bit
    def partials(rows, widths, sort, seed, tie_rows=0):
        gm = torch.Generator(device="cpu").manual_seed(seed)
        ds, ids = [], []
        for ws in widths:
            d = torch.round(torch.randn(rows, ws, generator=gm) * 8) / 8
            d[:, ::5] = float("inf")
            d[:tie_rows] = 0.5  # every entry of these rows ties
            if sort:
                d = torch.sort(d, dim=1).values
            ds.append(d.to(dev))
            ids.append(torch.randint(0, 250_000, (rows, ws), generator=gm,
                                     dtype=torch.int32).to(dev))
        return ds, ids

    # (rows, part widths, w, k_out, sorted, all-tie rows): the path's two
    # tiles, short and empty parts, padding past the real entries, the
    # winners' sort past shared memory (k_out > 4096), many ties across
    # the threshold, a warp a row (S w <= 256) and a block a row
    merge_cases = [
        (512, (1280,) * 4, 1280, 1280, True, 0),
        (512, (10,) * 4, 10, 10, True, 0),
        (512, (10,) * 4, 10, 10, False, 100),
        (16, (1280,) * 4, 1280, 1280, False, 0),
        (16, (1280, 300, 1280, 0), 1280, 1280, True, 0),
        (16, (1280, 7, 0, 0), 1280, 2000, False, 4),
        (8, (5000,) * 4, 5000, 3000, True, 0),
        (8, (5000,) * 4, 5000, 4500, False, 3),
        (9, (2000,) * 10, 2000, 4000, False, 2),
        (33, (7,) * 32, 7, 50, False, 5),
        (33, (40,) * 32, 40, 300, False, 0),
        (64, (100, 37), 100, 30, False, 7),
        (64, (1000,) * 3, 1000, 500, True, 9),
        (5, (1,), 1, 1, False, 0)]
    # every part count, k_out well under S w / 4
    merge_cases += [(17, (64,) * s_, 64, max(1, s_ * 64 // 5), s_ % 3 == 0,
                     4 * (s_ % 2)) for s_ in range(1, MG.MAX_PARTS + 1)]
    for seed, (rows_, widths, w_, k_out, srt, tie_rows) in enumerate(
            merge_cases):
        ds, ids = partials(rows_, widths, srt, seed, tie_rows)
        bases_s = [s * 250_000 for s in range(len(widths))]
        kd, ki = MG.merge_partials_topk(ds, ids, bases_s, w_, k_out,
                                        999_999)
        pd, pi = MG.merge_partials_plain(ds, ids, bases_s, w_, k_out,
                                         999_999)
        check(torch.equal(kd, pd) and torch.equal(ki, pi),
              f"merge_partials_topk [{rows_}, {widths}] k={k_out} "
              f"sorted={srt} tie_rows={tie_rows}")
    bases4 = [s * 250_000 for s in range(MESH["ndev"])]
    # at the mesh_int8 path's shape: 512 queries, 4 sorted x 1280. The
    # bound's bytes: every entry's dist, the k_out winners' ids, the
    # [B, k_out] (dist, id) output
    def merge_bound(rows, entries, k_out):
        return bound(4 * rows * entries + 12 * rows * k_out,
                     rows * entries, PEAK_F32)

    rows_, w_ = 512, 1280
    ds, ids = partials(rows_, (w_,) * 4, True, 9)
    kd, ki = MG.merge_partials_topk(ds, ids, bases4, w_, w_, 999_999)
    pd, pi = MG.merge_partials_plain(ds, ids, bases4, w_, w_, 999_999)
    check(torch.equal(kd, pd) and torch.equal(ki, pi),
          f"merge_partials_topk [{rows_}, 4x{w_}] k={w_}")
    del kd, ki, pd, pi
    cat_d = torch.cat(ds, dim=1)
    mms, mby = merge_bound(rows_, 4 * w_, w_)
    note("merge_partials_topk", 0.0,
         ms=cuda_ms(lambda: MG.merge_partials_topk(ds, ids, bases4, w_, w_,
                                                   999_999), 20),
         plain_ms=cuda_ms(lambda: MG.merge_partials_plain(
             ds, ids, bases4, w_, w_, 999_999), 10),
         library_ms=cuda_ms(lambda: torch.topk(cat_d, w_, dim=1,
                                               largest=False), 10),
         bound_ms=mms, bound_by=mby, shape=f"B={rows_} S=4 w={w_} k={w_}")
    emit("kernel", name="merge_partials_topk", tol=[0, 0], max_abs_err=0.0,
         ms=kern["merge_partials_topk"]["ms"],
         library_ms=kern["merge_partials_topk"]["library_ms"],
         edge_shapes_checked=len(merge_cases))
    # a launch here is a few microseconds of device work behind tens of
    # the host's, so both sides are the median of five timed loops
    ds, ids = partials(rows_, (10,) * 4, True, 10)
    cat_d = torch.cat(ds, dim=1)

    def host_bound_ms(fn):
        return statistics.median(cuda_ms(fn, 50) for _ in range(5))

    emit("kernel", name="merge_partials_topk", shape="B=512 S=4 w=10 k=10",
         ms=host_bound_ms(lambda: MG.merge_partials_topk(
             ds, ids, bases4, 10, 10, 999_999)),
         plain_ms=cuda_ms(lambda: MG.merge_partials_plain(
             ds, ids, bases4, 10, 10, 999_999), 10),
         library_ms=host_bound_ms(lambda: torch.topk(cat_d, 10, dim=1,
                                                     largest=False)),
         bound_ms=merge_bound(rows_, 40, 10)[0])
    del ds, ids, cat_d
    torch.cuda.empty_cache()

    # select_topk_rows past its shared-memory buffer: k = 5120
    lk_rows, lk_n, lk_k = 16, 1_000_000, 5120
    vals = torch.randn(lk_rows, lk_n, generator=g).to(dev)
    vals[3, ::9] = 0.0  # a block of ties across the k-th position
    v, i = T.select_topk_rows(vals, lk_k)
    pv, pi = T.top_k_smallest_plain(vals, lk_k)
    check(torch.equal(i, pi) and torch.equal(v, pv),
          f"select_topk_rows {lk_rows}x{lk_n} k={lk_k}")
    lms, lby = bound(4 * lk_rows * lk_n + 8 * lk_rows * lk_k,
                     lk_rows * lk_n, PEAK_F32)
    emit("kernel", name="select_topk_rows", shape=f"R={lk_rows} N={lk_n} "
         f"k={lk_k}", ms=cuda_ms(lambda: T.select_topk_rows(vals, lk_k), 5),
         plain_ms=cuda_ms(lambda: T.top_k_smallest_plain(vals, lk_k), 3),
         library_ms=cuda_ms(lambda: torch.topk(vals, lk_k, dim=1,
                                               largest=False), 5),
         bound_ms=lms, bound_by=lby)
    del vals, v, i, pv, pi

    # the knn10m store: rows made here, quantised on the card in blocks
    # (quantize_rows_int8 against its plain version, bit for bit); the
    # same pass keeps the exact f64 top 10 of the recall queries
    n10, d10, k10 = KNN10M["n"], KNN10M["dim"], KNN10M["k"]
    t0 = time.perf_counter()
    xs10 = normal_rows(n10, d10, KNN10M["seed"])
    q10 = normal_rows(max(KNN10M["batches"]), d10, KNN10M["seed"] + 1)
    gen10_s = time.perf_counter() - t0
    w10 = T.int8_width(d10)
    x8_10 = torch.empty((n10, w10), dtype=torch.int8, device=dev)
    arow10 = torch.empty((n10,), dtype=torch.float32, device=dev)
    x2_10 = torch.zeros((n10,), dtype=torch.float32, device=dev)
    nq10 = KNN10M["recall_q"]
    qn10 = torch.from_numpy(q10[:nq10]).to(dev).double()
    qn10 = qn10 / qn10.norm(dim=1, keepdim=True)
    top_v, top_i = [], []
    step = 1 << 19
    for s0 in range(0, n10, step):
        e0 = min(s0 + step, n10)
        blk = torch.from_numpy(xs10[s0:e0]).to(dev)
        T.quantize_rows_int8(blk, "cosine", x8_10[s0:e0], arow10[s0:e0],
                             x2_10[s0:e0])
        p8, pa, _ = T.quantize_rows_plain(blk, "cosine", w10)
        check(torch.equal(p8, x8_10[s0:e0]) and torch.equal(pa,
                                                            arow10[s0:e0]),
              f"quantize_rows_int8 rows {s0}:{e0} differ from the plain "
              f"version")
        del p8, pa
        b64 = blk.double()
        sims = (b64 @ qn10.T) / b64.norm(dim=1).clamp_min(1e-30)[:, None]
        tv, ti = torch.topk(sims, k10, dim=0)
        top_v.append(tv)
        top_i.append(ti + s0)
        del b64, sims
    tv, sel = torch.topk(torch.cat(top_v), k10, dim=0)
    oracle10 = torch.gather(torch.cat(top_i), 0, sel).T.cpu().numpy()
    del top_v, top_i, tv, sel
    for metric in ("euclidean", "cosine", "dot"):
        for dt in (torch.float32, torch.float64):
            xq = torch.randn(3001, 37, generator=g, dtype=dt).to(dev)
            xq[5] = 0.0
            o8 = torch.empty((3001, 48), dtype=torch.int8, device=dev)
            oa = torch.empty((3001,), dtype=torch.float32, device=dev)
            o2 = torch.zeros((3001,), dtype=torch.float32, device=dev)
            T.quantize_rows_int8(xq, metric, o8, oa, o2)
            p8, pa, p2 = T.quantize_rows_plain(xq, metric, 48)
            check(torch.equal(o8, p8) and torch.equal(oa, pa)
                  and torch.equal(o2, p2), f"quantize_rows_int8 {metric} {dt}")
    qrows = min(1 << 20, n10)  # one block of the runner's ensure()
    blk = torch.from_numpy(xs10[:qrows]).to(dev)
    o8 = torch.empty((qrows, w10), dtype=torch.int8, device=dev)
    oa = torch.empty((qrows,), dtype=torch.float32, device=dev)
    o2 = torch.zeros((qrows,), dtype=torch.float32, device=dev)
    qms, qby = bound(qrows * (4 * d10 + w10 + 4), 5 * qrows * d10, PEAK_F32)
    note("quantize_rows_int8", 0.0,
         ms=cuda_ms(lambda: T.quantize_rows_int8(blk, "cosine", o8, oa, o2),
                    5),
         plain_ms=cuda_ms(lambda: T.quantize_rows_plain(blk, "cosine", w10),
                          2),
         library_ms=None, bound_ms=qms, bound_by=qby,
         shape=f"R={qrows} D={d10} cosine f32")
    emit("kernel", name="quantize_rows_int8", tol=[0, 0], max_abs_err=0.0,
         ms=kern["quantize_rows_int8"]["ms"], rows_checked=n10)
    del blk, o8, oa, o2

    # rank_scores_int8 at the path's shape: a 16-query chunk over 10M rows
    c16 = 16
    qs16 = torch.from_numpy(q10[:c16]).to(dev)
    valid10 = torch.ones(n10, dtype=torch.bool, device=dev)
    valid10[::97] = False
    tol_i = (0.0, 1e-5)  # the kernel repeats the reference's float order
    s_k = T.rank_scores_int8(x8_10, qs16, "cosine", arow10, None, valid10)
    s_p = T.rank_scores_int8_plain(x8_10, qs16, "cosine", arow10, None,
                                   valid10)
    err = max_err(s_k, s_p, *tol_i, "rank_scores_int8 16x10Mx768")
    kc10 = min(n10, max(cnf.KNN_INT8_OVERSAMPLE * k10, k10 + 16))
    ck_v, ck_i = T.select_topk_rows(s_k, kc10)
    cp_v, cp_i = T.top_k_smallest_plain(s_p, kc10)
    check_ids(cp_v.cpu().numpy(), cp_i.cpu().numpy(), ck_i.cpu().numpy(),
              "int8 candidates 16x10M kc=1280", atol=0.0, rtol=1e-5)
    del s_p, cp_v, cp_i, ck_v, ck_i
    torch.cuda.empty_cache()
    kept = []
    sel_ms = cuda_ms(lambda: T.select_topk_rows(s_k, kc10), 5, kept)
    sel_plain_ms = cuda_ms(lambda: T.top_k_smallest_plain(s_k, kc10), 2,
                           kept)
    (kv, ki), (pv, pi) = kept
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          f"select_topk_rows R={c16} N={n10} k={kc10}")
    del kept, kv, ki, pv, pi
    emit("kernel", name="select_topk_rows", shape=f"R={c16} N={n10} "
         f"k={kc10}", ms=sel_ms, plain_ms=sel_plain_ms,
         library_ms=cuda_ms(lambda: torch.topk(s_k, kc10, dim=1,
                                               largest=False), 5),
         bound_ms=bound(4 * c16 * n10 + 8 * c16 * kc10, c16 * n10,
                        PEAK_F32)[0])
    for metric in ("euclidean", "cosine", "dot"):
        for probe_order in (False, True):
            sx = torch.randint(-127, 128, (5000, 64), generator=g,
                               dtype=torch.int8).to(dev)
            sa = (torch.rand(5000, generator=g) + 0.01).to(dev) / 127
            s2 = (torch.rand(5000, generator=g) * 10).to(dev)
            sv = (torch.rand(5000, generator=g) > 0.1).to(dev)
            sq_ = torch.randn(70, 64, generator=g).to(dev)
            sq_[0] = 0.0  # a zero (padding) query: finite scores
            e2 = max_err(
                T.rank_scores_int8(sx, sq_, metric, sa, s2, sv, probe_order),
                T.rank_scores_int8_plain(sx, sq_, metric, sa, s2, sv,
                                         probe_order),
                *tol_i, f"rank_scores_int8 {metric} probe={probe_order}")
            err = max(err, e2)
    # bit for bit over widths under, at and past the 32-column k-slice
    # and the 128-column k-step (16 mod 32 reads TMA's zero fill), query
    # counts around the 64-query slab, odd store rows, both metrics'
    # epilogues and both dequantisation orders; and the strided sample
    n_rank = 0
    for d_e in (16, 48, 768, 784, 3072):
        n_e = 4097 if d_e < 3072 else 3001
        ex8 = torch.randint(-127, 128, (n_e, d_e), generator=g,
                            dtype=torch.int8).to(dev)
        ea = ((torch.rand(n_e, generator=g) + 0.01) / 127).to(dev)
        e2_ = (torch.rand(n_e, generator=g) * 10).to(dev)
        ev = (torch.rand(n_e, generator=g) > 0.1).to(dev)
        for c_e in (1, 16, 65, 512):
            eq = torch.randn(c_e, d_e, generator=g).to(dev)
            for metric in ("euclidean", "cosine"):
                for probe_order in (False, True):
                    check(torch.equal(
                        T.rank_scores_int8(ex8, eq, metric, ea, e2_, ev,
                                           probe_order),
                        T.rank_scores_int8_plain(ex8, eq, metric, ea, e2_,
                                                 ev, probe_order)),
                        f"rank_scores_int8 C={c_e} N={n_e} D={d_e} {metric}"
                        f" probe={probe_order} not bit-equal")
                    n_rank += 1
        sample = (256 * 3, 3)  # output tile t = store tile 3 t
        check(torch.equal(
            T.rank_scores_int8(ex8, eq, "euclidean", ea, e2_, ev,
                               sample=sample),
            T.rank_int8(ex8, eq, "euclidean", ea, e2_, ev, sample=sample,
                        plain=True)),
            f"rank_scores_int8 D={d_e} strided sample not bit-equal")
        n_rank += 1
    del ex8, ea, e2_, ev, eq
    q8_16, _ = T.quantize_queries_plain(qs16)
    q8t = q8_16.t()

    def int_mm():
        return torch._int_mm(x8_10, q8t)

    try:
        lib_ms = cuda_ms(int_mm, 5)
    except RuntimeError as e:  # a yardstick only: shapes it refuses
        print(f"torch._int_mm refused [{n10}, {w10}] x [{w10}, {c16}]: "
              f"{e}", file=sys.stderr)
        lib_ms = None
    ims, iby = bound(n10 * w10 + 4 * c16 * w10 + 5 * n10 + 4 * c16 * n10,
                     2 * c16 * n10 * w10, PEAK_INT8)
    note("rank_scores_int8", err,
         ms=cuda_ms(lambda: T.rank_scores_int8(x8_10, qs16, "cosine",
                                               arow10, None, valid10), 10),
         plain_ms=cuda_ms(lambda: T.rank_scores_int8_plain(
             x8_10, qs16, "cosine", arow10, None, valid10), 2),
         library_ms=lib_ms, bound_ms=ims, bound_by=iby,
         shape=f"C={c16} N={n10} D={d10} cosine")
    emit("kernel", name="rank_scores_int8", tol=tol_i, max_abs_err=err,
         ms=kern["rank_scores_int8"]["ms"], edge_shapes_checked=n_rank)

    # the candidates pass and the whole one-pass algorithm on a 200k x 768
    # store with duplicated rows (ties at the kc-th score), tombstones and
    # queries on the duplicates; then a store in sorted order (rows by
    # their score against the queries' direction) with a small buffer
    # that forces the overflow path. The pass's pairs arrive in no order:
    # per query the sorted set and the count equal the plain version's.
    nc_, kc_ = 200_003, 256  # S = 24,832 sample rows >= 64 kc
    xc = torch.randn(nc_, d10, generator=gd, device=dev)
    xc[1000:1100] = xc[5]
    n_cand = 0
    for metric in ("cosine", "euclidean"):
        c8 = torch.empty((nc_, w10), dtype=torch.int8, device=dev)
        ca = torch.empty((nc_,), dtype=torch.float32, device=dev)
        c2 = torch.zeros((nc_,), dtype=torch.float32, device=dev)
        T.quantize_rows_int8(xc, metric, c8, ca, c2)
        cv = (torch.rand(nc_, generator=gd, device=dev) > 0.05)
        for c_e in (1, 16, 65, 512):
            qe = torch.randn(c_e, d10, generator=gd, device=dev)
            qe[0] = xc[5]
            q8e, qse = T.int8_query_scratch(c_e, w10, dev)
            se = T.rank_scores_int8(c8, qe, metric, ca, c2, cv, q8=q8e,
                                    qscale=qse)
            te = T.top_k_smallest_plain(se, kc_)[0][:, -1]
            del se
            kp, kn = T.rank_candidates_int8(c8, q8e, qse, metric, ca, c2,
                                            cv, te, 8192)
            pp, pn = T.rank_candidates_plain(c8, qe, metric, ca, c2, cv, te,
                                             8192)
            check_pairs(kp, kn, pp, pn,
                        f"rank_candidates_int8 {metric} C={c_e}")
            for cap_ in (None, 700):
                st_ = {}
                ki = T.int8_candidates(c8, ca, c2, cv, qe, kc_, metric,
                                       cap=cap_, stats=st_)
                pi = T.int8_candidates_plain(c8, ca, c2, cv, qe, kc_, metric,
                                             cap=cap_)
                check(torch.equal(ki, pi) and (cap_ is None
                                               or st_["overflow"] > 0),
                      f"int8_candidates {metric} C={c_e} cap={cap_}")
                n_cand += 1
        del c8, ca, c2, cv, kp, pp
    # sorted store: every row ordered by its dot with u; queries near u
    u = torch.randn(d10, generator=gd, device=dev)
    xs_sorted = xc[torch.argsort(xc @ u)]
    c8 = torch.empty((nc_, w10), dtype=torch.int8, device=dev)
    ca = torch.empty((nc_,), dtype=torch.float32, device=dev)
    c2 = torch.zeros((nc_,), dtype=torch.float32, device=dev)
    T.quantize_rows_int8(xs_sorted, "cosine", c8, ca, c2)
    cv = torch.ones(nc_, dtype=torch.bool, device=dev)
    qe = u[None, :] + 0.3 * torch.randn(65, d10, generator=gd, device=dev)
    for cap_ in (None, 700):
        st_ = {}
        ki = T.int8_candidates(c8, ca, c2, cv, qe, kc_, "cosine", cap=cap_,
                               stats=st_)
        check(torch.equal(ki, T.int8_candidates_plain(
            c8, ca, c2, cv, qe, kc_, "cosine", cap=cap_))
            and (cap_ is None or st_["overflow"] == 65),
            f"int8_candidates sorted store cap={cap_}")
        n_cand += 1
    del xc, xs_sorted, c8, ca, c2, cv, qe, ki, pi
    torch.cuda.empty_cache()
    cand_edge_checks()

    # at the path's shape: one pass for all 512 queries of a frame over
    # the (all-valid) 10M store, equal to the chunked path (16-query
    # chunks of scores and their kc best) for every query
    ones10 = torch.ones(n10, dtype=torch.bool, device=dev)
    qs512 = torch.from_numpy(q10).to(dev)
    c512 = qs512.shape[0]
    st10 = {}
    cand_all = T.int8_candidates(x8_10, arow10, None, ones10, qs512, kc10,
                                 "cosine", stats=st10)
    chunked = torch.cat([T.select_topk_rows(T.rank_scores_int8(
        x8_10, qs512[s0:s0 + c16], "cosine", arow10, None, ones10),
        kc10)[1] for s0 in range(0, c512, c16)])
    check(torch.equal(cand_all, chunked),
          "int8_candidates 512x10M differ from the chunked path")
    cnt10 = st10["counts"].double()
    emit("int8_candidates", queries=c512, rows=n10, kc=kc10, S=st10["S"],
         cap=st10["cap"], overflow=st10["overflow"],
         survivors_min=int(cnt10.min()), survivors_median=float(
             cnt10.median()), survivors_max=int(cnt10.max()),
         equal_chunked_path=True, shapes_checked=n_cand)
    cand_all = cand_all.cpu().numpy()
    del chunked
    # a mesh's one pass per shard: a four-way MeshVecStore over the same
    # rows, its shards views of the store above (2.5M rows a shard, a
    # sample past the shape rule), every shard's passes launched before
    # the first is awaited; equal to the one-device candidates
    ndm = MESH["ndev"]
    mdev = torch.device("cuda", torch.cuda.current_device())
    mesh10 = DM.MeshVecStore(
        "kernels/mesh10m", xs10, np.ones(n10, np.uint8), "cosine", 3.0,
        dict(cnf.device_cfg(), hbm_budget=1), ndm, devices=[mdev] * ndm)
    offs = mesh10.offsets
    mesh10._dev = [{"dev": mdev, "len": offs[s + 1] - offs[s],
                    "base": offs[s], "x8": x8_10[offs[s]:offs[s + 1]],
                    "arow": arow10[offs[s]:offs[s + 1]],
                    "x2": x2_10[offs[s]:offs[s + 1]],
                    "valid": ones10[offs[s]:offs[s + 1]]}
                   for s in range(ndm)]
    mesh10._nloc = max(sh["len"] for sh in mesh10._dev)
    shard_plan = T.int8_candidate_plan(
        mesh10._nloc, c512, kc10, cnf.device_cfg()["score_budget"] // 2)
    check(mesh10.rank_mode == "int8" and shard_plan is not None,
          f"mesh one-pass check: rank mode {mesh10.rank_mode}, shard plan "
          f"{shard_plan}")
    l0, e0 = kernelstats.launches(), kernelstats.events()
    m_meta, (m_cand,) = mesh10.knn(q10, k10)
    l1, e1 = kernelstats.launches(), kernelstats.events()
    m_launch = l1["rank_candidates_int8"] - l0["rank_candidates_int8"]
    m_over = e1["int8_overflow_rows"] - e0["int8_overflow_rows"]
    check(m_meta["kc"] == kc10 and m_launch == ndm and m_over == 0,
          f"mesh one pass: {m_meta}, {m_launch} candidates launches, "
          f"{m_over} rows overflowed")
    check(np.array_equal(m_cand, cand_all),
          "mesh one-pass candidates differ from the one-device path's")
    emit("mesh_int8_one_pass", shards=ndm, shard_rows=mesh10._nloc,
         queries=c512, kc=kc10, S=shard_plan[0], cap=shard_plan[2],
         candidates_launches=m_launch, overflow=m_over,
         equal_one_device=True)
    del mesh10, m_cand
    # the pieces of that pass, each timed alone: the threshold sample's
    # scores, its select, the candidates pass, the final select of pairs
    s_rows, s_step, cap10 = T.int8_candidate_plan(n10, c512, kc10, 1 << 28)
    q8a, qsa = T.int8_query_scratch(c512, w10, dev)
    smp = (s_rows, s_step)
    kept = []
    thr_ms = cuda_ms(lambda: T.rank_scores_int8(
        x8_10, qs512, "cosine", arow10, None, ones10, sample=smp, q8=q8a,
        qscale=qsa), 5, kept)
    thr_plain_ms = cuda_ms(lambda: T.rank_int8(
        x8_10, qs512, "cosine", arow10, None, ones10, sample=smp,
        plain=True), 1, kept)
    ss, ss_p = kept
    check(torch.equal(ss, ss_p), f"rank_scores_int8 C={c512} S={s_rows} "
          "threshold sample not bit-equal to the plain version")
    del kept, ss_p
    emit("kernel", name="rank_scores_int8", shape=f"C={c512} S={s_rows} "
         f"D={d10} cosine (threshold sample, every {s_step}th tile)",
         ms=thr_ms, plain_ms=thr_plain_ms,
         bound_ms=bound(s_rows * w10 + 4 * c512 * w10
                                   + 5 * s_rows + 4 * c512 * s_rows,
                                   2 * c512 * s_rows * w10, PEAK_INT8)[0])
    kept = []
    tsel_ms = cuda_ms(lambda: T.select_topk_rows(ss, kc10), 5, kept)
    tsel_plain_ms = cuda_ms(lambda: T.top_k_smallest_plain(ss, kc10), 1,
                            kept)
    (kv, ki), (pv, pi) = kept
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          f"select_topk_rows R={c512} N={s_rows} k={kc10} (threshold)")
    thr10 = kv[:, kc10 - 1].contiguous()
    del kept, kv, ki, pv, pi
    emit("kernel", name="select_topk_rows", shape=f"R={c512} N={s_rows} "
         f"k={kc10} (threshold select)", ms=tsel_ms,
         plain_ms=tsel_plain_ms,
         library_ms=cuda_ms(lambda: torch.topk(ss, kc10, dim=1,
                                               largest=False), 5),
         bound_ms=bound(4 * c512 * s_rows + 8 * c512 * kc10, c512 * s_rows,
                        PEAK_F32)[0])
    del ss
    torch.cuda.empty_cache()
    # the candidates pass at B = 1, 128 and 512 (inputs made as the path
    # makes them), held to its plain version; then the final select of
    # each pass's own pairs
    path10 = cand_path_rows(x8_10, arow10, ones10, qs512, kc10)
    check(path10[c512][2] == cap10,
          f"candidates buffer {path10[c512][2]} != {cap10}")
    pair_path_rows(path10, kc10)
    del path10, q8a, qsa, thr10
    # the few-row select at a B = 1 frame's threshold pass
    s1_rows = T.int8_candidate_plan(n10, 1, kc10, 1 << 28)[0]
    s1 = s_k[:1, :s1_rows].contiguous()
    kept = []
    s1_ms = cuda_ms(lambda: T.select_topk_rows(s1, kc10), 20, kept)
    s1_plain_ms = cuda_ms(lambda: T.top_k_smallest_plain(s1, kc10), 5, kept)
    (kv, ki), (pv, pi) = kept
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          f"select_topk_rows R=1 N={s1_rows} k={kc10} (B=1 threshold)")
    del kept, kv, ki, pv, pi
    emit("kernel", name="select_topk_rows", shape=f"R=1 N={s1_rows} "
         f"k={kc10} (B=1 threshold select)", ms=s1_ms, plain_ms=s1_plain_ms,
         library_ms=cuda_ms(lambda: torch.topk(s1, kc10, dim=1,
                                               largest=False), 20),
         bound_ms=bound(4 * s1_rows + 8 * kc10, s1_rows, PEAK_F32)[0])
    del s1
    # the runner's first chunk (queries 0..15, an all-valid store) must
    # give these candidates
    s_p = T.rank_scores_int8_plain(x8_10, qs16, "cosine", arow10)
    cand10_v, cand10_i = (t.cpu().numpy()
                          for t in T.top_k_smallest_plain(s_p, kc10))
    del s_k, s_p, x8_10, arow10, x2_10, valid10, q8_16, q8t, ones10, qs512
    torch.cuda.empty_cache()

    # the int8 kernels past 2048 columns: 3072-d rows (a query tile's
    # width chunks accumulate in int32), bit-equal to the plain versions
    nw, dw, cw = WIDE["n"], WIDE["dim"], WIDE["c"]
    xw = torch.randn(nw, dw, generator=g).to(dev)
    w8 = torch.empty((nw, dw), dtype=torch.int8, device=dev)
    wa = torch.empty((nw,), dtype=torch.float32, device=dev)
    w2 = torch.zeros((nw,), dtype=torch.float32, device=dev)
    for metric in ("cosine", "euclidean"):
        w2.zero_()  # only euclidean writes x2
        T.quantize_rows_int8(xw, metric, w8, wa, w2)
        p8, pa, p2 = T.quantize_rows_plain(xw, metric, dw)
        check(torch.equal(p8, w8) and torch.equal(pa, wa)
              and torch.equal(p2, w2), f"quantize_rows_int8 D={dw} {metric}")
        del p8, pa, p2
    wq = torch.randn(cw, dw, generator=g).to(dev)
    wv = (torch.rand(nw, generator=g) > 0.05).to(dev)
    for probe_order in (False, True):
        check(torch.equal(
            T.rank_scores_int8(w8, wq, "euclidean", wa, w2, wv, probe_order),
            T.rank_scores_int8_plain(w8, wq, "euclidean", wa, w2, wv,
                                     probe_order)),
            f"rank_scores_int8 D={dw} probe={probe_order} not bit-equal")
    wq8t = T.quantize_queries_plain(wq)[0].t()
    try:  # the int8 product alone, as at the 10M shape
        wlib_ms = cuda_ms(lambda: torch._int_mm(w8, wq8t), 10)
    except RuntimeError as e:
        print(f"torch._int_mm refused [{nw}, {dw}] x [{dw}, {cw}]: {e}",
              file=sys.stderr)
        wlib_ms = None
    emit("kernel", name="rank_scores_int8", shape=f"C={cw} N={nw} D={dw} "
         "euclidean", tol=[0, 0],
         ms=cuda_ms(lambda: T.rank_scores_int8(w8, wq, "euclidean", wa, w2,
                                               wv), 10),
         plain_ms=cuda_ms(lambda: T.rank_scores_int8_plain(
             w8, wq, "euclidean", wa, w2, wv), 2),
         library_ms=wlib_ms,
         bound_ms=bound(nw * dw + 4 * cw * dw + 9 * nw + 4 * cw * nw,
                        2 * cw * nw * dw, PEAK_INT8)[0])
    emit("kernel", name="quantize_rows_int8", shape=f"R={nw} D={dw} "
         "euclidean f32", tol=[0, 0],
         ms=cuda_ms(lambda: T.quantize_rows_int8(xw, "euclidean", w8, wa,
                                                 w2), 5),
         plain_ms=cuda_ms(lambda: T.quantize_rows_plain(xw, "euclidean",
                                                        dw), 2),
         bound_ms=bound(nw * (4 * dw + dw + 8), 5 * nw * dw, PEAK_F32)[0])
    del xw, w8, wa, w2, wq, wv, wq8t
    torch.cuda.empty_cache()

    # -- 4. the runner as a server ----------------------------------------------
    sup = DeviceSupervisor("auto", device="cuda")
    try:
        ready = sup.start()
        check(ready["platform"] == "cuda", f"runner platform {ready}")
        emit("runner", ready=ready, pid=sup.runner_pid())
        launches = {name: 0 for name in kernelstats.KERNELS}
        # the answers of the one-device paths the mesh phases repeat
        single = {}

        def drive(name, fn, runner=None, needs=()):
            runner = runner or sup
            runner.call("launch_counts", {"reset": True})
            out = fn()
            _, m, _ = runner.call("launch_counts", {})
            for kname, v in m["launches"].items():
                launches[kname] += v
            for kname in needs:
                check(m["launches"][kname] > 0,
                      f"{name}: kernel {kname} was not launched")
            emit(name, **out, launches=m["launches"], events=m["events"])

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
            single["knn1m"] = results
            single["knn1m_oracle"] = oracle
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
            # one B=512 frame: a rank, a candidate select and one fused
            # rescore (with the final top k) a query chunk
            meta = {"key": key, "tag": tag, "k": k}
            _, m0, _ = sup.call("launch_counts", {})
            sup.call("vec_knn", meta, [qs_np])
            _, m1, _ = sup.call("launch_counts", {})
            per_frame = {kn: m1["launches"][kn] - m0["launches"][kn]
                         for kn in ("rank_scores_bf16", "select_topk_rows",
                                    "gather_rescore", "gather_rescore_topk")}
            chunks = per_frame["rank_scores_bf16"]
            check(chunks > 0 and all(v == chunks
                                     for v in per_frame.values()),
                  f"knn1m B=512 frame launches {per_frame}")
            out["launches_per_B512_frame"] = per_frame
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
            # an elementwise metric takes the CUDA-core route
            mmeta = dict(meta, metric="manhattan")
            _, _, mb = sup.call("brute_knn", mmeta, [bxs_np, bq_np])
            t0 = time.perf_counter()
            for _ in range(iters):
                _, _, mb = sup.call("brute_knn", mmeta, [bxs_np, bq_np])
            mms = (time.perf_counter() - t0) * 1e3 / iters
            md, mi = (t.cpu().numpy() for t in T.top_k_smallest_plain(
                D.distance_matrix_plain(bxs, bq, "manhattan"), BRUTE["k"]))
            check(np.allclose(mb[0], md, atol=1e-4, rtol=1e-5),
                  "brute manhattan distances vs plain")
            check_ids(md, mi, mb[1], "brute manhattan vs plain")
            return {"rows": BRUTE["n"], "dim": BRUTE["dim"], "ms": ms,
                    "manhattan_ms": mms,
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
                    single[("graph3hop", bsz, union)] = bufs[0]
                    out[f"B{bsz}_{tagn}_ms"] = ms
                    out[f"B{bsz}_{tagn}_reached"] = int(bufs[0].sum())
            return out

        def knn10m():
            cfg = cnf.device_cfg()
            key, tag = "vec/b/b/tbl10m/ix", [1, 0]
            t0 = time.perf_counter()
            sup.ensure_loaded(key, tag, lambda: (
                "vec_load", {"metric": "cosine", "mink_p": 3.0, "cfg": cfg},
                [xs10, np.ones(n10, np.uint8)]))
            out = {"rows": n10, "dim": d10, "gen_s": round(gen10_s, 3),
                   "load_s": round(time.perf_counter() - t0, 3)}
            results = {}
            for bsz in KNN10M["batches"]:
                meta = {"key": key, "tag": tag, "k": k10}
                t, m, bufs = sup.call("vec_knn", meta, [q10[:bsz]])
                check(t == "ok" and m["mode"] == "cand"
                      and m["rank_mode"] == "int8" and m["kc"] == kc10,
                      f"vec_knn {t} {m}")
                iters = 3
                t0 = time.perf_counter()
                for _ in range(iters):
                    _, _, bufs = sup.call("vec_knn", meta, [q10[:bsz]])
                ms = (time.perf_counter() - t0) * 1e3 / iters
                (cand,) = bufs
                check(cand.shape == (bsz, kc10) and cand.dtype == np.int32
                      and ((cand >= 0) & (cand < n10)).all(),
                      f"knn10m B={bsz} candidates shape/values")
                results[bsz] = cand
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
            cand = results[max(KNN10M["batches"])]
            # the first 16-query chunk equals the plain pipeline's
            check_ids(cand10_v, cand10_i, cand[:c16],
                      "knn10m candidates vs the plain pipeline", atol=0.0,
                      rtol=1e-5)
            # every query's candidates equal the chunked path's, and the
            # smaller frames' are their prefixes
            check(np.array_equal(cand, cand_all),
                  "knn10m candidates differ from the chunked path")
            for bsz, c_ in results.items():
                check(np.array_equal(c_, cand_all[:bsz]),
                      f"knn10m B={bsz} differs from the chunked path")
            # one B=512 frame is one candidates pass over the store
            meta = {"key": key, "tag": tag, "k": k10}
            _, m0, _ = sup.call("launch_counts", {})
            sup.call("vec_knn", meta, [q10])
            _, m1, _ = sup.call("launch_counts", {})
            per_frame = {kn: m1["launches"][kn] - m0["launches"][kn]
                         for kn in ("rank_candidates_int8", "rank_scores_int8",
                                    "select_topk_rows", "select_topk_pairs")}
            check(per_frame["rank_candidates_int8"] == 1,
                  f"knn10m B=512 frame launches {per_frame}")
            check(m1["events"]["int8_overflow_rows"] == 0,
                  f"knn10m overflowed: {m1['events']}")
            out["launches_per_B512_frame"] = per_frame
            out["overflow_rows"] = m1["events"]["int8_overflow_rows"]
            # the serving side's exact rescore (idx/vector.py:1432), in
            # f64 from the rows here, then recall@10 against the oracle
            hits = 0
            for qi in range(nq10):
                ids = cand[qi]
                rows = xs10[ids].astype(np.float64)
                q = q10[qi].astype(np.float64)
                d = 1.0 - rows @ q / np.maximum(
                    np.linalg.norm(rows, axis=1) * np.linalg.norm(q), 1e-30)
                top = ids[np.argsort(d, kind="stable")[:k10]]
                hits += len(set(top.tolist()) & set(oracle10[qi].tolist()))
            recall = hits / (k10 * nq10)
            check(recall >= 0.95, f"knn10m recall@10 {recall} < 0.95")
            out["recall_at_10"] = recall
            out["kc"] = kc10
            sup.call("vec_drop", {"key": key})
            sup.forget(key)
            return out

        def ann_phase():
            key, tag = "ann/b/b/tbl/ix", [1, 0, 0]
            bufs = [ann["graph"], ann["x8"], ann["arow"], ann["x2q"]]

            def ship():
                # 226 MB ships in parts of 64 MB (the multipart path)
                sup.LOAD_PART_BYTES = 64 << 20
                try:
                    t0 = time.perf_counter()
                    sup.ensure_loaded(key, tag, lambda: (
                        "ann_load", {"metric": "cosine", "cfg": ann_cfg},
                        bufs))
                    return time.perf_counter() - t0
                finally:
                    sup.LOAD_PART_BYTES = DeviceSupervisor.LOAD_PART_BYTES

            out = {"rows": ANN["n"], "dim": ANN["dim"],
                   "gen_s": round(ann["gen_s"], 3),
                   "build_s": round(ann["build_s"], 3),
                   "load_s": round(ship(), 3)}
            meta = {"key": key, "tag": tag, "kc": ann_kc}
            results = {}
            for bsz in ANN["batches"]:
                t, m, rb = sup.call("ann_search", meta, [ann["qs"][:bsz]])
                check(t == "ok" and m["mode"] == "cand",
                      f"ann_search {t} {m}")
                iters = 5
                t0 = time.perf_counter()
                for _ in range(iters):
                    _, _, rb = sup.call("ann_search", meta,
                                        [ann["qs"][:bsz]])
                ms = (time.perf_counter() - t0) * 1e3 / iters
                check(rb[0].shape == (bsz, ann_kc)
                      and ((rb[0] >= 0) & (rb[0] < ANN["n"])).all(),
                      f"ann B={bsz} candidates shape/values")
                results[bsz] = rb[0]
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
            cand = results[max(ANN["batches"])]
            out["ids_equal_plain"] = bool(np.array_equal(cand, ann_plain))
            check(out["ids_equal_plain"],
                  "ann candidates differ from the plain descent")
            # exact rescore of the 40 candidates, recall@10 vs the oracle
            xs, qs = ann["xs"], ann["qs"]
            hits = 0
            for qi in range(ANN["recall_q"]):
                ids = cand[qi]
                rows = xs[ids].astype(np.float64)
                q = qs[qi].astype(np.float64)
                d = 1.0 - rows @ q / np.maximum(
                    np.linalg.norm(rows, axis=1) * np.linalg.norm(q), 1e-30)
                top = ids[np.argsort(d, kind="stable")[:ANN["k"]]]
                hits += len(set(top.tolist()) & set(ann_oracle[qi].tolist()))
            recall = hits / (ANN["k"] * ANN["recall_q"])
            check(recall >= 0.95, f"ann recall@10 {recall} < 0.95")
            out["recall_at_10"] = recall
            # drop, stale, reship: the same candidates
            sup.call("ann_drop", {"key": key})
            check(sup.call("ann_search", meta, [qs[:1]])[0] == "stale",
                  "a dropped ann store must answer stale")
            sup.forget(key)
            out["reship_s"] = round(ship(), 3)
            _, _, rb = sup.call("ann_search", meta, [qs])
            out["ids_equal_after_reship"] = bool(np.array_equal(rb[0], cand))
            check(out["ids_equal_after_reship"],
                  "ann candidates changed after a drop and a reship")
            return out

        drive("knn1m", knn1m, needs=("rank_scores_bf16", "select_topk_rows",
                                     "gather_rescore",
                                     "gather_rescore_topk"))
        drive("brute", brute, needs=("distance_tile", "distance_tile_tf32",
                                     "distance_tile_simt"))
        drive("graph3hop", graph3hop)
        sup.call("vec_drop", {"key": "vec/b/b/tbl/ix"})  # the knn1m store
        sup.forget("vec/b/b/tbl/ix")
        xs_np = full = rank = None  # the knn1m rows: host and card memory
        torch.cuda.empty_cache()
        drive("knn10m", knn10m, needs=(
            "quantize_rows_int8", "rank_scores_int8", "rank_candidates_int8",
            "select_topk_rows", "select_topk_pairs"))
        xs10 = None
        ann, ann_plain, ann_oracle = check_ann_descent()
        drive("ann", ann_phase)
        _, stat, _ = sup.call("status", {})
        check(stat["platform"] == "cuda", "status platform")
        emit("status", platform=stat["platform"],
             mem_used=stat["mem_used"], vec_bytes=stat["vec_bytes"],
             csr_bytes=stat["csr_bytes"], vec_blocks=stat["vec_blocks"],
             csr_blocks=stat["csr_blocks"], ann_blocks=stat["ann_blocks"],
             ann_bytes=stat["ann_bytes"],
             compile_cache=stat["compile_cache"])
    finally:
        sup.shutdown()

    t0 = time.perf_counter()
    xs_np = np.random.default_rng(KNN1M["seed"]).standard_normal(
        (n, dim), dtype=np.float32)  # the knn1m rows, same generator
    gen_s = time.perf_counter() - t0

    # -- 5. the supervisor: degrade, re-probe, pipelined dispatch, budgets -----
    # its runners start after the first runner has shut down and are gone
    # before the mesh runners start: one large runner holds the card
    supervisor_phase(xs_np, qs_np, launches)

    # -- 6. the mesh: runners with four logical devices -------------------------
    # started after the supervisor's runners have shut down, so no two
    # runners' stores share the card; each sets SURREAL_DEVICE_MESH
    # before it is spawned (the runner reads its environment)
    ndev = MESH["ndev"]
    cards = DM.physical_devices(DM.device_list(ndev, "cuda"))

    def mesh_runner(mode):
        os.environ["SURREAL_DEVICE_MESH"] = mode
        runner = DeviceSupervisor("auto", device="cuda", mesh_devices=ndev)
        ready = runner.start()
        check(ready["mesh"] == {"mode": mode, "n_devices": ndev,
                                "mesh_shape": [ndev], "axis": "mesh"}
              and ready["device_count"] == ndev, f"mesh runner {ready}")
        emit("runner", mesh_devices=ndev, physical_cards=cards, mode=mode,
             ready=ready, pid=runner.runner_pid())
        return runner

    def frames(runner, op, meta, batches, qsrc, iters, check_reply):
        """Warm each batch size once, then time `iters` frames;
        returns ({B: last bufs}, {timing fields}, last reply meta)."""
        res, out, m = {}, {}, None
        for bsz in batches:
            t, m, bufs = runner.call(op, meta, [qsrc[:bsz]])
            check(t == "ok", f"{op} {t} {m}")
            check_reply(m)
            t0 = time.perf_counter()
            for _ in range(iters):
                _, _, bufs = runner.call(op, meta, [qsrc[:bsz]])
            ms = (time.perf_counter() - t0) * 1e3 / iters
            res[bsz] = bufs
            out[f"B{bsz}_ms"] = ms
            out[f"B{bsz}_qps"] = bsz / ms * 1e3
        return res, out, m

    def recall_rescored(cand, xs_rows, qs_rows, oracle, kk):
        """recall@kk of candidates after the serving side's exact f64
        cosine rescore, against the oracle's ids."""
        hits = 0
        for qi in range(len(oracle)):
            ids = cand[qi]
            rows = xs_rows[ids].astype(np.float64)
            q = qs_rows[qi].astype(np.float64)
            d = 1.0 - rows @ q / np.maximum(
                np.linalg.norm(rows, axis=1) * np.linalg.norm(q), 1e-30)
            top = ids[np.argsort(d, kind="stable")[:kk]]
            hits += len(set(top.tolist()) & set(oracle[qi].tolist()))
        return hits / (kk * len(oracle))

    def vec_ship(runner, key, cfg):
        """Ship the knn1m rows (in parts); the placement shows in the
        replies of the queries."""
        t0 = time.perf_counter()
        runner.ensure_loaded(key, [1, 0], lambda: (
            "vec_load", {"metric": "cosine", "mink_p": 3.0, "cfg": cfg},
            [xs_np, np.ones(n, np.uint8)]))
        return time.perf_counter() - t0

    def vec_drop(runner, key):
        runner.call("vec_drop", {"key": key})
        runner.forget(key)

    def mesh_knn1m(runner):
        cfg = cnf.device_cfg()
        load_s = vec_ship(runner, "vec/mesh/knn1m", cfg)
        res, out, m = frames(
            runner, "vec_knn", {"key": "vec/mesh/knn1m", "tag": [1, 0],
                                "k": k}, KNN1M["batches"], qs_np, 5,
            # the self-sharded store answers as the reference's does:
            # mesh_ndev 1 (its shards are the runner's device list)
            lambda m: check(m["rank_mode"] == "bf16"
                            and m["mesh_ndev"] == 1, f"reply {m}"))
        for bsz, (d, ids) in res.items():
            rd, ri = single["knn1m"][bsz]
            check(np.allclose(d, rd, atol=1e-4, rtol=1e-5),
                  f"mesh_knn1m B={bsz} distances differ from knn1m's")
            check_ids(rd, ri, ids, f"mesh_knn1m B={bsz} vs knn1m")
        got = res[max(KNN1M["batches"])][1][:len(single["knn1m_oracle"])]
        recall = np.mean([len(set(a) & set(b)) / k for a, b in
                          zip(single["knn1m_oracle"], got)])
        check(recall == 1.0, f"mesh_knn1m recall@10 {recall} < 1.0")
        vec_drop(runner, "vec/mesh/knn1m")
        return dict(out, rows=n, dim=dim, load_s=round(load_s, 3),
                    gen_s=round(gen_s, 3), mesh_ndev=m["mesh_ndev"],
                    self_sharded_over=ndev, recall_at_10=float(recall),
                    ids_equal_knn1m=True)

    def mesh_exact(runner):
        # one device's exact answer: distance_tile + select_topk_rows
        # over the whole store, here in the script
        full = torch.from_numpy(xs_np).to(dev)
        one_d, one_i = (t.cpu().numpy() for t in T.knn_search(
            full, torch.from_numpy(qs_np).to(dev), k, "cosine"))
        del full
        torch.cuda.empty_cache()
        load_s = vec_ship(runner, "vec/mesh/exact", cnf.device_cfg())
        res, out, m = frames(
            runner, "vec_knn", {"key": "vec/mesh/exact", "tag": [1, 0],
                                "k": k}, KNN1M["batches"], qs_np, 5,
            lambda m: check(m["mode"] == "pairs" and m["rank_mode"] is None
                            and m["mesh_ndev"] == ndev, f"reply {m}"))
        same = True
        for bsz, (d, ids) in res.items():
            check(np.allclose(d, one_d[:bsz], atol=1e-4, rtol=1e-5),
                  f"mesh_exact B={bsz} distances differ from one device's")
            check_ids(one_d[:bsz], one_i[:bsz], ids, f"mesh_exact B={bsz}")
            same = same and np.array_equal(d, one_d[:bsz]) \
                and np.array_equal(ids, one_i[:bsz])
        got = res[max(KNN1M["batches"])][1][:len(single["knn1m_oracle"])]
        recall = np.mean([len(set(a) & set(b)) / k for a, b in
                          zip(single["knn1m_oracle"], got)])
        check(recall == 1.0, f"mesh_exact recall@10 {recall} < 1.0")
        check(same, "mesh_exact answers differ from one device's bytes")
        vec_drop(runner, "vec/mesh/exact")
        return dict(out, rows=n, dim=dim, load_s=round(load_s, 3),
                    mesh_ndev=m["mesh_ndev"], recall_at_10=float(recall),
                    bytes_equal_one_device=bool(same))

    def mesh_int8(runner):
        cfg = dict(cnf.device_cfg(), hbm_budget=MESH["int8_budget"])
        kc8 = min(n, max(cfg["int8_oversample"] * k, k + 16))
        # one device's int8 store of the same rows, here in the script
        one = VecStore("one", xs_np, np.ones(n, np.uint8), "cosine", 3.0,
                       cfg, dev)
        (_, (one_c,)) = one.knn(qs_np, k)
        load_s = vec_ship(runner, "vec/mesh/int8", cfg)
        res, out, m = frames(
            runner, "vec_knn", {"key": "vec/mesh/int8", "tag": [1, 0],
                                "k": k}, KNN1M["batches"], qs_np, 3,
            lambda m: check(m["mode"] == "cand" and m["kc"] == kc8
                            and m["rank_mode"] == "int8"
                            and m["mesh_ndev"] == ndev, f"reply {m}"))
        cand = res[max(KNN1M["batches"])][0]
        check(cand.shape == one_c.shape, "mesh_int8 candidate shape")
        # equal in order wherever the (shard-independent) scores are not
        # tied: the one-device store's sorted scores say where
        qd = torch.from_numpy(qs_np).to(dev)
        for s0 in range(0, len(qs_np), 128):
            sc = T.rank_scores_int8(one.device_rank, qd[s0:s0 + 128],
                                    "cosine", one.device_arow, None,
                                    one.device_valid)
            sv, si = (t.cpu().numpy() for t in T.select_topk_rows(sc, kc8))
            del sc
            check(np.array_equal(si, one_c[s0:s0 + 128]),
                  "the one-device int8 store's candidates")
            check_ids(sv, si, cand[s0:s0 + 128],
                      f"mesh_int8 candidates rows {s0}+", atol=0.0,
                      rtol=1e-6)
        for bsz, (c_,) in res.items():
            check(np.array_equal(c_, cand[:bsz]) or bsz == len(cand),
                  f"mesh_int8 B={bsz} is not a prefix of B=512's")
        del one
        torch.cuda.empty_cache()
        oracle = single["knn1m_oracle"]
        recall = recall_rescored(cand, xs_np, qs_np, oracle, k)
        check(recall >= 0.95, f"mesh_int8 recall@10 {recall} < 0.95")
        vec_drop(runner, "vec/mesh/int8")
        return dict(out, rows=n, dim=dim, load_s=round(load_s, 3),
                    mesh_ndev=m["mesh_ndev"], kc=kc8,
                    candidates_equal_one_device=float(
                        np.mean(cand == one_c)),
                    recall_at_10=recall)

    def mesh_ann(runner):
        key, tag = "ann/mesh", [1, 0, 0]
        bufs = [ann["graph"], ann["x8"], ann["arow"], ann["x2q"]]
        seq = DM.MeshAnnStore("seq", *bufs, "cosine", ann_cfg, ndev,
                              devices=[dev] * ndev).search_seq(ann["qs"],
                                                               ann_kc)

        def ship():
            runner.LOAD_PART_BYTES = 64 << 20
            try:
                t0 = time.perf_counter()
                runner.ensure_loaded(key, tag, lambda: (
                    "ann_load", {"metric": "cosine", "cfg": ann_cfg}, bufs))
                return time.perf_counter() - t0
            finally:
                runner.LOAD_PART_BYTES = DeviceSupervisor.LOAD_PART_BYTES

        load_s = ship()
        meta = {"key": key, "tag": tag, "kc": ann_kc}
        res, out, m = frames(
            runner, "ann_search", meta, ANN["batches"], ann["qs"], 5,
            lambda m: check(m["mode"] == "cand" and m["mesh_ndev"] == ndev,
                            f"reply {m}"))
        cand = res[max(ANN["batches"])][0]
        check(np.array_equal(cand, seq),
              "mesh_ann candidates differ from search_seq")
        for bsz, (c_,) in res.items():
            check(c_.shape == (bsz, ann_kc)
                  and ((c_ >= 0) & (c_ < ANN["n"])).all(),
                  f"mesh_ann B={bsz} candidates shape/values")
        recall = recall_rescored(cand, ann["xs"], ann["qs"], ann_oracle,
                                 ANN["k"])
        runner.call("ann_drop", {"key": key})
        check(runner.call("ann_search", meta, [ann["qs"][:1]])[0]
              == "stale", "a dropped mesh ann store must answer stale")
        runner.forget(key)
        reship_s = ship()
        _, _, rb = runner.call("ann_search", meta, [ann["qs"]])
        check(np.array_equal(rb[0], seq),
              "mesh_ann candidates changed after a drop and a reship")
        runner.call("ann_drop", {"key": key})
        return dict(out, rows=ANN["n"], dim=ANN["dim"],
                    load_s=round(load_s, 3), reship_s=round(reship_s, 3),
                    mesh_ndev=m["mesh_ndev"], ids_equal_search_seq=True,
                    ids_equal_after_reship=True, recall_at_10=recall)

    def mesh_graph3hop(runner):
        key, tag = "csr/mesh/person/knows/out", [1]
        t0 = time.perf_counter()
        runner.ensure_loaded(key, tag, lambda: (
            "csr_load", {"n_nodes": nn_}, [src_np, dst_np]))
        out = {"nodes": nn_, "edges": ne,
               "load_s": round(time.perf_counter() - t0, 3)}
        for bsz in GRAPH["batches"]:
            start = np.zeros((bsz, nn_), np.uint8)
            start[np.arange(bsz), np.arange(bsz)] = 1
            for union in (False, True):
                meta = {"key": key, "tag": tag, "hops": GRAPH["hops"],
                        "union": union}
                t, m, bufs = runner.call("csr_hop", meta, [start])
                check(t == "ok" and m["mesh_ndev"] == ndev, f"csr_hop {m}")
                iters = 3
                t0 = time.perf_counter()
                for _ in range(iters):
                    _, _, bufs = runner.call("csr_hop", meta, [start])
                ms = (time.perf_counter() - t0) * 1e3 / iters
                check(np.array_equal(bufs[0],
                                     single[("graph3hop", bsz, union)]),
                      f"mesh_graph3hop B={bsz} union={union} masks differ "
                      f"from graph3hop's")
                tagn = "union" if union else "frontier"
                out[f"B{bsz}_{tagn}_ms"] = ms
                out[f"B{bsz}_{tagn}_reached"] = int(bufs[0].sum())
        out["mesh_ndev"] = ndev
        out["masks_equal_graph3hop"] = True
        return out

    saved_mode = os.environ.get("SURREAL_DEVICE_MESH")
    try:
        runner = mesh_runner("auto")
        try:
            drive("mesh_knn1m", lambda: mesh_knn1m(runner), runner,
                  ("rank_scores_bf16", "select_topk_rows", "gather_rescore",
                   "merge_partials_topk"))
        finally:
            runner.shutdown()
        runner = mesh_runner("force")
        try:
            drive("mesh_exact", lambda: mesh_exact(runner), runner,
                  ("distance_tile", "distance_tile_tf32",
                   "distance_row_stats", "select_topk_rows",
                   "merge_partials_topk"))
            drive("mesh_int8", lambda: mesh_int8(runner), runner,
                  ("quantize_rows_int8", "rank_scores_int8",
                   "select_topk_rows", "merge_partials_topk"))
            drive("mesh_ann", lambda: mesh_ann(runner), runner,
                  ("rank_scores_int8", "select_topk_rows", "ann_descent",
                   "merge_partials_topk"))
            drive("mesh_graph3hop", lambda: mesh_graph3hop(runner), runner,
                  ("csr_hop_step", "mask_or_reduce"))
            _, stat, _ = runner.call("status", {})
            emit("mesh_status", mesh=stat["mesh"], cc=stat["cc"],
                 mem_used_device0=stat["mem_used_device0"],
                 device_count=stat["device_count"])
        finally:
            runner.shutdown()
    finally:
        if saved_mode is None:
            os.environ.pop("SURREAL_DEVICE_MESH", None)
        else:
            os.environ["SURREAL_DEVICE_MESH"] = saved_mode
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
