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
              overflow count and survivor counts are printed. Then
              knn_rank_approx (4 batches of 128 knn1m queries over the
              bf16 store, k = 26, ids as its plain version's wherever
              neighbouring rank scores differ by more than 1e-3), ONNX
              (tests/test_ml.py's three graphs and a 768-wide MLP head at
              B = 4096 on the card against run_graph on the CPU, atol
              1e-5, rtol 1e-4; nvidia-smi's compute mode) and the
              entry points (entry()'s fn against the plain path on the
              card, dryrun_multichip(4): its MULTICHIP line, four stages
              on cuda), their launches counted as the path's;
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
   engine  -- (4b, on that runner, its supervisor in mode require) the
              index engines (idx/vector.py, graph/csr.py) over the
              port's own KV store: knn10m's rows seeded into an engine
              over the resident int8 store (B 1/512, the f64 host
              rescore split from the frame, recall@10), knn1m's rows
              ingested through the KV as bench.py's _bulk_vectors writes
              them (sync, the ship, B 1/128/512 equal to the frames of
              the same store, 32 threads x 8 knn calls through the
              coalescer, recall@10), an exact store (20k x 128,
              manhattan and pearson, against the host ladder), the ann
              rows with KNN_ANN_MODE=auto (ensure_ann, B 1/512, recall,
              then overwrites, deletes and appends through the write
              path held to a brute rescore) and the graph (the CSR from
              the `~` keys at 20k / 200k and seeded arrays at 1M / 10M,
              multi_hop at B 1 and 8 riders bit-equal to the numpy
              hops); no fallback and no host routing may occur; the
              tables and indexes are defined through the port's SQL
              before the KV ingest;
   sql     -- (4b', on that runner, mode require) SurrealQL through
              the port's Datastore.execute over the engine's
              datastores: knn10m `<|10|>` at 128 clients (recall@10 of
              8 queries >= 0.95), knn1m `<|10,40|>` as bench.py drives
              it (sql_knn_qps, p50, p99, index_engine_qps of the same
              engine and their ratio, recall@10 of 16 queries >= 0.99,
              vector::distance::knn() and a `cond` query held to the f64
              oracle, CREATE / UPDATE / DELETE each seen by the next k=1
              probe), ann `<|10,40|>` (recall@10 >= 0.95, no numpy
              descent), brute (BRUTE's rows with emb inline: the
              vector::similarity::cosine ORDER BY ... LIMIT scan, on the
              host as in the reference, and `<|10,COSINE|>` on the card,
              both held to the f64 oracle) and graph (bench.py's 3-hop
              chain over the engine's 20k-node graph, equal to a numpy
              bag hop, on the host); each path prints its stage split
              (parse, plan, coalescer_wait, device_rpc, the rest) on
              its `sql_*` line; knn1m and knn10m launch no distance_tile
              (their queries reach the rank stores, not a brute scan);
              index_engine_qps runs after the knn1m path's counts are
              read, so they count only SQL queries; BASELINE config 2's
              query under EXPLAIN (the plan names the HNSW index and the
              KNN operator) and EXPLAIN FULL, which executes it, on
              knn1m (10 rows fetched), knn10m (the int8 route) and ann
              (the descent), each in a launch window of its own; INFO
              FOR DB, TABLE and INDEX on knn1m's datastore and INFO FOR
              SYSTEM, whose device section is this supervisor (mode
              require, ready); no fallback and no host routing may
              occur;
   auth    -- (after sql, on that runner, mode require) knn1m's
              datastore behind the port's network server (make_server
              on 127.0.0.1:0, not unauthenticated) with the root user
              `start --user root --pass root` defines, each step in a
              launch window of its own: (a) an anonymous POST /sql and
              an anonymous WebSocket query of `<|10,40|>` are refused
              with the IAM error and launch nothing (the stored user's
              hash route printed: `scrypt` without the argon2 package);
              (b) root signs in once over the WebSocket (CBOR), 128 SDK
              clients `authenticate` with its token and send 512 of
              SQL["knn1m"]'s `<|10,40|>` queries (queries/s, p50, p99),
              ids equal to Datastore.execute's as root, recall@10 of 16
              >= 0.99; (c) a database VIEWER over POST /sql with Basic
              auth answers root's ids, its CREATE is refused with the
              IAM error; (d) record access on `acl` (32,768 x 768 cosine
              rows of its own through the KV, owner user:alice on even
              ids and user:bob on odd ones, PERMISSIONS WHERE owner =
              $auth.id, its own bf16 store): alice and bob sign up and
              sign in over the WebSocket, session::ac() and $auth.id
              read back, 16 `<|10,40|>` queries each answer root's ids
              less the other user's rows; (e) fn::nearest, wrapping
              (b)'s query, answers (b)'s ids; (f) DEFINE EVENT audits
              alice's CREATE on acl, her next `<|10|>` probe answers the
              new row first; REBUILD INDEX drops the old store from the
              runner, the next queries ship the rebuilt one and answer
              as before; the bf16 store's three kernels launch in
              (b)-(f), distance_tile never, knn1m's store is never
              shipped again; no fallback, host routing or numpy descent
              may occur;
   ml      -- (after auth, on its server, which this script starts with
              SURREAL_CAPS_ALLOW_EXPERIMENTAL=ml) root imports a 768-wide
              MLP head (onnx_graphs' mlp_head_768 in a SurmlFile header,
              ml::head<1.0.0>) by POST /ml/import, INFO FOR DB lists it,
              GET /ml/export returns its bytes; 64 `SELECT id,
              ml::head<1.0.0>(emb) AS s FROM acl WHERE emb <|10,40|> $q`
              over the WebSocket answer the unscored query's ids and
              scores within atol 1e-5, rtol 1e-4 of run_graph on the
              CPU, every graph run on the card (first call, warm p50 and
              p99); a normalised two-column model as the "jax" engine and
              as ONNX, held to numpy; `SELECT ml::head<1.0.0>(emb) FROM
              acl LIMIT 1024` (ms a row); a datastore without the
              capability answers the reference's error and runs no
              graph; a VERSION read of a small table and INFO FOR DB
              VERSION before the import; the bf16 store's three kernels
              launch, no fallback, host routing or numpy descent; at
              most 20 s;
   api     -- (after ml, on its server) root defines DEFINE API
              "/nearest" FOR post (JSON body middleware, THEN `SELECT id
              FROM acl WHERE emb <|10,40|> $request.body.q`), INFO FOR DB
              lists it; 16 threads send 256 POST /api/b/b/nearest
              requests with root's Bearer token (requests/s, p50, p99),
              ids equal to in-process root's, recall@10 of 16 >= 0.99,
              an unknown path answers the reference's 404; api::invoke
              over the WebSocket answers the same ids; ALTER TABLE acl
              CHANGEFEED 1h, a CREATE seen first by the next <|1|>
              probe, SHOW CHANGES SINCE a datetime before it lists that
              create, then the DELETE too, DROP CHANGEFEED; on a
              256-row table (host only, as in the reference) a GROUP BY
              view equal to its SELECT after inserts, 32 updates and 32
              deletes, a bucket's file::put / file::get round trip and
              /graphql after DEFINE CONFIG GRAPHQL AUTO answering the
              SELECT's rows; the bf16 store's three kernels launch in
              the knn steps, distance_tile never; no fallback, host
              routing or numpy descent; at most 20 s;
   server  -- (after api, on that runner, mode require) knn1m's
              datastore behind the port's network server (make_server
              on 127.0.0.1:0, unauthenticated, the default admission
              gate), each step in a launch window of its own: 128
              clients of the port's SDK over the WebSocket (CBOR) send
              SQL["knn1m"] `<|10,40|>` queries (ws_knn_qps, p50, p99
              beside the sql phase's sql_knn_qps and index_engine_qps;
              recall@10 of 16 >= 0.99; the bf16 store's three kernels
              launch, distance_tile never); the same query through POST
              /sql and POST /rpc (JSON), ids equal; LIVE SELECT id FROM
              acl (phase auth's table: no step writes to knn1m's) on one
              session and a CREATE on another (one CREATE notification,
              the probe answers the row first), KILL (a second CREATE
              delivers nothing in 1 s), both rows deleted; bench.py's
              live_soak at its quick shape (64 sessions, 2 frozen, 4
              writers, 400 writes, 256-byte pad; order_violations 0,
              per_session_complete 62, live_sessions_end 0); a drain
              with one query in flight (the fresh vector's on acl, the
              first after the deletes: it answers without the deleted rows, a
              new request sheds with a typed 503, the drain reaches the
              supervisor's shutdown, which is counted, not run, so the
              runner serves the later phases); no fallback, host routing or numpy
              descent may occur;
   search  -- (4b'', on that runner, mode require) bench.py's
              bench_hybrid through the port's SurrealQL at 2,048
              documents (HYBRID): DEFINE ANALYZER, a FULLTEXT BM25 and
              an HNSW (D 64) index, the ingest, then its LET $vs
              (<|10,40|>) / LET $ft (@1@ 'graph') / search::rrf script,
              a warm-up and 8 timed runs, each in its own launch window
              (the bf16 rank store's three kernels launch in every run,
              distance_tile in none); $vs held to the f64 cosine top
              10, $ft to the reference's BM25 in numpy, the fused list
              to search::rrf recomputed; ingest seconds, scripts a
              second and the stage split printed; no fallback and no
              host routing may occur;
   segments -- (4c, on that runner, mode require) segmented ANN
              (idx/segments.py) at bench.py's knn_churn configuration
              (CHURN: 500k x 768 clustered euclidean rows written through
              the KV op log, KNN_SEG_MODE=force with 131,072-row seals,
              4 rounds (cut from 8 to pay for phase api; the rounds
              add whole seals) of +32,768 / -8,192 rows, each with a
              k=1 probe of the last committed row and 12 k=10 knn
              calls, recall@10
              >= 0.95 against an f64 oracle on the card every 4th round
              and at the end, no whole-store rebuild, every segment
              ready after drain); every ready segment's runner block
              (its own key) answering B 1 / 512 with the ids of the
              plain descent on the card, knn_batch at B=512 against the
              oracle; and the ann rows in a file:// datastore whose
              graph reloads after a restart with no build (reload_s
              beside build_s, the arrays and the B=512 ids equal); no
              fallback, host routing or numpy descent may occur;
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
              reship_s, wedge_detect_s, budget_unwind_s); before the
              budget check, 32 threads' single-query vec_knn payloads
              through a DeviceBatcher (one frame of the concatenated
              queries a dispatch) equal the sequential frames, with an
              average batch above 1 (queries/s of both printed);
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
              (the graph in 4 edge slices; masks bit-equal to graph3hop's);
7. hier    -- in this process, knn1m's store over multihost_mesh (2 hosts
              x 2 logical devices): sharded_rank_rescore_hier at B in
              1/128/512, ids as the single-level mesh's over the same
              four shards, recall@10 1.0, three merge_partials_topk a
              query chunk (one a host, one across the hosts).

It then prints the card line again, one JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, it exits non-zero before printing any result.

    python3 chip_smoke.py --only distance,csr,cand,ann,pairs,rescore,supervisor
    python3 chip_smoke.py --only hier,approx,entry,onnx,batcher
    python3 chip_smoke.py --only engine
    python3 chip_smoke.py --only sql
    python3 chip_smoke.py --only auth
    python3 chip_smoke.py --only ml
    python3 chip_smoke.py --only api
    python3 chip_smoke.py --only server
    python3 chip_smoke.py --only segments
    python3 chip_smoke.py --only search

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
supervisor: phase 5 alone, over knn1m's rows made here; hier,
approx, entry, onnx: those checks over knn1m's rows made here; batcher:
the batcher check over a supervised runner of its own; engine: phase
4b over rows made here and a runner of its own, which ships the knn10m
rows itself; sql: the same, then phase 4b' over its datastores; auth: then the auth
phase over knn1m's; ml: then the auth and ml phases over knn1m's;
api: then the auth and api phases over knn1m's;
server: then the auth and server phases over knn1m's;
segments: phase 4c over a runner of its own; search: phase 4b'' over a
runner of its own), then stops
without a result line. Each kernel row gives the time by CUDA
events over back-to-back calls and, for the pair select and the
rescore, the profiler's device time alone. It also runs from an older
checkout's root (copied there), whose distance_tile takes no row
statistics, whose candidates pass has one route and whose rescore has
no fused top k, to time that checkout's kernels at the same shapes.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import struct
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
# the sql phase's timed queries a path (bench.py's counts)
SQL = dict(knn1m=2048, knn10m=1024, ann=256)
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

# bench.py:540 bench_knn_churn (quick=False): clustered rows (n0 // 200
# centres, sigma 0.15) through the KV op log, segments sealed every
# `seal` rows, `rounds` rounds of +add / -dele rows and nq k=10 queries.
# n0 is cut from 1M to 500k (still past the 400k segment floor) for the
# time limit: at 1M the phase took about 480 s beside the rest's 420-460;
# rounds are cut from 8 to 4 to pay for phase api: the rounds must add
# whole seals (rounds x add a multiple of seal), or the drained set keeps
# an unsealed tail the descent check refuses, so 6 rounds cannot serve
# (PERF.md section 4)
CHURN = dict(n0=500_000, dim=768, seed=15, seal=131_072, rounds=4,
             add=32_768, dele=8_192, nq=12)

# bench.py:1230 bench_hybrid: n is cut from 5,000 to 2,048 documents,
# cnf.KNN_DEVICE_MIN_ROWS (the fewest rows at which the vector leg takes
# the card), for the full-text ingest, whose cost grows with the square
# of the documents (each write rewrites its terms' whole postings, as the
# reference's idx/fulltext.py does)
HYBRID = dict(n=2048, dim=64, seed=23, iters=8)
HYBRID_WORDS = ["graph", "vector", "index", "query", "search", "database",
                "tensor", "shard", "batch", "kernel"]
HYBRID_SQL = (
    "LET $vs = SELECT id, vector::distance::knn() AS distance FROM doc "
    "WHERE emb <|10,40|> $q;"
    "LET $ft = SELECT id, search::score(1) AS ft_score FROM doc "
    "WHERE text @1@ 'graph' ORDER BY ft_score DESC LIMIT 10;"
    "RETURN search::rrf([$vs, $ft], 10, 60);"
)

# phase auth: `clients` SDK clients authenticated with root's token send
# `queries` of SQL["knn1m"]'s queries; `acl`, the record users' table:
# rows of its own (owner user:alice on even ids, user:bob on odd ones),
# `queries` probes of each user. n is cut from 65,536 to 32,768 for the
# time limit: REBUILD INDEX reads and re-indexes every document on the
# host (the reference's build_index), 37 s at 65,536 rows on the card's
# host (PERF.md section 6)
AUTH = dict(clients=128, queries=512)
# phase ml: the scored `<|10,40|>` queries (their vectors' seed) and the
# phase's time limit in seconds
ML = dict(queries=64, seed=43, max_s=20.0)
# phase api: `threads` clients send `requests` POST /api/b/b/nearest
# requests (their vectors' seed), recall@10 over the first
# `recall_queries`; `tally` rows of the host-only table; the phase's time
# limit in seconds
API = dict(threads=16, requests=256, seed=47, recall_queries=16, tally=256,
           max_s=20.0)
ACL = dict(n=32_768, seed=41, queries=16)

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
# the two-level mesh check: knn1m's rows over MESH's devices in 2 hosts
HIER = dict(hosts=2)
# knn_rank_approx: 4 batches of 128 of knn1m's queries, k = 26
APPROX = dict(batches=4, queries=128, k=26)
# the batcher check: 32 threads, 8 single-query submissions each
BATCH = dict(threads=32, rounds=8)
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


def gpu_processes() -> str:
    """`nvidia-smi`'s compute processes (pid, memory), or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "none listed"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available: {e}"


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
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


def ann_rows():
    """The ann cell's rows and queries: clustered rows, queries near
    rows of them."""
    xs, rng = clustered_rows(ANN["n"], ANN["dim"], ANN["n"] // 100,
                             ANN["std"], ANN["seed"])
    qi = rng.integers(0, ANN["n"], max(ANN["batches"]))
    qs = xs[qi] + ANN["noise"] * rng.normal(
        size=(len(qi), ANN["dim"])).astype(np.float32)
    return xs, qs


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
    xs, qs = ann_rows()
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


def hybrid_ingest(conn, cfg):
    """bench.py bench_hybrid's setup and ingest through the port's
    `Datastore.execute`: DEFINE ANALYZER, the FULLTEXT and HNSW indexes,
    then cfg["n"] documents written by its CREATE, in its random order
    (seed 23). Host work only (the full-text postings and the vector
    op log; the supervisor is off here). Runs in a worker process that
    the script starts first, so the ingest's host time, which grows
    with the square of the documents, overlaps the kernels' build.
    Sends ("ingested", ingest seconds) once the ingest is done, then
    ("ok", committed KV items, record ids, texts, vectors, query,
    ingest seconds), which blocks until phase `search` reads it; or
    ("error", traceback) through `conn`."""
    import traceback

    try:
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.kvs.ds import Datastore

        SV.set_supervisor(SV.DeviceSupervisor("off"))
        n, dim = cfg["n"], cfg["dim"]
        ds = Datastore()
        ds.query(
            "DEFINE ANALYZER simple TOKENIZERS class FILTERS lowercase;"
            "DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER simple "
            f"BM25;DEFINE INDEX hx ON doc FIELDS emb HNSW DIMENSION {dim} "
            "DIST COSINE TYPE F32", ns="b", db="b")
        rng = np.random.default_rng(cfg["seed"])
        ids, texts = [], []
        embs = np.empty((n, dim), np.float32)
        t0 = time.perf_counter()
        for i in range(n):
            text = " ".join(rng.choice(HYBRID_WORDS, size=8))
            texts.append(text)
            emb = rng.normal(size=dim).astype(np.float32)
            embs[i] = emb
            (row,) = ds.query_one("CREATE doc CONTENT { text: $t, emb: $e }",
                                  ns="b", db="b",
                                  vars={"t": text, "e": emb.tolist()})
            ids.append(row["id"].id)
        ingest_s = time.perf_counter() - t0
        q = rng.normal(size=dim).astype(np.float32)
        t = ds.transaction(write=False)
        items = [(bytes(k), bytes(v)) for k, v in t.scan(b"", b"\xff" * 9)]
        t.cancel()
        ds.close()
        conn.send(("ingested", ingest_s))
        conn.send(("ok", items, ids, texts, embs, q, ingest_s))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def start_hybrid_ingest():
    """Start `hybrid_ingest` in a spawned worker process; returns
    (ingested, result): `ingested()` waits until the ingest is done and
    returns the seconds it waited, `result()` reads the worker's data
    and waits for the process's end."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=hybrid_ingest, args=(send, dict(HYBRID)),
                       name="hybrid-ingest", daemon=True)
    proc.start()
    send.close()
    got = []

    def read():
        try:
            out = recv.recv()
        except EOFError:
            out = ("error", "the worker sent nothing")
        check(out[0] != "error", f"search: the ingest worker failed: "
              f"{out[1] if out[0] == 'error' else ''}")
        return out

    def ingested():
        t0 = time.perf_counter()
        got.append(read())
        return time.perf_counter() - t0

    def result():
        try:
            if not got:
                got.append(read())
            out = read()
        finally:
            recv.close()
            proc.join(60)
            if proc.is_alive():
                proc.kill()
                proc.join()
        check(out[0] == "ok" and proc.exitcode == 0,
              f"search: the ingest worker ended with {proc.exitcode}")
        return out[1:]

    return ingested, result


def hnsw_def(tb, params):
    """The catalog definition of index `ix` on `tb`'s `emb` column (an
    engine's caller without a catalog of its own)."""
    from surrealdb_tpu_torch.catalog import IndexDef
    from surrealdb_tpu_torch.expr.ast import Idiom, PField

    return IndexDef("ix", tb, [Idiom([PField("emb")])], ["emb"],
                    hnsw=params)


class SoakWs:
    """A raw WebSocket client of the port's server (JSON frames, masked
    as RFC 6455 asks of a client): `call` waits for its reply, `feed`
    reads what has arrived without blocking (the soak's collector)."""

    def __init__(self, port, rcvbuf=None):
        import socket as S

        self.sock = S.socket(S.AF_INET, S.SOCK_STREAM)
        if rcvbuf:
            self.sock.setsockopt(S.SOL_SOCKET, S.SO_RCVBUF, rcvbuf)
        self.sock.settimeout(30)
        self.sock.connect(("127.0.0.1", port))
        key = "c29ha3Nlc3Npb25rZXk93d=="
        self.sock.sendall(
            (f"GET /rpc HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
             f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\n"
             f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            resp += chunk
        self.buf = bytearray(resp.split(b"\r\n\r\n", 1)[1])
        self._id = 0

    def call(self, method, params):
        self._id += 1
        payload = json.dumps({"id": self._id, "method": method,
                              "params": params}).encode()
        mask = b"\x11\x22\x33\x44"
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        n = len(payload)
        if n < 126:
            hdr = b"\x81" + bytes([0x80 | n])
        else:
            hdr = b"\x81" + struct.pack("!BH", 0x80 | 126, n)
        self.sock.sendall(hdr + mask + masked)
        while True:
            msg = self._read_msg()
            if msg.get("id") == self._id:
                return msg

    def _read_msg(self):
        while True:
            msgs = soak_parse(self.buf)
            if msgs:
                if msgs[0] is None:  # server close frame
                    raise ConnectionError("closed by server")
                return msgs[0]
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed")
            self.buf += chunk

    def feed(self) -> list:
        """Non-blocking drain for the collector: recv once, return the
        complete messages parsed out of the buffer."""
        try:
            chunk = self.sock.recv(262144)
        except (BlockingIOError, InterruptedError):
            return []
        except OSError:
            return [None]  # connection gone
        if not chunk:
            return [None]
        self.buf += chunk
        return soak_parse(self.buf, limit=0)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def soak_parse(buf: bytearray, limit: int = 1) -> list:
    """Parse complete server frames out of `buf` in place; returns
    decoded JSON messages (close frames decode to None)."""
    out = []
    while buf and (limit == 0 or len(out) < limit):
        if len(buf) < 2:
            break
        b1, b2 = buf[0], buf[1]
        n = b2 & 0x7F
        off = 2
        if n == 126:
            if len(buf) < 4:
                break
            n = struct.unpack_from("!H", buf, 2)[0]
            off = 4
        elif n == 127:
            if len(buf) < 10:
                break
            n = struct.unpack_from("!Q", buf, 2)[0]
            off = 10
        if len(buf) < off + n:
            break
        data = bytes(buf[off:off + n])
        del buf[:off + n]
        opcode = b1 & 0x0F
        if opcode == 0x8:
            out.append(None)
            break
        if opcode not in (0x1, 0x2):
            continue
        try:
            out.append(json.loads(data.decode()))
        except ValueError:
            continue
    return out


def live_soak(ds, port, sessions=64, frozen=2, writers=4, writes=400,
              payload_pad=256, table="soak", ns="s", db="s",
              settle_s=8.0):
    """bench.py:1445 live_soak over the port's server at `port` (serving
    `ds`): `sessions` WebSocket sessions each hold one LIVE SELECT on
    `table`, `frozen` of them never read their socket (a 4 KB receive
    buffer, so TCP backpressure bites), `writers` threads stream
    CREATEs through `ds`, first with no subscriber (the baseline write
    rate) and then into the subscribed fleet, and one collector thread
    drains every live socket through a selector, checking each
    session's per-writer sequence for order. Then every session closes
    without KILL and the registry must empty. Returns bench.py's
    metrics."""
    import selectors
    import threading

    pad = "x" * payload_pad if payload_pad else ""
    ds.execute(f"DEFINE TABLE {table}", ns=ns, db=db)
    # a per-phase base keeps `s` unique and monotonic per (phase,
    # writer): the order check keys on s // 1_000_000
    phase = [0]

    def run_writes(tag, count):
        phase[0] += 1
        base = phase[0] * 100_000_000

        def w(wi):
            for j in range(count // writers):
                r = ds.execute(
                    f"CREATE {table}:{tag}{wi}x{j} SET ts = $ts, "
                    f"s = $s, p = $p", ns=ns, db=db,
                    vars={"ts": time.time(),
                          "s": base + wi * 1_000_000 + j, "p": pad})
                check(r[0].error is None, f"soak write: {r[0].error}")

        ts = [threading.Thread(target=w, args=(i,), daemon=True)
              for i in range(writers)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return (count // writers) * writers / (time.perf_counter() - t0)

    base_qps = run_writes("b", writes)
    live, cold = [], []
    for i in range(sessions):
        is_frozen = i < frozen
        c = SoakWs(port, rcvbuf=4096 if is_frozen else None)
        c.call("use", [ns, db])
        c.lid = c.call("live", [table]).get("result")
        c.si = i
        (cold if is_frozen else live).append(c)
    stats = {"delivered": 0, "overflow": 0, "error": 0,
             "order_violations": 0, "lat": [], "closed": 0,
             "per_session": {}}
    stop = threading.Event()

    def collect():
        sel = selectors.DefaultSelector()
        for c in live:
            c.sock.setblocking(False)
            sel.register(c.sock, selectors.EVENT_READ, c)
        last_seq: dict = {}
        while not stop.is_set():
            for key, _ev in sel.select(timeout=0.2):
                c = key.data
                for msg in c.feed():
                    if msg is None:
                        try:
                            sel.unregister(c.sock)
                        except KeyError:
                            pass
                        stats["closed"] += 1
                        break
                    if msg.get("id") is not None:
                        continue
                    note = msg.get("result") or {}
                    act = note.get("action")
                    if act == "OVERFLOW":
                        stats["overflow"] += 1
                        continue
                    if act == "ERROR":
                        stats["error"] += 1
                        continue
                    row = note.get("result") or {}
                    ts = row.get("ts")
                    if isinstance(ts, (int, float)):
                        stats["lat"].append(time.time() - ts)
                    sq = row.get("s")
                    key_ = (c.si, sq is not None and sq // 1_000_000)
                    prev = last_seq.get(key_)
                    if prev is not None and sq is not None and sq <= prev:
                        stats["order_violations"] += 1
                    if sq is not None:
                        last_seq[key_] = sq
                    stats["delivered"] += 1
                    ps = stats["per_session"]
                    ps[c.si] = ps.get(c.si, 0) + 1

    col = threading.Thread(target=collect, daemon=True)
    col.start()
    t0 = time.perf_counter()
    fan_qps = run_writes("f", writes)
    target = len(live) * (writes // writers) * writers
    end = time.monotonic() + settle_s
    while time.monotonic() < end and stats["delivered"] < target:
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    stop.set()
    col.join(timeout=5)
    lats = sorted(stats["lat"])

    def pct(p):
        return (lats[min(int(len(lats) * p), len(lats) - 1)] * 1000
                if lats else None)

    # closing every session without KILL must empty the registry
    for c in live + cold:
        c.close()
    gc_end = time.monotonic() + 10.0
    while len(ds.live_queries) and time.monotonic() < gc_end:
        time.sleep(0.05)
    tel = ds.telemetry
    n_writes = (writes // writers) * writers
    return {
        "sessions": sessions, "frozen": frozen, "writes": n_writes,
        "delivered": stats["delivered"],
        "notifications_per_s": stats["delivered"] / wall,
        "delivery_p50_ms": pct(0.50), "delivery_p99_ms": pct(0.99),
        "write_qps_base": base_qps, "write_qps_fanout": fan_qps,
        "decoupling_ratio": fan_qps / base_qps if base_qps else 0.0,
        "order_violations": stats["order_violations"],
        "overflow_notes": stats["overflow"],
        "overflows": tel.get("live_overflows"),
        "overflow_disconnects": tel.get("live_overflow_disconnects"),
        "notifications_dropped": tel.get("notifications_dropped"),
        "live_sessions_end": len(ds.live_queries),
        "per_session_complete": sum(
            1 for v in stats["per_session"].values() if v >= n_writes),
    }


BRUTE_KERNELS = ("distance_tile", "distance_tile_tf32", "distance_tile_simt")


def launch_window(sup_, counts, phase, name, fn, needs=(),
                  absent=BRUTE_KERNELS, none=False, out_all=None):
    """Run one step of a server phase with the runner's launch counts
    set to 0 just before it and read just after: every kernel in
    `needs` must have launched, none in `absent`, and with `none` no
    kernel at all. The counts add to `counts` (the main path's)."""
    sup_.call("launch_counts", {"reset": True})
    out = fn()
    _, m, _ = sup_.call("launch_counts", {})
    fired = m["launches"]
    if counts is not None:
        for kname, v in fired.items():
            counts[kname] += v
    for kname in needs:
        check(fired[kname] > 0,
              f"{phase} {name}: kernel {kname} was not launched")
    for kname in absent:
        check(fired.get(kname, 0) == 0,
              f"{phase} {name}: kernel {kname} was launched")
    if none:
        check(not any(fired.values()), f"{phase} {name}: launched {fired}")
    emit(f"{phase}_{name}", **out,
         launches={kn: v for kn, v in fired.items() if v})
    if out_all is not None:
        out_all[name] = out


def record_ids(rows):
    return [r["id"].id for r in rows]


def http_call(base, path, body=None, headers=None, method="POST"):
    """One request to a port server on namespace and database b;
    returns (status, headers, body), also for an error status."""
    import urllib.error
    import urllib.request

    r = urllib.request.Request(
        base + path, data=body, method=method,
        headers={"surreal-ns": "b", "surreal-db": "b", **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def bound(nbytes, ops, peak):
    """Least time (ms) the card could take: the larger of bytes over
    the HBM rate and operations over the peak rate of their type."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _pb_varint(n):
    out = b""
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out += bytes([byte | 0x80])
        else:
            return out + bytes([byte])


def _pb_field(fno, wt, payload):
    return _pb_varint((fno << 3) | wt) + (
        _pb_varint(len(payload)) + payload if wt == 2 else payload)


def _pb_model(nodes, weights, inp, out):
    """An ONNX ModelProto: nodes (op, inputs, outputs, attrs: ints,
    floats or int lists), float32 initializers, one input and output."""
    graph = b""
    for op, ins, outs, attrs in nodes:
        msg = b"".join(_pb_field(1, 2, i.encode()) for i in ins)
        msg += b"".join(_pb_field(2, 2, o.encode()) for o in outs)
        msg += _pb_field(4, 2, op.encode())
        for name, val in attrs.items():
            a = _pb_field(1, 2, name.encode())
            if isinstance(val, float):
                a += _pb_field(2, 5, struct.pack("<f", val))
            elif isinstance(val, int):
                a += _pb_field(3, 0, _pb_varint(val))
            else:
                a += _pb_field(8, 2, b"".join(_pb_varint(int(x))
                                              for x in val))
            msg += _pb_field(5, 2, a)
        graph += _pb_field(1, 2, msg)
    for name, arr in weights.items():
        t = b"".join(_pb_field(1, 0, _pb_varint(d)) for d in arr.shape)
        t += _pb_field(2, 0, _pb_varint(1))  # float32
        t += _pb_field(8, 2, name.encode())
        t += _pb_field(9, 2, arr.astype("<f4").tobytes())
        graph += _pb_field(5, 2, t)
    graph += _pb_field(11, 2, _pb_field(1, 2, inp.encode()))
    graph += _pb_field(12, 2, _pb_field(1, 2, out.encode()))
    return _pb_field(7, 2, graph)


def onnx_graphs(dim=768, hidden=1024, batch=4096, flat=False) -> dict:
    """name -> (model bytes, feed): the three graphs of tests/test_ml.py
    (the linear model, conv + BN + relu + max pool, average pool +
    transpose + gather) and a `dim`-wide MLP head (hidden width
    `hidden`, 10 outputs) at B = `batch`. With `flat`, the conv and pool
    graphs start with a Reshape of a flat row (what an `ml::` call
    passes) to their NCHW input, and their feeds are flat rows."""
    def nchw(shape):
        if not flat:
            return [], "x", {}
        return ([("Reshape", ["x", "shape"], ["x4"], {})], "x4",
                {"shape": np.array(shape, np.float32)})

    lin = _pb_model([("MatMul", ["x", "w"], ["xw"], {}),
                     ("Add", ["xw", "b"], ["y"], {})],
                    {"w": np.array([[2.0], [3.0]], np.float32),
                     "b": np.array([1.0], np.float32)}, "x", "y")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 2, 6, 6)).astype(np.float32)
    w = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    scale = rng.normal(size=(3,)).astype(np.float32) + 1.5
    bmean = rng.normal(size=(3,)).astype(np.float32)
    bvar = np.abs(rng.normal(size=(3,))).astype(np.float32) + 0.5
    pre, xin, shp = nchw(x.shape)
    conv = _pb_model(
        pre + [("Conv", [xin, "w", "cb"], ["c"], {"strides": [1, 1],
                                                  "pads": [1, 1, 1, 1],
                                                  "kernel_shape": [3, 3]}),
               ("BatchNormalization", ["c", "scale", "bbias", "bmean",
                                       "bvar"], ["bn"], {"epsilon": 1e-5}),
               ("Relu", ["bn"], ["r"], {}),
               ("MaxPool", ["r"], ["y"], {"kernel_shape": [2, 2],
                                          "strides": [2, 2]})],
        {**shp, "w": w, "cb": bias, "scale": scale, "bbias": bias * 0 + 0.25,
         "bmean": bmean, "bvar": bvar}, "x", "y")
    x2 = np.random.default_rng(6).normal(size=(1, 2, 4, 4)).astype(
        np.float32)
    pre, xin, shp = nchw(x2.shape)
    gather = _pb_model(
        pre + [("AveragePool", [xin], ["p"], {"kernel_shape": [2, 2],
                                              "strides": [2, 2]}),
               ("Transpose", ["p"], ["t"], {"perm": [0, 2, 3, 1]}),
               ("Gather", ["t", "gidx"], ["y"], {"axis": 3})],
        {**shp, "gidx": np.array([1], np.float32)}, "x", "y")
    rng = np.random.default_rng(7)
    head = _pb_model(
        [("Gemm", ["x", "w1", "b1"], ["h"], {}),
         ("Relu", ["h"], ["r"], {}),
         ("Gemm", ["r", "w2", "b2"], ["z"], {}),
         ("Softmax", ["z"], ["y"], {})],
        {"w1": (rng.normal(size=(dim, hidden)) / np.sqrt(dim)).astype(
            np.float32),
         "b1": (0.1 * rng.normal(size=(hidden,))).astype(np.float32),
         "w2": (rng.normal(size=(hidden, 10)) / np.sqrt(hidden)).astype(
             np.float32),
         "b2": (0.1 * rng.normal(size=(10,))).astype(np.float32)}, "x", "y")
    if flat:
        x, x2 = x.reshape(1, -1), x2.reshape(1, -1)
    return {
        "linear": (lin, {"x": np.array([1.0, 1.0], np.float32)}),
        "conv_bn_pool": (conv, {"x": x}),
        "gather_transpose_avgpool": (gather, {"x": x2}),
        "mlp_head_768": (head, {"x": rng.normal(size=(batch, dim)).astype(
            np.float32)}),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    checks = ("distance", "csr", "cand", "ann", "pairs", "rescore",
              "supervisor", "hier", "approx", "entry", "onnx", "batcher",
              "engine", "sql", "auth", "ml", "api", "server", "segments",
              "search")
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
    # the server of phases auth, ml, api and server runs as users start one
    # that calls models: with the `ml` experimental capability, which
    # every datastore reads from the environment as it is made
    os.environ["SURREAL_CAPS_ALLOW_EXPERIMENTAL"] = "ml"
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

    # bench_hybrid's ingest: host work in a worker process of its own,
    # beside the kernels' build; it is done before the first measured
    # phase, and phase `search` reads its data
    hybrid = start_hybrid_ingest() if not only or "search" in only else None

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
            # single-query riders coalesced by the cross-query batcher
            out.update(batcher_check(sup, meta, qs_))
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

    # -- this slice's modules: the two-level mesh, knn_rank_approx, the
    # entry points, ONNX and the cross-query batcher (also `--only`) ----------
    def knn1m_device():
        """knn1m's rows and queries (the same generator as phase 3) on
        the card: (full, norms, rank, qs)."""
        rng_ = np.random.default_rng(KNN1M["seed"])
        xs_ = rng_.standard_normal((KNN1M["n"], KNN1M["dim"]),
                                   dtype=np.float32)
        qs_ = rng_.standard_normal((max(KNN1M["batches"]), KNN1M["dim"]),
                                   dtype=np.float32)
        full_ = torch.from_numpy(xs_).to(dev)
        del xs_
        norms_ = torch.cat([
            torch.linalg.norm(full_[s:s + 65536].double(), dim=1)
            for s in range(0, KNN1M["n"], 65536)]).float().clamp_min(1e-30)
        return (full_, norms_, (full_ / norms_[:, None]).to(torch.bfloat16),
                torch.from_numpy(qs_).to(dev))

    def knn1m_oracle(full_, norms_, qs_, nq=16):
        """The exact f64 top k of knn1m's first `nq` queries."""
        q64 = qs_[:nq].double()
        sims = torch.cat([
            (full_[s:s + 65536].double() @ q64.T)
            / norms_[s:s + 65536, None].double()
            for s in range(0, full_.shape[0], 65536)])
        return torch.topk(sims, KNN1M["k"], dim=0).indices.T.cpu().numpy()

    def in_process(fn, counts=None):
        """Drive `fn` with this process's launch counts set to 0 just
        before and read just after; they go into `counts`."""
        kernelstats.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = kernelstats.launches()
        if counts is not None:
            for kname, v in got.items():
                counts[kname] += v
        return out, {kname: v for kname, v in got.items() if v}

    def check_ids_past(ref_d, ref_i, got_i, what, atol, rtol=0.0):
        """check_ids for got_i's columns, ref_* holding one column more:
        the last kept column is checked against the next one too."""
        ref_i = np.asarray(ref_i)
        got_i = np.concatenate([np.asarray(got_i), ref_i[:, -1:]], axis=1)
        check_ids(ref_d, ref_i, got_i, what, atol, rtol)

    def hier_check(full_, norms_, rank_, qs_, oracle, counts=None):
        """knn1m's store over multihost_mesh(4 logical devices, 2 hosts):
        at every frame size, ids equal the single-level mesh's over the
        same four shards wherever its neighbouring distances differ by
        more than 1e-4, distances within atol 1e-4, rtol 1e-5; recall@10
        1.0 on the 16 oracle queries; hosts + 1 merges a query chunk."""
        from surrealdb_tpu_torch.parallel import mesh as PM

        t_0 = time.perf_counter()
        devs = DM.device_list(MESH["ndev"], "cuda")
        hmesh = PM.multihost_mesh(devs, hosts=HIER["hosts"])
        flat = PM.default_mesh(devs)
        shards = (PM.shard_rows_hier(hmesh, rank_),
                  PM.shard_rows_hier(hmesh, full_))
        nsh = PM.shard_vec_hier(hmesh, norms_)
        k_ = KNN1M["k"]
        kc_ = max(2 * k_, k_ + 16)

        def hier(q):
            return PM.sharded_rank_rescore_hier(hmesh, *shards, q, k_, kc_,
                                                "cosine", None, nsh)

        def single(q):
            return PM.sharded_rank_rescore(flat, *shards, q, k_, kc_,
                                           "cosine", None, nsh)

        out = {"rows": full_.shape[0], "dim": full_.shape[1],
               "hosts": len(hmesh), "devices_per_host": len(hmesh[0]),
               "physical_cards": DM.physical_devices(devs), "k": k_,
               "kc": kc_}
        err = 0.0
        for bsz in KNN1M["batches"]:
            q = qs_[:bsz]
            (hd, hi), per = in_process(lambda: hier(q), counts)
            check(per.get("merge_partials_topk") == len(hmesh) + 1
                  and per.get("rank_scores_bf16") == MESH["ndev"],
                  f"hier B={bsz} launches {per}")
            sd, si = single(q)
            err = max(err, max_err(hd, sd, 1e-4, 1e-5,
                                   f"hier B={bsz} vs the single level"))
            check_ids(sd.cpu().numpy(), si.cpu().numpy(), hi.cpu().numpy(),
                      f"hier B={bsz} vs the single level")
            out[f"B{bsz}_ms"] = cuda_ms(lambda: hier(q), 5)
            out[f"B{bsz}_single_level_ms"] = cuda_ms(lambda: single(q), 5)
            out[f"B{bsz}_launches"] = per
        got = hi[:oracle.shape[0]].cpu().numpy()
        recall = np.mean([len(set(a) & set(b)) / k_
                          for a, b in zip(oracle, got)])
        check(recall == 1.0, f"hier recall@10 {recall} < 1.0")
        emit("hier", **out, recall_at_10=float(recall), max_abs_err=err,
             seconds=round(time.perf_counter() - t_0, 3))

    def approx_check(rank_, qs_, counts=None):
        """knn_rank_approx over knn1m's bf16 store, qs_r [4, 128, 768],
        k = 26: ids equal its plain version's on the card wherever
        neighbouring rank scores differ by more than 1e-3."""
        t_0 = time.perf_counter()
        r_, b_, k_ = APPROX["batches"], APPROX["queries"], APPROX["k"]
        qs_r = qs_[:r_ * b_].reshape(r_, b_, qs_.shape[1])
        ids, per = in_process(
            lambda: T.knn_rank_approx(rank_, qs_r, k_, "cosine"), counts)
        check(ids.shape == (r_, b_, k_) and ids.dtype == torch.int32
              and per.get("rank_scores_bf16") == r_
              and per.get("select_topk_rows") == r_,
              f"approx: shape {tuple(ids.shape)}, launches {per}")
        for r in range(r_):
            pv, pi = T.top_k_smallest_plain(
                T.rank_scores_plain(rank_, qs_r[r], "cosine"), k_ + 1)
            check_ids_past(pv.cpu().numpy(), pi.cpu().numpy(),
                           ids[r].cpu().numpy(), f"approx batch {r}", 1e-3,
                           1e-5)
        del pv, pi
        emit("approx", shape=f"R={r_} B={b_} N={rank_.shape[0]} "
             f"D={rank_.shape[1]} k={k_} cosine",
             ms=cuda_ms(lambda: T.knn_rank_approx(rank_, qs_r, k_,
                                                  "cosine"), 5),
             plain_ms=cuda_ms(lambda: [T.top_k_smallest_plain(
                 T.rank_scores_plain(rank_, qs_r[r], "cosine"), k_)
                 for r in range(r_)], 2),
             launches=per, seconds=round(time.perf_counter() - t_0, 3))

    def entry_check(counts=None):
        """The entry points on the card: entry()'s fn against the
        plain path on the card, then dryrun_multichip(4): four stages,
        platform cuda, four shards, the real card count."""
        import contextlib
        import io

        from surrealdb_tpu_torch import entry as E

        t_0 = time.perf_counter()
        fn, (exs, eqs) = E.entry()
        guard_s = time.perf_counter() - t_0
        check(exs.is_cuda and eqs.is_cuda, "entry(): inputs not on the card")
        (ed, ei), per = in_process(lambda: fn(exs, eqs), counts)
        check(per.get("distance_tile", 0) >= 1
              and per.get("select_topk_rows", 0) >= 1,
              f"entry fn launches {per}")
        pv, pi = T.top_k_smallest_plain(
            D.distance_matrix_plain(exs, eqs, "cosine"), 11)
        err = max_err(ed, pv[:, :10], 1e-4, 1e-5, "entry fn")
        check_ids_past(pv.cpu().numpy(), pi.cpu().numpy(), ei.cpu().numpy(),
                       "entry fn", 1e-4)
        out = {"guard_s": guard_s, "ms": cuda_ms(lambda: fn(exs, eqs), 20),
               "plain_ms": cuda_ms(lambda: T.top_k_smallest_plain(
                   D.distance_matrix_plain(exs, eqs, "cosine"), 10), 20),
               "max_abs_err": err, "launches": per}
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                _, dper = in_process(
                    lambda: E.dryrun_multichip(MESH["ndev"]), counts)
        finally:
            print(buf.getvalue(), end="", flush=True)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("MULTICHIP: ")]
        check(len(lines) == 1, f"dryrun printed {len(lines)} MULTICHIP lines")
        st_ = json.loads(lines[0][len("MULTICHIP: "):])
        cards = DM.physical_devices(DM.device_list(MESH["ndev"], "cuda"))
        check(st_["stages"] == ["sharded_rank_rescore", "graph_hop",
                                "device_mesh_store", "hier_mesh"]
              and st_["platform"] == "cuda"
              and st_["n_devices_used"] == MESH["ndev"]
              and st_["physical_cards"] == cards
              and st_["sharded_kernel_ran"] and not st_["fallback_reason"],
              f"dryrun_multichip: {st_}")
        check(dper.get("csr_hop_step", 0) >= 1
              and dper.get("merge_partials_topk", 0) >= 1
              and dper.get("rank_scores_bf16", 0) >= 1,
              f"dryrun launches {dper}")
        emit("entry", **out, multichip=st_, dryrun_launches=dper,
             seconds=round(time.perf_counter() - t_0, 3))

    def onnx_check():
        """The three graphs of tests/test_ml.py and a 768-wide MLP head
        (Gemm 768->1024, Relu, Gemm 1024->10, Softmax) at B = 4096: run
        on the card against run_graph on the CPU, atol 1e-5, rtol 1e-4."""
        from surrealdb_tpu_torch.ml import onnx as O

        t_0 = time.perf_counter()
        out = {"compute_mode": compute_mode()}
        for name, (model, feed) in onnx_graphs().items():
            g_ = O.OnnxGraph.parse(model)
            got = O.run_graph(g_, feed)
            want = O.run_graph(g_, feed, device="cpu")
            check(len(got) == len(want) == 1 and got[0].is_cuda,
                  f"onnx {name}: outputs")
            err = max_err(got[0].cpu(), want[0], 1e-5, 1e-4, f"onnx {name}")
            out[name] = {"ms": cuda_ms(lambda: O.run_graph(g_, feed), 10),
                         "shape": list(got[0].shape), "max_abs_err": err}
        emit("onnx", **out, seconds=round(time.perf_counter() - t_0, 3))

    def batcher_check(sup_, meta_, qs_):
        """32 threads each submit single-query vec_knn payloads through a
        DeviceBatcher whose dispatch is one frame of the concatenated
        queries: each answer equals the query's own frame (ids wherever
        its neighbouring distances differ by more than 1e-4, distances
        within atol 1e-4, rtol 1e-5), and the average batch exceeds 1."""
        import threading

        from surrealdb_tpu_torch.device import batcher as BT

        t_0 = time.perf_counter()
        nt, rounds = BATCH["threads"], BATCH["rounds"]
        qsingle = qs_[:nt * rounds]
        t0 = time.perf_counter()
        seq = [sup_.call("vec_knn", meta_, [q[None]])[2] for q in qsingle]
        seq_s = time.perf_counter() - t0

        def dispatch(payloads):
            d_, i_ = sup_.call("vec_knn", meta_, [np.stack(payloads)])[2]
            return [(d_[j], i_[j]) for j in range(len(payloads))]

        b_ = BT.DeviceBatcher(dispatch=dispatch)
        before = BT.BATCH_STATS.to_dict()
        got, errors = [None] * len(qsingle), []

        def client(t):
            try:
                for r in range(rounds):
                    got[r * nt + t] = b_.submit(qsingle[r * nt + t])
            except Exception as e:  # collected, then checked
                errors.append(f"thread {t}: {e!r}")

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(nt)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        bat_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads),
              f"batcher: {errors[:3]}")
        after = BT.BATCH_STATS.to_dict()
        disp = after["dispatches"] - before["dispatches"]
        avg = (after["riders"] - before["riders"]) / max(disp, 1)
        ref_d = np.concatenate([s[0] for s in seq])
        check(np.allclose(np.stack([g_[0] for g_ in got]), ref_d, atol=1e-4,
                          rtol=1e-5), "batcher: distances differ from the "
              "sequential frames")
        check_ids(ref_d, np.concatenate([s[1] for s in seq]),
                  np.stack([g_[1] for g_ in got]), "batcher vs sequential")
        check(avg > 1, f"batcher: average batch {avg}")
        check(sup_.status()["batching"] == after, "status()['batching']")
        return {"batcher_threads": nt, "batcher_queries": len(qsingle),
                "single_frames_qps": len(qsingle) / seq_s,
                "batched_qps": len(qsingle) / bat_s,
                "batch_avg": avg, "batch_max": after["max"],
                "batch_dispatches": disp,
                "batcher_seconds": round(time.perf_counter() - t_0, 3)}

    def batcher_only():
        """`--only batcher`: a supervisor in mode auto over knn1m's rows,
        the batcher check, shut down."""
        rng_ = np.random.default_rng(KNN1M["seed"])
        xs_ = rng_.standard_normal((KNN1M["n"], KNN1M["dim"]),
                                   dtype=np.float32)
        qs_ = rng_.standard_normal((max(KNN1M["batches"]), KNN1M["dim"]),
                                   dtype=np.float32)
        key, tag = "vec/b/b/tbl/ix", [1, 0]
        sup_ = DeviceSupervisor("auto", device="cuda")
        try:
            sup_.start()
            sup_.ensure_loaded(key, tag, lambda: (
                "vec_load", {"metric": "cosine", "mink_p": 3.0,
                             "cfg": cnf.device_cfg()},
                [xs_, np.ones(xs_.shape[0], np.uint8)]))
            emit("batcher", **batcher_check(
                sup_, {"key": key, "tag": tag, "k": KNN1M["k"]}, qs_))
        finally:
            sup_.shutdown()

    # -- the index engines (also `--only engine`) -------------------------------
    def cosine_oracle(xs_, qs_, kk, step=1 << 19):
        """The exact f64 cosine top kk of qs_ over the host rows xs_,
        streamed through the card in blocks."""
        qn = torch.from_numpy(np.ascontiguousarray(qs_)).to(dev).double()
        qn = qn / qn.norm(dim=1, keepdim=True).clamp_min(1e-30)
        tv_, ti_ = [], []
        for s0 in range(0, xs_.shape[0], step):
            b64 = torch.from_numpy(xs_[s0:s0 + step]).to(dev).double()
            sims = (b64 @ qn.T) / b64.norm(dim=1).clamp_min(1e-30)[:, None]
            v_, i_ = torch.topk(sims, min(kk, sims.shape[0]), dim=0)
            tv_.append(v_)
            ti_.append(i_ + s0)
            del b64, sims
        _, sel_ = torch.topk(torch.cat(tv_), kk, dim=0)
        return torch.gather(torch.cat(ti_), 0, sel_).T.cpu().numpy()

    def engine_phase(sup_, data, counts=None):
        """The index engines over the port's own KV store, under `sup_` (a
        supervisor in mode require over a runner on the card): knn1m
        (1M x 768 cosine rows ingested through the KV as bench.py's
        _bulk_vectors writes them, sync, knn_batch at B 1/128/512 against
        the runner frames of the same store, 32 threads x 8 knn calls
        through the coalescer, recall@10), knn10m (the engine's host
        arrays seeded with the 10M rows as bench.py does, the int8
        store's candidates rescored in f64 here, recall@10), exact (a
        20k x 128 store with manhattan and pearson: the exact store),
        ann (250k clustered rows, KNN_ANN_MODE=auto: ensure_ann, the
        descent + exact re-rank, recall@10, then rows overwritten,
        deleted and appended through vector_index_update and the answers
        held to a brute rescore of the remaining rows) and graph (a CSR
        built from the `~` keys at 20k nodes / 200k edges, and the 1M /
        10M graph seeded as arrays: multi_hop with hops 3 at B 1 and 8
        concurrent riders, masks bit-equal to the numpy multi-hop).
        No fallback may hide the card: device_fallbacks and
        device_host_routed stay 0, the ANN numpy descent is never taken.
        `data["knn10m_store"]`, when set, is the (key, tag) of a resident
        store of those 10M rows (shipped by the runner path with the
        engine's own vec_load payload)."""
        import threading

        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch import resource
        from surrealdb_tpu_torch.device import batcher as BT
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.exec.document import get_indexes
        from surrealdb_tpu_torch.graph import csr as G
        from surrealdb_tpu_torch.idx import vector as V
        from surrealdb_tpu_torch.kvs.api import serialize
        from surrealdb_tpu_torch.kvs.ds import Datastore
        from surrealdb_tpu_torch.val import NONE, RecordId

        t_0 = time.perf_counter()
        k_ = KNN1M["k"]
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        # the default router sends a cuda platform's dispatches to the
        # card (segments stay out of these paths: knn1m and knn10m run
        # with KNN_ANN_MODE off, the ann rows are below the segment floor)
        cnf.KNN_HOST_BATCH = "auto"
        # the 30 GB knn10m arrays must not be evicted mid-run: the node
        # budget is the host's limit (the default is half of it)
        old_acct = resource.set_accountant(
            resource.MemoryAccountant(resource.host_limit_bytes()))
        old_sup = SV.set_supervisor(sup_)
        rpc = {"ns": 0, "calls": 0}

        def rec(name, ns):
            if name == "device_rpc":
                rpc["ns"] += ns
                rpc["calls"] += 1

        SV.bind_serving(stage_record=rec)
        out_all = {}

        def path(name, fn, needs):
            """Run one engine path with the runner's launch counts set to
            0 just before it and read just after."""
            sup_.call("launch_counts", {"reset": True})
            out = fn()
            _, m, _ = sup_.call("launch_counts", {})
            if counts is not None:
                for kname, v in m["launches"].items():
                    counts[kname] += v
            for kname in needs:
                check(m["launches"][kname] > 0,
                      f"engine {name}: kernel {kname} was not launched")
            emit(f"engine_{name}", **out,
                 launches={kn: v for kn, v in m["launches"].items() if v},
                 events=m["events"])
            out_all[name] = out

        def timed(fn, iters):
            """ms a call of fn and of its runner frames (device_rpc)."""
            fn()
            rpc["ns"] = rpc["calls"] = 0
            t0 = time.perf_counter()
            for _ in range(iters):
                res = fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
            return res, ms, rpc["ns"] / 1e6 / iters, rpc["calls"] / iters

        def ids_of(res):
            return np.array([[r.id for r, _d in row] for row in res])

        def dists_of(res):
            return np.array([[d for _r, d in row] for row in res])

        def kv_ingest(ds, tb, xs_):
            """bench.py's _bulk_vectors through the port's KV: a record
            and an `he` key a row, then `vn`, in one transaction."""
            t = ds.transaction(write=True)
            try:
                for i in range(xs_.shape[0]):
                    t.set(K.record("b", "b", tb, i),
                          serialize({"id": RecordId(tb, i)}))
                    t.set_val(K.ix_state("b", "b", tb, "ix", b"he",
                                         K.enc_value(i)), xs_[i].tobytes())
                t.set_val(K.ix_state("b", "b", tb, "ix", b"vn"),
                          xs_.shape[0])
                t.commit()
            except BaseException:
                t.cancel()
                raise

        def recall(got_ids, oracle):
            return float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                                  / oracle.shape[1]
                                  for a, b in zip(got_ids, oracle)]))

        def drop(ix):
            sup_.call("vec_drop", {"key": ix._dev_key})
            sup_.forget(ix._dev_key)

        def cos_params(dim_):
            return {"dimension": dim_, "distance": "cosine",
                    "vector_type": "f32"}

        def sql_catalog(ds, tb, dim_):
            """The table and its HNSW index through the port's SQL (as
            bench.py defines them before its KV ingest)."""
            ds.query(f"DEFINE TABLE {tb}; DEFINE INDEX ix ON {tb} FIELDS "
                     f"emb HNSW DIMENSION {dim_} DIST COSINE TYPE F32",
                     ns="b", db="b")

        def index_of(ds, ctx, tb):
            """The engine of `tb`'s index, through the catalog."""
            return V.get_vector_index(get_indexes(tb, ctx)[0], ctx)

        # the datastores the sql phase queries next (None: no sql phase)
        keep = data.get("sql")

        def knn10m_path():
            xs_, q_ = data["xs10"], data["q10"]
            n_ = xs_.shape[0]
            cnf.KNN_ANN_MODE = "off"
            t0 = time.perf_counter()
            ix = V.TpuVectorIndex("b", "b", "tbl10m", "ix",
                                  cos_params(xs_.shape[1]))
            if keep is not None:
                # the seeded engine behind a catalog of the port's SQL:
                # `vn` at the engine's version, so a query's sync keeps it
                ds = Datastore()
                sql_catalog(ds, "tbl10m", xs_.shape[1])
                t = ds.transaction(write=True)
                t.set_val(K.ix_state("b", "b", "tbl10m", "ix", b"vn"), 1)
                t.commit()
                ds.vector_indexes[("b", "b", "tbl10m", "ix")] = ix
            ix.vecs = xs_
            ix.valid = np.ones(n_, dtype=bool)
            ix.rids = [RecordId("tbl10m", i) for i in range(n_)]
            ix.version = 1
            out = {"rows": n_, "dim": xs_.shape[1],
                   "seed_s": time.perf_counter() - t0}
            if data.get("knn10m_store"):
                ix._dev_key, tag = data["knn10m_store"]
                check(list(tag) == [ix.version, ix._dev_epoch],
                      f"knn10m store tag {tag}")
                out["store"] = "resident (the runner path's vec_load)"
            t0 = time.perf_counter()
            ix.knn_batch(q_[:1], k_)
            out["first_call_s"] = time.perf_counter() - t0
            check(ix.rank_mode == "int8", f"knn10m rank mode {ix.rank_mode}")
            kc_ = min(n_, max(cnf.KNN_INT8_OVERSAMPLE * k_, k_ + 16))
            tag = [ix.version, ix._dev_epoch]
            for bsz in (1, 512):
                res, ms, rpc_ms, calls = timed(
                    lambda: ix.knn_batch(q_[:bsz], k_), 2)
                check(calls == 1, f"knn10m B={bsz}: {calls} frames a call")
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
                out[f"B{bsz}_frame_ms"] = rpc_ms
                out[f"B{bsz}_host_ms"] = ms - rpc_ms
                out[f"B{bsz}_host_share"] = (ms - rpc_ms) / ms
            # the runner frame's candidates rescored here in f64 (an
            # independent formula): ids equal wherever distances are apart
            t, m, (cand,) = sup_.call("vec_knn", {"key": ix._dev_key,
                                                   "tag": tag, "k": k_},
                                      [q_])
            check(t == "ok" and m["mode"] == "cand" and m["kc"] == kc_,
                  f"knn10m frame {t} {m}")
            nchk = 32
            ref_d, ref_i = [], []
            for qi in range(nchk):
                rows_ = xs_[cand[qi]].astype(np.float64)
                qv = q_[qi].astype(np.float64)
                d_ = 1.0 - rows_ @ qv / np.maximum(
                    np.linalg.norm(rows_, axis=1) * np.linalg.norm(qv),
                    1e-300)
                o_ = np.argsort(d_, kind="stable")[:k_ + 1]
                ref_d.append(d_[o_])
                ref_i.append(cand[qi][o_])
            got = res[:nchk]
            check(np.allclose(dists_of(got), np.array(ref_d)[:, :k_],
                              atol=1e-6, rtol=0),
                  "knn10m distances differ from the frame's f64 rescore")
            check_ids_past(np.array(ref_d), np.array(ref_i), ids_of(got),
                           "knn10m engine vs the frame's rescore", 1e-6)
            oracle = data.get("oracle10")
            if oracle is None:
                oracle = cosine_oracle(xs_, q_[:KNN10M["recall_q"]], k_)
            out["recall_at_10"] = recall(ids_of(res[:len(oracle)]), oracle)
            check(out["recall_at_10"] >= 0.95,
                  f"knn10m engine recall@10 {out['recall_at_10']} < 0.95")
            out["kc"] = kc_
            if keep is not None:
                # the resident store serves the sql phase, which drops it
                keep["knn10m"] = {"ds": ds, "ix": ix, "qs": q_,
                                  "oracle": oracle}
            else:
                drop(ix)
            return out

        def knn1m_path():
            xs_, q_ = data["xs1m"], data["qs1m"]
            n_ = xs_.shape[0]
            cnf.KNN_ANN_MODE = "off"
            ds = Datastore()
            sql_catalog(ds, "tbl", xs_.shape[1])
            t0 = time.perf_counter()
            kv_ingest(ds, "tbl", xs_)
            out = {"rows": n_, "dim": xs_.shape[1],
                   "ingest_s": time.perf_counter() - t0}
            ctx = ds.context("b", "b")
            ix = index_of(ds, ctx, "tbl")
            t0 = time.perf_counter()
            ix.sync(ctx)
            out["sync_s"] = time.perf_counter() - t0
            check(len(ix.rids) == n_ and np.array_equal(ix.vecs[-1], xs_[-1]),
                  "knn1m engine rows after the first sync")
            t0 = time.perf_counter()
            ix.knn_batch(q_[:1], k_)
            out["first_call_s"] = time.perf_counter() - t0  # the ship
            check(ix.rank_mode == "bf16", f"knn1m rank mode {ix.rank_mode}")
            tag = [ix.version, ix._dev_epoch]
            meta = {"key": ix._dev_key, "tag": tag, "k": k_}
            for bsz in KNN1M["batches"]:
                res, ms, rpc_ms, calls = timed(
                    lambda: ix.knn_batch(q_[:bsz], k_), 5)
                check(calls == 1, f"knn1m B={bsz}: {calls} frames a call")
                t1 = time.perf_counter()
                for _ in range(5):
                    _, _, (fd, fi) = sup_.call("vec_knn", meta, [q_[:bsz]])
                frame_ms = (time.perf_counter() - t1) * 1e3 / 5
                # the engine's answers are the frame's, row for row
                check(np.array_equal(dists_of(res), fd.astype(np.float64)),
                      f"knn1m B={bsz}: distances differ from the frame's")
                check_ids(fd, fi, ids_of(res), f"knn1m engine B={bsz}")
                # the engine's tax: its call less the runner frame inside
                # it (`device_rpc`); beside it a bare frame's ms
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
                out[f"B{bsz}_rpc_ms"] = rpc_ms
                out[f"B{bsz}_tax_ms"] = ms - rpc_ms
                out[f"B{bsz}_frame_ms"] = frame_ms
                if bsz == max(KNN1M["batches"]):
                    full_d, full_i = fd, fi
            # 32 threads x 8 single-query knn calls through the coalescer
            nt, rounds = BATCH["threads"], BATCH["rounds"]
            got, errors = [None] * (nt * rounds), []

            def client(t):
                try:
                    c_ = ds.context("b", "b")
                    for r in range(rounds):
                        i = r * nt + t
                        got[i] = ix.knn(q_[i].tolist(), k_, c_)
                except Exception as e:  # collected, then checked
                    errors.append(f"thread {t}: {e!r}")

            before = BT.BATCH_STATS.to_dict()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(nt)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            co_s = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"knn1m coalescer: {errors[:3]}")
            after = BT.BATCH_STATS.to_dict()
            disp = after["dispatches"] - before["dispatches"]
            nq_ = nt * rounds
            check(np.allclose(dists_of(got), full_d[:nq_], atol=1e-4,
                              rtol=1e-5), "knn1m coalesced distances")
            check_ids(full_d[:nq_], full_i[:nq_], ids_of(got),
                      "knn1m coalesced knn vs the B=512 frame")
            out.update(coalesced_queries=nq_, coalesced_qps=nq_ / co_s,
                       coalesced_dispatches=disp,
                       coalesced_batch_avg=(after["riders"]
                                            - before["riders"]) / max(disp, 1))
            oracle = data.get("oracle1m")
            if oracle is None:
                oracle = cosine_oracle(xs_, q_[:16], k_)
            out["recall_at_10"] = recall(full_i[:len(oracle)], oracle)
            check(out["recall_at_10"] >= 0.99,
                  f"knn1m engine recall@10 {out['recall_at_10']} < 0.99")
            drop(ix)
            ctx.txn.cancel()
            if keep is not None:
                keep["knn1m"] = {"ds": ds, "xs": xs_, "qs": q_}
            return out

        def exact_path():
            rng_ = np.random.default_rng(BRUTE["seed"])
            xs_ = rng_.standard_normal((BRUTE["n"], BRUTE["dim"]),
                                       dtype=np.float32)
            q_ = rng_.standard_normal((128, BRUTE["dim"]), dtype=np.float32)
            out = {"rows": BRUTE["n"], "dim": BRUTE["dim"]}
            ds = Datastore()
            kv_ingest(ds, "ex", xs_)
            for metric in ("manhattan", "pearson"):
                ctx = ds.context("b", "b")
                ix = V.TpuVectorIndex("b", "b", "ex", "ix", {
                    "dimension": BRUTE["dim"], "distance": metric,
                    "vector_type": "f32"})
                ix.sync(ctx)
                for bsz in (1, 128):
                    res, ms, _, _ = timed(lambda: ix.knn_batch(q_[:bsz], k_),
                                          5)
                    check(ix.rank_mode is None, f"exact store {ix.rank_mode}")
                    host = ix._host_knn_multi(q_[:bsz], k_ + 1)
                    hd = dists_of(host)
                    check(np.allclose(dists_of(res), hd[:, :k_], atol=1e-4,
                                      rtol=1e-5),
                          f"exact {metric} B={bsz}: distances vs the host")
                    check_ids_past(hd, ids_of(host), ids_of(res),
                                   f"exact {metric} B={bsz} vs the host",
                                   1e-4, 1e-5)
                    out[f"{metric}_B{bsz}_ms"] = ms
                drop(ix)
                ctx.txn.cancel()
            return out

        def ann_path():
            xs_, q_ = data["ann_xs"], data["ann_qs"]
            n_, dim_ = xs_.shape
            cnf.KNN_ANN_MODE = "auto"
            ds = Datastore()
            sql_catalog(ds, "ann", dim_)
            t0 = time.perf_counter()
            kv_ingest(ds, "ann", xs_)
            out = {"rows": n_, "dim": dim_,
                   "ingest_s": time.perf_counter() - t0}
            ctx = ds.context("b", "b")
            idef = get_indexes("ann", ctx)[0]
            ix = V.get_vector_index(idef, ctx)
            t0 = time.perf_counter()
            ix.sync(ctx)  # past KNN_ANN_MIN_ROWS: a background build starts
            out["sync_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(ix.ensure_ann(), "ensure_ann: no ready graph")
            out["ensure_ann_s"] = time.perf_counter() - t0
            out["build_s"] = ix._ann.build_s
            if data.get("ann_graph") is not None:
                check(np.array_equal(ix._ann.graph, data["ann_graph"]),
                      "the engine's graph differs from the ann path's build")
                out["graph_equal_ann_path"] = True
            check(ix.ann_plan(k_) == {"ann": "graph"}, "ann plan")
            for bsz in (1, 512):
                res, ms, rpc_ms, calls = timed(
                    lambda: ix.knn_batch(q_[:bsz], k_), 5)
                check(calls == 1, f"ann B={bsz}: {calls} frames a call")
                out[f"B{bsz}_ms"] = ms
                out[f"B{bsz}_qps"] = bsz / ms * 1e3
                out[f"B{bsz}_frame_ms"] = rpc_ms
            oracle = data.get("ann_oracle")
            if oracle is None:
                oracle = cosine_oracle(xs_, q_[:ANN["recall_q"]], k_)
            out["recall_at_10"] = recall(ids_of(res[:len(oracle)]), oracle)
            check(out["recall_at_10"] >= 0.95,
                  f"ann engine recall@10 {out['recall_at_10']} < 0.95")
            # overwrite, delete and append through the write path: rows
            # set to queries 0..63 (each must rank first), the first
            # answers of queries 64..127 deleted, 100 rows appended as
            # copies of queries 128..227
            first = ids_of(res)[:, 0]
            rng_ = np.random.default_rng(ANN["seed"] + 1)
            over = rng_.choice(n_, 64, replace=False)
            dels = sorted(set(first[64:128].tolist()) - set(over.tolist()))
            wctx = ds.context("b", "b", write=True)
            for j, r in enumerate(over):
                V.vector_index_update(idef, RecordId("ann", int(r)),
                                      {"emb": xs_[r].tolist()},
                                      {"emb": q_[j].tolist()}, wctx)
            for r in dels:
                V.vector_index_update(idef, RecordId("ann", int(r)),
                                      {"emb": xs_[r].tolist()}, NONE, wctx)
            for j in range(100):
                V.vector_index_update(idef, RecordId("ann", n_ + j), NONE,
                                      {"emb": q_[128 + j].tolist()}, wctx)
            wctx.txn.commit()
            rctx = ds.context("b", "b")
            t0 = time.perf_counter()
            ix.sync(rctx)
            out["oplog_sync_s"] = time.perf_counter() - t0
            check(ix._ann is not None and len(ix._ann_dirty) == len(over)
                  and len(ix.rids) == n_ + 100
                  and int((~ix.valid).sum()) == len(dels),
                  "ann engine state after the op log")
            nq_ = 256
            res = ix.knn_batch(q_[:nq_], k_)
            got_i = ids_of(res)
            check(all(got_i[j, 0] == over[j] for j in range(64)),
                  "an overwritten row is not its query's first answer")
            check(all(got_i[128 + j, 0] == n_ + j for j in range(100)),
                  "an appended row is not its query's first answer")
            check(not set(dels) & set(got_i.ravel().tolist()),
                  "a deleted row was answered")
            # every answer against a brute rescore of the remaining rows:
            # their distances against an f64 cosine computed here (an
            # independent formula), in order, and recall@10 against the
            # f64 top 10 of every valid row
            valid_ids = np.nonzero(ix.valid)[0]
            brute = valid_ids[cosine_oracle(ix.vecs[valid_ids], q_[:nq_],
                                            k_)]
            exact_d = True
            for qi in range(nq_):
                rows_ = ix.vecs[got_i[qi]].astype(np.float64)
                qv = q_[qi].astype(np.float64)
                d_ = 1.0 - rows_ @ qv / np.maximum(
                    np.linalg.norm(rows_, axis=1) * np.linalg.norm(qv),
                    1e-300)
                got_d = dists_of(res[qi:qi + 1])[0]
                exact_d &= bool(np.allclose(got_d, d_, atol=1e-6, rtol=0)
                                and np.all(np.diff(got_d) >= 0))
            out["merge_recall_at_10"] = recall(got_i, brute)
            check(exact_d, "ann answers' distances are not the exact ones")
            check(out["merge_recall_at_10"] >= 0.95,
                  f"ann merge recall@10 {out['merge_recall_at_10']}")
            out.update(overwritten=len(over), deleted=len(dels), appended=100,
                       dirty_rows=len(ix._ann_dirty),
                       host_descents=ix.ann_host_descents,
                       full_rebuilds=ix.ann_full_rebuilds)
            check(ix.ann_host_descents == 0,
                  f"the ANN numpy descent ran {ix.ann_host_descents} times")
            sup_.call("ann_drop", {"key": ix._ann_dev_key})
            sup_.forget(ix._ann_dev_key)
            rctx.txn.cancel()
            ctx.txn.cancel()
            if keep is not None:
                keep["ann"] = {"ds": ds, "ix": ix, "qs": q_}
            return out

        def hops(g, label, out, riders):
            """multi_hop at B = 1 and `riders` concurrent riders, both
            modes, masks bit-equal to the numpy multi-hop."""
            n_ = g.n_nodes()

            def want_ids(s, union):
                mask = np.zeros(n_, bool)
                mask[g.node_index[K.enc_value(s)]] = True
                w = g._host_multi_hop(mask, GRAPH["hops"], union)
                return [g.node_ids[i] for i in np.nonzero(w)[0]]

            for union in (False, True):
                mode = "union" if union else "frontier"
                s0 = g.node_ids[0]
                g.multi_hop([s0], GRAPH["hops"], mode)  # warm (and ship)
                t0 = time.perf_counter()
                for _ in range(3):
                    got = g.multi_hop([s0], GRAPH["hops"], mode)
                out[f"{label}_B1_{mode}_ms"] = (time.perf_counter()
                                                - t0) * 1e3 / 3
                check(got == want_ids(s0, union),
                      f"graph {label} B=1 {mode}: not the numpy multi-hop")
                res, errs = [None] * riders, []
                gate = threading.Barrier(riders)

                def rider(i):
                    try:
                        gate.wait()
                        res[i] = g.multi_hop([g.node_ids[i]], GRAPH["hops"],
                                             mode)
                    except Exception as e:  # collected, then checked
                        errs.append(repr(e))

                before = BT.BATCH_STATS.to_dict()
                threads = [threading.Thread(target=rider, args=(i,))
                           for i in range(riders)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                out[f"{label}_B{riders}_{mode}_ms"] = (time.perf_counter()
                                                       - t0) * 1e3
                after = BT.BATCH_STATS.to_dict()
                check(not errs, f"graph {label} riders: {errs[:3]}")
                out[f"{label}_B{riders}_{mode}_dispatches"] = (
                    after["dispatches"] - before["dispatches"])
                for i in range(riders):
                    check(res[i] == want_ids(g.node_ids[i], union),
                          f"graph {label} rider {i} {mode}: not the numpy "
                          f"multi-hop")
                out[f"{label}_B1_{mode}_reached"] = len(got)

        def graph_path():
            out = {}
            # the reference's quick size through the KV: the four `~`
            # keys an edge, as bench.py writes them
            nq_, eq_ = 20_000, 200_000
            rng_ = np.random.default_rng(GRAPH["seed"])
            src_, dst_ = (rng_.integers(0, nq_, eq_) for _ in range(2))
            ds = Datastore()
            ds.query("DEFINE TABLE person; DEFINE TABLE knows TYPE RELATION",
                     ns="b", db="b")
            t0 = time.perf_counter()
            t = ds.transaction(write=True)
            for i in range(nq_):
                t.set(K.record("b", "b", "person", i),
                      serialize({"id": RecordId("person", i)}))
            for e in range(eq_):
                s, d = int(src_[e]), int(dst_[e])
                t.set(K.record("b", "b", "knows", e), serialize({
                    "id": RecordId("knows", e),
                    "in": RecordId("person", s),
                    "out": RecordId("person", d)}))
                t.set(K.graph("b", "b", "person", s, K.DIR_OUT, "knows", e),
                      b"")
                t.set(K.graph("b", "b", "knows", e, K.DIR_IN, "person", s),
                      b"")
                t.set(K.graph("b", "b", "knows", e, K.DIR_OUT, "person", d),
                      b"")
                t.set(K.graph("b", "b", "person", d, K.DIR_IN, "knows", e),
                      b"")
            t.commit()
            out["quick_ingest_s"] = time.perf_counter() - t0
            ctx = ds.context("b", "b")
            t0 = time.perf_counter()
            g = G.get_csr(ds, ctx, "person", "knows", "out")
            out["quick_build_s"] = time.perf_counter() - t0
            check(len(g.rows) == eq_ and g.n_nodes() <= nq_,
                  f"quick CSR: {len(g.rows)} edges, {g.n_nodes()} nodes")
            ids_ = np.asarray(g.node_ids)
            check(sorted(zip(ids_[g.rows].tolist(), ids_[g.cols].tolist()))
                  == sorted(zip(src_.tolist(), dst_.tolist())),
                  "quick CSR edges differ from the written ones")
            out.update(quick_nodes=g.n_nodes(), quick_edges=len(g.rows))
            hops(g, "quick", out, GRAPH["batches"][-1])
            ctx.txn.cancel()
            if keep is not None:
                keep["graph"] = {"ds": ds, "src": src_, "dst": dst_}
            del ds, g
            # the BASELINE size, arrays seeded directly (its KV ingest is
            # 50M Python writes)
            src_np_, dst_np_ = data["src"], data["dst"]
            n_ = GRAPH["nodes"]
            t0 = time.perf_counter()
            g = G.CsrGraph("b", "b", "person", "knows", "out")
            g.node_ids = list(range(n_))
            g.node_index = {K.enc_value(i): i for i in range(n_)}
            g.rows, g.cols = src_np_, dst_np_
            g.edge_ids = []
            g._built, g.version = True, 0
            out["full_seed_s"] = time.perf_counter() - t0
            out.update(full_nodes=n_, full_edges=len(src_np_))
            hops(g, "full", out, GRAPH["batches"][-1])
            sup_.call("csr_drop", {"key": g._dev_key})
            return out

        try:
            if data.get("xs10") is not None:
                path("knn10m", knn10m_path, (
                    "rank_scores_int8", "rank_candidates_int8",
                    "select_topk_rows", "select_topk_pairs")
                    + (() if data.get("knn10m_store")
                       else ("quantize_rows_int8",)))
                data["xs10"] = None
            path("knn1m", knn1m_path, ("rank_scores_bf16", "select_topk_rows",
                                       "gather_rescore",
                                       "gather_rescore_topk"))
            path("exact", exact_path, ("distance_tile", "distance_tile_simt",
                                       "distance_tile_tf32",
                                       "distance_row_stats",
                                       "select_topk_rows"))
            path("ann", ann_path, ("ann_descent", "rank_scores_int8",
                                   "select_topk_rows"))
            path("graph", graph_path, ("csr_hop_step",))
            ctr = dict(sup_.counters)
            check(ctr["device_fallbacks"] == 0
                  and ctr["device_host_routed"] == 0,
                  f"a fallback hid the card: {ctr}")
            check(sup_.mode == "require", f"supervisor mode {sup_.mode}")
            emit("engine", mode=sup_.mode, counters=ctr,
                 paths=sorted(out_all),
                 seconds=round(time.perf_counter() - t_0, 3))
        finally:
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            resource.set_accountant(old_acct)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    def engine_only(with_sql=False, with_auth=False, with_ml=False,
                    with_api=False, with_server=False):
        """`--only engine`: the engine phase over rows made here (the
        knn10m rows shipped by the engine itself), under a supervisor in
        mode require of its own; `--only sql`: the same, then the sql
        phase over the engine's datastores; `--only auth`: then the auth
        phase over knn1m's; `--only ml`: then phase ml over auth's
        server; `--only api`: then phase api over auth's server (after
        ml when both are named); `--only server`: then the auth and
        server phases over knn1m's (the server's writes go to auth's
        `acl`)."""
        rng_ = np.random.default_rng(KNN1M["seed"])
        xs1 = rng_.standard_normal((KNN1M["n"], KNN1M["dim"]),
                                   dtype=np.float32)
        qs1 = rng_.standard_normal((max(KNN1M["batches"]), KNN1M["dim"]),
                                   dtype=np.float32)
        axs, aqs = ann_rows()
        grng = np.random.default_rng(GRAPH["seed"])
        src_ = grng.integers(0, GRAPH["nodes"],
                             size=GRAPH["edges"]).astype(np.int32)
        dst_ = grng.integers(0, GRAPH["nodes"],
                             size=GRAPH["edges"]).astype(np.int32)
        data = {"xs1m": xs1, "qs1m": qs1, "ann_xs": axs, "ann_qs": aqs,
                "src": src_, "dst": dst_,
                "xs10": normal_rows(KNN10M["n"], KNN10M["dim"],
                                    KNN10M["seed"]),
                "q10": normal_rows(max(KNN10M["batches"]), KNN10M["dim"],
                                   KNN10M["seed"] + 1)}
        del xs1, axs
        if with_sql:
            data["sql"] = {}
        sup_ = DeviceSupervisor("require", device="cuda")
        try:
            sup_.start()
            engine_phase(sup_, data)
            if with_sql:
                sql_phase(sup_, data["sql"], keep_knn1m=with_auth)
            if with_auth:
                knn1m_d = data["sql"].pop("knn1m")
                auth_phase(sup_, knn1m_d, keep_server=with_ml or with_api)
                if with_ml:
                    ml_phase(sup_, knn1m_d, keep_server=with_api)
                if with_api:
                    api_phase(sup_, knn1m_d)
                if with_server:
                    server_phase(sup_, knn1m_d)
        finally:
            sup_.shutdown()

    # -- the SurrealQL stack over the engine phase's datastores (also
    # `--only sql`) -------------------------------------------------------
    def cosine_top(xs_, qs_, kk, step=1 << 19):
        """(f64 cosine distances, row ids) of the exact top kk of qs_
        over the host rows xs_, streamed through the card in blocks."""
        qn = torch.from_numpy(np.ascontiguousarray(qs_)).to(dev).double()
        qn = qn / qn.norm(dim=1, keepdim=True).clamp_min(1e-30)
        tv_, ti_ = [], []
        for s0 in range(0, xs_.shape[0], step):
            b64 = torch.from_numpy(xs_[s0:s0 + step]).to(dev).double()
            sims = (b64 @ qn.T) / b64.norm(dim=1).clamp_min(1e-30)[:, None]
            v_, i_ = torch.topk(sims, min(kk, sims.shape[0]), dim=0)
            tv_.append(v_)
            ti_.append(i_ + s0)
            del b64, sims
        v_, sel_ = torch.topk(torch.cat(tv_), kk, dim=0)
        ids = torch.gather(torch.cat(ti_), 0, sel_)
        return (1.0 - v_).T.cpu().numpy(), ids.T.cpu().numpy()

    def sql_phase(sup_, sq, counts=None, keep_knn1m=False):
        """SurrealQL through the port's `Datastore.execute` over the
        engine phase's datastores (`sq`), under `sup_` (mode require):
        knn1m (`<|10,40|>` as bench.py drives it: 3 queries, 128 at 128
        clients, then SQL["knn1m"] at 128 clients; index_engine_qps of
        the same engine as bench.py measures it; recall@10 of 16 queries
        and the `vector::distance::knn()` distances against the f64
        oracle; a `cond` query held to the oracle over the rows it keeps;
        CREATE, UPDATE and DELETE each seen by the next k=1 probe),
        knn10m (the resident int8 store, `<|10|>` at 128 clients,
        recall@10 of 8 queries), ann (`<|10,40|>` over the graph-ANN
        store, recall@10 of 16 queries against the f64 top 10 of the
        rows left after the engine's writes, no numpy descent), brute
        (BRUTE's rows with `emb` inline in a table with no index: the
        `vector::similarity::cosine` ORDER BY ... LIMIT scan and
        `<|10,COSINE|>`, both held to the f64 oracle) and graph (the
        engine's 20k-node graph: the 3-hop chain of bench.py equal to a
        numpy bag hop; it runs on the host, as the reference's). Each
        path prints its stage split from `telemetry`, per query: parse;
        plan (the planner less the index search or the brute device
        call inside it); coalescer_wait (index_knn less device_rpc: the
        wait in the batcher's coalescer, with the engine's own host
        work); device_rpc (a frame's time shared over its riders); and
        the rest of the latency."""
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch import telemetry as TEL
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.kvs.api import serialize
        from surrealdb_tpu_torch.kvs.ds import Datastore
        from surrealdb_tpu_torch.val import RecordId

        t_0 = time.perf_counter()
        k_ = KNN1M["k"]
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        old_sup = SV.set_supervisor(sup_)
        # nothing bound: the datastore binds its own serving stack (the
        # query budget, cancellation and the device_rpc stage)
        SV.bind_serving()
        out_all = {}

        def stages():
            return {name: (st.count, st.total_ns)
                    for name, st in list(TEL._STAGES.items())}

        def drive(ds, sql, qs_, iters, threads, check_rows=True):
            """`iters` queries from `threads` clients (bench.py's
            _run_queries): (qps, per-query latencies in ms)."""
            ql = [q.tolist() for q in qs_]
            lat = np.zeros(iters)

            def one(i):
                t0 = time.perf_counter()
                rows = ds.query_one(sql, ns="b", db="b",
                                    vars={"q": ql[i % len(ql)]})
                lat[i] = (time.perf_counter() - t0) * 1e3
                if check_rows:
                    check(rows, f"sql: no results for {sql}")

            t0 = time.perf_counter()
            if threads <= 1:
                for i in range(iters):
                    one(i)
            else:
                with ThreadPoolExecutor(threads) as ex:
                    list(ex.map(one, range(iters)))
            return iters / (time.perf_counter() - t0), lat

        def measured(ds, sql, qs_, iters, threads):
            """qps, p50, p99 and the stage split of `iters` queries."""
            before = stages()
            qps, lat = drive(ds, sql, qs_, iters, threads)
            after = stages()

            def per(name):
                c0, n0 = before.get(name, (0, 0))
                return (after.get(name, (0, 0))[1] - n0) / 1e6 / iters

            mean = float(lat.mean())
            # `plan` holds the index search (`index_knn`, with the
            # batcher wait and device_rpc inside it) or, for a brute
            # scan, the device call itself
            knn_, rpc_ = per("index_knn"), per("device_rpc")
            return {"queries": iters, "clients": threads, "qps": qps,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "mean_ms": mean,
                    "stages_ms": {
                        "parse": per("parse"),
                        "plan": per("plan") - max(knn_, rpc_),
                        "coalescer_wait": max(knn_ - rpc_, 0.0),
                        "device_rpc": rpc_,
                        "rest": mean - per("parse") - per("plan")}}

        def path(name, fn, needs, absent=(), after=None):
            """One SQL path with the runner's launch counts set to 0
            just before it and read just after; the kernels of `absent`
            must not have launched. `after(out)` runs once the counts
            are read (work that is not the path's own queries)."""
            sup_.call("launch_counts", {"reset": True})
            out = fn()
            _, m, _ = sup_.call("launch_counts", {})
            if counts is not None:
                for kname, v in m["launches"].items():
                    counts[kname] += v
            for kname in needs:
                check(m["launches"][kname] > 0,
                      f"sql {name}: kernel {kname} was not launched")
            for kname in absent:
                check(m["launches"].get(kname, 0) == 0,
                      f"sql {name}: kernel {kname} was launched "
                      f"{m['launches'].get(kname, 0)} times")
            if after is not None:
                after(out)
            emit(f"sql_{name}", **out,
                 launches={kn: v for kn, v in m["launches"].items() if v},
                 events=m["events"])
            out_all[name] = out

        def ids(rows):
            return [r["id"].id for r in rows]

        def recall(got, oracle):
            return float(np.mean([len(set(a) & set(b.tolist())) / len(b)
                                  for a, b in zip(got, oracle)]))

        def knn1m():
            d = sq["knn1m"]
            ds, xs_, q_ = d["ds"], d["xs"], d["qs"]
            cnf.KNN_ANN_MODE = "off"
            q64 = q_[:64]
            sql = "SELECT id FROM tbl WHERE emb <|10,40|> $q"
            t0 = time.perf_counter()
            drive(ds, sql, q64, 3, 1)  # the ship
            warm_s = time.perf_counter() - t0
            drive(ds, sql, q64, 128, 128)  # warm batched shapes
            out = measured(ds, sql, q64, SQL["knn1m"], 128)
            out["warm_s"] = warm_s
            out["sql_knn_qps"] = out.pop("qps")
            # recall@10 and vector::distance::knn() against the f64 oracle
            nq_ = 16
            od, oi = cosine_top(xs_, q_[:nq_], k_ + 1)
            got, dist_err = [], 0.0
            for qi in range(nq_):
                rows = ds.query_one(
                    "SELECT id, vector::distance::knn() AS d FROM tbl "
                    "WHERE emb <|10,40|> $q", ns="b", db="b",
                    vars={"q": q_[qi].tolist()})
                got.append(ids(rows))
                rx = xs_[ids(rows)].astype(np.float64)
                qv = q_[qi].astype(np.float64)
                d64 = 1.0 - rx @ qv / np.maximum(
                    np.linalg.norm(rx, axis=1) * np.linalg.norm(qv), 1e-300)
                dist_err = max(dist_err, float(np.abs(
                    np.array([r["d"] for r in rows]) - d64).max()))
            out["recall_at_10"] = recall(got, oi[:, :k_])
            out["knn_fn_max_abs_err"] = dist_err
            check(out["recall_at_10"] >= 0.99,
                  f"sql knn1m recall@10 {out['recall_at_10']} < 0.99")
            check(dist_err <= 1e-4,
                  f"sql knn1m vector::distance::knn() error {dist_err}")
            # a KNN operator ANDed with a predicate: the oracle over the
            # rows the predicate keeps
            half = xs_.shape[0] // 2
            cd, ci = cosine_top(xs_[half:], q_[:4], k_ + 1)
            got_c = []
            t0 = time.perf_counter()
            for qi in range(4):
                rows = ds.query_one(
                    f"SELECT id FROM tbl WHERE emb <|10|> $q AND "
                    f"id >= tbl:{half}", ns="b", db="b",
                    vars={"q": q_[qi].tolist()})
                got_c.append(ids(rows))
            out["cond_ms"] = (time.perf_counter() - t0) * 1e3 / 4
            check(all(len(g) == k_ for g in got_c), "sql cond: short answer")
            check_ids_past(cd, ci + half, np.array(got_c),
                           "sql cond vs oracle", 1e-4)
            # three writes, each seen by the next k=1 probe
            rid = xs_.shape[0] + 1
            probe = "SELECT id FROM tbl WHERE emb <|1|> $q"
            v1, v2 = q_[-1].tolist(), q_[-2].tolist()
            writes = [
                ("create", f"CREATE tbl:{rid} SET emb = $q", v1, v1, True),
                ("update", f"UPDATE tbl:{rid} SET emb = $q", v2, v2, True),
                ("delete", f"DELETE tbl:{rid}", v2, v2, False)]
            for wname, wsql, wv, pv, present in writes:
                t0 = time.perf_counter()
                ds.query(wsql, ns="b", db="b", vars={"q": wv})
                first = ids(ds.query_one(probe, ns="b", db="b",
                                         vars={"q": pv}))
                out[f"{wname}_probe_ms"] = (time.perf_counter() - t0) * 1e3
                check((first == [rid]) == present,
                      f"sql {wname}: the probe answered {first}")
            out["writes_seen"] = len(writes)
            return out

        def engine_qps(out):
            """bench.py's _index_engine_qps on the knn1m engine (one
            knn_batch of 64 x 64), outside the path's counted window,
            and the SQL path's share of it."""
            d = sq["knn1m"]
            ix = d["ds"].vector_indexes[("b", "b", "tbl", "ix")]
            big = np.repeat(d["qs"][:64], 64, axis=0)
            ix.knn_batch(big, k_)
            t0 = time.perf_counter()
            ix.knn_batch(big, k_)
            out["index_engine_qps"] = len(big) / (time.perf_counter() - t0)
            out["sql_over_engine"] = (out["sql_knn_qps"]
                                      / out["index_engine_qps"])

        def knn10m():
            d = sq.pop("knn10m")
            ds, ix, q_, oracle = d["ds"], d["ix"], d["qs"], d["oracle"]
            cnf.KNN_ANN_MODE = "off"
            sql = "SELECT id FROM tbl10m WHERE emb <|10|> $q"
            q64 = q_[:64]
            drive(ds, sql, q64, 2, 1)
            drive(ds, sql, q64, 128, 128)
            out = measured(ds, sql, q64, SQL["knn10m"], 128)
            out["sql_knn_qps"] = out.pop("qps")
            nq_ = min(8, len(oracle))
            got = [ids(ds.query_one(sql, ns="b", db="b",
                                    vars={"q": q_[qi].tolist()}))
                   for qi in range(nq_)]
            out["recall_at_10"] = recall(got, oracle[:nq_])
            check(out["recall_at_10"] >= 0.95,
                  f"sql knn10m recall@10 {out['recall_at_10']} < 0.95")
            check(ix.rank_mode == "int8", f"knn10m rank mode {ix.rank_mode}")
            sq["explain_knn10m"] = d
            return out

        def ann():
            d = sq["ann"]
            ds, ix, q_ = d["ds"], d["ix"], d["qs"]
            cnf.KNN_ANN_MODE = "auto"
            hd0 = ix.ann_host_descents
            sql = "SELECT id FROM ann WHERE emb <|10,40|> $q"
            q64 = q_[:64]
            drive(ds, sql, q64, 2, 1)
            out = measured(ds, sql, q64, SQL["ann"], 64)
            nq_ = 16
            valid = np.nonzero(ix.valid)[0]
            _od, oi = cosine_top(ix.vecs[valid], q_[:nq_], k_)
            got = [ids(ds.query_one(sql, ns="b", db="b",
                                    vars={"q": q_[qi].tolist()}))
                   for qi in range(nq_)]
            # row i of the engine holds record id i (the appended rows
            # follow the first n)
            out["recall_at_10"] = recall(got, valid[oi])
            out["host_descents"] = ix.ann_host_descents - hd0
            check(out["recall_at_10"] >= 0.95,
                  f"sql ann recall@10 {out['recall_at_10']} < 0.95")
            check(ix.ann_host_descents == hd0,
                  "sql ann: the numpy descent ran")
            return out

        def explain(ds, tb, q, fetched=True):
            """BASELINE config 2's query under EXPLAIN (the plan names
            the HNSW index and the KNN operator) and EXPLAIN FULL, which
            executes it: its Fetch line counts the 10 rows when the
            records are in the KV (knn1m), and the path's launches are
            the query's."""
            sql = f"SELECT id FROM {tb} WHERE emb <|10,40|> $q"
            vars_ = {"q": q.tolist()}
            out = {}
            for form in ("EXPLAIN", "EXPLAIN FULL"):
                t0 = time.perf_counter()
                plan = ds.query_one(f"{form} {sql}", ns="b", db="b",
                                    vars=vars_)
                out[f"{form.lower().replace(' ', '_')}_ms"] = (
                    time.perf_counter() - t0) * 1e3
                head = plan[0]
                check(head["operation"] == "Iterate Index"
                      and head["detail"]["table"] == tb
                      and head["detail"]["plan"]["index"] == "ix"
                      and head["detail"]["plan"]["operator"] == "<|10,40|>",
                      f"sql {form} {tb}: plan {head}")
                out[form.lower().replace(" ", "_")] = [
                    {"operation": p["operation"],
                     **({"count": p["detail"]["count"]}
                        if p["operation"] == "Fetch" else {})}
                    for p in plan]
            fetch = [p for p in out["explain_full"]
                     if p["operation"] == "Fetch"]
            check(len(fetch) == 1, f"sql EXPLAIN FULL {tb}: {fetch}")
            if fetched:
                check(fetch[0]["count"] == k_,
                      f"sql EXPLAIN FULL {tb}: fetched {fetch[0]['count']}")
            return out

        def explain_knn1m():
            d = sq["knn1m"]
            cnf.KNN_ANN_MODE = "off"
            return explain(d["ds"], "tbl", d["qs"][5])

        def explain_knn10m():
            d = sq.pop("explain_knn10m")
            ix = d["ix"]
            cnf.KNN_ANN_MODE = "off"
            out = explain(d["ds"], "tbl10m", d["qs"][5], fetched=False)
            sup_.call("vec_drop", {"key": ix._dev_key})
            sup_.forget(ix._dev_key)
            return out

        def explain_ann():
            d = sq["ann"]
            ix = d["ix"]
            cnf.KNN_ANN_MODE = "auto"
            hd0 = ix.ann_host_descents
            out = explain(d["ds"], "ann", d["qs"][5], fetched=False)
            check(ix.ann_host_descents == hd0,
                  "sql EXPLAIN FULL ann: the numpy descent ran")
            sup_.call("ann_drop", {"key": ix._ann_dev_key})
            sup_.forget(ix._ann_dev_key)
            return out

        def info():
            """INFO FOR DB, TABLE and INDEX on the knn1m datastore, and
            INFO FOR SYSTEM: its device section is this supervisor's
            (mode require, ready) and its knn section the engines'."""
            ds = sq["knn1m"]["ds"]
            t0 = time.perf_counter()
            db_, tb_, ix_, sys_ = (
                r.unwrap() for r in ds.execute(
                    "INFO FOR DB; INFO FOR TABLE tbl; "
                    "INFO FOR INDEX ix ON tbl; INFO FOR SYSTEM",
                    ns="b", db="b"))
            out = {"ms": (time.perf_counter() - t0) * 1e3}
            check(set(db_["tables"]) >= {"tbl"}
                  and db_["tables"]["tbl"].startswith("DEFINE TABLE tbl"),
                  f"INFO FOR DB: {db_['tables']}")
            check(tb_["indexes"].get("ix", "").startswith(
                "DEFINE INDEX ix ON tbl FIELDS emb HNSW DIMENSION "
                f"{KNN1M['dim']}"), f"INFO FOR TABLE: {tb_['indexes']}")
            check(ix_["building"]["status"] == "ready",
                  f"INFO FOR INDEX: {ix_}")
            dev_ = sys_["device"]
            check(dev_["mode"] == "require" and dev_["state"] == "ready",
                  f"INFO FOR SYSTEM device: {dev_}")
            check(any(e["index"] == "b.b.tbl.ix" for e in sys_.get("knn", [])),
                  f"INFO FOR SYSTEM knn: {sys_.get('knn')}")
            out.update(index=tb_["indexes"]["ix"], building=ix_["building"],
                       device={f_: dev_.get(f_) for f_ in
                               ("mode", "state", "platform", "restarts")},
                       system_keys=sorted(sys_))
            return out

        def brute():
            rng_ = np.random.default_rng(BRUTE["seed"])
            xs_ = rng_.normal(size=(BRUTE["n"], BRUTE["dim"])).astype(
                np.float32)
            q_ = rng_.normal(size=(8, BRUTE["dim"])).astype(np.float32)
            ds = Datastore()
            ds.query("DEFINE TABLE tbl", ns="b", db="b")
            t = ds.transaction(write=True)
            for i in range(xs_.shape[0]):
                t.set(K.record("b", "b", "tbl", i), serialize(
                    {"id": RecordId("tbl", i), "emb": xs_[i].tolist()}))
            t.commit()
            od, oi = cosine_top(xs_, q_, k_ + 1)
            out = {"rows": BRUTE["n"], "dim": BRUTE["dim"]}
            forms = {
                "order_by": ("SELECT id, vector::similarity::cosine(emb, $q) "
                             "AS s FROM tbl ORDER BY s DESC LIMIT 10", "s",
                             lambda s: 1.0 - s, 1e-9),
                "knn_cosine": ("SELECT id, vector::distance::knn() AS d "
                               "FROM tbl WHERE emb <|10,COSINE|> $q", "d",
                               lambda d: d, 1e-4)}
            for fname, (sql, col, to_d, tol) in forms.items():
                drive(ds, sql, q_, 2, 1)
                res = [ds.query_one(sql, ns="b", db="b",
                                    vars={"q": q.tolist()}) for q in q_]
                got_d = np.array([[to_d(r[col]) for r in rows]
                                  for rows in res])
                err = float(np.abs(got_d - od[:, :k_]).max())
                check(err <= tol, f"sql brute {fname}: distance error {err}")
                check_ids_past(od, oi, np.array([ids(r) for r in res]),
                               f"sql brute {fname} vs oracle", 1e-4)
                m = measured(ds, sql, q_, 32, 1)
                out[fname] = {"max_abs_err": err, "qps": m["qps"],
                              "p50_ms": m["p50_ms"],
                              "stages_ms": m["stages_ms"]}
            out["order_by_runs_on"] = "host (columnar numpy, as the reference)"
            return out

        def graph():
            d = sq.pop("graph")
            ds, src_, dst_ = d["ds"], d["src"], d["dst"]
            sql = ("SELECT VALUE ->knows->person->knows->person->knows->"
                   "person FROM person:0")
            t0 = time.perf_counter()
            (got,) = ds.query_one(sql, ns="b", db="b")  # one source row
            out = {"first_ms": (time.perf_counter() - t0) * 1e3}
            # the numpy bag hop: every edge out of every frontier entry
            order = np.argsort(src_, kind="stable")
            s_sorted, d_sorted = src_[order], dst_[order]
            front = np.array([0])
            for _ in range(3):
                lo = np.searchsorted(s_sorted, front, "left")
                hi = np.searchsorted(s_sorted, front, "right")
                front = np.concatenate(
                    [d_sorted[a:b] for a, b in zip(lo, hi)] or [[]]
                ).astype(np.int64)
            got_ids = sorted(r.id for r in got)
            check(got_ids == sorted(front.tolist()),
                  f"sql graph: {len(got_ids)} ids, the numpy bag hop "
                  f"{len(front)}")
            t0 = time.perf_counter()
            for _ in range(3):
                ds.query_one(sql, ns="b", db="b")
            out.update(ms=(time.perf_counter() - t0) * 1e3 / 3,
                       reached=len(got_ids), runs_on="host")
            return out

        try:
            brute_ = ("distance_tile", "distance_tile_tf32",
                      "distance_tile_simt")
            if "knn10m" in sq:
                path("knn10m", knn10m, ("rank_scores_int8",
                                        "rank_candidates_int8",
                                        "select_topk_pairs"), absent=brute_)
                path("explain_knn10m", explain_knn10m,
                     ("rank_scores_int8", "rank_candidates_int8",
                      "select_topk_pairs"), absent=brute_)
            path("knn1m", knn1m, ("rank_scores_bf16", "select_topk_rows",
                                  "gather_rescore_topk"), absent=brute_,
                 after=engine_qps)
            path("explain_knn1m", explain_knn1m,
                 ("rank_scores_bf16", "select_topk_rows",
                  "gather_rescore_topk"), absent=brute_)
            path("info", info, (), absent=brute_)
            path("ann", ann, ("ann_descent",))
            path("explain_ann", explain_ann, ("ann_descent",))
            path("brute", brute, ("distance_tile",))
            path("graph", graph, ())
            ctr = dict(sup_.counters)
            check(ctr["device_fallbacks"] == 0
                  and ctr["device_host_routed"] == 0,
                  f"sql: a fallback hid the card: {ctr}")
            emit("sql", mode=sup_.mode, counters=ctr, paths=sorted(out_all),
                 seconds=round(time.perf_counter() - t_0, 3))
        finally:
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            for name, v in saved.items():
                setattr(cnf, name, v)
            # the server phase serves knn1m's datastore next, beside this
            # phase's figures for the same query
            kept = sq.get("knn1m") if keep_knn1m else None
            sq.clear()
            if kept is not None:
                kept["sql_out"] = out_all.get("knn1m")
                sq["knn1m"] = kept
        return out_all

    # -- the network server over knn1m's datastore (also `--only server`) --
    class KeepRunner:
        """The phase's runner as the drain sees it: every call goes to
        it, and drain_and_shutdown's closing `shutdown()` is counted,
        not run, so the later phases keep the runner."""

        def __init__(self, sup_):
            self._sup = sup_
            self.shutdowns = 0

        def __getattr__(self, name):
            return getattr(self._sup, name)

        def shutdown(self):
            self.shutdowns += 1

    # -- authentication and the schema statements over the wire (also
    # `--only auth`) -------------------------------------------------------
    def auth_phase(sup_, d, counts=None, keep_server=False):
        """knn1m's datastore behind `make_server(ds, "127.0.0.1", 0,
        unauthenticated=False)` with the root user `start --user root
        --pass root` defines (`__main__.define_root_user`), under `sup_`
        (mode require), each step in a launch window of its own: (a) an
        anonymous POST /sql and an anonymous WebSocket query of
        `<|10,40|>` are refused with the IAM error and launch nothing;
        (b) root signs in once over the WebSocket (CBOR), 128 SDK
        clients `authenticate` with its token and send AUTH["queries"]
        of SQL["knn1m"]'s `<|10,40|>` queries (queries/s, p50, p99), ids
        equal to `Datastore.execute`'s as root in process, recall@10 of
        16 >= 0.99 against the f64 oracle; (c) a database VIEWER over
        POST /sql with `Basic` auth answers root's ids and its CREATE is
        refused with the IAM error; (d) record access on `acl` (ACL:
        rows of its own written through the KV, `owner` user:alice on
        even ids and user:bob on odd ones, PERMISSIONS WHERE owner =
        $auth.id, its own bf16 store): alice and bob sign up and sign in
        over the WebSocket, `session::ac()` and `$auth.id` read back,
        and each one's `<|10,40|>` answers are root's less the other
        user's rows (the permission filter after the index's k); (e)
        `fn::nearest`, which wraps (b)'s query, called by root, answers
        (b)'s ids; (f) an event that audits acl's CREATEs: alice's
        CREATE writes its audit row and her next `<|10|>` probe answers
        the new row first; then REBUILD INDEX: the old store is dropped
        from the runner and the next queries ship the rebuilt one and
        answer as before. The bf16 store's three kernels launch in
        (b)-(f) and distance_tile never; knn1m's store is not shipped
        again. No fallback, host routing or numpy descent may occur.
        Leaves `d["acl"]` (the rows and the event's new row) and
        `d["tbl_store"]` (knn1m's store key and tag) for phases ml and
        server; with `keep_server`, the server serves on for phase ml
        (`d["auth_server"]`: the server and its port), which stops it."""
        import base64
        import threading

        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch import server as SRV
        from surrealdb_tpu_torch.__main__ import define_root_user
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.err import SdbError
        from surrealdb_tpu_torch.kvs.api import serialize
        from surrealdb_tpu_torch.sdk import connect
        from surrealdb_tpu_torch.val import RecordId

        t_0 = time.perf_counter()
        ds, xs_, q_ = d["ds"], d["xs"], d["qs"]
        k_ = KNN1M["k"]
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        cnf.KNN_ANN_MODE = "off"
        old_sup = SV.set_supervisor(sup_)
        SV.bind_serving()
        ix = ds.vector_indexes[("b", "b", "tbl", "ix")]
        ctr0, hd0 = dict(sup_.counters), ix.ann_host_descents
        tbl_store = (ix._dev_key, ix.version, ix._dev_epoch)
        d["tbl_store"] = tbl_store
        t0 = time.perf_counter()
        route = define_root_user(ds, "root", "root")
        define_s = time.perf_counter() - t0
        srv = SRV.make_server(ds, "127.0.0.1", 0, unauthenticated=False)
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url, base = f"ws://127.0.0.1:{port}", f"http://127.0.0.1:{port}"
        sql = "SELECT id FROM tbl WHERE emb <|10,40|> $q"
        acl_sql = "SELECT id FROM acl WHERE emb <|10,40|> $q"
        ql = [q.tolist() for q in q_[:64]]
        iam_err = "IAM error: Not enough permissions"
        bf16_ = ("rank_scores_bf16", "select_topk_rows",
                 "gather_rescore_topk")
        out_all, clients, state = {}, [], {}

        window = functools.partial(launch_window, sup_, counts, "auth",
                                   out_all=out_all)

        def ws_client():
            c = connect(url, fmt="cbor", timeout=120.0)
            clients.append(c)
            return c

        def anonymous():
            st, _h, b = http_call(
                base, "/sql", f"LET $q = {json.dumps(ql[0])}; {sql}".encode())
            rows = json.loads(b) if st == 200 else None
            check(st == 401 or all(r["status"] == "ERR"
                                   and iam_err in r["result"]
                                   for r in rows),
                  f"auth anonymous /sql: {st} {b[:300]}")
            c = ws_client()
            c.use("b", "b")
            try:
                res = c.query(sql, {"q": ql[0]})
            except SdbError as e:
                res = str(e)
            check(iam_err in res, f"auth anonymous ws: {res}")
            return {"http_status": st, "ws_refused": True,
                    "hash_route": route, "define_user_s": define_s}

        def root():
            c0 = ws_client()
            t0 = time.perf_counter()
            token = c0.signin(user="root", passwd="root")
            signin_ms = (time.perf_counter() - t0) * 1e3
            c0.use("b", "b")
            state["root"] = c0
            nc = AUTH["clients"]
            t0 = time.perf_counter()
            auth_clients = []
            for _ in range(nc):
                c = ws_client()
                c.authenticate(token)
                c.use("b", "b")
                auth_clients.append(c)
            authenticate_ms = (time.perf_counter() - t0) * 1e3 / nc
            # the same queries as root in process
            want = [record_ids(ds.query_one(sql, ns="b", db="b",
                                            vars={"q": q}))
                    for q in ql]
            state["want"] = want
            per = AUTH["queries"] // nc
            lat = np.zeros(per * nc)

            def client(ci, n_, timed):
                c = auth_clients[ci]
                for j in range(n_):
                    i = ci * n_ + j
                    t1 = time.perf_counter()
                    res = c.query(sql, {"q": ql[i % len(ql)]})
                    if timed:
                        lat[i] = (time.perf_counter() - t1) * 1e3
                    check(res[0]["status"] == "OK"
                          and record_ids(res[0]["result"])
                          == want[i % len(ql)],
                          f"auth root: answer {res[0]}")

            # one untimed query a client (the batched shapes), then the
            # timed ones
            for timed, n_ in ((False, 1), (True, per)):
                t1 = time.perf_counter()
                with ThreadPoolExecutor(nc) as ex:
                    list(ex.map(lambda ci: client(ci, n_, timed),
                                range(nc)))
                wall = time.perf_counter() - t1
            nq_ = 16
            _od, oi = cosine_top(xs_, q_[:nq_], k_)
            rec = float(np.mean([len(set(want[qi]) & set(oi[qi].tolist()))
                                 / k_ for qi in range(nq_)]))
            check(rec >= 0.99, f"auth root recall@10 {rec} < 0.99")
            return {"clients": nc, "queries": len(lat),
                    "qps": len(lat) / wall,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "signin_ms": signin_ms,
                    "authenticate_ms": authenticate_ms,
                    "ids_equal_in_process": True, "recall_at_10": rec}

        def viewer():
            ds.query("DEFINE USER reader ON DATABASE PASSWORD 'reader-pass' "
                     "ROLES VIEWER", ns="b", db="b")
            basic = {"Authorization": "Basic " + base64.b64encode(
                b"reader:reader-pass").decode()}
            t0 = time.perf_counter()
            for qi in range(4):
                st, _h, b = http_call(
                    base, "/sql",
                    f"LET $q = {json.dumps(ql[qi])}; {sql}".encode(), basic)
                rows = json.loads(b)[1]["result"]
                check(st == 200 and [int(r["id"].split(":")[1])
                                     for r in rows] == state["want"][qi],
                      f"auth viewer /sql: {st} {rows}")
            ms = (time.perf_counter() - t0) * 1e3 / 4
            st, _h, b = http_call(
                base, "/sql", f"CREATE tbl:{xs_.shape[0] + 99} SET emb = "
                f"{json.dumps(ql[0])}".encode(), basic)
            res = json.loads(b)
            check(st == 200 and res[0]["status"] == "ERR"
                  and iam_err in res[0]["result"],
                  f"auth viewer CREATE: {st} {res}")
            check((ix._dev_key, ix.version, ix._dev_epoch) == tbl_store,
                  "auth viewer: knn1m's store changed")
            return {"queries": 4, "ms_per_query": ms,
                    "ids_equal_root": True, "create_refused": True}

        # `acl`: rows of its own through the KV (a record holding its
        # vector and its owner, and the index's `he` key), then `vn`
        n_acl, dim = ACL["n"], KNN1M["dim"]
        arng = np.random.default_rng(ACL["seed"])
        axs = arng.standard_normal((n_acl, dim), dtype=np.float32)
        aqs = arng.standard_normal((ACL["queries"], dim), dtype=np.float32)
        d["acl"] = {"xs": axs}
        owners = (RecordId("user", "alice"), RecordId("user", "bob"))

        def acl_ingest():
            ds.query(
                "DEFINE TABLE acl PERMISSIONS FOR select, create, update, "
                "delete WHERE owner = $auth.id; DEFINE INDEX ix ON acl "
                f"FIELDS emb HNSW DIMENSION {dim} DIST COSINE TYPE F32; "
                "DEFINE ACCESS account ON DATABASE TYPE RECORD "
                "SIGNUP (CREATE type::record('user', $name) "
                "SET pass = crypto::scrypt::generate($pass)) "
                "SIGNIN (SELECT * FROM user WHERE id = "
                "type::record('user', $name) AND "
                "crypto::scrypt::compare(pass, $pass))", ns="b", db="b")
            t0 = time.perf_counter()
            t = ds.transaction(write=True)
            try:
                for i in range(n_acl):
                    t.set(K.record("b", "b", "acl", i), serialize(
                        {"id": RecordId("acl", i), "emb": axs[i].tolist(),
                         "owner": owners[i % 2]}))
                    t.set_val(K.ix_state("b", "b", "acl", "ix", b"he",
                                         K.enc_value(i)), axs[i].tobytes())
                t.set_val(K.ix_state("b", "b", "acl", "ix", b"vn"), n_acl)
                t.commit()
            except BaseException:
                t.cancel()
                raise
            return time.perf_counter() - t0

        def record():
            out = {"rows": n_acl, "ingest_s": acl_ingest()}
            users = {}
            t0 = time.perf_counter()
            for name in ("alice", "bob"):
                creds = {"NS": "b", "DB": "b", "AC": "account",
                         "name": name, "pass": f"{name}-pass"}
                ws_client().signup(**creds)
                c = ws_client()
                c.signin(**creds)
                back = c.query("RETURN [session::ac(), $auth.id]")
                check(back[0]["result"] == ["account",
                                            RecordId("user", name)],
                      f"auth record {name}: {back}")
                users[name] = c
            out["signup_signin_ms"] = (time.perf_counter() - t0) * 1e3 / 2
            aql = [q.tolist() for q in aqs]
            state["aql"] = aql
            t0 = time.perf_counter()
            roots = [record_ids(ds.query_one(acl_sql, ns="b", db="b",
                                        vars={"q": q}))
                     for q in aql]
            out["first_query_s"] = time.perf_counter() - t0  # the ship
            state["acl_root"] = roots
            got_n = 0
            t0 = time.perf_counter()
            for parity, name in enumerate(("alice", "bob")):
                for qi, q in enumerate(aql):
                    res = users[name].query(acl_sql, {"q": q})
                    got = record_ids(res[0]["result"])
                    want = [i for i in roots[qi] if i % 2 == parity]
                    check(res[0]["status"] == "OK" and got == want,
                          f"auth record {name} q{qi}: {got} != {want}")
                    got_n += len(got)
            out["ms_per_query"] = ((time.perf_counter() - t0) * 1e3
                                   / (2 * len(aql)))
            out["rows_answered"] = got_n
            out["root_rows"] = 2 * sum(len(r) for r in roots)
            state["alice"] = users["alice"]
            return out

        def function():
            ds.query("DEFINE FUNCTION fn::nearest($q: array<float>) "
                     f"{{ RETURN {sql}; }}", ns="b", db="b")
            c0 = state["root"]
            t0 = time.perf_counter()
            for qi in range(8):
                res = c0.query("RETURN fn::nearest($q)", {"q": ql[qi]})
                check(res[0]["status"] == "OK"
                      and record_ids(res[0]["result"]) == state["want"][qi],
                      f"auth fn::nearest q{qi}: {res[0]}")
            return {"calls": 8, "ids_equal_root": True,
                    "ms_per_call": (time.perf_counter() - t0) * 1e3 / 8}

        def event():
            ds.query("DEFINE TABLE audit PERMISSIONS FULL; DEFINE EVENT "
                     "audit ON acl WHEN $event = 'CREATE' THEN (CREATE "
                     "audit SET rec = $after.id, by = $auth.id)",
                     ns="b", db="b")
            alice, rid = state["alice"], n_acl + 1
            v = np.random.default_rng(ACL["seed"] + 1).standard_normal(
                dim).astype(np.float32).tolist()
            t0 = time.perf_counter()
            res = alice.query("CREATE type::record('acl', $id) SET emb = $v, "
                              "owner = $auth.id", {"id": rid, "v": v})
            out = {"create_ms": (time.perf_counter() - t0) * 1e3}
            check(res[0]["status"] == "OK", f"auth event CREATE: {res}")
            aud = ds.query_one("SELECT rec, by FROM audit WHERE rec = $r",
                           ns="b", db="b", vars={"r": RecordId("acl", rid)})
            check(len(aud) == 1
                  and aud[0]["by"] == RecordId("user", "alice"),
                  f"auth event: audit rows {aud}")
            t0 = time.perf_counter()
            first = record_ids(alice.query(
                "SELECT id FROM acl WHERE emb <|10|> $q",
                {"q": v})[0]["result"])
            out["probe_ms"] = (time.perf_counter() - t0) * 1e3
            check(first[:1] == [rid], f"auth event: the probe found {first}")
            # the new row is alice's and sits in the store from now on
            state["acl_new"] = d["acl"]["new"] = (rid, v)
            return out

        def rebuild():
            aix = ds.vector_indexes[("b", "b", "acl", "ix")]
            old = (aix._dev_key, [aix.version, aix._dev_epoch])
            before = [record_ids(ds.query_one(acl_sql, ns="b", db="b",
                                        vars={"q": q}))
                      for q in state["aql"][:4]]
            t0 = time.perf_counter()
            res = state["root"].query("REBUILD INDEX ix ON acl")
            out = {"rebuild_s": time.perf_counter() - t0}
            check(res[0]["status"] == "OK", f"auth REBUILD: {res}")
            t, _m, _ = sup_.call("vec_knn", {"key": old[0], "tag": old[1],
                                             "k": k_}, [aqs[:1]])
            check(t == "stale", f"auth REBUILD: the old store answered {t}")
            t0 = time.perf_counter()
            after = [record_ids(ds.query_one(acl_sql, ns="b", db="b",
                                        vars={"q": q}))
                     for q in state["aql"][:4]]
            out["first_query_s"] = time.perf_counter() - t0
            check(after == before,
                  f"auth REBUILD: answers {after} != {before}")
            nix = ds.vector_indexes[("b", "b", "acl", "ix")]
            check(nix is not aix and nix._dev_key != old[0],
                  "auth REBUILD: the engine was not replaced")
            out.update(old_store_dropped=True, ids_equal=True,
                       rows=len(nix.rids))
            return out

        try:
            window("anonymous", anonymous, (), none=True)
            window("root", root, bf16_)
            window("viewer", viewer, bf16_)
            window("record", record, bf16_)
            window("function", function, bf16_)
            window("event", event, bf16_)
            window("rebuild", rebuild, bf16_)
            check((ix._dev_key, ix.version, ix._dev_epoch) == tbl_store,
                  "auth: knn1m's store was shipped again")
            ctr = dict(sup_.counters)
            for name in ("device_fallbacks", "device_host_routed"):
                check(ctr[name] == ctr0[name],
                      f"auth: {name} moved {ctr0[name]} -> {ctr[name]}")
            check(ix.ann_host_descents == hd0, "auth: the numpy descent ran")
            emit("auth", mode=sup_.mode, counters=ctr,
                 steps=list(out_all),
                 seconds=round(time.perf_counter() - t_0, 3))
        finally:
            for c in clients:
                c.close()
            if keep_server:
                d["auth_server"] = (srv, port)
            else:
                srv.shutdown()
                srv.server_close()
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    # -- models on the card over phase auth's server (also `--only ml`) -----
    def ml_phase(sup_, d, counts=None, keep_server=False):
        """Phase auth's server (`d["auth_server"]`, started as `start
        --user root --pass root` with SURREAL_CAPS_ALLOW_EXPERIMENTAL=ml,
        as this script sets it) and its `acl` table, under `sup_` (mode
        require), each step in a launch window of its own: (a) root
        imports onnx_graphs()'s mlp_head_768 graph in a SurmlFile header
        (`head`, 1.0.0) by POST /ml/import with its token: the reply's
        hash is SurmlFile.hash, INFO FOR DB lists DEFINE MODEL
        ml::head<1.0.0>, GET /ml/export/head/1.0.0 returns the same
        bytes; (b) `SELECT id, ml::head<1.0.0>(emb) AS s FROM acl WHERE
        emb <|10,40|> $q` over the WebSocket as root for ML["queries"]
        queries, one at a time: ids equal to the unscored query's and to
        in-process root's, each `s` within atol 1e-5, rtol 1e-4 of
        run_graph on the CPU over the row's vector, every graph run on
        the card, the bf16 store's three kernels launched (first call,
        warm p50 and p99 a query); (c) a two-column model (z_score,
        linear_scaling) as the `"jax"` engine and as ONNX, called with
        objects, held to the normalisers and dense layers written out in
        numpy here; (d) `SELECT ml::head<1.0.0>(emb) FROM acl LIMIT
        1024`: ms a row (one run_graph a row); (e) a datastore whose
        capabilities do not allow ml answers the reference's error and
        runs no graph; (f) a small table `hist` (no index): CREATE, then
        UPDATE, then `SELECT * FROM hist:1 VERSION <ts between>` answers
        the first document, and INFO FOR DB VERSION <ts before the
        import> lacks the model. No step writes to `acl` or knn1m's
        `tbl`; no fallback, host routing or numpy descent may occur.
        Stops the server, unless `keep_server` leaves it serving for
        phase api, which stops it."""

        from surrealdb_tpu_torch import ml as ML_
        from surrealdb_tpu_torch.capabilities import Capabilities
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.kvs.ds import Datastore
        from surrealdb_tpu_torch.ml import onnx as O
        from surrealdb_tpu_torch.sdk import connect

        t_0 = time.perf_counter()
        ds, srv = d["ds"], d["auth_server"][0]
        port = d["auth_server"][1]
        url, base = f"ws://127.0.0.1:{port}", f"http://127.0.0.1:{port}"
        axs = d["acl"]["xs"]
        extra = dict([d["acl"]["new"]]) if "new" in d["acl"] else {}
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        cnf.KNN_ANN_MODE = "off"
        old_sup = SV.set_supervisor(sup_)
        SV.bind_serving()
        ix = ds.vector_indexes[("b", "b", "acl", "ix")]
        tix = ds.vector_indexes[("b", "b", "tbl", "ix")]
        ctr0, hd0 = dict(sup_.counters), ix.ann_host_descents
        bf16_ = ("rank_scores_bf16", "select_topk_rows",
                 "gather_rescore_topk")
        # every graph run of the path, with its output's device
        graph_runs = []
        run_graph0 = O.run_graph

        def counted(g_, feed_, device=None):
            outs_ = run_graph0(g_, feed_, device=device)
            graph_runs.append(outs_[0].device.type if outs_ else None)
            return outs_

        O.run_graph = counted
        out_all, clients = {}, []
        model, _feed = onnx_graphs()["mlp_head_768"]
        head = ML_.SurmlFile({"name": "head", "version": "1.0.0",
                              "columns": [], "normalisers": {},
                              "engine": "onnx"}, model)
        g_cpu = O.OnnxGraph.parse(model)
        arng = np.random.default_rng(ML["seed"])
        mqs = arng.standard_normal((ML["queries"], axs.shape[1]),
                                   dtype=np.float32)
        mql = [q.tolist() for q in mqs]
        scored = ("SELECT id, ml::head<1.0.0>(emb) AS s FROM acl "
                  "WHERE emb <|10,40|> $q")
        plain = "SELECT id FROM acl WHERE emb <|10,40|> $q"

        def window(name, fn, needs=(), none=False):
            def run():
                runs0 = len(graph_runs)
                out = fn()
                runs = graph_runs[runs0:]
                check(all(dv == "cuda" for dv in runs),
                      f"ml {name}: a graph ran on {set(runs)}")
                return {**out, "graph_runs": len(runs)}

            launch_window(sup_, counts, "ml", name, run, needs, none=none,
                          out_all=out_all)

        def http(path, body=None, method="POST"):
            st, _h, b = http_call(
                base, path, body, method=method,
                headers={"Authorization": f"Bearer {state['token']}"})
            return st, b

        def row_vec(i):
            return axs[i] if i < axs.shape[0] else np.asarray(
                extra[i], np.float32)

        def cpu_scores(rows):
            return run_graph0(g_cpu, {"x": np.stack(rows)},
                               device="cpu")[0].numpy()

        def close(a, b):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            err = float(np.abs(a - b).max()) if a.size else 0.0
            return err, bool(a.shape == b.shape and np.all(
                np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)))

        state = {}

        def import_():
            c = connect(url, fmt="cbor", timeout=120.0)
            clients.append(c)
            state["token"] = c.signin(user="root", passwd="root")
            c.use("b", "b")
            state["root"] = c
            state["before"] = ds.query_one("RETURN time::now()")
            time.sleep(0.002)
            t0 = time.perf_counter()
            st, body = http("/ml/import", head.to_bytes())
            import_ms = (time.perf_counter() - t0) * 1e3
            rep = json.loads(body) if st == 200 else body
            check(st == 200 and rep == {"name": "head", "version": "1.0.0",
                                        "hash": head.hash},
                  f"ml import: {st} {rep}")
            info = c.query("INFO FOR DB")[0]["result"]
            check(info["models"].get("head<1.0.0>", "").startswith(
                "DEFINE MODEL ml::head<1.0.0>"),
                f"ml import: INFO FOR DB models {info['models']}")
            t0 = time.perf_counter()
            st, raw = http("/ml/export/head/1.0.0", method="GET")
            export_ms = (time.perf_counter() - t0) * 1e3
            check(st == 200 and raw == head.to_bytes(),
                  f"ml export: {st}, {len(raw)} bytes")
            return {"import_ms": import_ms, "export_ms": export_ms,
                    "bytes": len(raw), "hash": head.hash}

        def knn():
            c = state["root"]
            reserved0 = torch.cuda.memory_reserved()
            want = [record_ids(ds.query_one(plain, ns="b", db="b",
                                            vars={"q": q}))
                    for q in mql]
            unscored = [record_ids(c.query(plain, {"q": q})[0]["result"])
                        for q in mql]
            check(unscored == want, "ml knn: the unscored ids differ from "
                  "in-process root's")
            lat, errs, nrows = [], [], []
            for qi, q in enumerate(mql):
                t1 = time.perf_counter()
                res = c.query(scored, {"q": q})
                lat.append((time.perf_counter() - t1) * 1e3)
                check(res[0]["status"] == "OK", f"ml knn q{qi}: {res[0]}")
                rows = res[0]["result"]
                check(record_ids(rows) == want[qi],
                      f"ml knn q{qi}: {record_ids(rows)} != {want[qi]}")
                err, ok = close([r["s"] for r in rows],
                                cpu_scores([row_vec(i)
                                            for i in record_ids(rows)]))
                check(ok, f"ml knn q{qi}: scores off by {err}")
                errs.append(err)
                nrows.append(len(rows))
            warm = np.asarray(lat[1:])
            return {"queries": len(mql), "rows": sum(nrows),
                    "first_ms": lat[0],
                    "p50_ms": float(np.percentile(warm, 50)),
                    "p99_ms": float(np.percentile(warm, 99)),
                    "ms_per_row": float(np.sum(warm)) / max(1, sum(nrows[1:])),
                    "max_abs_err": max(errs), "ids_equal_unscored": True,
                    "ids_equal_in_process": True,
                    "server_reserved_mb": torch.cuda.memory_reserved() / 2**20,
                    "server_reserved_delta_mb":
                        (torch.cuda.memory_reserved() - reserved0) / 2**20,
                    "gpu_processes": gpu_processes()}

        def buffered():
            rng_ = np.random.default_rng(ML["seed"] + 1)
            w1 = rng_.normal(size=(2, 8)).astype(np.float32)
            b1 = rng_.normal(size=(8,)).astype(np.float32)
            w2 = rng_.normal(size=(8, 1)).astype(np.float32)
            nz = {"a": {"type": "z_score", "mean": 3.0, "std_dev": 2.0},
                  "b": {"type": "linear_scaling", "min": -1.0, "max": 7.0}}
            jm = ML_.make_jax_model("bj", "1.0.0", ["a", "b"],
                                    [(w1, b1, "relu"), (w2, None, None)],
                                    normalisers=nz)
            om = ML_.SurmlFile(
                {"name": "bo", "version": "1.0.0", "columns": ["a", "b"],
                 "normalisers": nz, "engine": "onnx"},
                _pb_model([("MatMul", ["x", "w1"], ["h"], {}),
                           ("Add", ["h", "b1"], ["hb"], {}),
                           ("Relu", ["hb"], ["r"], {}),
                           ("MatMul", ["r", "w2"], ["y"], {})],
                          {"w1": w1, "b1": b1, "w2": w2}, "x", "y"))
            for f_ in (jm, om):
                st, body = http("/ml/import", f_.to_bytes())
                check(st == 200, f"ml buffered import: {st} {body}")
            objs = [{"a": float(a), "b": float(b)} for a, b in
                    rng_.normal(size=(8, 2)) * 4.0]
            c = state["root"]
            out = {}
            for name_, exact in (("bj", True), ("bo", False)):
                got = [c.query(f"RETURN ml::{name_}<1.0.0>($o)",
                               {"o": o})[0]["result"] for o in objs]
                # the normalisers and dense layers written out here
                want = []
                for o in objs:
                    x = np.asarray([[(o["a"] - 3.0) / 2.0,
                                     (o["b"] + 1.0) / 8.0]], np.float32)
                    h = np.maximum(x @ w1 + b1, 0)
                    want.append((h @ w2).reshape(-1).tolist())
                err, ok = close(got, want)
                if exact:
                    ok = got == want
                check(ok, f"ml buffered {name_}: {got} != {want}")
                out[name_] = {"calls": len(objs), "max_abs_err": err,
                              "exact": got == want}
            return out

        def scan():
            c = state["root"]
            t1 = time.perf_counter()
            res = c.query("SELECT ml::head<1.0.0>(emb) FROM acl LIMIT 1024")
            ms = (time.perf_counter() - t1) * 1e3
            check(res[0]["status"] == "OK", f"ml scan: {res[0]}")
            check(all(len(r) == 1 for r in res[0]["result"]),
                  "ml scan: a row holds more than its score")
            rows = [next(iter(r.values())) for r in res[0]["result"]]
            s_ = np.asarray(rows, np.float64)
            check(s_.shape == (1024, 10) and np.isfinite(s_).all()
                  and np.allclose(s_.sum(axis=1), 1.0, atol=1e-5),
                  f"ml scan: shape {s_.shape}")
            err, ok = close(s_[:16], cpu_scores([row_vec(i)
                                                 for i in range(16)]))
            check(ok, f"ml scan: the first rows' scores off by {err}")
            return {"rows": len(rows), "ms": ms, "ms_per_row": ms / len(rows),
                    "max_abs_err": err}

        def gate():
            closed = Datastore("memory", capabilities=Capabilities())
            try:
                ML_.import_model(closed, "b", "b", head.to_bytes())
                t1 = time.perf_counter()
                r = closed.execute("RETURN ml::head<1.0.0>($v)", ns="b",
                                   db="b", vars={"v": mql[0]})[0]
                ms = (time.perf_counter() - t1) * 1e3
            finally:
                closed.close()
            want = ("Problem with machine learning computation. Machine "
                    "learning computation is not enabled.")
            check(r.error == want, f"ml gate: {r.error}")
            return {"error": r.error, "ms": ms}

        def version():
            c = state["root"]
            res = c.query("CREATE hist:1 SET v = 1, at = 'first'; "
                          "SLEEP 2ms; LET $t = time::now(); SLEEP 2ms; "
                          "UPDATE hist:1 SET v = 2, at = 'second'; "
                          "SELECT * FROM hist:1 VERSION $t; "
                          "SELECT * FROM hist:1; "
                          "INFO FOR DB VERSION $before; INFO FOR DB",
                          {"before": state["before"]})
            check(all(r["status"] == "OK" for r in res), f"ml version: {res}")
            then, now = res[5]["result"], res[6]["result"]
            check([r["at"] for r in then] == ["first"]
                  and [r["at"] for r in now] == ["second"],
                  f"ml version: {then} / {now}")
            check("head<1.0.0>" not in res[7]["result"]["models"]
                  and "head<1.0.0>" in res[8]["result"]["models"],
                  "ml version: INFO FOR DB VERSION lists the model")
            return {"first_document": True, "info_lacks_model": True}

        try:
            store = (tix._dev_key, tix.version, tix._dev_epoch)
            window("import", import_, none=True)
            window("knn", knn, bf16_)
            window("buffered", buffered, none=True)
            window("scan", scan, none=True)
            runs0 = len(graph_runs)
            window("gate", gate, none=True)
            check(len(graph_runs) == runs0, "ml gate: a graph ran")
            window("version", version, none=True)
            check((tix._dev_key, tix.version, tix._dev_epoch) == store
                  and store == d["tbl_store"],
                  "ml: knn1m's store was shipped again")
            ctr = dict(sup_.counters)
            for name in ("device_fallbacks", "device_host_routed"):
                check(ctr[name] == ctr0[name],
                      f"ml: {name} moved {ctr0[name]} -> {ctr[name]}")
            check(ix.ann_host_descents == hd0, "ml: the numpy descent ran")
            secs = time.perf_counter() - t_0
            emit("ml", mode=sup_.mode, counters=ctr, steps=list(out_all),
                 graph_runs=len(graph_runs), seconds=round(secs, 3))
            check(secs <= ML["max_s"], f"ml: {secs:.1f} s > {ML['max_s']} s")
        finally:
            O.run_graph = run_graph0
            for c in clients:
                c.close()
            if not keep_server:
                srv.shutdown()
                srv.server_close()
                d.pop("auth_server", None)
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    # -- DEFINE API, changefeeds, views, buckets and GraphQL over phase
    # auth's server (also `--only api`) -------------------------------------
    def api_phase(sup_, d, counts=None):
        """Phase auth's server (`d["auth_server"]`, `start --user root
        --pass root`) and its `acl` table, under `sup_` (mode require),
        each step in a launch window of its own: (a) root defines
        `DEFINE API "/nearest" FOR post` with the JSON body middleware
        (api::req::body('json')), whose THEN returns status 200 and
        `SELECT id FROM acl WHERE emb <|10,40|> $request.body.q`; INFO
        FOR DB lists it; (b) API["threads"] threads send API["requests"]
        `POST /api/b/b/nearest` requests with root's Bearer token (query
        vectors of seed API["seed"]): requests/s, p50 and p99, ids equal
        to in-process root's `<|10,40|>` answers (taken between the
        windows, so that (b)'s counts are the requests' own), recall@10
        of the first API["recall_queries"] >= 0.99 against the f64
        oracle, the bf16
        store's three kernels launched and distance_tile never; an
        unknown path answers the reference's 404 ("Not found"); (c)
        `RETURN api::invoke("/nearest", {...})` over the WebSocket
        answers (b)'s ids; (d) `ALTER TABLE acl CHANGEFEED 1h`, a CREATE
        of one fresh vector, whose next `<|1|>` probe answers it first,
        `SHOW CHANGES FOR TABLE acl SINCE <before>` lists exactly that
        create, after the DELETE the create and the delete, then `ALTER
        TABLE acl DROP CHANGEFEED`: acl is as it was, with no
        changefeed; (e) on a table `tally` of API["tally"] rows (on the
        host, as in the reference): the view `tally_by` (GROUP BY g,
        count() and math::sum(x)) equals the GROUP BY SELECT after the
        inserts and after 32 updates and 32 deletes, a DEFINE BUCKET
        round-trips file::put / file::get, and `/graphql` after `DEFINE
        CONFIG GRAPHQL AUTO` answers the SELECT's rows. No step writes
        to knn1m's `tbl`; no fallback, host routing or numpy descent
        may occur; at most API["max_s"] seconds. Stops the server."""

        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.sdk import connect

        t_0 = time.perf_counter()
        ds, srv = d["ds"], d["auth_server"][0]
        port = d["auth_server"][1]
        url, base = f"ws://127.0.0.1:{port}", f"http://127.0.0.1:{port}"
        axs = d["acl"]["xs"]
        n_acl, dim = axs.shape
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        cnf.KNN_ANN_MODE = "off"
        old_sup = SV.set_supervisor(sup_)
        SV.bind_serving()
        tix = ds.vector_indexes[("b", "b", "tbl", "ix")]
        store = (tix._dev_key, tix.version, tix._dev_epoch)
        ctr0 = dict(sup_.counters)
        hd0 = ds.vector_indexes[("b", "b", "acl", "ix")].ann_host_descents
        bf16_ = ("rank_scores_bf16", "select_topk_rows",
                 "gather_rescore_topk")
        acl_sql = "SELECT id FROM acl WHERE emb <|10,40|> $q"
        qrng = np.random.default_rng(API["seed"])
        pqs = qrng.standard_normal((API["requests"], dim), dtype=np.float32)
        pql = [q.tolist() for q in pqs]
        out_all, clients, state = {}, [], {}

        window = functools.partial(launch_window, sup_, counts, "api",
                                   out_all=out_all)

        def http(path, body=None, headers=None):
            return http_call(base, path, body, headers={
                "Authorization": f"Bearer {state['token']}",
                **(headers or {})})

        def root_query(sql_, vars_=None):
            res = state["root"].query(sql_, vars_ or {})
            check(all(r["status"] == "OK" for r in res),
                  f"api: {sql_[:60]} -> {res}")
            return [r["result"] for r in res]

        def define():
            c = connect(url, fmt="cbor", timeout=120.0)
            clients.append(c)
            state["token"] = c.signin(user="root", passwd="root")
            c.use("b", "b")
            state["root"] = c
            t0 = time.perf_counter()
            root_query(
                'DEFINE API "/nearest" FOR post '
                "MIDDLEWARE api::req::body('json') THEN { RETURN { "
                "status: 200, body: (SELECT id FROM acl "
                "WHERE emb <|10,40|> $request.body.q) }; }")
            define_ms = (time.perf_counter() - t0) * 1e3
            info = root_query("INFO FOR DB")[0]
            check(info["apis"].get("/nearest", "").startswith(
                "DEFINE API '/nearest'"),
                f"api define: INFO FOR DB apis {info['apis']}")
            return {"define_ms": define_ms, "info_lists_api": True}

        def requests():
            want = state["want"]
            nt, n_ = API["threads"], len(pql)
            lat = np.zeros(n_)
            got = [None] * n_
            hdr = {"Content-Type": "application/json"}

            def client(ti):
                for i in range(ti, n_, nt):
                    body = json.dumps({"q": pql[i]}).encode()
                    t1 = time.perf_counter()
                    st, h, raw = http("/api/b/b/nearest", body, headers=hdr)
                    lat[i] = (time.perf_counter() - t1) * 1e3
                    check(st == 200, f"api request {i}: {st} {raw[:300]}")
                    got[i] = [int(r["id"].split(":")[1])
                              for r in json.loads(raw)]

            t1 = time.perf_counter()
            with ThreadPoolExecutor(nt) as ex:
                list(ex.map(client, range(nt)))
            wall = time.perf_counter() - t1
            for i in range(n_):
                check(got[i] == want[i],
                      f"api request {i}: ids {got[i]} != {want[i]}")
            # the oracle over acl's rows and phase auth's new row
            nq_ = API["recall_queries"]
            rows_ = axs
            rid_of = np.arange(n_acl)
            if "new" in d["acl"]:
                nid, nv = d["acl"]["new"]
                rows_ = np.vstack([axs, np.asarray(nv, np.float32)[None]])
                rid_of = np.append(rid_of, nid)
            _od, oi = cosine_top(rows_, pqs[:nq_], 10)
            rec = float(np.mean([
                len(set(want[qi]) & set(rid_of[oi[qi]].tolist())) / 10
                for qi in range(nq_)]))
            check(rec >= 0.99, f"api recall@10 {rec} < 0.99")
            st, h, raw = http("/api/b/b/nope", b"{}", headers=hdr)
            check(st == 404 and raw == b"Not found",
                  f"api unknown path: {st} {raw[:200]}")
            return {"threads": nt, "requests": n_, "rps": n_ / wall,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "ids_equal_in_process": True, "recall_at_10": rec,
                    "unknown_path_status": st}

        def invoke():
            lat = []
            for i in range(16):
                body = json.dumps({"q": pql[i]}).encode()
                t1 = time.perf_counter()
                res = root_query(
                    "RETURN api::invoke('/nearest', { method: 'post', "
                    "headers: { 'content-type': 'application/json' }, "
                    "body: $b })", {"b": body})[0]
                lat.append((time.perf_counter() - t1) * 1e3)
                check(res["status"] == 200
                      and record_ids(res["body"]) == state["want"][i],
                      f"api invoke {i}: {res}")
            return {"calls": len(lat), "p50_ms": float(np.median(lat)),
                    "ids_equal_requests": True}

        def changefeed():
            root_query("ALTER TABLE acl CHANGEFEED 1h")
            before = root_query("RETURN time::now()")[0]
            time.sleep(0.003)
            rid = n_acl + 7
            v = np.random.default_rng(API["seed"] + 1).standard_normal(
                dim).astype(np.float32).tolist()
            t0 = time.perf_counter()
            root_query("CREATE type::record('acl', $id) SET emb = $v, "
                       "owner = user:alice", {"id": rid, "v": v})
            create_ms = (time.perf_counter() - t0) * 1e3
            first = record_ids(root_query(
                "SELECT id FROM acl WHERE emb <|1|> $q", {"q": v})[0])
            check(first == [rid], f"api changefeed: the probe found {first}")
            show = "SHOW CHANGES FOR TABLE acl SINCE $t"
            t0 = time.perf_counter()
            feed = root_query(show, {"t": before})[0]
            show_ms = (time.perf_counter() - t0) * 1e3
            ch = [c for e in feed for c in e["changes"]]
            check(len(ch) == 1 and "update" in ch[0]
                  and ch[0]["update"]["id"].id == rid,
                  f"api changefeed: after the CREATE {feed}")
            root_query("DELETE type::record('acl', $id)", {"id": rid})
            feed = root_query(show, {"t": before})[0]
            ch = [c for e in feed for c in e["changes"]]
            check(len(ch) == 2 and "delete_only" in ch[1]
                  and ch[1]["delete_only"]["id"].id == rid,
                  f"api changefeed: after the DELETE {feed}")
            root_query("ALTER TABLE acl DROP CHANGEFEED")
            tb = root_query("INFO FOR DB")[0]["tables"]["acl"]
            check("CHANGEFEED" not in tb, f"api changefeed: {tb}")
            gone = record_ids(root_query(
                "SELECT id FROM acl WHERE emb <|1|> $q", {"q": v})[0])
            check(gone != [rid], "api changefeed: the deleted row answered")
            return {"create_ms": create_ms, "show_ms": show_ms,
                    "entries": len(feed), "dropped": True}

        def host_only():
            n_t = API["tally"]
            group = ("SELECT g, count() AS n, math::sum(x) AS s FROM tally "
                     "GROUP BY g ORDER BY g")
            view = "SELECT g, n, s FROM tally_by ORDER BY g"
            t0 = time.perf_counter()
            root_query("DEFINE TABLE tally_by AS SELECT g, count() AS n, "
                       "math::sum(x) AS s FROM tally GROUP BY g")
            root_query("INSERT INTO tally $rows RETURN NONE",
                       {"rows": [{"id": i, "g": i % 8, "x": i}
                                 for i in range(n_t)]})
            a, b = root_query(f"{group}; {view}")
            check(a == b and len(a) == 8, f"api view after inserts: {a} {b}")
            root_query("FOR $i IN 0..32 { UPDATE type::record('tally', $i) "
                       "SET x = $i + 1000 }; FOR $i IN 32..64 { DELETE "
                       "type::record('tally', $i) }")
            a, b = root_query(f"{group}; {view}")
            check(a == b and sum(r["n"] for r in a) == n_t - 32,
                  f"api view after updates and deletes: {a} {b}")
            view_ms = (time.perf_counter() - t0) * 1e3
            blob = bytes(range(256)) * 4
            root_query("DEFINE BUCKET blobs")
            back = root_query("file::put(f\"blobs:/a.bin\", $b); "
                              "RETURN file::get(f\"blobs:/a.bin\")",
                              {"b": blob})[1]
            check(back == blob, "api bucket: file::get differs")
            root_query("DEFINE CONFIG GRAPHQL AUTO")
            t0 = time.perf_counter()
            gq = '{ tally(order: "x", limit: %d) { x g } }' % n_t
            st, _h, raw = http("/graphql", json.dumps({"query": gq}).encode(),
                               headers={"Content-Type": "application/json"})
            gql_ms = (time.perf_counter() - t0) * 1e3
            rows = root_query("SELECT x, g FROM tally ORDER BY x")[0]
            got = json.loads(raw) if st == 200 else raw
            check(st == 200 and got.get("data", {}).get("tally") == rows,
                  f"api graphql: {st} {str(got)[:300]}")
            return {"tally_rows": n_t, "view_ms": view_ms,
                    "view_equals_group_by": True, "bucket_bytes": len(blob),
                    "graphql_rows": len(rows), "graphql_ms": gql_ms}

        try:
            window("define", define, none=True)
            # in-process root's answers, outside any window, so that
            # (b)'s counts are the /api requests' own
            state["want"] = [record_ids(ds.query_one(
                acl_sql, ns="b", db="b", vars={"q": q})) for q in pql]
            window("requests", requests, bf16_)
            window("invoke", invoke, bf16_)
            window("changefeed", changefeed, bf16_)
            window("host_only", host_only, none=True)
            check((tix._dev_key, tix.version, tix._dev_epoch) == store,
                  "api: knn1m's store was shipped again")
            ctr = dict(sup_.counters)
            for name in ("device_fallbacks", "device_host_routed"):
                check(ctr[name] == ctr0[name],
                      f"api: {name} moved {ctr0[name]} -> {ctr[name]}")
            aix = ds.vector_indexes[("b", "b", "acl", "ix")]
            check(aix.ann_host_descents == hd0, "api: the numpy descent ran")
            secs = time.perf_counter() - t_0
            emit("api", mode=sup_.mode, counters=ctr, steps=list(out_all),
                 seconds=round(secs, 3))
            check(secs <= API["max_s"],
                  f"api: {secs:.1f} s > {API['max_s']} s")
        finally:
            for c in clients:
                c.close()
            srv.shutdown()
            srv.server_close()
            d.pop("auth_server", None)
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    def server_phase(sup_, d, counts=None):
        """knn1m's datastore (BASELINE config 2 at full width, after the
        sql phase) behind the port's `make_server` on 127.0.0.1:0
        (unauthenticated, the default admission gate), under `sup_`
        (mode require), each step in a launch window of its own: (a)
        128 clients of the port's SDK (`connect("ws://…", fmt="cbor")`)
        send SQL["knn1m"] `<|10,40|>` queries (ws_knn_qps, p50, p99
        beside the sql phase's sql_knn_qps and index_engine_qps),
        recall@10 of 16 queries >= 0.99 against the f64 oracle; (b) the
        same query through POST /sql and POST /rpc (JSON), ids equal to
        the WebSocket's; (c) LIVE SELECT id FROM acl (phase auth's table)
        on one session, a CREATE of a fresh vector on another: one
        CREATE notification, the `<|10|>` probe answers the row first,
        KILL, a second CREATE delivers nothing in 1 s, both rows deleted;
        (d) bench.py's live soak at its quick shape on a table of its own
        (order_violations 0, per_session_complete 62, live_sessions_end
        0); (e) a drain with one query in flight (the fresh vector's
        `<|10,40|>` on acl, the first query after the deletes, which must
        not answer them): it finishes, a new request sheds with a typed
        503, and the drain reaches the supervisor's shutdown (counted by
        KeepRunner). No step writes to knn1m's `tbl`, whose store is the
        one phase auth found. No fallback, host routing or numpy descent
        may occur."""
        import threading

        from surrealdb_tpu_torch import server as SRV
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.sdk import _live_key, connect

        t_0 = time.perf_counter()
        ds, xs_, q_ = d["ds"], d["xs"], d["qs"]
        sql_out = d.get("sql_out") or {}
        k_ = KNN1M["k"]
        knobs = ("KNN_ANN_MODE", "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        cnf.KNN_ANN_MODE = "off"
        old_sup = SV.set_supervisor(sup_)
        SV.bind_serving()
        ix = ds.vector_indexes[("b", "b", "tbl", "ix")]
        ctr0, hd0 = dict(sup_.counters), ix.ann_host_descents
        srv = SRV.make_server(ds, "127.0.0.1", 0, unauthenticated=True)
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url, base = f"ws://127.0.0.1:{port}", f"http://127.0.0.1:{port}"
        sql = "SELECT id FROM tbl WHERE emb <|10,40|> $q"
        ql = [q.tolist() for q in q_[:64]]
        bf16_ = ("rank_scores_bf16", "select_topk_rows",
                 "gather_rescore_topk")
        out_all, clients, state = {}, [], {"served": True}

        window = functools.partial(launch_window, sup_, counts, "server",
                                   out_all=out_all)

        def ws_knn():
            for _ in range(128):
                c = connect(url, fmt="cbor", timeout=120.0)
                c.use("b", "b")
                clients.append(c)
            per = SQL["knn1m"] // len(clients)
            lat = np.zeros(per * len(clients))

            def client(ci, n_, timed):
                c = clients[ci]
                for j in range(n_):
                    i = ci * n_ + j
                    t0 = time.perf_counter()
                    res = c.query(sql, {"q": ql[i % len(ql)]})
                    if timed:
                        lat[i] = (time.perf_counter() - t0) * 1e3
                    check(res[0]["status"] == "OK"
                          and len(res[0]["result"]) == k_,
                          f"server ws: answer {res[0]}")

            # one untimed query a client (the batched shapes), then the
            # timed ones
            for timed, n_ in ((False, 1), (True, per)):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(len(clients)) as ex:
                    list(ex.map(lambda ci: client(ci, n_, timed),
                                range(len(clients))))
                wall = time.perf_counter() - t0
            out = {"clients": len(clients), "queries": len(lat),
                   "ws_knn_qps": len(lat) / wall,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99)),
                   "sql_knn_qps": sql_out.get("sql_knn_qps"),
                   "index_engine_qps": sql_out.get("index_engine_qps")}
            if out["sql_knn_qps"]:
                out["ws_over_sql"] = out["ws_knn_qps"] / out["sql_knn_qps"]
                out["ws_over_engine"] = (out["ws_knn_qps"]
                                         / out["index_engine_qps"])
            nq_ = 16
            _od, oi = cosine_top(xs_, q_[:nq_], k_)
            got = [record_ids(clients[qi].query(sql, {"q": q_[qi].tolist()})[0]
                       ["result"]) for qi in range(nq_)]
            out["recall_at_10"] = float(np.mean(
                [len(set(a) & set(b.tolist())) / k_
                 for a, b in zip(got, oi)]))
            check(out["recall_at_10"] >= 0.99,
                  f"server ws recall@10 {out['recall_at_10']} < 0.99")
            state["ws_ids"] = got
            return out

        def http_knn():
            t0 = time.perf_counter()
            for qi in range(4):
                want = state["ws_ids"][qi]
                qv = q_[qi].tolist()
                st, _h, b = http_call(
                    base, "/sql", f"LET $q = {json.dumps(qv)}; {sql}".encode())
                rows = json.loads(b)[1]["result"]
                check(st == 200 and [int(r["id"].split(":")[1])
                                     for r in rows] == want,
                      f"server /sql: {st} {rows}")
                st, _h, b = http_call(base, "/rpc", json.dumps(
                    {"id": 1, "method": "query",
                     "params": [sql, {"q": qv}]}).encode(),
                    {"Content-Type": "application/json"})
                rows = json.loads(b)["result"][0]["result"]
                check(st == 200 and [int(r["id"].split(":")[1])
                                     for r in rows] == want,
                      f"server /rpc: {st} {rows}")
            return {"queries": 4, "ids_equal_ws": True,
                    "ms_per_pair": (time.perf_counter() - t0) * 1e3 / 4}

        def live():
            a, b = clients[0], clients[1]
            got = []
            lid = _live_key(a.query("LIVE SELECT id FROM acl")[0]["result"])
            a.engine.register_live(lid, got.append)
            rid = d["acl"]["xs"].shape[0] + 7
            v = np.random.default_rng(KNN1M["seed"] + 5).standard_normal(
                KNN1M["dim"]).astype(np.float32).tolist()
            out = {}
            t0 = time.perf_counter()
            b.query(f"CREATE acl:{rid} SET emb = $v", {"v": v})
            end = time.monotonic() + 30
            while not got and time.monotonic() < end:
                time.sleep(0.001)
            out["notify_ms"] = (time.perf_counter() - t0) * 1e3
            check(len(got) == 1 and got[0]["action"] == "CREATE"
                  and got[0]["record"].id == rid
                  and got[0]["result"]["id"].id == rid,
                  f"server live: notifications {got}")
            t0 = time.perf_counter()
            first = record_ids(b.query(
                "SELECT id FROM acl WHERE emb <|10|> $q",
                {"q": v})[0]["result"])
            out["probe_ms"] = (time.perf_counter() - t0) * 1e3
            check(first[:1] == [rid],
                  f"server live: the probe found {first}")
            a.kill(lid)
            check(lid not in ds.live_queries,
                  "server live: KILL left the subscription")
            b.query(f"CREATE acl:{rid + 1} SET emb = $v", {"v": v})
            time.sleep(1.0)
            check(len(got) == 1,
                  f"server live: delivered after KILL: {got}")
            b.query(f"DELETE acl:{rid}; DELETE acl:{rid + 1}")
            # the next query (the drain's in-flight one) must not see them
            state["deleted"] = (v, (rid, rid + 1))
            out.update(notifications=len(got), quiet_after_kill_s=1.0)
            return out

        def soak():
            for c in clients:
                c.close()
            clients.clear()
            out = live_soak(ds, port, sessions=64, frozen=2, writers=4,
                            writes=400, payload_pad=256, table="soak",
                            ns="s", db="s")
            check(out["order_violations"] == 0,
                  f"server soak: order violations {out}")
            check(out["per_session_complete"] == 62,
                  f"server soak: complete sessions {out}")
            check(out["live_sessions_end"] == 0,
                  f"server soak: live queries left {out}")
            return out

        def drain():
            keeper = KeepRunner(sup_)
            SV.set_supervisor(keeper)
            res, dr = {}, {}

            v, gone = state["deleted"]

            def inflight():
                with connect(base, fmt="cbor") as h:
                    h.use("b", "b")
                    t0 = time.perf_counter()
                    res["r"] = h.query(
                        "SLEEP 500ms; SELECT id FROM acl WHERE emb <|10,40|> "
                        "$q", {"q": v})
                    res["ms"] = (time.perf_counter() - t0) * 1e3

            t = threading.Thread(target=inflight, daemon=True)
            t.start()
            end = time.monotonic() + 10
            while ds.inflight.count() == 0 and time.monotonic() < end:
                time.sleep(0.002)
            check(ds.inflight.count() > 0, "server drain: nothing in flight")

            def drainer():
                dr["clean"] = SRV.drain_and_shutdown(srv, ds, 30.0)

            td = threading.Thread(target=drainer, daemon=True)
            t0 = time.perf_counter()
            td.start()
            while not srv.admission.draining:
                time.sleep(0.001)
            st, hdrs, body = http_call(base, "/sql", b"RETURN 1")
            shed = json.loads(body)
            check(st == 503 and shed["code"] == 503
                  and int(hdrs.get("Retry-After", 0)) >= 1,
                  f"server drain: a new request got {st} {shed}")
            td.join(60)
            t.join(60)
            state["served"] = False
            SV.set_supervisor(sup_)
            check(dr.get("clean") is True, f"server drain: {dr}")
            rows = res["r"][1]
            check(rows["status"] == "OK" and len(rows["result"]) == k_
                  and not set(record_ids(rows["result"])) & set(gone),
                  f"server drain: the in-flight query answered {res}")
            check(keeper.shutdowns == 1,
                  f"server drain: supervisor shutdowns {keeper.shutdowns}")
            return {"drain_s": time.perf_counter() - t0, "clean": True,
                    "shed_status": st,
                    "retry_after_ms": shed["retry_after_ms"],
                    "inflight_ms": res["ms"], "inflight_answered": True,
                    "deleted_rows_gone": True}

        try:
            window("ws_knn", ws_knn, bf16_)
            window("http", http_knn, bf16_)
            window("live", live, bf16_)
            window("soak", soak, ())
            window("drain", drain, bf16_)
            ctr = dict(sup_.counters)
            for name in ("device_fallbacks", "device_host_routed"):
                check(ctr[name] == ctr0[name],
                      f"server: {name} moved {ctr0[name]} -> {ctr[name]}")
            check(ix.ann_host_descents == hd0,
                  "server: the numpy descent ran")
            check((ix._dev_key, ix.version, ix._dev_epoch)
                  == d["tbl_store"], "server: knn1m's store was shipped "
                  "again")
            emit("server", mode=sup_.mode, counters=ctr,
                 steps=sorted(out_all),
                 seconds=round(time.perf_counter() - t_0, 3))
        finally:
            for c in clients:
                c.close()
            if state["served"]:
                srv.shutdown()
            srv.server_close()
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    # -- full-text + vector search through SurrealQL (also `--only search`)
    def search_phase(sup_, counts=None):
        """bench.py:1230 bench_hybrid's configuration through the port's
        `Datastore.execute`, under `sup_` (mode require): its analyzer,
        a FULLTEXT BM25 index on `text` and an HNSW index (D 64, cosine,
        f32) on `emb`; HYBRID["n"] documents of 8 words of its 10-word
        vocabulary and a normal 64-wide vector each (seed 23), written
        by its CREATE in the ingest worker (`hybrid_ingest`) and carried
        into this process's datastore as its committed KV items; then
        its script (LET $vs <|10,40|>, LET $ft
        @1@ 'graph' ORDER BY ft_score DESC LIMIT 10, RETURN
        search::rrf), one warm-up and HYBRID["iters"] timed runs, and
        one more that also returns $vs and $ft. Each run has the
        runner's launch counts set to 0 just before it and read just
        after: rank_scores_bf16, select_topk_rows and
        gather_rescore_topk launch in every run, distance_tile in none.
        $vs holds the f64 cosine top 10 (ids wherever neighbouring
        oracle distances differ by more than 1e-4, distances within
        1e-4); every $ft hit holds 'graph' and its ft_score is the
        reference's BM25 recomputed in numpy (0.0 at this data: every
        word is in more than half the documents, so the clamped idf is
        0); the fused list is search::rrf recomputed here from the two.
        No fallback may hide the card. Prints the ingest seconds, the
        scripts a second and the stage split of the timed runs."""
        import math

        from surrealdb_tpu_torch import telemetry as TEL
        from surrealdb_tpu_torch.carry import datastore_from_items
        from surrealdb_tpu_torch.device import supervisor as SV

        t_0 = time.perf_counter()
        n_, dim_ = HYBRID["n"], HYBRID["dim"]
        host_batch = cnf.KNN_HOST_BATCH
        cnf.KNN_HOST_BATCH = "auto"
        old_sup = SV.set_supervisor(sup_)
        SV.bind_serving()
        ctr0 = dict(sup_.counters)
        brute_ = ("distance_tile", "distance_tile_tf32", "distance_tile_simt")
        needs = ("rank_scores_bf16", "select_topk_rows",
                 "gather_rescore_topk")
        try:
            items, ids, texts, embs, q, ingest_s = hybrid[1]()
            ds = datastore_from_items(items)
            id_row = {rid: i for i, rid in enumerate(ids)}
            check(len(id_row) == n_ == ds.query_one(
                "SELECT count() FROM doc GROUP ALL", ns="b",
                db="b")[0]["count"], "search: the documents differ")

            launched = {}
            spent = {}  # stage -> ns inside the timed scripts

            def stages():
                return {name: st.total_ns
                        for name, st in list(TEL._STAGES.items())}

            def run(sql, timed=False):
                sup_.call("launch_counts", {"reset": True})
                st0 = stages()
                t1 = time.perf_counter()
                res = ds.execute(sql, ns="b", db="b", vars={"q": q.tolist()})
                dt = time.perf_counter() - t1
                if timed:
                    for name, v in stages().items():
                        spent[name] = spent.get(name, 0) + v - st0.get(name, 0)
                _, m, _ = sup_.call("launch_counts", {})
                for r in res:
                    check(r.error is None, f"search: {r.error}")
                for kname, v in m["launches"].items():
                    launched[kname] = launched.get(kname, 0) + v
                    if counts is not None:
                        counts[kname] += v
                for kname in needs:
                    check(m["launches"][kname] > 0,
                          f"search: kernel {kname} was not launched")
                for kname in brute_:
                    check(m["launches"].get(kname, 0) == 0,
                          f"search: kernel {kname} was launched")
                return res, dt

            _, warm_s = run(HYBRID_SQL)
            times = [run(HYBRID_SQL, timed=True)[1]
                     for _ in range(HYBRID["iters"])]
            iters = len(times)

            def per(name):
                return spent.get(name, 0) / 1e6 / iters

            mean = float(np.mean(times)) * 1e3
            # one client: each device call lies inside the index search,
            # which lies inside `plan`, which lies inside the script.
            # Each window holds the script alone (the launch-count calls
            # around it are device calls too, and stay outside)
            knn_, rpc_ = per("index_knn"), per("device_rpc")
            stages_ms = {"parse": per("parse"),
                         "plan": per("plan") - knn_,
                         "coalescer_wait": knn_ - rpc_,
                         "device_rpc": rpc_,
                         "rest": mean - per("parse") - per("plan")}
            check(rpc_ > 0 and min(stages_ms.values()) >= 0,
                  f"search: the stage split does not nest: {stages_ms}")
            res, _ = run(HYBRID_SQL + "RETURN $vs; RETURN $ft;")
            fused, vs, ft = res[2].result, res[3].result, res[4].result

            # $vs: the f64 cosine top 10
            x64 = embs.astype(np.float64)
            q64 = q.astype(np.float64)
            d64 = 1.0 - x64 @ q64 / np.maximum(
                np.linalg.norm(x64, axis=1) * np.linalg.norm(q64), 1e-300)
            oi = np.argsort(d64, kind="stable")[:11]
            check(len(vs) == 10, f"search $vs: {len(vs)} rows")
            got_i = np.array([[id_row[r["id"].id] for r in vs]])
            vs_err = float(np.abs(np.array([r["distance"] for r in vs])
                                  - d64[oi[:10]]).max())
            check(vs_err <= 1e-4, f"search $vs: distance error {vs_err}")
            check_ids_past(d64[oi][None, :], oi[None, :], got_i,
                           "search $vs vs oracle", 1e-4)
            # $ft: the reference's BM25 (idx/fulltext.py _ft_search_impl)
            toks = [t.split() for t in texts]
            avg = sum(len(t) for t in toks) / n_
            df = sum(1 for t in toks if "graph" in t)
            idf = max(math.log((n_ - df + 0.5) / (df + 0.5)), 0.0)
            check(len(ft) == 10, f"search $ft: {len(ft)} rows")
            ft_err = 0.0
            for r in ft:
                t = toks[id_row[r["id"].id]]
                tf = t.count("graph")
                check(tf > 0, f"search $ft: {r['id']} lacks 'graph'")
                tfp = 1.0 + math.log(tf)
                k1, b_ = float(np.float32(1.2)), float(np.float32(0.75))
                want = 0.0 if idf == 0.0 else float(np.float32(
                    idf * (k1 + 1) * tfp
                    / (tfp + k1 * ((1 - b_) + b_ / avg * len(t)))))
                ft_err = max(ft_err, abs(r["ft_score"] - want))
            check(ft_err <= 1e-6, f"search $ft: BM25 error {ft_err}")
            # the fused list: search::rrf([$vs, $ft], 10, 60) recomputed
            scores, merged, order = {}, {}, []
            for lst in (vs, ft):
                for rank, item in enumerate(lst):
                    h = item["id"].id
                    if h not in merged:
                        merged[h] = dict(item)
                        order.append(h)
                    else:
                        merged[h].update(item)
                    scores[h] = scores.get(h, 0.0) + 1.0 / (60 + rank + 1)
            want_ids = sorted(order, key=lambda h: -scores[h])[:10]
            check([r["id"].id for r in fused] == want_ids,
                  "search: the fused order differs from search::rrf's")
            check(all(abs(r["rrf_score"] - scores[r["id"].id]) <= 1e-12
                      for r in fused), "search: rrf scores differ")
            ctr = dict(sup_.counters)
            for cname in ("device_fallbacks", "device_host_routed"):
                check(ctr[cname] == ctr0[cname],
                      f"search: {cname} moved {ctr0[cname]} -> {ctr[cname]}")
            emit("search", mode=sup_.mode, docs=n_, dim=dim_,
                 ingest_s=ingest_s, warm_s=warm_s,
                 scripts_per_s=iters / float(np.sum(times)),
                 p50_ms=float(np.percentile(times, 50)) * 1e3,
                 mean_ms=mean, stages_ms=stages_ms, runs=iters + 2,
                 vs_max_abs_err=vs_err, ft_max_abs_err=ft_err,
                 ft_idf=idf, ft_docs_with_term=df,
                 fused=len(fused),
                 launches={kn: v for kn, v in launched.items() if v},
                 counters={c: ctr[c] for c in ("device_fallbacks",
                                               "device_host_routed")},
                 seconds=round(time.perf_counter() - t_0, 3))
            ds.close()
        finally:
            SV.bind_serving()
            SV.set_supervisor(old_sup)
            cnf.KNN_HOST_BATCH = host_batch

    def search_only():
        """`--only search`: the search phase under a supervisor in mode
        require of its own."""
        sup_ = DeviceSupervisor("require", device="cuda")
        try:
            sup_.start()
            search_phase(sup_)
        finally:
            sup_.shutdown()

    # -- segmented ANN and the persisted artifacts (also `--only segments`) ---
    def euclid_oracle(xs_, qs_, kk, step=1 << 18):
        """The exact f64 euclidean top kk of qs_ over the host rows xs_
        (indices into xs_), streamed through the card in blocks."""
        q64 = torch.from_numpy(np.ascontiguousarray(qs_)).to(dev).double()
        q2 = (q64 * q64).sum(dim=1)
        tv_, ti_ = [], []
        for s0 in range(0, xs_.shape[0], step):
            b64 = torch.from_numpy(xs_[s0:s0 + step]).to(dev).double()
            d_ = (b64 * b64).sum(dim=1)[:, None] - 2.0 * (b64 @ q64.T) \
                + q2[None, :]
            v_, i_ = torch.topk(d_, min(kk, d_.shape[0]), dim=0,
                                largest=False)
            tv_.append(v_)
            ti_.append(i_ + s0)
            del b64, d_
        _, sel_ = torch.topk(torch.cat(tv_), kk, dim=0, largest=False)
        return torch.gather(torch.cat(ti_), 0, sel_).T.cpu().numpy()

    def segments_phase(sup_, counts=None):
        """Segmented ANN (idx/segments.py) and the persisted artifacts
        under `sup_` (a supervisor in mode require over a runner on the
        card): (a) churn at bench.py:540 bench_knn_churn's full
        configuration through the port's KV (CHURN), (b) every ready
        segment's descent held to its plain version, knn_batch at B=512
        against the f64 oracle, (c) a file:// datastore's graph reloaded
        after a restart (the ann rows). No fallback may hide the card:
        device_fallbacks, device_host_routed and ann_host_descents stay
        where they were."""
        import shutil

        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch import resource
        from surrealdb_tpu_torch.device import supervisor as SV
        from surrealdb_tpu_torch.idx import cagra as CG
        from surrealdb_tpu_torch.idx import vector as V
        from surrealdb_tpu_torch.kvs.api import serialize
        from surrealdb_tpu_torch.kvs.ds import Datastore
        from surrealdb_tpu_torch.val import RecordId

        t_0 = time.perf_counter()
        knobs = ("KNN_SEG_MODE", "KNN_SEG_ROWS", "KNN_ANN_MODE",
                 "KNN_HOST_BATCH")
        saved = {name: getattr(cnf, name) for name in knobs}
        cnf.KNN_HOST_BATCH = "auto"
        old_acct = resource.set_accountant(
            resource.MemoryAccountant(resource.host_limit_bytes()))
        old_sup = SV.set_supervisor(sup_)
        ctr0 = dict(sup_.counters)
        out_all = {}

        def path(name, fn, needs):
            """One path with the runner's launch counts set to 0 just
            before it and read just after."""
            sup_.call("launch_counts", {"reset": True})
            out = fn()
            _, m, _ = sup_.call("launch_counts", {})
            if counts is not None:
                for kname, v in m["launches"].items():
                    counts[kname] += v
            for kname in needs:
                check(m["launches"][kname] > 0,
                      f"segments {name}: kernel {kname} was not launched")
            out["launches"] = {kn: v for kn, v in m["launches"].items() if v}
            emit(f"segments_{name}", **out, events=m["events"])
            out_all[name] = out

        def pct(vals, p):
            vals = sorted(vals)
            return vals[min(int(p * (len(vals) - 1)), len(vals) - 1)]

        def ids_of(res):
            return np.array([[r.id for r, _d in row] for row in res])

        def recall(got_ids, oracle):
            return float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                                  / oracle.shape[1]
                                  for a, b in zip(got_ids, oracle)]))

        C = CHURN
        n0, dim = C["n0"], C["dim"]
        total = n0 + C["rounds"] * C["add"]
        rng = np.random.default_rng(C["seed"])
        nc = max(n0 // 200, 64)
        centers = rng.normal(size=(nc, dim)).astype(np.float32)
        xs_all = np.empty((total, dim), np.float32)
        live = np.zeros(total, bool)

        def mkvecs(count, out=None):
            """bench.py's mkvecs (the same draws), filled in chunks."""
            idx = rng.integers(0, nc, count)
            out = np.empty((count, dim), np.float32) if out is None else out
            for s0 in range(0, count, 1 << 17):
                e0 = min(s0 + (1 << 17), count)
                out[s0:e0] = (centers[idx[s0:e0]] + 0.15 * rng.normal(
                    size=(e0 - s0, dim))).astype(np.float32)
            return out

        params = {"dimension": dim, "distance": "euclidean",
                  "vector_type": "f32"}
        state = {"ver": 0}

        def churn_ops(ds, add_ids, dels):
            """bench.py's _churn_ops through the port's KV: a record,
            `he` and an `hl` entry a row, deletes, then `vn`."""
            ver = state["ver"]
            t = ds.transaction(write=True)
            try:
                for i in add_ids:
                    i = int(i)
                    raw = xs_all[i].tobytes()
                    t.set(K.record("b", "b", "tbl", i),
                          serialize({"id": RecordId("tbl", i)}))
                    t.set_val(K.ix_state("b", "b", "tbl", "ix", b"he",
                                         K.enc_value(i)), raw)
                    ver += 1
                    t.set_val(K.ix_state("b", "b", "tbl", "ix", b"hl",
                                         K.enc_u64(ver)), ("set", i, raw))
                for i in dels:
                    i = int(i)
                    t.delete(K.record("b", "b", "tbl", i))
                    t.delete(K.ix_state("b", "b", "tbl", "ix", b"he",
                                        K.enc_value(i)))
                    ver += 1
                    t.set_val(K.ix_state("b", "b", "tbl", "ix", b"hl",
                                         K.enc_u64(ver)), ("del", i, None))
                t.set_val(K.ix_state("b", "b", "tbl", "ix", b"vn"), ver)
                t.commit()
            except BaseException:
                t.cancel()
                raise
            state["ver"] = ver
            live[np.asarray(add_ids, np.int64)] = True
            live[np.asarray(dels, np.int64)] = False

        ds = Datastore()
        seg_ix = {}

        def churn_path():
            cnf.KNN_SEG_MODE, cnf.KNN_SEG_ROWS = "force", C["seal"]
            cnf.KNN_ANN_MODE = "force"
            t0 = time.perf_counter()
            mkvecs(n0, xs_all[:n0])
            out = {"rows": n0, "dim": dim, "centres": nc,
                   "seal_rows": C["seal"], "gen_s": time.perf_counter() - t0}
            t0 = time.perf_counter()
            churn_ops(ds, range(n0), [])
            out["ingest_s"] = time.perf_counter() - t0
            ctx = ds.context("b", "b")
            ix = V.get_vector_index(hnsw_def("tbl", params), ctx)
            seg_ix["ix"] = ix
            hd0 = ix.ann_host_descents
            t0 = time.perf_counter()
            ix.knn(mkvecs(1)[0].tolist(), 10, ctx)  # sync, engage, seal
            out["first_sync_s"] = time.perf_counter() - t0
            check(len(ix.rids) == n0 and ix._segs is not None
                  and ix._segs.active(), "churn: the first seal")
            t0 = time.perf_counter()
            check(ix.ensure_ann(), "churn: the first seal did not drain")
            out["first_build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ix.knn(xs_all[0].tolist(), 10, ctx)  # ships the 1M segment
            out["first_ship_s"] = time.perf_counter() - t0
            ctx.txn.cancel()
            nid = n0
            lat_ms, ingest_ms, recalls = [], [], []
            for r in range(C["rounds"]):
                add_ids = np.arange(nid, nid + C["add"])
                mkvecs(C["add"], xs_all[nid:nid + C["add"]])
                nid += C["add"]
                pool = np.flatnonzero(live)
                dels = rng.choice(pool, size=min(C["dele"], len(pool) - 1),
                                  replace=False)
                churn_ops(ds, add_ids, dels)
                ctx = ds.context("b", "b")
                probe_id = int(add_ids[-1])
                t0 = time.perf_counter()
                got = ix.knn(xs_all[probe_id].tolist(), 1, ctx)
                ingest_ms.append((time.perf_counter() - t0) * 1e3)
                check([rid.id for rid, _d in got] == [probe_id],
                      f"churn round {r}: the committed row is not "
                      f"searchable ({got})")
                round_lat = []
                for qv in mkvecs(C["nq"]):
                    t0 = time.perf_counter()
                    ix.knn(qv.tolist(), 10, ctx)
                    round_lat.append((time.perf_counter() - t0) * 1e3)
                lat_ms.append(round_lat)
                if r % 4 == 3 or r == C["rounds"] - 1:
                    qr = mkvecs(8)
                    got_i = np.array([[rid.id for rid, _d in
                                       ix.knn(q.tolist(), 10, ctx)]
                                      for q in qr])
                    live_ids = np.flatnonzero(live)
                    oracle = live_ids[euclid_oracle(xs_all[live_ids], qr,
                                                    10)]
                    recalls.append(recall(got_i, oracle))
                    check(recalls[-1] >= 0.95,
                          f"churn round {r}: recall@10 {recalls[-1]}")
                ctx.txn.cancel()
            segs = ix._segs
            t0 = time.perf_counter()
            check(segs.drain(), "churn: segments not all ready after drain")
            out["final_drain_s"] = time.perf_counter() - t0
            st = segs.status()
            check(all(s["state"] == "ready" for s in st["spans"]),
                  f"churn: spans {st['spans']}")
            check(ix.ann_full_rebuilds == 0 and st["stats"][
                "ann_full_rebuilds"] == 0,
                  f"churn: {ix.ann_full_rebuilds} whole-store rebuilds")
            check(ix.ann_host_descents == hd0,
                  f"churn: {ix.ann_host_descents - hd0} numpy descents")

            def third(frac0, frac1):
                return [x for rl in lat_ms[int(len(lat_ms) * frac0):
                                           max(int(len(lat_ms) * frac1), 1)]
                        for x in rl] or [0.0]

            all_lat = [x for rl in lat_ms for x in rl]
            first, last = third(0.0, 1 / 3), third(2 / 3, 1.0)
            out.update(
                rounds=C["rounds"], add=C["add"], dele=C["dele"],
                rows_end=int(live.sum()), recalls=recalls,
                recall_at_10_min=min(recalls),
                p50_ms=pct(all_lat, 0.5), p99_ms=pct(all_lat, 0.99),
                p50_ms_first_third=pct(first, 0.5),
                p99_ms_first_third=pct(first, 0.99),
                p50_ms_last_third=pct(last, 0.5),
                p99_ms_last_third=pct(last, 0.99),
                ingest_to_searchable_ms=ingest_ms,
                ingest_to_searchable_ms_p95=pct(ingest_ms, 0.95),
                ingest_to_searchable_ms_max=max(ingest_ms),
                segments=st["segments"], ready=st["ready"],
                tail_rows=st["tail_rows"], seg_counters=st["stats"],
                spans=[{**s, "build_s": seg.graph[0].build_s}
                       for s, seg in zip(st["spans"], segs.segs)],
                ann_full_rebuilds=ix.ann_full_rebuilds,
                residency=ix.residency())
            return out

        def descent_path():
            """(b) each ready segment's candidates from the runner (its own
            block) at B 1 / 512 equal to the plain descent on the card
            over the same arrays, at the engine's kc for that segment;
            knn_batch at B=512 equal to those candidates re-ranked here
            in f64 and merged (exact over the spans), and its recall@10
            against the f64 oracle, split by segment; the numpy
            descent's overlap with the card's beside it."""
            ix = seg_ix["ix"]
            qs_ = mkvecs(512)
            q64 = qs_.astype(np.float64)
            k_ = 10
            segs = list(ix._segs.segs)
            check(all(s.state == "ready" for s in segs)
                  and ix._segs.status()["tail_rows"] == 0
                  and not ix._ann_dirty, "descent: the drained set")
            valid = ix.valid
            out = {"segments": []}
            lists = []
            for seg in segs:
                ann, row_map = seg.graph
                m = ann.built_n
                # the engine's kc for this segment (_graph_span)
                live_graph = int(np.count_nonzero(
                    valid[row_map] if row_map is not None
                    else valid[seg.lo:seg.lo + m]))
                density = max(live_graph, 1) / max(m, 1)
                factor = min(int(np.ceil(1.0 / max(density, 1.0 / 64))), 64)
                kc = min(m, max(cnf.KNN_ANN_OVERSAMPLE * k_ * factor, 32))
                st_ = A.AnnStore("seg-check", ann.graph, ann.x8, ann.arow,
                                 ann.x2, ann.metric, cnf.ann_search_cfg(),
                                 dev)
                dv = st_._ensure()
                width, iters, expand, kc_ = st_._clamped(kc)
                row = {"lo": seg.lo, "hi": seg.hi, "graph_rows": m,
                       "live_graph": live_graph, "identity": row_map is None,
                       "kc": kc_, "width": width}
                tag = [int(seg.seq), int(seg.lo), int(seg.hi)]
                # a segment sealed late in the churn is first shipped here
                t0 = time.perf_counter()
                ix._ann_device_search(ann, qs_[:1], kc, dev_key=seg.dev_key,
                                      tag=tag)
                row["first_call_ms"] = (time.perf_counter() - t0) * 1e3
                for b in (1, 512):
                    t0 = time.perf_counter()
                    cand = ix._ann_device_search(ann, qs_[:b], kc,
                                                 dev_key=seg.dev_key,
                                                 tag=tag)
                    row[f"B{b}_frame_ms"] = (time.perf_counter() - t0) * 1e3
                    qa = torch.from_numpy(qs_[:b]).to(dev)
                    pscore = T.rank_scores_int8_plain(
                        dv["x8p"], qa, ann.metric, dv["arowp"], dv["x2qp"],
                        probe_order=True)
                    pd0, psel = T.top_k_smallest_plain(pscore, width)
                    pi, _pd = A.ann_descent_plain(
                        dv["graph"], dv["x8"], dv["arow"], dv["x2q"], qa,
                        dv["probe_ids"][psel.long()], pd0, ann.metric,
                        iters, expand, kc_)
                    pi = pi.cpu().numpy()
                    check(np.array_equal(cand, pi),
                          f"segment [{seg.lo}, {seg.hi}) B={b}: ids differ "
                          f"from the plain descent")
                    del pscore, pd0, psel
                row["ids_equal_plain"] = True
                # the f64 re-rank of the plain candidates (row ids of the
                # span, tombstones masked), the segment's own top k
                seg_lists = []
                for i in range(len(qs_)):
                    ids = pi[i].astype(np.int64)
                    ids = ids[(ids >= 0) & (ids < m)]
                    ids = np.unique(row_map[ids] if row_map is not None
                                    else ids + seg.lo)
                    diff = xs_all[ids].astype(np.float64) - q64[i]
                    d_ = np.sqrt(np.add.reduce(diff * diff, axis=-1))
                    d_ = np.where(valid[ids], d_, np.inf)
                    o_ = np.argsort(d_, kind="stable")[:k_]
                    seg_lists.append([(int(ids[j]), float(d_[j]))
                                      for j in o_ if np.isfinite(d_[j])])
                check(all(len(sl) == k_ for sl in seg_lists),
                      f"segment [{seg.lo}, {seg.hi}) underfilled")
                lists.append(seg_lists)
                span_live = seg.lo + np.flatnonzero(valid[seg.lo:seg.hi])
                soracle = span_live[euclid_oracle(xs_all[span_live], qs_,
                                                  k_)]
                row["segment_recall_at_10"] = recall(
                    np.array([[r for r, _d in sl] for sl in seg_lists]),
                    soracle)
                # the numpy descent (the engine's host fallback) scores
                # f32 queries against the dequantised rows: the card
                # quantises the queries too, so only the overlap is shown
                cfg = cnf.ann_search_cfg()
                w_ = min(max(cfg["width"], kc), m)
                fn, probe_fn = CG.int8_score_fn(ann, qs_)
                host = CG.descend(ann.graph, m, fn, len(qs_), w_,
                                  cfg["iters"], min(cfg["expand"], w_), kc,
                                  probe_fn=probe_fn)
                row["numpy_descent_overlap"] = float(np.mean([
                    len(set(a.tolist()) & set(b_.tolist())) / kc_
                    for a, b_ in zip(pi, host)]))
                out["segments"].append(row)
                del st_, dv
                torch.cuda.empty_cache()
            with ix.rw.read():
                t0 = time.perf_counter()
                res = ix.knn_batch(qs_, k_)
                out["B512_ms"] = (time.perf_counter() - t0) * 1e3
            want = []
            for i in range(len(qs_)):
                merged = sorted((p for sl in lists for p in sl[i]),
                                key=lambda p: p[1])[:k_]
                want.append(merged)
            got_i, want_i = ids_of(res), np.array([[r for r, _d in w]
                                                   for w in want])
            check(np.array_equal(got_i, want_i)
                  and np.allclose([[d for _r, d in row] for row in res],
                                  [[d for _r, d in w] for w in want],
                                  rtol=0, atol=1e-12),
                  "knn_batch B=512 differs from the segments' plain "
                  "candidates re-ranked and merged")
            out["B512_equal_plain_merge"] = True
            live_ids = np.flatnonzero(live)
            oracle = live_ids[euclid_oracle(xs_all[live_ids], qs_, k_)]
            out["B512_recall_at_10"] = recall(got_i, oracle)
            check(out["B512_recall_at_10"] >= 0.95,
                  f"segments B=512 recall@10 {out['B512_recall_at_10']}")
            return out

        def restart_path():
            """(c) the ann cell's rows in a file:// datastore: build and
            save, close, reopen, reload with no build; the arrays and
            the B=512 ids equal across the restart."""
            cnf.KNN_SEG_MODE = saved["KNN_SEG_MODE"]
            cnf.KNN_ANN_MODE = "auto"
            xs_, q_ = ann_rows()
            n_, dim_ = xs_.shape
            check(n_ < cnf.KNN_SEG_MIN_ROWS, "restart rows past the floor")
            base = os.path.join(cache_dir, "seg_restart", str(os.getpid()))
            shutil.rmtree(base, ignore_errors=True)
            rp = {"dimension": dim_, "distance": "cosine",
                  "vector_type": "f32"}
            out = {"rows": n_, "dim": dim_}
            try:
                ds1 = Datastore(f"file://{base}")
                t0 = time.perf_counter()
                t = ds1.transaction(write=True)
                for i in range(n_):
                    t.set(K.record("b", "b", "ann", i),
                          serialize({"id": RecordId("ann", i)}))
                    t.set_val(K.ix_state("b", "b", "ann", "ix", b"he",
                                         K.enc_value(i)), xs_[i].tobytes())
                t.set_val(K.ix_state("b", "b", "ann", "ix", b"vn"), n_)
                t.commit()
                out["ingest_s"] = time.perf_counter() - t0

                def open_sync(ds_):
                    # the sync schedules no background build (ANN off
                    # for it): ensure_ann's time is the build or the
                    # reload alone
                    cnf.KNN_ANN_MODE = "off"
                    c_ = ds_.context("b", "b")
                    ix_ = V.get_vector_index(hnsw_def("ann", rp), c_)
                    ix_.sync(c_)
                    c_.txn.cancel()
                    cnf.KNN_ANN_MODE = "auto"
                    check(ix_.snapshot_dir == ds_.ann_snapshot_dir,
                          "the engine's snapshot_dir")
                    return ix_

                ix1 = open_sync(ds1)
                t0 = time.perf_counter()
                check(ix1.ensure_ann(), "restart: no graph before")
                out["ensure_s"] = time.perf_counter() - t0
                out["build_s"] = ix1._ann.build_s
                check((ix1.ann_builds, ix1.ann_reloads) == (1, 0),
                      "restart: the first open must build")
                built = ix1._ann
                before = ix1.knn_batch(q_[:512], 10)
                out["artifact_bytes"] = os.path.getsize(
                    ix1._ann_snap_path())
                t0 = time.perf_counter()
                ds1.close()
                out["close_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ds2 = Datastore(f"file://{base}")
                out["reopen_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ix2 = open_sync(ds2)
                out["sync_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                check(ix2.ensure_ann(), "restart: no graph after")
                out["reload_s"] = time.perf_counter() - t0
                check((ix2.ann_builds, ix2.ann_reloads) == (0, 1),
                      f"restart: {ix2.ann_builds} builds after the reopen")
                for name in ("graph", "x8", "arow", "x2", "inv_norms"):
                    check(np.array_equal(getattr(ix2._ann, name),
                                         getattr(built, name)),
                          f"restart: reloaded {name} differs")
                after = ix2.knn_batch(q_[:512], 10)
                check(np.array_equal(ids_of(after), ids_of(before)),
                      "restart: ids differ across the restart")
                out["ids_equal_across_restart"] = True
                sup_.call("ann_drop", {"key": ix1._ann_dev_key})
                sup_.call("ann_drop", {"key": ix2._ann_dev_key})
                ds2.close()
            finally:
                shutil.rmtree(base, ignore_errors=True)
            return out

        try:
            path("churn", churn_path, ("ann_descent", "rank_scores_int8",
                                       "select_topk_rows"))
            path("descent", descent_path, ("ann_descent",))
            for seg in seg_ix["ix"]._segs.segs:
                sup_.call("ann_drop", {"key": seg.dev_key})
            ds.close()
            seg_ix.clear()
            path("restart", restart_path, ("ann_descent",))
            ctr = dict(sup_.counters)
            for name in ("device_fallbacks", "device_host_routed"):
                check(ctr[name] == ctr0[name],
                      f"segments: {name} moved {ctr0[name]} -> {ctr[name]}")
            check(sup_.mode == "require", f"supervisor mode {sup_.mode}")
            emit("segments", mode=sup_.mode, counters=ctr,
                 paths=sorted(out_all),
                 seconds=time.perf_counter() - t_0)
        finally:
            SV.set_supervisor(old_sup)
            resource.set_accountant(old_acct)
            for name, v in saved.items():
                setattr(cnf, name, v)
        return out_all

    def segments_only():
        """`--only segments`: the segments phase under a supervisor in
        mode require of its own."""
        sup_ = DeviceSupervisor("require", device="cuda")
        try:
            sup_.start()
            segments_phase(sup_)
        finally:
            sup_.shutdown()

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
    if hybrid is not None:
        # no measured phase shares the host with the ingest
        emit("hybrid_ingest", waited_s=round(hybrid[0](), 3))
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
        if "hier" in only or "approx" in only:
            full_o, norms_o, rank_o, qs_o = knn1m_device()
            if "approx" in only:
                approx_check(rank_o, qs_o)
            if "hier" in only:
                hier_check(full_o, norms_o, rank_o, qs_o,
                           knn1m_oracle(full_o, norms_o, qs_o))
            del full_o, norms_o, rank_o, qs_o
            torch.cuda.empty_cache()
        if "onnx" in only:
            onnx_check()
        if "entry" in only:
            entry_check()
        if "batcher" in only:
            batcher_only()
        if {"engine", "sql", "auth", "ml", "api", "server"} & set(only):
            engine_only(
                with_sql=bool({"sql", "auth", "ml", "api", "server"}
                              & set(only)),
                with_auth=bool({"auth", "ml", "api", "server"} & set(only)),
                with_ml="ml" in only, with_api="api" in only,
                with_server="server" in only)
        if "segments" in only:
            segments_only()
        if "search" in only:
            search_only()
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
    # the launch counts of the main path's runs (the runners' and this
    # process's), set to 0 just before each path and read just after
    launches = {name: 0 for name in kernelstats.KERNELS}
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

    # knn_rank_approx over the same store: a rank and a select a batch
    approx_check(rank, qs, launches)

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

    # ONNX graphs on the card against the CPU, then the entry
    # points (whose guard spawns and stops a runner of its own)
    onnx_check()
    entry_check(launches)

    # -- 4. the runner as a server ----------------------------------------------
    # mode require: the engine phase (4b) runs over this runner, and no
    # failure may degrade to a host path
    sup = DeviceSupervisor("require", device="cuda")
    try:
        ready = sup.start()
        check(ready["platform"] == "cuda", f"runner platform {ready}")
        emit("runner", ready=ready, pid=sup.runner_pid())
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
            oracle = knn1m_oracle(full, norms, qs, nq)
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
            # the store stays for the engine phase (4b), which drops it
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

        # -- 4b. the index engines over this runner --------------------------
        t0 = time.perf_counter()
        xs_np = np.random.default_rng(KNN1M["seed"]).standard_normal(
            (n, dim), dtype=np.float32)  # the knn1m rows, same generator
        gen_s = time.perf_counter() - t0
        data = {"xs1m": xs_np, "qs1m": qs_np,
                "oracle1m": single["knn1m_oracle"], "xs10": xs10, "q10": q10,
                "oracle10": oracle10,
                "knn10m_store": ("vec/b/b/tbl10m/ix", [1, 0]),
                "ann_xs": ann["xs"], "ann_qs": ann["qs"],
                "ann_oracle": ann_oracle, "ann_graph": ann["graph"],
                "src": src_np, "dst": dst_np, "sql": {}}
        xs10 = None  # the sql phase drops the knn10m rows
        engine_phase(sup, data, launches)
        # -- 4b'. SurrealQL over the engine phase's datastores, same runner
        sql_phase(sup, data["sql"], launches, keep_knn1m=True)
        # -- 4b (auth, server). knn1m's datastore behind the network
        # server: signed-in users, then the server's paths ------------------
        knn1m_d = data["sql"].pop("knn1m")
        auth_phase(sup, knn1m_d, launches, keep_server=True)
        ml_phase(sup, knn1m_d, launches, keep_server=True)
        api_phase(sup, knn1m_d, launches)
        server_phase(sup, knn1m_d, launches)
        del knn1m_d
        del data
        # -- 4b''. full-text + vector search through SurrealQL, same runner
        search_phase(sup, launches)
        # -- 4c. segmented ANN and the persisted artifacts, same runner ---
        segments_phase(sup, launches)
    finally:
        sup.shutdown()

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
    # -- 7. the two-level (dcn x data) mesh over knn1m's store, in process ----
    # (its card copies were dropped before knn10m: made again from the
    # host rows)
    full = torch.from_numpy(xs_np).to(dev)
    rank = (full / norms[:, None]).to(torch.bfloat16)
    hier_check(full, norms, rank, qs, single["knn1m_oracle"], launches)
    del full, rank
    torch.cuda.empty_cache()

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
