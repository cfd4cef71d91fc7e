"""Environment-variable knobs the index engines, the device runner, its
supervisor, the cross-query batcher, the live-query fan-out and the
network server read: the KNN, DEVICE, LIVE and HTTP settings of the
reference package's `cnf.py`, with the same SURREAL_* names and
defaults."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, "") or default


# -- KNN engine routing (idx/vector.py) ---------------------------------------
# stores below this many rows take the exact numpy host ladder
KNN_DEVICE_MIN_ROWS = env_int("SURREAL_KNN_DEVICE_MIN_ROWS", 2048)
# auto: dispatch to the runner unless its platform is the host's CPU
# (then the batched BLAS host path scores); device: always dispatch
# while the device serves; host: always score on the host
KNN_HOST_BATCH = env_str("SURREAL_KNN_HOST_BATCH", "auto")

# -- KNN kernel selection (shipped per store in the vec_load `cfg`) ----------
KNN_BLOCK_ROWS = env_int("SURREAL_KNN_BLOCK_ROWS", 262144)
# query rows per ranking step
KNN_QUERY_CHUNK = env_int("SURREAL_KNN_QUERY_CHUNK", 512)
# peak [chunk, N] f32 score-matrix elements per ranking step; large
# stores shrink the per-step query chunk to stay under this
KNN_SCORE_BUDGET_ELEMS = env_int("SURREAL_KNN_SCORE_BUDGET_ELEMS", 1 << 29)
# device byte budget for a bf16-rank + f32-full store (6 B/elem); above
# it the reference switches to an int8 ranking store
KNN_HBM_BUDGET_BYTES = env_int("SURREAL_KNN_HBM_BUDGET_BYTES", 12 << 30)
KNN_INT8_OVERSAMPLE = env_int("SURREAL_KNN_INT8_OVERSAMPLE", 128)

# -- quantized graph-ANN index (idx/cagra.py, device/annstore.py) ------------
# auto: stores at or above KNN_ANN_MIN_ROWS with a product metric build a
# graph in the background and route <|k|> searches through the int8
# descent + exact re-rank once it is ready; off: never; force: any store
# above a small floor
KNN_ANN_MODE = env_str("SURREAL_KNN_ANN", "auto")
KNN_ANN_MIN_ROWS = env_int("SURREAL_KNN_ANN_MIN_ROWS", 200_000)
# k above which a search keeps brute force
KNN_ANN_MAX_K = env_int("SURREAL_KNN_ANN_MAX_K", 64)
# appended + overwritten + deleted rows past this fraction of the store
# make the graph stale: a rebuild is scheduled (the rows it cannot see
# are brute-ranked and merged meanwhile)
KNN_ANN_TAIL_FRAC = env_float("SURREAL_KNN_ANN_TAIL_FRAC", 0.25)
# fixed out-degree of the search graph ([N, D_out] int32)
KNN_ANN_DEGREE = env_int("SURREAL_KNN_ANN_DEGREE", 32)
# greedy-descent frontier width; rounded up to a power of two by the
# serving side and never below the re-rank candidate count
KNN_ANN_SEARCH_WIDTH = env_int("SURREAL_KNN_ANN_SEARCH_WIDTH", 64)
# fixed descent iterations / nodes expanded per iteration
KNN_ANN_ITERS = env_int("SURREAL_KNN_ANN_ITERS", 24)
KNN_ANN_EXPAND = env_int("SURREAL_KNN_ANN_EXPAND", 2)
# exact re-rank oversampling: kc = max(OVERSAMPLE * k, 32) candidates
KNN_ANN_OVERSAMPLE = env_int("SURREAL_KNN_ANN_OVERSAMPLE", 4)
# routing probe (strided rows scored to seed the descent): a floor and
# a fraction of N, so the per-cluster miss rate stays flat as N grows
KNN_ANN_PROBE = env_int("SURREAL_KNN_ANN_PROBE", 4096)
KNN_ANN_PROBE_FRAC = env_float("SURREAL_KNN_ANN_PROBE_FRAC", 1 / 24)
# build knobs: RP-partition leaf size, trees merged, NN-descent refine
# rounds (-1 = auto: 1 round up to 200k rows, 0 above)
KNN_ANN_LEAF = env_int("SURREAL_KNN_ANN_LEAF", 512)
KNN_ANN_TREES = env_int("SURREAL_KNN_ANN_TREES", 2)
KNN_ANN_REFINE = env_int("SURREAL_KNN_ANN_REFINE", -1)
# int8 quantization clip quantile (1.0 = the exact per-row max)
KNN_ANN_CLIP_Q = env_float("SURREAL_KNN_ANN_CLIP_Q", 1.0)

# -- segmented ANN (idx/segments.py) -----------------------------------------
# sealed-segment serving for continuous ingest: writes land in an exact
# mutable tail, a seal policy freezes it into a segment, background jobs
# build each segment's own CAGRA graph and tier-merge small segments into
# larger ones, so the whole-store rebuild (KNN_ANN_TAIL_FRAC) never runs.
# auto: engage once the store crosses KNN_SEG_MIN_ROWS (smaller stores
# keep the whole-store graph); off: never; force: past 16 rows
KNN_SEG_MODE = env_str("SURREAL_KNN_SEG", "auto")
KNN_SEG_MIN_ROWS = env_int("SURREAL_KNN_SEG_MIN_ROWS", 400_000)
# seal policy for the mutable tail: row count, byte size, or age (0
# disables the age seal; it is checked at sync cadence, no timers)
KNN_SEG_ROWS = env_int("SURREAL_KNN_SEG_ROWS", 131_072)
KNN_SEG_BYTES = env_int("SURREAL_KNN_SEG_BYTES", 512 << 20)
KNN_SEG_AGE_S = env_float("SURREAL_KNN_SEG_AGE_S", 0.0)
# tiered merges: FANOUT adjacent segments of one size tier (tier t covers
# [SEG_ROWS * FANOUT^t, SEG_ROWS * FANOUT^(t+1)) rows) compact into one
KNN_SEG_FANOUT = env_int("SURREAL_KNN_SEG_FANOUT", 4)
# a segment's dead + overwritten fraction past which its own graph is
# rebuilt (its dead rows compacted out)
KNN_SEG_TOMB_FRAC = env_float("SURREAL_KNN_SEG_TOMB_FRAC", 0.5)

# -- the file-backed KV engine (kvs/file.py) -----------------------------------
# committed WAL batches between snapshot compactions
WAL_COMPACT_BATCHES = env_int("SURREAL_WAL_COMPACT_BATCHES", 4096)

# -- device runner and its supervisor ------------------------------------------
# off: host paths only. auto (default): supervised runner subprocess,
# degrade-and-recover. require: device failures surface as errors
# instead of degrading. inline: ops run in-process (debug/tests,
# forfeits fault isolation).
DEVICE_MODE = env_str("SURREAL_DEVICE", "auto")
# mesh execution (device/mesh.py): row-shard vec/ANN/CSR blocks across
# the runner's device list with a partial top-k per shard and an exact
# merge. auto (default): shard only when a store's single-device share
# busts the per-device byte budget. off: single-device stores. force:
# always shard across the full device list. An integer caps the mesh
# width. Read per call (the environment first), as the reference does.
DEVICE_MESH = env_str("SURREAL_DEVICE_MESH", "auto")
# runner store budget across the vec/csr block caches + multipart
# staging, per device; 0 = the per-kind LRU entry caps only
DEVICE_MEM_BUDGET_MB = env_int("SURREAL_DEVICE_MEM_BUDGET_MB", 0)
# runner init (torch + CUDA + kernel build) watchdog
BACKEND_INIT_TIMEOUT_S = env_float("SURREAL_BACKEND_INIT_TIMEOUT_S", 240.0)
DEVICE_DISPATCH_TIMEOUT_S = env_float("SURREAL_DEVICE_DISPATCH_TIMEOUT_S",
                                      10.0)
DEVICE_LOAD_TIMEOUT_S = env_float("SURREAL_DEVICE_LOAD_TIMEOUT_S", 120.0)
# degraded-state background re-probe cadence + promotion hysteresis
# (consecutive healthy probes required before traffic returns)
DEVICE_PROBE_INTERVAL_S = env_float("SURREAL_DEVICE_PROBE_INTERVAL_S", 5.0)
DEVICE_PROMOTE_SUCCESSES = env_int("SURREAL_DEVICE_PROMOTE_SUCCESSES", 2)
# query-bucket ladder warmed right after a vector or ANN store ships,
# and the hop depths after a CSR graph ships ("" disables)
DEVICE_PREWARM_BUCKETS = env_str("SURREAL_DEVICE_PREWARM_BUCKETS",
                                 "1,8,64")
DEVICE_PREWARM_HOPS = env_str("SURREAL_DEVICE_PREWARM_HOPS", "1,2,3")
# cross-query batcher dispatch pipelining (device/batcher.py): up to
# PIPELINE dispatches in flight at once; the overlapped one launches
# only once PIPELINE_MIN riders are queued, so light traffic keeps the
# strict one-batch-at-a-time coalescing
DEVICE_BATCH_PIPELINE = env_int("SURREAL_DEVICE_BATCH_PIPELINE", 2)
DEVICE_BATCH_PIPELINE_MIN = env_int("SURREAL_DEVICE_BATCH_PIPELINE_MIN",
                                    32)


def device_cfg() -> dict:
    """The per-store kernel budgets a serving process ships with a
    vec_load (the reference's `TpuVectorIndex._device_cfg`)."""
    return {
        "hbm_budget": KNN_HBM_BUDGET_BYTES,
        "score_budget": KNN_SCORE_BUDGET_ELEMS,
        "query_chunk": KNN_QUERY_CHUNK,
        "int8_oversample": KNN_INT8_OVERSAMPLE,
        "block_rows": KNN_BLOCK_ROWS,
    }


def ann_search_cfg() -> dict:
    """The descent knobs a serving process ships with an ann_load (the
    reference's `TpuVectorIndex._ann_search_cfg`): the width rounded up
    to a power of two."""
    width = 1
    while width < max(KNN_ANN_SEARCH_WIDTH, 1):
        width *= 2
    return {
        "width": width,
        "iters": max(KNN_ANN_ITERS, 1),
        "expand": max(KNN_ANN_EXPAND, 1),
    }


# ---------------------------------------------------------------------------
# The SurrealQL stack (syn/, exec/, fnc/, idx/planner.py, kvs/ds.py)
# ---------------------------------------------------------------------------

# Fixed at the reference's defaults (nothing in the port sets another
# value, so none of them is read from the environment):
# expression/function recursion ceiling
MAX_COMPUTATION_DEPTH = 120
# decoded-value cache over stored bytes (kvs/api.py deserialize)
DECODE_CACHE_BYTES = 256 << 20
# parsed-statement cache entries per datastore (kvs/ds.py execute)
AST_CACHE_SIZE = 512
# rows buffered per streaming operator batch (exec/stream.py)
OPERATOR_BUFFER_SIZE = 1024
MAX_STATEMENTS_PER_QUERY = 5000
# generated-collection byte cap (2^20 bytes)
GENERATION_ALLOCATION_LIMIT = 2 ** 20
# similarity/distance function input cap
FUNCTION_SIMILARITY_MAX_LENGTH = 100_000
# catalog entries cached per transaction (kvs/api.py)
TRANSACTION_CACHE_SIZE = 10_000
# columnar SELECT executor: auto | off | force (exec/vops.py)
COLUMNAR = env_str("SURREAL_COLUMNAR", "auto")
# full-text result cache bounds (idx/fulltext.py FtResult entries):
# entry count + estimated bytes, LRU-evicted (ft_cache_evictions)
FT_CACHE_ENTRIES = 512
FT_CACHE_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# The network server (server/, rpc.py) and its admission control
# (server/admission.py, inflight.py)
# ---------------------------------------------------------------------------

# concurrent queries executing at once (the worker-slot budget); the CLI
# --max-inflight flag overrides. 0 disables admission control entirely.
HTTP_MAX_INFLIGHT = env_int("SURREAL_HTTP_MAX_INFLIGHT", 64)
# requests allowed to WAIT for a slot; one past this sheds with a 503
HTTP_QUEUE_DEPTH = env_int("SURREAL_HTTP_QUEUE_DEPTH", 128)
# server-side default query timeout seeding the query's deadline when the
# client sends no X-Surreal-Timeout / rpc timeout field (0 = unbounded)
HTTP_DEFAULT_TIMEOUT_S = env_float("SURREAL_HTTP_DEFAULT_TIMEOUT_S", 0.0)
# SIGTERM drain budget: stop admitting, let in-flight work finish this
# long, then cancel whatever remains and exit
DRAIN_TIMEOUT_S = env_float("SURREAL_DRAIN_TIMEOUT_S", 10.0)
# WebSocket message / HTTP body caps (fixed at the reference's
# defaults, as the live settings below, apart from the overflow policy)
WEBSOCKET_MAX_MESSAGE_SIZE = 128 << 20
HTTP_MAX_BODY_SIZE = 128 << 20


# -- live-query fan-out (server/fanout.py) -----------------------------------
# Fixed at the reference's defaults (nothing in the port sets another
# value), apart from the overflow policy, which is read from
# SURREAL_LIVE_OVERFLOW.
# per-session bounded outbound notification queue: the writer thread
# drains it toward the client socket; a full queue triggers the
# overflow policy instead of ever blocking a committing writer
LIVE_QUEUE_DEPTH = 256
# what happens to a slow consumer whose queue overflows:
#   notify     — drop the queued backlog, count it, and push one typed
#                OVERFLOW notification per bound live id (the client
#                knows it lost a window and can re-read)
#   disconnect — force-close the laggard's connection (the client's
#                reconnect logic owns recovery)
LIVE_OVERFLOW_POLICY = env_str("SURREAL_LIVE_OVERFLOW", "notify")
# post-commit dispatch workers doing live-query matching (condition +
# projection evaluation). Events are sharded by (ns,db,tb) so one
# subscription always observes its table's commits in order.
LIVE_DISPATCH_WORKERS = 2
# commit batches a dispatch worker may have queued before the hub
# declares push overload: the backlog is dropped and every subscription
# on the affected tables gets a typed OVERFLOW notification
LIVE_DISPATCH_BACKLOG = 4096
# notifications coalesced into one socket write by a session's writer
# thread (burst batching: N frames, one sendall)
LIVE_DELIVERY_BATCH = 64
# dead-session sweep cadence (rides the kvs/net.py Runtime seam): GC
# live queries whose session died without KILL
LIVE_SWEEP_INTERVAL_S = 30.0
# embedded in-process notification buffer cap (Datastore.notifications,
# drained by drain_notifications()); drops are counted, the first warns
NOTIFY_BUFFER_CAP = 10_000
