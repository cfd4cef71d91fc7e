"""Environment-variable knobs the device runner and its supervisor
read: the KNN and DEVICE settings of the reference package's `cnf.py`,
with the same SURREAL_* names and defaults."""

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
