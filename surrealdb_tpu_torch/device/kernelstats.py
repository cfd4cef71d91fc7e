"""Kernel accounting for the device runner.

Two kinds of count:

- compile-shape hits/misses, as in the reference runner. Here a
  "compile" is the first build (or load) of the CUDA library in this
  process; a shape note is a dispatch against a (kernel, shape) pair,
  kept so the serving side's gauges read the same keys;
- launches: each CUDA kernel's wrapper adds one where it launches its
  kernel, and nowhere else (the plain PyTorch versions never count).
  A run reads them to show that its path really went through the
  kernels.

Lock-free on purpose: a lost increment under a thread race skews a
gauge by one sample.
"""

from __future__ import annotations

COUNTS = {"hits": 0, "misses": 0, "sharded": 0}
_SEEN: set = set()
# widest mesh any sharded dispatch ran on in this process
MESH_LAST = {"ndev": 0}
# store shapes change every sync epoch under write load, so the
# seen-set is bounded; overflow clears it
_SEEN_MAX = 4096

# distance_tile counts every launch, and each of its two routes
# (distance_tile_tf32: tensor cores; distance_tile_simt: CUDA cores) its
# own; gather_rescore every launch, and gather_rescore_topk those with
# the final top k fused in
KERNELS = ("distance_tile", "distance_tile_tf32", "distance_tile_simt",
           "distance_row_stats", "select_topk_rows", "rank_scores_bf16",
           "gather_rescore", "gather_rescore_topk", "csr_hop_step",
           "quantize_rows_int8",
           "rank_scores_int8", "rank_candidates_int8", "select_topk_pairs",
           "ann_descent", "merge_partials_topk", "mask_or_reduce")
LAUNCHES = {name: 0 for name in KERNELS}
# path events that are not launches: int8 store queries whose
# candidates overflowed their buffer and took the exact chunked path;
# bf16 store query chunks whose kc is past the fused rescore's limit
# (ops/topk.py RESCORE_TOPK_MAX_KC: the [C, kc] rescore, then a select)
EVENTS = {"int8_overflow_rows": 0, "rescore_select_route": 0}


def note_compile(kernel: str):
    COUNTS["misses"] += 1


def note_hit(kernel: str):
    COUNTS["hits"] += 1


def note_sharded(kernel: str, ndev: int):
    """Record a mesh dispatch (device/mesh.py stores) of width `ndev`;
    width-1 meshes don't count as sharded execution."""
    if ndev > 1:
        COUNTS["sharded"] += 1
        if ndev > MESH_LAST["ndev"]:
            MESH_LAST["ndev"] = ndev


def note_shape(kernel: str, shape_key) -> bool:
    """Record a dispatch against (kernel, shape_key); True when this
    shape was already seen in this process (a hit)."""
    key = (kernel, shape_key)
    if key in _SEEN:
        COUNTS["hits"] += 1
        return True
    if len(_SEEN) >= _SEEN_MAX:
        _SEEN.clear()
    _SEEN.add(key)
    COUNTS["misses"] += 1
    return False


def note_launch(kernel: str):
    LAUNCHES[kernel] += 1


def note_event(name: str, count: int = 1):
    EVENTS[name] += count


def launches() -> dict:
    return dict(LAUNCHES)


def events() -> dict:
    return dict(EVENTS)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in EVENTS:
        EVENTS[name] = 0


def snapshot() -> dict:
    out = dict(COUNTS)
    out["mesh_ndev"] = MESH_LAST["ndev"]
    return out
