"""Shard-partitioned vector serving (the reference package's
`idx/shardvec.py`), trimmed to `merge_topk`: the exact k-way merge the
segment fan-out (`idx/segments.py`) answers through. The scatter-gather
router over a range-sharded store is not ported."""

from __future__ import annotations


def merge_topk(ctx, lists: list, k: int):
    """K-way merge of per-part ascending `(rid, dist)` lists into the
    global top-k. Exact parts make the merge exact: each list is that
    part's true top-k, the parts partition the rows, so the k smallest
    of the union ARE the global top-k. Ties keep list order (stable)."""
    import heapq

    ctx.check_deadline()
    out = []
    for item in heapq.merge(*lists, key=lambda pair: pair[1]):
        out.append(item)
        if len(out) >= k:
            break
    return out
