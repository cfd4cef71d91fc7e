"""The search:: family of the reference's `fnc/misc_fns.py`: the
full-text score, highlight, offsets and analyze functions over
`idx/fulltext.py`, and the rrf and linear fusions of result lists. The
module's other families are not ported (`fnc/unported.py`), and the
registry takes these names at their place in the reference's order."""

from __future__ import annotations

from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _str, register


# -- search -------------------------------------------------------------------


@register("search::score")
def _search_score(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_score

    return search_score(int(args[0]) if args else 0, ctx)


@register("search::highlight")
def _search_highlight(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_highlight

    return search_highlight(args, ctx)


@register("search::offsets")
def _search_offsets(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_offsets

    return search_offsets(args, ctx)


@register("search::analyze")
def _search_analyze(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import analyze_text

    az = _str(args[0], "search::analyze", 1)
    return analyze_text(az, _str(args[1], "search::analyze", 2), ctx)


@register("search::rrf")
def _search_rrf(args, ctx):
    """Reciprocal-rank fusion of result-object arrays keyed on `id`
    (reference fnc search::rrf: merged fields + rrf_score)."""
    lists = args[0] if args else []
    limit = args[1] if len(args) > 1 else None
    k = args[2] if len(args) > 2 else 60
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "limit must be at least 1"
        )
    if not isinstance(k, (int, float)) or isinstance(k, bool) or k < 0:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "RRF constant must be at least 0"
        )
    from surrealdb_tpu_torch.val import hashable

    scores: dict = {}
    merged: dict = {}
    order: list = []
    for lst in lists or []:
        if not isinstance(lst, list):
            continue
        for rank, item in enumerate(lst):
            if not isinstance(item, dict):
                continue
            h = hashable(item.get("id", rank))
            if h not in merged:
                merged[h] = dict(item)
                order.append(h)
            else:
                merged[h].update(item)
            scores[h] = scores.get(h, 0.0) + 1.0 / (k + rank + 1)
    out = sorted(order, key=lambda h: -scores[h])[: int(limit)]
    res = []
    for h in out:
        row = merged[h]
        row["rrf_score"] = scores[h]
        res.append(row)
    return res


@register("search::linear")
def _search_linear(args, ctx):
    """Weighted linear fusion with per-list score normalization
    (reference fnc search::linear: minmax/zscore + linear_score)."""
    lists = args[0] if args else []
    weights = args[1] if len(args) > 1 else []
    limit = args[2] if len(args) > 2 else None
    norm = args[3] if len(args) > 3 else "minmax"
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Limit must be at least 1"
        )
    if norm not in ("minmax", "zscore"):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Norm must be 'minmax' or 'zscore'"
        )
    if not isinstance(lists, list) or not isinstance(weights, list) or \
            len(lists) != len(weights):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "The results and the weights array should have the same length"
        )
    for i, w in enumerate(weights):
        if isinstance(w, bool) or not isinstance(w, (int, float, Decimal)):
            raise SdbError(
                "Incorrect arguments for function search::linear(). "
                f"Weight at index {i} must be a number"
            )
    from surrealdb_tpu_torch.val import hashable

    # mirrors the reference's exact float op order (fnc/search.rs:380-537)
    # so normalized scores match bit-for-bit: per-doc raw score is
    # distance→1/(1+d) | ft_score | score | rank fallback 1/(1+count);
    # params per list, then weighted combination over score>0 entries
    n_lists = len(lists)
    documents: dict = {}  # h -> [scores_per_list, merged_obj]
    order: list = []
    count = 0
    for list_idx, lst in enumerate(lists):
        if not isinstance(lst, list):
            continue
        for item in lst:
            if not isinstance(item, dict) or "id" not in item:
                continue
            d = item.get("distance")
            fts = item.get("ft_score")
            sc = item.get("score")
            if isinstance(d, (int, float, Decimal)) and \
                    not isinstance(d, bool):
                score = 1.0 / (1.0 + float(d))
            elif isinstance(fts, (int, float, Decimal)) and \
                    not isinstance(fts, bool):
                score = float(fts)
            elif isinstance(sc, (int, float, Decimal)) and \
                    not isinstance(sc, bool):
                score = float(sc)
            else:
                score = 1.0 / (1.0 + count)
            h = hashable(item.get("id"))
            if h not in documents:
                documents[h] = [[0.0] * n_lists, dict(item)]
                order.append(h)
            else:
                documents[h][1].update(item)
            documents[h][0][list_idx] = score
            count += 1
    # per-list normalization params over scores > 0
    params = []
    for list_idx in range(n_lists):
        vals = [doc[0][list_idx] for doc in documents.values()
                if doc[0][list_idx] > 0.0]
        if not vals:
            params.append((0.0, 1.0))
            continue
        if norm == "minmax":
            lo = min(vals)
            rng = max(vals) - lo
            params.append((lo, rng if rng > 0.0 else 1.0))
        else:
            mean = sum(vals) / len(vals)
            var = sum((x - mean) ** 2 for x in vals) / len(vals)
            sd = var ** 0.5
            params.append((mean, sd if sd > 0.0 else 1.0))
    combined: dict = {}
    for h in order:
        scores_l, _obj = documents[h]
        total = 0.0
        for list_idx, score in enumerate(scores_l):
            if score > 0.0:
                w = weights[list_idx] if list_idx < len(weights) else 1.0
                a, b = params[list_idx]
                total += float(w) * ((score - a) / b)
        combined[h] = total
    out = sorted(order, key=lambda h: -combined[h])[: int(limit)]
    res = []
    for h in out:
        row = documents[h][1]
        row["linear_score"] = combined[h]
        res.append(row)
    return res
