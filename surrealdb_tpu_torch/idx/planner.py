"""Index access-path selection (reference: idx/planner/{mod,tree,plan}.rs +
exec/index/access_path.rs).

`plan_scan` inspects the WHERE tree for: a KNN operator (vector index /
brute-force top-k), a MATCHES operator (full-text), or indexable predicates
(= / IN / range on indexed columns). Returns a Source generator or None for
a full table scan. Distances are published through ctx.knn (the KnnContext,
exec/function/index.rs:289) for `vector::distance::knn()` projections.
"""

from __future__ import annotations

import numpy as np

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.expr.ast import (
    Binary,
    Idiom,
    Knn,
    Literal,
    Param,
    PField,
    RangeExpr,
)
from surrealdb_tpu_torch.val import NONE, Range, RecordId, hashable, value_cmp, \
    value_eq

from surrealdb_tpu_torch.err import NotPorted, SdbError


def _field_path(expr):
    from surrealdb_tpu_torch.expr.ast import PAll, PFlatten, PIndex, PMethod

    def _ok(p):
        if isinstance(p, (PAll, PFlatten)):
            return True
        if isinstance(p, PField):
            return True
        # argument-free method parts (id.id().r) are deterministic
        # per-document, so they name stable index column paths
        if isinstance(p, PMethod) and not p.args:
            return True
        # literal integer index parts (id[1]) are stable column paths
        return isinstance(p, PIndex) and isinstance(p.expr, Literal) \
            and isinstance(p.expr.value, int)

    if isinstance(expr, Idiom) and expr.parts and all(
        _ok(p) for p in expr.parts
    ) and isinstance(expr.parts[0], PField):
        from surrealdb_tpu_torch.exec.statements import expr_name

        return expr_name(expr)
    return None


def _split_ands(cond, out):
    if isinstance(cond, Binary) and cond.op == "&&":
        _split_ands(cond.lhs, out)
        _split_ands(cond.rhs, out)
    else:
        out.append(cond)


def _find_knn(cond):
    if isinstance(cond, Knn):
        return cond
    if isinstance(cond, Binary) and cond.op == "&&":
        return _find_knn(cond.lhs) or _find_knn(cond.rhs)
    return None


def _find_matches(cond):
    """All Matches nodes in the AND-tree."""
    from surrealdb_tpu_torch.expr.ast import Matches

    out = []

    def rec(c):
        if isinstance(c, Matches):
            out.append(c)
        elif isinstance(c, Binary) and c.op == "&&":
            rec(c.lhs)
            rec(c.rhs)

    rec(cond)
    return out


def _split_ors(cond, out):
    if isinstance(cond, Binary) and cond.op == "||":
        _split_ors(cond.lhs, out)
        _split_ors(cond.rhs, out)
    else:
        out.append(cond)


def _ft_index_for(d, indexes):
    path = _field_path(d.lhs)
    return next(
        (x for x in indexes
         if x.fulltext is not None and x.cols_str
         and (path is None or x.cols_str[0] == path)),
        None,
    )


def or_union_branches(tb, cond, indexes, ctx, value_idioms=True):
    """Streaming multi-index OR (reference UnionIndexScan): when the WHERE
    tree is a top-level OR and EVERY disjunct is servable by ONE index
    access (eq/IN/range on an indexed column, or a full-text MATCHES),
    return per-branch descriptors in cond order; else None — e.g. when
    WITH INDEX excludes a branch's index, the whole query falls back to
    a table scan."""
    from surrealdb_tpu_torch.expr.ast import Matches

    if not (isinstance(cond, Binary) and cond.op == "||"):
        return None
    disj = []
    _split_ors(cond, disj)
    if len(disj) < 2:
        return None
    array_paths = _array_like_paths(tb, ctx)
    branches = []
    for d in disj:
        if isinstance(d, Matches):
            idef = _ft_index_for(d, indexes)
            if idef is None:
                return None
            branches.append({"kind": "ft", "idef": idef, "mt": d})
            continue
        eqs, ins, rngs = _classify_preds(d, array_paths, value_idioms)
        chosen = _choose_index(indexes, eqs, ins, rngs) if (
            eqs or ins or rngs
        ) else None
        # a MATCHES inside the disjunct's AND tree is also a candidate
        # access (scored 800, losing only to unique full-equality)
        mts_d = _find_matches(d)
        ft_idef = _ft_index_for(mts_d[0], indexes) if mts_d else None
        if ft_idef is not None and (chosen is None or chosen[3] <= 800):
            branches.append({"kind": "ft", "idef": ft_idef, "mt": mts_d[0]})
            continue
        if chosen is None:
            return None
        idef, nmatch, tail, _score = chosen
        if tail is not None and tail[0] == "range" and nmatch == 0:
            branches.append({"kind": "range", "idef": idef, "tail": tail})
        elif tail is not None and tail[0] == "in" and nmatch == 0:
            branches.append({"kind": "in", "idef": idef, "tail": tail})
        else:
            branches.append({
                "kind": "idx", "idef": idef, "nmatch": nmatch,
                "tail": tail, "eqs": eqs,
            })
    return branches


def multi_index_leaves(tb, cond, indexes, ctx, value_idioms=True):
    """Legacy multi-index analysis (reference tree.rs leaf walk +
    Plan::MultiIndex, plan.rs:164-177): when the WHERE tree contains at
    least one OR and EVERY leaf predicate is servable by an index access,
    return one branch per leaf — non-range leaves first (DFS cond order),
    then range leaves grouped by index (plan.rs renders
    `non_range_indexes` then `ranges`); else None."""
    from surrealdb_tpu_torch.expr.ast import Matches

    leaves = []
    saw_or = [False]

    def walk(node):
        if isinstance(node, Binary) and node.op in ("&&", "||"):
            if node.op == "||":
                saw_or[0] = True
            return walk(node.lhs) and walk(node.rhs)
        leaves.append(node)
        return True

    if not walk(cond) or not saw_or[0] or len(leaves) < 2:
        return None
    array_paths = _array_like_paths(tb, ctx)
    non_range = []
    ranges = []
    for leaf in leaves:
        if isinstance(leaf, Matches):
            idef = _ft_index_for(leaf, indexes)
            if idef is None:
                return None
            non_range.append({"kind": "ft", "idef": idef, "mt": leaf})
            continue
        eqs, ins, rngs = _classify_preds(leaf, array_paths, value_idioms)
        if len(eqs) + len(ins) + len(rngs) != 1:
            return None
        chosen = _choose_index(indexes, eqs, ins, rngs)
        if chosen is None:
            return None
        idef, nmatch, tail, _score = chosen
        if tail is not None and tail[0] == "range" and nmatch == 0:
            ranges.append({"kind": "range", "idef": idef, "tail": tail})
        elif tail is not None and tail[0] == "in" and nmatch == 0:
            non_range.append({"kind": "in", "idef": idef, "tail": tail})
        elif nmatch and tail is None:
            non_range.append({
                "kind": "idx", "idef": idef, "nmatch": nmatch,
                "tail": None, "eqs": eqs,
            })
        else:
            return None
    # ranges grouped by index in first-seen order, leaf order within
    seen_ix = []
    for br in ranges:
        if br["idef"].name not in seen_ix:
            seen_ix.append(br["idef"].name)
    ranges.sort(key=lambda br: seen_ix.index(br["idef"].name))
    return non_range + ranges


def union_branch_scan(tb, br, ctx):
    """Execute ONE multi-index union branch — the single dispatch point
    shared by _union_scan and the streaming explain's row counting, so
    explain output can't drift from what actually runs."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    if br["kind"] in ("range", "in"):
        return _index_scan(tb, br["idef"], [], br["tail"], ctx)
    idef = br["idef"]
    eq_vals = [
        evaluate(br["eqs"][c], ctx) for c in idef.cols_str[:br["nmatch"]]
    ]
    return _index_scan(tb, idef, eq_vals, br["tail"], ctx)


def _union_scan(tb, branches, ctx):
    """Concatenate per-branch index scans, deduping by record id. The
    SELECT loop re-applies the full OR cond (cond NOT consumed), so each
    branch may safely over-approximate its disjunct."""

    def gen():
        seen = set()
        for br in branches:
            for src in union_branch_scan(tb, br, ctx):
                h = hashable(src.rid) if src.rid is not None else None
                if h is not None and h in seen:
                    continue
                if h is not None:
                    seen.add(h)
                yield src

    return gen()


def _remove_node(cond, node):
    """Drop `node` from an AND-tree; returns remaining cond or None."""
    if cond is node:
        return None
    if isinstance(cond, Binary) and cond.op == "&&":
        l = _remove_node(cond.lhs, node)
        r = _remove_node(cond.rhs, node)
        if l is None:
            return r
        if r is None:
            return l
        return Binary("&&", l, r)
    return cond


def get_indexes_for(tb, ctx):
    """Read-path index enumeration: PREPARE REMOVE decommissioned indexes
    are invisible to the planner (writes still maintain them — the write
    side scans the catalog directly, exec/document.py)."""
    ns, db = ctx.need_ns_db()
    return [
        d for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ix_prefix(ns, db, tb)))
        if not getattr(d, "prepare_remove", False)
    ]



def _array_like_paths(tb, ctx) -> set:
    """Field paths declared array/set (their index entries are unnested, so
    CONTAINS-family predicates can ride the index)."""
    from surrealdb_tpu_torch.exec.document import get_fields

    out = set()
    try:
        for fd in get_fields(tb, ctx):
            if fd.kind is not None and fd.kind.name in ("array", "set"):
                out.add(fd.name_str)
    except Exception:
        pass
    try:
        for idef in get_indexes_for(tb, ctx):
            for col in idef.cols_str:
                if col.endswith("[*]"):
                    out.add(col[:-3])
                elif col.endswith(".*"):
                    out.add(col[:-2])
    except Exception:
        pass
    return out


def _find_link_join(tb, cond, indexes, ctx):
    """Record-link index join (reference idx/planner/tree.rs remote-index
    resolution; plan.rs renders `operator: 'join'` with a `joins` list):
    a predicate `link.rest OP v` where the local table has a single-column
    plain index on `link`, the field is a typed `record<rt>` link, and
    `rt` serves `rest OP v` from one of its own indexes. Returns
    {lidef, ridef, rt, op, vexpr, mt} or None."""
    from surrealdb_tpu_torch.exec.document import get_fields
    from surrealdb_tpu_torch.expr.ast import Matches

    preds = []
    _split_ands(cond, preds)
    for pred in preds:
        mt = None
        if isinstance(pred, Matches):
            lp = _field_path(pred.lhs)
            op, vexpr, mt = "matches", pred.rhs, pred
        elif isinstance(pred, Binary) and pred.op in ("=", "==", "∈"):
            lp = _field_path(pred.lhs)
            if lp is None or _field_path(pred.rhs) is not None:
                continue
            op = "in" if pred.op == "∈" else "="
            vexpr = pred.rhs
        else:
            continue
        if lp is None or "." not in lp or ".*" in lp or "…" in lp:
            continue
        first, _, rest = lp.partition(".")
        lidef = next(
            (i for i in indexes
             if list(i.cols_str) == [first] and i.hnsw is None
             and i.fulltext is None and not i.count),
            None,
        )
        if lidef is None:
            continue
        try:
            fd = next(
                (f for f in get_fields(tb, ctx) if f.name_str == first), None
            )
        except SdbError:
            continue
        kind = getattr(fd, "kind", None)
        if kind is None or kind.name != "record" or \
                len(kind.inner or []) != 1:
            continue
        rt = kind.inner[0]
        rindexes = get_indexes_for(rt, ctx)
        if op == "matches":
            ridef = next(
                (x for x in rindexes
                 if x.fulltext is not None and x.cols_str
                 and x.cols_str[0] == rest),
                None,
            )
        else:
            ridef = next(
                (x for x in rindexes
                 if list(x.cols_str) == [rest] and x.hnsw is None
                 and x.fulltext is None and not x.count),
                None,
            )
        if ridef is None:
            continue
        return {"lidef": lidef, "ridef": ridef, "rt": rt, "op": op,
                "vexpr": vexpr, "mt": mt}
    return None


def _link_join_scan(tb, jn, ctx):
    """Execute a link join: remote index access -> remote record ids ->
    local equality scans on the link index. The WHERE clause re-applies
    row-wise afterwards (cond is NOT consumed)."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    def gen():
        rt, ridef = jn["rt"], jn["ridef"]
        if jn["op"] == "in":
            vals = evaluate(jn["vexpr"], ctx)
            vals = vals if isinstance(vals, list) else [vals]
            remote_ids = [
                s.rid
                for v in vals
                for s in _index_scan(rt, ridef, [v], None, ctx)
            ]
        else:
            remote_ids = [
                s.rid
                for s in _index_scan(
                    rt, ridef, [evaluate(jn["vexpr"], ctx)], None, ctx
                )
            ]
        seen = set()
        for rid in remote_ids:
            h = hashable(rid)
            if h in seen:
                continue
            seen.add(h)
            yield from _index_scan(tb, jn["lidef"], [rid], None, ctx)

    return gen()


def _is_array_value(e) -> bool:
    """Plan-time is_array() check (reference tree.rs requires a computed
    array before a union access applies)."""
    from surrealdb_tpu_torch.expr.ast import ArrayExpr, Literal

    if isinstance(e, ArrayExpr):
        return True
    return isinstance(e, Literal) and isinstance(e.value, list)


def _classify_preds(cond, array_paths=frozenset(), value_idioms=True):
    """WHERE-tree analysis shared by plan_scan and explain_plan: returns
    (eqs, ins, rngs) keyed by field path. value_idioms=False (streaming
    executor) rejects idiom-valued rhs like $obj.name entirely."""
    preds = []
    _split_ands(cond, preds)
    eqs: dict = {}
    ins: dict = {}
    rngs: dict = {}
    for pred in preds:
        if not isinstance(pred, Binary):
            continue
        if pred.op not in ("=", "==", "∈", "<", "<=", ">", ">=", "∋", "⊇",
                           "containsany", "anyinside", "allinside"):
            continue
        lp = _field_path(pred.lhs)
        rp = _field_path(pred.rhs)
        path = op = valexpr = None
        contain_alias = False
        if lp is not None and rp is None:
            op = pred.op
            if op == "∋":
                # CONTAINS only matches index entries when the column is
                # array-shaped (unnested entries — via a .*/… path, a
                # declared array/set field, or an explicit `col[*]` index
                # column); string fields use substring semantics and
                # can't ride the index
                if not _array_shaped(lp, array_paths):
                    continue
                op = "="  # per-element entries, equality lookup
                contain_alias = True
            elif op in ("⊇", "containsany"):
                # CONTAINSANY/CONTAINSALL [..] become a union of
                # per-element equality scans. Legacy tree planner: any
                # array value qualifies (tree.rs:651-664). Streaming
                # analyzer: only a `.*`-shaped column (Part::All) matches
                # (analysis.rs idiom_matches_containment).
                if not _is_array_value(pred.rhs):
                    continue
                if not value_idioms and not (".*" in lp or "…" in lp):
                    continue
                op = "in"
            elif op in ("anyinside", "allinside"):
                continue  # value op field handled in the rhs-path case
            elif op == "∈":
                op = "in"
            path, valexpr = lp, pred.rhs
            # idiom-valued rhs: allowed only when it starts from a value
            # (e.g. $obj.name) and the caller permits them (the legacy
            # planner computes them; the streaming executor does not)
            from surrealdb_tpu_torch.expr.ast import Idiom as _Idiom

            if isinstance(valexpr, _Idiom):
                if not value_idioms or not _doc_free_idiom(valexpr):
                    continue
        elif rp is not None and lp is None:
            if pred.op == "∈":
                if not _array_shaped(rp, array_paths):
                    continue
                path, op, valexpr = rp, "=", pred.lhs
                contain_alias = True
            elif pred.op in ("anyinside", "allinside"):
                # [..] ANYINSIDE/ALLINSIDE field -> union access
                # (reference tree.rs AnyInside|AllInside, IdiomPosition::Right;
                # same per-planner gates as ContainAny)
                if not _is_array_value(pred.lhs):
                    continue
                if not value_idioms and not (".*" in rp or "…" in rp):
                    continue
                path, op, valexpr = rp, "in", pred.lhs
            elif pred.op in ("⊇", "containsany", "∋"):
                continue  # field op value handled in the lhs-path case
            else:
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                path, op, valexpr = rp, flip.get(pred.op, pred.op), pred.lhs
            from surrealdb_tpu_torch.expr.ast import Idiom as _Idiom

            if isinstance(valexpr, _Idiom):
                if not value_idioms or not _doc_free_idiom(valexpr):
                    continue
        if path is None or path == "id":
            continue
        if not value_idioms and (".*" in path or "…" in path) and \
                pred.op in ("=", "==", "<", "<=", ">", ">="):
            # the streaming analyzer's plain equality/range access needs a
            # plain column idiom; Part::All columns serve only the
            # CONTAINS/INSIDE per-element accesses
            # (create_with_std_index_with_flattened_field)
            continue
        if op in ("=", "=="):
            eqs.setdefault(path, valexpr)
            if contain_alias:
                # `DEFINE INDEX ... FIELDS col[*]` / `col.*` columns hold
                # the unnested entries a containment access scans
                eqs.setdefault(path + "[*]", valexpr)
                eqs.setdefault(path + ".*", valexpr)
        elif op == "in":
            ins.setdefault(path, valexpr)
        else:
            rngs.setdefault(path, []).append((op, valexpr))
    return eqs, ins, rngs


def _doc_free_idiom(expr) -> bool:
    """True when an idiom starts from a self-contained value (a param or
    literal), so it can be computed once without a document."""
    from surrealdb_tpu_torch.expr.ast import ArrayExpr, ObjectExpr

    p0 = expr.parts[0] if expr.parts else None
    if not (isinstance(p0, tuple) and len(p0) == 2 and p0[0] == "start"):
        return False
    return isinstance(p0[1], (Param, Literal, ObjectExpr, ArrayExpr))


def _array_shaped(path: str, array_paths) -> bool:
    return ".*" in path or "…" in path or path in array_paths


def _choose_index(indexes, eqs, ins, rngs, model="streaming"):
    """Pick the best access path over the candidate indexes; returns
    (idef, nmatch, tail) or None.

    `model="streaming"` mirrors the reference's streaming planner
    (exec/index/analysis.rs IndexCandidate::score): single-column
    equality scores 1000 unique / 500 non-unique; a compound prefix
    scores 400 + 50·prefix (+25 with a narrowing range); a pure range
    scores 300 bounded / 200 half-bounded. Ties prefer the narrower
    index (the reference appends single-column candidates after compound
    ones and max_by_key keeps the last maximum), then the LATER-defined
    index (max_by_key keeps the last of equal maxima).

    `model="legacy"` mirrors the legacy tree planner (idx/planner/tree.rs):
    the longest run of leading eq columns wins, an IN/range tail counts
    extra, first-defined index wins ties."""
    best = None
    for pos, idef in enumerate(indexes):
        if idef.hnsw is not None or idef.fulltext is not None or idef.count:
            continue
        cols = idef.cols_str
        if not cols:
            continue
        nmatch = 0
        tail = None  # ('range', [(op, vx)]) | ('in', vx)
        for i, col in enumerate(cols):
            if col in eqs:
                nmatch += 1
                continue
            if i == nmatch and col in rngs:
                tail = ("range", rngs[col])
            elif i == nmatch and col in ins:
                tail = ("in", ins[col])
            break
        if nmatch == 0 and tail is None:
            continue
        if model == "legacy":
            key = (nmatch * 2 + (1 if tail else 0), 0, -pos)
        elif nmatch == len(cols) and tail is None and len(cols) == 1:
            key = (1000 if idef.unique else 500, -1, pos)
        elif tail is not None and tail[0] == "in" and nmatch == 0:
            from surrealdb_tpu_torch.expr.ast import ArrayExpr as _AE

            if isinstance(tail[1], _AE) and len(tail[1].items) == 1:
                # `x IN [v]` collapses to an equality access and scores
                # like one (the streaming planner's single-value
                # rewrite) — beats a range candidate on another column
                key = (1000 if idef.unique else 500, -len(cols), pos)
            else:
                # IN-expansion union is a FALLBACK path in the streaming
                # planner (analysis.rs try_in_expansion): it only applies
                # when no eq/range candidate exists, and prefers the
                # narrowest index whose FIRST column is the IN column
                key = (10, -len(cols), pos)
        elif nmatch:
            # compound access: prefix of equalities, optionally narrowed
            # by a range on the next column (IN tails are NOT pushed by
            # the streaming executor — prefix-only access)
            score = 400 + 50 * nmatch + (
                25 if tail is not None and tail[0] == "range" else 0
            )
            key = (score, -len(cols), pos)
        else:
            ops = {op for op, _vx in tail[1]}
            lower = any(o in (">", ">=") for o in ops)
            upper = any(o in ("<", "<=") for o in ops)
            key = (300 if (lower and upper) else 200, -len(cols), pos)
        if best is None or key > best[0]:
            best = (key, idef, nmatch, tail)
    if best is None:
        return None
    return best[1], best[2], best[3], best[0][0]


def plan_scan(tb: str, cond, ctx, stmt):
    """Return a Source generator when an index path applies, else None
    (table scan). A full-text MATCHES in the cond raises `NotPorted`."""
    import time as _time

    from surrealdb_tpu_torch.telemetry import stage_record

    t0 = _time.perf_counter_ns()
    if cond is not None and _find_matches(cond):
        raise NotPorted("the full-text match operator @@ is not ported")
    try:
        return _plan_scan(tb, cond, ctx, stmt)
    finally:
        # note: a KNN plan executes its index search eagerly in here,
        # so `plan` CONTAINS `index_knn` — the profile tool subtracts
        stage_record("plan", _time.perf_counter_ns() - t0)


def _plan_scan(tb: str, cond, ctx, stmt):
    if cond is None:
        return None
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.statements import Source, _resolve_type_fields

    # plan-time rewrite: `type::field($param)` with a statically-known
    # argument becomes the named column idiom, so parameterized
    # (schemaless OData-style) predicates match index access paths; the
    # rewrite is semantics-preserving, so downstream residual filters
    # may evaluate either tree
    cond = _resolve_type_fields(cond, ctx)

    with_index = getattr(stmt, "with_index", None) if stmt is not None else None
    if with_index == []:  # WITH NOINDEX: no index access paths...
        indexes = []
    else:
        indexes = get_indexes_for(tb, ctx)
        if with_index:
            indexes = [i for i in indexes if i.name in with_index]

    # ---- KNN --------------------------------------------------------------
    # ...but brute-force KNN is a scan operator (KnnTopK), not an index, so
    # it still applies under WITH NOINDEX (reference: exec/operators/knn_topk.rs)
    knn = _find_knn(cond)
    if knn is not None:
        return _plan_knn(tb, cond, knn, indexes, ctx, stmt)
    if with_index == []:
        return None

    # ---- multi-index OR (Plan::MultiIndex / UnionIndexScan) ---------------
    # the access shape must match the engine being run: the streaming
    # planner unions ONE access per top-level disjunct, the legacy tree
    # planner unions EVERY indexable leaf (plan.rs Plan::MultiIndex)
    if getattr(ctx.session, "planner_strategy", None) == "all-ro":
        union = or_union_branches(tb, cond, indexes, ctx, value_idioms=False)
    else:
        union = multi_index_leaves(tb, cond, indexes, ctx)
        if union is None:
            # OR-with-AND-tails: not a leaf union, but one access per
            # disjunct still beats a table scan — branches safely
            # over-approximate (the full cond filters above the union)
            union = or_union_branches(tb, cond, indexes, ctx)
    if union is not None:
        return _union_scan(tb, union, ctx)

    # ---- equality / range / contains on indexed columns --------------------
    array_paths = _array_like_paths(tb, ctx)
    eqs, ins, rngs = _classify_preds(cond, array_paths)
    legacy = getattr(ctx.session, "planner_strategy", None) != "all-ro"
    if not eqs and not rngs and not ins:
        jn = _find_link_join(tb, cond, indexes, ctx) if legacy else None
        return _link_join_scan(tb, jn, ctx) if jn is not None else None
    chosen = _choose_index(indexes, eqs, ins, rngs)
    if chosen is None:
        jn = _find_link_join(tb, cond, indexes, ctx) if legacy else None
        return _link_join_scan(tb, jn, ctx) if jn is not None else None
    idef, nmatch, tail, _score = chosen
    eq_vals = [evaluate(eqs[c], ctx) for c in idef.cols_str[:nmatch]]
    prefilter = _index_prefilter(idef, nmatch, tail, eqs, ins, rngs, ctx,
                                 array_paths)
    scan = _index_scan(tb, idef, eq_vals, tail, ctx, prefilter=prefilter)
    order = getattr(stmt, "order", None) if stmt is not None else None
    if order and order != "rand" and len(order) == 1 and \
            order[0][1] == "desc":
        from surrealdb_tpu_torch.exec.statements import expr_name

        if expr_name(order[0][0]) == idef.cols_str[0]:
            # ORDER BY <first index column> DESC rides the reverse index
            # iterator: emit in reverse key order so equal-key rows keep
            # reverse-scan relative order (the later stable sort preserves
            # it; reference ReverseOrder / backward range iterators)
            def rev(inner=scan):
                yield from reversed(list(inner))

            return rev()
    return scan


def _index_prefilter(idef, nmatch, tail, eqs, ins, rngs, ctx,
                     array_paths=frozenset()):
    """Sargable residual predicates on the index's OWN columns, compiled
    to (col_pos, test(decoded_value)) pairs — evaluated on the decoded
    index-key fields BEFORE the record fetch/deserialization, so rows
    the WHERE clause would drop anyway never pay the document decode.
    Purely an access-path optimization: the residual cond still
    re-applies row-wise above the scan (never consumed), so this may
    only skip rows the index key itself proves non-matching."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    tail_col = idef.cols_str[nmatch] if (
        tail is not None and nmatch < len(idef.cols_str)
    ) else None
    tests = []
    for pos, col in enumerate(idef.cols_str):
        if pos < nmatch or "*" in col or \
                _array_shaped(col, array_paths):
            # consumed by the eq prefix, or an array/set column whose
            # index entries are UNNESTED per-element values — a whole-
            # array predicate must never test against single elements
            continue
        preds = []
        if col in eqs and col != tail_col:
            v = evaluate(eqs[col], ctx)
            preds.append(lambda f, v=v: value_eq(f, v))
        if col in rngs:
            bounds = rngs[col]
            if col == tail_col and tail is not None and tail[0] == "range":
                # composite scans push exactly ONE bound into the key
                # range (_index_scan bounds=payload[:1]); the rest of
                # the same column's bounds prefilter here
                pushed = tail[1][:1] if nmatch else tail[1]
                bounds = [b for b in bounds if b not in pushed]
            for op, vx in bounds:
                v = evaluate(vx, ctx)
                if op == "<":
                    preds.append(lambda f, v=v: value_cmp(f, v) < 0)
                elif op == "<=":
                    preds.append(lambda f, v=v: value_cmp(f, v) <= 0)
                elif op == ">":
                    preds.append(lambda f, v=v: value_cmp(f, v) > 0)
                elif op == ">=":
                    preds.append(lambda f, v=v: value_cmp(f, v) >= 0)
        if col in ins and col != tail_col:
            vals = evaluate(ins[col], ctx)
            vals = vals if isinstance(vals, list) else [vals]
            preds.append(
                lambda f, vals=vals: any(value_eq(f, x) for x in vals)
            )
        for p in preds:
            tests.append((pos, p))
    return tests or None


def _dec_unique_fields(k: bytes, base: bytes, ncols: int):
    """Decode the field values of a unique-index entry key (fields only,
    no trailing rid); None on any decode wrinkle."""
    try:
        pos = len(base)
        fields = []
        for _ in range(ncols):
            f, pos = K.dec_value(k, pos)
            fields.append(f)
        return fields
    except Exception:
        return None


def _index_scan(tb, idef, eq_vals, tail, ctx, prefilter=None):
    """Scan an index: equality prefix on leading columns, then an optional
    range / IN-list on the next column. `prefilter` tests decoded key
    fields before the record fetch (sargable-residual pushdown)."""
    from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record
    from surrealdb_tpu_torch.exec.statements import Source

    ns, db = ctx.need_ns_db()
    seen = set()
    unique = idef.unique
    base = (
        K.index_unique_prefix(ns, db, tb, idef.name)
        if unique
        else K.index_prefix(ns, db, tb, idef.name)
    )

    def _fetch(rid):
        h = hashable(rid)
        if h in seen:
            return None
        seen.add(h)
        doc = fetch_record(ctx, rid)
        if doc is NONE:
            return None
        return Source(rid=rid, doc=doc)

    def _fields_pass(fields) -> bool:
        if prefilter is None:
            return True
        for pos, test in prefilter:
            if pos >= len(fields):
                continue
            try:
                if not test(fields[pos]):
                    from surrealdb_tpu_torch.exec.batch import _count

                    _count(ctx.ds, "pushdown_rows_pruned")
                    return False
            except Exception:
                return True  # never drop a row on a comparator wrinkle
        return True

    nonuniq_base = K.index_prefix(ns, db, tb, idef.name)

    def _emit_range(beg, end):
        ncols = len(idef.cols_str)
        if unique:
            # all-NONE rows of unique indexes live in the non-unique
            # keyspace (duplicates allowed); rebase the bounds there.
            # NONE sorts below every value, so those rows come FIRST in
            # index order (reference range scans interleave by key).
            nb = nonuniq_base + beg[len(base):]
            if end.startswith(base):
                ne = nonuniq_base + end[len(base):]
            else:
                # end was a whole-prefix bump: bump the rebased prefix
                ne = K.prefix_range(nb)[1]
            for k in ctx.txn.keys(nb, ne):
                _fields, idv = K.decode_index(k, ns, db, tb, idef.name, ncols)
                if not _fields_pass(_fields):
                    continue
                s = _fetch(RecordId(tb, idv))
                if s:
                    yield s
            for _k, rid in ctx.txn.scan_vals(beg, end):
                # unique entries key by field values under a different
                # prefix; the prefilter reads them via the shared codec
                if prefilter is not None:
                    _fields = _dec_unique_fields(_k, base, ncols)
                    if _fields is not None and not _fields_pass(_fields):
                        continue
                s = _fetch(rid)
                if s:
                    yield s
        else:
            for k in ctx.txn.keys(beg, end):
                _fields, idv = K.decode_index(k, ns, db, tb, idef.name, ncols)
                if not _fields_pass(_fields):
                    continue
                s = _fetch(RecordId(tb, idv))
                if s:
                    yield s

    def gen():
        prefix = base + K.index_fields_enc(eq_vals)
        if tail is None:
            if len(eq_vals) == len(idef.cols_str) and unique:
                rid = ctx.txn.get_val(
                    K.index_unique(ns, db, tb, idef.name, eq_vals)
                )
                if rid is not None:
                    s = _fetch(rid)
                    if s:
                        yield s
                elif any(x is NONE or x is None for x in eq_vals):
                    # all-NONE rows are stored without the unique
                    # constraint; scan the rebased non-unique range
                    yield from _emit_range(*K.prefix_range(prefix))
                return
            yield from _emit_range(*K.prefix_range(prefix))
            return
        kind, payload = tail
        if kind == "in":
            vals = evaluate(payload, ctx)
            if not isinstance(vals, list):
                vals = [vals]
            for v in vals:
                pre = prefix + K.enc_value(v)
                yield from _emit_range(*K.prefix_range(pre))
            return
        # range bounds on the next column. Composite scans (eq prefix)
        # push exactly ONE bound into the key range — the rest re-filter
        # via the residual WHERE (mirrors the streaming IndexScan access);
        # single-column scans combine all bounds as before.
        bounds = payload[:1] if eq_vals else payload
        lo = hi = None
        lo_incl = hi_incl = True
        for op, vx in bounds:
            v = evaluate(vx, ctx)
            if op in (">", ">="):
                lo, lo_incl = v, op == ">="
            else:
                hi, hi_incl = v, op == "<="
        beg, end = K.prefix_range(prefix)
        if lo is not None:
            beg = prefix + K.enc_value(lo)
            if not lo_incl:
                beg += b"\xff"
        if hi is not None:
            end = prefix + K.enc_value(hi)
            if hi_incl:
                end += b"\xff"
        yield from _emit_range(beg, end)

    return gen()


def _knn_safe_expr(expr) -> bool:
    if _field_path(expr) == "id":
        return True
    from surrealdb_tpu_torch.expr.ast import FunctionCall

    # knn-distance pseudo-functions read ctx.knn, not the document
    return isinstance(expr, FunctionCall) and expr.name in (
        "vector::distance::knn",
    ) and not expr.args


def _pseudo_only_projection(stmt, ctx, safe_expr, allow_order=False) -> bool:
    """True when a SELECT's output is derivable from an index result
    alone (rids + per-rid pseudo-function contexts): every projection is
    `id` or a `safe_expr` pseudo-function. Lets the scan skip per-row
    record fetches — the dominant host cost for high-QPS index serving.
    With `allow_order`, ORDER BY keys may be safe expressions or
    projection aliases (aliases re-evaluate their — safe — expressions
    against the keys-only row, exec/statements._apply_order_sources)."""
    from surrealdb_tpu_torch.expr.ast import SelectStmt

    if not isinstance(stmt, SelectStmt) or not ctx.session.is_owner:
        return False
    if (stmt.group is not None or stmt.split or stmt.fetch or stmt.omit
            or stmt.version is not None or stmt.explain):
        return False
    if stmt.order:  # ORDER BY may reference arbitrary fields
        if not allow_order or stmt.order == "rand":
            return False
        from surrealdb_tpu_torch.exec.statements import expr_name

        aliases = set()
        for e, a in (stmt.exprs or []):
            if e != "*":
                aliases.add(a or expr_name(e))
        for item in stmt.order:
            oexpr = item[0]
            if safe_expr(oexpr) or expr_name(oexpr) in aliases:
                continue
            return False
    if stmt.value is not None:
        return not stmt.exprs and safe_expr(stmt.value)
    if not stmt.exprs:
        return False
    return all(safe_expr(e) for e, _a in stmt.exprs)


def _id_only_projection(stmt, ctx) -> bool:
    """The KNN shape of `_pseudo_only_projection`: `SELECT id` /
    `SELECT VALUE id`, optionally with vector::distance::knn()."""
    return _pseudo_only_projection(stmt, ctx, _knn_safe_expr)


def _plan_knn(tb, cond, knn: Knn, indexes, ctx, stmt):
    from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record
    from surrealdb_tpu_torch.exec.statements import Source

    path = _field_path(knn.lhs)
    qv = evaluate(knn.rhs, ctx)
    rest = _remove_node(cond, knn)
    results = None
    if path is not None:
        # indexed ANN: `<|k,ef|>` / `<|k|>`, or `<|k,DIST|>` when DIST
        # matches the index distance (reference routes those to HNSW too)
        for idef in indexes:
            if idef.hnsw is None or not idef.cols_str or \
                    idef.cols_str[0] != path:
                continue
            if knn.dist is not None and knn.dist.lower() != \
                    idef.hnsw.get("distance", "euclidean"):
                continue
            from surrealdb_tpu_torch.idx.vector import get_vector_index

            eng = get_vector_index(idef, ctx)
            ef = knn.ef
            if ef is None and knn.dist is not None:
                ef = idef.hnsw.get("ef_construction", 150)
            results = eng.knn(
                qv, knn.k, ctx,
                ef=ef,
                cond=rest,
                cond_ctx=ctx if rest is not None else None,
            )
            break
        if results is None and knn.ef is not None:
            raise SdbError(
                f"There was no suitable index found for the provided KNN expression"
            )
    if results is None:
        # brute-force top-k over the table scan (KnnTopK operator,
        # exec/operators/knn_topk.rs)
        results = _brute_knn(tb, knn, qv, rest, ctx)
        rest_after = rest
        # the KnnTopK aggregate is global across all FROM sources: record k
        # so the SELECT loop trims the union of per-table top-ks back to k
        ctx._brute_knn_k = knn.k
    else:
        rest_after = None  # index path already applied the residual cond
    if getattr(ctx, "knn", None) is None:
        ctx.knn = {}

    def gen():
        from surrealdb_tpu_torch.exec.eval import fetch_record

        if _id_only_projection(stmt, ctx):
            # projection touches only `id` (plus knn-distance pseudo-
            # functions): the index result IS the answer — skip the
            # per-row record fetch entirely (keys-only KNN scan)
            for rid, dist in results:
                ctx.knn[hashable(rid)] = dist
                yield Source(rid=rid, doc={"id": rid})
            return
        for rid, dist in results:
            ctx.knn[hashable(rid)] = dist
            doc = fetch_record(ctx, rid)
            if doc is NONE:
                continue
            yield Source(rid=rid, doc=doc)

    ctx._cond_consumed = True
    if rest_after is not None:
        # brute path: still need residual filter; leave it to re-filter
        ctx._cond_consumed = True

        def gen2():
            from surrealdb_tpu_torch.exec.eval import evaluate as ev, fetch_record
            from surrealdb_tpu_torch.val import is_truthy

            for rid, dist in results:
                ctx.knn[hashable(rid)] = dist
                doc = fetch_record(ctx, rid)
                if doc is NONE:
                    continue
                yield Source(rid=rid, doc=doc)

        return gen2()
    return gen()


def _brute_knn(tb, knn: Knn, qv, rest, ctx):
    """Exact top-k over the table: batched on device for big tables
    (replaces KnnTopK's bounded max-heap with a device top k)."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.statements import _scan_table
    from surrealdb_tpu_torch.ops.metrics import normalize_metric
    from surrealdb_tpu_torch.val import is_truthy

    metric, p = normalize_metric(knn.dist or "euclidean")
    # fused columnar path: the residual predicate evaluates vectorized
    # over the table column store and only surviving candidates ship —
    # (mask, qvec, k) — through the cross-query batcher (exec/vops.py);
    # any wrinkle (exotic rows, overlay, non-conforming vectors) keeps
    # the exact row-at-a-time scan below
    from surrealdb_tpu_torch.exec.vops import fused_brute_knn

    fused = fused_brute_knn(tb, knn, qv, rest, ctx)
    if fused is not None:
        return fused
    path_expr = knn.lhs
    rows = []
    vecs = []
    dim = None
    for src in _scan_table(tb, ctx, None, None):
        c = ctx.with_doc(src.doc, src.rid)
        if rest is not None and not is_truthy(evaluate(rest, c)):
            continue
        v = evaluate(path_expr, c)
        if not isinstance(v, list):
            continue
        try:
            arr = np.asarray(v, dtype=np.float32)
        except (TypeError, ValueError):
            continue
        if arr.ndim != 1:
            continue
        if dim is None:
            dim = arr.shape[0]
        if arr.shape[0] != dim:
            continue
        rows.append(src.rid)
        vecs.append(arr)
    if not rows:
        return []
    xs = np.stack(vecs)
    q = np.asarray(qv, dtype=np.float32)
    n = len(rows)
    if n >= 4096:
        # big unindexed scans rank on device via the supervisor (the
        # rows are ephemeral — shipped with the call, nothing cached);
        # any device trouble degrades to the exact numpy path below
        from surrealdb_tpu_torch.device import (
            DeviceOpError, DeviceUnavailable, get_supervisor,
        )

        sup = get_supervisor()
        if sup.fast_path():
            try:
                _t, _m, bufs = sup.call(
                    "brute_knn",
                    {"k": min(knn.k, n), "metric": metric, "p": p},
                    [xs, q[None, :].astype(np.float32)],
                )
                d, i = bufs[0][0], bufs[1][0]
                return [(rows[int(ii)], float(dd))
                        for dd, ii in zip(d, i) if ii >= 0]
            except (DeviceUnavailable, DeviceOpError):
                sup.note_fallback()
        else:
            sup.note_fallback()  # same accounting as the vector path
    # host path
    from surrealdb_tpu_torch.idx.vector import TpuVectorIndex

    tmp = TpuVectorIndex.__new__(TpuVectorIndex)
    tmp.vecs = xs
    tmp.metric = metric
    tmp.mink_p = p
    d = tmp._host_distances(q)
    k = min(knn.k, n)
    idx = np.argpartition(d, k - 1)[:k]
    idx = idx[np.argsort(d[idx], kind="stable")]
    return [(rows[int(ii)], float(d[ii])) for ii in idx]

