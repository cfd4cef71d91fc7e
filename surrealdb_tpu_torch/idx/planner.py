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

from surrealdb_tpu_torch.err import SdbError


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


def _ft_branch_scan(tb, br, ctx):
    """One full-text branch of a multi-index union: run the search,
    publish the score/offset context (so the re-applied OR filter's
    MATCHES evaluates by membership), and yield the hits."""
    from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record
    from surrealdb_tpu_torch.exec.statements import Source
    from surrealdb_tpu_torch.idx.fulltext import ft_result

    mt = br["mt"]
    idef = br["idef"]
    q = evaluate(mt.rhs, ctx)
    pre = (ctx.vars.get("__ft__") or {}).get(("node", id(mt)))
    if pre is not None and pre["idef"].name == idef.name \
            and pre["query"] == str(q) and pre.get("res") is not None:
        res = pre["res"]
    else:
        res = ft_result(idef, str(q), ctx, boolean=mt.boolean)
    hits = res.hits
    ft_ctx = dict(ctx.vars.get("__ft__") or {})
    ctx.vars["__ft__"] = ft_ctx
    ref = mt.ref if mt.ref is not None else 0
    entry = {
        "scores": res.scores,
        "offsets": res.offsets,
        "idef": idef,
        "query": str(q),
        "res": res,
    }
    ft_ctx[ref] = entry
    # per-node key: two OR branches may share the default ref 0 (the AND
    # path rejects that as a duplicate, fulltext.py plan_matches); the
    # re-applied filter's membership check must not see the other
    # branch's hits, so matches_operator prefers this node-keyed entry
    ft_ctx[("node", id(mt))] = entry
    for rid, _s in hits:
        doc = fetch_record(ctx, rid)
        if doc is NONE:
            continue
        yield Source(rid=rid, doc=doc)


def union_branch_scan(tb, br, ctx):
    """Execute ONE multi-index union branch — the single dispatch point
    shared by _union_scan and the streaming explain's row counting, so
    explain output can't drift from what actually runs."""
    from surrealdb_tpu_torch.exec.eval import evaluate

    if br["kind"] == "ft":
        return _ft_branch_scan(tb, br, ctx)
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
        if jn["op"] == "matches":
            from surrealdb_tpu_torch.idx.fulltext import ft_search

            q = evaluate(jn["vexpr"], ctx)
            hits, _offsets = ft_search(
                ridef, str(q), ctx, boolean=jn["mt"].boolean
            )
            remote_ids = [r for r, _s in hits]
        elif jn["op"] == "in":
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


def _link_join_explain(tb, jn, ctx):
    from surrealdb_tpu_torch.exec.eval import evaluate

    if jn["op"] == "matches":
        mt = jn["mt"]
        rop = f"@{mt.ref}@" if mt.ref is not None else "@@"
        val = evaluate(jn["vexpr"], ctx)
    elif jn["op"] == "in":
        rop = "union"
        val = evaluate(jn["vexpr"], ctx)
    else:
        rop = "="
        val = evaluate(jn["vexpr"], ctx)
    return {
        "detail": {
            "plan": {
                "index": jn["lidef"].name,
                "joins": [
                    {"index": jn["ridef"].name, "operator": rop,
                     "value": val}
                ],
                "operator": "join",
            },
            "table": tb,
        },
        "operation": "Iterate Index",
    }


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


def _register_match_contexts(tb, cond, ctx):
    """The reference's QueryExecutor registers score/offset contexts for
    every indexed MATCHES in the cond even when the plan falls back to a
    table iterator (idx/planner/executor.rs QueryExecutor::new walks all
    matches expressions) — so search::score(ref)/highlight work without
    the full-text index driving the scan."""
    from surrealdb_tpu_torch.expr.ast import Matches

    nodes = []

    def rec(c):
        if isinstance(c, Matches):
            nodes.append(c)
        elif isinstance(c, Binary) and c.op in ("&&", "||"):
            rec(c.lhs)
            rec(c.rhs)

    rec(cond)
    if not nodes:
        return
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.idx.fulltext import ft_result

    indexes = get_indexes_for(tb, ctx)
    ft_ctx = dict(ctx.vars.get("__ft__") or {})
    registered: dict = {}
    for mt in nodes:
        idef = _ft_index_for(mt, indexes)
        if idef is None:
            continue  # no index: the filter evaluates it ad-hoc
        q = str(evaluate(mt.rhs, ctx))
        ref = mt.ref if mt.ref is not None else 0
        prev = registered.get(ref)
        if prev is not None:
            if prev == (idef.name, q):
                # same expression repeated: share the entry
                ft_ctx[("node", id(mt))] = ft_ctx[ref]
                continue
            # colliding refs (e.g. two implicit @@ in one cond): the
            # ref-keyed entry stays first-wins for the score functions;
            # the node-keyed entry below keeps membership exact per node
            # (plan_matches still rejects duplicates among AND-planned
            # matches, matching the reference's executor error)
        res = ft_result(idef, q, ctx, boolean=mt.boolean)
        entry = {
            "scores": res.scores,
            "offsets": res.offsets,
            "idef": idef,
            "query": q,
            "res": res,
        }
        if prev is None:
            ft_ctx[ref] = entry
            registered[ref] = (idef.name, q)
        ft_ctx[("node", id(mt))] = entry
    ctx.vars["__ft__"] = ft_ctx


def plan_scan(tb: str, cond, ctx, stmt):
    """Return a Source generator when an index path applies, else None
    (table scan). Indexed MATCHES in the cond get their score contexts
    registered regardless of which plan wins (the reference's
    QueryExecutor does this for every matches expression), so
    search::score/highlight work under table scans, eq-index scans,
    and union branches alike."""
    import time as _time

    from surrealdb_tpu_torch.telemetry import stage_record

    t0 = _time.perf_counter_ns()
    if cond is not None:
        with_index = getattr(stmt, "with_index", None) \
            if stmt is not None else None
        if with_index != []:
            _register_match_contexts(tb, cond, ctx)
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

    # ---- MATCHES ----------------------------------------------------------
    mts = _find_matches(cond)
    if mts:
        use_ft = True
        if getattr(ctx.session, "planner_strategy", None) == "all-ro":
            # multi-part idioms (`t.name @@ …`) may traverse record links;
            # MatchesOp only evaluates against the source table's fulltext
            # index (reference exec/planner.rs:525-537 PlannerUnimplemented)
            from surrealdb_tpu_torch.expr.ast import Idiom as _Idiom

            for m in mts:
                if isinstance(m.lhs, _Idiom) and len(m.lhs.parts) > 1:
                    raise SdbError(
                        "Invalid query: New executor does not support: "
                        "MATCHES with multi-part field path not yet "
                        "supported in streaming executor"
                    )
            # the streaming planner scores the MATCHES access at 800
            # (exec/index/analysis.rs:1281): a unique full-equality
            # candidate outranks it and the MATCHES drops to the filter
            eqs0, ins0, rngs0 = _classify_preds(
                cond, _array_like_paths(tb, ctx), value_idioms=False
            )
            ch0 = _choose_index(indexes, eqs0, ins0, rngs0) if (
                eqs0 or ins0 or rngs0
            ) else None
            if ch0 is not None and ch0[3] > 800:
                use_ft = False
        if use_ft:
            # a MATCHES on a multi-part link path can't use a LOCAL ft
            # index — try the remote-index join before plan_matches
            # raises (single-part un-indexed matches keep the error)
            if not all(_ft_index_for(m, indexes) for m in mts):
                jn = _find_link_join(tb, cond, indexes, ctx) if getattr(
                    ctx.session, "planner_strategy", None
                ) != "all-ro" else None
                if jn is not None:
                    return _link_join_scan(tb, jn, ctx)
                from surrealdb_tpu_torch.expr.ast import Idiom as _Idiom2

                if all(
                    isinstance(m.lhs, _Idiom2) and len(m.lhs.parts) > 1
                    for m in mts
                ):
                    return None  # link-path matches: row-wise ad hoc eval
            from surrealdb_tpu_torch.idx.fulltext import plan_matches

            return plan_matches(tb, cond, mts, indexes, ctx, stmt)

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


def _unsupported_expr(cond):
    """First planner-unsupported subexpression (unary ops) in an AND tree,
    rendered compactly for the Fallback explain entry."""
    from surrealdb_tpu_torch.expr.ast import Prefix as _Pfx

    preds = []
    _split_ands(cond, preds)
    for p in preds:
        if isinstance(p, _Pfx):
            from surrealdb_tpu_torch.exec.render_def import _expr_sql

            inner = _expr_sql(p.expr)
            return f"{p.op}{inner}"
    return None


def explain_plan(tb, cond, ctx, stmt):
    """EXPLAIN output (reference dbs/plan.rs Explanation)."""
    with_index = getattr(stmt, "with_index", None) if stmt is not None else None
    orig_cond = cond
    if with_index == []:
        cond = None  # WITH NOINDEX: always a table scan
    # record strategy (idx/planner/mod.rs check_record_strategy): a
    # count()-only selection over a bare table needs no document values —
    # GROUP ALL counts keys (Count), ungrouped iterates keys (KeysOnly)
    if orig_cond is None and stmt is not None and             not getattr(stmt, "order", None) and             getattr(stmt, "exprs", None):
        from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC3

        if (
            len(stmt.exprs) == 1
            and isinstance(stmt.exprs[0][0], _FC3)
            and stmt.exprs[0][0].name.lower() == "count"
            and not stmt.exprs[0][0].args
        ):
            group = getattr(stmt, "group", None)
            if group == []:
                # a live COUNT index serves the whole-table count directly
                # (reference count_exists_rewriter.rs; decommissioned
                # PREPARE REMOVE indexes are skipped)
                idxs0 = get_indexes_for(tb, ctx)
                if with_index:
                    idxs0 = [i for i in idxs0 if i.name in with_index]
                cidx = next(
                    (i for i in idxs0 if i.count
                     and getattr(i, "count_cond", None) is None
                     and not getattr(i, "prepare_remove", False)),
                    None,
                )
                if cidx is not None:
                    return {
                        "detail": {
                            "plan": {"index": cidx.name, "operator": "Count"},
                            "table": tb,
                        },
                        "operation": "Iterate Index Count",
                    }
                return {
                    "detail": {"direction": "forward", "table": tb},
                    "operation": "Iterate Table Count",
                }
            if group is None:
                return {
                    "detail": {"direction": "forward", "table": tb},
                    "operation": "Iterate Table Keys",
                }
    if cond is not None:
        from surrealdb_tpu_torch.exec.statements import _resolve_type_fields

        cond = _resolve_type_fields(cond, ctx)
        knn = _find_knn(cond)
        indexes = get_indexes_for(tb, ctx)
        if with_index:
            indexes = [i for i in indexes if i.name in with_index]
        if knn is not None:
            path = _field_path(knn.lhs)
            for idef in indexes:
                if idef.hnsw is not None and idef.cols_str and \
                        idef.cols_str[0] == path and (
                            knn.dist is None
                            or knn.dist.lower() == idef.hnsw.get(
                                "distance", "euclidean")
                        ):
                    from surrealdb_tpu_torch.exec.eval import evaluate

                    try:
                        qval = evaluate(knn.rhs, ctx)
                    except Exception:
                        qval = None
                    ef = knn.ef
                    if ef is None and knn.dist is not None:
                        ef = idef.hnsw.get("ef_construction", 150)
                    from surrealdb_tpu_torch.idx.vector import get_vector_index

                    eng = get_vector_index(idef, ctx)
                    plan = {
                        "index": idef.name,
                        "operator": f"<|{knn.k},{ef or 40}|>",
                        "value": qval,
                    }
                    ann_plan = eng.ann_plan(knn.k)
                    if ann_plan is not None:
                        # the size/metric gate routed this store off
                        # the brute scan: "graph" = whole-store CAGRA
                        # (int8 descent + exact re-rank), "segmented" =
                        # LSM-style sealed-segment fan-out with
                        # per-segment graphs (idx/segments.py); the
                        # segment/ready counts surface the lifecycle
                        plan.update(ann_plan)
                    refresh = getattr(eng, "refresh_parts", None)
                    if refresh is not None:
                        # sharded store: the search scatter-gathers
                        # across this many index shards (idx/shardvec)
                        try:
                            plan["shards"] = len(refresh())
                        except SdbError:
                            pass  # map unreadable: plan stays useful
                    return {
                        "detail": {"plan": plan, "table": tb},
                        "operation": "Iterate Index",
                    }
            return {
                "detail": {"direction": "forward", "table": tb},
                "operation": "Iterate Table",
            }
        union = multi_index_leaves(tb, cond, indexes, ctx)
        if union is not None:
            from surrealdb_tpu_torch.exec.eval import evaluate

            entries = []
            for br in union:
                if br["kind"] == "range":
                    frm = {"inclusive": False, "value": NONE}
                    to = {"inclusive": False, "value": NONE}
                    for rop, rexpr in br["tail"][1]:
                        rv = evaluate(rexpr, ctx)
                        if rop in (">", ">="):
                            frm = {"inclusive": rop == ">=", "value": rv}
                        else:
                            to = {"inclusive": rop == "<=", "value": rv}
                    entries.append({
                        "detail": {
                            "plan": {
                                "direction": "forward",
                                "from": frm,
                                "index": br["idef"].name,
                                "to": to,
                            },
                            "table": tb,
                        },
                        "operation": "Iterate Index",
                    })
                    continue
                if br["kind"] == "ft":
                    mt = br["mt"]
                    op = f"@{mt.ref}@" if mt.ref is not None else "@@"
                    try:
                        val = evaluate(mt.rhs, ctx)
                    except Exception:
                        val = None
                elif br["kind"] == "in":
                    op = "union"
                    iv = evaluate(br["tail"][1], ctx)
                    val = iv if isinstance(iv, list) else [iv]
                else:
                    idef = br["idef"]
                    op = "="
                    vals = [
                        evaluate(br["eqs"][c], ctx)
                        for c in idef.cols_str[:br["nmatch"]]
                    ]
                    val = vals[0] if len(vals) == 1 else vals
                entries.append({
                    "detail": {
                        "plan": {
                            "index": br["idef"].name,
                            "operator": op,
                            "value": val,
                        },
                        "table": tb,
                    },
                    "operation": "Iterate Index",
                })
            return entries
        # a top-level OR whose disjuncts each carry an AND tail is not a
        # leaf union (multi_index_leaves rejects it) but still unions one
        # access per disjunct — render it as a single UnionIndexScan
        # plan object (reference exec/operators/scan/union.rs JSON)
        orb = or_union_branches(tb, cond, indexes, ctx)
        if orb is not None:
            from surrealdb_tpu_torch.exec.eval import evaluate

            plans = []
            for br in orb:
                if br["kind"] == "range":
                    frm = {"inclusive": False, "value": NONE}
                    to = {"inclusive": False, "value": NONE}
                    for rop, rexpr in br["tail"][1]:
                        rv = evaluate(rexpr, ctx)
                        if rop in (">", ">="):
                            frm = {"inclusive": rop == ">=", "value": rv}
                        else:
                            to = {"inclusive": rop == "<=", "value": rv}
                    plans.append({
                        "direction": "forward", "from": frm,
                        "index": br["idef"].name, "to": to,
                    })
                    continue
                if br["kind"] == "ft":
                    mt = br["mt"]
                    op = f"@{mt.ref}@" if mt.ref is not None else "@@"
                    try:
                        val = evaluate(mt.rhs, ctx)
                    except Exception:
                        val = None
                elif br["kind"] == "in":
                    op = "union"
                    iv = evaluate(br["tail"][1], ctx)
                    val = iv if isinstance(iv, list) else [iv]
                else:
                    idef = br["idef"]
                    op = "="
                    vals = [
                        evaluate(br["eqs"][c], ctx)
                        for c in idef.cols_str[:br["nmatch"]]
                    ]
                    val = vals[0] if len(vals) == 1 else vals
                plans.append({
                    "index": br["idef"].name,
                    "operator": op,
                    "value": val,
                })
            return {
                "detail": {
                    "plan": {
                        "operator": "UnionIndexScan",
                        "branches": plans,
                    },
                    "table": tb,
                },
                "operation": "Iterate Index Union",
            }
        mts = _find_matches(cond)
        if mts:
            from surrealdb_tpu_torch.exec.eval import evaluate

            mt = mts[0]
            path = _field_path(mt.lhs)
            for idef in indexes:
                if idef.fulltext is not None and (
                    path is None or (idef.cols_str and idef.cols_str[0] == path)
                ):
                    op = f"@{mt.ref}@" if mt.ref is not None else "@@"
                    try:
                        val = evaluate(mt.rhs, ctx)
                    except Exception:
                        val = None
                    return {
                        "detail": {
                            "plan": {
                                "index": idef.name,
                                "operator": op,
                                "value": val,
                            },
                            "table": tb,
                        },
                        "operation": "Iterate Index",
                    }
        from surrealdb_tpu_torch.exec.eval import evaluate

        eqs, ins, rngs = _classify_preds(cond, _array_like_paths(tb, ctx))
        best = None
        chosen = _choose_index(indexes, eqs, ins, rngs, model="legacy")
        if chosen is None:
            jn = _find_link_join(tb, cond, indexes, ctx)
            if jn is not None:
                return _link_join_explain(tb, jn, ctx)
        count_only = False
        if stmt is not None and getattr(stmt, "group", None) == [] and \
                getattr(stmt, "exprs", None):
            from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC2

            count_only = (
                len(stmt.exprs) == 1
                and isinstance(stmt.exprs[0][0], _FC2)
                and stmt.exprs[0][0].name.lower() == "count"
                and not stmt.exprs[0][0].args
            )
        if chosen is not None:
            idef, nmatch, tail, _score = chosen
            if count_only:
                # a count-only scan requires the index to cover the whole
                # WHERE clause; residual predicates need real documents
                covered = set(idef.cols_str[:nmatch])
                if tail is not None:
                    covered.add(idef.cols_str[nmatch])
                preds = []
                _split_ands(cond, preds)
                classified = set(eqs) | set(ins) | set(rngs)
                _IDXOPS = ("=", "==", "\u2208", "<", "<=", ">", ">=",
                           "\u220b", "\u2287", "containsany")
                for pred in preds:
                    pth = None
                    servable = False
                    if isinstance(pred, Binary) and pred.op in _IDXOPS:
                        lp2 = _field_path(pred.lhs)
                        rp2 = _field_path(pred.rhs)
                        # exactly one side is the column; the other side
                        # must be a computable value
                        if (lp2 is None) != (rp2 is None):
                            pth = lp2 or rp2
                            servable = True
                    if not servable or pth not in covered or \
                            pth not in classified:
                        count_only = False
                        break
            vals = [evaluate(eqs[c], ctx) for c in idef.cols_str[:nmatch]]
            op = "="
            if tail is not None and tail[0] == "in":
                op = "union"
                iv = evaluate(tail[1], ctx)
                iv = iv if isinstance(iv, list) else [iv]
                if nmatch:
                    # composite: one [prefix..., v] branch per IN value
                    vals = [list(vals) + [x] for x in iv]
                else:
                    vals = vals + [iv]
            elif tail is not None and tail[0] == "range" and not nmatch \
                    and not count_only:
                frm = {"inclusive": False, "value": NONE}
                to = {"inclusive": False, "value": NONE}
                for rop2, rexpr2 in tail[1]:
                    rv2 = evaluate(rexpr2, ctx)
                    if rop2 in (">", ">="):
                        frm = {"inclusive": rop2 == ">=", "value": rv2}
                    else:
                        to = {"inclusive": rop2 == "<=", "value": rv2}
                direction = "forward"
                order_consumed = False
                order = getattr(stmt, "order", None) if stmt is not None                     else None
                if order and order != "rand" and len(order) == 1:
                    from surrealdb_tpu_torch.exec.statements import expr_name

                    oexpr, odir = order[0][0], order[0][1]
                    if expr_name(oexpr) == idef.cols_str[0]:
                        # the scan streams in index order: ASC rides the
                        # forward iterator, DESC the reverse iterator
                        order_consumed = True
                        if odir == "desc":
                            direction = "backward"
                detail = {
                    "plan": {
                        "direction": direction,
                        "from": frm,
                        "index": idef.name,
                        "to": to,
                    },
                    "table": tb,
                }
                if order_consumed:
                    detail["_order_consumed"] = True
                return {
                    "detail": detail,
                    "operation": "Iterate Index",
                }
            elif tail is not None and tail[0] == "range" and nmatch and \
                    not count_only:
                # composite eq-prefix + range tail: the reference renders
                # the prefix values and each range bound in cond order
                # (exe/lookup compound plans)
                return {
                    "detail": {
                        "plan": {
                            "index": idef.name,
                            "prefix": vals,
                            "ranges": [
                                {"operator": rop, "value": evaluate(rexpr, ctx)}
                                for rop, rexpr in tail[1]
                            ],
                        },
                        "table": tb,
                    },
                    "operation": "Iterate Index",
                }
            elif tail is not None:
                op = {">": "MoreThan", ">=": "MoreThanOrEqual",
                      "<": "LessThan", "<=": "LessThanOrEqual"}.get(
                          tail[1][0][0], "range")
                vals = vals + [evaluate(tail[1][0][1], ctx)]
            value = vals[0] if len(vals) == 1 else vals
            if op == "union" and len(vals) == 1:
                value = vals[0]
            if count_only and tail is not None and tail[0] == "range":
                frm = {"inclusive": True, "value": NONE}
                to = {"inclusive": False, "value": NONE}
                for rop, rexpr in tail[1]:
                    rv = evaluate(rexpr, ctx)
                    if rop in (">", ">="):
                        frm = {"inclusive": rop == ">=", "value": rv}
                    else:
                        to = {"inclusive": rop == "<=", "value": rv}
                return {
                    "detail": {
                        "plan": {
                            "direction": "forward",
                            "from": frm,
                            "index": idef.name,
                            "to": to,
                        },
                        "table": tb,
                    },
                    "operation": "Iterate Index Count",
                }
            return {
                "detail": {
                    "plan": {
                        "index": idef.name,
                        "operator": op,
                        "value": value,
                    },
                    "table": tb,
                },
                "operation": "Iterate Index Count" if count_only
                else "Iterate Index",
            }
    if cond is None and stmt is not None and with_index != []:
        # no WHERE, but a single-key ORDER BY over an indexed column:
        # stream the index in (reverse) order (reference Plan::SingleIndex
        # with Order/ReverseOrder iterators)
        order = getattr(stmt, "order", None)
        if order and order != "rand" and len(order) == 1:
            from surrealdb_tpu_torch.exec.statements import expr_name

            oexpr, odir = order[0][0], order[0][1]
            opath = expr_name(oexpr)
            idxs = get_indexes_for(tb, ctx)
            if with_index:
                idxs = [i for i in idxs if i.name in with_index]
            idef3 = next(
                (d for d in idxs
                 if d.cols_str and d.cols_str[0] == opath
                 and d.hnsw is None and d.fulltext is None and not d.count),
                None,
            )
            if idef3 is not None:
                return {
                    "detail": {
                        "plan": {
                            "index": idef3.name,
                            "operator": "ReverseOrder" if odir == "desc"
                            else "Order",
                        },
                        "table": tb,
                        "_order_consumed": True,
                    },
                    "operation": "Iterate Index",
                }
    base = {
        "detail": {"direction": "forward", "table": tb},
        "operation": "Iterate Table",
    }
    if cond is not None:
        reason = _unsupported_expr(cond)
        if reason is not None:
            # the planner analyzer bailed on an unsupported expression
            # shape: the explain carries a Fallback entry (dbs/plan.rs)
            return [base, {
                "detail": {"reason": f"Unsupported expression: {reason}"},
                "operation": "Fallback",
            }]
    return base
