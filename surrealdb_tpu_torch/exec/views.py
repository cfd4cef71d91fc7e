"""Incremental materialized-view maintenance (the reference package's
`exec/views.py`).

Mirrors the reference's aggregation framework (catalog/aggregation.rs:
Aggregation/AggregationStat/add_to_aggregation_stats/create_field_document)
and per-document view processing (doc/table.rs process_view*): every source
write updates the view's per-group aggregation stats in place — no source
rescan — so views stay correct even over DROP tables, cascade to
views-on-views, and fire events on the view rows they write.

Unsupported shapes (accumulating aggregates like array::group/math::median,
VALUE selectors) raise Unsupported and fall back to the scan-based rebuild
in exec/document.py.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass, field, replace

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.expr.ast import (
    Binary,
    FunctionCall,
    Idiom,
    PField,
    Prefix,
)
from surrealdb_tpu_torch.val import NONE, Datetime, RecordId, copy_value, is_truthy, render

# aggregate function -> (stat kind, expected arg type label)
_AGG_KINDS = {
    "count": ("countv", "number"),
    "math::max": ("nmax", "number"),
    "math::min": ("nmin", "number"),
    "math::sum": ("sum", "number"),
    "math::mean": ("mean", "number"),
    "math::stddev": ("stddev", "number"),
    "math::variance": ("variance", "number"),
    "time::max": ("tmax", "datetime"),
    "time::min": ("tmin", "datetime"),
}

_FN_NAME = {
    "countv": "count", "nmax": "math::max", "nmin": "math::min",
    "sum": "math::sum", "mean": "math::mean", "stddev": "math::stddev",
    "variance": "math::variance", "tmax": "time::max", "tmin": "time::min",
}


class Unsupported(Exception):
    """View shape the incremental engine can't maintain — caller falls
    back to the scan-based rebuild."""


@dataclass
class ViewAnalysis:
    kind: str  # "aggregate" | "plain"
    cond: object = None
    group_exprs: list = field(default_factory=list)
    aggregations: list = field(default_factory=list)  # (stat kind, argidx)
    arg_exprs: list = field(default_factory=list)
    fields: list = field(default_factory=list)  # (name, rewritten expr)


def _is_field_idiom(e, name=None):
    return (
        isinstance(e, Idiom)
        and len(e.parts) == 1
        and isinstance(e.parts[0], PField)
        and (name is None or e.parts[0].name == name)
    )


def analyze_view(sel) -> ViewAnalysis:
    """Reference AggregationAnalysis::analyze_fields_groups (materialized)."""
    group = getattr(sel, "group", None)
    cond = getattr(sel, "cond", None)
    exprs = getattr(sel, "exprs", None)
    if getattr(sel, "value", None) is not None or exprs is None:
        raise Unsupported("VALUE selectors are not supported on views")
    if getattr(sel, "split", None):
        raise Unsupported("SPLIT on a view")
    if group is None:
        return ViewAnalysis(kind="plain", cond=cond)

    a = ViewAnalysis(kind="aggregate", cond=cond)
    a.group_exprs = list(group)
    arg_map: dict = {}  # rendered arg expr -> index

    def arg_index(expr):
        key = repr(expr)
        idx = arg_map.get(key)
        if idx is None:
            idx = len(a.arg_exprs)
            arg_map[key] = idx
            a.arg_exprs.append(expr)
        return idx

    def rewrite(e, in_agg_arg=False):
        if isinstance(e, FunctionCall):
            fname = e.name.lower()
            if fname == "count" and not e.args:
                a.aggregations.append(("count", None))
                return Idiom([PField(f"_a{len(a.aggregations) - 1}")])
            if fname in _AGG_KINDS:
                if in_agg_arg:
                    raise Unsupported("nested aggregate")
                if len(e.args) != 1:
                    raise Unsupported("aggregate arity")
                kindname, _ = _AGG_KINDS[fname]
                idx = arg_index(e.args[0])
                a.aggregations.append((kindname, idx))
                return Idiom([PField(f"_a{len(a.aggregations) - 1}")])
            from surrealdb_tpu_torch.exec.statements import _is_aggregate

            if any(_is_aggregate(x) for x in e.args):
                new_args = [rewrite(x, in_agg_arg) for x in e.args]
                return replace(e, args=new_args)
            return e
        if isinstance(e, Idiom) and not in_agg_arg:
            for gi, g in enumerate(a.group_exprs):
                if e == g:
                    return Idiom([PField(f"_g{gi}")])
            return e
        if isinstance(e, Binary):
            return replace(
                e, lhs=rewrite(e.lhs, in_agg_arg), rhs=rewrite(e.rhs, in_agg_arg)
            )
        if isinstance(e, Prefix):
            return replace(e, expr=rewrite(e.expr, in_agg_arg))
        from surrealdb_tpu_torch.exec.statements import _is_aggregate

        if _is_aggregate(e):
            raise Unsupported("aggregate in unsupported expression shape")
        return e

    from surrealdb_tpu_torch.exec.statements import _is_aggregate, expr_name

    # aliases used in GROUP BY refer to their expressions
    for gi, g in enumerate(a.group_exprs):
        if _is_field_idiom(g):
            gname = g.parts[0].name
            for expr, alias in exprs:
                if expr == "*":
                    continue
                if alias == gname:
                    a.group_exprs[gi] = expr
                    break

    for expr, alias in exprs:
        if expr == "*":
            raise Unsupported("* selector on an aggregate view")
        name = alias or expr_name(expr)
        # group expression (by alias or directly)?
        matched = False
        for gi, g in enumerate(a.group_exprs):
            if expr == g or (alias and _is_field_idiom(g, alias)):
                a.fields.append((name, Idiom([PField(f"_g{gi}")])))
                matched = True
                break
        if matched:
            continue
        if _is_aggregate(expr):
            a.fields.append((name, rewrite(expr)))
        else:
            # non-aggregate, non-group selectors would accumulate values
            # (Aggregation::Accumulate) — unsupported on views
            raise Unsupported(f"accumulating selector {name}")

    # ensure a per-group record count exists (drives row deletion)
    if not any(k in ("count", "countv", "mean", "stddev", "variance")
               for k, _ in a.aggregations):
        a.aggregations.append(("count", None))
    return a


# ---------------------------------------------------------------------------
# aggregation stats
# ---------------------------------------------------------------------------


def new_stats(aggregations) -> list:
    out = []
    for kind, arg in aggregations:
        if kind == "count":
            out.append({"k": "count", "count": 0})
        elif kind == "countv":
            out.append({"k": "countv", "arg": arg, "count": 0})
        elif kind == "nmax":
            out.append({"k": "nmax", "arg": arg, "max": float("-inf")})
        elif kind == "nmin":
            out.append({"k": "nmin", "arg": arg, "min": float("inf")})
        elif kind == "sum":
            out.append({"k": "sum", "arg": arg, "sum": 0.0})
        elif kind == "mean":
            out.append({"k": "mean", "arg": arg, "sum": 0.0, "count": 0})
        elif kind in ("stddev", "variance"):
            out.append({"k": kind, "arg": arg, "sum": 0.0, "sumsq": 0.0,
                        "count": 0})
        elif kind == "tmax":
            out.append({"k": "tmax", "arg": arg, "max": None})
        elif kind == "tmin":
            out.append({"k": "tmin", "arg": arg, "min": None})
    return out


def _num(v, kind):
    from decimal import Decimal

    if isinstance(v, bool) or not isinstance(v, (int, float, Decimal)):
        raise SdbError(
            f"Incorrect arguments for function {_FN_NAME[kind]}(). "
            f"Argument 1 was the wrong type. Expected `number` but found "
            f"`{render(v)}`"
        )
    return v


def _dt(v, kind):
    if not isinstance(v, Datetime):
        raise SdbError(
            f"Incorrect arguments for function {_FN_NAME[kind]}(). "
            f"Argument 1 was the wrong type. Expected `datetime` but found "
            f"`{render(v)}`"
        )
    return v


def stats_add(stats, args):
    """reference add_to_aggregation_stats."""
    from surrealdb_tpu_torch.exec.operators import add, mul

    for s in stats:
        k = s["k"]
        if k == "count":
            s["count"] += 1
        elif k == "countv":
            if is_truthy(args[s["arg"]]):
                s["count"] += 1
        elif k == "nmax":
            n = _num(args[s["arg"]], k)
            if s["max"] < n:
                s["max"] = n
        elif k == "nmin":
            n = _num(args[s["arg"]], k)
            if s["min"] > n:
                s["min"] = n
        elif k == "sum":
            s["sum"] = add(s["sum"], _num(args[s["arg"]], k))
        elif k == "mean":
            s["sum"] = add(s["sum"], _num(args[s["arg"]], k))
            s["count"] += 1
        elif k in ("stddev", "variance"):
            n = _num(args[s["arg"]], k)
            s["sum"] = add(s["sum"], n)
            s["sumsq"] = add(s["sumsq"], mul(n, n))
            s["count"] += 1
        elif k == "tmax":
            d = _dt(args[s["arg"]], k)
            if s["max"] is None or s["max"] < d:
                s["max"] = d
        elif k == "tmin":
            d = _dt(args[s["arg"]], k)
            if s["min"] is None or s["min"] > d:
                s["min"] = d


def stats_remove(stats, args) -> list:
    """Downdate on record removal; returns stat indexes needing a
    recalculation (min/max losing their extremum)."""
    from surrealdb_tpu_torch.exec.operators import mul, sub

    recalc = []
    for i, s in enumerate(stats):
        k = s["k"]
        if k == "count":
            s["count"] -= 1
        elif k == "countv":
            if is_truthy(args[s["arg"]]):
                s["count"] -= 1
        elif k == "nmax":
            if args[s["arg"]] == s["max"]:
                recalc.append(i)
        elif k == "nmin":
            if args[s["arg"]] == s["min"]:
                recalc.append(i)
        elif k == "sum":
            s["sum"] = sub(s["sum"], _num(args[s["arg"]], k))
        elif k == "mean":
            s["sum"] = sub(s["sum"], _num(args[s["arg"]], k))
            s["count"] -= 1
        elif k in ("stddev", "variance"):
            n = _num(args[s["arg"]], k)
            s["sum"] = sub(s["sum"], n)
            s["sumsq"] = sub(s["sumsq"], mul(n, n))
            s["count"] -= 1
        elif k == "tmax":
            if args[s["arg"]] == s["max"]:
                recalc.append(i)
        elif k == "tmin":
            if args[s["arg"]] == s["min"]:
                recalc.append(i)
    return recalc


def stats_update(stats, before_args, after_args) -> list:
    """Same-group update; returns stat indexes needing recalculation."""
    from surrealdb_tpu_torch.exec.operators import add, mul, sub

    recalc = []
    for i, s in enumerate(stats):
        k = s["k"]
        if k == "count":
            pass
        elif k == "countv":
            if is_truthy(before_args[s["arg"]]):
                s["count"] -= 1
            if is_truthy(after_args[s["arg"]]):
                s["count"] += 1
        elif k == "nmax":
            after = _num(after_args[s["arg"]], k)
            before = before_args[s["arg"]]
            if after >= s["max"]:
                s["max"] = after
            elif before == s["max"]:
                recalc.append(i)
        elif k == "nmin":
            after = _num(after_args[s["arg"]], k)
            before = before_args[s["arg"]]
            if after <= s["min"]:
                s["min"] = after
            elif before == s["min"]:
                recalc.append(i)
        elif k == "sum":
            s["sum"] = add(sub(s["sum"], _num(before_args[s["arg"]], k)),
                           _num(after_args[s["arg"]], k))
        elif k == "mean":
            s["sum"] = add(sub(s["sum"], _num(before_args[s["arg"]], k)),
                           _num(after_args[s["arg"]], k))
        elif k in ("stddev", "variance"):
            b = _num(before_args[s["arg"]], k)
            n = _num(after_args[s["arg"]], k)
            s["sum"] = add(sub(s["sum"], b), n)
            s["sumsq"] = add(sub(s["sumsq"], mul(b, b)), mul(n, n))
        elif k == "tmax":
            after = _dt(after_args[s["arg"]], k)
            before = before_args[s["arg"]]
            if s["max"] is None or after >= s["max"]:
                s["max"] = after
            elif before == s["max"]:
                recalc.append(i)
        elif k == "tmin":
            after = _dt(after_args[s["arg"]], k)
            before = before_args[s["arg"]]
            if s["min"] is None or after <= s["min"]:
                s["min"] = after
            elif before == s["min"]:
                recalc.append(i)
    return recalc


def stats_count(stats):
    for s in stats:
        if s["k"] in ("count", "countv", "mean", "stddev", "variance"):
            return s["count"]
    return None


def field_document(group_vals, stats) -> dict:
    """reference create_field_document: {_aN: value, _gN: group value}."""
    from surrealdb_tpu_torch.exec.operators import div, float_div, mul, sub

    doc = {}
    for i, s in enumerate(stats):
        k = s["k"]
        if k in ("count", "countv"):
            v = s["count"]
        elif k == "nmax":
            v = s["max"]
        elif k == "nmin":
            v = s["min"]
        elif k == "sum":
            v = s["sum"]
        elif k == "mean":
            v = (float_div(s["sum"], s["count"]) if s["count"]
                 else float("nan"))
        elif k in ("stddev", "variance"):
            if s["count"] <= 1:
                v = 0.0
            else:
                mean = div(s["sum"], s["count"])
                var = div(sub(s["sumsq"], mul(s["sum"], mean)),
                          s["count"] - 1)
                if var == 0.0:
                    var = 0.0
                v = var if k == "variance" else (
                    _math.sqrt(float(var)) if float(var) > 0 else 0.0
                )
        elif k in ("tmax",):
            v = s["max"] if s["max"] is not None else NONE
        else:
            v = s["min"] if s["min"] is not None else NONE
        doc[f"_a{i}"] = v
    for gi, gv in enumerate(group_vals):
        doc[f"_g{gi}"] = gv
    return doc


# ---------------------------------------------------------------------------
# per-document view processing (reference doc/table.rs)
# ---------------------------------------------------------------------------


def _eval(expr, doc, ctx):
    from surrealdb_tpu_torch.exec.eval import evaluate

    c = ctx.with_doc(doc, None)
    return evaluate(expr, c)


def _compute_args(analysis, doc, ctx):
    return [_eval(e, doc, ctx) for e in analysis.arg_exprs]


def _compute_group(analysis, doc, ctx):
    return [_eval(g, doc, ctx) for g in analysis.group_exprs]


def _cond_ok(analysis, doc, ctx) -> bool:
    if analysis.cond is None:
        return True
    return is_truthy(_eval(analysis.cond, doc, ctx))


def process_view(view_tdef, analysis, rid, before, after, action, ctx):
    """Dispatch one source-document mutation into the view (reference
    doc/table.rs process_view / process_aggregate_view)."""
    if analysis.kind == "plain":
        _process_plain(view_tdef, analysis, rid, before, after, action, ctx)
        return
    if action == "CREATE":
        if not _cond_ok(analysis, after, ctx):
            return
        group = _compute_group(analysis, after, ctx)
        _view_create(view_tdef, analysis, group, after, ctx)
    elif action == "DELETE":
        if not _cond_ok(analysis, before, ctx):
            return
        group = _compute_group(analysis, before, ctx)
        _view_delete(view_tdef, analysis, group, before, ctx)
    else:  # UPDATE
        gb = (_compute_group(analysis, before, ctx)
              if _cond_ok(analysis, before, ctx) else None)
        ga = (_compute_group(analysis, after, ctx)
              if _cond_ok(analysis, after, ctx) else None)
        if gb is None and ga is None:
            return
        if gb is not None and ga is not None:
            from surrealdb_tpu_torch.val import value_eq

            same = len(gb) == len(ga) and all(
                value_eq(x, y) for x, y in zip(gb, ga)
            )
            if same:
                _view_update(view_tdef, analysis, gb, before, after, ctx)
            else:
                _view_delete(view_tdef, analysis, gb, before, ctx)
                _view_create(view_tdef, analysis, ga, after, ctx)
        elif gb is not None:
            _view_delete(view_tdef, analysis, gb, before, ctx)
        else:
            _view_create(view_tdef, analysis, ga, after, ctx)


def _process_plain(view_tdef, analysis, rid, before, after, action, ctx):
    """Non-aggregated materialized view: one view row per source row,
    same record key (reference ViewDefinition::Materialized)."""
    from surrealdb_tpu_torch.exec.statements import expr_name

    ns, db = ctx.need_ns_db()
    vrid = RecordId(view_tdef.name, rid.id)
    if analysis.cond is not None:
        doc = after if action != "DELETE" else before
        store = action != "DELETE" and is_truthy(_eval(analysis.cond, after, ctx))
    else:
        store = action != "DELETE"
    vkey = K.record(ns, db, view_tdef.name, rid.id)
    old = ctx.txn.get(vkey)
    from surrealdb_tpu_torch.kvs.api import deserialize, serialize

    old_doc = deserialize(old) if old is not None else NONE
    if store:
        row = {}
        from surrealdb_tpu_torch.exec.eval import evaluate

        sel = view_tdef.view
        c = ctx.with_doc(after, rid)
        for expr, alias in sel.exprs:
            if expr == "*":
                if isinstance(after, dict):
                    row.update(copy_value(after))
                continue
            row[alias or expr_name(expr)] = evaluate(expr, c)
        row["id"] = vrid
        ctx.txn.set(vkey, serialize(row))
        ctx.record_cache.pop((view_tdef.name, K.enc_value(rid.id)), None)
        _fire_triggers(
            vrid, old_doc, row,
            "UPDATE" if old is not None else "CREATE", ctx,
        )
    elif old is not None:
        ctx.txn.delete(vkey)
        ctx.record_cache.pop((view_tdef.name, K.enc_value(rid.id)), None)
        _fire_triggers(vrid, old_doc, NONE, "DELETE", ctx)


def _row_keys(view_tdef, group, ctx):
    ns, db = ctx.need_ns_db()
    gid = list(group)
    kb = K.enc_value(gid)
    return (
        RecordId(view_tdef.name, gid),
        K.record(ns, db, view_tdef.name, gid),
        K.view_meta(ns, db, view_tdef.name, kb),
    )


def _write_view_row(view_tdef, analysis, group, stats, before_doc, action, ctx):
    """Materialize the row from stats + run triggers (reference
    run_triggers: index + cascading views + events)."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.kvs.api import serialize

    vrid, vkey, mkey = _row_keys(view_tdef, group, ctx)
    fdoc = field_document(group, stats)
    row = {}
    c = ctx.with_doc(fdoc, vrid)
    for name, expr in analysis.fields:
        v = evaluate(expr, c)
        if v is not NONE:
            row[name] = v
    row["id"] = vrid
    ctx.txn.set(vkey, serialize(row))
    ctx.txn.set_val(mkey, stats)
    ctx.record_cache.pop((view_tdef.name, K.enc_value(vrid.id)), None)
    _fire_triggers(vrid, before_doc, row, action, ctx)


def _fire_triggers(vrid, before_doc, after_doc, action, ctx):
    """Index + cascade + events on a view-row write (reference
    doc/table.rs run_triggers)."""
    from surrealdb_tpu_torch.exec.document import (
        index_update,
        run_events,
        update_views,
    )

    if ctx.depth > 24:
        raise SdbError("Max computation depth exceeded")
    c = ctx.child()
    index_update(vrid, before_doc, after_doc, c)
    update_views(vrid, before_doc, after_doc, action, c)
    # view-row events see the record DATA (no id field) — the reference's
    # run_triggers builds the cursor from Record.data, where the id lives
    # in the key, not the value
    def _strip(d):
        if isinstance(d, dict) and "id" in d:
            d = {k: v for k, v in d.items() if k != "id"}
        return d

    run_events(vrid, _strip(before_doc), _strip(after_doc), action, c)


def _get_row_state(view_tdef, analysis, group, ctx):
    from surrealdb_tpu_torch.kvs.api import deserialize

    vrid, vkey, mkey = _row_keys(view_tdef, group, ctx)
    raw = ctx.txn.get(vkey)
    row = deserialize(raw) if raw is not None else None
    stats = ctx.txn.get_val(mkey)
    return vrid, row, stats


def _view_create(view_tdef, analysis, group, doc, ctx):
    vrid, row, stats = _get_row_state(view_tdef, analysis, group, ctx)
    action = "UPDATE" if row is not None else "CREATE"
    if stats is None:
        stats = new_stats(analysis.aggregations)
    args = _compute_args(analysis, doc, ctx)
    stats_add(stats, args)
    _write_view_row(view_tdef, analysis, group, stats,
                    row if row is not None else NONE, action, ctx)


def _view_delete(view_tdef, analysis, group, doc, ctx):
    vrid, row, stats = _get_row_state(view_tdef, analysis, group, ctx)
    if row is None or stats is None:
        return
    count = stats_count(stats)
    if count is not None and count <= 1:
        ns, db = ctx.need_ns_db()
        _vrid, vkey, mkey = _row_keys(view_tdef, group, ctx)
        ctx.txn.delete(vkey)
        ctx.txn.delete(mkey)
        ctx.record_cache.pop((view_tdef.name, K.enc_value(vrid.id)), None)
        _fire_triggers(vrid, row, NONE, "DELETE", ctx)
        return
    args = _compute_args(analysis, doc, ctx)
    recalc = stats_remove(stats, args)
    _recalculate(view_tdef, analysis, group, stats, recalc, ctx)
    _write_view_row(view_tdef, analysis, group, stats, row, "UPDATE", ctx)


def _view_update(view_tdef, analysis, group, before, after, ctx):
    vrid, row, stats = _get_row_state(view_tdef, analysis, group, ctx)
    if row is None or stats is None:
        # first sighting of this group (e.g. view defined before writes)
        _view_create(view_tdef, analysis, group, after, ctx)
        return
    bargs = _compute_args(analysis, before, ctx)
    aargs = _compute_args(analysis, after, ctx)
    recalc = stats_update(stats, bargs, aargs)
    _recalculate(view_tdef, analysis, group, stats, recalc, ctx)
    _write_view_row(view_tdef, analysis, group, stats, row, "UPDATE", ctx)


def _recalculate(view_tdef, analysis, group, stats, recalc, ctx):
    """Re-derive min/max stats by scanning the group's source rows
    (reference builds a SELECT over the source with the group condition)."""
    if not recalc:
        return
    from surrealdb_tpu_torch.exec.document import view_source_tables
    from surrealdb_tpu_torch.kvs.api import deserialize
    from surrealdb_tpu_torch.val import value_eq

    ns, db = ctx.need_ns_db()
    values_per_stat: dict = {i: [] for i in recalc}
    for src in view_source_tables(view_tdef.view):
        beg, end = K.prefix_range(K.record_prefix(ns, db, src))
        for _k, raw in ctx.txn.scan(beg, end):
            doc = deserialize(raw)
            if not _cond_ok(analysis, doc, ctx):
                continue
            g = _compute_group(analysis, doc, ctx)
            if len(g) != len(group) or not all(
                value_eq(x, y) for x, y in zip(g, group)
            ):
                continue
            args = _compute_args(analysis, doc, ctx)
            for i in recalc:
                values_per_stat[i].append(args[stats[i]["arg"]])
    for i in recalc:
        vals = [v for v in values_per_stat[i] if v is not NONE]
        s = stats[i]
        if not vals:
            continue  # source unavailable (DROP) — keep the old extremum
        if s["k"] in ("nmax", "tmax"):
            s["max"] = max(vals)
        else:
            s["min"] = min(vals)
