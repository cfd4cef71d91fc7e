"""Statement execution (reference: core/src/dbs/executor.rs + exec/planner.rs
SELECT pipeline Scan→Filter→Split→Aggregate→Sort→Limit; write statements run
the document pipeline in exec/document.py)."""

from __future__ import annotations

import random as _random
import time

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.catalog import (
    AccessDef,
    AnalyzerDef,
    DatabaseDef,
    EventDef,
    FieldDef,
    FunctionDef,
    IndexDef,
    NamespaceDef,
    ParamDef,
    SequenceDef,
    SubscriptionDef,
    TableDef,
    UserDef,
)
from surrealdb_tpu_torch.err import (
    BreakException,
    ContinueException,
    NotPorted,
    ReturnException,
    SdbError,
    ThrownError,
)
from surrealdb_tpu_torch.exec.coerce import coerce
from surrealdb_tpu_torch.exec.context import Ctx
from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record, walk
from surrealdb_tpu_torch.expr.ast import *  # noqa: F401,F403
from surrealdb_tpu_torch.val import (
    NONE,
    Range,
    RecordId,
    Table,
    Uuid,
    copy_value,
    is_truthy,
    render,
    sort_key,
    value_cmp,
)

# ---------------------------------------------------------------------------
# statement dispatch (expression position)
# ---------------------------------------------------------------------------


def eval_statement(node, ctx: Ctx):
    t = type(node)
    fn = _STMTS.get(t)
    if fn is not None:
        if isinstance(node, (DefineNamespace, DefineDatabase, DefineTable,
                             DefineField, DefineIndex, DefineEvent,
                             DefineAnalyzer, DefineUser, DefineAccess,
                             DefineModule,
                             DefineSequence, DefineConfig, DefineParam,
                             DefineFunction, RemoveStmt,
                             InfoStmt, RebuildIndex)):
            node = _ddl_resolve(node, ctx)
        return fn(node, ctx)
    return evaluate(node, ctx)


def _ddl_resolve(n, ctx: Ctx):
    """Materialize expression-valued DDL attributes — names, ON tables,
    comments, durations — at execution time. Reference: parameterized
    schema statements (language-tests/tests/language/parameterized/schema)
    compute each name/comment Expr in the DefineStatement itself."""
    import dataclasses

    changes = {}
    for a in ("name", "tb", "comment", "batch", "start", "target", "target2"):
        v = getattr(n, a, None)
        if not isinstance(v, Node):
            continue
        rv = evaluate(v, ctx)
        if a == "comment":
            changes[a] = None if rv is NONE else rv
        elif a in ("batch", "start"):
            if not isinstance(rv, int) or isinstance(rv, bool):
                raise SdbError(f"Expected an int but found {render(rv)}")
            changes[a] = rv
        else:
            if not isinstance(rv, str):
                raise SdbError(
                    f"Expected a string but found {render(rv)}"
                )
            changes[a] = rv
    dur = getattr(n, "duration", None)
    if isinstance(dur, dict) and any(isinstance(x, Node) for x in dur.values()):
        changes["duration"] = {
            k: (evaluate(x, ctx) if isinstance(x, Node) else x)
            for k, x in dur.items()
        }
    cfg = getattr(n, "config", None)
    if isinstance(cfg, dict):
        newcfg = {
            k: (evaluate(x, ctx) if isinstance(x, Node) and k in
                ("key", "name", "backend", "issuer_key", "path", "comment",
                 "namespace", "database")
                else x)
            for k, x in cfg.items()
        }
        if newcfg.get("comment") is NONE:
            newcfg["comment"] = None
        if newcfg != cfg:
            changes["config"] = newcfg
    if changes:
        n = dataclasses.replace(n, **changes)
    # a $param field name is a whole idiom string ("a.b") — parse it
    if (isinstance(n, DefineField) or
            (isinstance(n, RemoveStmt) and n.kind == "field")) and \
            isinstance(n.name, str):
        from surrealdb_tpu_torch.syn.parser import Parser

        n = dataclasses.replace(n, name=Parser(n.name)._field_name_parts())
    return n


# ---------------------------------------------------------------------------
# simple statements
# ---------------------------------------------------------------------------


def _s_let(n: LetStmt, ctx):
    if n.name in ("access", "auth", "token", "session"):
        # reference cnf PROTECTED_PARAM_NAMES
        raise SdbError(
            f"'{n.name}' is a protected variable and cannot be set"
        )
    v = evaluate(n.what, ctx)
    if n.kind is not None:
        try:
            v = coerce(v, n.kind)
        except SdbError as e:
            raise SdbError(
                f"Tried to set `${n.name}`, but couldn't coerce value: {e}"
            )
    ctx.vars[n.name] = v
    return NONE


def _s_return(n: ReturnStmt, ctx):
    v = evaluate(n.what, ctx)
    if n.fetch:
        v = apply_fetch(v, n.fetch, ctx)
    raise ReturnException(v)


def _s_if(n: IfStmt, ctx):
    for cond, body in n.branches:
        if is_truthy(evaluate(cond, ctx)):
            return eval_statement(body, ctx)
    if n.otherwise is not None:
        return eval_statement(n.otherwise, ctx)
    return NONE


def _s_for(n: ForStmt, ctx):
    rng = evaluate(n.range, ctx)
    if isinstance(rng, Range):
        try:
            items = list(rng.iter_ints())
        except TypeError:
            raise SdbError("FOR range must have integer bounds")
    elif isinstance(rng, list):
        items = rng
    elif isinstance(rng, dict):
        items = list(rng.values())
    else:
        raise SdbError(f"Cannot iterate over {render(rng)} in a FOR loop")
    for item in items:
        c = ctx.child()
        c.vars[n.param] = item
        try:
            eval_statement(n.body, c)
        except BreakException:
            break
        except ContinueException:
            continue
    return NONE


def _s_break(n, ctx):
    raise BreakException()


def _s_continue(n, ctx):
    raise ContinueException()


def _s_throw(n: ThrowStmt, ctx):
    from surrealdb_tpu_torch.exec.operators import to_string

    raise ThrownError(f"An error occurred: {to_string(evaluate(n.what, ctx))}")


def _s_sleep(n: SleepStmt, ctx):
    from surrealdb_tpu_torch.val import Duration

    d = evaluate(n.duration, ctx)
    if isinstance(d, Duration):
        # sliced so KILL / deadline expiry interrupts within ~50ms
        # instead of parking the worker for the whole duration
        end = time.monotonic() + min(d.to_seconds(), 30)
        while True:
            ctx.check_deadline()
            left = end - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(left, 0.05))
    return NONE


def _s_use(n: UseStmt, ctx):
    # empty-string namespaces/databases are legal (`USE NS ```)
    if n.ns is not None:
        ctx.session.ns = n.ns
        ctx.ns = n.ns
    if n.db is not None:
        ctx.session.db = n.db
        ctx.db = n.db
    return {
        "database": ctx.session.db if ctx.session.db is not None else NONE,
        "namespace": ctx.session.ns if ctx.session.ns is not None else NONE,
    }


def _s_option(n, ctx):
    if n.name.upper() == "IMPORT":
        # OPTION IMPORT: subsequent DEFINEs overwrite by default (import
        # streams re-define tables/fields; reference dbs/options.rs).
        # Scoped to THIS query run (the executor), not the session.
        if ctx.executor is not None:
            ctx.executor.import_mode = bool(n.value)
    return NONE


# ---------------------------------------------------------------------------
# target resolution — what a FROM/UPDATE/DELETE target yields
# ---------------------------------------------------------------------------


class Source:
    """One input row: a record (rid + doc) or a plain value. `_cols`
    holds per-row vectorized-expression values (exec/stream.py
    ColumnCache) — row-lifetime storage, so recycled object ids can't
    alias rows."""

    __slots__ = ("rid", "doc", "value", "_cols")

    def __init__(self, rid=None, doc=None, value=NONE):
        self.rid = rid
        self.doc = doc
        self.value = value
        self._cols = None


def _target_value(expr, ctx):
    """Evaluate a FROM target; bare idents become Tables."""
    if isinstance(expr, Idiom) and len(expr.parts) == 1 and isinstance(
        expr.parts[0], PField
    ):
        return Table(expr.parts[0].name)
    v = evaluate(expr, ctx)
    return v


def iterate_targets(what: list, ctx: Ctx, cond=None, stmt=None):
    """Yield Source objects for each target (reference dbs/iterator.rs
    Iterable collection)."""
    for expr in what:
        v = _target_value(expr, ctx)
        yield from _iterate_value(v, ctx, cond, stmt)


def _iterate_value(v, ctx, cond=None, stmt=None):
    ns, db = ctx.need_ns_db()
    if isinstance(v, Table):
        yield from _scan_table(v.name, ctx, cond, stmt)
    elif isinstance(v, RecordId):
        if isinstance(v.id, Range):
            yield from _scan_record_range(v, ctx)
        else:
            doc = fetch_record(ctx, v)
            yield Source(rid=v, doc=doc if doc is not NONE else NONE)
    elif isinstance(v, list):
        for x in v:
            yield from _iterate_value(x, ctx, cond, stmt)
    elif isinstance(v, dict):
        # objects are used as-is in SELECT; write statements resolve the id
        # themselves (reference prepare_computed: SELECT check happens first)
        yield Source(value=v)
    elif v is NONE or v is None:
        return
    else:
        yield Source(value=v)


def _scan_table(tb: str, ctx, cond=None, stmt=None):
    """Table scan — consults the index planner first (idx/planner.rs)."""
    from surrealdb_tpu_torch.exec.eval import apply_computed_fields, computed_fields_of
    from surrealdb_tpu_torch.idx.planner import plan_scan

    # the reference errors when scanning a table that was never defined
    # (language/statements/for/break_in_function.surql et al.)
    _ns0, _db0 = ctx.need_ns_db()
    if ctx.txn.get(K.tb_def(_ns0, _db0, tb)) is None:
        raise SdbError(f"The table '{tb}' does not exist")

    plan = plan_scan(tb, cond, ctx, stmt)
    if plan is not None:
        yield from plan
        return
    ns, db = ctx.need_ns_db()
    from surrealdb_tpu_torch.kvs.api import deserialize

    has_computed = bool(computed_fields_of(tb, ctx))
    pre = K.record_prefix(ns, db, tb)
    beg, end = K.prefix_range(pre)
    plen = len(pre)
    for k, raw in ctx.txn.scan(beg, end):
        # the prefix pins (ns, db, tb): only the id needs decoding
        idv, _pos = K.dec_value(k, plen)
        rid = RecordId(tb, idv)
        doc = deserialize(raw)
        if has_computed:
            doc = apply_computed_fields(tb, doc, rid, ctx)
        yield Source(rid=rid, doc=doc)


def _scan_record_range(v: RecordId, ctx):
    ns, db = ctx.need_ns_db()
    rng: Range = v.id
    from surrealdb_tpu_torch.kvs.api import deserialize

    if rng.beg is NONE:
        beg = K.record_prefix(ns, db, v.tb)
    else:
        beg = K.record(ns, db, v.tb, rng.beg)
        if not rng.beg_incl:
            beg += b"\x00"
    if rng.end is NONE:
        _, end = K.prefix_range(K.record_prefix(ns, db, v.tb))
    else:
        end = K.record(ns, db, v.tb, rng.end)
        if rng.end_incl:
            end += b"\xff"
    plen = len(K.record_prefix(ns, db, v.tb))
    for k, raw in ctx.txn.scan(beg, end):
        idv, _pos = K.dec_value(k, plen)
        yield Source(rid=RecordId(v.tb, idv), doc=deserialize(raw))


# ---------------------------------------------------------------------------
# permissions
# ---------------------------------------------------------------------------


def check_table_permission(tb: str, action: str, ctx: Ctx, doc=None, rid=None):
    """Row-level permission check (doc/check + scan operators). Returns
    truthy if the action is allowed for the session on this doc."""
    if ctx.session.is_owner or ctx.session.auth_level in ("editor",):
        return True
    if ctx._in_perm_check:
        # permission clauses evaluate with permissions disabled
        # (reference opt.new_with_perms(false)) — cyclic record links in
        # a predicate subquery must not recurse into more checks
        return True
    ns, db = ctx.need_ns_db()
    tdef = ctx.txn.get_val(K.tb_def(ns, db, tb))
    if tdef is None or tdef.permissions is None:
        return ctx.session.auth_level == "viewer" and action == "select"
    p = tdef.permissions.get(action, False)
    if p is True or p is False:
        return p
    c = ctx.with_doc(doc, rid)
    c._in_perm_check = True
    return is_truthy(evaluate(p, c))


# ---------------------------------------------------------------------------
# SELECT
# ---------------------------------------------------------------------------

_AGGREGATES = {
    "count", "math::sum", "math::mean", "math::min", "math::max",
    "math::stddev", "math::variance", "math::median", "math::mode",
    "math::product", "math::spread", "math::interquartile", "math::midhinge",
    "math::trimean", "math::bottom", "math::top", "math::percentile",
    "math::nearestrank", "time::min", "time::max", "array::group",
    "array::distinct", "array::flatten", "array::concat", "array::first",
    "array::last", "array::len", "array::max", "array::min", "array::sort",
    "array::join",
}


def _is_aggregate(expr) -> bool:
    if isinstance(expr, FunctionCall):
        if expr.name.lower() in _AGGREGATES:
            return True
        return any(_is_aggregate(a) for a in expr.args)
    if isinstance(expr, Binary):
        return _is_aggregate(expr.lhs) or _is_aggregate(expr.rhs)
    if isinstance(expr, Prefix):
        return _is_aggregate(expr.expr)
    return False


def expr_name(expr, sql=False) -> str:
    """Canonical output field name for an unaliased projection. sql=True
    renders for SQL output (reserved idents get backticks)."""
    if isinstance(expr, Idiom):
        from surrealdb_tpu_torch.val import escape_ident as _esc

        out = []
        for p in expr.parts:
            if isinstance(p, tuple):
                out.append(expr_name(p[1], sql))
            elif isinstance(p, PField):
                # `@` is the repeat-subject marker, never escaped
                name = p.name if p.name == "@" else (
                    _esc(p.name) if sql else p.name
                )
                if out:
                    out.append("." + name)
                else:
                    out.append(name)
            elif isinstance(p, PRecurse):
                if p.min == p.max and p.min is not None:
                    rng = str(p.min)
                elif p.max is None:
                    rng = ".." if p.min in (None, 1) else f"{p.min}.."
                elif p.min in (None, 1):
                    rng = f"..{p.max}"
                else:
                    rng = f"{p.min}..{p.max}"
                ins = f"+{p.instruction}" if p.instruction else ""
                txt = ("." if out else "") + "{" + rng + ins + "}"
                inner = list(p.parts or [])
                if inner and all(
                    isinstance(x, PDestructure) for x in inner
                ):
                    txt += expr_name(Idiom(inner), sql)
                elif inner:
                    txt += "(" + expr_name(Idiom(inner), sql) + ")"
                out.append(txt)
            elif isinstance(p, PDestructure):
                fields = []
                for nm, wh in p.fields:
                    if wh is None:
                        fields.append(nm)
                    else:
                        sub_i = wh if isinstance(wh, Idiom) \
                            else Idiom(list(wh))
                        fields.append(f"{nm}: {expr_name(sub_i, sql)}")
                out.append(
                    ("." if out else "") + "{ " + ", ".join(fields) + " }"
                )
            elif isinstance(p, PAll):
                out.append(".*" if out else "*")
            elif isinstance(p, PIndex):
                out.append(f"[{expr_name(p.expr)}]")
            elif isinstance(p, PLast):
                out.append("[$]")
            elif isinstance(p, PGraph):
                arrow = {"out": "->", "in": "<-", "both": "<->", "ref": "<~"}[p.dir]
                if p.alias is not None:
                    aname = p.alias if isinstance(p.alias, str) \
                        else expr_name(p.alias, sql)
                    # ->(edge AS name): the step names the output field
                    out.append(("." if out else "") + aname)
                    continue
                if p.expr is not None:
                    from surrealdb_tpu_torch.exec.render_def import _select_sql

                    out.append(f"{arrow}({_select_sql(p.expr)})")
                    continue
                names = ", ".join(w[0] for w in p.what) if p.what else "?"
                if len(p.what) <= 1:
                    out.append(f"{arrow}{names}")
                else:
                    out.append(f"{arrow}({names})")
            elif isinstance(p, PWhere):
                out.append("[WHERE]")
            elif isinstance(p, PMethod):
                out.append(f".{p.name}()")
            elif isinstance(p, PFlatten):
                out.append("…")
            else:
                out.append("")
        return "".join(out)
    if isinstance(expr, FunctionCall):
        return expr.name
    if isinstance(expr, Literal):
        return render(expr.value)
    if isinstance(expr, Param):
        return expr.name
    if isinstance(expr, Binary):
        # compound names render nested calls with their arguments
        # ("math::mean(v) + 1"), unlike bare top-level calls
        def sub(e):
            if isinstance(e, FunctionCall):
                from surrealdb_tpu_torch.exec.render_def import _expr_sql

                return _expr_sql(e)
            return expr_name(e, sql)

        return f"{sub(expr.lhs)} {expr.op} {sub(expr.rhs)}"
    if isinstance(expr, Cast):
        return expr_name(expr.expr)
    if isinstance(expr, Subquery):
        return "subquery"
    if isinstance(expr, RecordIdLit):
        return expr.tb
    if isinstance(expr, Knn):
        return expr_name(expr.lhs)
    return "field"


def _ast_params(node, out, _depth=0, _in_sub=False):
    """Collect Param names referenced anywhere in an AST fragment. Inside a
    SELECT subquery $this refers to the subquery's own document, but
    $parent still points at the enclosing (grouped) document, so only
    `parent` is collected there; deeper subqueries re-bind it."""
    import dataclasses

    from surrealdb_tpu_torch.expr.ast import Param as _Param, Subquery as _Sub

    if _depth > 40 or node is None:
        return
    if isinstance(node, _Param):
        if not _in_sub:
            out.add(node.name)
        elif node.name == "parent":
            out.add("parent")
        return
    if isinstance(node, _Sub) and isinstance(node.stmt, SelectStmt):
        if not _in_sub:
            _ast_params(node.stmt, out, _depth + 1, True)
        return
    if isinstance(node, (list, tuple)):
        for x in node:
            _ast_params(x, out, _depth + 1, _in_sub)
        return
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _ast_params(getattr(node, f.name), out, _depth + 1, _in_sub)


def _check_group_params(n):
    """Grouped selects have no document for $this/$parent to refer to
    (reference catalog/aggregation.rs AggregateExprCollector)."""
    names: set = set()
    for expr, _a in n.exprs:
        if expr != "*":
            _ast_params(expr, names)
    if n.value is not None:
        _ast_params(n.value, names)
    if "this" in names or "self" in names:
        raise SdbError(
            "Invalid query: Found a `$this` parameter refering to the "
            "document of a group by select statement\n"
            "Select statements with a group by currently have no defined "
            "document to refer to"
        )
    if "parent" in names:
        raise SdbError(
            "Invalid query: Found a `$parent` parameter refering to the "
            "document of a GROUP select statement\n"
            "Select statements with a GROUP BY or GROUP ALL currently have "
            "no defined document to refer to"
        )


def _s_select(n: SelectStmt, ctx: Ctx):
    ctx.check_deadline()
    c = _timeout_ctx(n, ctx)
    if c is ctx:
        c = ctx.child()
    if n.group is not None:
        _check_group_params(n)
    if n.explain:
        raise NotPorted("EXPLAIN is not ported")
    # VERSION clause
    if n.version is not None:
        raise NotPorted("VERSION reads are not ported")
    # streaming batched operator engine (execution engine A) for eligible
    # plain-scan shapes; everything else stays on the legacy recursive
    # path (reference plan_or_compute.rs legacy fallback)
    from surrealdb_tpu_torch.exec.stream import _UNSUPPORTED, try_stream_select

    out = try_stream_select(n, c)
    if out is not _UNSUPPORTED:
        return out
    rows = []
    perms = not c.session.is_owner
    for src in iterate_targets(n.what, c, n.cond, n):
        c.check_deadline()
        if src.rid is not None and src.doc is NONE:
            # direct record fetch that doesn't exist -> no row
            continue
        if perms and src.rid is not None:
            if not check_table_permission(src.rid.tb, "select", c, src.doc, src.rid):
                continue
            from surrealdb_tpu_torch.exec.document import reduce_fields

            if isinstance(src.doc, dict):
                src.doc = reduce_fields(src.rid.tb, src.doc, c)
        rows.append(src)
    # brute-force KNN over multiple FROM sources: each table contributed its
    # own top-k; the KnnTopK aggregate is global, so trim the union back to
    # the k nearest (top-k of a union ⊆ union of per-source top-ks)
    bk = getattr(c, "_brute_knn_k", None)
    if bk is not None and c.knn and len(rows) > bk:
        from surrealdb_tpu_torch.idx.planner import hashable

        rows.sort(
            key=lambda s: c.knn.get(hashable(s.rid), float("inf"))
            if s.rid is not None else float("inf")
        )
        rows = rows[:bk]
    n = _expand_field_projections(n, c)
    return _select_pipeline(n, rows, c)


def select_over_sources(n: SelectStmt, sources, ctx: Ctx):
    """Run a SELECT over pre-resolved sources (graph/reference lookup
    subqueries: `->(SELECT ...)` / `<~(SELECT ...)`)."""
    c = ctx.child()
    c._cond_consumed = False
    rows = list(sources)
    if not c.session.is_owner:
        rows = [
            src
            for src in rows
            if src.rid is None
            or check_table_permission(src.rid.tb, "select", c, src.doc, src.rid)
        ]
    return _select_pipeline(n, rows, c)


def _eval_limits(n, ctx):
    """Evaluate LIMIT/START exactly once: (ok, keep, lim, off). keep is
    the top-k bound (LIMIT+START, both non-negative) or None; lim/off
    are the evaluated ints to slice with (only valid when ok). On an
    evaluation error ok=False — the slicing below re-evaluates and
    raises at the legacy position (after the sort). Volatile LIMIT
    expressions must not evaluate twice: the sliced values are the SAME
    ints the heap was bounded with."""
    try:
        lim = int(evaluate(n.limit, ctx)) if n.limit is not None else None
        off = int(evaluate(n.start, ctx)) if n.start is not None else None
    except Exception:
        return False, None, None, None
    keep = None
    if lim is not None and lim >= 0 and (off or 0) >= 0:
        # negative slices keep python slice semantics (no heap)
        keep = lim + (off or 0)
    return True, keep, lim, off


def _select_pipeline(n: SelectStmt, rows, c):
    # WHERE (if planner didn't consume it, re-filter — planner marks via attr)
    if n.cond is not None and not getattr(c, "_cond_consumed", False):
        kept = []
        for src in rows:
            doc = src.doc if src.rid is not None else src.value
            cc = c.with_doc(doc, src.rid)
            cc.knn = c.knn
            if is_truthy(evaluate(n.cond, cc)):
                kept.append(src)
        rows = kept
    # SPLIT
    for sp in n.split:
        rows = _apply_split(rows, sp, c)

    # alias map: ORDER BY / GROUP BY may reference projection aliases
    aliases = {}
    for expr, alias in n.exprs:
        if expr == "*":
            continue
        aliases[alias or expr_name(expr)] = expr
    if n.value is not None and getattr(n, "value_alias", None):
        aliases[n.value_alias] = n.value
    # GROUP BY
    if n.group is not None:
        if any(e == "*" for e, _a in n.exprs):
            raise SdbError(
                "Invalid query: Incorrect selector for aggregate "
                "selection, expression `*` within in selector cannot "
                "be aggregated in a group."
            )
        # GROUP ALL over zero cond-matched rows: the legacy engine emits
        # nothing; the streaming executor emits the count-0 row
        empty_row = n.cond is None or (
            getattr(c.session, "planner_strategy", None) == "all-ro"
        )
        if not rows and not c.session.is_owner and \
                c.session.auth_level != "editor":
            # a hard PERMISSIONS NONE table suppresses the GROUP ALL row
            for w in n.what:
                try:
                    v = _target_value(w, c)
                except SdbError:
                    continue
                tbn = v.name if isinstance(v, Table) else (
                    v.tb if isinstance(v, RecordId) else None)
                if tbn is None:
                    continue
                ns_, db_ = c.need_ns_db()
                tdef = c.txn.get_val(K.tb_def(ns_, db_, tbn))
                if tdef is not None and tdef.permissions is not None and                         tdef.permissions.get("select") is False:
                    empty_row = False
        out_rows = _apply_group(rows, n, c, aliases, empty_row)
        lok, keep, lim, off = _eval_limits(n, c)
        if n.order and n.order != "rand":
            out_rows = _apply_order(out_rows, n.order, c, keep=keep)
        elif n.order == "rand":
            _stmt_rng(c).shuffle(out_rows)
        if n.start is not None:
            out_rows = out_rows[
                off if lok else int(evaluate(n.start, c)) :]
        if n.limit is not None:
            out_rows = out_rows[
                : lim if lok else int(evaluate(n.limit, c))]
    else:
        # ORDER BY on the underlying rows (aliases resolve to their exprs)
        lok, keep, lim, off = _eval_limits(n, c)
        if n.order == "rand":
            _stmt_rng(c).shuffle(rows)
        elif n.order:
            rows = _apply_order_sources(rows, n.order, c, aliases,
                                        keep=keep)
        if n.start is not None:
            rows = rows[off if lok else int(evaluate(n.start, c)) :]
        if n.limit is not None:
            rows = rows[: lim if lok else int(evaluate(n.limit, c))]
        # VALUE selectors see omitted docs (the scalar output can't be
        # pruned later); ORDER BY above still saw the full documents
        if n.omit and n.value is not None:
            omits_v = _expand_omits(n.omit, c)
            for src in rows:
                doc = src.doc if src.rid is not None else src.value
                if isinstance(doc, dict):
                    doc = copy_value(doc)
                    for om in omits_v:
                        _omit_path(doc, om, c)
                    if src.rid is not None:
                        src.doc = doc
                    else:
                        src.value = doc
        out_rows = [_project(src, n, c) for src in rows]
    # OMIT applies to the OUTPUT records (reference pluck stage): after
    # grouping/projection, so omitted group keys still group and omitted
    # projected fields disappear entirely
    if n.omit and n.value is None:
        omits = _expand_omits(n.omit, c)
        pruned = []
        for r in out_rows:
            if isinstance(r, dict):
                r = copy_value(r)
                for om in omits:
                    _omit_path(r, om, c)
            pruned.append(r)
        out_rows = pruned
    # FETCH
    if n.fetch:
        out_rows = [apply_fetch(r, n.fetch, c) for r in out_rows]
    if n.only:
        # target-level check: FROM ONLY NONE / [] / [a, b] error outright —
        # but a LIMIT 1 caps the stream before the check (reference
        # select.rs); zero ROWS from a valid single target return NONE
        limited_to_one = (
            n.limit is not None and int(evaluate(n.limit, c)) == 1
        )
        if len(n.what) == 1:
            tv = _target_value(n.what[0], c)
            too_many = (
                isinstance(tv, list) and len(tv) > 1 and not limited_to_one
            )
            if tv is NONE or tv is None or too_many or (
                isinstance(tv, list) and len(tv) == 0
            ):
                raise SdbError(
                    "Expected a single result output when using the ONLY keyword"
                )
        if len(out_rows) == 1:
            return out_rows[0]
        if len(out_rows) == 0:
            return NONE
        raise SdbError(
            "Expected a single result output when using the ONLY keyword"
        )
    return out_rows


def _expand_field_projections(n, ctx):
    """type::field()/type::fields() projections expand to the named
    idioms at execution (reference: functions/type/field suite)."""
    if n.value is not None or not n.exprs:
        return n
    hit = any(
        isinstance(e, FunctionCall)
        and e.name in ("type::field", "type::fields")
        for e, _a in n.exprs if e != "*"
    )
    if not hit:
        return n
    from surrealdb_tpu_torch.syn.parser import Parser
    import copy as _copy

    out = []
    for e, a in n.exprs:
        if not (isinstance(e, FunctionCall)
                and e.name in ("type::field", "type::fields")):
            out.append((e, a))
            continue
        v = evaluate(e.args[0], ctx) if e.args else NONE
        names = v if e.name == "type::fields" else [v]
        if not isinstance(names, list):
            raise SdbError(
                f"Incorrect arguments for function {e.name}(). Argument 1 "
                f"was the wrong type. Expected `array` but found "
                f"`{render(names)}`"
            )
        for nm in names:
            if not isinstance(nm, str):
                raise SdbError(
                    f"Incorrect arguments for function {e.name}(). "
                    f"Argument 1 was the wrong type. Expected `string` "
                    f"but found `{render(nm)}`"
                )
            out.append((Idiom(Parser(nm)._field_name_parts()), a))
    n2 = _copy.copy(n)
    n2.exprs = out
    return n2


def _expand_omits(omit, ctx):
    """Evaluate type::field()/type::fields() OMIT entries into idioms
    once per statement (reference: parameterized/select.surql)."""
    out = []
    for om in omit:
        if isinstance(om, FunctionCall) and om.name in (
                "type::field", "type::fields"):
            from surrealdb_tpu_torch.syn.parser import Parser

            v = evaluate(om.args[0], ctx) if om.args else NONE
            names = v if om.name == "type::fields" else [v]
            if not isinstance(names, list):
                continue
            for s in names:
                if isinstance(s, str):
                    out.append(Idiom(Parser(s)._field_name_parts()))
        else:
            out.append(om)
    return out


def _omit_path(doc, om, ctx=None):
    """Remove an OMIT path; `.{a, b}` destructure suffixes expand to the
    listed subpaths (reference idiom omit semantics)."""
    if not isinstance(om, Idiom):
        return
    _omit_parts(doc, om.parts)


def _omit_parts(doc, parts):
    if not parts:
        return
    part = parts[0]
    if isinstance(part, PField):
        if isinstance(doc, list):
            for item in doc:
                _omit_parts(item, parts)
            return
        if not isinstance(doc, dict):
            return
        if len(parts) == 1:
            doc.pop(part.name, None)
        else:
            _omit_parts(doc.get(part.name), parts[1:])
    elif isinstance(part, PDestructure):
        for name, sub in part.fields:
            if sub is None:
                _omit_parts(doc, [PField(name)])
            elif isinstance(sub, Idiom):
                subparts = [
                    p for p in sub.parts if not isinstance(p, tuple)
                ]
                _omit_parts(doc, [PField(name)] + subparts)
    elif isinstance(part, PAll):
        if len(parts) == 1:
            if isinstance(doc, (dict, list)):
                doc.clear()
            return
        if isinstance(doc, dict):
            for v in doc.values():
                _omit_parts(v, parts[1:])
        elif isinstance(doc, list):
            for item in doc:
                _omit_parts(item, parts[1:])


def _dynamic_field_key(expr, ctx):
    """Unaliased `type::field($p)` projections key by the RESOLVED field
    name (functions/type/field/..._variable_fields_projection)."""
    if isinstance(expr, FunctionCall) and expr.name == "type::field" \
            and expr.args:
        try:
            k = evaluate(expr.args[0], ctx)
        except SdbError:
            return None
        if isinstance(k, str):
            return k
    return None


def _project(src: Source, n: SelectStmt, ctx: Ctx):
    doc = src.doc if src.rid is not None else src.value
    c = ctx.with_doc(doc, src.rid)
    c.knn = ctx.knn
    if n.value is not None:
        try:
            return evaluate(n.value, c)
        except ReturnException as r:
            # a RETURN inside the projection expr yields that row's value
            # (reference catch_return at projection boundaries)
            return r.value
    out = {}
    star = False
    for expr, alias in n.exprs:
        if expr == "*":
            star = True
            if isinstance(doc, dict):
                for k, v in doc.items():
                    out[k] = copy_value(v)
            elif doc is not NONE and doc is not None and not isinstance(doc, dict):
                # SELECT * FROM scalar -> the scalar itself
                if len(n.exprs) == 1:
                    return copy_value(doc)
            continue
        v = evaluate(expr, c)
        if alias:
            _set_out_field(out, alias, v)
        else:
            dynk = _dynamic_field_key(expr, c)
            if dynk is not None:
                _set_out_field(out, dynk, v)
                continue
            segs = _idiom_segments(expr, c)
            if segs is not None:
                _set_nested_out(out, segs, v)
            else:
                _set_out_field(out, expr_name(expr), v)
    if not n.exprs and not star:
        return copy_value(doc)
    return out


def _idiom_segments(expr, ctx=None):
    """Nesting segments for an unaliased idiom projection (reference
    Value::set pluck semantics): field and graph parts nest; any other
    trailing part attaches at the last segment. None = not an idiom."""
    if not isinstance(expr, Idiom):
        return None
    segs = []
    for p in expr.parts:
        if isinstance(p, PField):
            segs.append(p.name)
        elif isinstance(p, PGraph):
            arrow = {"out": "->", "in": "<-", "both": "<->", "ref": "<~"}[p.dir]
            if getattr(p, "alias", None) is not None:
                # ->(edge AS name) names the output segment
                segs.append(p.alias if isinstance(p.alias, str)
                            else expr_name(p.alias))
                continue
            if getattr(p, "expr", None) is not None:
                from surrealdb_tpu_torch.exec.render_def import _select_sql

                segs.append(f"{arrow}({_select_sql(p.expr)})")
                continue
            names = ", ".join(w[0] for w in p.what) if p.what else "?"
            if len(p.what) <= 1:
                segs.append(f"{arrow}{names}")
            else:
                segs.append(f"{arrow}({names})")
        # every other part kind (index, where, value, all, ...) is dropped
        # from the output name, later field parts still nest (reference
        # Idiom::simplify, expr/idiom/mod.rs:75 keeps Field/Start/Lookup)
    if not segs:
        return None
    return segs


def _set_nested_out(out, segs: list, v):
    """Set a value at a nested path; arrays distribute over their elements
    (the computed value replaces whatever the deeper levels held)."""
    cur = out
    for i, s in enumerate(segs[:-1]):
        if isinstance(cur, list):
            for item in cur:
                if isinstance(item, dict):
                    _set_nested_out(item, segs[i:], v)
            return
        if not isinstance(cur, dict):
            return
        nxt = cur.get(s)
        if not isinstance(nxt, (dict, list)):
            nxt = {}
            cur[s] = nxt
        cur = nxt
    if isinstance(cur, list):
        for item in cur:
            if isinstance(item, dict):
                item[segs[-1]] = copy_value(v)
        return
    if isinstance(cur, dict):
        cur[segs[-1]] = v


def _set_out_field(out: dict, name: str, v):
    # alias paths like a.b create nested objects
    if "." in name and not name.startswith("("):
        segs = name.split(".")
        cur = out
        for s in segs[:-1]:
            nxt = cur.get(s)
            if not isinstance(nxt, dict):
                nxt = {}
                cur[s] = nxt
            cur = nxt
        cur[segs[-1]] = v
    else:
        out[name] = v


def _apply_split(rows, sp, ctx):
    out = []
    name = expr_name(sp) if isinstance(sp, Idiom) else None
    for src in rows:
        doc = src.doc if src.rid is not None else src.value
        c = ctx.with_doc(doc, src.rid)
        v = evaluate(sp, c)
        from surrealdb_tpu_torch.val import SSet as _SSet

        if isinstance(v, _SSet):
            v = list(v.items)
        if isinstance(v, list):
            for item in v:
                nd = copy_value(doc) if isinstance(doc, dict) else {}
                if name:
                    _set_path(nd, name.split("."), item)
                out.append(Source(rid=src.rid, doc=nd, value=nd))
        else:
            out.append(src)
    return out


def _set_path(doc, segs, v):
    cur = doc
    for s in segs[:-1]:
        nxt = cur.get(s)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[s] = nxt
        cur = nxt
    cur[segs[-1]] = v


def _drop_skipped(results):
    """Filter permission-skipped writes (document.SKIP sentinel)."""
    from surrealdb_tpu_torch.exec.document import SKIP

    return [r for r in results if r is not SKIP]


def _count_only_stmt(n) -> bool:
    return bool(n.exprs) and all(
        _is_aggregate(e) for e, _a in n.exprs if e != "*"
    ) and any(e != "*" for e, _a in n.exprs)


def _apply_group(rows, n: SelectStmt, ctx, aliases=None, empty_row=True):
    from surrealdb_tpu_torch.val import hashable

    if not rows and n.group == []:
        # GROUP ALL over no input: aggregates still emit one row
        # (count: 0) unless the table was hard-denied by permissions
        if empty_row and n.value is None and _count_only_stmt(n):
            row = {}
            for expr, alias in n.exprs:
                if expr == "*":
                    continue
                name = alias if alias else expr_name(expr)
                row[name] = _eval_aggregate(expr, [], ctx)
            return [row]
        return []

    groups: dict = {}
    order = []
    gb = [_resolve_alias(g, aliases) for g in (n.group or [])]
    keyvals: dict = {}
    for src in rows:
        doc = src.doc if src.rid is not None else src.value
        c = ctx.with_doc(doc, src.rid)
        vals = [evaluate(g, c) for g in gb] if gb else []
        key = tuple(hashable(v) for v in vals)
        if key not in groups:
            groups[key] = []
            keyvals[key] = vals
            order.append(key)
        groups[key].append(src)
    # groups emit in key order (the reference collects into an ordered map)
    order.sort(key=lambda k: tuple(sort_key(v) for v in keyvals[k]))
    out = []
    for key in order:
        members = groups[key]
        first = members[0]
        fdoc = first.doc if first.rid is not None else first.value
        fc = ctx.with_doc(fdoc, first.rid)
        if n.value is not None:
            if _is_aggregate(n.value):
                out.append(_eval_aggregate(n.value, members, ctx))
            else:
                out.append(evaluate(n.value, fc))
            continue
        row = {}
        for expr, alias in n.exprs:
            if expr == "*":
                if isinstance(fdoc, dict):
                    row.update(copy_value(fdoc))
                continue
            name = alias if alias else expr_name(expr)
            if _is_aggregate(expr):
                v = _eval_aggregate(expr, members, ctx)
            elif any(expr == g for g in gb):
                v = evaluate(expr, fc)
            else:
                # implicit array::group: the expression evaluates per
                # member row and the results collect into an array
                v = []
                for m in members:
                    d = m.doc if m.rid is not None else m.value
                    mc = ctx.with_doc(d, m.rid)
                    v.append(evaluate(expr, mc))
            _set_out_field(row, name, v)
        out.append(row)
    return out


# the reference's real streaming aggregates (catalog/aggregation.rs
# AggregateExprCollector); other _AGGREGATES entries are ordinary functions
# applied over an implicit Accumulate of their argument, so when their
# argument itself contains an aggregate they act as plain outer calls
_TRUE_AGGS = {
    "count", "math::sum", "math::mean", "math::min", "math::max",
    "math::stddev", "math::variance", "time::min", "time::max",
    "array::group",
}


def _eval_aggregate(expr, members, ctx):
    """Evaluate an aggregate expression over a group of source rows."""
    if (
        isinstance(expr, FunctionCall)
        and expr.name.lower() in _AGGREGATES
        and not (
            expr.name.lower() not in _TRUE_AGGS
            and any(_is_aggregate(a) for a in expr.args)
        )
    ):
        fname = expr.name.lower()
        from surrealdb_tpu_torch.fnc import FUNCS

        if fname == "count" and not expr.args:
            return len(members)
        # collect per-row values of the first argument
        vals = []
        for src in members:
            doc = src.doc if src.rid is not None else src.value
            c = ctx.with_doc(doc, src.rid)
            vals.append(evaluate(expr.args[0], c) if expr.args else NONE)
        if fname == "count":
            return sum(1 for v in vals if is_truthy(v))
        if fname == "math::sum":
            from decimal import Decimal as _D

            from surrealdb_tpu_torch.fnc import FUNCS as _F

            nums = [
                x for x in vals
                if isinstance(x, (int, float, _D))
                and not isinstance(x, bool)
            ]
            if not nums:
                return 0
            return _F["math::sum"]([nums], ctx)
        extra = []
        for a in expr.args[1:]:
            extra.append(evaluate(a, ctx))
        if fname == "array::group":
            # the grouped aggregate collects + flattens WITHOUT dedup
            # (reference Accumulate; array::distinct dedups explicitly)
            flat = []
            for v in vals:
                if isinstance(v, list):
                    flat.extend(v)
                else:
                    flat.append(v)
            return flat
        if fname in ("array::concat", "array::flatten"):
            flat = []
            for v in vals:
                if isinstance(v, list):
                    flat.extend(v)
                else:
                    flat.append(v)
            return flat
        if fname == "array::first":
            return vals[0] if vals else NONE
        if fname == "array::last":
            return vals[-1] if vals else NONE
        if fname == "array::len":
            return len(vals)
        if fname in ("math::stddev", "math::variance") and len([
            x for x in vals if not isinstance(x, bool)
            and isinstance(x, (int, float))
        ]) <= 1:
            # the grouped aggregate reports 0 for a single-member group
            # (reference catalog/aggregation.rs create_field_document),
            # unlike the plain math:: function which yields NaN
            return 0.0
        return FUNCS[fname]([vals] + extra, ctx)
    if isinstance(expr, Binary):
        return _binary_aggregate(expr, members, ctx)
    if isinstance(expr, Prefix):
        from surrealdb_tpu_torch.exec.operators import neg

        v = _eval_aggregate(expr.expr, members, ctx)
        if expr.op == "-":
            return neg(v)
        return v
    if isinstance(expr, FunctionCall):
        from surrealdb_tpu_torch.fnc import FUNCS

        args = [_eval_aggregate(a, members, ctx) for a in expr.args]
        fn = FUNCS.get(expr.name.lower())
        if fn is None:
            raise SdbError(f"The function '{expr.name}' does not exist")
        return fn(args, ctx)
    # non-aggregate: evaluate on first member
    first = members[0]
    doc = first.doc if first.rid is not None else first.value
    return evaluate(expr, ctx.with_doc(doc, first.rid))


def _binary_aggregate(expr, members, ctx):
    from surrealdb_tpu_torch.exec.operators import binary_op

    lhs = _eval_aggregate(expr.lhs, members, ctx)
    rhs = _eval_aggregate(expr.rhs, members, ctx)
    return binary_op(expr.op, lhs, rhs)


def _resolve_alias(expr, aliases):
    """A field-path ORDER/GROUP item naming a projection alias (including
    nested aliases like `AS b.c`) resolves to the aliased expression."""
    if not aliases:
        return expr
    if isinstance(expr, Idiom) and expr.parts and all(
        isinstance(p, PField) for p in expr.parts
    ):
        name = ".".join(p.name for p in expr.parts)
        if name in aliases and aliases[name] is not expr:
            return aliases[name]
    return expr


def _stmt_rng(ctx):
    """Statement-level RNG (ORDER BY RAND): datastore-scoped — never
    the process-global `random` instance another subsystem might be
    consuming."""
    rng = getattr(ctx.ds, "rng", None)
    if rng is None:
        rng = _random.Random()
        try:
            ctx.ds.rng = rng
        except AttributeError:
            pass
    return rng


def _apply_order_sources(rows, order, ctx, aliases=None, keep=None):
    """ORDER BY over source rows (pre-projection): aliases resolve to their
    expressions, everything else evaluates against the source doc.
    `keep` (LIMIT+START known non-negative) bounds the sort to a top-k
    heap instead of sorting every row."""
    items = []
    for expr, d, collate, numeric in order:
        resolved = _resolve_alias(expr, aliases)
        # ORDER keys mirror evaluation against the projected output: an
        # alias re-computes its projection (traversal and all); a raw
        # idiom walks the output row value-only — record links stay
        # un-traversed (reference select/fetch/order_by.surql)
        items.append((resolved, d, collate, numeric, resolved is not expr))
    # colstore-backed sort: clean scalar key columns go through one
    # np.lexsort instead of the row-at-a-time key extractor; any
    # exotic row / uncompilable key / COLLATE|NUMERIC flag bails to
    # the exact scalar path below (exec/vops.py fallback rules)
    from surrealdb_tpu_torch.exec.vops import lexsort_sources

    fast = lexsort_sources(
        rows, [(e, d, c, nu) for e, d, c, nu, _a in items], ctx,
        keep=keep,
    )
    if fast is not None:
        return fast
    keyed = []
    for src in rows:
        doc = src.doc if src.rid is not None else src.value
        cc = ctx.with_doc(doc, src.rid)
        cc.knn = ctx.knn
        keys = []
        for expr, d, collate, numeric, was_alias in items:
            cc._no_link_fetch = not was_alias
            try:
                keys.append((evaluate(expr, cc), d, collate, numeric))
            finally:
                cc._no_link_fetch = False
        keyed.append((_OrderKey(keys), src))
    if keep is not None and keep < len(keyed):
        import heapq

        # nsmallest is stable (documented equivalent of sorted()[:n])
        keyed = heapq.nsmallest(keep, keyed, key=lambda kr: kr[0])
        return [r for _k, r in keyed]
    keyed.sort(key=lambda kr: kr[0])
    return [r for _k, r in keyed]


def _order_cmp(v, w, collate, numeric):
    if collate and isinstance(v, str) and isinstance(w, str):
        from surrealdb_tpu_torch.utils.translit import lexical_cmp

        return lexical_cmp(v, w, numeric=numeric)
    if numeric and isinstance(v, str) and isinstance(w, str):
        import re

        def splitnum(s):
            return [
                int(p) if p.isdigit() else p
                for p in re.split(r"(\d+)", s)
                if p
            ]

        a, b = splitnum(v), splitnum(w)
        for x, y in zip(a, b):
            if type(x) is not type(y):
                x, y = str(x), str(y)
            if x != y:
                return -1 if x < y else 1
        return (len(a) > len(b)) - (len(a) < len(b))
    return value_cmp(v, w)


class _OrderKey:
    __slots__ = ("keys",)

    def __init__(self, keys):
        self.keys = keys

    def __lt__(self, other):
        for (v, d, collate, numeric), (w, _, _, _) in zip(
            self.keys, other.keys
        ):
            c = _order_cmp(v, w, collate, numeric)
            if c:
                return (c < 0) if d == "asc" else (c > 0)
        return False

    def __eq__(self, other):
        # heapq.nsmallest decorates with (key, index) tuples: without a
        # real __eq__, tied keys never fall through to the index and
        # tie order becomes heap-arbitrary — diverging from the stable
        # sorted()[:n] this class promises (and from the vectorized
        # lexsort path, which is stable by construction)
        for (v, _d, collate, numeric), (w, _, _, _) in zip(
            self.keys, other.keys
        ):
            if _order_cmp(v, w, collate, numeric):
                return False
        return True


def _apply_order(rows, order, ctx, keep=None):
    keyed = []
    for r in rows:
        c = ctx.with_doc(r, None)
        keys = []
        for item in order:
            expr, d, collate, numeric = item
            keys.append((evaluate(expr, c), d, collate, numeric))
        keyed.append((_OrderKey(keys), r))
    if keep is not None and keep < len(keyed):
        import heapq

        # bounded top-k: LIMIT (+START) keeps keep rows — an O(n log k)
        # heap instead of the full O(n log n) sort-then-slice
        keyed = heapq.nsmallest(keep, keyed, key=lambda kr: kr[0])
        return [r for _k, r in keyed]
    keyed.sort(key=lambda kr: kr[0])
    return [r for _k, r in keyed]


def apply_fetch(v, fetch_paths, ctx):
    """FETCH: inline record links at given paths. Params and
    type::field/type::fields calls resolve to path strings first
    (reference expr/fetch.rs compute)."""
    for p in fetch_paths:
        for parts in _fetch_parts(p, ctx):
            v = _fetch_path(v, parts, ctx)
    return v


def _fetch_parts(p, ctx):
    """One FETCH item -> list of part-lists (type::fields yields many)."""
    if isinstance(p, Idiom):
        # a bare single-field idiom naming a string/array param resolves
        # dynamically; plain idioms fetch statically
        if len(p.parts) == 1 and isinstance(p.parts[0], tuple) and \
                p.parts[0][0] == "start":
            return _fetch_parts_value(evaluate(p.parts[0][1], ctx))
        return [list(p.parts)]
    if isinstance(p, Param):
        return _fetch_parts_value(evaluate(p, ctx))
    if isinstance(p, FunctionCall) and p.name in ("type::field",
                                                  "type::fields"):
        # the reference evaluates the ARGUMENTS (strings), then parses
        # them as idioms — not the call itself (expr/fetch.rs:105-150)
        arg = evaluate(p.args[0], ctx) if p.args else NONE
        return _fetch_parts_value(arg)
    if isinstance(p, Literal) and isinstance(p.value, str):
        return _fetch_parts_value(p.value)
    return _fetch_parts_value(evaluate(p, ctx))


def _fetch_parts_value(val):
    from surrealdb_tpu_torch.val import render as _r

    if isinstance(val, str):
        from surrealdb_tpu_torch.syn.parser import Parser

        try:
            idm = Parser(val).parse_expr()
        except Exception:
            idm = None
        if not isinstance(idm, Idiom):
            raise SdbError(
                f"Found {_r(val)} on FETCH CLAUSE, but FETCH expects an "
                f"idiom, a string or fields"
            )
        return [list(idm.parts)]
    if isinstance(val, list):
        out = []
        for x in val:
            out.extend(_fetch_parts_value(x))
        return out
    if isinstance(val, Idiom):
        return [list(val.parts)]
    raise SdbError(
        f"Found {_r(val)} on FETCH CLAUSE, but FETCH expects an idiom, "
        f"a string or fields"
    )


def _fetch_path(v, parts, ctx):
    if not parts:
        return _fetch_value(v, ctx)
    if isinstance(v, list):
        return [_fetch_path(x, parts, ctx) for x in v]
    part = parts[0]
    if isinstance(part, PField) and isinstance(v, dict):
        name = part.name
        if name in v:
            nv = dict(v)
            nv[name] = _fetch_path(v[name], parts[1:], ctx)
            return nv
        return v
    if isinstance(part, PAll):
        return _fetch_path(v, parts[1:], ctx)
    if isinstance(v, RecordId):
        doc = fetch_record(ctx, v)
        if doc is NONE:
            return v
        return _fetch_path(doc, parts, ctx)
    return v


def _fetch_value(v, ctx):
    if isinstance(v, RecordId):
        doc = fetch_record(ctx, v)
        return copy_value(doc) if doc is not NONE else v
    if isinstance(v, list):
        return [_fetch_value(x, ctx) for x in v]
    return v


def _elide_count_args(node):
    """Predicate labels render count(->edge) as count(...) (reference
    count-exists rewriter plan text)."""
    import copy as _copy

    from surrealdb_tpu_torch.expr.ast import Binary as _B, Constant as _C
    from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC

    if isinstance(node, _FC) and node.name.lower() == "count" and node.args:
        n2 = _copy.copy(node)
        n2.args = [_C("...")]
        return n2
    if isinstance(node, _B):
        n2 = _copy.copy(node)
        n2.lhs = _elide_count_args(node.lhs)
        n2.rhs = _elide_count_args(node.rhs)
        return n2
    return node


def _resolve_type_fields(node, ctx):
    """Plan-time rewrite: `type::field(<doc-free expr>)` becomes the named
    column idiom so access-path analysis can match indexes (reference
    resolves parameterized OData-style columns at plan time)."""
    import copy as _copy

    from surrealdb_tpu_torch.expr.ast import Binary as _B
    from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC
    from surrealdb_tpu_torch.idx.planner import _doc_free_idiom  # noqa: F401

    def const_str(e):
        from surrealdb_tpu_torch.expr.ast import Literal as _L

        if isinstance(e, _L) and isinstance(e.value, str):
            return e.value
        if isinstance(e, Param):
            try:
                val = evaluate(e, ctx)
            except SdbError:
                return None
            return val if isinstance(val, str) else None
        return None

    def rec(e):
        if isinstance(e, _FC) and e.name.lower() == "type::field" \
                and len(e.args) == 1:
            s = const_str(e.args[0])
            if s:
                return Idiom([PField(p) for p in s.split(".")])
        if isinstance(e, _B):
            e2 = _copy.copy(e)
            e2.lhs = rec(e.lhs)
            e2.rhs = rec(e.rhs)
            return e2
        return e

    return rec(node)


import re as _re_mod


# ---------------------------------------------------------------------------
# write statements -> document pipeline
# ---------------------------------------------------------------------------


def _only_wrap(results, only):
    if not only:
        return results
    if len(results) == 1:
        return results[0]
    if len(results) == 0:
        return NONE
    raise SdbError("Expected a single result output when using the ONLY keyword")


def _timeout_ctx(n, ctx: Ctx) -> Ctx:
    """Child ctx with a deadline when the statement has TIMEOUT (expression-
    valued; reference: parameterized/timeout.surql). Without one, the
    global ALTER SYSTEM QUERY_TIMEOUT applies."""
    from surrealdb_tpu_torch.val import Duration

    if getattr(n, "timeout", None) is None:
        if ctx.deadline is None:
            try:
                cfg = ctx.txn.get_val(K.sys_cfg()) or {}
            except Exception:
                cfg = {}
            d = cfg.get("QUERY_TIMEOUT")
            if isinstance(d, Duration):
                c = ctx.child()
                c.deadline = time.monotonic() + d.to_seconds()
                c.timeout_dur = d
                return c
        return ctx

    d = evaluate(n.timeout, ctx)
    if not isinstance(d, Duration):
        raise SdbError(f"Expected a duration but found {render(d)}")
    c = ctx.child()
    # a statement TIMEOUT can only SHRINK the budget: the edge deadline
    # (X-Surreal-Timeout / server default) stays binding underneath it
    stmt_dl = time.monotonic() + d.to_seconds()
    if ctx.deadline is not None and ctx.deadline < stmt_dl:
        return c
    c.deadline = stmt_dl
    c.timeout_dur = d
    return c


def _s_create(n: CreateStmt, ctx: Ctx):
    from surrealdb_tpu_torch.exec.document import create_one
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    if getattr(n, "version", None) is not None:
        from surrealdb_tpu_torch.exec.eval import version_ns

        ctx = ctx.child()
        ctx.write_version = version_ns(evaluate(n.version, ctx))

    results = []
    for expr in n.what:
        v = _target_value(expr, ctx)
        targets = v if isinstance(v, list) else [v]
        for t in targets:
            ctx.check_deadline()
            results.append(create_one(t, n.data, n.output, ctx))
    results = _drop_skipped(results)
    results = [r for r in results if r is not NONE or n.output is not None]
    if n.output is not None and n.output.kind == "none":
        return _only_wrap([], n.only) if n.only else []
    return _only_wrap(results, n.only)


def _s_insert(n: InsertStmt, ctx: Ctx):
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    if getattr(n, "version", None) is not None:
        from surrealdb_tpu_torch.exec.eval import version_ns

        ctx = ctx.child()
        ctx.write_version = version_ns(evaluate(n.version, ctx))
    from surrealdb_tpu_torch.exec.document import insert_one, relate_insert_one

    into = None
    if n.into is not None:
        v = _target_value(n.into, ctx)
        if isinstance(v, Table):
            into = v.name
        elif isinstance(v, str):
            into = v
        elif isinstance(v, RecordId):
            into = v.tb
    results = []
    if isinstance(n.data, InsertRows):
        names = [expr_name(f) for f in n.data.fields]
        for row in n.data.rows:
            doc = {}
            for name, ex in zip(names, row):
                _set_path(doc, name.split("."), evaluate(ex, ctx))
            results.append(
                insert_one(into, doc, n.ignore, n.update, n.output, ctx)
            )
    else:
        data = evaluate(n.data, ctx)
        items = data if isinstance(data, list) else [data]
        for item in items:
            ctx.check_deadline()
            if not isinstance(item, dict):
                raise SdbError(f"Cannot INSERT {render(item)}")
            if n.relation:
                results.append(
                    relate_insert_one(into, item, n.ignore, n.output, ctx)
                )
            else:
                results.append(
                    insert_one(into, item, n.ignore, n.update, n.output, ctx)
                )
    results = _drop_skipped(results)
    if n.output is not None and n.output.kind == "none":
        return []
    return results


def _resolve_write_source(src, ctx):
    """Writes resolve object values carrying a record id to that record."""
    if src.rid is None and isinstance(src.value, dict):
        rid = src.value.get("id")
        if isinstance(rid, RecordId):
            return Source(rid=rid, doc=fetch_record(ctx, rid))
    return src


def _s_update(n: UpdateStmt, ctx: Ctx):
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    from surrealdb_tpu_torch.exec.document import update_one

    if n.explain:
        raise NotPorted("EXPLAIN is not ported")
    results = []
    for src in iterate_targets(n.what, ctx, None, None):
        ctx.check_deadline()
        src = _resolve_write_source(src, ctx)
        if src.rid is None:
            raise SdbError(f"Cannot UPDATE {render(src.value)}")
        if src.doc is NONE:
            continue  # UPDATE only touches existing records
        if n.cond is not None:
            c = ctx.with_doc(src.doc, src.rid)
            if not is_truthy(evaluate(n.cond, c)):
                continue
        results.append(update_one(src.rid, src.doc, n.data, n.output, ctx))
    results = _drop_skipped(results)
    results = [r for r in results if r is not NONE or n.output is None]
    if n.output is not None and n.output.kind == "none":
        return _only_wrap([], False) if not n.only else NONE
    return _only_wrap(results, n.only)


def _s_upsert(n: UpsertStmt, ctx: Ctx):
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    from surrealdb_tpu_torch.exec.document import create_one, update_one

    if n.explain:
        raise NotPorted("EXPLAIN is not ported")
    results = []
    for expr in n.what:
        v = _target_value(expr, ctx)
        targets = v if isinstance(v, list) else [v]
        for t in targets:
            ctx.check_deadline()
            if isinstance(t, RecordId) and not isinstance(t.id, Range):
                doc = fetch_record(ctx, t)
                if doc is NONE:
                    # a missing record is created regardless of WHERE
                    results.append(create_one(t, n.data, n.output, ctx, upsert=True))
                else:
                    if n.cond is not None:
                        c = ctx.with_doc(doc, t)
                        if not is_truthy(evaluate(n.cond, c)):
                            continue
                    results.append(update_one(t, doc, n.data, n.output, ctx))
            elif isinstance(t, Table) and n.cond is None:
                # bare-table UPSERT is a Yield (reference Iterable::Yield):
                # create ONE new record — unless a unique index already
                # holds the new row's values, which redirects the write to
                # that record (explicit-id UPSERT still errors instead)
                from surrealdb_tpu_torch.exec.document import (
                    _find_unique_conflict,
                    apply_data,
                )

                probe = apply_data({}, n.data, ctx.child(), None,
                                   this_doc=NONE)
                pid = probe.get("id")
                if pid is not None and pid is not NONE:
                    # data carries an explicit id: upsert THAT record
                    from surrealdb_tpu_torch.exec.document import record_id_key

                    prid = pid if isinstance(pid, RecordId) \
                        else RecordId(t.name, record_id_key(pid))
                    doc = fetch_record(ctx, prid)
                    if doc is NONE:
                        results.append(create_one(
                            prid, n.data, n.output, ctx, upsert=True
                        ))
                    else:
                        results.append(
                            update_one(prid, doc, n.data, n.output, ctx)
                        )
                    continue
                existing_rid = _find_unique_conflict(t.name, probe, None, ctx)
                if existing_rid is not None:
                    doc = fetch_record(ctx, existing_rid)
                    results.append(
                        update_one(existing_rid, doc, n.data, n.output, ctx)
                    )
                else:
                    results.append(
                        create_one(t, n.data, n.output, ctx, upsert=True)
                    )
            elif isinstance(t, Table):
                # UPSERT table WHERE: update matching, create if none —
                # an undefined table simply has no matches (no error)
                matched = False
                ns0, db0 = ctx.need_ns_db()
                srcs = (
                    _scan_table(t.name, ctx)
                    if ctx.txn.get(K.tb_def(ns0, db0, t.name)) is not None
                    else []
                )
                for src in srcs:
                    if n.cond is not None:
                        c = ctx.with_doc(src.doc, src.rid)
                        if not is_truthy(evaluate(n.cond, c)):
                            continue
                    matched = True
                    results.append(
                        update_one(src.rid, src.doc, n.data, n.output, ctx)
                    )
                if not matched:
                    results.append(
                        create_one(t, n.data, n.output, ctx, upsert=True)
                    )
            else:
                yield_src = list(_iterate_value(t, ctx))
                for src in yield_src:
                    src = _resolve_write_source(src, ctx)
                    if src.rid is None:
                        raise SdbError(f"Cannot UPSERT {render(src.value)}")
                    if src.doc is NONE:
                        results.append(
                            create_one(src.rid, n.data, n.output, ctx, upsert=True)
                        )
                    else:
                        results.append(
                            update_one(src.rid, src.doc, n.data, n.output, ctx)
                        )
    results = _drop_skipped(results)
    results = [r for r in results if r is not NONE or n.output is None]
    if n.output is not None and n.output.kind == "none":
        return []
    return _only_wrap(results, n.only)


def _s_delete(n: DeleteStmt, ctx: Ctx):
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    from surrealdb_tpu_torch.exec.document import delete_one

    if n.explain:
        raise NotPorted("EXPLAIN is not ported")
    results = []
    for src in iterate_targets(n.what, ctx, None, None):
        ctx.check_deadline()
        src = _resolve_write_source(src, ctx)
        if src.rid is None:
            raise SdbError(f"Cannot DELETE {render(src.value)}")
        if src.doc is NONE:
            continue
        if n.cond is not None:
            c = ctx.with_doc(src.doc, src.rid)
            if not is_truthy(evaluate(n.cond, c)):
                continue
        r = delete_one(src.rid, src.doc, n.output, ctx)
        if n.output is not None and n.output.kind != "none":
            # permission-skipped rows and select-gated outputs drop out;
            # a legitimately-NONE RETURN VALUE stays
            results.append(r)
    results = _drop_skipped(results)
    return _only_wrap(results, n.only) if n.only else results


def _s_relate(n: RelateStmt, ctx: Ctx):
    ctx = _timeout_ctx(n, ctx)
    ctx.check_deadline()
    from surrealdb_tpu_torch.exec.document import relate_one

    kind_v = _target_value(n.kind, ctx)
    froms = evaluate(n.from_, ctx) if not isinstance(n.from_, Idiom) or not (
        len(n.from_.parts) == 1 and isinstance(n.from_.parts[0], PField)
    ) else _target_value(n.from_, ctx)
    tos = evaluate(n.to, ctx) if not isinstance(n.to, Idiom) or not (
        len(n.to.parts) == 1 and isinstance(n.to.parts[0], PField)
    ) else _target_value(n.to, ctx)
    froms = froms if isinstance(froms, list) else [froms]
    tos = tos if isinstance(tos, list) else [tos]
    results = []
    for f in froms:
        ctx.check_deadline()
        for t in tos:
            fr = _as_rid(f, "in")
            to = _as_rid(t, "id")
            results.append(
                relate_one(kind_v, fr, to, n.data, n.output, ctx, n.uniq)
            )
    if n.output is not None and n.output.kind == "none":
        return []
    if n.output is None:
        results = [r for r in results if r is not NONE]
    results = _drop_skipped(results)
    return _only_wrap(results, n.only)


def _as_rid(v, prop="in"):
    if isinstance(v, RecordId):
        return v
    if isinstance(v, dict) and isinstance(v.get("id"), RecordId):
        return v["id"]
    raise SdbError(
        f"Cannot execute RELATE statement where property '{prop}' "
        f"is: {render(v)}"
    )


# ---------------------------------------------------------------------------
# DEFINE / REMOVE / INFO / etc.
# ---------------------------------------------------------------------------


def _ensure_ns_db(ctx: Ctx):
    """Auto-create namespace/database definitions on first use."""
    ns, db = ctx.need_ns_db()
    if ctx.txn.get(K.ns_def(ns)) is None:
        ctx.txn.set_val(K.ns_def(ns), NamespaceDef(ns))
    if ctx.txn.get(K.db_def(ns, db)) is None:
        ctx.txn.set_val(K.db_def(ns, db), DatabaseDef(db))


def _exists_guard(ctx, key, name, kind, if_not_exists, overwrite,
                  msg=None):
    if ctx.txn.get(key) is not None:
        if if_not_exists:
            return True  # skip silently
        if not overwrite and not getattr(ctx.executor, "import_mode", False):
            raise SdbError(
                msg or f"The {kind} '{name}' already exists"
            )
    return False


def _s_define_ns(n: DefineNamespace, ctx):
    if _exists_guard(ctx, K.ns_def(n.name), n.name, "namespace",
                     n.if_not_exists, n.overwrite):
        return NONE
    ctx.txn.set_val(K.ns_def(n.name), NamespaceDef(n.name, n.comment))
    return NONE


def _s_define_db(n: DefineDatabase, ctx):
    ns = ctx.session.ns
    if not ns:
        raise SdbError("Specify a namespace to use")
    if ctx.txn.get(K.ns_def(ns)) is None:
        ctx.txn.set_val(K.ns_def(ns), NamespaceDef(ns))
    if _exists_guard(ctx, K.db_def(ns, n.name), n.name, "database",
                     n.if_not_exists, n.overwrite):
        return NONE
    if n.changefeed is not None:
        raise NotPorted("CHANGEFEED is not ported")
    cf = None
    ctx.txn.set_val(
        K.db_def(ns, n.name),
        DatabaseDef(n.name, n.comment, cf, strict=getattr(n, "strict", False)),
    )
    return NONE


def _s_define_table(n: DefineTable, ctx):
    if n.view is not None:
        raise NotPorted("DEFINE TABLE ... AS SELECT (views) is not ported")
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if _exists_guard(ctx, K.tb_def(ns, db, n.name), n.name, "table",
                     n.if_not_exists, n.overwrite):
        return NONE
    if n.changefeed is not None:
        raise NotPorted("CHANGEFEED is not ported")
    cf = None
    # TYPE defaults: SCHEMAFULL implies NORMAL, otherwise ANY
    # (reference DefineTableStatement); explicit TYPE always wins
    if n.kind is None:
        kind = "normal" if n.full else "any"
    else:
        kind = n.kind
    # catalog table ids allocate monotonically per database (the
    # reference's TableId; surfaced by INFO ... STRUCTURE) — REMOVEd
    # tables never free their id
    _idk = K.tb_idseq(ns, db)
    existing = ctx.txn.get_val(K.tb_def(ns, db, n.name))
    if existing is not None:
        next_id = getattr(existing, "table_id", 0)  # redefinition keeps id
    else:
        next_id = ctx.txn.get_val(_idk) or 0
        ctx.txn.set_val(_idk, next_id + 1)
    tdef = TableDef(
        name=n.name,
        table_id=next_id,
        drop=n.drop,
        full=n.full,
        kind=kind,
        relation_from=n.relation_from,
        relation_to=n.relation_to,
        enforced=n.enforced,
        view=n.view,
        permissions=n.permissions,
        changefeed=cf,
        comment=n.comment,
    )
    ctx.txn.set_val(K.tb_def(ns, db, n.name), tdef)
    if kind == "relation":
        # relation tables implicitly define typed in/out fields
        from surrealdb_tpu_torch.catalog import FieldDef
        from surrealdb_tpu_torch.expr.ast import Kind as _Kind

        for fname, tbs in (("in", n.relation_from), ("out", n.relation_to)):
            fk = K.fd_def(ns, db, n.name, fname)
            if ctx.txn.get(fk) is None or n.overwrite:
                kk = _Kind("record", list(tbs) if tbs else [])
                ctx.txn.set_val(
                    fk,
                    FieldDef(
                        name=[PField(fname)], name_str=fname, kind=kk
                    ),
                )
    return NONE


def _kind_all_records(kind) -> bool:
    """True when every leaf of the type is a record (REFERENCE is only
    valid on record-typed fields; wrappers option/array/set pass through,
    unions need every branch to be records)."""
    if kind is None:
        return False
    nm = kind.name
    if nm == "record":
        return True
    if nm in ("option", "array", "set"):
        return all(
            _kind_all_records(i) for i in (kind.inner or [])
        ) and bool(kind.inner)
    if nm == "either":
        return all(_kind_all_records(i) for i in (kind.inner or []))
    return False


def _s_define_field(n: DefineField, ctx):
    if getattr(n, "flex", False):
        ns0 = ctx.session.ns
        db0 = ctx.session.db
        if ns0 and db0:
            td0 = ctx.txn.get_val(K.tb_def(ns0, db0, n.tb))
            if td0 is not None and not td0.full:
                raise SdbError(
                    "An error occurred: FLEXIBLE can only be used in "
                    "SCHEMAFULL tables"
                )
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if ctx.txn.get(K.tb_def(ns, db, n.tb)) is None:
        ctx.txn.set_val(K.tb_def(ns, db, n.tb), TableDef(name=n.tb))
    name_str = _field_name_str(n.name)
    _check_computed_field(n, name_str, ns, db, ctx)
    if getattr(n, "reference", None) is not None:
        # reference define/field.rs REFERENCE validations
        if "." in name_str or "[" in name_str:
            raise SdbError(
                f"Cannot use the `REFERENCE` keyword on nested field "
                f"`{name_str}`. Specify a referencing field at the root "
                f"level instead."
            )
        if n.kind is not None and not _kind_all_records(n.kind):
            from surrealdb_tpu_torch.exec.coerce import kind_name as _kn

            raise SdbError(
                f"Cannot use the `REFERENCE` keyword with "
                f"`TYPE {_kn(n.kind)}`. Specify only a `record` type, or "
                f"a type containing only records, instead."
            )
    if name_str == "id":
        # reference define/field.rs validate_id_restrictions
        for kw, present in (
            ("VALUE", n.value is not None),
            ("REFERENCE", getattr(n, "reference", None) is not None),
            ("DEFAULT", n.default is not None),
        ):
            if present:
                raise SdbError(
                    f"Cannot use the `{kw}` keyword on the `id` field."
                )
        if n.kind is not None and not _id_kind_supported(n.kind):
            from surrealdb_tpu_torch.exec.coerce import kind_name as _kn

            raise SdbError(
                f"Cannot use the `{_kn(n.kind)}` type on the `id` field, "
                f"as that's not a valid record id key."
            )
    _check_nested_kind(n, name_str, ns, db, ctx)
    kdef = K.fd_def(ns, db, n.tb, name_str)
    if _exists_guard(ctx, kdef, name_str, "field", n.if_not_exists, n.overwrite):
        return NONE
    fd = FieldDef(
        name=n.name,
        name_str=name_str,
        flex=n.flex,
        kind=n.kind,
        readonly=n.readonly,
        value=n.value,
        assert_=n.assert_,
        default=n.default,
        default_always=n.default_always,
        computed=n.computed,
        permissions=n.permissions,
        reference=n.reference,
        comment=n.comment,
    )
    ctx.txn.set_val(kdef, fd)
    _process_recursive_definitions(n, fd, ns, db, ctx)
    # on a relation table, the `in`/`out` field kinds ARE the relation's
    # endpoint constraint — keep the table def's IN/OUT union in sync so
    # INFO renders the live constraint (reference derives TYPE RELATION
    # IN/OUT from the in/out field definitions)
    if name_str in ("in", "out") and n.kind is not None:
        td = ctx.txn.get_val(K.tb_def(ns, db, n.tb))
        if td is not None and td.kind == "relation":
            tbs = _record_kind_tables(n.kind)
            if tbs is not None:
                import copy as _copy

                td = _copy.copy(td)
                if name_str == "in":
                    td.relation_from = tbs
                else:
                    td.relation_to = tbs
                ctx.txn.set_val(K.tb_def(ns, db, n.tb), td)
    return NONE


def _id_kind_supported(k) -> bool:
    """Kinds usable as a record-id key (reference record_id/key.rs
    kind_supported): any/number/int/string/uuid/array/set/object,
    int/string/array/object literals, and eithers of those."""
    nm = k.name
    if nm in ("any", "number", "int", "string", "uuid", "array", "set",
              "object"):
        return True
    if nm in ("array_literal", "object_literal"):
        return True
    if nm == "literal":
        return isinstance(k.literal, (int, str)) and \
            not isinstance(k.literal, bool)
    if nm == "either":
        return all(_id_kind_supported(b) for b in k.inner)
    return False


def _kind_inner_sub(k):
    """Kind of a container's elements (reference Kind::inner_kind):
    array/set expose their element kind; eithers union their branches'
    element kinds (flattened); everything else has no subtype."""
    from surrealdb_tpu_torch.expr.ast import Kind

    if not isinstance(k, Kind):
        return None
    if k.name in ("array", "set"):
        return k.inner[0] if k.inner else Kind("any")
    if k.name == "option":
        # reference models option<T> as none | T — subtypes pass through
        return _kind_inner_sub(k.inner[0]) if k.inner else None
    if k.name == "either":
        subs = [s for s in (_kind_inner_sub(b) for b in k.inner)
                if s is not None]
        if not subs:
            return None
        flat = []
        for s in subs:
            flat.extend(s.inner if s.name == "either" else [s])
        return flat[0] if len(flat) == 1 else Kind("either", flat)
    return None


def _process_recursive_definitions(n, fd, ns, db, ctx):
    """DEFINE FIELD f TYPE array<K> implicitly defines f.* TYPE K (and so
    on down through nested containers); an existing subtype def keeps its
    other clauses and gets its TYPE replaced. Reference:
    define/field.rs process_recursive_definitions."""
    from surrealdb_tpu_torch.expr.ast import Kind, PAll

    cur = _kind_inner_sub(fd.kind)
    name_parts = list(fd.name)
    depth = 0
    while cur is not None and depth < 16:
        if cur.name == "any":
            # `array` with no element type already implies `.* TYPE any`
            break
        name_parts = name_parts + [PAll()]
        nstr = _field_name_str(name_parts)
        key = K.fd_def(ns, db, n.tb, nstr)
        existing = ctx.txn.get_val(key)
        if existing is not None:
            import copy as _copy

            sub = _copy.copy(existing)
            sub.kind = cur
        else:
            sub = FieldDef(name=list(name_parts), name_str=nstr, kind=cur)
        ctx.txn.set_val(key, sub)
        cur = _kind_inner_sub(cur)
        depth += 1


def _record_kind_tables(kind):
    """For record / record<a | b> kinds, the endpoint table list (empty =
    any record); None when the kind isn't record-shaped."""
    from surrealdb_tpu_torch.expr.ast import Kind

    if not isinstance(kind, Kind):
        return None
    if kind.name == "record":
        # parser stores record<...> endpoint tables as plain ident strings
        return [str(t) for t in (kind.inner or [])]
    if kind.name == "either":
        out = []
        for b in kind.inner or []:
            sub = _record_kind_tables(b)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


def _check_nested_kind(n, name_str, ns, db, ctx):
    """A nested field's TYPE must equal the kind its parent projects at
    that segment (reference define/field.rs type-mismatch check)."""
    from surrealdb_tpu_torch.exec.coerce import kind_name
    from surrealdb_tpu_torch.expr.ast import Kind, PIndex as _PIdx

    if n.kind is None or len(n.name) < 2:
        return
    pfd = None
    split = None
    for i in range(len(n.name) - 1, 0, -1):
        cand = _field_name_str(n.name[:i])
        fd = ctx.txn.get_val(K.fd_def(ns, db, n.tb, cand))
        if fd is not None:
            pfd, parent_str, split = fd, cand, i
            break
    if pfd is None or pfd.kind is None:
        return

    def as_seg(p):
        if isinstance(p, PField):
            return ("key", p.name)
        if isinstance(p, PAll):
            return ("all", None)
        if isinstance(p, _PIdx):
            return ("idx", p.expr.value
                    if isinstance(p.expr, Literal) else None)
        return None

    segs = [as_seg(p) for p in n.name[split:]]
    if any(x is None for x in segs):
        return

    ALLOW = object()
    MISMATCH = object()

    def proj(k, seg):
        nm = k.name
        if nm == "option":
            return proj(k.inner[0], seg) if k.inner else ALLOW
        if nm == "either":
            outs = []
            for b in k.inner:
                r = proj(b, seg)
                if r is MISMATCH:
                    return MISMATCH
                if r is ALLOW:
                    continue
                outs.extend(r if isinstance(r, list) else [r])
            return outs or ALLOW
        if nm == "any":
            return ALLOW
        if nm == "object" and not getattr(k, "inner", None):
            # plain objects have keyed children only
            return ALLOW if seg[0] in ("key", "all") else MISMATCH
        if nm in ("array", "set"):
            if seg[0] not in ("all", "idx"):
                return MISMATCH
            if seg[0] == "idx" and getattr(k, "size", None) is not None \
                    and isinstance(seg[1], int) and seg[1] >= k.size:
                return MISMATCH  # index beyond the declared array size
            if not k.inner:
                return ALLOW
            return [k.inner[0]]
        if nm == "array_literal":
            if seg[0] == "idx":
                i = seg[1]
                if isinstance(i, int) and 0 <= i < len(k.inner):
                    return [k.inner[i]]
                return MISMATCH
            if seg[0] == "all":
                return list(k.inner)
            return MISMATCH
        if nm == "object_literal":
            if seg[0] == "key":
                for kk, kv in k.inner:
                    if kk == seg[1]:
                        return [kv]
                return MISMATCH
            if seg[0] == "all":
                return [kv for _kk, kv in k.inner]
            return MISMATCH
        return ALLOW

    if n.kind.name == "any":
        return  # `any` children are always compatible
    kinds = [pfd.kind]
    r = None
    for seg in segs:
        outs = []
        for k in kinds:
            rr = proj(k, seg)
            if rr is MISMATCH:
                outs = MISMATCH
                break
            if rr is ALLOW:
                outs = ALLOW
                break
            outs.extend(rr)
        r = outs
        if r is ALLOW or r is MISMATCH:
            break
        kinds = r
    if r is ALLOW:
        return
    if r is not MISMATCH:
        # canonical union of projected kinds must equal the declared kind;
        # option<K> and nested eithers flatten into the union
        def leaves(k):
            if k.name == "option" and k.inner:
                yield from leaves(k.inner[0])
            elif k.name == "either":
                for b in k.inner:
                    yield from leaves(b)
            else:
                yield kind_name(k)

        names = list(dict.fromkeys(x for k in r for x in leaves(k)))
        if "any" in names:
            return  # parent projects `any` at this segment
        want = " | ".join(names)
        have = " | ".join(
            dict.fromkeys(x for x in leaves(n.kind))
        )
        if want == have:
            return
    raise SdbError(
        f"Cannot set field `{name_str}` with type `{kind_name(n.kind)}` "
        f"as it mismatched with field `{parent_str}` with type "
        f"`{kind_name(pfd.kind)}`"
    )


def _check_computed_field(n, name_str, ns, db, ctx):
    """COMPUTED field validation (reference expr/statements/define/field.rs):
    clause exclusions, top-level-only, no indexes, and cycle detection."""
    existing = {
        fd.name_str: fd
        for _k, fd in ctx.txn.scan_vals(
            *K.prefix_range(K.fd_prefix(ns, db, n.tb))
        )
    }
    if n.computed is None:
        # defining a nested field under a computed parent is an error
        if "." in name_str:
            parent = name_str.split(".")[0]
            pfd = existing.get(parent)
            if pfd is not None and pfd.computed is not None:
                raise SdbError(
                    f"Cannot define nested field `{name_str}` as parent "
                    f"field `{parent}` is a `COMPUTED` field."
                )
        return
    if name_str == "id":
        raise SdbError("Cannot use the `COMPUTED` keyword on the `id` field.")
    for attr, kw in (("value", "VALUE"), ("assert_", "ASSERT"),
                     ("default", "DEFAULT"), ("reference", "REFERENCE"),
                     ("readonly", "READONLY")):
        if getattr(n, attr, None):
            raise SdbError(f"Cannot use the `{kw}` keyword with `COMPUTED`.")
    if len(n.name) > 1:
        raise SdbError(
            f"Cannot define field `{name_str}` as `COMPUTED` fields must "
            "be top-level."
        )
    for other in existing:
        if other.startswith(name_str + ".") or other.startswith(
                name_str + "["):
            raise SdbError(
                f"Cannot define field `{name_str}` as `COMPUTED` since a "
                f"nested field `{other}` already exists."
            )
    # computed fields cannot be indexed
    for _k, idef in ctx.txn.scan_vals(
            *K.prefix_range(K.ix_prefix(ns, db, n.tb))):
        for col in idef.cols_str:
            if col == name_str or col.startswith(name_str + "."):
                raise SdbError(
                    f"Computed fields cannot be indexed. Index: "
                    f"'{idef.name}' - Field: '{name_str}'"
                )
    # cycle detection over the computed-field dependency graph
    deps = {
        fname: sorted(_computed_deps(fd.computed))
        for fname, fd in existing.items()
        if fd.computed is not None and fname != name_str
    }
    deps[name_str] = sorted(_computed_deps(n.computed))

    def dfs(cur, path, seen):
        for d in deps.get(cur, []):
            if d == name_str:
                # canonical cycle: rotate to start at the smallest name
                i = path.index(min(path))
                cyc = path[i:] + path[:i]
                raise SdbError(
                    "Cyclic dependency detected among computed fields: "
                    + " -> ".join(cyc + [cyc[0]])
                )
            if d in deps and d not in seen:
                seen.add(d)
                dfs(d, path + [d], seen)

    dfs(name_str, [name_str], {name_str})


def _computed_deps(expr) -> set:
    """Field names referenced by a computed expression: bare idioms,
    `this.x` / `$this.x`, and `this['x']` bracket access."""
    out = set()

    def visit(node):
        if isinstance(node, Idiom) and node.parts:
            p0 = node.parts[0]
            if isinstance(p0, PField):
                out.add(p0.name)
            elif isinstance(p0, tuple) and len(p0) == 2 and p0[0] == "start":
                base = p0[1]
                if isinstance(base, Param) and base.name in ("this", "self"):
                    rest = node.parts[1:]
                    if rest:
                        r0 = rest[0]
                        if isinstance(r0, PField):
                            out.add(r0.name)
                        elif isinstance(r0, PIndex) and isinstance(
                                r0.expr, Literal) and isinstance(
                                r0.expr.value, str):
                            out.add(r0.expr.value)
            # bracket access on a bare field: a['b'] has PField head,
            # already collected above
        for f in getattr(node, "__dataclass_fields__", {}):
            v = getattr(node, f)
            if isinstance(v, Node):
                visit(v)
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, Node):
                        visit(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, Node):
                                visit(y)

    if expr is not None:
        visit(expr)
    return out


def _field_name_str(parts) -> str:
    out = []
    for p in parts:
        if isinstance(p, PField):
            out.append(("." if out else "") + p.name)
        elif isinstance(p, PAll):
            out.append(".*" if out else "*")
        elif isinstance(p, PIndex):
            from surrealdb_tpu_torch.expr.ast import Literal as _L

            if isinstance(p.expr, _L):
                out.append(f"[{p.expr.value}]")
        elif isinstance(p, PFlatten):
            out.append("\u2026")  # `field...` renders with an ellipsis
    return "".join(out)


def _s_define_index(n: DefineIndex, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if ctx.txn.get(K.tb_def(ns, db, n.tb)) is None:
        ctx.txn.set_val(K.tb_def(ns, db, n.tb), TableDef(name=n.tb))
    kdef = K.ix_def(ns, db, n.tb, n.name)
    if _exists_guard(ctx, kdef, n.name, "index", n.if_not_exists, n.overwrite):
        return NONE
    if n.overwrite and ctx.txn.get(kdef) is not None:
        _remove_index_data(ns, db, n.tb, n.name, ctx)
    # computed fields cannot be indexed
    computed_names = {
        fd.name_str
        for _k, fd in ctx.txn.scan_vals(
            *K.prefix_range(K.fd_prefix(ns, db, n.tb)))
        if fd.computed is not None
    }
    cols = []
    for c in n.cols:
        # type::field($f) / type::fields($fs) expand to idioms at define
        # time (reference: parameterized/schema/index.surql)
        if isinstance(c, FunctionCall) and c.name in (
                "type::field", "type::fields"):
            from surrealdb_tpu_torch.syn.parser import Parser

            v = evaluate(c.args[0], ctx) if c.args else NONE
            names = v if c.name == "type::fields" else [v]
            if not isinstance(names, list):
                raise SdbError(
                    f"Expected an array but found {render(names)}")
            for s in names:
                if not isinstance(s, str):
                    raise SdbError(
                        f"Expected a string but found {render(s)}")
                cols.append(Idiom(Parser(s)._field_name_parts()))
        else:
            cols.append(c)
    for c in cols:
        cname = expr_name(c)
        head = cname.split(".")[0].split("[")[0]
        if head in computed_names:
            raise SdbError(
                f"Computed fields cannot be indexed. Index: '{n.name}' - "
                f"Field: '{head}'"
            )
    td = ctx.txn.get_val(K.tb_def(ns, db, n.tb))
    if td is not None and td.full:
        # SCHEMAFULL: every indexed column must resolve to a defined
        # field (or a path its parent's kind can contain)
        for c in cols:
            _check_index_field_exists(c, n.tb, ns, db, ctx)
    idef = IndexDef(
        name=n.name,
        tb=n.tb,
        cols=cols,
        cols_str=[expr_name(c) for c in cols],
        unique=n.unique,
        hnsw=n.hnsw,
        fulltext=n.fulltext,
        count=n.count,
        count_cond=getattr(n, "count_cond", None),
        comment=n.comment,
    )
    ctx.txn.set_val(kdef, idef)
    from surrealdb_tpu_torch.exec.document import build_index

    if getattr(n, "concurrently", False):
        # background build (reference kvs/index.rs IndexBuilder): status
        # moves started -> indexing -> ready, visible via INFO FOR INDEX
        _spawn_index_build(ctx.ds, ns, db, idef)
        return NONE
    build_index(idef, ctx)
    return NONE


def _check_index_field_exists(col, tb, ns, db, ctx):
    """On SCHEMAFULL tables an index column must name a defined field, or
    have a defined top-level parent whose kind permits sub-field access
    (object/any/array/set/object-or-array literals, eithers of those, or
    no declared type). Reference: define/index.rs + kind.rs
    allows_sub_fields."""
    if not isinstance(col, Idiom):
        return
    path = expr_name(col)
    if path == "id":
        return
    if ctx.txn.get_val(K.fd_def(ns, db, tb, path)) is not None:
        return
    head = col.parts[0] if col.parts else None
    if isinstance(head, PField):
        pfd = ctx.txn.get_val(K.fd_def(ns, db, tb, head.name))
        if pfd is not None and (
            pfd.kind is None or _kind_allows_sub_fields(pfd.kind)
        ):
            return
    raise SdbError(f"The field '{path}' does not exist")


def _kind_allows_sub_fields(k) -> bool:
    nm = k.name
    if nm in ("any", "object", "array", "set", "object_literal",
              "array_literal"):
        return True
    if nm == "literal":
        return isinstance(k.literal, (list, dict))
    if nm == "option":
        return all(_kind_allows_sub_fields(b) for b in k.inner) if k.inner \
            else True
    if nm == "either":
        return all(
            b.name == "none" or _kind_allows_sub_fields(b) for b in k.inner
        )
    return False


def _spawn_index_build(ds, ns, db, idef):
    import threading

    from surrealdb_tpu_torch.exec.context import Ctx as _Ctx
    from surrealdb_tpu_torch.kvs.ds import Session as _Session

    key = (ns, db, idef.tb, idef.name)
    ds.index_builds[key] = {
        "status": "started", "initial": 0, "pending": 0, "updated": 0,
    }

    def run():
        from surrealdb_tpu_torch.exec.document import build_index

        for _attempt in range(5):
            txn = ds.transaction(write=True)
            c = _Ctx(ds, _Session(ns=ns, db=db, auth_level="owner"), txn)
            try:
                build_index(idef, c)
                txn.commit()
                return
            except SdbError as e:
                txn.cancel()
                if "conflict" not in str(e):
                    ds.index_builds[key] = {
                        "status": "error", "error": str(e),
                    }
                    return
        ds.index_builds[key] = {
            "status": "error", "error": "too many conflicts",
        }

    threading.Thread(target=run, daemon=True).start()


def _remove_index_data(ns, db, tb, ix, ctx):
    ctx.txn.delete_range(*K.prefix_range(K.index_prefix(ns, db, tb, ix)))
    ctx.txn.delete_range(*K.prefix_range(K.index_unique_prefix(ns, db, tb, ix)))
    ctx.txn.delete_range(*K.prefix_range(K.ix_state(ns, db, tb, ix, b"")))
    ctx.ds.vector_indexes.pop((ns, db, tb, ix), None)


_BASE_RANK = {"root": 0, "ns": 1, "db": 2}


def _s_remove(n: RemoveStmt, ctx: Ctx):
    ns = ctx.session.ns
    db = ctx.session.db
    kind = n.kind

    def _guard(key, label):
        if ctx.txn.get(key) is None:
            if n.if_exists:
                return True
            raise SdbError(f"The {kind} '{label}' does not exist")
        return False

    if kind == "namespace":
        key = K.ns_def(n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        ctx.txn.delete_range(*K.prefix_range(K.db_prefix(n.name)))
        ctx.txn.delete_range(*K.prefix_range(b"/*" + K.enc_str(n.name)))
        return NONE
    if kind == "database":
        key = K.db_def(ns, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        ctx.txn.delete_range(*K.prefix_range(K.tb_prefix(ns, n.name)))
        ctx.txn.delete_range(
            *K.prefix_range(b"/*" + K.enc_str(ns) + b"*" + K.enc_str(n.name))
        )
        return NONE
    if kind == "table":
        key = K.tb_def(ns, db, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        for kk in (K.fd_prefix, K.ix_prefix, K.ev_prefix, K.lq_prefix):
            ctx.txn.delete_range(*K.prefix_range(kk(ns, db, n.name)))
        base = K._tb(ns, db, n.name)
        ctx.txn.delete_range(*K.prefix_range(base))
        for ixkey in list(ctx.ds.vector_indexes):
            if ixkey[:3] == (ns, db, n.name):
                ctx.ds.vector_indexes.pop(ixkey, None)
        gk = (ns, db, n.name)
        from surrealdb_tpu_torch.exec.document import _bump_graph_version

        _bump_graph_version(ctx, gk)
        if ctx.ds.graph_engine:
            for ck in list(ctx.ds.graph_engine):
                if ck[2] == n.name or ck[3] == n.name:
                    ctx.ds.graph_engine.pop(ck, None)
        return NONE
    if kind == "field":
        name_str = _field_name_str(n.name) if isinstance(n.name, list) else n.name
        key = K.fd_def(ns, db, n.tb, name_str)
        if _guard(key, name_str):
            return NONE
        ctx.txn.delete(key)
        return NONE
    if kind == "index":
        key = K.ix_def(ns, db, n.tb, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        _remove_index_data(ns, db, n.tb, n.name, ctx)
        return NONE
    raise NotPorted(f"REMOVE {kind.upper()} is not ported")


# ---------------------------------------------------------------------------
# INFO
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# LIVE / KILL / SHOW
# ---------------------------------------------------------------------------


_GRANT_POOL = (
    "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)


def _unported(what):
    def fn(n, ctx):
        raise NotPorted(f"{what} is not ported")

    return fn


_STMTS = {
    LetStmt: _s_let,
    ReturnStmt: _s_return,
    IfStmt: _s_if,
    ForStmt: _s_for,
    BreakStmt: _s_break,
    ContinueStmt: _s_continue,
    ThrowStmt: _s_throw,
    SleepStmt: _s_sleep,
    UseStmt: _s_use,
    OptionStmt: _s_option,
    SelectStmt: _s_select,
    CreateStmt: _s_create,
    InsertStmt: _s_insert,
    UpdateStmt: _s_update,
    UpsertStmt: _s_upsert,
    DeleteStmt: _s_delete,
    RelateStmt: _s_relate,
    DefineNamespace: _s_define_ns,
    DefineDatabase: _s_define_db,
    DefineTable: _s_define_table,
    DefineField: _s_define_field,
    DefineIndex: _s_define_index,
    DefineEvent: _unported("DEFINE EVENT"),
    DefineParam: _unported("DEFINE PARAM"),
    DefineFunction: _unported("DEFINE FUNCTION"),
    DefineAnalyzer: _unported("DEFINE ANALYZER"),
    DefineUser: _unported("DEFINE USER"),
    DefineAccess: _unported("DEFINE ACCESS"),
    DefineModule: _unported("DEFINE MODULE"),
    DefineSequence: _unported("DEFINE SEQUENCE"),
    DefineConfig: _unported("DEFINE CONFIG"),
    RemoveStmt: _s_remove,
    AlterTable: _unported("ALTER TABLE"),
    AlterStmt: _unported("ALTER"),
    ExplainStmt: _unported("EXPLAIN"),
    RebuildIndex: _unported("REBUILD INDEX"),
    InfoStmt: _unported("INFO"),
    LiveStmt: _unported("LIVE SELECT"),
    KillStmt: _unported("KILL"),
    ShowStmt: _unported("SHOW CHANGES"),
    AccessStmt: _unported("ACCESS"),
}


def _import_silences(fn):
    """OPTION IMPORT: data statements run fully (indexes populate) but
    report NONE, matching import-stream behavior (statements/option)."""

    def wrapped(n, ctx):
        out = fn(n, ctx)
        if getattr(ctx.executor, "import_mode", False):
            # the statement's natural empty shape: ONLY -> NONE, else []
            return NONE if getattr(n, "only", False) else []
        return out

    return wrapped


for _t in (CreateStmt, InsertStmt, UpdateStmt, UpsertStmt, DeleteStmt,
           RelateStmt):
    _STMTS[_t] = _import_silences(_STMTS[_t])

