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

    plan = plan_scan(tb, cond, ctx, stmt) if ctx.version is None else None
    if plan is not None:
        yield from plan
        return
    ns, db = ctx.need_ns_db()
    from surrealdb_tpu_torch.kvs.api import deserialize

    has_computed = bool(computed_fields_of(tb, ctx))
    if ctx.version is not None:
        # as-of scan over the version history: last entry <= ts per id
        from surrealdb_tpu_torch.exec.eval import version_ns

        ts = version_ns(ctx.version)
        hp = K.hist_prefix(ns, db, tb)
        cur_id = None
        best = None
        for k, raw in ctx.txn.scan(*K.prefix_range(hp)):
            ident = k[len(hp):-8]
            ets = int.from_bytes(k[-8:], "big")
            if ident != cur_id:
                if cur_id is not None and best:
                    yield _hist_source(tb, cur_id, best, has_computed, ctx)
                cur_id, best = ident, None
            if ets <= ts:
                best = raw
        if cur_id is not None and best:
            yield _hist_source(tb, cur_id, best, has_computed, ctx)
        return
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


def _hist_source(tb, ident_enc, raw, has_computed, ctx):
    from surrealdb_tpu_torch.exec.eval import apply_computed_fields
    from surrealdb_tpu_torch.kvs.api import deserialize

    doc = deserialize(raw)
    rid = doc.get("id") if isinstance(doc, dict) else None
    if not isinstance(rid, RecordId):
        from surrealdb_tpu_torch.key import dec_value

        rid = RecordId(tb, dec_value(ident_enc)[0])
    if has_computed:
        doc = apply_computed_fields(tb, doc, rid, ctx)
    return Source(rid=rid, doc=doc)


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
        return _explain_select(n, c)
    # VERSION clause
    if n.version is not None:
        from surrealdb_tpu_torch.expr.ast import Subquery as _Subq

        if any(isinstance(w, _Subq) for w in n.what):
            raise SdbError(
                "Invalid query: VERSION clause cannot be used with a "
                "subquery source. Place the VERSION clause inside the "
                "subquery instead."
            )
        c.version = evaluate(n.version, ctx)
        from surrealdb_tpu_torch.exec.eval import version_ns as _vns

        vts = _vns(c.version)
        for w in n.what:
            # only bare-ident targets name a table statically; anything
            # else must NOT be evaluated here (it runs again in
            # iterate_targets: double side effects)
            tbn = None
            if isinstance(w, Idiom) and len(w.parts) == 1 and \
                    isinstance(w.parts[0], PField):
                tbn = w.parts[0].name
            if tbn is not None:
                ns_v, db_v = c.need_ns_db()
                if c.txn.get_val_at(K.tb_def(ns_v, db_v, tbn), vts) is None:
                    raise SdbError(f"The table '{tbn}' does not exist")
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


def _target_of(n, ctx):
    return None


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


def _explain_streaming(n: SelectStmt, ctx) -> str:
    """Streaming-executor EXPLAIN string (reference exec/ operator tree
    pretty-print, used under planner-strategy all-ro). EXPLAIN ANALYZE
    executes and annotates {rows: N} per operator + a Total rows line."""
    from surrealdb_tpu_torch.exec.render_def import _expr_sql
    from surrealdb_tpu_torch.idx.planner import (
        _choose_index,
        _classify_preds,
        _find_knn,
        _find_matches,
        _remove_node,
        get_indexes_for,
    )

    analyze = n.explain in ("analyze", "analyze-json", "postfix-full")
    json_fmt = n.explain in (
        "json", "analyze-json", "postfix", "postfix-full"
    )
    orig_n = n
    if (
        analyze
        and not json_fmt
        and not getattr(
            ctx.session, "redact_volatile_explain_attrs", False
        )
    ):
        # stream-eligible statements ANALYZE through the real operator
        # tree: measured rows/batches/elapsed per operator (reference
        # exec/operators/explain.rs AnalyzePlan). The redacted
        # (deterministic) form below serves the language-test harness.
        from surrealdb_tpu_torch.exec.stream import try_stream_analyze

        real = try_stream_analyze(n, ctx)
        if real is not None:
            return real

    # ORDER BY id is the natural scan order (reversed for DESC): the
    # sort is elided and LIMIT/START push into the scan — only when the
    # plan is a plain table scan (no predicate can pick an index)
    scan_dir = "Forward"
    single_target = len(n.what) == 1
    if (
        n.order
        and n.order != "rand"
        and len(n.order) == 1
        and expr_name(n.order[0][0]) == "id"
        and n.cond is None
        and single_target
    ):
        # only a TABLE scan can absorb id-order into scan direction;
        # RecordIdScan ranges keep the SortTopKByKey (reference
        # reverse_iterator_range_new_executor)
        try:
            _tv = _target_value(n.what[0], ctx)
        except SdbError:
            _tv = None
        if isinstance(_tv, Table):
            if n.order[0][1] == "desc":
                scan_dir = "Backward"
            n = _strip_order(n)

    # resolve scan children (one per FROM target)
    scans = []  # (label_fn, scan_rows)
    rid_range_scan = False
    total_scan_rows = 0
    residual = n.cond
    # KNN in the WHERE tree: KnnScan (HNSW access path) or KnnTopK (the
    # pipeline-breaking brute-force aggregate, exec/operators/knn_topk.rs)
    knn = _find_knn(n.cond) if n.cond is not None else None
    knn_residual = _remove_node(n.cond, knn) if knn is not None else None
    knn_brute = None
    for expr in n.what:
        # subquery FROM sources nest their own full sub-plan (reference
        # streaming planner: the inner SELECT is an operator subtree)
        sub_sel = None
        se = _unwrap_start(expr)
        if isinstance(se, Subquery) and isinstance(se.stmt, SelectStmt):
            sub_sel = se.stmt
        if sub_sel is not None:
            import copy as _copy

            sub = _copy.copy(sub_sel)
            # the sub-plan always renders as text (the outer call alone
            # JSON-encodes); keep only the analyze dimension
            sub.explain = "analyze" if analyze else "explain"
            txt = _explain_streaming(sub, ctx.child())
            sub_lines = [
                l for l in txt.split("\n")
                if l.strip() and not l.startswith("Total rows")
            ]
            rows = (
                len(list(_iterate_value(_target_value(expr, ctx), ctx)))
                if analyze else 0
            )
            scans.append(("__raw__", rows, sub_lines))
            total_scan_rows += rows
            continue
        v = _target_value(expr, ctx)
        if isinstance(v, RecordId):
            rows = len(list(_iterate_value(v, ctx))) if analyze else 0
            if isinstance(v.id, Range):
                rid_range_scan = True
                rg = v.id
                rid_s = (
                    f"{v.tb}:{render(rg.beg)}"
                    + ("..=" if rg.end_incl else "..")
                    + render(rg.end)
                )
            else:
                rid_s = v.render()
            scans.append(
                (f"RecordIdScan [ctx: Db] [record_id: {rid_s}]", rows)
            )
            total_scan_rows += rows
            continue
        if not isinstance(v, Table):
            rows = len(list(_iterate_value(v, ctx))) if analyze else 0
            from surrealdb_tpu_torch.expr.ast import Cast as _Cst, \
                RangeExpr as _Rng

            src_e = _unwrap_start(expr)
            if isinstance(src_e, _Cst) and isinstance(src_e.expr, _Rng):
                # `..` is a binary operator in the reference grammar, so
                # a cast-of-range renders `<array>  0 .. 5`
                from surrealdb_tpu_torch.exec.coerce import kind_name as _kn2

                rg = src_e.expr
                beg = _expr_sql(rg.beg) if rg.beg is not None else ""
                end = _expr_sql(rg.end) if rg.end is not None else ""
                src = f"<{_kn2(src_e.kind)}>  {beg} .. {end}"
            else:
                src = _expr_sql(src_e)
            scans.append(
                (f"SourceExpr [ctx: Db] [expr: {src}]", rows)
            )
            total_scan_rows += rows
            continue
        tb = v.name
        pushed_limit = pushed_offset = None
        indexes = get_indexes_for(tb, ctx)
        if n.with_index:
            indexes = [i for i in indexes if i.name in n.with_index]
        noindex = n.with_index == []
        label = None
        if knn is not None:
            qv = evaluate(knn.rhs, ctx)
            dim = len(qv) if isinstance(qv, list) else 0
            idef_h = None
            if not noindex and knn.dist is None:
                from surrealdb_tpu_torch.idx.planner import _field_path as _fpk

                kpath = _fpk(knn.lhs)
                idef_h = next(
                    (d for d in indexes
                     if d.hnsw is not None and d.cols_str
                     and d.cols_str[0] == kpath),
                    None,
                )
            if idef_h is not None:
                rows = 0
                if analyze:
                    from surrealdb_tpu_torch.idx.planner import plan_scan

                    plan = plan_scan(tb, n.cond, ctx.child(), n)
                    rows = sum(1 for _ in plan) if plan is not None else 0
                label = (
                    f"KnnScan [ctx: Db] [index: {idef_h.name}, k: {knn.k}, "
                    f"ef: {knn.ef or 40}, dimension: {dim}]"
                )
                residual = knn_residual  # rendered as a Filter above
                scans.append((label, rows))
                total_scan_rows += rows
                continue
            knn_brute = (knn, dim)
            if single_target and knn_residual is not None:
                rows = 0
                if analyze:
                    for src in _iterate_value(v, ctx, None, None):
                        doc = src.doc if src.rid is not None else src.value
                        cc = ctx.with_doc(doc, src.rid)
                        if is_truthy(evaluate(knn_residual, cc)):
                            rows += 1
                label = (
                    f"TableScan [ctx: Db] [table: {tb}, direction: Forward, "
                    f"predicate: {_expr_sql(knn_residual)}]"
                )
            else:
                rows = (
                    len(list(_iterate_value(v, ctx, None, None)))
                    if analyze else 0
                )
                label = (
                    f"TableScan [ctx: Db] [table: {tb}, direction: Forward]"
                )
            residual = None
            scans.append((label, rows))
            total_scan_rows += rows
            continue
        # a MATCHES candidate scores 800 (exec/index/analysis.rs:1281):
        # it loses to a unique full-equality access (1000) but beats
        # non-unique eq (500) and ranges — defer the choice until the
        # eq/range candidates are scored below
        mts = _find_matches(n.cond) if n.cond is not None and not noindex else []
        ft_cand = None
        if mts:
            mt = mts[0]
            idef = next((d for d in indexes if d.fulltext is not None), None)
            if idef is not None:
                ft_cand = (mt, idef)
        if label is None and n.cond is not None and not noindex:
            from surrealdb_tpu_torch.idx.planner import (
                _array_like_paths,
                _ft_branch_scan,
                or_union_branches,
                union_branch_scan,
            )

            # plan-time `type::field($param)` resolution applies to the
            # union analysis too (schemaless parameterized scans)
            orb = or_union_branches(
                tb, _resolve_type_fields(n.cond, ctx), indexes, ctx,
                value_idioms=False,
            )
            if orb is not None:
                from surrealdb_tpu_torch.val import hashable

                branch_lines = []
                seen_u = set()
                for br in orb:
                    brows = 0
                    if br["kind"] == "ft":
                        q = evaluate(br["mt"].rhs, ctx)
                        bl = (
                            f"FullTextScan [ctx: Db] "
                            f"[index: {br['idef'].name}, query: {q}]"
                        )
                    elif br["kind"] == "range":
                        acc = " ".join(
                            f"{op}{render(evaluate(vx, ctx))}"
                            for op, vx in sorted(
                                br["tail"][1],
                                key=lambda t: t[0] in ("<", "<="),
                            )
                        )
                        bl = (
                            f"IndexScan [ctx: Db] [index: {br['idef'].name}, "
                            f"access: {acc}, direction: Forward]"
                        )
                    elif br["kind"] == "in":
                        iv = evaluate(br["tail"][1], ctx)
                        iv = iv if isinstance(iv, list) else [iv]
                        acc = (
                            f"= {render(iv[0])}" if len(iv) == 1
                            else f"IN {render(iv)}"
                        )
                        bl = (
                            f"IndexScan [ctx: Db] [index: {br['idef'].name}, "
                            f"access: {acc}, direction: Forward]"
                        )
                    else:
                        idef_b = br["idef"]
                        eq_vals = [
                            evaluate(br["eqs"][c], ctx)
                            for c in idef_b.cols_str[:br["nmatch"]]
                        ]
                        acc = (
                            f"= {render(eq_vals[0])}"
                            if len(eq_vals) == 1 and br["tail"] is None
                            and len(idef_b.cols_str) == 1
                            else "[" + ", ".join(
                                render(x) for x in eq_vals) + "]"
                        )
                        bl = (
                            f"IndexScan [ctx: Db] [index: {idef_b.name}, "
                            f"access: {acc}, direction: Forward]"
                        )
                    if analyze:
                        srcs = list(union_branch_scan(tb, br, ctx.child()))
                        brows = len(srcs)
                        for s in srcs:
                            if s.rid is not None:
                                seen_u.add(hashable(s.rid))
                    branch_lines.append((bl, brows))
                urows = len(seen_u) if analyze else 0
                scans.append((
                    f"UnionIndexScan [ctx: Db] [table: {tb}, "
                    f"branches: {len(orb)}]",
                    urows, branch_lines,
                ))
                total_scan_rows += urows
                residual = n.cond
                continue

            cond_plan = _resolve_type_fields(n.cond, ctx)
            eqs, ins, rngs = _classify_preds(
                cond_plan, _array_like_paths(tb, ctx), value_idioms=False
            )
            chosen = _choose_index(indexes, eqs, ins, rngs) if (
                eqs or ins or rngs
            ) else None
            union_branches = None
            if chosen is not None:
                idef, nmatch, tail, chosen_score = chosen
                if tail is not None and tail[0] == "in" and nmatch == 0:
                    iv = evaluate(tail[1], ctx)
                    iv = iv if isinstance(iv, list) else [iv]
                    if len(iv) > 32:
                        # large IN arrays fall back to a table scan
                        # (reference: in_operator_large_array_fallback)
                        chosen = None
                    else:
                        union_branches = (idef, iv)
            if ft_cand is not None and (
                chosen is None or chosen[3] <= 800
            ):
                # the MATCHES access (800) outranks everything but a
                # unique full-equality candidate
                mt, idef_ft = ft_cand
                q = evaluate(mt.rhs, ctx)
                label = (
                    f"FullTextScan [ctx: Db] [index: {idef_ft.name}, "
                    f"query: {q}]"
                )
                residual = _remove_node(residual, mt)
                # the scan line reports the raw full-text hit count; the
                # residual Filter above it shows the post-filter rows
                rows = 0
                if analyze:
                    rows = len(list(_ft_branch_scan(
                        tb, {"mt": mt, "idef": idef_ft}, ctx.child()
                    )))
                scans.append((label, rows))
                total_scan_rows += rows
                continue
            if union_branches is not None and len(union_branches[1]) == 1:
                idef, iv = union_branches
                bv = iv[0]
                label = (
                    f"IndexScan [ctx: Db] [index: {idef.name}, "
                    f"access: = {render(bv)}, direction: Forward]"
                )
                rows = (
                    len(list(_iterate_value(v, ctx, n.cond, n)))
                    if analyze else 0
                )
                scans.append((label, rows))
                total_scan_rows += rows
                continue
            if union_branches is not None:
                idef, iv = union_branches
                branches = []
                col = idef.cols_str[0]
                base_path = col.replace("….", "").replace("…", "")
                for bv in iv:
                    brows = 0
                    if analyze:
                        from surrealdb_tpu_torch.syn.parser import Parser as _P

                        parts = _P(base_path)._field_name_parts()
                        for src in _iterate_value(v, ctx):
                            doc = src.doc if src.rid is not None else src.value
                            cc = ctx.with_doc(doc, src.rid)
                            cv = evaluate(Idiom(parts), cc)
                            if isinstance(cv, list):
                                flat = []
                                for x in cv:
                                    flat.extend(x if isinstance(x, list) else [x])
                                if any(value_cmp(x, bv) == 0 for x in flat):
                                    brows += 1
                            elif value_cmp(cv, bv) == 0:
                                brows += 1
                    bacc = (
                        f"[{render(bv)}]" if len(idef.cols_str) > 1
                        else f"= {render(bv)}"
                    )
                    branches.append((
                        f"IndexScan [ctx: Db] [index: {idef.name}, "
                        f"access: {bacc}, direction: Forward]",
                        brows,
                    ))
                urows = 0
                if analyze:
                    from surrealdb_tpu_torch.syn.parser import Parser as _P

                    parts = _P(base_path)._field_name_parts()
                    for src in _iterate_value(v, ctx):
                        doc = src.doc if src.rid is not None else src.value
                        cc = ctx.with_doc(doc, src.rid)
                        cv = evaluate(Idiom(parts), cc)
                        flat = []
                        if isinstance(cv, list):
                            for x in cv:
                                flat.extend(x if isinstance(x, list) else [x])
                        else:
                            flat = [cv]
                        if any(
                            value_cmp(x, bv) == 0 for bv in iv for x in flat
                        ):
                            urows += 1
                scans.append((
                    f"UnionIndexScan [ctx: Db] [table: {tb}, "
                    f"branches: {len(branches)}]",
                    urows, branches,
                ))
                total_scan_rows += urows
                continue
            if chosen is not None:
                vals = [evaluate(eqs[c], ctx) for c in idef.cols_str[:nmatch]]
                if nmatch == 0 and tail is not None and tail[0] == "range":
                    # single-column range: compact ">2000 <2020" form
                    acc = " ".join(
                        f"{op}{render(evaluate(vx, ctx))}"
                        for op, vx in sorted(
                            tail[1], key=lambda t: t[0] in ("<", "<=")
                        )
                    )
                    tail = ("rng_done", tail[1])
                elif len(idef.cols_str) > 1 or tail is not None:
                    acc = "[" + ", ".join(render(x) for x in vals) + "]"
                else:
                    acc = f"= {render(vals[0])}" if vals else "[]"
                # composite tails: only the FIRST range bound rides the
                # index access; later bounds — and any IN tail after an
                # eq prefix — drop to a residual Filter (the reference's
                # streaming executor pushes a single compound range)
                extra_bound_vxs = []
                in_tail_residual = False
                if tail is not None and tail[0] == "range":
                    # composite access pushes exactly ONE bound (cond
                    # order); every other bound filters above the scan
                    opmap = {">": "MoreThan", ">=": "MoreThanEqual",
                             "<": "LessThan", "<=": "LessThanEqual"}
                    op, vx = tail[1][0]
                    acc += f" {opmap.get(op, op)} {render(evaluate(vx, ctx))}"
                    extra_bound_vxs = [vx2 for _o2, vx2 in tail[1][1:]]
                elif tail is not None and tail[0] == "in":
                    if nmatch:
                        in_tail_residual = True
                    else:
                        acc += f" IN {render(evaluate(tail[1], ctx))}"
                direction = "Forward"
                if (
                    n.order
                    and n.order != "rand"
                    and len(n.order) == 1
                    and tail is not None
                    and tail[0] in ("range", "rng_done")
                ):
                    oexpr, odir, _oc, _on = n.order[0]
                    from surrealdb_tpu_torch.idx.planner import _field_path as _fp

                    if _fp(oexpr) == idef.cols_str[nmatch] \
                            and single_target:
                        if odir == "desc":
                            direction = "Backward"
                        n = _strip_order(n)
                if (
                    idef.unique
                    and nmatch == len(idef.cols_str)
                    and tail is None
                    and n.order
                    and n.order != "rand"
                ):
                    # a UNIQUE full-equality access yields at most one row:
                    # the streaming planner elides the sort entirely
                    n = _strip_order(n)
                limattr = ""
                if (
                    n.limit is not None
                    and n.group is None
                    and (not n.order or n.order == [])
                    and single_target
                ):
                    pushed_limit = int(evaluate(n.limit, ctx))
                    limattr = f", limit: {pushed_limit}"
                    n = _strip_limit(n)
                    if n.start is not None:
                        # START pushes with LIMIT (reference limit/offset
                        # pushdown into the index scan)
                        limattr += f", offset: {int(evaluate(n.start, ctx))}"
                        n = _strip_start(n)
                label = (
                    f"IndexScan [ctx: Db] [index: {idef.name}, access: {acc}, "
                    f"direction: {direction}{limattr}]"
                )
                # residual: predicates not covered by the index
                covered = set(idef.cols_str[:nmatch])
                if tail is not None and not in_tail_residual:
                    covered.add(idef.cols_str[nmatch])
                preds = []
                from surrealdb_tpu_torch.idx.planner import _split_ands, _field_path

                _split_ands(n.cond, preds)
                keep = []
                for pred in preds:
                    from surrealdb_tpu_torch.expr.ast import Binary as _B

                    pth = None
                    enforceable = False
                    is_extra_bound = False
                    if isinstance(pred, _B):
                        lp0 = _field_path(pred.lhs)
                        pth = lp0 or _field_path(pred.rhs)
                        # containment accesses (value INSIDE field, field
                        # CONTAINS v) scan candidate elements — the
                        # predicate always re-filters above the scan
                        enforceable = pred.op in (
                            "=", "==", "<", "<=", ">", ">="
                        ) or (pred.op == "∈" and lp0 is not None)
                        # later range bounds on the tail column dropped
                        # out of the access string — they filter above
                        is_extra_bound = any(
                            pred.rhs is vx or pred.lhs is vx
                            for vx in extra_bound_vxs
                        )
                    if pth is None or pth not in covered or not enforceable \
                            or is_extra_bound:
                        keep.append(pred)
                residual = None
                for pred in keep:
                    from surrealdb_tpu_torch.expr.ast import Binary as _B

                    residual = (
                        pred if residual is None
                        else _B("&&", residual, pred)
                    )
        if (
            label is None
            and n.cond is None
            and n.order
            and n.order != "rand"
            and len(n.order) == 1
            and n.group is None
            and n.start is None
            and not noindex
            and single_target
        ):
            # ORDER BY an indexed column: scan the index in order and
            # push the limit into the scan (reference limit pushdown)
            oexpr, odir, _oc, _on2 = n.order[0]
            opath = expr_name(oexpr)
            idef2 = next(
                (d for d in indexes
                 if d.cols_str and d.cols_str[0] == opath
                 and d.fulltext is None and d.hnsw is None),
                None,
            )
            if idef2 is not None:
                direction = "Backward" if odir == "desc" else "Forward"
                limattr = ""
                if n.limit is not None:
                    pushed_limit = int(evaluate(n.limit, ctx))
                    limattr = f", limit: {pushed_limit}"
                label = (
                    f"IndexScan [ctx: Db] [index: {idef2.name}, access: "
                    f", direction: {direction}{limattr}]"
                )
                n = _strip_limit(_strip_order(n))
        if label is None and n.cond is not None and single_target:
            # point lookup: a conjunct `id = <record>` scans one record
            # (reference RecordIdScan)
            prid = _id_eq_rid(n.cond, tb)
            if prid is not None:
                from surrealdb_tpu_torch.exec.stream import _inline_params

                pred_s = _expr_sql(
                    _elide_count_args(_inline_params(n.cond, ctx))
                )
                label = (
                    f"RecordIdScan [ctx: Db] [record_id: {prid.render()}, "
                    f"predicate: {pred_s}]"
                )
                residual = None
        if label is None and ctx.doc is not None and single_target:
            # scans inside a per-document context (computed fields, field
            # clauses) re-plan per evaluation: the reference labels them
            # DynamicScan with params UN-inlined (they're row-dynamic)
            extra = ""
            if n.cond is not None:
                extra += f", predicate: {_expr_sql(n.cond)}"
                residual = None
            if n.limit is not None and not n.order and n.group is None:
                extra += f", limit: {int(evaluate(n.limit, ctx))}"
                if n.start is not None:
                    extra += f", offset: {int(evaluate(n.start, ctx))}"
            label = f"DynamicScan [ctx: Db] [source: {tb}{extra}]"
        if label is None:
            extra = ""
            if n.cond is not None and single_target:
                # a single table scan absorbs the predicate; multi-source
                # and subquery plans keep a Filter node above (reference
                # explain/complex.surql). Params render inlined: physical
                # exprs hold evaluated constants.
                from surrealdb_tpu_torch.exec.stream import _inline_params
                extra += f", predicate: {_expr_sql(_elide_count_args(_inline_params(n.cond, ctx)))}"
                residual = None
            if (
                n.limit is not None
                and not n.order
                and n.group is None
            ):
                pushed_limit = int(evaluate(n.limit, ctx))
                extra += f", limit: {pushed_limit}"
                if n.start is not None:
                    pushed_offset = int(evaluate(n.start, ctx))
                    extra += f", offset: {pushed_offset}"
            label = (
                f"TableScan [ctx: Db] [table: {tb}, "
                f"direction: {scan_dir}{extra}]"
            )
        if analyze:
            # scans report their own emitted rows (pre-residual-filter);
            # table scans with inlined predicates report post-filter
            if label.startswith("TableScan") and n.cond is not None:
                kept = 0
                for src in _iterate_value(v, ctx, None, None):
                    doc = src.doc if src.rid is not None else src.value
                    cc = ctx.with_doc(doc, src.rid)
                    if is_truthy(evaluate(n.cond, cc)):
                        kept += 1
                rows = kept
            else:
                rows = len(list(_iterate_value(v, ctx, n.cond, n)))
            # a limit pushed into the scan caps the rows it emits
            if pushed_limit is not None:
                off = pushed_offset or 0
                rows = max(0, min(pushed_limit, rows - off))
        else:
            rows = 0
        scans.append((label, rows))
        total_scan_rows += rows

    # assemble the tree bottom-up
    mid_lines = []
    # run the select for row counts of upper operators
    out_rows_n = 0
    if analyze:
        saved = orig_n.explain
        orig_n.explain = None
        try:
            result = _s_select(orig_n, ctx.child())
        finally:
            orig_n.explain = saved
        out_rows_n = len(result) if isinstance(result, list) else 1

    root_lines = []
    lookup_lines = []  # raw pre-indented graph field.lookup sub-trees
    scan_lines = []  # (reldepth, text, rows)

    def _emit_scan(depth, entry):
        if entry[0] == "__raw__":
            # a nested sub-plan: pre-rendered lines, re-indented at
            # assembly relative to this slot
            for line in entry[2]:
                scan_lines.append((("raw", depth), line, 0))
            return
        scan_lines.append((depth, entry[0], entry[1]))
        if len(entry) > 2 and entry[2]:
            for bl, br in entry[2]:
                scan_lines.append((depth + 1, bl, br))

    if len(scans) > 1:
        scan_lines.append((0, "Union [ctx: Db]", total_scan_rows))
        for entry in scans:
            _emit_scan(1, entry)
    else:
        _emit_scan(0, scans[0])
    if knn_brute is not None:
        knn_o, dim_o = knn_brute
        dist_name = (knn_o.dist or "EUCLIDEAN").capitalize()
        filt_line = None
        if len(scans) > 1 and knn_residual is not None:
            filt_rows = 0
            if analyze:
                for expr in n.what:
                    vv = _target_value(expr, ctx)
                    for src in _iterate_value(vv, ctx, None, None):
                        doc = src.doc if src.rid is not None else src.value
                        cc = ctx.with_doc(doc, src.rid)
                        if is_truthy(evaluate(knn_residual, cc)):
                            filt_rows += 1
            filt_line = (
                f"Filter [ctx: Db] [predicate: {_expr_sql(knn_residual)}]",
                filt_rows,
            )
        else:
            filt_rows = scans[0][1] if scans else 0
        ktop_rows = min(knn_o.k, filt_rows) if analyze else 0
        wrapped = [(
            0,
            f"KnnTopK [ctx: Db] [field: {expr_name(knn_o.lhs)}, "
            f"k: {knn_o.k}, distance: {dist_name}, dimension: {dim_o}]",
            ktop_rows,
        )]
        shift = 1
        if filt_line is not None:
            wrapped.append((1, filt_line[0], filt_line[1]))
            shift = 2
        scan_lines = wrapped + [(_shift_depth(d, shift), t, r) for d, t, r in scan_lines]
    if not single_target and n.cond is not None and knn_brute is None:
        # multi-source plans always filter above the Union — a per-branch
        # index access can't cover the other branches (explain/complex)
        residual = n.cond
    if residual is not None:
        # rows THROUGH the filter: equals the final row count except under
        # grouping, where the aggregate collapses them (5581_select_count)
        filt_rows = out_rows_n
        if analyze and n.group is not None and single_target:
            try:
                v0 = _target_value(n.what[0], ctx)
                cctx = ctx.child()
                filt_rows = 0
                for src in _iterate_value(v0, cctx, n.cond, n):
                    doc = src.doc if src.rid is not None else src.value
                    if n.cond is None or cctx._cond_consumed or is_truthy(
                        evaluate(n.cond, cctx.with_doc(doc, src.rid))
                    ):
                        filt_rows += 1
            except SdbError:
                filt_rows = out_rows_n
        scan_lines = [
            (0, "Filter [ctx: Db] [predicate: "
             f"{_expr_sql(_label_cond(residual, ctx))}]",
             filt_rows)
        ] + [(_shift_depth(d, 1), t, r) for d, t, r in scan_lines]
    if n.split:
        names = ", ".join(expr_name(sp) for sp in n.split)
        scan_lines = [
            (0, f"Split [ctx: Db] [on: {names}]", out_rows_n)
        ] + [(_shift_depth(d, 1), t, r) for d, t, r in scan_lines]
    # aggregation / projection root
    if n.group is not None:
        if n.group:
            by = ", ".join(expr_name(g) for g in n.group) or ", ".join(
                (a or expr_name(e))
                for e, a in n.exprs
                if e != "*" and not _is_aggregate(e)
            )
            root_lines.append((f"Aggregate [ctx: Db] [by: {by}]", out_rows_n))
        else:
            # count-only GROUP ALL uses the dedicated count scans
            only_count = (
                len(n.exprs) == 1
                and isinstance(n.exprs[0][0], FunctionCall)
                and n.exprs[0][0].name.lower() == "count"
                and not n.exprs[0][0].args
            )
            if only_count and len(n.what) == 1 and len(scans) == 1:
                label, rows = scans[0][0], scans[0][1]
                tbname = label.split("table: ")[1].split(",")[0].rstrip(
                    "]"
                ) if "table: " in label else None
                tv = _target_value(n.what[0], ctx)
                if isinstance(tv, RecordId) and isinstance(tv.id, Range) \
                        and n.cond is None:
                    rg = tv.id
                    rsrc = (
                        f"{tv.tb}:{render(rg.beg)}"
                        + ("..=" if rg.end_incl else "..")
                        + render(rg.end)
                    )
                    text = f"CountScan [ctx: Db] [source: {rsrc}]"
                    return _render_tree([(0, text, 1 if analyze else 0)],
                                        analyze, 1)
                if label.startswith("TableScan") and n.cond is None:
                    from surrealdb_tpu_torch.val import escape_ident as _esc2

                    text = (
                        f"CountScan [ctx: Db] [source: {_esc2(tbname)}]"
                    )
                    return _render_tree([(0, text, 1 if analyze else 0)],
                                        analyze, 1)
                if label.startswith("IndexScan") and residual is None:
                    # a count scan needs the index to cover the WHOLE
                    # predicate; residuals require real documents
                    tbn = _target_value(n.what[0], ctx).name
                    cond_s = _expr_sql(n.cond) if n.cond is not None else ""
                    text = (
                        f"IndexCountScan [ctx: Db] [source: {tbn}, "
                        f"condition: {cond_s}]"
                    )
                    return _render_tree([(0, text, 1 if analyze else 0)],
                                        analyze, 1)
            root_lines.append(
                ("Aggregate [ctx: Db] [mode: GROUP ALL]",
                 max(out_rows_n, 1))
            )
    else:
        if n.value is not None:
            root_lines.append(
                (f"ProjectValue [ctx: Db] [expr: {_expr_sql(n.value)}]",
                 out_rows_n)
            )
            if isinstance(n.value, Idiom):
                prec = next(
                    (p for p in n.value.parts if isinstance(p, PRecurse)),
                    None,
                )
                if prec is not None:
                    pi = n.value.parts.index(prec)
                    lookup_lines.append((
                        "expr.recurse",
                        _recurse_flat(prec, n.value.parts[pi + 1:]),
                    ))
        else:
            # bare `Project` is the pass-through root over RecordIdScans
            # (point lookups, keys-only counts); once an ORDER/LIMIT
            # pipeline sits above the scan the reference renders the full
            # SelectProject (explain/select_basic, count_range_keys_only
            # vs reverse_iterator_range)
            only_rid_scans = scans and all(
                entry[0].startswith("RecordIdScan")
                and "predicate:" not in entry[0] for entry in scans
            ) and not (n.order and n.order != "rand") and n.limit is None
            graph_projs = bool(n.exprs) and all(
                e != "*" and isinstance(e, Idiom)
                and any(isinstance(p, PGraph) for p in e.parts)
                for e, _a in n.exprs
            )
            if graph_projs:
                # graph-lookup projections: bare Project root with one
                # `field.lookup:` sub-tree per projection
                root_lines.append(("Project [ctx: Db]", out_rows_n))
                for e, _a in n.exprs:
                    flat = _graph_hops_flat(e.parts)
                    if flat:
                        lookup_lines.append(("field.lookup", flat))
            elif only_rid_scans:
                root_lines.append(("Project [ctx: Db]", out_rows_n))
            else:
                def _proj_name(e, a):
                    if a:
                        return a
                    # destructure projections list the BASE field; the
                    # destructure itself runs in a Compute node
                    if isinstance(e, Idiom):
                        cut = next(
                            (ix for ix, p in enumerate(e.parts)
                             if isinstance(p, PDestructure)), None)
                        if cut:
                            return expr_name(Idiom(list(e.parts[:cut])))
                    return expr_name(e)

                projs = ", ".join(
                    "*" if e == "*" else _proj_name(e, a) for e, a in n.exprs
                )
                root_lines.append(
                    (f"SelectProject [ctx: Db] [projections: {projs}]",
                     out_rows_n)
                )
                # function-call fields render with elided args (reference
                # operator pretty-print: `vector::distance::knn(...)`)
                computed = [
                    f"{a or expr_name(e)} = " + (
                        f"{e.name}(...)" if isinstance(e, FunctionCall)
                        else _expr_sql(e)
                    )
                    for e, a in n.exprs
                    if e != "*" and not isinstance(e, Idiom)
                ]
                for e, a in n.exprs:
                    if e == "*" or not isinstance(e, Idiom):
                        continue
                    if any(isinstance(p, PDestructure) for p in e.parts) \
                            and not any(
                                isinstance(p, PRecurse) for p in e.parts
                            ):
                        computed.append(
                            f"{_proj_name(e, a)} = "
                            f"{expr_name(e, sql=True)}"
                        )
                # recursion idioms compute through a Recurse sub-plan
                for e, a in n.exprs:
                    if e == "*" or not isinstance(e, Idiom):
                        continue
                    prec = next(
                        (p for p in e.parts if isinstance(p, PRecurse)),
                        None,
                    )
                    if prec is None:
                        continue
                    nm = a or expr_name(e)
                    computed.append(f"{nm} = {expr_name(e, sql=True)}")
                    pi = e.parts.index(prec)
                    lookup_lines.append((
                        f"{nm}.recurse",
                        _recurse_flat(prec, e.parts[pi + 1:]),
                    ))
                if computed:
                    mid_lines.insert(
                        0,
                        (f"Compute [ctx: Db] [fields: {', '.join(computed)}]",
                         out_rows_n),
                    )
    # order / limit layers: grouped sorts sit ABOVE the Aggregate; plain
    # sorts sit under the projection
    if n.order and n.order != "rand":
        keys = ", ".join(
            f"{expr_name(e)} {'DESC' if d == 'desc' else 'ASC'}"
            for e, d, _c, _n2 in n.order
        )
        if n.group is not None:
            if n.limit is not None:
                lim = int(evaluate(n.limit, ctx))
                root_lines.insert(
                    0,
                    (f"SortTopK [ctx: Db] [order_by: {keys}, limit: {lim}]",
                     out_rows_n),
                )
            else:
                root_lines.insert(
                    0, (f"Sort [ctx: Db] [order_by: {keys}]", out_rows_n)
                )
        elif n.limit is not None:
            lim = int(evaluate(n.limit, ctx))
            off = int(evaluate(n.start, ctx)) if n.start is not None else 0
            # sorts sit directly under the projection, above Compute; the
            # top-k keeps limit+offset rows, the Limit node drops the skip
            mid_lines.insert(
                0,
                (f"SortTopKByKey [ctx: Db] [sort_keys: {keys}, "
                 f"limit: {lim + off}]",
                 out_rows_n)
            )
            limattr2 = f"limit: {lim}, offset: {off}" \
                if n.start is not None else f"limit: {lim}"
            mid_lines.insert(
                0, (f"Limit [ctx: Db] [{limattr2}]", out_rows_n)
            )
        else:
            # ORDER BY id ASC over a single forward table scan streams in
            # key order already — the sort is elided (iterator order)
            id_asc = (
                len(n.order) == 1
                and n.order[0][1] != "desc"
                and expr_name(n.order[0][0]) == "id"
                and len(scans) == 1
                and scans[0][0].startswith("TableScan")
                and "direction: Forward" in scans[0][0]
            )
            if not id_asc:
                mid_lines.insert(
                    0,
                    (f"SortByKey [ctx: Db] [sort_keys: {keys}]", out_rows_n)
                )
    if n.limit is not None and n.group is not None:
        lim = int(evaluate(n.limit, ctx))
        root_lines.insert(0, (f"Limit [ctx: Db] [limit: {lim}]", out_rows_n))
    if n.fetch:
        fields = ", ".join(expr_name(f) for f in n.fetch)
        root_lines.insert(
            0, (f"Fetch [ctx: Db] [fields: {fields}]", out_rows_n)
        )
    stacked = [(i, t, r) for i, (t, r) in enumerate(root_lines + mid_lines)]
    base = len(stacked)
    raw = []
    for label, flat in lookup_lines:
        for line in _lookup_raw_lines(label, flat, max(base - 1, 0)):
            raw.append((None, line, 0))
    shifted = []
    for d, t, r in scan_lines:
        if isinstance(d, tuple):
            shifted.append((None, "    " * (base + d[1]) + t, 0))
        else:
            shifted.append((base + d, t, r))
    ordered = stacked + raw + shifted
    if json_fmt:
        return _tree_to_json(ordered, analyze, out_rows_n)
    return _render_tree(ordered, analyze, out_rows_n)


def _id_eq_rid(cond, tb):
    """A top-level AND conjunct `id = <record>` / `<record> = id` (or ==)
    naming the scanned table -> the RecordId, else None (RecordIdScan)."""
    from surrealdb_tpu_torch.expr.ast import Binary as _B, Literal as _L

    preds = []
    from surrealdb_tpu_torch.idx.planner import _split_ands

    _split_ands(cond, preds)
    for p in preds:
        if not (isinstance(p, _B) and p.op in ("=", "==")):
            continue
        for lhs, rhs in ((p.lhs, p.rhs), (p.rhs, p.lhs)):
            if isinstance(lhs, Idiom) and len(lhs.parts) == 1 and \
                    isinstance(lhs.parts[0], PField) and \
                    lhs.parts[0].name == "id":
                v = None
                if isinstance(rhs, _L) and isinstance(rhs.value, RecordId):
                    v = rhs.value
                else:
                    from surrealdb_tpu_torch.expr.ast import RecordIdLit as _RL

                    if isinstance(rhs, _RL):
                        try:
                            from surrealdb_tpu_torch.exec.static_eval import (
                                static_value,
                            )

                            v = static_value(rhs)
                        except Exception:
                            v = None
                if isinstance(v, RecordId) and v.tb == tb and \
                        not isinstance(v.id, Range):
                    return v
    return None


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


def _label_cond(node, ctx):
    """Filter-label rendering: function args elide (count(...),
    type::field(...)) and doc-free IN/INSIDE arrays fold to their
    evaluated values."""
    import copy as _copy

    from surrealdb_tpu_torch.expr.ast import ArrayExpr as _AE
    from surrealdb_tpu_torch.expr.ast import Binary as _B, Constant as _C
    from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC
    from surrealdb_tpu_torch.expr.ast import Literal as _L

    def rec(e):
        if isinstance(e, _FC) and e.args and e.name.lower() in (
            "count", "type::field", "type::fields"
        ):
            e2 = _copy.copy(e)
            e2.args = [_C("...")]
            return e2
        if isinstance(e, _B):
            e2 = _copy.copy(e)
            e2.lhs = rec(e.lhs)
            e2.rhs = rec(e.rhs)
            if e2.op in ("∈", "IN") and isinstance(e.rhs, _AE):
                try:
                    e2.rhs = _L(evaluate(e.rhs, ctx))
                except SdbError:
                    pass
            return e2
        return e

    return rec(node)


def _strip_order(n):
    import copy as _copy

    n2 = _copy.copy(n)
    n2.order = []
    return n2


def _strip_limit(n):
    import copy as _copy

    n2 = _copy.copy(n)
    n2.limit = None
    return n2


def _strip_start(n):
    import copy as _copy

    n2 = _copy.copy(n)
    n2.start = None
    return n2


import re as _re_mod


def _tree_to_json(entries, analyze, total):
    """Structured (FORMAT JSON) explain: {operator, context, attributes,
    children[, metrics, total_rows]} (reference exec explain JSON)."""
    # raw pre-indented lookup lines (depth None) carry no tree position;
    # recover depth from their indentation so the JSON nest stays sane
    fixed = []
    for d, t, r in entries:
        if d is None:
            stripped = t.lstrip(" ")
            d = max((len(t) - len(stripped)) // 4, 0)
            t = stripped
        fixed.append((d, t, r))
    entries = fixed
    rx = _re_mod.compile(
        r"^(?P<op>\w+) \[ctx: (?P<ctx>\w+)\](?: \[(?P<attrs>.*)\])?$"
    )

    def parse(text):
        m = rx.match(text)
        if m is None:
            return {"operator": text, "context": "Db", "attributes": {}}
        attrs = {}
        raw = m.group("attrs")
        if raw:
            for part in _re_mod.split(r", (?=[\w.]+: )", raw):
                k, _, v = part.partition(": ")
                attrs[k] = v
        out = {
            "operator": m.group("op"),
            "context": m.group("ctx"),
            "attributes": attrs,
        }
        if m.group("op") == "Filter" and "predicate" in attrs:
            # reference Filter nodes also carry an expressions list
            out["expressions"] = [
                {"role": "predicate", "sql": attrs["predicate"]}
            ]
        return out

    nodes = []
    stack = []  # (depth, node)
    root = None
    for depth, text, rows in entries:
        node = parse(text)
        node["children"] = []
        if analyze:
            node["metrics"] = {"output_rows": rows}
        while stack and stack[-1][0] >= depth:
            stack.pop()
        if stack:
            stack[-1][1]["children"].append(node)
        else:
            root = node
        stack.append((depth, node))
        nodes.append(node)
    if root is None:
        root = {"operator": "Empty", "context": "Db", "attributes": {},
                "children": []}
    def prune(nd):
        if not nd["children"]:
            nd.pop("children", None)
        else:
            for ch in nd["children"]:
                prune(ch)
    prune(root)
    if analyze:
        root["total_rows"] = total
    return root


def _unwrap_start(e):
    """Unwrap a single-part start-tuple idiom to its inner expression."""
    if isinstance(e, Idiom) and len(e.parts) == 1 and \
            isinstance(e.parts[0], tuple) and e.parts[0][0] == "start":
        return e.parts[0][1]
    return e


def _shift_depth(d, k):
    """Shift a scan-line depth by k; raw sub-plan lines carry tuple depths."""
    if isinstance(d, tuple):
        return (d[0], d[1] + k)
    return d + k


def _render_tree(entries, analyze, total):
    out = []
    for depth, text, rows in entries:
        if depth is None:
            # raw pre-indented line (graph lookup sub-trees)
            out.append(text)
            continue
        line = ("    " * depth) + text
        if analyze:
            line += f" {{rows: {rows}}}"
        out.append(line)
    s = "\n".join(out) + "\n"
    if analyze:
        s += f"\nTotal rows: {total}"
    return s


def _graph_hops_flat(parts):
    """Top-down node labels for a graph-lookup chain: hops render
    outermost-last-hop-first, ending at CurrentValueSource (reference
    exec/operators/scan/graph.rs GraphEdgeScan explain). Subquery hops
    render their SELECT plan over a FullEdge-output scan."""
    from surrealdb_tpu_torch.exec.render_def import _expr_sql
    from surrealdb_tpu_torch.expr.ast import PGraph

    arrows = {"out": "->", "in": "<-", "both": "<->", "ref": "<~"}
    hops = [p for p in parts if isinstance(p, PGraph)]
    if not hops:
        return None
    flat = []
    for g in reversed(hops):
        if getattr(g, "expr", None) is not None:
            sel = g.expr
            tbls = ", ".join(expr_name(w) for w in sel.what)
            if sel.group:
                by = ", ".join(expr_name(x) for x in sel.group)
                flat.append(f"Aggregate [ctx: Db] [by: {by}]")
            else:
                projs = ", ".join(
                    "*" if e == "*" else (a or expr_name(e))
                    for e, a in sel.exprs
                ) or "*"
                flat.append(
                    f"SelectProject [ctx: Db] [projections: {projs}]"
                )
            if sel.cond is not None:
                flat.append(
                    f"Filter [ctx: Db] [predicate: {_expr_sql(sel.cond)}]"
                )
            flat.append(
                f"GraphEdgeScan [ctx: Db] [direction: {arrows[g.dir]}, "
                f"tables: {tbls}, output: FullEdge]"
            )
        else:
            tbls = ", ".join(w[0] for w in g.what) if g.what else "?"
            flat.append(
                f"GraphEdgeScan [ctx: Db] [direction: {arrows[g.dir]}, "
                f"tables: {tbls}, output: TargetId]"
            )
    flat.append("CurrentValueSource [ctx: Rt]")
    return flat


def _recurse_flat(prec, following=()):
    """Node labels for a `.{n}` recursion: a Recurse head, then the
    repeated path's hop chain. A destructure body (inside the braces or
    as the following part) is `pattern: tree` with no hop chain."""
    from surrealdb_tpu_torch.expr.ast import PDestructure as _PD

    if prec.min == prec.max and prec.min is not None:
        depth_s = str(prec.min)
    elif prec.max is None:
        depth_s = f"{1 if prec.min is None else prec.min}.."
    else:
        depth_s = f"{1 if prec.min is None else prec.min}..{prec.max}"
    attrs = (
        f"depth: {depth_s}, instruction: {prec.instruction or 'default'}"
    )
    inner = list(prec.parts or [])
    nxt = following[0] if following else None
    if any(isinstance(x, _PD) for x in inner) or (
        not inner and isinstance(nxt, _PD)
    ):
        attrs += ", pattern: tree"
        return [f"Recurse [ctx: Db] [{attrs}]"]
    head = [f"Recurse [ctx: Db] [{attrs}]"]
    hops = _graph_hops_flat(inner)
    return head + (hops if hops else ["CurrentValueSource [ctx: Rt]"])


def _lookup_raw_lines(label, flat, parent_depth):
    """Render a `{label}: <tree>` block: the label line sits 2 spaces past
    the parent's indent, nested nodes 4 more each."""
    base = "    " * parent_depth + "  "
    lines = [f"{base}{label}: {flat[0]}"]
    for i, lab in enumerate(flat[1:], 1):
        lines.append(base + "    " * i + lab)
    return lines


def _graph_lookup_lines(parts, label, parent_depth=0):
    flat = _graph_hops_flat(parts)
    if flat is None:
        return None
    return _lookup_raw_lines(label, flat, parent_depth)


def _s_explain_generic(n: ExplainStmt, ctx: Ctx):
    """EXPLAIN of non-select statements: AST pretty-print (Rt context)."""
    from surrealdb_tpu_torch.exec.render_def import _expr_sql

    lines = []

    def walk_node(node, depth):
        from surrealdb_tpu_torch.expr.ast import (
            BreakStmt as _Br,
            ContinueStmt as _Co,
            ForStmt as _For,
            IfElse as _If,
            LetStmt as _Let,
            ReturnStmt as _Ret,
            Subquery as _Sub,
            ThrowStmt as _Th,
        )

        if isinstance(node, _Ret):
            lines.append((depth, "Return [ctx: Rt]"))
            walk_node(node.what, depth + 1)
        elif isinstance(node, _Th):
            lines.append(
                (depth, f"Expr [ctx: Rt] [expr: THROW {_expr_sql(node.what)}]")
            )
        elif isinstance(node, _Br):
            lines.append((depth, "Expr [ctx: Rt] [expr: BREAK]"))
        elif isinstance(node, _Co):
            lines.append((depth, "Expr [ctx: Rt] [expr: CONTINUE]"))
        elif isinstance(node, _Let):
            lines.append((depth, f"Let [ctx: Rt] [param: ${node.name}]"))
            walk_node(node.what, depth + 1)
        elif isinstance(node, _For):
            from surrealdb_tpu_torch.expr.ast import BlockExpr as _Blk

            nstmts = (
                len(node.body.stmts) if isinstance(node.body, _Blk) else 1
            )
            lines.append((
                depth,
                f"Foreach [ctx: Rt] [param: {node.param}, statements: {nstmts}]",
            ))
        elif isinstance(node, _If):
            attrs = f"branches: {len(node.branches)}"
            if node.otherwise is not None:
                attrs += ", has_else: true"
            lines.append((depth, f"IfElse [ctx: Rt] [{attrs}]"))
        elif isinstance(node, _Sub):
            walk_node(node.stmt, depth)
        elif isinstance(node, SleepStmt):
            dur = evaluate(node.duration, ctx)
            lines.append((
                depth,
                f"Sleep [ctx: Rt] [duration: {render(dur)}]",
            ))
        elif isinstance(node, Idiom) and any(
            isinstance(p, PGraph) for p in node.parts
        ):
            # graph-lookup idiom: the Expr line plus a nested lookup tree
            from surrealdb_tpu_torch.exec.render_def import _select_sql

            arrows = {"out": "->", "in": "<-", "both": "<->", "ref": "<~"}
            pieces = []
            for p in node.parts:
                if isinstance(p, tuple) and p[0] == "start":
                    pieces.append(f"({_expr_sql(p[1])})")
                elif isinstance(p, PGraph):
                    if getattr(p, "expr", None) is not None:
                        pieces.append(
                            f"{arrows[p.dir]}({_select_sql(p.expr)})"
                        )
                    else:
                        nm = ", ".join(w[0] for w in p.what) \
                            if p.what else "?"
                        pieces.append(f"{arrows[p.dir]}{nm}")
                elif isinstance(p, PField):
                    pieces.append(f".{p.name}")
            lines.append(
                (depth, f"Expr [ctx: Db] [expr: {''.join(pieces)}]")
            )
            for raw in _graph_lookup_lines(node.parts, "expr.lookup"):
                lines.append((None, raw))
        else:
            lines.append((depth, f"Expr [ctx: Rt] [expr: {_expr_sql(node)}]"))

    walk_node(n.stmt, 0)
    out = []
    rows_suffix = " {rows: 0}" if n.analyze else ""
    for depth, text in lines:
        if depth is None:
            out.append(text)
            continue
        out.append(("    " * depth) + text + rows_suffix)
    s_out = "\n".join(out) + "\n"
    if n.analyze:
        # bare expressions report one row; control-flow statements zero
        is_bare = lines and lines[0][1].startswith("Expr ")
        total = 1 if is_bare else 0
        s_out += f"\nTotal rows: {total}"
    return s_out


def _explain_select(n: SelectStmt, ctx):
    """EXPLAIN — report the plan the iterator would use (dbs/plan.rs).
    EXPLAIN FULL also executes and reports fetch counts."""
    if ctx.session.planner_strategy == "all-ro":
        return _explain_streaming(n, ctx)
    from surrealdb_tpu_torch.idx.planner import explain_plan

    out = []
    range_target = False
    for expr in n.what:
        v = _target_value(expr, ctx)
        if isinstance(v, Table):
            plan_e = explain_plan(v.name, n.cond, ctx, n)
            out.extend(plan_e if isinstance(plan_e, list) else [plan_e])
            if n.with_index == []:
                out.append(
                    {
                        "detail": {"reason": "WITH NOINDEX"},
                        "operation": "Fallback",
                    }
                )
        elif isinstance(v, RecordId) and isinstance(v.id, Range):
            rg = v.id
            direction = "forward"
            if (
                n.order
                and n.order != "rand"
                and len(n.order) == 1
                and n.order[0][1] == "desc"
                and expr_name(n.order[0][0]) == "id"
            ):
                direction = "backward"
            rs = rg
            range_target = True
            count_only_rng = (
                n.cond is None
                and not n.order
                and len(n.exprs) == 1
                and isinstance(n.exprs[0][0], FunctionCall)
                and n.exprs[0][0].name.lower() == "count"
                and not n.exprs[0][0].args
            )
            if count_only_rng and n.group == []:
                rng_op = "Iterate Range Count"
            elif count_only_rng and n.group is None:
                rng_op = "Iterate Range Keys"
            else:
                rng_op = "Iterate Range"
            out.append(
                {
                    "detail": {
                        "direction": direction,
                        "range": rs,
                        "table": v.tb,
                    },
                    "operation": rng_op,
                }
            )
        else:
            out.append(
                {
                    "detail": {"type": "Value"},
                    "operation": "Iterate Value",
                }
            )
    # an index range scan that consumed the ORDER BY (in-order / backward
    # iteration) behaves order-free for the start/limit strategy
    # (iterator.rs can_cancel_on_limit); the marker is internal-only
    order_consumed = any([
        o.get("detail", {}).pop("_order_consumed", False)
        for o in out
        if isinstance(o.get("detail"), dict)
    ])  # list-comp: pop the marker from EVERY entry before any() looks
    out.append(_collector_detail(n, ctx))
    if n.explain in ("full", "postfix-full"):
        out.append(
            {
                "detail": {"type": "KeysAndValues"},
                "operation": "RecordStrategy",
            }
        )
        if (n.start is not None or n.limit is not None) \
                and not range_target:
            # mirrors iterator.rs can_start_skip / can_cancel_on_limit:
            # START pushes to storage only for a single unfiltered iterator
            # (or an index that applies the WHERE itself) with no ORDER BY;
            # LIMIT cancels early unless GROUP BY or un-indexed ORDER BY
            index_backed = bool(out) and str(
                out[0].get("operation", "")
            ).startswith("Iterate Index")
            can_skip = (
                not n.group
                and len(n.what) == 1
                and (n.cond is None or index_backed)
                and (not n.order or order_consumed)
            )
            can_cancel = not n.group and (not n.order or order_consumed)
            detail = {}
            if n.limit is not None and can_cancel:
                detail["CancelOnLimit"] = int(evaluate(n.limit, ctx))
            if n.start is not None and can_skip:
                sv = int(evaluate(n.start, ctx))
                if sv:
                    detail["SkipStart"] = sv
            if detail:
                out.append(
                    {"detail": detail, "operation": "StartLimitStrategy"}
                )
        count = 0
        for expr in n.what:
            v = _target_value(expr, ctx)
            cctx = ctx.child()
            for src in _iterate_value(v, cctx, n.cond, n):
                # the fetch stage counts rows that reach the collector:
                # post-WHERE (scan access paths may over-approximate)
                if n.cond is not None and not cctx._cond_consumed:
                    doc = src.doc if src.rid is not None else src.value
                    cc = cctx.with_doc(doc, src.rid)
                    if not is_truthy(evaluate(n.cond, cc)):
                        continue
                count += 1
        if n.start is not None:
            count = max(count - int(evaluate(n.start, ctx)), 0)
        if n.limit is not None:
            count = min(count, int(evaluate(n.limit, ctx)))
        # an in-order (range-plan) index scan cancelled on limit streams
        # straight from the index: the fetch stage reports 0
        if any(
            o.get("operation") == "StartLimitStrategy"
            and "CancelOnLimit" in o.get("detail", {})
            for o in out
        ) and any(
            o.get("operation") == "Iterate Index"
            and isinstance(o.get("detail", {}).get("plan"), dict)
            and "from" in o["detail"]["plan"]
            for o in out
        ):
            count = 0
        # a top-k collector (MemoryOrderedLimit) holds full rows — the
        # fetch stage never re-reads records (reference: count always 0)
        if any(
            o.get("operation") == "Collector"
            and o.get("detail", {}).get("type") == "MemoryOrderedLimit"
            for o in out
        ):
            count = 0
        out.append({"detail": {"count": count}, "operation": "Fetch"})
    return out


# ---------------------------------------------------------------------------
# write statements -> document pipeline
# ---------------------------------------------------------------------------


def _explain_write(n, ctx):
    from surrealdb_tpu_torch.idx.planner import explain_plan

    # UPSERT defers record creation (Iterable::Defer); other writes on a
    # direct record id iterate the record (dbs/iterator.rs)
    defer = type(n).__name__ == "UpsertStmt"
    out = []
    for expr in n.what:
        v = _target_value(expr, ctx)
        if isinstance(v, Table):
            if defer and n.cond is None:
                # bare-table UPSERT yields one new record — it never
                # scans the table (Iterable::Yield)
                out.append({
                    "detail": {"table": v.name},
                    "operation": "Iterate Yield",
                })
                continue
            plan_e = explain_plan(v.name, n.cond, ctx, n)
            out.extend(plan_e if isinstance(plan_e, list) else [plan_e])
        elif isinstance(v, RecordId) and not isinstance(v.id, Range):
            out.append({
                "detail": {"record": v},
                "operation": "Iterate Defer" if defer else "Iterate Record",
            })
        else:
            out.append({"detail": {"type": "Value"}, "operation": "Iterate Value"})
    out.append({"detail": {"type": "Memory"}, "operation": "Collector"})
    return out


def threading_active() -> int:
    import threading

    return threading.active_count()


def _collector_detail(n: SelectStmt, ctx=None):
    """Collector explain entry; GROUP queries report their aggregation
    slots (reference Group collector: _aN aggregations over exprN argument
    slots, _gN group expressions)."""
    if n.group is None:
        if n.order and n.order != "rand" and n.limit is not None                 and ctx is not None:
            # ordered + limited: the collector keeps start+limit rows
            lim = int(evaluate(n.limit, ctx))
            if n.start is not None:
                lim += int(evaluate(n.start, ctx))
            return {
                "detail": {"limit": lim, "type": "MemoryOrderedLimit"},
                "operation": "Collector",
            }
        ctype = "MemoryOrdered" if n.order else "Memory"
        return {"detail": {"type": ctype}, "operation": "Collector"}
    _AGG_NAMES = {
        "count": "Count", "math::sum": "Sum", "math::mean": "Mean",
        "__count_value__": "CountValue",
        "math::min": "Min", "math::max": "Max", "time::min": "DatetimeMin",
        "time::max": "DatetimeMax", "math::stddev": "StdDev",
        "math::variance": "Variance",
    }
    from surrealdb_tpu_torch.exec.render_def import _expr_sql

    aggs = {}
    sel = {}
    group_exprs = {}
    agg_exprs = {}
    expr_slots: dict = {}  # arg text -> exprN
    ai = 0
    # group slots are numbered in GROUP BY clause order (catalog
    # aggregation planner walks the GROUP BY list, not the projection)
    group_slots: dict = {}  # select-field name -> _gN
    non_agg: dict = {}  # select-field name -> expr
    for expr, alias in n.exprs:
        if expr == "*":
            continue
        if not (
            isinstance(expr, FunctionCall) and expr.name.lower() in _AGG_NAMES
        ):
            non_agg[alias or expr_name(expr)] = expr
    if isinstance(n.group, list):
        for g in n.group:
            gname = expr_name(g)
            gkey = f"_g{len(group_slots)}"
            group_slots[gname] = gkey
            src = non_agg.get(gname, g)
            group_exprs[gkey] = _expr_sql(src)
    for expr, alias in n.exprs:
        if expr == "*":
            continue
        name = alias or expr_name(expr)
        if isinstance(expr, FunctionCall) and expr.name.lower() in _AGG_NAMES:
            key = f"_a{ai}"
            ai += 1
            base = _AGG_NAMES[expr.name.lower()]
            if expr.args:
                if expr.name.lower() == "count":
                    base = "CountValue"
                argtext = expr_name(expr.args[0])
                slot = expr_slots.get(argtext)
                if slot is None:
                    slot = f"expr{len(expr_slots)}"
                    expr_slots[argtext] = slot
                    agg_exprs[slot] = argtext
                aggs[key] = f"{base}({slot})"
            else:
                aggs[key] = base
            sel[name] = key
        else:
            gkey = group_slots.get(name)
            if gkey is None:
                gkey = f"_g{len(group_slots)}"
                group_slots[name] = gkey
                group_exprs[gkey] = _expr_sql(expr)
            sel[name] = gkey
    return {
        "detail": {
            "Aggregate expressions": agg_exprs,
            "Aggregations": aggs,
            "Group expressions": group_exprs,
            "Select expression": sel,
            "type": "Group",
        },
        "operation": "Collector",
    }


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
        return _explain_write(n, ctx)
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
        return _explain_write(n, ctx)
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
        return _explain_write(n, ctx)
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


def _base_phrase(base, ctx):
    if base == "root":
        return "in the root"
    if base == "ns":
        return f"in the namespace '{ctx.session.ns}'"
    return f"in the database '{ctx.session.db}'"


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
    cf = None
    if n.changefeed is not None:
        from surrealdb_tpu_torch.val import Duration

        d = evaluate(n.changefeed, ctx)
        cf = d.ns if isinstance(d, Duration) else int(d)
    ctx.txn.set_val(
        K.db_def(ns, n.name),
        DatabaseDef(n.name, n.comment, cf, strict=getattr(n, "strict", False)),
    )
    return NONE


def _s_define_table(n: DefineTable, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if _exists_guard(ctx, K.tb_def(ns, db, n.name), n.name, "table",
                     n.if_not_exists, n.overwrite):
        return NONE
    cf = None
    if n.changefeed is not None:
        from surrealdb_tpu_torch.val import Duration

        d = evaluate(n.changefeed, ctx)
        cf = d.ns if isinstance(d, Duration) else int(d)
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
    if n.view is not None:
        _materialize_view(tdef, ctx)
    return NONE


def _materialize_view(tdef: TableDef, ctx):
    """Populate a `DEFINE TABLE ... AS SELECT` view at definition time by
    feeding every existing source record through the incremental engine
    (reference doc/table.rs model — leaves per-group aggregation stats in
    place for later writes). Build errors don't fail the DEFINE."""
    from surrealdb_tpu_torch.exec import views as V
    from surrealdb_tpu_torch.exec.document import rebuild_view, view_source_tables
    from surrealdb_tpu_torch.kvs.api import deserialize

    try:
        analysis = V.analyze_view(tdef.view)
    except V.Unsupported:
        analysis = None
    if analysis is None:
        try:
            rebuild_view(tdef, ctx)
        except SdbError:
            pass
        return
    ns, db = ctx.need_ns_db()
    # clear any stale rows + stats for a redefinition
    ctx.txn.delete_range(*K.prefix_range(K.record_prefix(ns, db, tdef.name)))
    ctx.txn.delete_range(*K.prefix_range(K.view_meta(ns, db, tdef.name)))
    try:
        for src in view_source_tables(tdef.view):
            beg, end = K.prefix_range(K.record_prefix(ns, db, src))
            for k, raw in list(ctx.txn.scan(beg, end)):
                doc = deserialize(raw)
                rid = doc.get("id") if isinstance(doc, dict) else None
                if not isinstance(rid, RecordId):
                    _ns2, _db2, _tb2, idv = K.decode_record_id(k)
                    rid = RecordId(src, idv)
                V.process_view(tdef, analysis, rid, NONE, doc, "CREATE", ctx)
    except SdbError:
        pass


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
    eng = ctx.ds.vector_indexes.pop((ns, db, tb, ix), None)
    if eng is not None:
        # REMOVE INDEX / REBUILD INDEX: the runner keeps no stale store
        eng.release_device()


def _s_define_event(n: DefineEvent, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if ctx.txn.get(K.tb_def(ns, db, n.tb)) is None:
        ctx.txn.set_val(K.tb_def(ns, db, n.tb), TableDef(name=n.tb))
    kdef = K.ev_def(ns, db, n.tb, n.name)
    if _exists_guard(ctx, kdef, n.name, "event", n.if_not_exists, n.overwrite):
        return NONE
    ctx.txn.set_val(kdef, EventDef(
        n.name, n.when, n.then, n.comment,
        getattr(n, "async_", False), getattr(n, "retry", None),
        getattr(n, "maxdepth", None),
    ))
    return NONE


def _s_define_param(n: DefineParam, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    kdef = K.pa_def(ns, db, n.name)
    if _exists_guard(ctx, kdef, f"${n.name}", "param", n.if_not_exists, n.overwrite):
        return NONE
    v = evaluate(n.value, ctx)
    ctx.txn.set_val(kdef, ParamDef(n.name, v, n.permissions, n.comment))
    return NONE


def _s_define_function(n: DefineFunction, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    kdef = K.fc_def(ns, db, n.name)
    if _exists_guard(ctx, kdef, n.name, "function", n.if_not_exists,
                     n.overwrite,
                     msg=f"The function 'fn::{n.name}' already exists"):
        return NONE
    ctx.txn.set_val(
        kdef,
        FunctionDef(n.name, n.args, n.block, n.returns, n.permissions, n.comment),
    )
    return NONE


_BASE_RANK = {"root": 0, "ns": 1, "db": 2}


def _s_define_analyzer(n: DefineAnalyzer, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    kdef = K.az_def(ns, db, n.name)
    if _exists_guard(ctx, kdef, n.name, "analyzer", n.if_not_exists, n.overwrite):
        return NONE
    ctx.txn.set_val(
        kdef, AnalyzerDef(n.name, n.tokenizers, n.filters, n.function, n.comment)
    )
    return NONE


def _s_define_user(n: DefineUser, ctx):
    from surrealdb_tpu_torch.fnc.misc_fns import password_hash

    base = n.base
    # a principal can only manage users at or below its own base
    # (reference Options::is_allowed level check / fn auth_limit)
    sess_base = getattr(ctx.session, "auth_base", "root")
    if _BASE_RANK.get(base, 2) < _BASE_RANK.get(sess_base, 0):
        raise SdbError(
            "IAM error: Not enough permissions to perform this action"
        )
    if base in ("ns", "db") and not ctx.session.ns:
        raise SdbError("Specify a namespace to use")
    if base == "db" and not ctx.session.db:
        raise SdbError("Specify a database to use")
    ns = ctx.session.ns if base in ("ns", "db") else None
    db = ctx.session.db if base == "db" else None
    kdef = K.us_def(base, ns, db, n.name)
    ulabel = {"root": "root user", "ns": "namespace user",
              "db": "database user"}[base]
    if _exists_guard(ctx, kdef, n.name, ulabel, n.if_not_exists, n.overwrite):
        return NONE
    ph = n.passhash or (password_hash(n.password) if n.password else "")
    ctx.txn.set_val(
        kdef, UserDef(n.name, base, ph, n.roles, n.duration, n.comment)
    )
    return NONE


def _s_define_access(n: DefineAccess, ctx):
    base = n.base
    ns = ctx.session.ns if base in ("ns", "db") else None
    db = ctx.session.db if base == "db" else None
    # materialize expression-valued config (KEY $key etc.) and validate
    # the algorithm surface (reference access_type.rs)
    cfg = dict(n.config)
    for a in ("key", "issuer_key", "url"):
        v = cfg.get(a)
        if isinstance(v, Node):
            rv = evaluate(v, ctx)
            cfg[a] = None if rv is NONE else rv
    kdef = K.ac_def(base, ns, db, n.name)
    if _exists_guard(
        ctx, kdef, n.name, "access", n.if_not_exists, n.overwrite,
        msg=(f"The access method '{n.name}' already exists "
             f"{_base_phrase(base, ctx)}"),
    ):
        # IF NOT EXISTS short-circuits before algorithm validation
        return NONE
    alg = (cfg.get("alg") or "").upper()
    ialg = (cfg.get("issuer_alg") or "").upper()
    if "ES512" in (alg, ialg):
        raise SdbError(
            "The ES512 algorithm is not currently supported. "
            "Please use ES384 or another supported algorithm"
        )
    if alg.startswith("HS") and cfg.get("issuer_key") is not None \
            and cfg.get("key") is not None \
            and cfg["issuer_key"] != cfg["key"]:
        raise SdbError(
            f"Invalid query: Symmetric algorithm {alg} requires the same "
            "key for signing and verification. Use the same key value for "
            "both KEY and WITH ISSUER KEY clauses, or omit WITH ISSUER KEY."
        )
    ctx.txn.set_val(
        kdef, AccessDef(n.name, base, n.kind, cfg, n.duration, n.comment)
    )
    return NONE


def _s_define_sequence(n: DefineSequence, ctx):
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    kdef = K.seq_state(ns, db, n.name)
    if ctx.txn.get(kdef) is not None:
        if n.if_not_exists:
            return NONE
        if not n.overwrite:
            raise SdbError(f"The sequence '{n.name}' already exists")
    tmo = None
    if n.timeout is not None:
        from surrealdb_tpu_torch.val import Duration

        tmo = evaluate(n.timeout, ctx)
        if not isinstance(tmo, Duration):
            raise SdbError(f"Expected a duration but found {render(tmo)}")
    sd = SequenceDef(n.name, n.batch, n.start, tmo)
    ctx.txn.set_val(kdef, (sd, n.start))
    ctx.ds.sequences.pop((ns, db, n.name), None)  # drop stale local batch
    return NONE


def _s_define_config(n: DefineConfig, ctx):
    from surrealdb_tpu_torch.catalog import (
        ApiActionDef,
        ApiDef,
        BucketDef,
        ConfigDef,
    )

    if n.what == "DEFAULT":
        # KV-level default session namespace/database (INFO FOR KV .defaults)
        key = K.cfg_def("", "", "DEFAULT")
        if _exists_guard(ctx, key, "DEFAULT", "config", n.if_not_exists,
                         n.overwrite):
            return NONE
        ctx.txn.set_val(key, dict(n.config))
        return NONE
    _ensure_ns_db(ctx)
    ns, db = ctx.need_ns_db()
    if n.what == "API_DEF":
        from surrealdb_tpu_torch.api import validate_define_path

        cfg = n.config
        validate_define_path(str(cfg["path"]))
        key = K.api_def(ns, db, cfg["path"])
        if _exists_guard(ctx, key, cfg["path"], "api", n.if_not_exists,
                         n.overwrite):
            return NONE
        # middleware args are computed at define time (reference:
        # parameterized/schema/api.surql renders fn::middleware('auth'))
        def _mw(mw):
            return [
                (name, [Literal(evaluate(a, ctx)) for a in args])
                for name, args in mw
            ]

        actions = [
            ApiActionDef(a["methods"], _mw(a["middleware"]), a["permissions"],
                         a["then"])
            for a in cfg["actions"]
        ]
        comment = cfg.get("comment")
        if comment is not None and not isinstance(comment, str):
            comment = evaluate(comment, ctx)
            if comment is NONE:
                comment = None
        ctx.txn.set_val(key, ApiDef(cfg["path"], actions, None, comment))
        return NONE
    if n.what == "BUCKET":
        cfg = n.config
        key = K.bucket_def(ns, db, cfg["name"])
        if _exists_guard(ctx, key, cfg["name"], "bucket", n.if_not_exists,
                         n.overwrite):
            return NONE
        comment = cfg.get("comment")
        if comment is not None and not isinstance(comment, str):
            comment = evaluate(comment, ctx)
            if comment is NONE:
                comment = None
        from surrealdb_tpu_torch.buc import check_backend_allowed

        backend = cfg.get("backend")
        if backend is not None and not isinstance(backend, str):
            backend = evaluate(backend, ctx)
        check_backend_allowed(backend)
        ctx.txn.set_val(
            key,
            BucketDef(cfg["name"], backend,
                      cfg.get("readonly", False),
                      cfg.get("permissions", True), comment),
        )
        return NONE
    key = K.cfg_def(ns, db, n.what)
    if _exists_guard(ctx, key, n.what, "config", n.if_not_exists, n.overwrite,
                     msg=f"The config for {n.what.lower()} already exists"):
        return NONE
    cd = ConfigDef(n.what)
    cfg = n.config
    if "middleware" in cfg:
        cd.middleware = cfg["middleware"]
    if "permissions" in cfg:
        cd.permissions = cfg["permissions"]
    if "tables" in cfg:
        cd.tables = cfg["tables"]
    if "functions" in cfg:
        cd.functions = cfg["functions"]
    if "depth" in cfg:
        cd.depth = cfg["depth"]
    if "complexity" in cfg:
        cd.complexity = cfg["complexity"]
    if "introspection" in cfg:
        cd.introspection = cfg["introspection"]
    ctx.txn.set_val(key, cd)
    return NONE


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
        # a table with dependent views cannot be removed (reference
        # catalog guard; view/removed.surql, view/delete_view.surql)
        from surrealdb_tpu_torch.exec.document import view_source_tables

        dependents = [
            d.name
            for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.tb_prefix(ns, db)))
            if d.view is not None and d.name != n.name
            and n.name in view_source_tables(d.view)
        ]
        if dependents:
            raise SdbError(
                f"Invalid query: Cannot delete table `{n.name}` on which a "
                f"view is defined, table(s) `{'`, `'.join(dependents)}` are "
                f"defined as a view on this table."
            )
        ctx.txn.delete(key)
        for kk in (K.fd_prefix, K.ix_prefix, K.ev_prefix, K.lq_prefix):
            ctx.txn.delete_range(*K.prefix_range(kk(ns, db, n.name)))
        base = K._tb(ns, db, n.name)
        ctx.txn.delete_range(*K.prefix_range(base))
        for ixkey in list(ctx.ds.vector_indexes):
            if ixkey[:3] == (ns, db, n.name):
                eng = ctx.ds.vector_indexes.pop(ixkey, None)
                if eng is not None:
                    eng.release_device()
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
    if kind == "analyzer":
        key = K.az_def(ns, db, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        return NONE
    if kind == "event":
        key = K.ev_def(ns, db, n.tb, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        return NONE
    if kind == "param":
        key = K.pa_def(ns, db, n.name)
        if ctx.txn.get(key) is None:
            if n.if_exists:
                return NONE
            raise SdbError(f"The param '${n.name}' does not exist")
        ctx.txn.delete(key)
        return NONE
    if kind == "function":
        key = K.fc_def(ns, db, n.name)
        if _guard(key, f"fn::{n.name}"):
            return NONE
        ctx.txn.delete(key)
        return NONE
    if kind == "analyzer":
        key = K.az_def(ns, db, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        return NONE
    if kind == "user":
        base = n.base or "root"
        ulabel = {"root": "root user", "ns": "namespace user",
                  "db": "database user"}[base]
        key = K.us_def(base, ns if base in ("ns", "db") else None,
                       db if base == "db" else None, n.name)
        if ctx.txn.get(key) is None:
            if n.if_exists:
                return NONE
            raise SdbError(f"The {ulabel} '{n.name}' does not exist")
        ctx.txn.delete(key)
        return NONE
    if kind == "access":
        base = n.base or "db"
        key = K.ac_def(base, ns if base in ("ns", "db") else None,
                       db if base == "db" else None, n.name)
        if ctx.txn.get(key) is None:
            if n.if_exists:
                return NONE
            raise SdbError(
                f"The access method '{n.name}' does not exist "
                f"{_base_phrase(base, ctx)}"
            )
        ctx.txn.delete(key)
        return NONE
    if kind == "sequence":
        key = K.seq_state(ns, db, n.name)
        if _guard(key, n.name):
            return NONE
        ctx.txn.delete(key)
        ctx.ds.sequences.pop((ns, db, n.name), None)
        return NONE
    if kind in ("config", "api", "bucket"):
        keyf = {"config": K.cfg_def, "api": K.api_def,
                "bucket": K.bucket_def}[kind]
        nm = n.name.upper() if kind == "config" else n.name
        if kind == "config" and nm == "DEFAULT":
            # DEFINE stores DEFAULT at root level; REMOVE checks there even
            # when ALTER upserted a DB-level copy (reference behaviour)
            key = K.cfg_def("", "", "DEFAULT")
        else:
            key = keyf(ns, db, nm)
        if ctx.txn.get(key) is None:
            if n.if_exists:
                return NONE
            if kind == "config":
                raise SdbError(
                    f"The config for {n.name.lower()} does not exist"
                )
            raise SdbError(f"The {kind} '{nm}' does not exist")
        ctx.txn.delete(key)
        return NONE
    if kind == "module":
        raise NotPorted(f"REMOVE {kind.upper()} is not ported")
    raise SdbError(f"unknown REMOVE kind {kind}")


def _supports_compaction(ctx) -> bool:
    return hasattr(ctx.ds.backend, "compact")


def _s_alter(n: AlterTable, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    key = K.tb_def(ns, db, n.name)
    tdef = ctx.txn.take_val(key)
    if tdef is None:
        if n.if_exists:
            return NONE
        raise SdbError(f"The table '{n.name}' does not exist")
    if getattr(n, "compact", False) and not _supports_compaction(ctx):
        raise SdbError(
            "The storage layer does not support compaction requests."
        )
    if n.full is not None:
        tdef.full = n.full
    if n.drop is not None:
        tdef.drop = n.drop
    if n.kind is not None:
        tdef.kind = n.kind
    if n.relation_from is not None:
        tdef.relation_from = n.relation_from
    if n.relation_to is not None:
        tdef.relation_to = n.relation_to
    if n.permissions is not None:
        tdef.permissions = n.permissions
    if n.comment is not None:
        if n.comment == "__drop__":
            tdef.comment = None
        else:
            c = n.comment
            if isinstance(c, Node):
                c = evaluate(c, ctx)
            tdef.comment = None if c is NONE else c
    if n.changefeed is not None:
        if n.changefeed == "__drop__":
            tdef.changefeed = None
        else:
            from surrealdb_tpu_torch.val import Duration

            d = evaluate(n.changefeed, ctx)
            tdef.changefeed = d.ns if isinstance(d, Duration) else int(d)
    ctx.txn.set_val(key, tdef)
    return NONE


def _s_alter_other(n: AlterStmt, ctx: Ctx):
    """ALTER for non-table definitions: load, apply clause edits, store."""
    ns = ctx.session.ns
    db = ctx.session.db
    kind = n.kind
    labels = {
        "field": "field", "index": "index", "event": "event",
        "param": "param", "function": "function", "analyzer": "analyzer",
        "user": "user", "access": "access", "sequence": "sequence",
        "api": "api", "bucket": "bucket", "config": "config",
    }
    if kind == "database":
        if n.name is not None and ctx.txn.get(K.db_def(ns, n.name)) is None:
            if n.if_exists:
                return NONE
            raise SdbError(f"The database '{n.name}' does not exist")
        if ("compact", True) in (n.changes or []) and not _supports_compaction(ctx):
            raise SdbError(
                "The storage layer does not support compaction requests."
            )
        return NONE  # COMPACT is a maintenance hint elsewhere
    if kind == "config":
        spec = dict(n.changes).get("config_spec") or {}
        what = n.name.upper()
        if what == "DEFAULT":
            # upsert behaviour, stored at DB level (unlike DEFINE, which
            # stores at root — REMOVE CONFIG DEFAULT checks root and errors)
            from surrealdb_tpu_torch.catalog import ConfigDef

            key = K.cfg_def(ns, db, "DEFAULT")
            d = ctx.txn.take_val(key)
            if not isinstance(d, ConfigDef):
                d = ConfigDef("DEFAULT")
            for k2 in ("namespace", "database"):
                if k2 in spec:
                    v = spec[k2]
                    setattr(d, k2, v if isinstance(v, str) else evaluate(v, ctx))
            ctx.txn.set_val(key, d)
            return NONE
        key = K.cfg_def(ns, db, what)
        d = ctx.txn.take_val(key)
        if d is None:
            if n.if_exists:
                return NONE
            raise SdbError(f"The config for {what.lower()} does not exist")
        for k2 in ("middleware", "permissions", "tables", "functions",
                   "depth", "complexity", "introspection"):
            if k2 in spec:
                setattr(d, k2, spec[k2])
        ctx.txn.set_val(key, d)
        return NONE
    if kind == "module":
        raise NotPorted(f"ALTER {kind.upper()} is not ported")
    if kind in ("system", "model"):
        if kind == "system":
            from surrealdb_tpu_torch.val import Duration as _Dur

            for clause, value in (n.changes or []):
                if clause == "compact" and not _supports_compaction(ctx):
                    raise SdbError(
                        "The storage layer does not support compaction "
                        "requests."
                    )
                if clause == "query_timeout":
                    skey = K.sys_cfg()
                    cfg = ctx.txn.take_val(skey) or {}
                    if value == "__drop__":
                        cfg.pop("QUERY_TIMEOUT", None)
                    else:
                        v = evaluate(value, ctx)
                        if not isinstance(v, _Dur):
                            raise SdbError(
                                f"Expected a duration but found {render(v)}"
                            )
                        cfg["QUERY_TIMEOUT"] = v
                    if cfg:
                        ctx.txn.set_val(skey, cfg)
                    else:
                        ctx.txn.delete(skey)
        return NONE
    if kind in ("api", "bucket"):
        keyf = K.api_def if kind == "api" else K.bucket_def
        key = keyf(ns, db, n.name)
        d = ctx.txn.take_val(key)
        if d is None:
            if n.if_exists:
                return NONE
            raise SdbError(f"The {kind} '{n.name}' does not exist")
        for clause, value in n.changes:
            if value == "__drop__":
                if clause == "comment":
                    d.comment = None
                elif clause == "readonly":
                    d.readonly = False
                continue
            if clause == "comment":
                v = value
                if not isinstance(v, (str, type(None))):
                    v = evaluate(v, ctx)
                    if v is NONE:
                        v = None
                d.comment = v
            elif clause == "api_then":
                methods, body = value
                from surrealdb_tpu_torch.catalog import ApiActionDef

                if methods == ["any"]:
                    # the fallback updates in place (it renders first)
                    for a in d.actions:
                        if "any" in a.methods:
                            a.then = body
                            break
                    else:
                        d.actions.append(ApiActionDef(["any"], [], True, body))
                else:
                    # an updated method handler moves to the END of the
                    # action list (the reference removes + re-pushes)
                    for a in list(d.actions):
                        if set(a.methods) == set(methods):
                            d.actions.remove(a)
                            a.then = body
                            d.actions.append(a)
                            break
                    else:
                        d.actions.append(ApiActionDef(methods, [], True, body))
            elif clause == "api_drop_then":
                methods = value
                for a in list(d.actions):
                    if not any(m in a.methods for m in methods):
                        continue
                    # selective drop: surviving methods of a multi-method
                    # group keep the handler under the remaining methods
                    a.methods = [m for m in a.methods if m not in methods]
                    if not a.methods:
                        a.then = None
                        if not a.middleware:
                            d.actions.remove(a)
            elif hasattr(d, clause):
                setattr(d, clause, value)
        ctx.txn.set_val(key, d)
        return NONE
    keymap = {
        "field": lambda: K.fd_def(ns, db, n.tb, n.name if isinstance(n.name, str) else _field_name_str(n.name)),
        "index": lambda: K.ix_def(ns, db, n.tb, n.name),
        "event": lambda: K.ev_def(ns, db, n.tb, n.name),
        "param": lambda: K.pa_def(ns, db, n.name),
        "function": lambda: K.fc_def(ns, db, n.name),
        "analyzer": lambda: K.az_def(ns, db, n.name),
        "user": lambda: K.us_def(
            n.base or "root",
            ns if (n.base or "root") in ("ns", "db") else None,
            db if (n.base or "root") == "db" else None,
            n.name,
        ),
        "access": lambda: K.ac_def(
            n.base or "db",
            ns if (n.base or "db") in ("ns", "db") else None,
            db if (n.base or "db") == "db" else None,
            n.name,
        ),
        "sequence": lambda: K.seq_state(ns, db, n.name),
    }
    key = keymap[kind]()
    stored = ctx.txn.take_val(key)
    if stored is None:
        if n.if_exists:
            return NONE
        disp = n.name
        if kind == "function":
            disp = f"fn::{disp}"
        elif kind == "param":
            disp = f"${disp}"
        if kind == "access":
            raise SdbError(
                f"The access method '{disp}' does not exist "
                f"{_base_phrase(n.base or 'db', ctx)}"
            )
        if kind == "user":
            raise SdbError(
                f"The user '{disp}' does not exist "
                f"{_base_phrase(n.base or 'root', ctx)}"
            )
        raise SdbError(
            f"The {labels.get(kind, kind)} '{disp}' does not exist"
        )
    d = stored[0] if kind == "sequence" else stored
    if kind == "sequence":
        from surrealdb_tpu_torch.val import Duration as _Dur

        for i2, (clause, value) in enumerate(list(n.changes)):
            if clause == "timeout" and value != "__drop__" and not isinstance(
                value, _Dur
            ):
                v2 = evaluate(value, ctx)
                if v2 is NONE or v2 is None:
                    n.changes[i2] = (clause, "__drop__")
                    continue
                if not isinstance(v2, _Dur):
                    raise SdbError(
                        f"Expected a duration but found {render(v2)}"
                    )
                n.changes[i2] = (clause, v2)
    for clause, value in n.changes:
        if value == "__drop__":
            if clause == "comment":
                d.comment = None
            elif clause in ("value", "default", "when"):
                setattr(d, "default" if clause == "default" else clause, None)
            elif clause == "assert":
                d.assert_ = None
            elif clause == "type":
                d.kind = None
            elif clause == "async":
                d.async_ = False
                d.retry = None
                d.maxdepth = None
            elif clause == "readonly":
                d.readonly = False
            elif clause == "flexible":
                d.flex = False
            elif clause in ("tokenizers", "filters", "roles"):
                setattr(d, clause, [])
            elif clause == "duration":
                d.duration = None
            elif clause == "timeout":
                d.timeout = None
            elif clause == "reference":
                d.reference = None
            continue
        if clause == "password":
            from surrealdb_tpu_torch.fnc.misc_fns import password_hash

            d.passhash = password_hash(value)
            continue
        if clause == "value" and kind == "param":
            d.value = evaluate(value, ctx)
            continue
        if hasattr(d, clause):
            v = value
            if clause in ("comment",) and not isinstance(v, (str, type(None))):
                v = evaluate(v, ctx)
                if v is NONE:
                    v = None
            setattr(d, clause, v)
    if kind == "sequence":
        ctx.txn.set_val(key, (d, stored[1]))
    else:
        ctx.txn.set_val(key, d)
    return NONE


def _s_rebuild(n: RebuildIndex, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    idef = ctx.txn.get_val(K.ix_def(ns, db, n.tb, n.name))
    if idef is None:
        if n.if_exists:
            return NONE
        raise SdbError(f"The index '{n.name}' does not exist")
    _remove_index_data(ns, db, n.tb, n.name, ctx)
    from surrealdb_tpu_torch.exec.document import build_index

    build_index(idef, ctx)
    return NONE


# ---------------------------------------------------------------------------
# INFO
# ---------------------------------------------------------------------------


class _AtTxn:
    """Read adapter serving catalog definitions as of a timestamp."""

    def __init__(self, txn, ts: int):
        self._txn = txn
        self._ts = ts

    def get_val(self, key):
        return self._txn.get_val_at(key, self._ts)

    def get(self, key):
        v = self._txn.get_val_at(key, self._ts)
        return None if v is None else b"\x01"

    def scan_vals(self, beg, end, limit=None, reverse=False):
        yield from self._txn.scan_vals_at(beg, end, self._ts)

    def __getattr__(self, name):
        return getattr(self._txn, name)


def _s_info(n: InfoStmt, ctx: Ctx):
    from surrealdb_tpu_torch.exec.render_def import (
        render_access,
        render_analyzer,
        render_db,
        render_event,
        render_field,
        render_function,
        render_index,
        render_ns,
        render_param,
        render_sequence,
        render_table,
        render_user,
    )

    if getattr(n, "version", None) is not None:
        from surrealdb_tpu_torch.exec.eval import version_ns

        ts = version_ns(evaluate(n.version, ctx))
        ctx = ctx.child()
        ctx.txn = _AtTxn(ctx.txn, ts)
    if n.level == "system":
        import os as _os

        mem_kb = 0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        mem_kb = int(line.split()[1])
                        break
        except OSError:
            pass
        # device state from the supervisor: never import torch on a
        # query thread; the runner subprocess owns the card, INFO reads
        # its health snapshot
        from surrealdb_tpu_torch.device import get_supervisor
        from surrealdb_tpu_torch.telemetry import (
            stage_snapshot as _stage_snapshot,
        )

        def _mem_snapshot():
            from surrealdb_tpu_torch.resource import get_accountant

            return get_accountant().snapshot()

        def _columnar_snapshot(ds):
            from surrealdb_tpu_torch.exec.batch import counters, store_nbytes

            out = dict(counters(ds))
            out["colstore_bytes"] = store_nbytes(ds)
            out["colstore_tables"] = len(
                getattr(ds, "_table_columns", {})
            )
            return out

        dev = get_supervisor().status()

        # shard topology (kvs/shard.py): ranges, epochs, primaries —
        # None/absent on unsharded stores. topology() serves the
        # last-known map without network I/O, so this can't stall INFO;
        # SdbError only covers the never-initialised-map edge.
        from surrealdb_tpu_torch.err import (
            QueryCancelled as _QC, QueryTimeout as _QT,
        )

        try:
            shard_topo = ctx.ds.backend.topology()
        except (_QC, _QT):
            raise  # cancellation must never be absorbed by INFO
        except SdbError:
            shard_topo = None
        # follower-read serving state (kvs/remote.py closed-timestamp
        # protocol): per-group closed_ts/lag/era observations plus the
        # session floor and the served/rejected/fallback counters —
        # cache-only, same no-network discipline as topology()
        repl_info = None
        repl_fn = getattr(ctx.ds.backend, "replication_info", None)
        if repl_fn is not None:
            try:
                repl_info = {
                    "groups": repl_fn(),
                    "counters": {
                        k: ctx.ds.telemetry.get(k) for k in (
                            "follower_reads_served",
                            "follower_read_fallbacks",
                        )
                    },
                    "closed_ts_lag_s":
                        ctx.ds.backend.replication_lag_s(),
                }
            except (_QC, _QT):
                raise
            except SdbError:
                repl_info = None
        out = {
            "available_parallelism": _os.cpu_count() or 1,
            "cpu_usage": 0.0,
            "load_average": list(_os.getloadavg()),
            "memory_allocated": mem_kb * 1024,
            "memory_usage": mem_kb * 1024,
            "physical_cores": _os.cpu_count() or 1,
            "threads": threading_active(),
            # the reference's key: the runner's device count when ready
            "tpu_devices": (dev.get("device_count", 0)
                            if dev.get("state") == "ready" else 0),
            # device supervisor health: state (cold/probing/ready/
            # degraded), restart/timeout counters, last error, resident
            # block-cache counts — the serving-side view of the runner
            "device": dev,
            "metrics": dict(ctx.ds.metrics),
            # the slow-query log's last 50 entries (kvs/ds.py; threshold
            # SURREAL_SLOW_QUERY_THRESHOLD_MS)
            "slow_queries": [
                {"ms": ms, "statement": label}
                for ms, label in ctx.ds.slow_log[-50:]
            ],
            # in-flight (non-LIVE) query registry: each id is a valid
            # KILL <query-id> target (inflight.py)
            "queries": ctx.ds.inflight.snapshot(),
            # per-stage query timing (telemetry.stage_record)
            "stages": _stage_snapshot(),
            # live-query fan-out spine health (server/fanout.py):
            # sessions, dispatch backlog, overflow/drop tallies
            "live": dict(ctx.ds.fanout.stats(),
                         subscriptions=len(ctx.ds.live_queries)),
            # node-wide resource governance (resource.py): accounted
            # derived-state bytes vs the soft/hard watermarks, the
            # per-kind breakdown, and eviction/shed/throttle counters
            "mem": _mem_snapshot(),
            # columnar executor health (exec/batch.py + exec/vops.py):
            # vectorized vs fallback rows, aggregate tier hits, column
            # store builds/hits/bytes, fused-KNN and pushdown tallies
            "columnar": _columnar_snapshot(ctx.ds),
        }
        if shard_topo is not None:
            out["shards"] = shard_topo
        if repl_info is not None:
            out["replication"] = repl_info
        # vector index residency — rows, host bytes, ANN state, sync
        # version, mesh width (device_sharded, device/mesh.py), and for
        # shard-partitioned serving (idx/shardvec.py) the per-shard
        # slices + replica addresses — so an operator can see which
        # slice of which index is serving where
        knn_status = []
        for ixkey, eng in list(ctx.ds.vector_indexes.items()):
            ent = {"index": ".".join(str(x) for x in ixkey)}
            status_fn = getattr(eng, "shards_status", None)
            if status_fn is not None:
                ent["shards"] = status_fn()
            else:
                res_fn = getattr(eng, "residency", None)
                if res_fn is None:
                    continue
                ent["residency"] = res_fn()
            knn_status.append(ent)
        if knn_status:
            out["knn"] = knn_status
        return out
    if n.level == "root":
        out = {"accesses": {}, "namespaces": {}, "nodes": {}, "system": {},
               "users": {}}
        syscfg = ctx.txn.get_val(K.sys_cfg())
        if syscfg:
            out["config"] = {k: v for k, v in sorted(syscfg.items())}
        dflt = ctx.txn.get_val(K.cfg_def("", "", "DEFAULT"))
        # always present: {} when no DEFAULT config (remove/config/default)
        out["defaults"] = (
            {k: v for k, v in sorted(dflt.items())} if dflt is not None
            else {}
        )
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ns_prefix())):
            out["namespaces"][d.name] = render_ns(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.us_prefix("root"))):
            out["users"][d.name] = render_user(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ac_prefix("root"))):
            out["accesses"][d.name] = render_access(d)
        return out
    if n.level == "ns":
        ns = ctx.session.ns
        out = {"accesses": {}, "databases": {}, "users": {}}
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.db_prefix(ns))):
            out["databases"][d.name] = render_db(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.us_prefix("ns", ns))):
            out["users"][d.name] = render_user(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ac_prefix("ns", ns))):
            out["accesses"][d.name] = render_access(d)
        return out
    if n.level == "db":
        ns, db = ctx.need_ns_db()
        out = {
            "accesses": {}, "analyzers": {}, "apis": {}, "buckets": {},
            "configs": {}, "functions": {}, "models": {}, "modules": {},
            "params": {}, "sequences": {}, "tables": {}, "users": {},
        }
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.tb_prefix(ns, db))):
            out["tables"][d.name] = render_table(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.pa_prefix(ns, db))):
            out["params"][d.name] = render_param(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.fc_prefix(ns, db))):
            out["functions"][d.name] = render_function(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.mod_prefix(ns, db))):
            txt = f"DEFINE MODULE mod::{d.name} AS <module>"
            if d.comment:
                txt += f" COMMENT '{d.comment}'"
            txt += " PERMISSIONS FULL"
            out["modules"][d.name] = txt
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ml_prefix(ns, db))):
            label = f"{d.name}<{d.version}>"
            txt = f"DEFINE MODEL ml::{d.name}<{d.version}>"
            if d.comment:
                txt += f" COMMENT '{d.comment}'"
            txt += " PERMISSIONS FULL"
            out["models"][label] = txt
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.az_prefix(ns, db))):
            out["analyzers"][d.name] = render_analyzer(d)
        for _k, d in ctx.txn.scan_vals(
            *K.prefix_range(K.us_prefix("db", ns, db))
        ):
            out["users"][d.name] = render_user(d)
        for _k, d in ctx.txn.scan_vals(
            *K.prefix_range(K.ac_prefix("db", ns, db))
        ):
            out["accesses"][d.name] = render_access(d)
        for _k, st in ctx.txn.scan_vals(
            *K.prefix_range(b"/!sq" + K.enc_str(ns) + K.enc_str(db))
        ):
            sd = st[0]
            out["sequences"][sd.name] = render_sequence(sd)
        from surrealdb_tpu_torch.exec.render_def import (
            render_api,
            render_bucket,
            render_config,
        )

        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.api_prefix(ns, db))):
            out["apis"][d.path] = render_api(d)
        for _k, d in ctx.txn.scan_vals(
            *K.prefix_range(K.bucket_prefix(ns, db))
        ):
            out["buckets"][d.name] = render_bucket(d)
        _cfg_names = {"GRAPHQL": "GraphQL", "API": "API", "DEFAULT": "Default"}
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.cfg_prefix(ns, db))):
            out["configs"][_cfg_names.get(d.what, d.what)] = render_config(d)
        if n.structure:
            from surrealdb_tpu_torch.exec.render_def import (
                config_structure,
                table_structure,
            )

            out["configs"] = [
                config_structure(d)
                for _k, d in ctx.txn.scan_vals(
                    *K.prefix_range(K.cfg_prefix(ns, db))
                )
            ]
            # STRUCTURE mode lists structured defs instead of SQL strings
            out["tables"] = [
                table_structure(d)
                for _k, d in ctx.txn.scan_vals(
                    *K.prefix_range(K.tb_prefix(ns, db))
                )
            ]
            seqs = []
            for _k, st in ctx.txn.scan_vals(
                *K.prefix_range(b"/!sq" + K.enc_str(ns) + K.enc_str(db))
            ):
                sd = st[0]
                seqs.append({
                    "name": sd.name,
                    "batch": str(sd.batch),
                    "start": str(sd.start),
                    "timeout": sd.timeout if sd.timeout is not None else NONE,
                })
            out["sequences"] = seqs
            for k2 in ("accesses", "analyzers", "apis", "buckets",
                       "functions", "models", "modules", "params", "users"):
                if isinstance(out.get(k2), dict):
                    out[k2] = list(out[k2].values())
        return out
    if n.level == "table":
        from surrealdb_tpu_torch.exec.render_def import (
            event_structure,
            field_structure,
            index_structure,
        )

        ns, db = ctx.need_ns_db()
        tb = n.target
        if ctx.txn.get(K.tb_def(ns, db, tb)) is None:
            raise SdbError(f"The table '{tb}' does not exist")
        if n.structure:
            out = {"events": [], "fields": [], "indexes": [], "lives": [],
                   "tables": []}
            for _k, d in ctx.txn.scan_vals(
                *K.prefix_range(K.fd_prefix(ns, db, tb))
            ):
                out["fields"].append(field_structure(d, tb))
            for _k, d in ctx.txn.scan_vals(
                *K.prefix_range(K.ix_prefix(ns, db, tb))
            ):
                out["indexes"].append(index_structure(d))
            for _k, d in ctx.txn.scan_vals(
                *K.prefix_range(K.ev_prefix(ns, db, tb))
            ):
                out["events"].append(event_structure(d, tb))
            return out
        out = {"events": {}, "fields": {}, "indexes": {}, "lives": {},
               "tables": {}}
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.fd_prefix(ns, db, tb))):
            from surrealdb_tpu_torch.exec.render_def import field_name_key

            out["fields"][field_name_key(d.name_str)] = render_field(d, tb)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ix_prefix(ns, db, tb))):
            out["indexes"][d.name] = render_index(d)
        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ev_prefix(ns, db, tb))):
            out["events"][d.name] = render_event(d, tb)
        # views (foreign tables) whose FROM sources this table are listed
        # under `tables` (reference catalog: table definitions carry their
        # source link; INFO FOR TABLE shows dependent views)
        from surrealdb_tpu_torch.exec.document import view_source_tables

        for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.tb_prefix(ns, db))):
            if d.view is not None and tb in view_source_tables(d.view):
                out["tables"][d.name] = render_table(d)
        return out
    if n.level == "index":
        ns, db = ctx.need_ns_db()
        idef = ctx.txn.get_val(K.ix_def(ns, db, n.target2, n.target))
        if idef is None:
            raise SdbError(f"The index '{n.target}' does not exist")
        st = ctx.ds.index_builds.get((ns, db, n.target2, n.target))
        if st is None:
            st = {"status": "ready", "initial": 0, "pending": 0,
                  "updated": 0}
        return {"building": dict(st)}
    if n.level == "user":
        explicit = None
        if n.target2:
            t2 = n.target2.lower()
            explicit = {"db": "db", "database": "db", "ns": "ns",
                        "namespace": "ns", "root": "root"}.get(t2)
        bases = (explicit,) if explicit else ("db", "ns", "root")
        key = None
        for b in bases:
            key_try = K.us_def(
                b,
                ctx.session.ns if b in ("ns", "db") else None,
                ctx.session.db if b == "db" else None,
                n.target,
            )
            if ctx.txn.get(key_try) is not None:
                key = key_try
                break
        if key is None:
            if explicit and explicit != "root":
                raise SdbError(
                    f"The user '{n.target}' does not exist "
                    f"{_base_phrase(explicit, ctx)}"
                )
            raise SdbError(f"The root user '{n.target}' does not exist")
        from surrealdb_tpu_torch.exec.render_def import render_user

        return render_user(ctx.txn.get_val(key))
    raise SdbError(f"unknown INFO level {n.level}")


# ---------------------------------------------------------------------------
# LIVE / KILL / SHOW
# ---------------------------------------------------------------------------


_GRANT_POOL = (
    "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)


def _s_show(n: ShowStmt, ctx: Ctx):
    from surrealdb_tpu_torch.cf import read_changes

    return read_changes(n, ctx)


def _s_live(n: LiveStmt, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    what = _target_value(n.what, ctx)
    if not isinstance(what, Table):
        raise SdbError("LIVE SELECT requires a table")
    lid = Uuid.new_v4()
    sub = SubscriptionDef(
        id=str(lid.u),
        ns=ns,
        db=db,
        tb=what.name,
        expr=n.expr,
        cond=n.cond,
        fetch=n.fetch,
        session_vars=dict(ctx.vars),
        auth_level=ctx.session.auth_level,
        rid=ctx.session.rid,
        node=ctx.ds.node_id,
    )
    ctx.txn.set_val(K.lq_def(ns, db, what.name, str(lid.u)), sub)
    ctx.ds.live_queries[str(lid.u)] = sub
    # route to the session's outbox IN THE SAME STEP as registration:
    # binding later (rpc layer, after the statement returns) leaves a
    # window where a dispatch worker matches the sub but finds no
    # route and silently drops the notification
    ob = getattr(ctx.session, "live_outbox", None)
    if ob is not None:
        ctx.ds.fanout.bind(str(lid.u), ob)
    return lid


def _s_kill(n: KillStmt, ctx: Ctx):
    v = evaluate(n.id, ctx)
    if isinstance(v, str):
        lid = v
    elif isinstance(v, Uuid):
        lid = str(v.u)
    else:
        raise SdbError("KILL requires a live query uuid")
    sub = ctx.ds.live_queries.pop(lid, None)
    if sub is not None:
        # stop routing BEFORE deleting the row: a dispatch worker that
        # already matched this lid may still hold a notification, but
        # nothing new is enqueued to the session after KILL returns
        ctx.ds.fanout.unbind(lid)
    if sub is None:
        # not a LIVE query: try the in-flight (normal) query registry —
        # KILL <query-id> sets the cooperative cancel flag and the
        # target fails with "The query was cancelled" at its next
        # check_deadline site
        if ctx.ds.inflight.kill(lid):
            return NONE
        raise SdbError(
            f"Can not execute KILL statement using id '{render(v)}'"
        )
    ctx.txn.delete(K.lq_def(sub.ns, sub.db, sub.tb, lid))
    return NONE


def _access_level(n, ctx):
    """Resolve the statement's base (explicit ON, else the session's
    selected base — reference Options::selected_base)."""
    base = n.base
    if base is None:
        base = ("db" if ctx.session.db
                else "ns" if ctx.session.ns else "root")
    ns = ctx.session.ns if base in ("ns", "db") else None
    db = ctx.session.db if base == "db" else None
    if base == "db" and (not ns or not db):
        ctx.need_ns_db()
    if base == "ns" and not ns:
        raise SdbError("Specify a namespace to use")
    return base, ns, db


def _access_nf(base, ctx, name):
    if base == "root":
        return f"The root access method '{name}' does not exist"
    if base == "ns":
        return (f"The access method '{name}' does not exist in the "
                f"namespace '{ctx.session.ns}'")
    return (f"The access method '{name}' does not exist in the "
            f"database '{ctx.session.db}'")


def _user_nf(base, ctx, name):
    if base == "root":
        return f"The root user '{name}' does not exist"
    if base == "ns":
        return (f"The user '{name}' does not exist in the "
                f"namespace '{ctx.session.ns}'")
    return (f"The user '{name}' does not exist in the "
            f"database '{ctx.session.db}'")


def _grant_object(g: dict, redact: bool) -> dict:
    """SurrealQL object for an access grant (reference
    expr/statements/access.rs access_object_from_grant)."""
    grant = dict(g["grant"])
    if redact and "key" in grant:
        grant["key"] = "[REDACTED]"
    return {
        "id": g["id"],
        "ac": g["ac"],
        "type": g["type"],
        "creation": g["creation"],
        "expiration": g.get("expiration", NONE),
        "revocation": g.get("revocation", NONE),
        "subject": dict(g["subject"]),
        "grant": grant,
    }


def _s_access(n, ctx):
    from surrealdb_tpu_torch.val import Datetime, Duration

    if n.op == "alter_sequence":
        ns, db = ctx.need_ns_db()
        if ctx.txn.get(K.seq_state(ns, db, n.name)) is None and not n.subject:
            raise SdbError(f"The sequence '{n.name}' does not exist")
        return NONE
    base, ns, db = _access_level(n, ctx)
    adef = ctx.txn.get_val(K.ac_def(base, ns, db, n.name))
    if adef is None:
        raise SdbError(_access_nf(base, ctx, n.name))

    if n.op == "grant":
        if adef.kind != "bearer":
            raise SdbError(
                f"The functionality 'Grants for {adef.kind.upper()}' is "
                f"not implemented"
            )
        kind, sv = n.subject
        bearer_for = (adef.config or {}).get("for", "user")
        if kind == "user":
            if bearer_for != "user":
                raise SdbError(
                    "The access method cannot issue grants to the "
                    "provided subject"
                )
            if ctx.txn.get(K.us_def(base, ns, db, sv)) is None:
                raise SdbError(_user_nf(base, ctx, sv))
            subject = {"user": sv}
        else:
            if bearer_for != "record":
                raise SdbError(
                    "The access method cannot issue grants to the "
                    "provided subject"
                )
            rid = evaluate(sv, ctx)
            subject = {"record": rid}
        rng = _random.SystemRandom()
        gid = rng.choice(_GRANT_POOL[10:]) + "".join(
            rng.choice(_GRANT_POOL) for _ in range(11)
        )
        secret = "".join(rng.choice(_GRANT_POOL) for _ in range(24))
        creation = Datetime.now()
        dur = (adef.duration or {}).get("grant", Duration.parse("30d"))
        if isinstance(dur, Duration):
            import datetime as _dt

            expiration = Datetime(
                creation.dt + _dt.timedelta(seconds=dur.to_seconds()),
                creation.ns_frac, creation.year_shift,
            )
        else:
            expiration = NONE
        g = {
            "id": gid,
            "ac": n.name,
            "type": "bearer",
            "creation": creation,
            "expiration": expiration,
            "revocation": NONE,
            "subject": subject,
            "grant": {"id": gid, "key": f"surreal-bearer-{gid}-{secret}"},
        }
        ctx.txn.set_val(K.ac_grant(base, ns, db, n.name, gid), g)
        # the ONE place the real key is returned (reference: grants are
        # redacted everywhere after creation)
        return _grant_object(g, redact=False)

    beg, end = K.prefix_range(K.ac_grant_prefix(base, ns, db, n.name))

    def _matching():
        sel_kind, operand = n.selector or ("all", None)
        for k, g in ctx.txn.scan_vals(beg, end):
            if sel_kind == "grant" and g["id"] != operand:
                continue
            if sel_kind == "where":
                doc = _grant_object(g, redact=True)
                if not is_truthy(evaluate(operand, ctx.with_doc(doc, None))):
                    continue
            yield k, g

    if n.op == "show":
        return [_grant_object(g, redact=True) for _k, g in _matching()]

    if n.op == "revoke":
        out = []
        now = Datetime.now()
        for k, g in _matching():
            if g.get("revocation") not in (None, NONE):
                continue
            g = dict(g)
            g["revocation"] = now
            ctx.txn.set_val(k, g)
            out.append(_grant_object(g, redact=True))
        return out

    if n.op == "purge":
        kinds, grace_e = n.purge or (set(), None)
        grace = 0.0
        if grace_e is not None:
            gv = evaluate(grace_e, ctx)
            if isinstance(gv, Duration):
                grace = gv.to_seconds()
        now = Datetime.now()
        out = []
        for k, g in _matching():
            exp = g.get("expiration")
            rev = g.get("revocation")
            dead = False
            gns = int(grace * 1e9)
            if "expired" in kinds and isinstance(exp, Datetime):
                dead = dead or now.epoch_ns() - exp.epoch_ns() >= gns
            if "revoked" in kinds and isinstance(rev, Datetime):
                dead = dead or now.epoch_ns() - rev.epoch_ns() >= gns
            if dead:
                ctx.txn.delete(k)
                out.append(_grant_object(g, redact=True))
        return out

    raise SdbError(f"unknown ACCESS operation '{n.op}'")


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
    DefineEvent: _s_define_event,
    DefineParam: _s_define_param,
    DefineFunction: _s_define_function,
    DefineAnalyzer: _s_define_analyzer,
    DefineUser: _s_define_user,
    DefineAccess: _s_define_access,
    DefineModule: _unported("DEFINE MODULE"),
    DefineSequence: _s_define_sequence,
    DefineConfig: _s_define_config,
    RemoveStmt: _s_remove,
    AlterTable: _s_alter,
    AlterStmt: _s_alter_other,
    ExplainStmt: _s_explain_generic,
    RebuildIndex: _s_rebuild,
    InfoStmt: _s_info,
    LiveStmt: _s_live,
    KillStmt: _s_kill,
    ShowStmt: _s_show,
    AccessStmt: _s_access,
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

