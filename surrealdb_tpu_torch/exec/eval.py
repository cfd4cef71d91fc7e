"""Expression evaluation + idiom walking.

Reference semantics: core/src/expr/ (every node's compute()), expr/part.rs
(idiom part application), expr/lookup.rs (graph steps). Single-value scalar
path; the batched device paths live in idx/ and graph/ and are entered from the
planner, not from here.
"""

from __future__ import annotations

import random as _random

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.catalog import ParamDef
from surrealdb_tpu_torch.err import NotPorted, ReturnException, SdbError
from surrealdb_tpu_torch.exec.coerce import cast, coerce
from surrealdb_tpu_torch.exec.context import Ctx
from surrealdb_tpu_torch.exec.operators import binary_op, neg
from surrealdb_tpu_torch.expr.ast import *  # noqa: F401,F403
from surrealdb_tpu_torch.val import (
    NONE,
    Closure,
    Geometry,
    Range,
    RecordId,
    Regex,
    Table,
    Uuid,
    copy_value,
    is_truthy,
    value_eq,
)

_ID_CHARS = "0123456789abcdefghijklmnopqrstuvwxyz"


def generate_record_key(kind: str = "__gen_rand__"):
    if kind == "__gen_uuid__":
        return Uuid.new_v7()
    if kind == "__gen_ulid__":
        import os
        import time

        # Crockford base32 ULID
        t = int(time.time() * 1000)
        rand = int.from_bytes(os.urandom(10), "big")
        alph = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"
        out = []
        for shift in range(45, -5, -5):
            out.append(alph[(t >> shift) & 31])
        for shift in range(75, -5, -5):
            out.append(alph[(rand >> shift) & 31])
        return "".join(out)
    return "".join(_random.choices(_ID_CHARS, k=20))


def version_ns(v) -> int:
    """Normalize a VERSION clause value to epoch nanoseconds."""
    from surrealdb_tpu_torch.val import Datetime, render

    if isinstance(v, Datetime):
        return v.epoch_ns()
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        # string datetimes coerce (reference VERSION computes to datetime)
        try:
            return Datetime.parse(v).epoch_ns()
        except ValueError:
            pass
    raise SdbError(f"Expected a datetime but found {render(v)}")


def fetch_record_at(ctx: Ctx, rid: RecordId, ts: int):
    """The record document as of `ts` (epoch ns) from the version history;
    NONE when absent or deleted at that time."""
    from surrealdb_tpu_torch.kvs.api import deserialize

    ns, db = ctx.need_ns_db()
    best = None
    for k, raw in ctx.txn.scan(
        *K.prefix_range(K.hist_record_prefix(ns, db, rid.tb, rid.id))
    ):
        ets = int.from_bytes(k[-8:], "big")
        if ets <= ts:
            best = raw
        else:
            break
    if best is None or best == b"":
        return NONE
    return deserialize(best)


def fetch_record(ctx: Ctx, rid: RecordId):
    """Fetch a record document (NONE if missing); caches within a statement.
    Computed fields are evaluated on read (reference doc/compute.rs)."""
    if ctx._no_link_fetch:
        # ORDER BY keys compare pre-FETCH without record-link traversal
        # (reference select/fetch/order_by.surql: city.name sorts as NONE)
        return NONE
    if ctx.version is not None:
        ck = (rid.tb, K.enc_value(rid.id), ctx.version)
        hit = ctx.record_cache.get(ck)
        if hit is not None:
            return hit
        doc = fetch_record_at(ctx, rid, version_ns(ctx.version))
        if isinstance(doc, dict):
            ctx.record_cache[ck] = doc
            doc = apply_computed_fields(rid.tb, doc, rid, ctx)
        ctx.record_cache[ck] = doc
        return doc
    ck = (rid.tb, K.enc_value(rid.id))
    hit = ctx.record_cache.get(ck)
    if hit is not None:
        return hit
    ns, db = ctx.need_ns_db()
    raw = ctx.txn.get(K.record(ns, db, rid.tb, rid.id))
    if raw is None:
        doc = NONE
    else:
        from surrealdb_tpu_torch.kvs.api import deserialize

        doc = deserialize(raw)
        ctx.record_cache[ck] = doc  # pre-cache raw: breaks compute cycles
        doc = apply_computed_fields(rid.tb, doc, rid, ctx)
    ctx.record_cache[ck] = doc
    return doc


def computed_fields_of(tb: str, ctx: Ctx):
    """Computed field definitions for a table (cached per statement)."""
    ck = ("__computed__", tb)
    hit = ctx.record_cache.get(ck)
    if hit is not None:
        return hit
    ns, db = ctx.need_ns_db()
    out = []
    for _k, fd in ctx.txn.scan_vals(*K.prefix_range(K.fd_prefix(ns, db, tb))):
        if fd.computed is not None:
            out.append(fd)
    ctx.record_cache[ck] = out
    return out


def apply_computed_fields(tb: str, doc, rid, ctx: Ctx):
    """Evaluate COMPUTED fields into the document on read."""
    if not isinstance(doc, dict):
        return doc
    fds = computed_fields_of(tb, ctx)
    if not fds:
        return doc
    doc = dict(doc)
    # computed fields may reference each other: iterate until stable
    pending = list(fds)
    for _pass in range(len(fds) + 1):
        if not pending:
            break
        nxt = []
        for fd in pending:
            c = ctx.with_doc(doc, rid)
            try:
                v = evaluate(fd.computed, c)
            except ReturnException as r:
                # a block body may RETURN its value — that terminates the
                # computed expression, not the enclosing statement
                v = r.value
            except SdbError:
                nxt.append(fd)
                continue
            if v is None or v is NONE:
                # likely an unresolved dependency — retry in a later pass
                nxt.append(fd)
                continue
            doc[fd.name_str] = _coerce_computed(fd, v, rid)
        if len(nxt) == len(pending):
            break
        pending = nxt
    for fd in pending:
        c = ctx.with_doc(doc, rid)
        try:
            v = evaluate(fd.computed, c)
        except ReturnException as r:
            # RETURN ends the computed block, not the enclosing statement
            v = r.value
        except SdbError:
            # a failing computed expression reads as NULL (reference
            # computed-future semantics)
            doc[fd.name_str] = None
            continue
        doc[fd.name_str] = _coerce_computed(fd, v, rid)
    return doc


def _coerce_computed(fd, v, rid):
    """A typed computed field coerces its value on read; failures carry
    the standard field-coercion error."""
    if fd.kind is None:
        return v
    try:
        return coerce(v, fd.kind)
    except SdbError as e:
        rids = rid.render() if rid is not None else "?"
        raise SdbError(
            f"Couldn't coerce value for field `{fd.name_str}` of "
            f"`{rids}`: {e}"
        )


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------


def evaluate(node, ctx: Ctx):
    t = type(node)
    fn = _DISPATCH.get(t)
    if fn is None:
        # statements in expression position
        from surrealdb_tpu_torch.exec import statements as st

        return st.eval_statement(node, ctx)
    return fn(node, ctx)


def _e_script(n, ctx):
    caps = getattr(ctx.ds, "capabilities", None)
    if caps is not None and not caps.scripting:
        raise SdbError("Scripting functions are not allowed")
    raise NotPorted("scripting functions (function() { ... }) are not ported")


def _e_literal(n, ctx):
    v = n.value
    if type(v) is list or type(v) is dict:
        return copy_value(v)
    return v


def _e_param(n, ctx):
    name = n.name
    if name in ctx.vars:
        return ctx.vars[name]
    if name in ("this", "self"):
        return ctx.doc if ctx.doc is not None else NONE
    if name == "parent":
        return ctx.parent_doc if ctx.parent_doc is not None else NONE
    if name == "session":
        return _session_value(ctx)
    if name == "auth":
        return ctx.session.rid if ctx.session.rid is not None else NONE
    if name == "token":
        tk = getattr(ctx.session, "token", None)
        if tk is not None:
            return tk
        return ctx.vars.get("token", NONE)
    if name == "access":
        return ctx.session.ac if ctx.session.ac is not None else NONE
    # DEFINE PARAM lookup (as-of under a VERSION clause) — requires a
    # selected namespace+database (reference: unknown params error
    # without one, language/param/param_no_namespace)
    if not ctx.ns:
        raise SdbError("Specify a namespace to use")
    if not ctx.db:
        raise SdbError("Specify a database to use")
    key = K.pa_def(ctx.ns, ctx.db, name)
    if ctx.version is not None:
        pd = ctx.txn.get_val_at(key, version_ns(ctx.version))
    else:
        pd = ctx.txn.get_val(key)
    if isinstance(pd, ParamDef):
        return pd.value
    return NONE


def _session_value(ctx):
    s = ctx.session
    return {
        "ac": s.ac if s.ac else NONE,
        "db": s.db if s.db is not None else NONE,
        "exp": NONE,
        "id": NONE,
        "ip": NONE,
        "ns": s.ns if s.ns is not None else NONE,
        "or": NONE,
        "rd": s.rid if s.rid else NONE,
        "tk": getattr(s, "token", None) or NONE,
    }


def _e_array(n, ctx):
    return [evaluate(x, ctx) for x in n.items]


def _e_object(n, ctx):
    out = {k: evaluate(v, ctx) for k, v in n.items}
    # GeoJSON-shaped object literals become Geometry values (reference
    # expr object computation auto-detects { type, coordinates })
    if len(out) == 2 and "type" in out and (
        "coordinates" in out or "geometries" in out
    ):
        from surrealdb_tpu_torch.exec.coerce import object_to_geometry

        g = object_to_geometry(out)
        if g is not None:
            return g
    return out


def _e_set(n, ctx):
    from surrealdb_tpu_torch.val import SSet

    return SSet([evaluate(x, ctx) for x in n.items])


def _e_recordid(n, ctx):
    idexpr = n.id
    if isinstance(idexpr, RangeExpr):
        rng = _e_range(idexpr, ctx)
        return RecordId(n.tb, rng)
    v = evaluate(idexpr, ctx) if idexpr is not None else None
    if isinstance(v, str) and v.startswith("__gen_") and v.endswith("__"):
        v = generate_record_key(v)
    if isinstance(v, (float,)):
        if v.is_integer():
            v = int(v)
    if isinstance(v, RecordId):
        v = v.id
    return RecordId(n.tb, v)


def _e_range(n, ctx):
    beg = evaluate(n.beg, ctx) if n.beg is not None else NONE
    end = evaluate(n.end, ctx) if n.end is not None else NONE
    return Range(beg, end, n.beg_incl, n.end_incl)


def _e_binary(n, ctx):
    sc = ctx._stream_cols
    if sc is not None:
        # streaming executor: arithmetic/comparison projections may have
        # been computed vectorized for the whole batch (exec/stream.py
        # ColumnCache vspecs); exotic rows miss and evaluate normally
        cols, src = sc
        v = cols.get_row(n, src)
        if v is not cols.MISS:
            return v
    op = n.op
    if op == "&&":
        # short-circuit, returning the deciding VALUE (0s && 2s -> 0s)
        lhs = evaluate(n.lhs, ctx)
        if not is_truthy(lhs):
            return lhs
        return evaluate(n.rhs, ctx)
    if op == "||":
        lhs = evaluate(n.lhs, ctx)
        if is_truthy(lhs):
            return lhs
        return evaluate(n.rhs, ctx)
    if op == "??":
        lhs = evaluate(n.lhs, ctx)
        if lhs is not NONE and lhs is not None:
            return lhs
        return evaluate(n.rhs, ctx)
    if op == "?:":
        lhs = evaluate(n.lhs, ctx)
        if is_truthy(lhs):
            return lhs
        return evaluate(n.rhs, ctx)
    lhs = evaluate(n.lhs, ctx)
    rhs = evaluate(n.rhs, ctx)
    return binary_op(op, lhs, rhs)


def _e_matches(n, ctx):
    """text @@ query — full-text match via the index (fnc/search path)."""
    from surrealdb_tpu_torch.idx.fulltext import matches_operator

    return matches_operator(n, ctx)


def _e_prefix(n, ctx):
    v = evaluate(n.expr, ctx)
    if n.op == "-":
        return neg(v)
    if n.op == "+":
        return v
    if n.op == "!":
        return not is_truthy(v)
    raise SdbError(f"unknown prefix {n.op}")


def _e_knn(n, ctx):
    """Bare <|k|> evaluation: check the planner-filled KnnContext."""
    if ctx.knn is not None and ctx.doc_id is not None:
        from surrealdb_tpu_torch.val import hashable

        return hashable(ctx.doc_id) in ctx.knn
    # no index context: brute compare is meaningless per-row; treat as false
    return False


def _e_cast(n, ctx):
    return cast(evaluate(n.expr, ctx), n.kind)


def _e_constant(n, ctx):
    import math as m

    from surrealdb_tpu_torch.val import Datetime, Duration

    name = n.name
    table = {
        "math::pi": m.pi, "math::e": m.e, "math::tau": m.tau,
        "math::inf": m.inf, "math::infinity": m.inf,
        "math::neg_inf": -m.inf, "math::neg_infinity": -m.inf,
        "math::nan": m.nan,
        # Rust std::f64::consts values (bit-exact, not recomputed)
        "math::frac_1_pi": 0.3183098861837907,
        "math::frac_1_sqrt_2": 0.7071067811865476,
        "math::frac_2_pi": 0.6366197723675814,
        "math::frac_2_sqrt_pi": 1.1283791670955126,
        "math::frac_pi_2": 1.5707963267948966,
        "math::frac_pi_3": 1.0471975511965979,
        "math::frac_pi_4": 0.7853981633974483,
        "math::frac_pi_6": 0.5235987755982989,
        "math::frac_pi_8": 0.39269908169872414,
        "math::ln_10": 2.302585092994046,
        "math::ln_2": 0.6931471805599453,
        "math::log10_2": 0.3010299956639812,
        "math::log10_e": m.log10(m.e), "math::log2_10": m.log2(10),
        "math::log2_e": m.log2(m.e), "math::sqrt_2": m.sqrt(2),
    }
    if name in table:
        return table[name]
    if name == "time::epoch":
        import datetime as _dt

        return Datetime(_dt.datetime.fromtimestamp(0, _dt.timezone.utc))
    if name == "time::minimum":
        # chrono DateTime::<Utc>::MIN_UTC (val/datetime.rs MIN_UTC)
        return Datetime.from_parts(-262143, 1, 1)
    if name == "time::maximum":
        # chrono DateTime::<Utc>::MAX_UTC
        return Datetime.from_parts(262142, 12, 31, 23, 59, 59, 999_999_999)
    if name == "duration::max":
        from surrealdb_tpu_torch.val import Duration as D

        return D(D.MAX_NS)
    # unknown bare path — treat as an idiom over the current doc? error.
    raise SdbError(f"unknown constant or function {name!r}")


def _e_function(n, ctx):
    sc = ctx._stream_cols
    if sc is not None:
        # streaming executor: this call may have been computed vectorized
        # for the whole batch (exec/stream.py ColumnCache)
        cols, src = sc
        v = cols.get_row(n, src)
        if v is not cols.MISS:
            return v
    from surrealdb_tpu_torch.fnc import call_function

    return call_function(n, ctx)


def _e_closure(n, ctx):
    return Closure(n.params, n.body, n.returns)


def call_closure(clo: Closure, args: list, ctx: Ctx):
    py = getattr(clo, "py", None)
    if py is not None:
        # host-implemented closure (e.g. the API middleware $next)
        return py(args, ctx)
    c = ctx.child()
    for i, (pname, pkind) in enumerate(clo.params):
        v = args[i] if i < len(args) else NONE
        if pkind is not None:
            try:
                v = coerce(v, pkind)
            except SdbError:
                from surrealdb_tpu_torch.exec.coerce import kind_name

                raise SdbError(
                    f"Incorrect arguments for function ANONYMOUS(). "
                    f"Expected a value of type '{kind_name(pkind)}' for "
                    f"argument ${pname}"
                )
        c.vars[pname] = v
    from surrealdb_tpu_torch.err import BreakException, ContinueException

    try:
        out = evaluate(clo.body, c)
    except ReturnException as r:
        out = r.value
    except (BreakException, ContinueException):
        # loop control cannot cross a function frame (reference ctrl flow)
        raise SdbError(
            "Invalid control flow statement, break or continue statement "
            "found outside of loop."
        )
    if clo.returns is not None:
        try:
            out = coerce(out, clo.returns)
        except SdbError as e:
            raise SdbError(
                f"Couldn't coerce return value from function `ANONYMOUS`: {e}"
            )
    return out


def _e_subquery(n, ctx):
    from surrealdb_tpu_torch.exec import statements as st

    c = ctx.child()
    # inside a subquery $parent is the enclosing statement's $this — the
    # doc the subquery expression is being computed against (reference
    # doc/compute: parent binding travels with the subquery frame)
    pin = ctx.vars.get("this", ctx.doc)
    if pin is not None:
        c.parent_doc = pin
        c.vars["parent"] = pin
    return st.eval_statement(n.stmt, c)


def _e_block(n, ctx):
    from surrealdb_tpu_torch.exec import statements as st

    c = ctx.child()
    out = NONE
    for s in n.stmts:
        out = st.eval_statement(s, c)
    return out


def _e_ifelse(n, ctx):
    from surrealdb_tpu_torch.exec import statements as st

    for cond, body in n.branches:
        if is_truthy(evaluate(cond, ctx)):
            return st.eval_statement(body, ctx)
    if n.otherwise is not None:
        return st.eval_statement(n.otherwise, ctx)
    return NONE


def _e_regex(n, ctx):
    return Regex(n.pattern)


def _e_mock(n, ctx):
    out = []
    if not getattr(n, "is_range", False) and n.end is None:
        for _ in range(n.beg):
            out.append(RecordId(n.tb, generate_record_key()))
        return out
    i64min, i64max = -(1 << 63), (1 << 63) - 1
    beg = n.beg if n.beg is not None else i64min
    if getattr(n, "beg_excl", False):
        beg += 1
    if n.end is None:
        stop = i64max + 1  # open end spans to i64::MAX inclusive
    else:
        stop = n.end + 1 if n.end_incl else n.end
    count = max(stop - beg, 0)
    # reference GENERATION_ALLOCATION_LIMIT: count * sizeof(Value) over cap
    from surrealdb_tpu_torch import cnf as _cnf

    if count * 32 > _cnf.GENERATION_ALLOCATION_LIMIT:
        raise SdbError("Mock range exceeds allocation limit")
    for i in range(beg, stop):
        out.append(RecordId(n.tb, i))
    return out


# ---------------------------------------------------------------------------
# Idiom walking
# ---------------------------------------------------------------------------


def _e_idiom(n, ctx):
    parts = n.parts
    if not parts:
        return NONE
    first = parts[0]
    if isinstance(first, tuple) and first[0] == "start":
        val = evaluate(first[1], ctx)
        rest = parts[1:]
    elif isinstance(first, PGraph):
        # graph step from the current record
        val = ctx.doc_id if ctx.doc_id is not None else _doc_id_of(ctx)
        if val is None:
            return NONE
        rest = parts
    elif isinstance(first, PField):
        name = first.name
        if name == "@":
            val = ctx.doc_id if ctx.doc_id is not None else ctx.doc
            rest = parts[1:]
        else:
            doc = ctx.doc
            if doc is None:
                # no current document: the value is NONE, but later parts
                # still evaluate for control-flow/side effects (BREAK
                # inside an index expr must escape the loop —
                # control_flow/loop/break_within_indexing_idiom)
                val = NONE
                rest = parts[1:]
            else:
                val = _get_field(doc, name, ctx)
                rest = parts[1:]
    elif isinstance(first, PAll):
        val = ctx.doc
        rest = parts[1:]
    else:
        val = ctx.doc
        rest = parts
    return walk(val, rest, ctx)


def _doc_id_of(ctx):
    doc = ctx.doc
    if isinstance(doc, dict):
        rid = doc.get("id")
        if isinstance(rid, RecordId):
            return rid
    return None


def _get_field(doc, name, ctx):
    if isinstance(doc, dict):
        return doc.get(name, NONE)
    if isinstance(doc, RecordId):
        sub = fetch_record(ctx, doc)
        if isinstance(sub, dict):
            return sub.get(name, NONE)
        return NONE
    if isinstance(doc, Geometry):
        obj = doc.to_object()
        return obj.get(name, NONE)
    if isinstance(doc, list):
        return [_get_field(x, name, ctx) for x in doc]
    if isinstance(doc, Range):
        if name == "begin" or name == "beg":
            return doc.beg
        if name == "end":
            return doc.end
    return NONE


def walk(val, parts, ctx: Ctx, depth=0):
    i = -1
    fanned = False  # a field step mapped over a list: later index parts
    # keep mapping per element (idiom chain continuity)
    from_graph = False  # the current list is a hop frontier (stays flat)
    while i + 1 < len(parts):
        i += 1
        part = parts[i]
        t = type(part)
        if t is PField:
            if part.name == "@":
                raise SdbError(
                    "Tried to use a `@` repeat recurse symbol in a "
                    "position where it is not supported"
                )
            if isinstance(val, list):
                fanned = True
            val = _apply_field(val, part.name, ctx)
        elif t is PAll:
            if isinstance(val, dict):
                val = list(val.values())
            elif isinstance(val, list):
                if i + 1 == len(parts):
                    return [
                        fetch_record(ctx, x) if isinstance(x, RecordId) else x
                        for x in val
                    ]
                val = [
                    walk(x, parts[i + 1 :], ctx, depth + 1) for x in val
                ]
                return val
            elif isinstance(val, RecordId):
                val = fetch_record(ctx, val)
                if val is NONE:
                    return NONE
                continue
            elif val is NONE or val is None:
                return NONE
        elif t is PIndex:
            idx = evaluate(part.expr, ctx)
            if fanned and isinstance(val, list):
                val = [_apply_index(x, idx, ctx) for x in val]
            else:
                val = _apply_index(val, idx, ctx)
        elif t is PLast:
            if isinstance(val, list):
                val = val[-1] if val else NONE
            else:
                val = NONE
        elif t is PWhere:
            if isinstance(val, list):
                out = []
                for x in val:
                    item = x
                    if isinstance(x, RecordId):
                        item = fetch_record(ctx, x)
                    c = ctx.with_doc(item, x if isinstance(x, RecordId) else None)
                    if is_truthy(evaluate(part.cond, c)):
                        out.append(x)
                val = out
            elif isinstance(val, (dict, RecordId)):
                item = val
                if isinstance(val, RecordId):
                    item = fetch_record(ctx, val)
                c = ctx.with_doc(item, val if isinstance(val, RecordId) else None)
                if not is_truthy(evaluate(part.cond, c)):
                    val = NONE
            else:
                val = NONE
        elif t is PMethod:
            val = _apply_method(val, part, ctx)
        elif t is PGraph:
            if isinstance(val, list) and not from_graph:
                # a VALUE list (array start / filtered array) maps each
                # element through the remaining chain — hop frontiers
                # stay flat (language/idiom/graph_filter_flattened)
                return [walk(x, parts[i:], ctx, depth + 1) for x in val]
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            if nxt is not None:
                # fold a run of identical `->edge->node` pairs into ONE
                # index-space multi-hop (frontiers never materialize
                # between hops — the raw-CSR schedule)
                pat = _csr_pair_pattern(part, nxt)
                hops = 1
                if pat is not None:
                    j = i + 2
                    while j + 1 < len(parts) and _csr_pair_pattern(
                        parts[j], parts[j + 1]
                    ) == pat:
                        hops += 1
                        j += 2
                fast = _csr_bag_pair_hop(val, part, nxt, ctx, hops)
                if fast is not None:
                    val = fast
                    from_graph = True
                    i += 2 * hops - 1
                    continue
            val = _apply_graph(val, part, ctx)
            from_graph = True
            # graph results are lists; subsequent field parts map over them
        elif t is PFlatten:
            if isinstance(val, list):
                out = []
                for x in val:
                    if isinstance(x, list):
                        out.extend(x)
                    else:
                        out.append(x)
                val = out
        elif t is PDestructure:
            val = _apply_destructure(val, part, ctx)
        elif t is POptional:
            if val is NONE or val is None:
                return val
        elif t is PRecurse:
            if part.parts:
                val = _apply_recurse(val, part, [], ctx)
                continue
            return _apply_recurse(val, part, parts[i + 1 :], ctx)
        else:
            raise SdbError(f"unhandled idiom part {part!r}")
    return val


def _apply_field(val, name, ctx):
    if isinstance(val, dict):
        return val.get(name, NONE)
    if isinstance(val, list):
        return [_apply_field(x, name, ctx) for x in val]
    if isinstance(val, RecordId):
        doc = fetch_record(ctx, val)
        if isinstance(doc, dict):
            if name == "id":
                return doc.get("id", val)
            return doc.get(name, NONE)
        if name == "id":
            return val
        return NONE
    if isinstance(val, Geometry):
        if name == "type":
            return val.kind
        if name == "coordinates":
            from surrealdb_tpu_torch.val import _coords_list

            return _coords_list(val.coords)
        return NONE
    if isinstance(val, Range):
        if name in ("begin", "beg"):
            return val.beg
        if name == "end":
            return val.end
        return NONE
    return NONE


def _apply_index(val, idx, ctx):
    from surrealdb_tpu_torch.val import SSet as _SSet

    if isinstance(val, _SSet):
        # sets index positionally over their sorted items
        val = list(val.items)
    if isinstance(val, RecordId):
        if isinstance(val.id, list) and isinstance(idx, (int, float)) \
                and not isinstance(idx, bool):
            # integer-indexing a record id with an array key drills into
            # the key (planner/select_compound_index_array id[1] access)
            val = val.id
        else:
            # other index kinds address the linked document
            val = fetch_record(ctx, val)
    if isinstance(val, list):
        if isinstance(idx, bool):
            return NONE
        if isinstance(idx, (int, float)):
            i = int(idx)
            # no negative indexing (primitive/array/basic.surql: [-1] is
            # NONE; the reference indexes with u64)
            if 0 <= i < len(val):
                return val[i]
            return NONE
        if isinstance(idx, Range):
            try:
                beg = idx.beg if isinstance(idx.beg, int) else 0
                end = idx.end if isinstance(idx.end, int) else len(val)
                if not idx.beg_incl:
                    beg += 1
                if idx.end_incl:
                    end += 1
                return val[beg:end]
            except TypeError:
                return NONE
        return NONE
    if isinstance(val, dict):
        if isinstance(idx, str):
            return val.get(idx, NONE)
        if isinstance(idx, (int, float)) and not isinstance(idx, bool):
            return val.get(str(int(idx)), NONE)
        return NONE
    if isinstance(val, RecordId):
        doc = fetch_record(ctx, val)
        return _apply_index(doc, idx, ctx) if doc is not NONE else NONE
    if isinstance(val, str):
        # strings are not indexable (reference idiom/recordid.surql)
        return NONE
    return NONE


def _apply_method(val, part, ctx):
    from surrealdb_tpu_torch.fnc import method_call

    if part.name == "__call__":
        args = [evaluate(a, ctx) for a in part.args]
        if isinstance(val, Closure):
            return call_closure(val, args, ctx)
        raise SdbError(f"{type(val).__name__} is not a function")
    # field holding a closure? (built-in idiom methods take priority:
    # `$obj.keys()` is object::keys even when `keys` is a closure field)
    args = [evaluate(a, ctx) for a in part.args]
    try:
        return method_call(val, part.name, args, ctx)
    except SdbError as builtin_err:
        if not str(builtin_err).startswith("The method '"):
            raise  # the builtin exists but failed — report that
        if isinstance(val, dict):
            f = val.get(part.name)
            if isinstance(f, Closure):
                return call_closure(f, args, ctx)
        if isinstance(val, RecordId):
            doc = fetch_record(ctx, val)
            if isinstance(doc, dict):
                f = doc.get(part.name)
                if isinstance(f, Closure):
                    return call_closure(f, args, ctx)
        if isinstance(val, dict):
            # an object field that isn't a closure (or is absent): the
            # reference phrases this as a failed method run
            raise SdbError(
                f"There was a problem running the {part.name}() function. "
                f"no such method found for the object type"
            )
        raise builtin_err


def _csr_pair_pattern(g1, g2):
    """Is (g1, g2) a plain `->edge->node` pair eligible for the CSR device
    hop? Returns (edge_tb, node_tb, dir) or None."""
    from surrealdb_tpu_torch.expr.ast import PGraph as _PG

    if not isinstance(g1, _PG) or not isinstance(g2, _PG):
        return None
    for g in (g1, g2):
        if (
            g.cond is not None
            or g.expr is not None
            or g.dir not in ("out", "in")
            or len(g.what) != 1
            or g.what[0][1] is not None
        ):
            return None
    if g1.dir != g2.dir:
        return None
    return g1.what[0][0], g2.what[0][0], g1.dir


def _csr_bag_pair_hop(val, g1, g2, ctx, hops=1):
    """Host CSR fast path for plain `->edge->node` chain pairs with BAG
    semantics. Engages when the adjacency cache is already valid, or the
    frontier is large enough to amortize a build; returns None to fall
    back to the per-record `~`-key scans."""
    pat = _csr_pair_pattern(g1, g2)
    if pat is None:
        return None
    if ctx.version is not None:
        return None  # CSR caches HEAD state; VERSION reads use key scans
    edge_tb, node_tb, _dir = pat
    rids = _collect_rids(val, ctx)
    if not rids or any(r.tb != node_tb for r in rids):
        return None
    ns, db = ctx.need_ns_db()
    gk0 = (ns, db, edge_tb)
    if gk0 in getattr(ctx.txn, "_graph_dirty", ()):
        # this txn holds uncommitted writes to the edge table — the
        # shared CSR (committed state) would miss them
        return None
    # alignment guard: a chain that fell back mid-way can present
    # (node, edge) in swapped roles — only pair when the first table is
    # a declared RELATION (the bench/graph schema norm)
    tdef = ctx.txn.peek_val(K.tb_def(ns, db, edge_tb))
    if tdef is None or getattr(tdef, "kind", None) != "relation":
        return None
    from surrealdb_tpu_torch.graph.csr import peek_csr
    csr = peek_csr(ctx.ds, ns, db, node_tb, edge_tb, g1.dir)
    gk = (ns, db, edge_tb)
    cur_ver = ctx.ds.graph_versions.get(gk, 0)
    cache_valid = csr is not None and csr.version == cur_ver
    if not cache_valid and len(rids) < 64:
        return None  # a point lookup shouldn't pay a full edge scan
    from surrealdb_tpu_torch.graph.csr import get_csr

    csr = get_csr(ctx.ds, ctx, node_tb, edge_tb, g1.dir)
    if not len(csr.rows):
        return None  # empty adjacency: per-record scans are authoritative
    idxs = csr.hop_bag_idx([r.id for r in rids], hops)
    return csr.materialize_rids(idxs, node_tb)


def _apply_graph(val, g: PGraph, ctx: Ctx):
    """One graph hop: scan `~` (or `&` reference) keys of each source record
    (SURVEY §3.4); `->(SELECT ...)` lookups run the select over the hop's
    destinations."""
    rids = _collect_rids(val, ctx)
    if not rids:
        return []
    from surrealdb_tpu_torch.graph import traverse_hop

    if g.expr is not None:
        # ->(SELECT ... [FIELD f] [clauses]) — the select's FROM names the
        # destination tables; FIELD restricts reference lookups
        from surrealdb_tpu_torch.exec import statements as st

        sel = g.expr
        tables = []
        for w in getattr(sel, "what", []):
            if isinstance(w, RecordIdLit):
                tables.append((w.tb, w))
                continue
            tv = st._target_value(w, ctx)
            if isinstance(tv, Table):
                tables.append((tv.name, None))
            elif isinstance(tv, str):
                tables.append((tv, None))
            elif isinstance(tv, RecordId):
                from surrealdb_tpu_torch.expr.ast import Literal as _Lit

                tables.append((tv.tb, _Lit(tv)))
            else:
                raise SdbError(
                    f"Cannot use {render(tv)} as a lookup target"
                )
        sub_g = PGraph(g.dir, tables, None)
        dests = traverse_hop(rids, sub_g, ctx, ref_field=sel.ref_field)
        sources = []
        for rid in dests:
            doc = fetch_record(ctx, rid)
            if doc is NONE:
                continue
            sources.append(st.Source(rid=rid, doc=doc))
        return st.select_over_sources(sel, sources, ctx)
    results = traverse_hop(rids, g, ctx)
    return results


def _collect_rids(val, ctx):
    out = []
    if isinstance(val, RecordId):
        out.append(val)
    elif isinstance(val, dict):
        rid = val.get("id")
        if isinstance(rid, RecordId):
            out.append(rid)
    elif isinstance(val, list):
        for x in val:
            out.extend(_collect_rids(x, ctx))
    return out


def _at_marker_index(sub):
    """Index of the `@` repeat marker in a destructure field idiom (parts
    after it post-process the recursion result, e.g. `.chain(...)`)."""
    if not isinstance(sub, Idiom):
        return None
    for j, p in enumerate(sub.parts):
        if isinstance(p, PField) and p.name == "@":
            return j
    return None


def _rec_inner_destructure(sub):
    """(prefix_parts, inner PDestructure, post_parts) when `sub` routes
    through a nested destructure that itself contains a recursion marker;
    `post_parts` (e.g. a trailing projection) apply to the result."""
    if not isinstance(sub, Idiom):
        return None
    for i, p in enumerate(sub.parts):
        if isinstance(p, PDestructure) and _destructure_has_rec(p):
            prefix = []
            for q in sub.parts[:i]:
                if isinstance(q, tuple) and len(q) == 2 and \
                        q[0] == "start" and isinstance(q[1], Idiom):
                    prefix.extend(q[1].parts)
                elif not isinstance(q, tuple):
                    prefix.append(q)
            return prefix, p, list(sub.parts[i + 1:])
    return None


def _destructure_has_rec(dez: PDestructure) -> bool:
    for _name, sub in dez.fields:
        if _at_marker_index(sub) is not None:
            return True
        if isinstance(sub, Idiom):
            for p in sub.parts:
                if isinstance(p, PDestructure) and _destructure_has_rec(p):
                    return True
    return False


_REC_ELIM = object()  # path-elimination marker: subtree can't reach rmax


def _recursive_destructure(val, dez: PDestructure, rmin, rmax, ctx, depth=0,
                           outer=None):
    """`@`-marked destructure recursion; `outer` is the full plan the `@`
    repeats (nested destructures re-enter it at the marker without
    consuming a depth level). Branches that dead-end before the final
    depth are eliminated — `a:1.{3}` drops links that stop at depth 2
    (reference exec/operators/recursion.rs path elimination)."""
    outer = outer if outer is not None else dez
    if isinstance(val, list):
        subs = [
            _recursive_destructure(x, dez, rmin, rmax, ctx, depth, outer)
            for x in val
            if x is not NONE and x is not None
        ]
        return [s for s in subs if s is not _REC_ELIM]
    node = val
    doc = fetch_record(ctx, node) if isinstance(node, RecordId) else node
    if not isinstance(doc, dict):
        return NONE
    out = {}
    for name, sub in dez.fields:
        if sub is None:
            out[name] = doc.get(name, NONE)
            continue
        nested = _rec_inner_destructure(sub)
        if nested is not None:
            prefix, inner, post = nested
            raw = walk(doc, prefix, ctx) if prefix else doc
            v = _recursive_destructure(
                raw, inner, rmin, rmax, ctx, depth, outer
            )
            if v is _REC_ELIM:
                return _REC_ELIM
            out[name] = walk(v, post, ctx) if post else v
            continue
        at_j = _at_marker_index(sub)
        if at_j is None:
            c = ctx.with_doc(doc, node if isinstance(node, RecordId) else None)
            out[name] = evaluate(sub, c)
            continue
        post_at = list(sub.parts[at_j + 1:])
        prefix = [p for p in sub.parts[:at_j] if not isinstance(p, tuple)]
        raw = walk(node if isinstance(node, RecordId) else doc, prefix, ctx)
        # a dead end keeps the step's own shape at the FINAL depth (NONE
        # link / empty graph step); before it, the branch is eliminated
        def _post(v):
            return walk(v, list(post_at), ctx) if post_at else v

        if raw is NONE or raw is None:
            if depth + 1 < rmin:
                return _REC_ELIM
            out[name] = _post(NONE)
            continue
        children = raw if isinstance(raw, list) else [raw]
        children = [c for c in children if c is not NONE and c is not None]
        if not children:
            if depth + 1 < rmin:
                return _REC_ELIM
            out[name] = _post([] if isinstance(raw, list) else NONE)
        elif depth + 1 >= rmax:
            # the depth bound emits the raw frontier ids
            out[name] = _post(children)
        else:
            subs = [
                _recursive_destructure(ch, outer, rmin, rmax, ctx, depth + 1,
                                       outer)
                for ch in children
            ]
            subs = [s for s in subs if s is not _REC_ELIM]
            if not subs:
                return _REC_ELIM
            out[name] = _post(subs)
    return out


def _apply_destructure(val, part: PDestructure, ctx):
    if isinstance(val, list):
        return [_apply_destructure(x, part, ctx) for x in val]
    if isinstance(val, RecordId):
        val = fetch_record(ctx, val)
    if not isinstance(val, dict):
        return NONE
    out = {}
    for name, sub in part.fields:
        if sub is None:
            out[name] = val.get(name, NONE)
        else:
            c = ctx.with_doc(val, None)
            out[name] = evaluate(sub, c)
    return out


def _apply_recurse(val, part: PRecurse, tail, ctx):
    """Bounded recursion `.{min..max[+instr]}(step)` (reference
    exec/operators/recursion.rs).

    - exact `{n}`: the frontier after exactly n steps (per-frontier dedup,
      revisits across depths allowed — cycles can resurface nodes)
    - range `{a..b}` default: first-seen union of the frontiers at depths
      a..b (no global visited set; b bounds termination)
    - +collect: BFS union with a visited set (safe for unbounded ranges)
    - +path: DFS enumeration of full paths, cutting on in-path revisits
      (the repeated node terminates and is included)
    - +shortest=target: BFS shortest path; +inclusive prepends the subject
    """
    from surrealdb_tpu_torch.val import hashable

    rmin = part.min if part.min is not None else 1
    rmax = part.max if part.max is not None else 256
    if part.min is not None and part.min < 1:
        raise SdbError(f"Found {part.min} for bound but expected at least 1.")
    if part.max is not None and part.max > 256:
        raise SdbError(
            f"Found {part.max} for bound but expected 256 at most."
        )
    if part.min is not None and part.min > 256:
        raise SdbError(
            f"Found {part.min} for bound but expected 256 at most."
        )
    parts = part.parts if part.parts else tail
    if not parts:
        return NONE
    names = []
    target = None
    if isinstance(part.instruction, dict):
        names = part.instruction.get("names", [])
        texpr = part.instruction.get("target")
        target = evaluate(texpr, ctx) if texpr is not None else None
    elif isinstance(part.instruction, str):
        names = [part.instruction]
    inclusive = "inclusive" in names
    mode = next(
        (n for n in names if n in ("collect", "path", "shortest")), None
    )
    step_is_graph = bool(parts) and isinstance(parts[0], PGraph)
    # recursive destructure: `.{..}.{ name, sub: ->x->y.@ }` — the @ marks
    # where the destructure repeats, building a nested tree
    if (
        len(parts) == 1
        and isinstance(parts[0], PDestructure)
        and _destructure_has_rec(parts[0])
    ):
        if mode is not None:
            raise SdbError(
                "Cannot construct a recursion plan when an instruction "
                "is provided"
            )
        res = _recursive_destructure(val, parts[0], rmin, rmax, ctx)
        return NONE if res is _REC_ELIM else res
    # a bare trailing `@` repeats the preceding path: `.{n}.contains.@`
    # ≡ `.{n}(.contains)`; parts after the marker apply to the final value
    at_idx = next(
        (j for j, p in enumerate(parts)
         if isinstance(p, PField) and p.name == "@"),
        None,
    )
    post_at = None
    if at_idx is not None:
        if mode is not None:
            raise SdbError(
                "Cannot construct a recursion plan when an instruction "
                "is provided"
            )
        post_at = list(parts[at_idx + 1:])
        parts = list(parts[:at_idx])
        if not parts:
            raise SdbError(
                "Tried to use a `@` repeat recurse symbol in a position "
                "where it is not supported"
            )

        def _post(v):
            return walk(v, post_at, ctx) if post_at else v

        inner = PRecurse(
            min=part.min, max=part.max, parts=parts, instruction=None
        )
        return _post(_apply_recurse(val, inner, [], ctx))

    def step(node):
        out = walk(node, parts, ctx)
        if out is NONE or out is None:
            return [], False
        if isinstance(out, list):
            flat = []
            for x in out:
                if isinstance(x, list):
                    flat.extend(x)
                else:
                    flat.append(x)
            return [x for x in flat if x is not NONE and x is not None], True
        return [out], False

    start_items = val if isinstance(val, list) else [val]
    start_items = [x for x in start_items if x is not NONE and x is not None]
    was_list = isinstance(val, list)

    # ---- path: BFS with in-path cycle cuts --------------------------------
    # paths emit in termination order — level by level (a dead end at
    # depth 1 precedes every depth-3 path), discovery order within a
    # level (reference recursion.rs path enumeration)
    if mode == "path":
        # acc holds the CORE path (traversed nodes, excluding the
        # +inclusive subject prefix) — the subject does not count toward
        # cycle detection, so alice.{..3+path+inclusive} may pass back
        # through alice and cut only on a core revisit
        paths = []

        def emit(sn, core):
            pre = [sn] if inclusive else []
            if len(pre) + len(core) >= rmin:
                paths.append(pre + core)

        frontier = [(sn, sn, []) for sn in start_items]
        depth = 0
        while frontier:
            nxt = []
            for sn, node, acc in frontier:
                if depth >= rmax:
                    emit(sn, acc)
                    continue
                children, islist = step(node)
                was_list = was_list or islist
                if not children:
                    emit(sn, acc)
                    continue
                inpath = {hashable(x) for x in acc}
                for ch in children:
                    if hashable(ch) in inpath:
                        # cycle: emit the path closed by the repeat
                        emit(sn, acc + [ch])
                        continue
                    nxt.append((sn, ch, acc + [ch]))
            depth += 1
            frontier = nxt
        return paths

    # ---- shortest: BFS with parent links ----------------------------------
    if mode == "shortest":
        visited = {hashable(x) for x in start_items}
        parent: dict = {}
        frontier = list(start_items)
        last_frontier = []
        depth = 0

        start_keys = {hashable(x) for x in start_items}

        def path_to(x, include_self=True):
            p = [x] if include_self else []
            cur = parent.get(hashable(x))
            while cur is not None:
                p.append(cur)
                cur = parent.get(hashable(cur))
            p.reverse()
            # the subject itself is not part of the path unless +inclusive
            if p and hashable(p[0]) in start_keys:
                p = p[1:]
            return p

        while depth < rmax and frontier:
            nxt = []
            for node in frontier:
                children, islist = step(node)
                was_list = was_list or islist
                for ch in children:
                    h = hashable(ch)
                    if h in visited:
                        continue
                    visited.add(h)
                    parent[h] = node
                    nxt.append(ch)
                    if target is not None and value_eq(ch, target):
                        path = path_to(ch)
                        if inclusive:
                            path = start_items[:1] + path
                        return path
            depth += 1
            frontier = nxt
            if nxt:
                last_frontier = nxt
        if part.max is not None and last_frontier:
            # bounded search that missed: the partial paths explored
            out = []
            for x in last_frontier:
                p = path_to(x)
                if inclusive:
                    p = start_items[:1] + p
                out.append(p)
            return out
        return NONE

    # ---- collect: BFS union with visited set (the subject itself may be
    # rediscovered through a cycle and collected) --------------------------
    if mode == "collect":
        visited = (
            {hashable(x) for x in start_items} if inclusive else set()
        )
        collected = []
        frontier = list(start_items)
        depth = 0
        while depth < rmax and frontier:
            nxt = []
            for node in frontier:
                children, islist = step(node)
                was_list = was_list or islist
                for ch in children:
                    h = hashable(ch)
                    if h in visited:
                        continue
                    visited.add(h)
                    nxt.append(ch)
            depth += 1
            if depth >= rmin:
                collected.extend(nxt)
            frontier = nxt
        if inclusive:
            collected = start_items + collected
        return collected

    # ---- default: follow the path until bounds or dead end ---------------
    # (reference recursion/default.rs: the path is applied to the WHOLE
    # current value each step — map+flatten WITHOUT dedup — and only the
    # final depth's value is returned; a dead end or a fixed point stops)
    def clean(v):
        if isinstance(v, list):
            flat = []
            for x in v:
                if isinstance(x, list):
                    flat.extend(
                        y for y in x if y is not NONE and y is not None
                    )
                elif x is not NONE and x is not None:
                    flat.append(x)
            return flat
        return v

    hard_limit = part.max is None
    current = val
    depth = 0
    while depth < rmax:
        ctx.check_deadline()
        nxt = clean(walk(current, list(parts), ctx))
        depth += 1
        final = nxt is NONE or nxt is None or (
            isinstance(nxt, list) and not nxt
        )
        if final or value_eq(nxt, current):
            # dead end or cycle fixed point: the previous value stands when
            # we got past min_depth, else the dead-end value itself
            if depth > rmin:
                return current
            return nxt
        current = nxt
    if hard_limit:
        # an open-ended `{n..}` that never dead-ended within 256 levels
        raise SdbError("Exceeded the idiom recursion limit of 256.")
    if depth >= rmin:
        return current
    return NONE


# ---------------------------------------------------------------------------
# dispatch table
# ---------------------------------------------------------------------------

_DISPATCH = {
    ScriptExpr: _e_script,
    Literal: _e_literal,
    Param: _e_param,
    ArrayExpr: _e_array,
    ObjectExpr: _e_object,
    SetExpr: _e_set,
    RecordIdLit: _e_recordid,
    RangeExpr: _e_range,
    Binary: _e_binary,
    Prefix: _e_prefix,
    Knn: _e_knn,
    Matches: _e_matches,
    FunctionCall: _e_function,
    Cast: _e_cast,
    Constant: _e_constant,
    ClosureExpr: _e_closure,
    Subquery: _e_subquery,
    BlockExpr: _e_block,
    IfElse: _e_ifelse,
    RegexLit: _e_regex,
    Mock: _e_mock,
    Idiom: _e_idiom,
}
