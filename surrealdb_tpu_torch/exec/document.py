"""Document write pipeline.

Stage order mirrors the reference (doc/mod.rs:12-37): process → alter →
field(schema) → check(perms) → store → edges → index → event → lives →
pluck(output). One function per statement kind drives the shared
pipeline. A table's events (`DEFINE EVENT`) run inside the writing
transaction (`run_events`: WHEN, then THEN with $event, $before, $after,
$value and $input bound; an ASYNC event never fails the write and is
retried up to its RETRY count). Live queries capture each
committed-to-be mutation here (`notify_lives`) and are matched after the
commit (server/fanout.py). Changefeeds and materialised views are not
ported: the statements that would define them raise `NotPorted`, so no
table reaches the write path with one.
"""

from __future__ import annotations

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.catalog import TableDef
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.exec.coerce import coerce
from surrealdb_tpu_torch.exec.context import Ctx
from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record, generate_record_key, walk
from surrealdb_tpu_torch.expr.ast import (
    ContentData,
    Idiom,
    MergeData,
    OutputClause,
    PatchData,
    PAll,
    PField,
    ReplaceData,
    SetData,
    UnsetData,
)
from surrealdb_tpu_torch.kvs.api import deserialize, deserialize_once, serialize
from surrealdb_tpu_torch.val import (
    NONE,
    Range,
    RecordId,
    Table,
    Uuid,
    copy_value,
    is_truthy,
    render,
    value_eq,
)

class _Skip:
    """Sentinel: a row skipped by INSERT IGNORE (distinct from a NONE
    result, which RETURN NONE/BEFORE legitimately produce)."""

    def __repr__(self):
        return "SKIP"


SKIP = _Skip()

# ---------------------------------------------------------------------------
# data clause application
# ---------------------------------------------------------------------------


_THIS_DEFAULT = object()


def apply_data(doc: dict, data, ctx: Ctx, rid=None, this_doc=_THIS_DEFAULT):
    """Apply SET/UNSET/CONTENT/MERGE/REPLACE/PATCH to a doc (mutates copy).

    `this_doc` pins what `$this` evaluates to during the data expressions:
    the reference fixes $this at the state the record had when the
    statement started (NONE for fresh creates) — it does NOT track the
    assignments as they land (language/statements/define/param/this.surql).
    """
    if data is None:
        return doc
    if this_doc is _THIS_DEFAULT:
        this_doc = doc
    if not isinstance(data, SetData):
        ctx = ctx.child()
        ctx.vars["this"] = this_doc
    if isinstance(data, (ContentData, ReplaceData)):
        v = evaluate(data.expr, ctx)
        if not isinstance(v, dict):
            raise SdbError(f"Cannot use {render(v)} in a CONTENT clause")
        out = _prune_none(copy_value(v))
        if "id" not in out and "id" in doc:
            out["id"] = doc["id"]
        return out
    if isinstance(data, MergeData):
        v = evaluate(data.expr, ctx)
        if not isinstance(v, dict):
            raise SdbError(f"Cannot use {render(v)} in a MERGE clause")
        out = copy_value(doc)
        _deep_merge(out, copy_value(v))
        if "id" in doc:
            out["id"] = doc["id"]
        return out
    if isinstance(data, PatchData):
        from surrealdb_tpu_torch.utils.patch import apply_patch

        ops = evaluate(data.expr, ctx)
        out = apply_patch(doc, ops)
        if "id" in doc:
            out["id"] = doc["id"]
        return out
    if isinstance(data, SetData):
        out = copy_value(doc)
        c = ctx.with_doc(out, rid)
        # bare-field references see assignments as they land (sequential
        # SET), but $this stays pinned to the statement-start state
        c.vars["this"] = this_doc
        for target, op, expr in data.items:
            v = evaluate(expr, c)
            path = _idiom_path(target)
            if op == "=":
                if v is NONE:
                    # assigning NONE removes the field (reference SET)
                    _del_path_value(out, path)
                else:
                    _set_path_value(out, path, v, ctx)
            elif op == "+=":
                cur = _get_path_value(out, path)
                _set_path_value(out, path, _add_assign(cur, v), ctx)
            elif op == "-=":
                cur = _get_path_value(out, path)
                _set_path_value(out, path, _sub_assign(cur, v), ctx)
            elif op == "+?=":
                cur = _get_path_value(out, path)
                if isinstance(cur, list):
                    if not any(value_eq(x, v) for x in cur):
                        _set_path_value(out, path, cur + [v], ctx)
                elif cur is NONE or cur is None:
                    _set_path_value(out, path, [v], ctx)
            elif op == "*=":
                from surrealdb_tpu_torch.exec.operators import mul

                cur = _get_path_value(out, path)
                _set_path_value(out, path, mul(cur, v), ctx)
        return out
    if isinstance(data, UnsetData):
        out = copy_value(doc)
        for f in data.fields:
            path = _idiom_path(f)
            _del_path_value(out, path)
        return out
    raise SdbError(f"unhandled data clause {data!r}")


def _add_assign(cur, v):
    if cur is NONE or cur is None:
        # reference increment on an absent field: numbers stay scalar,
        # anything else starts an array (SET citizens += person -> [person])
        from decimal import Decimal

        from surrealdb_tpu_torch.val import Duration

        from surrealdb_tpu_torch.val import SSet

        if isinstance(v, (list, SSet)):
            return v
        if isinstance(v, (int, float, Decimal, Duration)) and not isinstance(
            v, bool
        ):
            return v
        return [v]
    from surrealdb_tpu_torch.val import SSet

    if isinstance(cur, list):
        return cur + (list(v) if isinstance(v, (list, SSet)) else [v])
    if isinstance(cur, SSet):
        extra = list(v) if isinstance(v, (list, SSet)) else [v]
        return SSet(cur.items + extra)
    from surrealdb_tpu_torch.exec.operators import add

    return add(cur, v)


def _sub_assign(cur, v):
    if cur is NONE or cur is None:
        from surrealdb_tpu_torch.exec.operators import neg

        try:
            return neg(v)
        except SdbError:
            return NONE
    from surrealdb_tpu_torch.val import SSet

    # -= removes by VALUE on arrays/sets (unlike the binary `-` operator,
    # which errors for scalar operands; set_array_common_behaviour.surql)
    if isinstance(cur, list) and not isinstance(v, (list, SSet)):
        return [x for x in cur if not value_eq(x, v)]
    if isinstance(cur, SSet) and not isinstance(v, (list, SSet)):
        return SSet([x for x in cur.items if not value_eq(x, v)])
    from surrealdb_tpu_torch.exec.operators import sub

    return sub(cur, v)


def _prune_none(v):
    """NONE entries never store in objects (reference Value semantics):
    CONTENT { a: NONE } removes `a`, recursively."""
    if isinstance(v, dict):
        return {k: _prune_none(x) for k, x in v.items() if x is not NONE}
    if isinstance(v, list):
        return [_prune_none(x) for x in v]
    return v


def _deep_merge(dst: dict, src: dict):
    for k, v in src.items():
        if v is NONE:
            dst.pop(k, None)
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _idiom_path(target):
    if isinstance(target, Idiom):
        path = []
        for p in target.parts:
            if isinstance(p, PField):
                path.append(p.name)
            elif isinstance(p, PAll):
                path.append("*")
            elif hasattr(p, "expr"):
                from surrealdb_tpu_torch.expr.ast import PIndex

                if isinstance(p, PIndex):
                    path.append(("idx", p.expr))
                else:
                    raise SdbError("Unsupported assignment target")
            else:
                raise SdbError("Unsupported assignment target")
        return path
    raise SdbError("Unsupported assignment target")


def _set_path_value(doc, path, v, ctx):
    cur = doc
    for i, seg in enumerate(path[:-1]):
        if seg == "*":
            if isinstance(cur, list):
                for item in cur:
                    _set_path_value(item, path[i + 1 :], v, ctx)
            return
        if isinstance(seg, tuple):
            key = evaluate(seg[1], ctx)
            if isinstance(key, str):
                if isinstance(cur, dict):
                    nxt = cur.get(key)
                    if not isinstance(nxt, (dict, list)):
                        nxt = {}
                        cur[key] = nxt
                    cur = nxt
                    continue
                return
            idx = int(key)
            if isinstance(cur, list) and -len(cur) <= idx < len(cur):
                cur = cur[idx]
                continue
            return
        nxt = cur.get(seg) if isinstance(cur, dict) else None
        if not isinstance(nxt, (dict, list)):
            nxt = {}
            if isinstance(cur, dict):
                cur[seg] = nxt
            else:
                return
        cur = nxt
    last = path[-1]
    if last == "*":
        if isinstance(cur, list):
            for i in range(len(cur)):
                cur[i] = v
        return
    if isinstance(last, tuple):
        key = evaluate(last[1], ctx)
        if isinstance(key, str):
            if isinstance(cur, dict):
                cur[key] = v
            return
        idx = int(key)
        if isinstance(cur, list) and -len(cur) <= idx < len(cur):
            cur[idx] = v
        return
    if isinstance(cur, dict):
        cur[last] = v
    elif isinstance(cur, list):
        for item in cur:
            if isinstance(item, dict):
                item[last] = v


def _get_path_value(doc, path):
    cur = doc
    for seg in path:
        if seg == "*":
            return cur
        if isinstance(seg, tuple):
            return NONE
        if isinstance(cur, dict):
            cur = cur.get(seg, NONE)
        elif isinstance(cur, list):
            cur = [x.get(seg, NONE) if isinstance(x, dict) else NONE for x in cur]
        else:
            return NONE
    return cur


def _del_path_value(doc, path):
    cur = doc
    for seg in path[:-1]:
        if isinstance(cur, dict):
            cur = cur.get(seg)
        else:
            return
    if isinstance(cur, dict) and isinstance(path[-1], str):
        cur.pop(path[-1], None)


# ---------------------------------------------------------------------------
# table / schema helpers
# ---------------------------------------------------------------------------


def get_table(tb: str, ctx: Ctx, create=True) -> TableDef:
    ns, db = ctx.need_ns_db()
    tdef = ctx.txn.get_val(K.tb_def(ns, db, tb))
    if tdef is None:
        if not create:
            raise SdbError(f"The table '{tb}' does not exist")
        dbdef = ctx.txn.get_val(K.db_def(ns, db))
        if ctx.ds.strict or (
            dbdef is not None and getattr(dbdef, "strict", False)
        ):
            raise SdbError(f"The table '{tb}' does not exist")
        from surrealdb_tpu_torch.exec.statements import _ensure_ns_db

        _ensure_ns_db(ctx)
        tdef = TableDef(name=tb)
        ctx.txn.set_val(K.tb_def(ns, db, tb), tdef)
    return tdef


def get_fields(tb: str, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    out = [d for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.fd_prefix(ns, db, tb)))]
    out.sort(key=lambda f: len(f.name))
    return out


def get_indexes(tb: str, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    return [d for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ix_prefix(ns, db, tb)))]


def get_events(tb: str, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    return [d for _k, d in ctx.txn.scan_vals(*K.prefix_range(K.ev_prefix(ns, db, tb)))]


def apply_fields(
    tb: str, tdef: TableDef, before, after: dict, ctx: Ctx, rid, is_create: bool
):
    """Field-definition stage: defaults, VALUE, TYPE coercion, ASSERT,
    READONLY, schemafull pruning (reference doc/field.rs + doc/alter.rs)."""
    fields = get_fields(tb, ctx)
    defined_top = set()
    for fd in fields:
        path = [p.name if isinstance(p, PField) else "*" for p in fd.name]
        if path:
            defined_top.add(path[0])
        if fd.computed is not None:
            continue  # computed fields are read-time only (doc/compute.rs)
        targets = []
        for tgt_doc, old_doc in _field_targets(after, before, path[:-1]):
            last = path[-1]
            if last == "*":
                # a trailing `*` applies the definition to every child:
                # object values for dicts, elements for arrays
                if isinstance(tgt_doc, dict):
                    targets.extend(
                        (tgt_doc, old_doc, kk) for kk in list(tgt_doc)
                    )
                elif isinstance(tgt_doc, list):
                    targets.extend(
                        (tgt_doc, old_doc, i) for i in range(len(tgt_doc))
                    )
            elif isinstance(tgt_doc, dict):
                targets.append((tgt_doc, old_doc, last))
        for tgt_doc, old_doc, last in targets:
            if isinstance(last, int):
                cur = tgt_doc[last] if last < len(tgt_doc) else NONE
                old = (
                    old_doc[last]
                    if isinstance(old_doc, list) and last < len(old_doc)
                    else NONE
                )
            else:
                cur = tgt_doc.get(last, NONE)
                old = (
                    old_doc.get(last, NONE)
                    if isinstance(old_doc, dict)
                    else NONE
                )
            c = ctx.with_doc(after, rid)
            c.vars["input"] = cur
            c.vars["value"] = cur
            c.vars["before"] = old
            c.vars["after"] = cur
            # explicit input coerces to the declared type BEFORE the VALUE
            # clause runs (reference doc/field.rs order: default_value.surql)
            if cur is not NONE and fd.kind is not None:
                try:
                    if path == ["id"] and isinstance(cur, RecordId):
                        # a definition on `id` constrains the record KEY
                        coerce(cur.id, fd.kind)
                    else:
                        cur = coerce(cur, fd.kind)
                except SdbError as e:
                    raise SdbError(
                        f"Couldn't coerce value for field `{fd.name_str}` "
                        f"of `{rid.render() if rid else '?'}`: {e}"
                    )
                c.vars["value"] = cur
                c.vars["after"] = cur
            # DEFAULT
            if cur is NONE and fd.default is not None and (
                is_create or fd.default_always
            ):
                cur = evaluate(fd.default, c)
                c.vars["value"] = cur
                c.vars["after"] = cur
            # VALUE (always evaluated when set)
            if fd.value is not None:
                cur = evaluate(fd.value, c)
                c.vars["value"] = cur
                c.vars["after"] = cur
            # READONLY
            if fd.readonly and not is_create:
                if old is not NONE and (
                    (cur is not NONE and not value_eq(cur, old))
                    or (cur is NONE
                        and getattr(ctx, "_strict_readonly", False))
                ):
                    raise SdbError(
                        f"Found changed value for field `{fd.name_str}`, with record `{rid.render()}`, but field is readonly"
                    )
                if old is not NONE:
                    cur = old
            # TYPE coercion — a definition on `id` constrains the record
            # KEY, not the RecordId value itself (reference doc/field.rs)
            if fd.kind is not None:
                try:
                    if path == ["id"] and isinstance(cur, RecordId):
                        coerce(cur.id, fd.kind)
                    else:
                        cur = coerce(cur, fd.kind)
                except SdbError as e:
                    raise SdbError(
                        f"Couldn't coerce value for field `{fd.name_str}` of `{rid.render() if rid else '?'}`: {e}"
                    )
            # ASSERT
            skip_assert = cur is NONE and fd.kind is not None and \
                _kind_allows_none(fd.kind)
            if fd.assert_ is not None and not skip_assert:
                c.vars["value"] = cur
                if not is_truthy(evaluate(fd.assert_, c)):
                    from surrealdb_tpu_torch.exec.render_def import _expr_sql

                    raise SdbError(
                        f"Found {render(cur)} for field `{fd.name_str}`, with record `{rid.render()}`, but field must conform to: {_expr_sql(fd.assert_)}"
                    )
            if cur is NONE and isinstance(tgt_doc, dict):
                tgt_doc.pop(last, None)
            else:
                tgt_doc[last] = cur
    # COMPUTED fields are read-time only: strip any stored/copied snapshots
    # (reference doc/field.rs clears computed fields before store; pluck
    # recomputes them for output)
    for fd in fields:
        if fd.computed is not None and fd.name_str in after:
            after.pop(fd.name_str, None)
    # SCHEMAFULL strictness: unknown fields error (doc/field.rs)
    if tdef.full:
        defined_paths = set()
        flex_paths = set()
        for f in fields:
            p = tuple(
                q.name if isinstance(q, PField) else "*" for q in f.name
            )
            defined_paths.add(p)
            if f.flex or (f.kind is not None and f.kind.name == "any"):
                flex_paths.add(p)
        _check_schemafull(after, (), defined_paths, flex_paths, fields, tb, rid)
    return after


def _field_kind_at(fields, path):
    for f in fields:
        p = tuple(q.name if isinstance(q, PField) else "*" for q in f.name)
        if p == path:
            return f.kind
    return None


def _check_schemafull(doc, prefix, defined, flex, fields, tb, rid):
    """Error on any document path not covered by a field definition, unless
    under a FLEXIBLE (or literal-typed) ancestor."""
    if not isinstance(doc, dict):
        return
    for k in list(doc.keys()):
        if not prefix and k in ("id", "in", "out"):
            continue
        path = prefix + (k,)
        if _covered(path, flex):
            continue
        if path not in defined and not _has_descendant(path, defined):
            # literal kinds cover their sub-paths implicitly — the nearest
            # ANCESTOR with a declared kind decides (tuple literals like
            # [int, { k: int }] never get implicit .* defs, so the check
            # must look past undefined intermediate segments)
            lit_covered = False
            for j in range(len(path) - 1, 0, -1):
                anc_kind = _field_kind_at(fields, path[:j])
                if anc_kind is not None:
                    lit_covered = anc_kind.name in (
                        "literal", "object_literal", "array_literal"
                    )
                    break
            if lit_covered:
                continue
            dotted = ".".join(path)
            raise SdbError(
                f"Found field '{dotted}', but no such field exists for table '{tb}'"
            )
        v = doc[k]
        if isinstance(v, dict):
            _check_schemafull(v, path, defined, flex, fields, tb, rid)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, dict):
                    _check_schemafull(
                        item, path + ("*",), defined, flex, fields, tb, rid
                    )


def _covered(path, flex_paths):
    """Is some prefix of `path` a flexible field?"""
    for i in range(1, len(path) + 1):
        if path[:i] in flex_paths:
            return True
    return False


def _has_descendant(path, defined):
    return any(p[: len(path)] == path and len(p) > len(path) for p in defined)


def _field_targets(after, before, parent_path):
    """Yield (container, old_container) pairs for a field's parent path,
    expanding `*` over arrays."""
    pairs = [(after, before)]
    for seg in parent_path:
        nxt = []
        for doc, old in pairs:
            if seg == "*":
                if isinstance(doc, list):
                    for i, item in enumerate(doc):
                        olditem = (
                            old[i]
                            if isinstance(old, list) and i < len(old)
                            else NONE
                        )
                        nxt.append((item, olditem))
            else:
                if isinstance(doc, dict):
                    sub = doc.get(seg)
                    if sub is None or sub is NONE:
                        continue
                    oldsub = old.get(seg, NONE) if isinstance(old, dict) else NONE
                    nxt.append((sub, oldsub))
        pairs = nxt
    return pairs


# ---------------------------------------------------------------------------
# index maintenance
# ---------------------------------------------------------------------------


def _kind_allows_none(k) -> bool:
    if k.name in ("option", "any", "none"):
        return True
    if k.name == "either":
        return any(_kind_allows_none(b) for b in k.inner)
    return False


def _index_values(idef, doc, ctx, rid):
    c = ctx.with_doc(doc, rid)
    vals = [evaluate(col, c) for col in idef.cols]
    return vals


def _count_cond_matches(idef, doc, ctx, rid) -> bool:
    """COUNT index membership: the row exists and, for a conditional
    count index (COUNT WHERE expr), the condition is truthy on the doc."""
    if not isinstance(doc, dict):
        return False
    cond = getattr(idef, "count_cond", None)
    if cond is None:
        return True
    from surrealdb_tpu_torch.err import SdbError
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.val import is_truthy

    try:
        return is_truthy(evaluate(cond, ctx.with_doc(doc, rid)))
    except SdbError:
        return False


def _index_rows(vals, idef=None):
    """Index-entry combinator (reference idx/index.rs Indexable/Combinator):
    array columns unnest per-element UNLESS the column idiom ends with `…`
    (Flatten) — those index the whole (flattened) array as one value. The
    walk advances only one column iterator per step (staircase, not a cross
    product)."""
    from surrealdb_tpu_torch.expr.ast import Idiom, PFlatten

    cols = []
    for i, v in enumerate(vals):
        flat = False
        if idef is not None and i < len(idef.cols):
            col = idef.cols[i]
            if isinstance(col, Idiom) and col.parts and isinstance(
                col.parts[-1], PFlatten
            ):
                flat = True
        from surrealdb_tpu_torch.val import SSet

        if isinstance(v, SSet):
            v = list(v)
        if not flat and isinstance(v, list):
            cols.append(v if v else [NONE])
        else:
            cols.append([v])
    rows = []
    pos = [0] * len(cols)
    has_next = True
    while has_next:
        row = []
        has_next = False
        for i, values in enumerate(cols):
            row.append(values[pos[i]])
            if not has_next and pos[i] + 1 < len(values):
                pos[i] += 1
                has_next = True
        rows.append(row)
    return rows


_EDGE_POISON = object()


def _log_edge_op(ctx, gk, op):
    """Classify this txn's adjacency effect on an edge table for the CSR
    op-log: a ("add", edge_id, in_id, out_id) tuple, None for "no
    adjacency change", or _EDGE_POISON for changes only a rebuild can
    absorb (deletes, in/out rewrites)."""
    ops = getattr(ctx.txn, "_edge_ops", None)
    if ops is None:
        ops = ctx.txn._edge_ops = {}
    cur = ops.get(gk)
    if op is _EDGE_POISON:
        ops[gk] = _EDGE_POISON
        return
    if cur is _EDGE_POISON:
        return
    if cur is None:
        cur = ops[gk] = []
    if op is not None:
        cur.append(op)


def _bump_graph_version(ctx, gk):
    """Invalidate the CSR cache for a graph table — AFTER commit, so the
    shared cache never advances past committed state (an uncommitted
    RELATE must not stamp a committed-only rebuild as current)."""
    def bump():
        from surrealdb_tpu_torch.graph.csr import oplog_push

        ds = ctx.ds
        ops = getattr(ctx.txn, "_edge_ops", {}).get(gk)
        # version allocation and the op-log push are ONE atomic step:
        # concurrent commits must not share a version number or a CSR
        # replay could permanently skip one txn's edges
        with ds.lock:
            newv = ds.graph_versions.get(gk, 0) + 1
            ds.graph_versions[gk] = newv
            # unclassified writes (or poison) force the next reader to
            # rebuild; classified adds replay incrementally
            oplog_push(
                ds, gk, newv,
                None if ops is None or ops is _EDGE_POISON else list(ops),
            )

    if hasattr(ctx.txn, "on_commit"):
        # within this txn the CSR cache is stale for gk: the fast paths
        # check this marker and fall back to per-record scans. One hook
        # per distinct table — bulk writes register once.
        dirty = getattr(ctx.txn, "_graph_dirty", None)
        if dirty is None:
            dirty = ctx.txn._graph_dirty = set()
        if gk not in dirty:
            dirty.add(gk)
            ctx.txn.on_commit(bump)
    else:
        bump()


def index_update(rid: RecordId, before, after, ctx: Ctx):
    """Remove old entries / add new for every index on the table
    (reference idx/index.rs IndexOperation)."""
    ns, db = ctx.need_ns_db()
    for idef in get_indexes(rid.tb, ctx):
        if idef.hnsw is not None:
            from surrealdb_tpu_torch.idx.vector import vector_index_update

            vector_index_update(idef, rid, before, after, ctx)
            continue
        if idef.fulltext is not None:
            from surrealdb_tpu_torch.idx.fulltext import fulltext_index_update

            fulltext_index_update(idef, rid, before, after, ctx)
            continue
        old_rows = (
            _index_rows(_index_values(idef, before, ctx, rid), idef)
            if isinstance(before, dict)
            else []
        )
        new_rows = (
            _index_rows(_index_values(idef, after, ctx, rid), idef)
            if isinstance(after, dict)
            else []
        )
        if idef.count:
            key = K.ix_state(ns, db, rid.tb, idef.name, b"ct")
            cur = ctx.txn.get_val(key) or 0
            delta = (
                (1 if _count_cond_matches(idef, after, ctx, rid) else 0)
                - (1 if _count_cond_matches(idef, before, ctx, rid) else 0)
            )
            ctx.txn.set_val(key, cur + delta)
            continue
        if idef.unique:
            for row in old_rows:
                if any(x is NONE or x is None for x in row):
                    # NONE rows live in the non-unique keyspace (duplicates
                    # allowed; reference indexes None without the constraint)
                    ctx.txn.delete(
                        K.index(ns, db, rid.tb, idef.name, row, rid.id)
                    )
                    continue
                k = K.index_unique(ns, db, rid.tb, idef.name, row)
                existing = ctx.txn.get_val(k)
                if existing is not None and value_eq(existing, rid):
                    ctx.txn.delete(k)
            for row in new_rows:
                if any(x is NONE or x is None for x in row):
                    ctx.txn.set_val(
                        K.index(ns, db, rid.tb, idef.name, row, rid.id),
                        rid,
                    )
                    continue
                k = K.index_unique(ns, db, rid.tb, idef.name, row)
                existing = ctx.txn.get_val(k)
                if existing is not None and not value_eq(existing, rid):
                    vals = row[0] if len(row) == 1 else row
                    raise SdbError(
                        f"Database index `{idef.name}` already contains "
                        f"{render(_index_msg_value(vals))}, "
                        f"with record `{existing.render()}`"
                    )
                ctx.txn.set_val(k, rid)
        else:
            for row in old_rows:
                ctx.txn.delete(K.index(ns, db, rid.tb, idef.name, row, rid.id))
            for row in new_rows:
                ctx.txn.set(
                    K.index(ns, db, rid.tb, idef.name, row, rid.id), b"\x00"
                )


def _ref_targets(fd, doc, ctx, rid):
    """RecordIds held by a REFERENCE field (arrays/sets flatten)."""
    if not isinstance(doc, dict):
        return []
    c = ctx.with_doc(doc, rid)
    from surrealdb_tpu_torch.exec.eval import walk

    v = walk(doc, [p for p in fd.name], c)
    out = []

    def _collect(x):
        if isinstance(x, RecordId):
            out.append(x)
        elif isinstance(x, (list,)):
            for y in x:
                _collect(y)
        else:
            from surrealdb_tpu_torch.val import SSet

            if isinstance(x, SSet):
                for y in x.items:
                    _collect(y)

    _collect(v)
    return out


def refs_update(rid: RecordId, before, after, ctx: Ctx):
    """Maintain `&` reference keys for REFERENCE-marked fields."""
    ns, db = ctx.need_ns_db()
    for fd in get_fields(rid.tb, ctx):
        if fd.reference is None:
            continue
        old = _ref_targets(fd, before, ctx, rid) if isinstance(before, dict) else []
        new = _ref_targets(fd, after, ctx, rid) if isinstance(after, dict) else []
        oldk = {(t.tb, K.enc_value(t.id)): t for t in old}
        newk = {(t.tb, K.enc_value(t.id)): t for t in new}
        for hk, t in oldk.items():
            if hk not in newk:
                ctx.txn.delete(
                    K.ref(ns, db, t.tb, t.id, rid.tb, fd.name_str, rid.id)
                )
        for hk, t in newk.items():
            if hk not in oldk:
                ctx.txn.set(
                    K.ref(ns, db, t.tb, t.id, rid.tb, fd.name_str, rid.id),
                    b"",
                )


def apply_ref_on_delete(rid: RecordId, ctx: Ctx):
    """When deleting a referenced record, apply each referencing field's
    ON DELETE action (reference doc reference semantics). Ref keys are
    dropped before any recursive delete so cyclic cascades terminate."""
    ns, db = ctx.need_ns_db()
    deleting = ctx.record_cache.setdefault("__deleting__", set())
    me = (rid.tb, K.enc_value(rid.id))
    if me in deleting:
        return
    deleting.add(me)
    beg, end = K.prefix_range(K.ref_prefix(ns, db, rid.tb, rid.id))
    entries = []
    for k in list(ctx.txn.keys(beg, end)):
        _n, _d, _t, _i, ft, ff, fk = K.decode_ref(k)
        fdef = next(
            (
                fd
                for fd in get_fields(ft, ctx)
                if fd.reference is not None and fd.name_str == ff
            ),
            None,
        )
        entries.append((ft, ff, RecordId(ft, fk), k, fdef))
    # REJECT wins before any mutation happens
    for ft, ff, fk, k, fdef in entries:
        action = (fdef.reference or {}).get("on_delete", "ignore") if fdef else "ignore"
        if action == "reject":
            raise SdbError(
                f"Cannot delete `{rid.render()}` as it is referenced by "
                f"`{fk.render()}` with an ON DELETE REJECT clause"
            )
    for ft, ff, fk, k, fdef in entries:
        ctx.txn.delete(k)  # drop the ref key first: breaks cascade cycles
        if fdef is None:
            continue
        action = (fdef.reference or {}).get("on_delete", "ignore")
        fk_key = (fk.tb, K.enc_value(fk.id))
        if fk_key in deleting:
            continue
        ctx.record_cache.pop(fk_key, None)
        doc = fetch_record(ctx, fk)
        if doc is NONE:
            continue
        if action == "cascade":
            delete_one(fk, doc, OutputClause("none"), ctx)
        elif action == "unset":
            from surrealdb_tpu_torch.val import SSet

            cur = doc.get(ff, NONE)
            nd = copy_value(doc)

            def _not_me(x):
                return not (
                    isinstance(x, RecordId)
                    and x.tb == rid.tb
                    and value_eq(x.id, rid.id)
                )

            if isinstance(cur, list):
                nd[ff] = [x for x in cur if _not_me(x)]
            elif isinstance(cur, SSet):
                nd[ff] = SSet([x for x in cur.items if _not_me(x)])
            else:
                nd.pop(ff, None)
            _store_record(fk, doc, nd, ctx, "UPDATE", OutputClause("none"))
        elif action == "then":
            from surrealdb_tpu_torch.exec.statements import eval_statement

            c = ctx.with_doc(doc, fk)
            c.vars["reference"] = rid
            c.vars["this"] = fk
            then = (fdef.reference or {}).get("then")
            if then is not None:
                eval_statement(then, c)


def build_index(idef, ctx: Ctx):
    """Index an existing table's records (DEFINE INDEX on populated table).
    Returns the number of records indexed and records the build status
    (reference kvs/index.rs IndexBuilder / BuildingStatus)."""
    ns, db = ctx.need_ns_db()
    key = (ns, db, idef.tb, idef.name)
    ctx.ds.index_builds[key] = {
        "status": "indexing", "initial": 0, "pending": 0, "updated": 0,
    }
    count = 0
    beg, end = K.prefix_range(K.record_prefix(ns, db, idef.tb))
    for k, raw in list(ctx.txn.scan(beg, end)):
        count += 1
        _ns, _db, _tb, idv = K.decode_record_id(k)
        rid = RecordId(idef.tb, idv)
        doc = deserialize_once(raw)
        # inline: perform same logic for just this idef
        _single_index_add(idef, rid, doc, ctx)
    ctx.ds.index_builds[key] = {
        "status": "ready", "initial": count, "pending": 0, "updated": 0,
    }
    return count


def _single_index_add(idef, rid, doc, ctx):
    ns, db = ctx.need_ns_db()
    if idef.hnsw is not None:
        from surrealdb_tpu_torch.idx.vector import vector_index_update

        vector_index_update(idef, rid, NONE, doc, ctx)
        return
    if idef.fulltext is not None:
        from surrealdb_tpu_torch.idx.fulltext import fulltext_index_update

        fulltext_index_update(idef, rid, NONE, doc, ctx)
        return
    if idef.count:
        if not _count_cond_matches(idef, doc, ctx, rid):
            return
        key = K.ix_state(ns, db, rid.tb, idef.name, b"ct")
        cur = ctx.txn.get_val(key) or 0
        ctx.txn.set_val(key, cur + 1)
        return
    rows = _index_rows(_index_values(idef, doc, ctx, rid), idef)
    if idef.unique:
        for row in rows:
            if any(x is NONE or x is None for x in row):
                # rows with a NONE column skip the unique constraint (SQL
                # NULL semantics) but stay range-scannable
                ctx.txn.set_val(
                    K.index(ns, db, rid.tb, idef.name, row, rid.id), rid
                )
                continue
            k = K.index_unique(ns, db, rid.tb, idef.name, row)
            existing = ctx.txn.get_val(k)
            if existing is not None and not value_eq(existing, rid):
                vals = row[0] if len(row) == 1 else row
                raise SdbError(
                    f"Database index `{idef.name}` already contains "
                    f"{render(_index_msg_value(vals))}, "
                    f"with record `{existing.render()}`"
                )
            ctx.txn.set_val(k, rid)
    else:
        for row in rows:
            ctx.txn.set(K.index(ns, db, rid.tb, idef.name, row, rid.id), b"\x00")


def view_source_tables(sel) -> list:
    """Table names a view's SELECT reads from (views are not ported;
    INFO FOR TABLE lists a stored view under its source tables)."""
    froms = []
    for w in getattr(sel, "what", []):
        if isinstance(w, Idiom) and len(w.parts) == 1 and isinstance(
            w.parts[0], PField
        ):
            froms.append(w.parts[0].name)
    return froms


# ---------------------------------------------------------------------------
# events / live queries
# ---------------------------------------------------------------------------


def run_events(rid, before, after, action, ctx: Ctx, input_doc=NONE):
    events = get_events(rid.tb, ctx)
    if not events:
        return
    from surrealdb_tpu_torch.exec.statements import eval_statement

    for ev in events:
        c = ctx.with_doc(after if isinstance(after, dict) else before, rid)
        c.vars["event"] = action
        c.vars["before"] = before if before is not NONE else NONE
        c.vars["after"] = after if after is not NONE else NONE
        c.vars["value"] = after if isinstance(after, dict) else before
        c.vars["input"] = input_doc
        if ev.when is not None and not is_truthy(evaluate(ev.when, c)):
            continue
        if getattr(ev, "async_", False):
            # async events never fail the triggering write (reference
            # doc/event.rs enqueues them out-of-band); retry up to RETRY
            tries = 1 + int(getattr(ev, "retry", None) or 1)
            for _try in range(tries):
                try:
                    for stmt in ev.then:
                        eval_statement(stmt, c)
                    break
                except SdbError:
                    continue
            continue
        try:
            for stmt in ev.then:
                eval_statement(stmt, c)
        except SdbError as e:
            raise SdbError(
                f"Error while processing event {ev.name}: {e}"
            )


def notify_lives(rid, before, after, action, ctx: Ctx):
    """Live-query CAPTURE (doc/lives.rs:29 process_table_lives).

    The commit path does no matching: when the subscription registry
    has entries for this (ns, db, tb) — one indexed dict lookup — the
    mutation is snapshotted into the transaction's `_live_events`
    buffer. The executor publishes the buffer to the fan-out dispatch
    workers only after the transaction COMMITS (server/fanout.py);
    condition/projection evaluation, payload shaping, and delivery all
    happen post-commit, off this thread. A rolled-back statement's
    events are truncated with its savepoint, and a cancelled
    transaction publishes nothing."""
    ns, db = ctx.need_ns_db()
    if not ctx.ds.live_queries.count_for(ns, db, rid.tb):
        return
    from surrealdb_tpu_torch.server.fanout import LiveEvent

    txn = ctx.txn
    buf = getattr(txn, "_live_events", None)
    if buf is None:
        buf = txn._live_events = []
    # snapshot: the executor may mutate these dicts after this statement
    # (same-txn overwrites share doc objects via the record cache)
    buf.append(LiveEvent(
        ns, db, rid.tb, rid,
        copy_value(before), copy_value(after), action,
    ))


# ---------------------------------------------------------------------------
# output shaping
# ---------------------------------------------------------------------------


def shape_output(output: OutputClause, before, after, rid, ctx: Ctx):
    from surrealdb_tpu_torch.exec.eval import apply_computed_fields

    if isinstance(after, dict) and rid is not None:
        after = apply_computed_fields(rid.tb, after, rid, ctx)
    if rid is not None and not ctx.session.is_owner and \
            ctx.session.auth_level != "editor":
        from surrealdb_tpu_torch.exec.statements import check_table_permission

        # statement output is a read: rows the session can't SELECT drop
        # from the result set even when the write itself was allowed
        # (delete/permissions/no_select.surql)
        if isinstance(before, dict) and not check_table_permission(
            rid.tb, "select", ctx, before, rid
        ):
            before = SKIP
        if isinstance(after, dict) and not check_table_permission(
            rid.tb, "select", ctx, after, rid
        ):
            after = SKIP
        if (output is None or output.kind == "after") and after is SKIP:
            return SKIP
        if output is not None and output.kind == "before" and before is SKIP:
            return SKIP
        before = NONE if before is SKIP else before
        after = NONE if after is SKIP else after
        after = reduce_fields(rid.tb, after, ctx)
        before = reduce_fields(rid.tb, before, ctx)
    if output is None or output.kind == "after":
        return copy_value(after) if after is not NONE else NONE
    k = output.kind
    if k == "none":
        return NONE
    if k == "null":
        return None
    if k == "before":
        return copy_value(before) if before is not NONE else NONE
    if k == "diff":
        from surrealdb_tpu_torch.utils.patch import diff

        # NONE→doc diffs as a root replace (reference val diff semantics)
        return diff(before, after)
    if k in ("fields", "value"):
        from surrealdb_tpu_torch.exec.statements import expr_name

        doc = after if after is not NONE else before
        c = ctx.with_doc(doc, rid)
        c.vars["before"] = before
        c.vars["after"] = after
        if k == "value":
            return evaluate(output.fields[0][0], c)
        from surrealdb_tpu_torch.exec.statements import _dynamic_field_key

        out = {}
        for expr, alias in output.fields:
            if expr == "*":
                if isinstance(doc, dict):
                    out.update(copy_value(doc))
                continue
            key = alias or _dynamic_field_key(expr, c) or expr_name(expr)
            out[key] = evaluate(expr, c)
        return out
    return copy_value(after)


# ---------------------------------------------------------------------------
# the pipeline entry points
# ---------------------------------------------------------------------------


def _index_msg_value(v):
    """Uniqueness-violation messages show the value as decoded from the
    index key, which stores decimals in normalized form (0.0dec → 0dec)."""
    import decimal as _dec

    if isinstance(v, _dec.Decimal):
        n = v.normalize()
        if n.as_tuple().exponent > 0:
            n = n.quantize(_dec.Decimal(1))
        return n
    if isinstance(v, (list, tuple)):
        return [_index_msg_value(x) for x in v]
    return v


def _store_record(rid, before, after, ctx: Ctx, action, output, edge=None):
    """Shared store stages: schema, perms, write, edges, indexes, events,
    lives, output."""
    ns, db = ctx.need_ns_db()
    # the user-supplied document, before schema/VALUE clauses ($input)
    input_doc = copy_value(after) if isinstance(after, dict) else NONE
    tdef = get_table(rid.tb, ctx)
    is_create = action == "CREATE"
    # relation-table checks
    if tdef.kind == "relation" and edge is None and is_create and (
        not isinstance(after.get("in"), RecordId)
        or not isinstance(after.get("out"), RecordId)
    ):
        expect = "RELATION"
        if tdef.relation_from:
            expect += " IN " + " | ".join(tdef.relation_from)
        if tdef.relation_to:
            expect += " OUT " + " | ".join(tdef.relation_to)
        raise SdbError(
            f"Found record: `{rid.render()}` which is not a relation, "
            f"but expected a {expect}"
        )
    if tdef.kind == "normal" and edge is not None:
        raise SdbError(
            f"Found record: `{rid.render()}` which is a relation, "
            f"but expected a NORMAL"
        )
    # edges populate in/out BEFORE field schema so typed in/out coerce
    if edge is not None:
        l, r = edge
        if tdef.enforced:
            if fetch_record(ctx, l) is NONE:
                raise SdbError(f"The record '{l.render()}' does not exist")
            if fetch_record(ctx, r) is NONE:
                raise SdbError(f"The record '{r.render()}' does not exist")
        after["in"] = l
        after["out"] = r
    # field schema
    after = apply_fields(rid.tb, tdef, before, after, ctx, rid, is_create)
    after["id"] = rid
    # anonymous / read-only system sessions fail the statement-level IAM
    # check outright (reference Options::is_allowed, Action::Edit)
    if ctx.session.auth_level in ("none", "viewer"):
        raise SdbError(
            "IAM error: Not enough permissions to perform this action"
        )
    # table permissions run AFTER field processing (reference
    # doc/create.rs pipeline: check_permissions_table follows
    # process_table_fields) so DEFAULT/VALUE-computed fields participate;
    # a denied write silently drops the record (doc/check.rs
    # IgnoreError::Ignore), writing nothing
    if not ctx.session.is_owner and ctx.session.auth_level not in ("editor",):
        from surrealdb_tpu_torch.exec.statements import check_table_permission

        act = "create" if is_create else "update"
        if not check_table_permission(rid.tb, act, ctx, after, rid):
            return SKIP
    if edge is not None:
        l, r = edge
        # the four graph keys (reference doc/edges.rs:14)
        ctx.txn.set(K.graph(ns, db, l.tb, l.id, K.DIR_OUT, rid.tb, rid.id), b"")
        ctx.txn.set(K.graph(ns, db, rid.tb, rid.id, K.DIR_IN, l.tb, l.id), b"")
        ctx.txn.set(K.graph(ns, db, rid.tb, rid.id, K.DIR_OUT, r.tb, r.id), b"")
        ctx.txn.set(K.graph(ns, db, r.tb, r.id, K.DIR_IN, rid.tb, rid.id), b"")
    # store (drop tables discard writes but still run the rest)
    if not tdef.drop:
        ctx.txn.set(K.record(ns, db, rid.tb, rid.id), serialize(after))
        import time as _time

        wts = ctx.write_version or _time.time_ns()
        ctx.txn.set(
            K.hist(ns, db, rid.tb, rid.id, wts),
            serialize(after),
        )
        ctx.record_cache[(rid.tb, K.enc_value(rid.id))] = after
    gk = (ns, db, rid.tb)
    if tdef.kind == "relation":
        lv, rv = after.get("in"), after.get("out")
        if is_create and isinstance(lv, RecordId) and isinstance(
            rv, RecordId
        ):
            _log_edge_op(
                ctx, gk,
                ("add", rid.id, lv.tb, lv.id, rv.tb, rv.id),
            )
        elif isinstance(before, dict) and value_eq(
            before.get("in"), lv
        ) and value_eq(before.get("out"), rv):
            _log_edge_op(ctx, gk, None)  # edge payload change only
        else:
            _log_edge_op(ctx, gk, _EDGE_POISON)
    _bump_graph_version(ctx, gk)
    # indexes
    index_update(rid, before, after, ctx)
    # record references (REFERENCE fields)
    refs_update(rid, before, after, ctx)
    # events
    run_events(rid, before, after, action, ctx, input_doc)
    # live queries
    notify_lives(rid, before, after, action, ctx)
    return shape_output(output, before, after, rid, ctx)


def record_id_key(v, what="the Record ID"):
    """Validate+normalize a user-provided id value into a record key
    (reference: expr id coercion — '' / ranges are invalid)."""
    if isinstance(v, RecordId):
        if isinstance(v.id, Range):
            raise SdbError(
                f"Found {v.render()} for {what} but this is not a valid id"
            )
        v = v.id
    if isinstance(v, Range):
        raise SdbError(
            f"Found {render(v)} for {what} but this is not a valid id"
        )
    if isinstance(v, str):
        if v == "":
            raise SdbError(
                f"Found '' for {what} but this is not a valid id"
            )
        return v
    if isinstance(v, bool):
        raise SdbError(
            f"Found {render(v)} for {what} but this is not a valid id"
        )
    if isinstance(v, float):
        if v.is_integer():
            return int(v)
        raise SdbError(
            f"Found {render(v)} for {what} but this is not a valid id"
        )
    if isinstance(v, int):
        return v if -(1 << 63) <= v < (1 << 63) else str(v)
    if isinstance(v, (Uuid, list, dict)):
        return v
    raise SdbError(
        f"Found {render(v)} for {what} but this is not a valid id"
    )


def _id_matches(nid, rid: RecordId) -> bool:
    """Does a user-supplied id value match the target record? A bare key
    equal to the record's key also matches (reference doc/check.rs
    `r.key == v`)."""
    if isinstance(nid, RecordId):
        return nid.tb == rid.tb and value_eq(nid.id, rid.id)
    try:
        return value_eq(record_id_key(nid, "the `id` field"), rid.id)
    except SdbError:
        return False


def create_one(target, data, output, ctx: Ctx, upsert=False):
    """CREATE one target (table name / record id)."""
    explicit = None
    if isinstance(target, Table):
        tb = target.name
    elif isinstance(target, RecordId):
        if isinstance(target.id, Range):
            raise SdbError(
                f"Found {target.render()} for the Record ID but this is not a valid id"
            )
        tb = target.tb
        explicit = target
    elif isinstance(target, str):
        tb = target
    else:
        raise SdbError(f"Cannot CREATE {render(target)}")
    seed = {"id": explicit} if explicit is not None else {}
    doc = apply_data(seed, data, ctx, explicit, this_doc=NONE)
    nid = doc.get("id", NONE)
    if explicit is not None:
        if nid is not NONE and not _id_matches(nid, explicit):
            raise SdbError(
                f"Found {render(nid)} for the `id` field, but a specific record has been specified"
            )
        rid = explicit
    else:
        if nid is not NONE and nid is not None:
            rid = RecordId(tb, record_id_key(nid))
        else:
            rid = RecordId(tb, generate_record_key())
    doc["id"] = rid
    existing = fetch_record(ctx, rid)
    if existing is not NONE:
        raise SdbError(
            f"Database record `{rid.render()}` already exists"
        )
    return _store_record(rid, NONE, doc, ctx, "CREATE", output)


def _find_unique_conflict(tb, doc, rid, ctx):
    """Pre-check unique indexes for a conflicting record (INSERT IGNORE /
    ON DUPLICATE KEY UPDATE resolution)."""
    ns, db = ctx.need_ns_db()
    for idef in get_indexes(tb, ctx):
        if not idef.unique or idef.hnsw or idef.fulltext:
            continue
        rows = _index_rows(_index_values(idef, doc, ctx, rid), idef)
        for row in rows:
            if any(x is NONE or x is None for x in row):
                continue
            existing = ctx.txn.get_val(K.index_unique(ns, db, tb, idef.name, row))
            if existing is not None and not value_eq(existing, rid):
                return existing
    return None


def insert_one(into, doc, ignore, update, output, ctx: Ctx):
    rid = doc.get("id")
    if isinstance(rid, RecordId):
        if into and rid.tb != into:
            rid = RecordId(into, rid.id)
    elif rid is not None and rid is not NONE:
        if into is None:
            raise SdbError(
                "Cannot execute INSERT statement where property 'id' is: NONE"
            )
        rid = RecordId(into, record_id_key(rid, "the `id` field"))
    else:
        if into is None:
            raise SdbError(
                "Cannot execute INSERT statement where property 'id' is: NONE"
            )
        rid = RecordId(into, generate_record_key())
    doc = copy_value(doc)
    doc["id"] = rid
    existing = fetch_record(ctx, rid)
    dup_rid = rid if existing is not NONE else None
    if dup_rid is None and (ignore or update is not None):
        dup_rid = _find_unique_conflict(rid.tb, doc, rid, ctx)
        if dup_rid is not None:
            existing = fetch_record(ctx, dup_rid)
    if dup_rid is not None and existing is not NONE:
        if ignore:
            return SKIP  # IGNORE wins even when ON DUPLICATE KEY is present
        if update is not None:
            from surrealdb_tpu_torch.expr.ast import SetData

            c = ctx.with_doc(existing, dup_rid)
            c.vars["input"] = doc
            newdoc = apply_data(existing, SetData(update), c, dup_rid)
            return _store_record(
                dup_rid, existing, newdoc, ctx, "UPDATE", output
            )
        raise SdbError(f"Database record `{rid.render()}` already exists")
    return _store_record(rid, NONE, doc, ctx, "CREATE", output)


def relate_insert_one(into, doc, ignore, output, ctx: Ctx):
    rid = doc.get("id")
    if isinstance(rid, RecordId):
        pass
    elif rid is not None and rid is not NONE and into:
        rid = RecordId(into, record_id_key(rid, "the `id` field"))
    else:
        if into is None:
            raise SdbError(
                "Cannot execute INSERT statement where property 'id' is: NONE"
            )
        rid = RecordId(into, generate_record_key())
    l = doc.get("in", NONE)
    r = doc.get("out", NONE)
    if not isinstance(l, RecordId):
        raise SdbError(
            f"Cannot execute INSERT statement where property 'in' is: {render(l)}"
        )
    if not isinstance(r, RecordId):
        raise SdbError(
            f"Cannot execute INSERT statement where property 'out' is: {render(r)}"
        )
    doc = copy_value(doc)
    doc["id"] = rid
    existing = fetch_record(ctx, rid)
    if existing is not NONE:
        if ignore:
            return SKIP
        raise SdbError(f"Database record `{rid.render()}` already exists")
    return _store_record(rid, NONE, doc, ctx, "CREATE", output, edge=(l, r))


def reduce_fields(tb, doc, ctx, action="select"):
    """Permission-reduced view of a document for non-owner sessions
    (reference Document::current_reduced): fields whose permission for
    `action` denies the session disappear from the view."""
    if not isinstance(doc, dict):
        return doc
    if ctx.session.is_owner or ctx.session.auth_level == "editor":
        return doc
    out = None
    for fd in get_fields(tb, ctx):
        perms = getattr(fd, "permissions", None)
        if not perms:
            continue
        p = perms.get(action, True)
        if p is True:
            continue
        allowed = False
        if p not in (False, None):
            c = ctx.with_doc(doc, None)
            try:
                allowed = is_truthy(evaluate(p, c))
            except SdbError:
                allowed = False
        if not allowed:
            name = fd.name_str.split(".")[0].split("[")[0]
            if out is None:
                out = copy_value(doc)
            out.pop(name, None)
    return out if out is not None else doc


def update_one(rid: RecordId, before: dict, data, output, ctx: Ctx):
    # REPLACE is strict about readonly fields: dropping one errors, while
    # CONTENT/MERGE silently preserve them (upsert readonly tests)
    if isinstance(data, ReplaceData):
        ctx = ctx.child()
        ctx._strict_readonly = True
    perms = not ctx.session.is_owner and ctx.session.auth_level != "editor"
    visible = reduce_fields(rid.tb, before, ctx) if perms else before
    c = ctx.with_doc(visible, rid)
    after = apply_data(visible, data, c, rid, this_doc=visible)
    if perms and isinstance(before, dict) and isinstance(after, dict):
        # fields hidden from this session persist untouched unless the
        # data clause explicitly wrote them
        for k, v in before.items():
            if k not in visible and k not in after:
                after[k] = copy_value(v)
    nid = after.get("id", NONE)
    if nid is not NONE and not _id_matches(nid, rid):
        raise SdbError(
            f"Found {render(nid)} for the `id` field, but a specific record has been specified"
        )
    after["id"] = rid
    # edges keep their endpoints: in/out are immutable through data clauses
    if isinstance(before, dict) and isinstance(before.get("in"), RecordId) \
            and isinstance(before.get("out"), RecordId):
        after["in"] = before["in"]
        after["out"] = before["out"]
    return _store_record(rid, before, after, ctx, "UPDATE", output)


def delete_one(rid: RecordId, before, output, ctx: Ctx):
    ns, db = ctx.need_ns_db()
    if ctx.session.auth_level in ("none", "viewer"):
        raise SdbError(
            "IAM error: Not enough permissions to perform this action"
        )
    if not ctx.session.is_owner and ctx.session.auth_level not in ("editor",):
        from surrealdb_tpu_torch.exec.statements import check_table_permission

        if not check_table_permission(rid.tb, "delete", ctx, before, rid):
            # a row whose WHERE-perm doesn't match silently drops out of
            # the statement (reference doc/allow.rs: Ignore, not Error)
            return SKIP
    # referenced-record ON DELETE actions run before the record vanishes
    apply_ref_on_delete(rid, ctx)
    ctx.txn.delete(K.record(ns, db, rid.tb, rid.id))
    import time as _time

    # history tombstone: empty payload marks deletion-at-ts
    ctx.txn.set(K.hist(ns, db, rid.tb, rid.id, _time.time_ns()), b"")
    ctx.record_cache.pop((rid.tb, K.enc_value(rid.id)), None)
    gk = (ns, db, rid.tb)
    _bump_graph_version(ctx, gk)
    # purge graph edges; cascade delete edge records hanging off this node
    from surrealdb_tpu_torch.graph import purge_edges

    edges = purge_edges(rid, ctx)
    is_edge = isinstance(before, dict) and isinstance(
        before.get("in"), RecordId
    ) and isinstance(before.get("out"), RecordId)
    if is_edge:
        _log_edge_op(ctx, (ns, db, rid.tb), _EDGE_POISON)
    if not is_edge:
        for erid in edges:
            edoc = fetch_record(ctx, erid)
            if isinstance(edoc, dict) and isinstance(edoc.get("in"), RecordId):
                delete_one(erid, edoc, OutputClause("none"), ctx)
    index_update(rid, before, NONE, ctx)
    refs_update(rid, before, NONE, ctx)
    run_events(rid, before, NONE, "DELETE", ctx)
    notify_lives(rid, before, NONE, "DELETE", ctx)
    if output is None:
        return NONE
    return shape_output(output, before, NONE, rid, ctx)


def relate_one(kind, fr: RecordId, to: RecordId, data, output, ctx: Ctx, uniq=False):
    if isinstance(kind, Table):
        tb = kind.name
        rid = RecordId(tb, generate_record_key())
    elif isinstance(kind, RecordId):
        rid = kind
        tb = kind.tb
    elif isinstance(kind, str):
        tb = kind
        rid = RecordId(tb, generate_record_key())
    else:
        raise SdbError(
            f"Cannot execute RELATE statement where property 'id' "
            f"is: {render(kind)}"
        )
    doc = apply_data({"id": rid}, data, ctx, rid, this_doc=NONE)
    nid = doc.get("id")
    if isinstance(nid, RecordId) and (nid.tb != rid.tb or not value_eq(nid.id, rid.id)):
        rid = nid
    elif nid is not None and nid is not NONE and not isinstance(nid, RecordId) \
            and not value_eq(nid, rid.id):
        # CONTENT { id: "foo" } keys the edge within its table (knows:foo)
        rid = RecordId(tb, nid)
    doc["id"] = rid
    existing = fetch_record(ctx, rid)
    before = existing if existing is not NONE else NONE
    return _store_record(
        rid, before, doc, ctx, "CREATE" if before is NONE else "UPDATE",
        output, edge=(fr, to)
    )
