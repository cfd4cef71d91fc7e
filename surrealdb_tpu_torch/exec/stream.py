"""Streaming batched operator engine (execution engine A).

Reference: core/src/exec/mod.rs:1-35 — push-based batched operator DAG
(`ValueBatch` streams, no recursive compute()) with per-operator metrics
(core/src/exec/metrics.rs:50-60) surfaced through EXPLAIN ANALYZE.

Design notes (host engine):
- Operators are generator pipelines over row batches (`list[Source]`,
  BATCH_SIZE rows). SurrealQL rows are ragged/heterogeneous, so batches
  stay row-major; rectangular NUMERIC columns (vector fields) are
  extracted per batch and evaluated vectorized — one numpy/device call
  per batch instead of one `evaluate()` per row. That columnar fast path
  is where the batched engine beats the row-at-a-time legacy executor
  (the reference gets the same effect from its columnar ValueBatch).
- Every operator owns an OpMetrics (rows/batches/elapsed-ns). Metrics
  are recorded only when enabled (EXPLAIN ANALYZE) — zero overhead on
  the normal path, like the reference's `monitor_stream`.
- Statements outside the supported shape fall back to the legacy
  recursive executor (`plan_or_compute.rs:69` legacy_compute analog) —
  the reference ships exactly this dual-engine split.
"""

from __future__ import annotations

import heapq
import time

import numpy as np

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, Table, is_truthy

BATCH_SIZE = cnf.OPERATOR_BUFFER_SIZE

_UNSUPPORTED = object()


class OpMetrics:
    __slots__ = ("rows", "batches", "ns", "enabled", "vrows", "frows")

    def __init__(self):
        self.rows = 0
        self.batches = 0
        self.ns = 0
        self.enabled = False
        # columnar accounting: rows served by the vectorized kernels vs
        # rows that took the scalar-fallback path (EXPLAIN ANALYZE shows
        # both so a fallback regression is visible per operator)
        self.vrows = 0
        self.frows = 0


def _fmt_elapsed(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.2f}s"
    if ns >= 1_000_000:
        return f"{ns / 1e6:.2f}ms"
    if ns >= 1_000:
        return f"{ns / 1e3:.2f}µs"
    return f"{ns}ns"


class Operator:
    """Base operator: `execute(ctx)` yields row batches; `lines()` yields
    (depth, label, metrics) rows for EXPLAIN ANALYZE rendering."""

    label = "Op [ctx: Db]"

    def __init__(self, *children):
        self.children = list(children)
        self.metrics = OpMetrics()

    def enable_metrics(self):
        self.metrics.enabled = True
        for c in self.children:
            c.enable_metrics()

    def execute(self, ctx):
        gen = self._execute(ctx)
        if not self.metrics.enabled:
            return gen
        m = self.metrics

        def monitored():
            while True:
                t0 = time.perf_counter_ns()
                try:
                    b = next(gen)
                except StopIteration:
                    m.ns += time.perf_counter_ns() - t0
                    return
                m.ns += time.perf_counter_ns() - t0
                m.rows += len(b)
                m.batches += 1
                yield b

        return monitored()

    def _execute(self, ctx):  # pragma: no cover — abstract
        raise NotImplementedError

    def lines(self, depth=0):
        out = [(depth, self.label, self.metrics)]
        for c in self.children:
            out.extend(c.lines(depth + 1))
        return out


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------


# NOTE: the old `_vector_pred` numeric-AND-tree compiler grew into the
# general columnar expression compiler in exec/vops.py (comparison /
# boolean / arithmetic / IN over classified typed columns with per-row
# exotic fallback); TableScanOp routes every predicate through it.


class TableScanOp(Operator):
    """Batched table scan with the predicate inlined (single-target scans
    absorb the WHERE — reference operators/scan/table.rs) and optional
    limit/offset pushdown. Emits post-filter rows."""

    def __init__(self, tb: str, cond, pushed_limit, pushed_offset,
                 direction: str, label: str, cols=None):
        super().__init__()
        self.tb = tb
        self.cond = cond
        self.pushed_limit = pushed_limit
        self.pushed_offset = pushed_offset
        self.direction = direction
        self.label = label
        self.cols = cols  # ColumnCache for vectorized predicates (later)

    def _execute(self, ctx):
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch.exec.eval import (
            apply_computed_fields, computed_fields_of, evaluate,
        )
        from surrealdb_tpu_torch.kvs.api import deserialize
        from surrealdb_tpu_torch.val import RecordId

        ns, db = ctx.need_ns_db()
        if ctx.txn.get(K.tb_def(ns, db, self.tb)) is None:
            raise SdbError(f"The table '{self.tb}' does not exist")
        has_computed = bool(computed_fields_of(self.tb, ctx))
        pre = K.record_prefix(ns, db, self.tb)
        beg, end = K.prefix_range(pre)
        plen = len(pre)
        reverse = self.direction == "Backward"
        skip = self.pushed_offset or 0
        remaining = self.pushed_limit
        from surrealdb_tpu_torch.exec.statements import Source

        vec = None
        if self.cond is not None and not has_computed:
            from surrealdb_tpu_torch.exec import vops

            vec = vops.compile_predicate(self.cond, ctx)

        def row_pass(src):
            cc = ctx.with_doc(src.doc, src.rid)
            return is_truthy(evaluate(self.cond, cc))

        if vec is not None:
            # columnar filter: evaluate whole pending batches through
            # the vops kernels; rows the kernels classify exotic fall
            # back row-wise (bit-identical values, identical errors)
            from surrealdb_tpu_torch.exec.batch import BatchCols, _count

            pend: list = []
            batch = []

            def flush():
                nonlocal pend, skip, remaining, batch
                mask, fb = vec.masks(BatchCols(pend), ctx)
                nfb = int(fb.sum())
                m = self.metrics
                m.vrows += len(pend) - nfb
                m.frows += nfb
                _count(ctx.ds, "batches_vectorized")
                _count(ctx.ds, "rows_vectorized", len(pend) - nfb)
                if nfb:
                    _count(ctx.ds, "rows_fallback", nfb)
                passing = [
                    s_ for s_, ok, f in zip(pend, mask, fb)
                    if (row_pass(s_) if f else ok)
                ]
                pend = []
                for src in passing:
                    if skip > 0:
                        skip -= 1
                        continue
                    batch.append(src)
                    if remaining is not None:
                        remaining -= 1
                        if remaining <= 0:
                            return True
                return False

            done = False
            for k, raw in ctx.txn.scan(beg, end, reverse=reverse):
                ctx.check_deadline()
                # the scan prefix pins (ns, db, tb): only the id decodes
                idv, _pos = K.dec_value(k, plen)
                doc = deserialize(raw)
                pend.append(Source(rid=RecordId(self.tb, idv), doc=doc))
                if len(pend) >= BATCH_SIZE:
                    done = flush()
                    if batch:
                        yield batch
                        batch = []
                    if done:
                        break
            if pend and not done:
                flush()
            if batch:
                yield batch
            return

        batch = []
        for k, raw in ctx.txn.scan(beg, end, reverse=reverse):
            ctx.check_deadline()
            idv, _pos = K.dec_value(k, plen)
            rid = RecordId(self.tb, idv)
            doc = deserialize(raw)
            if has_computed:
                doc = apply_computed_fields(self.tb, doc, rid, ctx)
            src = Source(rid=rid, doc=doc)
            if self.cond is not None:
                cc = ctx.with_doc(doc, rid)
                if not is_truthy(evaluate(self.cond, cc)):
                    continue
            if skip > 0:
                skip -= 1
                continue
            batch.append(src)
            if remaining is not None:
                remaining -= 1
                if remaining <= 0:
                    break
            if len(batch) >= BATCH_SIZE:
                yield batch
                batch = []
        if batch:
            yield batch


# ---------------------------------------------------------------------------
# sort / limit
# ---------------------------------------------------------------------------


def _order_key_fn(order, ctx, aliases, cols):
    """Row→sort-key function with EXACT legacy semantics (reuses the
    comparator machinery from exec/statements._apply_order_sources)."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.statements import _OrderKey, _resolve_alias

    resolved = []
    for e, d, c, num in order:
        r = _resolve_alias(e, aliases)
        # aliases re-compute their projection (traversal allowed); raw
        # idioms sort value-only without record-link fetches
        resolved.append((r, d, c, num, r is not e))

    def key(src):
        doc = src.doc if src.rid is not None else src.value
        cc = ctx.with_doc(doc, src.rid)
        cc.knn = ctx.knn
        keys = []
        for e, d, collate, numeric, was_alias in resolved:
            v = cols.get_row(e, src)
            if v is _COL_MISS:
                cc._no_link_fetch = not was_alias
                try:
                    v = evaluate(e, cc)
                finally:
                    cc._no_link_fetch = False
            keys.append((v, d, collate, numeric))
        return _OrderKey(keys)

    return key


def _lexsort_try(rows, order, aliases, ctx, keep=None):
    """Colstore-backed sort for the streaming operators: clean scalar
    key columns go through one np.lexsort (exec/vops.py) instead of
    the row-at-a-time key extractor; None → the exact scalar sort
    (exotic rows, uncompilable keys, COLLATE/NUMERIC, tiny inputs)."""
    from surrealdb_tpu_torch.exec.statements import _resolve_alias
    from surrealdb_tpu_torch.exec.vops import lexsort_sources

    items = [
        (_resolve_alias(e, aliases), d, c, num)
        for e, d, c, num in order
    ]
    return lexsort_sources(rows, items, ctx, keep=keep)


class SortOp(Operator):
    """Pipeline-breaking full sort (SortByKey)."""

    def __init__(self, child, order, aliases, cols, label):
        super().__init__(child)
        self.order = order
        self.aliases = aliases
        self.cols = cols
        self.label = label

    def _execute(self, ctx):
        rows = []
        for b in self.children[0].execute(ctx):
            self.cols.prime(b, ctx)
            rows.extend(b)
        fast = _lexsort_try(rows, self.order, self.aliases, ctx)
        if fast is not None:
            rows = fast
        else:
            rows.sort(
                key=_order_key_fn(self.order, ctx, self.aliases,
                                  self.cols)
            )
        for s in range(0, len(rows), BATCH_SIZE):
            yield rows[s:s + BATCH_SIZE]


class VecTopKScanOp(Operator):
    """Columnar brute-force vector top-k: ORDER BY a recognized vector
    expression with LIMIT over a full table scan rides the persistent
    column store (col.py + the native C++ extraction kernel) — score the
    whole table in one numpy call, then materialize ONLY the winning
    rows. The winners' projected scores recompute per-row in f64 from
    the fetched documents, so output values are bit-identical to the
    row-at-a-time engine; only the ranking runs on the f32 column.
    Reference role: exec/operators/knn_topk.rs (KnnTopK scan operator)."""

    def __init__(self, tb, spec, keep, skip, desc, label):
        super().__init__()
        self.tb = tb
        self.spec = spec  # (kind, parts, qvec, expr)
        self.keep = keep
        self.skip = skip
        self.desc = desc
        self.label = label

    def _execute(self, ctx):
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch.col import get_vector_column
        from surrealdb_tpu_torch.exec.eval import fetch_record
        from surrealdb_tpu_torch.exec.statements import Source
        from surrealdb_tpu_torch.val import RecordId

        ns, db = ctx.need_ns_db()
        if ctx.txn.get(K.tb_def(ns, db, self.tb)) is None:
            raise SdbError(f"The table '{self.tb}' does not exist")
        kind, parts, qv, _expr = self.spec
        col = get_vector_column(ctx, self.tb, parts[0], qv.shape[0])
        if col is None or col.bad_ids:
            # dirty overlay or non-conforming rows: the planner guards
            # against engaging here, but races resolve to the safe path
            raise _FallbackToLegacy()
        m = col.mat
        qf = qv.astype(np.float32)
        if kind == "cos_sim":
            dots = m @ qf
            denom = col.norms() * np.linalg.norm(qf)
            with np.errstate(divide="ignore", invalid="ignore"):
                scores = dots / denom
        elif kind == "eucl":
            scores = np.linalg.norm(m - qf[None, :], axis=1)
        elif kind == "manh":
            scores = np.abs(m - qf[None, :]).sum(axis=1)
        else:  # dot
            scores = m @ qf
        n_rows = scores.shape[0]
        k = min(self.keep, n_rows)
        key = -scores if self.desc else scores
        if k < n_rows:
            part = np.argpartition(key, k - 1)[:k]
            order = part[np.argsort(key[part], kind="stable")]
        else:
            order = np.argsort(key, kind="stable")
        order = order[self.skip:]
        batch = []
        for i in order:
            ctx.check_deadline()
            rid = RecordId(self.tb, col.ids[int(i)])
            doc = fetch_record(ctx, rid)
            if doc is NONE:
                continue
            batch.append(Source(rid=rid, doc=doc))
            if len(batch) >= BATCH_SIZE:
                yield batch
                batch = []
        if batch:
            yield batch


class _FallbackToLegacy(Exception):
    """Raised mid-plan when a columnar fast path can't serve the txn."""


class SortTopKOp(Operator):
    """Order + limit as a bounded top-k (SortTopKByKey + Limit): keeps
    limit+offset rows via a heap instead of sorting the whole input —
    the reference's sort/topk.rs pipeline-breaking aggregate."""

    def __init__(self, child, order, aliases, cols, keep: int, skip: int,
                 label: str, limit_label: str):
        super().__init__(child)
        self.order = order
        self.aliases = aliases
        self.cols = cols
        self.keep = keep
        self.skip = skip
        self.label = label
        self.limit_label = limit_label
        self.limit_metrics = OpMetrics()

    def enable_metrics(self):
        super().enable_metrics()
        self.limit_metrics.enabled = True

    def _execute(self, ctx):
        rows = []
        for b in self.children[0].execute(ctx):
            self.cols.prime(b, ctx)
            rows.extend(b)
        top = _lexsort_try(rows, self.order, self.aliases, ctx,
                           keep=self.keep)
        if top is None:
            key = _order_key_fn(self.order, ctx, self.aliases,
                                self.cols)
            top = heapq.nsmallest(self.keep, rows, key=key)
        out = top[self.skip:]
        # the Limit node above the top-k drops the offset rows
        self.limit_metrics.rows += len(out)
        self.limit_metrics.batches += 1
        for s in range(0, len(out), BATCH_SIZE):
            yield out[s:s + BATCH_SIZE]

    def lines(self, depth=0):
        out = [
            (depth, self.limit_label, self.limit_metrics),
            (depth, self.label, self.metrics),
        ]
        for c in self.children:
            out.extend(c.lines(depth + 1))
        return out


class LimitOp(Operator):
    """START/LIMIT slicing when a sort sits below (not pushed into scan)."""

    def __init__(self, child, skip: int, limit, label):
        super().__init__(child)
        self.skip = skip
        self.limit = limit
        self.label = label

    def _execute(self, ctx):
        skip = self.skip
        remaining = self.limit
        for b in self.children[0].execute(ctx):
            if skip > 0:
                if skip >= len(b):
                    skip -= len(b)
                    continue
                b = b[skip:]
                skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                b = b[:remaining]
                remaining -= len(b)
            if b:
                yield b


# ---------------------------------------------------------------------------
# vectorized column cache
# ---------------------------------------------------------------------------

_COL_MISS = object()

# vector functions with a (field, query-constant) shape that vectorize to
# one numpy call per batch; math mirrors fnc/vector_fns.py (f64)
_VEC_FNS = {
    "vector::similarity::cosine": "cos_sim",
    "vector::distance::euclidean": "eucl",
    "vector::distance::manhattan": "manh",
    "vector::dot": "dot",
}


class ColumnCache:
    """Per-query cache of vectorized expression columns.

    For recognized exprs (vector fn over a plain field + query-constant
    vector), `prime(batch)` computes the whole batch in ONE numpy call;
    `get_row` serves individual rows (sort keys, projection) from the
    cached column. Rows whose field is missing/ragged fall back to the
    row-at-a-time evaluator — semantics are identical, only the schedule
    changes (SURVEY.md §7: batched operator DAG from day one)."""

    MISS = _COL_MISS

    def __init__(self):
        self.specs = {}  # id(expr) -> (kind, field_parts, qvec, expr)
        self.vspecs = {}  # id(expr) -> (vops node, expr) scalar kernels
        # computed values live ON each Source (src._cols[id(expr)]): their
        # lifetime is the row's lifetime — a persistent {id(src): value}
        # map would serve stale values when CPython recycles a freed
        # Source's address for a later batch's row

    def register(self, expr, ctx):
        from surrealdb_tpu_torch.expr.ast import Binary, FunctionCall, Idiom, \
            Param, PField
        from surrealdb_tpu_torch.exec.eval import evaluate

        if id(expr) in self.specs or id(expr) in self.vspecs:
            return True
        if not isinstance(expr, FunctionCall):
            # scalar projection kernels: arithmetic / comparison / IN
            # trees whose VALUE (not just truthiness) is exact — one
            # vops call per batch serves projections and sort keys
            # (logic ops return operand values, so roots stay scalar)
            from surrealdb_tpu_torch.exec import vops

            if isinstance(expr, Binary) and (
                expr.op in vops._CMP_OPS or expr.op in vops._ARITH_OPS
                or expr.op in ("∈", "∉")
            ):
                node = vops.compile_expr(expr, ctx)
                if node is not None and not isinstance(node, vops._Field):
                    self.vspecs[id(expr)] = (node, expr)
                    return True
            return False
        kind = _VEC_FNS.get(expr.name.lower())
        if kind is None or len(expr.args) != 2:
            return False
        fe, qe = expr.args
        if not (isinstance(fe, Idiom)
                and all(isinstance(p, PField) for p in fe.parts)):
            return False
        # the second arg must be query-constant (param / literal): evaluate
        # once up front
        if not isinstance(qe, (Param, list)):
            from surrealdb_tpu_torch.expr.ast import Literal
            if not isinstance(qe, Literal):
                return False
        try:
            qv = evaluate(qe, ctx)
        except SdbError:
            return False
        if not (isinstance(qv, list) and qv
                and all(isinstance(x, (int, float)) for x in qv)):
            return False
        self.specs[id(expr)] = (
            kind, [p.name for p in fe.parts], np.asarray(qv, np.float64),
            expr,
        )
        return True

    def prime(self, batch, ctx):
        if self.vspecs:
            from surrealdb_tpu_torch.exec import vops
            from surrealdb_tpu_torch.exec.batch import RANK_EXOTIC, BatchCols

            for sid, (node, _expr) in self.vspecs.items():
                todo = [
                    src for src in batch
                    if getattr(src, "_cols", None) is None
                    or sid not in src._cols
                ]
                if not todo:
                    continue
                col = node.eval(BatchCols(todo), ctx)
                if col is None:
                    continue  # runtime bail: rows evaluate row-wise
                for i, src in enumerate(todo):
                    if col.rank[i] == RANK_EXOTIC:
                        continue  # scalar fallback (exact error/value)
                    cols = getattr(src, "_cols", None)
                    if cols is None:
                        cols = src._cols = {}
                    cols[sid] = vops.col_value_at(col, i)
        if not self.specs:
            return
        for sid, (kind, parts, qv, expr) in self.specs.items():
            idxs = []
            mats = []
            dim = qv.shape[0]
            for src in batch:
                cols = getattr(src, "_cols", None)
                if cols is not None and sid in cols:
                    continue
                doc = src.doc if src.rid is not None else src.value
                v = doc
                for p in parts:
                    v = v.get(p) if isinstance(v, dict) else None
                if isinstance(v, list) and len(v) == dim:
                    # numeric-dtype check via numpy (int/float kinds only;
                    # bools/objects reject) — far cheaper than a
                    # per-element isinstance loop
                    try:
                        arr = np.asarray(v)
                    except (TypeError, ValueError):
                        continue
                    if arr.dtype.kind in ("i", "f"):
                        idxs.append(src)
                        mats.append(arr.astype(np.float64, copy=False))
                # else: row falls back to evaluate() (exact same errors)
            if not mats:
                continue
            m = np.asarray(mats, np.float64)
            if kind == "cos_sim":
                dots = m @ qv
                denom = np.linalg.norm(m, axis=1) * np.linalg.norm(qv)
                with np.errstate(divide="ignore", invalid="ignore"):
                    vals = dots / denom
            elif kind == "eucl":
                vals = np.linalg.norm(m - qv[None, :], axis=1)
            elif kind == "manh":
                vals = np.abs(m - qv[None, :]).sum(axis=1)
            else:  # dot
                vals = m @ qv
            for src, val in zip(idxs, vals):
                cols = getattr(src, "_cols", None)
                if cols is None:
                    cols = src._cols = {}
                cols[sid] = float(val)

    def get_row(self, expr, src):
        cols = getattr(src, "_cols", None)
        if cols is None:
            return _COL_MISS
        return cols.get(id(expr), _COL_MISS)


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------


class ProjectOp(Operator):
    """SelectProject / ProjectValue — row projection with the vectorized
    column cache consulted for recognized exprs."""

    def __init__(self, child, stmt, cols, label, compute_label=None):
        super().__init__(child)
        self.stmt = stmt
        self.cols = cols
        self.label = label
        self.compute_label = compute_label
        self.compute_metrics = OpMetrics()

    def enable_metrics(self):
        super().enable_metrics()
        self.compute_metrics.enabled = True

    def _execute(self, ctx):
        from surrealdb_tpu_torch.exec.statements import _project

        n = self.stmt
        for b in self.children[0].execute(ctx):
            self.cols.prime(b, ctx)
            out = []
            for src in b:
                ctx._stream_cols = (self.cols, src)
                try:
                    out.append(_project(src, n, ctx))
                finally:
                    ctx._stream_cols = None
            if self.compute_label is not None:
                self.compute_metrics.rows += len(out)
                self.compute_metrics.batches += 1
            yield out

    def lines(self, depth=0):
        out = [(depth, self.label, self.metrics)]
        d = depth + 1
        if self.compute_label is not None:
            out.append((d, self.compute_label, self.compute_metrics))
            d += 1
        # children render under the deepest mid line (the plan tree is a
        # straight spine of root + mid lines)
        for c in self.children:
            out.extend(c.lines(d))
        return out


class AggregateOp(Operator):
    """GROUP BY / GROUP ALL over the scanned rows (reference
    exec/operators/aggregate.rs). A barrier by nature: drains the child,
    groups via the shared grouping engine, then emits the final grouped
    rows (ORDER/START/LIMIT apply to the grouped output)."""

    def __init__(self, child, stmt, aliases, label):
        super().__init__(child)
        self.stmt = stmt
        self.aliases = aliases
        self.label = label

    def _execute(self, ctx):
        from surrealdb_tpu_torch.exec import vops
        from surrealdb_tpu_torch.exec.eval import evaluate
        from surrealdb_tpu_torch.exec.statements import (
            _apply_group, _apply_order, _stmt_rng,
        )

        n = self.stmt
        out = None
        scan = self.children[0]
        if (
            not self.metrics.enabled
            and isinstance(scan, TableScanOp)
            and scan.pushed_limit is None
            and not scan.pushed_offset
            and scan.direction == "Forward"
        ):
            # whole-table tier: filter + group + aggregate straight off
            # the version-keyed column store — no Source rows at all.
            # (EXPLAIN ANALYZE keeps the streaming tier so per-operator
            # row counts stay real.)
            out = vops.columnar_group_select(n, scan.tb, ctx,
                                             self.aliases)
        if out is None:
            rows = []
            for b in scan.execute(ctx):
                ctx.check_deadline()
                rows.extend(b)
            self.metrics.vrows += len(rows)
            out = vops.group_sources(rows, n, ctx, self.aliases)
            if out is None:
                self.metrics.vrows = 0
                self.metrics.frows += len(rows)
                empty_row = n.cond is None or (
                    getattr(ctx.session, "planner_strategy", None)
                    == "all-ro"
                )
                out = _apply_group(rows, n, ctx, self.aliases, empty_row)
        from surrealdb_tpu_torch.exec.statements import _eval_limits

        # LIMIT/START evaluate ONCE: the heap bound and the slice must
        # see the same ints (volatile LIMIT expressions)
        lok, keep, lim, off = _eval_limits(n, ctx)
        if n.order == "rand":
            _stmt_rng(ctx).shuffle(out)
        elif n.order:
            out = _apply_order(out, n.order, ctx, keep=keep)
        if n.start is not None:
            out = out[off if lok else int(evaluate(n.start, ctx)):]
        if n.limit is not None:
            out = out[:lim if lok else int(evaluate(n.limit, ctx))]
        for i in range(0, len(out), BATCH_SIZE):
            yield out[i:i + BATCH_SIZE]
        if not out:
            yield []


# ---------------------------------------------------------------------------
# plan building / routing
# ---------------------------------------------------------------------------


def _inline_params(e, ctx):
    """Deep-copy an expression with $params replaced by their bound values
    — the reference's streaming explain renders physical exprs, which hold
    the evaluated constants, not the param names."""
    import dataclasses

    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.expr.ast import Literal, Param

    if isinstance(e, Param):
        try:
            return Literal(evaluate(e, ctx))
        except SdbError:
            return e
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            nv = _inline_params(v, ctx)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e
    if isinstance(e, list):
        out = [_inline_params(x, ctx) for x in e]
        return out if any(a is not b for a, b in zip(out, e)) else e
    if isinstance(e, tuple):
        out = tuple(_inline_params(x, ctx) for x in e)
        return out if any(a is not b for a, b in zip(out, e)) else e
    return e


def build_select_plan(n, ctx):
    """Build the streaming operator tree for an eligible SELECT; returns
    None when the statement needs the legacy engine (index access paths,
    grouping, permissions, multi-source, graph/recursion projections —
    the reference's PlannerUnsupported fallback, exec/planner.rs:309)."""
    from surrealdb_tpu_torch.exec.statements import (
        _expand_field_projections, _target_value, expr_name,
    )
    from surrealdb_tpu_torch.exec.render_def import _expr_sql
    from surrealdb_tpu_torch.expr.ast import FunctionCall, Idiom, PRecurse
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.idx.planner import _find_knn, _find_matches, plan_scan

    if getattr(ctx.session, "planner_strategy", None) == "compute-only":
        return None
    if (
        n.version is not None or ctx.version is not None
        or n.split or n.fetch or n.omit or n.only
        or n.order == "rand" or len(n.what) != 1
        or not ctx.session.is_owner or ctx.perms_enabled
    ):
        return None
    if n.group is not None and any(e == "*" for e, _a in n.exprs):
        return None  # `*` in a grouped selection errors on the legacy path
    try:
        v = _target_value(n.what[0], ctx)
    except SdbError:
        return None
    if not isinstance(v, Table):
        return None
    tb = v.name
    if n.cond is not None:
        if _find_knn(n.cond) is not None or _find_matches(n.cond):
            return None
        if plan_scan(tb, n.cond, ctx, n) is not None:
            return None  # an index access path applies — legacy engine
    n = _expand_field_projections(n, ctx)
    # recursion idioms need the legacy Recurse machinery's explain shape;
    # execution-wise evaluate() handles them, so only exclude from plans
    # when they appear (keeps analyze labels honest)
    for e, _a in n.exprs:
        if isinstance(e, Idiom) and any(
            isinstance(p, PRecurse) for p in e.parts
        ):
            return None
    if isinstance(n.value, Idiom) and any(
        isinstance(p, PRecurse) for p in n.value.parts
    ):
        return None

    cols = ColumnCache()
    for e, _a in n.exprs:
        if e != "*":
            cols.register(e, ctx)
    if n.value is not None:
        cols.register(n.value, ctx)

    aliases = {}
    for expr, alias in n.exprs:
        if expr != "*":
            aliases[alias or expr_name(expr)] = expr
    if n.value is not None and getattr(n, "value_alias", None):
        aliases[n.value_alias] = n.value

    if n.group is not None:
        if not n.group:
            # GROUP ALL rides the legacy count/aggregate fast paths
            # (key-only count scans beat draining every row here)
            return None
        extra = ""
        if n.cond is not None:
            from surrealdb_tpu_torch.exec.statements import _elide_count_args

            extra += (
                ", predicate: "
                + _expr_sql(_elide_count_args(_inline_params(n.cond, ctx)))
            )
        scan = TableScanOp(
            tb, n.cond, None, None, "Forward",
            f"TableScan [ctx: Db] [table: {tb}, direction: Forward{extra}]",
            cols,
        )
        by = ", ".join(expr_name(g) for g in n.group) or ", ".join(
            (a or expr_name(e)) for e, a in n.exprs if e != "*"
        )
        return AggregateOp(
            scan, n, aliases, f"Aggregate [ctx: Db] [by: {by}]"
        )

    order = list(n.order) if n.order and n.order != "rand" else []
    # ORDER BY id over a plain scan streams in key order already (the
    # order-preserving key codec IS id order): elide the sort — Backward
    # scan for DESC. COLLATE/NUMERIC id sorts — and projections that
    # alias some other expression AS id — keep the real sort.
    scan_dir = "Forward"
    if (
        order
        and len(order) == 1
        and expr_name(order[0][0]) == "id"
        and "id" not in aliases
        and order[0][2] is None
        and not order[0][3]
    ):
        if order[0][1] != "desc":
            order = []
        elif n.cond is None:
            scan_dir = "Backward"
            order = []

    lim = int(evaluate(n.limit, ctx)) if n.limit is not None else None
    off = int(evaluate(n.start, ctx)) if n.start is not None else 0
    if (lim is not None and lim < 0) or off < 0:
        # Legacy applies Python slice semantics to negative START/LIMIT;
        # keep one behavior by routing those (rare) shapes to legacy.
        return None

    pushed_limit = pushed_offset = None
    extra = ""
    if n.cond is not None:
        from surrealdb_tpu_torch.exec.statements import _elide_count_args

        extra += f", predicate: {_expr_sql(_elide_count_args(_inline_params(n.cond, ctx)))}"
    if not order and (lim is not None or off):
        pushed_limit = lim
        if lim is not None:
            extra += f", limit: {lim}"
        if off:
            pushed_offset = off
            extra += f", offset: {off}"
    # columnar vector top-k: ORDER BY <vec-fn alias> LIMIT k over a bare
    # scan scores the whole table from the column store in one shot
    node = None
    if (
        n.cond is None
        and lim is not None
        and len(order) == 1
        and not order[0][2]  # no COLLATE
        and not order[0][3]  # no NUMERIC
    ):
        from surrealdb_tpu_torch.exec.statements import _resolve_alias

        oexpr = _resolve_alias(order[0][0], aliases)
        spec = cols.specs.get(id(oexpr))
        if spec is not None and len(spec[1]) == 1:
            from surrealdb_tpu_torch.col import get_vector_column

            col = get_vector_column(ctx, tb, spec[1][0], spec[2].shape[0])
            if col is not None and not col.bad_ids:
                desc = order[0][1] == "desc"
                node = VecTopKScanOp(
                    tb, spec, lim + off, off, desc,
                    f"VecTopKScan [ctx: Db] [table: {tb}, "
                    f"expr: {spec[0]}, limit: {lim + off}]",
                )
                order = []

    if node is None:
        scan_label = (
            f"TableScan [ctx: Db] [table: {tb}, direction: "
            f"{scan_dir}{extra}]"
        )
        node = TableScanOp(tb, n.cond, pushed_limit, pushed_offset,
                           scan_dir, scan_label, cols)

    if order:
        keys = ", ".join(
            f"{expr_name(e)} {'DESC' if d == 'desc' else 'ASC'}"
            for e, d, _c, _n2 in order
        )
        if lim is not None:
            limattr = (
                f"limit: {lim}, offset: {off}" if off else f"limit: {lim}"
            )
            node = SortTopKOp(
                node, order, aliases, cols, lim + off, off,
                f"SortTopKByKey [ctx: Db] [sort_keys: {keys}, "
                f"limit: {lim + off}]",
                f"Limit [ctx: Db] [{limattr}]",
            )
        else:
            node = SortOp(
                node, order, aliases, cols,
                f"SortByKey [ctx: Db] [sort_keys: {keys}]",
            )
            if off:
                node = LimitOp(
                    node, off, None, f"Start [ctx: Db] [offset: {off}]"
                )
    if n.value is not None:
        label = f"ProjectValue [ctx: Db] [expr: {_expr_sql(n.value)}]"
        compute_label = None
    else:
        projs = ", ".join(
            "*" if e == "*" else (a or expr_name(e)) for e, a in n.exprs
        )
        label = f"SelectProject [ctx: Db] [projections: {projs}]"
        computed = [
            f"{a or expr_name(e)} = " + (
                f"{e.name}(...)" if isinstance(e, FunctionCall)
                else _expr_sql(e)
            )
            for e, a in n.exprs
            if e != "*" and not isinstance(e, Idiom)
        ]
        compute_label = (
            f"Compute [ctx: Db] [fields: {', '.join(computed)}]"
            if computed else None
        )
    return ProjectOp(node, n, cols, label, compute_label)


def try_stream_select(n, ctx):
    """Execute via the streaming engine; _UNSUPPORTED → legacy fallback."""
    plan = build_select_plan(n, ctx)
    if plan is None:
        return _UNSUPPORTED
    out = []
    try:
        for b in plan.execute(ctx):
            out.extend(b)
    except _FallbackToLegacy:
        # a columnar fast path couldn't serve this txn after all (raised
        # before any batch is emitted)
        return _UNSUPPORTED
    return out


def try_stream_analyze(n, ctx):
    """EXPLAIN ANALYZE through the real operator tree: executes, drains,
    and renders per-operator measured rows/batches/elapsed (reference
    exec/operators/explain.rs AnalyzePlan + metrics.rs). Returns None when
    the statement isn't stream-eligible (cosmetic renderer handles it)."""
    import copy as _copy

    n2 = _copy.copy(n)
    n2.explain = None
    plan = build_select_plan(n2, ctx)
    if plan is None:
        return None
    plan.enable_metrics()
    total = 0
    for b in plan.execute(ctx):
        total += len(b)
    lines = []
    for depth, label, m in plan.lines():
        extra = ""
        if m.vrows or m.frows:
            # columnar accounting: rows the vectorized kernels served
            # vs rows that took the scalar fallback (exec/vops.py)
            extra = f"vectorized: {m.vrows}, fallback: {m.frows}, "
        lines.append(
            "    " * depth + label
            + f" {{rows: {m.rows}, batches: {m.batches}, "
            + extra
            + f"elapsed: {_fmt_elapsed(m.ns)}}}"
        )
    return "\n".join(lines) + f"\n\nTotal rows: {total}"
