"""Vectorized operator kernels over classified columns (exec/batch.py).

Reference: core/src/exec/ — the push executor evaluates predicates,
projections and aggregates over ValueBatch columns with one kernel call
per batch instead of one `evaluate()` per row.

Exactness contract (the golden-file conformance suite is the net):

- A compiled node either produces the bit-identical value the scalar
  evaluator would produce for a row, or marks that row EXOTIC; exotic
  rows are re-evaluated through the ordinary `evaluate()` path (same
  values, same errors, same short-circuit order).
- Compilation is conservative: any expression shape outside the known
  set returns None and the whole expression stays scalar ("per-
  expression fallback").
- Kernels never raise on data: every case where the scalar operators
  would raise (arithmetic on NONE, negating a string, >2^53 integers,
  NaN ordering, ...) is classified exotic instead, so the scalar
  fallback raises the exact error text at the exact row.

Aggregation: `group_sources` (streaming tier — per-group fallback via
the drained Source rows) and `columnar_group_select` (whole-table tier
over the version-keyed column store — bails to the streaming tier on
any wrinkle) share one grouping core. Float sums run through
`np.cumsum`, which accumulates strictly left-to-right — bit-identical
to the scalar fold (pairwise `np.sum`/`np.add.reduceat` are NOT and
are never used for float aggregates).
"""

from __future__ import annotations

import numpy as np

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.exec.batch import (
    RANK_BOOL,
    RANK_EXOTIC,
    RANK_NONE,
    RANK_NULL,
    RANK_NUM,
    RANK_STR,
    Column,
    _count,
)
from surrealdb_tpu_torch.val import NONE, type_rank

_I53 = 1 << 53

_CMP_OPS = ("<", "<=", ">", ">=", "=", "==", "!=")
_ARITH_OPS = ("+", "-", "*", "/")


def _enabled() -> bool:
    from surrealdb_tpu_torch import cnf

    return cnf.COLUMNAR != "off"


# ---------------------------------------------------------------------------
# compiled nodes
# ---------------------------------------------------------------------------


class _Field:
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts

    def paths(self, out):
        out.add(self.parts)

    def eval(self, colset, ctx):
        return colset.col(self.parts)


class _Const:
    """A query-constant operand, evaluated once per execution."""

    __slots__ = ("value", "crank", "cnum")

    def __init__(self, value):
        self.value = value
        self.crank = type_rank(value)
        self.cnum = None
        if self.crank == 3:
            # Decimal compares through float() (val._num_cmp); int/float
            # pass through — callers reject NaN / >2^53 ints at compile
            from decimal import Decimal

            self.cnum = float(value) if isinstance(value, Decimal) \
                else value
        elif self.crank == 2:
            self.cnum = 1.0 if self.value else 0.0


class _Cmp:
    __slots__ = ("op", "lhs", "rhs")

    def __init__(self, op, lhs, rhs):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs

    def paths(self, out):
        for s in (self.lhs, self.rhs):
            if not isinstance(s, _Const):
                s.paths(out)

    def eval(self, colset, ctx):
        op = self.op
        if isinstance(self.rhs, _Const):
            l = self.lhs.eval(colset, ctx)
            if l is None:
                return None
            return _cmp_col_const(op, l, self.rhs)
        if isinstance(self.lhs, _Const):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            l = self.rhs.eval(colset, ctx)
            if l is None:
                return None
            return _cmp_col_const(flip.get(op, op), l, self.lhs)
        l = self.lhs.eval(colset, ctx)
        r = self.rhs.eval(colset, ctx)
        if l is None or r is None:
            return None
        return _cmp_col_col(op, l, r)


class _In:
    """lhs ∈ <const list> — an OR of per-element equality kernels."""

    __slots__ = ("lhs", "elems", "neg")

    def __init__(self, lhs, elems, neg):
        self.lhs = lhs
        self.elems = elems  # list[_Const]
        self.neg = neg

    def paths(self, out):
        self.lhs.paths(out)

    def eval(self, colset, ctx):
        l = self.lhs.eval(colset, ctx)
        if l is None:
            return None
        n = l.n
        mask = np.zeros(n, bool)
        for c in self.elems:
            r = _cmp_col_const("==", l, c)
            mask |= r.num != 0.0
        if self.neg:
            mask = ~mask & (l.rank != RANK_EXOTIC)
        return _bool_col(n, mask, l.rank == RANK_EXOTIC)


class _Logic:
    __slots__ = ("op", "lhs", "rhs")

    def __init__(self, op, lhs, rhs):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs

    def paths(self, out):
        self.lhs.paths(out)
        self.rhs.paths(out)

    def eval(self, colset, ctx):
        l = self.lhs.eval(colset, ctx)
        if l is None:
            return None
        r = self.rhs.eval(colset, ctx)
        if r is None:
            return None
        tl, el = _truthy(l)
        tr, er = _truthy(r)
        if self.op == "&&":
            # short-circuit: a valid falsy lhs decides the row — an
            # exotic rhs there never runs on the scalar path either
            mask = tl & tr
            exo = el | (tl & ~el & er)
        else:
            mask = tl | tr
            exo = el | (~tl & ~el & er)
        return _bool_col(l.n, mask & ~exo, exo)


class _Not:
    __slots__ = ("inner",)

    def __init__(self, inner):
        self.inner = inner

    def paths(self, out):
        self.inner.paths(out)

    def eval(self, colset, ctx):
        c = self.inner.eval(colset, ctx)
        if c is None:
            return None
        t, e = _truthy(c)
        return _bool_col(c.n, ~t & ~e, e)


class _Neg:
    __slots__ = ("inner",)

    def __init__(self, inner):
        self.inner = inner

    def paths(self, out):
        self.inner.paths(out)

    def eval(self, colset, ctx):
        c = self.inner.eval(colset, ctx)
        if c is None:
            return None
        # negation is numeric-only (`neg` raises on everything else)
        exo = c.rank != RANK_NUM
        out = Column(c.n, np.where(exo, RANK_EXOTIC, RANK_NUM).astype(
            np.int8), -c.num, c.is_int.copy(), None)
        return out


class _Arith:
    __slots__ = ("op", "lhs", "rhs")

    def __init__(self, op, lhs, rhs):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs

    def paths(self, out):
        for s in (self.lhs, self.rhs):
            if not isinstance(s, _Const):
                s.paths(out)

    def eval(self, colset, ctx):
        op = self.op
        l = self.lhs.eval(colset, ctx) if not isinstance(self.lhs, _Const) \
            else self.lhs
        r = self.rhs.eval(colset, ctx) if not isinstance(self.rhs, _Const) \
            else self.rhs
        if l is None or r is None:
            return None
        if isinstance(l, _Const):
            if l.crank != 3:
                return None
            n = r.n
            la = np.full(n, float(l.cnum))
            lint = np.full(n, isinstance(l.value, int)
                           and not isinstance(l.value, bool))
            lexo = np.zeros(n, bool)
        else:
            n = l.n
            la, lint = l.num, l.is_int
            lexo = l.rank != RANK_NUM
        if isinstance(r, _Const):
            if r.crank != 3:
                return None
            ra = np.full(n, float(r.cnum))
            rint = np.full(n, isinstance(r.value, int)
                           and not isinstance(r.value, bool))
            rexo = np.zeros(n, bool)
        else:
            ra, rint = r.num, r.is_int
            rexo = r.rank != RANK_NUM
        exo = lexo | rexo
        is_int = lint & rint
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            if op == "+":
                out = la + ra
            elif op == "-":
                out = la - ra
            elif op == "*":
                out = la * ra
            else:
                # float division only; int/int keeps the exact truncating
                # scalar semantics, and a negative-zero divisor's infinity
                # sign diverges from the scalar branch — both exotic
                exo = exo | is_int | ((ra == 0.0) & np.signbit(ra))
                out = la / ra
                zero = ra == 0.0
                if zero.any():
                    # scalar div: 0/0 → NaN, a/0 → ±inf by sign of a
                    out = np.where(zero & (la == 0.0), np.nan, out)
                    out = np.where(zero & (la > 0.0), np.inf, out)
                    out = np.where(zero & (la < 0.0), -np.inf, out)
                is_int = np.zeros(n, bool)
        # rows whose exact integer result left the f64-exact window, and
        # NaN results (ordering diverges), re-run on the scalar path
        exo = exo | (is_int & (np.abs(out) >= _I53)) | np.isnan(out)
        rank = np.where(exo, RANK_EXOTIC, RANK_NUM).astype(np.int8)
        return Column(n, rank, np.where(exo, 0.0, out), is_int & ~exo,
                      None)


def _bool_col(n, mask, exotic):
    rank = np.where(exotic, RANK_EXOTIC, RANK_BOOL).astype(np.int8)
    return Column(n, rank, mask.astype(np.float64), np.zeros(n, bool),
                  None)


def _truthy(col):
    """(truthy, exotic) masks with exact `is_truthy` semantics per rank."""
    r = col.rank
    exo = r == RANK_EXOTIC
    t = np.zeros(col.n, bool)
    numish = (r == RANK_BOOL) | (r == RANK_NUM)
    t[numish] = col.num[numish] != 0.0
    smask = r == RANK_STR
    if smask.any():
        t[smask] = np.not_equal(col.strs[smask], "")
    return t, exo


def _cmp_col_const(op, l, c: _Const):
    n = l.n
    r = l.rank
    exo = r == RANK_EXOTIC
    crank = c.crank
    if op in ("=", "==", "!="):
        if crank == 16 and op == "=":
            return None  # `=` against a regex is a match, not equality
        eq = np.zeros(n, bool)
        if crank <= 1:
            eq = r == crank
        elif crank in (2, 3):
            eq = (r == crank) & (l.num == c.cnum)
        elif crank == 4:
            smask = r == RANK_STR
            if smask.any():
                eq[smask] = np.equal(l.strs[smask], c.value)
        # other const ranks never equal a vectorizable row value
        if op == "!=":
            eq = ~eq & ~exo
        return _bool_col(n, eq & ~exo, exo)
    # ordering: rank order first, then the typed comparator inside the
    # shared rank (val.value_cmp semantics)
    lt = r < crank
    gt = (r > crank) & ~exo
    if crank in (2, 3):
        same = r == crank
        lt = lt | (same & (l.num < c.cnum))
        gt = gt | (same & (l.num > c.cnum))
    elif crank == 4:
        smask = r == RANK_STR
        if smask.any():
            sl = np.zeros(n, bool)
            sg = np.zeros(n, bool)
            sl[smask] = np.less(l.strs[smask], c.value)
            sg[smask] = np.greater(l.strs[smask], c.value)
            lt = lt | sl
            gt = gt | sg
    elif crank <= 1:
        pass  # same-rank NONE/NULL compare equal
    if op == "<":
        mask = lt
    elif op == "<=":
        mask = ~gt
    elif op == ">":
        mask = gt
    else:
        mask = ~lt
    return _bool_col(n, mask & ~exo, exo)


def _cmp_col_col(op, l, r):
    n = l.n
    exo = (l.rank == RANK_EXOTIC) | (r.rank == RANK_EXOTIC)
    lr, rr = l.rank, r.rank
    ltr = lr < rr
    gtr = lr > rr
    same = (lr == rr) & ~exo
    lt = ltr.copy()
    gt = gtr.copy()
    eq = np.zeros(n, bool)
    eq[same & (lr <= 1)] = True
    numish = same & ((lr == RANK_BOOL) | (lr == RANK_NUM))
    if numish.any():
        eq[numish] = l.num[numish] == r.num[numish]
        lt[numish] = l.num[numish] < r.num[numish]
        gt[numish] = l.num[numish] > r.num[numish]
    smask = same & (lr == RANK_STR)
    if smask.any():
        ls, rs = l.strs[smask], r.strs[smask]
        eq[smask] = np.equal(ls, rs)
        lt[smask] = np.less(ls, rs)
        gt[smask] = np.greater(ls, rs)
    if op in ("=", "=="):
        mask = eq
    elif op == "!=":
        mask = ~eq
    elif op == "<":
        mask = lt
    elif op == "<=":
        mask = ~gt
    elif op == ">":
        mask = gt
    else:
        mask = ~lt
    return _bool_col(n, mask & ~exo, exo)


def col_value_at(col, i):
    """The exact Python value of a computed column row (derived results
    only carry rank/num; field columns keep their original values)."""
    if col.vals is not None:
        return col.vals[i]
    r = col.rank[i]
    if r == RANK_NONE:
        return NONE
    if r == RANK_NULL:
        return None
    if r == RANK_BOOL:
        return bool(col.num[i])
    if r == RANK_NUM:
        return int(col.num[i]) if col.is_int[i] else float(col.num[i])
    if r == RANK_STR:
        return col.strs[i]
    raise SdbError("exotic row has no vectorized value")  # pragma: no cover


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


def _const_expr_value(e, ctx):
    """Evaluate a row-constant operand once; _MISS when `e` is not
    row-constant (it references the document)."""
    from surrealdb_tpu_torch.expr.ast import (
        ArrayExpr, Constant, Literal, Param, Prefix,
    )

    if isinstance(e, Literal):
        return e.value
    if isinstance(e, (Param, Constant)):
        from surrealdb_tpu_torch.exec.eval import evaluate

        return evaluate(e, ctx)
    if isinstance(e, ArrayExpr):
        out = []
        for x in e.items:
            v = _const_expr_value(x, ctx)
            if v is _MISS:
                return _MISS
            out.append(v)
        return out
    if isinstance(e, Prefix) and e.op == "-":
        v = _const_expr_value(e.expr, ctx)
        if v is _MISS:
            return _MISS
        from surrealdb_tpu_torch.exec.operators import neg

        try:
            return neg(v)
        except SdbError:
            return _MISS
    return _MISS


_MISS = object()


def _field_node(e):
    from surrealdb_tpu_torch.expr.ast import Idiom, PField

    if isinstance(e, Idiom) and e.parts and all(
        isinstance(p, PField) for p in e.parts
    ):
        return _Field(tuple(p.name for p in e.parts))
    return None


def _const_ok_for_cmp(v) -> bool:
    import math
    from decimal import Decimal

    if isinstance(v, float) and math.isnan(v):
        return False
    if isinstance(v, int) and not isinstance(v, bool) and abs(v) > _I53:
        return False
    if isinstance(v, Decimal):
        try:
            f = float(v)
        except (OverflowError, ValueError):
            return False
        if math.isnan(f):
            return False
    return True


def compile_expr(e, ctx):
    """Compile an expression into a vectorized node; None = unsupported
    (the caller keeps the whole expression on the scalar path)."""
    if not _enabled():
        return None
    from surrealdb_tpu_torch.expr.ast import Binary, Prefix

    fn = _field_node(e)
    if fn is not None:
        return fn
    if isinstance(e, Prefix):
        inner = compile_expr(e.expr, ctx)
        if inner is None:
            return None
        if e.op == "!":
            return _Not(inner)
        if e.op == "-":
            return _Neg(inner)
        return None
    if not isinstance(e, Binary):
        return None
    op = e.op
    if op in ("&&", "||"):
        l = compile_expr(e.lhs, ctx)
        r = compile_expr(e.rhs, ctx)
        if l is None or r is None:
            return None
        return _Logic(op, l, r)
    if op in ("∈", "∉"):
        l = compile_expr(e.lhs, ctx)
        if l is None or isinstance(l, _Logic):
            # &&/|| VALUE semantics return the deciding operand, not a
            # bool — only their truthiness vectorizes, never their value
            return None
        v = _const_expr_value(e.rhs, ctx)
        if v is _MISS:
            return None
        from surrealdb_tpu_torch.val import SSet

        if isinstance(v, SSet):
            v = list(v.items)
        if not isinstance(v, list):
            return None
        elems = []
        for x in v:
            if not _const_ok_for_cmp(x):
                return None
            elems.append(_Const(x))
        return _In(l, elems, op == "∉")
    if op in _CMP_OPS or op in _ARITH_OPS:
        from decimal import Decimal

        sides = []
        for s in (e.lhs, e.rhs):
            v = _const_expr_value(s, ctx)
            if v is not _MISS:
                if not _const_ok_for_cmp(v):
                    return None
                if op in _ARITH_OPS and isinstance(v, Decimal):
                    # scalar arithmetic stays in Decimal (value AND
                    # result type); the f64 kernel would not
                    return None
                sides.append(_Const(v))
                continue
            sub = compile_expr(s, ctx)
            if sub is None or isinstance(sub, _Logic):
                # &&/|| value semantics (see the IN branch above)
                return None
            sides.append(sub)
        l, r = sides
        if isinstance(l, _Const) and isinstance(r, _Const):
            return None  # constant folding is the static evaluator's job
        if op in _ARITH_OPS:
            return _Arith(op, l, r)
        return _Cmp(op, l, r)
    return None


class VecPred:
    """A compiled WHERE predicate: `masks(colset, ctx)` returns
    (pass_mask, fallback_mask) — fallback rows must re-run the full
    scalar predicate. None from the kernel (runtime bail) surfaces as
    an all-fallback answer."""

    __slots__ = ("node", "paths")

    def __init__(self, node):
        self.node = node
        p = set()
        node.paths(p)
        self.paths = p

    def masks(self, colset, ctx):
        col = self.node.eval(colset, ctx)
        if col is None:
            n = colset.n
            return np.zeros(n, bool), np.ones(n, bool)
        t, e = _truthy(col)
        return t & ~e, e


def compile_predicate(cond, ctx):
    """Compile a WHERE tree; None = keep the scalar row loop."""
    if cond is None:
        return None
    node = compile_expr(cond, ctx)
    if node is None:
        return None
    return VecPred(node)


# ---------------------------------------------------------------------------
# grouping core
# ---------------------------------------------------------------------------


class _View:
    """A masked, row-aligned view over a column set: numpy payloads are
    compressed eagerly (cheap), python values resolve through the index
    map only when touched."""

    __slots__ = ("col", "idx", "rank", "num", "is_int", "_strs", "n")

    def __init__(self, col, idx):
        self.col = col
        self.idx = idx
        self.rank = col.rank[idx] if idx is not None else col.rank
        self.num = col.num[idx] if idx is not None else col.num
        self.is_int = col.is_int[idx] if idx is not None else col.is_int
        self._strs = None
        self.n = len(self.rank)

    @property
    def strs(self):
        if self._strs is None:
            s = self.col.strs
            self._strs = s[self.idx] if self.idx is not None else s
        return self._strs

    def value_at(self, j):
        i = int(self.idx[j]) if self.idx is not None else int(j)
        return col_value_at(self.col, i)


def _factorize(view):
    """Grouping codes for one key column — two rows share a code iff
    `hashable(a) == hashable(b)` would put them in one legacy group
    (int 1 and float 1.0 share; True and 1 do not)."""
    r = view.rank
    n = view.n
    codes = np.zeros(n, np.int64)
    codes[r == RANK_NULL] = 1
    bm = r == RANK_BOOL
    if bm.any():
        codes[bm] = 2 + view.num[bm].astype(np.int64)
    base = 4
    nm = r == RANK_NUM
    if nm.any():
        _u, inv = np.unique(view.num[nm], return_inverse=True)
        codes[nm] = base + inv
        base += len(_u)
    sm = r == RANK_STR
    if sm.any():
        # dict factorization (exact Python string equality, O(n) hash
        # lookups) — np.unique over an object array would sort with
        # per-element Python comparisons
        seen: dict = {}
        sub = np.empty(int(sm.sum()), np.int64)
        for i, s in enumerate(view.strs[sm].tolist()):
            code = seen.get(s)
            if code is None:
                code = seen[s] = len(seen)
            sub[i] = code
        codes[sm] = base + sub
    return codes


def _combine_codes(code_list):
    combined = code_list[0]
    for c in code_list[1:]:
        m = int(c.max()) + 1 if len(c) else 1
        combined = combined * m + c
        _u, combined = np.unique(combined, return_inverse=True)
    u, first_idx, inv = np.unique(
        combined, return_index=True, return_inverse=True
    )
    return inv.astype(np.int64), first_idx, len(u)


class _Groups:
    __slots__ = ("inv", "first", "G", "order", "starts", "counts")

    def __init__(self, inv, first, G):
        self.inv = inv
        self.first = first
        self.G = G
        self.order = np.argsort(inv, kind="stable")
        self.counts = np.bincount(inv, minlength=G)
        ends = np.cumsum(self.counts)
        self.starts = ends - self.counts

    def seg(self, g):
        return self.order[self.starts[g]:self.starts[g] + self.counts[g]]


def _group_sum(view, seg, want_mean=False):
    """math::sum / the sum half of math::mean over one group segment,
    bit-identical to the scalar left-to-right fold."""
    r = view.rank[seg]
    nm = r == RANK_NUM
    cnt = int(nm.sum())
    if cnt == 0:
        return (0, 0) if want_mean else 0
    sub = seg[nm]
    ints = view.is_int[sub]
    vals = view.num[sub]
    if ints.all():
        if cnt * float(np.max(np.abs(vals))) < float(1 << 62):
            total = int(np.cumsum(vals.astype(np.int64))[-1])
        else:
            total = 0
            for v in vals.tolist():
                total += int(v)
    elif not ints.any():
        total = float(np.cumsum(vals)[-1])
    else:
        # mixed int/float: promotion points matter — exact scalar fold
        total = 0
        it = ints.tolist()
        for v, isi in zip(vals.tolist(), it):
            total = total + (int(v) if isi else v)
    return (total, cnt) if want_mean else total


def _agg_call_shape(expr):
    """(fname, arg_expr) for the directly-vectorizable aggregate calls;
    None otherwise (per-group scalar fallback)."""
    from surrealdb_tpu_torch.expr.ast import FunctionCall

    if not isinstance(expr, FunctionCall):
        return None
    fname = expr.name.lower()
    if fname == "count" and not expr.args:
        return (fname, None)
    if fname in ("count", "math::sum", "math::min", "math::max",
                 "math::mean", "array::group") and len(expr.args) == 1:
        return (fname, expr.args[0])
    return None


def _build_groups(key_nodes, colset, ctx, mask_idx):
    views = []
    for node in key_nodes:
        col = node.eval(colset, ctx)
        if col is None:
            return None
        v = _View(col, mask_idx)
        if (v.rank == RANK_EXOTIC).any():
            return None  # exotic group keys: legacy dict grouping
        views.append(v)
    if not views:
        return None
    codes = [_factorize(v) for v in views]
    inv, first, G = _combine_codes(codes)
    return views, _Groups(inv, first, G)


def group_core(n_stmt, key_exprs, ctx, colset, mask_idx,
               sources_sorted_fn):
    """Shared vectorized GROUP BY core. `sources_sorted_fn(order)`
    returns member Source rows for per-group scalar fallback, or None
    when the caller cannot materialize rows (whole-table tier — any
    fallback need bails the tier instead).

    Returns the output rows (emission order = group keys sorted by the
    legacy comparator) or None when this statement can't be served
    vectorized."""
    from surrealdb_tpu_torch.err import QueryCancelled, QueryTimeout
    from surrealdb_tpu_torch.exec.statements import _set_out_field, expr_name
    from surrealdb_tpu_torch.val import copy_value, sort_key

    key_nodes = []
    for g in key_exprs:
        node = compile_expr(g, ctx)
        if node is None:
            return None
        key_nodes.append(node)
    built = _build_groups(key_nodes, colset, ctx, mask_idx)
    if built is None:
        return None
    views, groups = built
    G = groups.G

    # emission order: representative key values, legacy comparator
    reps = []
    for g in range(G):
        f = groups.first[g]
        reps.append(tuple(v.value_at(f) for v in views))
    emit = sorted(range(G), key=lambda g: tuple(
        sort_key(v) for v in reps[g]
    ))

    # plan each output field once, then fill per group
    out_rows = [dict() for _ in range(G)]
    members_cache = [None]

    def members(g):
        if members_cache[0] is None:
            srcs = sources_sorted_fn(groups.order)
            if srcs is None:
                return None
            members_cache[0] = srcs
        s = int(groups.starts[g])
        return members_cache[0][s:s + int(groups.counts[g])]

    is_value = n_stmt.value is not None
    fields = []
    if is_value:
        fields.append((n_stmt.value, "__value__"))
    else:
        for expr, alias in n_stmt.exprs:
            if expr == "*":
                return None  # grouped `*` is a statement error upstream
            fields.append((expr, alias or expr_name(expr)))

    gb = key_exprs
    try:
        for expr, name in fields:
            ctx.check_deadline()
            vals_out = _agg_field(
                expr, n_stmt, ctx, colset, mask_idx, groups, views,
                gb, members, reps, is_value=is_value,
            )
            if vals_out is None:
                return None
            for g in range(G):
                v = vals_out[g]
                if isinstance(v, (list, dict)):
                    v = copy_value(v)
                if name == "__value__":
                    out_rows[g] = v
                else:
                    _set_out_field(out_rows[g], name, v)
    except (QueryTimeout, QueryCancelled):
        raise
    except SdbError:
        # a scalar fallback raised: bail so the legacy group loop
        # re-raises the exact error at the exact (sorted-group-order)
        # position — field-major fallback here could surface a
        # different group's error first
        return None
    _count(ctx.ds, "agg_groups", G)
    return [out_rows[g] for g in emit]


def _agg_field(expr, n_stmt, ctx, colset, mask_idx, groups, views,
               gb, members, reps, is_value=False):
    """Per-group values for one output field; None bails the tier."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.operators import float_div
    from surrealdb_tpu_torch.exec.statements import _is_aggregate

    G = groups.G
    if _is_aggregate(expr):
        shape = _agg_call_shape(expr)
        if shape is not None:
            fname, arg = shape
            if fname == "count" and arg is None:
                return [int(groups.counts[g]) for g in range(G)]
            node = compile_expr(arg, ctx)
            view = None
            if node is not None:
                col = node.eval(colset, ctx)
                if col is not None:
                    view = _View(col, mask_idx)
            if view is None:
                return _per_group_fallback(expr, groups, members, ctx)
            exotic = view.rank == RANK_EXOTIC
            if fname == "count":
                if exotic.any():
                    return _per_group_fallback(expr, groups, members, ctx)
                t, _e = _truthy_view(view)
                w = np.bincount(groups.inv, weights=t.astype(np.float64),
                                minlength=G)
                return [int(w[g]) for g in range(G)]
            if fname == "array::group":
                if not isinstance(node, _Field):
                    return _per_group_fallback(expr, groups, members, ctx)
                out = []
                for g in range(G):
                    flat = []
                    for j in groups.seg(g):
                        v = view.col.vals[
                            int(view.idx[j]) if view.idx is not None
                            else int(j)
                        ]
                        if isinstance(v, list):
                            flat.extend(v)
                        else:
                            flat.append(v)
                    out.append(flat)
                return out
            if exotic.any():
                return _per_group_fallback(expr, groups, members, ctx)
            if fname == "math::sum":
                return [_group_sum(view, groups.seg(g)) for g in range(G)]
            if fname == "math::mean":
                out = []
                for g in range(G):
                    total, cnt = _group_sum(view, groups.seg(g),
                                            want_mean=True)
                    out.append(float("nan") if cnt == 0
                               else float_div(total, cnt))
                return out
            # math::min / math::max: any non-numeric member is the exact
            # scalar coercion error — per-group fallback raises it
            out = []
            for g in range(G):
                seg = groups.seg(g)
                r = view.rank[seg]
                if not (r == RANK_NUM).all():
                    return _per_group_fallback(expr, groups, members,
                                               ctx)
                vals = view.num[seg]
                j = int(np.argmin(vals)) if fname == "math::min" \
                    else int(np.argmax(vals))
                out.append(view.value_at(seg[j]))
            return out
        return _per_group_fallback(expr, groups, members, ctx)
    if any(expr == g for g in gb):
        ki = next(i for i, g in enumerate(gb) if expr == g)
        return [reps[g][ki] for g in range(G)]
    if is_value:
        # non-aggregate SELECT VALUE with GROUP: evaluate on the first
        # member of each group (legacy `_apply_group` semantics)
        node = compile_expr(expr, ctx)
        view = None
        if node is not None:
            col = node.eval(colset, ctx)
            if col is not None:
                view = _View(col, mask_idx)
        if view is not None and not (view.rank == RANK_EXOTIC).any():
            return [view.value_at(groups.first[g]) for g in range(G)]
        out = []
        for g in range(G):
            m = members(g)
            if m is None:
                return None
            first = m[0]
            d = first.doc if first.rid is not None else first.value
            out.append(evaluate(expr, ctx.with_doc(d, first.rid)))
        return out
    # implicit collect: the expression evaluates per member row
    node = compile_expr(expr, ctx)
    view = None
    if node is not None:
        col = node.eval(colset, ctx)
        if col is not None:
            view = _View(col, mask_idx)
    if view is None or (view.rank == RANK_EXOTIC).any():
        return _collect_fallback(expr, groups, members, ctx)
    return [
        [view.value_at(j) for j in groups.seg(g)] for g in range(G)
    ]


def _truthy_view(view):
    col = Column(view.n, view.rank, view.num, view.is_int, None)
    col._strs = view._strs if view._strs is not None else None
    if col._strs is None and (view.rank == RANK_STR).any():
        col._strs = view.strs
    return _truthy(col)


def _per_group_fallback(expr, groups, members, ctx):
    from surrealdb_tpu_torch.exec.statements import _eval_aggregate

    out = []
    for g in range(groups.G):
        m = members(g)
        if m is None:
            return None
        out.append(_eval_aggregate(expr, m, ctx))
    return out


def _collect_fallback(expr, groups, members, ctx):
    from surrealdb_tpu_torch.exec.eval import evaluate

    out = []
    for g in range(groups.G):
        m = members(g)
        if m is None:
            return None
        vals = []
        for src in m:
            d = src.doc if src.rid is not None else src.value
            vals.append(evaluate(expr, ctx.with_doc(d, src.rid)))
        out.append(vals)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def group_sources(rows, n_stmt, ctx, aliases):
    """Streaming-tier vectorized GROUP BY over drained Source rows.
    Returns the grouped output rows, or None → legacy `_apply_group`."""
    if not _enabled() or not rows:
        return None
    from surrealdb_tpu_torch.exec.batch import BatchCols
    from surrealdb_tpu_torch.exec.statements import _resolve_alias

    gb = [_resolve_alias(g, aliases) for g in (n_stmt.group or [])]
    if not gb:
        return None
    colset = BatchCols(rows)

    def sources_sorted(order):
        return [rows[int(i)] for i in order]

    out = group_core(n_stmt, gb, ctx, colset, None, sources_sorted)
    if out is not None:
        _count(ctx.ds, "agg_streamed")
        _count(ctx.ds, "rows_vectorized", len(rows))
    return out


class _TableColset:
    __slots__ = ("tc", "n")

    def __init__(self, tc):
        self.tc = tc
        self.n = tc.n

    def col(self, parts):
        return self.tc.cols[parts]


def columnar_group_select(n_stmt, tb, ctx, aliases):
    """Whole-table tier: serve a grouped SELECT straight from the
    version-keyed column store — no Source materialization at all.
    Returns output rows (pre ORDER/START/LIMIT) or None to stream."""
    if not _enabled():
        return None
    from surrealdb_tpu_torch.exec.batch import get_table_columns
    from surrealdb_tpu_torch.exec.statements import _resolve_alias

    gb = [_resolve_alias(g, aliases) for g in (n_stmt.group or [])]
    if not gb:
        return None
    pred = None
    if n_stmt.cond is not None:
        pred = compile_predicate(n_stmt.cond, ctx)
        if pred is None:
            return None
    # collect every path the statement touches so ONE scan builds them
    paths = set()
    nodes = []
    for g in gb:
        node = compile_expr(g, ctx)
        if node is None:
            return None
        node.paths(paths)
        nodes.append(node)
    exprs = [n_stmt.value] if n_stmt.value is not None else [
        e for e, _a in n_stmt.exprs
    ]
    for e in exprs:
        if e == "*":
            return None
        for sub in _touched_subexprs(e):
            node = compile_expr(sub, ctx)
            if node is not None:
                node.paths(paths)
    if pred is not None:
        paths |= pred.paths
    tc = get_table_columns(ctx, tb, paths)
    if tc is None:
        return None
    colset = _TableColset(tc)
    if pred is not None:
        mask, fb = pred.masks(colset, ctx)
        if fb.any():
            return None  # scalar-fallback rows need real documents
        idx = np.flatnonzero(mask)
    else:
        idx = None
    out = group_core(n_stmt, gb, ctx, colset, idx, lambda order: None)
    if out is not None:
        _count(ctx.ds, "agg_columnar")
        _count(ctx.ds, "rows_vectorized", tc.n)
    return out


# ---------------------------------------------------------------------------
# vectorized ORDER BY (colstore-backed lexsort)
# ---------------------------------------------------------------------------


def _order_codes(col):
    """Dense per-row sort codes for one ORDER BY key column, exactly
    mirroring `value_cmp` over the vectorizable ranks: type rank first
    (NONE < NULL < bool < number < string), then the typed comparator
    inside the rank (numeric compare for bool/number — int 1 ties
    float 1.0; Python string order for strings). Equal-comparing rows
    share a code, so later keys and sort stability decide them —
    byte-identical to the scalar `_OrderKey` path."""
    n = col.n
    rank = col.rank.astype(np.int64)
    val = col.num.copy()
    smask = col.rank == RANK_STR
    if smask.any():
        sv = col.strs[smask].tolist()
        uniq = {s: i for i, s in enumerate(sorted(set(sv)))}
        val[np.flatnonzero(smask)] = [float(uniq[s]) for s in sv]
    order = np.lexsort((val, rank))
    sr = rank[order]
    svv = val[order]
    new = np.ones(n, bool)
    new[1:] = (sr[1:] != sr[:-1]) | (svv[1:] != svv[:-1])
    codes = np.empty(n, np.int64)
    codes[order] = np.cumsum(new) - 1
    return codes


def lexsort_sources(rows, items, ctx, keep=None):
    """Colstore-backed ORDER BY over drained Source rows: when every
    key is a clean scalar column (compilable expression, no exotic
    rows, no COLLATE/NUMERIC), sort via np.lexsort over dense codes
    instead of the row-at-a-time key extractor. Returns the reordered
    (and `keep`-bounded) row list, or None → the exact scalar path
    (same fallback rules as every kernel in this module: bail, never
    guess). `items` are `(resolved_expr, dir, collate, numeric)`.
    Small row sets stay scalar — below the floor the per-column setup
    costs more than the row loop it replaces."""
    if not _enabled() or len(rows) < 64:
        return None
    from surrealdb_tpu_torch.exec.batch import BatchCols

    for _expr, _d, collate, numeric in items:
        if collate or numeric:
            return None  # collation/numeric string order: scalar path
    nodes = []
    for expr, _d, _c, _n in items:
        node = compile_expr(expr, ctx)
        if node is None:
            return None
        nodes.append(node)
    colset = BatchCols(rows)
    keys = []
    for node, (_e, d, _c, _n) in zip(nodes, items):
        col = node.eval(colset, ctx)
        if col is None or (col.rank == RANK_EXOTIC).any():
            # exotic rows (links, datetimes, NaN, >2^53 ints, nested
            # values, missing docs) need the scalar comparator
            return None
        codes = _order_codes(col)
        keys.append(codes if d == "asc" else -codes)
    # np.lexsort is stable and sorts by the LAST key first — reverse so
    # the first ORDER BY key is primary; equal full-keys keep original
    # row order, exactly like the stable scalar sort (and like
    # heapq.nsmallest on the keep-bounded path)
    order = np.lexsort(tuple(reversed(keys)))
    if keep is not None and keep < len(order):
        order = order[:keep]
    _count(ctx.ds, "order_lexsort")
    _count(ctx.ds, "rows_vectorized", len(rows))
    return [rows[int(i)] for i in order]


# ---------------------------------------------------------------------------
# fused filtered-KNN (hybrid vector + predicate queries)
# ---------------------------------------------------------------------------

# Cross-query batcher for fused (candidate mask, query vector, k)
# payloads: riders arriving together ride ONE scoring kernel per
# (matrix, mask) group — the device/batcher.py discipline applied
# to hybrid brute-force KNN. Lazy: embedded datastores that never run
# a hybrid query pay nothing.
_FUSED_BATCHER = None


def _get_fused_batcher():
    global _FUSED_BATCHER
    if _FUSED_BATCHER is None:
        from surrealdb_tpu_torch.device import DeviceOpError, DeviceUnavailable
        from surrealdb_tpu_torch.device.batcher import DeviceBatcher

        _FUSED_BATCHER = DeviceBatcher(
            dispatch=_fused_dispatch,
            fallback=_fused_host_single,
            retryable=(DeviceUnavailable, DeviceOpError),
        )
    return _FUSED_BATCHER


def _fused_host_single(p):
    """Exact host scoring for one rider (the same `_host_distances`
    ladder the legacy brute path uses)."""
    from surrealdb_tpu_torch.idx.vector import TpuVectorIndex

    xs = p["mat"][p["cand"]]
    tmp = TpuVectorIndex.__new__(TpuVectorIndex)
    tmp.vecs = xs
    tmp.metric = p["metric"]
    tmp.mink_p = p["p"]
    d = tmp._host_distances(p["q"])
    k = min(p["k"], xs.shape[0])
    idx = np.argpartition(d, k - 1)[:k] if k < xs.shape[0] else \
        np.arange(xs.shape[0])
    idx = idx[np.argsort(d[idx], kind="stable")]
    return [(int(p["cand"][int(i)]), float(d[i])) for i in idx]


def _fused_dispatch(payloads):
    """One coalesced dispatch: group riders by (matrix, candidate-mask)
    and run ONE batched scoring kernel per group — device when healthy
    and the candidate set is big enough, exact host ladder otherwise."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.device import get_supervisor

    groups = {}
    for i, p in enumerate(payloads):
        groups.setdefault(p["token"], []).append(i)
    results = [None] * len(payloads)
    sup = get_supervisor()
    for token, idxs in groups.items():
        p0 = payloads[idxs[0]]
        cand = p0["cand"]
        n = int(cand.shape[0])
        if n == 0:
            for i in idxs:
                results[i] = []
            continue
        use_device = n >= cnf.KNN_DEVICE_MIN_ROWS and sup.fast_path() \
            and len(idxs) > 0
        if use_device:
            xs = p0["mat"][cand]
            qs = np.stack([payloads[i]["q"] for i in idxs])
            kmax = min(max(payloads[i]["k"] for i in idxs), n)
            _t, _m, bufs = sup.call(
                "brute_knn",
                {"k": kmax, "metric": p0["metric"], "p": p0["p"]},
                [xs, qs.astype(np.float32)],
            )
            d, ind = bufs[0], bufs[1]
            for row, i in enumerate(idxs):
                k = min(payloads[i]["k"], n)
                results[i] = [
                    (int(cand[int(ii)]), float(dd))
                    for dd, ii in zip(d[row][:k], ind[row][:k])
                    if ii >= 0
                ]
        else:
            for i in idxs:
                results[i] = _fused_host_single(payloads[i])
    return results


def fused_brute_knn(tb, knn, qv, rest, ctx):
    """Serve a brute-force (possibly filtered) KNN from the column
    store: the residual predicate evaluates vectorized over the table
    columns, and only surviving rows ship — as (candidate mask, query
    vector, k) — through the cross-query batcher for scoring. Returns
    [(rid, dist)] or None → the legacy row-at-a-time scan."""
    if not _enabled():
        return None
    from surrealdb_tpu_torch.exec.batch import _count, get_table_columns
    from surrealdb_tpu_torch.expr.ast import Idiom, PField

    lhs = knn.lhs
    if not (isinstance(lhs, Idiom) and len(lhs.parts) == 1
            and isinstance(lhs.parts[0], PField)):
        return None
    field = lhs.parts[0].name
    if not (isinstance(qv, list) and qv and all(
        isinstance(x, (int, float)) and not isinstance(x, bool)
        for x in qv
    )):
        return None
    dim = len(qv)
    pred = None
    if rest is not None:
        pred = compile_predicate(rest, ctx)
        if pred is None:
            return None
    from surrealdb_tpu_torch.col import get_vector_column

    col = get_vector_column(ctx, tb, field, dim)
    if col is None or col.bad_ids or col.ids_enc is None:
        # non-conforming rows: the legacy scan's first-row-dim /skip
        # semantics must decide, not the column store
        return None
    if pred is not None:
        tc = get_table_columns(ctx, tb, pred.paths)
        if tc is None or tc.version != col.version:
            return None
        mask, fb = pred.masks(_TableColset(tc), ctx)
        if fb.any():
            return None  # fallback rows need real documents
        pos = _vec_align(ctx.ds, tb, field, dim, tc, col)
        if pos is None:
            return None
        cand = np.flatnonzero(mask[pos])
    else:
        cand = np.arange(len(col.ids), dtype=np.int64)
    if len(cand) == 0:
        return []
    from surrealdb_tpu_torch.ops.metrics import normalize_metric

    metric, p = normalize_metric(knn.dist or "euclidean")
    q = np.asarray(qv, dtype=np.float32)
    # exact mask bytes in the token — a hash collision between two
    # different candidate sets would score a rider against the wrong
    # rows, silently
    token = (id(col.mat), cand.tobytes(), metric, float(p))
    payload = {
        "mat": col.mat, "cand": cand, "q": q, "k": int(knn.k),
        "metric": metric, "p": float(p), "token": token,
    }
    _count(ctx.ds, "fused_knn_queries")
    out = _get_fused_batcher().submit(payload)
    rids = col.ids
    from surrealdb_tpu_torch.val import RecordId

    return [(RecordId(tb, rids[vi]), dist) for vi, dist in out]


def _vec_align(ds, tb, field, dim, tc, col):
    """Row positions of the vector column inside the table column set
    (both are key-ordered scans of the same snapshot; the vector rows
    are a subsequence). Cached per write version."""
    cache = getattr(ds, "_fused_align", None)
    if cache is None:
        cache = ds._fused_align = {}
    key = (tb, field, dim)
    hit = cache.get(key)
    if hit is not None and hit[0] == tc.version and hit[1] == id(col):
        return hit[2]
    te = tc.ids_enc
    pos = np.empty(len(col.ids_enc), np.int64)
    j = 0
    for i, s in enumerate(col.ids_enc):
        while j < len(te) and te[j] != s:
            j += 1
        if j >= len(te):
            return None  # snapshots diverged: rebuild next query
        pos[i] = j
        j += 1
    cache[key] = (tc.version, id(col), pos)
    return pos


def _touched_subexprs(e):
    """Field-bearing argument expressions of an output field (for path
    pre-collection; over-approximation is fine — unneeded columns cost
    one vector each)."""
    from surrealdb_tpu_torch.expr.ast import Binary, FunctionCall, Idiom, Prefix

    out = []

    def rec(x):
        if isinstance(x, Idiom):
            out.append(x)
        elif isinstance(x, FunctionCall):
            for a in x.args:
                rec(a)
        elif isinstance(x, Binary):
            rec(x.lhs)
            rec(x.rhs)
        elif isinstance(x, Prefix):
            rec(x.expr)

    rec(e)
    return out
