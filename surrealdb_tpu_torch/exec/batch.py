"""Columnar ValueBatch representation (execution engine A, layer 2).

Reference: core/src/exec/ ValueBatch — the push executor's unit of work
is a batch of typed column vectors, not a row. SurrealQL values are
heterogeneous, so a column here is a *classified* vector: every row
carries a type rank (NONE / NULL / bool / number / string — the same
ranks `val.type_rank` orders comparisons by) plus a float64 payload for
the numeric ranks and a lazy string payload for rank 4. Rows whose
value can't be represented exactly in that scheme (Decimal, NaN, >2^53
integers, datetimes, nested arrays/objects, record links, ...) are
marked EXOTIC and always take the scalar `evaluate()` path — the
vectorized kernels in exec/vops.py never guess: a row is either served
bit-exactly from the typed payload or it falls back.

Two batch sources:

- `BatchCols` wraps one streaming batch of `Source` rows (exec/stream
  operators): columns extract lazily per referenced field path.
- `TableColumns` is the version-keyed whole-table column store (the
  col.py VectorColumn idiom generalized to scalars): one partial-decode
  scan per (table, write-version) serves every later analytics query
  from numpy arrays. Entries register with the memory accountant
  under the `col` kind (eviction = drop + rebuild-on-touch).
"""

from __future__ import annotations

import numpy as np

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.val import NONE, RecordId

# type ranks mirror val.type_rank for the vectorizable prefix; EXOTIC
# marks rows the kernels must not touch
RANK_NONE = 0
RANK_NULL = 1
RANK_BOOL = 2
RANK_NUM = 3
RANK_STR = 4
RANK_EXOTIC = 99

# integers beyond 2^53 do not round-trip through float64; comparisons
# and arithmetic on them stay on the exact scalar path
_I53 = 1 << 53

_MISSING_DOC = object()  # non-dict intermediate on a path walk


class Column:
    """One classified column over `n` rows."""

    __slots__ = ("n", "rank", "num", "is_int", "vals", "_strs")

    def __init__(self, n, rank, num, is_int, vals):
        self.n = n
        self.rank = rank      # int8[n] — RANK_* per row
        self.num = num        # f64[n]  — value where rank∈{BOOL,NUM}
        self.is_int = is_int  # bool[n] — rank-NUM rows that were int
        self.vals = vals      # original python values (NONE = missing)
        self._strs = None

    @property
    def strs(self):
        """Object array of the string rows; non-string rows hold "" so
        elementwise comparisons never see None (results are masked by
        rank anyway)."""
        if self._strs is None:
            s = np.empty(self.n, dtype=object)
            mask = self.rank == RANK_STR
            s[:] = ""
            idx = np.flatnonzero(mask)
            vals = self.vals
            for i in idx:
                s[i] = vals[i]
            self._strs = s
        return self._strs

    def has_exotic(self) -> bool:
        return bool((self.rank == RANK_EXOTIC).any())

    def exotic_mask(self):
        return self.rank == RANK_EXOTIC

    def nbytes(self) -> int:
        b = self.rank.nbytes + self.num.nbytes + self.is_int.nbytes
        # python values: rough per-slot estimate (most are smallish
        # scalars; strings/objects are shared with the decode layer)
        b += 56 * self.n
        return b


def classify_value(v):
    """(rank, num, is_int) for one value — the single classification
    the whole columnar engine agrees on."""
    if v is NONE:
        return RANK_NONE, 0.0, False
    if v is None:
        return RANK_NULL, 0.0, False
    if isinstance(v, bool):
        return RANK_BOOL, 1.0 if v else 0.0, False
    if isinstance(v, int):
        if -_I53 <= v <= _I53:
            return RANK_NUM, float(v), True
        return RANK_EXOTIC, 0.0, False
    if isinstance(v, float):
        # NaN ordering (sorts last) and -0.0 min/max tie-breaks diverge
        # from IEEE kernel semantics — exact scalar path for both
        if v != v or (v == 0.0 and np.signbit(v)):
            return RANK_EXOTIC, 0.0, False
        return RANK_NUM, v, False
    if isinstance(v, str):
        return RANK_STR, 0.0, False
    return RANK_EXOTIC, 0.0, False


def column_from_values(vals) -> Column:
    n = len(vals)
    rank = np.empty(n, np.int8)
    num = np.zeros(n, np.float64)
    is_int = np.zeros(n, bool)
    cls = classify_value
    for i, v in enumerate(vals):
        r, f, ii = cls(v)
        rank[i] = r
        num[i] = f
        is_int[i] = ii
    return Column(n, rank, num, is_int, vals)


def path_value(doc, parts):
    """Walk a plain field path through nested dicts. Missing → NONE
    (matching idiom evaluation); any non-dict intermediate → the
    _MISSING_DOC marker, which classifies the row EXOTIC (lists
    distribute under idiom semantics — scalar path territory)."""
    v = doc
    for p in parts:
        if isinstance(v, dict):
            v = v.get(p, NONE)
        elif v is NONE or v is None:
            return NONE
        else:
            return _MISSING_DOC
    return v


class BatchCols:
    """Lazy per-batch column cache over a list of Source rows."""

    __slots__ = ("sources", "n", "_cols")

    def __init__(self, sources):
        self.sources = sources
        self.n = len(sources)
        self._cols = {}

    def col(self, parts: tuple) -> Column:
        c = self._cols.get(parts)
        if c is None:
            vals = []
            for src in self.sources:
                doc = src.doc if src.rid is not None else src.value
                v = path_value(doc, parts) if isinstance(doc, dict) \
                    else _MISSING_DOC
                vals.append(v)
            c = column_from_values(vals)
            # a _MISSING_DOC marker is not a value: classify it exotic
            for i, v in enumerate(vals):
                if v is _MISSING_DOC:
                    c.rank[i] = RANK_EXOTIC
                    vals[i] = NONE
            self._cols[parts] = c
        return c


# ---------------------------------------------------------------------------
# whole-table column store (version-keyed, accountant-covered)
# ---------------------------------------------------------------------------


class TableColumns:
    """Immutable column set for one table at one write version. All
    columns come from ONE snapshot scan, so they are row-aligned with
    each other and with `ids_enc` (the encoded record-id key suffixes
    in key order — the alignment token shared with col.py's vector
    columns for the fused filtered-KNN seam)."""

    __slots__ = ("version", "n", "paths", "cols", "ids_enc", "_ids")

    def __init__(self, version, n, paths, cols, ids_enc):
        self.version = version
        self.n = n
        self.paths = paths      # frozenset of path tuples built
        self.cols = cols        # path tuple -> Column
        self.ids_enc = ids_enc  # list[bytes] key suffixes, key order
        self._ids = None

    def ids(self, tb):
        """Decoded RecordIds, built on first touch (aggregation paths
        never need them; the fused-KNN path does)."""
        if self._ids is None:
            self._ids = [
                RecordId(tb, K.dec_value(s)[0]) for s in self.ids_enc
            ]
        return self._ids

    def nbytes(self) -> int:
        b = sum(c.nbytes() for c in self.cols.values())
        b += sum(len(s) + 64 for s in self.ids_enc)
        return b


def _store(ds) -> dict:
    s = getattr(ds, "_table_columns", None)
    if s is None:
        s = ds._table_columns = {}
    return s


def txn_range_clean(txn, beg: bytes, end: bytes) -> bool:
    """True only when the transaction's OWN write buffer provably has
    no key in [beg, end). FAIL CLOSED: an engine whose write set we
    cannot see (unknown backend shape) answers False — committed-state
    caches must never serve over an invisible overlay (the fulltext
    `_txn_wrote` discipline; ShardTx buffers writes per-shard in
    `_subs`)."""
    btx = getattr(txn, "btx", None)
    if btx is None:
        return False
    w = getattr(btx, "writes", None)
    if w is not None:
        return not any(beg <= k < end for k in w)
    subs = getattr(btx, "_subs", None)  # ShardTx: per-shard buffers
    if subs is not None:
        try:
            return not any(
                beg <= k < end
                for sub in subs.values() for k in sub.writes
            )
        except AttributeError:
            return False
    return False


def table_columns_servable(ctx, tb: str) -> bool:
    """Commit-consistent column serving needs: columnar mode on, no
    uncommitted writes to this table in the current txn (they would be
    invisible to the committed-state columns), and no computed fields
    (those need per-row evaluation)."""
    from surrealdb_tpu_torch import cnf

    if cnf.COLUMNAR == "off":
        return False
    ns, db = ctx.need_ns_db()
    gk = (ns, db, tb)
    if gk in getattr(ctx.txn, "_graph_dirty", ()):
        return False
    pre = K.record_prefix(ns, db, tb)
    beg, end = K.prefix_range(pre)
    if not txn_range_clean(ctx.txn, beg, end):
        return False
    from surrealdb_tpu_torch.exec.eval import computed_fields_of

    if computed_fields_of(tb, ctx):
        return False
    return True


def get_table_columns(ctx, tb: str, paths) -> "TableColumns | None":
    """The whole-table column set covering `paths` (tuples of field
    names), building (or extending via full rebuild — columns must stay
    row-aligned) when needed. Returns None when committed-state serving
    can't be proven (caller streams instead). Same freshness contract
    as col.get_vector_column: the version stamp is read before the
    build transaction opens."""
    if not table_columns_servable(ctx, tb):
        return None
    ns, db = ctx.need_ns_db()
    gk = (ns, db, tb)
    paths = frozenset(tuple(p) for p in paths)
    version = ctx.ds.graph_versions.get(gk, 0)
    store = _store(ctx.ds)
    hit = store.get(gk)
    if hit is not None and hit.version == version and \
            paths <= hit.paths:
        _count(ctx.ds, "colstore_hits")
        acct = getattr(ctx.ds, "_mem_col", None)
        if acct is not None:
            acct.touch()
        return hit
    want = paths if hit is None or hit.version != version \
        else paths | hit.paths
    tc = _build_table_columns(ctx, tb, want, version)
    if tc is None:
        return None
    store[gk] = tc
    _count(ctx.ds, "colstore_builds")
    return tc


def _build_table_columns(ctx, tb, paths, version):
    from surrealdb_tpu_torch.kvs.api import deserialize_fields

    ns, db = ctx.need_ns_db()
    pre = K.record_prefix(ns, db, tb)
    beg, end = K.prefix_range(pre)
    plen = len(pre)
    tops = {p[0] for p in paths}
    per_path = {p: [] for p in paths}
    ids_enc = []
    # build from a FRESH transaction (committed state only) — the
    # caller's snapshot may predate commits already counted in the
    # version stamp (col.py / graph CSR build pattern)
    txn = ctx.ds.transaction(write=False)
    try:
        i = 0
        for k, raw in txn.scan(beg, end):
            i += 1
            if (i & 0x3FF) == 0:
                ctx.check_deadline()
            doc = deserialize_fields(raw, tops)
            ids_enc.append(k[plen:])
            if doc is None:
                for p in paths:
                    per_path[p].append(_MISSING_DOC)
                continue
            for p in paths:
                per_path[p].append(path_value(doc, p))
    finally:
        txn.cancel()
    cols = {}
    for p, vals in per_path.items():
        ctx.check_deadline()
        c = column_from_values(vals)
        for j, v in enumerate(vals):
            if v is _MISSING_DOC:
                c.rank[j] = RANK_EXOTIC
                vals[j] = NONE
        cols[p] = c
    return TableColumns(version, len(ids_enc), frozenset(paths), cols,
                        ids_enc)


# ---------------------------------------------------------------------------
# counters (surfaced via INFO FOR SYSTEM `columnar` + /metrics)
# ---------------------------------------------------------------------------

# fixed monotone counter set, DATASTORE-scoped (like the sibling
# ft/csr counters — a process hosting several nodes must not blend
# their numbers); kvs/ds.py registers them with telemetry
COUNTER_KEYS = (
    "colstore_hits",
    "colstore_builds",
    "batches_vectorized",
    "rows_vectorized",
    "rows_fallback",
    "agg_groups",
    "agg_columnar",
    "agg_streamed",
    "order_lexsort",
    "fused_knn_queries",
    "pushdown_rows_pruned",
)


def counters(ds) -> dict:
    c = getattr(ds, "_columnar_counters", None)
    if c is None:
        c = ds._columnar_counters = {k: 0 for k in COUNTER_KEYS}
    return c


def _count(ds, name, by=1):
    c = counters(ds)
    c[name] = c.get(name, 0) + by


def store_nbytes(ds) -> int:
    total = 0
    for tc in list(getattr(ds, "_table_columns", {}).values()):
        total += tc.nbytes()
    for _v, _cid, pos in list(getattr(ds, "_fused_align", {}).values()):
        total += int(pos.nbytes)
    return total
