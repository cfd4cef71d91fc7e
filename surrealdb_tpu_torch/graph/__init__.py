"""Graph traversal engine.

Host path: per-source `~`-key range scans (reference: dbs/processor.rs
collect_lookup, key/graph/mod.rs:124). Device path: CSR adjacency blocks,
hop = gather + segmented reduce (surrealdb_tpu_torch.graph.csr), engaged for large
frontiers — SURVEY.md §3.4's fan-out×depth hot loop.
"""

from __future__ import annotations

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.expr.ast import PGraph
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, RecordId, is_truthy

# frontier size at which multi-hop expansion moves to the CSR engine
TPU_FRONTIER_THRESHOLD = 512


def _key_filter(what, ctx):
    """Per-table key filters from lookup ranges: tb -> predicate(fk)."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.operators import contains
    from surrealdb_tpu_torch.val import Range as _Range, value_eq

    filt = {}
    for w in what or []:
        if len(w) > 1 and w[1] is not None:
            ridlit = evaluate(w[1], ctx)
            key = ridlit.id if hasattr(ridlit, "id") else ridlit

            def pred(fk, key=key):
                if isinstance(key, _Range):
                    return contains(key, fk)
                return value_eq(fk, key)

            filt[w[0]] = pred
    return filt


def traverse_hop(rids: list, g: PGraph, ctx, ref_field=None) -> list:
    """One graph hop from a set of source records; returns destination ids."""
    ns, db = ctx.need_ns_db()
    want = [w[0] for w in g.what] if g.what else None
    kfilt = _key_filter(g.what, ctx)
    if ref_field is None:
        ref_field = getattr(g, "ref_field", None)
    if g.dir == "ref":
        if ref_field is None and any(
            w[1] is not None for w in (g.what or [])
        ):
            # <~lookup:1..2 needs FIELD to bound the scan (reference:
            # invalid-range-lookup)
            raise SdbError(
                "Cannot scan a specific range of record references "
                "without a referencing field"
            )
        out = []
        for rid in rids:
            if want:
                for ft in want:
                    beg, end = K.prefix_range(
                        K.ref_ft_prefix(ns, db, rid.tb, rid.id, ft)
                    )
                    for k in ctx.txn.keys(beg, end):
                        _n, _d, _t, _i, ftb, ff, fk = K.decode_ref(k)
                        if ref_field is not None and ff != ref_field:
                            continue
                        if ft in kfilt and not kfilt[ft](fk):
                            continue
                        out.append(RecordId(ftb, fk))
            else:
                beg, end = K.prefix_range(K.ref_prefix(ns, db, rid.tb, rid.id))
                for k in ctx.txn.keys(beg, end):
                    _n, _d, _t, _i, ftb, ff, fk = K.decode_ref(k)
                    if ref_field is not None and ff != ref_field:
                        continue
                    out.append(RecordId(ftb, fk))
        # NO dedupe: a record referencing via several fields appears once
        # per referencing field (reference via_referencing_field.surql)
        return _cond_filter(out, g, ctx)
    # VERSION-aware traversal: graph keys are HEAD-only, so at a version
    # each edge record must have existed at that timestamp
    vts = None
    if ctx.version is not None:
        from surrealdb_tpu_torch.exec.eval import version_ns

        vts = version_ns(ctx.version)

    def _alive(dest):
        if vts is None:
            return True
        from surrealdb_tpu_torch.exec.eval import fetch_record_at
        from surrealdb_tpu_torch.val import NONE as _N

        return fetch_record_at(ctx, dest, vts) is not _N

    # key order: IN (\x01) sorts before OUT (\x02), so a `<->` scan
    # yields incoming edges first (reference Dir enum In < Out)
    dirs = []
    if g.dir in ("in", "both"):
        dirs.append(K.DIR_IN)
    if g.dir in ("out", "both"):
        dirs.append(K.DIR_OUT)
    out = []
    seen = set()
    for rid in rids:
        for d in dirs:
            if want:
                # per-table prefix scans ride the key order
                for ft in want:
                    pre = K.graph_ft_prefix(ns, db, rid.tb, rid.id, d, ft)
                    beg, end = K.prefix_range(pre)
                    for k in ctx.txn.keys(beg, end):
                        _ns, _db, _tb, _id, _d, ftb, fk = K.decode_graph(k)
                        if ft in kfilt and not kfilt[ft](fk):
                            continue
                        dest = RecordId(ftb, fk)
                        if not _alive(dest):
                            continue
                        out.append(dest)
            else:
                pre = K.graph_dir_prefix(ns, db, rid.tb, rid.id, d)
                beg, end = K.prefix_range(pre)
                for k in ctx.txn.keys(beg, end):
                    _ns, _db, _tb, _id, _d, ftb, fk = K.decode_graph(k)
                    dest = RecordId(ftb, fk)
                    if not _alive(dest):
                        continue
                    out.append(dest)
    return _cond_filter(out, g, ctx)


def _cond_filter(out, g, ctx):
    """Shared WHERE-on-hop filter for edge and reference traversals."""
    if g.cond is None:
        return out
    from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record

    filtered = []
    for dest in out:
        doc = fetch_record(ctx, dest)
        c = ctx.with_doc(doc, dest)
        if is_truthy(evaluate(g.cond, c)):
            filtered.append(dest)
    return filtered


def purge_edges(rid: RecordId, ctx):
    """On record delete: remove its `~` keys, counterpart keys, and any edge
    records attached to it (reference: doc/purge.rs semantics)."""
    ns, db = ctx.need_ns_db()
    pre = K.graph_node_prefix(ns, db, rid.tb, rid.id)
    beg, end = K.prefix_range(pre)
    edges = []
    for k in list(ctx.txn.keys(beg, end)):
        _ns, _db, _tb, _id, d, ft, fk = K.decode_graph(k)
        ctx.txn.delete(k)
        # counterpart key on the destination
        other_dir = K.DIR_IN if d == K.DIR_OUT else K.DIR_OUT
        ctx.txn.delete(K.graph(ns, db, ft, fk, other_dir, rid.tb, rid.id))
        edges.append(RecordId(ft, fk))
    return edges


def find_references(rid: RecordId, ctx, tb=None, ff=None) -> list:
    """record::refs — scan tables for record-link references (brute)."""
    from surrealdb_tpu_torch.kvs.api import deserialize
    from surrealdb_tpu_torch.val import Table

    ns, db = ctx.need_ns_db()
    tables = []
    if tb is not None:
        tables = [tb.name if isinstance(tb, Table) else tb]
    else:
        for _k, tdef in ctx.txn.scan_vals(*K.prefix_range(K.tb_prefix(ns, db))):
            tables.append(tdef.name)
    out = []

    def _references(v):
        if isinstance(v, RecordId):
            return v.tb == rid.tb and K.enc_value(v.id) == K.enc_value(rid.id)
        if isinstance(v, list):
            return any(_references(x) for x in v)
        return False

    for t in tables:
        beg, end = K.prefix_range(K.record_prefix(ns, db, t))
        for k, raw in ctx.txn.scan(beg, end):
            doc = deserialize(raw)
            if not isinstance(doc, dict):
                continue
            if ff is not None:
                if _references(doc.get(ff, NONE)):
                    out.append(doc.get("id"))
            else:
                if any(
                    _references(v) for kk, v in doc.items() if kk != "id"
                ):
                    out.append(doc.get("id"))
    return out
