"""Graph engine: CSR adjacency blocks + device frontier expansion (the
reference package's `graph/csr.py`).

Node -> node adjacency through an edge table is packed once into CSR
arrays, built from the edge table's `~` graph keys (or its records when
it has none); the runner holds them on the card, where a multi-hop
expansion runs `csr_hop_step` once a hop with no host traffic until the
final masks. Concurrent traversals coalesce through a `DeviceBatcher`
into one [B, n] frame per (hops, union) shape.

This module imports neither torch nor CUDA: hops dispatch through the
port's supervisor, and degrade to the equivalent numpy multi-hop
whenever the device is cold, degraded or off (not in mode `require`,
where the device is the contract and a failure raises).
"""

from __future__ import annotations

import threading
import uuid

import numpy as np

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.idx.cagra import pack_csr
from surrealdb_tpu_torch.kvs.api import deserialize
from surrealdb_tpu_torch.val import RecordId


class CsrGraph:
    """node→node adjacency for one (node_tb, edge_tb, direction) pattern."""

    def __init__(self, ns, db, node_tb, edge_tb, direction):
        self.key = (ns, db, node_tb, edge_tb, direction)
        self.version = -1
        self.node_ids: list = []  # idx -> record key (node_tb ids)
        self.node_index: dict = {}  # enc(id) -> idx
        self.rows = np.zeros(0, np.int32)  # [E] source node idx per edge
        self.cols = np.zeros(0, np.int32)  # [E] dest node idx per edge
        self.edge_ids: list = []  # [E] edge record keys (for edge output)
        # device blocks live in the supervised DeviceRunner, addressed
        # by (cache key, [epoch]); build/replay bump the epoch so the
        # runner's copy goes stale and re-ships on the next hop
        self._dev_key = f"csr/{uuid.uuid4().hex[:16]}"
        self._dev_epoch = 0
        self.indptr = None  # host CSR (sorted by row, stable)
        self.sorted_cols = None
        self.lock = threading.RLock()
        self._built = False  # a full build has populated the arrays
        self._batcher = None  # lazy cross-query hop batcher

    def build(self, ctx):
        """Pack the edge table's adjacency into CSR arrays. Primary
        source: the `~` graph keys of the EDGE table — per edge record,
        the DIR_IN key names the source node and the DIR_OUT key the
        destination, so one key scan (no record deserialization, the
        11s-of-CBOR first-query tax the graph bench measured) yields
        the whole edge list. The `~` keys are also the truth the
        per-record traversal walks, so the CSR matches it by
        construction. Edge tables written without graph keys (raw KV
        ingest) fall back to scanning + deserializing the edge docs.
        Reads a FRESH transaction (committed state only) so a cancelled
        writer can never leave phantom edges in this shared cache; a
        transaction's own uncommitted RELATEs become visible to the CSR
        path after commit."""
        ns, db, node_tb, edge_tb, direction = self.key
        ds = ctx.ds
        txn = ds.transaction(write=False)
        ctx = type(ctx)(ds, ctx.session, txn)

        node_ids: list = []
        node_index: dict = {}

        def idx_of(idv):
            h = K.enc_value(idv)
            i = node_index.get(h)
            if i is None:
                i = len(node_ids)
                node_index[h] = i
                node_ids.append(idv)
            return i

        rows, cols, eids = [], [], []

        def idx_enc(h, idv):
            # like idx_of, but keyed by the ALREADY-ENCODED id bytes
            # sliced straight out of the graph key (skips re-encoding
            # every endpoint — ~20% of the old first-query build time)
            i = node_index.get(h)
            if i is None:
                i = len(node_ids)
                node_index[h] = i
                node_ids.append(idv)
            return i

        def add_edge(eid, src, dst):
            erid = RecordId(edge_tb, eid)
            si = idx_enc(*src)
            di = idx_enc(*dst)
            if direction in ("out", "both"):
                rows.append(si)
                cols.append(di)
                eids.append(erid)
            if direction in ("in", "both"):
                rows.append(di)
                cols.append(si)
                eids.append(erid)

        pre = K.graph_tb_prefix(ns, db, edge_tb)
        beg, end = K.prefix_range(pre)
        plen = len(pre)
        pend_key = pend = None  # DIR_IN half awaiting its DIR_OUT twin
        saw_keys = False
        ftb_enc = K.enc_str(node_tb)
        _IN, _OUT = K.DIR_IN, K.DIR_OUT
        # self-table relations (node_tb == edge_tb) mix NODE adjacency
        # keys into the edge table's `~` prefix: a node's own IN/OUT
        # keys would pair as a phantom edge. Only the doc scan can tell
        # records apart there (edges carry in/out fields, nodes don't).
        key_iter = () if edge_tb == node_tb else ctx.txn.keys(beg, end)
        for k in key_iter:
            saw_keys = True
            if pend_key is not None:
                # fast path: the DIR_OUT twin shares the IN key's edge-id
                # span — one slice compare instead of re-decoding the id
                pos = plen + len(pend_key)
                if (k[plen:pos] == pend_key and k[pos:pos + 1] == _OUT
                        and k[pos + 1:pos + 1 + len(ftb_enc)] == ftb_enc):
                    p2 = pos + 1 + len(ftb_enc)
                    fk, q = K.dec_value(k, p2)
                    add_edge(pend[0], pend[1],
                             (bytes(k[p2:q]), fk))
                    pend_key = pend = None
                    continue
            eid, pos = K.dec_value(k, plen)
            d = k[pos:pos + 1]
            ftb, p2 = K.dec_str(k, pos + 1)
            if ftb != node_tb:
                # either endpoint in another table (the doc build skips
                # those edges too), or this edge record participating as
                # a NODE of some other relation — not this CSR's edge.
                # pend survives: such keys can interleave between an
                # edge's IN and OUT twins (sorted by dir, then ft), and
                # a stale pend can never mis-pair — the OUT twin must
                # match the pend's exact edge-id span.
                continue
            fk, q = K.dec_value(k, p2)
            ekey = bytes(k[plen:pos])
            if d == _IN:
                pend_key, pend = ekey, (eid, (bytes(k[p2:q]), fk))
            elif d == _OUT and pend_key == ekey:
                add_edge(pend[0], pend[1], (bytes(k[p2:q]), fk))
                pend_key = pend = None
        if not saw_keys:
            # no graph keys at all: edges were written straight into the
            # KV (bulk ingest) — read in/out from the records themselves
            beg, end = K.prefix_range(K.record_prefix(ns, db, edge_tb))
            for _k, raw in ctx.txn.scan(beg, end):
                doc = deserialize(raw)
                if not isinstance(doc, dict):
                    continue
                l = doc.get("in")
                r = doc.get("out")
                if not (isinstance(l, RecordId)
                        and isinstance(r, RecordId)):
                    continue
                if l.tb != node_tb or r.tb != node_tb:
                    continue
                if direction in ("out", "both"):
                    rows.append(idx_of(l.id))
                    cols.append(idx_of(r.id))
                    eids.append(doc.get("id"))
                if direction in ("in", "both"):
                    rows.append(idx_of(r.id))
                    cols.append(idx_of(l.id))
                    eids.append(doc.get("id"))
        txn.cancel()
        self.node_ids = node_ids
        self.node_index = node_index
        self.rows = np.asarray(rows, np.int32)
        self.cols = np.asarray(cols, np.int32)
        self.edge_ids = eids
        self._dev_epoch += 1
        self.indptr = None
        self.sorted_cols = None
        self._node_rids = None  # node identity changed: drop the rid cache
        self._built = True

    def n_nodes(self) -> int:
        return len(self.node_ids)

    def _ensure_host(self):
        """Host CSR: rows stable-sorted so each row's destinations keep
        edge-scan (= edge-key) order — the order the per-record `~`-key
        walk produces."""
        if self.indptr is None:
            self.indptr, self.sorted_cols, _ = pack_csr(
                self.rows, self.cols, len(self.node_ids)
            )

    def _idx_of(self, idv):
        h = K.enc_value(idv)
        i = self.node_index.get(h)
        if i is None:
            i = len(self.node_ids)
            self.node_index[h] = i
            self.node_ids.append(idv)
            if getattr(self, "_node_rids", None) is not None:
                self._node_rids.append(RecordId(self.key[2], idv))
        return i

    def replay(self, ops) -> bool:
        """Apply committed edge-op deltas (("add", edge_id, in_id,
        out_id)) instead of rescanning the edge table — the vector
        index's op-log sync pattern. Only appends are replayable; any
        other op returns False and the caller full-rebuilds. Derived
        structures (host sort, device blocks, rid cache lengths) refresh
        lazily; the numpy re-sort is orders of magnitude cheaper than
        re-deserializing every edge record from the KV."""
        node_tb = self.key[2]
        edge_tb = self.key[3]
        direction = self.key[4]
        new_rows, new_cols, new_eids = [], [], []
        for op in ops:
            if not (isinstance(op, tuple) and op[0] == "add"):
                return False
            _tag, eid, in_tb, in_id, out_tb, out_id = op
            if in_tb != node_tb or out_tb != node_tb:
                # an edge whose endpoints live in other tables is
                # invisible to THIS CSR — exactly build()'s filter
                continue
            erid = RecordId(edge_tb, eid)
            if direction in ("out", "both"):
                new_rows.append(self._idx_of(in_id))
                new_cols.append(self._idx_of(out_id))
                new_eids.append(erid)
            if direction in ("in", "both"):
                new_rows.append(self._idx_of(out_id))
                new_cols.append(self._idx_of(in_id))
                new_eids.append(erid)
        if not new_rows:
            return True
        self.rows = np.concatenate(
            [self.rows, np.asarray(new_rows, np.int32)]
        )
        self.cols = np.concatenate(
            [self.cols, np.asarray(new_cols, np.int32)]
        )
        self.edge_ids.extend(new_eids)
        self._dev_epoch += 1
        self.indptr = None
        self.sorted_cols = None
        return True

    def hop_bag_idx(self, start_keys: list, hops: int):
        """`hops` consecutive `->edge->node` pair hops with BAG semantics,
        entirely in index space — frontiers never materialize id values
        between hops. Returns a numpy array of node indexes."""
        with self.lock:
            self._ensure_host()
            fr = []
            for idv in start_keys:
                i = self.node_index.get(K.enc_value(idv))
                if i is not None:
                    fr.append(i)
            fr = np.asarray(fr, np.int64)
            for _ in range(hops):
                if not len(fr):
                    break
                if len(fr) == 1:
                    i = int(fr[0])
                    fr = self.sorted_cols[
                        self.indptr[i]:self.indptr[i + 1]
                    ].astype(np.int64, copy=False)
                    continue
                # vectorized multi-source gather: repeat each source's
                # slice via cumulative offsets (no per-vertex Python loop)
                starts = self.indptr[fr]
                ends = self.indptr[fr + 1]
                counts = (ends - starts).astype(np.int64)
                total = int(counts.sum())
                if total == 0:
                    fr = fr[:0]
                    continue
                # index trick: positions 0..total-1 mapped to per-source
                # offsets
                offs = np.repeat(starts, counts)
                base = np.repeat(np.cumsum(counts) - counts, counts)
                pos = np.arange(total, dtype=np.int64) - base + offs
                fr = self.sorted_cols[pos].astype(np.int64, copy=False)
            return fr

    def materialize_rids(self, idxs, node_tb: str) -> list:
        """Node indexes -> RecordId list via a once-built shared cache
        (RecordIds are immutable: handing out the same objects is safe
        and skips per-row construction)."""
        with self.lock:
            rids = getattr(self, "_node_rids", None)
            if rids is None or len(rids) != len(self.node_ids):
                rids = self._node_rids = [
                    RecordId(node_tb, v) for v in self.node_ids
                ]
        if hasattr(idxs, "tolist"):
            idxs = idxs.tolist()  # bulk int conversion beats per-element
        return [rids[j] for j in idxs]

    def hop_bag(self, start_keys: list) -> list:
        """One `->edge->node` pair hop with BAG semantics (duplicates and
        per-source order preserved) — the host fast path for plain chain
        traversals; frontiers are numpy gathers instead of per-record KV
        scans. Runs under the graph lock: a
        concurrent rebuild reassigns these arrays."""
        with self.lock:
            self._ensure_host()
            parts = []
            for idv in start_keys:
                i = self.node_index.get(K.enc_value(idv))
                if i is not None:
                    parts.append(
                        self.sorted_cols[self.indptr[i]:self.indptr[i + 1]]
                    )
            if not parts:
                return []
            cat = np.concatenate(parts) if len(parts) > 1 else parts[0]
            ids = self.node_ids
            return [ids[int(j)] for j in cat]

    def multi_hop(self, start_keys: list, hops: int, collect_mode="frontier"):
        """Expand `hops` steps from the start nodes — on device through
        the supervisor when it's serving, else the equivalent numpy
        multi-hop (byte-identical results either way).

        collect_mode 'frontier': nodes reachable in exactly `hops` steps
        (frontier semantics, revisits allowed through the visited mask);
        'union': all nodes reached in 1..hops steps.
        Returns a list of node keys."""
        n = self.n_nodes()
        if n == 0 or not len(self.rows):
            return []
        start = np.zeros(n, dtype=bool)
        found_any = False
        for idv in start_keys:
            i = self.node_index.get(K.enc_value(idv))
            if i is not None:
                start[i] = True
                found_any = True
        if not found_any:
            return []
        union = collect_mode == "union"
        mask = self._hop_batched(start, hops, union)
        return [self.node_ids[i] for i in np.nonzero(mask)[0]]

    def _hop_batched(self, start, hops: int, union: bool):
        """Run one hop expansion through the cross-query batcher:
        concurrent traversals coalesce into one stacked-mask device
        call per (hops, union) shape; device trouble degrades each
        rider individually to the numpy multi-hop."""
        b = self._batcher
        if b is None:
            from surrealdb_tpu_torch.device import (
                DeviceOpError, DeviceUnavailable,
            )
            from surrealdb_tpu_torch.device.batcher import DeviceBatcher

            b = DeviceBatcher(
                dispatch=self._hop_dispatch,
                fallback=self._hop_fallback,
                retryable=(DeviceUnavailable, DeviceOpError),
            )
            self._batcher = b
        return b.submit((start, hops, union))

    def _hop_dispatch(self, payloads):
        """Batched hop expansion via the supervised runner: riders with
        the same (hops, union) shape share ONE [B, n] kernel call.
        Raises DeviceUnavailable/DeviceOpError for the batcher's
        per-rider host degrade."""
        from surrealdb_tpu_torch.device import get_supervisor

        sup = get_supervisor()
        if not sup.fast_path():
            raise sup.unavailable(f"device {sup.state}")
        tag = [int(self._dev_epoch)]

        def loader():
            return "csr_load", {"n_nodes": self.n_nodes()}, [
                np.ascontiguousarray(self.rows),
                np.ascontiguousarray(self.cols),
            ]

        groups: dict = {}
        for i, (start, hops, union) in enumerate(payloads):
            # mask length rides the group key: a rider that built its
            # mask against an older CSR epoch (concurrent rebuild) must
            # not shape-break its batchmates' np.stack — it dispatches
            # alone and fails (or degrades) on its own
            groups.setdefault(
                (int(hops), bool(union), len(start)), []
            ).append(i)
        out = [None] * len(payloads)
        for (hops, union, _nlen), idxs in groups.items():
            stacked = np.stack(
                [payloads[i][0] for i in idxs]
            ).astype(np.uint8)
            for _attempt in (0, 1):
                sup.ensure_loaded(self._dev_key, tag, loader)
                t, _meta, bufs = sup.call(
                    "csr_hop",
                    {"key": self._dev_key, "tag": tag,
                     "hops": hops, "union": union},
                    [stacked],
                )
                if t == "stale":
                    sup.forget(self._dev_key)
                    continue
                break
            else:
                # two stale rounds: give up on the device for this
                # batch (SdbError in require mode — surfaces loudly)
                raise sup.unavailable("csr cache thrashing")
            masks = bufs[0].astype(bool)
            if masks.ndim == 1:
                masks = masks[None, :]
            for j, i in enumerate(idxs):
                out[i] = masks[j]
        return out

    def _hop_fallback(self, payload):
        """Per-rider degrade: count one fallback per query (the old
        single-dispatch accounting) and answer from the numpy path."""
        from surrealdb_tpu_torch.device import get_supervisor

        get_supervisor().note_fallback()
        return self._host_multi_hop(*payload)

    def _host_multi_hop(self, start, hops: int, union: bool):
        """Numpy fallback with the device kernel's exact semantics:
        per hop, destination mask = scatter-or of cols where the source
        row is in the frontier."""
        rows, cols = self.rows, self.cols
        frontier = start
        acc = np.zeros_like(start) if union else None
        for _ in range(hops):
            nxt = np.zeros_like(frontier)
            if len(rows):
                nxt[cols[frontier[rows]]] = True
            frontier = nxt
            if union:
                acc |= nxt
            elif not frontier.any():
                break
        return acc if union else frontier


def peek_csr(ds, ns, db, node_tb, edge_tb, direction):
    """The cached CSR WITHOUT building (None if never built)."""
    if ds.graph_engine is None:
        return None
    return ds.graph_engine.get((ns, db, node_tb, edge_tb, direction))


def oplog_push(ds, gk, version: int, ops):
    """Record one committed transaction's edge ops for `gk` at `version`
    (ops None = unreplayable change). A None entry would poison every
    later slice window anyway, so it simply CLEARS the log — plain-table
    writes (which always push None) therefore never accumulate anything.
    Bounded: overflow trims the oldest entries, re-creating the
    full-rebuild gap naturally."""
    log = getattr(ds, "_edge_oplog", None)
    if log is None:
        log = ds._edge_oplog = {}
    if ops is None:
        log[gk] = []
        totals = getattr(ds, "_edge_oplog_totals", None)
        if totals is not None:
            totals[gk] = 0
        return
    lst = log.setdefault(gk, [])
    lst.append((version, ops))
    totals = getattr(ds, "_edge_oplog_totals", None)
    if totals is None:
        totals = ds._edge_oplog_totals = {}
    total = totals.get(gk, 0) + len(ops)
    while len(lst) > 1 and total > 100_000:
        _v, o = lst.pop(0)
        total -= len(o)
    totals[gk] = total


def oplog_slice(ds, gk, from_ver: int, to_ver: int):
    """All ops for versions (from_ver, to_ver], or None when the log has
    gaps or unreplayable entries in that window."""
    log = getattr(ds, "_edge_oplog", {}).get(gk)
    if not log:
        return None
    out = []
    seen = set()
    for v, ops in log:
        if from_ver < v <= to_ver:
            if ops is None:
                return None
            seen.add(v)
            out.extend(ops)
    if len(seen) != to_ver - from_ver:
        return None  # a version in the window left no ops (trimmed/gap)
    return out


def get_csr(ds, ctx, node_tb, edge_tb, direction) -> CsrGraph:
    """Datastore-cached CSR; rebuilt when the edge table changes (tracked
    via a bump counter on writes — device blocks are a cache over KV)."""
    ns, db = ctx.need_ns_db()
    if ds.graph_engine is None:
        ds.graph_engine = {}
    key = (ns, db, node_tb, edge_tb, direction)
    g = ds.graph_engine.get(key)
    if g is None:
        g = CsrGraph(ns, db, node_tb, edge_tb, direction)
        ds.graph_engine[key] = g
    ver = ds.graph_versions.get((ns, db, edge_tb), 0)
    with g.lock:
        if g.version != ver:
            ops = (
                oplog_slice(ds, (ns, db, edge_tb), g.version, ver)
                if g._built and ver > g.version else None
            )
            if ops is None or not g.replay(ops):
                g.build(ctx)
            g.version = ver
    return g
