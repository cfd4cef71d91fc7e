"""The port's segmented ANN (idx/segments.py) against the reference's on
the same op log: every case of tests/test_segments.py, at its sizes
(DIM 12, KNN_SEG_ROWS 256, KNN_SEG_FANOUT 2, exact f64 host scoring).

Each case applies the same op-log entries to a reference engine and a
port engine and holds, after `drain()`, the segment tables equal (lo,
hi, state), every segment's graph, x8, arow and x2 (and row map) equal
byte for byte, the `knn_batch` answers equal (ids and f64 distances)
and the engine-scoped counters equal. The background maintenance
worker is off in both packages for these comparisons (seals run at
sync as always; builds and merges run in `drain()`), so both tables
take the same jobs over the same snapshots; `test_background_worker_*`
runs the worker itself. One case serves the segment descents through
the port's DeviceHost("cpu") plain kernels (per-segment device keys),
one engages segments under `auto` past a patched floor.
"""

import threading

import jax
import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.idx import cagra as rcagra
from surrealdb_tpu.idx import segments as rseg
from surrealdb_tpu.idx.vector import TpuVectorIndex as RefIndex
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.device import supervisor as portsup
from surrealdb_tpu_torch.idx import cagra as pcagra
from surrealdb_tpu_torch.idx import segments as pseg
from surrealdb_tpu_torch.idx.vector import TpuVectorIndex as PortIndex

from test_torch_engine import RTOL, _assert_close

DIM = 12
ARRAYS = ("graph", "x8", "arow", "x2")


def _mk(cls, metric="euclidean"):
    ix = cls("b", "b", "t", "ix", {
        "dimension": DIM, "distance": metric, "vector_type": "f32",
    })
    ix.version = 0
    return ix


def _sets(vecs, start_id):
    return [
        ("set", start_id + i, np.asarray(v, np.float32).tobytes())
        for i, v in enumerate(vecs)
    ]


def _dels(ids):
    return [("del", int(d), None) for d in ids]


def _pairs(res):
    return [[(r.id, d) for r, d in row] for row in res]


def _table(ix):
    return [(s.lo, s.hi, s.state) for s in ix._segments().segs]


def _set_both(monkeypatch, name, value):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, name, value)


class Twin:
    """One engine in each package, fed the same op-log entries."""

    def __init__(self, metric="euclidean"):
        self.ref = _mk(RefIndex, metric)
        self.port = _mk(PortIndex, metric)
        self.both = (self.ref, self.port)

    def apply(self, entries, maintain=True):
        """Apply entries the way sync's log applier does, then run the
        post-sync maintenance hook."""
        for ix in self.both:
            with ix.lock, ix.rw.write():
                ix._apply_entries(entries)
            if maintain:
                ix._maybe_maintain()

    def seal(self):
        """Seal WITHOUT building: exact per-segment serving."""
        for ix in self.both:
            with ix._segments().lock:
                ix._segments()._seal_locked()

    def ensure_ann(self):
        r, p = (ix.ensure_ann() for ix in self.both)
        assert r == p
        return p

    def drain(self):
        r, p = (ix._segments().drain() for ix in self.both)
        assert r == p
        return p

    def brute(self, qs, k):
        """Each package's own exact path with segments disabled."""
        old = rcnf.KNN_SEG_MODE, pcnf.KNN_SEG_MODE
        rcnf.KNN_SEG_MODE = pcnf.KNN_SEG_MODE = "off"
        try:
            return [_pairs(ix.knn_batch(qs, k)) for ix in self.both]
        finally:
            rcnf.KNN_SEG_MODE, pcnf.KNN_SEG_MODE = old

    def answers(self, qs, k):
        """The port's answers, held equal to the reference's."""
        r, p = (_pairs(ix.knn_batch(qs, k)) for ix in self.both)
        assert p == r
        return p

    def same(self, qs=None, ks=(10,), drain=True):
        """Tables, graphs, counters and answers equal across packages."""
        if drain:
            self.drain()
        assert _table(self.port) == _table(self.ref)
        for rs, ps in zip(self.ref._segments().segs,
                          self.port._segments().segs):
            assert (rs.graph is None) == (ps.graph is None)
            if rs.graph is None:
                continue
            (ra, rm), (pa, pm) = rs.graph, ps.graph
            assert pa.built_n == ra.built_n and pa.metric == ra.metric
            for name in ARRAYS:
                a, b = getattr(pa, name), getattr(ra, name)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert (rm is None) == (pm is None)
            if rm is not None:
                assert np.array_equal(pm, rm)
        assert self.port._segments().stats == self.ref._segments().stats
        assert self.port.ann_full_rebuilds == self.ref.ann_full_rebuilds
        if qs is not None:
            for k in ks:
                self.answers(qs, k)

    def close(self):
        for ix in self.both:
            if ix._segs is not None:
                if hasattr(ix._segs, "close"):
                    ix._segs.close()
                else:
                    ix._segs.reset()


@pytest.fixture()
def twin_cnf(monkeypatch):
    """The reference fixture's knobs in both packages, the worker off."""
    _set_both(monkeypatch, "KNN_SEG_MODE", "force")
    _set_both(monkeypatch, "KNN_SEG_ROWS", 256)
    _set_both(monkeypatch, "KNN_SEG_FANOUT", 2)
    _set_both(monkeypatch, "KNN_ANN_MODE", "force")
    # both sides on the exact f64 host ladder
    _set_both(monkeypatch, "KNN_HOST_BATCH", "host")
    for m in (rseg, pseg):
        monkeypatch.setattr(m.SegmentedAnn, "_kick", lambda self: None)
        m.reset_counters()
    yield


@pytest.fixture()
def twin(twin_cnf):
    t = Twin()
    try:
        yield t
    finally:
        t.close()


# -- exact fan-out ----------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_exact_fanout_byte_identical_property(twin, monkeypatch, seed):
    """Random seal points, deletes and a mutable tail with nothing
    built: the fan-out equals the brute oracle and the reference; then
    the drained graphs and answers equal the reference's."""
    rng = np.random.default_rng(seed)
    _set_both(monkeypatch, "KNN_SEG_ROWS", int(rng.integers(64, 400)))
    nid = 0
    for _ in range(int(rng.integers(2, 6))):
        vs = rng.normal(size=(int(rng.integers(80, 500)), DIM))
        twin.apply(_sets(vs, nid), maintain=False)
        nid += len(vs)
        twin.seal()
        if nid > 10:
            dels = rng.integers(0, nid, int(rng.integers(0, 30)))
            twin.apply(_dels(dels), maintain=False)
    st = twin.port._segments().status()
    assert st["segments"] >= 1 and st["ready"] == 0
    qs = rng.normal(size=(6, DIM)).astype(np.float32)
    for k in (1, 7, 23):
        got = twin.answers(qs, k)
        assert got == twin.brute(qs, k)[1], f"k={k} diverged from brute"
    assert _table(twin.port) == _table(twin.ref)
    twin.same(qs, ks=(1, 7, 23))
    assert twin.port._segments().status()["ready"] >= 1


# -- delete-heavy segments ----------------------------------------------------


def test_tombstone_95pct_segment_still_fills_k(twin):
    rng = np.random.default_rng(11)
    vs = rng.normal(size=(1200, DIM))
    twin.apply(_sets(vs, 0))
    assert twin.ensure_ann()
    twin.same()
    st = twin.port._segments().status()
    lo, hi = st["spans"][0]["lo"], st["spans"][0]["hi"]
    ix = twin.port
    live = [ix.rids[r].id for r in range(lo, hi) if ix.valid[r]]
    twin.apply(_dels(live[: int(len(live) * 0.95)]))
    qs = rng.normal(size=(5, DIM)).astype(np.float32)
    k = 10
    got = twin.answers(qs, k)
    assert all(len(g) == k for g in got)
    assert got == twin.brute(qs, k)[1]
    # the staleness rule rebuilds the SEGMENT, compacting its dead rows
    assert twin.ensure_ann()
    twin.same(qs, ks=(k,))
    spans = twin.port._segments().status()["spans"]
    total_graph = sum(s.get("graph_rows", 0) for s in spans)
    assert total_graph <= int(ix.valid.sum()) + int(pcnf.KNN_SEG_ROWS)
    assert pseg.counters()["ann_full_rebuilds"] == 0
    assert twin.port._segments().stats["seg_rebuilds"] >= 1
    assert twin.answers(qs, k) == twin.brute(qs, k)[1]


def test_merge_compacts_tombstones(twin, monkeypatch):
    _set_both(monkeypatch, "KNN_SEG_ROWS", 128)
    rng = np.random.default_rng(7)
    nid = 0
    for _ in range(4):
        twin.apply(_sets(rng.normal(size=(128, DIM)), nid), maintain=False)
        nid += 128
        twin.seal()
    twin.apply(_dels(range(0, nid, 3)), maintain=False)
    assert twin.ensure_ann()
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    twin.same(qs, ks=(1, 10))
    st = twin.port._segments().status()
    assert pseg.counters()["seg_merges"] >= 1
    assert sum(s.get("graph_rows", 0) for s in st["spans"]) == \
        int(twin.port.valid.sum())


# -- seal / merge during queries ----------------------------------------------


def test_seal_merge_during_query_snapshot_consistency(twin, monkeypatch):
    """Port queries racing the whole lifecycle (seal, build, merge,
    splice) answer as the brute oracle at every point; the drained
    state equals the reference's."""
    _set_both(monkeypatch, "KNN_SEG_ROWS", 100)
    rng = np.random.default_rng(23)
    twin.apply(_sets(rng.normal(size=(900, DIM)), 0), maintain=False)
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    want = twin.brute(qs, 8)[1]
    errs = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                got = _pairs(twin.port.knn_batch(qs, 8))
                if got != want:
                    errs.append(got)
                    return
        except Exception as e:  # surfaced below
            errs.append(repr(e))

    t = threading.Thread(target=query_loop, daemon=True)
    t.start()
    try:
        assert twin.port.ensure_ann()
        for _ in range(3):
            twin.port._segments().drain()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert not errs, f"racing query diverged: {errs[:1]}"
    assert twin.ref.ensure_ann()
    for _ in range(3):
        twin.ref._segments().drain()
    twin.same(qs, ks=(8,))
    assert twin.answers(qs, 8) == want


# -- lifecycle details --------------------------------------------------------


def test_adopts_legacy_graph_without_rebuild(twin_cnf, monkeypatch):
    _set_both(monkeypatch, "KNN_SEG_MODE", "off")
    t = Twin()
    try:
        rng = np.random.default_rng(5)
        t.apply(_sets(rng.normal(size=(500, DIM)), 0))
        assert t.ensure_ann()
        legacy = t.port._ann
        assert legacy is not None
        for name in ARRAYS:
            assert getattr(legacy, name).tobytes() == \
                getattr(t.ref._ann, name).tobytes()
        _set_both(monkeypatch, "KNN_SEG_MODE", "force")
        t.apply(_sets(rng.normal(size=(40, DIM)), 500))
        st = t.port._segments().status()
        assert st["segments"] >= 1 and st["spans"][0]["hi"] == 500
        assert t.port._segments().segs[0].graph[0] is legacy  # adopted
        assert t.port._ann is None
        qs = rng.normal(size=(3, DIM)).astype(np.float32)
        assert t.answers(qs, 5) == t.brute(qs, 5)[1]
        t.same(qs, ks=(5,))
    finally:
        t.close()


def test_overwrite_in_sealed_segment_exact_immediately(twin):
    rng = np.random.default_rng(9)
    twin.apply(_sets(rng.normal(size=(600, DIM)), 0))
    assert twin.ensure_ann()
    q = rng.normal(size=DIM).astype(np.float32)
    twin.apply(_sets([q], 77))  # overwrite row 77 to the query
    res = twin.answers(q[None, :], 3)[0]
    assert res[0] == (77, 0.0)
    assert set(twin.port._ann_dirty) == set(twin.ref._ann_dirty) == {77}
    twin.same(q[None, :], ks=(3,))


def test_full_rebuild_counter_counts_legacy_treadmill(twin_cnf,
                                                      monkeypatch):
    _set_both(monkeypatch, "KNN_SEG_MODE", "off")
    t = Twin()
    rng = np.random.default_rng(3)
    t.apply(_sets(rng.normal(size=(400, DIM)), 0), maintain=False)
    assert t.ensure_ann()
    assert pseg.counters()["ann_full_rebuilds"] == 0
    # drift past KNN_ANN_TAIL_FRAC: the next build is a treadmill turn
    t.apply(_sets(rng.normal(size=(200, DIM)), 400), maintain=False)
    assert t.ensure_ann()
    assert pseg.counters()["ann_full_rebuilds"] >= 1
    assert pseg.counters() == rseg.counters()
    assert t.port.ann_full_rebuilds == t.ref.ann_full_rebuilds >= 1
    for name in ARRAYS:
        assert getattr(t.port._ann, name).tobytes() == \
            getattr(t.ref._ann, name).tobytes()


def test_churn_zero_full_rebuilds_segmented(twin, monkeypatch):
    _set_both(monkeypatch, "KNN_SEG_ROWS", 200)
    rng = np.random.default_rng(17)
    nid = 0
    for _ in range(10):
        twin.apply(_sets(rng.normal(size=(150, DIM)), nid))
        nid += 150
        twin.apply(_dels(rng.integers(0, nid, 25)))
        twin.same()
    c = pseg.counters()
    assert c == rseg.counters()
    assert c["seg_seals"] >= 2 and c["seg_builds"] >= 2
    assert c["ann_full_rebuilds"] == 0
    qs = rng.normal(size=(6, DIM)).astype(np.float32)
    got = twin.answers(qs, 10)
    want = twin.brute(qs, 10)[1]
    hits = sum(len({i for i, _ in g} & {i for i, _ in w})
               for g, w in zip(got, want))
    assert hits / (10 * len(qs)) >= 0.95


def test_repack_resets_segments(twin):
    rng = np.random.default_rng(31)
    twin.apply(_sets(rng.normal(size=(700, DIM)), 0))
    assert twin.ensure_ann()
    for ix in twin.both:
        old_gen = ix._segments().gen
        rids = list(ix.rids)
        rows = [ix.vecs[i].copy() for i in range(len(rids))]
        with ix.lock, ix.rw.write():
            ix._install_rows(rids, rows, dict(ix.row_index))
        assert ix._segments().gen > old_gen
        assert ix._segments().status()["segments"] == 0
        ix._maybe_maintain()
    assert twin.ensure_ann()
    qs = rng.normal(size=(3, DIM)).astype(np.float32)
    assert twin.answers(qs, 5) == twin.brute(qs, 5)[1]
    twin.same(qs, ks=(5,))


def test_graph_eviction_degrades_to_exact_and_rebuilds(twin):
    rng = np.random.default_rng(41)
    twin.apply(_sets(rng.normal(size=(600, DIM)), 0))
    assert twin.ensure_ann()
    qs = rng.normal(size=(3, DIM)).astype(np.float32)
    want = twin.brute(qs, 7)[1]
    segs = [ix._segments().segs[0] for ix in twin.both]
    for seg in segs:
        seg.acct.evict()
        assert seg.graph is None and seg.state == "pending"
    assert twin.answers(qs, 7) == want
    assert twin.ensure_ann()
    for seg in segs:
        assert seg.state == "ready" and seg.graph is not None
    assert twin.answers(qs, 7) == want
    twin.same(qs, ks=(7,))


def test_seg_snapshot_persist_reload(twin_cnf, tmp_path, monkeypatch):
    """Per-segment artifacts reload instead of rebuilding, across the
    two packages: a file the reference saved serves the port, and the
    other way round; an overwritten row changes the span's bytes and
    misses the artifact. No job is in flight when build_index is
    patched: the worker is off and nothing was built yet."""
    rng = np.random.default_rng(13)
    vs = rng.normal(size=(500, DIM))
    builds = {"ref": 0, "port": 0}
    for name, mod in (("ref", rcagra), ("port", pcagra)):
        real = mod.build_index

        def counting(*a, _real=real, _name=name, **kw):
            builds[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "build_index", counting)

    def engine(cls, d, rows):
        ix = _mk(cls)
        ix.snapshot_dir = str(d)
        with ix.lock, ix.rw.write():
            ix._apply_entries(_sets(rows, 0))
        ix._maybe_maintain()
        assert ix._segs._maint_running is False
        return ix

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    r1 = engine(RefIndex, tmp_path / "r", vs)
    p1 = engine(PortIndex, tmp_path / "p", vs)
    assert r1.ensure_ann() and p1.ensure_ann()
    assert builds == {"ref": 1, "port": 1}
    rfiles = sorted(f.name for f in (tmp_path / "r").glob("*.annsnap"))
    pfiles = sorted(f.name for f in (tmp_path / "p").glob("*.annsnap"))
    assert rfiles == pfiles and len(pfiles) == 1
    # the same artifact but for the build's wall time in the header
    (ra, rmeta), (pa, pmeta) = (
        pcagra.load_index(str(tmp_path / d / rfiles[0])) for d in "rp")
    rmeta.pop("build_s")
    pmeta.pop("build_s")
    assert rmeta == pmeta
    for name in ARRAYS + ("inv_norms",):
        assert getattr(ra, name).tobytes() == getattr(pa, name).tobytes()
    # each package reloads the OTHER's file: no build
    p2 = engine(PortIndex, tmp_path / "r", vs)
    r2 = engine(RefIndex, tmp_path / "p", vs)
    assert p2.ensure_ann() and r2.ensure_ann()
    assert builds == {"ref": 1, "port": 1}
    for a, b in ((p2, r1), (r2, p1)):
        ga, gb = a._segments().segs[0].graph[0], b._segments().segs[0].graph[0]
        for name in ARRAYS:
            assert getattr(ga, name).tobytes() == getattr(gb, name).tobytes()
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    assert _pairs(p2.knn_batch(qs, 5)) == _pairs(r1.knn_batch(qs, 5))
    # an overwrite invalidates by content
    vs2 = vs.copy()
    vs2[3] += 1.0
    p3 = engine(PortIndex, tmp_path / "r", vs2)
    assert p3.ensure_ann()
    assert builds == {"ref": 1, "port": 2}
    for ix in (r1, p1, p2, r2, p3):
        ix._segs.reset()


def test_explain_surfaces_segmented(twin_cnf, ds):
    """The port's engine reports the segmented route with the
    reference's fan-out shape: fed through its KV write path (its
    `ann_plan` against the reference's), and driven through its SQL
    EXPLAIN with the reference's script, where the plan equals the
    reference's."""
    import json

    from surrealdb_tpu_torch.idx.vector import (
        get_vector_index, vector_index_update,
    )
    from surrealdb_tpu_torch.catalog import IndexDef
    from surrealdb_tpu_torch.expr.ast import Idiom, PField
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.val import NONE, RecordId

    rng = np.random.default_rng(19)
    rows = rng.normal(size=(320, DIM))
    ds.query(
        f"DEFINE TABLE t; DEFINE INDEX ix ON t FIELDS v HNSW "
        f"DIMENSION {DIM} DIST EUCLIDEAN TYPE F32"
    )
    ds.query("".join(
        f"CREATE t:{i} SET v = [{', '.join(f'{x:.4f}' for x in v)}];"
        for i, v in enumerate(rows)
    ))
    q = rng.normal(size=DIM)
    vals = ", ".join(f"{x:.4f}" for x in q)
    sql = f"SELECT id FROM t WHERE v <|5,10|> [{vals}]"
    ds.query(sql)  # engage + seal
    rix = next(iter(ds.vector_indexes.values()))
    assert rix.ensure_ann()
    blob = json.dumps(ds.query(f"EXPLAIN {sql}")[0], default=str)
    assert "segmented" in blob, blob

    pds = Datastore("memory")
    idef = IndexDef("ix", "t", [Idiom([PField("v")])], ["v"],
                    hnsw={"dimension": DIM, "distance": "euclidean",
                          "vector_type": "f32"})
    w = pds.context("b", "b", write=True)
    for i, v in enumerate(rows):
        vec = [float(f"{x:.4f}") for x in v]
        vector_index_update(idef, RecordId("t", i), NONE, {"v": vec}, w)
    w.txn.commit()
    ctx = pds.context("b", "b")
    pix = get_vector_index(idef, ctx)
    qv = [float(f"{x:.4f}") for x in q]
    pix.knn(qv, 5, ctx)  # engage + seal
    try:
        assert pix.ensure_ann()
        assert pix.ann_plan(5) == rix.ann_plan(5)
        assert pix.ann_plan(5)["ann"] == "segmented"
        assert pix.residency()["ann"] == "segmented"
        qs = np.asarray([qv], np.float32)
        assert _pairs(pix.knn_batch(qs, 5)) == _pairs(rix.knn_batch(qs, 5))
    finally:
        pds.close()

    sds = Datastore("memory")
    try:
        sds.query(
            f"DEFINE TABLE t; DEFINE INDEX ix ON t FIELDS v HNSW "
            f"DIMENSION {DIM} DIST EUCLIDEAN TYPE F32"
        )
        sds.query("".join(
            f"CREATE t:{i} SET v = [{', '.join(f'{x:.4f}' for x in v)}];"
            for i, v in enumerate(rows)
        ))
        ids = [[r["id"].id for r in res] for res in sds.query(sql)]
        assert ids == [[r["id"].id for r in res] for res in ds.query(sql)]
        six = next(iter(sds.vector_indexes.values()))
        assert six.ensure_ann()
        pblob = json.dumps(sds.query(f"EXPLAIN {sql}")[0], default=str)
        assert pblob == blob
    finally:
        sds.close()


# -- the port's own paths -----------------------------------------------------


def test_auto_engages_past_the_floor(twin_cnf, monkeypatch):
    """`auto` (the default) engages segments once the store crosses
    KNN_SEG_MIN_ROWS, in both packages alike; below it the whole-store
    graph serves."""
    _set_both(monkeypatch, "KNN_SEG_MODE", "auto")
    _set_both(monkeypatch, "KNN_SEG_MIN_ROWS", 700)
    t = Twin()
    try:
        rng = np.random.default_rng(29)
        t.apply(_sets(rng.normal(size=(600, DIM)), 0))
        assert not t.port._seg_engaged() and not t.ref._seg_engaged()
        assert t.ensure_ann()
        assert t.port.ann_plan(10) == t.ref.ann_plan(10) == {"ann": "graph"}
        t.apply(_sets(rng.normal(size=(300, DIM)), 600))
        assert t.port._seg_engaged() and t.ref._seg_engaged()
        assert t.ensure_ann()
        qs = rng.normal(size=(5, DIM)).astype(np.float32)
        t.same(qs, ks=(1, 10))
        assert t.port.ann_plan(10)["ann"] == "segmented"
        assert t.port.ann_plan(10) == t.ref.ann_plan(10)
        assert t.port._ann is None  # the whole-store graph was adopted
    finally:
        t.close()


@pytest.fixture()
def device_sups(twin_cnf, monkeypatch):
    """Inline supervisors in both packages: the port's over
    DeviceHost("cpu") (its plain kernels), routed to the device."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    _set_both(monkeypatch, "KNN_HOST_BATCH", "device")
    old_r = refsup.set_supervisor(refsup.DeviceSupervisor(mode="inline"))
    old_p = portsup.set_supervisor(
        portsup.DeviceSupervisor("inline", device="cpu"))
    yield portsup.get_supervisor()
    refsup.reset_supervisor()
    refsup.set_supervisor(old_r)
    portsup.reset_supervisor()
    portsup.set_supervisor(old_p)


def test_graph_span_device_branch_per_segment_keys(device_sups,
                                                   monkeypatch):
    """Ready segments serve through the runner's ann_search against
    their own block ("ann/seg-<uuid>", tag [seq, lo, hi]); answers
    match the reference's device path wherever distances separate
    neighbours, no query takes the numpy descent and nothing falls
    back. A rejected descent degrades to the numpy descent, counted."""
    from surrealdb_tpu_torch.device import DeviceOpError

    _set_both(monkeypatch, "KNN_SEG_ROWS", 400)
    t = Twin(metric="cosine")
    try:
        rng = np.random.default_rng(37)
        centers = rng.normal(size=(20, DIM)).astype(np.float32)
        xs = centers[rng.integers(0, 20, 1500)] + 0.15 * rng.normal(
            size=(1500, DIM)).astype(np.float32)
        t.apply(_sets(xs[:1000], 0))
        assert t.ensure_ann()
        t.apply(_sets(xs[1000:], 1000))
        assert t.ensure_ann()
        t.same()
        segs = t.port._segments().segs
        assert len(segs) >= 2 and all(s.state == "ready" for s in segs)
        qs = xs[rng.integers(0, 1500, 8)] + 0.05 * rng.normal(
            size=(8, DIM)).astype(np.float32)
        ref = _pairs(t.ref.knn_batch(qs, 10))
        got = _pairs(t.port.knn_batch(qs, 10))
        _assert_close(ref, got, rtol=RTOL, atol=0.0)
        sup = device_sups
        for s in segs:
            assert s.dev_key.startswith("ann/seg-")
            assert sup._loaded.get(s.dev_key) == [s.seq, s.lo, s.hi]
        assert t.port.ann_host_descents == 0
        assert sup.counters["device_fallbacks"] == 0
        assert sup.counters["device_host_routed"] == 0

        def rejected(*_a, **_kw):
            raise DeviceOpError("rejected")

        monkeypatch.setattr(t.port, "_ann_device_search", rejected)
        _set_both(monkeypatch, "KNN_HOST_BATCH", "host")
        want = _pairs(t.ref.knn_batch(qs, 10))
        _set_both(monkeypatch, "KNN_HOST_BATCH", "device")
        assert _pairs(t.port.knn_batch(qs, 10)) == want
        assert t.port.ann_host_descents == len(segs)
        assert sup.counters["device_fallbacks"] == len(segs)
    finally:
        t.close()


def test_background_worker_churn(monkeypatch):
    """The maintenance worker itself (seal at sync, build / merge on the
    daemon thread) under insert/delete churn in the port: answers stay
    within the graph's recall of brute, no whole-store rebuild, and
    after drain every segment is ready."""
    _set_both(monkeypatch, "KNN_SEG_MODE", "force")
    _set_both(monkeypatch, "KNN_SEG_ROWS", 200)
    _set_both(monkeypatch, "KNN_SEG_FANOUT", 2)
    _set_both(monkeypatch, "KNN_ANN_MODE", "force")
    _set_both(monkeypatch, "KNN_HOST_BATCH", "host")
    pseg.reset_counters()
    ix = _mk(PortIndex)
    rng = np.random.default_rng(43)
    nid = 0
    try:
        for _ in range(8):
            with ix.lock, ix.rw.write():
                ix._apply_entries(_sets(rng.normal(size=(150, DIM)), nid))
            ix._maybe_maintain()
            nid += 150
            with ix.lock, ix.rw.write():
                ix._apply_entries(_dels(rng.integers(0, nid, 25)))
            ix._maybe_maintain()
        assert ix._segments().drain(timeout_s=30)
        st = ix._segments().status()
        assert all(s["state"] in ("ready", "empty") for s in st["spans"])
        assert st["stats"]["seg_builds"] >= 2
        assert ix.ann_full_rebuilds == 0
        qs = rng.normal(size=(6, DIM)).astype(np.float32)
        got = _pairs(ix.knn_batch(qs, 10))
        pcnf.KNN_SEG_MODE = "off"
        want = _pairs(ix.knn_batch(qs, 10))
        pcnf.KNN_SEG_MODE = "force"
        hits = sum(len({i for i, _ in g} & {i for i, _ in w})
                   for g, w in zip(got, want))
        assert hits / 60 >= 0.95
    finally:
        ix._segments().close(timeout_s=30)
    assert not ix._segments()._maint_running


def test_mesh_width_reported_as_device_sharded(twin_cnf, monkeypatch):
    """The runner's reply names the mesh it served on (`mesh_ndev`): the
    engine records it for its ANN blocks (segment descents included)
    and its vector blocks, and `residency()` / `SegmentedAnn.status()`
    report it as `device_sharded`, as the reference's do."""
    monkeypatch.setenv("SURREAL_DEVICE_MESH", "force")
    _set_both(monkeypatch, "KNN_HOST_BATCH", "device")
    old = portsup.set_supervisor(
        portsup.DeviceSupervisor("inline", device="cpu", mesh_devices=4))
    ix = _mk(PortIndex, "cosine")
    flat = _mk(PortIndex, "cosine")
    try:
        rng = np.random.default_rng(47)
        xs = rng.normal(size=(2600, DIM))
        for eng in (ix, flat):
            with eng.lock, eng.rw.write():
                eng._apply_entries(_sets(xs, 0))
        ix._maybe_maintain()
        assert ix.ensure_ann()
        assert "device_sharded" not in ix.residency()
        qs = rng.normal(size=(3, DIM)).astype(np.float32)
        assert [len(r) for r in ix.knn_batch(qs, 5)] == [5, 5, 5]
        assert ix.residency()["device_sharded"] == 4
        assert ix._segs.status()["device_sharded"] == 4
        assert ix.ann_host_descents == 0
        pcnf.KNN_SEG_MODE = pcnf.KNN_ANN_MODE = "off"
        assert [len(r) for r in flat.knn_batch(qs, 5)] == [5, 5, 5]
        assert flat.residency()["device_sharded"] == 4
    finally:
        ix._segments().close()
        portsup.reset_supervisor()
        portsup.set_supervisor(old)
