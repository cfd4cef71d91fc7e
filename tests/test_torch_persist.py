"""The port's persisted state against the reference's: `SKVANN01` graph
artifacts (idx/cagra.py save_index / load_index) and the file-backed KV
engine (kvs/file.py FileBackend), each written by one package and read
by the other; torn and CRC-broken artifacts; crash recovery, conflicts,
ENOSPC read-only mode and recovery as tests/test_mvcc.py and
tests/test_resource.py hold the reference; a `file://` datastore whose
engines reload their whole-store and segment graphs after a reopen; and
the artifact frame's `>I` length cap, which both packages share."""

import os
import pickle
import struct
import sys

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.idx import cagra as rcagra
from surrealdb_tpu.idx import segments as rseg
from surrealdb_tpu.idx.vector import TpuVectorIndex as RefIndex
from surrealdb_tpu.kvs.faults import inject_enospc
from surrealdb_tpu.kvs.file import FileBackend as RefFileBackend
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch.err import SdbError, StorageFullError
from surrealdb_tpu_torch.idx import cagra as pcagra
from surrealdb_tpu_torch.idx import segments as pseg
from surrealdb_tpu_torch.idx.vector import TpuVectorIndex as PortIndex
from surrealdb_tpu_torch.catalog import IndexDef
from surrealdb_tpu_torch.expr.ast import Idiom, PField
from surrealdb_tpu_torch.idx.vector import get_vector_index
from surrealdb_tpu_torch.kvs.api import serialize
from surrealdb_tpu_torch.kvs.ds import Datastore
from surrealdb_tpu_torch.kvs.file import FileBackend
from surrealdb_tpu_torch.val import RecordId

ARRAYS = ("graph", "x8", "arow", "x2", "inv_norms")
DIM = 12


def _rows(n=600, d=DIM, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)).astype(np.float32)
    return centers[rng.integers(0, 12, n)] + 0.2 * rng.normal(
        size=(n, d)).astype(np.float32)


def _same_index(a, b):
    assert (a.metric, a.built_n, a.built_version, a.built_epoch) == \
        (b.metric, b.built_n, b.built_version, b.built_epoch)
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# -- SKVANN01 artifacts -------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_artifact_files_byte_equal_and_cross_readable(tmp_path, metric):
    xs = _rows()
    ann = pcagra.build_index(xs, metric, 7, 2)
    extra = {"dim": DIM, "rows": "digest", "segment": True}
    pp, rp = str(tmp_path / "p.annsnap"), str(tmp_path / "r.annsnap")
    pcagra.save_index(ann, pp, extra=extra)
    rcagra.save_index(ann, rp, extra=extra)
    with open(pp, "rb") as f, open(rp, "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's file
    pa, pmeta = pcagra.load_index(rp)
    ra, rmeta = rcagra.load_index(pp)
    assert pmeta == rmeta and pmeta["rows"] == "digest"
    _same_index(pa, ann)
    _same_index(ra, ann)
    assert pa.build_s == ann.build_s


def _corrupt(path, kind):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if kind == "torn":
        raw = raw[:len(raw) - 9]
    elif kind == "crc":
        raw[-3] ^= 0xFF
    else:
        raw[:8] = b"SKVANN00"
    with open(path, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("kind", ["torn", "crc", "magic"])
def test_corrupt_artifact_rejected_by_both(tmp_path, kind):
    ann = pcagra.build_index(_rows(), "euclidean", 0, 0)
    path = str(tmp_path / "x.annsnap")
    pcagra.save_index(ann, path)
    _corrupt(path, kind)
    for mod in (pcagra, rcagra):
        with pytest.raises(ValueError):
            mod.load_index(path)
    with pytest.raises(OSError):
        pcagra.load_index(str(tmp_path / "absent.annsnap"))


def _engine(cls, snapshot_dir, xs, version=0):
    ix = cls("b", "b", "t", "ix", {"dimension": xs.shape[1],
                                   "distance": "euclidean",
                                   "vector_type": "f32"})
    ix.version = version
    ix.snapshot_dir = snapshot_dir
    with ix.lock, ix.rw.write():
        ix._apply_entries([("set", i, x.tobytes()) for i, x in
                           enumerate(xs)])
    return ix


@pytest.fixture()
def whole_store(monkeypatch):
    """The whole-store graph path in both packages (segments off)."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_ANN_MODE", "force")
        monkeypatch.setattr(c, "KNN_SEG_MODE", "off")
        monkeypatch.setattr(c, "KNN_HOST_BATCH", "host")


@pytest.mark.parametrize("kind", ["torn", "crc"])
def test_engine_removes_a_corrupt_artifact_and_rebuilds(whole_store,
                                                        tmp_path, kind,
                                                        capsys):
    xs = _rows()
    ix = _engine(PortIndex, str(tmp_path), xs)
    assert ix.ensure_ann() and ix.ann_builds == 1
    path = ix._ann_snap_path()
    assert os.path.exists(path)
    _corrupt(path, kind)
    ix2 = _engine(PortIndex, str(tmp_path), xs)
    assert ix2.ensure_ann()
    assert (ix2.ann_builds, ix2.ann_reloads) == (1, 0)
    assert "rejected" in capsys.readouterr().err
    # removed, then written afresh by the rebuild: a third engine loads it
    ix3 = _engine(PortIndex, str(tmp_path), xs)
    assert ix3.ensure_ann()
    assert (ix3.ann_builds, ix3.ann_reloads) == (0, 1)
    _same_index(ix3._ann, ix2._ann)


def test_whole_store_artifact_cross_package(whole_store, tmp_path):
    """The reference's engine saves, the port's reloads with no build
    (same file name, header digest and arrays), and the answers over
    the reloaded graph are the reference's."""
    xs = _rows(900)
    ref = _engine(RefIndex, str(tmp_path), xs)
    assert ref.ensure_ann()
    port = _engine(PortIndex, str(tmp_path), xs)
    assert port._ann_snap_path() == ref._ann_snap_path()
    assert port.ensure_ann()
    assert (port.ann_builds, port.ann_reloads) == (0, 1)
    _same_index(port._ann, ref._ann)
    qs = _rows(5, seed=9)
    assert [[(r.id, d) for r, d in row] for row in port.knn_batch(qs, 8)] \
        == [[(r.id, d) for r, d in row] for row in ref.knn_batch(qs, 8)]
    # a different mutation stamp is a stale artifact: rebuilt
    port2 = _engine(PortIndex, str(tmp_path), xs, version=5)
    assert port2.ensure_ann() and port2.ann_builds == 1


def test_failed_artifact_save_is_harmless(tmp_path, capsys):
    eng = PortIndex("n", "d", "t", "i", {"dimension": 4,
                                         "distance": "euclidean",
                                         "vector_type": "f32"})
    blocker = tmp_path / "block"
    blocker.write_text("not a directory")
    eng.snapshot_dir = str(blocker / "sub")  # mkdir will fail

    class _FakeAnn:
        built_n = 0

    eng._save_ann_snapshot(_FakeAnn(), np.zeros((0, 4), np.float32), [])
    assert "ann snapshot save failed" in capsys.readouterr().err


# -- the file-backed KV engine ------------------------------------------------


def _fill(backend, compact):
    """Commits with overwrites and deletes; `compact` rewrites the
    snapshot midway, so the directory holds a snapshot AND a WAL."""
    for i in range(40):
        w = backend.transaction(write=True)
        w.set(f"k{i:03d}".encode(), bytes([i]) * (i + 1))
        if i % 5 == 4:
            w.delete(f"k{i - 2:03d}".encode())
        w.commit()
        if compact and i == 20:
            backend.compact()
    w = backend.transaction(write=True)
    w.set(b"k001", b"over")
    w.set(b"\x00bin\xff", b"")
    w.commit()


def _items(backend):
    return sorted(backend.vs.latest_items())


@pytest.mark.parametrize("compact", [False, True], ids=["wal", "snapshot"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_file_backend_directory_cross_package(tmp_path, writer, compact):
    """A directory written (and crashed, no close) by one package opens
    in the other with equal items; and after a close (compaction)."""
    path = str(tmp_path / "db")
    wcls, rcls = (RefFileBackend, FileBackend) if writer == "ref" \
        else (FileBackend, RefFileBackend)
    b = wcls(path)
    _fill(b, compact)
    want = _items(b)
    assert len(want) > 20
    b.wal.close()  # a crash: no close()
    other = rcls(path)
    assert _items(other) == want
    r = other.transaction(write=False)
    assert r.get(b"k001") == b"over" and r.get(b"k002") is None
    assert list(r.scan(b"k", b"l")) == [kv for kv in want
                                        if b"k" <= kv[0] < b"l"]
    r.cancel()
    other.close()
    again = wcls(path)
    assert _items(again) == want
    again.close()


def test_file_backend_refuses_foreign_pickles(tmp_path):
    """The restricted unpickler: a snapshot naming a class, or a WAL
    batch of another shape, refuses the directory."""
    path = tmp_path / "db"
    path.mkdir()
    with open(path / "snapshot.bin", "wb") as f:
        pickle.dump({b"k": b"v", b"f": os.getcwd}, f, protocol=5)
    with pytest.raises(SdbError, match="refused"):
        FileBackend(str(path))
    with open(path / "snapshot.bin", "wb") as f:
        pickle.dump({b"k": b"v"}, f, protocol=5)
    with open(path / "wal.bin", "wb") as f:
        pickle.dump({b"a": b"1"}, f, protocol=5)
        pickle.dump([b"not", b"a", b"dict"], f, protocol=5)
    with pytest.raises(SdbError, match="not a dict"):
        FileBackend(str(path))
    with open(path / "wal.bin", "wb") as f:
        pickle.dump({b"a": "str value"}, f, protocol=5)
    with pytest.raises(SdbError, match="refused"):
        FileBackend(str(path))


def test_file_backend_crash_recovery(tmp_path):
    """Kill without close: reopening replays the WAL; a torn tail batch
    is dropped without losing earlier commits."""
    path = str(tmp_path / "db")
    b = FileBackend(path)
    for i in range(10):
        w = b.transaction(write=True)
        w.set(f"k{i}".encode(), str(i).encode())
        w.commit()
    b.wal.close()
    with open(os.path.join(path, "wal.bin"), "ab") as f:
        f.write(pickle.dumps({b"torn": b"x"}, protocol=5)[:7])
    b2 = FileBackend(path)
    r = b2.transaction(write=False)
    for i in range(10):
        assert r.get(f"k{i}".encode()) == str(i).encode()
    assert r.get(b"torn") is None
    r.cancel()
    b2.close()


def test_file_backend_conflict_and_durability(tmp_path):
    path = str(tmp_path / "db")
    b = FileBackend(path)
    t1 = b.transaction(write=True)
    t2 = b.transaction(write=True)
    t1.set(b"k", b"1")
    t2.set(b"k", b"2")
    t1.commit()
    with pytest.raises(SdbError, match="conflict"):
        t2.commit()
    b.close()
    b2 = FileBackend(path)
    r = b2.transaction(write=False)
    assert r.get(b"k") == b"1"
    r.cancel()
    b2.close()


def test_compaction_every_wal_compact_batches(tmp_path, monkeypatch):
    from surrealdb_tpu_torch.kvs import file as pfile

    monkeypatch.setattr(pfile, "WAL_COMPACT_BATCHES", 4)
    path = str(tmp_path / "db")
    b = FileBackend(path)
    for i in range(6):
        w = b.transaction(write=True)
        w.set(b"k%d" % i, b"v")
        w.commit()
    assert b._wal_batches == 2
    assert os.path.getsize(os.path.join(path, "snapshot.bin")) > 0
    b.wal.close()
    assert len(_items(RefFileBackend(path))) == 6


def test_enospc_wal_enters_typed_read_only(tmp_path):
    d = str(tmp_path / "db")
    b = FileBackend(d)
    tx = b.transaction(True)
    tx.set(b"a", b"1")
    tx.commit()
    heal = inject_enospc(b)
    tx = b.transaction(True)
    tx.set(b"c", b"3")
    with pytest.raises(StorageFullError):
        tx.commit()
    assert b.read_only is not None
    # reads keep serving; the refused write is invisible
    tx = b.transaction(False)
    assert tx.get(b"a") == b"1" and tx.get(b"c") is None
    tx.cancel()
    tx = b.transaction(True)
    tx.set(b"d", b"4")
    with pytest.raises(StorageFullError):
        tx.commit()
    heal()
    assert b.try_recover()
    tx = b.transaction(True)
    tx.set(b"e", b"5")
    tx.commit()
    b.close()
    b2 = FileBackend(d)
    tx = b2.transaction(False)
    assert tx.get(b"a") == b"1"
    assert tx.get(b"c") is None and tx.get(b"d") is None
    assert tx.get(b"e") == b"5"
    tx.cancel()
    b2.close()


def test_enospc_snapshot_compaction_read_only(tmp_path):
    b = FileBackend(str(tmp_path / "db"))
    tx = b.transaction(True)
    tx.set(b"a", b"1")
    tx.commit()
    heal = inject_enospc(b, after=0, snapshots=True)
    b._sync_wal = lambda: None
    with pytest.raises(StorageFullError):
        b.compact()
    assert b.read_only is not None
    tx = b.transaction(False)
    assert tx.get(b"a") == b"1"
    tx.cancel()
    heal()
    assert b.try_recover()
    b.close()


# -- a file:// datastore across a restart -------------------------------------


def _ingest(ds, xs, tb="t"):
    """bench.py's _churn_ops shape: a record, `he`, `hl` a row, `vn`."""
    t = ds.transaction(write=True)
    for i, x in enumerate(xs):
        t.set(PK.record("b", "b", tb, i), serialize({"id": RecordId(tb, i)}))
        t.set_val(PK.ix_state("b", "b", tb, "ix", b"he", PK.enc_value(i)),
                  x.tobytes())
        t.set_val(PK.ix_state("b", "b", tb, "ix", b"hl", PK.enc_u64(i + 1)),
                  ("set", i, x.tobytes()))
    t.set_val(PK.ix_state("b", "b", tb, "ix", b"vn"), len(xs))
    t.commit()


IDEF = IndexDef("ix", "t", [Idiom([PField("emb")])], ["emb"],
                hnsw={"dimension": DIM, "distance": "euclidean",
                      "vector_type": "f32"})


def _open(path):
    ds = Datastore(f"file://{path}")
    ctx = ds.context("b", "b")
    ix = get_vector_index(IDEF, ctx)
    ix.sync(ctx)
    ctx.txn.cancel()
    return ds, ix


def test_file_datastore_reloads_whole_store_graph(whole_store, tmp_path):
    path = tmp_path / "db"
    xs = _rows(800)
    qs = _rows(6, seed=8)
    ds = Datastore(f"file://{path}")
    assert ds.ann_snapshot_dir == str(path / ".ann-cache")
    _ingest(ds, xs)
    ds.close()
    ds, ix = _open(path)
    try:
        assert ix.snapshot_dir == ds.ann_snapshot_dir
        assert ix.ensure_ann()
        assert (ix.ann_builds, ix.ann_reloads) == (1, 0)
        before = [[(r.id, d) for r, d in row]
                  for row in ix.knn_batch(qs, 10)]
        built = ix._ann
    finally:
        ds.close()
    ds, ix = _open(path)
    try:
        assert ix.ensure_ann()
        assert (ix.ann_builds, ix.ann_reloads) == (0, 1)
        _same_index(ix._ann, built)
        assert [[(r.id, d) for r, d in row]
                for row in ix.knn_batch(qs, 10)] == before
    finally:
        ds.close()


def test_file_datastore_reloads_segment_graphs(tmp_path, monkeypatch):
    """Segment graphs persist too: after a reopen the drained segments
    load their artifacts, no build runs, and the graphs are the ones
    built before (the first datastore's close stopped its worker)."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_ANN_MODE", "force")
        monkeypatch.setattr(c, "KNN_SEG_MODE", "force")
        monkeypatch.setattr(c, "KNN_SEG_ROWS", 256)
        monkeypatch.setattr(c, "KNN_HOST_BATCH", "host")
    path = tmp_path / "db"
    xs = _rows(900)
    qs = _rows(6, seed=8)
    ds = Datastore(f"file://{path}")
    _ingest(ds, xs)
    ds.close()
    ds, ix = _open(path)
    try:
        assert ix.ensure_ann()
        graphs = [s.graph[0] for s in ix._segs.segs]
        assert len(graphs) >= 1 and ix.ann_plan(10)["ann"] == "segmented"
        before = [[(r.id, d) for r, d in row]
                  for row in ix.knn_batch(qs, 10)]
    finally:
        ds.close()
    assert not ix._segs._maint_running and ix._segs.segs == []
    builds = []
    real = pcagra.build_index

    def counting(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pcagra, "build_index", counting)
    ds, ix = _open(path)
    try:
        assert ix.ensure_ann()
        assert builds == []
        for g, s in zip(graphs, ix._segs.segs):
            _same_index(s.graph[0], g)
        assert [[(r.id, d) for r, d in row]
                for row in ix.knn_batch(qs, 10)] == before
    finally:
        ds.close()


# -- the frame's >I length (a fault of the reference the port copies) ---------


@pytest.fixture()
def capped_frames(monkeypatch):
    """struct.pack refusing an artifact frame LENGTH past a small cap,
    as `>I` refuses one past 4 GiB; the CRC packs are untouched."""
    cap = 4096
    real = struct.pack

    def pack(fmt, *vals):
        caller = sys._getframe(1)
        if (fmt == ">I" and caller.f_code.co_name == "_write_frame"
                and vals[0] == len(caller.f_locals["body"])
                and vals[0] > cap):
            raise struct.error(f"'I' format requires 0 <= number <= {cap}")
        return real(fmt, *vals)

    monkeypatch.setattr(struct, "pack", pack)
    return cap


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_frame_length_cap_fails_the_segment_build(capped_frames, tmp_path,
                                                  monkeypatch, pkg):
    """An array past the cap cannot be saved: save_index raises
    struct.error, which is not an OSError, so the segment path's save
    does not fail gracefully: `_build_ann_for` raises, `_build_segment`
    returns False, and the segment stays pending, served exactly, and
    is built again (and refused again) on every retry. In both
    packages alike."""
    cls, cagra_, seg_mod, c = (
        (RefIndex, rcagra, rseg, rcnf) if pkg == "ref"
        else (PortIndex, pcagra, pseg, pcnf))
    monkeypatch.setattr(c, "KNN_ANN_MODE", "force")
    monkeypatch.setattr(c, "KNN_SEG_MODE", "force")
    monkeypatch.setattr(c, "KNN_SEG_ROWS", 256)
    monkeypatch.setattr(c, "KNN_HOST_BATCH", "host")
    monkeypatch.setattr(seg_mod.SegmentedAnn, "_kick", lambda self: None)
    xs = _rows(600)
    ann = cagra_.build_index(xs, "euclidean", 0, 0)
    with pytest.raises(struct.error) as e:
        cagra_.save_index(ann, str(tmp_path / "big.annsnap"))
    assert not isinstance(e.value, OSError)
    assert not os.listdir(tmp_path)  # the tmp file was removed
    builds = []
    real = cagra_.build_index

    def counting(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cagra_, "build_index", counting)
    ix = _engine(cls, str(tmp_path), xs)
    ix._maybe_maintain()  # the first seal
    qs = _rows(4, seed=5)
    try:
        for retry in (1, 2):
            assert ix.ensure_ann() is False
            assert len(builds) == retry
            st = ix._segments().status()
            assert [s["state"] for s in st["spans"]] == ["pending"]
            got = ix.knn_batch(qs, 7)
            c.KNN_SEG_MODE = "off"
            want = ix.knn_batch(qs, 7)
            c.KNN_SEG_MODE = "force"
            assert [[(r.id, d) for r, d in row] for row in got] == \
                [[(r.id, d) for r, d in row] for row in want]
        assert not [f for f in os.listdir(tmp_path)
                    if f.endswith(".annsnap")]
    finally:
        ix._segments().reset()
