"""The port's TpuVectorIndex against the reference's on the same KV
bytes (carried across with `datastore_from_items`): the exact host
ladder and the BLAS host path bit for bit, the device path through each
package's inline host (the port's DeviceHost on the CPU), the int8
store's candidates rescored in f64, op-log sync, and the forced ANN
overlay with dirty rows and tombstones."""

import threading

import jax
import numpy as np
import pytest

from surrealdb_tpu import Datastore as RefDatastore
from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu import key as RK
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.exec.context import Ctx as RefCtx
from surrealdb_tpu.idx.vector import TpuVectorIndex as RefIndex
from surrealdb_tpu.kvs.api import serialize as ref_serialize
from surrealdb_tpu.kvs.ds import Session as RefSession
from surrealdb_tpu.val import RecordId as RefRid
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch.catalog import IndexDef
from surrealdb_tpu_torch.carry import datastore_from_items
from surrealdb_tpu_torch.device import DeviceOpError
from surrealdb_tpu_torch.device import supervisor as portsup
from surrealdb_tpu_torch.idx.vector import TpuVectorIndex as PortIndex
from surrealdb_tpu_torch.idx.vector import get_vector_index
from surrealdb_tpu_torch.expr.ast import Idiom, PField
from surrealdb_tpu_torch.kvs.api import serialize
from surrealdb_tpu_torch.val import RecordId

# f32 distances through the two device paths
ATOL, RTOL = 1e-4, 1e-5


def _items(ds):
    t = ds.transaction(write=False)
    try:
        return list(t.scan(b"", b"\xff" * 9))
    finally:
        t.cancel()


@pytest.fixture()
def sups(monkeypatch):
    """Inline supervisors in both packages (the port's over
    DeviceHost("cpu")), the ANN and segment paths off, host routing."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_ANN_MODE", "off")
        monkeypatch.setattr(c, "KNN_SEG_MODE", "off")
        monkeypatch.setattr(c, "KNN_HOST_BATCH", "host")
    old_r = refsup.set_supervisor(refsup.DeviceSupervisor(mode="inline"))
    old_p = portsup.set_supervisor(
        portsup.DeviceSupervisor("inline", device="cpu"))
    yield
    refsup.reset_supervisor()
    refsup.set_supervisor(old_r)
    portsup.reset_supervisor()
    portsup.set_supervisor(old_p)


def _route(monkeypatch, mode):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_HOST_BATCH", mode)


class Pair:
    """One index over the same KV bytes in both packages."""

    def __init__(self, xs, ids=None, metric="cosine", vt="f32"):
        ids = list(range(len(xs))) if ids is None else ids
        self.rds = RefDatastore("memory")
        t = self.rds.transaction(write=True)
        for i, idv in enumerate(ids):
            t.set(RK.record("b", "b", "t", idv),
                  ref_serialize({"id": RefRid("t", idv)}))
            t.set_val(RK.ix_state("b", "b", "t", "ix", b"he",
                                  RK.enc_value(idv)), xs[i].tobytes())
        t.set_val(RK.ix_state("b", "b", "t", "ix", b"vn"), len(ids))
        t.commit()
        self.pds = datastore_from_items(_items(self.rds))
        self.params = {"dimension": xs.shape[1], "distance": metric,
                       "vector_type": vt}
        self.ref = RefIndex("b", "b", "t", "ix", self.params)
        self.port = PortIndex("b", "b", "t", "ix", self.params)
        self.ver = len(ids)
        self.sync()

    def ctxs(self, write=False):
        return (RefCtx(self.rds, RefSession("b", "b"),
                       self.rds.transaction(write=write)),
                self.pds.context("b", "b", write=write))

    def sync(self, write=False):
        rc, pc = self.ctxs(write)
        self.ref.sync(rc)
        self.port.sync(pc)
        for c in (rc.txn, pc.txn):
            c.commit() if write else c.cancel()

    def ops(self, adds=(), dels=(), ops=None, drop_log=()):
        """Commit one op-log batch to both datastores the way the write
        path does (record, `he`, `hl`, `vn`); `ops` is a list of
        ("set", id, vec) / ("del", id) in order; `drop_log` removes
        those versions' log entries (a trimmed log)."""
        ops = list(ops or []) + [("set", i, v) for i, v in adds] + \
            [("del", i) for i in dels]
        for ds, K, ser, mk in ((self.rds, RK, ref_serialize, RefRid),
                               (self.pds, PK, serialize, RecordId)):
            t = ds.transaction(write=True)
            ver = self.ver
            for op in ops:
                ver += 1
                idv = op[1]
                he = K.ix_state("b", "b", "t", "ix", b"he", K.enc_value(idv))
                hl = K.ix_state("b", "b", "t", "ix", b"hl", K.enc_u64(ver))
                if op[0] == "set":
                    t.set(K.record("b", "b", "t", idv),
                          ser({"id": mk("t", idv)}))
                    t.set_val(he, op[2].tobytes())
                    t.set_val(hl, ("set", idv, op[2].tobytes()))
                else:
                    t.delete(K.record("b", "b", "t", idv))
                    t.delete(he)
                    t.set_val(hl, ("del", idv, None))
                if ver - self.ver in drop_log:
                    t.delete(hl)
            t.set_val(K.ix_state("b", "b", "t", "ix", b"vn"), ver)
            t.commit()
        self.ver += len(ops)

    def same_state(self):
        r, p = self.ref, self.port
        assert p.version == r.version
        assert [x.id for x in p.rids] == [x.id for x in r.rids]
        assert p.vecs.dtype == r.vecs.dtype
        np.testing.assert_array_equal(p.vecs, r.vecs)
        np.testing.assert_array_equal(p.valid, r.valid)
        assert p.row_index == r.row_index
        assert p._ann_dirty.keys() == r._ann_dirty.keys()


def _pairs(res):
    return [[(r.id, d) for r, d in row] for row in res]


def _assert_close(ref, got, rtol=RTOL, atol=ATOL):
    """Ids equal wherever the reference's neighbouring distances differ
    by more than the tolerance; distances within it."""
    assert [len(r) for r in ref] == [len(g) for g in got]
    for rrow, grow in zip(ref, got):
        rd = np.array([d for _i, d in rrow])
        gd = np.array([d for _i, d in grow])
        np.testing.assert_allclose(gd, rd, rtol=rtol, atol=atol)
        tol = atol + rtol * np.abs(rd)
        gap = np.diff(rd) > tol[1:]
        sep = np.ones(len(rd), bool)
        sep[1:] &= gap
        sep[:-1] &= gap
        for j in np.nonzero(sep)[0]:
            assert grow[j][0] == rrow[j][0], (j, rrow[j], grow[j])


EXACT_METRICS = ["euclidean", "cosine", "dot", "manhattan", "chebyshev",
                 "hamming", ("minkowski", 3.0), "pearson", "jaccard"]


@pytest.mark.parametrize("vt", ["f32", "f64"])
@pytest.mark.parametrize("metric", EXACT_METRICS, ids=str)
def test_host_exact_ladder_below_2048_rows_bit_equal(sups, metric, vt):
    rng = np.random.default_rng(11)
    dt = np.float32 if vt == "f32" else np.float64
    xs = rng.normal(size=(600, 12)).astype(dt)
    if metric in ("hamming", "jaccard"):
        xs = np.abs(np.round(xs * 2)).astype(dt)
    qs = xs[:5] + 0.1 * rng.normal(size=(5, 12)).astype(dt)
    p = Pair(xs, metric=metric, vt=vt)
    p.same_state()
    assert _pairs(p.port.knn_batch(qs, 7)) == _pairs(p.ref.knn_batch(qs, 7))
    rc, pc = p.ctxs()
    got = p.port.knn(qs[0].tolist(), 9, pc)
    assert _pairs([got]) == _pairs([p.ref.knn(qs[0].tolist(), 9, rc)])


@pytest.mark.parametrize("vt", ["f32", "f64"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_host_blas_path_bit_equal(sups, metric, vt):
    rng = np.random.default_rng(12)
    dt = np.float32 if vt == "f32" else np.float64
    xs = rng.normal(size=(3000, 16)).astype(dt)
    qs = rng.normal(size=(6, 16)).astype(dt)
    p = Pair(xs, metric=metric, vt=vt)
    for b in (1, 6):
        assert _pairs(p.port.knn_batch(qs[:b], 10)) == \
            _pairs(p.ref.knn_batch(qs[:b], 10))
    # tombstones enter the BLAS path's invalid list
    p.ops(dels=[3, 17, 2999])
    p.sync()
    p.same_state()
    assert _pairs(p.port.knn_batch(qs, 12)) == _pairs(p.ref.knn_batch(qs, 12))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_device_path_matches_reference(sups, monkeypatch, metric):
    _route(monkeypatch, "device")
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(5, 32)).astype(np.float32)
    p = Pair(xs, metric=metric)
    ref, got = p.ref.knn_batch(qs, 10), p.port.knn_batch(qs, 10)
    assert p.port.rank_mode == p.ref.rank_mode == "bf16"
    _assert_close(_pairs(ref), _pairs(got))
    rc, pc = p.ctxs()
    _assert_close(_pairs([p.ref.knn(qs[1].tolist(), 10, rc)]),
                  _pairs([p.port.knn(qs[1].tolist(), 10, pc)]))
    st = portsup.get_supervisor().counters
    assert st["device_fallbacks"] == 0 and st["device_host_routed"] == 0


def test_int8_candidates_rescored_bit_equal(sups, monkeypatch):
    """The int8 store (forced by a small hbm_budget, N = 40k, kc = 64):
    the runner answers candidates, which each engine rescores exactly
    in f64 from its host rows."""
    _route(monkeypatch, "device")
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_HBM_BUDGET_BYTES", 1 << 20)
        monkeypatch.setattr(c, "KNN_INT8_OVERSAMPLE", 4)
    rng = np.random.default_rng(14)
    xs = rng.normal(size=(40_000, 32)).astype(np.float32)
    qs = rng.normal(size=(4, 32)).astype(np.float32)
    p = Pair(xs, metric="cosine")
    ref, got = p.ref.knn_batch(qs, 16), p.port.knn_batch(qs, 16)
    assert p.port.rank_mode == p.ref.rank_mode == "int8"
    r, g = _pairs(ref), _pairs(got)
    assert [[d for _i, d in row] for row in g] == \
        [[d for _i, d in row] for row in r]
    _assert_close(r, g, rtol=0.0, atol=0.0)


def test_oplog_sync_matches_reference(sups):
    rng = np.random.default_rng(15)
    d = 8

    def vec():
        return rng.normal(size=d).astype(np.float32)

    xs = rng.normal(size=(400, d)).astype(np.float32)
    qs = rng.normal(size=(4, d)).astype(np.float32)
    p = Pair(xs, metric="euclidean")

    def check():
        p.sync()
        p.same_state()
        assert _pairs(p.port.knn_batch(qs, 10)) == \
            _pairs(p.ref.knn_batch(qs, 10))

    p.ops(adds=[(400, vec()), ("s1", vec()), ([1, "a"], vec())])  # append
    check()
    p.ops(adds=[(5, vec()), ("s1", vec())])                        # overwrite
    check()
    p.ops(dels=[7, 8, "s1"])                                       # delete
    check()
    p.ops(ops=[("set", "tmp", vec()), ("del", "tmp")])             # create, delete
    check()
    p.ops(ops=[("set", "n2", vec()), ("set", "n2", vec())])        # overwrite an append
    check()
    assert "n2" in [x.id for x in p.port.rids] and \
        "tmp" in [x.id for x in p.port.rids]
    p.ops(adds=[(401, vec()), (402, vec())], drop_log=(1,))        # a gap
    p.sync(write=True)  # rebuild, trimming the log as the reference does
    p.same_state()
    # the same KV after the trim (the reference's catalog history keys,
    # carried across inert, aside)
    assert [kv for kv in _items(p.pds) if not kv[0].startswith(b"/%")] == \
        [kv for kv in _items(p.rds) if not kv[0].startswith(b"/%")]
    check()
    p.ops(dels=list(range(10, 150)))                               # fragmentation
    check()
    assert p.port.valid.all() and len(p.port.rids) == len(p.ref.rids)


def test_ann_overlay_matches_reference(sups, monkeypatch):
    """The forced ANN overlay (KNN_ANN_MODE=force, segments off): both
    builds byte-equal, then overwritten rows, tombstones and an appended
    tail merged by the exact re-rank: through the device descent and
    through the numpy descent."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_ANN_MODE", "force")
    rng = np.random.default_rng(16)
    n, d = 3000, 16
    centers = rng.normal(size=(30, d)).astype(np.float32)
    xs = centers[rng.integers(0, 30, n)] + 0.15 * rng.normal(
        size=(n, d)).astype(np.float32)
    qs = xs[rng.integers(0, n, 6)] + 0.05 * rng.normal(
        size=(6, d)).astype(np.float32)
    p = Pair(xs, metric="cosine")
    assert p.ref.ensure_ann() and p.port.ensure_ann()
    for name in ("graph", "x8", "arow", "x2", "inv_norms"):
        np.testing.assert_array_equal(getattr(p.port._ann, name),
                                      getattr(p.ref._ann, name))
    assert p.port.ann_plan(10) == p.ref.ann_plan(10) == {"ann": "graph"}
    p.ops(adds=[(int(i), rng.normal(size=d).astype(np.float32))
                for i in rng.choice(n, 20, replace=False)]
          + [(n + i, xs[i] + 0.01) for i in range(30)],
          dels=[int(i) for i in rng.choice(n, 20, replace=False)])
    p.sync()
    p.same_state()
    assert p.port._ann is not None and len(p.port._ann_dirty) > 0
    _route(monkeypatch, "host")
    host = _pairs(p.ref.knn_batch(qs, 10))
    assert _pairs(p.port.knn_batch(qs, 10)) == host
    assert p.port.ann_host_descents == 1
    _route(monkeypatch, "device")
    _assert_close(_pairs(p.ref.knn_batch(qs, 10)),
                  _pairs(p.port.knn_batch(qs, 10)), rtol=RTOL, atol=0.0)
    assert p.port.ann_host_descents == 1
    # a descent the runner rejects degrades to the numpy descent and
    # counts as a device fallback
    st = portsup.get_supervisor().counters
    assert st["device_fallbacks"] == 0

    def rejected(*_a):
        raise DeviceOpError("rejected")

    monkeypatch.setattr(p.port, "_ann_device_search", rejected)
    assert _pairs(p.port.knn_batch(qs, 10)) == host
    assert p.port.ann_host_descents == 2 and st["device_fallbacks"] == 1


def test_coalesced_knn_equals_batched(sups, monkeypatch):
    _route(monkeypatch, "device")
    rng = np.random.default_rng(17)
    xs = rng.normal(size=(3000, 16)).astype(np.float32)
    qs = rng.normal(size=(32, 16)).astype(np.float32)
    p = Pair(xs, metric="cosine")
    want = _pairs(p.port.knn_batch(qs, 10))
    got, errors = [None] * len(qs), []

    def client(t):
        try:
            _rc, pc = p.ctxs()
            for i in range(t, len(qs), 8):
                got[i] = _pairs([p.port.knn(qs[i].tolist(), 10, pc)])[0]
        except Exception as e:  # collected, then checked
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors
    # riders coalesce into frames of other sizes: f32 sums may differ in
    # the last bits
    _assert_close(want, got)


def test_paths_left_out_raise(sups, monkeypatch):
    rng = np.random.default_rng(18)
    xs = rng.normal(size=(300, 8)).astype(np.float32)
    p = Pair(xs, metric="cosine")
    rc, pc = p.ctxs()
    # segmented ANN is ported: `auto` past the floor engages segments,
    # and ensure_ann() drains them (the first seal's graph built)
    monkeypatch.setattr(pcnf, "KNN_SEG_MODE", "auto")
    monkeypatch.setattr(pcnf, "KNN_ANN_MODE", "auto")
    monkeypatch.setattr(pcnf, "KNN_SEG_MIN_ROWS", 100)
    monkeypatch.setattr(pcnf, "KNN_SEG_ROWS", 128)
    try:
        assert p.port._seg_engaged()
        assert p.port.ensure_ann()
        st = p.port._segments().status()
        assert (st["segments"], st["ready"], st["tail_rows"]) == (1, 1, 0)
        p.ops(adds=[(300, xs[0])])
        _rc, pc2 = p.ctxs()
        p.port.sync(pc2)
        assert p.port.ann_plan(3) == {"ann": "segmented", "segments": 1,
                                      "ready": 1, "tail_rows": 1}
        assert p.port.ensure_ann()
        pc2.txn.cancel()
    finally:
        p.port._segments().close()
    idef = IndexDef("ix", "t", [Idiom([PField("v")])], ["v"],
                    hnsw=p.params)
    eng = get_vector_index(idef, pc)
    assert get_vector_index(idef, pc) is eng
    assert p.pds.vector_indexes[("b", "b", "t", "ix")] is eng
