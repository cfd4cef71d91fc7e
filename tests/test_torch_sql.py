"""The slice as a whole, through SurrealQL: the reference's serving stack
with the port's DeviceHost (device="cpu") plugged under its inline
supervisor answers `<|10|>` KNN, 3-hop graph and brute-scan queries with
the same ids as the same stack over the reference's own DeviceHost.

Plugging the port under the reference's SQL stack happens here only:
the port itself imports nothing of surrealdb_tpu.
"""

import jax
import numpy as np
import pytest

from surrealdb_tpu import Datastore, cnf
from surrealdb_tpu import key as K
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.kvs.api import serialize
from surrealdb_tpu.val import RecordId
from surrealdb_tpu_torch.device.handlers import DeviceHost as PortHost


def _use(host):
    """Install an inline reference supervisor over `host` (None = the
    reference DeviceHost, created on first use)."""
    sup = refsup.DeviceSupervisor(mode="inline")
    sup._inline_host = host
    refsup.set_supervisor(sup)
    return sup


@pytest.fixture()
def port_and_ref(monkeypatch):
    monkeypatch.setattr(cnf, "KNN_ANN_MODE", "off")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    old = refsup.set_supervisor(None)
    yield
    refsup.reset_supervisor()
    refsup.set_supervisor(old)


def _ingest(ds, tb, xs, ix=None, inline_emb=False):
    txn = ds.transaction(write=True)
    try:
        for i in range(xs.shape[0]):
            doc = {"id": RecordId(tb, i)}
            if inline_emb:
                doc["emb"] = xs[i].tolist()
            txn.set(K.record("b", "b", tb, i), serialize(doc))
            if ix is not None:
                txn.set_val(K.ix_state("b", "b", tb, ix, b"he",
                                       K.enc_value(i)), xs[i].tobytes())
        if ix is not None:
            txn.set_val(K.ix_state("b", "b", tb, ix, b"vn"), xs.shape[0])
        txn.commit()
    except BaseException:
        txn.cancel()
        raise


def _recording(host):
    """Note every op the host answers in `host.ops`."""
    host.ops = []
    handle = host.handle

    def rec(op, meta, bufs):
        host.ops.append(op)
        return handle(op, meta, bufs)

    host.handle = rec
    return host


def _ids(rows):
    return [r["id"].id for r in rows]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan"])
def test_knn_query_returns_reference_ids(port_and_ref, metric):
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(20_000, 128)).astype(np.float32)
    qs = rng.normal(size=(3, 128)).astype(np.float32)
    ds = Datastore("memory")
    ds.query(f"DEFINE TABLE tbl; DEFINE INDEX ix ON tbl FIELDS emb HNSW "
             f"DIMENSION 128 DIST {metric.upper()} TYPE F32",
             ns="b", db="b")
    _ingest(ds, "tbl", xs, ix="ix")
    sql = "SELECT id FROM tbl WHERE emb <|10|> $q"
    port = _recording(PortHost("cpu"))
    answers = {}
    for name, host in (("port", port), ("ref", None)):
        _use(host)
        answers[name] = [_ids(ds.query_one(sql, ns="b", db="b",
                                           vars={"q": q.tolist()}))
                         for q in qs]
    ds.close()
    assert answers["port"] == answers["ref"]
    assert all(len(a) == 10 for a in answers["port"])
    # the port's host really served the index
    assert port.ops.count("vec_knn") == 3 and len(port.vec) == 1
    assert next(iter(port.vec.values()))[1].rank_mode == (
        None if metric == "manhattan" else "bf16")


def _csr_hops(ds, mode):
    """3 hops from person:1 through the reference's graph engine
    (graph/csr.py CsrGraph.multi_hop -> the supervisor's csr_hop op)."""
    from surrealdb_tpu.exec.context import Ctx
    from surrealdb_tpu.graph.csr import get_csr
    from surrealdb_tpu.kvs.ds import Session

    txn = ds.transaction(write=False)
    try:
        ctx = Ctx(ds, Session(ns="b", db="b"), txn)
        csr = get_csr(ds, ctx, "person", "knows", "out")
        return sorted(csr.multi_hop([1], 3, mode))
    finally:
        txn.cancel()


def test_graph_and_brute_queries_return_reference_ids(port_and_ref):
    rng = np.random.default_rng(19)
    ds = Datastore("memory")
    ds.query("DEFINE TABLE person; DEFINE TABLE knows TYPE RELATION",
             ns="b", db="b")
    n = 60
    stmts = [f"CREATE person:{i};" for i in range(n)]
    for a in range(n):
        for b in rng.integers(0, n, size=3):
            stmts.append(f"RELATE person:{a}->knows->person:{int(b)};")
    ds.query("".join(stmts), ns="b", db="b")
    xs = rng.normal(size=(5000, 128)).astype(np.float32)
    ds.query("DEFINE TABLE vt", ns="b", db="b")
    _ingest(ds, "vt", xs, inline_emb=True)
    q = rng.normal(size=(128,)).astype(np.float32)
    hop3 = ("SELECT ->knows->person->knows->person->knows->person "
            "FROM ONLY person:1")
    brute = ("SELECT id, vector::similarity::cosine(emb, $q) AS s FROM vt "
             "ORDER BY s DESC LIMIT 10")
    # `<|k|>` over an unindexed field: the planner's brute_knn op
    brute_knn = "SELECT id FROM vt WHERE emb <|10, COSINE|> $q"
    port = _recording(PortHost("cpu"))
    answers = {}
    for name, host in (("port", port), ("ref", None)):
        _use(host)
        answers[name] = (
            ds.query_one(hop3, ns="b", db="b"),
            _csr_hops(ds, "frontier"),
            _csr_hops(ds, "union"),
            _ids(ds.query_one(brute, ns="b", db="b",
                              vars={"q": q.tolist()})),
            _ids(ds.query_one(brute_knn, ns="b", db="b",
                              vars={"q": q.tolist()})),
        )
    ds.close()
    assert answers["port"] == answers["ref"]
    sql_hop3, frontier, union, top10, knn10 = answers["port"]
    # the bag of 3-step walks ends exactly on the 3-hop frontier
    ends = {r.id for r in sql_hop3["->knows"]["->person"]["->knows"][
        "->person"]["->knows"]["->person"]}
    assert ends == set(frontier) and set(frontier) <= set(union)
    assert len(top10) == 10 and knn10 == top10
    # the hops and the brute scan ran on the port's host
    assert {"csr_hop", "brute_knn"} <= set(port.ops) and len(port.csr) == 1


def test_forced_ann_query_returns_reference_ids(port_and_ref, monkeypatch):
    """SURREAL_KNN_ANN=force (whole-store graph, segments off): the
    serving side builds the CAGRA graph and serves `<|10|>` through
    ann_load + ann_search and its exact rescore; the port's host gives
    the reference's ids."""
    monkeypatch.setattr(cnf, "KNN_ANN_MODE", "force")
    monkeypatch.setattr(cnf, "KNN_SEG_MODE", "off")
    rng = np.random.default_rng(41)
    centers = rng.normal(size=(30, 32)).astype(np.float32)
    xs = centers[rng.integers(0, 30, 3000)]
    xs += 0.15 * rng.normal(size=xs.shape).astype(np.float32)
    qs = xs[:4] + 0.075 * rng.normal(size=(4, 32)).astype(np.float32)
    ds = Datastore("memory")
    ds.query("DEFINE TABLE tbl; DEFINE INDEX ix ON tbl FIELDS emb HNSW "
             "DIMENSION 32 DIST COSINE TYPE F32", ns="b", db="b")
    _ingest(ds, "tbl", xs, ix="ix")
    sql = "SELECT id FROM tbl WHERE emb <|10|> $q"
    port = _recording(PortHost("cpu"))
    _use(port)
    ds.query_one(sql, ns="b", db="b", vars={"q": qs[0].tolist()})
    ix = next(iter(ds.vector_indexes.values()))
    assert ix.ensure_ann()
    answers = {}
    for name, host in (("port", port), ("ref", None)):
        _use(host)
        answers[name] = [_ids(ds.query_one(sql, ns="b", db="b",
                                           vars={"q": q.tolist()}))
                         for q in qs]
    ds.close()
    assert answers["port"] == answers["ref"]
    assert all(len(a) == 10 for a in answers["port"])
    # the graph served: the port answered ann_search from its ANN store
    assert port.ops.count("ann_search") == 4 and len(port.ann) == 1
