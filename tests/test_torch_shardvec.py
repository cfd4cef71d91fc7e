"""The port's sharded vector router (`idx/shardvec.py` over the part
engines of `idx/vector.py`) against the reference's, and the slice as a
whole through `Datastore("shard://...")`.

Both packages hold the same rows (made from a seed with numpy) on the
same shard layout, each on in-process KV servers of its own, and answer
the same `SELECT id, vector::distance::knn() AS d FROM tbl WHERE emb
<|10|> $q`. The device floor (`KNN_DEVICE_MIN_ROWS`, and each vector
module's `DEVICE_MIN_ROWS`) is lowered in both packages so every part
takes its package's device path: the port's inline supervisor on the
CPU (its runner's plain kernels, `DeviceHost("cpu")`), the reference's
in its own CPU mode.

Tolerance: ids are equal wherever neighbouring distances differ by more
than 1e-4 (near ties may swap), distances agree within atol 1e-4 and
rtol 1e-5. Shard names hold each cluster's own addresses, so names and
error texts compare with every address replaced by its group's index.
"""

import contextlib
import re

import jax
import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.idx import shardvec as RSV
from surrealdb_tpu.idx import vector as RV
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.device import supervisor as portsup
from surrealdb_tpu_torch.device.handlers import DeviceHost as PortHost
from surrealdb_tpu_torch.idx import shardvec as PSV
from surrealdb_tpu_torch.idx import vector as PV
from torch_shard_harness import pkg, sharded_cluster
from torch_sql_harness import norm, same

NS = DB = "b"
MIN_ROWS = 512
ATOL, RTOL = 1e-4, 1e-5
SQL = ("SELECT id, vector::distance::knn() AS d FROM tbl "
       "WHERE emb <|10|> $q")


@pytest.fixture()
def pair(monkeypatch):
    """Each package's inline supervisor (the port's over a recording
    `DeviceHost("cpu")`), the device floor lowered in both."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_DEVICE_MIN_ROWS", MIN_ROWS)
        monkeypatch.setattr(c, "KNN_ANN_MODE", "off")
        monkeypatch.setattr(c, "KNN_SEG_MODE", "off")
        monkeypatch.setattr(c, "KNN_HOST_BATCH", "device")
    for m in (RV, PV):
        monkeypatch.setattr(m, "DEVICE_MIN_ROWS", MIN_ROWS)
    old_r = refsup.set_supervisor(refsup.DeviceSupervisor(mode="inline"))
    sup = portsup.DeviceSupervisor("inline", device="cpu")
    host = PortHost("cpu")
    ops = []
    handle = host.handle

    def recording(op, meta, bufs):
        ops.append(op)
        return handle(op, meta, bufs)

    host.handle = recording
    sup._inline_host = host
    old_p = portsup.set_supervisor(sup)
    try:
        yield ops
    finally:
        refsup.reset_supervisor()
        refsup.set_supervisor(old_r)
        portsup.reset_supervisor()
        portsup.set_supervisor(old_p)


def _hek(name, i, tb="tbl"):
    K = pkg(name, "key")
    return K.ix_state(NS, DB, tb, "ix", b"he", K.enc_value(i))


def _hl(name, tb="tbl"):
    return pkg(name, "key").ix_state(NS, DB, tb, "ix", b"hl")


def _define(ds, dim, tb="tbl"):
    ds.query(f"DEFINE TABLE {tb}; DEFINE INDEX ix ON {tb} FIELDS emb HNSW "
             f"DIMENSION {dim} DIST EUCLIDEAN TYPE F32", ns=NS, db=DB)


def _bulk(name, ds, xs, tb="tbl", chunk=512):
    """bench.py's routing-client ingest: records, index rows and the
    version, `chunk` rows a commit."""
    K = pkg(name, "key")
    serialize = pkg(name, "kvs.api").serialize
    RecordId = pkg(name, "val").RecordId
    n = xs.shape[0]
    for s in range(0, n, chunk):
        txn = ds.transaction(write=True)
        try:
            for i in range(s, min(s + chunk, n)):
                txn.set(K.record(NS, DB, tb, i),
                        serialize({"id": RecordId(tb, i)}))
                txn.set_val(_hek(name, i, tb), xs[i].tobytes())
            txn.set_val(K.ix_state(NS, DB, tb, "ix", b"vn"), min(s + chunk, n))
            txn.commit()
        except BaseException:
            txn.cancel()
            raise


def _answer(res):
    return [(r["id"].id, r["d"]) for r in (res.result or [])]


def _close(pairs_a, pairs_b, what):
    """Ids equal wherever neighbouring distances differ by more than
    ATOL; distances within ATOL + RTOL*|d|."""
    assert len(pairs_a) == len(pairs_b), what
    da = np.array([d for _i, d in pairs_a])
    db = np.array([d for _i, d in pairs_b])
    assert np.all(np.abs(da - db) <= ATOL + RTOL * np.abs(db)), what
    gap = np.diff(da) > ATOL
    sep = np.ones(len(da), bool)
    sep[1:] &= gap
    sep[:-1] &= gap
    ia = np.array([i for i, _d in pairs_a])
    ib = np.array([i for i, _d in pairs_b])
    assert np.array_equal(ia[sep], ib[sep]), what


def _rows(n=4096, dim=64, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.normal(size=(6, dim)).astype(np.float32))


def _anon(text, addrs):
    for g, group in enumerate(addrs):
        for a in group:
            text = text.replace(a, f"<g{g}>")
    return re.sub(r"\b\d+\.\d+s\b", "<s>", text)


@pytest.mark.parametrize("groups", [2, 4])
def test_router_answers_as_the_reference(pair, groups):
    xs, qs = _rows()
    n = xs.shape[0]
    got = {}
    for name in ("ref", "port"):
        cuts = [_hek(name, n * g // groups) for g in range(1, groups)]
        with sharded_cluster(name, cuts) as (_srvs, addrs):
            ds = pkg(name, "kvs.ds").Datastore(f"shard://{addrs[0][0]}")
            try:
                _define(ds, xs.shape[1])
                _bulk(name, ds, xs)
                got[name] = [_answer(ds.execute(SQL, ns=NS, db=DB,
                                                vars={"q": q.tolist()})[-1])
                             for q in qs]
                eng = ds.vector_indexes[(NS, DB, "tbl", "ix")]
                assert len(eng.parts) == groups
                assert all(len(p.engine.rids) >= MIN_ROWS
                           for p in eng.parts)
                info = ds.query("INFO FOR SYSTEM", ns=NS, db=DB)[0]
                got[name + "_info"] = [
                    {k: s[k] for k in ("rows", "version", "range")}
                    for s in info["knn"][0]["shards"]]
                got[name + "_fanout"] = ds.telemetry.get("knn_shard_fanout")
            finally:
                ds.close()
    for i, (a, b) in enumerate(zip(got["port"], got["ref"])):
        assert len(a) == 10
        _close(a, b, f"query {i}")
    assert got["port_info"] == got["ref_info"]
    assert got["port_fanout"] == got["ref_fanout"]
    # every part of the port answered from its runner's store
    assert pair.count("vec_load") == groups
    assert pair.count("vec_knn") == groups * len(qs)


def _four_groups(name):
    """Cuts [he(n/3), he(2n/3), hl): group 1 serves the middle element
    slice alone; the op log and the version key live on group 3."""
    return [_hek(name, 1365), _hek(name, 2730), _hl(name)]


@pytest.mark.parametrize("mode", ["error", "partial"])
def test_stopped_group_names_the_same_shard(pair, monkeypatch, mode):
    """With one group's servers stopped, a fresh serving node (its part
    must rebuild from that group) answers as the reference's: in
    `error` mode KnnShardUnavailable with the reference's message, in
    `partial` mode the healthy parts' answer flagged with the same
    missing shard; the hedge and partial counts are equal."""
    xs, qs = _rows(n=4096, dim=16, seed=5)
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_SHARD_TIMEOUT_S", 0.3)
        monkeypatch.setattr(c, "KNN_PARTIAL", mode)
    got = {}
    for name in ("ref", "port"):
        R = pkg(name, "kvs.remote")
        S = pkg(name, "kvs.shard")
        DS = pkg(name, "kvs.ds").Datastore
        with sharded_cluster(name, _four_groups(name)) as (srvs, addrs):

            def fresh():
                be = S.ShardedBackend(
                    addrs[0][0], op_timeout=0.5, connect_timeout=0.5,
                    policy=R.RetryPolicy(deadline_s=1.0, base_ms=10,
                                         max_ms=50))
                return DS(backend=be)

            ds = fresh()
            _define(ds, xs.shape[1])
            _bulk(name, ds, xs)
            full = _answer(ds.execute(SQL, ns=NS, db=DB,
                                      vars={"q": qs[0].tolist()})[-1])
            ds.close()
            for s in srvs[1]:
                s.shutdown()
                s.server_close()
            ds2 = fresh()
            try:
                res = [ds2.execute(SQL, ns=NS, db=DB,
                                   vars={"q": q.tolist()})[-1]
                       for q in qs[:2]]
                got[name] = {
                    "errors": [None if r.error is None
                               else _anon(r.error, addrs).split(": kv ")[0]
                               for r in res],
                    "partial": [None if r.partial is None else
                                [_anon(m, addrs)
                                 for m in r.partial["missing_shards"]]
                                for r in res],
                    "answers": [_answer(r) for r in res],
                    "hedged": ds2.telemetry.get("knn_hedged_dispatches"),
                    "partials": ds2.telemetry.get("knn_partial_results"),
                    "full": full,
                }
            finally:
                ds2.close()
    p, r = got["port"], got["ref"]
    assert p["errors"] == r["errors"] and p["partial"] == r["partial"]
    assert (p["hedged"], p["partials"]) == (r["hedged"], r["partials"])
    assert p["hedged"] >= 2
    _close(p["full"], r["full"], "before the stop")
    if mode == "error":
        assert all(e.startswith("knn shard(s) unavailable") and "<g1>" in e
                   for e in p["errors"])
        assert p["partials"] == 0
    else:
        assert p["errors"] == [None, None] and p["partials"] == 2
        assert all(m == [p["partial"][0][0]] and "<g1>" in m[0]
                   for m in p["partial"])
        for a, b in zip(p["answers"], r["answers"]):
            _close(a, b, "partial answer")
        # none of the answers comes from the stopped group's slice
        assert all(not 1365 <= i < 2730 for a in p["answers"] for i, _d in a)


def test_split_while_serving_stays_exact(pair):
    """A split through the upper element slice while the router serves:
    the next query re-partitions behind the epoch fence, the moved
    slice rebuilds from KV truth, and the answers stay the reference's."""
    xs, qs = _rows(n=3072, dim=32, seed=11)
    got = {}
    for name in ("ref", "port"):
        serve_kv = pkg(name, "kvs.remote").serve_kv
        split_shard = pkg(name, "kvs.shard").split_shard
        spare = serve_kv("127.0.0.1", 0, block=False, fsync=False)
        try:
            with sharded_cluster(name, [_hek(name, 1536)]) as (_s, addrs):
                ds = pkg(name, "kvs.ds").Datastore(f"shard://{addrs[0][0]}")
                try:
                    _define(ds, xs.shape[1])
                    _bulk(name, ds, xs)
                    before = [_answer(ds.execute(SQL, ns=NS, db=DB, vars={
                        "q": q.tolist()})[-1]) for q in qs]
                    eng = ds.vector_indexes[(NS, DB, "tbl", "ix")]
                    epoch0 = eng.map_epoch
                    split_shard(addrs[0][0], _hek(name, 2304),
                                [f"127.0.0.1:{spare.server_address[1]}"])
                    after = [ds.execute(SQL, ns=NS, db=DB,
                                        vars={"q": q.tolist()})[-1]
                             for q in qs]
                    assert all(r.error is None and r.partial is None
                               for r in after)
                    got[name] = (before, [_answer(r) for r in after],
                                 [len(p.engine.rids) for p in eng.parts])
                    assert eng.map_epoch > epoch0
                finally:
                    ds.close()
        finally:
            spare.shutdown()
            spare.server_close()
    (pb, pa, prows), (rb, ra, rrows) = got["port"], got["ref"]
    assert prows == rrows == [1536, 768, 768]
    for a, b, c in zip(pb, pa, rb):
        assert a == b  # the port's answers did not move across the split
        _close(a, c, "split")
    for a, b in zip(pa, ra):
        _close(a, b, "after the split")


def test_writes_sync_through_the_log_and_the_router_trims_it(pair,
                                                             monkeypatch):
    """SQL writes on both sides of the cut fill the shared op log; the
    parts sync through it (no rebuild) and see the writes; once every
    part has consumed a burst, a write-capable query trims the log, as
    the reference's router does; a fresh node (a gap in the log)
    rebuilds and answers the same."""
    for m in (RSV, PSV):
        monkeypatch.setattr(m, "TRIM_LOG_ENTRIES", 8)
    dim = 8
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(1200, dim)).astype(np.float32)
    q = rng.normal(size=dim).astype(np.float32)
    got = {}
    for name in ("ref", "port"):
        hl = _hl(name)
        with sharded_cluster(name, [_hek(name, 600)]) as (_s, addrs):
            DS = pkg(name, "kvs.ds").Datastore
            ds = DS(f"shard://{addrs[0][0]}")
            try:
                _define(ds, dim)
                _bulk(name, ds, xs)
                first = _answer(ds.execute(SQL, ns=NS, db=DB,
                                           vars={"q": q.tolist()})[-1])
                eng = ds.vector_indexes[(NS, DB, "tbl", "ix")]
                installs = [id(p.engine.vecs) for p in eng.parts]
                for rid, scale in ((7, 0.0), (900, 0.001)):
                    v = (q * (1 + scale)).astype(np.float32)
                    r = ds.execute(f"UPDATE tbl:{rid} SET emb = $v",
                                   ns=NS, db=DB, vars={"v": v.tolist()})[-1]
                    assert r.error is None
                for i in range(1200, 1212):
                    r = ds.execute(f"CREATE tbl:{i} SET emb = $v", ns=NS,
                                   db=DB, vars={"v": xs[i - 1200].tolist()})
                    assert r[-1].error is None
                txn = ds.transaction(False)
                n_log = sum(1 for _ in txn.scan(hl, hl + b"\xff" * 8))
                txn.cancel()
                res = ds.execute(SQL, ns=NS, db=DB,
                                 vars={"q": q.tolist()})[-1]
                synced = [id(p.engine.vecs) for p in eng.parts]
                txn = ds.transaction(False)
                n_after = sum(1 for _ in txn.scan(hl, hl + b"\xff" * 8))
                txn.cancel()
                ds2 = DS(f"shard://{addrs[0][0]}")
                res2 = ds2.execute(SQL, ns=NS, db=DB,
                                   vars={"q": q.tolist()})[-1]
                ds2.close()
                got[name] = (first, _answer(res), _answer(res2), n_log,
                             n_after, installs != synced)
            finally:
                ds.close()
    p, r = got["port"], got["ref"]
    _close(p[0], r[0], "before the writes")
    _close(p[1], r[1], "after the writes")
    _close(p[2], r[2], "a fresh node")
    assert [i for i, _d in p[1][:2]] == [7, 900]
    assert p[3:] == r[3:]
    assert p[3] == 14 and p[1] == p[2]


def test_knn_with_a_condition_answers_as_the_reference(pair):
    xs, qs = _rows(n=2048, dim=16, seed=23)
    sql = ("SELECT id, vector::distance::knn() AS d FROM tbl "
           "WHERE emb <|10|> $q AND g = 1")
    got = {}
    for name in ("ref", "port"):
        with sharded_cluster(name, [_hek(name, 1024)]) as (_s, addrs):
            ds = pkg(name, "kvs.ds").Datastore(f"shard://{addrs[0][0]}")
            try:
                _define(ds, xs.shape[1])
                rows = [{"id": i, "emb": xs[i].tolist(), "g": i % 3}
                        for i in range(xs.shape[0])]
                ds.query("INSERT INTO tbl $rows RETURN NONE", ns=NS, db=DB,
                         vars={"rows": rows})
                got[name] = [_answer(ds.execute(sql, ns=NS, db=DB, vars={
                    "q": q.tolist()})[-1]) for q in qs]
            finally:
                ds.close()
    for a, b in zip(got["port"], got["ref"]):
        assert len(a) == 10 and all(i % 3 == 1 for i, _d in a)
        _close(a, b, "cond")


SLICE_SCRIPT = [
    "DEFINE TABLE n; DEFINE TABLE e TYPE RELATION; DEFINE INDEX ix ON n "
    "FIELDS emb HNSW DIMENSION 8 DIST EUCLIDEAN TYPE F32",
    "INSERT INTO n $rows RETURN NONE",
    "RELATE n:1->e:a->n:700 RETURN NONE; RELATE n:700->e:b->n:3 RETURN NONE; "
    "RELATE n:1->e:c->n:5 RETURN NONE",
    "SELECT id, vector::distance::knn() AS d FROM n WHERE emb <|10|> $q",
    "SELECT VALUE ->e->n FROM ONLY n:1",
    "SELECT VALUE ->e->n->e->n FROM ONLY n:1",
    "UPDATE n:650 SET emb = $q",
    "SELECT id, vector::distance::knn() AS d FROM n WHERE emb <|3|> $q",
    "SELECT id FROM n WHERE emb <|10|> $q EXPLAIN",
    "SELECT count() FROM n GROUP ALL READ AT 30s",
    "SELECT id, vector::distance::knn() AS d FROM n WHERE emb <|5|> $q "
    "READ AT 30s",
    "DELETE n:650",
    "SELECT VALUE id FROM n WHERE emb <|1|> $q",
]


def test_slice_script_through_shard_datastores_matches_reference(pair):
    """The same SurrealQL script through `Datastore("shard://...")` in
    both packages, over groups of a primary and a replica: DDL, writes
    on both sides of the element cut, `<|10|>`, `->e->n`, EXPLAIN's
    `shards`, INFO FOR SYSTEM's `shards` and `knn`, and READ AT served
    by the replicas."""
    rng = np.random.default_rng(29)
    n, dim = 1200, 8
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    q = rng.normal(size=dim).astype(np.float32)
    vars_ = {"rows": [{"id": i, "emb": xs[i].tolist()} for i in range(n)],
             "q": q.tolist()}
    got = {}
    for name in ("ref", "port"):
        K = pkg(name, "key")
        cut = K.ix_state(NS, DB, "n", "ix", b"he", K.enc_value(600))
        with sharded_cluster(name, [cut], members_per_group=2) as (
                srvs, addrs):
            ds = pkg(name, "kvs.ds").Datastore(f"shard://{addrs[0][0]}")
            try:
                out = []
                for sql in SLICE_SCRIPT:
                    res = ds.execute(sql, ns=NS, db=DB, vars=vars_)
                    out.append([("err", r.error) if r.error is not None
                                else ("ok", norm(r.result)) for r in res])
                info = ds.query("INFO FOR SYSTEM", ns=NS, db=DB)[0]
                topo = norm(info["shards"])
                knn = [[{k: s[k] for k in ("rows", "version", "range")}
                        for s in ent["shards"]] for ent in info["knn"]]
                served = ds.telemetry.get("follower_reads_served")
                got[name] = (out, _anon(repr(topo), addrs), knn, served > 0)
            finally:
                ds.close()
    (pout, ptopo, pknn, pserved), (rout, rtopo, rknn, rserved) = \
        got["port"], got["ref"]
    for i, (a, b) in enumerate(zip(pout, rout)):
        if SLICE_SCRIPT[i].startswith("SELECT id, vector::distance"):
            pa = [(row["id"][2], row["d"]) for row in a[0][1]]
            pb = [(row["id"][2], row["d"]) for row in b[0][1]]
            _close(pa, pb, SLICE_SCRIPT[i])
            continue
        same(a, b, f"statement {i}: {SLICE_SCRIPT[i]}")
    assert ptopo == rtopo and pknn == rknn
    assert pserved and rserved
    plan = pout[8][0][1][0]["detail"]["plan"]
    assert plan["shards"] == 2
    assert [r[2] for r in pout[4][0][1]] == [700, 5]
    assert pout[7][0][1][0]["id"][2] == 650
    # n:650 was deleted by the script
    assert len(pknn[0]) == 2 and sum(s["rows"] for s in pknn[0]) == n - 1


def test_sdk_remote_engine_over_a_kv_group():
    """The SDK's `remote://` engine embeds a datastore over the KV
    service, as the reference's does: the same answers through either
    package's SDK against either package's server."""
    from surrealdb_tpu.sdk import connect as rconnect
    from surrealdb_tpu_torch.sdk import connect as pconnect

    got = {}
    for name, connect in (("ref", rconnect), ("port", pconnect)):
        serve_kv = pkg("port" if name == "ref" else "ref",
                       "kvs.remote").serve_kv
        srv = serve_kv("127.0.0.1", 0, block=False, fsync=False)
        try:
            with contextlib.closing(connect(
                    f"remote://127.0.0.1:{srv.server_address[1]}")) as db:
                db.use("t", "t")
                db.create("person:1", {"name": "a"})
                db.query("CREATE person:2 SET name = 'b'")
                got[name] = [r["result"] for r in norm(db.query(
                    "SELECT name FROM person ORDER BY name"))]
        finally:
            srv.shutdown()
            srv.server_close()
    assert got["port"] == got["ref"] == [[{"name": "a"}, {"name": "b"}]]


def test_part_in_mode_require_fails_the_query_not_to_the_host(
        monkeypatch):
    """No fallback hides the card: a part engine whose supervisor is in
    mode `require` and cannot reach its runner fails the query with the
    supervisor's `DeviceRequired`, never a host or partial answer."""
    from surrealdb_tpu_torch.device.supervisor import DeviceRequired
    from surrealdb_tpu_torch.kvs.ds import Datastore

    for name, v in (("KNN_DEVICE_MIN_ROWS", MIN_ROWS), ("KNN_ANN_MODE", "off"),
                    ("KNN_SEG_MODE", "off"), ("KNN_HOST_BATCH", "auto"),
                    ("KNN_PARTIAL", "partial")):
        monkeypatch.setattr(pcnf, name, v)
    monkeypatch.setattr(PV, "DEVICE_MIN_ROWS", MIN_ROWS)
    sup = portsup.DeviceSupervisor("require", device="cpu")

    def unreachable(*_a, **_k):
        raise sup.unavailable("runner died")

    monkeypatch.setattr(sup, "call", unreachable)
    host_calls = []
    monkeypatch.setattr(PV.TpuVectorIndex, "_host_knn_single",
                        lambda *a: host_calls.append(a))
    monkeypatch.setattr(PV.TpuVectorIndex, "_host_knn_multi",
                        lambda *a: host_calls.append(a))
    old = portsup.set_supervisor(sup)
    xs, qs = _rows(n=2048, dim=16, seed=31)
    try:
        with sharded_cluster("port", [_hek("port", 1024)]) as (_s, addrs):
            ds = Datastore(f"shard://{addrs[0][0]}")
            try:
                _define(ds, xs.shape[1])
                _bulk("port", ds, xs)
                res = ds.execute(SQL, ns=NS, db=DB,
                                 vars={"q": qs[0].tolist()})[-1]
                eng = ds.vector_indexes[(NS, DB, "tbl", "ix")]
                assert len(eng.parts) == 2
            finally:
                ds.close()
    finally:
        portsup.set_supervisor(old)
        sup.shutdown()
    assert res.result is None and res.partial is None
    assert res.error == str(sup.unavailable("runner died"))
    assert isinstance(sup.unavailable("x"), DeviceRequired)
    assert host_calls == []


@pytest.mark.parametrize("mode", ["error", "partial"])
def test_unreachable_version_shard_fails_typed(pair, monkeypatch, mode):
    """With the group holding the index's version key stopped, no part
    can prove its freshness: the port answers the typed failure naming
    that shard (`KnnShardUnavailable` in `error` mode; in `partial` mode
    an empty answer flagged with it). This is a repair: the reference's
    failure record for that shard lacks its `span`, so its query ends in
    "Internal error: KeyError: 'span'"."""
    xs, qs = _rows(n=2048, dim=16, seed=41)
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_SHARD_TIMEOUT_S", 0.3)
        monkeypatch.setattr(c, "KNN_PARTIAL", mode)
    got = {}
    for name in ("ref", "port"):
        R = pkg(name, "kvs.remote")
        S = pkg(name, "kvs.shard")
        vn = pkg(name, "key").ix_state(NS, DB, "tbl", "ix", b"vn")
        # group 2 holds the version key alone; both element slices, the
        # catalog and the records stay reachable
        cuts = [_hek(name, 1024), vn, vn + b"\x00"]
        with sharded_cluster(name, cuts) as (srvs, addrs):

            def fresh():
                be = S.ShardedBackend(
                    addrs[0][0], op_timeout=0.5, connect_timeout=0.5,
                    policy=R.RetryPolicy(deadline_s=1.0, base_ms=10,
                                         max_ms=50))
                return pkg(name, "kvs.ds").Datastore(backend=be)

            ds = fresh()
            _define(ds, xs.shape[1])
            _bulk(name, ds, xs)
            ds.close()
            for s in srvs[2]:
                s.shutdown()
                s.server_close()
            ds2 = fresh()
            try:
                r = ds2.execute(SQL, ns=NS, db=DB,
                                vars={"q": qs[0].tolist()})[-1]
                got[name] = (r.error, r.partial, r.result)
            finally:
                ds2.close()
    assert got["ref"][0] == "Internal error: KeyError: 'span'"
    err, partial, result = got["port"]
    if mode == "error":
        assert err.startswith("knn shard(s) unavailable "
                              "(SURREAL_KNN_PARTIAL=error): ")
        assert "@" + addrs[2][0] in err and partial is None
    else:
        assert err is None and result == []
        assert len(partial["missing_shards"]) == 1
        assert partial["missing_shards"][0].endswith("@" + addrs[2][0])
