"""The port's SurrealQL stack against the reference's: the same script,
with the same numpy-seeded `$q` vectors, runs through the reference's
`Datastore("memory")` (an inline reference supervisor on the CPU) and
the port's (`DeviceSupervisor("inline", device="cpu")`), and the two
give the same results and hold the same KV items.

Tolerance: results are normalised to plain Python (a `RecordId` becomes
`("rid", tb, id)`, a datetime its epoch nanoseconds, a catalog
definition its class name and fields) and floats compare with atol 1e-4,
rtol 1e-5; everything else, error texts included, compares exactly.
KV items compare key for key; values byte for byte, except values
written by pickle (catalog definitions and index op-log tuples name
their package's classes), which compare decoded and normalised. Two key
families hold the wall clock of the write in their last 8 bytes, the
catalog history (`/%` + the catalog key + time) and a record's version
history (`/*ns*db*tb%id` + time): both compare without those 8 bytes,
in the order of the writes, values as above.

Device kernels: `KNN_DEVICE_MIN_ROWS` is lowered in both packages (and
the engines' `DEVICE_MIN_ROWS`), so small stores take the device path
of each package's inline host: the bf16 rank store for cosine and
euclidean, the exact store for manhattan, the int8 store under a small
`KNN_HBM_BUDGET_BYTES`, and the graph-ANN overlay under
`KNN_ANN_MODE=force`.
"""

import time

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.idx import vector as RV
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.idx import vector as PV
from torch_sql_harness import (  # noqa: F401  (both is a fixture)
    ATOL,
    DB,
    DIM,
    NS,
    RTOL,
    both,
)


def _vectors(n, dim=DIM, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


def _fill(both, tb, xs, extra=True):
    rows = [{"id": i, "emb": xs[i].tolist(), "n": i, "g": i % 3}
            if extra else {"id": i, "emb": xs[i].tolist()}
            for i in range(xs.shape[0])]
    both.ok(f"INSERT INTO {tb} $rows RETURN NONE", {"rows": rows})


def _define_hnsw(both, tb, dist, dim=DIM):
    both.ok(f"DEFINE TABLE {tb}; DEFINE INDEX ix ON {tb} FIELDS emb HNSW "
            f"DIMENSION {dim} DIST {dist} TYPE F32")


def _ids(res):
    return [r["id"].id for r in res]


# -- KNN through each store ----------------------------------------------------

STORES = {
    "bf16-cosine": ("COSINE", {}),
    "bf16-euclidean": ("EUCLIDEAN", {}),
    "exact-manhattan": ("MANHATTAN", {}),
    "int8": ("COSINE", {"KNN_HBM_BUDGET_BYTES": 1024}),
    "ann": ("COSINE", {"KNN_ANN_MODE": "force"}),
}


@pytest.mark.parametrize("store", list(STORES))
def test_knn_forms_on_each_store(both, monkeypatch, store):
    dist, knobs = STORES[store]
    for name, v in knobs.items():
        for c in (rcnf, pcnf):
            monkeypatch.setattr(c, name, v)
    n = 400 if store == "ann" else 300
    xs = _vectors(n)
    _define_hnsw(both, "v", dist)
    _fill(both, "v", xs)
    qs = _vectors(4, seed=9)
    if store == "ann":
        # the graph builds in the background: build it now in both
        both.ok("SELECT id FROM v WHERE emb <|1|> $q", {"q": qs[0].tolist()})
        for ds in (both.ref, both.port):
            assert ds.vector_indexes[(NS, DB, "v", "ix")].ensure_ann()
    for q in qs:
        vars = {"q": q.tolist()}
        res = both.ok("SELECT id, vector::distance::knn() AS d FROM v "
                      "WHERE emb <|5|> $q; "
                      "SELECT id FROM v WHERE emb <|5,40|> $q; "
                      "SELECT VALUE id FROM v WHERE emb <|3|> $q; "
                      f"SELECT id FROM v WHERE emb <|4,{dist}|> $q", vars)
        assert len(res[0]) == 5 and len(res[2]) == 3 and len(res[3]) == 4
    # the port's queries reached its device host
    assert ("ann_search" if store == "ann" else "vec_knn") in both.ops
    both.same_items()


def test_brute_knn_and_order_by_scan(both):
    """`<|k,DIST|>` on a table with no index (fused_brute_knn through the
    batcher past the device floor) and the `vector::similarity::*`
    ORDER BY ... LIMIT scan."""
    xs = _vectors(200)
    both.ok("DEFINE TABLE b")
    _fill(both, "b", xs)
    for q in _vectors(3, seed=11):
        vars = {"q": q.tolist()}
        both.ok("SELECT id, vector::distance::knn() AS d FROM b "
                "WHERE emb <|5,COSINE|> $q; "
                "SELECT id FROM b WHERE emb <|4,EUCLIDEAN|> $q; "
                "SELECT id FROM b WHERE emb <|4,MANHATTAN|> $q AND g = 1; "
                "SELECT id, vector::similarity::cosine(emb, $q) AS s FROM b "
                "ORDER BY s DESC LIMIT 5; "
                "SELECT id, vector::distance::euclidean(emb, $q) AS s "
                "FROM b ORDER BY s LIMIT 3", vars)
    assert "brute_knn" in both.ops


def test_knn_with_cond(both):
    xs = _vectors(300)
    _define_hnsw(both, "c", "COSINE")
    _fill(both, "c", xs)
    for q in _vectors(3, seed=21):
        vars = {"q": q.tolist()}
        res = both.ok(
            "SELECT id, vector::distance::knn() AS d FROM c "
            "WHERE emb <|5|> $q AND n >= 150; "
            # one row in 50 passes: the first 64 candidates rarely hold 5
            # of them, so the loop refills
            "SELECT id FROM c WHERE emb <|5|> $q AND n % 50 = 0; "
            "SELECT id FROM c WHERE emb <|4,40|> $q AND g = 2 AND n < 200",
            vars)
        assert all(i >= 150 for i in _ids(res[0]))
        assert len(res[1]) == 5 and all(i % 50 == 0 for i in _ids(res[1]))


def test_knn_cond_at_engine_level(both):
    """The port's `TpuVectorIndex.knn` with a `cond` against the
    reference's, over the same catalog and rows: the refill loop gives
    the same ids."""
    from surrealdb_tpu.exec.context import Ctx as RCtx
    from surrealdb_tpu.kvs.ds import Session as RSession
    from surrealdb_tpu.syn import parse as rparse
    from surrealdb_tpu_torch.syn import parse as pparse

    xs = _vectors(300)
    _define_hnsw(both, "e", "EUCLIDEAN")
    _fill(both, "e", xs)
    rcond = rparse("RETURN n % 40 = 1")[0].what
    pcond = pparse("RETURN n % 40 = 1")[0].what
    rtx = both.ref.transaction(write=False)
    rctx = RCtx(both.ref, RSession(NS, DB, auth_level="owner"), rtx)
    pctx = both.port.context(NS, DB)
    try:
        from surrealdb_tpu.exec.document import get_indexes as rgi
        from surrealdb_tpu_torch.exec.document import get_indexes as pgi

        reng = RV.get_vector_index(rgi("e", rctx)[0], rctx)
        peng = PV.get_vector_index(pgi("e", pctx)[0], pctx)
        for q in _vectors(3, seed=4):
            r = reng.knn(q.tolist(), 6, rctx, cond=rcond, cond_ctx=rctx)
            p = peng.knn(q.tolist(), 6, pctx, cond=pcond, cond_ctx=pctx)
            assert [x[0].id for x in r] == [x[0].id for x in p]
            assert all(x[0].id % 40 == 1 for x in p) and len(p) == 6
            np.testing.assert_allclose([x[1] for x in p], [x[1] for x in r],
                                       atol=ATOL, rtol=RTOL)
    finally:
        rtx.cancel()
        pctx.txn.cancel()


def test_vector_functions(both):
    a, b = [1.0, 2.0, 3.0], [4.0, -5.0, 6.5]
    fns = ["add", "subtract", "multiply", "divide", "cross", "dot",
           "angle", "project", "distance::euclidean", "distance::manhattan",
           "distance::chebyshev", "distance::hamming",
           "similarity::cosine", "similarity::jaccard",
           "similarity::pearson", "similarity::spearman"]
    sql = "; ".join(f"RETURN vector::{f}($a, $b)" for f in fns)
    sql += ("; RETURN vector::magnitude($a); RETURN vector::normalize($b)"
            "; RETURN vector::scale($a, 2.5)"
            "; RETURN vector::distance::minkowski($a, $b, 3)"
            "; RETURN vector::add($a, [1])")
    both.run(sql, {"a": a, "b": b})


def test_functions_and_selects(both):
    both.ok("CREATE p:1 SET name = 'Ann', age = 31, tags = ['a', 'b'], "
            "score = 1.5; "
            "CREATE p:2 SET name = 'bob', age = 25, tags = ['b'], score = 2; "
            "CREATE p:3 SET name = 'Cid', age = 40, tags = [], score = 0.25, "
            "boss = p:1; "
            "CREATE p:4 SET name = 'dee', age = 25, boss = p:2")
    both.run(
        "SELECT * FROM p ORDER BY age DESC, name; "
        "SELECT name FROM p WHERE age > 24 AND 'b' IN tags LIMIT 1 START 1; "
        "SELECT age, count() AS n, math::sum(score) AS s FROM p GROUP BY age; "
        "SELECT count() FROM p GROUP ALL; "
        "SELECT VALUE name FROM p ORDER BY name; "
        "SELECT * FROM ONLY p:1; "
        "SELECT name, boss.name AS bn FROM p WHERE boss; "
        "SELECT * FROM p:3 FETCH boss; "
        "SELECT math::max(age) AS m, array::group(tags) AS t FROM p GROUP ALL; "
        "RETURN [math::mean([1, 2, 4]), math::floor(2.7), math::pow(2, 10), "
        "math::sqrt(16), math::abs(-3), math::round(2.5), math::fixed(3.14159, 2), "
        "math::median([3, 1, 2]), math::stddev([1, 2, 3, 4])]; "
        "RETURN [array::len([1, 2]), array::distinct([1, 1, 2]), "
        "array::sort([3, 1, 2]), array::reverse([1, 2]), array::flatten([[1], [2]]), "
        "array::union([1], [2]), array::first([5, 6]), array::slice([1, 2, 3], 1)]; "
        "RETURN [string::uppercase('ab'), string::split('a,b', ','), "
        "string::len('abc'), string::concat('a', 'b'), string::trim(' a '), "
        "string::replace('aab', 'a', 'c'), string::slug('Hello World')]; "
        "RETURN [type::string(5), type::int('7'), type::float('1.5'), "
        "type::is::string('a'), type::thing('p', 9), type::table('p'), "
        "type::number('3')]; "
        "RETURN [time::year(d'2024-02-03T04:05:06Z'), "
        "time::format(d'2024-02-03T04:05:06Z', '%Y-%m-%d'), "
        "time::floor(d'2024-02-03T04:05:06Z', 1h), 1h30m + 30m, "
        "duration::secs(2m)]; "
        "RETURN count([1, 2, 3]); RETURN <int> '12'; RETURN 1 + 2 * 3; "
        "RETURN u'0189eee5-2b6e-7000-8000-000000000000'; "
        "RETURN {a: 1, b: [1, 2]}.b[1]; RETURN [1, 2, 3][WHERE $this > 1]; "
        "RETURN 10dec / 4; RETURN <set> [1, 1, 2]; RETURN 1..4")


def test_writes_then_reads(both):
    both.ok("DEFINE TABLE w SCHEMAFULL; DEFINE FIELD name ON w TYPE string; "
            "DEFINE FIELD n ON w TYPE int DEFAULT 0; "
            "DEFINE INDEX wn ON w FIELDS n; DEFINE INDEX wu ON w FIELDS name UNIQUE")
    both.run(
        "CREATE w:1 SET name = 'a', n = 1; CREATE w:2 SET name = 'b'; "
        "CREATE w:3 SET name = 'a'; "
        "INSERT INTO w [{id: 4, name: 'd', n: 4}, {id: 5, name: 'e', n: 5}]; "
        "UPDATE w:2 SET n += 10 RETURN AFTER; "
        "UPDATE w SET n = n * 2 WHERE n > 3 RETURN DIFF; "
        "UPSERT w:6 SET name = 'f', n = 6 RETURN BEFORE; "
        "UPSERT w:6 MERGE {n: 7}; "
        "DELETE w:1 RETURN BEFORE; DELETE w WHERE n = 7; "
        "CREATE w:7 SET name = 1; "
        "SELECT * FROM w WHERE n = 20; SELECT * FROM w WHERE name = 'e'; "
        "SELECT * FROM w ORDER BY id")
    both.same_items()


def test_define_index_over_existing_rows(both):
    xs = _vectors(120)
    both.ok("DEFINE TABLE x")
    _fill(both, "x", xs)
    both.ok(f"DEFINE INDEX ix ON x FIELDS emb HNSW DIMENSION {DIM} "
            f"DIST EUCLIDEAN TYPE F32; DEFINE INDEX xn ON x FIELDS g")
    both.same_items()
    q = {"q": xs[7].tolist()}
    res = both.ok("SELECT id FROM x WHERE emb <|3|> $q; "
                  "SELECT count() FROM x WHERE g = 1 GROUP ALL", q)
    assert res[0][0]["id"].id == 7
    # a concurrent build runs on a thread of its own in each package
    both.ok("DEFINE TABLE y")
    _fill(both, "y", xs[:80])
    both.ok(f"DEFINE INDEX iy ON y FIELDS emb HNSW DIMENSION {DIM} "
            f"DIST COSINE TYPE F32 CONCURRENTLY")
    for ds in (both.ref, both.port):
        key = (NS, DB, "y", "iy")
        deadline = time.monotonic() + 30
        while ds.index_builds.get(key, {}).get("status") != "ready":
            assert time.monotonic() < deadline, ds.index_builds.get(key)
            time.sleep(0.01)
    both.ok("SELECT id FROM y WHERE emb <|3|> $q", q)
    both.same_items()
    both.run("REMOVE INDEX xn ON x; REMOVE FIELD emb ON x; "
             "SELECT count() FROM x WHERE g = 1 GROUP ALL; REMOVE TABLE y; "
             "SELECT * FROM y; REMOVE INDEX nope ON x")
    both.same_items()


def test_graph_idioms(both):
    both.ok("DEFINE TABLE knows TYPE RELATION IN person OUT person")
    sql = ["CREATE person:%d SET name = 'p%d'" % (i, i) for i in range(8)]
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (3, 5), (4, 6), (5, 7),
             (2, 5), (6, 0)]
    sql += ["RELATE person:%d->knows:%d->person:%d SET w = %d"
            % (a, i, b, a + b) for i, (a, b) in enumerate(edges)]
    both.ok("; ".join(sql))
    both.run(
        "SELECT VALUE ->knows->person->knows->person->knows->person "
        "FROM person:0; "
        "SELECT ->knows->person AS out, <-knows<-person AS inn FROM person:3; "
        "SELECT VALUE <->knows<->person FROM person:2; "
        "SELECT VALUE ->(SELECT out, w FROM knows WHERE w > 4) FROM person:3; "
        "SELECT ->knows[WHERE w > 5]->person.name AS n FROM person:3; "
        "SELECT count(->knows) AS c FROM person ORDER BY c DESC, id; "
        "SELECT * FROM knows WHERE in = person:0 ORDER BY out; "
        "RELATE person:9->knows:99->person:1")
    both.ok("DELETE person:3")
    both.run("SELECT VALUE ->knows->person FROM person:1; "
             "SELECT VALUE ->knows->person->knows->person FROM person:0")
    both.same_items()


def test_graph_bag_hop_over_csr(both, monkeypatch):
    """The 3-hop chain past the CSR threshold: both packages build the
    host CSR from the `~` keys and walk it."""
    import surrealdb_tpu.graph as RG
    import surrealdb_tpu_torch.graph as PG

    for g in (RG, PG):
        monkeypatch.setattr(g, "TPU_FRONTIER_THRESHOLD", 4)
    rng = np.random.default_rng(3)
    n, deg = 60, 4
    both.ok("; ".join(f"CREATE person:{i}" for i in range(n)))
    rel = []
    for a in range(n):
        for j, b in enumerate(rng.choice(n, size=deg, replace=False)):
            rel.append(f"RELATE person:{a}->knows:{a * deg + j}"
                       f"->person:{int(b)}")
    both.ok("; ".join(rel))
    for src in (0, 5):
        both.ok("SELECT VALUE ->knows->person->knows->person->knows->person "
                f"FROM person:{src}")


def test_transactions_and_control_flow(both):
    both.run(
        "BEGIN; CREATE a:1 SET v = 1; CREATE a:2 SET v = 2; COMMIT; "
        "BEGIN; CREATE a:3; THROW 'nope'; CREATE a:4; COMMIT; "
        "BEGIN; CREATE a:5; CANCEL; "
        "SELECT * FROM a ORDER BY id; "
        "LET $x = 3; IF $x > 2 { RETURN 'big' } ELSE { RETURN 'small' }; "
        "FOR $i IN [1, 2, 3] { CREATE b SET i = $i, id = $i }; "
        "SELECT VALUE i FROM b ORDER BY i; "
        "RETURN (SELECT VALUE v FROM a ORDER BY v); "
        "COMMIT; BEGIN; BEGIN; CANCEL; THROW {a: 1}; "
        "USE NS other DB other; CREATE z:1; SELECT * FROM z")
    both.same_items()


def test_parse_errors_match(both):
    for sql in ["SELEC * FROM x", "SELECT * FROM", "CREATE x SET a = ",
                "SELECT * FROM x WHERE emb <|3 $q",
                "RETURN math::sqr(4)", "SELECT * FROM x; RETURN [1, 2",
                "SELECT id FROM t WHERE emb <|,3|> $q"]:
        out = both.run(sql)
        assert len(out) == 1 and out[0].error, sql


def test_unported_statements_raise(both):
    """What the port leaves out names itself: scripting functions (DEFINE
    FUNCTION, DEFINE EVENT, DEFINE PARAM and crypto:: are ported:
    tests/test_torch_ddl.py holds them to the reference; VERSION reads:
    test_torch_version.py; the statements once left out beside scripting:
    `test_formerly_unported_statements_match` below)."""
    both.ok("CREATE x:1")
    out = both.port.execute("RETURN function() { return 1; }", ns=NS, db=DB)
    assert len(out) == 1
    assert out[0].error is not None and "not ported" in out[0].error
    assert "scripting" in out[0].error, out[0].error


@pytest.mark.parametrize("sql", [
    "SHOW CHANGES FOR TABLE x SINCE 0",
    "DEFINE CONFIG GRAPHQL AUTO; INFO FOR DB",
    "RETURN http::get('http://localhost')",
    "DEFINE TABLE v AS SELECT * FROM x; SELECT * FROM v; CREATE x:2; "
    "SELECT * FROM v",
    "DEFINE TABLE cf CHANGEFEED 1h; CREATE cf:1; "
    "SHOW CHANGES FOR TABLE cf SINCE 0",
], ids=["SHOW CHANGES", "DEFINE CONFIG", "http::get", "views",
        "CHANGEFEED"])
def test_formerly_unported_statements_match(both, sql):
    """The five statements the port once refused answer as the
    reference's (http::get to a target the capabilities deny: the same
    error), with the same KV items."""
    both.ok("CREATE x:1")
    both.run(sql)
    both.same_items()
