"""The port's EXPLAIN and INFO against the reference's: each statement
runs through a reference and a port datastore (`torch_sql_harness.both`)
with `redact_volatile_explain_attrs` set in both sessions, under the
default planner and the streaming one (`planner_strategy = "all-ro"`,
the text operator tree), and the two give the same plans.

Tolerance: the harness's (plans and INFO maps compare exactly, floats
inside them with atol 1e-4 and rtol 1e-5). An EXPLAIN ANALYZE without
the redaction measures time: its `elapsed` figures are masked before
the comparison, every other figure compares exactly. INFO FOR SYSTEM
reads the process (memory, load, threads) and each package's own
supervisor: it compares by keys, and by the supervisor's mode and state.
"""

import re
import threading
import time

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.idx import fulltext as RF
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.idx import fulltext as PF
from torch_sql_harness import (  # noqa: F401  (both is a fixture)
    DB,
    DIM,
    NS,
    _results,
    both,
    norm,
    same,
)

REDACT = {"redact_volatile_explain_attrs": True}
STRATEGIES = {"default": None, "all-ro": "all-ro"}

FORMS = [
    "EXPLAIN {q}",
    "EXPLAIN FULL {q}",
    "EXPLAIN ANALYZE {q}",
    "EXPLAIN FORMAT JSON {q}",
    "EXPLAIN ANALYZE FORMAT JSON {q}",
    "{q} EXPLAIN",
    "{q} EXPLAIN FULL",
]

SELECTS = [
    "SELECT * FROM v",
    "SELECT * FROM v:3",
    "SELECT * FROM v:1..5",
    "SELECT * FROM v, v:2",
    "SELECT * FROM v WHERE n = 3",
    "SELECT * FROM v WHERE g = 1",
    "SELECT * FROM v WHERE g = 1 LIMIT 4",
    "SELECT * FROM v WHERE g = 1 OR n = 4",
    "SELECT * FROM v WHERE n > 290 ORDER BY n",
    "SELECT * FROM v WHERE n IN [1, 2, 3]",
    "SELECT * FROM v WHERE g = 2 AND n < 30",
    "SELECT * FROM v WITH NOINDEX WHERE g = 1",
    "SELECT * FROM v WITH INDEX gi WHERE g = 1 AND n = 4",
    "SELECT * FROM v ORDER BY id DESC LIMIT 3",
    "SELECT * FROM v ORDER BY n DESC LIMIT 3 START 2",
    "SELECT count() FROM v GROUP ALL",
    "SELECT g, count() FROM v GROUP BY g",
    "SELECT g, math::sum(n) AS s FROM v WHERE n < 50 GROUP BY g",
    "SELECT VALUE n FROM v WHERE !(g = 1) LIMIT 2",
    "SELECT * FROM (SELECT * FROM v WHERE g = 1) WHERE n > 3",
    "SELECT id, vector::distance::knn() AS d FROM v WHERE emb <|5|> $q",
    "SELECT id FROM v WHERE emb <|10,40|> $q",
    "SELECT id FROM v WHERE emb <|4,40|> $q AND g = 2",
    "SELECT id FROM v WHERE emb <|5,EUCLIDEAN|> $q",
    "SELECT id FROM v WHERE emb <|3,COSINE|> $q AND n > 10",
    "SELECT * FROM v WHERE txt @@ 'gamma'",
    "SELECT id, search::score(1) AS s FROM v WHERE txt @1@ 'gamma delta' "
    "ORDER BY s DESC LIMIT 3",
    "SELECT * FROM v WHERE txt @@ 'alpha' AND g = 1",
    "SELECT ->e->v FROM v:1",
    "SELECT VALUE ->e->v->e->v FROM v:1",
    "SELECT <-e<-v AS back FROM v:3",
    "SELECT * FROM e WHERE in = v:1",
    "SELECT * FROM nope",
]


@pytest.fixture()
def loaded(both):
    """A table with an HNSW (bf16 cosine), a plain, a unique and a
    full-text index, and a few edges."""
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(300, DIM)).astype(np.float32)
    both.ok(f"DEFINE TABLE v; DEFINE INDEX ix ON v FIELDS emb HNSW "
            f"DIMENSION {DIM} DIST COSINE TYPE F32; "
            "DEFINE INDEX gi ON v FIELDS g; DEFINE INDEX ni ON v FIELDS n "
            "UNIQUE; DEFINE ANALYZER simple TOKENIZERS blank FILTERS "
            "lowercase; DEFINE INDEX ft ON v FIELDS txt FULLTEXT ANALYZER "
            "simple BM25 HIGHLIGHTS")
    rows = [{"id": i, "emb": xs[i].tolist(), "n": i, "g": i % 3,
             "txt": "gamma delta" if i % 5 == 0 else "alpha beta"}
            for i in range(300)]
    both.ok("INSERT INTO v $rows RETURN NONE", {"rows": rows})
    both.ok("RELATE v:1->e:1->v:2; RELATE v:2->e:2->v:3; "
            "RELATE v:1->e:3->v:3")
    both.vars = {"q": xs[7].tolist()}
    return both


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("form", FORMS)
def test_explain_selects(loaded, form, strategy):
    session = dict(REDACT, planner_strategy=STRATEGIES[strategy])
    sql = "; ".join(form.format(q=q) for q in SELECTS)
    out = loaded.run(sql, loaded.vars, **session)
    assert len(out) == len(SELECTS)
    assert sum(r.error is None for r in out) >= len(SELECTS) - 2


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_explain_writes_and_other_statements(loaded, strategy):
    session = dict(REDACT, planner_strategy=STRATEGIES[strategy])
    loaded.run(
        "EXPLAIN UPDATE v SET x = 1 WHERE g = 1; "
        "EXPLAIN DELETE v WHERE n = 3; UPDATE v:4 SET y = 2 EXPLAIN; "
        "DELETE v:5 EXPLAIN FULL; UPDATE v SET z = 1 WHERE n < 3 EXPLAIN; "
        "EXPLAIN CREATE v:999 SET n = 999; EXPLAIN RETURN 1 + 1; "
        "EXPLAIN LET $x = 3; EXPLAIN INSERT INTO v { id: 1000 }; "
        "EXPLAIN RELATE v:1->e->v:4; EXPLAIN UPSERT v:6 SET w = 1; "
        "EXPLAIN DEFINE TABLE t2; EXPLAIN INFO FOR DB",
        loaded.vars, **session)
    loaded.same_items()
    loaded.run("EXPLAIN SELECT * FROM v VERSION d'2024-01-01T00:00:00Z'",
               loaded.vars, **session)


_ELAPSED = re.compile(r"elapsed: [0-9.]+(ns|µs|ms|s)")


def _masked(rs):
    return [(k, _ELAPSED.sub("elapsed: T", v) if isinstance(v, str) else v)
            for k, v in _results(rs)]


def test_explain_analyze_measured(loaded):
    """EXPLAIN ANALYZE without the redaction runs the streaming
    operator tree and reports measured rows, batches and elapsed time
    per operator (exec/stream.py try_stream_analyze)."""
    from surrealdb_tpu.kvs.ds import Session as RSession
    from surrealdb_tpu_torch.kvs.ds import Session as PSession

    sql = ("EXPLAIN ANALYZE SELECT * FROM v WHERE n > 250; "
           "EXPLAIN ANALYZE SELECT g, count() FROM v GROUP BY g; "
           "EXPLAIN ANALYZE SELECT * FROM v LIMIT 7; "
           "EXPLAIN ANALYZE SELECT id FROM v WHERE emb <|5|> $q")
    outs = []
    for ds, cls in ((loaded.ref, RSession), (loaded.port, PSession)):
        sess = cls(ns=NS, db=DB, auth_level="owner")
        sess.planner_strategy = "all-ro"
        outs.append(_masked(ds.execute(sql, ns=NS, db=DB, vars=loaded.vars,
                                       session=sess)))
    same(outs[0], outs[1])
    assert any("elapsed: T" in v for _k, v in outs[1] if isinstance(v, str))


KNN_STORES = {
    "bf16": ("COSINE", {}),
    "exact": ("MANHATTAN", {}),
    "int8": ("COSINE", {"KNN_HBM_BUDGET_BYTES": 1024}),
    "ann": ("COSINE", {"KNN_ANN_MODE": "force"}),
    "segmented": ("EUCLIDEAN", {"KNN_ANN_MODE": "force",
                                "KNN_SEG_MODE": "force",
                                "KNN_SEG_ROWS": 256,
                                "KNN_SEG_FANOUT": 2}),
}


@pytest.mark.parametrize("store", list(KNN_STORES))
def test_explain_knn_stores(both, monkeypatch, store):
    """EXPLAIN of KNN over each store the port serves: the plan reads
    the engine's route (ANN plan, residency)."""
    from surrealdb_tpu.idx import segments as rseg
    from surrealdb_tpu_torch.idx import segments as pseg

    dist, knobs = KNN_STORES[store]
    for name, v in knobs.items():
        for c in (rcnf, pcnf):
            monkeypatch.setattr(c, name, v)
    for m in (rseg, pseg):
        monkeypatch.setattr(m.SegmentedAnn, "_kick", lambda self: None)
    n = 400 if store in ("ann", "segmented") else 300
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(n, DIM)).astype(np.float32)
    both.ok(f"DEFINE TABLE k; DEFINE INDEX ix ON k FIELDS emb HNSW "
            f"DIMENSION {DIM} DIST {dist} TYPE F32")
    both.ok("INSERT INTO k $rows RETURN NONE",
            {"rows": [{"id": i, "emb": xs[i].tolist(), "g": i % 4}
                      for i in range(n)]})
    q = {"q": xs[11].tolist()}
    both.ok("SELECT id FROM k WHERE emb <|5|> $q", q)
    if store in ("ann", "segmented"):
        for ds in (both.ref, both.port):
            assert ds.vector_indexes[(NS, DB, "k", "ix")].ensure_ann()
    for strategy in STRATEGIES.values():
        both.ok("EXPLAIN SELECT id FROM k WHERE emb <|10,40|> $q; "
                "EXPLAIN FULL SELECT id FROM k WHERE emb <|10,40|> $q; "
                "SELECT id FROM k WHERE emb <|5|> $q AND g = 1 EXPLAIN; "
                "EXPLAIN ANALYZE SELECT id, vector::distance::knn() AS d "
                "FROM k WHERE emb <|3,40|> $q", q,
                **dict(REDACT, planner_strategy=strategy))
    # INFO FOR SYSTEM reports the engine's residency as the reference's
    r, p = (ds.execute("INFO FOR SYSTEM", ns=NS, db=DB)[0].result["knn"]
            for ds in (both.ref, both.port))
    same(norm(r), norm(p))
    for ds in (both.ref, both.port):
        ds.close()


def _define_all(both):
    both.ok(
        "DEFINE NAMESPACE other COMMENT 'o'; DEFINE DATABASE d2 COMMENT 'd'; "
        "DEFINE TABLE p SCHEMAFULL PERMISSIONS FOR select WHERE true "
        "COMMENT 'pc'; DEFINE FIELD name ON p TYPE string ASSERT "
        "string::len($value) > 0; DEFINE FIELD age ON p TYPE option<int> "
        "DEFAULT 1 READONLY; DEFINE FIELD tags ON p TYPE array<string>; "
        "DEFINE FIELD emb ON p TYPE option<array<float>>; "
        "DEFINE INDEX pn ON p FIELDS name UNIQUE; DEFINE INDEX pa ON p "
        "FIELDS age; DEFINE INDEX pe ON p FIELDS emb HNSW DIMENSION 4 "
        "DIST EUCLIDEAN TYPE F32 EFC 100 M 8; DEFINE ANALYZER az TOKENIZERS "
        "blank, camel FILTERS ascii, lowercase, edgengram(2,5) COMMENT 'ac'; "
        "DEFINE INDEX pf ON p FIELDS name FULLTEXT ANALYZER az "
        "BM25(1.1,0.5) HIGHLIGHTS; DEFINE TABLE r TYPE RELATION IN p OUT p "
        "ENFORCED; DEFINE TABLE s DROP; DEFINE TABLE n TYPE NORMAL")


INFOS = [
    "INFO FOR ROOT", "INFO FOR NS", "INFO FOR DB", "INFO FOR TABLE p",
    "INFO FOR TABLE r", "INFO FOR INDEX pn ON p", "INFO FOR INDEX pf ON p",
    "INFO FOR ROOT STRUCTURE", "INFO FOR NS STRUCTURE",
    "INFO FOR DB STRUCTURE", "INFO FOR TABLE p STRUCTURE",
    "INFO FOR TABLE nope", "INFO FOR INDEX nope ON p", "INFO FOR USER nope",
    "INFO FOR USER nope ON DATABASE",
]


def test_info_after_each_definition(both):
    for sql in INFOS:
        both.run(sql)
    _define_all(both)
    for sql in INFOS:
        both.run(sql)
    both.ok("CREATE p:1 SET name = 'Ann', tags = ['x'], emb = [1, 2, 3, 4]; "
            "REMOVE INDEX pa ON p; REMOVE ANALYZER az")
    for sql in INFOS:
        both.run(sql)
    both.same_items()


def test_info_version_is_not_ported(both):
    """INFO … VERSION (once left out) answers the reference's: before
    the table was defined, it lists none."""
    both.ok("DEFINE TABLE p")
    out = both.ok("INFO FOR DB VERSION d'2024-01-01T00:00:00Z'")
    assert out[0]["tables"] == {}


def test_info_for_system(loaded):
    """The same keys in both, and each package's supervisor in the same
    mode and state (inline, ready after the KNN queries)."""
    loaded.ok("SELECT id FROM v WHERE emb <|3|> $q", loaded.vars)
    r = loaded.ref.execute("INFO FOR SYSTEM", ns=NS, db=DB)[0].result
    p = loaded.port.execute("INFO FOR SYSTEM", ns=NS, db=DB)[0].result
    assert list(r) == list(p)
    assert r["device"]["mode"] == p["device"]["mode"] == "inline"
    assert r["device"]["state"] == p["device"]["state"]
    assert list(r["mem"]) == list(p["mem"])
    assert list(r["columnar"]) == list(p["columnar"])
    assert r["live"] == p["live"]
    assert [k["index"] for k in r["knn"]] == [k["index"] for k in p["knn"]]
    assert r["metrics"] == p["metrics"]


def test_info_for_index_during_a_concurrent_build(both, monkeypatch):
    """INFO FOR INDEX while a CONCURRENTLY full-text build is held at
    its first document, then after it ends: the same status in both."""
    entered = {id(RF): threading.Event(), id(PF): threading.Event()}
    release = threading.Event()
    for mod in (RF, PF):
        orig = mod.fulltext_index_update

        def held(*a, _orig=orig, _ev=entered[id(mod)]):
            _ev.set()
            assert release.wait(30)
            return _orig(*a)

        monkeypatch.setattr(mod, "fulltext_index_update", held)
    both.ok("INSERT INTO doc $rows",
            {"rows": [{"id": i, "text": f"word{i} common"} for i in range(6)]})
    both.ok("DEFINE INDEX ft ON doc FIELDS text FULLTEXT BM25 CONCURRENTLY")
    for ev in entered.values():
        assert ev.wait(30)
    try:
        res = both.ok("INFO FOR INDEX ft ON doc")
        assert res[0]["building"]["status"] == "indexing"
    finally:
        release.set()
    for ds in (both.ref, both.port):
        key = (NS, DB, "doc", "ft")
        deadline = time.monotonic() + 30
        while ds.index_builds.get(key, {}).get("status") != "ready":
            assert time.monotonic() < deadline, ds.index_builds.get(key)
            time.sleep(0.01)
    res = both.ok("INFO FOR INDEX ft ON doc")
    assert res[0]["building"]["initial"] == 6
    both.same_items()
