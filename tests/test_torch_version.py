"""VERSION reads and the slow-query log of the port against the
reference's.

Each script runs through a reference and a port datastore
(`torch_sql_harness.both`): the same results and error texts, and the
same KV items (the history keys compared without their wall-clock
time). A script takes its timestamps with `time::now()` between writes
that a `SLEEP` keeps apart, so each package reads its own history at the
same point of the script: a record, a table and a graph step under
VERSION, the subquery error, a table that did not exist then, INFO FOR
DB / TABLE under VERSION, EXPLAIN with VERSION, and a `<|k|>` under
VERSION, which must not reach the device's store of the present rows.
Tolerance: the harness's (floats atol 1e-4, rtol 1e-5, everything else
exactly).
"""

import numpy as np
import pytest

from torch_sql_harness import DIM, MIN_ROWS, both  # noqa: F401

GAP = "SLEEP 5ms; LET $t{n} = time::now(); SLEEP 5ms"


# writes with three versions between them, $t1 < $t2 < $t3 (a LET lives
# for its script: each test's reads follow it in the same script)
HISTORY = (
    "CREATE h:1 SET v = 1, tag = 'first'; CREATE h:2 SET v = 10; "
    f"{GAP.format(n=1)}; "
    "UPDATE h:1 SET v = 2, tag = 'second'; DELETE h:2; CREATE h:3 SET v = 30; "
    f"{GAP.format(n=2)}; "
    "DEFINE TABLE late; CREATE late:1; "
    "DEFINE PARAM $p VALUE 'then'; "
    f"{GAP.format(n=3)}; "
    "UPDATE h:1 SET v = 3; DEFINE PARAM OVERWRITE $p VALUE 'now'; ")


def test_select_record_and_table_under_version(both):
    both.ok(
        HISTORY +
        "SELECT * FROM h:1 VERSION $t1; SELECT * FROM h:1 VERSION $t2; "
        "SELECT * FROM h:1 VERSION $t3; SELECT * FROM h:1; "
        "SELECT * FROM h:2 VERSION $t1; SELECT * FROM h:2 VERSION $t2; "
        "SELECT * FROM h VERSION $t1; SELECT * FROM h VERSION $t2; "
        "SELECT v FROM h WHERE v > 1 ORDER BY v DESC VERSION $t2; "
        "SELECT count() FROM h GROUP ALL VERSION $t1; "
        "SELECT VALUE v FROM h:1, h:3 VERSION $t2")
    both.same_items()


def test_version_values_and_params(both):
    """A parameter reads its definition as of the version; a datetime,
    a datetime string and an integer of nanoseconds are versions, other
    values are refused."""
    out = both.run(
        HISTORY +
        "SELECT VALUE $p FROM h:1 VERSION $t3; "
        "SELECT VALUE $p FROM h:1 VERSION $t2; SELECT VALUE $p FROM h:1; "
        "SELECT * FROM h VERSION d'2000-01-01T00:00:00Z'; "
        "SELECT * FROM h VERSION '2000-01-01T00:00:00Z'; "
        "SELECT * FROM h VERSION 0; SELECT * FROM h VERSION 'soon'; "
        "SELECT * FROM h VERSION [1]")
    # the table did not exist in 2000 (nor at 0 ns); the last two are no
    # datetimes
    assert [r.error for r in out[-8:]] == [None] * 3 + [
        "The table 'h' does not exist"] * 3 + [
        "Expected a datetime but found 'soon'",
        "Expected a datetime but found [1]"]


def test_version_subquery_error_and_missing_table(both):
    out = both.run(
        HISTORY +
        "SELECT * FROM (SELECT * FROM h) VERSION $t1; "
        "SELECT * FROM (SELECT * FROM h VERSION $t1); "
        "SELECT * FROM late VERSION $t1; SELECT * FROM late VERSION $t3; "
        "SELECT * FROM nothing VERSION $t1; SELECT * FROM late:1 VERSION $t1")
    errs = [r.error for r in out][-6:]
    assert not [e for e in [r.error for r in out][:-6] if e]
    assert errs[0] and "subquery" in errs[0]
    assert errs[2] == "The table 'late' does not exist"
    assert errs[4] == "The table 'nothing' does not exist"


def test_graph_step_under_version(both):
    """An edge written after the version is not walked at it; a node
    deleted since is walked at it."""
    both.ok("CREATE a:1, b:1, b:2; RELATE a:1->likes:one->b:1; "
            f"{GAP.format(n=1)}; "
            "RELATE a:1->likes:two->b:2; "
            f"{GAP.format(n=2)}; "
            "DELETE likes WHERE out = b:1; "
            "SELECT ->likes->b AS o FROM a:1 VERSION $t1; "
            "SELECT ->likes->b AS o FROM a:1 VERSION $t2; "
            "SELECT ->likes->b AS o FROM a:1; "
            "SELECT ->likes.out AS o FROM a:1 VERSION $t2; "
            "SELECT <-likes<-a AS i FROM b VERSION $t2")
    both.same_items()


def test_info_under_version(both):
    both.ok(HISTORY +
            "DEFINE FIELD v ON h TYPE int; DEFINE INDEX hv ON h FIELDS v; "
            "INFO FOR DB VERSION $t1; INFO FOR DB VERSION $t3; "
            "INFO FOR TABLE h VERSION $t3; INFO FOR TABLE h; "
            "INFO FOR TABLE late VERSION $t3; "
            "INFO FOR DB VERSION d'2000-01-01T00:00:00Z'")
    both.run("INFO FOR TABLE late VERSION d'2000-01-01T00:00:00Z'; "
             "INFO FOR DB STRUCTURE VERSION time::now()")


def test_explain_under_version(both):
    both.run(HISTORY +
             "EXPLAIN SELECT * FROM h VERSION $t1; "
             "EXPLAIN FULL SELECT * FROM h WHERE v > 1 VERSION $t2; "
             "SELECT * FROM h WHERE v > 1 VERSION $t2 EXPLAIN",
             redact_volatile_explain_attrs=True)


def test_knn_under_version(both):
    """A `<|k|>` under VERSION goes as the reference sends it: its
    answer (or error) is the reference's, and the port's device sees no
    query of the present rows' store for it."""
    rng = np.random.default_rng(3)
    n = MIN_ROWS + 16
    xs = rng.standard_normal((n, DIM)).astype(np.float32)
    q = rng.standard_normal(DIM).astype(np.float32).tolist()
    both.ok(f"DEFINE INDEX ix ON v FIELDS emb HNSW DIMENSION {DIM} "
            "DIST EUCLIDEAN TYPE F32")
    both.ok("FOR $i IN 0..$n { CREATE type::record('v', $i) SET "
            "emb = $xs[$i] }", {"n": n, "xs": xs.tolist()})
    del both.ops[:]
    out = both.ok(
        "SLEEP 5ms; LET $t1 = time::now(); SLEEP 5ms; "
        "UPDATE v:0 SET emb = $q; UPDATE v:1 SET emb = $q; "
        "SELECT id FROM v WHERE emb <|3|> $q", {"q": q})
    assert {r["id"].id for r in out[-1][:2]} == {0, 1}
    assert "vec_knn" in both.ops
    del both.ops[:]
    both.run("SLEEP 5ms; LET $t1 = time::now(); SLEEP 5ms; "
             "UPDATE v:2 SET emb = $q; "
             "SELECT id FROM v WHERE emb <|3|> $q VERSION $t1; "
             "SELECT id, vector::distance::knn() AS d FROM v "
             "WHERE emb <|3,EUCLIDEAN|> $q VERSION $t1", {"q": q})
    assert not [op for op in both.ops if op in ("vec_knn", "ann_search")]


@pytest.mark.parametrize("threshold", [0.0, 1e-9])
def test_slow_query_log(both, monkeypatch, threshold):
    """A threshold of 0 turns the log off, as the reference's; a
    threshold below any statement's time logs every statement, and INFO
    FOR SYSTEM lists the last 50 as the reference does (each entry's ms
    is the wall time of its own run, so the entries compare by their
    statements and the ms as positive numbers)."""
    for ds in (both.ref, both.port):
        monkeypatch.setattr(ds, "slow_log_threshold_ms", threshold)
    both.ok("CREATE s:1; SELECT * FROM s; RETURN 1")
    r = both.ref.query("INFO FOR SYSTEM", ns="t", db="t")[0]["slow_queries"]
    p = both.port.query("INFO FOR SYSTEM", ns="t", db="t")[0]["slow_queries"]
    assert [e["statement"] for e in p] == [e["statement"] for e in r]
    assert [list(e) for e in p] == [list(e) for e in r]
    assert all(e["ms"] > 0 for e in p)
    assert both.port.metrics["slow_queries"] == \
        both.ref.metrics["slow_queries"]
    if threshold:
        assert [e["statement"] for e in p][:2] == ["CreateStmt", "SelectStmt"]
    else:
        assert p == [] and both.port.metrics["slow_queries"] == 0
    for _ in range(60):
        both.port.execute("SELECT * FROM s", ns="t", db="t")
        both.ref.execute("SELECT * FROM s", ns="t", db="t")
    r = both.ref.query("INFO FOR SYSTEM", ns="t", db="t")[0]["slow_queries"]
    p = both.port.query("INFO FOR SYSTEM", ns="t", db="t")[0]["slow_queries"]
    assert len(p) == len(r) == (50 if threshold else 0)
    assert [e["statement"] for e in p] == [e["statement"] for e in r]


def test_slow_query_log_ring(monkeypatch):
    """The ring keeps its last entries as the reference's does: past
    1,000 it drops the oldest 500."""
    from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore

    logs = []
    for cls in (RefDatastore, PortDatastore):
        ds = cls("memory")
        try:
            ds.slow_log_threshold_ms = 1.0
            for i in range(1203):
                ds.record_statement(i % 3 != 0, (i % 7 + 1) * 1_000_000,
                                    f"stmt{i}" * (i % 50))
            ds.record_statement(True, 999_999, "fast")
            logs.append((list(ds.slow_log), dict(ds.metrics)))
        finally:
            ds.close()
    assert logs[0] == logs[1]
    assert len(logs[1][0]) == 703


def test_threshold_from_environment(monkeypatch):
    from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore

    for env, want in (("2.5", 2.5), ("", 0.0), ("x", 0.0)):
        monkeypatch.setenv("SURREAL_SLOW_QUERY_THRESHOLD_MS", env)
        for cls in (RefDatastore, PortDatastore):
            ds = cls("memory")
            try:
                assert ds.slow_log_threshold_ms == want
            finally:
                ds.close()
