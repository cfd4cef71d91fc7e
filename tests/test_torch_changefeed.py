"""Changefeeds, SHOW CHANGES and materialised views of the port
(`cf.py`, `exec/views.py`, their statements in `exec/statements.py` and
their write stages in `exec/document.py`) against the reference's.

Each case feeds the same statements to a reference and a port datastore
(`torch_sql_harness.both`) and compares results, errors and KV items.
Tolerance: the harness's (floats atol 1e-4, rtol 1e-5, everything else
exact). A changefeed's versionstamp holds the wall milliseconds of the
write, so the two packages never give equal bytes: the harness compares
changefeed keys without those 8 bytes, in write order, and SHOW CHANGES
versionstamps by rank. `SINCE <versionstamp>` takes each package's own
versionstamp; `SINCE <datetime>` cuts between writes a `SLEEP` apart, so
both packages cut at the same write.
"""

import pytest

from surrealdb_tpu import cf as rcf
from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu_torch import cf as pcf
from surrealdb_tpu_torch import cnf as pcnf
from torch_sql_harness import DB, NS, _ranked, both, norm, same  # noqa: F401


# -- changefeeds -------------------------------------------------------------------


@pytest.mark.parametrize("ddl", [
    "DEFINE TABLE x CHANGEFEED 1h",
    "DEFINE TABLE x CHANGEFEED 1h INCLUDE ORIGINAL",
    "DEFINE DATABASE OVERWRITE t CHANGEFEED 1h; DEFINE TABLE x",
    "DEFINE TABLE x; ALTER TABLE x CHANGEFEED 30m",
], ids=["table", "include-original", "database", "alter"])
def test_changefeed_records_writes(both, ddl):
    """CREATE, UPDATE, UPSERT, DELETE and INSERT land in SHOW CHANGES,
    with INFO showing the clause."""
    both.ok(ddl)
    both.ok("CREATE x:1 SET a = 1; UPDATE x:1 SET a = 2; "
            "UPSERT x:2 SET a = 3; INSERT INTO x [{ id: 3, a: 4 }]; "
            "DELETE x:2; CREATE y:1 SET b = 1")
    out = both.ok("SHOW CHANGES FOR TABLE x SINCE 0; "
                  "SHOW CHANGES FOR TABLE x SINCE 0 LIMIT 2; "
                  "SHOW CHANGES FOR TABLE y SINCE 0; "
                  "INFO FOR TABLE x; INFO FOR DB")
    assert len(out[0]) == 5 and len(out[1]) == 2
    both.same_items()


def test_changefeed_drop_and_since_versionstamp(both):
    """SINCE a versionstamp of each package's own feed, then DROP
    CHANGEFEED: later writes are not logged."""
    both.ok("DEFINE TABLE x CHANGEFEED 1h; CREATE x:1; CREATE x:2; "
            "CREATE x:3")
    got = []
    for ds in (both.ref, both.port):
        feed = ds.query("SHOW CHANGES FOR TABLE x SINCE 0", ns=NS, db=DB)[0]
        vs = feed[1]["versionstamp"]
        out = ds.execute("SHOW CHANGES FOR TABLE x SINCE $v; "
                         "SHOW CHANGES FOR TABLE x SINCE $v LIMIT 1",
                         ns=NS, db=DB, vars={"v": vs})
        got.append([norm(_ranked(r.result)) for r in out])
    same(got[0], got[1])
    assert len(got[1][0]) == 2 and len(got[1][1]) == 1
    both.ok("ALTER TABLE x DROP CHANGEFEED; CREATE x:4; INFO FOR TABLE x")
    out = both.ok("SHOW CHANGES FOR TABLE x SINCE 0")
    assert len(out[0]) == 3
    both.same_items()


def test_changefeed_since_datetime(both):
    """SINCE a datetime taken between writes a SLEEP apart."""
    out = both.ok("DEFINE TABLE x CHANGEFEED 1h; CREATE x:1; SLEEP 5ms; "
                  "LET $t = time::now(); SLEEP 5ms; CREATE x:2; "
                  "UPDATE x:1 SET n = 1; "
                  "SHOW CHANGES FOR TABLE x SINCE $t; "
                  "SHOW CHANGES FOR TABLE x SINCE d'2000-01-01T00:00:00Z'")
    assert len(out[-2]) == 2 and len(out[-1]) == 3
    both.run("SHOW CHANGES FOR TABLE x SINCE 'x'; "
             "SHOW CHANGES FOR TABLE nope SINCE 0")
    both.same_items()


def test_changefeed_gc_of_expired_entries(both, monkeypatch):
    """run_changefeed_gc drops entries past their table's retention and
    keeps the rest; changefeed_gc_tick takes the lease and sweeps."""
    both.ok("DEFINE TABLE short CHANGEFEED 1ms; DEFINE TABLE long "
            "CHANGEFEED 1h; CREATE short:1; CREATE long:1; SLEEP 10ms")
    purged = [rcf.run_changefeed_gc(both.ref),
              pcf.run_changefeed_gc(both.port)]
    assert purged[0] == purged[1] == 1
    assert both.ref.telemetry.get("changefeed_gc_purged") == \
        both.port.telemetry.get("changefeed_gc_purged")
    both.ok("SHOW CHANGES FOR TABLE short SINCE 0; "
            "SHOW CHANGES FOR TABLE long SINCE 0")
    both.same_items()
    both.ok("CREATE short:2; CREATE short:3; SLEEP 10ms")
    assert rcf.changefeed_gc_tick(both.ref) == \
        pcf.changefeed_gc_tick(both.port) == 2
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "CHANGEFEED_RETENTION_S", 0.0)
    assert rcf.run_changefeed_gc(both.ref) == \
        pcf.run_changefeed_gc(both.port) == 0
    # the tick's lease row holds each node's random id: the feeds compare
    out = both.ok("SHOW CHANGES FOR TABLE short SINCE 0; "
                  "SHOW CHANGES FOR TABLE long SINCE 0")
    assert out[0] == [] and len(out[1]) == 1


# -- views -------------------------------------------------------------------------

VIEWS = {
    "group-aggregates": (
        "DEFINE TABLE v AS SELECT g, count() AS n, math::sum(x) AS s, "
        "math::mean(x) AS m, math::min(x) AS lo, math::max(x) AS hi "
        "FROM src GROUP BY g"),
    "group-all": (
        "DEFINE TABLE v AS SELECT count() AS n, math::sum(x) AS s FROM src "
        "GROUP ALL"),
    "filtered-projection": (
        "DEFINE TABLE v AS SELECT x, g FROM src WHERE x > 2"),
    "rebuild-route": (
        "DEFINE TABLE v AS SELECT g, x FROM src GROUP BY g"),
    "view-on-view": (
        "DEFINE TABLE v AS SELECT g, count() AS n FROM src GROUP BY g; "
        "DEFINE TABLE w AS SELECT count() AS groups FROM v GROUP ALL"),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_view_under_writes(both, case):
    """A view defined over existing rows, then kept under creates,
    updates and deletes (the incremental engine, or the rebuild by scan
    for a shape `analyze_view` refuses)."""
    both.ok("INSERT INTO src $rows RETURN NONE",
            {"rows": [{"id": i, "g": i % 3, "x": i} for i in range(8)]})
    both.ok(VIEWS[case])
    both.ok("SELECT * FROM v; INFO FOR TABLE src; INFO FOR DB")
    both.ok("CREATE src:20 SET g = 1, x = 9; UPDATE src:1 SET x = 100; "
            "UPDATE src:2 SET g = 0; DELETE src:3; DELETE src:4")
    both.run("SELECT * FROM v; SELECT * FROM w")
    both.ok("DELETE src")
    both.ok("SELECT * FROM v")
    both.same_items()


def test_view_analysis_refusals_and_remove_guard(both):
    """Which view shapes the incremental engine takes, the REMOVE TABLE
    guard on a view's source, and a redefinition."""
    from surrealdb_tpu.exec import views as RV
    from surrealdb_tpu.syn import parse as rparse
    from surrealdb_tpu_torch.exec import views as PV
    from surrealdb_tpu_torch.syn import parse as pparse

    for sql in ["SELECT g, count() AS n FROM src GROUP BY g",
                "SELECT VALUE x FROM src",
                "SELECT math::median(x) AS m FROM src GROUP ALL",
                "SELECT g, x FROM src GROUP BY g",
                "SELECT x FROM src WHERE x > 1",
                "SELECT * FROM src"]:
        got = []
        for parse, V in ((rparse, RV), (pparse, PV)):
            try:
                got.append(("ok", norm(V.analyze_view(parse(sql)[0]))))
            except V.Unsupported as e:
                got.append(("unsupported", str(e)))
        assert got[0][0] == got[1][0], (sql, got)
    both.ok("CREATE src:1 SET g = 1, x = 1")
    both.ok("DEFINE TABLE v AS SELECT g, count() AS n FROM src GROUP BY g")
    both.run("REMOVE TABLE src; DEFINE TABLE OVERWRITE v AS SELECT x FROM "
             "src; SELECT * FROM v; REMOVE TABLE v; REMOVE TABLE src")
    both.same_items()
