"""The port's schema statements against the reference's: DEFINE / REMOVE
/ ALTER EVENT, PARAM, FUNCTION and SEQUENCE, ALTER TABLE and the other
ALTERs, REBUILD INDEX, the ACCESS statement's grants, and the crypto::,
session:: and sequence::nextval functions. Each script runs through a
reference and a port datastore (`torch_sql_harness.both`), and the
results and the KV items are compared.

Tolerance: as `torch_sql_harness` (floats atol 1e-4, rtol 1e-5,
everything else exactly). A password hash or a bearer grant holds
random salt or key bytes: a hash is compared by what each package's
compare function says of it, a grant with its random parts masked.
"""

import re

import numpy as np
import pytest

from surrealdb_tpu.fnc import misc_fns as RM
from surrealdb_tpu_torch.fnc import misc_fns as PM
from torch_sql_harness import DIM, MIN_ROWS, NS, DB, both, norm, same  # noqa: F401


@pytest.fixture(autouse=True)
def _scripts_parse(monkeypatch):
    """Every script of these tests parses: a parse error is one errored
    result in both packages, which would compare equal and test nothing."""
    from torch_sql_harness import Both

    run = Both.run

    def checked(self, sql, vars=None, **session):
        out = run(self, sql, vars, **session)
        assert not (len(out) == 1 and out[0].error is not None
                    and out[0].error.startswith("Parse error")), out[0].error
        return out

    monkeypatch.setattr(Both, "run", checked)


# -- events -----------------------------------------------------------------------


def test_events_on_create_update_delete(both):
    both.ok(
        "DEFINE TABLE person SCHEMALESS; "
        "DEFINE EVENT log ON person WHEN $event IN ['CREATE', 'UPDATE', "
        "'DELETE'] THEN (UPSERT type::record('log', [$event, $value.id]) "
        "SET before = $before, after = $after, input = $input, "
        "n = (SELECT VALUE count() FROM person GROUP ALL)); "
        "DEFINE EVENT big ON person WHEN $after.age > 40 THEN "
        "{ CREATE type::record('big', $after.id.id()) SET age = $after.age }")
    both.run("CREATE person:1 SET name = 'a', age = 30; "
             "CREATE person:2 CONTENT {name: 'b', age: 50}; "
             "UPDATE person:1 SET age = 41; "
             "UPSERT person:3 SET age = 1; "
             "DELETE person:2; "
             "SELECT * FROM log ORDER BY id; SELECT * FROM big ORDER BY id; "
             "INFO FOR TABLE person")
    both.same_items()


def test_event_errors_and_async_retry(both):
    both.ok("DEFINE EVENT fail ON t WHEN $event = 'CREATE' THEN "
            "{ THROW 'no ' + <string> $after.id }; "
            "DEFINE EVENT later ON u ASYNC RETRY 2 THEN "
            "{ CREATE type::record('v', $after.id.id()); THROW 'always' }")
    both.run("CREATE t:1; SELECT * FROM t; CREATE u:1; SELECT * FROM u; "
             "SELECT * FROM v; "
             "BEGIN; CREATE t:2; COMMIT; SELECT * FROM t")
    both.same_items()


def test_event_ddl(both):
    both.run(
        "DEFINE EVENT e ON x THEN {}; DEFINE EVENT e ON x THEN {}; "
        "DEFINE EVENT IF NOT EXISTS e ON x THEN { CREATE y }; "
        "DEFINE EVENT OVERWRITE e ON x WHEN $event = 'UPDATE' THEN "
        "{ CREATE y:1 } COMMENT 'c'; "
        "ALTER EVENT e ON x COMMENT 'd'; ALTER EVENT nope ON x COMMENT 'd'; "
        "ALTER EVENT IF EXISTS nope ON x COMMENT 'd'; "
        "INFO FOR TABLE x; REMOVE EVENT e ON x; REMOVE EVENT e ON x; "
        "REMOVE EVENT IF EXISTS e ON x; INFO FOR TABLE x")
    both.same_items()


# -- params -----------------------------------------------------------------------


def test_params(both):
    both.run(
        "DEFINE PARAM $limit VALUE 3; DEFINE PARAM $obj VALUE {a: [1, 2], "
        "b: time::epoch + 1s}; RETURN [$limit, $obj.a[1]]; "
        "DEFINE PARAM $limit VALUE 4; DEFINE PARAM IF NOT EXISTS $limit "
        "VALUE 5; DEFINE PARAM OVERWRITE $limit VALUE $limit * 10 "
        "COMMENT 'x'; RETURN $limit; LET $limit = 1; RETURN $limit; "
        "FOR $i IN [1, 2] { CREATE p SET v = $obj.a[$i - 1], id = $i }; "
        "SELECT * FROM p WHERE v < $obj.a[1]; "
        "ALTER PARAM $limit VALUE 7; ALTER PARAM $nope VALUE 1; "
        "INFO FOR DB; REMOVE PARAM $limit; RETURN $limit; "
        "REMOVE PARAM $limit; REMOVE PARAM IF EXISTS $limit; INFO FOR DB")
    both.same_items()


# -- functions ----------------------------------------------------------------------


def test_functions(both):
    both.run(
        "DEFINE FUNCTION fn::add($a: int, $b: int) -> int { RETURN $a + $b; }; "
        "DEFINE FUNCTION fn::greet($name: string, $p: option<string>) "
        "{ RETURN (IF $p { $p } ELSE { 'hi' }) + ' ' + $name; }; "
        "DEFINE FUNCTION fn::rows($n: number) { "
        "FOR $i IN 1..=$n { CREATE r SET id = $i, sq = fn::add($i, $i) }; "
        "RETURN SELECT VALUE sq FROM r ORDER BY sq; }; "
        "DEFINE FUNCTION fn::bad() -> int { RETURN 'x'; }; "
        "DEFINE FUNCTION fn::brk() { BREAK; }; "
        "DEFINE FUNCTION fn::nested::name() { RETURN 'n'; }; "
        "RETURN fn::add(1, 2); RETURN fn::add('1', 2); RETURN fn::add(1); "
        "RETURN fn::add(1, 2, 3); RETURN fn::greet('a'); "
        "RETURN fn::greet('a', 'yo'); RETURN fn::rows(3); RETURN fn::bad(); "
        "RETURN fn::brk(); RETURN fn::nested::name(); RETURN fn::nope(); "
        "RETURN 'b'.greet(); "
        "DEFINE FUNCTION fn::add() { RETURN 0 }; "
        "ALTER FUNCTION fn::add COMMENT 'sum'; INFO FOR DB; "
        "REMOVE FUNCTION fn::add; RETURN fn::add(1, 2); "
        "REMOVE FUNCTION fn::add; REMOVE FUNCTION IF EXISTS fn::add")
    both.same_items()


def test_analyzer_function_and_fulltext(both):
    both.ok("DEFINE FUNCTION fn::fold($s: string) -> string "
            "{ RETURN string::lowercase(string::replace($s, '-', ' ')); }; "
            "DEFINE ANALYZER az FUNCTION fn::fold TOKENIZERS blank; "
            "DEFINE FUNCTION fn::num($s: string) { RETURN 1; }; "
            "DEFINE ANALYZER bad FUNCTION fn::num TOKENIZERS blank")
    both.run("RETURN search::analyze('az', 'Graph-Vector INDEX'); "
             "RETURN search::analyze('bad', 'x')")
    both.ok("DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER az BM25")
    for i, text in enumerate(["Graph-Search now", "vector-GRAPH", "plain"]):
        both.ok(f"CREATE doc:{i} SET text = '{text}'")
    both.run("SELECT id, search::score(1) AS s FROM doc WHERE text @1@ "
             "'graph' ORDER BY id")
    both.same_items()


# -- sequences ----------------------------------------------------------------------


def test_sequences(both):
    both.run(
        "DEFINE SEQUENCE s BATCH 3 START 10; DEFINE SEQUENCE s; "
        "DEFINE SEQUENCE IF NOT EXISTS s; "
        "RETURN [sequence::nextval('s'), sequence::nextval('s'), "
        "sequence::nextval('s'), sequence::nextval('s')]; "
        "BEGIN; RETURN sequence::nextval('s'); CANCEL; "
        "RETURN sequence::nextval('s'); RETURN sequence::nextval('nope'); "
        "DEFINE SEQUENCE z TIMEOUT 0ns; RETURN sequence::nextval('z'); "
        "DEFINE SEQUENCE t TIMEOUT 'x'; "
        "ALTER SEQUENCE s TIMEOUT 5s; INFO FOR DB; "
        "CREATE q SET id = sequence::nextval('s'); SELECT * FROM q; "
        "REMOVE SEQUENCE s; RETURN sequence::nextval('s'); "
        "REMOVE SEQUENCE s; REMOVE SEQUENCE IF EXISTS s; "
        "DEFINE SEQUENCE s START 100; RETURN sequence::nextval('s')")
    both.same_items()


# -- ALTER ----------------------------------------------------------------------------


def test_alter_table_and_definitions(both):
    both.ok("DEFINE TABLE a SCHEMALESS; DEFINE FIELD f ON a TYPE int; "
            "DEFINE INDEX i ON a FIELDS f; DEFINE ANALYZER z TOKENIZERS blank")
    both.run(
        "ALTER TABLE a COMMENT 'one'; ALTER TABLE a SCHEMAFULL; "
        "ALTER TABLE a PERMISSIONS FOR select FULL FOR create NONE; "
        "ALTER TABLE nope COMMENT 'x'; ALTER TABLE IF EXISTS nope COMMENT 'x'; "
        "INFO FOR TABLE a; ALTER TABLE a DROP COMMENT; "
        "ALTER FIELD f ON a COMMENT 'field'; ALTER FIELD f ON a TYPE string; "
        "ALTER INDEX i ON a COMMENT 'ix'; ALTER ANALYZER z COMMENT 'az'; "
        "ALTER FIELD nope ON a COMMENT 'x'; INFO FOR TABLE a; INFO FOR DB; "
        "ALTER SYSTEM QUERY_TIMEOUT 5s; ALTER SYSTEM QUERY_TIMEOUT 'x'; "
        "INFO FOR ROOT; ALTER SYSTEM DROP QUERY_TIMEOUT; INFO FOR ROOT; "
        "ALTER DATABASE COMPACT; CREATE a:1 SET f = 'x'")
    both.same_items()


@pytest.mark.parametrize("stmt,kind", [
    ("ALTER CONFIG GRAPHQL TABLES AUTO", "ALTER CONFIG"),
    ("ALTER API '/x' COMMENT 'c'", "ALTER API"),
    ("ALTER BUCKET b COMMENT 'c'", "ALTER BUCKET"),
    ("ALTER TABLE t CHANGEFEED 1h", "CHANGEFEED"),
])
def test_alter_of_unported_kinds_names_them(both, stmt, kind):
    both.ok("DEFINE TABLE t")
    out = both.port.execute(stmt, ns=NS, db=DB)
    assert out[0].error is not None and "not ported" in out[0].error
    assert kind in out[0].error, out[0].error


# -- REBUILD INDEX ---------------------------------------------------------------------


def test_rebuild_standard_and_unique_indexes(both):
    both.ok("DEFINE INDEX f ON t FIELDS a; DEFINE INDEX u ON t FIELDS b "
            "UNIQUE; CREATE t:1 SET a = 1, b = 'x'; CREATE t:2 SET a = 1, "
            "b = 'y'")
    both.run("REBUILD INDEX f ON t; REBUILD INDEX u ON t; "
             "REBUILD INDEX nope ON t; REBUILD INDEX IF EXISTS nope ON t; "
             "SELECT id FROM t WHERE a = 1 ORDER BY id; "
             "CREATE t:3 SET b = 'x'; SELECT * FROM t WHERE b = 'y'")
    both.same_items()


def test_rebuild_vector_index_leaves_no_stale_store(both):
    """REBUILD of an HNSW index over the device path: the runner drops
    the old engine's store (`vec_drop`), the next query ships the rebuilt
    rows (`vec_load`) and answers as before."""
    rng = np.random.default_rng(5)
    n = MIN_ROWS * 2
    xs = rng.standard_normal((n, DIM)).astype(np.float32)
    both.ok(f"DEFINE INDEX ix ON v FIELDS emb HNSW DIMENSION {DIM} "
            "DIST COSINE TYPE F32")
    both.ok("FOR $r IN $rows { CREATE type::record('v', $r.i) SET emb = "
            "$r.emb }", {"rows": [{"i": i, "emb": xs[i].tolist()}
                                  for i in range(n)]})
    q = {"q": rng.standard_normal(DIM).astype(np.float32).tolist()}
    sql = "SELECT id, vector::distance::knn() AS d FROM v WHERE emb <|5,40|> $q"
    before = both.run(sql, q)
    assert "vec_knn" in both.ops
    both.ops.clear()
    both.run("REBUILD INDEX ix ON v")
    assert both.ops == ["vec_drop", "ann_drop"], both.ops
    after = both.run(sql, q)
    assert "vec_load" in both.ops and "vec_knn" in both.ops, both.ops
    same(norm([r.result for r in before]), norm([r.result for r in after]))
    both.same_items()


# -- the ACCESS statement ----------------------------------------------------------------


_GRANT_ID = re.compile(r"^[A-Za-z][0-9A-Za-z]{11}$")


def _masked(v):
    """A grant object (or a list of them) with its random id, key and
    times replaced by their shape."""
    if isinstance(v, list):
        return [_masked(x) for x in v]
    if not isinstance(v, dict):
        return v
    out = {}
    for k, x in v.items():
        if k == "id" and isinstance(x, str):
            assert _GRANT_ID.match(x), x
            x = "<id>"
        elif k == "key" and isinstance(x, str) and x != "[REDACTED]":
            assert re.match(r"^surreal-bearer-[0-9A-Za-z]{12}-[0-9A-Za-z]{24}$",
                            x), x
            x = "<key>"
        elif k in ("creation", "expiration", "revocation") and \
                type(x).__name__ == "Datetime":
            x = "<time>"
        out[k] = _masked(x)
    return out


def test_access_grants(both):
    both.ok("DEFINE USER u ON DATABASE PASSWORD 'p' ROLES VIEWER; "
            "DEFINE ACCESS api ON DATABASE TYPE BEARER FOR USER "
            "DURATION FOR GRANT 1d; "
            "DEFINE ACCESS rec ON DATABASE TYPE BEARER FOR RECORD; "
            "DEFINE ACCESS jwt ON DATABASE TYPE JWT ALGORITHM HS256 KEY 'k'")
    sql = ("ACCESS api GRANT FOR USER u; ACCESS api GRANT FOR USER nope; "
           "ACCESS rec GRANT FOR RECORD user:1; ACCESS api GRANT FOR RECORD "
           "user:1; ACCESS jwt GRANT FOR USER u; ACCESS nope SHOW ALL; "
           "ACCESS api SHOW ALL; ACCESS api REVOKE ALL; ACCESS api SHOW "
           "WHERE revocation != NONE; ACCESS api PURGE REVOKED; "
           "ACCESS api SHOW ALL")
    r = both.ref.execute(sql, ns=NS, db=DB)
    p = both.port.execute(sql, ns=NS, db=DB)
    assert len(r) == len(p)
    for a, b in zip(r, p):
        assert (a.error is None) == (b.error is None), (a.error, b.error)
        if a.error is not None:
            assert a.error == b.error
        else:
            same(norm(_masked(a.result)), norm(_masked(b.result)))


# -- crypto::, session:: ------------------------------------------------------------------


def test_crypto_digests(both):
    both.run("RETURN [crypto::md5('a'), crypto::sha1('a'), "
             "crypto::sha256('a'), crypto::sha512('a'), crypto::joaat('a'), "
             "crypto::blake3('a'), crypto::blake3(''), "
             "crypto::blake3(string::repeat('x', 3000))]; "
             "RETURN crypto::md5(1); RETURN crypto::sha256()")


@pytest.mark.parametrize("scheme", ["pbkdf2", "scrypt", "argon2", "bcrypt"])
def test_password_hashes_cross_package(both, scheme):
    """A hash one package generates, the other's compare accepts (and a
    wrong password it refuses)."""
    for gen, cmp_ in ((both.ref, both.port), (both.port, both.ref)):
        h = gen.query_one(f"RETURN crypto::{scheme}::generate('pw')",
                          ns=NS, db=DB)
        ok = cmp_.query_one(f"RETURN [crypto::{scheme}::compare($h, 'pw'), "
                            f"crypto::{scheme}::compare($h, 'no')]",
                            ns=NS, db=DB, vars={"h": h})
        assert ok == [True, False], (scheme, h)
    both.run(f"RETURN crypto::{scheme}::compare('garbage', 'pw')")


def test_password_hash_routes(monkeypatch):
    """Users' passhashes: argon2id where the package imports, else the
    reference's own `$scrypt$` form, which both packages read."""
    assert PM.password_hash("pw").startswith("$argon2id$")
    monkeypatch.setattr(PM, "argon2_available", lambda: False)
    h = PM.password_hash("pw")
    assert h.startswith("$scrypt$n=16384,r=8,p=1$")
    assert RM.password_compare(h, "pw") and not RM.password_compare(h, "x")
    assert PM.password_compare(h, "pw")


def test_session_functions(both):
    both.run("RETURN [session::ns(), session::db(), session::ac(), "
             "session::rd(), session::id(), session::ip(), "
             "session::origin(), session::token()]; "
             "USE NS other DB o2; RETURN [session::ns(), session::db()]")


def test_unported_function_families_stay_in_order():
    """The registry keeps the reference's order with the crypto::,
    session:: and sequence:: families ported and the rest named."""
    import surrealdb_tpu.fnc as R
    import surrealdb_tpu_torch.fnc as P
    from surrealdb_tpu_torch.fnc import unported

    assert list(R.FUNCS) == list(P.FUNCS)
    left = unported.UNPORTED_AFTER_SEARCH
    assert not [n for n in left if n.startswith(("crypto::", "session::",
                                                 "sequence::"))]
