"""The port's full-text search against the reference's: DEFINE ANALYZER,
FULLTEXT indexes and their postings, `@@` / `@N@`, the `search::`
functions and the hybrid (vector + full-text + rrf) script of the
reference's `bench.py bench_hybrid`. Each script runs through a
reference and a port datastore (`torch_sql_harness.both`), and the two
give the same results and hold the same KV items.

Tolerance: the harness's. Results compare normalised, floats (BM25
scores, fused scores, distances) with atol 1e-4 and rtol 1e-5, error
texts exactly; KV items key for key and value for value, the full-text
write version (`bv`) past one base given to both packages. Hit order is
compared exactly: where scores tie it is the posting's insertion order
in both packages.
"""

import math
import time

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore
from torch_sql_harness import (  # noqa: F401  (both is a fixture)
    DB,
    NS,
    _results,
    both,
    same,
)

# the vocabulary and the script of bench.py bench_hybrid
WORDS = ["graph", "vector", "index", "query", "search", "database",
         "tensor", "shard", "batch", "kernel"]
HYBRID = (
    "LET $vs = SELECT id, vector::distance::knn() AS distance FROM doc "
    "WHERE emb <|10,40|> $q;"
    "LET $ft = SELECT id, search::score(1) AS ft_score FROM doc "
    "WHERE text @1@ 'graph' ORDER BY ft_score DESC LIMIT 10;"
    "RETURN search::rrf([$vs, $ft], 10, 60);"
)

CORPUS = [
    "The quick brown fox jumps over the lazy dog",
    "A lazy afternoon: dogs sleeping, foxes running",
    "Graph databases index relations; vector databases index embeddings",
    "Running quickly, the runner ran past the dog park",
    "Élan vital — café au lait, naïve façade",
    "camelCaseWords and snake_case_words, mixedUP Text",
    "Search engines rank documents with BM25 scores",
    "completely unrelated line about tensors and kernels",
]


def _rows(texts):
    return [{"id": i, "text": t} for i, t in enumerate(texts)]


def _post_keys(ds, tb, ix):
    t = ds.transaction(write=False)
    try:
        pre = PK.ix_state(NS, DB, tb, ix, b"")
        return [k for k, _ in t.scan(*PK.prefix_range(pre))]
    finally:
        t.cancel()


def test_fulltext_index_writes_postings(both):
    """A FULLTEXT index writes the reference's postings (`bf` per term,
    `bl` per document, `bs` stats, `bv` version) and never the plain
    index entries."""
    both.ok("DEFINE INDEX ft ON doc FIELDS text FULLTEXT BM25; "
            "CREATE doc:1 SET text = 'hello world'; "
            "CREATE doc:2 SET text = 'hello there'")
    both.same_items()
    kinds = [k[len(PK.ix_state(NS, DB, "doc", "ft", b"")):][:2]
             for k in _post_keys(both.port, "doc", "ft")]
    assert kinds.count(b"bf") == 3 and kinds.count(b"bl") == 2
    assert b"bs" in kinds and b"bv" in kinds
    t = both.port.transaction(write=False)
    try:
        plain = list(t.scan(*PK.prefix_range(
            PK.index_prefix(NS, DB, "doc", "ft"))))
    finally:
        t.cancel()
    assert plain == []


ANALYZERS = {
    "blank": "TOKENIZERS blank",
    "class": "TOKENIZERS class",
    "camel": "TOKENIZERS camel",
    "punct": "TOKENIZERS punct",
    "blank-class-camel-punct": "TOKENIZERS blank, class, camel, punct",
    "lowercase": "TOKENIZERS blank FILTERS lowercase",
    "uppercase": "TOKENIZERS blank FILTERS uppercase",
    "ascii": "TOKENIZERS blank FILTERS ascii",
    "snowball": "TOKENIZERS blank FILTERS lowercase, snowball(english)",
    "edgengram": "TOKENIZERS blank FILTERS lowercase, edgengram(2,4)",
    "ngram": "TOKENIZERS class FILTERS ngram(1,3)",
    "chain": "TOKENIZERS blank, class FILTERS ascii, lowercase, "
             "snowball(english), edgengram(1,3)",
}


@pytest.mark.parametrize("name", list(ANALYZERS))
def test_analyzers_through_search_analyze(both, name):
    both.ok(f"DEFINE ANALYZER a {ANALYZERS[name]}")
    for text in CORPUS:
        out = both.ok("RETURN search::analyze('a', $t)", {"t": text})
        assert isinstance(out[0], list)
    both.run("RETURN search::analyze('nope', 'x'); "
             "RETURN search::analyze('a', 3); INFO FOR DB")
    both.same_items()


@pytest.mark.parametrize("bm25", ["BM25", "BM25(1.5,0.3)", "BM25(0.8,1)"])
def test_writes_maintain_postings(both, bm25):
    """CREATE, INSERT, UPDATE and DELETE on an indexed table: postings,
    lengths and stats follow each write, and the scores read them."""
    both.ok("DEFINE ANALYZER en TOKENIZERS blank, class "
            "FILTERS lowercase, snowball(english); "
            f"DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER en "
            f"{bm25} HIGHLIGHTS")
    both.ok("CREATE doc:0 SET text = $t", {"t": CORPUS[0]})
    both.ok("INSERT INTO doc $rows", {"rows": _rows(CORPUS)[1:]})
    both.same_items()
    q = ("SELECT id, search::score(1) AS s FROM doc WHERE text @1@ $w "
         "ORDER BY s DESC, id")
    for w in ("dog", "lazy fox", "databases", "run", "zebra"):
        both.ok(q, {"w": w})
    both.ok("UPDATE doc:1 SET text = 'no animals here'; "
            "UPDATE doc:3 SET text = text + ' and the dog again'; "
            "DELETE doc:0; UPSERT doc:9 SET text = 'dog dog dog'")
    both.same_items()
    for w in ("dog", "lazy", "animals"):
        both.ok(q, {"w": w})
    both.ok("DELETE doc")
    both.same_items()


def test_match_operators_and_search_functions(both):
    both.ok("DEFINE ANALYZER en TOKENIZERS blank, class "
            "FILTERS lowercase, snowball(english); "
            "DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER en "
            "BM25 HIGHLIGHTS; DEFINE INDEX ft2 ON doc FIELDS title "
            "FULLTEXT ANALYZER en BM25 HIGHLIGHTS")
    rows = [{"id": i, "text": t, "title": CORPUS[-1 - i], "n": i}
            for i, t in enumerate(CORPUS)]
    both.ok("INSERT INTO doc $rows", {"rows": rows})
    both.ok(
        "SELECT id FROM doc WHERE text @@ 'dog' ORDER BY id; "
        "SELECT id, search::score(1) AS s FROM doc WHERE text @1@ 'lazy dog' "
        "ORDER BY s DESC, id; "
        "SELECT id, search::score(0) AS a, search::score(1) AS b FROM doc "
        "WHERE text @0@ 'dog' AND title @1@ 'tensors' ORDER BY id; "
        "SELECT id FROM doc WHERE text @0@ 'dog' OR title @1@ 'dog' "
        "ORDER BY id; "
        "SELECT id FROM doc WHERE text @@ 'dog' AND n > 2 ORDER BY id; "
        "SELECT id, search::highlight('<b>', '</b>', 1) AS h, "
        "search::offsets(1) AS o FROM doc WHERE text @1@ 'lazy dogs' "
        "ORDER BY id; "
        "SELECT id, search::highlight('[', ']', 1, true) AS h FROM doc "
        "WHERE text @1@ 'databases index' ORDER BY id; "
        "SELECT id, search::score(1) AS s FROM doc WHERE text @1@ 'dog' "
        "ORDER BY s DESC LIMIT 2; "
        "SELECT VALUE id FROM doc WHERE text @AND@ 'lazy dog'; "
        "SELECT VALUE id FROM doc WHERE text @OR@ 'lazy graph' ORDER BY id; "
        "SELECT count() FROM doc WHERE text @@ 'the' GROUP ALL")
    both.ok(
        "LET $a = SELECT id, search::score(1) AS ft_score FROM doc "
        "WHERE text @1@ 'dog' ORDER BY ft_score DESC; "
        "LET $b = SELECT id, search::score(1) AS score FROM doc "
        "WHERE title @1@ 'dog lazy' ORDER BY score DESC; "
        "RETURN search::rrf([$a, $b], 5, 60); "
        "RETURN search::rrf([$a, $b], 3, 1); "
        "RETURN search::linear([$a, $b], [1, 2], 5, 'minmax'); "
        "RETURN search::linear([$a, $b], [0.5, 0.5], 4, 'zscore')")
    both.run("RETURN search::rrf([], 0); RETURN search::rrf([], 2, -1); "
             "RETURN search::linear([[]], [1, 2], 3); "
             "RETURN search::linear([[]], [1], 3, 'l2'); "
             "RETURN search::linear([[]], ['a'], 3)")


def test_match_and_knn(both):
    """A match ANDed with a KNN, the KNN on the device path."""
    rng = np.random.default_rng(3)
    n, dim = 200, 8
    both.ok("DEFINE ANALYZER s TOKENIZERS class FILTERS lowercase; "
            "DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER s BM25; "
            f"DEFINE INDEX hx ON doc FIELDS emb HNSW DIMENSION {dim} "
            "DIST EUCLIDEAN TYPE F32")
    rows = [{"id": i, "text": " ".join(rng.choice(WORDS, size=3)),
             "emb": rng.normal(size=dim).astype(np.float32).tolist()}
            for i in range(n)]
    both.ok("INSERT INTO doc $rows RETURN NONE", {"rows": rows})
    q = {"q": rng.normal(size=dim).astype(np.float32).tolist()}
    both.ok("SELECT id, vector::distance::knn() AS d FROM doc "
            "WHERE emb <|5|> $q AND text @@ 'graph'; "
            "SELECT id, search::score(1) AS s FROM doc "
            "WHERE text @1@ 'graph' AND emb <|8,40|> $q ORDER BY id", q)
    assert "vec_knn" in both.ops
    both.same_items()


def test_selective_terms_score_nonzero(both):
    """Rare terms in a larger corpus: positive idf, so the BM25 scores
    are not zero and the ORDER BY score follows them."""
    rng = np.random.default_rng(11)
    texts = [" ".join(rng.choice(WORDS, size=6)) for _ in range(60)]
    texts[7] += " zebra"
    texts[21] += " zebra zebra okapi"
    texts[40] += " okapi"
    both.ok("DEFINE ANALYZER s TOKENIZERS blank FILTERS lowercase; "
            "DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER s "
            "BM25(1.2,0.75)")
    both.ok("INSERT INTO doc $rows", {"rows": _rows(texts)})
    res = both.ok("SELECT id, search::score(1) AS s FROM doc "
                  "WHERE text @1@ 'zebra okapi' ORDER BY s DESC; "
                  "SELECT id, search::score(1) AS s FROM doc "
                  "WHERE text @1@ 'zebra' ORDER BY s DESC LIMIT 1; "
                  "SELECT VALUE id FROM doc "
                  "WHERE text @OR@ 'okapi zebra' ORDER BY id")
    assert [r["id"].id for r in res[0]] == [21]
    assert res[0][0]["s"] > 0 and res[1][0]["id"].id == 21
    assert [r.id for r in res[2]] == [7, 21, 40]


@pytest.mark.parametrize("mode", ["inline", "concurrently"])
def test_define_index_over_existing_rows(both, mode):
    both.ok("DEFINE ANALYZER en TOKENIZERS blank FILTERS lowercase, "
            "snowball(english)")
    both.ok("INSERT INTO doc $rows", {"rows": _rows(CORPUS)})
    tail = " CONCURRENTLY" if mode == "concurrently" else ""
    both.ok("DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER en BM25 "
            f"HIGHLIGHTS{tail}")
    for ds in (both.ref, both.port):
        key = (NS, DB, "doc", "ft")
        deadline = time.monotonic() + 30
        while ds.index_builds.get(key, {}).get("status") != "ready":
            assert time.monotonic() < deadline, ds.index_builds.get(key)
            time.sleep(0.01)
    both.same_items()
    both.ok("SELECT id, search::score(1) AS s FROM doc "
            "WHERE text @1@ 'dogs' ORDER BY id; INFO FOR INDEX ft ON doc")
    both.run("REMOVE INDEX ft ON doc; SELECT id FROM doc WHERE text @@ 'dog'; "
             "REMOVE ANALYZER en; REMOVE ANALYZER en; "
             "REMOVE ANALYZER IF EXISTS en; INFO FOR DB")
    both.same_items()


def test_error_texts(both):
    both.ok("CREATE doc:1 SET text = 'a b'")
    both.run("DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER nope BM25; "
             "SELECT * FROM doc WHERE text @@ 'a'; "
             "SELECT * FROM doc WHERE text @1@ 'a'; "
             "DEFINE ANALYZER a TOKENIZERS blank; "
             "DEFINE ANALYZER a TOKENIZERS blank; "
             "DEFINE ANALYZER IF NOT EXISTS a TOKENIZERS class; "
             "DEFINE ANALYZER OVERWRITE a TOKENIZERS class FILTERS uppercase; "
             "RETURN search::score(1); RETURN search::highlight('<', '>', 1)")
    both.same_items()
    # an analyzer FUNCTION runs its fn:: function (DEFINE FUNCTION), and
    # one that is missing or returns no string fails as the reference's
    both.run("DEFINE ANALYZER f FUNCTION fn::up TOKENIZERS blank; "
             "RETURN search::analyze('f', 'x'); "
             "DEFINE FUNCTION fn::up($s: string) { RETURN "
             "string::uppercase($s) }; RETURN search::analyze('f', 'x y'); "
             "DEFINE FUNCTION OVERWRITE fn::up($s: string) { RETURN 1 }; "
             "RETURN search::analyze('f', 'x')")
    out = both.port.execute("RETURN search::analyze('f', 'x')", ns=NS, db=DB)
    assert "not ported" not in out[0].error and "fn::" not in out[0].error


def _bm25(texts, term, k1=1.2, b=0.75):
    """The reference's BM25 (idx/fulltext.py _ft_search_impl) over
    whitespace tokens: clamped idf, tf' = 1 + ln(tf)."""
    toks = [t.split() for t in texts]
    n = len(toks)
    avg = sum(len(t) for t in toks) / n
    df = sum(1 for t in toks if term in t)
    idf = max(math.log((n - df + 0.5) / (df + 0.5)), 0.0)
    out = {}
    for i, t in enumerate(toks):
        tf = t.count(term)
        if tf:
            tfp = 1.0 + math.log(tf)
            norm = (1 - b) + b / avg * len(t)
            out[i] = float(np.float32(idf * (k1 + 1) * tfp / (tfp + k1 * norm)))
    return out


def test_bench_hybrid_script(both):
    """bench.py bench_hybrid's setup and script at 300 documents and
    D=16 (ids given, so both packages hold the same rows): its vector
    leg takes the inline host's device path."""
    n, dim = 300, 16
    both.ok("DEFINE ANALYZER simple TOKENIZERS class FILTERS lowercase;"
            "DEFINE INDEX ft ON doc FIELDS text FULLTEXT ANALYZER simple BM25;"
            f"DEFINE INDEX hx ON doc FIELDS emb HNSW DIMENSION {dim} "
            "DIST COSINE TYPE F32")
    rng = np.random.default_rng(23)
    texts = []
    for i in range(n):
        text = " ".join(rng.choice(WORDS, size=8))
        texts.append(text)
        emb = rng.normal(size=dim).astype(np.float32)
        both.ok(f"CREATE doc:{i} CONTENT {{ text: $t, emb: $e }}",
                {"t": text, "e": emb.tolist()})
    q = {"q": rng.normal(size=dim).astype(np.float32).tolist()}
    both.ops.clear()
    res = both.ok(HYBRID, q)
    assert "vec_knn" in both.ops
    fused = res[-1]
    assert len(fused) == 10
    both.same_items()
    # the full-text leg against a BM25 in numpy: every word is in more
    # than half the documents, so the clamped idf makes each score 0
    res = both.ok("SELECT id, search::score(1) AS ft_score FROM doc "
                  "WHERE text @1@ 'graph' ORDER BY ft_score DESC LIMIT 10", q)
    want = _bm25(texts, "graph")
    for r in res[0]:
        assert "graph" in texts[r["id"].id].split()
        assert r["ft_score"] == pytest.approx(want[r["id"].id], abs=1e-6)


def test_reference_file_store_reopened_by_the_port(tmp_path, both):
    """A `file://` datastore the reference wrote, with an analyzer and a
    full-text index, reopened by the port: `@@`, scores, highlights and
    INFO answer as the reference does, and the port's writes keep the
    postings the reference's would."""
    path = f"file://{tmp_path / 'db'}"
    ref = RefDatastore(path)
    ref.execute("DEFINE ANALYZER en TOKENIZERS blank, class FILTERS "
                "lowercase, snowball(english); DEFINE INDEX ft ON doc FIELDS "
                "text FULLTEXT ANALYZER en BM25 HIGHLIGHTS; "
                "INSERT INTO doc $rows", ns=NS, db=DB,
                vars={"rows": _rows(CORPUS)})
    sql = ("SELECT id, search::score(1) AS s, search::highlight('<b>', "
           "'</b>', 1) AS h FROM doc WHERE text @1@ 'dog' ORDER BY id; "
           "SELECT VALUE id FROM doc WHERE text @@ 'lazy' ORDER BY id; "
           "INFO FOR DB; INFO FOR TABLE doc")
    want = _results(ref.execute(sql, ns=NS, db=DB))
    ref.close()
    port = PortDatastore(path)
    try:
        same(want, _results(port.execute(sql, ns=NS, db=DB)))
        out = port.execute("CREATE doc:100 SET text = 'another dog'; "
                           "SELECT VALUE id FROM doc WHERE text @@ 'dog' "
                           "ORDER BY id", ns=NS, db=DB)
        assert [r.id for r in out[1].result] == [0, 1, 3, 100]
    finally:
        port.close()


def test_result_cache_is_bounded(both, monkeypatch):
    """The full-text result cache holds at most its entry cap, and a
    write (a new `bv`) misses it, in both packages."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "FT_CACHE_ENTRIES", 2)
    ref, port = RefDatastore("memory"), PortDatastore("memory")
    try:
        for ds in (ref, port):
            ds.execute("DEFINE INDEX ft ON doc FIELDS text FULLTEXT BM25; "
                       "INSERT INTO doc $rows", ns=NS, db=DB,
                       vars={"rows": _rows(CORPUS)})
            for w in ("dog", "lazy", "fox", "dog"):
                ds.execute("SELECT id FROM doc WHERE text @@ $w", ns=NS,
                           db=DB, vars={"w": w})
        assert len(port._ft_cache) == len(ref._ft_cache) == 2
        assert port._ft_cache.evictions == ref._ft_cache.evictions
        assert port.telemetry.get("ft_cache_evictions") == \
            port._ft_cache.evictions
    finally:
        ref.close()
        port.close()
