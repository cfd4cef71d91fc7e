"""GraphQL of the port (`gql.py`, DEFINE CONFIG GRAPHQL, POST /graphql
and the rpc method `graphql`) against the reference's.

Each case runs the same GraphQL document through `execute_graphql` of
both packages over datastores that hold the same rows (made through
`torch_sql_harness.both`), and, over HTTP, through a server of each
package. Tolerance: exact. Answers compare after each package's JSON
(or CBOR) is decoded, with the keys of every object in the same order
(`torch_sql_harness.same` checks key order).
"""

import json
import threading
import urllib.request

import pytest

from surrealdb_tpu import wire as rwire
from surrealdb_tpu.gql import execute_graphql as ref_gql
from surrealdb_tpu.kvs.ds import Session as RefSession
from surrealdb_tpu.server import make_server as ref_make_server
from surrealdb_tpu_torch import wire as pwire
from surrealdb_tpu_torch.gql import execute_graphql as port_gql
from surrealdb_tpu_torch.kvs.ds import Session as PortSession
from surrealdb_tpu_torch.server import make_server as port_make_server
from torch_sql_harness import DB, NS, both, norm, same  # noqa: F401

SCHEMA = """
  DEFINE TABLE person SCHEMAFULL;
  DEFINE FIELD name ON person TYPE string;
  DEFINE FIELD age ON person TYPE int;
  DEFINE FIELD score ON person TYPE option<float>;
  DEFINE FIELD tags ON person TYPE option<array<string>>;
  DEFINE FIELD city ON person TYPE option<record<city>>;
  DEFINE TABLE city SCHEMAFULL; DEFINE FIELD name ON city TYPE string;
  DEFINE TABLE note;
  CREATE city:1 SET name = 'SF';
  CREATE city:2 SET name = 'NY';
  CREATE person:1 SET name = 'Ada', age = 36, city = city:1, score = 1.5,
    tags = ['a', 'b'];
  CREATE person:2 SET name = 'Bob', age = 41, city = city:2;
  CREATE person:3 SET name = 'Cy', age = 29;
  CREATE note:1 SET text = 'free form', n = 3;
  DEFINE FUNCTION fn::double($x: number) { RETURN $x * 2 };
  DEFINE FUNCTION fn::greet($who: string, $p: option<string>) {
    RETURN ($p ?? 'hi') + ' ' + $who };
"""


def _gql(both, doc, variables=None, level="owner"):
    """The same document through both packages; their answers equal."""
    out = []
    for gql, sess, ds in ((ref_gql, RefSession, both.ref),
                          (port_gql, PortSession, both.port)):
        try:
            got = gql(ds, sess(ns=NS, db=DB, auth_level=level), doc,
                      variables or {})
            out.append(norm(json.loads(json.dumps(got))))
        except Exception as e:  # each package's SdbError
            out.append(("err", type(e).__name__, str(e)))
    same(out[0], out[1])
    return out[1]


QUERIES = {
    "filter-ops": [
        "query { person(filter: {age: {gt: 30}}) { name age } }",
        "{ person(filter: {age: {gte: 36, lte: 40}}) { name } }",
        "{ person(filter: {name: \"Bob\"}) { name age } }",
        "{ person(filter: {name: {ne: \"Bob\"}, age: {lt: 40}}) { name } }",
        "{ person(filter: {tags: {contains: \"a\"}}) { name tags } }",
        "{ person(filter: {age: {eq: 29}}) { id name } }",
        "{ person(filter: {bad: {xx: 1}}) { name } }",
    ],
    "order-limit-start": [
        "{ person(order: \"age\", desc: true) { name } }",
        "{ person(order: \"name\", limit: 2) { name } }",
        "{ person(order: \"age\", limit: 1, start: 1) { name age } }",
        "{ a: person(id: \"1\") { name } b: city { name } }",
    ],
    "links": [
        "{ person(id: \"1\") { name city { name } } }",
        "{ person(order: \"age\") { name city { id name } } }",
        "{ city(id: \"2\") { id name } }",
    ],
    "schemaless": [
        "{ note { id text n } }",
    ],
    "errors": [
        "{ nosuch { id } }",
        "{ person { name ",
        "query Q($o: String) { person(order: $o) { name } }",
        "mutation { explode_person(id: \"1\") { name } }",
        "",
    ],
}


@pytest.mark.parametrize("case", list(QUERIES))
def test_queries(both, case):
    """Queries with filters, ordering, paging, aliases and record links,
    and the error answers."""
    both.ok(SCHEMA)
    for doc in QUERIES[case]:
        _gql(both, doc, {"o": "name LIMIT 1; REMOVE TABLE person"})
    both.same_items()


def test_mutations(both):
    """create_, update_ and delete_ mutations, then the rows they left."""
    both.ok(SCHEMA)
    for doc in [
        'mutation { create_person(data: {name: "Eve", age: 29}) { name age } }',
        'mutation { update_person(id: "1", data: {age: 37}) { name age } }',
        'mutation { delete_person(id: "2") { name } }',
        'mutation { create_note(data: {text: "x"}) { text } }',
        'mutation { update_person(id: "3", data: {age: "x"}) { name } }',
        'mutation M($d: Object) { create_city(data: $d) { name } }',
    ]:
        _gql(both, doc, {"d": {"name": "LA"}})
    both.ok("SELECT name, age FROM person ORDER BY name; "
            "SELECT text FROM note ORDER BY text; "
            "SELECT name FROM city ORDER BY name")


def test_introspection(both):
    """__schema and __type, built from the catalog."""
    both.ok(SCHEMA)
    out = _gql(both, "query { __schema { types } }")
    names = {t["name"] for t in out["data"]["__schema"]["types"]}
    assert {"person", "city", "Query", "Mutation"} <= names
    _gql(both, '{ __type(name: "person") { name } }')
    _gql(both, '{ __type(name: "nosuch") { name } }')


def test_config_limits_and_functions(both):
    """DEFINE CONFIG GRAPHQL: TABLES and FUNCTIONS (AUTO, INCLUDE,
    EXCLUDE, NONE), DEPTH and COMPLEXITY, and ALTER of them."""
    both.ok(SCHEMA)
    both.ok("DEFINE CONFIG GRAPHQL TABLES AUTO FUNCTIONS AUTO DEPTH 3 "
            "COMPLEXITY 10; INFO FOR DB")
    deep = "{ person { city { " + "x { " * 4 + "y" + " }" * 4 + " } } }"
    wide = "{ " + " ".join(f"a{i}: person {{ name }}" for i in range(9)) + " }"
    for doc in ["{ double(x: 21) }", '{ greet(who: "Al") }',
                '{ greet(who: "Al", p: "yo") }',
                '{ person(order: "age") { name } }', deep, wide]:
        _gql(both, doc)
    for cfg in ["TABLES INCLUDE person FUNCTIONS INCLUDE double",
                "TABLES EXCLUDE person, note FUNCTIONS EXCLUDE double",
                "TABLES NONE FUNCTIONS NONE"]:
        both.ok(f"DEFINE CONFIG OVERWRITE GRAPHQL {cfg}; INFO FOR DB")
        for doc in ["{ double(x: 2) }", '{ greet(who: "B") }',
                    "{ person { name } }", "{ city { name } }"]:
            _gql(both, doc)
    both.ok("ALTER CONFIG GRAPHQL TABLES AUTO; INFO FOR DB")
    both.run("REMOVE CONFIG GRAPHQL; REMOVE CONFIG GRAPHQL; INFO FOR DB")
    both.same_items()


# -- over HTTP: /graphql and rpc graphql ----------------------------------------------


class Served:
    def __init__(self, ds, make):
        self.srv = make(ds, "127.0.0.1", 0, unauthenticated=True)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _post(base, path, body, headers):
    r = urllib.request.Request(base + path, method="POST", data=body)
    for k, v in headers.items():
        r.add_header(k, v)
    with urllib.request.urlopen(r, timeout=15) as resp:
        return resp.status, resp.read()


@pytest.fixture()
def servers(both):
    both.ok(SCHEMA)
    pair = (Served(both.ref, ref_make_server),
            Served(both.port, port_make_server))
    try:
        yield pair
    finally:
        for s in pair:
            s.close()


DOCS = [
    ('{ person(order: "age") { name city { name } } }', {}),
    ('query Q($a: Int) { person(filter: {age: {gt: $a}}) { name } }',
     {"a": 30}),
    ('mutation { create_note(data: {text: "w"}) { text } }', {}),
    ('{ nosuch { id } }', {}),
]
NSDB = {"surreal-ns": NS, "surreal-db": DB}


@pytest.mark.parametrize("doc,variables", DOCS,
                         ids=["query", "variables", "mutation", "error"])
def test_graphql_route(servers, doc, variables):
    """POST /graphql answers the same status and JSON on both servers."""
    body = json.dumps({"query": doc, "variables": variables}).encode()
    hdrs = {**NSDB, "Content-Type": "application/json"}
    r = _post(servers[0].base, "/graphql", body, hdrs)
    p = _post(servers[1].base, "/graphql", body, hdrs)
    assert r[0] == p[0] == 200
    same(norm(json.loads(r[1])), norm(json.loads(p[1])))


@pytest.mark.parametrize("fmt", ["json", "cbor"])
@pytest.mark.parametrize("params", [
    [{"query": '{ person(order: "name") { name age } }'}],
    [{"query": 'query Q($n: String) { person(filter: {name: $n}) { age } }',
      "variables": {"n": "Ada"}}],
    ['{ city { name } }'],
    [],
], ids=["object", "variables", "string", "no-params"])
def test_rpc_graphql(servers, fmt, params):
    """The rpc method graphql over POST /rpc, in JSON and in CBOR."""
    got = []
    for served, wire in ((servers[0], rwire), (servers[1], pwire)):
        msg = {"id": 3, "method": "graphql", "params": params}
        if fmt == "cbor":
            body, hdrs = wire.encode(msg), {"Content-Type": "application/cbor",
                                            "Accept": "application/cbor"}
        else:
            body, hdrs = json.dumps(msg).encode(), \
                {"Content-Type": "application/json"}
        st, raw = _post(served.base, "/rpc", body, {**NSDB, **hdrs})
        got.append((st, norm(json.loads(raw) if fmt == "json"
                             else wire.decode(raw))))
    same(got[0], got[1])
    assert "not ported" not in json.dumps(got[1], default=str)
