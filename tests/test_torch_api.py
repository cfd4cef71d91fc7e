"""DEFINE API, `api::invoke`, the `/api/*` route, buckets with the
`file::` family and the `http::` family of the port (`api.py`,
`buc.py`, `fnc/misc_fns.py`, `server/__init__.py`) against the
reference's.

Each case feeds the same statements to a reference and a port datastore
(`torch_sql_harness.both`) and compares their results, errors and KV
items; the HTTP cases send the same requests to a server of each package
over those datastores. Tolerance: the harness's (floats atol 1e-4, rtol
1e-5, everything else exact); HTTP status, content type and body bytes
compare exactly. KNN ids compare exactly.
"""

import http.server
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from surrealdb_tpu import capabilities as rcaps
from surrealdb_tpu.server import make_server as ref_make_server
from surrealdb_tpu_torch import capabilities as pcaps
from surrealdb_tpu_torch.server import make_server as port_make_server
from torch_sql_harness import DIM, NS, DB, both, norm, same  # noqa: F401


def _vectors(n, dim=DIM, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


# -- paths and routing ----------------------------------------------------------


def test_path_typing_and_specificity(both):
    """Static beats a typed parameter beats a catch-all; a typed segment
    that does not coerce falls through to the next match."""
    both.ok("""
      DEFINE API "/u/fixed" FOR get THEN { { body: { m: 'fixed' } } };
      DEFINE API "/u/:id<number>" FOR get THEN { { body: { id: $request.params.id } } };
      DEFINE API "/u/:flag<bool>/x" FOR get THEN { { body: { f: $request.params.flag } } };
      DEFINE API "/u/*rest" FOR get THEN { { body: { rest: $request.params.rest } } };
      DEFINE API "/v/\\\\:lit" FOR get THEN { { body: 'lit' } };
      DEFINE API "/w/:name" FOR get, post THEN { { body: $request } };
    """)
    for path in ["/u/fixed", "/u/42", "/u/4.5", "/u/true/x", "/u/maybe/x",
                 "/u/a/b", "/u", "/nope", "/v/:lit", "/w/bob"]:
        res = both.ok(f"RETURN api::invoke('{path}')")
        assert res[0]["status"] in (200, 404)
    both.ok("RETURN api::invoke('/w/amy', { method: 'post', "
            "query: { a: '1' }, headers: { 'x-h': 'v' }, body: 5, "
            "params: { extra: 1 }, context: { c: true } })")
    both.same_items()


def test_define_path_validation_and_ddl(both):
    """DEFINE API's path checks, IF NOT EXISTS / OVERWRITE, ALTER and
    REMOVE, and INFO FOR DB's rendering of each."""
    both.run('DEFINE API "" FOR get THEN { 1 }; '
             'DEFINE API "nope" FOR get THEN { 1 }')
    both.run("""
      DEFINE API "/a" FOR get THEN { { body: 1 } } COMMENT 'one';
      DEFINE API "/a" FOR get THEN { { body: 2 } };
      DEFINE API IF NOT EXISTS "/a" FOR get THEN { { body: 3 } };
      DEFINE API OVERWRITE "/a" FOR get, put MIDDLEWARE api::res::status(201)
        THEN { { body: 4 } } FOR any THEN { { body: 'any' } };
      INFO FOR DB;
      ALTER API "/a" COMMENT 'c2';
      ALTER API "/a" FOR post THEN { { body: 'p' } };
      ALTER API "/a" FOR any THEN { { body: 'any2' } };
      ALTER API IF EXISTS "/zz" COMMENT 'x';
      ALTER API "/zz" COMMENT 'x';
      INFO FOR DB;
      RETURN [api::invoke('/a'), api::invoke('/a', { method: 'post' }),
              api::invoke('/a', { method: 'delete' })];
      ALTER API "/a" DROP FOR get, put;
      RETURN [api::invoke('/a'), api::invoke('/a', { method: 'put' })];
      INFO FOR DB;
      REMOVE API "/a"; REMOVE API "/a"; REMOVE API IF EXISTS "/a";
      INFO FOR DB
    """)
    both.same_items()


def test_define_config_api_and_default(both):
    """DEFINE / ALTER / REMOVE CONFIG for API (middleware and
    permissions) and DEFAULT, with INFO FOR DB and FOR ROOT."""
    both.run("""
      DEFINE CONFIG API MIDDLEWARE api::res::header('x-cfg', 'on')
        PERMISSIONS FULL;
      DEFINE CONFIG API PERMISSIONS NONE;
      DEFINE CONFIG OVERWRITE API MIDDLEWARE api::res::header('x-cfg', 'two');
      DEFINE API "/c" FOR get THEN { { body: 1 } };
      RETURN api::invoke('/c');
      INFO FOR DB;
      ALTER CONFIG API PERMISSIONS NONE;
      ALTER CONFIG IF EXISTS GRAPHQL TABLES AUTO;
      ALTER CONFIG GRAPHQL TABLES AUTO;
      INFO FOR DB;
      DEFINE CONFIG DEFAULT NAMESPACE 'n1' DATABASE 'd1';
      INFO FOR ROOT;
      ALTER CONFIG DEFAULT NAMESPACE 'n2';
      REMOVE CONFIG DEFAULT;
      REMOVE CONFIG API; REMOVE CONFIG API; REMOVE CONFIG IF EXISTS API;
      INFO FOR DB
    """)
    both.same_items()


# -- middleware -------------------------------------------------------------------

MIDDLEWARE = {
    "chain-order": (
        """DEFINE FUNCTION fn::tag($req: object, $next: function, $t: string) {
             LET $req = $req + { body: ($req.body ?? {}) + {
               order: array::append($req.body.order ?? [], $t) } };
             RETURN $next($req);
           };
           DEFINE CONFIG API MIDDLEWARE fn::tag('db');
           DEFINE API "/m"
             FOR any MIDDLEWARE fn::tag('any')
               THEN { { body: { order: $request.body.order } } }
             FOR get MIDDLEWARE fn::tag('get')
               THEN { { body: { order: $request.body.order } } };""",
        ["{}", "{ method: 'put' }"]),
    "req-body": (
        """DEFINE API "/m" FOR post MIDDLEWARE api::req::body('json')
             THEN { { body: { got: $request.body } } };""",
        ["{ method: 'post', headers: { 'content-type': 'application/json' }, "
         "body: <bytes>'{\"a\": [1, 2.5, \"x\"]}' }",
         "{ method: 'post', headers: { 'content-type': 'application/json' }, "
         "body: <bytes>'{\"a\": null}' }",
         "{ method: 'post', headers: { 'content-type': 'text/plain' }, "
         "body: <bytes>'{}' }",
         "{ method: 'post', body: <bytes>'{}' }",
         "{ method: 'post', headers: { 'content-type': 'application/json' }, "
         "body: 'not bytes' }",
         "{ method: 'post', headers: { 'content-type': 'application/json' }, "
         "body: <bytes>'{bad' }"]),
    "req-body-auto": (
        """DEFINE API "/m" FOR post MIDDLEWARE api::req::body()
             THEN { { body: { got: $request.body } } };""",
        ["{ method: 'post', headers: { 'Content-Type': 'text/plain' }, "
         "body: <bytes>'hi' }",
         "{ method: 'post', headers: { 'content-type': "
         "'application/octet-stream' }, body: <bytes>'hi' }",
         "{ method: 'post', headers: { 'content-type': 'image/png' }, "
         "body: <bytes>'hi' }",
         "{ method: 'post', body: 'raw' }"]),
    "res-body": (
        """DEFINE API "/m" FOR get MIDDLEWARE api::res::body('json')
             THEN { { body: { a: 1, b: [true, 'x'] } } };
           DEFINE API "/p" FOR get MIDDLEWARE api::res::body('plain')
             THEN { { body: 'text' } };
           DEFINE API "/n" FOR get MIDDLEWARE api::res::body()
             THEN { { body: { a: 1 } } };
           DEFINE API "/b" FOR get MIDDLEWARE api::res::body('bytes')
             THEN { { body: <bytes>'raw' } };
           DEFINE API "/c" FOR get MIDDLEWARE api::res::body('cbor')
             THEN { { body: { a: 1 } } };""",
        ["{}", "{ headers: { accept: 'text/plain' } }",
         "{ headers: { accept: 'application/*' } }",
         "{ headers: { accept: '*/*' } }"],
        ["/m", "/p", "/n", "/b", "/c"]),
    "res-status-headers": (
        """DEFINE API "/m" FOR get
             MIDDLEWARE api::res::status(404), api::res::header('x-a', 'b'),
               api::res::headers({ 'x-b': 'c', 'x-gone': NONE })
             THEN { { status: 200, body: {}, headers: { 'x-gone': 'no' } } };
           DEFINE API "/bad" FOR get MIDDLEWARE api::res::status(99)
             THEN { { body: {} } };
           DEFINE API "/hdr" FOR get MIDDLEWARE api::res::header('x y', 'b')
             THEN { { body: {} } };
           DEFINE API "/own" FOR get THEN { { status: 1000, body: 1 } };""",
        ["{}"], ["/m", "/bad", "/hdr", "/own"]),
    "timeout-max-body": (
        """DEFINE API "/m" FOR post MIDDLEWARE api::timeout(1s),
             api::req::max_body(4) THEN { { body: 'ok' } };
           DEFINE API "/slow" FOR get MIDDLEWARE api::timeout(1ms)
             THEN { SLEEP 20ms; { body: 'late' } };""",
        ["{ method: 'post', body: <bytes>'abc' }",
         "{ method: 'post', body: <bytes>'abcdef' }", "{}"],
        ["/m", "/slow"]),
    "unknown-middleware": (
        """DEFINE API "/m" FOR get MIDDLEWARE api::nope()
             THEN { { body: 1 } };""", ["{}"]),
    "throwing": (
        """DEFINE FUNCTION fn::boom($req: object, $next: function) { THROW 'x' };
           DEFINE API "/m" FOR get MIDDLEWARE fn::boom() THEN { { body: {} } };
           DEFINE API "/t" FOR get THEN { THROW 'handler' };
           DEFINE API "/r" FOR get THEN { RETURN { body: 'early' }; };
           DEFINE API "/v" FOR get THEN { 'a plain value' };""",
        ["{}"], ["/m", "/t", "/r", "/v"]),
}


@pytest.mark.parametrize("case", list(MIDDLEWARE))
def test_middleware(both, case):
    """Each built-in middleware and a custom `fn::` one (with `$next`),
    their error statuses, and throwing handlers (a 500 with no body)."""
    spec = MIDDLEWARE[case]
    ddl, opts = spec[0], spec[1]
    paths = spec[2] if len(spec) > 2 else ["/m"]
    both.ok(ddl)
    calls = ", ".join(f"api::invoke('{p}', {o})" for p in paths for o in opts)
    out = both.ok(f"RETURN [{calls}]")
    assert len(out[0]) == len(paths) * len(opts)
    both.same_items()


def test_permissions_for_record_and_anonymous_sessions(both):
    """Method, route and config permissions gate record and anonymous
    sessions; system users pass."""
    both.ok("""
      DEFINE API "/deny" FOR get PERMISSIONS NONE THEN { { body: {} } };
      DEFINE API "/allow" FOR get PERMISSIONS FULL
        THEN { { body: { ok: true } } };
      DEFINE API "/cond" FOR get PERMISSIONS WHERE $auth = NONE
        THEN { { body: 'c' } }
        FOR any PERMISSIONS WHERE $auth != NONE THEN { { body: 'a' } };
      DEFINE API "/any" FOR any PERMISSIONS NONE THEN { { body: 'a' } }
        FOR put THEN { { body: 'p' } };
    """)
    sql = ("RETURN [api::invoke('/deny'), api::invoke('/allow'), "
           "api::invoke('/cond'), api::invoke('/any', { method: 'put' })]")
    for level in ("record", "none", "owner", "viewer"):
        both.ok(sql, auth_level=level)
    both.ok("DEFINE CONFIG API PERMISSIONS NONE")
    both.ok(sql, auth_level="record")
    both.ok(sql, auth_level="owner")


def test_api_invoke_reaches_the_device_store(both):
    """A handler's `<|k,ef|>` query over the lowered device floor goes
    through the port's device host, and answers the plain query's ids."""
    xs = _vectors(300)
    both.ok(f"DEFINE TABLE acl; DEFINE INDEX ix ON acl FIELDS emb HNSW "
            f"DIMENSION {DIM} DIST COSINE TYPE F32")
    both.ok("INSERT INTO acl $rows RETURN NONE",
            {"rows": [{"id": i, "emb": xs[i].tolist()} for i in range(300)]})
    both.ok("""DEFINE API "/nearest" FOR post
               MIDDLEWARE api::req::body('json')
               THEN { {
                 status: 200,
                 body: (SELECT id FROM acl WHERE emb <|10,40|> $request.body.q)
               } };""")
    del both.ops[:]
    for q in _vectors(4, seed=9):
        body = json.dumps({"q": q.tolist()})
        out = both.ok(
            "RETURN api::invoke('/nearest', { method: 'post', "
            "headers: { 'content-type': 'application/json' }, body: $b }); "
            "SELECT id FROM acl WHERE emb <|10,40|> $q",
            {"b": body.encode(), "q": q.tolist()})
        assert out[0]["status"] == 200
        assert [r["id"] for r in out[0]["body"]] == [r["id"] for r in out[1]]
        assert len(out[1]) == 10
    assert both.ops.count("vec_knn") >= 8
    both.same_items()


# -- the /api/* route over HTTP ----------------------------------------------------


class Served:
    def __init__(self, ds, make):
        self.srv = make(ds, "127.0.0.1", 0, unauthenticated=True)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _req(base, path, method="GET", body=None, headers=None):
    r = urllib.request.Request(base + path, method=method, data=body)
    for k, v in (headers or {}).items():
        r.add_header(k, v)
    try:
        with urllib.request.urlopen(r, timeout=15) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.headers.get("x-a"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("x-a"), \
            e.read()


@pytest.fixture()
def servers(both):
    pair = (Served(both.ref, ref_make_server),
            Served(both.port, port_make_server))
    try:
        yield pair
    finally:
        for s in pair:
            s.close()


HTTP_CASES = [
    ("GET", "/api/t/t/hello", None, {}),
    ("POST", "/api/t/t/echo", b'{"x": [1, 2]}',
     {"Content-Type": "application/json"}),
    ("PUT", "/api/t/t/echo", b'{"x": 1}',
     {"Content-Type": "application/json"}),
    ("PATCH", "/api/t/t/echo", b"{}", {"Content-Type": "application/json"}),
    ("DELETE", "/api/t/t/hello", None, {}),
    ("GET", "/api/t/t/text", None, {}),
    ("GET", "/api/t/t/bytes", None, {}),
    ("GET", "/api/t/t/cbor", None, {"Accept": "application/cbor"}),
    ("GET", "/api/t/t/cbor", None, {"Accept": "image/png"}),
    ("GET", "/api/t/t/q?a=1&b=2&b=3", None, {}),
    ("GET", "/api/t/t/nope", None, {}),
    ("GET", "/api/t/t", None, {}),
    ("GET", "/api/t/other/hello", None, {}),
    ("GET", "/api/t/t/boom", None, {}),
]


@pytest.mark.parametrize("method,path,body,headers", HTTP_CASES,
                         ids=[f"{m} {p}" for m, p, _b, _h in HTTP_CASES])
def test_api_route_over_http(both, servers, method, path, body, headers):
    """Each server answers the same status, content type, header and
    body bytes for the same request."""
    both.ok("""
      DEFINE API "/hello" FOR get, delete
        MIDDLEWARE api::res::header('x-a', 'hi')
        THEN { { status: 200, body: { hello: 'world', m: $request.method } } };
      DEFINE API "/echo" FOR post, put, patch MIDDLEWARE api::req::body('json')
        THEN { { status: 201, body: { got: $request.body,
                                      m: $request.method } } };
      DEFINE API "/text" FOR get THEN { { body: 'plain text' } };
      DEFINE API "/bytes" FOR get THEN { { body: <bytes>'raw' } };
      DEFINE API "/cbor" FOR get MIDDLEWARE api::res::body()
        THEN { { body: { a: 1 } } };
      DEFINE API "/q" FOR get THEN { { body: $request.query } };
      DEFINE API "/boom" FOR get THEN { THROW 'no' };
    """)
    r = _req(servers[0].base, path, method, body, headers)
    p = _req(servers[1].base, path, method, body, headers)
    assert r == p, (r, p)


def test_api_route_reaches_the_device_store(both, servers):
    """POST /api/t/t/nearest answers the in-process `<|10,40|>` ids."""
    xs = _vectors(300)
    both.ok(f"DEFINE TABLE acl; DEFINE INDEX ix ON acl FIELDS emb HNSW "
            f"DIMENSION {DIM} DIST COSINE TYPE F32")
    both.ok("INSERT INTO acl $rows RETURN NONE",
            {"rows": [{"id": i, "emb": xs[i].tolist()} for i in range(300)]})
    both.ok("""DEFINE API "/nearest" FOR post
               MIDDLEWARE api::req::body('json')
               THEN { RETURN {
                 status: 200,
                 body: (SELECT VALUE id FROM acl
                        WHERE emb <|10,40|> $request.body.q)
               }; };""")
    del both.ops[:]
    q = _vectors(1, seed=11)[0].tolist()
    body = json.dumps({"q": q}).encode()
    hdrs = {"Content-Type": "application/json"}
    r = _req(servers[0].base, "/api/t/t/nearest", "POST", body, hdrs)
    p = _req(servers[1].base, "/api/t/t/nearest", "POST", body, hdrs)
    assert r == p and p[0] == 200
    want = both.ok("SELECT VALUE id FROM acl WHERE emb <|10,40|> $q",
                   {"q": q})[0]
    assert json.loads(p[3]) == [f"acl:{x.id}" for x in want]
    assert "vec_knn" in both.ops


# -- buckets and file:: -------------------------------------------------------------


def test_bucket_round_trips(both):
    """DEFINE BUCKET and every file:: function: put, get, head, exists,
    copy, rename, list and delete, across two buckets (file metadata's
    `updated` is a wall-clock time: it is left out of the comparison)."""
    both.ok("DEFINE BUCKET b; DEFINE BUCKET c COMMENT 'second'; INFO FOR DB")
    both.run("""
      RETURN file::put(f"b:/one.txt", 'hello');
      RETURN file::put(f"b:/two.bin", <bytes>'two');
      RETURN file::put(f"b:/ints", [1, 2, 255]);
      RETURN file::put_if_not_exists(f"b:/one.txt", 'other');
      RETURN file::get(f"b:/one.txt");
      RETURN file::get(f"b:/ints");
      RETURN file::get(f"b:/missing");
      RETURN file::head(f"b:/one.txt").size;
      RETURN file::head(f"b:/missing");
      RETURN [file::exists(f"b:/one.txt"), file::exists(f"b:/zz")];
      RETURN file::copy(f"b:/one.txt", 'copy.txt');
      RETURN file::copy(f"b:/zz", 'x');
      RETURN file::copy_if_not_exists(f"b:/zz", 'x');
      RETURN file::copy_if_not_exists(f"b:/two.bin", 'copy.txt');
      RETURN file::rename(f"b:/two.bin", f"c:/moved.bin");
      RETURN file::rename_if_not_exists(f"b:/copy.txt", '/one.txt');
      RETURN file::get(f"c:/moved.bin");
      RETURN file::list('b').map(|$f| [$f.file, $f.size]);
      RETURN file::list('b', { prefix: '/o', limit: 1 }).map(|$f| $f.file);
      RETURN file::list('b', { start: '/one' }).map(|$f| $f.file);
      RETURN [file::bucket(f"b:/one.txt"), file::key(f"b:/one.txt")];
      RETURN file::delete(f"b:/one.txt");
      RETURN file::delete(f"b:/one.txt");
      RETURN file::list('b').map(|$f| $f.file);
      RETURN file::get(f"nob:/x");
      RETURN file::put(f"b:/x", 12);
      RETURN file::bucket('str');
      RETURN file::list(1);
    """)
    both.same_items()


def test_bucket_ddl_readonly_and_backends(both):
    """A READONLY bucket refuses writes; a `file:` backend is refused as
    the reference refuses it (file access denied), another backend is
    not supported; ALTER and REMOVE BUCKET."""
    both.run("""
      DEFINE BUCKET ro READONLY;
      RETURN file::put(f"ro:/a", 'x');
      RETURN file::get(f"ro:/a");
      DEFINE BUCKET fb BACKEND "file:/tmp/somewhere";
      DEFINE BUCKET mem BACKEND "memory";
      DEFINE BUCKET s3 BACKEND "s3://bucket";
      DEFINE BUCKET ro READONLY;
      DEFINE BUCKET IF NOT EXISTS ro;
      DEFINE BUCKET OVERWRITE ro COMMENT 'again';
      INFO FOR DB;
      ALTER BUCKET ro COMMENT 'c';
      ALTER BUCKET ro DROP COMMENT;
      ALTER BUCKET nope COMMENT 'c';
      ALTER BUCKET IF EXISTS nope COMMENT 'c';
      INFO FOR DB;
      REMOVE BUCKET ro; REMOVE BUCKET ro; REMOVE BUCKET IF EXISTS ro;
      INFO FOR DB
    """)
    both.same_items()


# -- http:: --------------------------------------------------------------------------


class _Echo(http.server.BaseHTTPRequestHandler):
    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n).decode() if n else ""
        if self.path == "/text":
            out, ctype = b"plain words", "text/plain"
        else:
            out = json.dumps({"method": self.command, "path": self.path,
                              "body": body,
                              "x": self.headers.get("x-h")}).encode()
            ctype = "application/json"
        if self.path == "/fail":
            self.send_response(500)
        else:
            self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(out)

    do_GET = do_PUT = do_POST = do_PATCH = do_DELETE = do_HEAD = _answer

    def log_message(self, *a):
        pass


@pytest.fixture()
def echo():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("allowed", [True, False], ids=["allowed", "denied"])
def test_http_functions(both, echo, allowed):
    """Each http:: method against a local server when the capabilities
    allow the target, and the reference's error when they do not."""
    if allowed:
        both.ref.capabilities.allow_net = rcaps.Targets.parse("127.0.0.1")
        both.port.capabilities.allow_net = pcaps.Targets.parse("127.0.0.1")
    out = both.run(f"""
      RETURN http::get('{echo}/a');
      RETURN http::head('{echo}/a');
      RETURN http::put('{echo}/p', {{ a: 1 }});
      RETURN http::post('{echo}/p', 'text body', {{ 'x-h': 'hv' }});
      RETURN http::patch('{echo}/p', <bytes>'raw');
      RETURN http::delete('{echo}/d');
      RETURN http::get('{echo}/text');
      RETURN http::get('{echo}/fail');
      RETURN http::get(1);
    """)
    if allowed:
        assert out[0].error is None and out[0].result["method"] == "GET"
    else:
        assert "is not allowed" in out[0].error


def test_device_failure_in_a_handler_is_the_query_error(both, monkeypatch):
    """In mode `require` the card's failure (`DeviceRequired`) inside an
    API handler is the invoking query's error, as it is a plain query's;
    other handler errors keep the reference's 500 with no body."""
    from surrealdb_tpu_torch.device.supervisor import DeviceRequired
    from surrealdb_tpu_torch.idx import vector as PV

    xs = _vectors(100)
    both.ok(f"DEFINE TABLE acl; DEFINE INDEX ix ON acl FIELDS emb HNSW "
            f"DIMENSION {DIM} DIST COSINE TYPE F32")
    both.ok("INSERT INTO acl $rows RETURN NONE",
            {"rows": [{"id": i, "emb": xs[i].tolist()} for i in range(100)]})
    both.ok("""DEFINE API "/n" FOR get
               THEN { { body: (SELECT id FROM acl WHERE emb <|3|> $q) } };
               DEFINE API "/t" FOR get THEN { THROW 'no' };""")

    def refuse(self, *a, **k):
        raise DeviceRequired("device required: the card could not serve")

    monkeypatch.setattr(PV.TpuVectorIndex, "knn", refuse)
    q = {"q": xs[0].tolist()}
    out = both.port.execute("LET $q = $v; RETURN api::invoke('/n'); "
                            "SELECT id FROM acl WHERE emb <|3|> $q; "
                            "RETURN api::invoke('/t')",
                            ns=NS, db=DB, vars={"v": q["q"]})
    assert out[1].error == out[2].error == \
        "device required: the card could not serve"
    assert out[3].error is None and out[3].result["status"] == 500
