"""The port's network server (`server/`, `rpc.py`, `server/admission.py`,
`__main__.py`) against the reference's: each route and RPC method runs
the same request through a reference server and a port server, both
started in this process on port 0 over a fresh `Datastore("memory")`,
and the two give the same answers.

Tolerance: JSON bodies compare exactly after each statement's "time"
field is dropped (it is a measured duration); CBOR bodies are decoded
by their own package's `wire` and normalised as
`torch_sql_harness.norm` does (floats to atol 1e-4, rtol 1e-5). KNN
distances compare at atol 1e-4 / rtol 1e-5, ids exactly. Live query ids
are random uuids and compare only within one package.

Routes, methods, formats and subcommands the port leaves out answer
with the reference's error envelope for the route and a `NotPorted`
message naming each; a case below covers each. Authentication (the
`Bearer` and `Basic` headers, /signin, /signup, rpc signin / signup /
authenticate, `start --user/--pass`) answers as the reference's; on a
server started without `--unauthenticated` the port also refuses an
anonymous session's statements (guest access is off unless
SURREAL_CAPS_ALLOW_GUESTS says otherwise), where the reference runs them.
"""

import base64
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from surrealdb_tpu import wire as rwire
from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
from surrealdb_tpu.server import make_server as ref_make_server
from surrealdb_tpu_torch import wire as pwire
from surrealdb_tpu_torch.err import ShedError
from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore
from surrealdb_tpu_torch.server import (
    drain_and_shutdown,
    make_server,
    parse_timeout,
)
from surrealdb_tpu_torch.server.admission import AdmissionController
from torch_sql_harness import both, norm, same  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NSDB = {"surreal-ns": "t", "surreal-db": "t"}


class Served:
    """A server of one package over `ds`, serving on a thread."""

    def __init__(self, ds, make=make_server, **kw):
        self.ds = ds
        self.srv = make(ds, "127.0.0.1", 0, unauthenticated=kw.pop(
            "unauthenticated", True), **kw)
        self.port = self.srv.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        try:
            self.srv.shutdown()
        except Exception:
            pass
        self.srv.server_close()


def req(base, path, method="GET", body=None, headers=None, timeout=15):
    """(status, headers, body) of one request; HTTP errors included."""
    data = body.encode() if isinstance(body, str) else body
    r = urllib.request.Request(base + path, method=method, data=data)
    for k, v in (headers or {}).items():
        r.add_header(k, v)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_RAND_KEY = re.compile(r"^[0-9a-z]{20}$")


def untimed(v):
    """An answer without its measured "time" fields, and with generated
    record keys (20 random characters, as `CREATE tb` or a RELATE without
    an id makes) replaced by `<rand>`."""
    if isinstance(v, list):
        return [untimed(x) for x in v]
    if isinstance(v, dict):
        return {k: untimed(x) for k, x in v.items() if k != "time"}
    if isinstance(v, tuple) and len(v) == 3 and v[0] == "rid" \
            and isinstance(v[2], str) and _RAND_KEY.match(v[2]):
        return ("rid", v[1], "<rand>")
    if isinstance(v, tuple):
        return tuple(untimed(x) for x in v)
    if isinstance(v, str) and ":" in v:
        tb, _, key = v.partition(":")
        if _RAND_KEY.match(key):
            return f"{tb}:<rand>"
    return v


@pytest.fixture(scope="module")
def pair():
    ref = Served(RefDatastore("memory"), ref_make_server)
    port = Served(PortDatastore("memory"))
    try:
        yield ref, port
    finally:
        for s in (ref, port):
            s.close()
            s.ds.close()


def both_req(pair, path, method="GET", body=None, headers=None):
    """The same request to both servers: the same status; returns the
    two (status, headers, body) triples."""
    r = req(pair[0].base, path, method, body, headers)
    p = req(pair[1].base, path, method, body, headers)
    assert r[0] == p[0], (path, r, p)
    return r, p


def both_json(pair, path, method="GET", body=None, headers=None):
    r, p = both_req(pair, path, method, body, headers)
    rj, pj = untimed(json.loads(r[2])), untimed(json.loads(p[2]))
    assert rj == pj, (path, rj, pj)
    return p[0], pj


# -- health, version, /sql, /key ------------------------------------------------


@pytest.mark.parametrize("path", ["/health", "/status", "/version"])
def test_health_version(pair, path):
    r, p = both_req(pair, path)
    assert r[0] == 200 and r[2] == p[2]
    if path == "/version":
        assert p[2] == b"surrealdb-tpu-0.1.0"


SQL_SCRIPTS = [
    "CREATE srv:1 SET x = 1, y = [1, 2.5, 'a'], z = { n: NONE }; "
    "SELECT * FROM srv",
    "RETURN 40 + 2; RETURN d'2024-01-02T03:04:05Z'; RETURN 1dec / 3",
    "SELECT * FROM nosuch; THROW 'boom'; RETURN 'after'",
    "BEGIN; CREATE srv:2 SET x = 2; CANCEL; SELECT count() FROM srv GROUP ALL",
    "SELEC broken",
]


@pytest.mark.parametrize("sql", SQL_SCRIPTS)
def test_sql_route(pair, sql):
    st, out = both_json(pair, "/sql", "POST", sql, NSDB)
    assert st == 200 and isinstance(out, list)


def test_sql_route_without_ns(pair):
    st, out = both_json(pair, "/sql", "POST", "CREATE x:1")
    assert out[0]["status"] == "ERR"


def test_key_rest(pair):
    hdrs = {**NSDB, "Content-Type": "application/json"}
    steps = [
        ("/key/widget/a", "POST", json.dumps({"n": 5})),
        ("/key/widget/b", "POST", json.dumps({"n": 6, "m": [1, 2]})),
        ("/key/widget/a", "PATCH", json.dumps({"m": 6})),
        ("/key/widget/b", "PUT", json.dumps({"n": 7})),
        ("/key/widget", "GET", None),
        ("/key/widget?limit=1&start=1", "GET", None),
        ("/key/widget/a", "DELETE", None),
        ("/key/widget", "GET", None),
        ("/key/widget", "DELETE", None),
        ("/key/widget", "GET", None),
        ("/key/widget/a", "POST", "{not json"),
        ("/key/widget?limit=x", "GET", None),
        ("/key/", "GET", None),
    ]
    for path, method, body in steps:
        both_json(pair, path, method, body, hdrs)


def test_key_route_injection_blocked(pair):
    """Path segments are bound as parameters, never spliced into SQL."""
    from urllib.parse import quote

    hdrs = {**NSDB, "Content-Type": "application/json"}
    both_json(pair, "/key/safekey/one", "POST", json.dumps({"v": 1}), hdrs)
    evil = quote("safekey; REMOVE TABLE safekey", safe="")
    both_json(pair, f"/key/{evil}", "GET", None, hdrs)
    st, out = both_json(pair, "/key/safekey", "GET", None, hdrs)
    assert out[0]["result"][0]["v"] == 1


def test_unknown_route_and_body_cap(pair, monkeypatch):
    both_json(pair, "/nowhere")
    both_json(pair, "/nowhere", "POST", "x")
    from surrealdb_tpu import cnf as rcnf
    from surrealdb_tpu_torch import cnf as pcnf

    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "HTTP_MAX_BODY_SIZE", 8)
    st, out = both_json(pair, "/sql", "POST", "RETURN 1234567890", NSDB)
    assert st == 413


# -- RPC over HTTP ---------------------------------------------------------------

RPC_CALLS = [
    ("ping", []),
    ("version", []),
    ("query", ["RETURN 40 + 2"]),
    ("query", ["SELECT * FROM $x", {"x": [1, 2]}]),
    ("create", ["rpc:1", {"v": 1, "f": 1.5}]),
    ("create", ["rpc"]),
    ("select", ["rpc:1"]),
    ("insert", ["rpc", [{"id": 2, "v": 2}, {"id": 3, "v": 3}]]),
    ("update", ["rpc:2", {"v": 20}]),
    ("upsert", ["rpc:9", {"v": 9}]),
    ("merge", ["rpc:3", {"w": "m"}]),
    ("patch", ["rpc:3", [{"op": "replace", "path": "/v", "value": 33}]]),
    ("relate", ["rpc:1", "links", "rpc:2", {"k": 1}]),
    ("run", ["string::uppercase", None, ["abc"]]),
    ("delete", ["rpc:9"]),
    ("select", ["rpc:1..3"]),
    ("query", ["SELECT VALUE ->links->rpc FROM rpc:1"]),
    ("let", ["a", 1]),
    ("unset", []),
    ("query", []),
    ("nosuch", []),
    ("invalidate", []),
]


def _rpc_body(fmt, method, params, wire):
    msg = {"id": 7, "method": method, "params": params}
    if fmt == "cbor":
        return wire.encode(msg), {"Content-Type": "application/cbor",
                                  "Accept": "application/cbor"}
    return json.dumps(msg).encode(), {"Content-Type": "application/json"}


@pytest.mark.parametrize("fmt", ["json", "cbor"])
def test_http_rpc(pair, fmt):
    """Every RPC method through POST /rpc, in JSON and in CBOR, skipping
    the records of earlier calls' random ids (`create rpc`)."""
    outs = []
    for method, params in RPC_CALLS:
        got = []
        for served, wire in ((pair[0], rwire), (pair[1], pwire)):
            body, hdrs = _rpc_body(fmt, method, params, wire)
            st, _h, raw = req(served.base, "/rpc", "POST", body,
                              {**NSDB, **hdrs})
            assert st == 200
            got.append(untimed(json.loads(raw)) if fmt == "json"
                       else untimed(norm(wire.decode(raw))))
        r, p = got
        if method == "create" and len(params) == 1:
            # a random record id: the shape only
            assert len(r["result"]) == len(p["result"]) == 1
            continue
        same(r, p)
        outs.append(p)
    assert outs[2]["result"][0]["result"] == 42


def test_http_rpc_malformed(pair):
    """A CBOR body that does not decode, or a request that is not an
    object, answers the same error in both packages."""
    for body, ctype in ((b"[1, 2]", "application/json"),
                        (b"\x82\x01\x02", "application/cbor")):
        r, p = both_req(pair, "/rpc", "POST", body,
                        {**NSDB, "Content-Type": ctype})
        if ctype == "application/cbor":
            rd, pd = norm(rwire.decode(r[2])), norm(pwire.decode(p[2]))
        else:
            rd, pd = json.loads(r[2]), json.loads(p[2])
        assert rd == pd and pd["error"]["code"] == -32000


@pytest.mark.parametrize("body,ctype,want", [
    (b"{not json", "application/json",
     {"id": None, "error": {"code": -32700, "message": "Parse error"}}),
    (b"\x81", "application/cbor",
     {"id": None, "error": {"code": -32000,
                            "message": "truncated CBOR input"}}),
])
def test_http_rpc_body_that_does_not_decode(body, ctype, want):
    """A body that does not decode: the port answers an error envelope;
    the reference lets the decode error (a JSONDecodeError, or an
    IndexError from its CBOR reader) escape its handler and drops the
    connection with no answer (a defect this test pins)."""
    import http.client

    ref = Served(RefDatastore("memory"), ref_make_server)
    port = Served(PortDatastore("memory"))
    try:
        st, _h, raw = req(port.base, "/rpc", "POST", body,
                          {**NSDB, "Content-Type": ctype})
        got = json.loads(raw) if ctype.endswith("json") \
            else pwire.decode(raw)
        assert st == 200 and got == want
        with pytest.raises((http.client.RemoteDisconnected,
                            ConnectionError)):
            req(ref.base, "/rpc", "POST", body,
                {**NSDB, "Content-Type": ctype})
    finally:
        for s in (ref, port):
            s.close()
            s.ds.close()


# -- RPC over the WebSocket, with live queries ----------------------------------


@pytest.mark.parametrize("fmt", ["json", "cbor"])
def test_ws_rpc_and_live(pair, fmt):
    """The same RPC session over each server's WebSocket (the SDK's
    engine of its own package), then LIVE: a second session's writes
    reach the first as CREATE / UPDATE / DELETE, and KILL stops them."""
    from surrealdb_tpu.sdk import connect as rconnect
    from surrealdb_tpu_torch.sdk import connect as pconnect

    results = []
    for served, connect in ((pair[0], rconnect), (pair[1], pconnect)):
        url = f"ws://127.0.0.1:{served.port}"
        out = []
        with connect(url, fmt=fmt) as db, connect(url, fmt=fmt) as w:
            eng = db.engine
            db.use("t", f"ws{fmt}")
            w.use("t", f"ws{fmt}")
            for method, params in RPC_CALLS:
                if method == "create" and len(params) == 1:
                    continue
                try:
                    out.append(("ok", untimed(norm(eng.call(method,
                                                            params)))))
                except Exception as e:
                    out.append(("err", type(e).__name__, str(e)))
            got = []
            lid = db.live("wsl", got.append)
            w.create("wsl:1", {"v": 1})
            w.update("wsl:1", {"v": 2})
            w.delete("wsl:1")
            end = time.monotonic() + 5
            while len(got) < 3 and time.monotonic() < end:
                time.sleep(0.01)
            assert all(n["id"] is not None for n in got)
            out.append([(n["action"], norm(n["record"]), norm(n["result"]))
                        for n in got])
            db.kill(lid)
            w.create("wsl:2", {"v": 3})
            time.sleep(0.2)
            out.append(len(got))
            # the WS session's variables persist between requests
            db.let("x", 5)
            out.append(untimed(norm(db.query("RETURN $x"))))
        results.append(out)
    same(results[0], results[1])
    assert results[1][-3][0][0] == "CREATE" and results[1][-2] == 3


def _ws_raw(port, proto=None):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    key = base64.b64encode(os.urandom(16)).decode()
    extra = f"Sec-WebSocket-Protocol: {proto}\r\n" if proto else ""
    s.sendall((f"GET /rpc HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
               f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
               f"{extra}\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = s.recv(4096)
        if not chunk:
            break
        resp += chunk
    return s, resp


def test_ws_upgrade_required(pair):
    both_json(pair, "/rpc")


def test_ws_ping_and_parse_error(pair):
    """A ping frame gets its pong; a garbled frame a parse error, and
    the session lives on."""
    for served in pair:
        s, resp = _ws_raw(served.port)
        assert b" 101 " in resp.split(b"\r\n")[0]
        mask = os.urandom(4)
        s.sendall(b"\x89\x82" + mask + bytes(
            c ^ mask[i % 4] for i, c in enumerate(b"hi")))
        assert s.recv(4) == b"\x8a\x02hi"
        bad = b"{nope"
        s.sendall(b"\x81" + bytes([0x80 | len(bad)]) + mask + bytes(
            c ^ mask[i % 4] for i, c in enumerate(bad)))
        hdr = s.recv(2)
        msg = json.loads(s.recv(hdr[1] & 0x7F))
        assert msg == {"error": {"code": -32700, "message": "Parse error"}}
        s.close()


# -- TLS ------------------------------------------------------------------------


def test_tls_server(tmp_path):
    """HTTPS through make_server's stdlib `ssl` (`--web-crt` /
    `--web-key`)."""
    import ssl

    crt, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", crt, "-days", "1", "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    ds = PortDatastore("memory")
    s = Served(ds, tls_cert=crt, tls_key=key)
    try:
        sctx = ssl.create_default_context()
        sctx.check_hostname = False
        sctx.verify_mode = ssl.CERT_NONE
        base = f"https://127.0.0.1:{s.port}"
        body = urllib.request.urlopen(base + "/version", context=sctx).read()
        assert body == b"surrealdb-tpu-0.1.0"
        r = urllib.request.Request(base + "/sql", data=b"RETURN 1 + 1",
                                   headers=NSDB, method="POST")
        out = json.loads(urllib.request.urlopen(r, context=sctx).read())
        assert out[0]["result"] == 2
    finally:
        s.close()
        ds.close()


# -- admission, deadlines, cancellation, drain ----------------------------------


@pytest.fixture()
def small():
    """The port's server with 2 worker slots + 1 queue slot."""
    ds = PortDatastore("memory")
    s = Served(ds, max_inflight=2, queue_depth=1)
    try:
        yield s
    finally:
        s.close()
        ds.close()


def test_admission_bounds_and_typed_shed():
    ac = AdmissionController(max_inflight=2, queue_depth=1)
    t1 = ac.admit()
    t2 = ac.admit()
    seated = threading.Event()
    got = []

    def waiter():
        seated.set()
        tk = ac.admit()
        got.append(tk)
        tk.release()

    w = threading.Thread(target=waiter, daemon=True)
    w.start()
    seated.wait()
    time.sleep(0.05)
    with pytest.raises(ShedError) as ei:
        ac.admit()
    assert ei.value.retry_after_s > 0
    t1.release()
    w.join(timeout=2)
    assert not w.is_alive() and got, "queued waiter must get the freed slot"
    t2.release()


def test_admission_deadline_and_drain():
    ac = AdmissionController(max_inflight=1, queue_depth=8)
    ac._ewma_s = 1.0
    tk = ac.admit()
    t0 = time.monotonic()
    with pytest.raises(ShedError):
        ac.admit(deadline=time.monotonic() + 0.05)
    assert time.monotonic() - t0 < 0.05, "deadline shed must be immediate"

    def finish():
        time.sleep(0.15)
        tk.release()

    threading.Thread(target=finish, daemon=True).start()
    assert ac.drain(5.0) is True
    with pytest.raises(ShedError):
        ac.admit()


def test_parse_timeout_forms():
    assert parse_timeout("500ms") == pytest.approx(0.5)
    assert parse_timeout("2s") == pytest.approx(2.0)
    assert parse_timeout("1m") == pytest.approx(60.0)
    assert parse_timeout(1.5) == pytest.approx(1.5)
    assert parse_timeout("0.25") == pytest.approx(0.25)
    for bad in ("junk", "-1s", "0", True):
        with pytest.raises(Exception):
            parse_timeout(bad)


def test_burst_sheds_typed_503_never_500(small):
    results = []

    def one():
        results.append(req(small.base, "/sql", "POST", "SLEEP 500ms", NSDB))

    ts = [threading.Thread(target=one) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    codes = sorted(s for s, _h, _b in results)
    assert 500 not in codes
    assert codes.count(200) >= 2, codes
    assert 503 in codes, codes
    st, hdrs, body = next(r for r in results if r[0] == 503)
    shed = json.loads(body)
    assert shed["code"] == 503 and shed["retry_after_ms"] >= 0
    assert int(hdrs["Retry-After"]) >= 1
    assert req(small.base, "/health")[0] == 200


def test_edge_timeout_header(pair):
    t0 = time.monotonic()
    st, out = both_json(pair, "/sql", "POST", "SLEEP 10s",
                        {**NSDB, "X-Surreal-Timeout": "200ms"})
    assert time.monotonic() - t0 < 4.0
    assert out[0]["status"] == "ERR"
    assert "exceeded the timeout" in out[0]["result"]
    st, out = both_json(pair, "/sql", "POST", "RETURN 1",
                        {**NSDB, "X-Surreal-Timeout": "tomorrow"})
    assert st == 400 and "Invalid timeout" in out["error"]


def test_statement_timeout_cannot_extend_edge_budget(small):
    small.ds.execute("CREATE |ext:1..40| SET x = 1", ns="t", db="t")
    t0 = time.monotonic()
    st, _h, body = req(small.base, "/sql", "POST",
                       "SELECT * FROM ext WHERE sleep(40ms) = NONE "
                       "TIMEOUT 1m;", {**NSDB, "X-Surreal-Timeout": "200ms"})
    out = json.loads(body)
    assert out[0]["status"] == "ERR" and "timeout" in out[0]["result"]
    assert time.monotonic() - t0 < 2.0


def test_kill_inflight_select_within_250ms(small):
    ds = small.ds
    ds.execute("CREATE |victim:1..40| SET x = 1", ns="t", db="t")
    out = {}

    def run():
        out["r"] = req(small.base, "/sql", "POST",
                       "SELECT * FROM victim WHERE sleep(40ms) = NONE", NSDB)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    qid = None
    while time.monotonic() < deadline and qid is None:
        for q in ds.inflight.snapshot():
            if "victim" in q["statement"]:
                qid = q["id"]
        time.sleep(0.01)
    assert qid, "in-flight SELECT never registered"
    t0 = time.monotonic()
    st, _h, _b = req(small.base, "/sql", "POST", f"KILL '{qid}'", NSDB)
    assert st == 200
    t.join(timeout=5)
    dt = time.monotonic() - t0
    assert not t.is_alive()
    res = json.loads(out["r"][2])
    assert res[0]["status"] == "ERR" and "cancelled" in res[0]["result"]
    assert dt < 0.25, f"kill took {dt * 1000:.0f}ms"
    assert ds.telemetry.get("queries_killed") >= 1


def test_client_disconnect_cancels_inflight(small):
    ds = small.ds
    body = b"SLEEP 30s"
    raw = (f"POST /sql HTTP/1.1\r\nHost: 127.0.0.1:{small.port}\r\n"
           f"surreal-ns: t\r\nsurreal-db: t\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    s = socket.create_connection(("127.0.0.1", small.port), timeout=5)
    s.sendall(raw)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            "SLEEP" in q["statement"] for q in ds.inflight.snapshot()):
        time.sleep(0.01)
    assert any("SLEEP" in q["statement"] for q in ds.inflight.snapshot())
    s.close()
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline and ds.inflight.count() > 0:
        time.sleep(0.02)
    assert ds.inflight.count() == 0, "disconnected client's query still running"
    assert ds.telemetry.get("queries_killed") >= 1


def test_ws_rpc_timeout_field(small):
    from surrealdb_tpu_torch.sdk import connect

    with connect(f"ws://127.0.0.1:{small.port}", fmt="json") as db:
        db.use("t", "t")
        eng = db.engine
        # the SDK sends no timeout field: frame one by hand
        rid = 999
        slot = [threading.Event(), None]
        with eng._plock:
            eng._pending[rid] = slot
        eng._send_frame(json.dumps({"id": rid, "method": "query",
                                    "params": ["SLEEP 10s"],
                                    "timeout": "200ms"}).encode(), 0x1)
        t0 = time.monotonic()
        assert slot[0].wait(5)
        assert time.monotonic() - t0 < 2.0
        rows = slot[1]["result"]
        assert rows[0]["status"] == "ERR"
        assert "exceeded the timeout" in rows[0]["result"]


def test_metrics_and_traces(small):
    req(small.base, "/sql", "POST", "RETURN 1", NSDB)
    req(small.base, "/sql", "POST", "SLEEP 10s",
        {**NSDB, "X-Surreal-Timeout": "50ms"})
    st, _h, m = req(small.base, "/metrics")
    text = m.decode()
    for needle in (
        "surreal_queries_admitted_total",
        "surreal_queries_timed_out_total",
        "surreal_inflight_queries",
        "surreal_admission_queue_depth",
        "surreal_admission_active",
        "surreal_live_queries",
        "surreal_live_sessions",
        "surreal_notifications_dropped_total",
        "surreal_device_fallbacks",
        "surreal_mem_accounted_bytes",
        "surreal_query_duration_ms_count",
    ):
        assert needle in text, f"missing {needle}\n{text}"
    assert "# TYPE surreal_inflight_queries gauge" in text
    st, _h, body = req(small.base, "/telemetry/traces")
    assert st == 200 and isinstance(json.loads(body), list)


def test_metrics_need_a_session_on_a_secured_server():
    ds = PortDatastore("memory")
    s = Served(ds, unauthenticated=False)
    try:
        for path in ("/metrics", "/telemetry/traces"):
            st, _h, body = req(s.base, path)
            assert st == 401 and json.loads(body) == {
                "error": "Not authenticated"}
        st, _h, body = req(s.base, "/sql", "POST", "CREATE locked:1", NSDB)
        assert json.loads(body)[0]["status"] == "ERR"
    finally:
        s.close()
        ds.close()


def test_drain_finishes_inflight_then_stops():
    ds = PortDatastore("memory")
    s = Served(ds, max_inflight=4, queue_depth=4)
    results = []

    def one():
        results.append(req(s.base, "/sql", "POST", "SLEEP 400ms", NSDB))

    t = threading.Thread(target=one, daemon=True)
    t.start()
    time.sleep(0.1)
    shed = {}

    def late():
        while not s.srv.admission.draining:
            time.sleep(0.005)
        shed["r"] = req(s.base, "/sql", "POST", "RETURN 1", NSDB)

    lt = threading.Thread(target=late, daemon=True)
    lt.start()
    t0 = time.monotonic()
    clean = drain_and_shutdown(s.srv, ds, 10.0)
    assert clean is True and time.monotonic() - t0 < 5.0
    t.join(timeout=5)
    lt.join(timeout=5)
    st, _h, body = results[0]
    assert st == 200 and json.loads(body)[0]["status"] == "OK"
    st, hdrs, body = shed["r"]
    assert st == 503 and json.loads(body)["code"] == 503
    assert "Retry-After" in hdrs
    s.srv.server_close()
    ds.close()


def test_drain_budget_cancels_stragglers():
    ds = PortDatastore("memory")
    s = Served(ds, max_inflight=4, queue_depth=4)
    results = []

    def one():
        results.append(req(s.base, "/sql", "POST", "SLEEP 30s", NSDB))

    t = threading.Thread(target=one, daemon=True)
    t.start()
    time.sleep(0.15)
    t0 = time.monotonic()
    clean = drain_and_shutdown(s.srv, ds, 0.2)
    assert clean is False, "a 30s query cannot drain in 200ms"
    assert time.monotonic() - t0 < 5.0
    t.join(timeout=5)
    assert not t.is_alive()
    out = json.loads(results[0][2])
    assert out[0]["status"] == "ERR" and "cancelled" in out[0]["result"]
    s.srv.server_close()
    ds.close()


# -- KNN over the wire ------------------------------------------------------------


def test_knn_over_the_wire(both):
    """`<|10,40|>` on a small HNSW table through each package's server:
    POST /sql, POST /rpc (JSON and CBOR) and the WebSocket (CBOR), each
    with the port's inline `DeviceHost("cpu")` (the `both` fixture's,
    whose device floor is lowered): the device op serves every query,
    ids are equal and distances agree."""
    from surrealdb_tpu.sdk import connect as rconnect
    from surrealdb_tpu_torch.sdk import connect as pconnect

    rng = np.random.default_rng(11)
    xs = rng.normal(size=(200, 16)).astype(np.float32)
    qs = rng.normal(size=(4, 16)).astype(np.float32)
    both.ok("DEFINE TABLE v; DEFINE INDEX ix ON v FIELDS emb HNSW "
            "DIMENSION 16 DIST COSINE TYPE F32")
    both.ok("INSERT INTO v $rows RETURN NONE",
            {"rows": [{"id": i, "emb": xs[i].tolist()}
                      for i in range(len(xs))]})
    sql = ("SELECT id, vector::distance::knn() AS d FROM v "
           "WHERE emb <|10,40|> $q")
    ref, port = Served(both.ref, ref_make_server), Served(both.port)
    try:
        answers = {}
        for name, served, connect, wire in (
                ("ref", ref, rconnect, rwire),
                ("port", port, pconnect, pwire)):
            out = []
            for q in qs:
                ql = json.dumps(q.tolist())
                st, _h, b = req(served.base, "/sql", "POST",
                                f"LET $q = {ql}; {sql}", NSDB)
                out.append(("sql", json.loads(b)[1]["result"]))
                body, hdrs = _rpc_body("json", "query",
                                       [sql, {"q": q.tolist()}], wire)
                st, _h, b = req(served.base, "/rpc", "POST", body,
                                {**NSDB, **hdrs})
                out.append(("rpc", json.loads(b)["result"][0]["result"]))
                body, hdrs = _rpc_body("cbor", "query",
                                       [sql, {"q": q.tolist()}], wire)
                st, _h, b = req(served.base, "/rpc", "POST", body,
                                {**NSDB, **hdrs})
                out.append(("rpc-cbor", norm(wire.decode(b)["result"][0]
                                             ["result"])))
            with connect(f"ws://127.0.0.1:{served.port}", fmt="cbor") as db:
                db.use("t", "t")
                for q in qs:
                    res = db.query(sql, {"q": q.tolist()})
                    out.append(("ws", norm(res[0]["result"])))
            answers[name] = out
        same(answers["ref"], answers["port"])
        assert all(len(a[1]) == 10 for a in answers["port"])
        # the wire answers are the in-process ones
        for qi, q in enumerate(qs):
            local = both.ok(sql, {"q": q.tolist()})[0]
            assert [r["id"] for r in answers["port"][3 * qi][1]] == [
                f"v:{r['id'].id}" for r in local]
        assert both.ops.count("vec_knn") >= 4 * len(qs) + len(qs), both.ops
        assert "brute_knn" not in both.ops
    finally:
        ref.close()
        port.close()


# -- a store carried from the reference's server to the port's `start` ----------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_carried_store_served_by_port_start(tmp_path):
    """A `file://` store written through the reference's server is
    opened and served by `python -m surrealdb_tpu_torch start --path
    file://… --device off`, which answers as the reference's did; the
    server drains and exits on SIGTERM."""
    path = f"file://{tmp_path / 'store'}"
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(64, 8)).astype(np.float32)
    ds = RefDatastore(path)
    s = Served(ds, ref_make_server)
    queries = [
        "SELECT * FROM person ORDER BY id",
        "SELECT VALUE ->knows->person FROM ONLY person:1",
        "SELECT id FROM vec WHERE emb <|3|> " + json.dumps(xs[5].tolist()),
        "INFO FOR TABLE vec",
        "SELECT count() FROM vec GROUP ALL",
    ]
    try:
        script = ("DEFINE TABLE vec; DEFINE INDEX ix ON vec FIELDS emb HNSW "
                  "DIMENSION 8 DIST EUCLIDEAN TYPE F32;"
                  "CREATE person:1 SET name = 'ada'; "
                  "CREATE person:2 SET name = 'bob'; "
                  "RELATE person:1->knows->person:2;")
        st, _h, b = req(s.base, "/sql", "POST", script, NSDB)
        assert all(r["status"] == "OK" for r in json.loads(b))
        for i in range(len(xs)):
            req(s.base, f"/key/vec/{i}", "POST",
                json.dumps({"emb": xs[i].tolist()}),
                {**NSDB, "Content-Type": "application/json"})
        want = [untimed(json.loads(req(s.base, "/sql", "POST", q, NSDB)[2]))
                for q in queries]
    finally:
        s.close()
        ds.close()
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "surrealdb_tpu_torch", "start", "--bind",
         f"127.0.0.1:{port}", "--path", path, "--unauthenticated",
         "--device", "off"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        base = f"http://127.0.0.1:{port}"
        end = time.monotonic() + 60
        while time.monotonic() < end:
            try:
                if req(base, "/health", timeout=1)[0] == 200:
                    break
            except OSError:
                time.sleep(0.1)
        got = [untimed(json.loads(req(base, "/sql", "POST", q, NSDB)[2]))
               for q in queries]
        assert got == want
        # /key/vec/5 made a string key
        assert got[2][0]["result"][0]["id"] == "vec:`5`"
        from surrealdb_tpu_torch.__main__ import main

        assert main(["isready", "--conn", base]) == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    assert proc.returncode == 0, err.decode()
    assert f"listening on http://127.0.0.1:{port}".encode() in out


# -- what the port leaves out ------------------------------------------------------

LEFT_OUT_ROUTES = [
    ("GET", "/api/t/t/hello", 404, "error", "/api/*"),
    ("POST", "/api/t/t/hello", 404, "error", "/api/*"),
    ("PUT", "/api/t/t/hello", 404, "error", "/api/*"),
    ("POST", "/graphql", 200, "errors", "/graphql"),
    ("POST", "/signin", 401, "details", "/signin"),
    ("POST", "/signup", 401, "details", "/signup"),
    ("GET", "/export", 400, "error", "/export"),
    ("POST", "/import", 400, "error", "/import"),
    ("GET", "/ml/export/m/1.0", 400, "error", "/ml/*"),
    ("POST", "/ml/import", 400, "error", "/ml/*"),
    ("GET", "/kv/topology", 503, "error", "/kv/topology"),
]


@pytest.mark.parametrize("method,path,code,key,name", LEFT_OUT_ROUTES,
                         ids=lambda v: str(v))
def test_left_out_route_answers_not_ported(pair, method, path, code, key,
                                           name):
    """Each left-out route names itself. /signin and /signup are ported:
    with no credentials they answer the reference's authentication
    failure (the same 401 and `details`). So are /ml/export and
    /ml/import: a model that does not exist and a body that is no model
    answer the reference's status and error; /api/* (an endpoint nobody
    defined: the reference's 404 and body) and /graphql (an empty
    query: the reference's error envelope)."""
    if path.startswith("/api/") or path == "/graphql":
        r, p = both_req(pair, path, method,
                        b"{}" if method != "GET" else None, NSDB)
        assert p[0] == code and r[2] == p[2], (r, p)
        assert r[1].get("Content-Type") == p[1].get("Content-Type")
        assert b"not ported" not in p[2]
        if path == "/graphql":
            assert json.loads(p[2])[key]
        assert req(pair[1].base, "/health")[0] == 200
        return
    if path.startswith("/ml/"):
        r, p = both_req(pair, path, method,
                        b"{}" if method != "GET" else None, NSDB)
        assert p[0] == r[0] == (404 if method == "GET" else 400)
        assert json.loads(r[2]) == json.loads(p[2])
        assert "not ported" not in json.loads(p[2])["error"]
        assert req(pair[1].base, "/health")[0] == 200
        return
    if path == "/kv/topology":
        # ported: the reference's answer (`{}` on an unsharded store;
        # the sharded cases are in test_torch_shard.py)
        r, p = both_req(pair, path, method, None, NSDB)
        assert (p[0], json.loads(p[2])) == (r[0], json.loads(r[2]))
        assert b"not ported" not in p[2]
        assert req(pair[1].base, "/health")[0] == 200
        return
    if path in ("/signin", "/signup"):
        r, p = both_req(pair, path, method, b"{}", NSDB)
        assert p[0] == code and json.loads(r[2]) == json.loads(p[2]) == {
            "code": 401, "details": "There was a problem with authentication"}
        assert req(pair[1].base, "/health")[0] == 200
        return
    st, _h, body = req(pair[1].base, path, method,
                       b"{}" if method != "GET" else None, NSDB)
    out = json.loads(body)
    assert st == code, (st, out)
    msg = out[key][0]["message"] if key == "errors" else out[key]
    assert name in msg and "not ported" in msg
    # the connection stays usable: the body was read
    assert req(pair[1].base, "/health")[0] == 200


@pytest.mark.parametrize("scheme,cred", [
    ("Bearer", "eyJhbGciOi.e30.sig"),
    ("Basic", base64.b64encode(b"root:root").decode()),
])
@pytest.mark.parametrize("path", ["/sql", "/rpc", "/key/x"])
def test_auth_header_answers_not_ported(pair, scheme, cred, path):
    """Ported: an invalid Bearer token is a 401, never downgraded to an
    anonymous session, and Basic signs its user in; both packages give
    the same answer."""
    for served in pair:
        served.ds.query("DEFINE USER IF NOT EXISTS root ON ROOT PASSWORD "
                        "'root' ROLES OWNER")
    body = (json.dumps({"id": 1, "method": "query",
                        "params": ["RETURN 1"]})
            if path == "/rpc" else "RETURN 1")
    r, p = both_req(pair, path, "POST", body,
                    {**NSDB, "Authorization": f"{scheme} {cred}"})
    rj, pj = untimed(json.loads(r[2])), untimed(json.loads(p[2]))
    assert rj == pj, (rj, pj)
    if scheme == "Bearer":
        assert p[0] == 401 and pj == {
            "error": "There was a problem with authentication"}
    else:
        assert p[0] == r[0] and "not ported" not in json.dumps(pj)


@pytest.mark.parametrize("hdr", ["Content-Type", "Accept"])
def test_flatbuffers_rpc_answers_not_ported(pair, hdr):
    st, _h, raw = req(pair[1].base, "/rpc", "POST", b"\x00\x01",
                      {**NSDB, hdr: "application/vnd.surrealdb.flatbuffers"})
    out = json.loads(raw)
    assert "flatbuffers" in out["error"]["message"]
    assert "not ported" in out["error"]["message"]


def test_flatbuffers_ws_answers_not_ported(pair):
    s, resp = _ws_raw(pair[1].port, proto="flatbuffers")
    head, _, body = resp.partition(b"\r\n\r\n")
    n = int(re.search(rb"Content-Length: (\d+)", head).group(1))
    while len(body) < n:
        body += s.recv(4096)
    s.close()
    assert b" 400 " in head.split(b"\r\n")[0]
    assert b"flatbuffers format is not ported" in body


_AUTH_PARAMS = {"signin": [{"user": "u", "pass": "p"}],
                "signup": [{"user": "u"}], "authenticate": ["tok"]}


@pytest.mark.parametrize("fmt", ["json", "cbor"])
@pytest.mark.parametrize("method", ["signin", "signup", "authenticate",
                                    "graphql"])
def test_left_out_rpc_methods(pair, method, fmt):
    """signin, signup, authenticate and graphql are ported and answer as
    the reference's (here, for credentials nobody holds, the same
    authentication failure; graphql given no query, the same answer)."""
    if method == "graphql":
        got = []
        for served, wire in ((pair[0], rwire), (pair[1], pwire)):
            body, hdrs = _rpc_body(fmt, method, [{"user": "u", "pass": "p"}],
                                   wire)
            st, _h, raw = req(served.base, "/rpc", "POST", body,
                              {**NSDB, **hdrs})
            got.append((st, json.loads(raw) if fmt == "json"
                        else norm(wire.decode(raw))))
        assert got[0] == got[1]
        assert "not ported" not in json.dumps(got[1], default=str)
        return
    got = []
    for served, wire in ((pair[0], rwire), (pair[1], pwire)):
        body, hdrs = _rpc_body(fmt, method, _AUTH_PARAMS[method], wire)
        st, _h, raw = req(served.base, "/rpc", "POST", body,
                          {**NSDB, **hdrs})
        got.append((st, json.loads(raw) if fmt == "json"
                    else norm(wire.decode(raw))))
    assert got[0] == got[1]
    assert got[1][1]["error"]["message"] == \
        "There was a problem with authentication"


@pytest.mark.parametrize("argv,name", [
    (["export", "--ns", "t", "--db", "t"], "export"),
    (["import", "--ns", "t", "--db", "t", "x.surql"], "import"),
    (["kv"], "kv"),
    (["kv-admin", "topology", "--meta", "127.0.0.1:1"], "kv-admin"),
    (["upgrade", "--path", "memory"], "upgrade"),
    (["fix", "--path", "memory"], "fix"),
    (["ml", "export", "--ns", "t", "--db", "t", "m", "1"], "ml"),
    (["start", "--user", "root", "--pass", "root"], "--user/--pass"),
    (["start", "--path", "remote://127.0.0.1:1"], "remote://"),
    (["sql", "--path", "lsm://x"], "lsm://"),
])
def test_left_out_subcommands(capsys, monkeypatch, argv, name):
    """Each left-out subcommand or engine names itself. `start --user
    --pass` is ported: it defines the root user and serves. So is `ml
    export`: a model missing from the datastore raises the reference's
    error. So are `kv` (it starts the KV service with the reference's
    settings), `kv-admin` and the `remote://` engine (with nothing at
    the address, both packages fail with the same retryable error)."""
    from surrealdb_tpu_torch.__main__ import main

    if name == "kv":
        import surrealdb_tpu.kvs.remote as RR
        import surrealdb_tpu_torch.kvs.remote as PR
        from surrealdb_tpu.__main__ import main as ref_main

        calls = []
        for mod in (RR, PR):
            monkeypatch.setattr(mod, "serve_kv",
                                lambda *a, **kw: calls.append((a, kw)))
        assert ref_main(argv) == 0 and main(argv) == 0
        assert calls[0] == calls[1] and calls[1][0] == ("127.0.0.1", 8100)
        return
    if name in ("kv-admin", "remote://"):
        from surrealdb_tpu import cnf as rcnf
        from surrealdb_tpu.__main__ import main as ref_main
        from surrealdb_tpu_torch import cnf as pcnf

        for c in (rcnf, pcnf):
            monkeypatch.setattr(c, "KV_RETRY_DEADLINE_S", 0.3)
        errs = []
        for fn, args in ((ref_main, argv), (main, [*argv, "--device", "off"]
                                            if argv[0] == "start" else argv)):
            with pytest.raises(Exception) as e:
                fn(args)
            errs.append((type(e.value).__name__,
                         str(e.value).split("): ")[-1]))
        assert errs[0] == errs[1] == (
            "RetryableKvError",
            "kv service unreachable: [Errno 111] Connection refused")
        return

    if name == "ml":
        from surrealdb_tpu.__main__ import main as ref_main
        from surrealdb_tpu.err import SdbError as RefError
        from surrealdb_tpu_torch.err import SdbError as PortError

        with pytest.raises(RefError) as r:
            ref_main(argv)
        with pytest.raises(PortError) as p:
            main(argv)
        assert str(p.value) == str(r.value) == \
            "The model 'ml::m<1>' does not exist"
        return

    if name == "--user/--pass":
        import surrealdb_tpu_torch.server as SRV
        from surrealdb_tpu_torch import iam
        from surrealdb_tpu_torch.kvs.ds import Session

        seen = {}

        def fake_serve(ds, host, port, **kw):
            s = Session()
            seen["token"] = iam.signin(ds, s, {"user": "root",
                                               "pass": "root"})
            seen.update(level=s.auth_level, **kw)
            ds.close()

        monkeypatch.setattr(SRV, "serve", fake_serve)
        assert main([*argv, "--device", "off"]) == 0
        assert seen["level"] == "owner" and seen["token"]
        assert not seen["unauthenticated"]
        return
    assert main(argv) != 0
    err = capsys.readouterr().err
    assert name in err and "not ported" in err


def test_cli_version_validate_isready(tmp_path, capsys):
    from surrealdb_tpu_torch.__main__ import main

    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "surrealdb-tpu 0.1.0"
    good, bad = tmp_path / "a.surql", tmp_path / "b.surql"
    good.write_text("SELECT * FROM x WHERE emb <|3|> [1, 2];")
    bad.write_text("SELEC nope")
    assert main(["validate", str(good)]) == 0
    assert main(["validate", str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{good}: OK" in out and f"{bad}: " in out
    assert main(["isready", "--conn", f"http://127.0.0.1:{_free_port()}"]) == 1
    assert "Not ready" in capsys.readouterr().out


@pytest.mark.parametrize("argv,env,want", [
    ([], None, "require"),
    (["--device", "off"], None, "off"),
    (["--device", "auto"], "require", "auto"),
    ([], "auto", "auto"),
])
def test_start_device_mode(monkeypatch, argv, env, want):
    """`start` runs on the card unless asked for the host: with neither
    `--device` nor SURREAL_DEVICE its supervisor is in mode require."""
    import surrealdb_tpu_torch.server as SRV
    from surrealdb_tpu_torch.__main__ import main

    seen = {}

    def fake_serve(ds, host, port, **kw):
        seen.update(mode=os.environ.get("SURREAL_DEVICE"), host=host,
                    port=port, **kw)
        ds.close()

    monkeypatch.setattr(SRV, "serve", fake_serve)
    if env is None:
        monkeypatch.delenv("SURREAL_DEVICE", raising=False)
    else:
        monkeypatch.setenv("SURREAL_DEVICE", env)
    assert main(["start", "--bind", "127.0.0.1:9", "--unauthenticated",
                 "--default-timeout", "5s", *argv]) == 0
    assert seen["mode"] == want
    assert (seen["host"], seen["port"]) == ("127.0.0.1", 9)
    assert seen["default_timeout_s"] == 5.0 and seen["unauthenticated"]


@pytest.mark.parametrize("argv,env,want", [
    ([], None, "require"),
    (["--device", "off"], None, "off"),
    (["--device", "auto"], "require", "auto"),
    ([], "auto", "auto"),
])
def test_sql_device_mode(monkeypatch, capsys, argv, env, want):
    """The `sql` REPL shares `start`'s device policy: with neither
    `--device` nor SURREAL_DEVICE a supervisor built for its datastore
    is in mode require, never auto's silent host answers."""
    import builtins

    from surrealdb_tpu_torch.__main__ import main
    from surrealdb_tpu_torch.device.supervisor import DeviceSupervisor

    lines = iter(["RETURN 1 + 1"])

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", fake_input)
    if env is None:
        monkeypatch.delenv("SURREAL_DEVICE", raising=False)
    else:
        monkeypatch.setenv("SURREAL_DEVICE", env)
    assert main(["sql", "--ns", "t", "--db", "t", *argv]) == 0
    assert "2" in capsys.readouterr().out.splitlines()
    assert os.environ["SURREAL_DEVICE"] == want
    assert DeviceSupervisor().mode == want


# -- authentication over the wire -------------------------------------------------------

_ACCESS = (
    "DEFINE ACCESS account ON DATABASE TYPE RECORD "
    "SIGNUP (CREATE type::record('user', $name) SET pass = "
    "crypto::scrypt::generate($pass)) "
    "SIGNIN (SELECT * FROM user WHERE id = type::record('user', $name) "
    "AND crypto::scrypt::compare(pass, $pass)); "
    "DEFINE TABLE note PERMISSIONS FOR select, create WHERE owner = "
    "$auth.id; DEFINE USER ed ON DATABASE PASSWORD 'ed' ROLES EDITOR")


def _claims(token):
    body = token.split(".")[1]
    payload = json.loads(base64.urlsafe_b64decode(body + "=" * (-len(body) % 4)))
    return {k: v for k, v in payload.items() if k not in ("iat", "exp")}


@pytest.fixture()
def secured():
    """A reference and a port server over fresh datastores, started
    without --unauthenticated, each with the record access above."""
    ref = Served(RefDatastore("memory"), ref_make_server,
                 unauthenticated=False)
    port = Served(PortDatastore("memory"), unauthenticated=False)
    for s in (ref, port):
        s.ds.query(_ACCESS, ns="t", db="t")
    try:
        yield ref, port
    finally:
        for s in (ref, port):
            s.close()
            s.ds.close()


def test_signin_signup_routes_and_bearer(secured):
    """POST /signup and /signin answer tokens with the same claims; each
    token then serves as a Bearer header on /sql and /rpc, and a Basic
    header signs the database user in."""
    creds = {"NS": "t", "DB": "t", "AC": "account", "name": "al",
             "pass": "pw"}
    toks = []
    for path in ("/signup", "/signin"):
        r, p = both_req(secured, path, "POST", json.dumps(creds))
        rj, pj = json.loads(r[2]), json.loads(p[2])
        assert p[0] == 200 and rj["details"] == pj["details"]
        assert _claims(rj["token"]) == _claims(pj["token"])
        toks.append((rj["token"], pj["token"]))
    r, p = both_req(secured, "/signin", "POST",
                    json.dumps({**creds, "pass": "no"}))
    assert p[0] == 401 and json.loads(r[2]) == json.loads(p[2])
    rtok, ptok = toks[1]
    sql = ("CREATE note:1 SET owner = $auth.id; CREATE note:2 SET owner = "
           "user:zed; SELECT * FROM note; RETURN session::ac()")
    out = []
    for served, tok in ((secured[0], rtok), (secured[1], ptok)):
        hdr = {**NSDB, "Authorization": f"Bearer {tok}"}
        st, _h, raw = req(served.base, "/sql", "POST", sql, hdr)
        assert st == 200
        rpc = json.dumps({"id": 1, "method": "query",
                          "params": ["SELECT id FROM note"]})
        st2, _h, raw2 = req(served.base, "/rpc", "POST", rpc,
                            {**hdr, "Content-Type": "application/json"})
        out.append((untimed(json.loads(raw)), st2,
                    untimed(json.loads(raw2))))
    assert out[0] == out[1]
    assert out[1][0][2]["result"] == [{"id": "note:1", "owner": "user:al"}]
    basic = {**NSDB, "Authorization": "Basic " + base64.b64encode(
        b"ed:ed").decode()}
    r, p = both_req(secured, "/sql", "POST", "CREATE e:1; SELECT * FROM e",
                    basic)
    assert untimed(json.loads(r[2])) == untimed(json.loads(p[2]))
    assert json.loads(p[2])[1]["result"] == [{"id": "e:1"}]


@pytest.mark.parametrize("fmt", ["json", "cbor"])
def test_ws_signin_signup_authenticate(secured, fmt):
    """The same WebSocket session in both packages: signup, signin,
    queries as the record user, a second connection authenticating with
    the first one's token, invalidate."""
    from surrealdb_tpu.sdk import connect as rconnect
    from surrealdb_tpu_torch.sdk import connect as pconnect

    creds = {"NS": "t", "DB": "t", "AC": "account", "name": "bo",
             "pass": "pw"}
    results = []
    for served, connect in ((secured[0], rconnect), (secured[1], pconnect)):
        url = f"ws://127.0.0.1:{served.port}"
        out = []
        with connect(url, fmt=fmt) as a, connect(url, fmt=fmt) as b:
            out.append(_claims(a.signup(**creds)))
            tok = a.signin(**creds)
            out.append(_claims(tok))
            out.append(untimed(norm(a.query(
                "CREATE note:1 SET owner = $auth.id; SELECT * FROM note; "
                "RETURN [session::ac(), $auth.id]"))))
            b.authenticate(tok)
            out.append(untimed(norm(b.query("SELECT id FROM note"))))
            b.invalidate()
            try:
                out.append(("ok", untimed(norm(b.query("SELECT * FROM "
                                                       "note")))))
            except Exception as e:
                out.append(("err", str(e)))
            try:
                b.authenticate("x.y.z")
                out.append("accepted")
            except Exception as e:
                out.append(("err", str(e)))
        results.append(out)
    assert results[0][:4] == results[1][:4]
    assert results[1][3][0]["result"] in ([{"id": ("rid", "note", 1)}],
                                          [{"id": "note:1"}])
    assert results[0][5] == results[1][5] == (
        "err", "There was a problem with authentication")
    # after invalidate the session is anonymous: the reference answers
    # what an anonymous session may see (nothing), the port refuses it
    assert results[0][4] == ("ok", [{"status": "OK", "result": []}])
    assert results[1][4][0] == "err" and "IAM error" in results[1][4][1]


def test_secured_server_refuses_anonymous_statements():
    """Guest access is off unless SURREAL_CAPS_ALLOW_GUESTS says so: an
    anonymous statement fails with the IAM error over /sql, /rpc and the
    WebSocket, and the same one runs once signed in."""
    from surrealdb_tpu_torch.capabilities import Capabilities
    from surrealdb_tpu_torch.sdk import connect

    ds = PortDatastore("memory")
    ds.query("DEFINE USER root ON ROOT PASSWORD 'root' ROLES OWNER; "
             "CREATE t:1", ns="t", db="t")
    s = Served(ds, unauthenticated=False)
    iam_err = "IAM error: Not enough permissions to perform this action"
    try:
        st, _h, raw = req(s.base, "/sql", "POST", "SELECT * FROM t; "
                          "RETURN 1", NSDB)
        assert st == 200 and [r["result"] for r in json.loads(raw)] == \
            [iam_err, iam_err]
        with connect(f"ws://127.0.0.1:{s.port}") as c:
            c.use("t", "t")
            with pytest.raises(Exception, match="IAM error"):
                c.query("SELECT * FROM t")
            c.signin(user="root", passwd="root")
            rows = c.query("SELECT * FROM t")[0]["result"]
            assert [norm(r["id"]) for r in rows] in (["t:1"],
                                                     [("rid", "t", 1)])
        hdr = {**NSDB, "Authorization": "Basic " + base64.b64encode(
            b"root:root").decode()}
        st, _h, raw = req(s.base, "/sql", "POST", "SELECT * FROM t", hdr)
        assert json.loads(raw)[0]["result"] == [{"id": "t:1"}]
        ds.capabilities = Capabilities(guest_access=True)
        st, _h, raw = req(s.base, "/sql", "POST", "RETURN 1", NSDB)
        assert json.loads(raw)[0]["result"] == 1
    finally:
        s.close()
        ds.close()


def test_start_user_pass_on_a_restarted_store(tmp_path, monkeypatch):
    """`start --user --pass` over a file:// store twice: the second boot
    keeps the user the first one wrote, and its password still signs
    in; the hash is argon2id here, `$scrypt$` without the package."""
    import surrealdb_tpu_torch.server as SRV
    from surrealdb_tpu_torch import iam
    from surrealdb_tpu_torch.__main__ import define_root_user, main
    from surrealdb_tpu_torch.fnc import misc_fns
    from surrealdb_tpu_torch.kvs.ds import Session

    seen = []

    def fake_serve(ds, host, port, **kw):
        s = Session()
        iam.signin(ds, s, {"user": "admin", "pass": "p w'x"})
        seen.append(s.auth_level)
        ds.close()

    monkeypatch.setattr(SRV, "serve", fake_serve)
    path = f"file://{tmp_path}/db"
    for _ in range(2):
        assert main(["start", "--path", path, "--user", "admin", "--pass",
                     "p w'x", "--device", "off"]) == 0
    assert seen == ["owner", "owner"]
    monkeypatch.setattr(misc_fns, "argon2_available", lambda: False)
    ds = PortDatastore("memory")
    try:
        assert define_root_user(ds, "root", "root") == "scrypt"
    finally:
        ds.close()
