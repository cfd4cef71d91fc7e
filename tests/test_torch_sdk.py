"""The port's SDK (`sdk/`) against the reference's: the same method-API
scenario runs through each package's embedded engine (`mem://`,
`file://`), WebSocket engine (CBOR and JSON) and one-shot HTTP engine,
each remote engine against its own package's server on port 0, and the
answers are the same.

Tolerance: answers are normalised as `torch_sql_harness.norm` does
(floats to atol 1e-4, rtol 1e-5, everything else exactly), measured
"time" fields dropped. Live query ids are random uuids and compare only
within one package.
"""

import threading
import time

import pytest

from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
from surrealdb_tpu.sdk import connect as rconnect
from surrealdb_tpu.server import make_server as ref_make_server
from surrealdb_tpu_torch.err import NotPorted, SdbError
from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore
from surrealdb_tpu_torch.sdk import connect as pconnect
from surrealdb_tpu_torch.server import make_server
from torch_sql_harness import norm, same


def _untimed(v):
    if isinstance(v, list):
        return [_untimed(x) for x in v]
    if isinstance(v, dict):
        return {k: _untimed(x) for k, x in v.items() if k != "time"}
    return v


class _Server:
    def __init__(self, ds, make):
        self.ds = ds
        self.srv = make(ds, "127.0.0.1", 0, unauthenticated=True)
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.ds.close()


@pytest.fixture()
def servers():
    ref = _Server(RefDatastore("memory"), ref_make_server)
    port = _Server(PortDatastore("memory"), make_server)
    try:
        yield ref, port
    finally:
        ref.close()
        port.close()


def _crud_scenario(db):
    """The reference's SDK scenario; returns every answer."""
    out = []
    db.use("t", "t")
    created = db.create("person:1", {"name": "ada", "age": 36})
    assert created and created[0]["name"] == "ada"
    out.append(created)
    out.append(db.create("person:2", {"name": "bob", "age": 41}))
    rows = db.select("person")
    assert len(rows) == 2
    out.append(rows)
    up = db.update("person:1", {"name": "ada", "age": 37})
    assert up[0]["age"] == 37
    out.append(up)
    out.append(db.merge("person:2", {"city": "x"}))
    out.append(db.select("person:2"))
    res = db.query("SELECT * FROM person WHERE age > $a ORDER BY age",
                   {"a": 36})
    assert res[0]["status"] == "OK"
    assert [r["age"] for r in res[0]["result"]] == [37, 41]
    out.append(res)
    out.append(db.upsert("person:3", {"name": "cy", "age": 5}))
    out.append(db.patch("person:3", [{"op": "replace", "path": "/age",
                                      "value": 6}]))
    out.append(db.insert("person", [{"id": 4, "name": "di"}]))
    out.append(db.relate("person:1", "knows", "person:2", {"since": 2020}))
    k = db.query("SELECT VALUE ->knows->person FROM ONLY person:1")
    assert k[0]["status"] == "OK" and len(k[0]["result"]) == 1
    out.append(k)
    assert db.run("string::uppercase", "abc") == "ABC"
    db.let("lim", 2)
    out.append(db.query("SELECT name FROM person ORDER BY name LIMIT $lim"))
    db.unset("lim")
    gone = db.delete("person:2")
    assert gone[0]["name"] == "bob"
    out.append(gone)
    out.append(db.select("person"))
    out.append(db.ping())
    assert "surrealdb-tpu" in db.version()
    out.append(db.version())
    with pytest.raises(Exception) as ei:  # each package's SdbError
        db.query("THROW 'nope'")
    out.append(str(ei.value))
    out.append(db.query("RETURN 1; THROW 'x'"))
    return _untimed(norm(out))


def _edges_scrubbed(v):
    """The RELATE answer's edge id is random: keep its table only."""
    if isinstance(v, list):
        return [_edges_scrubbed(x) for x in v]
    if isinstance(v, dict):
        return {k: _edges_scrubbed(x) for k, x in v.items()}
    if isinstance(v, tuple) and len(v) == 3 and v[:2] == ("rid", "knows"):
        return ("rid", "knows", "<rand>")
    if isinstance(v, str) and v.startswith("knows:"):
        return "knows:<rand>"
    return v


def test_local_engine_crud():
    with rconnect("mem://") as r, pconnect("mem://") as p:
        same(_edges_scrubbed(_crud_scenario(r)),
             _edges_scrubbed(_crud_scenario(p)))


@pytest.mark.parametrize("fmt", ["cbor", "json"])
def test_ws_engine_crud(servers, fmt):
    ref, port = servers
    with rconnect(f"ws://127.0.0.1:{ref.port}", fmt=fmt) as r, \
            pconnect(f"ws://127.0.0.1:{port.port}", fmt=fmt) as p:
        same(_edges_scrubbed(_crud_scenario(r)),
             _edges_scrubbed(_crud_scenario(p)))


@pytest.mark.parametrize("fmt", ["cbor", "json"])
def test_http_engine_crud(servers, fmt):
    ref, port = servers
    with rconnect(f"http://127.0.0.1:{ref.port}", fmt=fmt) as r, \
            pconnect(f"http://127.0.0.1:{port.port}", fmt=fmt) as p:
        same(_edges_scrubbed(_crud_scenario(r)),
             _edges_scrubbed(_crud_scenario(p)))


def _live_scenario(connect, url):
    with connect(url) as db:
        db.use("t", "t")
        got = []
        lid = db.live("person", got.append)
        assert lid
        with connect(url) as w:
            w.use("t", "t")
            w.create("person:9", {"name": "eve"})
            w.update("person:9", {"name": "eve2"})
            w.delete("person:9")
        deadline = time.monotonic() + 5
        while len(got) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        notes = [(n["action"], norm(n["record"]), norm(n["result"]))
                 for n in got]
        assert all(str(n["id"]) == lid or getattr(n["id"], "u", None)
                   for n in got)
        db.kill(lid)
        with connect(url) as w:
            w.use("t", "t")
            w.create("person:10", {"name": "zed"})
        time.sleep(0.3)
        return notes, len(got)


def test_ws_live_push(servers):
    """LIVE over the WebSocket engine: notifications arrive on the
    client socket in order; KILL stops them."""
    ref, port = servers
    r = _live_scenario(rconnect, f"ws://127.0.0.1:{ref.port}")
    p = _live_scenario(pconnect, f"ws://127.0.0.1:{port.port}")
    same(r, p)
    assert [n[0] for n in p[0]] == ["CREATE", "UPDATE", "DELETE"]
    assert p[1] == 3


def test_local_live_push():
    out = []
    for connect in (rconnect, pconnect):
        with connect("mem://") as db:
            db.use("t", "t")
            got = []
            db.live("person", got.append)
            db.create("person:5", {"name": "lil"})
            deadline = time.monotonic() + 3
            while not got and time.monotonic() < deadline:
                time.sleep(0.02)
            out.append([(n["action"], norm(n["record"]), norm(n["result"]))
                        for n in got])
    same(out[0], out[1])
    assert out[1][0][0] == "CREATE"


def test_http_engine_rejects_live(servers):
    _ref, port = servers
    with pconnect(f"http://127.0.0.1:{port.port}") as db:
        db.use("t", "t")
        with pytest.raises(SdbError, match="not supported over the HTTP"):
            db.live("person", lambda n: None)


def test_scheme_dispatch_file(tmp_path):
    p = tmp_path / "db"
    with pconnect(f"file://{p}") as db:
        db.use("t", "t")
        db.create("person:1", {"name": "p"})
    with pconnect(f"file://{p}") as db:  # durable across reopen
        db.use("t", "t")
        assert db.select("person:1")[0]["name"] == "p"


def test_scheme_dispatch_rejects_unknown():
    with pytest.raises(SdbError, match="unsupported connection scheme"):
        pconnect("bogus://x")


def test_ws_survives_malformed_frames(servers):
    """A garbled CBOR frame gets a parse-error reply, and neither the
    server's session nor the client's reader dies."""
    _ref, port = servers
    with pconnect(f"ws://127.0.0.1:{port.port}") as db:
        db.use("t", "t")
        db.engine._send_frame(b"\x81", 0x2)  # truncated cbor array
        db.engine._send_frame(b"\x01", 0x2)  # top-level non-map
        assert db.version() == "surrealdb-tpu-0.1.0"


# -- what the port leaves out -------------------------------------------------------


@pytest.mark.parametrize("url", ["mem://", "ws://127.0.0.1:1",
                                 "http://127.0.0.1:1"])
@pytest.mark.parametrize("fmt", ["fb", "flatbuffers"])
def test_flatbuffers_format_not_ported(url, fmt):
    with pytest.raises(NotPorted, match="flatbuffers format is not ported"):
        pconnect(url, fmt=fmt)


def test_remote_engine_not_ported():
    with pytest.raises(NotPorted, match="remote:// engine is not ported"):
        pconnect("remote://127.0.0.1:1")


@pytest.mark.parametrize("engine", ["local", "ws", "http"])
@pytest.mark.parametrize("method", ["signin", "signup", "authenticate",
                                    "graphql"])
def test_left_out_methods_name_themselves(servers, engine, method):
    """signin, signup, authenticate and graphql are ported: through each
    engine they answer as the reference's SDK does (tokens with the same
    claims, the same session after them, the same refusal of a bad
    token; the same GraphQL answer)."""
    ref, port = servers

    def url(srv):
        return {"local": "mem://", "ws": f"ws://127.0.0.1:{srv.port}",
                "http": f"http://127.0.0.1:{srv.port}"}[engine]

    if method == "graphql":
        outs = []
        for srv, connect in ((ref, rconnect), (port, pconnect)):
            with connect(url(srv)) as db:
                db.use("t", "t")
                db.query("DEFINE TABLE OVERWRITE gqp; "
                         "DEFINE CONFIG OVERWRITE GRAPHQL AUTO; "
                         "UPSERT gqp:1 SET n = 1")
                try:
                    outs.append(norm(db.graphql("{ gqp { id n } }")))
                except SdbError as e:
                    outs.append(("err", str(e)))
        same(outs[0], outs[1])
        assert "not ported" not in str(outs[1])
        return
    outs = []
    for srv, connect in ((ref, rconnect), (port, pconnect)):
        out = []
        with connect(url(srv)) as db:
            db.use("t", "t")
            db.query(_SDK_AUTH)
            if method == "signin":
                out.append(_claims(db.signin(user="root", passwd="root")))
            elif method == "signup":
                out.append(_claims(db.signup(
                    NS="t", DB="t", AC="account", name="u", **{"pass": "p"})))
            else:
                db.signup(NS="t", DB="t", AC="account", name="v",
                          **{"pass": "p"})
                tok = db.signin(NS="t", DB="t", AC="account", name="v",
                                **{"pass": "p"})
                db.invalidate()
                db.authenticate(tok)
            out.append(_untimed(norm(db.query(
                "RETURN [session::ac(), $auth.id]"))))
            if method == "authenticate" and engine != "http":
                try:
                    db.authenticate("bad.token.here")
                    out.append("accepted")
                except Exception as e:
                    out.append(str(e))
        outs.append(out)
    same(outs[0], outs[1])
    if method == "authenticate" and engine == "http":
        # the stateless engine keeps the token client-side; the next
        # request carries it as a Bearer header, which the server
        # refuses (a 401) instead of serving anonymously
        with pconnect(url(port)) as db:
            db.use("t", "t")
            db.authenticate("bad.token.here")
            with pytest.raises(SdbError, match="There was a problem with "
                                               "authentication"):
                db.query("RETURN 1")


_SDK_AUTH = (
    "DEFINE USER IF NOT EXISTS root ON ROOT PASSWORD 'root' ROLES OWNER; "
    "DEFINE ACCESS IF NOT EXISTS account ON DATABASE TYPE RECORD "
    "SIGNUP (CREATE type::record('user', $name) SET pass = "
    "crypto::scrypt::generate($pass)) "
    "SIGNIN (SELECT * FROM user WHERE id = type::record('user', $name) "
    "AND crypto::scrypt::compare(pass, $pass))")


def _claims(token):
    import base64
    import json

    body = token.split(".")[1]
    payload = json.loads(base64.urlsafe_b64decode(body + "=" * (-len(body) % 4)))
    return {k: v for k, v in payload.items() if k not in ("iat", "exp")}
