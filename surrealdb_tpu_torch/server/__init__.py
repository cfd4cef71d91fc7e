"""HTTP + WebSocket server surface (the reference package's `server/`;
reference: surrealdb/server/ — axum router server/src/ntw/mod.rs:130 and
the WebSocket session actor server/src/rpc/websocket.rs).

Stdlib-only: ThreadingHTTPServer for routes, hand-rolled RFC6455 WebSocket
upgrade on /rpc with live-query notification push (JSON or CBOR).

Routes: /status, /health, /version, /metrics, /telemetry/traces,
POST /sql, POST /rpc, GET /rpc (the WebSocket), /key/:table[/:id],
POST /ml/import and GET /ml/export/:name/:version (`ml/__init__.py`). The
admission gate, X-Surreal-Timeout and cancel-on-disconnect guard every
data route. POST /signin and /signup answer a token (`iam.py`); an
`Authorization: Bearer <token>` header authenticates the request's
session (an invalid token is a 401, never an anonymous session) and
`Basic` signs its user in. Left out, each answering with the reference's
error envelope for the route and a `NotPorted` message naming it:
/api/* (`DEFINE API`), /graphql, /export, /import and /kv/topology;
the flatbuffers format."""

from __future__ import annotations

import base64
import hashlib
import json
import select
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from surrealdb_tpu_torch import inflight as _inflight
from surrealdb_tpu_torch.err import NotPorted, SdbError, ShedError
from surrealdb_tpu_torch.kvs.ds import Datastore, Session
from surrealdb_tpu_torch.rpc import RpcError, RpcSession
from surrealdb_tpu_torch.val import to_json

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# routes that must stay responsive under overload: liveness probes and
# the observability surface bypass admission control entirely
_UNGATED_PATHS = ("/status", "/health", "/version", "/metrics",
                  "/telemetry/traces")


def _not_ported(what: str) -> str:
    return str(NotPorted(f"{what} is not ported"))


def parse_timeout(raw) -> float:
    """Parse an X-Surreal-Timeout header / rpc `timeout` field into
    seconds: a bare number is seconds; `500ms`/`2s`/`1m` durations are
    accepted. Raises SdbError on garbage (a client that asked for a
    budget and mistyped it must not silently run unbounded)."""
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        v = float(raw)
    else:
        s = str(raw).strip().lower()
        try:
            if s.endswith("ms"):
                v = float(s[:-2]) / 1000.0
            elif s.endswith("s"):
                v = float(s[:-1])
            elif s.endswith("m"):
                v = float(s[:-1]) * 60.0
            else:
                v = float(s)
        except ValueError:
            raise SdbError(f"Invalid timeout value: {raw!r}")
    if v <= 0:
        raise SdbError(f"Invalid timeout value: {raw!r}")
    return v


class _AuthFailed(Exception):
    """Bearer token rejected — maps to HTTP 401."""


class _BodyTooLarge(Exception):
    pass


class SurrealHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    ds: Datastore = None  # set by make_server
    # What an unauthenticated network session gets. Secure default is "none"
    # (reference: anonymous sessions carry no grants); make_server's
    # unauthenticated=True dev mode raises it to "owner".
    anon_level = "none"
    server_obj = None
    admission = None  # AdmissionController (None = unbounded dev mode)
    default_timeout_s = 0.0  # server default query budget (0 = none)

    def log_message(self, fmt, *args):
        pass

    # -- helpers ------------------------------------------------------------
    def _json(self, code: int, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str, ctype="text/plain"):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        from surrealdb_tpu_torch import cnf

        n = int(self.headers.get("Content-Length") or 0)
        if n > cnf.HTTP_MAX_BODY_SIZE:
            raise _BodyTooLarge()
        return self.rfile.read(n) if n else b""

    def _refuse(self, code: int, payload):
        """Answer a left-out route: its body is read first, so the next
        request on a kept-alive connection parses from its own start."""
        self._body()
        self._json(code, payload)

    def _session(self) -> Session:
        s = Session(
            ns=self.headers.get("surreal-ns") or self.headers.get("NS"),
            db=self.headers.get("surreal-db") or self.headers.get("DB"),
            auth_level=self.anon_level,
        )
        s.guests_refused = self.anon_level == "none"
        auth = self.headers.get("Authorization") or ""
        if auth.startswith("Bearer "):
            from surrealdb_tpu_torch.iam import authenticate

            # an invalid token is a hard 401, not a silent downgrade to
            # an anonymous session (reference net/auth.rs)
            try:
                authenticate(self.ds, s, auth[7:])
            except SdbError as e:
                raise _AuthFailed(str(e))
        elif auth.startswith("Basic "):
            from surrealdb_tpu_torch.iam import signin

            try:
                raw = base64.b64decode(auth[6:]).decode()
                user, _, passwd = raw.partition(":")
                signin(self.ds, s,
                       {"user": user, "pass": passwd, "NS": s.ns, "DB": s.db})
            except (SdbError, ValueError):
                s.auth_level = "none"
        return s

    def _run_sql(self, sql: str, sess: Session, vars=None):
        res = self.ds.execute(sql, session=sess, vars=vars or {})
        out = []
        for r in res:
            row = {
                "status": "OK" if r.ok else "ERR",
                "result": to_json(r.result) if r.ok else r.error,
                "time": f"{r.time_ns / 1e6:.3f}ms",
            }
            if getattr(r, "partial", None):
                # typed partial KNN answer (SURREAL_KNN_PARTIAL=partial):
                # the client must be able to see WHICH shards are missing
                row["partial"] = r.partial
            out.append(row)
        return out

    def _api_route(self, method: str):
        """/api/:ns/:db/<path> serves DEFINE API endpoints, which are
        not ported: the route's error envelope (404) names it."""
        self._refuse(404, {"error": _not_ported("/api/* (DEFINE API)")})

    # -- admission / deadline / cancellation --------------------------------
    def _deadline(self):
        """Absolute monotonic deadline for this request: the client's
        X-Surreal-Timeout header, else the server default (0 = none)."""
        raw = self.headers.get("X-Surreal-Timeout") \
            or self.headers.get("surreal-timeout")
        if raw:
            return time.monotonic() + parse_timeout(raw)
        if self.default_timeout_s:
            return time.monotonic() + self.default_timeout_s
        return None

    def _shed_response(self, e: ShedError):
        body = json.dumps({
            "error": str(e), "code": 503,
            "retry_after_ms": int(e.retry_after_s * 1000),
        }).encode()
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After",
                         str(max(1, int(e.retry_after_s + 0.999))))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _conn_dropped(self) -> bool:
        """True when the client socket is at EOF (peer went away). TLS
        sockets reject MSG_PEEK (ValueError) — treat those as alive:
        no disconnect watch, the deadline still bounds the work.

        Deliberate semantic: a half-close (client shutdown(SHUT_WR)
        after sending the request) also reads as EOF and cancels the
        query — the common reverse-proxy/server posture (nginx treats
        client aborts the same way). Clients that half-close and still
        expect a response must send a deadline instead."""
        try:
            r, _w, _x = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except ValueError:
            return False  # SSLSocket: flags unsupported
        except OSError:
            return True

    def _run_watched(self, fn, handle):
        """Run `fn` in a worker thread while THIS thread watches the
        client socket: a disconnect flips the query's cancel flag, so an
        abandoned request releases its worker slot within one
        check_deadline interval instead of running to completion."""
        done = threading.Event()
        out: dict = {}

        def run():
            try:
                with _inflight.activate(handle):
                    fn()
            except BaseException as e:  # re-raised on the dispatch thread
                out["exc"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="surreal-query-worker")
        t.start()
        try:
            while not done.wait(0.05):
                if not handle.cancel.is_set() and self._conn_dropped():
                    handle.cancel.set()
        finally:
            done.wait()
        if "exc" in out:
            raise out["exc"]

    # -- routes -------------------------------------------------------------
    def _dispatch(self, fn):
        try:
            self._dispatch_gated(fn)
        except _BodyTooLarge:
            # the oversized body was never read — keep-alive would parse
            # its bytes as the next request line, so drop the connection
            self.close_connection = True
            self._json(413, {
                "error": "Request body exceeds the maximum allowed size"
            })
        except _AuthFailed as e:
            self._json(401, {"error": str(e)})
        except ShedError as e:
            self._shed_response(e)
        except SdbError as e:
            self._json(400, {"error": str(e)})
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-response: nothing left to tell it
            self.close_connection = True

    def _dispatch_gated(self, fn):
        path = urlparse(self.path).path
        # liveness/observability bypass; the WS upgrade admits per
        # REQUEST inside its read loop, not per connection
        if (self.admission is None or path in _UNGATED_PATHS
                or (path == "/rpc" and self.command == "GET")):
            fn()
            return
        deadline = self._deadline()
        ticket = self.admission.admit(deadline)
        handle = self.ds.inflight.open(
            self.headers.get("surreal-ns") or self.headers.get("NS"),
            self.headers.get("surreal-db") or self.headers.get("DB"),
            f"{self.command} {path}", deadline,
        )
        handle.edge = True  # first ds.execute refines to the real SQL
        try:
            self._run_watched(fn, handle)
        finally:
            self.ds.inflight.close(handle)
            ticket.release()

    def do_GET(self):
        self._dispatch(self._do_GET)

    def do_POST(self):
        self._dispatch(self._do_POST)

    def do_PUT(self):
        self._dispatch(self._do_PUT)

    def do_PATCH(self):
        self._dispatch(self._do_PATCH)

    def do_DELETE(self):
        self._dispatch(self._do_DELETE)

    def _do_GET(self):
        path = urlparse(self.path).path
        if path.startswith("/api/"):
            self._api_route("GET")
            return
        if path in ("/status", "/health"):
            self._text(200, "")
            return
        if path == "/version":
            import surrealdb_tpu_torch

            self._text(200, f"surrealdb-tpu-{surrealdb_tpu_torch.__version__}")
            return
        if path == "/metrics":
            # Prometheus text format (reference telemetry/metrics; pull
            # instead of OTLP push — no egress in this build). Gated like
            # other data routes: traces/counters leak query shapes.
            if self._session().auth_level == "none":
                self._json(401, {"error": "Not authenticated"})
                return
            self._text(200, self.ds.telemetry.prometheus(self.ds),
                       "text/plain; version=0.0.4")
            return
        if path == "/telemetry/traces":
            if self._session().auth_level == "none":
                self._json(401, {"error": "Not authenticated"})
                return
            self._json(200, self.ds.telemetry.recent_traces())
            return
        if path == "/kv/topology":
            # the sharded KV engine is not ported
            self._json(503, {"error": _not_ported("/kv/topology")})
            return
        if path == "/export":
            self._json(400, {"error": _not_ported("/export")})
            return
        if path == "/rpc":
            self._ws_upgrade()
            return
        if path.startswith("/ml/export/"):
            # /ml/export/:name/:version (reference ntw /ml/*)
            sess = self._session()
            if sess.auth_level == "none":
                self._json(401, {"error": "Not authenticated"})
                return
            segs = [unquote(x) for x in path.split("/") if x]
            if len(segs) != 4 or not sess.ns or not sess.db:
                self._json(400, {"error": "Expected /ml/export/:name/:version with ns/db headers"})
                return
            from surrealdb_tpu_torch.ml import export_model

            try:
                raw = export_model(self.ds, sess.ns, sess.db, segs[2], segs[3])
            except SdbError as e:
                self._json(404, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
            return
        if path.startswith("/key/"):
            self._key_route("GET")
            return
        self._json(404, {"error": "Not found"})

    def _do_POST(self):
        path = urlparse(self.path).path
        if path.startswith("/api/"):
            self._api_route("POST")
            return
        if path == "/sql":
            sess = self._session()
            sql = self._body().decode()
            try:
                self._json(200, self._run_sql(sql, sess))
            except SdbError as e:
                self._json(400, {"error": str(e)})
            return
        if path == "/ml/import":
            sess = self._session()
            if sess.auth_level == "none":
                self._json(401, {"error": "Not authenticated"})
                return
            if not sess.ns or not sess.db:
                self._json(400, {"error": "Specify ns and db headers"})
                return
            from surrealdb_tpu_torch.ml import import_model

            try:
                d = import_model(self.ds, sess.ns, sess.db, self._body())
            except SdbError as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, {"name": d.name, "version": d.version,
                             "hash": d.hash})
            return
        if path == "/import":
            self._refuse(400, {"error": _not_ported("/import")})
            return
        if path == "/signin":
            from surrealdb_tpu_torch.iam import signin

            try:
                creds = json.loads(self._body() or b"{}")
                token = signin(self.ds, self._session(), creds)
                self._json(200, {"code": 200,
                                 "details": "Authentication succeeded",
                                 "token": token})
            except SdbError as e:
                self._json(401, {"code": 401, "details": str(e)})
            return
        if path == "/signup":
            from surrealdb_tpu_torch.iam import signup

            try:
                creds = json.loads(self._body() or b"{}")
                token = signup(self.ds, self._session(), creds)
                self._json(200, {"code": 200,
                                 "details": "Authentication succeeded",
                                 "token": token})
            except SdbError as e:
                self._json(401, {"code": 401, "details": str(e)})
            return
        if path == "/rpc":
            # HTTP one-shot RPC with format negotiation
            # (json | cbor | flatbuffers — reference api/mod.rs MIME list)
            ctype = (self.headers.get("Content-Type") or "").lower()
            accept = (self.headers.get("Accept") or ctype).lower()
            if "flatbuffers" in ctype or "flatbuffers" in accept:
                # the flatbuffers format needs the `flatbuffers` package
                self._refuse(200, {"id": None, "error": {
                    "code": -32000,
                    "message": _not_ported("the flatbuffers format")}})
                return
            fmt_in = "cbor" if "cbor" in ctype else "json"
            fmt_out = "cbor" if "cbor" in accept else "json"
            rich_out = fmt_out != "json"

            def respond(payload):
                if fmt_out == "cbor":
                    from surrealdb_tpu_torch import wire

                    body = wire.encode(payload)
                    mime = "application/cbor"
                else:
                    self._json(200, payload)
                    return
                self.send_response(200)
                self.send_header("Content-Type", mime)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            req = {}
            try:
                raw = self._body() or b"{}"
                if fmt_in == "cbor":
                    from surrealdb_tpu_torch import wire

                    decoded = wire.decode(raw)
                else:
                    decoded = json.loads(raw)
                if not isinstance(decoded, dict):
                    # req stays {} so the error path can req.get("id")
                    raise SdbError("rpc request must be an object")
                req = decoded
                rs = RpcSession(self.ds, anon_level=self.anon_level)
                rs.session = self._session()
                out = rs.handle(req.get("method", ""), req.get("params") or [])
                respond({
                    "id": req.get("id"),
                    "result": out if rich_out else to_json(out),
                })
            except RpcError as e:
                respond({"id": req.get("id"),
                         "error": {"code": e.code, "message": str(e)}})
            except SdbError as e:
                respond({"id": req.get("id"),
                         "error": {"code": -32000, "message": str(e)}})
            except ValueError:
                # a body that is not JSON: the parse-error envelope the
                # WebSocket answers a garbled frame with (the reference
                # lets the decode error escape and drops the connection)
                respond({"id": None,
                         "error": {"code": -32700, "message": "Parse error"}})
            return
        if path.startswith("/key/"):
            self._key_route("POST")
            return
        if path == "/graphql":
            # the GraphQL route's error envelope
            self._refuse(200, {"errors": [
                {"message": _not_ported("/graphql")}]})
            return
        self._json(404, {"error": "Not found"})

    def _do_PUT(self):
        if urlparse(self.path).path.startswith("/api/"):
            self._api_route("PUT")
            return
        if urlparse(self.path).path.startswith("/key/"):
            self._key_route("PUT")
            return
        self._json(404, {"error": "Not found"})

    def _do_PATCH(self):
        if urlparse(self.path).path.startswith("/key/"):
            self._key_route("PATCH")
            return
        self._json(404, {"error": "Not found"})

    def _do_DELETE(self):
        if urlparse(self.path).path.startswith("/key/"):
            self._key_route("DELETE")
            return
        self._json(404, {"error": "Not found"})

    def _key_route(self, method: str):
        """REST CRUD: /key/:table[/:id] (reference ntw key routes)."""
        parts = [unquote(p) for p in urlparse(self.path).path.split("/")[2:]]
        qs = parse_qs(urlparse(self.path).query)
        sess = self._session()
        tb = parts[0] if parts else None
        rid = parts[1] if len(parts) > 1 else None
        if not tb:
            self._json(400, {"error": "Missing table"})
            return
        # Bind the path segments as parameters — never interpolate raw URL
        # text into SurrealQL (reference builds these from parsed Thing
        # values; crafted /key/:table/:id segments must not inject syntax).
        vars = {"_tb": tb}
        if rid is not None:
            vars["_id"] = rid
            target = "type::record($_tb, $_id)"
        else:
            target = "type::table($_tb)"
        body = self._body()
        data = None
        if body:
            try:
                data = json.loads(body)
            except ValueError:
                self._json(400, {"error": "Invalid JSON body"})
                return
        try:
            limit = int(qs.get("limit", ["100"])[0])
            start = int(qs.get("start", ["0"])[0])
        except ValueError:
            self._json(400, {"error": "Invalid limit/start"})
            return
        if method == "GET":
            sql = f"SELECT * FROM {target} LIMIT {limit} START {start}"
        elif method == "POST":
            vars["data"] = data or {}
            sql = f"CREATE {target} CONTENT $data"
        elif method == "PUT":
            vars["data"] = data or {}
            sql = f"UPDATE {target} CONTENT $data"
        elif method == "PATCH":
            vars["data"] = data or {}
            sql = f"UPDATE {target} MERGE $data"
        else:
            sql = f"DELETE {target} RETURN BEFORE"
        self._json(200, self._run_sql(sql, sess, vars))

    # -- websocket ----------------------------------------------------------
    def _ws_upgrade(self):
        key = self.headers.get("Sec-WebSocket-Key")
        if not key or "websocket" not in (
            self.headers.get("Upgrade") or ""
        ).lower():
            self._json(426, {"error": "WebSocket upgrade required"})
            return
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        # format negotiation rides the subprotocol header, like the
        # reference (server/src/rpc: cbor | json; json when unstated)
        offered = [
            p.strip()
            for p in (self.headers.get("Sec-WebSocket-Protocol") or "").split(",")
            if p.strip()
        ]
        proto = next(
            (p for p in offered if p in ("cbor", "json", "flatbuffers")),
            None,
        )
        if proto == "flatbuffers":
            self._json(400, {"error": _not_ported("the flatbuffers format")})
            return
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        if proto:
            self.send_header("Sec-WebSocket-Protocol", proto)
        self.end_headers()
        self.close_connection = True
        self._ws_serve(fmt=proto or "json")

    @staticmethod
    def _ws_frame(payload) -> bytes:
        """One complete RFC6455 server frame for `payload` (bytes →
        binary opcode, str → text)."""
        if isinstance(payload, bytes):
            data, header = payload, b"\x82"  # FIN + binary (cbor)
        else:
            data, header = payload.encode(), b"\x81"  # FIN + text
        n = len(data)
        if n < 126:
            header += struct.pack("!B", n)
        elif n < (1 << 16):
            header += struct.pack("!BH", 126, n)
        else:
            header += struct.pack("!BQ", 127, n)
        return header + data

    def _ws_send(self, payload):
        # lint: lock-held(per-connection write mutex: it exists only to keep WS frames whole on this socket; nothing else waits on it)
        with self._ws_lock:
            self.connection.sendall(self._ws_frame(payload))

    def _ws_recv(self):
        """Read one frame; returns (opcode, payload) or None on close."""
        hdr = self.rfile.read(2)
        if len(hdr) < 2:
            return None
        b1, b2 = hdr
        opcode = b1 & 0x0F
        masked = b2 & 0x80
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self.rfile.read(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self.rfile.read(8))[0]
        from surrealdb_tpu_torch import cnf

        if n > cnf.WEBSOCKET_MAX_MESSAGE_SIZE:
            return None  # oversized frame: drop the connection
        mask = self.rfile.read(4) if masked else b"\x00" * 4
        data = bytearray(self.rfile.read(n))
        if masked:
            for i in range(len(data)):
                data[i] ^= mask[i % 4]
        return opcode, bytes(data)

    def _ws_serve(self, fmt: str = "json"):
        rs = RpcSession(self.ds, anon_level=self.anon_level)
        self._ws_lock = threading.Lock()
        if fmt == "cbor":
            from surrealdb_tpu_torch import wire

            pack = wire.encode
            unpack = wire.decode
            jsonify = lambda v: v  # cbor carries rich values natively
        else:
            pack = json.dumps
            unpack = lambda data: json.loads(data.decode())
            jsonify = to_json

        # live-query notification push: the session actor is read/write
        # split (reference rpc/websocket.rs:47) — THIS thread only reads
        # requests; notifications flow through a bounded per-session
        # outbox drained by a dedicated writer thread, so a consumer
        # whose TCP window is full stalls only its own writer, never a
        # committing transaction or another session
        def send_notes(notes):
            frames = bytearray()
            for n in notes:
                frames += self._ws_frame(pack({
                    "result": {
                        "id": n.live_id,
                        "action": n.action,
                        "record": jsonify(n.record),
                        "result": jsonify(n.result),
                    }
                }))
            # burst coalescing: one sendall for the whole batch
            # lint: lock-held(per-connection write mutex: frame atomicity on this socket only)
            with self._ws_lock:
                self.connection.sendall(bytes(frames))

        def force_close():
            # overflow policy "disconnect": kick the laggard — the read
            # loop unblocks with EOF and the finally-block GC runs
            try:
                self.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

        outbox = self.ds.fanout.register_session(
            send_notes, close_conn=force_close,
            label=f"{self.client_address[0]}:{self.client_address[1]}"
            if self.client_address else "",
        )
        # the LIVE statement itself binds lid→outbox atomically with
        # subscription registration (exec/statements.py _s_live) —
        # binding only at the rpc layer would race dispatch
        rs.session.live_outbox = outbox
        try:
            while True:
                frame = self._ws_recv()
                if frame is None:
                    break
                opcode, data = frame
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping -> pong
                    # lint: lock-held(per-connection write mutex: frame atomicity on this socket only)
                    with self._ws_lock:
                        self.connection.sendall(
                            b"\x8a" + struct.pack("!B", len(data)) + data
                        )
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                try:
                    req = unpack(data)
                    if not isinstance(req, dict):
                        raise ValueError("request must be an object")
                except Exception:
                    # a malformed frame (truncated cbor raises IndexError,
                    # bad json ValueError, non-map top level …) must never
                    # kill the session — answer with the parse error
                    self._ws_send(pack({
                        "error": {"code": -32700, "message": "Parse error"}
                    }))
                    continue
                rid = req.get("id")
                try:
                    # per-REQUEST admission + deadline: one connection
                    # cannot monopolize worker slots between queries,
                    # and the rpc `timeout` field mirrors the HTTP
                    # X-Surreal-Timeout header
                    deadline = None
                    if req.get("timeout") is not None:
                        deadline = (time.monotonic()
                                    + parse_timeout(req["timeout"]))
                    elif self.default_timeout_s:
                        deadline = (time.monotonic()
                                    + self.default_timeout_s)
                    ticket = (self.admission.admit(deadline)
                              if self.admission is not None else None)
                    handle = self.ds.inflight.open(
                        rs.session.ns, rs.session.db,
                        f"rpc {req.get('method', '')}", deadline,
                    )
                    handle.edge = True
                    try:
                        with _inflight.activate(handle):
                            out = rs.handle(
                                req.get("method", ""),
                                req.get("params") or [],
                                deadline=deadline,
                            )
                    finally:
                        self.ds.inflight.close(handle)
                        if ticket is not None:
                            ticket.release()
                    self._ws_send(pack(
                        {"id": rid, "result": jsonify(out)}
                    ))
                except ShedError as e:
                    self._ws_send(pack({
                        "id": rid,
                        "error": {
                            "code": 503, "message": str(e),
                            "retry_after_ms": int(e.retry_after_s * 1000),
                        },
                    }))
                except RpcError as e:
                    self._ws_send(pack({
                        "id": rid,
                        "error": {"code": e.code, "message": str(e)},
                    }))
                except SdbError as e:
                    self._ws_send(pack({
                        "id": rid,
                        "error": {"code": -32000, "message": str(e)},
                    }))
        finally:
            # session teardown: stop routing, then GC this session's
            # live queries (registry entries + persisted !lq rows) — a
            # session that dies without KILL must not keep paying match
            # cost on every write forever
            self.ds.fanout.unregister_session(outbox)
            if rs.live_ids:
                self.ds.gc_session_lives(rs.live_ids)


def make_server(ds: Datastore, host="127.0.0.1", port=8000,
                unauthenticated=False, tls_cert=None,
                tls_key=None, max_inflight=None, queue_depth=None,
                default_timeout_s=None) -> ThreadingHTTPServer:
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.server.admission import AdmissionController

    if max_inflight is None:
        max_inflight = cnf.HTTP_MAX_INFLIGHT
    if queue_depth is None:
        queue_depth = cnf.HTTP_QUEUE_DEPTH
    if default_timeout_s is None:
        default_timeout_s = cnf.HTTP_DEFAULT_TIMEOUT_S
    admission = (
        AdmissionController(max_inflight, queue_depth,
                            telemetry=ds.telemetry)
        if max_inflight and max_inflight > 0 else None
    )
    handler = type("BoundHandler", (SurrealHandler,), {
        "ds": ds,
        "anon_level": "owner" if unauthenticated else "none",
        "admission": admission,
        "default_timeout_s": default_timeout_s or 0.0,
    })
    # a deep accept backlog lets a connection burst reach admission
    # control (typed 503 + Retry-After) instead of dying as kernel RSTs
    # at the default listen(5)
    class _HttpServer(ThreadingHTTPServer):
        request_queue_size = 128
        daemon_threads = True

    if not tls_cert:
        srv = _HttpServer((host, port), handler)
        srv.admission = admission
        return srv
    # TLS termination in-process (reference ntw: axum_server rustls from
    # --web-crt/--web-key). The handshake runs in the per-connection
    # handler thread — doing it inside accept() would let one stalled
    # client block every new connection.
    import ssl

    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(tls_cert, tls_key)

    class TlsServer(_HttpServer):
        def get_request(self):
            sock, addr = self.socket.accept()
            sock.settimeout(30)
            return sctx.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False
            ), addr

        def finish_request(self, request, client_address):
            request.do_handshake()
            request.settimeout(None)
            super().finish_request(request, client_address)

        def handle_error(self, request, client_address):
            import ssl as _ssl

            import sys as _sys

            et = _sys.exc_info()[0]
            if et is not None and issubclass(
                et, (_ssl.SSLError, TimeoutError, OSError)
            ):
                return  # failed/stalled handshakes are routine noise
            super().handle_error(request, client_address)

    srv = TlsServer((host, port), handler)
    srv.admission = admission
    return srv


def drain_and_shutdown(srv, ds: Datastore, drain_timeout_s: float) -> bool:
    """Graceful drain (the SIGTERM path): stop admitting — every new
    request sheds with a retryable 503 — wait up to `drain_timeout_s`
    for in-flight work, cooperatively cancel whatever remains, then stop
    the accept loop. Returns True when everything finished inside the
    budget (no cancellation needed)."""
    admission = getattr(srv, "admission", None)
    clean = True
    if admission is not None:
        clean = admission.drain(drain_timeout_s)
    if not clean or admission is None:
        ds.inflight.cancel_all()
        # cancelled queries notice at their next check_deadline site;
        # give them one beat to unwind before the socket goes away
        end = time.monotonic() + 2.0
        while ds.inflight.count() > 0 and time.monotonic() < end:
            time.sleep(0.02)
    # push-path drain: flush committed-but-undispatched notifications,
    # give session writers a beat to deliver their queues, then close —
    # the CancelEvent wakers wake parked writers immediately
    ds.fanout.drain(timeout=min(drain_timeout_s, 5.0))
    ds.fanout.close_all()
    srv.shutdown()
    # the device runner holds nothing durable (its caches rebuild from
    # KV truth) — kill it with the server instead of leaving an orphan
    from surrealdb_tpu_torch.device import get_supervisor

    get_supervisor().shutdown()
    return clean


def serve(ds: Datastore, host="127.0.0.1", port=8000, unauthenticated=False,
          tls_cert=None, tls_key=None, max_inflight=None, queue_depth=None,
          default_timeout_s=None, drain_timeout_s=None):
    from surrealdb_tpu_torch import cnf

    srv = make_server(ds, host, port, unauthenticated=unauthenticated,
                      tls_cert=tls_cert, tls_key=tls_key,
                      max_inflight=max_inflight, queue_depth=queue_depth,
                      default_timeout_s=default_timeout_s)
    if drain_timeout_s is None:
        drain_timeout_s = cnf.DRAIN_TIMEOUT_S
    # SIGTERM → graceful drain. shutdown() must run off the serving
    # thread (it blocks until serve_forever returns), so the handler
    # hands the drain to a helper thread and serve_forever unwinds.
    import signal

    def on_sigterm(_sig, _frm):
        threading.Thread(
            target=drain_and_shutdown, args=(srv, ds, drain_timeout_s),
            daemon=True, name="surreal-drain",
        ).start()

    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded serve): no signal hook
    # served nodes join the cluster: heartbeat + membership GC loops
    # (reference engine/tasks.rs); embedded datastores stay single-node
    ds.start_node_tasks()
    # prewarm the device runner at boot (async): torch/CUDA init happens
    # in the supervised subprocess under the init watchdog while the
    # server is already accepting (in mode auto early queries serve from
    # the host; traffic moves to the card when the runner reports ready)
    from surrealdb_tpu_torch.device import get_supervisor

    get_supervisor().ensure_started()
    scheme = "https" if tls_cert else "http"
    print(f"surrealdb-tpu listening on {scheme}://{host}:{port}")
    srv.serve_forever()
