"""SDK: the client-facing fluent API over pluggable engines (the
reference package's `sdk/`).

Reference shape: `surrealdb/src/` — `Surreal<C>` with `method/` (fluent
query/select/create/... calls), `engine/local` (embeds the datastore in
process), `engine/remote/ws` (WebSocket + CBOR client), and `engine/any`
(runtime scheme dispatch: mem:// file:// ws:// http://).

Here the local engine wraps `Datastore` + `RpcSession` (same method
dispatch the server uses, so both engines run identical code paths), and
the remote engines speak the server's own wire formats: a hand-rolled
RFC 6455 WebSocket client with `Sec-WebSocket-Protocol: cbor|json`
negotiation, or one-shot HTTP `/rpc` POSTs.

    from surrealdb_tpu_torch.sdk import connect
    db = connect("ws://127.0.0.1:8000")      # or "mem://", "http://…"
    db.signin(user="root", passwd="root")
    db.use("ns", "db")
    db.create("person:1", {"name": "a"})
    rows = db.query("SELECT * FROM person")
    lid = db.live("person", lambda n: print(n))

`signin`, `signup` and `authenticate` go through the server's `iam.py`
(the HTTP engine replays the session's token on each request);
`graphql` reaches the server's `gql.py`. Not ported: the flatbuffers
format (`fmt="fb"`, which needs the `flatbuffers` package) and the
`remote://` engine raise `NotPorted`; so do the server's /export,
/import and /kv/topology routes.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import os
import socket
import struct
import threading
from typing import Any, Callable, Optional
from urllib.parse import urlparse

from surrealdb_tpu_torch.err import NotPorted, SdbError

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _live_key(lid) -> str:
    """Uuid-or-str live id -> the canonical uuid string the server keys
    notifications by (val.Uuid's str() is its repr, not the uuid)."""
    u = getattr(lid, "u", None)
    return str(u) if u is not None else str(lid)


class RpcRemoteError(SdbError):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


class LocalEngine:
    """Embedded engine (reference engine/local): the datastore lives in
    this process; method calls dispatch straight through RpcSession."""

    def __init__(self, path: str):
        from surrealdb_tpu_torch.kvs.ds import Datastore
        from surrealdb_tpu_torch.rpc import RpcSession

        self.ds = Datastore(path)
        # the embedding process owns the datastore: root session
        self.rs = RpcSession(self.ds, anon_level="owner")
        self._live_cbs: dict = {}
        # embedded delivery: callbacks run on the fan-out hub's dispatch
        # workers (post-commit), NOT on the writing thread — a slow
        # callback delays notifications, never commits. Exceptions are
        # counted (notify_handler_errors), not swallowed silently.
        self.ds.notification_handlers.append(self._on_notify)

    def _on_notify(self, n):
        cb = self._live_cbs.get(_live_key(n.live_id))
        if cb is not None:
            cb({
                "id": n.live_id,
                "action": n.action,
                "record": n.record,
                "result": n.result,
            })

    def call(self, method: str, params: list) -> Any:
        from surrealdb_tpu_torch.rpc import RpcError

        try:
            return self.rs.handle(method, params)
        except RpcError as e:
            raise RpcRemoteError(e.code, str(e))

    def register_live(self, live_id: str, cb) -> None:
        self._live_cbs[str(live_id)] = cb

    def unregister_live(self, live_id: str) -> None:
        self._live_cbs.pop(str(live_id), None)

    def close(self):
        try:
            self.ds.notification_handlers.remove(self._on_notify)
        except ValueError:
            pass
        self.ds.close()


class WsEngine:
    """WebSocket engine (reference engine/remote/ws): one socket, a reader
    thread that demultiplexes responses by request id and forwards live
    notifications (frames without an id) to registered callbacks."""

    def __init__(self, host: str, port: int, fmt: str = "cbor",
                 timeout: float = 30.0):
        self.fmt = fmt
        self.timeout = timeout
        self._ids = itertools.count(1)
        self._pending: dict = {}  # id -> [event, response]
        self._live_cbs: dict = {}
        self._lock = threading.Lock()  # send side
        self._plock = threading.Lock()  # pending/live maps
        self._closed = False
        if fmt == "cbor":
            from surrealdb_tpu_torch import wire

            self._pack = wire.encode
            self._unpack = wire.decode
        elif fmt in ("fb", "flatbuffers"):
            raise NotPorted("the flatbuffers format is not ported")
        else:
            self._pack = lambda v: json.dumps(v).encode()
            self._unpack = lambda b: json.loads(b.decode())
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._handshake(host, port)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- websocket plumbing -------------------------------------------------
    def _handshake(self, host, port):
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET /rpc HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
            f"Sec-WebSocket-Protocol: {self.fmt}\r\n\r\n"
        )
        self.sock.sendall(req.encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise SdbError("websocket handshake failed: connection closed")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        status = head.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise SdbError(f"websocket handshake refused: {status.decode()}")
        want = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        headtext = head.decode()
        if want not in headtext:
            raise SdbError("websocket handshake failed: bad accept key")
        # the server must echo the subprotocol; a silent mismatch would
        # make every call time out on undecodable frames
        echoed = None
        for line in headtext.split("\r\n")[1:]:
            k, _, v = line.partition(":")
            if k.strip().lower() == "sec-websocket-protocol":
                echoed = v.strip()
        if echoed != self.fmt:
            raise SdbError(
                f"server did not accept the '{self.fmt}' subprotocol "
                f"(got {echoed!r}); try connect(url, fmt='json')"
            )
        self._residual = rest

    def _send_frame(self, payload: bytes, opcode: int):
        # clients MUST mask (RFC 6455 §5.3)
        mask = os.urandom(4)
        n = len(payload)
        header = struct.pack("!B", 0x80 | opcode)
        if n < 126:
            header += struct.pack("!B", 0x80 | n)
        elif n < (1 << 16):
            header += struct.pack("!BH", 0x80 | 126, n)
        else:
            header += struct.pack("!BQ", 0x80 | 127, n)
        data = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        # lint: lock-held(this lock's only job is serializing frame writes on the client socket; no shared engine state is guarded by it)
        with self._lock:
            self.sock.sendall(header + mask + data)

    def _recv_exact(self, n: int) -> bytes:
        out = bytearray()
        if self._residual:
            take = self._residual[:n]
            self._residual = self._residual[len(take):]
            out += take
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("websocket closed")
            out += chunk
        return bytes(out)

    def _recv_frame(self):
        b1, b2 = self._recv_exact(2)
        opcode = b1 & 0x0F
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._recv_exact(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._recv_exact(8))[0]
        mask = self._recv_exact(4) if b2 & 0x80 else None
        data = self._recv_exact(n)
        if mask:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        return opcode, data

    def _read_loop(self):
        try:
            while not self._closed:
                opcode, data = self._recv_frame()
                if opcode == 0x8:
                    break
                if opcode == 0x9:  # ping -> pong
                    self._send_frame(data, 0xA)
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                try:
                    msg = self._unpack(data)
                    if not isinstance(msg, dict):
                        raise ValueError("response must be an object")
                except Exception:
                    # skip one garbled frame (truncated cbor raises
                    # IndexError) rather than killing the reader thread
                    continue
                rid = msg.get("id")
                if rid is None:  # live-query notification
                    note = msg.get("result") or {}
                    with self._plock:
                        cb = self._live_cbs.get(_live_key(note.get("id")))
                    if cb is not None:
                        try:
                            cb(note)
                        except Exception:
                            pass
                    continue
                with self._plock:
                    slot = self._pending.get(rid)
                if slot is not None:
                    slot[1] = msg
                    slot[0].set()
        except (ConnectionError, OSError):
            pass
        finally:
            # fail all waiters so callers see a clean error, not a timeout
            with self._plock:
                for slot in self._pending.values():
                    if slot[1] is None:
                        slot[1] = {"error": {
                            "code": -32000, "message": "connection closed"}}
                    slot[0].set()

    # -- rpc ----------------------------------------------------------------
    def call(self, method: str, params: list) -> Any:
        rid = next(self._ids)
        slot = [threading.Event(), None]
        with self._plock:
            self._pending[rid] = slot
        try:
            self._send_frame(
                self._pack({"id": rid, "method": method, "params": params}),
                0x2 if self.fmt == "cbor" else 0x1,
            )
            if not slot[0].wait(self.timeout):
                raise SdbError(f"rpc timeout: {method}")
        finally:
            with self._plock:
                self._pending.pop(rid, None)
        msg = slot[1]
        err = msg.get("error")
        if err:
            raise RpcRemoteError(
                int(err.get("code", -32000)), err.get("message", "error")
            )
        return msg.get("result")

    def register_live(self, live_id: str, cb) -> None:
        with self._plock:
            self._live_cbs[str(live_id)] = cb

    def unregister_live(self, live_id: str) -> None:
        with self._plock:
            self._live_cbs.pop(str(live_id), None)

    def close(self):
        self._closed = True
        try:
            self._send_frame(b"", 0x8)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class HttpEngine:
    """One-shot HTTP /rpc engine (reference engine/remote/http). Stateless
    on the server side, so session state (use/signin) is replayed into
    every request via headers. No live queries (the reference's HTTP
    engine doesn't support them either)."""

    def __init__(self, host: str, port: int, fmt: str = "json",
                 timeout: float = 30.0):
        self.base = f"http://{host}:{port}"
        self.fmt = fmt
        self.timeout = timeout
        self.ns = self.db = None
        self.token: Optional[str] = None
        self._vars: dict = {}

    def call(self, method: str, params: list) -> Any:
        import urllib.request

        # session-state methods are client-side under a stateless engine
        if method == "use":
            self.ns = params[0] if len(params) > 0 else self.ns
            self.db = params[1] if len(params) > 1 else self.db
            return None
        if method == "let":
            self._vars[params[0]] = params[1]
            return None
        if method == "unset":
            self._vars.pop(params[0], None)
            return None
        if method == "authenticate":
            self.token = params[0]
            return None
        if method == "invalidate":
            self.token = None
            return None
        if method == "query" and self._vars:
            vars_in = params[1] if len(params) > 1 else {}
            params = [params[0], {**self._vars, **(vars_in or {})}]
        if self.fmt == "cbor":
            from surrealdb_tpu_torch import wire

            body = wire.encode({"method": method, "params": params})
            ctype = "application/cbor"
        else:
            body = json.dumps({"method": method, "params": params}).encode()
            ctype = "application/json"
        hdrs = {"Content-Type": ctype, "Accept": ctype}
        if self.ns:
            hdrs["surreal-ns"] = self.ns
        if self.db:
            hdrs["surreal-db"] = self.db
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base + "/rpc", data=body, headers=hdrs, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
        except urllib.error.HTTPError as e:
            raw = e.read()
            if e.code == 401:
                # a refused credential: the route's JSON body, in any
                # format, not an RPC envelope
                try:
                    why = json.loads(raw).get("error")
                except ValueError:
                    why = None
                raise RpcRemoteError(
                    -32000, why or "There was a problem with authentication")
        except urllib.error.URLError as e:
            raise SdbError(f"rpc connection failed: {e.reason}")
        if self.fmt == "cbor":
            from surrealdb_tpu_torch import wire

            msg = wire.decode(raw)
        else:
            msg = json.loads(raw.decode())
        err = msg.get("error")
        if err:
            raise RpcRemoteError(
                int(err.get("code", -32000)), err.get("message", "error")
            )
        out = msg.get("result")
        if method in ("signin", "signup") and isinstance(out, str):
            self.token = out
        return out

    def register_live(self, live_id, cb):
        raise SdbError("live queries are not supported over the HTTP engine")

    def unregister_live(self, live_id):
        pass

    def close(self):
        pass


# ---------------------------------------------------------------------------
# the fluent client
# ---------------------------------------------------------------------------


class Surreal:
    """Method API (reference surrealdb/src/method/). Every call maps 1:1
    onto an RPC method so local and remote engines behave identically."""

    def __init__(self, engine):
        self.engine = engine

    # -- session ------------------------------------------------------------
    def use(self, ns: Optional[str] = None, db: Optional[str] = None):
        self.engine.call("use", [ns, db])
        return self

    def signin(self, user: Optional[str] = None, passwd: Optional[str] = None,
               **creds) -> Optional[str]:
        if user is not None:
            creds.setdefault("user", user)
        if passwd is not None:
            creds.setdefault("pass", passwd)
        return self.engine.call("signin", [creds])

    def signup(self, **creds) -> Optional[str]:
        return self.engine.call("signup", [creds])

    def authenticate(self, token: str):
        return self.engine.call("authenticate", [token])

    def invalidate(self):
        return self.engine.call("invalidate", [])

    def let(self, name: str, value: Any):
        self.engine.call("let", [name, value])
        return self

    def unset(self, name: str):
        self.engine.call("unset", [name])
        return self

    def info(self):
        return self.engine.call("info", [])

    def version(self) -> str:
        return self.engine.call("version", [])

    def ping(self):
        return self.engine.call("ping", [])

    # -- data ---------------------------------------------------------------
    def query(self, sql: str, vars: Optional[dict] = None):
        """Run SurrealQL; returns the per-statement results list. Raises on
        a single-statement error (multi-statement results are returned
        as-is, mirroring the reference's Response::check semantics)."""
        out = self.engine.call("query", [sql, vars or {}])
        if isinstance(out, list) and len(out) == 1:
            one = out[0]
            if isinstance(one, dict) and one.get("status") == "ERR":
                raise SdbError(str(one.get("result")))
        return out

    def select(self, what):
        return self.engine.call("select", [what])

    def create(self, what, data: Any = None):
        return self.engine.call(
            "create", [what] if data is None else [what, data]
        )

    def insert(self, what, data: Any):
        return self.engine.call("insert", [what, data])

    def insert_relation(self, table, data: Any):
        return self.engine.call("insert_relation", [table, data])

    def update(self, what, data: Any = None):
        return self.engine.call(
            "update", [what] if data is None else [what, data]
        )

    def upsert(self, what, data: Any = None):
        return self.engine.call(
            "upsert", [what] if data is None else [what, data]
        )

    def merge(self, what, data: Any):
        return self.engine.call("merge", [what, data])

    def patch(self, what, patches: list):
        return self.engine.call("patch", [what, patches])

    def delete(self, what):
        return self.engine.call("delete", [what])

    def relate(self, frm, edge, to, data: Any = None):
        params = [frm, edge, to]
        if data is not None:
            params.append(data)
        return self.engine.call("relate", [*params])

    def run(self, fn_name: str, *args):
        return self.engine.call("run", [fn_name, None, list(args)])

    def graphql(self, query: str, variables: Optional[dict] = None):
        return self.engine.call("graphql", [query, variables or {}])

    # -- live queries -------------------------------------------------------
    def live(self, table: str, callback: Callable[[dict], None],
             diff: bool = False) -> str:
        """Start LIVE SELECT on `table`; `callback(notification)` fires on
        every matching mutation until `kill(live_id)`.

        Delivery contract (server/fanout.py): notifications arrive in
        commit order, exactly once — delivered asynchronously from a
        bounded per-session queue, so a slow callback/socket never
        stalls the writers producing the mutations. Two typed actions
        beyond CREATE/UPDATE/DELETE can arrive:

        - ``OVERFLOW``: this session fell behind and the server dropped
          its queued backlog (``result`` carries ``{"dropped": n}``);
          re-read the table to resynchronize. Under the server's
          ``disconnect`` overflow policy the connection is closed
          instead and no OVERFLOW is sent.
        - ``ERROR``: the subscription's WHERE/projection raised during
          matching; the server killed it (``result`` is the message).
        """
        live_id = _live_key(self.engine.call("live", [table, diff]))
        self.engine.register_live(live_id, callback)
        return live_id

    def kill(self, live_id: str):
        live_id = _live_key(live_id)
        self.engine.unregister_live(live_id)
        return self.engine.call("kill", [live_id])

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def connect(url: str = "mem://", fmt: str = "cbor",
            timeout: float = 30.0) -> Surreal:
    """engine/any: pick the engine from the URL scheme.

    mem:// | memory        embedded, in-memory
    file://p | skv://p     embedded, persistent
    ws://host:port         WebSocket RPC (cbor by default)
    http://host:port       one-shot HTTP RPC
    """
    if fmt in ("fb", "flatbuffers"):
        raise NotPorted("the flatbuffers format is not ported")
    u = urlparse(url if "://" in url else f"mem://{url}")
    scheme = u.scheme or "mem"
    if scheme in ("mem", "memory"):
        return Surreal(LocalEngine("memory"))
    if scheme == "remote":
        raise NotPorted("the remote:// engine is not ported")
    if scheme in ("file", "skv"):
        return Surreal(LocalEngine(url))
    if scheme == "ws":
        return Surreal(
            WsEngine(u.hostname or "127.0.0.1", u.port or 8000, fmt=fmt,
                     timeout=timeout)
        )
    if scheme == "http":
        return Surreal(
            HttpEngine(u.hostname or "127.0.0.1", u.port or 8000,
                       fmt="json" if fmt == "json" else "cbor",
                       timeout=timeout)
        )
    raise SdbError(f"unsupported connection scheme: {scheme}://")
