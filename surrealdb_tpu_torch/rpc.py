"""Protocol-neutral RPC method dispatch (the reference package's
`rpc.py`; reference: core/src/rpc/ — the `Method` enum, request parsing,
responses). Shared by the WebSocket session actor and the HTTP one-shot
/rpc route.

`signin`, `signup` and `authenticate` go through `iam.py`: they change
the connection's session (its auth level, base, record id and token)
for every later method. `graphql` runs a GraphQL query through
`gql.py`."""

from __future__ import annotations

from typing import Any, Optional

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.kvs.ds import Datastore, Session
from surrealdb_tpu_torch.val import NONE, RecordId, Table, to_json


class RpcError(SdbError):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class RpcSession:
    """One client connection's state (reference server/src/rpc/websocket.rs
    session handling)."""

    def __init__(self, ds: Datastore, anon_level: str = "none"):
        self.ds = ds
        # Network sessions start unauthenticated ("none") unless the server
        # was explicitly started in unauthenticated dev mode.
        self.session = Session(auth_level=anon_level)
        self.session.guests_refused = anon_level == "none"
        self.live_ids: set = set()
        # absolute monotonic deadline for the CURRENT request (the rpc
        # `timeout` field / X-Surreal-Timeout header); every ds.execute
        # issued while dispatching it inherits the budget
        self.deadline: Optional[float] = None

    # -- dispatch -----------------------------------------------------------
    def handle(self, method: str, params: list,
               deadline: Optional[float] = None) -> Any:
        caps = getattr(self.ds, "capabilities", None)
        if caps is not None and not caps.allows_rpc(method):
            raise RpcError(-32000, f"Method not allowed: {method}")
        m = getattr(self, f"rpc_{method.replace('::', '_')}", None)
        if m is None:
            raise RpcError(-32601, f"Method not found: {method}")
        self.deadline = deadline
        try:
            return m(params)
        finally:
            self.deadline = None

    def _query(self, sql, vars=None):
        return self.ds.execute(
            sql, session=self.session, vars=vars or {},
            deadline=self.deadline,
        )

    def _one(self, sql, vars=None):
        res = self._query(sql, vars)
        last = res[-1] if res else None
        if last is None:
            return NONE
        if last.error is not None:
            raise RpcError(-32000, last.error)
        return last.result

    # -- methods ------------------------------------------------------------
    def rpc_ping(self, params):
        return NONE

    def rpc_version(self, params):
        import surrealdb_tpu_torch

        return f"surrealdb-tpu-{surrealdb_tpu_torch.__version__}"

    def rpc_use(self, params):
        ns = params[0] if len(params) > 0 else None
        db = params[1] if len(params) > 1 else None
        if ns:
            self.session.ns = ns
        if db:
            self.session.db = db
        return NONE

    def rpc_info(self, params):
        return self._one("SELECT * FROM $auth")

    def rpc_let(self, params):
        if len(params) < 2:
            raise RpcError(-32602, "Invalid params")
        self.session.variables[params[0]] = params[1]
        return NONE

    rpc_set = rpc_let

    def rpc_unset(self, params):
        if not params:
            raise RpcError(-32602, "Invalid params")
        self.session.variables.pop(params[0], None)
        return NONE

    def rpc_query(self, params):
        if not params:
            raise RpcError(-32602, "Invalid params")
        sql = params[0]
        vars = params[1] if len(params) > 1 else {}
        res = self._query(sql, vars)
        out = []
        for r in res:
            row = {
                "status": "OK" if r.ok else "ERR",
                "result": r.result if r.ok else r.error,
                "time": f"{r.time_ns / 1e6:.3f}ms",
            }
            if getattr(r, "partial", None):
                # typed partial KNN answer (SURREAL_KNN_PARTIAL=
                # partial): an RPC client must never mistake a
                # shard-incomplete candidate set for a complete one
                row["partial"] = r.partial
            out.append(row)
        return out

    def rpc_select(self, params):
        what = _thing(params[0])
        return self._one("SELECT * FROM $what", {"what": what})

    def rpc_create(self, params):
        what = _thing(params[0])
        data = params[1] if len(params) > 1 else None
        if data is None:
            return self._one("CREATE $what", {"what": what})
        return self._one("CREATE $what CONTENT $data", {"what": what, "data": data})

    def rpc_insert(self, params):
        what = params[0]
        data = params[1] if len(params) > 1 else {}
        tb = what if isinstance(what, str) else None
        return self._one(
            f"INSERT INTO {tb} $data" if tb else "INSERT $data",
            {"data": data},
        )

    def rpc_insert_relation(self, params):
        what = params[0]
        data = params[1] if len(params) > 1 else {}
        return self._one(
            f"INSERT RELATION INTO {what} $data", {"data": data}
        )

    def rpc_update(self, params):
        what = _thing(params[0])
        data = params[1] if len(params) > 1 else None
        if data is None:
            return self._one("UPDATE $what", {"what": what})
        return self._one("UPDATE $what CONTENT $data", {"what": what, "data": data})

    def rpc_upsert(self, params):
        what = _thing(params[0])
        data = params[1] if len(params) > 1 else None
        if data is None:
            return self._one("UPSERT $what", {"what": what})
        return self._one("UPSERT $what CONTENT $data", {"what": what, "data": data})

    def rpc_merge(self, params):
        what = _thing(params[0])
        data = params[1] if len(params) > 1 else {}
        return self._one("UPDATE $what MERGE $data", {"what": what, "data": data})

    def rpc_patch(self, params):
        what = _thing(params[0])
        data = params[1] if len(params) > 1 else []
        return self._one("UPDATE $what PATCH $data", {"what": what, "data": data})

    def rpc_delete(self, params):
        what = _thing(params[0])
        return self._one("DELETE $what RETURN BEFORE", {"what": what})

    def rpc_relate(self, params):
        if len(params) < 3:
            raise RpcError(-32602, "Invalid params")
        fr, kind, to = (
            _thing(params[0]),
            params[1],
            _thing(params[2]),
        )
        data = params[3] if len(params) > 3 else None
        vars = {"from": fr, "to": to, "data": data}
        if data is None:
            return self._one(f"RELATE $from->{kind}->$to", vars)
        return self._one(f"RELATE $from->{kind}->$to CONTENT $data", vars)

    def rpc_run(self, params):
        if not params:
            raise RpcError(-32602, "Invalid params")
        name = params[0]
        args = params[2] if len(params) > 2 else []
        arglist = ", ".join(f"$__a{i}" for i in range(len(args)))
        vars = {f"__a{i}": a for i, a in enumerate(args)}
        return self._one(f"RETURN {name}({arglist})", vars)

    def rpc_live(self, params):
        if not params:
            raise RpcError(-32602, "Invalid params")
        what = params[0]
        diff = bool(params[1]) if len(params) > 1 else False
        expr = "DIFF" if diff else "*"
        lid = self._one(f"LIVE SELECT {expr} FROM {what}")
        key = str(lid.u)
        self.live_ids.add(key)
        # routing was bound by the LIVE statement itself (atomically
        # with registration, via session.live_outbox) — nothing to do
        # here beyond remembering the id for session-close GC
        return lid

    def rpc_kill(self, params):
        if not params:
            raise RpcError(-32602, "Invalid params")
        out = self._one("KILL $id", {"id": params[0]})
        # uuid-or-str param: the KILL statement itself already unbound
        # the fan-out route; here only the session-close GC set shrinks
        self.live_ids.discard(str(getattr(params[0], "u", params[0])))
        return out

    def rpc_signin(self, params):
        from surrealdb_tpu_torch.iam import signin

        if not params or not isinstance(params[0], dict):
            raise RpcError(-32602, "Invalid params")
        return signin(self.ds, self.session, params[0])

    def rpc_signup(self, params):
        from surrealdb_tpu_torch.iam import signup

        if not params or not isinstance(params[0], dict):
            raise RpcError(-32602, "Invalid params")
        return signup(self.ds, self.session, params[0])

    def rpc_authenticate(self, params):
        from surrealdb_tpu_torch.iam import authenticate

        if not params:
            raise RpcError(-32602, "Invalid params")
        return authenticate(self.ds, self.session, params[0])

    def rpc_invalidate(self, params):
        self.session.auth_level = "none"
        self.session.rid = None
        return NONE

    def rpc_graphql(self, params):
        from surrealdb_tpu_torch.gql import execute_graphql

        if not params:
            raise RpcError(-32602, "Invalid params")
        q = params[0]
        if isinstance(q, dict):
            query = q.get("query", "")
            variables = q.get("variables") or {}
        else:
            query = str(q)
            variables = {}
        return execute_graphql(self.ds, self.session, query, variables)


def _thing(v):
    """Convert an RPC `thing` param (string 'tb' or 'tb:id') to a value."""
    if isinstance(v, (RecordId, Table)):
        return v
    if isinstance(v, str):
        if ":" in v:
            from surrealdb_tpu_torch.exec.static_eval import static_value
            from surrealdb_tpu_torch.syn.parser import parse_record_literal

            try:
                return static_value(parse_record_literal(v))
            except Exception:
                return Table(v)
        return Table(v)
    return v


def json_result(value) -> Any:
    return to_json(value)
