"""DEFINE API invocation engine (the reference package's `api.py`).

Reference: core/src/api/mod.rs:1-11 (middleware chain, body handling,
response shaping), core/src/expr/statements/define/api.rs (definition
surface), core/src/api/path.rs (path grammar: static segments, `:param`
dynamic segments with optional `<type>` coercion, `*rest` catch-alls,
`\\:`/`\\*` escapes), core/src/api/middleware (api::timeout,
api::req::body, api::res::{body,status,header,headers} built-ins plus
user `fn::` middleware with the ($req, $next, ...args) calling
convention), core/src/api/invocation.rs (permission evaluation order:
method -> route -> global config).

The chain runs entirely inside the executor — api::invoke() is an
ordinary function call, and the HTTP /api/:ns/:db/* route drives the
same code path. A handler's `<|k|>` query reaches the card as any
top-level query does; where the card fails it in mode `require`, that
error is the invoking query's (the reference package answers a 500).
The flatbuffers body strategy is not ported: it
raises `NotPorted` naming itself.
"""

from __future__ import annotations

import json as _json
import re
import time as _time

from surrealdb_tpu_torch.err import NotPorted, ReturnException, SdbError
from surrealdb_tpu_torch.val import NONE, Closure

__all__ = ["invoke", "validate_define_path"]


class _ApiError(Exception):
    """A shaped API failure: becomes {status, body: message} directly."""

    def __init__(self, status: int, body):
        super().__init__(str(body))
        self.status = status
        self.body = body


# ---------------------------------------------------------------------------
# Path grammar
# ---------------------------------------------------------------------------

_HEADER_NAME_RE = re.compile(r"^[!#$%&'*+\-.^_`|~0-9A-Za-z]+$")


def validate_define_path(path: str) -> None:
    """DEFINE-time validation with the reference's exact error strings."""
    if path == "":
        raise SdbError(
            "The string could not be parsed into a path: Path cannot be empty"
        )
    if not path.startswith("/"):
        raise SdbError(
            "The string could not be parsed into a path: "
            "Segment should start with /"
        )


def _parse_segments(path: str) -> list:
    """-> [("static", text) | ("param", name, type|None) | ("rest", name)].

    Escapes: `\\:` and `\\*` make the next char literal. A `*name`
    segment must be last and captures one-or-more remaining segments.
    """
    segs = []
    for raw in path.split("/"):
        if raw == "":
            continue
        if raw.startswith("\\:") or raw.startswith("\\*"):
            segs.append(("static", raw[1:]))
        elif raw.startswith(":"):
            name = raw[1:]
            typ = None
            m = re.match(r"^([^<]*)<([^>]*)>$", name)
            if m:
                name, typ = m.group(1), m.group(2)
            segs.append(("param", name, typ))
        elif raw.startswith("*"):
            segs.append(("rest", raw[1:]))
        else:
            segs.append(("static", raw.replace("\\:", ":").replace(
                "\\*", "*")))
    return segs


def _coerce_segment(value: str, typ):
    """Typed dynamic segment (`:id<number>`): coerce or fail the match."""
    if typ in (None, "", "string"):
        return value
    if typ in ("number", "int", "float", "decimal"):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            raise ValueError(value)
    if typ == "bool":
        if value in ("true", "false"):
            return value == "true"
        raise ValueError(value)
    if typ == "uuid":
        from surrealdb_tpu_torch.val import Uuid

        return Uuid(value)
    return value


def _match_segments(defsegs: list, reqsegs: list):
    """-> (params dict, specificity tuple) or None.

    Specificity per segment: static=0 < param=1 < rest=2; tuples compare
    lexicographically so `/users/specific` beats `/users/:id` beats
    `/users/*rest`, and a longer static prefix beats an early catch-all.
    """
    params = {}
    spec = []
    i = 0
    for seg in defsegs:
        kind = seg[0]
        if kind == "rest":
            if i >= len(reqsegs):
                return None  # rest requires at least one segment
            params[seg[1]] = list(reqsegs[i:])
            spec.append(2)
            i = len(reqsegs)
            return params, tuple(spec)
        if i >= len(reqsegs):
            return None
        if kind == "static":
            if seg[1] != reqsegs[i]:
                return None
            spec.append(0)
        else:  # param
            try:
                params[seg[1]] = _coerce_segment(reqsegs[i], seg[2])
            except (ValueError, SdbError):
                return None
            spec.append(1)
        i += 1
    if i != len(reqsegs):
        return None
    return params, tuple(spec)


# ---------------------------------------------------------------------------
# Body strategies
# ---------------------------------------------------------------------------

_STRATEGY_CTYPE = {
    "json": "application/json",
    "cbor": "application/cbor",
    "flatbuffers": "application/vnd.surrealdb.flatbuffers",
    "plain": "text/plain",
    "bytes": "application/octet-stream",
    "native": "application/vnd.surrealdb.native",
}
_CTYPE_STRATEGY = {v: k for k, v in _STRATEGY_CTYPE.items()}


def _decode_body(strategy: str, body):
    if strategy == "native":
        return body
    if not isinstance(body, (bytes, bytearray)):
        raise _ApiError(400, "Request body must be binary data")
    data = bytes(body)
    try:
        if strategy == "json":
            return _from_json(_json.loads(data.decode()))
        if strategy == "cbor":
            from surrealdb_tpu_torch.wire import decode as _cbor_dec

            return _cbor_dec(data)
        if strategy == "flatbuffers":
            raise NotPorted("the flatbuffers format is not ported")
        if strategy == "plain":
            return data.decode()
        if strategy == "bytes":
            return data
    except (_ApiError, NotPorted):
        raise
    except Exception:
        raise _ApiError(400, "Failed to decode the request body")
    raise _ApiError(400, "Failed to decode the request body")


def _from_json(v):
    if isinstance(v, dict):
        return {k: _from_json(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_json(x) for x in v]
    if v is None:
        # a JSON null fails the decode (400), as in the reference package,
        # whose `val` has no NULL for its import here
        raise ValueError("null in a JSON body")
    return v


def _apply_req_body(strategy, req):
    headers = req.get("headers") or {}
    ctype = _header_get(headers, "content-type")
    if strategy == "auto":
        if ctype is None:
            return req  # no Content-Type: pass the body through untouched
        target = _CTYPE_STRATEGY.get(str(ctype).split(";")[0].strip())
        if target is None:
            raise _ApiError(415, f"Unsupported Content-Type: {ctype}")
    else:
        target = strategy
        if target != "native":
            expected = _STRATEGY_CTYPE.get(target)
            if expected is None:
                raise _ApiError(400, "Failed to decode the request body")
            if ctype is None or str(ctype).split(";")[0].strip() != expected:
                raise _ApiError(
                    400, f"Expected Content-Type to be {expected}"
                )
    return {**req, "body": _decode_body(target, req.get("body", NONE))}


def _parse_accept(value: str) -> list:
    """-> [(media_type, q)] in preference order (q desc, listed order)."""
    items = []
    for idx, part in enumerate(str(value).split(",")):
        bits = part.strip().split(";")
        mt = bits[0].strip().lower()
        if not mt:
            continue
        q = 1.0
        for p in bits[1:]:
            p = p.strip()
            if p.startswith("q="):
                try:
                    q = float(p[2:])
                except ValueError:
                    q = 1.0
        items.append((mt, q, idx))
    items.sort(key=lambda t: (-t[1], t[2]))
    return [(mt, q) for mt, q, _ in items]


def _negotiate(strategy, req):
    """-> output strategy honouring the Accept header, or 406."""
    accept = _header_get(req.get("headers") or {}, "accept")
    if strategy != "auto":
        ctype = _STRATEGY_CTYPE[strategy]
        if accept is None:
            return strategy
        for mt, _q in _parse_accept(accept):
            if mt in ("*/*", ctype) or (
                mt.endswith("/*") and ctype.startswith(mt[:-1])
            ):
                return strategy
        raise _ApiError(
            406, "No output strategy was possible for this API request"
        )
    if accept is None:
        return "json"
    for mt, _q in _parse_accept(accept):
        if mt == "*/*":
            return "json"
        s = _CTYPE_STRATEGY.get(mt)
        if s is not None:
            return s
        if mt.endswith("/*"):
            for ct, st in _CTYPE_STRATEGY.items():
                if ct.startswith(mt[:-1]):
                    return st
    raise _ApiError(
        406, "No output strategy was possible for this API request"
    )


def _serialize_body(strategy, body) -> bytes:
    from surrealdb_tpu_torch.val import render, to_json

    if strategy == "json":
        return _json.dumps(to_json(body)).encode()
    if strategy == "cbor":
        from surrealdb_tpu_torch.wire import encode as _cbor_enc

        return _cbor_enc(body)
    if strategy == "flatbuffers":
        raise NotPorted("the flatbuffers format is not ported")
    if strategy == "plain":
        return (body if isinstance(body, str) else render(body)).encode()
    if strategy == "bytes":
        if isinstance(body, (bytes, bytearray)):
            return bytes(body)
        return (body if isinstance(body, str) else render(body)).encode()
    return _json.dumps(to_json(body)).encode()


def _apply_res_body(strategy, res, req):
    if res.get("raw"):
        return res
    if strategy != "auto" and strategy not in _STRATEGY_CTYPE:
        raise SdbError(f"Unknown response body strategy '{strategy}'")
    out = _negotiate(strategy, req)
    headers = dict(res.get("headers") or {})
    headers["content-type"] = _STRATEGY_CTYPE[out]
    if out == "native":
        # native responses carry the value through unserialized
        return {**res, "headers": headers}
    body = _serialize_body(out, res.get("body", NONE))
    return {**res, "body": body, "headers": headers}


# ---------------------------------------------------------------------------
# Response validation / shaping
# ---------------------------------------------------------------------------


def _validate_status(status):
    # the http crate accepts 100..=999; the message cites the RFC range
    ok = isinstance(status, (int, float)) and not isinstance(status, bool) \
        and float(status).is_integer() and 100 <= int(status) <= 999
    if not ok:
        shown = int(status) if isinstance(status, float) and float(
            status).is_integer() else status
        from surrealdb_tpu_torch.val import render

        shown = shown if isinstance(shown, (int, float)) else render(shown)
        raise _ApiError(
            400,
            f"Invalid HTTP status code: {shown}. Must be between 100 and 599",
        )
    return int(status)


def _validate_header(name, value) -> tuple:
    lname = str(name).lower()
    if not _HEADER_NAME_RE.match(lname):
        raise _ApiError(
            400,
            f"Invalid header name: {name}: invalid HTTP header name",
        )
    sval = value if isinstance(value, str) else None
    if sval is None:
        from surrealdb_tpu_torch.val import render

        sval = render(value)
    if "\r" in sval or "\n" in sval:
        raise _ApiError(
            400,
            f"Invalid header value for {lname}: {sval}: "
            "failed to parse header value",
        )
    return lname, sval


def _normalize_response(out):
    """Handler / custom-middleware output -> response object."""
    if isinstance(out, dict) and ("status" in out or "body" in out
                                  or "headers" in out or "raw" in out
                                  or "context" in out):
        res = dict(out)
        res.setdefault("status", 200)
        res.setdefault("headers", {})
        res.setdefault("body", NONE)
        res.setdefault("context", {})
        return res
    return {"status": 200, "headers": {}, "body": out, "context": {}}


def _finalize(res) -> dict:
    status = _validate_status(res.get("status", 200))
    headers = {}
    for k, v in dict(res.get("headers") or {}).items():
        if v is NONE or v is None:
            continue
        lk, lv = _validate_header(k, v)
        headers[lk] = lv
    return {"status": status, "headers": headers,
            "body": res.get("body", NONE)}


# ---------------------------------------------------------------------------
# Middleware chain
# ---------------------------------------------------------------------------


class _HostNext(Closure):
    """The $next value handed to custom middleware — a host-implemented
    closure that resumes the chain when called as $next($req)."""

    __slots__ = ("py",)

    def __init__(self, py):
        super().__init__([("req", None)], None)
        self.py = py

    def render(self) -> str:
        return "|$req| <api middleware chain>"


def _header_get(headers: dict, name: str):
    for k, v in (headers or {}).items():
        if str(k).lower() == name:
            return v
    return None


def _permission_allows(perm, ctx) -> bool:
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.val import is_truthy

    if perm is True:
        return True
    if perm is False:
        return False
    c = ctx.child()
    c.vars["auth"] = getattr(ctx.session, "rid", None) or NONE
    try:
        return is_truthy(evaluate(perm, c))
    except SdbError:
        return False


def invoke(ctx, path: str, opts: dict):
    """api::invoke(path, opts) — route, authorize, run the chain."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import ApiDef, ConfigDef
    from surrealdb_tpu_torch.exec.eval import evaluate

    ns, db = ctx.need_ns_db()
    opts = opts if isinstance(opts, dict) else {}
    reqsegs = [s for s in str(path).split("/") if s != ""]

    best = None  # (spec, ApiDef, params)
    for _k, cand in ctx.txn.scan_vals(
        *K.prefix_range(K.api_prefix(ns, db))
    ):
        if not isinstance(cand, ApiDef):
            continue
        m = _match_segments(_parse_segments(cand.path), reqsegs)
        if m is None:
            continue
        params, spec = m
        if best is None or spec < best[0]:
            best = (spec, cand, params)
    if best is None:
        return {"status": 404, "body": "Not found", "headers": {}}
    _spec, d, path_params = best

    method = str(opts.get("method", "get")).lower()
    method_action = None
    any_action = None
    for a in d.actions:
        if method in a.methods and method_action is None:
            method_action = a
        if "any" in a.methods and any_action is None:
            any_action = a
    action = method_action or any_action
    if action is None or action.then is None:
        return {"status": 404, "body": "Not found", "headers": {}}

    cfg = ctx.txn.get_val(K.cfg_def(ns, db, "API"))
    cfg = cfg if isinstance(cfg, ConfigDef) else None

    # permissions: method -> route -> global, all must allow; system
    # sessions (owner/editor/viewer) bypass like the reference — both
    # record users AND anonymous sessions are gated
    if getattr(ctx.session, "auth_level", "owner") in ("record", "none"):
        levels = [action.permissions]
        if any_action is not None and any_action is not action:
            levels.append(any_action.permissions)
        if cfg is not None:
            levels.append(cfg.permissions)
        for perm in levels:
            if not _permission_allows(perm, ctx):
                return {
                    "status": 403,
                    "body": "Permission denied: You are not allowed to "
                            "access this resource",
                    "headers": {},
                }

    # middleware chain: DB config -> FOR any -> FOR method
    mws = []
    if cfg is not None:
        mws.extend(cfg.middleware or [])
    if any_action is not None and any_action is not action:
        mws.extend(any_action.middleware or [])
    mws.extend(action.middleware or [])

    req = {
        "method": method,
        "path": str(path),
        "params": {**path_params, **(opts.get("params") or {})},
        "query": opts.get("query") if isinstance(opts.get("query"), dict)
        else {},
        "headers": opts.get("headers") if isinstance(
            opts.get("headers"), dict) else {},
        "body": opts.get("body", NONE),
        "context": opts.get("context") if isinstance(
            opts.get("context"), dict) else {},
    }

    def run_handler(req_obj, ectx):
        c = ectx.child()
        c.vars["request"] = req_obj
        try:
            out = evaluate(action.then, c)
        except ReturnException as r:
            out = r.value
        return _normalize_response(out)

    def run(i, req_obj, ectx):
        if i == len(mws):
            return run_handler(req_obj, ectx)
        name, argexprs = mws[i]
        args = [evaluate(a, ectx) for a in argexprs]
        if name in ("api::timeout", "timeout"):
            from surrealdb_tpu_torch.val import Duration

            inner = ectx.child()
            if args and isinstance(args[0], Duration):
                inner.deadline = _time.monotonic() + args[0].ns / 1e9
                inner.timeout_dur = args[0]
            res = run(i + 1, req_obj, inner)
            if inner.deadline is not None and \
                    _time.monotonic() > inner.deadline:
                raise _ApiError(500, "deadline has elapsed")
            return res
        if name == "api::req::body":
            strategy = str(args[0]).lower() if args else "auto"
            return run(i + 1, _apply_req_body(strategy, req_obj), ectx)
        if name == "api::req::max_body":
            from surrealdb_tpu_torch.val import Duration as _D  # noqa: F401

            limit = args[0] if args else None
            body = req_obj.get("body")
            nbytes = None
            if isinstance(body, (bytes, bytearray)):
                nbytes = len(body)
            if limit is not None and nbytes is not None:
                try:
                    lim = int(limit)
                except (TypeError, ValueError):
                    lim = None
                if lim is not None and nbytes > lim:
                    raise _ApiError(413, "Request body too large")
            return run(i + 1, req_obj, ectx)
        if name == "api::res::status":
            res = run(i + 1, req_obj, ectx)
            return {**res, "status": _validate_status(
                args[0] if args else 200)}
        if name == "api::res::header":
            res = run(i + 1, req_obj, ectx)
            if len(args) >= 2:
                lk, lv = _validate_header(args[0], args[1])
                headers = dict(res.get("headers") or {})
                headers[lk] = lv
                res = {**res, "headers": headers}
            return res
        if name == "api::res::headers":
            res = run(i + 1, req_obj, ectx)
            if args and isinstance(args[0], dict):
                headers = dict(res.get("headers") or {})
                for k, v in args[0].items():
                    if v is NONE or v is None:
                        headers.pop(str(k).lower(), None)
                    else:
                        lk, lv = _validate_header(k, v)
                        headers[lk] = lv
                res = {**res, "headers": headers}
            return res
        if name == "api::res::body":
            strategy = str(args[0]).lower() if args else "auto"
            res = run(i + 1, req_obj, ectx)
            return _apply_res_body(strategy, res, req_obj)
        if name.startswith("fn::"):
            from surrealdb_tpu_torch.fnc import call_custom

            nxt = _HostNext(
                lambda a, c, _i=i: _normalize_response(
                    run(_i + 1, a[0] if a else req_obj, ectx)
                )
            )
            out = call_custom(name[4:], [req_obj, nxt] + args, ectx)
            return _normalize_response(out)
        raise SdbError(f"Unknown API middleware '{name}'")

    from surrealdb_tpu_torch.device.supervisor import DeviceRequired

    try:
        res = run(0, req, ctx)
        return _finalize(res)
    except _ApiError as e:
        return {"status": e.status, "body": e.body, "headers": {}}
    except (NotPorted, DeviceRequired):
        # a left-out path, or the card failing a handler's query in mode
        # require, is the query's error, never a 500 without a body
        raise
    except SdbError as e:
        msg = str(e)
        if "exceeded the timeout" in msg:
            return {"status": 500, "body": msg, "headers": {}}
        return {"status": 500, "body": NONE, "headers": {}}
