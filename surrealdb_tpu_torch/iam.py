"""AuthN/Z (the reference package's `iam.py`; reference: core/src/iam/ —
root/ns/db users, DEFINE ACCESS record signup/signin, roles, token
issuance).

Tokens are HS256 JWTs signed with a per-datastore secret (stdlib hmac);
an access method with its own key signs and verifies with it (HS* or RS*
through `utils/rsa.py`, or a JWKS endpoint behind the network
capability). Record access runs the access method's SIGNIN/SIGNUP
clauses with the credentials bound as variables, and AUTHENTICATE on
every token it verifies. Passwords compare by their hash's route
(`fnc/misc_fns.py password_compare`: argon2id, pbkdf2, scrypt)."""

from __future__ import annotations

import base64
import hmac
import json
import secrets
import time
from hashlib import sha256

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc.misc_fns import password_compare
from surrealdb_tpu_torch.kvs.ds import Session
from surrealdb_tpu_torch.val import NONE, RecordId


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode().rstrip("=")


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _secret(ds) -> bytes:
    sec = getattr(ds, "_jwt_secret", None)
    if sec is None:
        sec = secrets.token_bytes(32)
        ds._jwt_secret = sec
    return sec


def _level_from_roles(roles) -> str:
    roles = {str(r).lower() for r in (roles or ())}
    if "owner" in roles:
        return "owner"
    if "editor" in roles:
        return "editor"
    return "viewer"


_HS_HASHES = {"HS256": "sha256", "HS384": "sha384", "HS512": "sha512"}
_RS_HASHES = {"RS256": "sha256", "RS384": "sha384", "RS512": "sha512"}


def issue_token(ds, claims: dict, ttl_s: int = 3600, cfg: dict | None = None,
                session: Session | None = None) -> str:
    """Issue a JWT. With an access config carrying an issuer key (WITH JWT
    ... [WITH ISSUER KEY]), sign with that key and the configured algorithm
    so the access method can verify its own tokens (reference
    core/src/iam/issue.rs); otherwise HS256 with the datastore secret."""
    import hashlib

    alg, key_bytes, rsa_nd = "HS256", _secret(ds), None
    if cfg and (cfg.get("alg") or cfg.get("key") or cfg.get("issuer_key")
                or cfg.get("issuer_alg")):
        # WITH ISSUER ALGORITHM pins the signing algorithm; otherwise the
        # verification algorithm doubles as the issuing one
        calg = (cfg.get("issuer_alg") or cfg.get("alg") or "HS512").upper()
        ikey = cfg.get("issuer_key")
        if calg in _HS_HASHES:
            k = ikey if ikey is not None else cfg.get("key")
            if k is not None:
                alg, key_bytes = calg, str(k).encode()
        elif calg in _RS_HASHES:
            if ikey is None:
                # silently downgrading to the datastore secret would issue
                # tokens third parties can never verify against the
                # configured public key — fail loudly at issue time
                raise SdbError(
                    "An issuer key is required for asymmetric algorithms"
                )
            from surrealdb_tpu_torch.utils.rsa import rsa_private_key_from_pem

            try:
                rsa_nd = rsa_private_key_from_pem(str(ikey))
                alg = calg
            except (ValueError, IndexError):
                raise SdbError("There was a problem with authentication")
    header = {"alg": alg, "typ": "JWT"}
    now = int(time.time())
    payload = {"iat": now, "exp": now + ttl_s, "iss": "SurrealDB", **claims}
    if session is not None:
        # the verified claims back the $token / $session.tk variables
        session.token = dict(payload)
    h = _b64(json.dumps(header).encode())
    p = _b64(json.dumps(payload).encode())
    signing = f"{h}.{p}".encode()
    if rsa_nd is not None:
        from surrealdb_tpu_torch.utils.rsa import sign_pkcs1_v15

        sig = sign_pkcs1_v15(rsa_nd[0], rsa_nd[1], signing, _RS_HASHES[alg])
    else:
        sig = hmac.new(
            key_bytes, signing, getattr(hashlib, _HS_HASHES[alg])
        ).digest()
    return f"{h}.{p}.{_b64(sig)}"


def verify_token(ds, token: str) -> dict:
    try:
        h, p, s = token.split(".")
    except ValueError:
        raise SdbError("There was a problem with authentication")
    want = hmac.new(_secret(ds), f"{h}.{p}".encode(), sha256).digest()
    if not hmac.compare_digest(want, _unb64(s)):
        raise SdbError("There was a problem with authentication")
    payload = json.loads(_unb64(p))
    if payload.get("exp", 0) < time.time():
        raise SdbError("The token has expired")
    return payload


def signin(ds, session: Session, creds: dict) -> str:
    ns = creds.get("NS") or creds.get("ns") or creds.get("namespace")
    db = creds.get("DB") or creds.get("db") or creds.get("database")
    ac = creds.get("AC") or creds.get("ac") or creds.get("access")
    user = creds.get("user") or creds.get("username")
    passwd = creds.get("pass") or creds.get("password")

    txn = ds.transaction(write=False)
    try:
        if ac and ns and db:
            return _record_access(ds, session, ns, db, ac, creds, "signin")
        if user is not None:
            # db, then ns, then root user
            for base, n, d in (
                ("db", ns, db) if db else (None, None, None),
                ("ns", ns, None) if ns else (None, None, None),
                ("root", None, None),
            ):
                if base is None:
                    continue
                ud = txn.get_val(K.us_def(base, n, d, user))
                if ud is not None and password_compare(ud.passhash, passwd or ""):
                    session.auth_level = _level_from_roles(ud.roles)
                    session.auth_base = base
                    if n:
                        session.ns = n
                    if d:
                        session.db = d
                    return issue_token(
                        ds,
                        {"ID": user, "base": base, "NS": n, "DB": d,
                         "roles": list(ud.roles)},
                        session=session,
                    )
            raise SdbError(
                "There was a problem with authentication"
            )
        raise SdbError("There was a problem with authentication")
    finally:
        txn.cancel()


def signup(ds, session: Session, creds: dict) -> str:
    ns = creds.get("NS") or creds.get("ns") or creds.get("namespace")
    db = creds.get("DB") or creds.get("db") or creds.get("database")
    ac = creds.get("AC") or creds.get("ac") or creds.get("access")
    if not (ac and ns and db):
        raise SdbError("There was a problem with authentication")
    return _record_access(ds, session, ns, db, ac, creds, "signup")


def _record_access(ds, session, ns, db, ac, creds, mode) -> str:
    txn = ds.transaction(write=False)
    try:
        acc = txn.get_val(K.ac_def("db", ns, db, ac))
    finally:
        txn.cancel()
    if acc is None or acc.kind != "record":
        raise SdbError("There was a problem with authentication")
    expr = acc.config.get(mode)
    if expr is None:
        raise SdbError("There was a problem with authentication")
    vars = {
        k: v
        for k, v in creds.items()
        if k not in ("NS", "DB", "AC", "ns", "db", "ac", "namespace",
                     "database", "access")
    }
    out = _eval_clause(ds, ns, db, expr, vars)
    if isinstance(out, list):
        out = out[0] if out else NONE
    if isinstance(out, dict):
        out = out.get("id", NONE)
    if not isinstance(out, RecordId):
        raise SdbError("There was a problem with authentication")
    session.ns = ns
    session.db = db
    session.ac = ac
    session.auth_level = "record"
    session.rid = out
    ttl = 3600
    dur = getattr(acc, "duration", None) or {}
    tok_d = dur.get("token") if isinstance(dur, dict) else None
    if tok_d is not None and hasattr(tok_d, "to_seconds"):
        ttl = int(tok_d.to_seconds())
    return issue_token(
        ds, {"ID": out.render(), "NS": ns, "DB": db, "AC": ac},
        ttl_s=ttl, cfg=acc.config, session=session,
    )


_JWKS_TTL_S = 43200  # reference iam/jwks.rs caches fetched sets for 12h


def _fetch_jwks(ds, url: str) -> list:
    """Fetch + cache a JWKS document (reference core/src/iam/jwks.rs:
    per-URL cache, capability-gated egress)."""
    import time as _time
    import urllib.request

    cache = getattr(ds, "_jwks_cache", None)
    if cache is None:
        cache = ds._jwks_cache = {}
    hit = cache.get(url)
    if hit is not None and hit[0] > _time.monotonic():
        return hit[1]
    caps = getattr(ds, "capabilities", None)
    if caps is not None:
        from urllib.parse import urlparse as _up

        host = _up(url).netloc
        if not caps.allows_net(host):
            raise SdbError(f"Access to network target '{host}' is not allowed")
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            doc = json.loads(r.read().decode())
    except Exception as e:
        raise SdbError(f"There was a problem fetching the JWKS: {e}")
    keys = doc.get("keys") or []
    cache[url] = (_time.monotonic() + _JWKS_TTL_S, keys)
    return keys


def _verify_with_access(ds, cfg: dict, token: str) -> dict:
    """Verify a third-party JWT against a DEFINE ACCESS JWT config:
    HS* via the configured symmetric key, RS* via a PEM key or a JWKS
    endpoint (key selected by kid)."""
    try:
        h, p, s = token.split(".")
        header = json.loads(_unb64(h))
    except (ValueError, UnicodeDecodeError):
        raise SdbError("There was a problem with authentication")
    # The algorithm is pinned from the access config — NEVER from the
    # attacker-controlled token header (RS->HS confusion: HMAC-signing
    # with the public PEM as the secret). Unset ALGORITHM defaults to
    # the reference's HS512; JWKS-backed access is asymmetric-only and
    # the header alg must still match the config/JWK.
    header_alg = (header.get("alg") or "").upper()
    cfg_alg = (cfg.get("alg") or "").upper()
    if cfg.get("url"):
        alg = cfg_alg or header_alg
        if not alg.startswith("RS") or (cfg_alg and header_alg != cfg_alg):
            raise SdbError("There was a problem with authentication")
    else:
        alg = cfg_alg or "HS512"
    if header_alg != alg:
        raise SdbError("There was a problem with authentication")
    signing = f"{h}.{p}".encode()
    sig = _unb64(s)
    ok = False
    if alg.startswith("HS"):
        import hashlib

        hname = _HS_HASHES.get(alg)
        key = (cfg.get("key") or "").encode()
        if hname and key:
            want = hmac.new(key, signing, getattr(hashlib, hname)).digest()
            ok = hmac.compare_digest(want, sig)
    elif alg.startswith("RS"):
        from surrealdb_tpu_torch.utils.rsa import (
            rsa_public_key_from_pem, verify_pkcs1_v15,
        )

        hname = _RS_HASHES.get(alg)
        pairs = []
        if cfg.get("url"):
            kid = header.get("kid")
            for jwk in _fetch_jwks(ds, cfg["url"]):
                if jwk.get("kty") != "RSA":
                    continue
                if kid is not None and jwk.get("kid") not in (None, kid):
                    continue
                if jwk.get("alg") and str(jwk["alg"]).upper() != alg:
                    continue
                pairs.append((
                    int.from_bytes(_unb64(jwk["n"]), "big"),
                    int.from_bytes(_unb64(jwk["e"]), "big"),
                ))
        elif cfg.get("key"):
            try:
                pairs.append(rsa_public_key_from_pem(cfg["key"]))
            except (ValueError, IndexError):
                pass
        ok = hname is not None and any(
            verify_pkcs1_v15(n, e, signing, sig, hname) for n, e in pairs
        )
    if not ok:
        raise SdbError("There was a problem with authentication")
    payload = json.loads(_unb64(p))
    # reference jsonwebtoken requires exp by default and honours nbf
    exp = payload.get("exp")
    if not isinstance(exp, (int, float)) or isinstance(exp, bool):
        raise SdbError("There was a problem with authentication")
    if exp < time.time():
        raise SdbError("The token has expired")
    nbf = payload.get("nbf")
    if isinstance(nbf, (int, float)) and not isinstance(nbf, bool) \
            and nbf > time.time():
        raise SdbError("There was a problem with authentication")
    return payload


def _eval_clause(ds, ns, db, expr, vars: dict):
    """Evaluate an access-method clause (SIGNIN/SIGNUP/AUTHENTICATE) in
    its own owner-level write transaction. Cancels on ANY failure so no
    transaction leaks, commits otherwise."""
    from surrealdb_tpu_torch.exec.context import Ctx
    from surrealdb_tpu_torch.exec.eval import evaluate

    from surrealdb_tpu_torch.err import ReturnException

    sess = Session(ns=ns, db=db, auth_level="owner")
    txn = ds.transaction(write=True)
    try:
        ctx = Ctx(ds, sess, txn)
        ctx.vars.update(vars)
        try:
            out = evaluate(expr, ctx)
        except ReturnException as r:
            out = r.value
    except BaseException:
        txn.cancel()
        raise
    txn.commit()
    return out


def _run_authenticate_clause(ds, ns, db, kind, cfg, payload, rid):
    """Evaluate the access method's AUTHENTICATE clause (reference
    core/src/iam/verify.rs): $token holds the verified claims; a thrown
    error rejects the token. For record access the clause result becomes
    the session rid and MUST be a record id — a gate clause that returns
    none for a blocked user fails closed. Returns the final rid."""
    expr = (cfg or {}).get("authenticate")
    if expr is None:
        return rid
    out = _eval_clause(ds, ns, db, expr,
                       {"token": dict(payload), "auth": rid or NONE})
    if kind == "record":
        # reference access.rs authenticate_record: the result must be a
        # record id, which becomes the session rid
        if not isinstance(out, RecordId):
            raise SdbError("There was a problem with authentication")
        return out
    # reference access.rs authenticate_generic: any non-none result fails
    if out is not NONE and out is not None:
        raise SdbError("There was a problem with authentication")
    return rid


def authenticate(ds, session: Session, token: str):
    # tokens naming an ACCESS method with its own verification config
    # (JWT key/alg or JWKS URL) verify against that config, not the
    # internal datastore secret (reference iam/verify.rs)
    try:
        _h, _p, _s = token.split(".")
        peek = json.loads(_unb64(_p))
    except (ValueError, UnicodeDecodeError):
        raise SdbError("There was a problem with authentication")
    ac, pns, pdb = peek.get("AC") or peek.get("ac"), \
        peek.get("NS") or peek.get("ns"), peek.get("DB") or peek.get("db")
    if ac and pns and pdb:
        txn = ds.transaction(write=False)
        try:
            adef = txn.get_val(K.ac_def("db", pns, pdb, ac))
        finally:
            txn.cancel()
        cfg = getattr(adef, "config", None) or {}
        if adef is not None and (cfg.get("url") or cfg.get("alg") or
                                 cfg.get("key")):
            try:
                payload = _verify_with_access(ds, cfg, token)
            except SdbError as e:
                if getattr(adef, "kind", None) == "record" and \
                        "problem with authentication" in str(e):
                    # tokens issued by our own signin/signup for a record
                    # access (datastore-secret signed) remain valid even
                    # when the access also carries a verification config;
                    # expiry / JWKS errors are NOT masked by the fallback
                    payload = verify_token(ds, token)
                else:
                    raise
            rid = None
            raw = payload.get("ID") or payload.get("id")
            if raw:
                from surrealdb_tpu_torch.exec.static_eval import static_value
                from surrealdb_tpu_torch.syn.parser import parse_record_literal

                rid = static_value(parse_record_literal(str(raw)))
            # the AUTHENTICATE clause runs BEFORE the session mutates: a
            # rejection must not leave a long-lived RPC session upgraded
            rid = _run_authenticate_clause(
                ds, pns, pdb, getattr(adef, "kind", None), cfg, payload, rid
            )
            session.ns, session.db, session.ac = pns, pdb, ac
            session.rid = rid
            session.auth_level = "record"
            session.token = dict(payload)
            return NONE
    payload = verify_token(ds, token)
    if payload.get("AC"):
        from surrealdb_tpu_torch.exec.static_eval import static_value
        from surrealdb_tpu_torch.syn.parser import parse_record_literal

        pns, pdb, pac = payload.get("NS"), payload.get("DB"), payload["AC"]
        rid = static_value(parse_record_literal(payload["ID"]))
        txn = ds.transaction(write=False)
        try:
            adef = txn.get_val(K.ac_def("db", pns, pdb, pac))
        finally:
            txn.cancel()
        if adef is not None:
            rid = _run_authenticate_clause(
                ds, pns, pdb, getattr(adef, "kind", None),
                getattr(adef, "config", None), payload, rid,
            )
        session.ns, session.db, session.ac = pns, pdb, pac
        session.rid = rid
        session.auth_level = "record"
        session.token = dict(payload)
    else:
        base = payload.get("base", "root")
        n, d = payload.get("NS"), payload.get("DB")
        if not payload.get("ID"):
            raise SdbError("There was a problem with authentication")
        # re-verify the system user still exists and derive the level from
        # its *current* roles (reference re-resolves the user on every
        # authenticate — a deleted or demoted user must not keep access)
        txn = ds.transaction(write=False)
        try:
            ud = txn.get_val(K.us_def(base, n, d, payload.get("ID")))
        finally:
            txn.cancel()
        if ud is None:
            raise SdbError("There was a problem with authentication")
        session.auth_level = _level_from_roles(ud.roles)
        session.auth_base = payload.get("base", "root")
        session.token = dict(payload)
        if n:
            session.ns = n
        if d:
            session.db = d
    return NONE
