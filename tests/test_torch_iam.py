"""The port's `iam.py` against the reference's: signin of root, namespace
and database users, record access (SIGNUP / SIGNIN / AUTHENTICATE),
tokens verified with an access method's own key (HS256/384/512, RS256 by
a PEM key or a JWKS endpoint served on 127.0.0.1), DEFINE / REMOVE USER
and ACCESS, the passhash routes, and a record user's KNN under row-level
PERMISSIONS on the device path (a `DeviceHost("cpu")` through the port's
inline supervisor, `torch_sql_harness.both`).

Tolerance: tokens compare by their decoded header and claims, less
`iat`, `exp` and `jti` (times of issue); sessions by their auth level,
base, namespace, database, access method, record id and token claims
(less the same three); query results as `torch_sql_harness` (floats
atol 1e-4, rtol 1e-5, the rest exactly), error texts exactly. Password
hashes hold random salts and compare by sign-in outcome.
"""

import base64
import hashlib
import hmac
import json
import re
import secrets
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from surrealdb_tpu import iam as RI
from surrealdb_tpu.capabilities import Capabilities as RCaps
from surrealdb_tpu.capabilities import Targets as RTargets
from surrealdb_tpu.err import SdbError as RErr
from surrealdb_tpu.kvs.ds import Session as RSession
from surrealdb_tpu_torch import iam as PI
from surrealdb_tpu_torch.capabilities import Capabilities as PCaps
from surrealdb_tpu_torch.capabilities import Targets as PTargets
from surrealdb_tpu_torch.err import SdbError as PErr
from surrealdb_tpu_torch.fnc import misc_fns as PM
from surrealdb_tpu_torch.kvs.ds import Session as PSession
from torch_sql_harness import DIM, MIN_ROWS, NS, DB, both, norm, same  # noqa: F401

_VOLATILE = ("iat", "exp", "jti")


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _claims(token):
    h, p, _s = token.split(".")
    payload = {k: v for k, v in json.loads(_unb64(p)).items()
               if k not in _VOLATILE}
    return json.loads(_unb64(h)), payload


def _session(s):
    tok = {k: v for k, v in (s.token or {}).items() if k not in _VOLATILE}
    return {"auth_level": s.auth_level, "auth_base": s.auth_base,
            "ns": s.ns, "db": s.db, "ac": s.ac,
            "rid": norm(s.rid), "token": tok}


def _call(fn_r, fn_p, *args, sessions=(None, None)):
    """Call the reference's and the port's iam function on their own
    datastore and a fresh session each: the same outcome (a token with
    the same header and claims, or the same error), the same session
    after it. Returns (ref session, port session, ref out, port out)."""
    rs = sessions[0] or RSession()
    ps = sessions[1] or PSession()
    (rds, pds), rest = args[0], args[1:]
    try:
        r = ("ok", fn_r(rds, rs, *rest))
    except RErr as e:
        r = ("err", str(e))
    try:
        p = ("ok", fn_p(pds, ps, *rest))
    except PErr as e:
        p = ("err", str(e))
    assert r[0] == p[0], (r, p)
    if r[0] == "err":
        assert r[1] == p[1]
    elif isinstance(r[1], str):
        assert _claims(r[1]) == _claims(p[1])
    else:
        same(norm(r[1]), norm(p[1]))
    assert _session(rs) == _session(ps)
    return rs, ps, r[1], p[1]


def _signin(both, creds, **kw):
    return _call(RI.signin, PI.signin, (both.ref, both.port), creds, **kw)


def _signup(both, creds, **kw):
    return _call(RI.signup, PI.signup, (both.ref, both.port), creds, **kw)


def _authenticate(both, rtok, ptok):
    """Each package authenticates its own token (each signs with a
    secret of its own): the same session after it."""
    rs, ps = RSession(), PSession()
    try:
        r = ("ok", RI.authenticate(both.ref, rs, rtok))
    except RErr as e:
        r = ("err", str(e))
    try:
        p = ("ok", PI.authenticate(both.port, ps, ptok))
    except PErr as e:
        p = ("err", str(e))
    assert r[0] == p[0] and (r[0] == "ok" or r[1] == p[1]), (r, p)
    assert _session(rs) == _session(ps)
    return rs, ps


_PASSHASH = re.compile(r"PASSHASH '\$argon2[^']*'")


def _hashless(v):
    """A normalised result with argon2 passhashes (random salts) masked."""
    if isinstance(v, str):
        return _PASSHASH.sub("PASSHASH <argon2>", v)
    if isinstance(v, (list, tuple)):
        return type(v)(_hashless(x) for x in v)
    if isinstance(v, dict):
        return {k: _hashless(x) for k, x in v.items()}
    return v


def _same_items(both):
    """`both.same_items()` with the password hashes a record holds (a
    random salt each) masked."""
    from surrealdb_tpu.kvs.api import deserialize as rdes
    from surrealdb_tpu_torch.kvs.api import deserialize as pdes
    from torch_sql_harness import _items

    def masked(v):
        if isinstance(v, str) and v.startswith(("$scrypt$", "$argon2",
                                                "$pbkdf2")):
            return "<hash>"
        if isinstance(v, list):
            return [masked(x) for x in v]
        if isinstance(v, dict):
            return {k: masked(x) for k, x in v.items()}
        return v

    ri, pi = _items(both.ref), _items(both.port)
    assert [k for k, _ in ri] == [k for k, _ in pi]
    for (k, rv), (_k, pv) in zip(ri, pi):
        if rv != pv:
            same(_hashless(masked(norm(rdes(rv)))),
                 _hashless(masked(norm(pdes(pv)))), repr(k))


def _as(both, sessions, sql, vars=None):
    """`sql` through each package under its own session: the same
    results."""
    from torch_sql_harness import _results

    r = both.ref.execute(sql, session=sessions[0], vars=vars)
    p = both.port.execute(sql, session=sessions[1], vars=vars)
    same(_hashless(_results(r)), _hashless(_results(p)))
    return p


# -- system users ----------------------------------------------------------------------


@pytest.mark.parametrize("base,role", [("ROOT", "OWNER"), ("NAMESPACE", "EDITOR"),
                                       ("DATABASE", "VIEWER")])
def test_system_user_signin(both, base, role):
    both.ok(f"DEFINE USER u ON {base} PASSWORD 'secret' ROLES {role} "
            "DURATION FOR TOKEN 2h")
    creds = {"user": "u", "pass": "secret"}
    if base != "ROOT":
        creds["NS"] = NS
    if base == "DATABASE":
        creds["DB"] = DB
    rs, ps, rtok, ptok = _signin(both, creds)
    assert rs.auth_level == role.lower()
    _signin(both, {**creds, "pass": "wrong"})
    _signin(both, {"user": "nobody", "pass": "secret"})
    _authenticate(both, rtok, ptok)
    # the signed-in session's rights: a viewer reads, an editor writes
    _as(both, (rs, ps), f"USE NS {NS} DB {DB}; CREATE w:1; SELECT * FROM w; "
        "INFO FOR DB")


def test_define_user_levels_and_render(both):
    both.run("DEFINE USER a ON ROOT PASSWORD 'x' ROLES OWNER; "
             "DEFINE USER a ON ROOT PASSWORD 'x'; "
             "DEFINE USER IF NOT EXISTS a ON ROOT PASSWORD 'y'; "
             "DEFINE USER n ON NAMESPACE PASSWORD 'x' ROLES EDITOR "
             "COMMENT 'ns user'; DEFINE USER d ON DATABASE PASSHASH "
             "'$scrypt$n=16384,r=8,p=1$00$00' ROLES VIEWER")
    # a database owner cannot define a root user (its base is below)
    both.run("DEFINE USER r2 ON ROOT PASSWORD 'x' ROLES OWNER",
             auth_base="db")
    both.run("DEFINE USER r3 ON DATABASE PASSWORD 'x'", auth_base="db")
    for sql in ("INFO FOR ROOT", "INFO FOR NS", "INFO FOR DB",
                "INFO FOR USER a", "INFO FOR USER n ON NAMESPACE",
                "INFO FOR USER d ON DATABASE"):
        r = both.ref.query_one(sql, ns=NS, db=DB)
        p = both.port.query_one(sql, ns=NS, db=DB)
        # argon2 salts differ; the rest renders the same
        same(_hashless(norm(r)), _hashless(norm(p)))
    both.run("ALTER USER n ON NAMESPACE COMMENT 'c'; "
             "ALTER USER nope ON ROOT COMMENT 'c'; "
             "REMOVE USER n ON NAMESPACE; REMOVE USER n ON NAMESPACE; "
             "REMOVE USER IF EXISTS n ON NAMESPACE; INFO FOR NS")


def test_removed_or_demoted_user_loses_its_token(both):
    both.ok("DEFINE USER u ON ROOT PASSWORD 'p' ROLES OWNER")
    _rs, _ps, rtok, ptok = _signin(both, {"user": "u", "pass": "p"})
    both.ok("ALTER USER u ON ROOT ROLES VIEWER")
    rs, _ps = _authenticate(both, rtok, ptok)
    assert rs.auth_level == "viewer"
    both.ok("ALTER USER u ON ROOT PASSWORD 'q'")
    _signin(both, {"user": "u", "pass": "p"})
    _signin(both, {"user": "u", "pass": "q"})
    both.ok("REMOVE USER u ON ROOT")
    _authenticate(both, rtok, ptok)


# -- password hashes across the packages ----------------------------------------------


def test_port_scrypt_user_signs_in_on_the_reference(both, monkeypatch):
    """Where `argon2` does not import (the card's machine), the port
    writes the reference's `$scrypt$` form: the reference signs that user
    in."""
    monkeypatch.setattr(PM, "argon2_available", lambda: False)
    both.port.query("DEFINE USER s ON ROOT PASSWORD 'pw' ROLES OWNER",
                    ns=NS, db=DB)
    ph = both.port.query_one("INFO FOR USER s", ns=NS, db=DB)
    h = re.search(r"PASSHASH '([^']*)'", ph).group(1)
    assert h.startswith("$scrypt$n=16384,r=8,p=1$")
    both.ref.query(f"DEFINE USER s ON ROOT PASSHASH '{h}' ROLES OWNER",
                   ns=NS, db=DB)
    _signin(both, {"user": "s", "pass": "pw"})
    _signin(both, {"user": "s", "pass": "nope"})


def test_reference_argon2_user_signs_in_on_the_port(both):
    both.ref.query("DEFINE USER a ON ROOT PASSWORD 'pw' ROLES EDITOR",
                   ns=NS, db=DB)
    rh = both.ref.query_one("INFO FOR USER a", ns=NS, db=DB)
    h = re.search(r"PASSHASH '([^']*)'", rh).group(1)
    assert h.startswith("$argon2id$")
    both.port.query(f"DEFINE USER a ON ROOT PASSHASH '{h}' ROLES EDITOR",
                    ns=NS, db=DB)
    rs, ps, _r, _p = _signin(both, {"user": "a", "pass": "pw"})
    assert ps.auth_level == "editor"
    _signin(both, {"user": "a", "pass": "nope"})


def test_missing_argon2_is_named_never_false(both, monkeypatch):
    both.port.query("DEFINE USER a ON ROOT PASSWORD 'pw'", ns=NS, db=DB)
    monkeypatch.setitem(sys.modules, "argon2", None)
    monkeypatch.setitem(sys.modules, "argon2.exceptions", None)
    assert not PM.argon2_available()
    assert PM.password_hash("pw").startswith("$scrypt$")
    with pytest.raises(PErr, match="argon2"):
        PI.signin(both.port, PSession(), {"user": "a", "pass": "pw"})
    out = both.port.execute(
        "RETURN crypto::argon2::generate('x'); "
        "RETURN crypto::argon2::compare('$argon2id$v=19$x', 'x'); "
        "DEFINE USER b ON ROOT PASSWORD 'pw'; INFO FOR USER b",
        ns=NS, db=DB)
    for r in out[:2]:
        assert r.error is not None and "`argon2` package" in r.error
    assert out[2].error is None and "$scrypt$" in out[3].result
    s = PSession()
    PI.signin(both.port, s, {"user": "b", "pass": "pw"})
    assert s.auth_level == "viewer"


# -- record access ------------------------------------------------------------------------

_ACCESS = (
    "DEFINE ACCESS account ON DATABASE TYPE RECORD "
    "SIGNUP (CREATE type::record('user', $name) SET pass = "
    "crypto::scrypt::generate($pass), tier = $tier) "
    "SIGNIN (SELECT * FROM user WHERE id = type::record('user', $name) "
    "AND crypto::scrypt::compare(pass, $pass)) "
    "DURATION FOR TOKEN 30m")


def _creds(name, pw, **kw):
    return {"NS": NS, "DB": DB, "AC": "account", "name": name, "pass": pw,
            **kw}


def test_record_signup_signin_authenticate(both):
    both.ok(_ACCESS + "; DEFINE TABLE note PERMISSIONS FOR select, create "
            "WHERE owner = $auth.id")
    rs, ps, rtok, ptok = _signup(both, _creds("alice", "a", tier=1))
    assert rs.auth_level == "record" and rs.rid.render() == "user:alice"
    _signup(both, {"NS": NS, "DB": DB, "AC": "nope", "name": "x"})
    _signup(both, {"NS": NS, "name": "x"})
    _signin(both, _creds("alice", "a"))
    _signin(both, _creds("alice", "wrong"))
    _signin(both, _creds("bob", "a"))
    rs, ps = _authenticate(both, rtok, ptok)
    _as(both, (rs, ps),
        "RETURN [session::ac(), session::rd(), session::ns(), "
        "session::db(), $auth.id, $auth.tier, $token.AC, $token.ID]; "
        "CREATE note:1 SET owner = $auth.id; CREATE note:2 SET owner = "
        "user:bob; SELECT * FROM note; SELECT * FROM user; "
        "DEFINE TABLE x; INFO FOR DB")
    _same_items(both)


def test_record_access_with_issuer_key(both):
    both.ok("DEFINE ACCESS acc ON DATABASE TYPE RECORD "
            "SIGNUP (CREATE user SET id = $id) "
            "SIGNIN (SELECT * FROM user WHERE id = $id) "
            "WITH JWT ALGORITHM HS384 KEY 'issuerkey'")
    creds = {"NS": NS, "DB": DB, "AC": "acc", "id": "u1"}
    _rs, _ps, rtok, ptok = _signup(both, creds)
    h, p, s = ptok.split(".")
    want = hmac.new(b"issuerkey", f"{h}.{p}".encode(), hashlib.sha384)
    assert hmac.compare_digest(want.digest(), _unb64(s))
    _authenticate(both, rtok, ptok)
    _signin(both, creds)


def test_authenticate_clause(both):
    both.ok("DEFINE ACCESS g ON DATABASE TYPE JWT ALGORITHM HS256 KEY 'k' "
            "AUTHENTICATE { IF $token.deny { THROW 'denied' } }; "
            "DEFINE ACCESS r ON DATABASE TYPE RECORD "
            "SIGNIN (SELECT * FROM user WHERE id = $id) "
            "SIGNUP (CREATE user SET id = $id, blocked = $blocked) "
            "AUTHENTICATE (IF $auth.blocked { NONE } ELSE { $auth.id })")
    base = {"AC": "g", "NS": NS, "DB": DB, "ID": "u:1",
            "exp": time.time() + 60}
    rs, _ps = _authenticate(both, _hs("HS256", "k", base),
                            _hs("HS256", "k", base))
    assert rs.auth_level == "record"
    deny = {**base, "deny": True}
    _authenticate(both, _hs("HS256", "k", deny), _hs("HS256", "k", deny))
    _rs, _ps, rtok, ptok = _signup(both, {"NS": NS, "DB": DB, "AC": "r",
                                          "id": "a", "blocked": False})
    _authenticate(both, rtok, ptok)
    _rs, _ps, rtok, ptok = _signup(both, {"NS": NS, "DB": DB, "AC": "r",
                                          "id": "b", "blocked": True})
    _authenticate(both, rtok, ptok)


def test_removed_access_refuses(both):
    both.ok(_ACCESS)
    _signup(both, _creds("c", "c"))
    both.run("REMOVE ACCESS account ON DATABASE; REMOVE ACCESS account ON "
             "DATABASE; REMOVE ACCESS IF EXISTS account ON DATABASE; "
             "INFO FOR DB")
    _signin(both, _creds("c", "c"))


# -- tokens of an access method's own key ----------------------------------------------------


def _hs(alg, key, payload):
    hn = {"HS256": hashlib.sha256, "HS384": hashlib.sha384,
          "HS512": hashlib.sha512}[alg]
    h = _b64(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    p = _b64(json.dumps(payload).encode())
    sig = hmac.new(key.encode(), f"{h}.{p}".encode(), hn).digest()
    return f"{h}.{p}.{_b64(sig)}"


@pytest.mark.parametrize("alg", ["HS256", "HS384", "HS512"])
def test_hs_tokens(both, alg):
    both.ok(f"DEFINE ACCESS partner ON DATABASE TYPE JWT ALGORITHM {alg} "
            "KEY 'sharedsecret'")
    good = {"AC": "partner", "NS": NS, "DB": DB, "ID": "user:9",
            "exp": time.time() + 60, "role": "x"}
    t = _hs(alg, "sharedsecret", good)
    rs, _ps = _authenticate(both, t, t)
    assert rs.auth_level == "record" and rs.ac == "partner"
    for bad in (_hs(alg, "other", good),
                _hs(alg, "sharedsecret", {**good, "exp": time.time() - 5}),
                _hs(alg, "sharedsecret", {k: v for k, v in good.items()
                                          if k != "exp"}),
                _hs("HS256" if alg != "HS256" else "HS384", "sharedsecret",
                    good),
                "not.a.token", "x"):
        _authenticate(both, bad, bad)


def _miller_rabin(n, rounds=24):
    if n % 2 == 0:
        return n == 2
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits):
    while True:
        p = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _miller_rabin(p):
            return p


def _der_int(x):
    b = x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return _der(0x02, b)


def _der(tag, body):
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(nb)]) + nb + body


def _pem(kind, der):
    b = base64.encodebytes(der).decode()
    return f"-----BEGIN {kind}-----\n{b}-----END {kind}-----\n"


@pytest.fixture(scope="module")
def rsa():
    """A 1024-bit RSA key made here: (n, e, d, public PEM, private PEM)."""
    e = 65537
    while True:
        p, q = _prime(512), _prime(512)
        phi = (p - 1) * (q - 1)
        if p != q and phi % e:
            break
    n, d = p * q, pow(e, -1, phi)
    pub = _pem("RSA PUBLIC KEY", _der(0x30, _der_int(n) + _der_int(e)))
    priv = _pem("RSA PRIVATE KEY", _der(0x30, b"".join(_der_int(x) for x in (
        0, n, e, d, p, q, d % (p - 1), d % (q - 1), pow(q, -1, p)))))
    return n, e, d, pub, priv


def _rs(n, d, header, payload, hname="sha256"):
    h = _b64(json.dumps(header).encode())
    p = _b64(json.dumps(payload).encode())
    msg = f"{h}.{p}".encode()
    k = (n.bit_length() + 7) // 8
    di = {"sha256": "3031300d060960864801650304020105000420",
          "sha384": "3041300d060960864801650304020205000430",
          "sha512": "3051300d060960864801650304020305000440"}[hname]
    t = bytes.fromhex(di) + hashlib.new(hname, msg).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")
    return f"{h}.{p}.{_b64(sig)}"


@pytest.mark.parametrize("alg,hname", [("RS256", "sha256"),
                                       ("RS384", "sha384"),
                                       ("RS512", "sha512")])
def test_rs_tokens_with_a_pem_key(both, rsa, alg, hname):
    n, _e, d, pub, _priv = rsa
    both.ok(f"DEFINE ACCESS ext ON DATABASE TYPE JWT ALGORITHM {alg} "
            f"KEY '{pub}'")
    body = {"AC": "ext", "NS": NS, "DB": DB, "ID": "user:7",
            "exp": time.time() + 60}
    t = _rs(n, d, {"alg": alg}, body, hname)
    rs, _ps = _authenticate(both, t, t)
    assert rs.auth_level == "record" and rs.rid.render() == "user:7"
    h, p, s = t.split(".")
    forged = f"{h}.{_b64(json.dumps({**body, 'ID': 'user:1'}).encode())}.{s}"
    _authenticate(both, forged, forged)
    # an HS token keyed with the public PEM text is refused (the
    # algorithm is the access method's, never the token header's)
    hs = _hs("HS256", pub, body)
    _authenticate(both, hs, hs)


def test_rs256_issued_by_record_access(both, rsa):
    n, e, _d, pub, priv = rsa
    both.ok("DEFINE ACCESS acc ON DATABASE TYPE RECORD "
            "SIGNUP (CREATE user SET id = $id) "
            "SIGNIN (SELECT * FROM user WHERE id = $id) "
            f"WITH JWT ALGORITHM RS256 KEY '{pub}' WITH ISSUER KEY '{priv}'")
    from surrealdb_tpu_torch.utils.rsa import verify_pkcs1_v15

    _rs_, _ps, rtok, ptok = _signup(both, {"NS": NS, "DB": DB, "AC": "acc",
                                           "id": "r1"})
    for tok in (rtok, ptok):
        h, p, s = tok.split(".")
        assert verify_pkcs1_v15(n, e, f"{h}.{p}".encode(), _unb64(s))
    _authenticate(both, rtok, ptok)


def _spawn_jwks(doc):
    class H(BaseHTTPRequestHandler):
        hits = [0]

        def do_GET(self):
            H.hits[0] += 1
            body = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, H, f"http://127.0.0.1:{srv.server_port}/jwks.json"


def test_jwks(both, rsa):
    n, e, d, _pub, _priv = rsa
    jwks = {"keys": [{"kty": "RSA", "kid": "k1", "alg": "RS256",
                      "n": _b64(n.to_bytes((n.bit_length() + 7) // 8, "big")),
                      "e": _b64(e.to_bytes(3, "big"))}]}
    srv, H, url = _spawn_jwks(jwks)
    try:
        body = {"AC": "ext", "NS": NS, "DB": DB, "ID": "user:7",
                "exp": time.time() + 3600}
        t = _rs(n, d, {"alg": "RS256", "kid": "k1"}, body)
        both.ok(f"DEFINE ACCESS ext ON DATABASE TYPE JWT URL '{url}'")
        # network targets are denied by default: the fetch is refused
        _authenticate(both, t, t)
        assert H.hits[0] == 0
        both.ref.capabilities = RCaps(allow_net=RTargets.parse("127.0.0.1"))
        both.port.capabilities = PCaps(allow_net=PTargets.parse("127.0.0.1"))
        rs, _ps = _authenticate(both, t, t)
        assert rs.auth_level == "record"
        assert H.hits[0] == 2  # one fetch a package, then each one's cache
        _authenticate(both, t, t)
        assert H.hits[0] == 2
        wrong_kid = _rs(n, d, {"alg": "RS256", "kid": "k2"}, body)
        _authenticate(both, wrong_kid, wrong_kid)
    finally:
        srv.shutdown()
        srv.server_close()


# -- a record user's KNN under PERMISSIONS on the device path -------------------------------


def test_record_user_knn_under_permissions(both):
    """The reference's semantics: the index answers the k nearest of the
    whole table and the permission check then drops the rows the user may
    not read, so a user's answer is root's answer less the others' rows
    (not the k nearest of the user's own rows)."""
    rng = np.random.default_rng(11)
    n = MIN_ROWS * 4
    xs = rng.standard_normal((n, DIM)).astype(np.float32)
    both.ok(_ACCESS + "; DEFINE TABLE acl PERMISSIONS FOR select, create, "
            "update, delete WHERE owner = $auth.id; DEFINE INDEX ix ON acl "
            f"FIELDS emb HNSW DIMENSION {DIM} DIST COSINE TYPE F32")
    both.ok("FOR $r IN $rows { CREATE type::record('acl', $r.i) SET emb = "
            "$r.emb, owner = type::record('user', IF $r.i % 2 = 0 "
            "{ 'alice' } ELSE { 'bob' }) }",
            {"rows": [{"i": i, "emb": xs[i].tolist()} for i in range(n)]})
    sessions = {}
    for name in ("alice", "bob"):
        _signup(both, _creds(name, name))
        rs, ps, _r, _p = _signin(both, _creds(name, name))
        sessions[name] = (rs, ps)
    qs = rng.standard_normal((6, DIM)).astype(np.float32)
    sql = "SELECT id, vector::distance::knn() AS d FROM acl WHERE emb <|10,40|> $q"
    both.ops.clear()
    for q in qs:
        v = {"q": q.tolist()}
        root = [r["id"].id for r in both.run(sql, v)[0].result]
        assert len(root) == 10
        for parity, name in enumerate(("alice", "bob")):
            got = _as(both, sessions[name], sql, v)[0].result
            assert [r["id"].id for r in got] == \
                [i for i in root if i % 2 == parity]
    assert "vec_knn" in both.ops
    # a record user's write goes through the same check; an event on it
    # runs as that user, so its CREATE needs the audit table's grant
    both.ok("DEFINE EVENT audit ON acl WHEN $event = 'CREATE' THEN "
            "(CREATE type::record('audit', $after.id.id()) SET "
            "rec = $after.id, by = $auth.id)")
    _as(both, sessions["alice"],
        "CREATE acl:900 SET emb = $v, owner = $auth.id; "
        "CREATE acl:901 SET emb = $v, owner = user:bob; "
        "SELECT rec, by FROM audit",
        {"v": qs[0].tolist()})
    both.ok("DEFINE TABLE OVERWRITE audit PERMISSIONS FULL")
    _as(both, sessions["alice"],
        "CREATE acl:902 SET emb = $v, owner = $auth.id; "
        "SELECT rec, by FROM audit; "
        "SELECT id FROM acl WHERE emb <|3|> $v",
        {"v": qs[1].tolist()})
    _same_items(both)


def test_function_permissions_for_record_users(both):
    both.ok(_ACCESS + "; DEFINE FUNCTION fn::mine() { RETURN $auth.id } "
            "PERMISSIONS WHERE $auth.id = user:alice; "
            "DEFINE FUNCTION fn::none() { RETURN 1 } PERMISSIONS NONE; "
            "DEFINE FUNCTION fn::all() { RETURN 2 }")
    sessions = {}
    for name in ("alice", "bob"):
        rs, ps, _r, _p = _signup(both, _creds(name, name))
        sessions[name] = (rs, ps)
    for name in ("alice", "bob"):
        _as(both, sessions[name], "RETURN fn::mine(); RETURN fn::none(); "
            "RETURN fn::all()")
    both.run("RETURN [fn::mine(), fn::none(), fn::all()]")
