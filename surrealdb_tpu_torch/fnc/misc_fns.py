"""The reference's `fnc/misc_fns.py` families crypto::, parse::,
encoding::, bytes::, geo::, session::, sequence::, value:: and search::
(hashes and password hashing; e-mail and URL parts; base64, JSON and
CBOR; byte lengths; haversine distance and bearing, centroid, area and
geohash; the session's attributes; batch-allocated sequences;
`value::chain` / `diff` / `patch` over `utils/patch.py`; the full-text
score, highlight, offsets and analyze functions over `idx/fulltext.py`
and the rrf and linear fusions), http:: (behind the `allows_net`
capability), api::invoke (`api.py`) and file:: over DEFINE BUCKET
stores (`buc.py`)."""

from __future__ import annotations

import hashlib
import hmac as _hmac
import math
import secrets

from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _str, register
from surrealdb_tpu_torch.val import NONE, Geometry, to_json


# -- crypto -------------------------------------------------------------------


@register("crypto::md5")
def _md5(args, ctx):
    return hashlib.md5(_str(args[0], "crypto::md5", 1).encode()).hexdigest()


@register("crypto::sha1")
def _sha1(args, ctx):
    return hashlib.sha1(_str(args[0], "crypto::sha1", 1).encode()).hexdigest()


@register("crypto::sha256")
def _sha256(args, ctx):
    return hashlib.sha256(_str(args[0], "crypto::sha256", 1).encode()).hexdigest()


@register("crypto::joaat")
def _joaat(args, ctx):
    """Jenkins one-at-a-time hash (u32 decimal, reference fnc/crypto)."""
    data = _str(args[0], "crypto::joaat", 1).encode()
    h = 0
    for b in data:
        h = (h + b) & 0xFFFFFFFF
        h = (h + (h << 10)) & 0xFFFFFFFF
        h ^= h >> 6
    h = (h + (h << 3)) & 0xFFFFFFFF
    h ^= h >> 11
    h = (h + (h << 15)) & 0xFFFFFFFF
    return h


@register("crypto::sha512")
def _sha512(args, ctx):
    return hashlib.sha512(_str(args[0], "crypto::sha512", 1).encode()).hexdigest()


@register("crypto::blake3")
def _blake3(args, ctx):
    from surrealdb_tpu_torch.utils.blake3 import blake3_hex

    return blake3_hex(_str(args[0], "crypto::blake3", 1).encode())


# password hashing: argon2id (the reference's user passhashes) where the
# `argon2` package imports, pbkdf2 and scrypt; bcrypt takes the pbkdf2 route


def _pbkdf2_hash(pw: str, rounds=600_000) -> str:
    salt = secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", pw.encode(), salt, rounds)
    return f"$pbkdf2-sha256$i={rounds}${salt.hex()}${dk.hex()}"


def _pbkdf2_compare(h: str, pw: str) -> bool:
    try:
        _, alg, iters, salt, dk = h.split("$")
        rounds = int(iters.split("=")[1])
        got = hashlib.pbkdf2_hmac("sha256", pw.encode(), bytes.fromhex(salt), rounds)
        return _hmac.compare_digest(got.hex(), dk)
    except (ValueError, IndexError):
        return False


def _scrypt_hash(pw: str) -> str:
    salt = secrets.token_bytes(16)
    dk = hashlib.scrypt(pw.encode(), salt=salt, n=2**14, r=8, p=1)
    return f"$scrypt$n=16384,r=8,p=1${salt.hex()}${dk.hex()}"


def _scrypt_compare(h: str, pw: str) -> bool:
    try:
        parts = h.split("$")
        salt, dk = parts[3], parts[4]
        got = hashlib.scrypt(pw.encode(), salt=bytes.fromhex(salt), n=2**14, r=8, p=1)
        return _hmac.compare_digest(got.hex(), dk)
    except (ValueError, IndexError):
        return False


@register("crypto::pbkdf2::generate")
def _pbkdf2_gen(args, ctx):
    return _pbkdf2_hash(_str(args[0], "f", 1))


@register("crypto::pbkdf2::compare")
def _pbkdf2_cmp(args, ctx):
    return _pbkdf2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


@register("crypto::scrypt::generate")
def _scrypt_gen(args, ctx):
    return _scrypt_hash(_str(args[0], "f", 1))


@register("crypto::scrypt::compare")
def _scrypt_cmp(args, ctx):
    return _scrypt_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


def _argon2():
    """The `argon2` package (argon2-cffi), or an error that names it: an
    argon2id hash is never quietly compared as false where it cannot be
    read."""
    try:
        import argon2
        import argon2.exceptions
    except ImportError:
        raise SdbError(
            "argon2id hashing needs the `argon2` package (argon2-cffi), "
            "which is not installed"
        )
    return argon2


def argon2_available() -> bool:
    try:
        _argon2()
    except SdbError:
        return False
    return True


def _argon2_hash(pw: str) -> str:
    return _argon2().PasswordHasher().hash(pw)


def _argon2_compare(h: str, pw: str) -> bool:
    a2 = _argon2()
    try:
        return a2.PasswordHasher().verify(h, pw)
    except (a2.exceptions.VerifyMismatchError,
            a2.exceptions.VerificationError,
            a2.exceptions.InvalidHashError):
        return False


@register("crypto::argon2::generate")
def _argon2_gen(args, ctx):
    return _argon2_hash(_str(args[0], "f", 1))


@register("crypto::argon2::compare")
def _argon2_cmp(args, ctx):
    return _argon2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


@register("crypto::bcrypt::generate")
def _bcrypt_gen(args, ctx):
    return _pbkdf2_hash(_str(args[0], "f", 1))


@register("crypto::bcrypt::compare")
def _bcrypt_cmp(args, ctx):
    return _pbkdf2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


def password_hash(pw: str) -> str:
    """A user's passhash: argon2id, as the reference's, where the
    `argon2` package imports; elsewhere the reference's own
    `$scrypt$n=16384,r=8,p=1$...` form, which the reference reads too."""
    if argon2_available():
        return _argon2_hash(pw)
    return _scrypt_hash(pw)


def password_compare(h: str, pw: str) -> bool:
    if h.startswith("$argon2"):
        return _argon2_compare(h, pw)
    if h.startswith("$pbkdf2"):
        return _pbkdf2_compare(h, pw)
    if h.startswith("$scrypt"):
        return _scrypt_compare(h, pw)
    return False


# -- parse --------------------------------------------------------------------


def _email_parts(s):
    """RFC-style address validation (reference addr crate): returns
    (local, host) or None when the address is invalid."""
    import re as _re

    in_q = False
    at = -1
    for i, ch in enumerate(s):
        if ch == '"':
            in_q = not in_q
        elif ch == "@" and not in_q:
            at = i
    if in_q or at <= 0 or at == len(s) - 1:
        return None
    local, dom = s[:at], s[at + 1:]
    if local.startswith('"'):
        if not (local.endswith('"') and len(local) >= 2):
            return None
    else:
        t = local
        if not t or t[0] == "." or t[-1] == "." or ".." in t:
            return None
        if not _re.fullmatch(r"[A-Za-z0-9.!#$%&'*+/=?^_`{|}~-]+", t):
            return None
    if dom.startswith("[") and dom.endswith("]"):
        host = dom[1:-1]
        # only IPv4 address literals are accepted
        if not _re.fullmatch(
            r"(25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)"
            r"(\.(25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)){3}", host
        ):
            return None
        return local, host
    labels = dom.split(".")
    for lb in labels:
        if not lb or lb[0] == "-" or lb[-1] == "-":
            return None
        if not _re.fullmatch(r"[A-Za-z0-9-]+", lb):
            return None
    return local, dom


@register("parse::email::host")
def _email_host(args, ctx):
    parts = _email_parts(_str(args[0], "parse::email::host", 1))
    return parts[1] if parts else NONE


@register("parse::email::user")
def _email_user(args, ctx):
    parts = _email_parts(_str(args[0], "parse::email::user", 1))
    return parts[0] if parts else NONE


class _UrlNone:
    """Unparseable URL: every component reads NONE."""

    hostname = None
    fragment = ""
    path = ""
    query = ""
    scheme = ""
    port = None


def _url(args, fname):
    from urllib.parse import quote, urlparse

    from surrealdb_tpu_torch.val import render as _r

    v = args[0]
    if not isinstance(v, str):
        raise SdbError(
            f"Incorrect arguments for function {fname}(). Argument 1 was "
            f"the wrong type. Expected `string` but found `{_r(v)}`"
        )
    try:
        u = urlparse(v)
    except ValueError:
        return _UrlNone()
    if not u.scheme or not (u.netloc or u.path):
        return _UrlNone()

    class _U:
        hostname = u.hostname
        fragment = u.fragment
        scheme = u.scheme
        # WHATWG: special schemes normalize an empty path to "/" and
        # resolve . / .. segments
        def _norm_path(pth):
            if not pth:
                return ""
            out = []
            segs = pth.split("/")
            for i, seg in enumerate(segs):
                if seg == ".":
                    if i == len(segs) - 1:
                        out.append("")
                    continue
                if seg == "..":
                    if len(out) > 1:
                        out.pop()
                    if i == len(segs) - 1:
                        out.append("")
                    continue
                out.append(seg)
            return "/".join(out)

        path = _norm_path(u.path) or (
            "/" if u.scheme in ("http", "https", "ws", "wss", "ftp", "file")
            else ""
        )
        # query serializes percent-encoded; existing %XX escapes are
        # preserved (url crate form serialization)
        query = quote(u.query, safe="=&,-._~!$*+;:@/?%")

        try:
            port = u.port
        except ValueError:
            port = None

    return _U()


@register("parse::url::domain")
def _url_domain(args, ctx):
    h = _url(args, "parse::url::domain").hostname
    return h if h else NONE


@register("parse::url::host")
def _url_host(args, ctx):
    h = _url(args, "parse::url::host").hostname
    return h if h else NONE


@register("parse::url::fragment")
def _url_fragment(args, ctx):
    f = _url(args, "parse::url::fragment").fragment
    return f if f else NONE


@register("parse::url::path")
def _url_path(args, ctx):
    return _url(args, "parse::url::path").path or NONE


@register("parse::url::port")
def _url_port(args, ctx):
    p = _url(args, "parse::url::port").port
    return p if p is not None else NONE


@register("parse::url::query")
def _url_query(args, ctx):
    q = _url(args, "parse::url::query").query
    return q if q else NONE


@register("parse::url::scheme")
def _url_scheme(args, ctx):
    s = _url(args, "parse::url::scheme").scheme
    return s if s else NONE


# -- encoding -----------------------------------------------------------------


@register("encoding::base64::encode")
def _b64_encode(args, ctx):
    import base64

    v = args[0]
    data = v if isinstance(v, (bytes, bytearray)) else _str(v, "f").encode()
    out = base64.b64encode(bytes(data)).decode()
    padded = len(args) > 1 and args[1] is True
    return out if padded else out.rstrip("=")


def _to_jsonable(v):
    from surrealdb_tpu_torch.exec.operators import to_string
    from surrealdb_tpu_torch.val import SSet

    if v is NONE or v is None:
        return None
    if isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, list):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, SSet):
        return [_to_jsonable(x) for x in v.items]
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    return to_string(v)


def _from_jsonable(v):
    if v is None:
        return None
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _from_jsonable(x) for k, x in v.items()}
    return v


@register("encoding::json::encode")
def _json_encode(args, ctx):
    import json

    return json.dumps(
        _to_jsonable(args[0]), separators=(",", ":"), ensure_ascii=False
    )


@register("encoding::json::decode")
def _json_decode(args, ctx):
    import json

    s2 = _str(args[0], "encoding::json::decode", 1)
    try:
        return _from_jsonable(json.loads(s2))
    except ValueError:
        raise SdbError(
            "Incorrect arguments for function encoding::json::decode(). "
            "Invalid JSON"
        )


def _cbor_encode_val(v, out: bytearray):
    """The reference's encoding: the scalars (NONE as tag 6 + null,
    null, booleans, integers, 64-bit floats, text, bytes) in the wire
    codec's bytes (`wire.py`), arrays, sets and objects as plain CBOR
    arrays and maps, and any other value as its string."""
    from surrealdb_tpu_torch import wire
    from surrealdb_tpu_torch.val import SSet

    if isinstance(v, (list, SSet)):
        items = v.items if isinstance(v, SSet) else v
        wire._head(out, 4, len(items))
        for x in items:
            _cbor_encode_val(x, out)
    elif isinstance(v, dict):
        wire._head(out, 5, len(v))
        for k, x in v.items():
            _cbor_encode_val(k, out)
            _cbor_encode_val(x, out)
    elif v is NONE or v is None or isinstance(
            v, (bool, int, float, str, bytes, bytearray)):
        out += wire.encode(v)
    else:
        from surrealdb_tpu_torch.exec.operators import to_string

        out += wire.encode(to_string(v))


def _cbor_invalid():
    return SdbError(
        "Incorrect arguments for function encoding::cbor::decode(). "
        "Invalid CBOR input"
    )


def _cbor_decode_val(b: bytes, pos: int):
    import struct

    def take(k):
        if pos + k > len(b):
            raise _cbor_invalid()

    if pos >= len(b):
        raise _cbor_invalid()
    ib = b[pos]
    major, info = ib >> 5, ib & 0x1F
    pos += 1
    if info < 24:
        n = info
    elif info == 24:
        take(1)
        n = b[pos]
        pos += 1
    elif info == 25:
        take(2)
        n = int.from_bytes(b[pos:pos + 2], "big")
        pos += 2
    elif info == 26:
        take(4)
        n = int.from_bytes(b[pos:pos + 4], "big")
        pos += 4
    elif info == 27:
        take(8)
        n = int.from_bytes(b[pos:pos + 8], "big")
        pos += 8
    else:
        # indefinite lengths / reserved additional-info are unsupported
        raise SdbError(
            "Incorrect arguments for function encoding::cbor::decode(). "
            "Invalid CBOR input"
        )
    if major == 0:
        return n, pos
    if major == 1:
        return -1 - n, pos
    if major == 2:
        take(n)
        return bytes(b[pos:pos + n]), pos + n
    if major == 3:
        take(n)
        return b[pos:pos + n].decode("utf-8"), pos + n
    if major == 4:
        out = []
        for _ in range(n):
            v, pos = _cbor_decode_val(b, pos)
            out.append(v)
        return out, pos
    if major == 5:
        out = {}
        for _ in range(n):
            k, pos = _cbor_decode_val(b, pos)
            v, pos = _cbor_decode_val(b, pos)
            out[k if isinstance(k, str) else str(k)] = v
        return out, pos
    if major == 6:
        v, pos = _cbor_decode_val(b, pos)
        if n == 6:
            return NONE, pos
        return v, pos
    # major 7: simple / float
    if info == 20:
        return False, pos
    if info == 21:
        return True, pos
    if info in (22, 23):
        return None, pos
    if info == 27:
        return struct.unpack(">d", b[pos - 8:pos])[0], pos
    if info == 26:
        return struct.unpack(">f", b[pos - 4:pos])[0], pos
    raise SdbError(
        "Incorrect arguments for function encoding::cbor::decode(). "
        "Invalid CBOR input"
    )


@register("encoding::cbor::encode")
def _cbor_encode(args, ctx):
    out = bytearray()
    _cbor_encode_val(args[0], out)
    return bytes(out)


@register("encoding::cbor::decode")
def _cbor_decode(args, ctx):
    v = args[0]
    if not isinstance(v, (bytes, bytearray)):
        from surrealdb_tpu_torch.val import render as _r

        raise SdbError(
            "Incorrect arguments for function encoding::cbor::decode(). "
            f"Argument 1 was the wrong type. Expected `bytes` but found "
            f"`{_r(v)}`"
        )
    try:
        out, _pos = _cbor_decode_val(bytes(v), 0)
        return out
    except (IndexError, UnicodeDecodeError):
        raise SdbError(
            "Incorrect arguments for function encoding::cbor::decode(). "
            "Invalid CBOR input"
        )


@register("encoding::base64::decode")
def _b64_decode(args, ctx):
    import base64

    s = _str(args[0], "f", 1)
    pad = "=" * (-len(s) % 4)
    return base64.b64decode(s + pad)


@register("string::base64_encode")
def _b64e2(args, ctx):
    return _b64_encode(args, ctx)


# -- bytes --------------------------------------------------------------------


@register("bytes::len")
def _bytes_len(args, ctx):
    v = args[0]
    if not isinstance(v, (bytes, bytearray)):
        from surrealdb_tpu_torch.fnc import ArgError

        raise ArgError(1, "bytes", v)
    return len(v)


# -- geo ----------------------------------------------------------------------

_EARTH_R = 6371008.8  # meters (mean earth radius)


def _as_geom(v):
    """GeoJSON-shaped objects coerce to geometries in geo:: functions."""
    if isinstance(v, Geometry):
        return v
    if isinstance(v, dict) and isinstance(v.get("type"), str) and \
            "coordinates" in v:
        def tup(c):
            if isinstance(c, list):
                return tuple(tup(x) for x in c)
            return c

        return Geometry(v["type"], tup(v["coordinates"]))
    return v


def _pt(v, fname, argn=1):
    from surrealdb_tpu_torch.val import render

    v = _as_geom(v)
    if isinstance(v, Geometry) and v.kind == "Point":
        return float(v.coords[0]), float(v.coords[1])
    if isinstance(v, Geometry) or isinstance(v, dict):
        return None  # a geometry, just not a point -> NONE result
    raise SdbError(
        f"Incorrect arguments for function {fname}(). Argument {argn} was "
        f"the wrong type. Expected `geometry` but found `{render(v)}`"
    )


@register("geo::distance")
def _geo_distance(args, ctx):
    a = _pt(args[0], "geo::distance", 1)
    b = _pt(args[1], "geo::distance", 2)
    if a is None or b is None:
        return NONE
    (lon1, lat1) = a
    (lon2, lat2) = b
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return _EARTH_R * 2 * math.atan2(math.sqrt(a), math.sqrt(1 - a))


@register("geo::bearing")
def _geo_bearing(args, ctx):
    a = _pt(args[0], "geo::bearing", 1)
    b = _pt(args[1], "geo::bearing", 2)
    if a is None or b is None:
        return NONE
    (lon1, lat1) = a
    (lon2, lat2) = b
    # geo crate Haversine::bearing op order: radians per coordinate,
    # delta in radians, then rem_euclid(360) — the reference folds
    # values > 180 back to the [-180, 180] range
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dl = math.radians(lon2) - math.radians(lon1)
    x = math.sin(dl) * math.cos(p2)
    y = math.cos(p1) * math.sin(p2) - math.sin(p1) * math.cos(p2) * math.cos(dl)
    deg = math.degrees(math.atan2(x, y)) % 360.0
    return deg - 360.0 if deg > 180.0 else deg


def _ring_centroid(ring):
    """Polygon ring centroid: triangle fan translated to the first vertex
    (geo crate Centroid — the translation keeps float bits identical)."""
    pts = [(float(p[0]), float(p[1])) for p in ring]
    if len(pts) > 1 and pts[0] == pts[-1]:
        pts = pts[:-1]
    if len(pts) < 3:
        return None
    x0, y0 = pts[0]
    area = cx = cy = 0.0
    for i in range(1, len(pts) - 1):
        dx1, dy1 = pts[i][0] - x0, pts[i][1] - y0
        dx2, dy2 = pts[i + 1][0] - x0, pts[i + 1][1] - y0
        a = dx1 * dy2 - dx2 * dy1
        area += a
        cx += a * (dx1 + dx2)
        cy += a * (dy1 + dy2)
    if area == 0.0:
        return None
    return x0 + cx / (3.0 * area), y0 + cy / (3.0 * area)


@register("geo::centroid")
def _geo_centroid(args, ctx):
    from surrealdb_tpu_torch.exec.operators import _points_of

    from surrealdb_tpu_torch.val import render as _r

    v = _as_geom(args[0])
    if not isinstance(v, Geometry):
        raise SdbError(
            "Incorrect arguments for function geo::centroid(). Argument 1 "
            f"was the wrong type. Expected `geometry` but found `{_r(v)}`"
        )
    if v.kind == "Polygon" and v.coords:
        c = _ring_centroid(v.coords[0])
        if c is not None:
            return Geometry("Point", c)
    pts = _points_of(v)
    if not pts:
        return NONE
    xs = sum(float(p[0]) for p in pts) / len(pts)
    ys = sum(float(p[1]) for p in pts) / len(pts)
    return Geometry("Point", (xs, ys))


@register("geo::area")
def _geo_area(args, ctx):
    from surrealdb_tpu_torch.val import render as _r

    v = _as_geom(args[0])
    if not isinstance(v, Geometry):
        raise SdbError(
            "Incorrect arguments for function geo::area(). Argument 1 was "
            f"the wrong type. Expected `geometry` but found `{_r(v)}`"
        )

    def ring_area(ring):
        # chamberlain-duquette (geo crate): sum over vertices of
        # rad(x_next - x_prev) * sin(rad(y)), WGS84 equatorial radius
        pts = [(float(p[0]), float(p[1])) for p in ring]
        if len(pts) > 1 and pts[0] == pts[-1]:
            pts = pts[:-1]
        n = len(pts)
        if n < 3:
            return 0.0
        s = 0.0
        for i in range(n):
            x_prev = pts[i - 1][0]
            x_next = pts[(i + 1) % n][0]
            s += math.radians(x_next - x_prev) * math.sin(
                math.radians(pts[i][1])
            )
        return abs(s) * 6378137.0 * 6378137.0 / 2

    if v.kind == "Polygon":
        area = ring_area(v.coords[0]) if v.coords else 0.0
        for hole in v.coords[1:]:
            area -= ring_area(hole)
        return area
    if v.kind == "MultiPolygon":
        return sum(
            _geo_area([Geometry("Polygon", p)], ctx) for p in v.coords
        )
    return 0.0


_GH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


@register("geo::hash::encode")
def _geohash_encode(args, ctx):
    a = _pt(args[0], "geo::hash::encode", 1)
    if a is None:
        return NONE
    lon, lat = a
    precision = int(args[1]) if len(args) > 1 else 12
    if not 1 <= precision <= 12:
        raise SdbError(
            "Incorrect arguments for function geo::hash::encode(). The "
            "second argument must be an integer greater than 0 and less "
            "than or equal to 12."
        )
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    bits, bit, ch = 0, 0, 0
    even = True
    out = []
    while len(out) < precision:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon > mid:
                ch |= 1 << (4 - bit)
                lon_r[0] = mid
            else:
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat > mid:
                ch |= 1 << (4 - bit)
                lat_r[0] = mid
            else:
                lat_r[1] = mid
        even = not even
        if bit < 4:
            bit += 1
        else:
            out.append(_GH32[ch])
            bit, ch = 0, 0
    return "".join(out)


@register("geo::hash::decode")
def _geohash_decode(args, ctx):
    if not isinstance(args[0], str):
        return NONE
    s = args[0]
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    even = True
    for c in s:
        cd = _GH32.index(c)
        for mask in (16, 8, 4, 2, 1):
            r = lon_r if even else lat_r
            mid = (r[0] + r[1]) / 2
            if cd & mask:
                r[0] = mid
            else:
                r[1] = mid
            even = not even
    return Geometry("Point", ((lon_r[0] + lon_r[1]) / 2, (lat_r[0] + lat_r[1]) / 2))


@register("geo::is::valid")
def _geo_valid(args, ctx):
    v = args[0]
    if not isinstance(v, Geometry):
        return False
    from surrealdb_tpu_torch.exec.operators import _points_of

    return all(
        -180 <= float(p[0]) <= 180 and -90 <= float(p[1]) <= 90
        for p in _points_of(v)
    )


# -- session ------------------------------------------------------------------


@register("session::ac")
def _s_ac(args, ctx):
    return ctx.session.ac if ctx.session.ac else NONE


@register("session::db")
def _s_db(args, ctx):
    return ctx.session.db if ctx.session.db else NONE


@register("session::ns")
def _s_ns(args, ctx):
    return ctx.session.ns if ctx.session.ns else NONE


@register("session::id")
def _s_id(args, ctx):
    return NONE


@register("session::ip")
def _s_ip(args, ctx):
    return NONE


@register("session::origin")
def _s_origin(args, ctx):
    return NONE


@register("session::rd")
def _s_rd(args, ctx):
    return ctx.session.rid if ctx.session.rid else NONE


@register("session::token")
def _s_token(args, ctx):
    return ctx.vars.get("token", NONE)


# -- sequence -----------------------------------------------------------------


@register("sequence::nextval")
def _nextval(args, ctx):
    """Batch-allocated distributed sequences (kvs/sequences.rs:1-20):
    each node transactionally claims a BATCH-sized id range from the KV
    state row in its OWN transaction, then hands ids out locally — so
    concurrent nodes contend once per batch, not once per id, and ids
    survive the calling statement's rollback (reference semantics)."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.kvs.mem import CONFLICT_MSG

    name = _str(args[0], "sequence::nextval", 1)
    ns, db = ctx.need_ns_db()
    kdef = K.seq_state(ns, db, name)
    skey = (ns, db, name)
    with ctx.ds.lock:
        rng = ctx.ds.sequences.get(skey)
        if rng is not None and rng[0] < rng[1]:
            v = rng[0]
            rng[0] += 1
            return v
    st = ctx.txn.get_val(kdef)
    if st is None:
        raise SdbError(f"The sequence '{name}' does not exist")
    tmo = getattr(st[0], "timeout", None)
    deadline = None
    if tmo is not None and getattr(tmo, "ns", None) is not None:
        import time as _time

        # batch allocation respects the sequence's TIMEOUT (reference
        # kvs/sequences.rs; a 0ns timeout can never allocate)
        if tmo.ns == 0:
            raise SdbError(
                "The query was not executed because it exceeded the "
                f"timeout: {tmo.render()}"
            )
        deadline = _time.monotonic() + tmo.ns / 1e9
    for _ in range(16):
        if deadline is not None:
            import time as _time

            if _time.monotonic() > deadline:
                raise SdbError(
                    "The query was not executed because it exceeded the "
                    f"timeout: {tmo.render()}"
                )
        txn = ctx.ds.transaction(write=True)
        try:
            st2 = txn.get_val(kdef)
            if st2 is None:
                # defined inside the caller's still-uncommitted txn:
                # allocate through that txn (single-node bootstrap case)
                txn.cancel()
                sd, current = st
                ctx.txn.set_val(kdef, (sd, current + 1))
                return current
            sd, current = st2
            batch = max(int(getattr(sd, "batch", 1000) or 1), 1)
            txn.set_val(kdef, (sd, current + batch))
            txn.commit()
            with ctx.ds.lock:
                ctx.ds.sequences[skey] = [current + 1, current + batch]
            return current
        except SdbError as e:
            txn.cancel()
            if str(e) != CONFLICT_MSG:
                raise
    raise SdbError(f"sequence '{name}' allocation contention")


# -- value --------------------------------------------------------------------


@register("value::chain")
def _vchain(args, ctx):
    # value.chain(|$v| ...) — apply a closure to any value (fnc/value.rs)
    from surrealdb_tpu_torch.exec.eval import call_closure
    from surrealdb_tpu_torch.val import Closure

    if len(args) != 2 or not isinstance(args[1], Closure):
        raise SdbError(
            "Incorrect arguments for function value::chain(). "
            "Expected a closure"
        )
    return call_closure(args[1], [args[0]], ctx)


@register("value::diff")
def _vdiff(args, ctx):
    from surrealdb_tpu_torch.utils.patch import diff

    return diff(args[0], args[1])


@register("value::patch")
def _vpatch(args, ctx):
    from surrealdb_tpu_torch.utils.patch import apply_patch

    return apply_patch(args[0], args[1])


# -- search -------------------------------------------------------------------


@register("search::score")
def _search_score(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_score

    return search_score(int(args[0]) if args else 0, ctx)


@register("search::highlight")
def _search_highlight(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_highlight

    return search_highlight(args, ctx)


@register("search::offsets")
def _search_offsets(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_offsets

    return search_offsets(args, ctx)


@register("search::analyze")
def _search_analyze(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import analyze_text

    az = _str(args[0], "search::analyze", 1)
    return analyze_text(az, _str(args[1], "search::analyze", 2), ctx)


@register("search::rrf")
def _search_rrf(args, ctx):
    """Reciprocal-rank fusion of result-object arrays keyed on `id`
    (reference fnc search::rrf: merged fields + rrf_score)."""
    lists = args[0] if args else []
    limit = args[1] if len(args) > 1 else None
    k = args[2] if len(args) > 2 else 60
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "limit must be at least 1"
        )
    if not isinstance(k, (int, float)) or isinstance(k, bool) or k < 0:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "RRF constant must be at least 0"
        )
    from surrealdb_tpu_torch.val import hashable

    scores: dict = {}
    merged: dict = {}
    order: list = []
    for lst in lists or []:
        if not isinstance(lst, list):
            continue
        for rank, item in enumerate(lst):
            if not isinstance(item, dict):
                continue
            h = hashable(item.get("id", rank))
            if h not in merged:
                merged[h] = dict(item)
                order.append(h)
            else:
                merged[h].update(item)
            scores[h] = scores.get(h, 0.0) + 1.0 / (k + rank + 1)
    out = sorted(order, key=lambda h: -scores[h])[: int(limit)]
    res = []
    for h in out:
        row = merged[h]
        row["rrf_score"] = scores[h]
        res.append(row)
    return res


@register("search::linear")
def _search_linear(args, ctx):
    """Weighted linear fusion with per-list score normalization
    (reference fnc search::linear: minmax/zscore + linear_score)."""
    lists = args[0] if args else []
    weights = args[1] if len(args) > 1 else []
    limit = args[2] if len(args) > 2 else None
    norm = args[3] if len(args) > 3 else "minmax"
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Limit must be at least 1"
        )
    if norm not in ("minmax", "zscore"):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Norm must be 'minmax' or 'zscore'"
        )
    if not isinstance(lists, list) or not isinstance(weights, list) or \
            len(lists) != len(weights):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "The results and the weights array should have the same length"
        )
    for i, w in enumerate(weights):
        if isinstance(w, bool) or not isinstance(w, (int, float, Decimal)):
            raise SdbError(
                "Incorrect arguments for function search::linear(). "
                f"Weight at index {i} must be a number"
            )
    from surrealdb_tpu_torch.val import hashable

    # mirrors the reference's exact float op order (fnc/search.rs:380-537)
    # so normalized scores match bit-for-bit: per-doc raw score is
    # distance→1/(1+d) | ft_score | score | rank fallback 1/(1+count);
    # params per list, then weighted combination over score>0 entries
    n_lists = len(lists)
    documents: dict = {}  # h -> [scores_per_list, merged_obj]
    order: list = []
    count = 0
    for list_idx, lst in enumerate(lists):
        if not isinstance(lst, list):
            continue
        for item in lst:
            if not isinstance(item, dict) or "id" not in item:
                continue
            d = item.get("distance")
            fts = item.get("ft_score")
            sc = item.get("score")
            if isinstance(d, (int, float, Decimal)) and \
                    not isinstance(d, bool):
                score = 1.0 / (1.0 + float(d))
            elif isinstance(fts, (int, float, Decimal)) and \
                    not isinstance(fts, bool):
                score = float(fts)
            elif isinstance(sc, (int, float, Decimal)) and \
                    not isinstance(sc, bool):
                score = float(sc)
            else:
                score = 1.0 / (1.0 + count)
            h = hashable(item.get("id"))
            if h not in documents:
                documents[h] = [[0.0] * n_lists, dict(item)]
                order.append(h)
            else:
                documents[h][1].update(item)
            documents[h][0][list_idx] = score
            count += 1
    # per-list normalization params over scores > 0
    params = []
    for list_idx in range(n_lists):
        vals = [doc[0][list_idx] for doc in documents.values()
                if doc[0][list_idx] > 0.0]
        if not vals:
            params.append((0.0, 1.0))
            continue
        if norm == "minmax":
            lo = min(vals)
            rng = max(vals) - lo
            params.append((lo, rng if rng > 0.0 else 1.0))
        else:
            mean = sum(vals) / len(vals)
            var = sum((x - mean) ** 2 for x in vals) / len(vals)
            sd = var ** 0.5
            params.append((mean, sd if sd > 0.0 else 1.0))
    combined: dict = {}
    for h in order:
        scores_l, _obj = documents[h]
        total = 0.0
        for list_idx, score in enumerate(scores_l):
            if score > 0.0:
                w = weights[list_idx] if list_idx < len(weights) else 1.0
                a, b = params[list_idx]
                total += float(w) * ((score - a) / b)
        combined[h] = total
    out = sorted(order, key=lambda h: -combined[h])[: int(limit)]
    res = []
    for h in out:
        row = documents[h][1]
        row["linear_score"] = combined[h]
        res.append(row)
    return res


def _http_call(method):
    def call(args, ctx):
        from urllib.parse import urlparse

        url = _str(args[0], f"http::{method}", 1)
        parsed = urlparse(url)
        host = parsed.hostname or ""
        target = f"{host}:{parsed.port}" if parsed.port else host
        caps = getattr(ctx.ds, "capabilities", None)
        # network access is deny-by-default (reference capability gate)
        if caps is None or not caps.allows_net(target):
            raise SdbError(
                f"Access to network target '{target}' is not allowed"
            )
        import json as _json
        import urllib.request

        body = args[1] if len(args) > 1 else None
        headers = args[2] if len(args) > 2 else {}
        data = None
        req_headers = dict(headers) if isinstance(headers, dict) else {}
        if body is not None and body is not NONE and method in (
            "put", "post", "patch"
        ):
            if isinstance(body, (dict, list)):
                data = _json.dumps(to_json(body)).encode()
                req_headers.setdefault("Content-Type", "application/json")
            elif isinstance(body, bytes):
                data = body
            else:
                data = str(body).encode()
        req = urllib.request.Request(
            url, method=method.upper(), data=data, headers=req_headers
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                raw = resp.read()
                if method == "head":
                    return NONE
                ctype = resp.headers.get("Content-Type", "")
                if "json" in ctype:
                    try:
                        return _json.loads(raw)
                    except ValueError:
                        pass
                try:
                    return raw.decode()
                except UnicodeDecodeError:
                    return raw
        except Exception as e:
            raise SdbError(f"There was an error processing a remote HTTP request: {e}")

    return call


for _m in ("head", "get", "put", "post", "patch", "delete"):
    register(f"http::{_m}")(_http_call(_m))


@register("api::invoke")
def _api_invoke(args, ctx):
    """Invoke a DEFINE API endpoint through the full middleware engine
    (reference core/src/api/mod.rs)."""
    from surrealdb_tpu_torch.api import invoke as _invoke

    path = _str(args[0], "api::invoke", 1)
    opts = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    return _invoke(ctx, path, opts)


@register("file::bucket")
def _file_bucket(args, ctx):
    from surrealdb_tpu_torch.val import File

    v = args[0]
    if isinstance(v, File):
        return v.bucket
    raise SdbError("Incorrect arguments for function file::bucket(). Expected a file")


@register("file::key")
def _file_key(args, ctx):
    from surrealdb_tpu_torch.val import File

    v = args[0]
    if isinstance(v, File):
        return v.key
    raise SdbError("Incorrect arguments for function file::key(). Expected a file")


# -- file:: bucket operations (reference core/src/buc/ + fnc file ops) ------


def _file_arg(args, fname):
    from surrealdb_tpu_torch.val import File

    v = args[0] if args else NONE
    if not isinstance(v, File):
        raise SdbError(
            f"Incorrect arguments for function file::{fname}(). Expected a file"
        )
    return v


def _as_bytes(v, fname):
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, list) and all(
        isinstance(x, int) and not isinstance(x, bool) and 0 <= x < 256
        for x in v
    ):
        return bytes(v)  # int arrays coerce to bytes (reference file ops)
    raise SdbError(
        f"Incorrect arguments for function file::{fname}(). "
        f"Expected bytes or string data"
    )


@register("file::put")
def _file_put(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "put")
    get_bucket(f.bucket, ctx, for_write=True).put(
        f.key, _as_bytes(args[1] if len(args) > 1 else NONE, "put")
    )
    return NONE


@register("file::put_if_not_exists")
def _file_put_ine(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "put_if_not_exists")
    get_bucket(f.bucket, ctx, for_write=True).put_if_not_exists(
        f.key, _as_bytes(args[1] if len(args) > 1 else NONE,
                         "put_if_not_exists")
    )
    return NONE


@register("file::get")
def _file_get(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "get")
    data = get_bucket(f.bucket, ctx).get(f.key)
    return NONE if data is None else data


@register("file::head")
def _file_head(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "head")
    meta = get_bucket(f.bucket, ctx).head(f.key)
    return NONE if meta is None else meta


@register("file::exists")
def _file_exists(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "exists")
    return get_bucket(f.bucket, ctx).exists(f.key)


@register("file::delete")
def _file_delete(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    f = _file_arg(args, "delete")
    get_bucket(f.bucket, ctx, for_write=True).delete(f.key)
    return NONE


def _dst_target(args, fname):
    """Destination (bucket|None, key): a string stays in the source bucket,
    a File may point into another bucket (cross-bucket copy/rename)."""
    v = args[1] if len(args) > 1 else NONE
    from surrealdb_tpu_torch.val import File as _File

    if isinstance(v, _File):
        return v.bucket, v.key
    if isinstance(v, str):
        return None, (v if v.startswith("/") else "/" + v)
    raise SdbError(
        f"Incorrect arguments for function file::{fname}(). Expected a key"
    )


def _copy_like(ctx, f, args, fname, if_not_exists=False,
               idempotent_missing=False, remove_src=False):
    from surrealdb_tpu_torch.buc import get_bucket

    src = get_bucket(f.bucket, ctx, for_write=remove_src)
    dbucket, dkey = _dst_target(args, fname)
    if dbucket is None or dbucket == f.bucket:
        if remove_src:
            src.rename(f.key, dkey, if_not_exists=if_not_exists)
        else:
            src.copy(f.key, dkey, if_not_exists=if_not_exists,
                     idempotent_missing=idempotent_missing)
        return
    dst = get_bucket(dbucket, ctx, for_write=True)
    data = src.get(f.key)
    if data is None:
        if idempotent_missing:
            return
        src._missing_source(f.key)
    if if_not_exists and dst.exists(dkey):
        return
    dst.put(dkey, data)
    if remove_src:
        src.delete(f.key)


@register("file::copy")
def _file_copy(args, ctx):
    f = _file_arg(args, "copy")
    _copy_like(ctx, f, args, "copy")
    return NONE


@register("file::copy_if_not_exists")
def _file_copy_ine(args, ctx):
    f = _file_arg(args, "copy_if_not_exists")
    _copy_like(ctx, f, args, "copy_if_not_exists", if_not_exists=True,
               idempotent_missing=True)
    return NONE


@register("file::rename")
def _file_rename(args, ctx):
    f = _file_arg(args, "rename")
    _copy_like(ctx, f, args, "rename", remove_src=True)
    return NONE


@register("file::rename_if_not_exists")
def _file_rename_ine(args, ctx):
    f = _file_arg(args, "rename_if_not_exists")
    _copy_like(ctx, f, args, "rename_if_not_exists", if_not_exists=True,
               remove_src=True)
    return NONE


@register("file::list")
def _file_list(args, ctx):
    from surrealdb_tpu_torch.buc import get_bucket

    name = args[0] if args else NONE
    if not isinstance(name, str):
        raise SdbError(
            "Incorrect arguments for function file::list(). Expected a "
            "bucket name"
        )
    opts = args[1] if len(args) > 1 and isinstance(args[1], dict) else None
    return get_bucket(name, ctx).list(opts)
