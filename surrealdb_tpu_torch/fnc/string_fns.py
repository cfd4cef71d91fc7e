"""string:: functions (reference: core/src/fnc/string.rs)."""

from __future__ import annotations

import re as _re

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _arr, _num, _str, register
from surrealdb_tpu_torch.val import NONE, Datetime, RecordId, Regex, Uuid


@register("string::capitalize")
def _capitalize(args, ctx):
    s = _str(args[0], "string::capitalize", 1)
    out = []
    prev_ws = True
    for ch in s:
        if prev_ws and ch.islower():
            out.append(ch.upper())
        else:
            out.append(ch)
        prev_ws = ch.isspace()
    return "".join(out)


@register("string::concat")
def _concat(args, ctx):
    from surrealdb_tpu_torch.exec.operators import to_string

    return "".join(to_string(a) for a in args)


@register("string::contains")
def _contains(args, ctx):
    return _str(args[1], "string::contains", 2) in _str(args[0], "string::contains", 1)


@register("string::ends_with")
def _ends(args, ctx):
    return _str(args[0], "f", 1).endswith(_str(args[1], "f", 2))


FUNCS_endsWith = _ends


@register("string::starts_with")
def _starts(args, ctx):
    return _str(args[0], "f", 1).startswith(_str(args[1], "f", 2))


@register("string::join")
def _join(args, ctx):
    from surrealdb_tpu_torch.exec.operators import to_string

    sep = _str(args[0], "string::join", 1)
    return sep.join(to_string(a) for a in args[1:])


@register("string::len")
def _len(args, ctx):
    return len(_str(args[0], "string::len", 1))


@register("string::lowercase")
def _lower(args, ctx):
    return _str(args[0], "string::lowercase", 1).lower()


@register("string::uppercase")
def _upper(args, ctx):
    return _str(args[0], "string::uppercase", 1).upper()


@register("string::matches")
def _matches(args, ctx):
    s = _str(args[0], "string::matches", 1)
    p = args[1]
    if isinstance(p, Regex):
        return p.rx.search(s) is not None
    return _re.search(p, s) is not None


@register("string::repeat")
def _repeat(args, ctx):
    return _str(args[0], "string::repeat", 1) * int(_num(args[1], "string::repeat", 2))


@register("string::replace")
def _replace(args, ctx):
    s = _str(args[0], "string::replace", 1)
    old = args[1]
    new = _str(args[2], "string::replace", 3) if len(args) > 2 else ""
    if isinstance(old, Regex):
        out = old.rx.sub(new, s)
    else:
        out = s.replace(_str(old, "string::replace"), new)
    if len(out.encode()) > 1048576 and len(out) > len(s):
        raise SdbError(
            "Incorrect arguments for function string::replace(). Output "
            "must not exceed 1048576 bytes."
        )
    return out


@register("string::reverse")
def _reverse(args, ctx):
    return _str(args[0], "string::reverse", 1)[::-1]


@register("string::slice")
def _slice(args, ctx):
    s = _str(args[0], "string::slice", 1)
    beg = int(args[1]) if len(args) > 1 else 0
    n = int(args[2]) if len(args) > 2 else None
    if beg < 0:
        beg += len(s)
    if n is None:
        return s[beg:]
    if n < 0:
        return s[beg : len(s) + n]
    return s[beg : beg + n]


@register("string::slug")
def _slug(args, ctx):
    s = _str(args[0], "string::slug", 1).lower()
    s = _re.sub(r"[^a-z0-9]+", "-", s)
    return s.strip("-")


@register("string::split")
def _split(args, ctx):
    s = _str(args[0], "string::split", 1)
    sep = _str(args[1], "string::split", 2)
    if sep == "":
        return list(s)
    return s.split(sep)


@register("string::trim")
def _trim(args, ctx):
    return _str(args[0], "string::trim", 1).strip()


@register("string::words")
def _words(args, ctx):
    return _str(args[0], "string::words", 1).split()


_HTML_ENC = {
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;",
    "'": "&#39;", "`": "&#96;", "/": "&#47;", "=": "&#61;",
    " ": "&#32;", "\n": "&#10;", "\r": "&#13;", "\t": "&#9;",
}


@register("string::html::encode")
def _html_encode(args, ctx):
    # reference: ammonia::clean_text — named entities for markup chars,
    # numeric references for separators/attribute-breaking chars
    return "".join(
        _HTML_ENC.get(c, c) for c in _str(args[0], "f", 1)
    )


@register("string::html::sanitize")
def _html_sanitize(args, ctx):
    return _re.sub(r"<[^>]*script[^>]*>.*?</[^>]*script[^>]*>", "",
                   _str(args[0], "f", 1), flags=_re.S | _re.I)


# -- is:: ---------------------------------------------------------------------

_EMAIL_RX = _re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")
_HEX_RX = _re.compile(r"^(0x)?[0-9a-fA-F]+$")
_NUMERIC_RX = _re.compile(r"^[+-]?\d+(\.\d+)?$")
_SEMVER_RX = _re.compile(
    r"^(0|[1-9]\d*)\.(0|[1-9]\d*)\.(0|[1-9]\d*)"
    r"(?:-((?:0|[1-9]\d*|\d*[a-zA-Z-][0-9a-zA-Z-]*)"
    r"(?:\.(?:0|[1-9]\d*|\d*[a-zA-Z-][0-9a-zA-Z-]*))*))?"
    r"(?:\+([0-9a-zA-Z-]+(?:\.[0-9a-zA-Z-]+)*))?$"
)
_ULID_RX = _re.compile(r"^[0-7][0-9A-HJKMNP-TV-Z]{25}$")
_UUID_RX = _re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$"
)


def _is(name, fn):
    @register(f"string::is::{name}")
    def _f(args, ctx, fn=fn):
        v = args[0]
        if not isinstance(v, str) or v == "":
            return False
        return fn(v)


_is("alphanum", lambda s: bool(s) and s.isalnum())
_is("alpha", lambda s: bool(s) and s.isalpha())
_is("ascii", lambda s: s.isascii())
_is("hexadecimal", lambda s: bool(_HEX_RX.match(s)))
_is("numeric", lambda s: bool(_NUMERIC_RX.match(s)))
_ATEXT = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    "!#$%&'*+-/=?^_`{|}~"
)


def _is_email_addr(s: str) -> bool:
    """RFC 5321 addr-spec shape (reference links the `addr` crate):
    dot-atom local part, dot-atom domain or [address literal]."""
    at = s.rfind("@")
    if at <= 0 or at == len(s) - 1:
        return False
    local, domain = s[:at], s[at + 1:]
    for seg in local.split("."):
        if not seg or any(c not in _ATEXT for c in seg):
            return False
    if domain.startswith("[") and domain.endswith("]"):
        return len(domain) > 2  # address literal (IPv6: / IPv4)
    for seg in domain.split("."):
        if not seg or seg.startswith("-") or seg.endswith("-"):
            return False
        if not all(c.isalnum() or c == "-" for c in seg):
            return False
    return True


_is("email", _is_email_addr)
_is("semver", lambda s: bool(_SEMVER_RX.match(s)))
_is("ulid", lambda s: bool(_ULID_RX.match(s)))
_is("uuid", lambda s: bool(_UUID_RX.match(s)))
_is("url", lambda s: bool(_re.match(r"^[a-zA-Z][a-zA-Z0-9+.-]*://[^\s]+$", s)))
def _is_domain(s):
    # internationalized labels validate through their punycode form
    if not s.isascii():
        try:
            s = s.encode("idna").decode()
        except UnicodeError:
            return False
    return bool(_re.match(
        r"^([a-zA-Z0-9]([a-zA-Z0-9-]{0,61}[a-zA-Z0-9])?\.)+[a-zA-Z0-9-]{2,}$",
        s,
    ))


_is("domain", _is_domain)
_is("ip", lambda s: _is_ip(s))
_is("ipv4", lambda s: _is_ipv4(s))
_is("ipv6", lambda s: _is_ipv6(s))
_is("latitude", lambda s: _is_float_in(s, -90, 90))
_is("longitude", lambda s: _is_float_in(s, -180, 180))


def _is_ipv4(s):
    import ipaddress

    try:
        ipaddress.IPv4Address(s)
        return True
    except ValueError:
        return False


def _is_ipv6(s):
    import ipaddress

    try:
        ipaddress.IPv6Address(s)
        return True
    except ValueError:
        return False


def _is_ip(s):
    return _is_ipv4(s) or _is_ipv6(s)


def _is_float_in(s, lo, hi):
    try:
        return lo <= float(s) <= hi
    except ValueError:
        return False


@register("string::is::datetime")
def _is_datetime(args, ctx):
    s = args[0]
    fmt = args[1] if len(args) > 1 else None
    if not isinstance(s, str):
        return False
    if fmt:
        import datetime as _dt

        try:
            _dt.datetime.strptime(s, _strftime_of(fmt))
            return True
        except ValueError:
            return False
    try:
        Datetime.parse(s)
        return True
    except ValueError:
        return False


@register("string::is::record")
def _is_record(args, ctx):
    s = args[0]
    if isinstance(s, RecordId):
        return True
    if not isinstance(s, str):
        return False
    try:
        from surrealdb_tpu_torch.exec.static_eval import static_value
        from surrealdb_tpu_torch.syn.parser import parse_record_literal

        v = static_value(parse_record_literal(s))
        if len(args) > 1:
            want = args[1]
            tb = want.name if hasattr(want, "name") else want
            return v.tb == tb
        return True
    except Exception:
        return False


# -- similarity / distance ----------------------------------------------------


def _check_similarity_len(fname, a, b):
    """O(n*m) guard (reference fnc/string.rs check_similarity_input_length)."""
    from surrealdb_tpu_torch import cnf

    mx = cnf.FUNCTION_SIMILARITY_MAX_LENGTH
    if len(a) > mx or len(b) > mx:
        raise SdbError(
            f"Incorrect arguments for function {fname}(). Input strings "
            f"must not exceed {mx} bytes (got {len(a)} and {len(b)})."
        )


def _levenshtein(a, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@register("string::distance::levenshtein")
def _lev(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    _check_similarity_len("string::distance::levenshtein", a, b)
    return _levenshtein(a, b)


@register("string::distance::damerau_levenshtein")
def _dlev(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    _check_similarity_len("string::distance::damerau_levenshtein", a, b)
    da = {}
    maxdist = len(a) + len(b)
    d = [[maxdist] * (len(b) + 2) for _ in range(len(a) + 2)]
    for i in range(len(a) + 1):
        d[i + 1][1] = i
        d[i + 1][0] = maxdist
    for j in range(len(b) + 1):
        d[1][j + 1] = j
        d[0][j + 1] = maxdist
    for i in range(1, len(a) + 1):
        db = 0
        for j in range(1, len(b) + 1):
            k = da.get(b[j - 1], 0)
            l = db
            if a[i - 1] == b[j - 1]:
                cost = 0
                db = j
            else:
                cost = 1
            d[i + 1][j + 1] = min(
                d[i][j] + cost,
                d[i + 1][j] + 1,
                d[i][j + 1] + 1,
                d[k][l] + (i - k - 1) + 1 + (j - l - 1),
            )
        da[a[i - 1]] = i
    return d[len(a) + 1][len(b) + 1]


@register("string::distance::normalized_levenshtein")
def _nlev(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    m = max(len(a), len(b))
    return 1.0 - (_levenshtein(a, b) / m if m else 0.0)


@register("string::distance::normalized_damerau_levenshtein")
def _ndlev(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    m = max(len(a), len(b))
    if not m:
        return 1.0
    return 1.0 - _dlev(args, ctx) / m


@register("string::distance::osa_distance")
def _osa(args, ctx):
    """Optimal string alignment (restricted Damerau-Levenshtein,
    strsim::osa_distance)."""
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    la, lb = len(a), len(b)
    d = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la + 1):
        d[i][0] = i
    for j in range(lb + 1):
        d[0][j] = j
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] \
                    and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[la][lb]


@register("string::distance::hamming")
def _hamming(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    if len(a) != len(b):
        raise SdbError("Incorrect arguments for function string::distance::hamming(). Strings must be of equal length")
    return sum(x != y for x, y in zip(a, b))


def _jaro(a, b):
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if not la or not lb:
        return 0.0
    match_dist = max(la, lb) // 2 - 1
    a_matches = [False] * la
    b_matches = [False] * lb
    matches = 0
    for i in range(la):
        lo = max(0, i - match_dist)
        hi = min(lb, i + match_dist + 1)
        for j in range(lo, hi):
            if b_matches[j] or a[i] != b[j]:
                continue
            a_matches[i] = b_matches[j] = True
            matches += 1
            break
    if not matches:
        return 0.0
    t = 0
    k = 0
    for i in range(la):
        if a_matches[i]:
            while not b_matches[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    t /= 2
    return (matches / la + matches / lb + (matches - t) / matches) / 3


@register("string::similarity::jaro")
def _jaro_fn(args, ctx):
    return _jaro(_str(args[0], "f", 1), _str(args[1], "f", 2))


@register("string::similarity::jaro_winkler")
def _jw(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    j = _jaro(a, b)
    prefix = 0
    for x, y in zip(a, b):
        if x == y and prefix < 4:
            prefix += 1
        else:
            break
    return j + prefix * 0.1 * (1 - j)


@register("string::similarity::fuzzy")
def _fuzzy_sim(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    # fuzzy match score similar to the reference's fuzzy matcher: 0 if no
    # subsequence match, else a positive score
    from surrealdb_tpu_torch.exec.operators import _fuzzy

    if not _fuzzy(b.lower(), a.lower()):
        return 0
    return len(b)


@register("string::similarity::sorensen_dice")
def _sdice(args, ctx):
    """Sørensen–Dice coefficient over character bigrams
    (strsim::sorensen_dice)."""
    a = _str(args[0], "f", 1).replace(" ", "")
    b = _str(args[1], "f", 2).replace(" ", "")
    if a == b:
        return 1.0
    if len(a) < 2 or len(b) < 2:
        return 0.0
    from collections import Counter

    ba = Counter(a[i:i + 2] for i in range(len(a) - 1))
    bb = Counter(b[i:i + 2] for i in range(len(b) - 1))
    inter = sum((ba & bb).values())
    return 2.0 * inter / (sum(ba.values()) + sum(bb.values()))


@register("string::similarity::smithwaterman")
def _sw(args, ctx):
    a, b = _str(args[0], "f", 1), _str(args[1], "f", 2)
    prev = [0] * (len(b) + 1)
    best = 0
    for ca in a:
        cur = [0]
        for j, cb in enumerate(b, 1):
            score = max(
                0,
                prev[j - 1] + (2 if ca == cb else -1),
                prev[j] - 1,
                cur[j - 1] - 1,
            )
            cur.append(score)
            best = max(best, score)
        prev = cur
    return best


# -- semver -------------------------------------------------------------------


def _parse_semver(s):
    m = _SEMVER_RX.match(s)
    if not m:
        raise SdbError(f"Invalid semantic version: {s}")
    return m


@register("string::semver::compare")
def _semver_cmp(args, ctx):
    a = _parse_semver(_str(args[0], "f", 1))
    b = _parse_semver(_str(args[1], "f", 2))
    ka = (int(a[1]), int(a[2]), int(a[3]))
    kb = (int(b[1]), int(b[2]), int(b[3]))
    if ka != kb:
        return -1 if ka < kb else 1
    pa, pb = a[4], b[4]
    if pa == pb:
        return 0
    if pa is None:
        return 1
    if pb is None:
        return -1
    return -1 if pa < pb else 1


@register("string::semver::major")
def _semver_major(args, ctx):
    return int(_parse_semver(_str(args[0], "f", 1))[1])


@register("string::semver::minor")
def _semver_minor(args, ctx):
    return int(_parse_semver(_str(args[0], "f", 1))[2])


@register("string::semver::patch")
def _semver_patch(args, ctx):
    return int(_parse_semver(_str(args[0], "f", 1))[3])


@register("string::semver::inc::major")
def _semver_inc_major(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{int(m[1]) + 1}.0.0"


@register("string::semver::inc::minor")
def _semver_inc_minor(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{m[1]}.{int(m[2]) + 1}.0"


@register("string::semver::inc::patch")
def _semver_inc_patch(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{m[1]}.{m[2]}.{int(m[3]) + 1}"


@register("string::semver::set::major")
def _semver_set_major(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{int(args[1])}.{m[2]}.{m[3]}"


@register("string::semver::set::minor")
def _semver_set_minor(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{m[1]}.{int(args[1])}.{m[3]}"


@register("string::semver::set::patch")
def _semver_set_patch(args, ctx):
    m = _parse_semver(_str(args[0], "f", 1))
    return f"{m[1]}.{m[2]}.{int(args[1])}"


def _strftime_of(fmt: str) -> str:
    """Convert chrono-style format to strftime (common specifiers match)."""
    return fmt
