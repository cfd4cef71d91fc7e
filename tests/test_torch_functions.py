"""The parse::, encoding::, bytes::, geo:: and value:: functions of the
port (`surrealdb_tpu_torch/fnc/misc_fns.py`) against the reference's.

Each case is one `RETURN` of a table of inputs, error cases included,
through a reference and a port datastore (`torch_sql_harness.both`):
results and error texts must be equal. Tolerance: the harness's (floats
atol 1e-4, rtol 1e-5), and the geo:: cases besides compare their floats
with `==` (both packages run the same stdlib math in the same order).
A test of the registry holds its order to the reference's and the
names left in `fnc/unported.py` to the http::, api:: and file:: ones.
"""

import pytest

from torch_sql_harness import both, norm  # noqa: F401

URL = ("'https://user:pw@www.surrealdb.com:8080/path/../to/./page"
       "?query=a b&x=%20&y#frag'")

PARSE = [
    "parse::email::host('john.doe@example.com')",
    "parse::email::host('\"quoted@at\"@example.com')",
    "parse::email::host('no-at-sign')",
    "parse::email::host('a@[127.0.0.1]')",
    "parse::email::host('a@[::1]')",
    "parse::email::host('.a@b.com')",
    "parse::email::host('a@-b.com')",
    "parse::email::host(1)",
    "parse::email::user('john.doe@example.com')",
    "parse::email::user('a..b@example.com')",
    "parse::email::user('@example.com')",
    "parse::email::user(NONE)",
    f"parse::url::domain({URL})",
    f"parse::url::host({URL})",
    f"parse::url::fragment({URL})",
    f"parse::url::path({URL})",
    f"parse::url::port({URL})",
    f"parse::url::query({URL})",
    f"parse::url::scheme({URL})",
    "parse::url::path('http://x.com')",
    "parse::url::path('mailto:me@x.com')",
    "parse::url::host('http://[::1]:80/')",
    "parse::url::port('http://x.com:99999/')",
    "parse::url::port('http://x.com/')",
    "parse::url::scheme('not a url')",
    "parse::url::query('http://x.com/?a=%zz&b=c/d')",
    "parse::url::fragment('http://x.com/a/b/..')",
    "parse::url::domain(123)",
]

ENCODING = [
    "encoding::base64::encode('hello')",
    "encoding::base64::encode('hello', true)",
    "encoding::base64::encode(<bytes>'hi there')",
    "encoding::base64::encode(1)",
    "encoding::base64::decode('aGVsbG8')",
    "encoding::base64::decode('aGVsbG8=')",
    "encoding::base64::decode('!!!')",
    "encoding::base64::decode(5)",
    "string::base64_encode('surreal')",
    "string::base64_encode('surreal', true)",
    "encoding::json::encode({ a: 1, b: [1, 2.5, 'x', NONE, NULL, true], "
    "c: d'2024-01-01T00:00:00Z', d: 1.5dec, e: r'x:1', f: <set>[3, 1], "
    "g: 1h30m, h: 'ü' })",
    "encoding::json::encode('text')",
    "encoding::json::decode('{\"a\":[1,2.5,{\"b\":null}],\"c\":\"d\"}')",
    "encoding::json::decode('{bad')",
    "encoding::json::decode(1)",
    "encoding::cbor::encode({ a: 1, b: [-1, -300, 70000, 5000000000, 1.25, "
    "'x', NONE, NULL, true, false], c: <bytes>'raw', d: 2dec, "
    "e: d'2024-01-01T00:00:00Z', f: <set>[2, 1], g: r'x:1' })",
    "encoding::cbor::encode('')",
    "encoding::cbor::encode(-1)",
    "encoding::cbor::decode(encoding::cbor::encode({ a: [1, 'x', NONE, "
    "NULL, 1.5, <bytes>'b'], n: -70000 }))",
    # a map with an integer key, a tag, an f32 and an f16 (unsupported)
    "encoding::cbor::decode(encoding::base64::decode('ogFhYcEaAAAAAQ'))",
    "encoding::cbor::decode(encoding::base64::decode('+kAgAAA'))",
    "encoding::cbor::decode(encoding::base64::decode('+TwA'))",
    # indefinite length, truncated and bad UTF-8 inputs
    "encoding::cbor::decode(encoding::base64::decode('nwH/'))",
    "encoding::cbor::decode(encoding::base64::decode('ZGFi'))",
    "encoding::cbor::decode(encoding::base64::decode('YoCA'))",
    "encoding::cbor::decode(<bytes>'')",
    "encoding::cbor::decode('x')",
]

BYTES = [
    "bytes::len(<bytes>'abc')",
    "bytes::len(encoding::base64::decode('AAEC'))",
    "bytes::len(<bytes>'')",
    "bytes::len('abc')",
]

POLY = ("{ type: 'Polygon', coordinates: [[[-0.38, 51.43], [0.02, 51.47], "
        "[0.24, 51.60], [-0.12, 51.72], [-0.38, 51.43]], [[-0.1, 51.5], "
        "[0.0, 51.5], [0.0, 51.55], [-0.1, 51.5]]] }")
GEO = [
    "geo::distance((-0.04, 51.55), (30.46, -17.86))",
    "geo::distance((0, 0), (0, 0))",
    "geo::distance((170.5, 10), (-170.25, -10.75))",
    "geo::distance({ type: 'Point', coordinates: [1, 2] }, (3, 4))",
    f"geo::distance({POLY}, (3, 4))",
    "geo::distance('x', (3, 4))",
    "geo::distance((3, 4), 5)",
    "geo::bearing((-0.04, 51.55), (30.46, -17.86))",
    "geo::bearing((30.46, -17.86), (-0.04, 51.55))",
    "geo::bearing((0, 0), (-10, 0))",
    f"geo::bearing((1, 2), {POLY})",
    "geo::bearing(1, (1, 2))",
    f"geo::centroid({POLY})",
    "geo::centroid({ type: 'MultiPoint', coordinates: [[0, 0], [1, 3], "
    "[2.5, -1]] })",
    "geo::centroid({ type: 'LineString', coordinates: [[0, 0], [4, 2]] })",
    "geo::centroid({ type: 'Polygon', coordinates: [[[0, 0], [1, 1], "
    "[2, 2], [0, 0]]] })",
    "geo::centroid((1.5, 2.5))",
    "geo::centroid('x')",
    f"geo::area({POLY})",
    "geo::area({ type: 'MultiPolygon', coordinates: [[[[0, 0], [1, 0], "
    "[1, 1], [0, 1], [0, 0]]], [[[10, 10], [11, 10], [11, 12], [10, 10]]]] })",
    "geo::area((1, 2))",
    "geo::area({ type: 'Polygon', coordinates: [[[0, 0], [1, 1]]] })",
    "geo::area([1, 2])",
    "geo::hash::encode((-0.04, 51.55))",
    "geo::hash::encode((-0.04, 51.55), 5)",
    "geo::hash::encode((179.999, -89.999), 1)",
    "geo::hash::encode((-0.04, 51.55), 13)",
    "geo::hash::encode((-0.04, 51.55), 0)",
    f"geo::hash::encode({POLY})",
    "geo::hash::encode('x')",
    "geo::hash::decode('gcpuvpk44kpr')",
    "geo::hash::decode('u4pruyd')",
    "geo::hash::decode(1)",
    "geo::hash::decode('a')",
    "geo::is::valid((1, 2))",
    "geo::is::valid((200, 2))",
    f"geo::is::valid({POLY})",
    "geo::is::valid('x')",
]

VALUE = [
    "value::diff({ a: 1, b: [1, 2], d: { e: 'x' } }, "
    "{ a: 2, b: [1, 2, 3], c: 'x', d: { e: 'y' } })",
    "value::diff([1, 2, 3], [1, 3])",
    "value::diff('abc', 'abd')",
    "value::diff(1, 1)",
    "value::patch({ a: 1, b: [1] }, [{ op: 'replace', path: '/a', "
    "value: 2 }, { op: 'add', path: '/b/-', value: 5 }, { op: 'add', "
    "path: '/c', value: { d: 1 } }])",
    "value::patch({ a: 1 }, [{ op: 'remove', path: '/a' }])",
    "value::patch({ a: 1 }, [{ op: 'copy', from: '/a', path: '/b' }, "
    "{ op: 'move', from: '/a', path: '/c' }])",
    "value::patch({ a: 1 }, [{ op: 'test', path: '/a', value: 2 }])",
    "value::patch({ a: 1 }, [{ op: 'bogus', path: '/a' }])",
    "value::patch({ a: 1 }, 'x')",
    "value::patch({ a: 1 }, value::diff({ a: 1 }, { a: [1, { b: 2 }] }))",
    "value::chain(1, |$v| $v + 1)",
    "value::chain([1, 2], |$v| array::len($v) * 10)",
    "(5).chain(|$v| $v * 2)",
    "value::chain(1, 2)",
]

CASES = ([("parse", c) for c in PARSE] + [("encoding", c) for c in ENCODING]
         + [("bytes", c) for c in BYTES] + [("geo", c) for c in GEO]
         + [("value", c) for c in VALUE])


def _exact(a, b, path="$"):
    """The geo:: rule: every float equal to the last bit."""
    assert type(a) is type(b), f"{path}: {a!r} != {b!r}"
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _exact(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{path}: {a!r} != {b!r}"
        for k in a:
            _exact(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _geo_plain(v):
    """A result with each geometry as its kind and raw coordinates."""
    if type(v).__name__ == "Geometry":
        return ("geometry", v.kind, _geo_plain(v.coords))
    if isinstance(v, (list, tuple)):
        return [_geo_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _geo_plain(x) for k, x in v.items()}
    return norm(v)


@pytest.mark.parametrize("family,expr", CASES,
                         ids=[f"{f}-{i}" for i, (f, _e) in enumerate(CASES)])
def test_function_equals_reference(both, family, expr):
    sql = f"RETURN {expr}"
    out = both.run(sql)
    assert len(out) == 1
    err = out[0].error
    assert err is None or not err.startswith("Parse error"), err
    assert err is None or "not ported" not in err, err
    if family == "geo":
        r = both.ref.execute(sql, ns="t", db="t")[0]
        p = out[0]
        assert (r.error, p.error) == (r.error, r.error)
        if r.error is None:
            _exact(_geo_plain(r.result), _geo_plain(p.result))


def test_cbor_bytes_equal_reference(both):
    """`encoding::cbor::encode` gives the reference's bytes, and both
    packages decode each other's."""
    vals = "{ a: [1, -2, 3.5, 'x', NONE, NULL, true], b: <bytes>'z', " \
           "c: 1.25dec, d: d'2024-01-01T00:00:00Z', e: <set>[2, 1] }"
    r = both.ref.query(f"RETURN encoding::cbor::encode({vals})",
                       ns="t", db="t")[0]
    p = both.port.query(f"RETURN encoding::cbor::encode({vals})",
                        ns="t", db="t")[0]
    assert isinstance(p, bytes) and p == r
    dec = "RETURN encoding::cbor::decode($b)"
    assert norm(both.port.query(dec, ns="t", db="t", vars={"b": r})[0]) == \
        norm(both.ref.query(dec, ns="t", db="t", vars={"b": p})[0])


def test_registry_order_and_left_out_names():
    """The registry's order is the reference's, and the names left in
    `fnc/unported.py` are exactly the http::, api:: and file:: ones, in
    the reference's order; the five families are ported functions."""
    import surrealdb_tpu.fnc as R
    import surrealdb_tpu_torch.fnc as P
    from surrealdb_tpu_torch.fnc import unported

    assert list(R.FUNCS) == list(P.FUNCS)
    left = unported.UNPORTED_AFTER_SEARCH
    assert list(left) == [n for n in R.FUNCS
                          if n.startswith(("http::", "api::", "file::"))]
    fams = ("parse::", "encoding::", "bytes::", "geo::", "value::",
            "string::base64_encode")
    names = [n for n in P.FUNCS if n.startswith(fams)]
    # 27 names and geo::is_valid, the registry's alias of geo::is::valid
    assert len(names) == 28 and P.FUNCS["geo::is_valid"] is \
        P.FUNCS["geo::is::valid"]
    for n in names:
        assert P.FUNCS[n].__module__ == "surrealdb_tpu_torch.fnc.misc_fns", n
        assert not P.FUNCS[n].__qualname__.startswith("_unported"), n
