"""The port's models (`surrealdb_tpu_torch/ml/__init__.py`, the `ml::`
dispatch, /ml/import and /ml/export, `ml import|export`) against the
reference's `ml/` on the CPU, case for case with tests/test_ml.py.

The same bytes and inputs go through both packages: the surml container
and its hash in both directions, the four normalisers, raw and buffered
compute through each package's `Datastore.execute` on the linear, conv
and MLP graphs of `chip_smoke.py onnx_graphs()` (built at small widths,
the conv and pool graphs taking a flat row as `ml::` passes one) and on
the `"jax"` engine, the errors letter for letter (version required, the
capability gate, a corrupt import), case-sensitive names, the routes'
status codes and bodies, the CLI over one file datastore, and INFO FOR
DB, ALTER MODEL and REMOVE MODEL with a model imported.

Tolerance: ONNX outputs within atol 1e-5, rtol 1e-4 (the port runs the
graph with torch ops, in full f32); the `"jax"` engine, the normalisers,
bytes, hashes, error texts and status codes compare exactly. SQL results
also pass the harness's comparison (`torch_sql_harness.same`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from surrealdb_tpu import ml as RML
from surrealdb_tpu.err import SdbError as RefError
from surrealdb_tpu.server import make_server as ref_make_server
from surrealdb_tpu_torch import ml as PML
from surrealdb_tpu_torch.err import SdbError as PortError
from surrealdb_tpu_torch.server import make_server as port_make_server
from test_ml import _onnx_linear
from test_torch_server import Served, req
from torch_sql_harness import NS, DB, both, norm  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
NSDB = {"surreal-ns": NS, "surreal-db": DB}


@pytest.fixture()
def ml(both):
    """The harness's pair with the `ml` experimental capability on, as
    `SURREAL_CAPS_ALLOW_EXPERIMENTAL=ml` turns it on for a server."""
    for ds in (both.ref, both.port):
        ds.capabilities.allow_experimental.names.add("ml")
    return both


def _graphs():
    return chip_smoke.onnx_graphs(dim=16, hidden=32, batch=4, flat=True)


def _jax_layers(seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(3, 8)).astype(np.float32),
         rng.normal(size=(8,)).astype(np.float32), "relu"),
        (rng.normal(size=(8, 8)).astype(np.float32), None, "tanh"),
        (rng.normal(size=(8, 4)).astype(np.float32),
         rng.normal(size=(4,)).astype(np.float32), "sigmoid"),
        (rng.normal(size=(4, 3)).astype(np.float32), None, "softmax"),
        (rng.normal(size=(3, 2)).astype(np.float32), None, None),
    ]


NORMALISERS = {
    "a": {"type": "z_score", "mean": 3.0, "std_dev": 2.0},
    "b": {"type": "linear_scaling", "min": -1.0, "max": 7.0},
    "c": {"type": "log_standard", "base": 2.0},
}


def _containers(pkg):
    """name -> SurmlFile of one package, authored the same way."""
    g = _graphs()
    return {
        "jax": pkg.make_jax_model("prices", "1.0.0", ["a", "b", "c"],
                                  _jax_layers(), normalisers=NORMALISERS,
                                  description="a head"),
        "raw_onnx": pkg.SurmlFile.from_bytes(g["conv_bn_pool"][0]),
        "onnx": pkg.SurmlFile(
            {"name": "head", "version": "1.0.0", "columns": [],
             "normalisers": {}, "engine": "onnx"}, g["mlp_head_768"][0]),
    }


@pytest.mark.parametrize("kind", ["jax", "raw_onnx", "onnx"])
def test_surml_bytes_and_hash_cross_package(kind):
    ref, port = _containers(RML)[kind], _containers(PML)[kind]
    rb, pb = ref.to_bytes(), port.to_bytes()
    assert pb == rb and port.hash == ref.hash
    # each package loads the other's bytes, with the same header and hash
    back_p, back_r = PML.SurmlFile.from_bytes(rb), RML.SurmlFile.from_bytes(pb)
    assert back_p.header == back_r.header == ref.header
    assert back_p.hash == back_r.hash == ref.hash
    assert back_p.to_bytes() == back_r.to_bytes() == rb


VALUES = [-3.5, -1.0, 0.0, 1e-40, 0.5, 2.0, 7.0, 1e6]
ONE = {
    "linear_scaling": {"type": "linear_scaling", "min": -1.0, "max": 7.0},
    "linear_scaling_flat": {"type": "linear_scaling", "min": 2.0, "max": 2.0},
    "z_score": {"type": "z_score", "mean": 3.0, "std_dev": 2.0},
    "z_score_zero_sd": {"type": "z_score", "mean": 1.0, "std_dev": 0.0},
    "log_standard": {"type": "log_standard", "base": 2.0},
    "log_standard_default": {"type": "log_standard"},
    "clipping": {"type": "clipping", "min": -1.0, "max": 2.0},
    "clipping_open": {"type": "clipping", "max": 0.5},
    "unknown": {"type": "bogus"},
}


@pytest.mark.parametrize("name", list(ONE))
def test_normalisers(ml, name):
    """Each normaliser over a table of values, directly and through a
    buffered `ml::` call (identity weights: the call answers the
    normalised value)."""
    nz = {"x": ONE[name]}
    models = [pkg.make_jax_model("n", "1.0.0", ["x"],
                                 [(np.eye(1, dtype=np.float32), None, None)],
                                 normalisers=nz) for pkg in (RML, PML)]
    for v in VALUES:
        assert models[1]._normalise("x", v) == models[0]._normalise("x", v)
    RML.import_model(ml.ref, NS, DB, models[0].to_bytes())
    PML.import_model(ml.port, NS, DB, models[1].to_bytes())
    for v in VALUES:
        out = ml.run(f"RETURN ml::n<1.0.0>({{ x: {v!r} }})")
        ref = ml.ref.execute(f"RETURN ml::n<1.0.0>({{ x: {v!r} }})",
                             ns=NS, db=DB)[0]
        assert out[0].error == ref.error
        assert out[0].result == ref.result


GRAPH_CASES = ["linear", "conv_bn_pool", "gather_transpose_avgpool",
               "mlp_head_768"]


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_raw_compute_through_sql(ml, name):
    """Raw compute (an array argument) on each ONNX graph, through both
    packages' SQL: the rows of the feed one call each, and a table's
    rows in one SELECT."""
    model, feed = _graphs()[name]
    rows = np.asarray(feed["x"], np.float32)
    rows = rows.reshape(rows.shape[0] if rows.ndim > 1 else 1, -1)
    d_r = RML.import_model(ml.ref, NS, DB, model, name="g", version="1.0.0")
    d_p = PML.import_model(ml.port, NS, DB, model, name="g", version="1.0.0")
    assert (d_p.name, d_p.version, d_p.hash) == (d_r.name, d_r.version,
                                                 d_r.hash)
    for row in rows:
        out = ml.ok("RETURN ml::g<1.0.0>($x)", {"x": row.tolist()})[0]
        ref = ml.ref.query("RETURN ml::g<1.0.0>($x)", ns=NS, db=DB,
                           vars={"x": row.tolist()})[0]
        assert all(type(v) is float for v in out)
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    ml.ok("FOR $i IN 0..$n { CREATE type::record('r', $i) SET x = $xs[$i] }",
          {"n": len(rows), "xs": rows.tolist()})
    out = ml.ok("SELECT id, ml::g<1.0.0>(x) AS s FROM r")[0]
    ref = ml.ref.query("SELECT id, ml::g<1.0.0>(x) AS s FROM r",
                       ns=NS, db=DB)[0]
    assert norm([r["id"] for r in out]) == norm([r["id"] for r in ref])
    np.testing.assert_allclose([r["s"] for r in out], [r["s"] for r in ref],
                               atol=ATOL, rtol=RTOL)


def test_buffered_compute_onnx_and_number(ml):
    """An ONNX model with named columns and normalisers takes an object;
    a number is a one-element raw input."""
    lin = _onnx_linear(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32),
                       np.array([0.5, -0.5], np.float32))
    header = {"name": "lin", "version": "2.0.0", "columns": ["b", "a"],
              "normalisers": {"a": {"type": "clipping", "min": 0.0,
                                    "max": 1.0}},
              "engine": "onnx"}
    RML.import_model(ml.ref, NS, DB, RML.SurmlFile(header, lin).to_bytes())
    PML.import_model(ml.port, NS, DB, PML.SurmlFile(header, lin).to_bytes())
    one = _onnx_linear(np.array([[3.0]], np.float32),
                       np.array([1.0], np.float32))
    RML.import_model(ml.ref, NS, DB, one, name="one", version="1")
    PML.import_model(ml.port, NS, DB, one, name="one", version="1")
    ml.ok("RETURN ml::lin<2.0.0>({ a: 5, b: 2 }); "
          "RETURN ml::lin<2.0.0>({ a: 0.25, b: -1.5, c: 9 }); "
          "RETURN ml::lin<2.0.0>([1, 1]); RETURN ml::one<1>(2); "
          "RETURN ml::one<1>(2.5dec); RETURN ml::one<1>([4])")
    ml.run("RETURN ml::lin<2.0.0>({ a: 5 })")


def test_jax_engine(ml):
    """The `"jax"` engine: dense layers in f32 numpy, equal to the last
    bit; raw and buffered, and its errors."""
    ref = RML.make_jax_model("h", "1.0.0", ["a", "b", "c"], _jax_layers(),
                             normalisers=NORMALISERS)
    port = PML.make_jax_model("h", "1.0.0", ["a", "b", "c"], _jax_layers(),
                              normalisers=NORMALISERS)
    x = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    a, b = RML._jax_forward(ref.model, x), PML._jax_forward(port.model, x)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    RML.import_model(ml.ref, NS, DB, ref.to_bytes())
    PML.import_model(ml.port, NS, DB, port.to_bytes())
    out = ml.ok("RETURN ml::h<1.0.0>([0.5, -1, 2]); "
                "RETURN ml::h<1.0.0>({ a: 1, b: 2, c: 3 }); "
                "RETURN ml::h<1.0.0>({ c: 1.5, b: 0, a: -2 })")
    want = [ml.ref.query(s, ns=NS, db=DB)[0] for s in (
        "RETURN ml::h<1.0.0>([0.5, -1, 2])",
        "RETURN ml::h<1.0.0>({ a: 1, b: 2, c: 3 })",
        "RETURN ml::h<1.0.0>({ c: 1.5, b: 0, a: -2 })")]
    assert out == want
    for pkg, err, ds in ((RML, RefError, ml.ref), (PML, PortError, ml.port)):
        bad = pkg.make_jax_model("bad", "1", [], [(np.eye(2), None, None)])
        spec_bad = pkg.SurmlFile({**bad.header, "engine": "tpu"}, bad.model)
        pkg.import_model(ds, NS, DB, spec_bad.to_bytes(), name="eng")
    ml.run("RETURN ml::eng<1>([1, 2])")


@pytest.mark.parametrize("sql", [
    "RETURN ml::m([1])",
    "RETURN ml::Model([1, 2])",
    "RETURN ml::m<1.0.0>([1])",
    "RETURN ml::gone<1.0.0>([1])",
    "RETURN ml::m<1.0.0>([1], [2])",
    "RETURN ml::m<1.0.0>()",
    "RETURN ml::m<1.0.0>('x')",
    "RETURN ml::m<1.0.0>(['x'])",
    "RETURN ml::m<1.0.0>({ a: 'x' })",
    "RETURN ml::m<1.0.0>({ a: true })",
    "RETURN ml::m<1.0.0>(true)",
    "RETURN ml::m<1.0.0>({ b: 1 })",
])
@pytest.mark.parametrize("allowed", [False, True], ids=["gated", "allowed"])
def test_errors_letter_for_letter(both, sql, allowed):
    """The capability gate (ml not allowed), the version requirement and
    the argument errors: the same text in both packages."""
    if allowed:
        for ds in (both.ref, both.port):
            ds.capabilities.allow_experimental.names.add("ml")
    for pkg, ds in ((RML, both.ref), (PML, both.port)):
        pkg.import_model(ds, NS, DB, pkg.make_jax_model(
            "m", "1.0.0", ["a"], [(np.eye(1), None, None)]).to_bytes())
    out = both.run(sql)
    if not allowed:
        assert out[0].error == (
            "Problem with machine learning computation. Machine learning "
            "computation is not enabled.")
    elif sql == "RETURN ml::m([1])":
        assert out[0].error == (
            "Incorrect arguments for function ml::m(). A model version is "
            "required: ml::m<1.0.0>(...)")


def test_case_sensitive_names(ml):
    for pkg, ds in ((RML, ml.ref), (PML, ml.port)):
        pkg.import_model(ds, NS, DB, pkg.make_jax_model(
            "MyModel", "1.0.0", ["x"],
            [(np.array([[2.0]], np.float32), None, None)]).to_bytes())
    out = ml.run("RETURN ml::MyModel<1.0.0>([4]); "
                 "RETURN ml::mymodel<1.0.0>([4]); "
                 "RETURN ml::MYMODEL<1.0.0>([4])")
    assert out[0].result == [8.0]
    assert out[1].error == "The model 'ml::mymodel<1.0.0>' does not exist"


def _npz_without_spec():
    import io

    buf = io.BytesIO()
    np.savez(buf, w0=np.eye(2, dtype=np.float32))
    return buf.getvalue()


CORRUPT = {
    "truncated_varint": b"\x80\x80\x80",
    "short_header": b"SURMLTPU\x05",
    "header_not_object": b"SURMLTPU" + (3).to_bytes(4, "little") + b"[1]",
    "header_not_json": b"SURMLTPU" + (3).to_bytes(4, "little") + b"{x}",
    "wire_type": b"\x0f\x00",
    "no_graph": b"\x08\x01",
    "no_nodes": chip_smoke._pb_model([], {}, "x", "y"),
    "jax_not_npz": b"SURMLTPU" + (17).to_bytes(4, "little")
                   + b'{"engine": "jax"}' + b"garbage",
    "jax_no_spec": b"SURMLTPU" + (17).to_bytes(4, "little")
                   + b'{"engine": "jax"}' + _npz_without_spec(),
}


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_import_refused(ml, name):
    data = CORRUPT[name]
    with pytest.raises(RefError) as r:
        RML.import_model(ml.ref, NS, DB, data, name="bad", version="1.0.0")
    with pytest.raises(PortError) as p:
        PML.import_model(ml.port, NS, DB, data, name="bad", version="1.0.0")
    assert str(p.value) == str(r.value)
    ml.same_items()


def test_info_alter_remove_model(ml):
    """INFO FOR DB lists an imported model; ALTER MODEL and REMOVE
    MODEL answer what the reference answers."""
    f = [pkg.make_jax_model("m", "1.0.0", ["a"], [(np.eye(1), None, None)],
                            description="scores") for pkg in (RML, PML)]
    RML.import_model(ml.ref, NS, DB, f[0].to_bytes())
    PML.import_model(ml.port, NS, DB, f[1].to_bytes())
    RML.import_model(ml.ref, NS, DB, f[0].to_bytes(), version="2.0.0")
    PML.import_model(ml.port, NS, DB, f[1].to_bytes(), version="2.0.0")
    out = ml.ok("INFO FOR DB; INFO FOR DB STRUCTURE")
    models = out[0]["models"]
    assert list(models) == ["m<1.0.0>", "m<2.0.0>"]
    assert models["m<1.0.0>"] == "DEFINE MODEL ml::m<1.0.0> COMMENT " \
        "'scores' PERMISSIONS FULL"
    # the reference parses ALTER MODEL <name> (and changes nothing); its
    # parser refuses REMOVE MODEL and a versioned ALTER target
    for sql in ("ALTER MODEL m COMMENT 'x'",
                "ALTER MODEL IF EXISTS m COMMENT 'x'",
                "ALTER MODEL ml::m<1.0.0> COMMENT 'x'",
                "REMOVE MODEL ml::m<1.0.0>",
                "REMOVE MODEL IF EXISTS ml::m<9.9.9>", "REMOVE MODEL m"):
        ml.run(sql)
    assert ml.ok("INFO FOR DB")[0]["models"] == models
    assert ml.ok("RETURN ml::m<2.0.0>([3])")[0] == [3.0]
    ml.same_items()


@pytest.fixture()
def servers(ml):
    pair = (Served(ml.ref, ref_make_server), Served(ml.port, port_make_server))
    try:
        yield pair
    finally:
        for s in pair:
            s.close()


def _both(servers, path, method="GET", body=None, headers=NSDB):
    r = req(servers[0].base, path, method, body, headers)
    p = req(servers[1].base, path, method, body, headers)
    assert p[0] == r[0], (path, r, p)
    return r, p


def test_http_import_export(servers):
    """POST /ml/import and GET /ml/export/:name/:version over each
    package's server: the same status codes, bodies and bytes, and
    either package's upload exported by the other."""
    f = PML.make_jax_model("web", "0.1.0", ["x"],
                           [(np.array([[2.0]], np.float32), None, None)])
    r, p = _both(servers, "/ml/import", "POST", f.to_bytes())
    assert p[0] == 200 and json.loads(p[2]) == json.loads(r[2]) == {
        "name": "web", "version": "0.1.0", "hash": f.hash}
    r, p = _both(servers, "/ml/export/web/0.1.0")
    assert p[0] == 200 and p[2] == r[2] == f.to_bytes()
    assert p[1]["Content-Type"] == r[1]["Content-Type"]
    for path, code in (("/ml/export/web/9.9.9", 404),
                       ("/ml/export/web", 400),
                       ("/ml/export/web/0.1.0/x", 400)):
        r, p = _both(servers, path)
        assert p[0] == code and json.loads(p[2]) == json.loads(r[2])
    r, p = _both(servers, "/ml/export/web/0.1.0", headers={})
    assert p[0] == 400 and json.loads(p[2]) == json.loads(r[2])
    r, p = _both(servers, "/ml/import", "POST", f.to_bytes(),
                 headers={"surreal-ns": NS})
    assert p[0] == 400 and json.loads(p[2]) == json.loads(r[2])
    r, p = _both(servers, "/ml/import", "POST", b"\x80\x80\x80")
    assert p[0] == 400 and json.loads(p[2]) == json.loads(r[2])
    r, p = _both(servers, "/ml/other")
    assert p[0] == 404
    # the port serves a model the reference's server took, and back
    g = RML.make_jax_model("g", "1.0.0", ["x"],
                           [(np.array([[3.0]], np.float32), None, None)])
    req(servers[0].base, "/ml/import", "POST", g.to_bytes(), NSDB)
    raw = req(servers[0].base, "/ml/export/g/1.0.0", headers=NSDB)[2]
    st, _h, body = req(servers[1].base, "/ml/import", "POST", raw, NSDB)
    assert st == 200 and json.loads(body)["hash"] == g.hash
    st, _h, body = req(servers[1].base, "/sql", "POST",
                       "RETURN ml::g<1.0.0>([7])", NSDB)
    assert json.loads(body)[0]["result"] == [21.0]


def test_http_routes_secured(ml):
    """A server without --unauthenticated answers an anonymous model
    route with the reference's 401."""
    pair = (Served(ml.ref, ref_make_server, unauthenticated=False),
            Served(ml.port, port_make_server, unauthenticated=False))
    try:
        f = PML.make_jax_model("w", "1", ["x"], [(np.eye(1), None, None)])
        for path, method, body in (("/ml/import", "POST", f.to_bytes()),
                                   ("/ml/export/w/1", "GET", None)):
            r = req(pair[0].base, path, method, body, NSDB)
            p = req(pair[1].base, path, method, body, NSDB)
            assert p[0] == r[0] == 401
            assert json.loads(p[2]) == json.loads(r[2])
    finally:
        for s in pair:
            s.close()


def _cli(pkg, *argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", pkg, "ml", *argv], cwd=ROOT,
                          env=env, capture_output=True, timeout=120)


def test_cli_import_export(tmp_path):
    """`python -m surrealdb_tpu_torch ml import|export` against the
    reference's CLI on the same file datastore: each package exports
    what the other imported, byte for byte, and prints the same line."""
    f = PML.make_jax_model("cli", "1.2.3", ["x"],
                           [(np.array([[2.0]], np.float32), None, None)])
    src = tmp_path / "m.surml"
    src.write_bytes(f.to_bytes())
    raw = _onnx_linear(np.array([[1.0], [1.0]], np.float32),
                       np.array([0.0], np.float32))
    onnx = tmp_path / "m.onnx"
    onnx.write_bytes(raw)
    for imp, exp in (("surrealdb_tpu", "surrealdb_tpu_torch"),
                     ("surrealdb_tpu_torch", "surrealdb_tpu")):
        path = f"file://{tmp_path / imp}"
        outs = []
        for pkg in (imp, "surrealdb_tpu" if imp != "surrealdb_tpu"
                    else "surrealdb_tpu_torch"):
            # the same import through each package's CLI, into a store of
            # its own, prints the same line
            p = path if pkg == imp else f"file://{tmp_path / (imp + '-2')}"
            res = _cli(pkg, "import", "--path", p, "--ns", NS, "--db", DB,
                       str(src))
            assert res.returncode == 0, res.stderr.decode()
            outs.append(res.stdout)
        assert outs[0] == outs[1] == \
            f"imported ml::cli<1.2.3> hash={f.hash}\n".encode()
        res = _cli(imp, "import", "--path", path, "--ns", NS, "--db", DB,
                   "--name", "lin", "--version", "9", str(onnx))
        assert res.returncode == 0, res.stderr.decode()
        res = _cli(exp, "export", "--path", path, "--ns", NS, "--db", DB,
                   "cli", "1.2.3")
        assert res.returncode == 0 and res.stdout == f.to_bytes()
        out = tmp_path / f"{exp}.onnx.surml"
        res = _cli(exp, "export", "--path", path, "--ns", NS, "--db", DB,
                   "lin", "9", str(out))
        assert res.returncode == 0
        assert out.read_bytes() == RML.SurmlFile.from_bytes(raw).to_bytes()
        res = [_cli(pkg, "export", "--path", path, "--ns", NS, "--db", DB,
                    "cli", "0") for pkg in (imp, exp)]
        assert res[0].returncode == res[1].returncode != 0
        assert res[0].stderr.decode().strip().splitlines()[-1].split(": ")[-1] \
            == res[1].stderr.decode().strip().splitlines()[-1].split(": ")[-1] \
            == "The model 'ml::cli<0>' does not exist"
