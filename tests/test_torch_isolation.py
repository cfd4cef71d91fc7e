"""The port stands alone: no module of surrealdb_tpu_torch (nor
chip_smoke.py or trace_mesh.py) imports jax or the JAX package, and
importing the port initialises no CUDA."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "surrealdb_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "trace_mesh.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "surrealdb_tpu"), (path, name)


def test_import_initialises_nothing():
    code = (
        "import sys, surrealdb_tpu_torch, "
        "surrealdb_tpu_torch.device.handlers, "
        "surrealdb_tpu_torch.device.supervisor, "
        "surrealdb_tpu_torch.device.runner, surrealdb_tpu_torch.carry, "
        "surrealdb_tpu_torch.ops.topk, surrealdb_tpu_torch.entry, "
        "surrealdb_tpu_torch.ml.onnx, surrealdb_tpu_torch.device.batcher, "
        "surrealdb_tpu_torch.parallel.mesh\n"
        "ds = surrealdb_tpu_torch.Datastore('memory')\n"
        "assert ds.query_one('RETURN 1 + 1') == 2\n"
        "from surrealdb_tpu_torch.device import supervisor\n"
        "assert supervisor._SUP is None\n"
        "import torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'surrealdb_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "from surrealdb_tpu_torch.device import compile_cache\n"
        "assert compile_cache.status()['built'] == []\n"
        "print('isolated')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_engines_import_no_torch():
    """The index engines and the SurrealQL stack run in the serving
    process: importing them (and the KV layer under them) loads neither
    torch nor the JAX package."""
    code = (
        "import sys\n"
        "import surrealdb_tpu_torch.idx.vector, surrealdb_tpu_torch.graph.csr, "
        "surrealdb_tpu_torch.kvs.ds, surrealdb_tpu_torch.kvs.mem, "
        "surrealdb_tpu_torch.resource, surrealdb_tpu_torch.telemetry, "
        "surrealdb_tpu_torch.syn, surrealdb_tpu_torch.syn.parser, "
        "surrealdb_tpu_torch.exec.executor, surrealdb_tpu_torch.exec.statements, "
        "surrealdb_tpu_torch.exec.document, surrealdb_tpu_torch.exec.stream, "
        "surrealdb_tpu_torch.exec.vops, surrealdb_tpu_torch.fnc, "
        "surrealdb_tpu_torch.idx.planner, surrealdb_tpu_torch.graph, "
        "surrealdb_tpu_torch.col, surrealdb_tpu_torch.inflight\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'surrealdb_tpu')]\n"
        "assert not bad, bad\n"
        "print('no torch')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no torch" in out.stdout


def test_server_modules_import_no_reference():
    """The live-query fan-out, the network server, the RPC layer, the
    SDK, the node tasks, the clock seam and the CLI: importing them (and
    starting a server that answers one request) loads neither the JAX
    package nor jax, nor torch."""
    code = (
        "import sys, json, threading, urllib.request\n"
        "import surrealdb_tpu_torch.server, surrealdb_tpu_torch.server.fanout, "
        "surrealdb_tpu_torch.server.admission, surrealdb_tpu_torch.rpc, "
        "surrealdb_tpu_torch.sdk, surrealdb_tpu_torch.node, "
        "surrealdb_tpu_torch.kvs.net, surrealdb_tpu_torch.__main__\n"
        "from surrealdb_tpu_torch.kvs.ds import Datastore\n"
        "ds = Datastore('memory')\n"
        "srv = surrealdb_tpu_torch.server.make_server(ds, '127.0.0.1', 0, "
        "unauthenticated=True)\n"
        "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "r = urllib.request.Request(f'http://127.0.0.1:{srv.server_address[1]}"
        "/sql', data=b'RETURN 1 + 1', method='POST')\n"
        "assert json.loads(urllib.request.urlopen(r).read())[0]['result'] == 2\n"
        "srv.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'surrealdb_tpu')]\n"
        "assert not bad, bad\n"
        "print('no reference')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no reference" in out.stdout
