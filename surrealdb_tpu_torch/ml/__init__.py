"""Models of the port (the reference package's `ml/__init__.py`): the
`.surml` container, `ml::name<version>(…)` calls, and model storage
behind `/ml/import`, `/ml/export` and `ml import|export`.

- `SurmlFile`: the `SURMLTPU` header (JSON: name, version, columns,
  output, normalisers, engine) and the model payload; `to_bytes`,
  `from_bytes` and `hash` give the reference's bytes and hash, so a file
  either package writes loads in the other. Raw ONNX bytes are wrapped
  in a fresh header.
- Engines: `"onnx"` decodes the graph once (`onnx.py OnnxGraph.parse`)
  and runs it with `onnx.py run_graph` on `model_device()`: the card,
  unless the device supervisor is in mode `off` or was built for the CPU
  (as the CPU tests build it); the output comes back to the host. The
  tag `"jax"` (the reference's name, kept because stored blobs carry
  it) is an npz of dense layers run in f32 numpy (`_jax_forward`, as
  the reference runs it).
- `compute_model` runs one graph a call, in the query's thread, as the
  reference does; the parsed models are cached on the datastore
  (`ml_cache`, cleared past 32 entries).
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from typing import Any, Optional

import numpy as np

from surrealdb_tpu_torch.err import SdbError

_MAGIC = b"SURMLTPU"


def model_device() -> str:
    """Where `ml::` runs an ONNX graph: the device supervisor's device
    (`cuda` unless it was built for the CPU), or the CPU in mode `off`."""
    from surrealdb_tpu_torch.device.supervisor import get_supervisor

    sup = get_supervisor()
    return "cpu" if sup.mode == "off" else sup.device


class SurmlFile:
    """Model container: JSON header + payload.

    header = {
      name, version, description,
      columns: [str],               # buffered-compute input order
      output: {name, normaliser?},
      normalisers: {col: {type: "linear_scaling"|"z_score"|
                          "log_standard"|"clipping", ...params}},
      engine: "onnx" | "jax",
    }
    """

    def __init__(self, header: dict, model: bytes):
        self.header = header
        self.model = model
        self._graph = None

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        h = json.dumps(self.header).encode()
        return _MAGIC + struct.pack("<I", len(h)) + h + self.model

    @classmethod
    def from_bytes(cls, data: bytes) -> "SurmlFile":
        if data[:8] == _MAGIC:
            try:
                (hlen,) = struct.unpack("<I", data[8:12])
                header = json.loads(data[12:12 + hlen].decode())
            except (struct.error, ValueError, UnicodeDecodeError) as e:
                raise SdbError(f"invalid surml file: {e}")
            if not isinstance(header, dict):
                raise SdbError("invalid surml file: header is not an object")
            return cls(header, data[12 + hlen:])
        # raw ONNX bytes: wrap with a fresh header (SurMlFile::fresh)
        return cls({"name": "", "version": "", "columns": [],
                    "normalisers": {}, "engine": "onnx"}, data)

    @property
    def hash(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()[:16]

    # -- execution ----------------------------------------------------------
    def _normalise(self, col: str, v: float) -> float:
        nz = (self.header.get("normalisers") or {}).get(col)
        if not nz:
            return v
        t = nz.get("type")
        if t == "linear_scaling":
            lo, hi = nz.get("min", 0.0), nz.get("max", 1.0)
            return (v - lo) / (hi - lo) if hi != lo else 0.0
        if t == "z_score":
            sd = nz.get("std_dev", 1.0)
            return (v - nz.get("mean", 0.0)) / (sd if sd else 1.0)
        if t == "log_standard":
            import math

            base = nz.get("base", 10.0)
            return math.log(max(v, 1e-30), base)
        if t == "clipping":
            return min(max(v, nz.get("min", v)), nz.get("max", v))
        return v

    def raw_compute(self, vec: np.ndarray) -> list[float]:
        x = np.asarray(vec, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        out = self._run(x)
        return [float(v) for v in np.asarray(out).reshape(-1)]

    def buffered_compute(self, named: dict[str, float]) -> list[float]:
        cols = self.header.get("columns") or sorted(named)
        try:
            row = [self._normalise(c, float(named[c])) for c in cols]
        except KeyError as e:
            raise SdbError(
                f"The model expects the input field {e.args[0]!r}"
            )
        return self.raw_compute(np.asarray(row, dtype=np.float32))

    def _run(self, x: np.ndarray):
        engine = self.header.get("engine", "onnx")
        if engine == "onnx":
            from surrealdb_tpu_torch.ml.onnx import OnnxGraph, run_graph

            if self._graph is None:
                self._graph = OnnxGraph.parse(self.model)
            g = self._graph
            if not g.inputs:
                raise SdbError("ONNX model has no graph inputs")
            outs = run_graph(g, {g.inputs[0]: x}, device=model_device())
            if not outs:
                raise SdbError("ONNX model produced no outputs")
            return outs[0].cpu().numpy()
        if engine == "jax":
            return _jax_forward(self.model, x)
        raise SdbError(f"unknown model engine '{engine}'")


def _jax_forward(payload: bytes, x: np.ndarray):
    """The reference's `"jax"` engine: an npz with `spec` (a JSON list of
    layers) and the named weight arrays. Layers: {"op": "dense", "w":
    key, "b": key?, "act": "relu"|"sigmoid"|"tanh"|"softmax"|None}.
    Run in f32 numpy, as the reference runs it (tiny MLP heads on the
    query's thread)."""
    z = np.load(io.BytesIO(payload), allow_pickle=False)
    spec = json.loads(bytes(z["spec"]).decode())
    h = np.asarray(x, dtype=np.float32)
    for layer in spec:
        if layer["op"] == "dense":
            w = np.asarray(z[layer["w"]], dtype=np.float32)
            h = h @ w
            if layer.get("b"):
                h = h + np.asarray(z[layer["b"]], dtype=np.float32)
            act = layer.get("act")
            if act == "relu":
                h = np.maximum(h, 0)
            elif act == "sigmoid":
                h = 1.0 / (1.0 + np.exp(-h))
            elif act == "tanh":
                h = np.tanh(h)
            elif act == "softmax":
                m = np.max(h, axis=-1, keepdims=True)
                e = np.exp(h - m)
                h = e / np.sum(e, axis=-1, keepdims=True)
        else:
            raise SdbError(f"unknown jax layer op '{layer['op']}'")
    return np.asarray(h)


def make_jax_model(name: str, version: str, columns: list[str],
                   layers: list[tuple[np.ndarray, Optional[np.ndarray], Optional[str]]],
                   normalisers: Optional[dict] = None,
                   description: str = "") -> SurmlFile:
    """Author a `"jax"`-engine surml file from (W, b, activation) layers."""
    spec = []
    arrays: dict[str, np.ndarray] = {}
    for i, (w, b, act) in enumerate(layers):
        entry: dict[str, Any] = {"op": "dense", "w": f"w{i}", "act": act}
        arrays[f"w{i}"] = np.asarray(w, dtype=np.float32)
        if b is not None:
            entry["b"] = f"b{i}"
            arrays[f"b{i}"] = np.asarray(b, dtype=np.float32)
        spec.append(entry)
    buf = io.BytesIO()
    np.savez(buf, spec=np.frombuffer(json.dumps(spec).encode(), dtype=np.uint8),
             **arrays)
    header = {
        "name": name, "version": version, "description": description,
        "columns": list(columns), "normalisers": normalisers or {},
        "engine": "jax",
    }
    return SurmlFile(header, buf.getvalue())


# ---------------------------------------------------------------------------
# datastore integration
# ---------------------------------------------------------------------------


def import_model(ds, ns: str, db: str, data: bytes,
                 name: Optional[str] = None,
                 version: Optional[str] = None):
    """Store a surml/ONNX model (the /ml/import route and the CLI).
    Returns its MlModelDef."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import MlModelDef

    f = SurmlFile.from_bytes(data)
    # validate the payload now, so a corrupt upload fails at import and
    # not at query time
    try:
        if f.header.get("engine", "onnx") == "onnx":
            from surrealdb_tpu_torch.ml.onnx import OnnxGraph

            g = OnnxGraph.parse(f.model)
            if not g.nodes:
                raise SdbError("ONNX model graph has no nodes")
        else:
            z = np.load(io.BytesIO(f.model), allow_pickle=False)
            json.loads(bytes(z["spec"]).decode())
    except SdbError:
        raise
    except Exception as e:
        raise SdbError(f"invalid model payload: {e}")
    name = name or f.header.get("name") or "model"
    version = version or f.header.get("version") or "0.0.0"
    d = MlModelDef(
        name=name, version=version,
        comment=f.header.get("description") or None,
        hash=f.hash,
    )
    txn = ds.transaction(write=True)
    try:
        if txn.get(K.ns_def(ns)) is None or txn.get(K.db_def(ns, db)) is None:
            from surrealdb_tpu_torch.catalog import DatabaseDef, NamespaceDef

            if txn.get(K.ns_def(ns)) is None:
                txn.set_val(K.ns_def(ns), NamespaceDef(ns))
            if txn.get(K.db_def(ns, db)) is None:
                txn.set_val(K.db_def(ns, db), DatabaseDef(db))
        txn.set_val(K.ml_def(ns, db, name, version), d)
        txn.set(K.ml_blob(ns, db, name, version), f.to_bytes())
        txn.commit()
    except BaseException:
        txn.cancel()
        raise
    return d


def export_model(ds, ns: str, db: str, name: str, version: str) -> bytes:
    from surrealdb_tpu_torch import key as K

    txn = ds.transaction(write=False)
    try:
        raw = txn.get(K.ml_blob(ns, db, name, version))
    finally:
        txn.cancel()
    if raw is None:
        raise SdbError(
            f"The model 'ml::{name}<{version}>' does not exist"
        )
    return raw


def compute_model(name: str, version: str, args: list, ctx) -> list:
    """`ml::name<version>(arg)` (reference expr/model.rs compute):
    object -> buffered compute, number/array -> raw compute."""
    from decimal import Decimal

    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.catalog import MlModelDef

    ns, db = ctx.need_ns_db()
    mdef = ctx.txn.get_val(K.ml_def(ns, db, name, version))
    if not isinstance(mdef, MlModelDef):
        raise SdbError(f"The model 'ml::{name}<{version}>' does not exist")
    if len(args) != 1:
        raise SdbError(
            f"Incorrect arguments for function ml::{name}<{version}>(). "
            f"The function expects 1 argument."
        )
    cache = ctx.ds.ml_cache
    f = cache.get((ns, db, name, version, mdef.hash))
    if f is None:
        # the blob is read only on a miss: per-row calls reuse the
        # parsed model
        raw = ctx.txn.get(K.ml_blob(ns, db, name, version))
        if raw is None:
            raise SdbError(
                f"The model 'ml::{name}<{version}>' does not exist"
            )
        f = SurmlFile.from_bytes(raw)
        if len(cache) > 32:
            cache.clear()
        cache[(ns, db, name, version, mdef.hash)] = f
    arg = args[0]
    if isinstance(arg, dict):
        named = {}
        for k, v in arg.items():
            if isinstance(v, bool) or not isinstance(
                v, (int, float, Decimal)
            ):
                raise SdbError(
                    f"Incorrect arguments for function "
                    f"ml::{name}<{version}>(). The function expects "
                    f"numeric input fields."
                )
            named[k] = float(v)
        out = f.buffered_compute(named)
    elif isinstance(arg, (int, float, Decimal)) and not isinstance(arg, bool):
        out = f.raw_compute(np.asarray([float(arg)], dtype=np.float32))
    elif isinstance(arg, list):
        try:
            vec = np.asarray([float(x) for x in arg], dtype=np.float32)
        except (TypeError, ValueError):
            raise SdbError(
                f"Incorrect arguments for function ml::{name}<{version}>()."
            )
        out = f.raw_compute(vec)
    else:
        raise SdbError(
            f"Incorrect arguments for function ml::{name}<{version}>()."
        )
    return out
