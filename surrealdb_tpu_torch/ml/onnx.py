"""ONNX graphs on the card: the reference's `ml/onnx.py` decoder and
executor, with torch library ops in place of eager `jnp`/`lax` ops.

The ModelProto protobuf is decoded directly (varint tags and
length-delimited fields), as the reference does: there is no onnx
package to lean on. `run_graph` executes the nodes in file order on the
card (or the CPU when asked) and returns tensors on that device.

Semantics are the reference's, not ONNX's where they differ: `Cast` is
the identity; `Softmax` is taken over the given axis as written; the
average pool divides by the real elements when it pads
(count_include_pad=0) and max pooling pads with -inf; `Gather` wraps an
index in [-n, 0) and fills NaN (the least integer for integer inputs)
past the axis, as `jnp.take` does; `Shape` is int32 and 64-bit weights
narrow to 32 bits, as JAX does with x64 off. Products and convolutions
run in full f32 (no TF32) inside `run_graph`.

Covered operator set: MatMul, Gemm, Add, Sub, Mul, Div, Relu,
LeakyRelu, Sigmoid, Tanh, Softmax, Identity, Cast, Dropout, Constant,
Flatten, Reshape, Concat, Neg, Exp, Sqrt, Pow, Clip, ReduceMean,
ReduceSum, Transpose, Gather, Squeeze, Unsqueeze, Shape,
BatchNormalization, Conv, MaxPool, AveragePool, GlobalAveragePool,
GlobalMaxPool.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Any

import numpy as np

from surrealdb_tpu_torch.err import SdbError


class OnnxError(SdbError, ValueError):
    """A model the decoder or the executor cannot take: a statement's
    error in an `ml::` call, and a ValueError to a caller running a
    graph by hand."""


# ---------------------------------------------------------------------------
# protobuf wire decoding
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, i = _varint(buf, i)
        elif wt == 1:  # 64-bit
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = buf[i:i + 4]
            i += 4
        else:
            raise OnnxError(f"unsupported protobuf wire type {wt}")
        yield fno, wt, v


def _packed_varints(buf: bytes):
    out = []
    i = 0
    while i < len(buf):
        v, i = _varint(buf, i)
        out.append(v)
    return out


_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims = []
    dtype = 1
    raw = None
    floats = []
    ints = []
    name = ""
    for fno, wt, v in _fields(buf):
        if fno == 1:  # dims
            if wt == 0:
                dims.append(v)
            else:
                dims.extend(_packed_varints(v))
        elif fno == 2:
            dtype = v
        elif fno == 4:  # float_data (packed)
            floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif fno == 7:  # int64_data
            if wt == 0:
                ints.append(v)
            else:
                ints.extend(_packed_varints(v))
        elif fno == 8:
            name = v.decode()
        elif fno == 9:
            raw = v
    np_dt = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dt)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32)
    elif ints:
        arr = np.asarray(ints, dtype=np.int64)
    else:
        arr = np.zeros(0, np_dt)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _attr(buf: bytes):
    name = ""
    val: Any = None
    for fno, wt, v in _fields(buf):
        if fno == 1:
            name = v.decode()
        elif fno == 2:  # f
            val = struct.unpack("<f", v)[0]
        elif fno == 3:  # i
            val = v - (1 << 64) if v >= (1 << 63) else v
        elif fno == 4:  # s
            val = v.decode(errors="replace")
        elif fno == 5:  # t
            val = _tensor(v)[1]
        elif fno == 7:  # floats
            val = list(struct.unpack(f"<{len(v) // 4}f", v))
        elif fno == 8:  # ints (packed or repeated)
            if wt == 0:
                val = (val or []) + [v]
            else:
                val = _packed_varints(v)
    return name, val


class OnnxNode:
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, op, inputs, outputs, attrs):
        self.op = op
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs


class OnnxGraph:
    """Decoded ONNX graph: nodes in topological (file) order, initializer
    weights, and the input/output value names."""

    __slots__ = ("nodes", "weights", "inputs", "outputs")

    def __init__(self):
        self.nodes: list[OnnxNode] = []
        self.weights: dict[str, np.ndarray] = {}
        self.inputs: list[str] = []
        self.outputs: list[str] = []

    @classmethod
    def parse(cls, model_bytes: bytes) -> "OnnxGraph":
        graph_buf = None
        for fno, _wt, v in _fields(model_bytes):
            if fno == 7:  # ModelProto.graph
                graph_buf = v
        if graph_buf is None:
            raise OnnxError("not an ONNX model: no graph found")
        g = cls()
        for fno, _wt, v in _fields(graph_buf):
            if fno == 1:  # node
                op = ""
                ins: list[str] = []
                outs: list[str] = []
                attrs: dict[str, Any] = {}
                for f2, _w2, v2 in _fields(v):
                    if f2 == 1:
                        ins.append(v2.decode())
                    elif f2 == 2:
                        outs.append(v2.decode())
                    elif f2 == 4:
                        op = v2.decode()
                    elif f2 == 5:
                        an, av = _attr(v2)
                        attrs[an] = av
                g.nodes.append(OnnxNode(op, ins, outs, attrs))
            elif fno == 5:  # initializer
                name, arr = _tensor(v)
                g.weights[name] = arr
            elif fno in (11, 12):  # input / output ValueInfoProto
                vname = ""
                for f2, _w2, v2 in _fields(v):
                    if f2 == 1:
                        vname = v2.decode()
                        break
                if fno == 11:
                    g.inputs.append(vname)
                else:
                    g.outputs.append(vname)
        # graph inputs exclude initializers (weights list as inputs too)
        g.inputs = [x for x in g.inputs if x not in g.weights]
        return g


# ---------------------------------------------------------------------------
# torch execution
# ---------------------------------------------------------------------------

# JAX with x64 off keeps 32 bits of a 64-bit array
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}


def _as_tensor(v, device):
    """The reference's `jnp.asarray(v)`: 64-bit values narrowed to 32."""
    import torch

    arr = np.asarray(v)
    # a copy: decoded weights are read-only views of the model bytes
    arr = np.array(arr, dtype=_NARROW.get(arr.dtype, arr.dtype), order="C")
    return torch.from_numpy(arr).to(device)


def _int_sum(x, out):
    """jnp.sum's integer dtypes: bool and signed sums in int32,
    unsigned in uint32 (torch sums them in 64 bits)."""
    import torch

    if x.dtype.is_floating_point:
        return out
    unsigned = x.dtype in (torch.uint8, torch.uint16, torch.uint32)
    return out.to(torch.uint32 if unsigned else torch.int32)


def _softmax(x, axis):
    import torch

    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


def _spatial_pads(a, nsp: int):
    """ONNX pads [b1..bn, e1..en] -> [(b1,e1)...]; SAME_UPPER handled by
    the caller via explicit output shapes when auto_pad is set."""
    pads = a.get("pads")
    if pads is None:
        return [(0, 0)] * nsp
    return [(int(pads[i]), int(pads[i + nsp])) for i in range(nsp)]


def _same_pads(shape, ks, strides, dil):
    """lax's "SAME" padding: out = ceil(in / stride), the total pad
    split with the odd element after."""
    out = []
    for n, k, s, d in zip(shape, ks, strides, dil):
        total = max(0, (-(-n // s) - 1) * s + (k - 1) * d + 1 - n)
        out.append((total // 2, total - total // 2))
    return out


def _pad(x, pads, value=0.0):
    """Pad (or crop, for negative pads) the trailing spatial dims."""
    import torch.nn.functional as F

    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def _conv(ins, a):
    """ONNX Conv on NCW/NCHW layouts: the padding applied first (any
    asymmetric or lax-"SAME" pads), then torch's convolution."""
    import torch.nn.functional as F

    x, w = ins[0], ins[1]
    nsp = x.dim() - 2
    if nsp not in (1, 2):
        raise OnnxError(f"ONNX Conv over {nsp} spatial dims is not "
                        "supported")
    strides = [int(s) for s in a.get("strides", [1] * nsp)]
    dil = [int(d) for d in a.get("dilations", [1] * nsp)]
    group = int(a.get("group", 1))
    if a.get("auto_pad") in ("SAME_UPPER", "SAME_LOWER"):
        pads = _same_pads(x.shape[2:], w.shape[2:], strides, dil)
    else:
        pads = _spatial_pads(a, nsp)
    conv = F.conv1d if nsp == 1 else F.conv2d
    out = conv(_pad(x, pads), w, stride=strides, dilation=dil, groups=group)
    if len(ins) > 2 and ins[2] is not None:
        b = ins[2]
        shp = [1] * out.dim()
        shp[1] = b.shape[0]
        out = out + b.reshape(shp)
    return out


def _window_sum(x, ks, strides):
    """Sums over the pooling windows (no padding of its own)."""
    import torch.nn.functional as F

    if len(ks) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1, ks[0]), (1, strides[0]),
                            divisor_override=1).squeeze(2)
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[len(ks)]
    return pool(x, ks, strides, divisor_override=1)


def _pool(x, a, op):
    """ONNX MaxPool/AveragePool (count_include_pad=0 semantics for the
    average: divide by the number of REAL elements)."""
    import torch
    import torch.nn.functional as F

    nsp = x.dim() - 2
    if nsp not in (1, 2, 3):
        raise OnnxError(f"ONNX {op} over {nsp} spatial dims is not "
                        "supported")
    ks = [int(k) for k in a.get("kernel_shape", [1] * nsp)]
    strides = [int(s) for s in a.get("strides", [1] * nsp)]
    pads = _spatial_pads(a, nsp)
    if op == "MaxPool":
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nsp]
        return pool(_pad(x, pads, float("-inf")), ks, strides)
    sums = _window_sum(_pad(x, pads), ks, strides)
    if not a.get("count_include_pad") and any(p != (0, 0) for p in pads):
        counts = _window_sum(_pad(torch.ones_like(x), pads), ks, strides)
        return sums / counts
    return sums / float(np.prod(ks))


def _gather(x, idx, axis: int):
    """jnp.take's default mode: an index in [-n, 0) wraps to i + n, one
    outside [-n, n) reads NaN (the least integer for integer inputs)."""
    import torch

    axis %= x.dim()
    n = x.shape[axis]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    out = torch.index_select(x, axis, idx.clamp(0, max(n - 1, 0)).reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    if bool(oob.any()):
        if x.dtype.is_floating_point:
            fill = float("nan")
        elif x.dtype == torch.bool:
            fill = True
        else:
            fill = torch.iinfo(x.dtype).min
        mask = oob.reshape((1,) * axis + idx.shape
                           + (1,) * (x.dim() - axis - 1))
        out = torch.where(mask, torch.full_like(out, fill), out)
    return out


def _axes_input(a, ins):
    axes = a.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = [int(x) for x in ins[1].cpu().tolist()]
    return axes


@contextlib.contextmanager
def _full_f32():
    """Products and convolutions in full f32 (cuBLAS and cuDNN take
    TF32 otherwise), restored on the way out."""
    import torch

    prec = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)


def run_graph(g: OnnxGraph, feed: dict, device=None) -> list:
    """Execute the graph on `device` (default the card); returns the
    output tensors there."""
    import torch

    dev = torch.device(device or "cuda")
    with _full_f32():
        return _run(g, feed, dev)


def _run(g: OnnxGraph, feed: dict, dev) -> list:
    import torch

    env: dict[str, Any] = {k: _as_tensor(v, dev) for k, v in g.weights.items()}
    for k, v in feed.items():
        env[k] = torch.as_tensor(np.asarray(v, dtype=np.float32)).to(dev)

    def get(name):
        if name == "":
            return None
        if name not in env:
            raise OnnxError(f"ONNX execution: missing tensor '{name}'")
        return env[name]

    for node in g.nodes:
        op = node.op
        a = node.attrs
        ins = [get(x) for x in node.inputs]
        if op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Gemm":
            x, w = ins[0], ins[1]
            if a.get("transA"):
                x = x.T
            if a.get("transB"):
                w = w.T
            out = a.get("alpha", 1.0) * (x @ w)
            if len(ins) > 2 and ins[2] is not None:
                out = out + a.get("beta", 1.0) * ins[2]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Relu":
            out = torch.clamp_min(ins[0], 0)
        elif op == "LeakyRelu":
            out = torch.where(ins[0] > 0, ins[0],
                              a.get("alpha", 0.01) * ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + torch.exp(-ins[0]))
        elif op == "Tanh":
            out = torch.tanh(ins[0])
        elif op == "Softmax":
            out = _softmax(ins[0], a.get("axis", -1))
        elif op in ("Identity", "Cast", "Dropout"):
            out = ins[0]
        elif op == "Constant":
            out = _as_tensor(a.get("value"), dev)
        elif op == "Flatten":
            ax = a.get("axis", 1)
            shp = tuple(ins[0].shape)
            lead = int(np.prod(shp[:ax])) if ax else 1
            out = ins[0].reshape(lead, -1)
        elif op == "Reshape":
            shape = [int(x) for x in ins[1].cpu().tolist()]
            out = ins[0].reshape(shape)
        elif op == "Concat":
            out = torch.cat(ins, dim=a.get("axis", 0))
        elif op == "Neg":
            out = -ins[0]
        elif op == "Exp":
            out = torch.exp(ins[0])
        elif op == "Sqrt":
            out = torch.sqrt(ins[0])
        elif op == "Pow":
            out = ins[0] ** ins[1]
        elif op == "Clip":
            out = ins[0]
            if len(ins) > 1 and ins[1] is not None:
                out = torch.maximum(ins[1], out)
            if len(ins) > 2 and ins[2] is not None:
                out = torch.minimum(ins[2], out)
        elif op in ("ReduceMean", "ReduceSum"):
            x = ins[0]
            dims = tuple(a.get("axes", [])) or tuple(range(x.dim()))
            keep = bool(a.get("keepdims", 1))
            if op == "ReduceSum":
                out = _int_sum(x, torch.sum(x, dim=dims, keepdim=keep))
            else:
                if not x.dtype.is_floating_point:
                    x = x.to(torch.float32)
                out = torch.mean(x, dim=dims, keepdim=keep)
        elif op == "Transpose":
            perm = a.get("perm")
            out = ins[0].permute(
                perm if perm is not None else
                tuple(reversed(range(ins[0].dim()))))
        elif op == "Gather":
            idx = ins[1].to(torch.int32)
            out = _gather(ins[0], idx, a.get("axis", 0))
        elif op == "Squeeze":
            axes = _axes_input(a, ins)
            x = ins[0]
            if axes:
                dims = tuple(int(ax) % x.dim() for ax in axes)
                if any(x.shape[d] != 1 for d in dims):
                    raise OnnxError(
                        f"cannot squeeze axes {list(axes)} of shape "
                        f"{tuple(x.shape)}")
                out = x.squeeze(dims)
            else:
                out = x.squeeze()
        elif op == "Unsqueeze":
            out = ins[0]
            for ax in sorted(_axes_input(a, ins) or [0]):
                out = out.unsqueeze(int(ax))
        elif op == "Shape":
            out = torch.tensor(list(ins[0].shape), dtype=torch.int32,
                               device=dev)
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = ins[:5]
            eps = a.get("epsilon", 1e-5)
            # stats broadcast over the channel axis (axis 1)
            shp = [1] * x.dim()
            shp[1] = x.shape[1]
            out = (
                (x - mean.reshape(shp))
                / torch.sqrt(var.reshape(shp) + eps)
                * scale.reshape(shp)
                + bias.reshape(shp)
            )
        elif op == "Conv":
            out = _conv(ins, a)
        elif op in ("MaxPool", "AveragePool"):
            out = _pool(ins[0], a, op)
        elif op == "GlobalAveragePool":
            out = torch.mean(ins[0], dim=tuple(range(2, ins[0].dim())),
                             keepdim=True)
        elif op == "GlobalMaxPool":
            out = torch.amax(ins[0], dim=tuple(range(2, ins[0].dim())),
                             keepdim=True)
        else:
            raise OnnxError(f"ONNX operator '{op}' is not supported")
        env[node.outputs[0]] = out
        for extra in node.outputs[1:]:
            env[extra] = out

    return [env[o] for o in g.outputs if o in env]
