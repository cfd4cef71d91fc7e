"""The port's ONNX decoder and executor (`surrealdb_tpu_torch/ml/onnx.py`)
against the reference's `ml/onnx.py` on the CPU.

Every operator of the reference's list runs as one small graph, through
both: outputs within atol=1e-5, rtol=1e-4, with equal dtypes, shapes
and NaN patterns. The three graphs of tests/test_ml.py, the decoder's
error messages (word for word, as the port's `OnnxError`), and one SQL
`ml::` call of the reference's stack with its `run_graph` replaced by
the port's.
"""

import struct

import numpy as np
import pytest
import torch

from surrealdb_tpu.err import SdbError
from surrealdb_tpu.ml import onnx as ref_onnx
from surrealdb_tpu_torch.ml import onnx as port_onnx

from test_ml import Datastore, _onnx_linear, _pb_model, _pb_node

ATOL, RTOL = 1e-5, 1e-4
U64 = (1 << 64) - 1


# -- a protobuf builder for typed tensors and every attribute kind ------------

def _varint(n):
    n &= U64
    out = b""
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out += bytes([byte | 0x80])
        else:
            return out + bytes([byte])


def _field(fno, wt, payload):
    return _varint((fno << 3) | wt) + (
        _varint(len(payload)) + payload if wt == 2 else payload)


_CODES = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
          np.dtype(np.float64): 11}


def _tensor(name, arr):
    arr = np.asarray(arr)
    msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    msg += _field(2, 0, _varint(_CODES[arr.dtype]))
    msg += _field(8, 2, name.encode())
    msg += _field(9, 2, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return msg


def _attr(name, val):
    msg = _field(1, 2, name.encode())
    if isinstance(val, float):
        msg += _field(2, 5, struct.pack("<f", val))
    elif isinstance(val, int):
        msg += _field(3, 0, _varint(val))
    elif isinstance(val, str):
        msg += _field(4, 2, val.encode())
    elif isinstance(val, np.ndarray):
        msg += _field(5, 2, _tensor("", val))
    elif val and isinstance(val[0], float):
        msg += _field(7, 2, struct.pack(f"<{len(val)}f", *val))
    else:
        msg += _field(8, 2, b"".join(_varint(int(x)) for x in val))
    return msg


def _node(op, ins, outs, attrs=None):
    msg = b"".join(_field(1, 2, i.encode()) for i in ins)
    msg += b"".join(_field(2, 2, o.encode()) for o in outs)
    msg += _field(4, 2, op.encode())
    for k, v in (attrs or {}).items():
        msg += _field(5, 2, _attr(k, v))
    return msg


def _model(nodes, weights, inputs, outputs):
    graph = b"".join(_field(1, 2, _node(*n)) for n in nodes)
    graph += b"".join(_field(5, 2, _tensor(k, v)) for k, v in weights.items())
    for name in inputs + list(weights):  # weights list as inputs too
        graph += _field(11, 2, _field(1, 2, name.encode()))
    for name in outputs:
        graph += _field(12, 2, _field(1, 2, name.encode()))
    return _field(7, 2, graph)


def _run_both(model, feed):
    rg = ref_onnx.OnnxGraph.parse(model)
    pg = port_onnx.OnnxGraph.parse(model)
    assert pg.inputs == rg.inputs and pg.outputs == rg.outputs
    assert [n.op for n in pg.nodes] == [n.op for n in rg.nodes]
    want = ref_onnx.run_graph(rg, feed)
    got = port_onnx.run_graph(pg, feed, device="cpu")
    assert len(got) == len(want) >= 1
    return want, got


def assert_same(want, got):
    for w, g in zip(want, got):
        assert g.device.type == "cpu"
        g = g.numpy()
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_array_equal(g, w)


# -- one small graph per operator ----------------------------------------------

R = np.random.default_rng(21)


def _f(*shape):
    return R.normal(size=shape).astype(np.float32)


I64 = np.int64
X4 = _f(3, 4)
IMG = _f(2, 4, 7, 6)
SEQ = _f(2, 4, 9)

# name: (nodes, weights, feed)
CASES = {
    "MatMul": ([("MatMul", ["x", "w"], ["y"])], {"w": _f(4, 5)},
               {"x": X4}),
    "Gemm": ([("Gemm", ["x", "w", "c"], ["y"],
               {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0})],
             {"w": _f(6, 4), "c": _f(6)}, {"x": _f(3, 4).T.copy()}),
    "Gemm-noC": ([("Gemm", ["x", "w"], ["y"])], {"w": _f(4, 2)},
                 {"x": X4}),
    "Add": ([("Add", ["x", "b"], ["y"])], {"b": _f(4)}, {"x": X4}),
    "Sub": ([("Sub", ["b", "x"], ["y"])], {"b": _f(3, 1)}, {"x": X4}),
    "Mul": ([("Mul", ["x", "x"], ["y"])], {}, {"x": X4}),
    "Div": ([("Div", ["x", "b"], ["y"])], {"b": _f(4) + 3.0}, {"x": X4}),
    "Div-int": ([("Div", ["i", "j"], ["y"])],
                {"i": np.array([7, -7, 9], I64), "j": np.array([2, 2, 4],
                                                               I64)},
                {"x": X4}),
    "Relu": ([("Relu", ["x"], ["y"])], {}, {"x": X4}),
    "LeakyRelu": ([("LeakyRelu", ["x"], ["y"], {"alpha": 0.2})], {},
                  {"x": X4}),
    "LeakyRelu-default": ([("LeakyRelu", ["x"], ["y"])], {}, {"x": X4}),
    "Sigmoid": ([("Sigmoid", ["x"], ["y"])], {}, {"x": X4 * 10}),
    "Tanh": ([("Tanh", ["x"], ["y"])], {}, {"x": X4}),
    "Softmax": ([("Softmax", ["x"], ["y"], {"axis": 1})], {},
                {"x": _f(2, 5, 3) * 20}),
    "Softmax-default": ([("Softmax", ["x"], ["y"])], {}, {"x": X4}),
    "Identity": ([("Identity", ["x"], ["y"])], {}, {"x": X4}),
    "Cast": ([("Cast", ["x"], ["y"], {"to": 7})], {}, {"x": X4}),
    "Dropout": ([("Dropout", ["x"], ["y", "mask"])], {}, {"x": X4}),
    "Constant": ([("Constant", [], ["c"], {"value": _f(3, 4).astype(
        np.float64)}), ("Add", ["x", "c"], ["y"])], {}, {"x": X4}),
    "Constant-int": ([("Constant", [], ["y"],
                       {"value": np.array([3, -1], I64)})], {}, {"x": X4}),
    "Flatten": ([("Flatten", ["x"], ["y"], {"axis": 2})], {}, {"x": IMG}),
    "Flatten-0": ([("Flatten", ["x"], ["y"], {"axis": 0})], {}, {"x": IMG}),
    "Flatten-default": ([("Flatten", ["x"], ["y"])], {}, {"x": IMG}),
    "Reshape": ([("Reshape", ["x", "s"], ["y"])],
                {"s": np.array([4, -1, 3], I64)}, {"x": IMG}),
    "Concat": ([("Concat", ["x", "b", "x"], ["y"], {"axis": 1})],
               {"b": _f(3, 2)}, {"x": X4}),
    "Neg": ([("Neg", ["x"], ["y"])], {}, {"x": X4}),
    "Exp": ([("Exp", ["x"], ["y"])], {}, {"x": X4}),
    "Sqrt": ([("Sqrt", ["x"], ["y"])], {}, {"x": X4}),
    "Pow": ([("Pow", ["x", "e"], ["y"])], {"e": np.array([2.0, 0.5, 3.0,
                                                         -1.0], np.float32)},
            {"x": np.abs(X4) + 0.5}),
    "Clip": ([("Clip", ["x", "lo", "hi"], ["y"])],
             {"lo": np.array(-0.5, np.float32),
              "hi": np.array(0.7, np.float32)}, {"x": X4}),
    "Clip-min": ([("Clip", ["x", "lo"], ["y"])],
                 {"lo": np.array(0.1, np.float32)}, {"x": X4}),
    "Clip-max": ([("Clip", ["x", "", "hi"], ["y"])],
                 {"hi": np.array(0.1, np.float32)}, {"x": X4}),
    "ReduceMean": ([("ReduceMean", ["x"], ["y"], {"axes": [1, 3]})], {},
                   {"x": IMG}),
    "ReduceMean-all": ([("ReduceMean", ["x"], ["y"], {"keepdims": 0})], {},
                       {"x": IMG}),
    "ReduceSum": ([("ReduceSum", ["x"], ["y"], {"axes": [2],
                                                 "keepdims": 0})], {},
                  {"x": IMG}),
    "ReduceSum-int": ([("ReduceSum", ["i"], ["y"])],
                      {"i": np.array([[1, 2], [3, 4]], I64)}, {"x": X4}),
    "Transpose": ([("Transpose", ["x"], ["y"], {"perm": [0, 2, 3, 1]})],
                  {}, {"x": IMG}),
    "Transpose-default": ([("Transpose", ["x"], ["y"])], {}, {"x": IMG}),
    "Gather": ([("Gather", ["x", "g"], ["y"], {"axis": 1})],
               {"g": np.array([[3, 0], [-1, -4]], I64)}, {"x": X4}),
    "Gather-out-of-range": ([("Gather", ["x", "g"], ["y"])],
                            {"g": np.array([5, -4, 2, -3], I64)},
                            {"x": X4}),
    "Gather-int-scalar": ([("Gather", ["i", "g"], ["y"])],
                          {"i": np.array([[1, 2], [3, 4], [5, 6]], I64),
                           "g": np.array(7, I64)}, {"x": X4}),
    "Gather-float-index": ([("Gather", ["x", "g"], ["y"], {"axis": 1})],
                           {"g": np.array([1.9, -0.5], np.float32)},
                           {"x": X4}),
    "Squeeze": ([("Squeeze", ["x"], ["y"], {"axes": [0, 2]})], {},
                {"x": _f(1, 3, 1, 2)}),
    "Squeeze-input-axes": ([("Squeeze", ["x", "a"], ["y"])],
                           {"a": np.array([2], I64)}, {"x": _f(1, 3, 1, 2)}),
    "Squeeze-all": ([("Squeeze", ["x"], ["y"])], {}, {"x": _f(1, 3, 1, 2)}),
    "Unsqueeze": ([("Unsqueeze", ["x"], ["y"], {"axes": [3, 0]})], {},
                  {"x": X4}),
    "Unsqueeze-input-axes": ([("Unsqueeze", ["x", "a"], ["y"])],
                             {"a": np.array([1], I64)}, {"x": X4}),
    "Unsqueeze-default": ([("Unsqueeze", ["x"], ["y"])], {}, {"x": X4}),
    "Shape": ([("Shape", ["x"], ["y"])], {}, {"x": IMG}),
    "Shape-Gather-Reshape": ([("Shape", ["x"], ["s"]),
                              ("Gather", ["s", "g"], ["s2"]),
                              ("Reshape", ["x", "s2"], ["y"])],
                             {"g": np.array([1, 0], I64)}, {"x": X4}),
    "BatchNormalization": ([("BatchNormalization",
                             ["x", "sc", "bi", "mu", "var"], ["y"],
                             {"epsilon": 1e-3})],
                           {"sc": _f(4), "bi": _f(4), "mu": _f(4),
                            "var": np.abs(_f(4)) + 0.5}, {"x": IMG}),
    "Conv2d-asym-pads": ([("Conv", ["x", "w", "b"], ["y"],
                           {"pads": [1, 0, 2, 1], "strides": [2, 1]})],
                         {"w": _f(5, 4, 3, 2), "b": _f(5)}, {"x": IMG}),
    "Conv2d-same-upper": ([("Conv", ["x", "w"], ["y"],
                            {"auto_pad": "SAME_UPPER", "strides": [2, 2]})],
                          {"w": _f(3, 4, 3, 3)}, {"x": IMG}),
    "Conv2d-same-lower": ([("Conv", ["x", "w"], ["y"],
                            {"auto_pad": "SAME_LOWER",
                             "dilations": [2, 1]})],
                          {"w": _f(3, 4, 2, 3)}, {"x": IMG}),
    "Conv2d-group-dilation": ([("Conv", ["x", "w"], ["y"],
                                {"group": 2, "dilations": [2, 2],
                                 "pads": [1, 1, 1, 1]})],
                              {"w": _f(6, 2, 2, 2)}, {"x": IMG}),
    "Conv1d": ([("Conv", ["x", "w", "b"], ["y"],
                 {"pads": [2, 1], "strides": [2]})],
               {"w": _f(3, 4, 3), "b": _f(3)}, {"x": SEQ}),
    "MaxPool": ([("MaxPool", ["x"], ["y"], {"kernel_shape": [3, 2],
                                            "strides": [2, 2],
                                            "pads": [1, 0, 1, 1]})],
                {}, {"x": IMG}),
    "MaxPool1d": ([("MaxPool", ["x"], ["y"], {"kernel_shape": [3],
                                              "pads": [1, 1]})],
                  {}, {"x": SEQ}),
    "AveragePool": ([("AveragePool", ["x"], ["y"],
                      {"kernel_shape": [2, 3], "strides": [1, 2],
                       "pads": [1, 1, 0, 1]})], {}, {"x": IMG}),
    "AveragePool-include-pad": ([("AveragePool", ["x"], ["y"],
                                  {"kernel_shape": [3, 3],
                                   "pads": [1, 1, 1, 1],
                                   "count_include_pad": 1})], {},
                                {"x": IMG}),
    "AveragePool1d": ([("AveragePool", ["x"], ["y"],
                        {"kernel_shape": [4], "strides": [3]})], {},
                      {"x": SEQ}),
    "AveragePool3d": ([("AveragePool", ["x"], ["y"],
                        {"kernel_shape": [2, 2, 2], "pads": [0, 1, 0, 1,
                                                             0, 0]})], {},
                      {"x": _f(1, 2, 3, 4, 5)}),
    "GlobalAveragePool": ([("GlobalAveragePool", ["x"], ["y"])], {},
                          {"x": IMG}),
    "GlobalMaxPool": ([("GlobalMaxPool", ["x"], ["y"])], {}, {"x": SEQ}),
}
OPERATORS = {"MatMul", "Gemm", "Add", "Sub", "Mul", "Div", "Relu",
             "LeakyRelu", "Sigmoid", "Tanh", "Softmax", "Identity", "Cast",
             "Dropout", "Constant", "Flatten", "Reshape", "Concat", "Neg",
             "Exp", "Sqrt", "Pow", "Clip", "ReduceMean", "ReduceSum",
             "Transpose", "Gather", "Squeeze", "Unsqueeze", "Shape",
             "BatchNormalization", "Conv", "MaxPool", "AveragePool",
             "GlobalAveragePool", "GlobalMaxPool"}


def test_every_reference_operator_has_a_case():
    covered = {n[0] for nodes, _w, _f in CASES.values() for n in nodes}
    assert covered == OPERATORS


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_reference(case):
    nodes, weights, feed = CASES[case]
    model = _model(nodes, weights, list(feed), ["y"])
    assert_same(*_run_both(model, feed))


# -- the graphs of tests/test_ml.py --------------------------------------------

def _conv_bn_pool():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 2, 6, 6)).astype(np.float32)
    w = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    scale = rng.normal(size=(3,)).astype(np.float32) + 1.5
    bmean = rng.normal(size=(3,)).astype(np.float32)
    bvar = np.abs(rng.normal(size=(3,))).astype(np.float32) + 0.5
    model = _pb_model(
        [_pb_node("Conv", ["x", "w", "cb"], ["c"],
                  {"strides": [1, 1], "pads": [1, 1, 1, 1],
                   "kernel_shape": [3, 3]}),
         _pb_node("BatchNormalization",
                  ["c", "scale", "bbias", "bmean", "bvar"], ["bn"],
                  {"epsilon": 1e-5}),
         _pb_node("Relu", ["bn"], ["r"]),
         _pb_node("MaxPool", ["r"], ["y"],
                  {"kernel_shape": [2, 2], "strides": [2, 2]})],
        {"w": w, "cb": bias, "scale": scale, "bbias": bias * 0 + 0.25,
         "bmean": bmean, "bvar": bvar}, "x", "y")
    return model, {"x": x}


def _gather_transpose_avgpool():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 2, 4, 4)).astype(np.float32)
    model = _pb_model(
        [_pb_node("AveragePool", ["x"], ["p"],
                  {"kernel_shape": [2, 2], "strides": [2, 2]}),
         _pb_node("Transpose", ["p"], ["t"], {"perm": [0, 2, 3, 1]}),
         _pb_node("Gather", ["t", "gidx"], ["y"], {"axis": 3})],
        {"gidx": np.array([1], np.float32)}, "x", "y")
    return model, {"x": x}


def _linear():
    w = np.array([[2.0], [3.0]], np.float32)
    b = np.array([1.0], np.float32)
    return _onnx_linear(w, b), {"x": np.array([1.0, 1.0], np.float32)}


@pytest.mark.parametrize("build", [_linear, _conv_bn_pool,
                                   _gather_transpose_avgpool],
                         ids=["linear", "conv_bn_pool",
                              "gather_transpose_avgpool"])
def test_ml_graphs_match_reference(build):
    model, feed = build()
    assert_same(*_run_both(model, feed))


# -- errors --------------------------------------------------------------------

def _errors_of(fn_ref, fn_port):
    with pytest.raises(SdbError) as ref_err:
        fn_ref()
    with pytest.raises(port_onnx.OnnxError) as port_err:
        fn_port()
    assert isinstance(port_err.value, ValueError)
    assert str(port_err.value) == str(ref_err.value)
    return str(port_err.value)


@pytest.mark.parametrize("model,feed,want", [
    (_field(1, 2, b"x"), None, "not an ONNX model: no graph found"),
    (_field(7, 3, b""), None, "unsupported protobuf wire type 3"),
    (_model([("Add", ["x", "nope"], ["y"])], {}, ["x"], ["y"]),
     {"x": X4}, "ONNX execution: missing tensor 'nope'"),
    (_model([("Einsum", ["x"], ["y"])], {}, ["x"], ["y"]),
     {"x": X4}, "ONNX operator 'Einsum' is not supported"),
], ids=["no-graph", "wire-type", "missing-tensor", "unsupported-op"])
def test_errors_match_reference(model, feed, want):
    if feed is None:
        msg = _errors_of(lambda: ref_onnx.OnnxGraph.parse(model),
                         lambda: port_onnx.OnnxGraph.parse(model))
    else:
        msg = _errors_of(
            lambda: ref_onnx.run_graph(ref_onnx.OnnxGraph.parse(model),
                                       feed),
            lambda: port_onnx.run_graph(port_onnx.OnnxGraph.parse(model),
                                        feed, device="cpu"))
    assert msg == want


def test_run_graph_leaves_the_precision_flags_as_it_found_them():
    model, feed = _conv_bn_pool()
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    port_onnx.run_graph(port_onnx.OnnxGraph.parse(model), feed,
                        device="cpu")
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32) == before


# -- the reference's SQL stack over the port's executor ------------------------

def test_sql_ml_call_through_the_port(monkeypatch):
    from surrealdb_tpu.ml import import_model

    calls = []

    def port_run_graph(g, feed):
        calls.append(len(g.nodes))
        return [t.numpy() for t in port_onnx.run_graph(g, feed,
                                                       device="cpu")]

    monkeypatch.setattr(ref_onnx, "run_graph", port_run_graph)
    ds = Datastore("memory")
    try:
        w = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
        b = np.array([0.5, -0.5], np.float32)
        import_model(ds, "t", "t", _onnx_linear(w, b), name="lin",
                     version="2.0.0")
        out = ds.query("RETURN ml::lin<2.0.0>([1, 1])", ns="t", db="t")[0]
    finally:
        ds.close()
    assert out == [pytest.approx(4.5), pytest.approx(5.5)]
    assert calls == [2]
