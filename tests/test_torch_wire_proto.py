"""The port's CBOR codec and device framing against the reference's:
byte-identical header encodings, and frames that cross between the two
implementations over a socketpair in both directions."""

import math
import socket
import struct

import numpy as np
import pytest

from surrealdb_tpu import wire as ref_wire
from surrealdb_tpu.device import proto as ref_proto
from surrealdb_tpu_torch import wire as port_wire
from surrealdb_tpu_torch.device import proto as port_proto

CFG = {"hbm_budget": 12 << 30, "score_budget": 1 << 29, "query_chunk": 512,
       "int8_oversample": 128, "block_rows": 262144}

# real frame headers: [tag, meta, descs]
HEADERS = [
    ["ready", {"platform": "cuda", "device_count": 1,
               "compile_cache": {"dir": "/srv/build/torch_kernels/ab12",
                                 "hits": 0, "misses": 1, "build_s": 7.25,
                                 "built": ["csr_hop.cu", "distance.cu"]},
               "mesh": {"mode": "auto", "n_devices": 1,
                        "mesh_shape": [1], "axis": "mesh"}}, []],
    ["init_error", {"error": "RuntimeError: CUDA is not available"}, []],
    ["vec_load", {"metric": "cosine", "mink_p": 3.0, "cfg": CFG,
                  "key": "vec/b/b/tbl/ix", "tag": [3, 0], "seq": 7},
     [["<f4", [1000, 768]], ["|u1", [1000]]]],
    ["vec_load_begin", {"metric": "euclidean", "mink_p": 3.0, "cfg": CFG,
                        "key": "vec/t", "tag": [12, 1], "shape": [1000000,
                                                                  768],
                        "dtype": "<f4", "seq": 1}, [["|u1", [1000000]]]],
    ["vec_knn", {"key": "vec/b/b/tbl/ix", "tag": [3, 0], "k": 10,
                 "seq": 4294967296}, [["<f4", [128, 768]]]],
    ["csr_hop", {"key": "csr/b/b/person/knows/out", "tag": [5], "hops": 3,
                 "union": True, "seq": 12}, [["|u1", [8, 1000000]]]],
    ["brute_knn", {"k": 10, "metric": "minkowski", "p": -2.5, "seq": -1},
     [["<f8", [20000, 128]], ["<f4", [1, 128]]]],
    ["ok", {"mode": "pairs", "rank_mode": None, "mesh_ndev": 1,
            "cc": {"hits": 3, "misses": 1, "sharded": 0, "mesh_ndev": 1},
            "seq": 4}, [["<f4", [128, 10]], ["<i4", [128, 10]]]],
    ["ok", {"platform": "cpu", "vec_blocks": 0, "mem_used": 0,
            "mem_budget": 1 << 40, "oom_refusals": 0, "flag": False,
            "note": "naïve ☃", "raw": b"\x00\xff", "inf": math.inf,
            "small": 5e-324, "neg": -(1 << 40), "big": (1 << 64) - 1},
     []],
    ["err", {"seq": 9, "error": "NotPorted: not ported: int8 rank store",
             "trace": "Traceback ...\n" * 40, "oom": True}, []],
]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_encoding_is_byte_identical(i):
    h = HEADERS[i]
    enc = port_wire.encode(h)
    assert enc == ref_wire.encode(h)
    assert port_wire.decode(enc) == ref_wire.decode(enc) == h


def test_decodes_half_and_single_floats():
    for raw in (b"\xf9\x3c\x00", b"\xf9\x7c\x00", b"\xf9\x00\x01",
                b"\xfa\x3f\x80\x00\x00", b"\xfa\xc0\x49\x0f\xdb"):
        assert port_wire.decode(raw) == ref_wire.decode(raw)
    assert port_wire.decode(b"\xf9\xc4\x00") == -4.0
    with pytest.raises(ValueError):
        port_wire.decode(b"\x82\x01")  # truncated list
    with pytest.raises(ValueError):
        port_wire.decode(b"\x01\x02")  # trailing bytes


def _frames():
    rng = np.random.default_rng(0)
    return [
        ("vec_knn", {"key": "vec/x", "tag": [1, 2], "k": 10, "seq": 3},
         [rng.normal(size=(4, 16)).astype(np.float32)]),
        ("ok", {"mode": "pairs", "seq": 3},
         [rng.normal(size=(4, 10)).astype(np.float32),
          rng.integers(0, 99, size=(4, 10)).astype(np.int32)]),
        ("csr_hop", {"hops": 3, "union": False, "seq": 4},
         [np.zeros((0, 7), np.uint8)]),
        ("ping", {}, []),
        ("brute_knn", {"k": 2, "metric": "dot"},
         [np.asfortranarray(rng.normal(size=(5, 3))),
          np.float32(1.5) * np.ones((1, 3), np.float32)]),
    ]


@pytest.mark.parametrize("sender,receiver", [
    (ref_proto, port_proto), (port_proto, ref_proto), (port_proto,
                                                       port_proto)])
def test_frames_cross_between_implementations(sender, receiver):
    a, b = socket.socketpair()
    try:
        for tag, meta, bufs in _frames():
            sender.send_msg(a, tag, meta, bufs)
            rtag, rmeta, rbufs = receiver.recv_msg(b)
            assert (rtag, rmeta) == (tag, meta)
            assert len(rbufs) == len(bufs)
            for got, want in zip(rbufs, bufs):
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
    finally:
        a.close()
        b.close()


def test_frame_caps_match():
    assert port_proto.MAX_FRAME == ref_proto.MAX_FRAME == 16 << 30
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", 10) + struct.pack(">I", 20))
        with pytest.raises(ConnectionError):
            port_proto.recv_msg(b)
        a.close()
        with pytest.raises(ConnectionError):
            port_proto.recv_msg(b)
    finally:
        a.close()
        b.close()


class _F(float):
    pass


_VEC = np.random.default_rng(3).standard_normal(768).astype(np.float32)

# lists at and around the one-call float path: a run of doubles packs
# and unpacks in one struct call, anything else item by item
FLOAT_RUNS = [
    [1.5] * 15, [1.5] * 16, _VEC.tolist(), [float("nan")] * 17,
    [float("inf"), -0.0] * 10, [1.5] * 16 + [2], [2] + [1.5] * 16,
    [True] + [1.5] * 16, [1.5] * 20 + ["a"], [[1.5] * 20, [2.5] * 20],
    [_F(1.5)] * 20, {"emb": _VEC.tolist(), "id": 7},
]


@pytest.mark.parametrize("i", range(len(FLOAT_RUNS)))
def test_float_runs_encode_and_decode_as_the_reference(i):
    v = FLOAT_RUNS[i]
    raw = port_wire.encode(v)
    assert raw == ref_wire.encode(v)
    assert repr(port_wire.decode(raw)) == repr(ref_wire.decode(raw))
