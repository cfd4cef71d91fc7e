"""Device RPC framing, the same frames as the reference runner's.

One message =

    u32 total_len | u32 header_len | header | buf0 | buf1 | ...

`header` is the CBOR encoding (surrealdb_tpu_torch.wire) of
`[tag, meta, descs]` where `descs` lists `[dtype_str, shape]` per
buffer. Buffers are the raw little-endian bytes of C-contiguous numpy
arrays, so f32/int32 query and result tensors never pay a CBOR
round-trip. `total_len` counts the header-length word, the header and
the buffers.
"""

from __future__ import annotations

import struct

import numpy as np

from surrealdb_tpu_torch import wire

_HDR = struct.Struct(">I")
# device frames carry whole block caches (a store re-ship after a
# runner restart), so the cap is far above a query frame's size
MAX_FRAME = 16 << 30


def _recv_exact(sock, n: int) -> bytearray:
    """Exactly n bytes, received in place into one buffer (no growth,
    no copy: a store ship moves gigabytes through here)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 4 << 20))
        if not r:
            raise ConnectionError("device peer closed")
        got += r
    return buf


def send_msg(sock, tag: str, meta: dict, bufs=()) -> None:
    """Ship one (tag, meta, buffers) message. Buffers are numpy arrays;
    non-contiguous input is copied, dtype/shape ride the header."""
    arrs = [np.ascontiguousarray(b) for b in bufs]
    descs = [[a.dtype.str, list(a.shape)] for a in arrs]
    header = wire.encode([tag, meta, descs])
    total = 4 + len(header) + sum(a.nbytes for a in arrs)
    if total > MAX_FRAME:
        raise ValueError(f"device frame too large: {total}")
    sock.sendall(_HDR.pack(total) + _HDR.pack(len(header)) + header)
    for a in arrs:
        if a.nbytes:
            sock.sendall(memoryview(a.reshape(-1).view(np.uint8)))


def recv_msg(sock):
    """Receive one message -> (tag, meta, [numpy arrays])."""
    (total,) = _HDR.unpack(_recv_exact(sock, 4))
    if total > MAX_FRAME:
        raise ConnectionError(f"device frame too large: {total}")
    (hlen,) = _HDR.unpack(_recv_exact(sock, 4))
    if hlen > total - 4:
        raise ConnectionError("device frame header overruns frame")
    tag, meta, descs = wire.decode(bytes(_recv_exact(sock, hlen)))
    bufs = []
    for dtype_str, shape in descs:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape)) if shape else 1
        raw = _recv_exact(sock, n * dt.itemsize)
        bufs.append(np.frombuffer(raw, dtype=dt).reshape(shape))
    return tag, meta, bufs
