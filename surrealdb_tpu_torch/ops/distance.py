"""Batched distance matrices: [B, N] distances between query rows and
stored rows (the reference's `ops/distance.py`).

`distance_matrix` runs the CUDA kernel `distance_tile`
(csrc/distance.cu) on a CUDA tensor and `distance_matrix_plain`, the
same formulas in a few lines of PyTorch, on a CPU tensor. The optional
`valid` mask (+inf where 0) is fused into the kernel's store.
"""

from __future__ import annotations

import ctypes

import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops.metrics import (
    CHEBYSHEV,
    COSINE,
    DOT,
    EUCLIDEAN,
    HAMMING,
    JACCARD,
    MANHATTAN,
    METRIC_CODE,
    MINKOWSKI,
    PEARSON,
)

# elements of the [B, chunk, D] broadcast the plain version holds at once
_PLAIN_BROADCAST_ELEMS = 1 << 24


def _normalized(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-30)


def distance_matrix_plain(xs, qs, metric: str = EUCLIDEAN, p: float = 3.0,
                          valid=None):
    """Plain PyTorch version of the reference's distance_matrix."""
    xs = xs.to(torch.float32)
    qs = qs.to(torch.float32)
    if metric == EUCLIDEAN:
        x2 = (xs * xs).sum(-1)[None, :]
        q2 = (qs * qs).sum(-1)[:, None]
        d = torch.sqrt(torch.clamp(x2 + q2 - 2.0 * (qs @ xs.T), min=0.0))
    elif metric == COSINE:
        d = 1.0 - _normalized(qs) @ _normalized(xs).T
    elif metric == DOT:
        d = -(qs @ xs.T)
    elif metric == PEARSON:
        xc = xs - xs.mean(-1, keepdim=True)
        qc = qs - qs.mean(-1, keepdim=True)
        d = 1.0 - _normalized(qc) @ _normalized(xc).T
    elif metric in (MANHATTAN, CHEBYSHEV, HAMMING, MINKOWSKI, JACCARD):
        step = max(1, _PLAIN_BROADCAST_ELEMS
                   // max(qs.shape[0] * qs.shape[1], 1))
        d = torch.cat([
            _elementwise(xs[s:s + step], qs, metric, p)
            for s in range(0, xs.shape[0], step)
        ] or [qs.new_zeros((qs.shape[0], 0))], dim=1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if valid is not None:
        d = torch.where(valid.to(torch.bool)[None, :], d,
                        torch.full_like(d, float("inf")))
    return d


def _elementwise(xs, qs, metric, p):
    q = qs[:, None, :]
    x = xs[None, :, :]
    if metric == MANHATTAN:
        return (q - x).abs().sum(-1)
    if metric == CHEBYSHEV:
        return (q - x).abs().amax(-1)
    if metric == HAMMING:
        return (q != x).sum(-1).to(torch.float32)
    if metric == MINKOWSKI:
        return torch.pow(torch.pow((q - x).abs(), p).sum(-1), 1.0 / p)
    mn = torch.minimum(q, x).sum(-1)
    mx = torch.maximum(q, x).sum(-1)
    return 1.0 - mn / torch.clamp(mx, min=1e-30)


def _stream(t):
    """The raw handle of the current stream on t's device (what
    `torch.cuda.current_stream(dev).cuda_stream` returns, without
    building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _ptr(t):
    return None if t is None else t.data_ptr()


def distance_tile(xs, qs, metric: str, p: float = 3.0, valid=None):
    """Launch csrc/distance.cu on CUDA tensors -> [B, N] f32."""
    from surrealdb_tpu_torch.device import compile_cache

    if metric not in METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    if not (xs.is_cuda and qs.is_cuda):
        raise ValueError("distance_tile takes CUDA tensors")
    if xs.dim() != 2 or qs.dim() != 2 or xs.shape[1] != qs.shape[1]:
        raise ValueError(f"shapes {tuple(xs.shape)} / {tuple(qs.shape)}")
    xs = xs.to(torch.float32).contiguous()
    qs = qs.to(torch.float32).contiguous()
    n, dim = xs.shape
    b = qs.shape[0]
    if valid is not None:
        valid = valid.to(device=xs.device, dtype=torch.uint8).contiguous()
        if valid.shape != (n,):
            raise ValueError(f"valid mask shape {tuple(valid.shape)}")
    out = torch.empty((b, n), dtype=torch.float32, device=xs.device)
    xstats = torch.empty((max(n, 1), 2), dtype=torch.float32,
                         device=xs.device)
    qstats = torch.empty((max(b, 1), 2), dtype=torch.float32,
                         device=xs.device)
    fn = compile_cache.declare(
        compile_cache.library("distance.cu"), "distance_tile",
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p])
    err = fn(xs.data_ptr(), qs.data_ptr(), _ptr(valid), out.data_ptr(),
             xstats.data_ptr(), qstats.data_ptr(), n, b, dim,
             METRIC_CODE[metric], float(p), _stream(xs))
    compile_cache.check(err, "distance_tile")
    kernelstats.note_launch("distance_tile")
    return out


def distance_matrix(xs, qs, metric: str = EUCLIDEAN, p: float = 3.0,
                    valid=None):
    """[B, N] distances between each query row and every stored row;
    +inf where `valid` (optional [N] bool/uint8) is 0. CUDA tensors run
    the kernel, CPU tensors the plain version."""
    if xs.is_cuda:
        return distance_tile(xs, qs, metric, p, valid)
    return distance_matrix_plain(xs, qs, metric, p, valid)
