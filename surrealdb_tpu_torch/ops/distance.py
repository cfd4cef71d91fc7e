"""Batched distance matrices: [B, N] distances between query rows and
stored rows (the reference's `ops/distance.py`).

`distance_matrix` runs the CUDA kernel `distance_tile`
(csrc/distance.cu) on a CUDA tensor and `distance_matrix_plain`, the
same formulas in a few lines of PyTorch, on a CPU tensor. The optional
`valid` mask (+inf where 0) is fused into the kernel's store.

The kernel has two routes, chosen by shape (`tile_route`): the product
metrics (euclidean, cosine, dot, pearson) on the tensor cores in 3xTF32
where TMA can read the rows (D % 4 == 0, a 16-byte aligned base), and
every other metric or shape on the CUDA cores; each route counts its
own launches beside `distance_tile`'s.

Euclidean, cosine and pearson read per-row statistics (`row_stats`). A
store computes its rows' once and passes them as `xstats`; a call
without them computes them itself. The plain version takes the same
argument, so the CPU path runs the same wiring.
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

# metrics whose distance is one product (the tensor-core route), and
# those that read per-row statistics
PRODUCT_METRICS = (EUCLIDEAN, COSINE, DOT, PEARSON)
STAT_METRICS = (EUCLIDEAN, COSINE, PEARSON)


def row_stats_plain(xs, metric: str):
    """[N, 2] f32 per-row statistics: euclidean (|x|^2, 1), cosine (0,
    max(|x|, 1e-30)), pearson (mean, max(|x - mean|, 1e-30)) -- the
    plain distance's own expressions, so that handing them over changes
    no bit of its result."""
    xs = xs.to(torch.float32)
    zero = xs.new_zeros(xs.shape[:1])
    if metric == EUCLIDEAN:
        return torch.stack([(xs * xs).sum(-1), torch.ones_like(zero)],
                           dim=1)
    if metric == COSINE:
        norm = torch.clamp(torch.linalg.norm(xs, dim=-1), min=1e-30)
        return torch.stack([zero, norm], dim=1)
    if metric == PEARSON:
        mean = xs.mean(-1)
        norm = torch.clamp(torch.linalg.norm(xs - mean[:, None], dim=-1),
                           min=1e-30)
        return torch.stack([mean, norm], dim=1)
    raise ValueError(f"metric {metric!r} takes no row statistics")


def distance_matrix_plain(xs, qs, metric: str = EUCLIDEAN, p: float = 3.0,
                          valid=None, xstats=None):
    """Plain PyTorch version of the reference's distance_matrix;
    `xstats` ([N, 2], `row_stats`) stands in for the rows' statistics."""
    xs = xs.to(torch.float32)
    qs = qs.to(torch.float32)
    if metric in STAT_METRICS:
        if xstats is None:
            xstats = row_stats_plain(xs, metric)
        qstats = row_stats_plain(qs, metric)
    if metric == EUCLIDEAN:
        x2 = xstats[:, 0][None, :]
        q2 = qstats[:, 0][:, None]
        d = torch.sqrt(torch.clamp(x2 + q2 - 2.0 * (qs @ xs.T), min=0.0))
    elif metric in (COSINE, PEARSON):
        # normalised first (pearson centred, then divided), as the
        # reference does
        xn = (xs - xstats[:, 0:1]) / xstats[:, 1:2]
        qn = (qs - qstats[:, 0:1]) / qstats[:, 1:2]
        d = 1.0 - qn @ xn.T
    elif metric == DOT:
        d = -(qs @ xs.T)
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


def row_stats(xs, metric: str):
    """[N, 2] f32 row statistics of `xs` for `metric` (None for a metric
    that takes none): csrc/distance.cu `distance_row_stats` on a CUDA
    tensor, the plain version on a CPU tensor. A store computes them
    once and passes them to every `distance_matrix` call."""
    if metric not in STAT_METRICS:
        return None
    if not xs.is_cuda:
        return row_stats_plain(xs, metric)
    from surrealdb_tpu_torch.device import compile_cache

    if xs.dim() != 2:
        raise ValueError(f"rows must be 2-D, got {tuple(xs.shape)}")
    xs = xs.to(torch.float32).contiguous()
    n, dim = xs.shape
    out = torch.empty((n, 2), dtype=torch.float32, device=xs.device)
    fn = compile_cache.declare(
        compile_cache.library("distance.cu"), "distance_row_stats",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])
    # a store places its shards before any query makes their device
    # current: launch on the rows' own card
    with torch.cuda.device(xs.device):
        err = fn(xs.data_ptr(), n, dim, METRIC_CODE[metric],
                 out.data_ptr(), _stream(xs))
    compile_cache.check(err, "distance_row_stats")
    kernelstats.note_launch("distance_row_stats")
    return out


# the tensor-core route's query tiles read 32 columns a step
TF32_K_STEP = 32


def tile_route(xs, metric: str) -> str:
    """"tf32" (the product metrics on the tensor cores) where TMA can read
    the rows -- a 16-byte row pitch (D % 4 == 0), a 16-byte aligned base
    and int32 row coordinates -- else "simt" (the CUDA cores). A choice
    by shape and metric alone, never by a failed build or launch."""
    n, dim = xs.shape
    if (metric in PRODUCT_METRICS and dim % 4 == 0 and n < 2 ** 31
            and xs.data_ptr() % 16 == 0):
        return "tf32"
    return "simt"


def distance_tile(xs, qs, metric: str, p: float = 3.0, valid=None,
                  xstats=None):
    """Launch csrc/distance.cu on CUDA tensors -> [B, N] f32; `xstats`,
    the rows' `row_stats`, skips their per-call computation."""
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
    dev = xs.device
    if valid is not None:
        valid = valid.to(device=dev, dtype=torch.uint8).contiguous()
        if valid.shape != (n,):
            raise ValueError(f"valid mask shape {tuple(valid.shape)}")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    ready = 0
    qstats = None
    if metric in STAT_METRICS:
        if xstats is not None:
            if (xstats.shape != (n, 2) or xstats.dtype != torch.float32
                    or xstats.device != dev or not xstats.is_contiguous()):
                raise ValueError("xstats must be [N, 2] contiguous f32 on "
                                 "the rows' device")
            ready = 1
        else:
            xstats = torch.empty((max(n, 1), 2), dtype=torch.float32,
                                 device=dev)
        qstats = torch.empty((max(b, 1), 2), dtype=torch.float32,
                             device=dev)
    lib = compile_cache.library("distance.cu")
    route = tile_route(xs, metric)
    if route == "tf32":
        dp = -(-dim // TF32_K_STEP) * TF32_K_STEP
        qsplit = torch.empty((2, max(b, 1), dp), dtype=torch.float32,
                             device=dev)
        fn = compile_cache.declare(
            lib, "distance_tile_tf32",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        err = fn(xs.data_ptr(), qs.data_ptr(), _ptr(valid), out.data_ptr(),
                 _ptr(xstats), ready, _ptr(qstats), qsplit[0].data_ptr(),
                 qsplit[1].data_ptr(), n, b, dim, METRIC_CODE[metric],
                 _stream(xs))
    else:
        fn = compile_cache.declare(
            lib, "distance_tile_simt",
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p])
        err = fn(xs.data_ptr(), qs.data_ptr(), _ptr(valid), out.data_ptr(),
                 _ptr(xstats), ready, _ptr(qstats), n, b, dim,
                 METRIC_CODE[metric], float(p), _stream(xs))
    compile_cache.check(err, f"distance_tile_{route}")
    kernelstats.note_launch("distance_tile")
    kernelstats.note_launch(f"distance_tile_{route}")
    return out


def distance_matrix(xs, qs, metric: str = EUCLIDEAN, p: float = 3.0,
                    valid=None, xstats=None):
    """[B, N] distances between each query row and every stored row;
    +inf where `valid` (optional [N] bool/uint8) is 0; `xstats` the
    rows' precomputed `row_stats`. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    if xs.is_cuda:
        return distance_tile(xs, qs, metric, p, valid, xstats)
    return distance_matrix_plain(xs, qs, metric, p, valid, xstats)
