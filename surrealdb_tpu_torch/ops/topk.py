"""Top-k selection and the KNN kernels built on it (the reference's
`ops/topk.py`).

Every function takes and returns tensors on one device. On a CUDA
tensor each kernel wrapper launches its kernel (csrc/select.cu,
csrc/rank_rescore.cu, and csrc/distance.cu through
`ops.distance.distance_matrix`); on a CPU tensor it runs the plain
PyTorch version beside it. Ties go to the lower index, as
`jax.lax.top_k` breaks them; the plain versions get that from a stable
sort.
"""

from __future__ import annotations

import ctypes

import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops.distance import _ptr, _stream, distance_matrix
from surrealdb_tpu_torch.ops.metrics import COSINE, EUCLIDEAN, METRIC_CODE

# largest k whose select buffer lives in shared memory (csrc/kernels.h
# SURREAL_SELECT_MAX_K); a larger k sorts in a device scratch buffer
SELECT_MAX_K = 4096


# -- exact per-row selection ---------------------------------------------------

def top_k_smallest_plain(vals, k: int, ids=None):
    """Plain version: stable ascending sort, first k (any k <= N, the
    kernel's large-k case included)."""
    order = torch.sort(vals, dim=1, stable=True).indices[:, :k]
    out_v = torch.gather(vals, 1, order)
    if ids is not None:
        return out_v, torch.gather(ids, 1, order).to(torch.int32)
    return out_v, order.to(torch.int32)


def select_topk_rows(vals, k: int, ids=None):
    """Launch csrc/select.cu on a CUDA [R, N] f32 tensor."""
    from surrealdb_tpu_torch.device import compile_cache

    if not vals.is_cuda or vals.dim() != 2:
        raise ValueError("select_topk_rows takes a 2-D CUDA tensor")
    vals = vals.to(torch.float32).contiguous()
    rows, n = vals.shape
    if not 1 <= k <= n:
        raise ValueError(f"select_topk_rows: k={k} outside 1..{n}")
    if ids is not None:
        ids = ids.to(torch.int32).contiguous()
        if ids.shape != vals.shape:
            raise ValueError(f"id map shape {tuple(ids.shape)}")
    out_v = torch.empty((rows, k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=vals.device)
    if rows == 0:
        return out_v, out_i
    scratch, scratch_ld = None, 0
    if k > SELECT_MAX_K:
        # the sort buffer of the large-k path: [rows, pow2 >= k] u64
        scratch_ld = 1 << (k - 1).bit_length()
        scratch = torch.empty((rows, scratch_ld), dtype=torch.int64,
                              device=vals.device)
    fn = compile_cache.declare(
        compile_cache.library("select.cu"), "select_topk_rows",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p])
    err = fn(vals.data_ptr(), n, _ptr(ids), n, rows, n, k,
             out_v.data_ptr(), out_i.data_ptr(), _ptr(scratch), scratch_ld,
             _stream(vals))
    compile_cache.check(err, "select_topk_rows")
    kernelstats.note_launch("select_topk_rows")
    return out_v, out_i


def top_k_smallest(vals, k: int, ids=None):
    """[R, N] -> (values [R, k], int32 indices [R, k]) of the k smallest
    per row, ascending, ties to the lower index. With `ids` ([R, N]
    int32) the indices are mapped through it."""
    if vals.is_cuda:
        return select_topk_rows(vals, k, ids)
    return top_k_smallest_plain(vals, k, ids)


# -- exact KNN -------------------------------------------------------------------

def knn_search(xs, qs, k: int, metric: str = EUCLIDEAN, p: float = 3.0,
               valid=None):
    """Distance + validity mask (+inf) + top-k."""
    return top_k_smallest(distance_matrix(xs, qs, metric, p, valid), k)


def knn_search_blocked(xs, qs, k: int, metric: str = EUCLIDEAN,
                       p: float = 3.0, valid=None, block: int = 65536):
    """Blockwise scan with a running exact top-k (peak [B, block]): the
    same two kernels per block, then a selection over [best, block]
    candidates through an id map. The running best starts as
    (+inf, -1), as the reference's does."""
    n = xs.shape[0]
    b = qs.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                        device=qs.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=qs.device)
    for base in range(0, n, block):
        blk = xs[base:base + block]
        vmask = None if valid is None else valid[base:base + block]
        d = distance_matrix(blk, qs, metric, p, vmask)
        cand_d, cand_i = top_k_smallest(d, min(k, blk.shape[0]))
        merged_d = torch.cat([best_d, cand_d], dim=1)
        merged_i = torch.cat([best_i, cand_i + base], dim=1)
        best_d, best_i = top_k_smallest(merged_d, k, ids=merged_i)
    return best_d, best_i


# -- bf16 rank + exact f32 rescore ------------------------------------------------

def _pad_to(qs, width: int):
    """Zero-pad query rows to the rank store's width (the store may carry
    zero columns up to a multiple of 8; they add nothing to a dot)."""
    if qs.shape[1] == width:
        return qs
    if qs.shape[1] > width:
        raise ValueError(f"query width {qs.shape[1]} > store width {width}")
    return torch.nn.functional.pad(qs, (0, width - qs.shape[1]))


def rank_scores_plain(xs_rank, qs, metric: str, x2=None, valid=None):
    """Plain version: the bf16 product in f32 on bf16-rounded inputs
    (exact per product), the score epilogue, the mask."""
    qs = _pad_to(qs, xs_rank.shape[1])
    dots = qs.to(torch.bfloat16).float() @ xs_rank.float().T
    score = x2[None, :] - 2.0 * dots if metric == EUCLIDEAN else -dots
    if valid is not None:
        score = torch.where(valid.to(torch.bool)[None, :], score,
                            torch.full_like(score, float("inf")))
    return score


def rank_scores_bf16(xs_rank, qs, metric: str, x2=None, valid=None):
    """Launch csrc/rank_rescore.cu rank_scores_bf16 -> [C, N] f32."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (xs_rank.is_cuda and qs.is_cuda):
        raise ValueError("rank_scores_bf16 takes CUDA tensors")
    if xs_rank.dtype != torch.bfloat16 or xs_rank.dim() != 2:
        raise ValueError("rank store must be a 2-D bfloat16 tensor")
    xs_rank = xs_rank.contiguous()
    n, dim = xs_rank.shape
    if dim % 8:
        raise ValueError(f"rank store width {dim} is not a multiple of 8")
    # the reference's qs.astype(bfloat16), at the store's width
    qb = _pad_to(qs, dim).to(torch.bfloat16).contiguous()
    c = qb.shape[0]
    euclid = metric == EUCLIDEAN
    if euclid:
        x2 = x2.to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.to(torch.uint8).contiguous()
    out = torch.empty((c, n), dtype=torch.float32, device=qb.device)
    fn = compile_cache.declare(
        compile_cache.library("rank_rescore.cu"), "rank_scores_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    err = fn(xs_rank.data_ptr(), qb.data_ptr(),
             x2.data_ptr() if euclid else None, _ptr(valid),
             out.data_ptr(), n, c, dim, int(euclid), _stream(qb))
    compile_cache.check(err, "rank_scores_bf16")
    kernelstats.note_launch("rank_scores_bf16")
    return out


def rank_scores(xs_rank, qs, metric: str, x2=None, valid=None):
    if xs_rank.is_cuda:
        return rank_scores_bf16(xs_rank, qs, metric, x2, valid)
    return rank_scores_plain(xs_rank, qs, metric, x2, valid)


def gather_rescore_plain(xs_full, qs, cand, metric: str, norms=None,
                         valid=None):
    """Plain version: gather [C, kc, D] rows, exact f32 distances."""
    rows = xs_full[cand.long()]
    if metric == EUCLIDEAN:
        diff = rows - qs[:, None, :]
        d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    else:
        dd = torch.einsum("bkd,bd->bk", rows, qs)
        if metric == COSINE:
            qn = torch.clamp(torch.linalg.norm(qs, dim=-1), min=1e-30)
            d = 1.0 - dd / torch.clamp(norms[cand.long()] * qn[:, None],
                                       min=1e-30)
        else:
            d = -dd
    if valid is not None:
        d = torch.where(valid.to(torch.bool)[cand.long()], d,
                        torch.full_like(d, float("inf")))
    return d


def gather_rescore_cuda(xs_full, qs, cand, metric: str, norms=None,
                        valid=None):
    """Launch csrc/rank_rescore.cu gather_rescore -> [C, kc] f32."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (xs_full.is_cuda and qs.is_cuda and cand.is_cuda):
        raise ValueError("gather_rescore takes CUDA tensors")
    xs_full = xs_full.to(torch.float32).contiguous()
    qs = qs.to(torch.float32).contiguous()
    cand = cand.to(torch.int32).contiguous()
    n, dim = xs_full.shape
    c, kc = cand.shape
    if qs.shape != (c, dim):
        raise ValueError(f"query shape {tuple(qs.shape)} for cand {c}x{kc}")
    if metric == COSINE:
        norms = norms.to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.to(torch.uint8).contiguous()
    out = torch.empty((c, kc), dtype=torch.float32, device=qs.device)
    fn = compile_cache.declare(
        compile_cache.library("rank_rescore.cu"), "gather_rescore",
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    err = fn(xs_full.data_ptr(), qs.data_ptr(), cand.data_ptr(),
             norms.data_ptr() if metric == COSINE else None, _ptr(valid),
             out.data_ptr(), n, c, kc, dim, METRIC_CODE[metric],
             _stream(qs))
    compile_cache.check(err, "gather_rescore")
    kernelstats.note_launch("gather_rescore")
    return out


def gather_rescore(xs_full, qs, cand, metric: str, norms=None, valid=None):
    if xs_full.is_cuda:
        return gather_rescore_cuda(xs_full, qs, cand, metric, norms, valid)
    return gather_rescore_plain(xs_full, qs, cand, metric, norms, valid)


def knn_rank_rescore(xs_rank, xs_full, qs_r, k: int, kc: int,
                     metric: str = EUCLIDEAN, x2=None, norms=None,
                     valid=None):
    """Two-stage KNN for euclidean/cosine/dot. Per query chunk of
    `qs_r` ([R, C, D] f32): bf16 rank scores over the whole store, the
    exact kc best candidates, their exact f32 rescore, the exact top k
    of those. Returns (dists [R, C, k] f32, ids [R, C, k] int32).
    `x2` f32 row norms^2 (euclidean), `norms` f32 row norms (cosine)."""
    n = xs_rank.shape[0]
    dev = qs_r.device
    if x2 is None and metric == EUCLIDEAN:
        x2 = torch.zeros((n,), dtype=torch.float32, device=dev)
    if norms is None and metric == COSINE:
        norms = torch.ones((n,), dtype=torch.float32, device=dev)
    d_parts, i_parts = [], []
    for qs in qs_r.to(torch.float32):
        score = rank_scores(xs_rank, qs, metric, x2, valid)
        _, cand = top_k_smallest(score, kc)
        del score
        d = gather_rescore(xs_full, qs, cand, metric, norms, valid)
        dk, ik = top_k_smallest(d, k, ids=cand)
        d_parts.append(dk)
        i_parts.append(ik)
    return torch.stack(d_parts), torch.stack(i_parts)


# -- int8 ranking store --------------------------------------------------------

# the int8 kernels read rows 16 bytes at a time: stores and queries are
# padded with zero columns to a multiple of this (zeros add nothing to a
# dot product and never raise a row's max |x|)
INT8_ALIGN = 16


def int8_width(dim: int) -> int:
    return -(-dim // INT8_ALIGN) * INT8_ALIGN


def _full(t, value: float):
    """`value` as a tensor of t's shape: dividing by it is an IEEE
    division (torch turns `scalar / tensor` into reciprocal-multiply,
    and a division by a scalar into a multiply by its reciprocal on the
    card), as numpy and XLA divide."""
    return torch.full_like(t, value)


def quantize_rows_plain(rows, metric: str, width: int):
    """Plain version of the reference's int8 store quantisation
    (device/vecstore.py int8 branch): f64 row statistics, cosine rows
    divided by their f32 norms, per-row scale m = max(max|x|, 1e-30),
    x8 = rint(x * (127 / m)), arow = m / 127. Returns (x8 [N, width]
    int8, arow [N] f32, x2 [N] f32, zeros unless euclidean)."""
    r64 = rows.to(torch.float64)
    ss = (r64 * r64).sum(1)
    x2 = ss.to(torch.float32) if metric == EUCLIDEAN else torch.zeros_like(
        ss, dtype=torch.float32)
    blk = rows.to(torch.float32)
    if metric == COSINE:
        norms = torch.clamp(torch.sqrt(ss), min=1e-30).to(torch.float32)
        blk = blk / norms[:, None]
    m = torch.clamp(blk.abs().amax(1) if blk.shape[1] else
                    blk.new_zeros(blk.shape[0]), min=1e-30)
    x8 = torch.round(blk * (_full(m, 127.0) / m)[:, None]).to(torch.int8)
    if width > x8.shape[1]:
        x8 = torch.nn.functional.pad(x8, (0, width - x8.shape[1]))
    return x8, m / _full(m, 127.0), x2


def quantize_rows_int8(rows, metric: str, x8, arow, x2):
    """Launch csrc/rank_int8.cu quantize_rows_int8: quantise the CUDA
    rows [R, D] (f32 or f64) into x8 [R, W] (W >= D, zero columns past
    D), arow [R] and, for euclidean, x2 [R] (caller's slices)."""
    from surrealdb_tpu_torch.device import compile_cache

    if not rows.is_cuda or rows.dim() != 2:
        raise ValueError("quantize_rows_int8 takes a 2-D CUDA tensor")
    if rows.dtype not in (torch.float32, torch.float64):
        rows = rows.to(torch.float64)
    rows = rows.contiguous()
    n, dim = rows.shape
    width = x8.shape[1]
    for t, shape in ((x8, (n, width)), (arow, (n,)), (x2, (n,))):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"output shape {tuple(t.shape)} != {shape}")
    fn = compile_cache.declare(
        compile_cache.library("rank_int8.cu"), "quantize_rows_int8",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p])
    err = fn(rows.data_ptr(), int(rows.dtype == torch.float64), n, dim,
             width, METRIC_CODE[metric], x8.data_ptr(), arow.data_ptr(),
             x2.data_ptr(), _stream(rows))
    compile_cache.check(err, "quantize_rows_int8")
    kernelstats.note_launch("quantize_rows_int8")


def quantize_rows(rows, metric: str, x8, arow, x2):
    """Fill the int8 store slices x8/arow/x2 from `rows` (the kernel on
    the card, the plain version on the CPU)."""
    if rows.is_cuda:
        quantize_rows_int8(rows, metric, x8, arow, x2)
        return
    q, a, s = quantize_rows_plain(rows, metric, x8.shape[1])
    x8.copy_(q)
    arow.copy_(a)
    x2.copy_(s)


def _int8_dots(x8, q8):
    """Exact int32 products [C, N] of int8 rows, rounded to f32 as the
    reference's `dots.astype(float32)` rounds them, through an f64
    product in row blocks (exact at any width: |dot| <= 127^2 D stays
    far below 2^53)."""
    step = max(1, (256 << 20) // max(8 * x8.shape[1], 1))
    qd = q8.to(torch.float64)
    return torch.cat([
        (qd @ x8[s:s + step].to(torch.float64).T).to(torch.float32)
        for s in range(0, x8.shape[0], step)
    ] or [qd.new_zeros((q8.shape[0], 0), dtype=torch.float32)], dim=1)


def quantize_queries_plain(qs):
    """(q8 int8, sq f32): sq = 127 / max(|q|, 1e-30), q8 = round(q sq)
    (half to even, as jnp.round)."""
    m = torch.clamp(qs.abs().amax(1), min=1e-30)
    sq = _full(m, 127.0) / m
    return torch.round(qs * sq[:, None]).to(torch.int8), sq


def rank_scores_int8_plain(x8, qs, metric: str, arow, x2=None, valid=None,
                           probe_order: bool = False):
    """Plain version: the reference's query quantisation, the exact
    int8 product, its dequantisation order (knn_rank_int8:
    dots * (arow / sq); the ANN probe: dots * (arow * (1 / sq))), the
    score epilogue and the mask."""
    qs = _pad_to(qs.to(torch.float32), x8.shape[1])
    q8, sq = quantize_queries_plain(qs)
    dots = _int8_dots(x8, q8)
    if probe_order:
        scale = arow[None, :] * (_full(sq, 1.0) / sq)[:, None]
    else:
        scale = arow[None, :] / sq[:, None]
    approx = dots * scale
    score = x2[None, :] - 2.0 * approx if metric == EUCLIDEAN else -approx
    if valid is not None:
        score = torch.where(valid.to(torch.bool)[None, :], score,
                            torch.full_like(score, float("inf")))
    return score


def rank_scores_int8(x8, qs, metric: str, arow, x2=None, valid=None,
                     probe_order: bool = False):
    """Launch csrc/rank_int8.cu rank_scores_int8 -> [C, N] f32."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (x8.is_cuda and qs.is_cuda):
        raise ValueError("rank_scores_int8 takes CUDA tensors")
    if x8.dtype != torch.int8 or x8.dim() != 2 or not x8.is_contiguous():
        raise ValueError("int8 store must be a contiguous 2-D int8 tensor")
    n, width = x8.shape
    if width % INT8_ALIGN:
        raise ValueError(f"int8 store width {width} is not a multiple of "
                         f"{INT8_ALIGN}")
    qs = _pad_to(qs.to(torch.float32), width).contiguous()
    c = qs.shape[0]
    euclid = metric == EUCLIDEAN
    arow = arow.to(torch.float32).contiguous()
    if euclid:
        x2 = x2.to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.to(torch.uint8).contiguous()
    out = torch.empty((c, n), dtype=torch.float32, device=qs.device)
    # the queries quantised once: int8 rows and their scales
    q8 = torch.empty((c, width), dtype=torch.int8, device=qs.device)
    qscale = torch.empty((c,), dtype=torch.float32, device=qs.device)
    fn = compile_cache.declare(
        compile_cache.library("rank_int8.cu"), "rank_scores_int8",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    err = fn(x8.data_ptr(), qs.data_ptr(), arow.data_ptr(),
             x2.data_ptr() if euclid else None, _ptr(valid), out.data_ptr(),
             q8.data_ptr(), qscale.data_ptr(), n, c, width, int(euclid),
             int(probe_order), _stream(qs))
    compile_cache.check(err, "rank_scores_int8")
    kernelstats.note_launch("rank_scores_int8")
    return out


def rank_int8(x8, qs, metric: str, arow, x2=None, valid=None,
              probe_order: bool = False):
    if x8.is_cuda:
        return rank_scores_int8(x8, qs, metric, arow, x2, valid, probe_order)
    return rank_scores_int8_plain(x8, qs, metric, arow, x2, valid,
                                  probe_order)


def knn_rank_int8(x8, arow, x2, valid, qs_r, kc: int,
                  metric: str = EUCLIDEAN):
    """Candidate ranking over the int8 store (the reference's
    knn_rank_int8): per query chunk of `qs_r` ([R, C, D] f32), int8
    scores over the whole store and the exact kc best (ties to the
    lower index, in place of approx_max_k). Returns int32 [R, C, kc];
    the exact rescore happens on the serving side."""
    parts = []
    for qs in qs_r.to(torch.float32):
        score = rank_int8(x8, qs, metric, arow, x2, valid)
        _, cand = top_k_smallest(score, kc)
        del score
        parts.append(cand)
    return torch.stack(parts)
