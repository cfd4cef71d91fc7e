"""Top-k selection and the KNN kernels built on it (the reference's
`ops/topk.py`).

Every function takes and returns tensors on one device. On a CUDA
tensor each kernel wrapper launches its kernel (csrc/select.cu,
csrc/rank_rescore.cu, csrc/rank_int8.cu, and csrc/distance.cu through
`ops.distance.distance_matrix`); on a CPU tensor it runs the plain
PyTorch version beside it. Ties go to the lower index, as
`jax.lax.top_k` breaks them; the plain versions get that from a stable
sort.
"""

from __future__ import annotations

import ctypes
import functools

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


# few rows over many entries: the select kernel splits each row over
# blocks of at least this many entries, and gathers the entries at or
# below the k-th's radix bin into a per-row buffer of at least this size
# (csrc/select.cu; the per-row workspace is csrc/kernels.h
# SURREAL_SELECT_WORK_U32 u32)
SELECT_BLOCK_MIN = 16384
SELECT_GATHER_MIN = 1 << 16
# rows shorter than this take one block each: the split's six launches
# cost more than they save there
SELECT_SPLIT_MIN = 1 << 19
SELECT_WORK_U32 = 5124


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def select_plan(rows: int, n: int, k: int, sms: int):
    """(blocks per row, gather buffer entries) of the select kernel for
    `rows` rows of `n` entries on a card of `sms` SMs: one block a row
    (0 entries) once the rows fill the SMs or a row is short, else
    enough blocks a row for about two per SM."""
    if rows >= sms or n < SELECT_SPLIT_MIN:
        return 1, 0
    g = min(-(-2 * sms // rows), n // SELECT_BLOCK_MIN)
    if g <= 1:
        return 1, 0
    return g, min(n, max(SELECT_GATHER_MIN, 4 * k))


def _select_buffers(rows: int, n: int, k: int, device):
    """The select kernel's device buffers: the large-k sort scratch
    ([rows, pow2 >= k] u64) and, split over blocks, the per-row
    workspace and gather buffer. Returns the argument tail of both
    select entries (scratch, scratch_ld, blocks_per_row, work, gather,
    gather_cap) and the tensors that must outlive the launch."""
    scratch, scratch_ld = None, 0
    if k > SELECT_MAX_K:
        scratch_ld = 1 << (k - 1).bit_length()
        scratch = torch.empty((rows, scratch_ld), dtype=torch.int64,
                              device=device)
    g, gcap = select_plan(rows, n, k, _sm_count(device.index or 0))
    work = gather = None
    if g > 1:
        work = torch.empty((rows, SELECT_WORK_U32), dtype=torch.int32,
                           device=device)
        gather = torch.empty((rows, gcap), dtype=torch.int64, device=device)
    args = (_ptr(scratch), scratch_ld, g, _ptr(work), _ptr(gather), gcap)
    return args, (scratch, work, gather)


_SELECT_TAIL = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]


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
    tail, _keep = _select_buffers(rows, n, k, vals.device)
    fn = compile_cache.declare(
        compile_cache.library("select.cu"), "select_topk_rows",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p] + _SELECT_TAIL)
    err = fn(vals.data_ptr(), n, _ptr(ids), n, rows, n, k,
             out_v.data_ptr(), out_i.data_ptr(), *tail, _stream(vals))
    compile_cache.check(err, "select_topk_rows")
    kernelstats.note_launch("select_topk_rows")
    return out_v, out_i


def order_key_plain(vals):
    """The kernels' order-preserving uint32 of f32 values (-0.0 and
    +0.0 share one), as int64."""
    bits = torch.where(vals == 0, torch.zeros_like(vals), vals).view(
        torch.int32).to(torch.int64)
    return torch.where(bits < 0, -1 - bits, bits + (1 << 31))


def key_value_plain(keys):
    """The f32 value of order keys (int64 in [0, 2^32))."""
    bits = torch.where(keys >= (1 << 31), keys - (1 << 31), -1 - keys)
    return bits.to(torch.int32).view(torch.float32)


def pack_pairs_plain(keys, ids):
    """(order key << 32 | id) as the kernels write them, in int64."""
    signed = torch.where(keys >= (1 << 31), keys - (1 << 32), keys)
    return (signed << 32) | ids.to(torch.int64)


# the pair select (csrc/select.cu select_pairs_kernel, one block a row)
# keeps its buffer in shared memory up to PAIR_SMEM_KEYS keys (PBUF_SMEM
# there), else in a [rows, buffer] device scratch the wrapper allocates
PAIR_SMEM_KEYS = 8192


def pair_select_plan(k: int):
    """(buffer keys, scratch keys a row) of select_topk_pairs for k: the
    buffer holds the keys a row's block sorts (its k smallest and the
    rest of a guess or of a histogram bin), a power of two of at least
    1.25 k and 64 keys; scratch only past PAIR_SMEM_KEYS."""
    buf = max(64, 1 << (k + k // 4 - 1).bit_length())
    return buf, (0 if buf <= PAIR_SMEM_KEYS else buf)


def top_k_pairs_plain(pairs, counts, k: int):
    """Plain version of select_topk_pairs: per row the k smallest of
    pairs[r, :min(counts[r], cap)] by (value, id) -> (values [R, k] f32,
    ids [R, k] int32); a row with fewer than k pairs gives (+inf, -1)."""
    rows, cap = pairs.shape
    out_v = torch.full((rows, k), float("inf"), dtype=torch.float32,
                       device=pairs.device)
    out_i = torch.full((rows, k), -1, dtype=torch.int32, device=pairs.device)
    for r in range(rows):
        m = min(int(counts[r]), cap)
        if m < k:
            continue
        p = pairs[r, :m]
        keys, ids = (p >> 32) & 0xFFFFFFFF, p & 0xFFFFFFFF
        order = torch.sort(ids, stable=True).indices
        order = order[torch.sort(keys[order], stable=True).indices][:k]
        out_v[r] = key_value_plain(keys[order])
        out_i[r] = ids[order].to(torch.int32)
    return out_v, out_i


def select_topk_pairs(pairs, counts, k: int):
    """Launch csrc/select.cu select_topk_pairs on CUDA pairs [R, cap]
    (int64 holding the u64 (order key << 32 | id)) with counts [R];
    rows with fewer than k pairs give (+inf, -1), written by the
    kernel."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (pairs.is_cuda and counts.is_cuda) or pairs.dim() != 2:
        raise ValueError("select_topk_pairs takes CUDA tensors")
    rows, cap = pairs.shape
    if not 1 <= k <= cap:
        raise ValueError(f"select_topk_pairs: k={k} outside 1..{cap}")
    pairs = pairs.contiguous()
    counts = counts.to(torch.int32).contiguous()
    out_v = torch.empty((rows, k), dtype=torch.float32, device=pairs.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=pairs.device)
    if rows == 0:
        return out_v, out_i
    buf, scratch_keys = pair_select_plan(k)
    scratch = (torch.empty((rows, scratch_keys), dtype=torch.int64,
                           device=pairs.device) if scratch_keys else None)
    fn = compile_cache.declare(
        compile_cache.library("select.cu"), "select_topk_pairs",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p])
    err = fn(pairs.data_ptr(), cap, counts.data_ptr(), rows, k, buf,
             out_v.data_ptr(), out_i.data_ptr(), _ptr(scratch),
             _stream(pairs))
    compile_cache.check(err, "select_topk_pairs")
    kernelstats.note_launch("select_topk_pairs")
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
               valid=None, xstats=None):
    """Distance + validity mask (+inf) + top-k; `xstats` the rows'
    cached `ops.distance.row_stats`."""
    return top_k_smallest(distance_matrix(xs, qs, metric, p, valid, xstats),
                          k)


def knn_search_blocked(xs, qs, k: int, metric: str = EUCLIDEAN,
                       p: float = 3.0, valid=None, block: int = 65536,
                       xstats=None):
    """Blockwise scan with a running exact top-k (peak [B, block]): the
    same two kernels per block (each block's slice of the cached
    `xstats`), then a selection over [best, block] candidates through an
    id map. The running best starts as (+inf, -1), as the reference's
    does."""
    n = xs.shape[0]
    b = qs.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                        device=qs.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=qs.device)
    for base in range(0, n, block):
        blk = xs[base:base + block]
        vmask = None if valid is None else valid[base:base + block]
        st = None if xstats is None else xstats[base:base + block]
        d = distance_matrix(blk, qs, metric, p, vmask, st)
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


def knn_rank_approx(xs, qs_r, k: int, metric: str = EUCLIDEAN, x2=None,
                    valid=None):
    """Candidate ranking alone over R query batches in one call: per
    batch of `qs_r` ([R, B, D] f32) the bf16 rank scores over the whole
    store `xs` ([N, D] bfloat16; normalised rows for cosine) and their
    exact k best -> ids [R, B, k] int32. The reference selects with
    `approx_max_k`, which is exact off the TPU; the port selects
    exactly everywhere. `x2` f32 row norms^2 (euclidean)."""
    n = xs.shape[0]
    if x2 is None and metric == EUCLIDEAN:
        x2 = torch.zeros((n,), dtype=torch.float32, device=xs.device)
    out = []
    for qs in qs_r.to(torch.float32):
        score = rank_scores(xs, qs, metric, x2, valid)
        out.append(top_k_smallest(score, k)[1])
        del score
    return torch.stack(out)


def jax_rows(ids, n: int):
    """Row indices by JAX's gather rule: an id in [-n, 0) wraps to
    id + n, then every id is clamped to [0, n - 1] (csrc/kernels.h
    surreal_jax_row)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def gather_rescore_plain(xs_full, qs, cand, metric: str, norms=None,
                         valid=None):
    """Plain version: gather [C, kc, D] rows (JAX's index rule), exact
    f32 distances."""
    rows_ix = jax_rows(cand, xs_full.shape[0])
    rows = xs_full[rows_ix]
    if metric == EUCLIDEAN:
        diff = rows - qs[:, None, :]
        d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    else:
        dd = torch.einsum("bkd,bd->bk", rows, qs)
        if metric == COSINE:
            qn = torch.clamp(torch.linalg.norm(qs, dim=-1), min=1e-30)
            d = 1.0 - dd / torch.clamp(norms[rows_ix] * qn[:, None],
                                       min=1e-30)
        else:
            d = -dd
    if valid is not None:
        d = torch.where(valid.to(torch.bool)[rows_ix], d,
                        torch.full_like(d, float("inf")))
    return d


def gather_rescore_topk_plain(xs_full, qs, cand, metric: str, k: int,
                              norms=None, valid=None):
    """Plain version of the fused rescore: the [C, kc] distances, then
    their k smallest by (value, column), ids through cand -> (values
    [C, k] f32, ids [C, k] int32)."""
    return top_k_smallest_plain(
        gather_rescore_plain(xs_full, qs, cand, metric, norms, valid), k,
        ids=cand)


# gather_rescore's launch (csrc/rank_rescore.cu): four warps a block,
# four rows staged in shared memory a warp; a query's columns over a
# cluster of up to RESCORE_MAX_CLUSTER blocks; the fused top k takes kc
# up to RESCORE_TOPK_MAX_KC (a larger kc goes to the [C, kc] output and
# select_topk_rows). The kernel's entry refuses more of either
# (GR_MAX_CLUSTER, GR_MAX_KC there).
RESCORE_MAX_CLUSTER = 8
RESCORE_BLOCK_ROWS = 8
RESCORE_TOPK_MAX_KC = 2048


def rescore_plan(c: int, kc: int, sms: int) -> int:
    """Blocks a query of gather_rescore for c queries of kc candidates
    on a card of `sms` SMs: about two blocks an SM over the queries, at
    most RESCORE_MAX_CLUSTER, each with at least RESCORE_BLOCK_ROWS
    columns (two for each of its warps)."""
    return max(1, min(RESCORE_MAX_CLUSTER, -(-2 * sms // max(c, 1)),
                      -(-kc // RESCORE_BLOCK_ROWS)))


def _gather_rescore_launch(xs_full, qs, cand, metric: str, k: int, norms,
                           valid):
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
    dev = qs.device
    out = vals = ids = None
    if k:
        vals = torch.empty((c, k), dtype=torch.float32, device=dev)
        ids = torch.empty((c, k), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((c, kc), dtype=torch.float32, device=dev)
    fn = compile_cache.declare(
        compile_cache.library("rank_rescore.cu"), "gather_rescore",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    err = fn(xs_full.data_ptr(), qs.data_ptr(), cand.data_ptr(),
             norms.data_ptr() if metric == COSINE else None, _ptr(valid),
             _ptr(out), _ptr(vals), _ptr(ids), n, c, kc, dim, k,
             METRIC_CODE[metric],
             rescore_plan(c, kc, _sm_count(dev.index or 0)), _stream(qs))
    compile_cache.check(err, "gather_rescore")
    kernelstats.note_launch("gather_rescore")
    if k:
        kernelstats.note_launch("gather_rescore_topk")
        return vals, ids
    return out


def gather_rescore_cuda(xs_full, qs, cand, metric: str, norms=None,
                        valid=None):
    """Launch csrc/rank_rescore.cu gather_rescore -> [C, kc] f32."""
    return _gather_rescore_launch(xs_full, qs, cand, metric, 0, norms, valid)


def gather_rescore_topk_cuda(xs_full, qs, cand, metric: str, k: int,
                             norms=None, valid=None):
    """Launch csrc/rank_rescore.cu gather_rescore with the final top k
    fused in (kc <= RESCORE_TOPK_MAX_KC) -> (values [C, k] f32, ids
    [C, k] int32)."""
    return _gather_rescore_launch(xs_full, qs, cand, metric, k, norms, valid)


def gather_rescore(xs_full, qs, cand, metric: str, norms=None, valid=None):
    if xs_full.is_cuda:
        return gather_rescore_cuda(xs_full, qs, cand, metric, norms, valid)
    return gather_rescore_plain(xs_full, qs, cand, metric, norms, valid)


def gather_rescore_topk(xs_full, qs, cand, metric: str, k: int, norms=None,
                        valid=None):
    """The exact rescore of the candidates and its k best by (distance,
    column): one launch up to RESCORE_TOPK_MAX_KC candidates, past it
    the [C, kc] rescore and select_topk_rows (counted as the event
    rescore_select_route)."""
    if cand.shape[1] > RESCORE_TOPK_MAX_KC:
        kernelstats.note_event("rescore_select_route")
        return top_k_smallest(
            gather_rescore(xs_full, qs, cand, metric, norms, valid), k,
            ids=cand)
    if xs_full.is_cuda:
        return gather_rescore_topk_cuda(xs_full, qs, cand, metric, k, norms,
                                        valid)
    return gather_rescore_topk_plain(xs_full, qs, cand, metric, k, norms,
                                     valid)


def knn_rank_rescore(xs_rank, xs_full, qs_r, k: int, kc: int,
                     metric: str = EUCLIDEAN, x2=None, norms=None,
                     valid=None):
    """Two-stage KNN for euclidean/cosine/dot. Per query chunk of
    `qs_r` ([R, C, D] f32): bf16 rank scores over the whole store, the
    exact kc best candidates, their exact f32 rescore with the exact top
    k of those in the same launch (`gather_rescore_topk`). Returns (dists [R, C, k] f32, ids [R, C, k] int32).
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
        dk, ik = gather_rescore_topk(xs_full, qs, cand, metric, k, norms,
                                     valid)
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


def int8_sample_rows(n_out: int, tile_step: int, device=None):
    """The store rows of a strided sample of whole store tiles: output
    tile t is store tile t * tile_step (tile_step 1: every row)."""
    t = torch.arange(n_out // INT8_TILE, device=device) * (
        tile_step * INT8_TILE)
    return (t[:, None] + torch.arange(INT8_TILE, device=device)).reshape(-1)


def _int8_args(x8, qs, metric, arow, x2, valid):
    """The int8 kernels' operands, checked: (x8, qs padded to the store
    width, arow, x2 or None, valid as uint8 or None, euclid)."""
    if x8.dtype != torch.int8 or x8.dim() != 2 or not x8.is_contiguous():
        raise ValueError("int8 store must be a contiguous 2-D int8 tensor")
    if x8.shape[1] % INT8_ALIGN:
        raise ValueError(f"int8 store width {x8.shape[1]} is not a "
                         f"multiple of {INT8_ALIGN}")
    euclid = metric == EUCLIDEAN
    if qs is not None:
        qs = _pad_to(qs.to(torch.float32), x8.shape[1]).contiguous()
    arow = _aligned(arow.to(torch.float32).contiguous())
    x2 = _aligned(x2.to(torch.float32).contiguous()) if euclid else None
    if valid is not None:
        valid = _aligned(valid.to(torch.uint8).contiguous())
    return x8, qs, arow, x2, valid, euclid


def _aligned(t):
    """t, or a copy of it when its data is not 16-byte aligned (the
    kernels fetch per-row scales and mask bytes 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def int8_query_scratch(c: int, width: int, device):
    """The int8 kernels' quantised queries: q8 [C, W] int8, sq [C]."""
    return (torch.empty((c, width), dtype=torch.int8, device=device),
            torch.empty((c,), dtype=torch.float32, device=device))


def rank_scores_int8(x8, qs, metric: str, arow, x2=None, valid=None,
                     probe_order: bool = False, sample=None, q8=None,
                     qscale=None):
    """Launch csrc/rank_int8.cu rank_scores_int8 -> [C, N] f32 (or
    [C, S] over the strided sample `sample` = (S, tile_step)). The
    quantised queries go to q8 / qscale when given (the candidates pass
    reuses them)."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (x8.is_cuda and qs.is_cuda):
        raise ValueError("rank_scores_int8 takes CUDA tensors")
    x8, qs, arow, x2, valid, euclid = _int8_args(x8, qs, metric, arow, x2,
                                                 valid)
    n, width = x8.shape
    c = qs.shape[0]
    n_out, step = sample if sample is not None else (n, 1)
    out = torch.empty((c, n_out), dtype=torch.float32, device=qs.device)
    if q8 is None:
        q8, qscale = int8_query_scratch(c, width, qs.device)
    fn = compile_cache.declare(
        compile_cache.library("rank_int8.cu"), "rank_scores_int8",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    err = fn(x8.data_ptr(), qs.data_ptr(), arow.data_ptr(), _ptr(x2),
             _ptr(valid), out.data_ptr(), q8.data_ptr(), qscale.data_ptr(),
             n, n_out, step, c, width, int(euclid), int(probe_order),
             _stream(qs))
    compile_cache.check(err, "rank_scores_int8")
    kernelstats.note_launch("rank_scores_int8")
    return out


def rank_int8(x8, qs, metric: str, arow, x2=None, valid=None,
              probe_order: bool = False, sample=None, plain=None):
    if x8.is_cuda and not plain:
        return rank_scores_int8(x8, qs, metric, arow, x2, valid, probe_order,
                                sample)
    if sample is not None:
        rows = int8_sample_rows(*sample, device=x8.device)
        x8, arow = x8[rows], arow[rows]
        x2 = x2[rows] if x2 is not None else None
        valid = valid[rows] if valid is not None else None
    return rank_scores_int8_plain(x8, qs, metric, arow, x2, valid,
                                  probe_order)


def rank_candidates_plain(x8, qs, metric: str, arow, x2, valid, thr,
                          cap: int):
    """Plain version of rank_candidates_int8: every store row whose
    score's order key is at or below thr[c]'s, as (order key << 32 |
    row) pairs in row order -> (pairs [C, cap] int64, padded with -1;
    counts [C] int32, also past cap)."""
    c, n = qs.shape[0], x8.shape[0]
    kt = order_key_plain(thr.to(torch.float32))
    pairs = torch.full((c, cap), -1, dtype=torch.int64, device=qs.device)
    counts = torch.zeros((c,), dtype=torch.int64, device=qs.device)
    step = max(INT8_TILE, (1 << 24) // max(c, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        keys = order_key_plain(rank_scores_int8_plain(
            x8[s:e], qs, metric, arow[s:e],
            x2[s:e] if x2 is not None else None,
            valid[s:e] if valid is not None else None))
        q, j = torch.nonzero(keys <= kt[:, None], as_tuple=True)
        got = torch.bincount(q, minlength=c)
        pos = counts[q] + (torch.arange(q.numel(), device=qs.device)
                           - (torch.cumsum(got, 0) - got)[q])
        fit = pos < cap
        pairs[q[fit], pos[fit]] = pack_pairs_plain(keys[q, j], j + s)[fit]
        counts += got
    return pairs, counts.to(torch.int32)


# the candidates pass's resident route (csrc/rank_int8.cu
# cand_int8_kernel): a block holds 128 queries (two halves of 64; one
# half when C <= 64), a cluster of up to four blocks a launch of 512
# queries; its ring stages are 16 KB k-steps of 128 store rows, as many
# as shared memory holds beside the queries and the fixed part (alignment
# slack, the consumers' columns, the eight consumer warps' areas (queue
# of value groups, tags, survivor list: CT_WAREA), the per-query
# constants and counters: CT_FIXED), between 3 and 8
CAND_SLAB = 128
CAND_LAUNCH = 512
CAND_STAGE_BYTES = 128 * 128
CAND_FIXED_BYTES = 1024 + 2 * 3 * 128 * 4 \
    + 8 * (128 * 32 + 128 * 4 + 64 * 8 + 16) + 4 * 128 * 4 + 2 * 2 * 128 * 4
CAND_SMEM_BYTES = 227 * 1024
CAND_STAGES = (3, 8)


def candidates_plan(c: int, width: int):
    """(cluster blocks, query halves of 64 a block, ring stages) of the
    candidates pass for 1 <= c <= 512 queries over int8 rows `width`
    columns wide: ceil(c / 128) blocks, one half when c <= 64. Stages 0
    (with (1, 0)) is the streamed route: the block's queries and three
    stages do not fit in shared memory (rows past 1024 columns)."""
    if not 1 <= c <= CAND_LAUNCH:
        raise ValueError(f"{c} queries: a candidates launch takes 1.."
                         f"{CAND_LAUNCH}")
    halves = 1 if c <= 64 else 2
    ktiles = -(-width // 128)
    free = (CAND_SMEM_BYTES - CAND_FIXED_BYTES
            - ktiles * halves * 64 * 128)
    stages = min(CAND_STAGES[1], free // CAND_STAGE_BYTES)
    if stages < CAND_STAGES[0]:
        return 1, 0, 0
    return -(-c // CAND_SLAB), halves, stages


def rank_candidates_int8(x8, q8, qscale, metric: str, arow, x2, valid, thr,
                         cap: int):
    """Launch csrc/rank_int8.cu rank_candidates_int8 with the queries
    quantised by an earlier rank_scores_int8 into q8 / qscale (one
    launch per 512 queries, each as candidates_plan sizes it) ->
    (pairs [C, cap] int64 holding u64 (order key << 32 | row), in no
    order; counts [C] int32, also past cap)."""
    from surrealdb_tpu_torch.device import compile_cache

    if not (x8.is_cuda and q8.is_cuda):
        raise ValueError("rank_candidates_int8 takes CUDA tensors")
    x8, _, arow, x2, valid, euclid = _int8_args(x8, None, metric, arow, x2,
                                                valid)
    n, width = x8.shape
    c = q8.shape[0]
    thr = thr.to(torch.float32).contiguous()
    pairs = torch.empty((c, cap), dtype=torch.int64, device=q8.device)
    counts = torch.empty((c,), dtype=torch.int32, device=q8.device)
    # euclidean: each 256-row tile's least x2, in the kernel's integer
    # floor of the dots that can reach T (padding rows do not lower it)
    x2min = (torch.nn.functional.pad(x2, (0, -n % INT8_TILE),
                                     value=float("inf"))
             .view(-1, INT8_TILE).amin(1) if euclid else None)
    fn = compile_cache.declare(
        compile_cache.library("rank_int8.cu"), "rank_candidates_int8",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    for s in range(0, c, CAND_LAUNCH):
        e = min(s + CAND_LAUNCH, c)
        err = fn(x8.data_ptr(), None, arow.data_ptr(), _ptr(x2),
                 _ptr(valid), thr[s:e].data_ptr(), pairs[s:e].data_ptr(),
                 counts[s:e].data_ptr(), cap, _ptr(x2min),
                 q8[s:e].data_ptr(), qscale[s:e].data_ptr(), n, e - s,
                 width, int(euclid), *candidates_plan(e - s, width),
                 _stream(q8))
        compile_cache.check(err, "rank_candidates_int8")
        kernelstats.note_launch("rank_candidates_int8")
    return pairs, counts


# -- one pass over the int8 store for a whole query frame ----------------------

# store rows a tile of the int8 rank kernel (csrc/rank_int8.cu BN): the
# threshold sample is whole tiles
INT8_TILE = 256


# the threshold path's shape rule: a sample of fewer than this many rows
# per candidate leaves more than 1/64 of the store (kc n / S rows) above
# nothing but T, and the candidates pass is then slower than the chunked
# path's one read of the store (a small store, or a mesh shard of one)
INT8_SAMPLE_PER_KC = 64


def int8_candidate_plan(n: int, c: int, kc: int, budget_elems: int,
                        cap=None):
    """(S, tile_step, cap) of the threshold path for c queries over n
    rows, or None where the chunked path serves them: S sample rows,
    min(n / 8, budget / c) rounded down to whole store tiles, every
    tile_step-th tile of the store; cap the per-query candidate buffer,
    about 4x the expected kc n / S survivors as a power of two (at most
    n). The shape rule: S < 64 kc (small stores) takes the chunked
    path."""
    stiles = min(n // 8, budget_elems // max(c, 1)) // INT8_TILE
    s = stiles * INT8_TILE
    if s < INT8_SAMPLE_PER_KC * kc:
        return None
    step = (n // INT8_TILE) // stiles
    if cap is None:
        want = -(-4 * kc * n // s)
        cap = min(1 << (want - 1).bit_length(), n)
    return s, step, int(cap)


def int8_query_group(n: int, c: int, kc: int, budget_elems: int) -> int:
    """Queries a candidates pass takes at once: all c unless their
    [group, cap] pair buffer (8 bytes an entry) would outgrow what the
    chunked path held (budget f32 scores + their int32 twin, 8 bytes an
    element): then the largest power of two that fits. All c when no
    group size gets a plan (the chunked path chunks by the budget)."""
    g = 1 << (max(c, 1) - 1).bit_length()
    while g >= 1:
        plan = int8_candidate_plan(n, min(g, c), kc, budget_elems)
        if plan is not None and min(g, c) * plan[2] <= budget_elems:
            return min(g, c)
        g //= 2
    return c


def _int8_chunked(x8, arow, x2, valid, qs, kc, metric, budget_elems,
                  plain):
    """The exact chunked path: int8 scores of query chunks over the
    whole store ([chunk, N] under budget_elems) and their kc best."""
    n = x8.shape[0]
    chunk = 1 << max(0, (max(1, min(budget_elems // max(n, 1),
                                    qs.shape[0]))).bit_length() - 1)
    parts = []
    for s in range(0, qs.shape[0], chunk):
        score = rank_int8(x8, qs[s:s + chunk], metric, arow, x2, valid,
                          plain=plain)
        parts.append(top_k_smallest_plain(score, kc) if plain
                     else top_k_smallest(score, kc))
        del score
    return _cat_parts(parts)


def _cat_parts(parts):
    """(vals, ids) of several query groups, one after another (a single
    group as it is: a small frame pays no copy)."""
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _int8_group_start(x8, arow, x2, valid, qs, kc, metric, budget_elems,
                      cap, plain):
    """Launch one query group's pass (nothing waits for the card): a
    dict for _int8_group_finish."""
    n, width = x8.shape
    c = qs.shape[0]
    job = {"store": (x8, arow, x2, valid), "qs": qs, "kc": kc,
           "metric": metric, "budget": budget_elems, "plain": plain,
           "plan": int8_candidate_plan(n, c, kc, budget_elems, cap)}
    if job["plan"] is None:
        job["out"] = _int8_chunked(x8, arow, x2, valid, qs, kc, metric,
                                   budget_elems, plain)
        return job
    s, step, cap = job["plan"]
    if not plain:
        q8, qscale = int8_query_scratch(c, width, qs.device)
        ss = rank_scores_int8(x8, qs, metric, arow, x2, valid,
                              sample=(s, step), q8=q8, qscale=qscale)
        thr = select_topk_rows(ss, kc)[0][:, kc - 1]
        del ss
        pairs, counts = rank_candidates_int8(x8, q8, qscale, metric, arow,
                                             x2, valid, thr, cap)
        job["out"] = select_topk_pairs(pairs, counts, kc)
    else:
        ss = rank_int8(x8, qs, metric, arow, x2, valid, sample=(s, step),
                       plain=True)
        thr = top_k_smallest_plain(ss, kc)[0][:, kc - 1]
        del ss
        pairs, counts = rank_candidates_plain(
            x8, _pad_to(qs.to(torch.float32), width), metric, arow, x2,
            valid, thr, cap)
        job["out"] = top_k_pairs_plain(pairs, counts, kc)
    job["counts"] = counts
    return job


def _int8_group_finish(job, st):
    """The group's answer: a query whose count passed cap (or, with no
    finite threshold, fell short of kc) takes the exact chunked path,
    decided by the count alone. The one wait for the card is here."""
    vals, ids = job["out"]
    if job["plan"] is None:
        st["chunked"] += job["qs"].shape[0]
        return vals, ids
    s, _, cap = job["plan"]
    counts = job["counts"]
    over = torch.nonzero((counts > cap) | (counts < job["kc"])).reshape(-1)
    st["S"], st["cap"] = s, cap
    st["counts"].append(counts)
    if over.numel():
        st["overflow"] += int(over.numel())
        kernelstats.note_event("int8_overflow_rows", int(over.numel()))
        ov, oi = _int8_chunked(*job["store"], job["qs"][over], job["kc"],
                               job["metric"], job["budget"], job["plain"])
        vals[over], ids[over] = ov, oi
    return vals, ids


def int8_topk_start(x8, arow, x2, valid, qs, kc: int,
                    metric: str = EUCLIDEAN, budget_elems: int = 1 << 28,
                    cap=None, plain=None):
    """Launch `int8_topk`'s passes without waiting for the card (a mesh
    launches every shard's before it takes the first answer); the
    returned jobs go to int8_topk_finish."""
    plain = not x8.is_cuda if plain is None else plain
    n = x8.shape[0]
    c = qs.shape[0]
    kc = min(kc, n)
    group = max(1, int8_query_group(n, c, kc, budget_elems))
    return [_int8_group_start(x8, arow, x2, valid, qs[g:g + group], kc,
                              metric, budget_elems, cap, plain)
            for g in range(0, c, group)] or [
        {"plan": None, "qs": qs, "out": (
            torch.empty((0, kc), device=qs.device),
            torch.empty((0, kc), dtype=torch.int32, device=qs.device))}]


def int8_topk_finish(jobs, stats=None):
    """The answers of int8_topk_start's jobs (overflowing queries
    served by the exact chunked path)."""
    st = {"S": 0, "cap": 0, "overflow": 0, "chunked": 0, "counts": []}
    parts = [_int8_group_finish(job, st) for job in jobs]
    if stats is not None:
        st["counts"] = (torch.cat(st["counts"]).cpu() if st["counts"]
                        else torch.zeros(0, dtype=torch.int32))
        stats.update(st)
    return _cat_parts(parts)


def int8_topk(x8, arow, x2, valid, qs, kc: int, metric: str = EUCLIDEAN,
              budget_elems: int = 1 << 28, cap=None, stats=None,
              plain=None):
    """The kc best rows of the int8 store per query of qs [C, D], exact,
    ordered by (score, row): (scores [C, kc] f32, rows [C, kc] int32).

    One pass over the store for all C queries (as many as
    `int8_query_group` lets share one pair buffer): (1) a strided
    sample of S whole store tiles is scored and its kc-th smallest
    score per query is the threshold T (the kc-th smallest of a subset
    is at or above the store's, so every true candidate, ties at the
    kc-th included, scores at or below T); (2) one candidates pass
    appends every row at or below T to the query's [cap] buffer; (3)
    the kc smallest of those by (score, row). A query whose count
    exceeds cap (or falls short of kc: no finite T) takes the exact
    chunked path, as do all queries of a store too small for the
    sample (S < 64 kc). `budget_elems` bounds the transient memory as
    the chunked path's [chunk, N] scores did; `cap` overrides the
    buffer size (a small one forces the overflow path); `stats` (a
    dict) receives S, cap, the overflow and chunked query counts and
    the per-query survivor counts. On CUDA tensors the kernels run
    unless `plain` asks for the plain versions (the CPU's path)."""
    return int8_topk_finish(int8_topk_start(x8, arow, x2, valid, qs, kc,
                                            metric, budget_elems, cap,
                                            plain), stats)


def int8_candidates(x8, arow, x2, valid, qs, kc: int,
                    metric: str = EUCLIDEAN, budget_elems: int = 1 << 28,
                    cap=None, stats=None):
    """int32 [C, kc]: the kc best store rows per query (`int8_topk`)."""
    return int8_topk(x8, arow, x2, valid, qs, kc, metric, budget_elems, cap,
                     stats)[1]


def int8_candidates_plain(x8, arow, x2, valid, qs, kc: int,
                          metric: str = EUCLIDEAN,
                          budget_elems: int = 1 << 28, cap=None,
                          stats=None):
    """Plain version of int8_candidates (the same sample, cap and
    overflow rules through every kernel's plain version), on the
    tensors' device; a small `cap` forces the overflow path."""
    return int8_topk(x8, arow, x2, valid, qs, kc, metric, budget_elems, cap,
                     stats, plain=True)[1]


def knn_rank_int8(x8, arow, x2, valid, qs_r, kc: int,
                  metric: str = EUCLIDEAN):
    """Candidate ranking over the int8 store (the reference's
    knn_rank_int8) for query chunks qs_r [R, C, D] f32: the chunks'
    queries in one `int8_candidates` call (each query's candidates do
    not depend on its chunk). Returns int32 [R, C, kc]; the exact
    rescore happens on the serving side."""
    r, c = qs_r.shape[0], qs_r.shape[1]
    cand = int8_candidates(x8, arow, x2, valid,
                           qs_r.reshape(r * c, -1).to(torch.float32), kc,
                           metric)
    return cand.reshape(r, c, -1)
