"""The merges of mesh execution: per-shard partial top-k tiles into one
answer, per-shard CSR hop masks into the next frontier (the reference's
`all_gather` + `lax.top_k` and `psum(part) > 0`).

On CUDA tensors each wrapper launches its kernel (csrc/mesh_merge.cu);
on CPU tensors it runs the plain PyTorch version beside it. The
partials arrive on the merging device through `gather_to`.
"""

from __future__ import annotations

import array
import ctypes
import contextlib

import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops.distance import _ptr, _stream

# csrc/kernels.h SURREAL_MERGE_MAX_PARTS / SURREAL_MERGE_SORT_KEYS
MAX_PARTS = 32
SORT_KEYS = 4096
# no clamp of the globalised ids (the legacy sharded store's rule)
NO_CLAMP = (1 << 31) - 1
# merge_partials_topk(table, parts, b, w, k_out, id_max, out_dist,
# out_ids, scratch, scratch_ld, stream)
_MERGE_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])


# -- moving tensors between the shards' devices ------------------------------

def on(device):
    """Make `device` current for the kernels launched inside (a CUDA
    launch goes to the current device); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def move(t, device):
    """`t` on `device`: the same tensor when it is there already, else a
    copy that waits on an event recorded on the source's stream (the
    copy runs after the work that wrote `t`)."""
    if t.device == device:
        return t
    if t.is_cuda and device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(ev)
        with torch.cuda.device(device):
            return t.to(device, non_blocking=True)
    return t.to(device)


def gather_to(tensors, device):
    return [move(t, device) for t in tensors]


# -- partial top-k merge ------------------------------------------------------

def _padded(dists, ids, w):
    """The partials at width w: a part with w_s < w columns gains
    (+inf, local id = column) padding columns."""
    out_d, out_i = [], []
    for d, i in zip(dists, ids):
        ws = d.shape[1]
        if ws < w:
            b = d.shape[0]
            d = torch.cat([d, torch.full((b, w - ws), float("inf"),
                                         dtype=torch.float32,
                                         device=d.device)], dim=1)
            i = torch.cat([i.to(torch.int32), torch.arange(
                ws, w, dtype=torch.int32, device=d.device).expand(b, -1)],
                dim=1)
        out_d.append(d.to(torch.float32))
        out_i.append(i.to(torch.int32))
    return out_d, out_i


def merge_partials_plain(dists, ids, bases, w: int, k_out: int,
                         id_max: int = NO_CLAMP):
    """Plain version: the padded partials concatenated in shard order,
    ids globalised (min(local + base, id_max)), a stable ascending sort,
    the first k_out."""
    pd, pi = _padded(dists, ids, w)
    d_all = torch.cat(pd, dim=1)
    i_all = torch.cat([i.to(torch.int64) + int(base)
                       for i, base in zip(pi, bases)], dim=1)
    i_all = torch.clamp(i_all, max=int(id_max)).to(torch.int32)
    order = torch.sort(d_all, dim=1, stable=True).indices[:, :k_out]
    return torch.gather(d_all, 1, order), torch.gather(i_all, 1, order)


def merge_partials_topk(dists, ids, bases, w: int, k_out: int,
                        id_max: int = NO_CLAMP):
    """Launch csrc/mesh_merge.cu merge_partials_topk over the partials
    (CUDA tensors on one device, [B, w_s] f32 dists and int32 local
    ids, w_s <= w) -> (dists [B, k_out] f32, ids [B, k_out] int32).
    The launch path is one pass over the parts (checks and pointers)
    and one C call: at the path's small tiles the host is most of it."""
    from surrealdb_tpu_torch.device import compile_cache

    nparts = len(dists)
    if not 1 <= nparts <= MAX_PARTS or len(ids) != nparts \
            or len(bases) != nparts:
        raise ValueError(f"merge_partials_topk: {nparts} parts "
                         f"(1..{MAX_PARTS})")
    if not 1 <= k_out <= nparts * w:
        raise ValueError(f"merge_partials_topk: k_out={k_out} outside "
                         f"1..{nparts * w}")
    d0 = dists[0]
    if not d0.is_cuda:
        raise ValueError("merge_partials_topk takes CUDA tensors")
    dev, b = d0.device, d0.shape[0]
    keep = []  # converted copies, alive until the launch
    # the C side's table: dist pointers, id pointers, bases, widths
    table = [0] * (4 * nparts)
    for s in range(nparts):
        d, i = dists[s], ids[s]
        shape = d.shape
        if shape != i.shape or shape[0] != b or shape[1] > w:
            raise ValueError(f"partial shape {tuple(shape)} / "
                             f"{tuple(i.shape)} for B={b} w={w}")
        if d.device != dev or i.device != dev:
            raise ValueError("merge_partials_topk takes CUDA tensors on "
                             "one device")
        if d.dtype is not torch.float32 or not d.is_contiguous():
            d = d.to(torch.float32).contiguous()
            keep.append(d)
        if i.dtype is not torch.int32 or not i.is_contiguous():
            i = i.to(torch.int32).contiguous()
            keep.append(i)
        table[2 * nparts + s] = int(bases[s])
        table[3 * nparts + s] = shape[1]
        if shape[1]:
            table[s] = d.data_ptr()
            table[nparts + s] = i.data_ptr()
    out_d = torch.empty((b, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_out), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    scratch, m = None, 0
    if k_out > SORT_KEYS:
        # the winners' sort buffer: [B, pow2 >= k_out] u64
        m = 1 << (k_out - 1).bit_length()
        scratch = torch.empty((b, m), dtype=torch.int64, device=dev)
    fn = compile_cache.declare(compile_cache.library("mesh_merge.cu"),
                               "merge_partials_topk", _MERGE_ARGTYPES)
    table = array.array("q", table)  # int64s the C side reads in place
    err = fn(table.buffer_info()[0], nparts, b, w, k_out, int(id_max),
             out_d.data_ptr(), out_i.data_ptr(), _ptr(scratch), m,
             _stream(out_d))
    compile_cache.check(err, "merge_partials_topk")
    kernelstats.note_launch("merge_partials_topk")
    return out_d, out_i


def merge_partials(dists, ids, bases, w: int, k_out: int,
                   id_max: int = NO_CLAMP):
    """The exact top k_out of the shards' partial tiles by (dist,
    position in shard order), ids globalised: the kernel on the card,
    the plain version on the CPU."""
    if dists[0].is_cuda:
        return merge_partials_topk(dists, ids, bases, w, k_out, id_max)
    return merge_partials_plain(dists, ids, bases, w, k_out, id_max)


# -- CSR hop mask reduction ---------------------------------------------------

def mask_or_plain(parts, acc=None):
    """Plain version: the OR of the [B, n] uint8 masks (their max);
    acc |= it when given."""
    nxt = torch.stack([p.to(torch.uint8) for p in parts]).amax(0)
    if acc is not None:
        acc |= nxt
    return nxt


def mask_or_reduce(parts, acc=None):
    """Launch csrc/mesh_merge.cu mask_or_reduce over the CUDA [B, n]
    uint8 masks of one device -> their OR (and acc |= it)."""
    from surrealdb_tpu_torch.device import compile_cache

    nparts = len(parts)
    if not 1 <= nparts <= MAX_PARTS:
        raise ValueError(f"mask_or_reduce: {nparts} parts (1..{MAX_PARTS})")
    dev, shape = parts[0].device, parts[0].shape
    for t in parts + ([acc] if acc is not None else []):
        if not (t.is_cuda and t.device == dev and t.dtype == torch.uint8
                and t.is_contiguous() and t.shape == shape):
            raise ValueError("mask_or_reduce takes contiguous uint8 CUDA "
                             "masks of one shape on one device")
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    fn = compile_cache.declare(
        compile_cache.library("mesh_merge.cu"), "mask_or_reduce",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p])
    err = fn((ctypes.c_void_p * nparts)(*[p.data_ptr() for p in parts]),
             nparts, out.numel(), out.data_ptr(), _ptr(acc), _stream(out))
    compile_cache.check(err, "mask_or_reduce")
    kernelstats.note_launch("mask_or_reduce")
    return out


def mask_or(parts, acc=None):
    if parts[0].is_cuda:
        return mask_or_reduce(parts, acc)
    return mask_or_plain(parts, acc)
