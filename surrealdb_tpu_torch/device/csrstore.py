"""Runner-side CSR graph blocks (the reference's `device/csrstore.py`).

The serving process ships the rows/cols edge arrays once per cache
epoch; a multi-hop expansion arrives as a [B, n] batch of start-node
masks (or a legacy [n] mask) and leaves as the reached-node masks,
uint8. `multi_hop_masks` loops the hops on the host; each hop is one
launch of the CUDA kernel `csr_hop_step` (csrc/csr_hop.cu) on a CUDA
tensor, or the plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.device.vecstore import to_device


def multi_hop_plain(rows, cols, start, hops: int, union: bool):
    """Plain version of the reference's _multi_hop_impl: per hop, gather
    frontier[:, rows], scatter-add into cols, keep > 0; with `union`
    the OR of every hop layer (the start is not included)."""
    frontier = start.to(torch.bool)
    acc = torch.zeros_like(frontier) if union else None
    for _ in range(hops):
        contrib = frontier[:, rows.long()].to(torch.int32)
        nxt = torch.zeros(frontier.shape, dtype=torch.int32,
                          device=frontier.device)
        frontier = nxt.index_add_(1, cols.long(), contrib) > 0
        if union:
            acc |= frontier
    return acc if union else frontier


def hop_words(b: int) -> int:
    """u32 words a node of the kernel's bit-packed frontier holds for a
    batch of b rows."""
    return max(1, -(-int(b) // 32))


def csr_hop_step(rows, cols, frontier, nxt, acc=None):
    """Launch csrc/csr_hop.cu once: next[b, cols[e]] = 1 wherever
    frontier[b, rows[e]] (and acc too, when given). `nxt` must be
    zero; all masks are [B, n] uint8 on the card. The kernel packs the
    frontier into `hop_words(B)` words a node in scratch allocated
    here."""
    from surrealdb_tpu_torch.device import compile_cache

    for t in (rows, cols, frontier, nxt) + ((acc,) if acc is not None
                                            else ()):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("csr_hop_step takes contiguous CUDA tensors")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError("edge arrays must be int32")
    if frontier.dtype != torch.uint8 or nxt.dtype != torch.uint8:
        raise ValueError("frontier masks must be uint8")
    b, n = frontier.shape
    if nxt.shape != (b, n) or (acc is not None and acc.shape != (b, n)):
        raise ValueError("frontier, next and acc must share one shape")
    # the packed frontier and next frontier, [2, n, W] u32
    words = torch.empty((2, n, hop_words(b)), dtype=torch.int32,
                        device=frontier.device)
    fn = compile_cache.declare(
        compile_cache.library("csr_hop.cu"), "csr_hop_step",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(rows.data_ptr(), cols.data_ptr(), rows.shape[0],
             frontier.data_ptr(), nxt.data_ptr(),
             None if acc is None else acc.data_ptr(), b, n,
             words.data_ptr(),
             torch.cuda.current_stream(rows.device).cuda_stream)
    compile_cache.check(err, "csr_hop_step")
    kernelstats.note_launch("csr_hop_step")


def multi_hop_masks(rows, cols, start, hops: int, union: bool):
    """[B, n] start masks -> [B, n] reached masks (bool), `hops` steps;
    with `union` the OR of every hop layer."""
    if not rows.is_cuda:
        return multi_hop_plain(rows, cols, start, hops, union)
    frontier = start.to(torch.uint8).contiguous()
    acc = torch.zeros_like(frontier) if union else None
    for _ in range(hops):
        nxt = torch.zeros_like(frontier)
        csr_hop_step(rows, cols, frontier, nxt, acc)
        frontier = nxt
    return (acc if union else frontier).to(torch.bool)


class CsrStore:
    """Device-resident adjacency for ONE graph cache epoch."""

    def __init__(self, key: str, rows: np.ndarray, cols: np.ndarray,
                 n_nodes: int, device="cuda"):
        self.key = key
        self.n_nodes = int(n_nodes)
        self.rows = rows
        self.cols = cols
        self.device = torch.device(device)
        self.device_edges = None

    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.cols.nbytes)

    def device_nbytes(self) -> int:
        """Device-resident bytes once ensured (the two edge arrays move
        to the device as they are)."""
        return self.nbytes()

    def _ensure(self):
        if self.device_edges is None:
            for name, arr in (("rows", self.rows), ("cols", self.cols)):
                # the kernel indexes the masks with these unchecked
                if len(arr) and (int(arr.min()) < 0
                                 or int(arr.max()) >= self.n_nodes):
                    raise ValueError(f"csr {name} index outside "
                                     f"[0, {self.n_nodes})")
            self.device_edges = (
                to_device(self.rows, self.device, torch.int32),
                to_device(self.cols, self.device, torch.int32),
            )
        return self.device_edges

    def multi_hop(self, start: np.ndarray, hops: int,
                  union: bool) -> np.ndarray:
        """[B, n] (or legacy [n]) start masks -> same-shaped reached
        masks, uint8. Batch sizes round up to a power of two, as the
        reference's do."""
        rows_d, cols_d = self._ensure()
        single = start.ndim == 1
        masks = start[None, :] if single else start
        b = masks.shape[0]
        bucket = 1
        while bucket < b:
            bucket *= 2
        if bucket != b:
            masks = np.concatenate(
                [masks, np.zeros((bucket - b, masks.shape[1]),
                                 masks.dtype)]
            )
        kernelstats.note_shape(
            "csr_multi_hop",
            (self.n_nodes, int(hops), bool(union), len(self.rows), bucket))
        out = multi_hop_masks(
            rows_d, cols_d, to_device(masks.astype(bool), self.device),
            int(hops), bool(union),
        )
        out = out.cpu().numpy()[:b].astype(np.uint8)
        return out[0] if single else out
