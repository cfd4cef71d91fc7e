"""Runner-side quantized graph-ANN blocks (the reference's
`device/annstore.py`, single device).

The serving process builds the CAGRA-style index (fixed-out-degree
graph + per-row-scaled int8 rows, `idx/cagra.py`) and ships it once per
build through the (key, tag) block protocol. A search arrives as a
[B, D] f32 query batch and leaves as [B, kc] int32 candidate ids; the
exact re-rank happens on the serving side, which holds the full rows.

A search is two stages, both on the card:

- the routing probe: int8 scores of the B queries against a strided
  sample of P rows, precomputed at install (`rank_scores_int8` in its
  probe order, csrc/rank_int8.cu), and its best W per query
  (`select_topk_rows`, csrc/select.cu) seed the frontier;
- the descent: `ann_descent` (csrc/ann_descent.cu), one block per
  query running every iteration of the greedy frontier search in one
  launch; `ann_descent_plain` beside it is the same loop in PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.device.vecstore import to_device
from surrealdb_tpu_torch.ops.metrics import EUCLIDEAN


# -- the descent: kernel wrapper and plain version ----------------------------

def ann_descent_plain(graph, x8, arow, x2q, qs, init_ids, init_dist,
                      metric: str, iters: int, expand: int, kc: int,
                      trace: dict = None):
    """Plain version of the reference's descent loop (`_descent_scored`
    after the probe): `iters` rounds over the [B, W] frontier seeded by
    (init_ids, init_dist), stable sorts standing in for lax.top_k.
    Returns (ids int32 [B, kc], dists f32 [B, kc]). `trace`, when
    given, receives the ids scored and the ids expanded (for the
    bound of the kernel's work)."""
    from surrealdb_tpu_torch.ops.topk import (
        _full,
        _pad_to,
        jax_rows,
        quantize_queries_plain,
    )

    b, width = init_ids.shape
    n, d_out = graph.shape
    q8, sq = quantize_queries_plain(_pad_to(qs.to(torch.float32),
                                            x8.shape[1]))
    q8 = q8.to(torch.float64)
    inv_sq = _full(sq, 1.0) / sq
    ids = init_ids.to(torch.int64)
    dist = init_dist.to(torch.float32)
    expanded = torch.zeros((b, width), dtype=torch.bool, device=ids.device)
    rows_ix = torch.arange(b, device=ids.device)[:, None]
    inf = torch.tensor(float("inf"), device=ids.device)

    def score_rows(nb):
        nbc = jax_rows(nb, n)
        dots = torch.einsum("bcd,bd->bc", x8[nbc].to(torch.float64), q8)
        dots = dots.to(torch.float32) * (arow[nbc] * inv_sq[:, None])
        if metric == EUCLIDEAN:
            return x2q[nbc] - 2.0 * dots
        return -dots

    for _ in range(iters):
        key = torch.where(expanded, inf, dist)
        esel = torch.sort(key, dim=1, stable=True).indices[:, :expand]
        expanded[rows_ix, esel] = True
        src = jax_rows(torch.gather(ids, 1, esel), n)
        nb = graph[src].reshape(b, expand * d_out).to(torch.int64)
        dup = (nb[:, :, None] == ids[:, None, :]).any(dim=2)
        inner = torch.tril(nb[:, :, None] == nb[:, None, :],
                           diagonal=-1).any(dim=2)
        drop = dup | inner
        nd = torch.where(drop, inf, score_rows(nb))
        if trace is not None:
            trace.setdefault("scored", []).append(nb[~drop])
            trace.setdefault("expanded", []).append(src.reshape(-1))
        mi = torch.cat([ids, nb], dim=1)
        md = torch.cat([dist, nd], dim=1)
        me = torch.cat([expanded, drop], dim=1)
        keep = torch.sort(md, dim=1, stable=True).indices[:, :width]
        ids = torch.gather(mi, 1, keep)
        dist = torch.gather(md, 1, keep)
        expanded = torch.gather(me, 1, keep)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :kc]
    return (torch.gather(ids, 1, order).to(torch.int32),
            torch.gather(dist, 1, order))


def ann_descent_cuda(graph, x8, arow, x2q, qs, init_ids, init_dist,
                     metric: str, iters: int, expand: int, kc: int):
    """Launch csrc/ann_descent.cu on CUDA tensors -> (ids, dists)."""
    from surrealdb_tpu_torch.device import compile_cache
    from surrealdb_tpu_torch.ops.topk import INT8_ALIGN, _pad_to

    if not (graph.is_cuda and x8.is_cuda and qs.is_cuda):
        raise ValueError("ann_descent takes CUDA tensors")
    n, d_out = graph.shape
    width = x8.shape[1]
    if x8.dtype != torch.int8 or width % INT8_ALIGN or x8.shape[0] != n:
        raise ValueError("int8 rows must be [N, multiple of 16] int8")
    b, w = init_ids.shape
    if not 1 <= kc <= w or not 1 <= expand <= w:
        raise ValueError(f"kc={kc}, expand={expand} outside 1..W={w}")
    graph = graph.to(torch.int32).contiguous()
    x8 = x8.contiguous()
    arow = arow.to(torch.float32).contiguous()
    euclid = metric == EUCLIDEAN
    x2q = x2q.to(torch.float32).contiguous()
    qs = _pad_to(qs.to(torch.float32), width).contiguous()
    init_ids = init_ids.to(torch.int32).contiguous()
    init_dist = init_dist.to(torch.float32).contiguous()
    out_i = torch.empty((b, kc), dtype=torch.int32, device=qs.device)
    out_d = torch.empty((b, kc), dtype=torch.float32, device=qs.device)
    fn = compile_cache.declare(
        compile_cache.library("ann_descent.cu"), "ann_descent",
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    err = fn(graph.data_ptr(), x8.data_ptr(), arow.data_ptr(),
             x2q.data_ptr(), qs.data_ptr(), init_ids.data_ptr(),
             init_dist.data_ptr(), out_i.data_ptr(), out_d.data_ptr(), n,
             d_out, width, b, w, expand, iters, kc, int(euclid),
             torch.cuda.current_stream(qs.device).cuda_stream)
    compile_cache.check(err, "ann_descent")
    kernelstats.note_launch("ann_descent")
    return out_i, out_d


def ann_descent(graph, x8, arow, x2q, qs, init_ids, init_dist, metric: str,
                iters: int, expand: int, kc: int):
    if qs.is_cuda:
        return ann_descent_cuda(graph, x8, arow, x2q, qs, init_ids,
                                init_dist, metric, iters, expand, kc)
    return ann_descent_plain(graph, x8, arow, x2q, qs, init_ids, init_dist,
                             metric, iters, expand, kc)


def probe_seed(dev: dict, qs, metric: str, width: int):
    """The routing probe: int8 scores of `qs` against the precomputed
    probe rows (the reference's dequantisation order for the probe) and
    their best `width` -> (ids int32 [B, W], dists f32 [B, W])."""
    from surrealdb_tpu_torch.ops.topk import rank_int8, top_k_smallest

    pscore = rank_int8(dev["x8p"], qs, metric, dev["arowp"], dev["x2qp"],
                       probe_order=True)
    dist, sel = top_k_smallest(pscore, width)
    return dev["probe_ids"][sel.long()], dist


# -- the store ------------------------------------------------------------------

class AnnStore:
    """Device-resident quantized graph index for ONE build snapshot."""

    def __init__(self, key: str, graph: np.ndarray, x8: np.ndarray,
                 arow: np.ndarray, x2q: np.ndarray, metric: str,
                 cfg: dict, device="cuda"):
        self.key = key
        self.graph = graph
        self.x8 = x8
        self.arow = arow
        self.x2q = x2q
        self.metric = metric
        self.cfg = dict(cfg)
        self.device = torch.device(device)
        self.dev = None

    def nbytes(self) -> int:
        return int(self.graph.nbytes + self.x8.nbytes
                   + self.arow.nbytes + self.x2q.nbytes)

    def device_nbytes(self) -> int:
        """Device-resident bytes once installed: the four shipped
        arrays plus the precomputed probe-row slices (no array is built
        here: this runs on every budget-admission pass)."""
        from surrealdb_tpu_torch.idx.cagra import probe_count

        n, dim = self.x8.shape
        w = max(int(self.cfg.get("width", 64)), 1)
        return self.nbytes() + probe_count(n, w) * (dim + 12)

    @staticmethod
    def estimate_device_bytes(n: int, dim: int, d_out: int) -> int:
        """Admission estimate from the begin-frame shapes: graph int32 +
        int8 rows + the f32 per-row arrays; probe slices add at most
        ~N/24 rows."""
        n = max(int(n), 0)
        probe = min(n, max(4096, n // 8))
        return n * (4 * max(int(d_out), 1) + max(int(dim), 1) + 8) \
            + probe * (max(int(dim), 1) + 12)

    def _ensure(self) -> dict:
        if self.dev is None:
            from surrealdb_tpu_torch.idx.cagra import entry_ids, probe_count
            from surrealdb_tpu_torch.ops.topk import int8_width

            n, dim = self.x8.shape
            w = max(int(self.cfg.get("width", 64)), 1)
            probe = entry_ids(n, probe_count(n, w))
            dev = self.device
            x8 = to_device(self.x8, dev)
            if int8_width(dim) != dim:
                # zero columns up to the kernels' 16-byte row multiple
                x8 = torch.nn.functional.pad(x8, (0, int8_width(dim) - dim))
            probe_t = to_device(probe, dev)
            arow = to_device(self.arow, dev, torch.float32)
            x2q = to_device(self.x2q, dev, torch.float32)
            self.dev = {
                "graph": to_device(self.graph, dev, torch.int32),
                "x8": x8,
                "arow": arow,
                "x2q": x2q,
                # probe rows precomputed: the seed stage is one [B, P]
                # product, never a [B, P, D] gather
                "x8p": x8[probe_t].contiguous(),
                "arowp": arow[probe_t].contiguous(),
                "x2qp": x2q[probe_t].contiguous(),
                "probe_ids": probe_t.to(torch.int32),
            }
        return self.dev

    def _clamped(self, kc: int):
        """(width, iters, expand, kc) after the reference's clamps."""
        n = self.x8.shape[0]
        p = int(self._ensure()["probe_ids"].shape[0])
        cfg = self.cfg
        width = max(int(cfg.get("width", 64)), 1)
        iters = max(int(cfg.get("iters", 24)), 1)
        expand = max(int(cfg.get("expand", 2)), 1)
        kc = min(max(int(kc), 1), n)
        # the frontier seeds from the probe's top-`width`: width is
        # bounded by the probe size; an oversized kc clamps down (the
        # serving side reads the returned column count)
        width = min(max(width, kc), n, p)
        kc = min(kc, width)
        expand = min(expand, width)
        return width, iters, expand, kc

    def search_scored(self, qs: np.ndarray, kc: int):
        """[B, D] f32 queries -> (ids int32 [B, kc], int8 descent scores
        f32 [B, kc]), best first. Batches round up to a power of two
        (zero rows), as the reference's compiled ladder does."""
        dev = self._ensure()
        width, iters, expand, kc = self._clamped(kc)
        b = qs.shape[0]
        bucket = 1
        while bucket < b:
            bucket *= 2
        qsb = to_device(np.ascontiguousarray(qs, np.float32), self.device)
        if bucket != b:
            qsb = torch.cat([qsb, qsb.new_zeros((bucket - b, qsb.shape[1]))])
        kernelstats.note_shape(
            "ann_descent", (self.x8.shape, self.graph.shape[1], bucket,
                            self.metric, width, iters, expand, kc))
        ids0, dist0 = probe_seed(dev, qsb, self.metric, width)
        ids, dist = ann_descent(dev["graph"], dev["x8"], dev["arow"],
                                dev["x2q"], qsb, ids0, dist0, self.metric,
                                iters, expand, kc)
        return (np.ascontiguousarray(ids[:b].cpu().numpy(), np.int32),
                np.ascontiguousarray(dist[:b].cpu().numpy(), np.float32))

    def search(self, qs: np.ndarray, kc: int) -> np.ndarray:
        """[B, D] f32 queries -> [B, kc] int32 candidate ids (unique per
        row, best-first by int8 descent score)."""
        return self.search_scored(qs, kc)[0]
