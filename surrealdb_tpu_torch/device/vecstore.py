"""Runner-side vector block store (the reference's `device/vecstore.py`,
single-device branches).

The serving process ships raw `[N, D]` rows + a validity mask once per
cache epoch; queries arrive as `[B, D]` f32 batches and leave as
`[B, k]` (dist, row-id) tiles. Kernel selection mirrors the reference:

- euclidean/cosine/dot: a bf16 ranking store + the f32 full store, both
  on the device (the f32 rows are the one host-to-device transfer; the
  bf16 rows, divided by their norms first for cosine, are derived on the
  device), served by `knn_rank_rescore`;
- when that pair (6 B/elem) exceeds `cfg["hbm_budget"]`: the int8
  ranking store (1 B/elem), quantised on the device in blocks of rows
  (`quantize_rows_int8`, the reference's formula bit for bit) and served
  by `knn_rank_int8`, whose kc = `int8_oversample`·k candidates leave as
  a "cand" reply for the serving side's exact rescore;
- other metrics: the exact store (`knn_search`), blockwise above
  `cfg["block_rows"]` (`knn_search_blocked`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops.metrics import COSINE, EUCLIDEAN, GEMM_METRICS

# rows per step of the on-device f64 row statistics
_STAT_ROWS = 1 << 16


def _pow2_chunks(b_total: int, n: int, query_chunk: int,
                 elems_budget: int):
    """Power-of-two query bucket/chunk sizing shared by every ranking
    branch, with the [chunk, n] score matrix held under `elems_budget`
    elements. Returns (bucket, chunk, rounds)."""
    cap = min(max(1, query_chunk), max(1, elems_budget // max(n, 1)))
    bucket = 1
    while bucket < b_total:
        bucket *= 2
    chunk = 1
    while chunk * 2 <= min(cap, bucket):
        chunk *= 2
    return bucket, chunk, bucket // chunk


def to_device(arr: np.ndarray, device, dtype=None):
    """numpy -> tensor on `device`. A buffer may be a read-only view of
    received bytes (frames from the reference's framing); nothing here
    writes through it, so the read-only warning of `torch.from_numpy`
    is silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def _row_stat(full, fn):
    """f64-accurate per-row statistic of the device rows, in steps."""
    return torch.cat([
        fn(full[s:s + _STAT_ROWS].to(torch.float64)).to(torch.float32)
        for s in range(0, full.shape[0], _STAT_ROWS)
    ] or [full.new_zeros((0,))])


class VecStore:
    """Device-resident blocks for ONE vector index cache epoch."""

    def __init__(self, key: str, vecs: np.ndarray, valid: np.ndarray,
                 metric: str, mink_p: float, cfg: dict, device="cpu"):
        self.key = key
        self.vecs = vecs
        self.valid = valid.astype(bool)
        self.metric = metric
        self.mink_p = float(mink_p)
        self.cfg = dict(cfg)
        self.device = torch.device(device)
        self.device_vecs = None
        self.device_valid = None
        self.device_rank = None
        self.device_full = None
        self.device_norms = None
        self.device_x2 = None
        self.device_arow = None
        self.rank_mode = None  # "bf16" | "int8" | None (exact store)

    def nbytes(self) -> int:
        return int(self.vecs.nbytes)

    @staticmethod
    def estimate_device_bytes(n: int, dim: int, itemsize: int,
                              metric: str, cfg: dict) -> int:
        """Device-resident bytes this store will pin once ensured; it
        follows `ensure()`'s branches so the runner's byte budget can
        admit or refuse a ship before allocating anything."""
        n = max(int(n), 0)
        dim = max(int(dim), 1)
        if metric not in GEMM_METRICS:
            # exact store: the raw rows + the validity mask
            return n * dim * itemsize + n
        if 6 * n * dim > cfg.get("hbm_budget", 1 << 62):
            # int8 ranking store: rows (1 B/elem) + arow/x2 + valid
            return n * dim + 9 * n
        # bf16 rank + f32 full (6 B/elem) + per-row stats + valid
        return 6 * n * dim + 9 * n

    def device_nbytes(self) -> int:
        n, dim = self.vecs.shape
        return self.estimate_device_bytes(
            n, dim, self.vecs.dtype.itemsize, self.metric, self.cfg
        )

    def ensure(self):
        if self.device_vecs is not None or self.device_rank is not None:
            return
        dev = self.device
        valid = to_device(self.valid, dev)
        if self.metric not in GEMM_METRICS:
            # the distance kernel computes in f32, as the reference's
            # distance_matrix casts its inputs
            self.device_vecs = to_device(self.vecs, dev, torch.float32)
            self.device_valid = valid
            return
        n, dim = self.vecs.shape
        if 6 * n * dim > self.cfg["hbm_budget"]:
            # bf16 rank + f32 full (6 B/elem) won't fit: int8 ranking
            # store (1 B/elem); the exact rescore of the oversampled
            # candidates happens on the serving side
            self._ensure_int8(valid)
            return
        full = to_device(self.vecs, dev, torch.float32)
        x2 = norms = None
        if self.metric == EUCLIDEAN:
            x2 = _row_stat(full, lambda b: (b * b).sum(1))
        elif self.metric == COSINE:
            norms = torch.clamp(
                _row_stat(full, lambda b: torch.linalg.norm(b, dim=1)),
                min=1e-30)
        self.device_full = full
        self.device_x2 = x2
        self.device_norms = norms
        self.device_valid = valid
        rank = full / norms[:, None] if self.metric == COSINE else full
        if dim % 8:
            # the rank kernel reads rows 16 bytes at a time: zero columns
            # up to a multiple of 8 (they add nothing to a dot product)
            rank = torch.nn.functional.pad(rank, (0, -dim % 8))
        self.device_rank = rank.to(torch.bfloat16)
        self.rank_mode = "bf16"

    def _ensure_int8(self, valid):
        """Quantise the rows into the device int8 store, one block of
        rows (256 MB of f32, as the reference steps) at a time: only the
        int8 rows, their scales, x2 (euclidean, else zeros) and the mask
        stay on the device."""
        from surrealdb_tpu_torch.ops import topk

        dev = self.device
        n, dim = self.vecs.shape
        x8 = torch.empty((n, topk.int8_width(dim)), dtype=torch.int8,
                         device=dev)
        arow = torch.empty((n,), dtype=torch.float32, device=dev)
        x2 = torch.zeros((n,), dtype=torch.float32, device=dev)
        rows = self.vecs
        if rows.dtype not in (np.float32, np.float64):
            rows = rows.astype(np.float64)
        step = max(1, (256 << 20) // max(dim * 4, 1))
        for s in range(0, n, step):
            e = min(s + step, n)
            topk.quantize_rows(to_device(rows[s:e], dev), self.metric,
                               x8[s:e], arow[s:e], x2[s:e])
        self.device_rank = x8
        self.device_arow = arow
        self.device_x2 = x2
        self.device_valid = valid
        self.rank_mode = "int8"

    def knn(self, qvs: np.ndarray, k: int):
        """Batched device search: [B, D] f32 queries -> (meta, bufs).

        mode "pairs": bufs = [dists f32 [B, k'], ids i32 [B, k']]
        (invalid slots carry inf / out-of-range ids).
        mode "cand": bufs = [cand i32 [B, kc]], int8 ranking candidates
        for the serving side's exact rescore."""
        self.ensure()
        from surrealdb_tpu_torch.ops import topk

        cfg = self.cfg
        n = self.vecs.shape[0]
        qs = to_device(qvs, self.device, torch.float32)
        if self.rank_mode == "int8":
            kc = min(n, max(cfg["int8_oversample"] * k, k + 16))
            b_total = qs.shape[0]
            # the halved score budget, as the reference's: its int8
            # kernel holds int32 dots AND the f32 scores at [chunk, N]
            bucket, chunk, r = _pow2_chunks(
                b_total, n, cfg["query_chunk"], cfg["score_budget"] // 2
            )
            kernelstats.note_shape(
                "knn_rank_int8", (self.vecs.shape, chunk, kc, self.metric))
            if bucket != b_total:
                qs = torch.cat([qs, qs.new_zeros((bucket - b_total,
                                                  qs.shape[1]))])
            cand = topk.knn_rank_int8(
                self.device_rank, self.device_arow, self.device_x2,
                self.device_valid, qs.reshape(r, chunk, -1), kc,
                self.metric,
            )
            cand = cand.reshape(bucket, kc)[:b_total]
            return (
                {"mode": "cand", "rank_mode": self.rank_mode, "kc": kc},
                [np.ascontiguousarray(cand.cpu().numpy(), np.int32)],
            )
        if self.device_rank is not None:
            # oversampling absorbs bf16 ranking error AND tombstoned
            # rows ranked into the candidate set
            kc = min(n, max(2 * k, k + 16))
            b_total = qs.shape[0]
            bucket, chunk, r = _pow2_chunks(
                b_total, n, cfg["query_chunk"], cfg["score_budget"]
            )
            kernelstats.note_shape(
                "knn_rank_rescore",
                (self.vecs.shape, chunk, min(k, kc), kc, self.metric))
            if bucket != b_total:
                qs = torch.cat([qs, qs.new_zeros((bucket - b_total,
                                                  qs.shape[1]))])
            dists, ids = topk.knn_rank_rescore(
                self.device_rank, self.device_full,
                qs.reshape(r, chunk, -1), min(k, kc), kc, self.metric,
                self.device_x2, self.device_norms, self.device_valid,
            )
            dists = dists.reshape(bucket, -1)[:b_total]
            ids = ids.reshape(bucket, -1)[:b_total]
        elif n > cfg["block_rows"]:
            kernelstats.note_shape(
                "knn_search_blocked",
                (self.vecs.shape, qs.shape[0], k, self.metric))
            dists, ids = topk.knn_search_blocked(
                self.device_vecs, qs, k, self.metric, self.mink_p,
                self.device_valid,
            )
        else:
            kernelstats.note_shape(
                "knn_search", (self.vecs.shape, qs.shape[0], k, self.metric))
            dists, ids = topk.knn_search(
                self.device_vecs, qs, k, self.metric, self.mink_p,
                self.device_valid,
            )
        return self._pairs(dists, ids)

    def _pairs(self, dists, ids):
        return (
            {"mode": "pairs", "rank_mode": self.rank_mode},
            [
                np.ascontiguousarray(dists.cpu().numpy(), np.float32),
                np.ascontiguousarray(ids.cpu().numpy(), np.int32),
            ],
        )
