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
  by `int8_candidates` (the reference's `knn_rank_int8`, all of a
  frame's queries in one pass over the store), whose kc =
  `int8_oversample`·k candidates leave as a "cand" reply for the
  serving side's exact rescore;
- other metrics: the exact store (`knn_search`), blockwise above
  `cfg["block_rows"]` (`knn_search_blocked`).

On a runner whose device list holds more than one device, the bf16 and
exact stores shard their rows over every device, as the reference's do
over `jax.devices()` (`parallel/mesh.py`: `sharded_rank_rescore`,
`sharded_knn`); the int8 store stays on the first device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.ops.distance import STAT_METRICS, row_stats
from surrealdb_tpu_torch.ops.metrics import COSINE, EUCLIDEAN, GEMM_METRICS

# rows per step of the on-device f64 row statistics
_STAT_ROWS = 1 << 16


def _pow2(b: int) -> int:
    """The power-of-two query bucket of a batch of b."""
    return 1 << max(0, (max(int(b), 1) - 1).bit_length())


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


def quantize_store(rows: np.ndarray, metric: str, device):
    """The int8 ranking store of host rows on `device`, quantised there
    one block of rows (256 MB of f32, as the reference steps) at a time
    (`quantize_rows_int8`, the reference's numpy formula bit for bit):
    (x8 [N, W] int8 with W the kernels' 16-byte width, arow [N] f32,
    x2 [N] f32: euclidean |x|^2, else zeros)."""
    from surrealdb_tpu_torch.ops import topk

    n, dim = rows.shape
    x8 = torch.empty((n, topk.int8_width(dim)), dtype=torch.int8,
                     device=device)
    arow = torch.empty((n,), dtype=torch.float32, device=device)
    x2 = torch.zeros((n,), dtype=torch.float32, device=device)
    if rows.dtype not in (np.float32, np.float64):
        rows = rows.astype(np.float64)
    step = max(1, (256 << 20) // max(dim * 4, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        topk.quantize_rows(to_device(rows[s:e], device), metric, x8[s:e],
                           arow[s:e], x2[s:e])
    return x8, arow, x2


def _row_stat(full, fn):
    """f64-accurate per-row statistic of the device rows, in steps."""
    return torch.cat([
        fn(full[s:s + _STAT_ROWS].to(torch.float64)).to(torch.float32)
        for s in range(0, full.shape[0], _STAT_ROWS)
    ] or [full.new_zeros((0,))])


class VecStore:
    """Device-resident blocks for ONE vector index cache epoch."""

    def __init__(self, key: str, vecs: np.ndarray, valid: np.ndarray,
                 metric: str, mink_p: float, cfg: dict, device="cuda",
                 devices=None):
        self.key = key
        self.vecs = vecs
        self.valid = valid.astype(bool)
        self.metric = metric
        self.mink_p = float(mink_p)
        self.cfg = dict(cfg)
        # the runner's device list; the store lives on its first device
        # and shards its rows over all of them when there are several
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.mesh = None
        self.device_vecs = None
        self.device_xstats = None  # the exact store's row statistics
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
                              metric: str, cfg: dict, ndev: int = 1) -> int:
        """Device-resident bytes this store will pin once ensured over
        `ndev` devices (the runner's device count); it follows
        `ensure()`'s branches, including the per-device share that picks
        bf16 or int8, so the runner's byte budget can admit or refuse a
        ship before allocating anything."""
        ndev = max(int(ndev), 1)
        n = max(int(n), 0)
        dim = max(int(dim), 1)
        if metric not in GEMM_METRICS:
            # exact store: the raw rows + the validity mask
            return (n * dim * itemsize) // ndev + n
        if (6 * n * dim) // ndev > cfg.get("hbm_budget", 1 << 62):
            # int8 ranking store: rows (1 B/elem) + arow/x2 + valid
            return n * dim + 9 * n
        # bf16 rank + f32 full (6 B/elem) + per-row stats + valid
        return (6 * n * dim) // ndev + 9 * n

    def device_nbytes(self) -> int:
        n, dim = self.vecs.shape
        return self.estimate_device_bytes(
            n, dim, self.vecs.dtype.itemsize, self.metric, self.cfg,
            len(self.devices)
        )

    def ensure(self):
        if self.device_vecs is not None or self.device_rank is not None:
            return
        dev = self.device
        multi = len(self.devices) > 1
        if multi:
            from surrealdb_tpu_torch.parallel import mesh as pmesh
        if self.metric not in GEMM_METRICS:
            # the distance kernel computes in f32, as the reference's
            # distance_matrix casts its inputs
            if multi:
                self.mesh = pmesh.default_mesh(self.devices)
                self.device_vecs = pmesh.shard_rows(self.mesh, self.vecs,
                                                    torch.float32)
                self.device_valid = pmesh.shard_rows(self.mesh, self.valid)
                if self.metric in STAT_METRICS:
                    self.device_xstats = pmesh.Shards(
                        [row_stats(r, self.metric)
                         for r in self.device_vecs.parts],
                        self.mesh, self.device_vecs.n)
            else:
                self.device_vecs = to_device(self.vecs, dev, torch.float32)
                self.device_valid = to_device(self.valid, dev)
                # once a store, not once a query
                self.device_xstats = row_stats(self.device_vecs,
                                               self.metric)
            return
        n, dim = self.vecs.shape
        if (6 * n * dim) // len(self.devices) > self.cfg["hbm_budget"]:
            # bf16 rank + f32 full (6 B/elem, its per-device share on a
            # mesh) won't fit: int8 ranking store (1 B/elem) on the first
            # device; the exact rescore of the oversampled candidates
            # happens on the serving side
            self.device_rank, self.device_arow, self.device_x2 = \
                quantize_store(self.vecs, self.metric, dev)
            self.device_valid = to_device(self.valid, dev)
            self.rank_mode = "int8"
            return
        if multi:
            self.mesh = pmesh.default_mesh(self.devices)
            parts = [self._bf16_arrays(self.vecs[lo:hi], self.valid[lo:hi],
                                       d)
                     for d, (lo, hi) in zip(self.mesh, pmesh.row_slices(
                         n, len(self.mesh)))]
            (self.device_full, self.device_x2, self.device_norms,
             self.device_valid, self.device_rank) = (
                pmesh.Shards([p[i] for p in parts], self.mesh, n)
                for i in range(5))
        else:
            (self.device_full, self.device_x2, self.device_norms,
             self.device_valid, self.device_rank) = self._bf16_arrays(
                self.vecs, self.valid, dev)
        self.rank_mode = "bf16"

    def _bf16_arrays(self, rows: np.ndarray, valid: np.ndarray, dev):
        """(f32 rows, x2 | None, norms | None, valid, bf16 rank rows) of
        host rows on `dev`: x2 for euclidean, norms for cosine, whose
        rank rows are divided by their norms first."""
        full = to_device(rows, dev, torch.float32)
        x2 = norms = None
        if self.metric == EUCLIDEAN:
            x2 = _row_stat(full, lambda b: (b * b).sum(1))
        elif self.metric == COSINE:
            norms = torch.clamp(
                _row_stat(full, lambda b: torch.linalg.norm(b, dim=1)),
                min=1e-30)
        rank = full / norms[:, None] if self.metric == COSINE else full
        if rows.shape[1] % 8:
            # the rank kernel reads rows 16 bytes at a time: zero columns
            # up to a multiple of 8 (they add nothing to a dot product)
            rank = torch.nn.functional.pad(rank, (0, -rows.shape[1] % 8))
        return (full, x2, norms, to_device(valid, dev),
                rank.to(torch.bfloat16))

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
        if self.mesh is not None:
            return self._pairs(*self._knn_sharded(qs, k))
        if self.rank_mode == "int8":
            kc = min(n, max(cfg["int8_oversample"] * k, k + 16))
            # every query of the frame in one pass over the store (the
            # chunking by the score budget is gone: each query's
            # candidates are its own); the budget bounds the pass's
            # transient memory, as the reference's int8 kernel holds
            # int32 dots AND f32 scores at [chunk, N]
            kernelstats.note_shape(
                "knn_rank_int8", (self.vecs.shape, _pow2(qs.shape[0]), kc,
                                  self.metric))
            cand = topk.int8_candidates(
                self.device_rank, self.device_arow, self.device_x2,
                self.device_valid, qs, kc, self.metric,
                cfg["score_budget"] // 2)
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
                self.device_valid, xstats=self.device_xstats,
            )
        else:
            kernelstats.note_shape(
                "knn_search", (self.vecs.shape, qs.shape[0], k, self.metric))
            dists, ids = topk.knn_search(
                self.device_vecs, qs, k, self.metric, self.mink_p,
                self.device_valid, self.device_xstats,
            )
        return self._pairs(dists, ids)

    def _knn_sharded(self, qs, k: int):
        """The row-sharded store (a device list of several devices):
        bf16 rank + rescore per shard and the exact merge, query chunk
        by query chunk; the exact store in one sharded scan."""
        from surrealdb_tpu_torch.parallel import mesh as pmesh

        if self.device_rank is None:
            kernelstats.note_shape(
                "sharded_knn", (self.vecs.shape, qs.shape[0], k, self.metric))
            return pmesh.sharded_knn(self.mesh, self.device_vecs, qs,
                                     self.device_valid, k, self.metric,
                                     self.mink_p, self.device_xstats)
        kc = max(2 * k, k + 16)
        b_total = qs.shape[0]
        _, chunk, _ = _pow2_chunks(b_total, self.device_rank.nloc,
                                   self.cfg["query_chunk"],
                                   self.cfg["score_budget"])
        kernelstats.note_shape(
            "sharded_rank_rescore", (self.vecs.shape, chunk, k, kc,
                                     self.metric))
        d_parts, i_parts = [], []
        for s in range(0, b_total, chunk):
            qc = qs[s:s + chunk]
            if qc.shape[0] < chunk:
                qc = torch.cat([qc, qc.new_zeros((chunk - qc.shape[0],
                                                  qc.shape[1]))])
            dc, ic = pmesh.sharded_rank_rescore(
                self.mesh, self.device_rank, self.device_full, qc, k, kc,
                self.metric, self.device_x2, self.device_norms,
                self.device_valid)
            d_parts.append(dc)
            i_parts.append(ic)
        return (torch.cat(d_parts)[:b_total], torch.cat(i_parts)[:b_total])

    def _pairs(self, dists, ids):
        return (
            {"mode": "pairs", "rank_mode": self.rank_mode},
            [
                np.ascontiguousarray(dists.cpu().numpy(), np.float32),
                np.ascontiguousarray(ids.cpu().numpy(), np.int32),
            ],
        )
