"""Mesh execution: row-shard vector/ANN blocks and edge-shard CSR blocks
over the runner's device list (the reference's `device/mesh.py`).

The reference builds a 1-D mesh over `jax.devices()` (widened on a CPU
with `--xla_force_host_platform_device_count`). Its counterpart here is
a device list: by default the visible cards `cuda:0..n-1`; asked for N
logical devices (the runner's `--mesh-devices N`, the same facility as
the reference's forced device count), shard s goes to
`cuda:(s % device_count)`, or every shard to "cpu" when the caller asks
for the CPU. One process holds every shard, as the reference's runner
does; nothing here uses `torch.distributed`.

At install time a store cuts its shipped arrays into contiguous row
(vec/ANN) or edge (CSR) slices, one per device, each a tensor of its
own length on its own device (no padding to a uniform shape). A query
runs each shard's partial kernel -- `distance_tile` +
`select_topk_rows`, the int8 store's one-pass candidates
(`ops/topk.py int8_topk`), the ANN probe +
`ann_descent`, `csr_hop_step` -- on that shard's device; the partials
travel to the first device (`ops/merge.py`: a `.to(device,
non_blocking=True)` after a CUDA event of the source's stream, nothing
when both share a card) and merge there: `merge_partials_topk` takes
the exact top k by (dist, position in shard order), `lax.top_k`'s rule
over the reference's `all_gather`; `mask_or_reduce` ORs the CSR hop
masks, the reference's `psum(part) > 0`. The contracts:

- exact and int8 scores are per (row, query), so the sharded answer is
  the single-device answer of the same kernel wherever the kernel is
  row-independent: `distance_tile`, `rank_scores_int8` and
  `select_topk_rows` are, so on the card the mesh answer is
  byte-identical to one device's; on the CPU the plain euclidean and
  cosine distances come from a matrix product whose low bits may depend
  on the shard's row count, so those two metrics are held within
  tolerance there (as the reference's own euclidean is not byte-stable
  on its CPU mesh);
- CSR hop masks are ORs of per-slice masks, bit-equal to one device's;
- the graph descent is partitioned (per-slice sub-graph, foreign edges
  turned into self-loops that the duplicate rule drops, per-slice
  probes), so it equals `search_seq` -- the same partition searched
  slice by slice with the plain descent -- not a whole-store descent.

Placement is budget-aware (`pick_ndev`): the smallest power-of-two
count whose per-device share of the install estimate fits the runner's
per-device budget; `SURREAL_DEVICE_MESH=force` takes the whole list.
Importing this module touches no device.

    python -m surrealdb_tpu_torch.device.mesh --devices 8 --device cpu \\
        [--budget-check]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device import kernelstats
from surrealdb_tpu_torch.device.vecstore import (
    _pow2_chunks, quantize_store, to_device,
)
from surrealdb_tpu_torch.ops import merge as M
from surrealdb_tpu_torch.ops.distance import row_stats

MESH_AXIS = "mesh"

MXU_METRICS = ("euclidean", "cosine", "dot")

# -- the device list ----------------------------------------------------------

def device_list(n=None, device="cuda") -> list:
    """N logical devices of `device`'s kind: shard s on
    `cuda:(s % device_count)`, or on "cpu" for every shard. `n` None:
    every visible card (an explicit `cuda:i`: that card), one CPU."""
    dev = torch.device(device)
    if n is not None and not 1 <= int(n) <= M.MAX_PARTS:
        raise ValueError(f"mesh devices {n} outside 1..{M.MAX_PARTS}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * int(n or 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if n is None and dev.index is not None:
        return [dev]
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA device is visible")
    return [torch.device("cuda", s % count)
            for s in range(count if n is None else int(n))]


def physical_devices(devs) -> int:
    """How many distinct devices hold the list's shards."""
    return len({str(d) for d in devs})


# -- topology / placement knobs -----------------------------------------------

def mesh_mode() -> str:
    """SURREAL_DEVICE_MESH: "auto" (shard when a store busts the
    per-device budget), "off", "force" (shard even when one device
    fits), or an integer cap. Read from the environment per call."""
    raw = os.environ.get("SURREAL_DEVICE_MESH")
    if raw is None:
        raw = getattr(cnf, "DEVICE_MESH", "auto")
    raw = str(raw).strip().lower()
    return raw or "auto"


def _mesh_cap() -> int:
    mode = mesh_mode()
    if mode in ("auto", "force"):
        return 0  # uncapped
    if mode == "off":
        return 1
    try:
        return max(int(mode), 1)
    except ValueError:
        return 0


def mesh_size(n_devices: int) -> int:
    """Usable mesh width: the device list's length `n_devices` (the
    reference's len(jax.devices())) under the SURREAL_DEVICE_MESH cap;
    1 when the mesh is off."""
    if mesh_mode() == "off":
        return 1
    n = max(int(n_devices), 1)
    cap = _mesh_cap()
    return min(n, cap) if cap else n


def describe(n_devices: int) -> dict:
    """Topology snapshot for the runner ready-frame / status() of a
    device list of `n_devices`."""
    n = mesh_size(n_devices)
    return {"mode": mesh_mode(), "n_devices": n, "mesh_shape": [n],
            "axis": MESH_AXIS}


def pick_ndev(est_total_fn, budget_bytes: int, n_rows: int = 1 << 62, *,
              n_devices: int) -> int:
    """Device count for a new store install. `est_total_fn(d)` returns
    the estimated TOTAL device bytes when sharded over `d` devices
    (padding included); the chosen count is the smallest pow2 whose
    per-device share `ceil(est/d)` fits the per-device budget — the
    "fits on 8 but not 1 → shard" rule. "force" mode → the full mesh;
    no budget under "auto" → 1 (nothing to rescue: the legacy stores
    keep their own self-sharded rank paths). Clamped to `n_rows` so
    no slice is ever empty. Over budget even fully sharded → the full
    mesh; `_admit` then refuses honestly. `n_devices` is the caller's
    device list length."""
    nmesh = min(mesh_size(n_devices), max(int(n_rows), 1))
    if nmesh <= 1:
        return 1
    if mesh_mode() == "force":
        return nmesh
    if budget_bytes <= 0:
        return 1
    cands = []
    d = 1
    while d < nmesh:
        cands.append(d)
        d *= 2
    cands.append(nmesh)
    for d in cands:
        if -(-int(est_total_fn(d)) // d) <= budget_bytes:
            return d
    return nmesh


def even_splits(n: int, ndev: int) -> list:
    """Contiguous shard fenceposts [0, ..., n] (ndev+1 entries)."""
    ndev = max(int(ndev), 1)
    step = -(-n // ndev) if n else 0
    return [min(i * step, n) for i in range(ndev + 1)]


def _check_offsets(offs, n: int, ndev: int, allow_empty: bool = True):
    if len(offs) != ndev + 1 or offs[0] != 0 or offs[-1] != n:
        raise ValueError(f"bad mesh offsets {offs!r} for n={n} ndev={ndev}")
    for a, b in zip(offs, offs[1:]):
        if b < a or (not allow_empty and b == a):
            raise ValueError(f"bad mesh offsets {offs!r}: "
                             f"{'empty' if b == a else 'unordered'} slice")


def _shard_devices(ndev: int, devs, key: str, what: str) -> list:
    """The first `ndev` devices of the store's list."""
    devs = list(devs or ())
    if len(devs) < ndev:
        raise RuntimeError(f"mesh {what} {key!r} placed on {ndev} devices "
                           f"but was given {len(devs)}")
    return [torch.device(d) for d in devs[:ndev]]


def _merge_on(dev0, d_parts, i_parts, bases, w, k_out, id_max):
    with M.on(dev0):
        return M.merge_partials(M.gather_to(d_parts, dev0),
                                M.gather_to(i_parts, dev0), bases, w, k_out,
                                id_max)


def _no_partial(b: int, device):
    """The partial of an empty slice: no entries (all padding)."""
    return (torch.empty((b, 0), dtype=torch.float32, device=device),
            torch.empty((b, 0), dtype=torch.int32, device=device))


# -- sharded vector store -----------------------------------------------------

class MeshVecStore:
    """Row-sharded vector blocks for ONE cache epoch on the device list.

    Same (key, tag) ship protocol and knn() contract as VecStore — the
    serving process ships the full arrays once; the runner slices at
    install time. Kernel selection: non-MXU metrics and MXU stores
    whose per-device 6 B/elem share fits HBM run the exact kernel
    (mode "pairs"); larger MXU stores run int8 ranking (mode "cand",
    exact rescore on the serving side, unchanged)."""

    def __init__(self, key: str, vecs: np.ndarray, valid: np.ndarray,
                 metric: str, mink_p: float, cfg: dict, ndev: int,
                 offsets=None, devices=None):
        self.key = key
        self.vecs = vecs
        self.valid = valid.astype(bool)
        self.metric = metric
        self.mink_p = float(mink_p)
        self.cfg = dict(cfg)
        self.mesh_ndev = max(int(ndev), 1)
        n, dim = vecs.shape
        self.offsets = (
            [int(o) for o in offsets] if offsets is not None
            else even_splits(n, self.mesh_ndev)
        )
        _check_offsets(self.offsets, n, self.mesh_ndev)
        if metric in MXU_METRICS and (6 * n * dim) // self.mesh_ndev \
                > self.cfg.get("hbm_budget", 1 << 62):
            self.rank_mode = "int8"
        else:
            self.rank_mode = None  # exact store
        self._devices = devices
        self._dev = None
        self._nloc = 0

    def nbytes(self) -> int:
        return int(self.vecs.nbytes)

    @staticmethod
    def estimate_device_bytes(n: int, dim: int, itemsize: int,
                              metric: str, cfg: dict, ndev: int) -> int:
        """TOTAL device bytes across the mesh once ensured, counted as
        the reference's padded slices count them — `pick_ndev`/`_admit`
        divide by ndev for the per-device share. Mirrors `ensure()`'s
        branches."""
        ndev = max(int(ndev), 1)
        n = max(int(n), 0)
        dim = max(int(dim), 1)
        nloc = -(-n // ndev) if n else 1
        if metric in MXU_METRICS and (6 * n * dim) // ndev \
                > cfg.get("hbm_budget", 1 << 62):
            # int8 ranking: rows (1 B/elem) + arow/x2 f32 + valid + base
            return ndev * nloc * (dim + 9) + 4 * ndev
        # exact store: raw rows + the validity mask + base
        return ndev * nloc * (dim * itemsize + 1) + 4 * ndev

    def device_nbytes(self) -> int:
        n, dim = self.vecs.shape
        return self.estimate_device_bytes(
            n, dim, self.vecs.dtype.itemsize, self.metric, self.cfg,
            self.mesh_ndev,
        )

    def ensure(self):
        if self._dev is not None:
            return
        ndev = self.mesh_ndev
        devs = _shard_devices(ndev, self._devices, self.key, "store")
        offs = self.offsets
        self._nloc = max(max(offs[s + 1] - offs[s] for s in range(ndev)), 1)
        shards = []
        for s, dev in enumerate(devs):
            lo, hi = offs[s], offs[s + 1]
            sh = {"dev": dev, "len": hi - lo, "base": lo,
                  "valid": to_device(self.valid[lo:hi], dev)}
            if self.rank_mode == "int8":
                # the int8 store's per-row quantisation (row-independent:
                # the shard's bytes are the single-device store's rows)
                sh["x8"], sh["arow"], sh["x2"] = quantize_store(
                    self.vecs[lo:hi], self.metric, dev)
            else:
                sh["rows"] = to_device(self.vecs[lo:hi], dev, torch.float32)
                # the rows' statistics once a store, not once a query
                # (row-independent: the single-device store's values)
                sh["xstats"] = row_stats(sh["rows"], self.metric)
            shards.append(sh)
        self._dev = shards

    def _partials(self, qc, width: int, score):
        """Per shard: `score(shard, queries on its device)` -> [C, len]
        and its `width` best (fewer on a shorter slice: the merge pads
        them); the partials stay on their devices."""
        from surrealdb_tpu_torch.ops.topk import top_k_smallest

        d_parts, i_parts = [], []
        for sh in self._dev:
            if sh["len"] == 0:
                d, i = _no_partial(qc.shape[0], qc.device)
            else:
                with M.on(sh["dev"]):
                    d, i = top_k_smallest(score(sh, M.move(qc, sh["dev"])),
                                          min(width, sh["len"]))
            d_parts.append(d)
            i_parts.append(i)
        return d_parts, i_parts

    def knn(self, qvs: np.ndarray, k: int):
        """Batched mesh search: [B, D] f32 queries -> (meta, bufs) with
        the exact VecStore.knn() contract plus meta["mesh_ndev"]."""
        self.ensure()
        from surrealdb_tpu_torch.ops.distance import distance_matrix
        from surrealdb_tpu_torch.ops.topk import (
            int8_topk_finish, int8_topk_start,
        )

        cfg = self.cfg
        n = self.vecs.shape[0]
        ndev = self.mesh_ndev
        nloc = self._nloc
        b_total = qvs.shape[0]
        k = max(int(k), 1)
        dev0 = self._dev[0]["dev"]
        qs = to_device(np.ascontiguousarray(qvs, np.float32), dev0)
        bases = [sh["base"] for sh in self._dev]

        def chunks(budget):
            _b, chunk, _r = _pow2_chunks(
                b_total, nloc, cfg["query_chunk"], budget
            )
            return chunk

        def run(chunk, width, k_out, score):
            parts = []
            for s in range(0, b_total, chunk):
                qc = qs[s:s + chunk]
                if qc.shape[0] < chunk:
                    qc = torch.cat([qc, qc.new_zeros(
                        (chunk - qc.shape[0], qc.shape[1]))])
                parts.append(_merge_on(dev0, *self._partials(
                    qc, width, score), bases, width, k_out, n - 1))
            return (torch.cat([p[0] for p in parts])[:b_total],
                    torch.cat([p[1] for p in parts])[:b_total])

        if self.rank_mode == "int8":
            kc = min(n, max(cfg["int8_oversample"] * k, k + 16))
            kc_l = min(kc, nloc)
            kc_out = min(kc, ndev * kc_l)
            kernelstats.note_shape(
                "mesh_vec_int8",
                (self.vecs.shape, ndev, b_total, kc_out, self.metric))
            kernelstats.note_sharded("mesh_vec_int8", ndev)
            # per shard, every query in one pass over its rows (the
            # shard's kc_l best by (score, row), as its select gave
            # them), every shard launched before the first is awaited;
            # then the exact merge
            jobs = []
            for sh in self._dev:
                if sh["len"]:
                    with M.on(sh["dev"]):
                        jobs.append(int8_topk_start(
                            sh["x8"], sh["arow"], sh["x2"], sh["valid"],
                            M.move(qs, sh["dev"]), min(kc_l, sh["len"]),
                            self.metric, cfg["score_budget"] // 2))
                else:
                    jobs.append(None)
            d_parts, i_parts = [], []
            for sh, job in zip(self._dev, jobs):
                if job is None:
                    d, i = _no_partial(b_total, dev0)
                else:
                    with M.on(sh["dev"]):
                        d, i = int8_topk_finish(job)
                d_parts.append(d)
                i_parts.append(i)
            _, cand = _merge_on(dev0, d_parts, i_parts, bases, kc_l, kc_out,
                                n - 1)
            return (
                {"mode": "cand", "rank_mode": "int8", "kc": kc_out,
                 "mesh_ndev": ndev},
                [np.ascontiguousarray(cand.cpu().numpy(), np.int32)],
            )
        k_l = min(k, nloc)
        k_out = min(k, ndev * k_l)
        chunk = chunks(cfg["score_budget"])
        kernelstats.note_shape(
            "mesh_vec_exact",
            (self.vecs.shape, ndev, chunk, k_out, self.metric))
        kernelstats.note_sharded("mesh_vec_exact", ndev)
        dists, ids = run(chunk, k_l, k_out, lambda sh, q: distance_matrix(
            sh["rows"], q, self.metric, self.mink_p, sh["valid"],
            sh["xstats"]))
        return (
            {"mode": "pairs", "rank_mode": None, "mesh_ndev": ndev},
            [np.ascontiguousarray(dists.cpu().numpy(), np.float32),
             np.ascontiguousarray(ids.cpu().numpy(), np.int32)],
        )


# -- sharded graph-ANN store --------------------------------------------------

class MeshAnnStore:
    """Row-sharded CAGRA-style graph index for ONE build snapshot.

    Partitioned descent: each device owns a contiguous row slice with
    the graph's foreign edges remapped to self-loops (the descent's dup
    rule scores them +inf, so they cost an expansion slot, not a wrong
    answer) and its own strided routing probe; per-device candidates
    merge by (int8 score, position). Every slice must be non-empty
    (`pick_ndev` clamps to n_rows)."""

    def __init__(self, key: str, graph: np.ndarray, x8: np.ndarray,
                 arow: np.ndarray, x2q: np.ndarray, metric: str,
                 cfg: dict, ndev: int, offsets=None, devices=None):
        self.key = key
        self.graph = graph
        self.x8 = x8
        self.arow = arow
        self.x2q = x2q
        self.metric = metric
        self.cfg = dict(cfg)
        self.mesh_ndev = max(int(ndev), 1)
        n = x8.shape[0]
        self.offsets = (
            [int(o) for o in offsets] if offsets is not None
            else even_splits(n, self.mesh_ndev)
        )
        _check_offsets(self.offsets, n, self.mesh_ndev, allow_empty=False)
        self._devices = devices
        self._dev = None
        self._nloc = 0
        self._minlen = 0
        self._plen = 0

    def nbytes(self) -> int:
        return int(self.graph.nbytes + self.x8.nbytes
                   + self.arow.nbytes + self.x2q.nbytes)

    @staticmethod
    def estimate_device_bytes(n: int, dim: int, d_out: int,
                              ndev: int) -> int:
        """TOTAL device bytes across the mesh (AnnStore's formula per
        padded slice + per-slice probe rows)."""
        ndev = max(int(ndev), 1)
        n = max(int(n), 0)
        nloc = -(-n // ndev) if n else 1
        probe = min(nloc, max(4096, nloc // 8))
        return ndev * nloc * (4 * max(int(d_out), 1)
                              + max(int(dim), 1) + 8) \
            + ndev * probe * (max(int(dim), 1) + 12)

    def device_nbytes(self) -> int:
        n, dim = self.x8.shape
        return self.estimate_device_bytes(
            n, dim, self.graph.shape[1], self.mesh_ndev
        )

    def _ensure(self):
        if self._dev is not None:
            return
        from surrealdb_tpu_torch.idx.cagra import entry_ids, probe_count
        from surrealdb_tpu_torch.ops.topk import int8_width

        ndev = self.mesh_ndev
        devs = _shard_devices(ndev, self._devices, self.key, "ANN store")
        offs = self.offsets
        dim = self.x8.shape[1]
        lens = [offs[s + 1] - offs[s] for s in range(ndev)]
        nloc = max(lens)
        minlen = min(lens)
        self._nloc, self._minlen = nloc, minlen
        w = max(int(self.cfg.get("width", 64)), 1)
        # one probe size for every slice: the nloc-sized probe budget
        # clamped to the smallest slice
        plen = max(1, min(minlen, probe_count(nloc, w)))
        self._plen = plen
        shards = []
        for s, dev in enumerate(devs):
            lo, hi = offs[s], offs[s + 1]
            g = self.graph[lo:hi].astype(np.int64)
            own = np.arange(hi - lo, dtype=np.int64)[:, None]
            inside = (g >= lo) & (g < hi)
            graph_l = np.where(inside, g - lo, own).astype(np.int32)
            x8 = to_device(self.x8[lo:hi], dev)
            if int8_width(dim) != dim:
                # zero columns up to the kernels' 16-byte row multiple
                x8 = torch.nn.functional.pad(x8, (0, int8_width(dim) - dim))
            arow = to_device(self.arow[lo:hi], dev, torch.float32)
            x2q = to_device(self.x2q[lo:hi], dev, torch.float32)
            probe = to_device(entry_ids(hi - lo, plen), dev)
            shards.append({
                "dev": dev, "base": lo,
                "graph": to_device(graph_l, dev),
                "x8": x8, "arow": arow, "x2q": x2q,
                "x8p": x8[probe].contiguous(),
                "arowp": arow[probe].contiguous(),
                "x2qp": x2q[probe].contiguous(),
                "probe_ids": probe.to(torch.int32),
            })
        self._dev = shards

    def _clamps(self, kc: int):
        cfg = self.cfg
        n = self.x8.shape[0]
        width = max(int(cfg.get("width", 64)), 1)
        iters = max(int(cfg.get("iters", 24)), 1)
        expand = max(int(cfg.get("expand", 2)), 1)
        kc = min(max(int(kc), 1), n)
        # per-shard clamps: AnnStore.search()'s rules against the
        # SMALLEST slice so every device runs the same shapes
        kc_l = min(kc, self._minlen)
        width_l = min(max(width, kc_l), self._minlen, self._plen)
        kc_l = min(kc_l, width_l)
        expand_l = min(expand, width_l)
        kc_out = min(kc, self.mesh_ndev * kc_l)
        return width_l, iters, expand_l, kc_l, kc_out

    @staticmethod
    def _bucket(qs: np.ndarray):
        b = qs.shape[0]
        bucket = 1
        while bucket < b:
            bucket *= 2
        qsb = np.ascontiguousarray(qs, np.float32)
        if bucket != b:
            qsb = np.concatenate(
                [qsb, np.zeros((bucket - b, qsb.shape[1]), np.float32)]
            )
        return qsb, b

    def search(self, qs: np.ndarray, kc: int) -> np.ndarray:
        """[B, D] f32 queries -> [B, kc'] int32 candidate ids, merged
        from the per-device partial descents."""
        from surrealdb_tpu_torch.device.annstore import (
            ann_descent, probe_seed,
        )

        self._ensure()
        width_l, iters, expand_l, kc_l, kc_out = self._clamps(kc)
        qsb, b = self._bucket(qs)
        kernelstats.note_shape(
            "mesh_ann_descent",
            (self._nloc, self.x8.shape[1], self.graph.shape[1], self._plen,
             qsb.shape[0], self.metric, width_l, iters, expand_l, kc_l,
             kc_out, self.mesh_ndev))
        kernelstats.note_sharded("mesh_ann_descent", self.mesh_ndev)
        dev0 = self._dev[0]["dev"]
        q0 = to_device(qsb, dev0)
        d_parts, i_parts = [], []
        for sh in self._dev:
            with M.on(sh["dev"]):
                q = M.move(q0, sh["dev"])
                ids0, d0 = probe_seed(sh, q, self.metric, width_l)
                ids, dist = ann_descent(
                    sh["graph"], sh["x8"], sh["arow"], sh["x2q"], q, ids0,
                    d0, self.metric, iters, expand_l, kc_l)
            d_parts.append(dist)
            i_parts.append(ids)
        _, cand = _merge_on(dev0, d_parts, i_parts,
                            [sh["base"] for sh in self._dev], kc_l, kc_out,
                            self.x8.shape[0] - 1)
        return np.ascontiguousarray(cand[:b].cpu().numpy(), np.int32)

    def search_seq(self, qs: np.ndarray, kc: int) -> np.ndarray:
        """The oracle of the partitioned descent: the SAME partition
        searched slice by slice with the plain versions (probe scores,
        stable selection, `ann_descent_plain`) and merged by a numpy
        stable argsort of the concatenated scores — `lax.top_k`'s tie
        rule; what `search` must reproduce exactly."""
        from surrealdb_tpu_torch.device.annstore import ann_descent_plain
        from surrealdb_tpu_torch.ops.topk import (
            rank_scores_int8_plain, top_k_smallest_plain,
        )

        self._ensure()
        width_l, iters, expand_l, kc_l, kc_out = self._clamps(kc)
        qsb, b = self._bucket(qs)
        n = self.x8.shape[0]
        d_parts, i_parts = [], []
        for sh in self._dev:
            q = to_device(qsb, sh["dev"])
            pscore = rank_scores_int8_plain(
                sh["x8p"], q, self.metric, sh["arowp"], sh["x2qp"],
                probe_order=True)
            d0, sel = top_k_smallest_plain(pscore, width_l)
            ids, dist = ann_descent_plain(
                sh["graph"], sh["x8"], sh["arow"], sh["x2q"], q,
                sh["probe_ids"][sel.long()], d0, self.metric, iters,
                expand_l, kc_l)
            i_parts.append(np.minimum(
                ids.cpu().numpy().astype(np.int64) + sh["base"], n - 1
            ).astype(np.int32))
            d_parts.append(dist.cpu().numpy())
        dist = np.concatenate(d_parts, axis=1)
        gids = np.concatenate(i_parts, axis=1)
        order = np.argsort(dist, axis=1, kind="stable")[:, :kc_out]
        return np.ascontiguousarray(
            np.take_along_axis(gids, order, axis=1)[:b], np.int32
        )


# -- sharded CSR graph store --------------------------------------------------

class MeshCsrStore:
    """Edge-sharded adjacency for ONE graph cache epoch: each device
    expands its contiguous edge slice into its own [B, n] mask and
    `mask_or_reduce` ORs them — bit-equal to CsrStore's single-device
    scan."""

    def __init__(self, key: str, rows: np.ndarray, cols: np.ndarray,
                 n_nodes: int, ndev: int, offsets=None, devices=None):
        self.key = key
        self.n_nodes = int(n_nodes)
        self.rows = rows
        self.cols = cols
        self.mesh_ndev = max(int(ndev), 1)
        e = rows.shape[0]
        self.offsets = (
            [int(o) for o in offsets] if offsets is not None
            else even_splits(e, self.mesh_ndev)
        )
        _check_offsets(self.offsets, e, self.mesh_ndev)
        self._devices = devices
        self._dev = None
        self._eloc = 0

    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.cols.nbytes)

    @staticmethod
    def estimate_device_bytes(e: int, ndev: int) -> int:
        """TOTAL device bytes, as the reference counts them: two int32
        edge arrays + the int32 padding mask, padded per slice."""
        ndev = max(int(ndev), 1)
        eloc = -(-max(int(e), 0) // ndev) if e else 1
        return ndev * eloc * 12

    def device_nbytes(self) -> int:
        return self.estimate_device_bytes(self.rows.shape[0],
                                          self.mesh_ndev)

    def _ensure(self):
        if self._dev is not None:
            return
        for name, arr in (("rows", self.rows), ("cols", self.cols)):
            # the kernel indexes the masks with these unchecked
            if len(arr) and (int(arr.min()) < 0
                             or int(arr.max()) >= self.n_nodes):
                raise ValueError(f"csr {name} index outside "
                                 f"[0, {self.n_nodes})")
        ndev = self.mesh_ndev
        devs = _shard_devices(ndev, self._devices, self.key, "CSR store")
        offs = self.offsets
        self._eloc = max(max(offs[s + 1] - offs[s] for s in range(ndev)), 1)
        self._dev = [
            {"dev": dev,
             "rows": to_device(self.rows[offs[s]:offs[s + 1]], dev,
                               torch.int32),
             "cols": to_device(self.cols[offs[s]:offs[s + 1]], dev,
                               torch.int32)}
            for s, dev in enumerate(devs)
        ]

    def _hop(self, sh, frontier):
        """One hop of one edge slice: the [B, n] uint8 mask of the nodes
        its edges reach from `frontier` (on the slice's device)."""
        from surrealdb_tpu_torch.device.csrstore import (
            csr_hop_step, multi_hop_plain,
        )

        if not frontier.is_cuda:
            return multi_hop_plain(sh["rows"], sh["cols"], frontier, 1,
                                   False).to(torch.uint8)
        part = torch.zeros_like(frontier)
        if sh["rows"].shape[0]:
            csr_hop_step(sh["rows"], sh["cols"], frontier, part)
        return part

    def multi_hop(self, start: np.ndarray, hops: int,
                  union: bool) -> np.ndarray:
        """CsrStore.multi_hop's exact contract over the mesh."""
        self._ensure()
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
        kernelstats.note_shape("mesh_csr_hop", (self.n_nodes, self._eloc,
                                                self.mesh_ndev, int(hops),
                                                bool(union), bucket))
        kernelstats.note_sharded("mesh_csr_hop", self.mesh_ndev)
        dev0 = self._dev[0]["dev"]
        frontier = to_device(masks.astype(bool), dev0).to(torch.uint8)
        acc = torch.zeros_like(frontier) if union else None
        for _ in range(int(hops)):
            parts = []
            for sh in self._dev:
                with M.on(sh["dev"]):
                    parts.append(self._hop(sh, M.move(frontier, sh["dev"])))
            with M.on(dev0):
                frontier = M.mask_or(M.gather_to(parts, dev0), acc)
        out = (acc if union else frontier).cpu().numpy()[:b]
        out = out.astype(np.uint8)
        return out[0] if single else out


# -- selfcheck / proof entry points -------------------------------------------

def _knn_close(ref, got, atol=1e-4, rtol=1e-5) -> bool:
    """Distances within atol + rtol|d| (+inf where the reference has
    it) and ids equal wherever the reference's neighbouring distances
    are separated by more."""
    (rd, ri), (gd, gi) = ref, got
    rd = np.asarray(rd, np.float64)
    gd = np.asarray(gd, np.float64)
    if rd.shape != gd.shape or not np.array_equal(np.isinf(rd),
                                                  np.isinf(gd)):
        return False
    fin = np.isfinite(rd)
    if not (np.abs(gd[fin] - rd[fin])
            <= atol + rtol * np.abs(rd[fin])).all():
        return False
    with np.errstate(invalid="ignore"):
        gap = np.diff(rd, axis=1) > atol + rtol * np.abs(rd[:, 1:])
    sep = fin.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    return bool((np.asarray(gi) == np.asarray(ri))[sep].all())


def selfcheck(devs: list, max_devices=None, seed: int = 0) -> dict:
    """Property sweep across pow2 device counts AND random contiguous
    row splits: sharded exact (euclidean, manhattan), int8 ranking,
    partitioned ANN descent (vs `search_seq`) and CSR multi-hop (vs
    the single-device CsrStore). Returns a report dict; ok=False on the
    first divergence. Runs on the device list `devs`.

    Byte-identity is the bar wherever the partial kernels are
    row-independent: manhattan, int8, the descent, CSR, and euclidean
    on the card. The plain euclidean distance on the CPU is a matrix
    product whose low bits depend on the shard's row count, so there
    it is held to atol=1e-4, rtol=1e-5 with ids by the id rule
    (`checks["vec_exact_euclidean"]`; its byte-identity is reported in
    `byte_identical`)."""
    from surrealdb_tpu_torch.device.csrstore import CsrStore

    devs = [torch.device(d) for d in devs]
    navail = len(devs)
    cap = min(navail, int(max_devices)) if max_devices else navail
    counts = [d for d in (1, 2, 4, 8) if d <= cap]
    rng = np.random.default_rng(seed)
    checks: dict = {}
    byte_identical: dict = {}
    report = {"n_devices": navail, "counts": counts,
              "device": str(devs[0]) if devs else None,
              "physical_devices": physical_devices(devs),
              "checks": checks, "byte_identical": byte_identical}

    def rand_offsets(n, ndev):
        cut = np.sort(rng.choice(np.arange(1, n), size=ndev - 1,
                                 replace=False))
        return [0] + [int(c) for c in cut] + [n]

    n, dim, k, nq = 257, 16, 10, 5
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 20, replace=False)] = False
    qs = (xs[rng.integers(0, n, nq)]
          + 0.1 * rng.normal(size=(nq, dim))).astype(np.float32)
    cfg = {"hbm_budget": 1 << 62, "score_budget": 1 << 22,
           "query_chunk": 64, "int8_oversample": 4,
           "block_rows": 1 << 20}

    def sweep(n_items, make, run, ref=None, close=None):
        """run(store) -> result; each (ndev, split) must equal `ref`
        (the first result unless a single-device oracle is given):
        byte for byte, or by `close(ref, result)` when given. Returns
        (ok, byte-identical everywhere)."""
        ok = same = True
        for d in counts:
            splits = [even_splits(n_items, d)]
            if d > 1 and n_items >= d:
                splits.append(rand_offsets(n_items, d))
            for offs in splits:
                cur = run(make(d, offs))
                if ref is None:
                    ref = cur
                    continue
                eq = all(np.array_equal(a, b) for a, b in zip(cur, ref))
                same = same and eq
                ok = ok and (close(ref, cur) if close else eq)
        return ok, same

    for metric in ("euclidean", "manhattan"):
        loose = metric == "euclidean" and devs[0].type == "cpu"
        checks[f"vec_exact_{metric}"], \
            byte_identical[f"vec_exact_{metric}"] = sweep(
                n,
                lambda d, offs, m=metric: MeshVecStore(
                    f"chk/{m}", xs, valid, m, 3.0, cfg, d, offs, devs),
                lambda st: tuple(st.knn(qs, k)[1]),
                close=_knn_close if loose else None,
            )
    cfg8 = dict(cfg, hbm_budget=0)  # force the int8 ranking branch
    checks["vec_int8"], byte_identical["vec_int8"] = sweep(
        n,
        lambda d, offs: MeshVecStore(
            "chk/int8", xs, valid, "euclidean", 3.0, cfg8, d, offs, devs),
        lambda st: tuple(st.knn(qs, k)[1]),
    )
    # partitioned descent: the mesh search vs the sequential oracle of
    # the SAME partition (per-(ndev, split) identity — the partition
    # itself legitimately changes the candidate walk)
    x8 = np.clip(np.rint(xs * 32), -127, 127).astype(np.int8)
    arow = np.full(n, 1 / 32.0, np.float32)
    x2q = (xs.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    graph = rng.integers(0, n, size=(n, 8)).astype(np.int32)
    acfg = {"width": 32, "iters": 6, "expand": 2}
    ok = True
    for d in counts:
        splits = [even_splits(n, d)]
        if d > 1:
            splits.append(rand_offsets(n, d))
        for offs in splits:
            st = MeshAnnStore("chk/ann", graph, x8, arow, x2q,
                              "euclidean", acfg, d, offs, devs)
            if st.search(qs, 16).tobytes() != \
                    st.search_seq(qs, 16).tobytes():
                ok = False
    checks["ann_descent_vs_seq"] = ok
    n_nodes, n_edges = 64, 400
    rows = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    cols = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    starts = np.zeros((3, n_nodes), np.uint8)
    starts[np.arange(3), rng.integers(0, n_nodes, 3)] = 1
    single = CsrStore("chk/csr0", rows, cols, n_nodes, devs[0])
    for hops, union in ((1, False), (3, True)):
        ref = (single.multi_hop(starts, hops, union),)
        name = f"csr_hop{hops}{'u' if union else ''}"
        checks[name], byte_identical[name] = sweep(
            n_edges,
            lambda d, offs: MeshCsrStore(
                "chk/csr", rows, cols, n_nodes, d, offs, devs),
            lambda st, h=hops, u=union: (st.multi_hop(starts, h, u),),
            ref=ref,
        )
    report["ok"] = all(checks.values())
    report["sharded_kernel_ran"] = max(counts) > 1
    return report


def _budget_store():
    """The over-budget store both budget proofs ship: a manhattan
    (non-MXU → exact) store of ~2.1 MB against a 1 MiB per-device
    budget — fits at ndev=4, not at 1."""
    n, dim = 8192, 64
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    valid = np.ones(n, bool)
    meta = {
        "key": "budget/chk", "tag": ["t1"], "metric": "manhattan",
        "mink_p": 3.0,
        "cfg": {"hbm_budget": 1 << 62, "score_budget": 1 << 22,
                "query_chunk": 64, "int8_oversample": 4,
                "block_rows": 1 << 20},
    }
    return xs, valid, meta


def _host(device: str, ndev: int, budget_bytes: int):
    from surrealdb_tpu_torch.device.handlers import DeviceHost

    host = DeviceHost(device, mesh_devices=ndev)
    host.budget_bytes = int(budget_bytes)
    return host


def refusal_probe(budget_bytes: int = 1 << 20, device: str = "cuda") -> dict:
    """Negative half of the placement proof, run in a 1-device process
    (`--devices 1 --refusal-probe`): the same store must be REFUSED
    when there is no mesh to widen onto."""
    from surrealdb_tpu_torch.device.handlers import DeviceBudgetError

    xs, valid, meta = _budget_store()
    host = _host(device, 1, budget_bytes)
    out = {"n_devices": mesh_size(len(host.devices)),
           "budget_bytes": int(budget_bytes)}
    try:
        host.handle("vec_load", dict(meta), [xs, valid])
        out["refused"] = False
    except DeviceBudgetError as e:
        out["refused"] = True
        out["refusal"] = str(e)
    out["ok"] = bool(out["refused"] and out["n_devices"] == 1)
    return out


def budget_check(budget_bytes: int = 1 << 20, device: str = "cuda",
                 ndev: int = 8) -> dict:
    """Per-device budget placement proof: a store whose single-device
    estimate is over budget SERVES SHARDED on this (multi-device)
    list, and the SAME ship is refused by a 1-device subprocess
    (`refusal_probe`) — fits on the mesh, not on one device."""
    import json
    import subprocess
    import sys

    xs, valid, meta = _budget_store()
    qs = xs[:3] + 0.1
    out: dict = {"budget_bytes": int(budget_bytes)}
    saved = os.environ.get("SURREAL_DEVICE_MESH")
    try:
        os.environ["SURREAL_DEVICE_MESH"] = "auto"
        host = _host(device, ndev, budget_bytes)
        tag, lmeta, _ = host.handle("vec_load", dict(meta), [xs, valid])
        out["load"] = tag
        out["mesh_ndev"] = int(lmeta.get("mesh_ndev", 1))
        tag, kmeta, bufs = host.handle(
            "vec_knn", {"key": meta["key"], "tag": meta["tag"], "k": 5},
            [qs],
        )
        out["knn"] = tag
        out["knn_mesh_ndev"] = int(kmeta.get("mesh_ndev", 1))
        out["sharded_served"] = (
            tag == "ok" and out["mesh_ndev"] >= 2
            and out["knn_mesh_ndev"] >= 2
            and bufs[1].shape == (3, 5)
        )
    finally:
        if saved is None:
            os.environ.pop("SURREAL_DEVICE_MESH", None)
        else:
            os.environ["SURREAL_DEVICE_MESH"] = saved
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH", "")) if p)
    r = subprocess.run(
        [sys.executable, "-m", "surrealdb_tpu_torch.device.mesh",
         "--devices", "1", "--device", device, "--refusal-probe"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    try:
        probe = json.loads(r.stdout.strip().splitlines()[-1])
    except Exception:
        probe = {"ok": False, "stderr": r.stderr[-500:]}
    out["refusal_probe"] = probe
    out["single_device_refused"] = bool(probe.get("refused"))
    out["ok"] = bool(out.get("sharded_served") and probe.get("ok"))
    return out


def _main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="surrealdb_tpu_torch.device.mesh")
    ap.add_argument("--devices", type=int, default=8,
                    help="logical devices of the device list")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="shards on the cards (default) or on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-check", action="store_true",
                    help="also prove per-device budget placement")
    ap.add_argument("--refusal-probe", action="store_true",
                    help="run only the 1-device budget refusal probe")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", flush=True)
        return 2
    if args.refusal_probe:
        rep = refusal_probe(device=args.device)
        print(json.dumps(rep))
        return 0 if rep["ok"] else 1
    rep = selfcheck(device_list(args.devices, args.device),
                    max_devices=args.devices, seed=args.seed)
    if args.budget_check:
        rep["budget"] = budget_check(device=args.device, ndev=args.devices)
        rep["ok"] = bool(rep["ok"] and rep["budget"]["ok"])
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main())
