"""Row-sharded KNN over a list of devices, and over a host-major list
of device lists (the reference's `parallel/mesh.py`, its 1-D data mesh
and its two-level dcn x data mesh).

The legacy self-sharded vector store (device/vecstore.py on a runner
with several devices) cuts its rows into one contiguous shard per
device. Each shard runs the port's single-device kernels on its own
device -- `distance_tile` + `select_topk_rows` for the exact metrics,
`rank_scores_bf16` + `select_topk_rows` (exact kc candidates, in place
of `approx_max_k`) + `gather_rescore` for euclidean/cosine/dot, the
candidate gather never leaving its shard -- and only the [B, k] or
[B, kc] (dist, local id) tiles travel to the first device, where
`merge_partials_topk` (csrc/mesh_merge.cu) takes the exact top k by
(dist, position in shard order), as the reference's `all_gather` +
`lax.top_k` does.

The reference pads N up to a multiple of the device count (zero rows,
masked); here a shard holds only its real rows, and the padding rows
exist only as the merge's padding columns, (+inf, global id past N)
where they would surface.

The two-level mesh (`multihost_mesh`) is `hosts` lists of devices, one
per host. Its shards are the flat host-major list's `row_slices`, so a
row's global id is (host * ndata + data) * nloc + local, as the
reference's. Each shard runs the single-level shard body; each host
merges its shards' tiles on its first device (the reference's ICI
stage), and the hosts' [B, k] winners merge on the first host's
(the DCN stage). The two stages are kept apart: one merge of every
shard's tile gives the same set but may order ties otherwise.
"""

from __future__ import annotations

import torch

from surrealdb_tpu_torch.device.vecstore import to_device
from surrealdb_tpu_torch.ops import merge as M
from surrealdb_tpu_torch.ops.metrics import COSINE, EUCLIDEAN


def default_mesh(devices) -> list:
    """The device list rows shard over (the reference's mesh over
    `jax.devices()`)."""
    if not devices:
        raise RuntimeError("no device list configured")
    return [torch.device(d) for d in devices]


def row_slices(n: int, ndev: int) -> list:
    """Shard s holds rows [s*nloc, (s+1)*nloc) of the padded store,
    nloc = ceil(n / ndev), clipped to the n real rows."""
    nloc = -(-n // max(ndev, 1))
    return [(min(s * nloc, n), min((s + 1) * nloc, n)) for s in range(ndev)]


class Shards:
    """One [N, ...] array as per-device row shards (`row_slices`)."""

    def __init__(self, parts: list, mesh: list, n: int):
        self.parts = parts
        self.mesh = mesh
        self.n = int(n)
        self.nloc = -(-self.n // len(mesh))

    def bases(self) -> list:
        """Global row id of each shard's row 0 (the reference's
        axis_index * nloc)."""
        return [s * self.nloc for s in range(len(self.mesh))]


def _place(arr, lo: int, hi: int, device, dtype):
    if isinstance(arr, torch.Tensor):
        return arr[lo:hi].to(device=device, dtype=dtype or arr.dtype)
    return to_device(arr[lo:hi], device, dtype)


def shard_rows(mesh: list, arr, dtype=None) -> Shards:
    """Place a [N, ...] array (host numpy, or a tensor: a shard on the
    tensor's own device is a view of it) row-sharded over the device
    list."""
    return Shards([_place(arr, lo, hi, d, dtype)
                   for d, (lo, hi) in zip(mesh, row_slices(len(arr),
                                                           len(mesh)))],
                  mesh, len(arr))


def _part(shards: Shards, s: int):
    return None if shards is None else shards.parts[s]


def _merge(dev0, d_parts, i_parts, bases, w, k):
    with M.on(dev0):
        return M.merge_partials(M.gather_to(d_parts, dev0),
                                M.gather_to(i_parts, dev0), bases, w, k)


def _empty(b: int, device):
    return (torch.empty((b, 0), dtype=torch.float32, device=device),
            torch.empty((b, 0), dtype=torch.int32, device=device))


def sharded_knn(mesh: list, xs: Shards, qs, valid: Shards, k: int,
                metric: str = EUCLIDEAN, p: float = 3.0,
                xstats: Shards = None):
    """Exact fused distance + top-k on row-sharded rows (the non-MXU
    metrics): per shard `distance_matrix` (masked, with the shard's
    cached row statistics `xstats` when given) and its k_l best,
    then the exact merge. Returns (dists [B, k] f32, ids [B, k] int32)
    on the first device; padding slots carry +inf and ids >= N."""
    from surrealdb_tpu_torch.ops.distance import distance_matrix
    from surrealdb_tpu_torch.ops.topk import top_k_smallest

    qs = torch.as_tensor(qs, dtype=torch.float32)
    k_l = min(k, xs.nloc)
    d_parts, i_parts = [], []
    for s, dev in enumerate(mesh):
        rows = xs.parts[s]
        if rows.shape[0] == 0:
            d, i = _empty(qs.shape[0], mesh[0])
        else:
            with M.on(dev):
                d = distance_matrix(rows, M.move(qs, dev), metric, p,
                                    _part(valid, s), _part(xstats, s))
                d, i = top_k_smallest(d, min(k_l, rows.shape[0]))
        d_parts.append(d)
        i_parts.append(i)
    return _merge(mesh[0], d_parts, i_parts, xs.bases(), k_l,
                  min(k, len(mesh) * k_l))


def _rank_rescore_parts(mesh: list, xs_rank: Shards, xs_full: Shards, qs,
                        kc: int, metric: str, x2, norms, valid):
    """Per shard of the flat device list: the bf16 rank scores, their
    exact kc best, the exact f32 rescore of those candidates from the
    shard's own rows -> ([B, kc] dists, [B, kc] local ids) per shard (an
    empty shard's on the first device)."""
    from surrealdb_tpu_torch.ops.topk import (
        gather_rescore, rank_scores, top_k_smallest,
    )

    d_parts, i_parts = [], []
    for s, dev in enumerate(mesh):
        rank = xs_rank.parts[s]
        if rank.shape[0] == 0:
            d, cand = _empty(qs.shape[0], mesh[0])
        else:
            with M.on(dev):
                q = M.move(qs, dev)
                v = _part(valid, s)
                x2_s = _part(x2, s)
                if x2_s is None and metric == EUCLIDEAN:
                    x2_s = torch.zeros((rank.shape[0],), device=dev)
                n_s = _part(norms, s)
                if n_s is None and metric == COSINE:
                    n_s = torch.ones((rank.shape[0],), device=dev)
                score = rank_scores(rank, q, metric, x2_s, v)
                _, cand = top_k_smallest(score, min(kc, rank.shape[0]))
                del score
                d = gather_rescore(xs_full.parts[s], q, cand, metric, n_s, v)
        d_parts.append(d)
        i_parts.append(cand)
    return d_parts, i_parts


def sharded_rank_rescore(mesh: list, xs_rank: Shards, xs_full: Shards, qs,
                         k: int, kc: int, metric: str = EUCLIDEAN,
                         x2: Shards = None, norms: Shards = None,
                         valid: Shards = None):
    """Two-stage sharded KNN for euclidean/cosine/dot: per shard the bf16
    rank scores, their exact kc best, the exact f32 rescore of those
    candidates from the shard's own rows; then the exact merge of the
    [B, kc] tiles. Returns (dists [B, k'] f32, ids [B, k'] int32) on
    the first device, k' = min(k, kc * ndev) with kc clamped to the
    shard rows."""
    qs = torch.as_tensor(qs, dtype=torch.float32)
    kc = min(kc, xs_rank.nloc)
    k = min(k, kc * len(mesh))
    d_parts, i_parts = _rank_rescore_parts(mesh, xs_rank, xs_full, qs, kc,
                                           metric, x2, norms, valid)
    return _merge(mesh[0], d_parts, i_parts, xs_rank.bases(), kc, k)


# -- the two-level (dcn x data) mesh ------------------------------------------

def multihost_mesh(devices, hosts: int = None) -> list:
    """`hosts` groups of len(devices) // hosts devices, host-major (the
    reference's (dcn, data) mesh over simulated hosts: one process
    drives every group). `hosts` None or <= 1: one group."""
    devices = default_mesh(devices)
    if hosts is None or hosts <= 1:
        return [devices]
    if len(devices) % hosts:
        raise ValueError(
            f"{len(devices)} devices do not split into {hosts} hosts"
        )
    per = len(devices) // hosts
    return [devices[h * per:(h + 1) * per] for h in range(hosts)]


def _flat(mesh: list) -> list:
    return [d for host in mesh for d in host]


def shard_rows_hier(mesh: list, arr, dtype=None) -> Shards:
    """Row-shard a host [N, ...] array over both levels (host-major)."""
    return shard_rows(_flat(mesh), arr, dtype)


def shard_vec_hier(mesh: list, arr, dtype=None) -> Shards:
    """Place a host [N] per-row array sharded to match shard_rows_hier
    (a shard holds only real rows: the reference's pad and fill have
    nothing to fill)."""
    return shard_rows(_flat(mesh), arr, dtype)


def sharded_rank_rescore_hier(mesh: list, xs_rank: Shards, xs_full: Shards,
                              qs, k: int, kc: int, metric: str = EUCLIDEAN,
                              x2: Shards = None, norms: Shards = None,
                              valid: Shards = None):
    """Two-stage sharded KNN over a two-level mesh: the shard body of
    `sharded_rank_rescore` on every device, then `merge_partials_topk`
    over each host's shards (data order, to min(k, kc * ndata)) and over
    the hosts' winners (host order, to k). Returns (dists [B, k'] f32,
    ids [B, k'] int32) on the first host's first device, k' = min(k,
    kc * ndata) with kc clamped to the shard rows."""
    flat = _flat(mesh)
    ndata = len(mesh[0])
    qs = torch.as_tensor(qs, dtype=torch.float32)
    kc = min(kc, xs_rank.nloc)
    k = min(k, kc * ndata)
    d_parts, i_parts = _rank_rescore_parts(flat, xs_rank, xs_full, qs, kc,
                                           metric, x2, norms, valid)
    bases = xs_rank.bases()
    host_d, host_i = [], []
    for h, host in enumerate(mesh):
        sl = slice(h * ndata, (h + 1) * ndata)
        d, i = _merge(host[0], d_parts[sl], i_parts[sl], bases[sl], kc, k)
        host_d.append(d)
        host_i.append(i)
    # the hosts' ids are global already
    return _merge(mesh[0][0], host_d, host_i, [0] * len(mesh), k, k)
