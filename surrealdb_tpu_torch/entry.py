"""Entry points of the port (the reference's `__graft_entry__.py`).

entry():            (fn, (xs, qs)): exact cosine KNN over 4096 x 128
                    rows for 8 queries, k = 10 (`knn_search`:
                    `distance_tile` + `select_topk_rows`), on the card.
dryrun_multichip(): the sharded query step over n logical devices
                    (`cuda:(s % device_count)`, as the mesh runner places
                    them) at tiny shapes: the single-level mesh's
                    `sharded_rank_rescore`, one CSR hop, the serving
                    `MeshVecStore` against one device, and the two-level
                    mesh's `sharded_rank_rescore_hier`. Prints one
                    `MULTICHIP: {...}` line.

Both run on the card unless the caller passes `device="cpu"`. Before
touching the card, a supervised runner is spawned and awaited (the
backend guard); where it cannot start, the entry points raise
`DeviceUnavailable` and nothing falls back to the CPU.
"""

from __future__ import annotations

import json

import numpy as np

from surrealdb_tpu_torch import cnf

_BACKEND_GUARDED = False


def _guard_backend_init(device=None):
    """Probe the card's init in a supervised runner subprocess with the
    init watchdog (SURREAL_BACKEND_INIT_TIMEOUT_S, default 240 s): a
    runner that fails or hangs raises DeviceUnavailable here, after the
    supervisor is shut down, instead of hanging this process or
    carrying on on the CPU. Skipped when the caller asks for the CPU."""
    global _BACKEND_GUARDED

    if _BACKEND_GUARDED or str(device).split(":")[0] == "cpu":
        return
    from surrealdb_tpu_torch.device.supervisor import (
        DeviceSupervisor, DeviceUnavailable,
    )

    timeout = cnf.env_float("SURREAL_BACKEND_INIT_TIMEOUT_S", 240.0)
    sup = DeviceSupervisor(mode="auto", init_timeout_s=timeout,
                           device=str(device or "cuda"))
    try:
        ok = sup.wait_ready(timeout + 10)
        reason = None if ok else (
            sup.last_error
            or f"backend init watchdog: device discovery hung > "
               f"{timeout:.0f}s")
    finally:
        sup.shutdown()
    if reason is not None:
        raise DeviceUnavailable(reason)
    _BACKEND_GUARDED = True


def entry(device=None):
    """Returns (fn, (xs, qs)): `fn(xs, qs)` -> (dists [8, 10] f32, ids
    [8, 10] int32), the inputs on `device` (default the card)."""
    _guard_backend_init(device)
    import torch

    from surrealdb_tpu_torch.ops.topk import knn_search

    dev = torch.device(device or "cuda")
    xs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4096, 128)).astype(np.float32)).to(dev)
    qs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 128)).astype(np.float32)).to(dev)

    def fn(xs, qs):
        d, i = knn_search(xs, qs, 10, "cosine")
        return d, i

    return fn, (xs, qs)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded query step over `n_devices` logical devices. Prints
    ONE `MULTICHIP: {...}` JSON line (stdout, also on failure) whose
    `sharded_kernel_ran` and `n_devices_used` come from the shards that
    ran, `platform` from the devices they ran on and `physical_cards`
    from how many distinct devices hold them. Raises on any failed
    check."""
    status = {
        "probe": "dryrun_multichip",
        "n_devices": int(n_devices),
        "sharded_kernel_ran": False,
        "n_devices_used": 0,
        "mesh_shape": [0],
        "fallback_reason": None,
        "stages": [],
        "platform": None,
        "physical_cards": 0,
    }
    try:
        _dryrun_multichip(int(n_devices), status, device)
    except BaseException as e:
        status["fallback_reason"] = f"{e.__class__.__name__}: {e}"[:300]
        raise
    finally:
        print("MULTICHIP: " + json.dumps(status), flush=True)


def _check(cond, what: str):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _recall(got, want) -> float:
    hits = sum(len(set(g.tolist()) & set(w.tolist()))
               for g, w in zip(got, want))
    return hits / want.size


def probe_hop(indices: np.ndarray, device):
    """The reference probe's hop (`__graft_entry__.py` `hop`): node v
    has out-edges to indices[2v] and indices[2v + 1]; from the frontier
    {0, 1, 2, 3}, the [n] bool mask of the nodes one hop away, by one
    `csr_hop_step` on the card (the plain hop on the CPU)."""
    import torch

    from surrealdb_tpu_torch.device.csrstore import multi_hop_masks

    n_nodes = len(indices) // 2
    dev = torch.device(device)
    src = torch.arange(n_nodes, dtype=torch.int32).repeat_interleave(2)
    frontier = torch.zeros((1, n_nodes), dtype=torch.uint8)
    frontier[0, :4] = 1
    return multi_hop_masks(src.to(dev), torch.from_numpy(
        np.ascontiguousarray(indices, np.int32)).to(dev), frontier.to(dev),
        1, False)[0]


def _dryrun_multichip(n_devices: int, status: dict, device) -> None:
    _guard_backend_init(device)
    import torch

    from surrealdb_tpu_torch.device import kernelstats
    from surrealdb_tpu_torch.device import mesh as DM
    from surrealdb_tpu_torch.ops.topk import knn_search
    from surrealdb_tpu_torch.parallel import mesh as PM

    devices = DM.device_list(n_devices, str(device or "cuda"))
    status["platform"] = devices[0].type
    status["physical_cards"] = DM.physical_devices(devices)

    # ---- 1) the single-level sharded KNN step: per shard a bf16 rank,
    # its exact kc best and their f32 rescore, then the exact merge
    mesh = PM.default_mesh(devices)
    n, dim, b, k = 64 * n_devices, 32, 4, 5
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    x2 = (xs.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    ones = np.ones((n,), dtype=bool)
    rank = PM.shard_rows(mesh, xs, torch.bfloat16)
    d, i = PM.sharded_rank_rescore(
        mesh, rank, PM.shard_rows(mesh, xs), torch.from_numpy(qs), k, 4 * k,
        "euclidean", PM.shard_rows(mesh, x2), None, PM.shard_rows(mesh, ones))
    got_i = i.cpu().numpy()
    ref = np.linalg.norm(xs[None, :, :] - qs[:, None, :], axis=-1)
    want_i = np.argsort(ref, axis=1)[:, :k]
    recall = _recall(got_i, want_i)
    _check(recall >= 0.95, f"sharded recall {recall}")
    status["sharded_kernel_ran"] = True
    status["n_devices_used"] = sum(1 for p in rank.parts if p.shape[0])
    status["mesh_shape"] = [len(mesh)]
    status["stages"].append("sharded_rank_rescore")

    # ---- 2) one graph frontier hop over the reference probe's CSR (two
    # out-edges a node, four start nodes): one csr_hop_step
    n_nodes = 64 * n_devices
    indices = rng.integers(0, n_nodes, size=(2 * n_nodes,)).astype(np.int32)
    nf = probe_hop(indices, devices[0])
    _check(bool(nf.any()), "graph hop reached no node")
    status["stages"].append("graph_hop")

    # ---- 3) the serving mesh store: row shards, per-device partial
    # top-k, the exact merge, against one device's exact scan (the same
    # bytes on the card; on the CPU the plain product's low bits depend
    # on the row count, so ids equal and distances close)
    mcfg = {"hbm_budget": 1 << 62, "score_budget": 1 << 22,
            "query_chunk": 64, "int8_oversample": 4, "block_rows": 1 << 20}
    before = kernelstats.snapshot().get("sharded", 0)
    mst = DM.MeshVecStore("probe/mesh", xs, np.ones(n, np.uint8),
                          "euclidean", 3.0, mcfg, n_devices,
                          devices=devices)
    mmeta, mbufs = mst.knn(qs, k)
    dev0 = devices[0]
    rd, ri = knn_search(torch.from_numpy(xs).to(dev0),
                        torch.from_numpy(qs).to(dev0), k, "euclidean",
                        valid=torch.ones(n, dtype=torch.bool, device=dev0))
    rd, ri = rd.cpu().numpy(), ri.cpu().numpy()
    md, mi = np.asarray(mbufs[0]), np.asarray(mbufs[1])
    if dev0.type == "cuda":
        same = md.tobytes() == rd.tobytes() and mi.tobytes() == ri.tobytes()
    else:
        same = np.array_equal(mi, ri) and np.allclose(md, rd, atol=1e-4,
                                                      rtol=1e-5)
    _check(same, "mesh store top-k diverged from the single-device kernel")
    sharded = kernelstats.snapshot().get("sharded", 0) - before
    _check(mmeta.get("mesh_ndev") == n_devices >= 1
           and (n_devices == 1 or sharded >= 1),
           f"mesh store served on {mmeta.get('mesh_ndev')} devices")
    status["stages"].append("device_mesh_store")

    # ---- 4) the two-level (dcn x data) mesh: each host merges its
    # shards' tiles, then the hosts' winners merge
    if n_devices >= 2:
        hmesh = PM.multihost_mesh(devices, hosts=2)
        hd, hi = PM.sharded_rank_rescore_hier(
            hmesh, PM.shard_rows_hier(hmesh, xs, torch.bfloat16),
            PM.shard_rows_hier(hmesh, xs), torch.from_numpy(qs), k, 4 * k,
            "euclidean", PM.shard_vec_hier(hmesh, x2), None,
            PM.shard_vec_hier(hmesh, ones))
        recall_h = _recall(hi.cpu().numpy(), want_i)
        _check(recall_h >= 0.95, f"hier recall {recall_h}")
        status["stages"].append("hier_mesh")
