"""Device op dispatch table of the torch runner (the reference's
`device/handlers.py`): vector, graph-ANN and CSR block caches, on one
device or sharded over the runner's device list, brute KNN, status.

Every handler is `(meta, bufs) -> (tag, meta_out, bufs_out)`; raising
maps to an `("err", ...)` reply. Op names, the meta/bufs layout and the
`ok`/`stale`/`err` tags are the reference's, so a reference supervisor
can drive this host. The store caches are bounded LRU: an evicted store
answers `stale` on its next use and the serving side re-ships (device
blocks are a cache over KV truth). The byte budget
(SURREAL_DEVICE_MEM_BUDGET_MB) admits a ship by evicting LRU stores
first and refuses it with `DeviceBudgetError` only when the store
cannot fit an otherwise-empty runner. The budget is per device: on a
device list of several devices, placement (`device/mesh.py`
`pick_ndev`) first widens a store over the mesh, so one that fits on 8
devices but not on 1 shards instead of refusing; every store accounts
its share on the most-loaded device.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.device.vecstore import to_device

# bounded block caches: enough for every live index in a busy node, and
# an eviction is only a re-ship (never an error)
MAX_VEC_STORES = 64
MAX_ANN_STORES = 16
MAX_CSR_STORES = 64


class DeviceBudgetError(RuntimeError):
    """A ship would exceed the runner's device-memory byte budget even
    after evicting every other store. The reply carries `oom: true`;
    the serving side degrades that store to its host path."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA was asked for and is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(runner: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _vec_estimate(n: int, dim: int, itemsize: int, meta: dict,
                  ndev: int, ndev_list: int) -> int:
    """Install estimate: the mesh store's TOTAL bytes when the load is
    placed on a mesh (`ndev` >= 1), else the VecStore formula over the
    runner's `ndev_list` devices."""
    if ndev:
        from surrealdb_tpu_torch.device.mesh import MeshVecStore

        return MeshVecStore.estimate_device_bytes(
            n, dim, itemsize, meta["metric"], meta["cfg"], ndev
        )
    from surrealdb_tpu_torch.device.vecstore import VecStore

    return VecStore.estimate_device_bytes(
        n, dim, itemsize, meta["metric"], meta["cfg"], ndev_list
    )


class DeviceHost:
    """Per-runner registry of vector, graph-ANN and CSR block caches.
    `mesh_devices` N asks for a device list of N logical devices
    (device/mesh.py `device_list`); the default is every visible card,
    or one CPU."""

    def __init__(self, device="cuda", mesh_devices=None):
        from surrealdb_tpu_torch.device import mesh as devmesh

        self.devices = devmesh.device_list(mesh_devices,
                                           resolve_device(device))
        self.device = self.devices[0]
        if self.device.type == "cuda":
            from surrealdb_tpu_torch.device import compile_cache

            compile_cache.ensure_built()
        self.vec: OrderedDict = OrderedDict()  # key -> (tag, VecStore)
        self.csr: OrderedDict = OrderedDict()  # key -> (tag, CsrStore)
        self.ann: OrderedDict = OrderedDict()  # key -> (tag, AnnStore)
        # multipart vec loads in flight: key -> (meta, vecs, valid)
        self._staging: dict = {}
        # multipart ANN loads: key -> (meta, {name: array}); the int8
        # rows and the graph ship as independently chunked buffers
        self._ann_staging: dict = {}
        self.budget_bytes = cnf.env_int(
            "SURREAL_DEVICE_MEM_BUDGET_MB", cnf.DEVICE_MEM_BUDGET_MB
        ) << 20
        self.oom_refusals = 0
        self.budget_evictions = 0
        # multipart install reservations: key -> install bytes admitted
        # at vec_load_begin but not yet resident
        self._reserved: dict = {}

    # -- device-memory budget ------------------------------------------------

    def _staged(self) -> int:
        total = 0
        for _m, vecs, valid in self._staging.values():
            total += int(vecs.nbytes) + int(valid.nbytes)
        for _m, by_name in self._ann_staging.values():
            total += sum(int(a.nbytes) for a in by_name.values())
        return total + sum(self._reserved.values())

    def mem_used(self) -> int:
        """Estimated device-resident bytes across the block caches plus
        multipart staging (host-side until load_end, admitted up
        front) and reservations."""
        total = 0
        for cache in (self.vec, self.csr, self.ann):
            for _tag, st in cache.values():
                total += st.device_nbytes()
        return total + self._staged()

    def mem_used_device0(self) -> int:
        """Estimated bytes on the most-loaded device: a sharded store
        contributes its per-device share (estimate / mesh_ndev), an
        unsharded one, staging and reservations their whole estimate —
        what the per-device budget admits against."""
        total = 0
        for cache in (self.vec, self.csr, self.ann):
            for _tag, st in cache.values():
                ndev = max(int(getattr(st, "mesh_ndev", 1) or 1), 1)
                total += -(-st.device_nbytes() // ndev)
        return total + self._staged()

    def _place(self, est_total_fn, n_items: int) -> int:
        """Mesh width for an install: 0 = an unsharded store (mesh off,
        one device, or a store that fits one device's budget), else the
        budget-aware pow2 count of device/mesh.pick_ndev."""
        from surrealdb_tpu_torch.device import mesh as devmesh

        ndevs = len(self.devices)
        if devmesh.mesh_size(ndevs) <= 1:
            return 0
        nd = devmesh.pick_ndev(est_total_fn, self.budget_bytes,
                               n_rows=max(n_items, 1), n_devices=ndevs)
        return nd if nd > 1 else 0

    def _place_vec(self, n: int, dim: int, itemsize: int,
                   meta: dict) -> int:
        from surrealdb_tpu_torch.device.mesh import MeshVecStore

        return self._place(lambda d: MeshVecStore.estimate_device_bytes(
            n, dim, itemsize, meta["metric"], meta["cfg"], d), n)

    def _place_ann(self, n: int, dim: int, d_out: int) -> int:
        from surrealdb_tpu_torch.device.mesh import MeshAnnStore

        return self._place(lambda d: MeshAnnStore.estimate_device_bytes(
            n, dim, d_out, d), n)

    def _place_csr(self, n_edges: int) -> int:
        from surrealdb_tpu_torch.device.mesh import MeshCsrStore

        return self._place(
            lambda d: MeshCsrStore.estimate_device_bytes(n_edges, d),
            n_edges)

    def _evict_key(self, key: str):
        for cache in (self.vec, self.csr, self.ann):
            cache.pop(key, None)

    def _admit(self, incoming: int, keep_key: str = "", ndev: int = 1):
        """Admit `incoming` total estimated bytes sharded over `ndev`
        devices: the per-device budget sees `ceil(incoming/ndev)`."""
        self._admit_share(-(-int(incoming) // max(int(ndev), 1)), keep_key)

    def _admit_share(self, share: int, keep_key: str = ""):
        """Make room for `share` estimated device-0 bytes or raise
        DeviceBudgetError. Victims pop oldest-first, in kind order
        csr -> vec -> ann (ascending re-ship cost). `keep_key`'s
        outdated copy is dropped first and is never counted against its
        replacement."""
        if self.budget_bytes <= 0:
            return
        if keep_key:
            self._evict_key(keep_key)
        if share > self.budget_bytes:
            self.oom_refusals += 1
            raise DeviceBudgetError(
                f"store needs ~{share >> 20} MiB per device but the "
                f"device budget is {self.budget_bytes >> 20} MiB "
                f"(SURREAL_DEVICE_MEM_BUDGET_MB)"
            )
        while self.mem_used_device0() + share > self.budget_bytes:
            victim = None
            for cache in (self.csr, self.vec, self.ann):
                for key in cache:
                    if key != keep_key:
                        victim = (cache, key)
                        break
                if victim is not None:
                    break
            if victim is None:
                self.oom_refusals += 1
                raise DeviceBudgetError(
                    f"store needs ~{share >> 20} MiB per device; "
                    f"{self.mem_used_device0() >> 20} MiB resident is "
                    f"unevictable (staging) under the "
                    f"{self.budget_bytes >> 20} MiB budget"
                )
            victim[0].pop(victim[1], None)
            self.budget_evictions += 1

    # -- ops ----------------------------------------------------------------

    def handle(self, op: str, meta: dict, bufs: list):
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown device op {op!r}")
        return fn(meta, bufs)

    def op_ping(self, meta, bufs):
        return "ok", {}, []

    def platform(self) -> str:
        return self.device.type

    def device_count(self) -> int:
        """The device list's length (the reference's len(jax.devices()),
        logical devices included)."""
        return len(self.devices)

    def op_status(self, meta, bufs):
        from surrealdb_tpu_torch.device import compile_cache, kernelstats
        from surrealdb_tpu_torch.device import mesh as devmesh

        def _sharded(cache):
            return sum(1 for _t, s in cache.values()
                       if getattr(s, "mesh_ndev", 1) > 1)

        return "ok", {
            "platform": self.platform(),
            "device_count": self.device_count(),
            "mesh": dict(devmesh.describe(len(self.devices)),
                         sharded_vec=_sharded(self.vec),
                         sharded_ann=_sharded(self.ann),
                         sharded_csr=_sharded(self.csr)),
            "mem_used_device0": self.mem_used_device0(),
            "vec_blocks": len(self.vec),
            "csr_blocks": len(self.csr),
            "ann_blocks": len(self.ann),
            "vec_bytes": sum(s.nbytes() for _t, s in self.vec.values()),
            "csr_bytes": sum(s.nbytes() for _t, s in self.csr.values()),
            "ann_bytes": sum(s.nbytes() for _t, s in self.ann.values()),
            "mem_used": self.mem_used(),
            "mem_budget": self.budget_bytes,
            "oom_refusals": self.oom_refusals,
            "budget_evictions": self.budget_evictions,
            "compile_cache": compile_cache.status(),
            "cc": kernelstats.snapshot(),
            "launches": kernelstats.launches(),
        }, []

    def op_launch_counts(self, meta, bufs):
        """Kernel launch counts (and path events, such as int8
        candidate overflows) of this runner; `reset` zeroes them after
        reading."""
        from surrealdb_tpu_torch.device import kernelstats

        out, events = kernelstats.launches(), kernelstats.events()
        if meta.get("reset"):
            kernelstats.reset_launches()
        return "ok", {"launches": out, "events": events}, []

    def _install_vec(self, key, tag, st):
        st.ensure()
        self.vec.pop(key, None)
        self.vec[key] = (list(tag), st)
        while len(self.vec) > MAX_VEC_STORES:
            self.vec.popitem(last=False)
        return "ok", {"rank_mode": st.rank_mode,
                      "mesh_ndev": getattr(st, "mesh_ndev", 1)}, []

    def _vec_store(self, key, vecs, valid, meta, ndev: int):
        """Placed construction: a MeshVecStore over `ndev` devices, else
        the VecStore (which shards itself over a device list of several
        devices, as the reference's does)."""
        if ndev:
            from surrealdb_tpu_torch.device.mesh import MeshVecStore

            return MeshVecStore(key, vecs, valid, meta["metric"],
                                meta.get("mink_p", 3.0), meta["cfg"], ndev,
                                devices=self.devices[:ndev])
        from surrealdb_tpu_torch.device.vecstore import VecStore

        return VecStore(key, vecs, valid, meta["metric"],
                        meta.get("mink_p", 3.0), meta["cfg"], self.device,
                        self.devices)

    def op_vec_load(self, meta, bufs):
        key = meta["key"]
        vecs, valid = bufs
        ndev = self._place_vec(vecs.shape[0], vecs.shape[1],
                               vecs.dtype.itemsize, meta)
        self._admit(
            _vec_estimate(vecs.shape[0], vecs.shape[1],
                          vecs.dtype.itemsize, meta, ndev,
                          len(self.devices)),
            keep_key=key, ndev=max(ndev, 1),
        )
        return self._install_vec(
            key, meta["tag"], self._vec_store(key, vecs, valid, meta, ndev))

    def op_vec_load_begin(self, meta, bufs):
        key = meta["key"]
        n, dim = meta["shape"]
        dtype = np.dtype(meta["dtype"])
        # admit staging + the final device arrays up front, BEFORE the
        # big allocation; the install share stays reserved until
        # load_end so a concurrent ship cannot overcommit. Staging is a
        # host buffer: it occupies the runner whole, the install share
        # is what lands per device.
        ndev = self._place_vec(int(n), int(dim), dtype.itemsize, meta)
        est = _vec_estimate(int(n), int(dim), dtype.itemsize, meta, ndev,
                            len(self.devices))
        share = -(-est // max(ndev, 1))
        self._admit_share(int(n) * int(dim) * dtype.itemsize + int(n)
                          + share, keep_key=key)
        self._reserved.pop(key, None)
        if self.budget_bytes > 0:
            self._reserved[key] = share
        vecs = np.empty((int(n), int(dim)), dtype=dtype)
        (valid,) = bufs
        lmeta = dict(meta)
        lmeta["_mesh_ndev"] = ndev
        self._staging[key] = (lmeta, vecs, valid)
        return "ok", {}, []

    def op_vec_load_part(self, meta, bufs):
        ent = self._staging.get(meta["key"])
        if ent is None:
            return "stale", {}, []
        _m, vecs, _valid = ent
        off = int(meta["off"])
        (chunk,) = bufs
        vecs[off:off + chunk.shape[0]] = chunk
        return "ok", {}, []

    def op_vec_load_end(self, meta, bufs):
        key = meta["key"]
        ent = self._staging.pop(key, None)
        self._reserved.pop(key, None)  # the install replaces it below
        if ent is None:
            return "stale", {}, []
        lmeta, vecs, valid = ent
        return self._install_vec(
            key, meta["tag"], self._vec_store(
                key, vecs, valid, lmeta, int(lmeta.get("_mesh_ndev", 0))))

    def op_vec_drop(self, meta, bufs):
        self.vec.pop(meta["key"], None)
        self._staging.pop(meta["key"], None)
        self._reserved.pop(meta["key"], None)
        return "ok", {}, []

    def op_vec_knn(self, meta, bufs):
        ent = self.vec.get(meta["key"])
        if ent is None or ent[0] != list(meta["tag"]):
            return "stale", {}, []
        self.vec.move_to_end(meta["key"])
        out_meta, out_bufs = ent[1].knn(bufs[0], int(meta["k"]))
        out_meta.setdefault("mesh_ndev", getattr(ent[1], "mesh_ndev", 1))
        return "ok", out_meta, out_bufs

    def _prewarm_shapes(self, cache, meta, field, warm_one):
        """Run one dispatch per listed step against a loaded block ahead
        of traffic. Best-effort by contract: a failed step stops the
        ladder but never fails serving; a dropped/re-tagged block is
        `stale`."""
        ent = cache.get(meta["key"])
        if ent is None or ent[0] != list(meta["tag"]):
            return "stale", {}, []
        warmed = []
        for v in meta.get(field, (1,)):
            v = int(v)
            if v < 1:
                continue
            try:
                warm_one(ent[1], v)
                warmed.append(v)
            except Exception:
                break
        return "ok", {"warmed": warmed}, []

    def op_vec_prewarm(self, meta, bufs):
        k = int(meta.get("k", 10))

        def warm(st, b):
            st.knn(np.zeros((b, st.vecs.shape[1]), np.float32), k)

        return self._prewarm_shapes(self.vec, meta, "buckets", warm)

    # -- quantized graph-ANN blocks (device/annstore.py) --------------------

    def _ann_install(self, key, tag, meta, graph, x8, arow, x2q):
        ndev = self._place_ann(x8.shape[0], x8.shape[1], graph.shape[1])
        if ndev:
            from surrealdb_tpu_torch.device.mesh import MeshAnnStore

            self._admit(MeshAnnStore.estimate_device_bytes(
                x8.shape[0], x8.shape[1], graph.shape[1], ndev),
                keep_key=key, ndev=ndev)
            st = MeshAnnStore(key, graph, x8, arow, x2q, meta["metric"],
                              meta.get("cfg") or {}, ndev,
                              devices=self.devices[:ndev])
        else:
            from surrealdb_tpu_torch.device.annstore import AnnStore

            self._admit(AnnStore.estimate_device_bytes(
                x8.shape[0], x8.shape[1], graph.shape[1]), keep_key=key)
            st = AnnStore(key, graph, x8, arow, x2q, meta["metric"],
                          meta.get("cfg") or {}, self.device)
        st._ensure()
        self.ann.pop(key, None)
        self.ann[key] = (list(tag), st)
        while len(self.ann) > MAX_ANN_STORES:
            self.ann.popitem(last=False)
        return "ok", {"mesh_ndev": getattr(st, "mesh_ndev", 1)}, []

    def op_ann_load(self, meta, bufs):
        graph, x8, arow, x2q = bufs
        return self._ann_install(meta["key"], meta["tag"], meta,
                                 graph, x8, arow, x2q)

    def op_ann_load_begin(self, meta, bufs):
        from surrealdb_tpu_torch.device.annstore import AnnStore

        key = meta["key"]
        arow, x2q = bufs
        n = arow.shape[0]
        # host staging (~est, occupying the runner whole) and the
        # installed arrays (est, or its per-device share once
        # _ann_install places a mesh store) coexist briefly at load_end;
        # the install share stays reserved until then so a concurrent
        # ship cannot overcommit
        ndev = self._place_ann(n, int(meta["dim"]), int(meta["d_out"]))
        est = AnnStore.estimate_device_bytes(
            n, int(meta["dim"]), int(meta["d_out"]))
        share = -(-est // max(ndev, 1))
        self._admit_share(est + share, keep_key=key)
        self._reserved.pop(key, None)
        if self.budget_bytes > 0:
            self._reserved[key] = share
        by_name = {
            "graph": np.empty((n, int(meta["d_out"])), np.int32),
            "x8": np.empty((n, int(meta["dim"])), np.int8),
            "arow": arow,
            "x2q": x2q,
        }
        self._ann_staging[key] = (dict(meta), by_name)
        return "ok", {}, []

    def op_ann_load_part(self, meta, bufs):
        ent = self._ann_staging.get(meta["key"])
        if ent is None:
            return "stale", {}, []
        target = ent[1][meta["buf"]]
        off = int(meta["off"])
        (chunk,) = bufs
        target[off:off + chunk.shape[0]] = chunk
        return "ok", {}, []

    def op_ann_load_end(self, meta, bufs):
        key = meta["key"]
        ent = self._ann_staging.pop(key, None)
        self._reserved.pop(key, None)  # _ann_install re-admits below
        if ent is None:
            return "stale", {}, []
        lmeta, by_name = ent
        return self._ann_install(
            key, meta["tag"], lmeta, by_name["graph"], by_name["x8"],
            by_name["arow"], by_name["x2q"])

    def op_ann_drop(self, meta, bufs):
        self.ann.pop(meta["key"], None)
        self._ann_staging.pop(meta["key"], None)
        self._reserved.pop(meta["key"], None)
        return "ok", {}, []

    def op_ann_search(self, meta, bufs):
        ent = self.ann.get(meta["key"])
        if ent is None or ent[0] != list(meta["tag"]):
            return "stale", {}, []
        self.ann.move_to_end(meta["key"])
        cand = ent[1].search(bufs[0], int(meta["kc"]))
        return "ok", {"mode": "cand",
                      "mesh_ndev": getattr(ent[1], "mesh_ndev", 1)}, [cand]

    def op_ann_prewarm(self, meta, bufs):
        """Query-bucket ladder for an ANN index's descent."""
        kc = int(meta.get("kc", 40))

        def warm(st, b):
            st.search(np.zeros((b, st.x8.shape[1]), np.float32), kc)

        return self._prewarm_shapes(self.ann, meta, "buckets", warm)

    def op_csr_load(self, meta, bufs):
        key = meta["key"]
        rows, cols = bufs
        ndev = self._place_csr(rows.shape[0])
        if ndev:
            from surrealdb_tpu_torch.device.mesh import MeshCsrStore

            self._admit(MeshCsrStore.estimate_device_bytes(
                rows.shape[0], ndev), keep_key=key, ndev=ndev)
            st = MeshCsrStore(key, rows, cols, int(meta["n_nodes"]), ndev,
                              devices=self.devices[:ndev])
        else:
            from surrealdb_tpu_torch.device.csrstore import CsrStore

            self._admit(int(rows.nbytes) + int(cols.nbytes), keep_key=key)
            st = CsrStore(key, rows, cols, int(meta["n_nodes"]),
                          self.device)
        self.csr.pop(key, None)
        self.csr[key] = (list(meta["tag"]), st)
        while len(self.csr) > MAX_CSR_STORES:
            self.csr.popitem(last=False)
        return "ok", {}, []

    def op_csr_drop(self, meta, bufs):
        self.csr.pop(meta["key"], None)
        return "ok", {}, []

    def op_csr_hop(self, meta, bufs):
        ent = self.csr.get(meta["key"])
        if ent is None or ent[0] != list(meta["tag"]):
            return "stale", {}, []
        self.csr.move_to_end(meta["key"])
        mask = ent[1].multi_hop(
            bufs[0], int(meta["hops"]), bool(meta["union"])
        )
        return "ok", {"mesh_ndev": getattr(ent[1], "mesh_ndev", 1)}, [mask]

    def op_csr_prewarm(self, meta, bufs):
        def warm(st, hops):
            start = np.zeros((1, st.n_nodes), np.uint8)
            for union in (False, True):
                st.multi_hop(start, hops, union)

        return self._prewarm_shapes(self.csr, meta, "hops", warm)

    def op_brute_knn(self, meta, bufs):
        """One-shot exact KNN over ephemeral rows (the planner's brute
        path: nothing cached, the rows ship with the call)."""
        from surrealdb_tpu_torch.ops.topk import knn_search

        xs, qs = bufs
        d, i = knn_search(
            to_device(xs, self.device, torch.float32),
            to_device(qs, self.device, torch.float32),
            int(meta["k"]), meta["metric"], float(meta.get("p", 3.0)),
        )
        return "ok", {}, [
            np.ascontiguousarray(d.cpu().numpy(), np.float32),
            np.ascontiguousarray(i.cpu().numpy(), np.int32),
        ]
