"""Where a store's `vec_knn` frame time goes: torch.profiler traces of
the knn1m rows on one device and on four logical devices, and of the
knn10m int8 store.

Five stores of the same rows (1M x 768 cosine f32, seed 13, the
generator of chip_smoke.py's knn1m phase), each on a DeviceHost of its
own in this process, then on a runner over its socket:

- knn1m       one device, default cfg (the bf16 rank store);
- mesh_knn1m  four devices, SURREAL_DEVICE_MESH=auto (the self-sharded
              store, `sharded_rank_rescore`);
- mesh_exact  four devices, SURREAL_DEVICE_MESH=force, default cfg (a
              MeshVecStore of exact f32 shards: `distance_tile` +
              `select_topk_rows` a shard, the merge);
- int8        one device, cfg hbm_budget 512 MiB (the int8 rank store);
- mesh_int8   four devices, SURREAL_DEVICE_MESH=force, the same cfg
              (a MeshVecStore, int8 "cand");

and, in process only, knn10m: an int8 VecStore of 10M x 768 random int8
rows made on the card from a seed (knn10m's shape; the kernels' work
does not depend on the rows' origin, and 30 GB of host rows would not
fit a runner's ship here).

For each store and batch size: the wall time of FRAMES frames one by
one (in process and through the runner), and a profiled run of TRACED
frames: per frame the device busy time (the union of the kernel, copy
and set intervals), the idle share (1 - busy / wall) and the idle before
the frame's first and after its last device event, the kernels' time by
name, and the CUDA runtime calls the host made (launches, allocations,
copies, syncs).

    python3 trace_mesh.py [--frames 20] [--traced 5] [--batch 512]
                          [--stores knn1m,int8,...] [--sample-per-kc N]

`--batch` takes a comma list of frame sizes; `--stores` a comma list of
the names above (default: all six). `--sample-per-kc N` sets the int8
stores' shape rule (ops/topk.py INT8_SAMPLE_PER_KC: the one-pass path
needs a threshold sample of at least N kc rows; a large N sends every
query to the chunked path) in this process, so it skips the runners.

Prints one JSON line per store and batch size and, before the last
line, the card's name and power limit; the full report goes to
chiprun_out/mesh_trace.json and the mesh_int8 trace at the largest
batch to chiprun_out/mesh_int8.trace.json. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N, DIM, SEED, K = 1_000_000, 768, 13, 10
N10M = 10_000_000
NDEV = 4
INT8_BUDGET = 512 << 20
OUT = "chiprun_out"

STORES = (
    # name, logical devices, SURREAL_DEVICE_MESH, int8 cfg
    ("knn1m", 1, "auto", False),
    ("mesh_knn1m", NDEV, "auto", False),
    ("mesh_exact", NDEV, "force", False),
    ("int8", 1, "auto", True),
    ("mesh_int8", NDEV, "force", True),
    ("knn10m", 1, "auto", True),
)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def spread(xs) -> dict:
    return {"min": min(xs), "median": statistics.median(xs),
            "max": max(xs), "mean": statistics.fmean(xs)}


def union_us(intervals, lo, hi) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def profile_frames(frame, traced: int, export=None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(traced):
            with record_function(f"frame{i}"):
                frame()
            torch.cuda.synchronize()
    if export:
        prof.export_chrome_trace(export)
    evs = list(prof.events())
    frames = sorted((e.time_range.start, e.time_range.end) for e in evs
                    if e.name.startswith("frame")
                    and e.device_type == DeviceType.CPU)
    # kernels, copies and sets (not the frames' own GPU-side marks)
    dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA
               and not e.name.startswith("frame")]
    ivs = sorted((e.time_range.start, e.time_range.end) for e in dev_evs)
    walls = [(b - a) / 1e3 for a, b in frames]
    busy = [union_us(ivs, a, b) / 1e3 for a, b in frames]
    # idle before the frame's first device event and after its last
    head, tail = [], []
    for a, b in frames:
        inside = [iv for iv in ivs if a <= iv[0] < b]
        if inside:
            head.append((inside[0][0] - a) / 1e3)
            tail.append((b - max(e for _s, e in inside)) / 1e3)
    kernels: dict = {}
    for e in dev_evs:
        name = e.name if len(e.name) <= 60 else e.name[:57] + "..."
        c = kernels.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e.time_range.end - e.time_range.start) / 1e3
    calls: dict = {}  # CUDA runtime calls, by name without "_v<n>"
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
            c = calls.setdefault(e.name.split("_v")[0], [0, 0.0])
            c[0] += 1
            c[1] += (e.time_range.end - e.time_range.start) / 1e3
    nf = max(len(frames), 1)
    return {
        "device_events": len(dev_evs),
        "wall_ms": walls,
        "device_busy_ms": busy if dev_evs else None,
        "idle_share": ([1 - b / w for b, w in zip(busy, walls)]
                       if dev_evs else None),
        "head_idle_ms": head,
        "tail_idle_ms": tail,
        "kernels_per_frame": {
            n: {"count": c / nf, "ms": t / nf}
            for n, (c, t) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][1])},
        "runtime_calls_per_frame": {
            n: {"count": c / nf, "ms": t / nf}
            for n, (c, t) in sorted(calls.items())},
    }


def knn10m_store(device):
    """The knn10m-shaped int8 VecStore: 10M x 768 random int8 rows and
    row scales made on the card from a seed, every row valid."""
    import torch
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.device.vecstore import VecStore

    gen = torch.Generator(device=device).manual_seed(SEED)
    # the store reads only the host rows' shape here
    no_rows = np.broadcast_to(np.zeros(1, np.float32), (N10M, DIM))
    st = VecStore("knn10m", no_rows, np.ones(N10M, np.uint8), "cosine",
                  3.0, dict(cnf.device_cfg(), hbm_budget=1), device)
    st.device_rank = torch.randint(-127, 128, (N10M, DIM), dtype=torch.int8,
                                   device=device, generator=gen)
    st.device_arow = (torch.rand(N10M, device=device, generator=gen) / 127
                      + 1e-4)
    st.device_x2 = torch.zeros(N10M, device=device)
    st.device_valid = torch.ones(N10M, dtype=torch.bool, device=device)
    st.rank_mode = "int8"
    return st


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_mesh: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--traced", type=int, default=5)
    ap.add_argument("--batch", default="512")
    ap.add_argument("--stores", default=",".join(s[0] for s in STORES))
    ap.add_argument("--sample-per-kc", type=int, default=None)
    args = ap.parse_args()
    batches = [int(b) for b in args.batch.split(",")]
    names = args.stores.split(",")
    unknown = set(names) - {s[0] for s in STORES}
    if unknown:
        ap.error(f"unknown stores {sorted(unknown)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.device import compile_cache, kernelstats
    from surrealdb_tpu_torch.device.handlers import DeviceHost
    from surrealdb_tpu_torch.device.supervisor import DeviceSupervisor
    from surrealdb_tpu_torch.ops import topk

    if args.sample_per_kc is not None:
        topk.INT8_SAMPLE_PER_KC = args.sample_per_kc
    os.makedirs(OUT, exist_ok=True)
    card = card_line()
    compile_cache.ensure_built()
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((N, DIM), dtype=np.float32)
    qs = rng.standard_normal((max(batches), DIM), dtype=np.float32)
    valid = np.ones(N, np.uint8)
    saved = os.environ.get("SURREAL_DEVICE_MESH")
    report = {"card": card, "rows": N, "dim": DIM, "batches": batches,
              "k": K, "sample_per_kc": topk.INT8_SAMPLE_PER_KC,
              "stores": {}}
    try:
        for name, ndev, mode, int8 in STORES:
            if name not in names:
                continue
            os.environ["SURREAL_DEVICE_MESH"] = mode
            cfg = cnf.device_cfg()
            if int8:
                cfg = dict(cfg, hbm_budget=INT8_BUDGET)
            key = f"vec/trace/{name}"
            meta = {"key": key, "tag": [1, 0], "k": K}
            outs = {b: {"logical_devices": ndev, "mode": mode}
                    for b in batches}

            if name == "knn10m":
                store = knn10m_store(torch.device("cuda", 0))
                host = None

                def frame(b):
                    return store.knn(qs[:b], K)
            else:
                host = DeviceHost("cuda", mesh_devices=ndev)
                t, lmeta, _ = host.handle("vec_load", {
                    "key": key, "tag": [1, 0], "metric": "cosine",
                    "mink_p": 3.0, "cfg": cfg}, [xs, valid])
                assert t == "ok", (t, lmeta)

                def frame(b):
                    _t, reply, _b = host.handle("vec_knn", dict(meta),
                                                [qs[:b]])
                    return reply, _b
            for b in batches:
                out = outs[b]
                for _ in range(2):  # warm: build the store, first launches
                    reply, _ = frame(b)
                out["reply"] = {k_: reply.get(k_) for k_ in (
                    "mode", "rank_mode", "mesh_ndev")}
                walls = []
                kernelstats.reset_launches()
                for _ in range(args.frames):
                    t0 = time.perf_counter()
                    frame(b)
                    walls.append((time.perf_counter() - t0) * 1e3)
                out["launches_per_frame"] = {
                    k_: v / args.frames
                    for k_, v in kernelstats.launches().items() if v}
                out["overflow_rows"] = kernelstats.events()[
                    "int8_overflow_rows"]
                out["in_process_ms"] = walls
                out["in_process"] = spread(walls)
                out["trace"] = profile_frames(
                    lambda: frame(b), args.traced,
                    os.path.join(OUT, f"{name}.trace.json")
                    if name == "mesh_int8" and b == max(batches) else None)
            if host is not None:
                host.handle("vec_drop", {"key": key}, [])
            del host, frame
            if name == "knn10m":
                del store
            torch.cuda.empty_cache()

            if name != "knn10m" and args.sample_per_kc is None:
                runner = DeviceSupervisor(device="cuda", mesh_devices=ndev)
                runner.start()
                try:
                    runner.ensure_loaded(key, [1, 0], lambda: (
                        "vec_load", {"metric": "cosine", "mink_p": 3.0,
                                     "cfg": cfg}, [xs, valid]))
                    for b in batches:
                        for _ in range(2):
                            runner.call("vec_knn", meta, [qs[:b]])
                        walls = []
                        for _ in range(args.frames):
                            t0 = time.perf_counter()
                            t, _m, _b = runner.call("vec_knn", meta,
                                                    [qs[:b]])
                            walls.append((time.perf_counter() - t0) * 1e3)
                            assert t == "ok", _m
                        outs[b]["runner_ms"] = walls
                        outs[b]["runner"] = spread(walls)
                finally:
                    runner.shutdown()
            for b in batches:
                out = outs[b]
                tr = out["trace"]
                busy = tr["device_busy_ms"]
                print(json.dumps({
                    "store": name, "batch": b, "reply": out["reply"],
                    "in_process_ms": out["in_process"],
                    "runner_ms": out.get("runner"),
                    "traced_wall_ms": spread(tr["wall_ms"]),
                    "device_busy_ms": spread(busy) if busy else None,
                    "idle_share": (spread(tr["idle_share"]) if busy
                                   else None),
                    "head_idle_ms": (spread(tr["head_idle_ms"]) if busy
                                     else None),
                    "tail_idle_ms": (spread(tr["tail_idle_ms"]) if busy
                                     else None),
                    "device_events": tr["device_events"],
                    "top_kernels": dict(list(
                        tr["kernels_per_frame"].items())[:6]),
                    "runtime_calls": tr["runtime_calls_per_frame"],
                    "launches_per_frame": out["launches_per_frame"],
                    "overflow_rows": out["overflow_rows"],
                }), flush=True)
            report["stores"][name] = {str(b): o for b, o in outs.items()}
    finally:
        if saved is None:
            os.environ.pop("SURREAL_DEVICE_MESH", None)
        else:
            os.environ["SURREAL_DEVICE_MESH"] = saved
    with open(os.path.join(OUT, "mesh_trace.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
