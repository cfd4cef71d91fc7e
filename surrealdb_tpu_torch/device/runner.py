"""Torch device runner: the subprocess that owns all torch/CUDA state.

Spawned with one end of a socketpair (device/supervisor.py). torch and
CUDA initialise HERE, never in a serving process, and the CUDA kernels
are built (or loaded from the build cache) before the runner announces
itself, so a CUDA init that hangs or a failed build stalls or kills
this process while the supervisor's init watchdog decides.

Protocol (device/proto.py frames, the reference runner's):
  runner -> supervisor on boot:  ("ready", {platform, device_count,
                                            compile_cache, mesh})
                                 or ("init_error", {error})
  supervisor -> runner:          (op, {seq, ...}, bufs)
  runner -> supervisor:          ("ok"|"stale"|"err", {seq, ...}, bufs)

The loop is single-threaded and crash-only: the serving side rebuilds
every store from its own data after a restart.

`--mesh-devices N` gives the runner a device list of N logical devices
(device/mesh.py): shard s on `cuda:(s % device_count)`, or every shard
on the CPU with `--device cpu`. It is the counterpart of the
reference's forced device count (`--xla_force_host_platform_device_count`),
which widens its mesh on a CPU: several logical devices on one card
check the partition and the merge; speed across cards needs as many
cards. Without it the list is every visible card (one CPU).

    python -m surrealdb_tpu_torch.device.runner --fd N [--device cpu]
        [--mesh-devices N]
"""

from __future__ import annotations

import argparse
import signal
import socket
import traceback


def serve(sock, device: str = "cuda", mesh_devices=None) -> None:
    """Init torch (+ CUDA), announce readiness, serve until EOF or
    shutdown."""
    from surrealdb_tpu_torch.device import proto

    try:
        from surrealdb_tpu_torch.device.handlers import DeviceHost

        host = DeviceHost(device, mesh_devices)
        from surrealdb_tpu_torch.device import compile_cache
        from surrealdb_tpu_torch.device import mesh as devmesh

        ready = {
            "platform": host.platform(),
            "device_count": host.device_count(),
            "compile_cache": compile_cache.status(),
            "mesh": devmesh.describe(host.device_count()),
        }
    except BaseException as e:  # init failed: report, then die
        try:
            proto.send_msg(sock, "init_error",
                           {"error": f"{e.__class__.__name__}: {e}"[:500]})
        except OSError:
            pass
        raise
    from surrealdb_tpu_torch.device import kernelstats
    from surrealdb_tpu_torch.device.handlers import DeviceBudgetError

    proto.send_msg(sock, "ready", ready)
    while True:
        try:
            op, meta, bufs = proto.recv_msg(sock)
        except ConnectionError:
            return  # supervisor went away: die with it
        if op == "shutdown":
            try:
                proto.send_msg(sock, "ok", {"seq": meta.get("seq")})
            except OSError:
                pass
            return
        seq = meta.get("seq")
        try:
            tag, out_meta, out_bufs = host.handle(op, meta, bufs)
            out_meta = dict(out_meta)
            out_meta["seq"] = seq
            # compile counters piggyback on every reply, as the
            # reference runner's do
            out_meta["cc"] = kernelstats.snapshot()
            proto.send_msg(sock, tag, out_meta, out_bufs)
        except ConnectionError:
            return
        except Exception as e:
            reply = {"seq": seq,
                     "error": f"{e.__class__.__name__}: {e}"[:500],
                     "trace": traceback.format_exc(limit=6)[-2000:]}
            if isinstance(e, DeviceBudgetError):
                # typed refusal, not a health event
                reply["oom"] = True
            try:
                proto.send_msg(sock, "err", reply)
            except OSError:
                return


def main(fd: int, device: str = "cuda", mesh_devices=None) -> None:
    # the supervisor owns this process's lifetime; a Ctrl-C aimed at the
    # server must not race the supervisor's orderly shutdown
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):
        pass
    sock = socket.socket(fileno=fd)
    try:
        serve(sock, device, mesh_devices)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m surrealdb_tpu_torch.device.runner",
        description="Torch device runner: serves device frames on an "
                    "inherited socket.")
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socket file descriptor")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="N logical devices in the mesh's device list "
                         "(default: every visible card, or one CPU)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = _parse()
    main(args.fd, args.device, args.mesh_devices)
