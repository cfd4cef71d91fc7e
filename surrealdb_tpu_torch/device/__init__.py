"""The torch device runner and its supervisor.

- `runner.py`: the runner subprocess; owns torch/CUDA state behind the
  framed socket protocol of `proto.py`.
- `handlers.py`: `DeviceHost`, the op table (vector, graph-ANN and CSR
  stores, brute KNN, status), usable in-process as well.
- `supervisor.py`: `DeviceSupervisor`, the serving side's health-checked
  dispatch: an init watchdog, pipelined calls (a send and a receive
  thread, replies matched by `seq`), per-dispatch deadlines capped by
  the query's remaining budget (`bind_serving`), wedge detection,
  kill-and-restart, and a circuit breaker that degrades to the host
  paths and re-promotes after a streak of healthy probes. Modes
  `off`/`auto`/`require`/`inline`; a process-wide singleton
  (`get_supervisor`/`set_supervisor`/`reset_supervisor`).
- `batcher.py`: `DeviceBatcher`, the cross-query batcher (concurrent
  riders coalesce into one dispatch) and its `BATCH_STATS`.

Crash-only: the runner holds nothing the serving process can't rebuild,
so recovery is "kill it and re-ship". Importing this package imports no
torch and never initialises CUDA: only the runner (or an inline host)
does.
"""

from __future__ import annotations

from surrealdb_tpu_torch.device.supervisor import (
    DeviceOpError,
    DeviceOutOfMemory,
    DeviceRequired,
    DeviceSupervisor,
    DeviceUnavailable,
    QueryCancelled,
    QueryTimeout,
    attach_telemetry,
    bind_serving,
    get_supervisor,
    reset_supervisor,
    set_supervisor,
)

__all__ = [
    "DeviceOpError",
    "DeviceOutOfMemory",
    "DeviceRequired",
    "DeviceSupervisor",
    "DeviceUnavailable",
    "QueryCancelled",
    "QueryTimeout",
    "attach_telemetry",
    "bind_serving",
    "get_supervisor",
    "reset_supervisor",
    "set_supervisor",
]
