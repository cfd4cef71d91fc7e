"""Memory tracking + query kill-switch (the reference package's
`mem.py`; reference core/src/mem/mod.rs:
a tracking allocator reports process memory; queries abort with
QueryBeyondMemoryThreshold once SURREAL_MEMORY_THRESHOLD is exceeded).

Python has no global allocator hook worth paying for, so the tracker
samples the process RSS from /proc/self/statm (falling back to
resource.getrusage peak where /proc is absent), cached for a few
milliseconds so per-row checks stay cheap. Per-subsystem reporters mirror
mem/registry.rs for INFO FOR SYSTEM / telemetry.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SdbError

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_CACHE_S = 0.005
_last = [0.0, 0]  # (stamp, rss_bytes)

MEMORY_THRESHOLD_MSG = (
    "The query was not executed due to the memory threshold being reached"
)


def current_rss() -> int:
    now = time.monotonic()
    if now - _last[0] < _CACHE_S:
        return _last[1]
    rss = 0
    try:
        with open("/proc/self/statm", "rb") as f:
            rss = int(f.read().split()[1]) * _PAGE
    except OSError:
        try:
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            rss = 0
    _last[0] = now
    _last[1] = rss
    return rss


def check_threshold() -> None:
    """Raise when the process is over SURREAL_MEMORY_THRESHOLD (0 = off;
    user-set values floor at 1 MiB like the reference)."""
    thr = cnf.MEMORY_THRESHOLD
    if thr <= 0:
        return
    thr = max(thr, 1 << 20)
    if current_rss() > thr:
        raise SdbError(MEMORY_THRESHOLD_MSG)


# -- per-subsystem reporters (reference mem/registry.rs) ---------------------

_reporters: dict[str, Callable[[], int]] = {}


def register_reporter(name: str, fn: Callable[[], int]) -> None:
    _reporters[name] = fn


def report() -> dict:
    out = {"process_rss_bytes": current_rss()}
    for name, fn in _reporters.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = -1
    return out
