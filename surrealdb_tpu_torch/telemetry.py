"""Per-stage query timing (the reference package's `telemetry.py`
`stage_record`): a process-wide table of stage name -> count, total,
max and last nanoseconds. The vector engine records `index_knn` (the
wall time of a `knn` call: cache sync, batcher wait, kernel); a serving
stack binds `stage_record` into the supervisor (`bind_serving`) for its
`device_rpc` stage."""

from __future__ import annotations


class StageStat:
    """One stage's accumulated timing (lock-free: under the GIL a lost
    update during a race skews a metric by one sample)."""

    __slots__ = ("count", "total_ns", "max_ns", "last_ns")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.max_ns = 0
        self.last_ns = 0

    def add(self, ns: int):
        self.count += 1
        self.total_ns += ns
        self.last_ns = ns
        if ns > self.max_ns:
            self.max_ns = ns


_STAGES: dict[str, StageStat] = {}


def stage_record(name: str, ns: int):
    """Record `ns` nanoseconds spent in query stage `name`."""
    st = _STAGES.get(name)
    if st is None:
        st = _STAGES.setdefault(name, StageStat())
    st.add(ns)
