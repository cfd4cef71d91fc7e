"""Node-wide memory accounting for derived state (the reference
package's `resource.py`, trimmed to what the index engines register
with): `Account`, `MemoryAccountant` (with INFO FOR SYSTEM's
`snapshot`), `register`, `checkpoint`, `throttle`, `get_accountant` /
`set_accountant`, `admit_ok` (the server's admission gate),
`attach_telemetry` (the `/metrics` gauges) and `BudgetedLRU`, the
full-text result cache's container. The port keeps its own process-wide
accountant.

Every byte of derived state an engine holds (a vector index's host rows
and per-epoch rank stats, its CAGRA build) is a cache over KV truth and
registers a tracked, evictable `Account`. A node budget
(`SURREAL_MEM_BUDGET_MB`, default `SURREAL_MEM_BUDGET_FRAC` = 0.5 of the
cgroup or host limit) splits into a soft watermark
(`SURREAL_MEM_SOFT_FRAC`, 0.8) and a hard one: past soft, checkpoints
evict in `EVICT_ORDER` (coldest first within a kind), which degrades an
engine to rebuild-on-touch; past hard, `throttle` evicts at the chunk
boundaries of a rebuild or an ANN build. LRU order rides a monotone
counter, never a clock.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

from surrealdb_tpu_torch import cnf

# Eviction priority, first kind evicted first, ordered by rebuild cost
# (the reference's order, over the kinds the port registers): per-epoch
# rank stats are a trivial recompute, a full-text result re-runs its
# posting walk, ANN graphs rebuild in the background while brute force
# serves, vector host arrays rebuild from a KV range scan on the next
# sync. The live fan-out's backlog and session outboxes (`push`) come
# last: their "eviction" is the typed slow-consumer overflow policy.
EVICT_ORDER = ("rank_stats", "ft", "ann", "vec", "push")


def host_limit_bytes() -> int:
    """The memory ceiling this process actually runs under: the cgroup
    limit when one is set (containers), else physical MemTotal."""
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw and raw != "max":
                v = int(raw)
                # some v1 kernels report "no limit" as a huge sentinel
                if 0 < v < (1 << 60):
                    return v
        except (OSError, ValueError):
            continue
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 8 << 30  # conservative fallback when nothing is readable


class Account:
    """One holder's tracked, evictable slice of derived state.

    `size_fn` is polled (cheap arithmetic over arrays the holder
    already has) — holders never have to thread incremental +=/-=
    bookkeeping through every mutation path. `evict` drops the state
    (degrade to rebuild-on-touch) and is only ever called from a
    checkpoint site that holds none of the owner's locks."""

    __slots__ = ("kind", "label", "_size_fn", "_evict_fn", "_owner_ref",
                 "last_touch", "closed", "evictions", "__weakref__")

    def __init__(self, kind: str, label: str, size_fn, evict=None,
                 owner=None):
        self.kind = kind
        self.label = label
        self._size_fn = _weak_callable(size_fn)
        self._evict_fn = _weak_callable(evict) if evict is not None \
            else None
        self._owner_ref = (weakref.ref(owner) if owner is not None
                           else None)
        self.last_touch = 0
        self.closed = False
        self.evictions = 0

    def alive(self) -> bool:
        if self.closed:
            return False
        return self._owner_ref is None or self._owner_ref() is not None

    def bytes(self) -> int:
        fn = self._size_fn()
        if fn is None:
            return 0
        try:
            return int(fn())
        except Exception:
            return 0  # a dying owner must not poison accounting

    def touch(self):
        self.last_touch = _ACCT_TICK.tick()

    def evict(self) -> bool:
        """Run the holder's evict callback. Returns True when the
        callback ran (freed bytes show up in the next size_fn poll)."""
        fn = self._evict_fn() if self._evict_fn is not None else None
        if fn is None:
            return False
        try:
            fn()
        except Exception:
            return False
        self.evictions += 1
        return True

    def close(self):
        """The holder is gone (a retired segment): the accountant drops
        the account at its next poll."""
        self.closed = True



def _weak_callable(fn):
    """Wrap a callable so the account never keeps its owner alive: a
    bound method is held through WeakMethod, anything else strongly.
    Returns a zero-arg resolver yielding the callable or None."""
    try:
        wm = weakref.WeakMethod(fn)
        return wm
    except TypeError:
        return lambda: fn


class _Tick:
    """Monotone counter for LRU ordering (deliberately not a clock)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def tick(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


_ACCT_TICK = _Tick()


class MemoryAccountant:
    """Process-wide registry of evictable derived-state accounts with a
    soft/hard watermark budget. All public entries are thread-safe;
    eviction callbacks run OUTSIDE the accountant lock (they take the
    owner's own locks)."""

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            mb = cnf.env_int("SURREAL_MEM_BUDGET_MB", 0)
            if mb > 0:
                budget_bytes = mb << 20
            else:
                frac = cnf.env_float("SURREAL_MEM_BUDGET_FRAC", 0.5)
                budget_bytes = int(host_limit_bytes() * max(frac, 0.01))
        self._lock = threading.Lock()
        self._accounts: dict[int, Account] = {}
        self._next_id = 0
        self._evicting = threading.local()
        # hot-path poll gate: far below the soft watermark, checkpoints
        # and admissions reuse the last full poll for up to POLL_STRIDE
        # calls instead of re-invoking every account's size_fn per
        # query. Anywhere NEAR pressure (last poll over half of soft)
        # every call polls fresh. register()/set_budget() force the
        # next gated call to poll.
        self._poll_counter = 0
        self._last_usage = 1 << 62
        self.counters = {"mem_evictions": 0, "mem_evicted_bytes": 0,
                         "mem_shed": 0, "mem_throttles": 0}
        for kind in EVICT_ORDER:
            self.counters[f"mem_evictions_{kind}"] = 0
        self.set_budget(budget_bytes)

    # -- budget -------------------------------------------------------------
    def set_budget(self, budget_bytes: int):
        """(Re)set the node budget; soft = SOFT_FRAC of it, hard = all
        of it."""
        budget_bytes = max(int(budget_bytes), 1)
        soft_frac = cnf.env_float("SURREAL_MEM_SOFT_FRAC", 0.8)
        soft_frac = min(max(soft_frac, 0.05), 1.0)
        with self._lock:
            self.budget_bytes = budget_bytes
            self.hard_bytes = budget_bytes
            self.soft_bytes = int(budget_bytes * soft_frac)
        self._last_usage = 1 << 62  # force a fresh poll post-clamp

    # -- registration -------------------------------------------------------
    def register(self, kind: str, label: str, size_fn,
                 evict=None, owner=None) -> Account:
        """Register one derived-state holder. `size_fn() -> bytes` is
        polled at checkpoints; `evict()` drops the state (rebuild-on-
        touch). With `owner`, the account dies with it (weakref) — a
        discarded engine can never pin itself through the accountant."""
        acct = Account(kind, label, size_fn, evict=evict, owner=owner)
        acct.last_touch = _ACCT_TICK.tick()
        with self._lock:
            self._next_id += 1
            self._accounts[self._next_id] = acct
        self._last_usage = 1 << 62  # new account: next gated call polls
        return acct

    def _live_accounts(self) -> list[Account]:
        with self._lock:
            dead = [i for i, a in self._accounts.items()
                    if not a.alive()]
            for i in dead:
                del self._accounts[i]
            return list(self._accounts.values())

    # how many gated calls may reuse the last poll while usage is far
    # below the soft watermark (admission/checkpoint hot paths)
    POLL_STRIDE = 16

    # -- usage --------------------------------------------------------------
    def usage(self) -> int:
        """Accounted bytes across every live account (fresh poll)."""
        total = sum(a.bytes() for a in self._live_accounts())
        self._last_usage = total
        return total

    def _usage_gated(self) -> int:
        """Hot-path usage: a fresh poll whenever the last poll was
        anywhere near pressure (over half the soft watermark) or the
        stride expired; otherwise the cached total. Lost increments on
        the racing counter cost at most one extra/skipped poll."""
        self._poll_counter += 1
        if (self._last_usage * 2 > self.soft_bytes
                or self._poll_counter % self.POLL_STRIDE == 0):
            return self.usage()
        return self._last_usage

    def snapshot(self) -> dict:
        """Accounting breakdown for INFO FOR SYSTEM / bench JSON."""
        by_kind: dict[str, int] = {}
        total = 0
        for a in self._live_accounts():
            b = a.bytes()
            total += b
            by_kind[a.kind] = by_kind.get(a.kind, 0) + b
        return {
            "accounted_bytes": total,
            "budget_bytes": self.budget_bytes,
            "soft_bytes": self.soft_bytes,
            "hard_bytes": self.hard_bytes,
            "by_kind": {k: v for k, v in sorted(by_kind.items())},
            "counters": dict(self.counters),
        }

    # -- eviction -----------------------------------------------------------
    def maybe_evict(self, target: Optional[int] = None) -> int:
        """Priority-ordered eviction down to `target` (default: the
        soft watermark). Within a kind, coldest account first (monotone
        touch order), largest first on ties. Returns bytes freed."""
        if getattr(self._evicting, "busy", False):
            return 0  # re-entrant checkpoint from inside an eviction
        target = self.soft_bytes if target is None else target
        usage = self.usage()
        if usage <= target:
            return 0
        self._evicting.busy = True
        try:
            freed = 0
            order = {k: i for i, k in enumerate(EVICT_ORDER)}
            accounts = [a for a in self._live_accounts()
                        if a._evict_fn is not None]
            accounts.sort(key=lambda a: (
                order.get(a.kind, len(order)), a.last_touch, -a.bytes()
            ))
            for a in accounts:
                if usage <= target:
                    break
                before = a.bytes()
                if before <= 0:
                    continue
                if not a.evict():
                    continue
                after = a.bytes()
                got = max(before - after, 0)
                freed += got
                usage -= got
                self.counters["mem_evictions"] += 1
                self.counters["mem_evicted_bytes"] += got
                key = f"mem_evictions_{a.kind}"
                if key in self.counters:
                    self.counters[key] += 1
            return freed
        finally:
            self._evicting.busy = False

    # -- pressure entries ----------------------------------------------------
    def checkpoint(self, fresh: bool = False) -> None:
        """Cheap pressure check for safe call sites (no holder locks
        held): past the soft watermark, run one eviction pass. Gated —
        far below pressure this reuses the last poll (POLL_STRIDE).
        Call sites that just GREW state by a step (an ANN install, a
        rebuild) pass `fresh=True`: a single jump can cross both
        watermarks at once, which the near-pressure heuristic cannot
        anticipate from a stale low poll."""
        u = self.usage() if fresh else self._usage_gated()
        if u > self.soft_bytes:
            self.maybe_evict()

    def admit_ok(self) -> bool:
        """Admission-layer gate: True when a new query may start. Over
        the hard watermark an eviction pass runs first; only a node
        that STAYS over hard sheds (typed 503 in server/admission.py)."""
        if self._usage_gated() <= self.hard_bytes:
            return True
        self.maybe_evict()
        if self.usage() <= self.hard_bytes:
            return True
        self.counters["mem_shed"] += 1
        return False

    def throttle(self, stage: str = "") -> None:
        """Chunk-boundary pause point for allocation-heavy background
        work (ANN builds, index rebuild scans): past hard, evict; if
        the node stays over hard and `SURREAL_MEM_PAUSE_S` > 0, wait
        (bounded) for pressure to abate before allocating more (default
        0: the eviction pass is the pause)."""
        if self.usage() <= self.hard_bytes:
            return
        self.counters["mem_throttles"] += 1
        self.maybe_evict()
        pause_s = cnf.env_float("SURREAL_MEM_PAUSE_S", 0.0)
        if pause_s <= 0:
            return
        end = time.monotonic() + pause_s
        while self.usage() > self.hard_bytes \
                and time.monotonic() < end:
            time.sleep(min(0.02, pause_s))


class BudgetedLRU:
    """Entry-count + byte-capped LRU mapping (the FtResult cache's
    container, reusable for any keyed derived-state cache). Costs are
    caller-estimated at put() (cheap arithmetic, not sys.getsizeof
    traversals); eviction pops least-recently-used entries and counts
    them. Thread-safe."""

    def __init__(self, max_entries: int, max_bytes: int):
        self.max_entries = max(int(max_entries), 1)
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()  # key -> (value, cost)
        self.nbytes = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                self.misses += 1
                return default
            self._d.move_to_end(key)
            self.hits += 1
            return ent[0]

    def put(self, key, value, cost: int = 0):
        cost = max(int(cost), 0)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self.nbytes -= old[1]
            self._d[key] = (value, cost)
            self.nbytes += cost
            while self._d and (len(self._d) > self.max_entries
                               or self.nbytes > self.max_bytes):
                if len(self._d) == 1 and len(self._d) <= \
                        self.max_entries:
                    break  # one oversized entry may live alone
                _k, (_v, c) = self._d.popitem(last=False)
                self.nbytes -= c
                self.evictions += 1

    def shrink(self, frac: float = 0.5) -> int:
        """Accountant evict callback: drop the coldest `frac` of the
        entries. Returns bytes freed."""
        with self._lock:
            drop = max(int(len(self._d) * frac), 1) if self._d else 0
            freed = 0
            for _ in range(drop):
                if not self._d:
                    break
                _k, (_v, c) = self._d.popitem(last=False)
                freed += c
                self.nbytes -= c
                self.evictions += 1
            return freed

    def clear(self):
        with self._lock:
            self._d.clear()
            self.nbytes = 0

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        with self._lock:
            return key in self._d


# -- process-wide singleton ---------------------------------------------------
# Memory is a process-wide resource: every Datastore/engine in the
# process shares ONE accountant (the device supervisor's discipline).
# Tests swap instances.

_ACCT: Optional[MemoryAccountant] = None
_ACCT_LOCK = threading.Lock()


def get_accountant() -> MemoryAccountant:
    global _ACCT
    with _ACCT_LOCK:
        if _ACCT is None:
            _ACCT = MemoryAccountant()
        return _ACCT


def set_accountant(acct: Optional[MemoryAccountant]):
    """Install an accountant instance; returns the previous one (tests
    restore it)."""
    global _ACCT
    with _ACCT_LOCK:
        old, _ACCT = _ACCT, acct
        return old


def register(kind: str, label: str, size_fn, evict=None,
             owner=None) -> Account:
    """Module-level convenience: register with the current accountant.
    The returned Account stays valid across set_accountant swaps only
    for bookkeeping the holder does itself (touch); tests that swap
    accountants re-create their holders."""
    return get_accountant().register(kind, label, size_fn, evict=evict,
                                     owner=owner)


def checkpoint(fresh: bool = False):
    get_accountant().checkpoint(fresh=fresh)


def throttle(stage: str = ""):
    get_accountant().throttle(stage)


def attach_telemetry(telemetry):
    """Register the accountant's gauges/counters on a datastore's
    telemetry hub. Closures read the CURRENT singleton so a swapped
    accountant keeps reporting."""
    telemetry.register_gauge(
        "mem_accounted_bytes", lambda: get_accountant().usage()
    )
    telemetry.register_gauge(
        "mem_budget_bytes", lambda: get_accountant().budget_bytes
    )
    telemetry.register_gauge(
        "mem_soft_bytes", lambda: get_accountant().soft_bytes
    )
    for name in ("mem_evictions", "mem_evicted_bytes", "mem_shed",
                 "mem_throttles"):
        telemetry.register_counter(
            name, lambda n=name: get_accountant().counters.get(n, 0)
        )
    for kind in EVICT_ORDER:
        telemetry.register_counter(
            f"mem_evictions_{kind}",
            lambda k=kind: get_accountant().counters.get(
                f"mem_evictions_{k}", 0
            ),
        )
