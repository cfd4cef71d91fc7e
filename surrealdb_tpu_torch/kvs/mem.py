"""In-memory storage engine (the reference package's `kvs/mem.py`:
`VersionedStore`, `MemTx`, `MemBackend`; reference: core/src/kvs/mem/).

MVCC over a sorted keyspace: every key holds a short version chain
`[(version, value|None), ...]`; a transaction pins the store version at
start (snapshot isolation — repeatable reads, no torn mid-commit state) and
commit validates the writeset against versions committed since the snapshot
(optimistic write-write conflict detection, like the reference backends'
serializable/optimistic transactions). Conflicts raise a retryable error.
Chains are pruned to the oldest active snapshot at commit time.

Savepoints snapshot the overlay (cheap dict copy), giving statement-level
rollback like the reference's api.rs savepoint API.
"""

from __future__ import annotations

import threading
from typing import Optional

try:
    from sortedcontainers import SortedDict, SortedList
except ImportError:  # container lacks the dep — pure-Python fallback
    from surrealdb_tpu_torch.utils.sortedcompat import SortedDict, SortedList

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.kvs.api import Backend, BackendTx

CONFLICT_MSG = (
    "Failed to commit transaction due to a read or write conflict. "
    "This transaction can be retried"
)


class VersionedStore:
    """The shared MVCC keyspace: version chains + active-snapshot registry."""

    def __init__(self):
        # key -> list[(version, value|None)] ascending by version
        self.chains: SortedDict = SortedDict()
        self.version = 0
        self.active: SortedList = SortedList()
        self.lock = threading.RLock()

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> int:
        with self.lock:
            self.active.add(self.version)
            return self.version

    def release(self, snap: int) -> None:
        with self.lock:
            self._release_locked(snap)

    def _release_locked(self, snap: int) -> None:
        try:
            self.active.remove(snap)
        except ValueError:
            pass

    # -- reads -------------------------------------------------------------
    @staticmethod
    def _resolve(chain, snap: int) -> Optional[bytes]:
        """Latest value at version <= snap (None = absent/tombstone)."""
        val = None
        for ver, v in chain:
            if ver > snap:
                break
            val = v
        return val

    def read(self, key: bytes, snap: int) -> Optional[bytes]:
        with self.lock:
            chain = self.chains.get(key)
            if chain is None:
                return None
            return self._resolve(chain, snap)

    def range_keys(self, beg: bytes, end: bytes):
        with self.lock:
            return list(self.chains.irange(beg, end, inclusive=(True, False)))

    def range_items(self, beg: bytes, end: bytes, snap: int, limit=None,
                    reverse=False):
        """Resolve a whole range at `snap` under one lock acquisition."""
        with self.lock:
            keys = self.chains.irange(beg, end, inclusive=(True, False),
                                      reverse=reverse)
            out = []
            for k in keys:
                v = self._resolve(self.chains[k], snap)
                if v is None:
                    continue
                out.append((k, v))
                if limit is not None and len(out) >= limit:
                    break
            return out

    def read_latest(self, key: bytes) -> Optional[bytes]:
        """Newest committed value for one key (no snapshot pin) — serves
        the sharding metadata reads (shard map / commit-log decisions)
        where the caller wants the latest state, not a snapshot."""
        with self.lock:
            chain = self.chains.get(key)
            return None if chain is None else chain[-1][1]

    def latest_items(self):
        """(key, value) pairs of the newest committed state (for snapshots/
        compaction/export). Tombstoned keys are skipped."""
        with self.lock:
            out = []
            for k, chain in self.chains.items():
                v = chain[-1][1]
                if v is not None:
                    out.append((k, v))
            return out

    def seed(self, key: bytes, val: Optional[bytes]) -> None:
        """Load-path write at version 0 (no snapshots exist yet)."""
        if val is None:
            self.chains.pop(key, None)
        else:
            self.chains[key] = [(0, val)]

    # -- commit ------------------------------------------------------------
    def commit(self, writes: dict, snap: int, pre_apply=None,
               release: bool = True) -> int:
        """Validate + apply a writeset. Returns the new version.

        Raises SdbError(CONFLICT_MSG) when any written key was committed by
        another transaction after `snap`. `pre_apply` (e.g. a WAL append)
        runs under the store lock after validation passes, so durability and
        visibility stay atomic. With `release`, the committer's own snapshot
        is dropped inside the SAME lock acquisition — validating first is
        essential: if the snapshot were released before validation, a
        concurrent delete could prune a conflicting chain away entirely and
        the conflict would be missed.
        """
        with self.lock:
            for k in writes:
                chain = self.chains.get(k)
                if chain is not None and chain[-1][0] > snap:
                    if release:
                        self._release_locked(snap)
                    raise SdbError(CONFLICT_MSG)
            if release:
                self._release_locked(snap)
            if pre_apply is not None:
                pre_apply()
            self.version += 1
            ver = self.version
            min_active = self.active[0] if self.active else ver
            for k, v in writes.items():
                chain = self.chains.get(k)
                if chain is None:
                    if v is None:
                        continue  # delete of a never-written key
                    chain = []
                    self.chains[k] = chain
                chain.append((ver, v))
                self._prune(k, chain, min_active)
            return ver

    def _prune(self, key: bytes, chain, min_active: int) -> None:
        """Drop versions no active snapshot can read. Keeps the newest entry
        at or below min_active plus everything after it."""
        keep_from = 0
        for i, (ver, _v) in enumerate(chain):
            if ver <= min_active:
                keep_from = i
            else:
                break
        if keep_from:
            del chain[:keep_from]
        if len(chain) == 1 and chain[0][1] is None:
            # fully-visible tombstone: the key is gone for every reader
            del self.chains[key]


class MemTx(BackendTx):
    def __init__(self, store, write: bool):
        self.store = store
        self.vs: VersionedStore = store.vs
        self.write = write
        self.snap = self.vs.snapshot()
        self.writes: dict[bytes, Optional[bytes]] = {}  # None = tombstone
        self.savepoints: list[dict] = []
        self.done = False

    def _check(self):
        if self.done:
            raise SdbError("transaction is finished")

    def _release(self):
        if self.snap is not None:
            self.vs.release(self.snap)
            self.snap = None

    def __del__(self):
        self._release()

    def get(self, key: bytes) -> Optional[bytes]:
        self._check()
        if key in self.writes:
            return self.writes[key]
        return self.vs.read(key, self.snap)

    def set(self, key: bytes, val: bytes) -> None:
        self._check()
        if not self.write:
            raise SdbError("transaction is read-only")
        self.writes[key] = bytes(val)

    def delete(self, key: bytes) -> None:
        self._check()
        if not self.write:
            raise SdbError("transaction is read-only")
        self.writes[key] = None

    def scan(self, beg, end, limit=None, reverse=False):
        self._check()
        if not self.writes:
            yield from self.vs.range_items(beg, end, self.snap, limit,
                                           reverse)
            return
        # merge the snapshot range with the overlay
        base = dict(self.vs.range_items(beg, end, self.snap))
        for k, v in self.writes.items():
            if beg <= k < end:
                if v is None:
                    base.pop(k, None)
                else:
                    base[k] = v
        keys = sorted(base, reverse=reverse)
        n = 0
        for k in keys:
            yield k, base[k]
            n += 1
            if limit is not None and n >= limit:
                return

    def new_save_point(self):
        self.savepoints.append(dict(self.writes))

    def rollback_to_save_point(self):
        if self.savepoints:
            self.writes = self.savepoints.pop()

    def release_last_save_point(self):
        if self.savepoints:
            self.savepoints.pop()

    def commit(self):
        self._check()
        self.done = True
        snap, self.snap = self.snap, None
        if self.writes:
            # the store releases the snapshot under the same lock as the
            # conflict validation (release-before-validate would let a
            # concurrent delete prune a conflicting chain away)
            self.vs.commit(self.writes, snap)
        else:
            self.vs.release(snap)

    def cancel(self):
        self.done = True
        self.writes.clear()
        self._release()


class MemBackend(Backend):
    def __init__(self):
        self.vs = VersionedStore()
        self.lock = self.vs.lock

    def transaction(self, write: bool) -> MemTx:
        return MemTx(self, write)
