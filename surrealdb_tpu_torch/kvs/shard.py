"""Range-sharded remote KV: shard map, routing client, cross-shard 2PC
(the reference package's `kvs/shard.py`; its shard map encodes byte for
byte as the reference's, so either package's client reads a topology
the other wrote).

The reference architecture runs stateless compute nodes over TiKV — a
RANGE-SHARDED distributed KV. This module gives our storage tier the
same shape: the ordered keyspace is partitioned into contiguous ranges,
each range served by one replication group from kvs/remote.py (primary +
replicas + lease failover, unchanged), and a `ShardedBackend` client
routes every read, scan, and commit by range while implementing the
existing `Backend`/`BackendTx` contract — `Datastore`, the executor,
and the vector/graph caches need zero changes.

Topology
--------
- The **shard map** is a versioned document (epoch + ordered list of
  `[beg, end, addrs, epoch]` ranges) stored on the META shard (group 0)
  under the internal key `\\x00!shardmap`. Clients bootstrap from the
  meta group's addresses (`shard://h:p[,h:p]`), cache the map, and
  refresh it whenever a server answers `kv wrong shard epoch` — the
  refresh happens BEFORE the next attempt and without backoff, so a
  stale map never burns the query's deadline.
- Each group's server enforces its assigned range (kvs/remote.py
  `shard_set`): the fence is what makes a split safe.

Transactions
------------
A `ShardTx` lazily opens one `RemoteTx` per touched shard (each pins its
own snapshot — a documented weakening: there is no global snapshot
across shards; per-shard reads are individually consistent). Writes
buffer client-side in the owning shard's sub-transaction.

- **Single-shard commit** (the common case): exactly today's one-round
  optimistic commit — no 2PC overhead on the fast path.
- **Cross-shard commit**: two-phase. Phase 1 `prepare`s every
  participant (validate + stage + write-lock, durably, replicated);
  the decision is then persisted as a first-writer-wins record in the
  meta shard's commit-log keyspace (`\\x00!txnlog/<txid>`) — THAT write
  is the commit point; phase 2 `decide`s each participant. A
  participant whose coordinator dies resolves through the commit log
  (kvs/remote.py resolver thread), claiming abort when no decision was
  recorded — so a coordinator SIGKILLed between prepare and commit
  recovers to a consistent abort everywhere, and one killed after the
  record recovers to a consistent commit.

Versionstamps
-------------
`SHOW CHANGES` ordering must survive sharding, so a sharded datastore
draws versionstamps from a sequence window leased from the meta shard
(PD-style TSO, node.lease_tso_window): windows are disjoint and the
counter embeds wall-clock millis, so stamps stay globally unique,
totally ordered, and roughly time-correlated.

Splits
------
`split_shard` (CLI: `surreal kv-admin split`) moves the upper half of a
range onto a new group behind an epoch fence: narrow the source's range
(writes beyond the split point start bouncing with `WrongShardEpoch`),
copy the fenced slice, assign the new group, publish the bumped map,
then purge the moved slice from the source. Clients that hit the fence
refresh the map through the existing RetryPolicy machinery.
"""

from __future__ import annotations

import threading
import uuid
from typing import Iterator, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import RetryableKvError, SdbError
from surrealdb_tpu_torch.kvs import net
from surrealdb_tpu_torch.kvs.api import Backend, BackendTx
from surrealdb_tpu_torch.kvs.remote import (
    RemoteBackend,
    RetryPolicy,
    SHARD_MAP_KEY,
    _encode,
    _decode,
    _is_wrong_shard,
    _parse_addr,
    _Pool,
)


# ---------------------------------------------------------------------------
# shard map
# ---------------------------------------------------------------------------


class Shard:
    """One contiguous key range and the replication group serving it."""

    __slots__ = ("beg", "end", "addrs", "epoch")

    def __init__(self, beg: bytes, end: Optional[bytes],
                 addrs: tuple, epoch: int):
        self.beg = bytes(beg)
        self.end = None if end is None else bytes(end)
        self.addrs = tuple(addrs)
        self.epoch = int(epoch)

    def contains(self, key: bytes) -> bool:
        return key >= self.beg and (self.end is None or key < self.end)

    def __repr__(self):
        hi = "inf" if self.end is None else repr(self.end)
        return f"Shard([{self.beg!r},{hi}) @{self.epoch} {self.addrs})"


class ShardMap:
    """Versioned, ordered, gap-free partition of the keyspace."""

    def __init__(self, epoch: int, shards: list):
        shards = sorted(shards, key=lambda s: s.beg)
        if not shards:
            raise SdbError("kv shard map: no shards")
        if shards[0].beg != b"":
            raise SdbError("kv shard map: first range must start at ''")
        if shards[-1].end is not None:
            raise SdbError("kv shard map: last range must be unbounded")
        for a, b in zip(shards, shards[1:]):
            if a.end != b.beg:
                raise SdbError(
                    f"kv shard map: gap/overlap at {a.end!r} vs {b.beg!r}"
                )
        self.epoch = int(epoch)
        self.shards = shards

    def locate(self, key: bytes) -> int:
        for i, s in enumerate(self.shards):
            if s.contains(key):
                return i
        raise SdbError(f"kv shard map: no shard for key {key!r}")

    def covering(self, beg: bytes, end: bytes) -> list[int]:
        """Indices of every shard intersecting [beg, end), in order."""
        out = []
        for i, s in enumerate(self.shards):
            if s.end is not None and s.end <= beg:
                continue
            if s.beg >= end:
                break
            out.append(i)
        return out

    def encode(self) -> bytes:
        return _encode([
            self.epoch,
            [[s.beg, s.end, list(s.addrs), s.epoch] for s in self.shards],
        ])

    @classmethod
    def decode(cls, raw: bytes) -> "ShardMap":
        epoch, entries = _decode(bytes(raw))
        return cls(int(epoch), [
            Shard(bytes(beg), None if end is None else bytes(end),
                  tuple(str(a) for a in addrs), int(sepoch))
            for beg, end, addrs, sepoch in entries
        ])


class _SimulatedCrash(BaseException):
    """Test-only coordinator crash: raised AFTER the requested 2PC
    point with no cleanup whatsoever (no aborts, no decides) — the
    recovery machinery must converge on its own, exactly as after a
    coordinator SIGKILL."""


# ---------------------------------------------------------------------------
# routing client
# ---------------------------------------------------------------------------


class ShardTx(BackendTx):
    """One logical transaction over the sharded keyspace.

    Routes by key through the backend's cached shard map; lazily opens
    one RemoteTx per touched shard. Reads that hit a moved range
    re-route transparently (the sub-transaction had no writes to lose);
    once a shard holds buffered writes, topology churn aborts the
    transaction retryably — the retry runs against the fresh map."""

    def __init__(self, backend: "ShardedBackend", write: bool,
                 max_staleness: Optional[float] = None):
        self.done = False
        self.backend = backend
        self.write = write
        # bounded-staleness follower reads: every per-shard
        # sub-transaction inherits the bound, so a cross-shard scan or
        # a scatter-gather KNN fans out over each GROUP's replicas
        # instead of serializing on each group's primary
        self.max_staleness = None if write else max_staleness
        self._map = backend.shard_map()
        self._subs: dict = {}  # shard index -> RemoteTx
        self._sp_depth = 0
        self._crash_point = None  # test hook: "after_prepare"/"after_mark"

    # -- plumbing -----------------------------------------------------------

    def _check(self):
        if self.done:
            raise SdbError("transaction is finished")

    def _sub(self, i: int):
        tx = self._subs.get(i)
        if tx is None:
            s = self._map.shards[i]
            gb = self.backend.group_backend(s.addrs)
            # the routing epoch rides into the follower-read proof: a
            # replica that has not applied this epoch's fence (and
            # therefore may be missing a split's seeded slice) must
            # reject rather than serve a hole
            tx = gb.transaction(self.write,
                                max_staleness=self.max_staleness,
                                min_shard_epoch=s.epoch)
            # sub-transactions opened mid-statement must carry the same
            # savepoint depth as their siblings, or a statement-level
            # rollback would silently keep their writes
            for _ in range(self._sp_depth):
                tx.new_save_point()
            self._subs[i] = tx
        return tx

    def _any_writes(self) -> bool:
        return any(sub.writes for sub in self._subs.values())

    def prepin(self, key: bytes) -> None:
        """Open (pin) the sub-transaction owning `key` NOW. The scatter
        paths (idx/shardvec.py) pre-pin every involved shard from the
        coordinating thread before fanning reads out to workers —
        lazy `_sub` creation must never race across threads."""
        self._check()
        self._sub(self._map.locate(key))

    def _wrong_shard_read(self, i: int):
        """A read bounced off a moved range: refresh the map and
        re-route. Only safe while NO shard holds writes. Every open
        sub-transaction is dropped — `_subs` is keyed by shard index,
        which the new map renumbers — and reads re-pin lazily (snapshot
        moves forward, the same documented weakening as a read-only
        failover re-pin)."""
        self.backend.note_stale()
        if self._any_writes():
            self._abort_all()
            raise RetryableKvError(
                "kv shard map changed under a write transaction; "
                "transaction aborted and can be retried"
            )
        subs, self._subs = self._subs, {}
        for sub in subs.values():
            try:
                sub.cancel()
            except (SdbError, OSError):
                pass
        self.backend.refresh_map()
        self._map = self.backend.shard_map()

    def _abort_all(self):
        self.done = True
        for sub in self._subs.values():
            try:
                sub.cancel()
            except (SdbError, OSError):
                pass

    # -- reads / writes -----------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        self._check()
        for _attempt in range(3):
            i = self._map.locate(key)
            sub = self._sub(i)
            try:
                return sub.get(key)
            except SdbError as e:
                if not _is_wrong_shard(e):
                    raise
                self._wrong_shard_read(i)
        raise RetryableKvError(
            "kv shard map unstable; transaction aborted and can be "
            "retried"
        )

    def set(self, key: bytes, val: bytes) -> None:
        self._check()
        if not self.write:
            raise SdbError("transaction is read-only")
        self._sub(self._map.locate(key)).set(key, val)

    def delete(self, key: bytes) -> None:
        self._check()
        if not self.write:
            raise SdbError("transaction is read-only")
        self._sub(self._map.locate(key)).delete(key)

    def scan(self, beg, end, limit=None,
             reverse=False) -> Iterator[tuple[bytes, bytes]]:
        """Cross-shard ordered scan: shards are disjoint, contiguous,
        and visited in key order (reversed for reverse scans), so the
        stitched stream is globally ordered with per-shard buffering
        only. A concurrent split aborts the scan retryably — a yielded
        prefix can't be rewound against a new topology."""
        self._check()
        order = self._map.covering(beg, end)
        if reverse:
            order = list(reversed(order))
        remaining = limit
        for i in order:
            s = self._map.shards[i]
            lo = max(beg, s.beg)
            hi = end if s.end is None else min(end, s.end)
            if lo >= hi:
                continue
            sub = self._sub(i)
            try:
                for k, v in sub.scan(lo, hi, remaining, reverse):
                    yield k, v
                    if remaining is not None:
                        remaining -= 1
                        if remaining <= 0:
                            return
            except SdbError as e:
                if not _is_wrong_shard(e):
                    raise
                self.backend.note_stale()
                self.backend.refresh_map()
                raise RetryableKvError(
                    "kv shard scan crossed a topology change; "
                    "transaction aborted and can be retried"
                )

    # -- savepoints ---------------------------------------------------------

    def new_save_point(self):
        self._sp_depth += 1
        for sub in self._subs.values():
            sub.new_save_point()

    def rollback_to_save_point(self):
        if self._sp_depth:
            self._sp_depth -= 1
        for sub in self._subs.values():
            sub.rollback_to_save_point()

    def release_last_save_point(self):
        if self._sp_depth:
            self._sp_depth -= 1
        for sub in self._subs.values():
            sub.release_last_save_point()

    # -- commit / cancel ----------------------------------------------------

    def commit(self):
        self._check()
        self.done = True
        writers = [(i, sub) for i, sub in sorted(self._subs.items())
                   if sub.writes]
        readers = [sub for i, sub in self._subs.items() if not sub.writes]
        for sub in readers:  # release read snapshots first
            try:
                sub.commit()
            except (SdbError, OSError):  # robust: read-snap release only
                pass  # a reader's snapshot release can't fail the txn
        if not writers:
            return
        if len(writers) == 1:
            # fast path: exactly today's one-round optimistic commit
            try:
                writers[0][1].commit()
            except SdbError as e:
                if _is_wrong_shard(e):
                    self.backend.note_stale()
                    self.backend.refresh_map()
                    raise RetryableKvError(
                        f"kv shard moved during commit; transaction "
                        f"aborted and can be retried: {e}"
                    )
                raise
            return
        self._commit_2pc(writers)

    def _commit_2pc(self, writers):
        backend = self.backend
        txid = backend.new_txid()
        meta_addrs = list(backend.meta_addrs)
        prepared: list = []
        try:
            for i, sub in writers:
                sub.prepare_2pc(txid, meta_addrs)
                prepared.append(i)
            if self._crash_point == "after_prepare":
                raise _SimulatedCrash(txid)
        except _SimulatedCrash:
            raise
        except BaseException as e:
            # Claim the ABORT record FIRST: any prepare that staged
            # server-side (including an ambiguous one whose ack was
            # lost) now converges to abort through the resolver even if
            # our decide frames below never arrive.
            try:
                backend.mark_txn(txid, "abort")
            except (SdbError, OSError):
                # participants' resolvers claim abort against the log
                backend.count("kv_2pc_abort_mark_deferred")
            for i in prepared:
                backend.decide(self._map.shards[i].addrs, txid, "abort",
                               best_effort=True)
            # writers the prepare loop never reached still pin a server
            # snapshot + pooled connection — release them now instead of
            # leaving them to GC (cancel is a no-op on the one that
            # raised: prepare_2pc finishes its sub on every path)
            for _i, sub in writers:
                if not sub.done:
                    try:
                        sub.cancel()
                    except (SdbError, OSError):  # robust: local release
                        pass
            backend.count("kv_2pc_aborts")
            if isinstance(e, SdbError) and _is_wrong_shard(e):
                backend.note_stale()
                backend.refresh_map()
                raise RetryableKvError(
                    f"kv shard moved during prepare; transaction "
                    f"aborted and can be retried: {e}"
                )
            raise
        # decision point: the commit-log record IS the commit
        try:
            decision = backend.mark_txn(txid, "commit")
        except BaseException as e:
            raise RetryableKvError(
                f"kv 2pc decision not recorded; OUTCOME UNKNOWN — "
                f"participants resolve through the commit log; retry "
                f"only with idempotent writes: {e}"
            )
        if decision != "commit":
            # a participant's resolver beat us to an abort claim (our
            # prepares outlived the orphan grace): consistent abort
            for i, _sub in writers:
                backend.decide(self._map.shards[i].addrs, txid, "abort",
                               best_effort=True)
            backend.count("kv_2pc_aborts")
            raise RetryableKvError(
                "kv 2pc transaction aborted by recovery (prepare "
                "outlived the orphan grace); transaction can be retried"
            )
        if self._crash_point == "after_mark":
            raise _SimulatedCrash(txid)
        # phase 2: deliver the decision; a shard we cannot reach right
        # now applies it later via its resolver against the commit log
        for i, _sub in writers:
            backend.decide(self._map.shards[i].addrs, txid, "commit",
                           best_effort=True)
        backend.count("kv_2pc_commits")

    def cancel(self):
        if self.done:
            return
        self._abort_all()

    def __del__(self):
        if not self.done:
            try:
                self.cancel()
            except Exception:
                pass


class ShardedBackend(Backend):
    """Routing client over a range-sharded KV cluster.

    `addr` names the META group (`h:p[,h:p]` — shard 0's replica set);
    the shard map is read from there and per-group `RemoteBackend`
    clients (pool + retry + failover, unchanged) are built lazily as
    shards are touched."""

    def __init__(self, addr: str, secret: Optional[str] = None,
                 telemetry=None, policy: Optional[RetryPolicy] = None,
                 op_timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None,
                 transport: Optional[net.Transport] = None,
                 txid_factory=None):
        import os as _os

        if secret is None:
            secret = _os.environ.get("SURREAL_KV_SECRET") or None
        self.secret = secret
        self.telemetry = telemetry
        self.policy = policy or RetryPolicy()
        self.op_timeout = op_timeout
        self.connect_timeout = connect_timeout
        self.transport = transport
        # injectable for a deterministic simulator (uuid4 would make
        # two runs of the same seed diverge); None = real uuid4 hex
        self.txid_factory = txid_factory
        self.lock = threading.RLock()
        self._groups: dict = {}  # tuple(addrs) -> RemoteBackend
        self._map: Optional[ShardMap] = None
        self._stale = True
        # per-client record of every shard-map epoch adopted, in order —
        # a simulator's epoch-monotonicity invariant reads this
        self.epoch_history: list[int] = []
        self.meta = RemoteBackend(addr, secret=secret, telemetry=telemetry,
                                  policy=policy, op_timeout=op_timeout,
                                  connect_timeout=connect_timeout,
                                  transport=transport)
        self.meta_addrs = tuple(
            f"{h}:{p}" for h, p in self.meta.pool.addrs
        )
        self.refresh_map()
        if telemetry is not None:
            telemetry.register_gauge(
                "kv_shards",
                lambda: 0 if self._map is None else len(self._map.shards),
            )
            telemetry.register_gauge(
                "kv_shard_map_epoch",
                lambda: -1 if self._map is None else self._map.epoch,
            )

    # -- telemetry ----------------------------------------------------------

    def count(self, name: str):
        if self.telemetry is not None:
            self.telemetry.inc(name)

    # -- shard map ----------------------------------------------------------

    def note_stale(self):
        with self.lock:
            self._stale = True

    def shard_map(self) -> ShardMap:
        if self._stale:
            self.refresh_map()
        m = self._map
        if m is None:
            raise SdbError(
                "kv shard map not initialised; run `surreal kv-admin init`"
            )
        return m

    def refresh_map(self) -> ShardMap:
        raw = self.meta.pool.call(["get_latest", SHARD_MAP_KEY],
                                  policy=self.policy)
        if raw is None:
            raise SdbError(
                "kv shard map not initialised; run `surreal kv-admin init`"
            )
        m = ShardMap.decode(raw)
        with self.lock:
            if self._map is None or m.epoch >= self._map.epoch:
                self._map = m
            self._stale = False
            m = self._map
            if len(self.epoch_history) < 65536:
                self.epoch_history.append(m.epoch)
        self.count("kv_shard_map_refreshes")
        return m

    def new_txid(self) -> str:
        if self.txid_factory is not None:
            return self.txid_factory()
        return uuid.uuid4().hex

    def topology(self):
        """Shard topology for INFO FOR SYSTEM / the /kv/topology route.

        Served from the LAST-KNOWN map even when it is marked stale:
        this is the diagnostic you read when the cluster is sick, so it
        must not block for a retry deadline against an unreachable meta
        shard. The `epoch` field tells the operator how fresh it is."""
        m = self._map
        if m is None:
            m = self.shard_map()

        def _k(b):
            return None if b is None else b.decode("utf-8",
                                                   "backslashreplace")

        ranges = []
        for s in m.shards:
            gb = self._groups.get(s.addrs)
            primary = (gb.pool.addrs[gb.pool.primary_i]
                       if gb is not None else None)
            ranges.append({
                "begin": _k(s.beg),
                "end": _k(s.end),
                "epoch": s.epoch,
                "primary": (f"{primary[0]}:{primary[1]}"
                            if primary else s.addrs[0]),
                "addrs": list(s.addrs),
            })
        return {"epoch": m.epoch, "shards": ranges}

    # -- group clients ------------------------------------------------------

    def group_backend(self, addrs: tuple) -> RemoteBackend:
        addrs = tuple(addrs)
        with self.lock:
            gb = self._groups.get(addrs)
        if gb is not None:
            return gb
        if set(addrs) == set(self.meta_addrs):
            gb = self.meta  # shard 0 usually IS the meta group
        else:
            try:
                gb = RemoteBackend(
                    ",".join(addrs), secret=self.secret,
                    telemetry=self.telemetry, policy=self.policy,
                    op_timeout=self.op_timeout,
                    connect_timeout=self.connect_timeout,
                    transport=self.transport,
                )
            except RetryableKvError as e:
                raise RetryableKvError(
                    f"kv shard unavailable ({','.join(addrs)}): {e}"
                )
        with self.lock:
            cur = self._groups.setdefault(addrs, gb)
        if cur is not gb and gb is not self.meta:
            gb.close()
        return cur

    # -- 2PC coordinator plumbing -------------------------------------------

    def mark_txn(self, txid: str, want: str) -> str:
        """Record (or learn) the decision for `txid` in the meta shard's
        commit log; first writer wins."""
        return self.meta.pool.call(["txn_mark", txid, want],
                                   policy=self.policy)

    def decide(self, addrs: tuple, txid: str, decision: str,
               best_effort: bool = False):
        """Deliver a decision to one participant group (follows that
        group's failovers through its pool). With `best_effort`, a
        delivery failure is swallowed BUT counted — the participant's
        resolver finishes the job against the commit log."""
        try:
            return self.group_backend(addrs).pool.call(
                ["decide", txid, decision], policy=self.policy
            )
        except (SdbError, OSError):
            if not best_effort:
                raise
            self.count("kv_2pc_decide_deferred")
            return None

    # -- TSO ----------------------------------------------------------------

    def tso_window(self, n: int) -> tuple[int, int]:
        """Lease a window of `n` versionstamps from the meta shard
        (PD-style TSO). See node.lease_tso_window."""
        from surrealdb_tpu_torch.node import lease_tso_window

        return lease_tso_window(
            lambda: self.meta.transaction(True), n
        )

    # -- Backend contract ---------------------------------------------------

    supports_staleness = True

    def transaction(self, write: bool,
                    max_staleness: Optional[float] = None) -> ShardTx:
        return ShardTx(self, write, max_staleness=max_staleness)

    def replication_info(self) -> dict:
        """Per-group follower-read serving state (INFO FOR SYSTEM
        `replication` section): the meta group's plus every touched
        group's observation cache, keyed by the group's range label.
        Cache-only — no network I/O (same discipline as topology())."""
        groups = {"meta": self.meta.replication_info()}
        m = self._map
        with self.lock:
            touched = dict(self._groups)
        if m is not None:
            for s in m.shards:
                gb = touched.get(s.addrs)
                if gb is None or gb is self.meta:
                    continue
                hi = "inf" if s.end is None else repr(s.end)
                groups[f"[{s.beg!r},{hi})"] = gb.replication_info()
        return groups

    def replication_lag_s(self) -> float:
        with self.lock:
            gbs = list(self._groups.values())
        lags = [gb.replication_lag_s() for gb in {id(g): g
                for g in gbs + [self.meta]}.values()]
        lags = [g for g in lags if g >= 0.0]
        return max(lags) if lags else -1.0

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.unregister_gauge("kv_shards")
            self.telemetry.unregister_gauge("kv_shard_map_epoch")
        with self.lock:
            groups, self._groups = dict(self._groups), {}
        for gb in groups.values():
            if gb is not self.meta:
                gb.close()
        self.meta.close()


# ---------------------------------------------------------------------------
# admin: bootstrap / split / topology (CLI `surreal kv-admin`)
# ---------------------------------------------------------------------------


def _group_pool(addrs, secret=None, transport=None,
                policy: Optional[RetryPolicy] = None) -> _Pool:
    import os as _os

    if secret is None:
        secret = _os.environ.get("SURREAL_KV_SECRET") or None
    return _Pool([_parse_addr(a) for a in addrs], secret=secret,
                 transport=transport, policy=policy)


def _write_map(meta_addrs, m: ShardMap, secret=None, transport=None,
               policy: Optional[RetryPolicy] = None):
    be = RemoteBackend(",".join(meta_addrs), secret=secret,
                       transport=transport, policy=policy)
    try:
        tx = be.transaction(True)
        tx.set(SHARD_MAP_KEY, m.encode())
        tx.commit()
    finally:
        be.close()


def read_topology(meta_addr: str, secret: Optional[str] = None,
                  transport=None,
                  policy: Optional[RetryPolicy] = None) -> ShardMap:
    addrs = [a.strip() for a in meta_addr.split(",") if a.strip()]
    pool = _group_pool(addrs, secret, transport=transport, policy=policy)
    try:
        raw = pool.call(["get_latest", SHARD_MAP_KEY])
    finally:
        pool.close()
    if raw is None:
        raise SdbError(
            "kv shard map not initialised; run `surreal kv-admin init`"
        )
    return ShardMap.decode(raw)


def init_topology(groups: list, split_keys: list,
                  secret: Optional[str] = None, transport=None,
                  policy: Optional[RetryPolicy] = None) -> ShardMap:
    """Bootstrap a sharded cluster: fence every group to its range and
    publish the initial map on the meta group (group 0).

    `groups` is a list of address lists (each one replication group, in
    shard order); `split_keys` the N-1 range boundaries."""
    if len(groups) != len(split_keys) + 1:
        raise SdbError(
            f"kv-admin init: {len(groups)} groups need "
            f"{len(groups) - 1} split keys, got {len(split_keys)}"
        )
    if list(split_keys) != sorted(set(split_keys)):
        raise SdbError("kv-admin init: split keys must be strictly "
                       "ascending")
    bounds = [b""] + [bytes(k) for k in split_keys] + [None]
    epoch = 1
    shards = []
    for i, g in enumerate(groups):
        pool = _group_pool(g, secret, transport=transport, policy=policy)
        try:
            pool.call(["shard_set", bounds[i], bounds[i + 1], epoch])
        finally:
            pool.close()
        shards.append(Shard(bounds[i], bounds[i + 1], tuple(g), epoch))
    m = ShardMap(epoch, shards)
    _write_map(groups[0], m, secret, transport=transport, policy=policy)
    return m


def split_shard(meta_addr: str, key: bytes, new_group: list,
                secret: Optional[str] = None, transport=None,
                policy: Optional[RetryPolicy] = None) -> ShardMap:
    """Split the range containing `key` at `key`: the upper half moves
    to `new_group` (a running, empty replication group) behind an epoch
    fence. Safe to re-run after a partial failure — every step is
    idempotent up to the map publish, and the source purge only runs
    after the new map is durable."""
    meta_addrs = [a.strip() for a in meta_addr.split(",") if a.strip()]
    m = read_topology(meta_addr, secret, transport=transport,
                      policy=policy)
    i = m.locate(key)
    src = m.shards[i]
    if key <= src.beg or (src.end is not None and key >= src.end):
        raise SdbError(
            f"kv-admin split: {key!r} is not strictly inside "
            f"[{src.beg!r}, {src.end!r})"
        )
    new_epoch = m.epoch + 1
    src_pool = _group_pool(src.addrs, secret, transport=transport,
                           policy=policy)
    dst_pool = _group_pool(new_group, secret, transport=transport,
                           policy=policy)
    try:
        # 1. fence: the source stops serving [key, end) immediately
        src_pool.call(["shard_set", src.beg, key, new_epoch])
        # 2. copy the fenced slice (no writes can touch it anymore),
        # PAGED: the server caps each page by count and bytes, so a
        # slice of any size moves without ever building one giant frame
        cursor = bytes(key)
        while True:
            items = src_pool.call(["shard_items", cursor, src.end, 2048])
            if not items:
                break
            for j in range(0, len(items), 512):
                dst_pool.call(["seed", items[j:j + 512]])
            cursor = bytes(items[-1][0]) + b"\x00"
        # 3. assign the new group its range
        dst_pool.call(["shard_set", key, src.end, new_epoch])
        # 4. publish the new map — from here clients route correctly
        shards = list(m.shards)
        shards[i] = Shard(src.beg, key, src.addrs, new_epoch)
        shards.insert(i + 1, Shard(key, src.end, tuple(new_group),
                                   new_epoch))
        out = ShardMap(new_epoch, shards)
        _write_map(meta_addrs, out, secret, transport=transport,
                   policy=policy)
        # 5. GC the moved slice on the source (safe: map is durable)
        src_pool.call(["shard_purge", key, src.end])
        return out
    finally:
        src_pool.close()
        dst_pool.close()
