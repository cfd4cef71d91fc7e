"""Network KV engine (the reference package's `kvs/remote.py`; its
frames, WAL and snapshots are byte for byte the reference's, so either
package's client talks to either package's server and either package
opens the other's data directory): the distributed-storage role of the
reference's TiKV backend (core/src/kvs/tikv/mod.rs:32-103) — stateless database
nodes over a shared transactional KV service.

One `surreal kv` PRIMARY process owns the MVCC keyspace (the same
VersionedStore the in-process engine uses: snapshot isolation +
optimistic write-write validation). Database nodes connect with
`Datastore("remote://host:port[,host:port...]")`; a transaction pins a
server snapshot, buffers writes locally (client-side overlay, like the
reference's optimistic txns), and ships the whole writeset at commit for
validation under the server's store lock. Wire format: 4-byte
length-prefixed CBOR frames (wire.py) — no pickle on the wire protocol
itself.

Replication & failover (reference role: TiKV's Raft log shipping +
lease-based leadership): the primary ships every
committed writeset — synchronously, before the client sees the ok — to
each ATTACHED replica as a sequenced `repl_apply` frame over the same
protocol; replicas apply in order (duplicates are dropped by sequence
number, gaps force a full resync) and serve as warm standbys. Primary
liveness is a lease row (node.py KV_PRIMARY_LEASE) renewed through the
replicated keyspace itself, so replicas observe it like any other row.
When replication traffic stops past the failover timeout, a replica
checks the (replicated) lease, surveys its peers, defers to any
lower-ranked live replica, and otherwise promotes itself via the
single-winner lease acquire — then starts replicating to the remaining
peers. Clients rediscover the promoted primary automatically via
`status` probes inside a deadline-aware retry policy (bounded
exponential backoff + jitter, connect/reset retried, logical errors
surfaced immediately).

Durability contract: a write acknowledged to a client is (a) in the
primary's WAL and (b) applied on every replica that was attached at
commit time. Killing the primary therefore loses no acknowledged write
as long as one attached replica survives to be promoted.

Follower reads (closed-timestamp bounded staleness): replicas may serve
READ-ONLY transactions that carry an explicit `max_staleness` bound.
The primary stamps a monotone CLOSED TIMESTAMP (its wall clock at ship
time, under wal_lock — every commit it has ever acked is in a frame at
or below that stamp) into every `repl_apply`/`repl_sync` frame and into
the `repl_ping` heartbeat, so a replica's closed timestamp keeps
advancing on the heartbeat cadence even when writes pause, and its lag
is bounded by one ping interval on a healthy link. A replica serves a
follower read iff it can PROVE the requested timestamp is closed:
`closed_ts >= max(wall - max_staleness, session floor)` and its durable
era (`\x00!replstate`) is at least the session's observed era — a
partitioned, era-stale, or lagging replica fails the proof with the
typed retryable "kv follower too stale" error (never silent stale
data), and the client pool falls back to another replica and then the
primary. Session monotonicity: every follower pin returns the serving
node's (closed_ts, era); the pool folds them into a high-water floor
that all later follower pins must meet, so one session's reads never
travel backwards in time. Exact reads (no staleness bound — the
default) never touch any of this and stay primary-served.

Security model: the KV service is a CLUSTER-INTERNAL endpoint (the
reference's TiKV gRPC port is the same); optional shared-secret auth
(SURREAL_KV_SECRET / KvServer(secret=...)) rejects unauthenticated
peers — replication links authenticate with the same secret — and the
value codec's pickle fallback is import-restricted (kvs/api.py) so
stored bytes can't smuggle arbitrary code objects.

Sharding (kvs/shard.py rides this module): a KvServer can be fenced to
one key range of a range-sharded keyspace (`shard_set`, persisted and
replicated as an internal \x00!shardcfg row). Ops on keys outside the
assigned range answer "kv wrong shard epoch" so a stale client refreshes
its shard map. Cross-shard transactions use the 2PC participant ops
(`prepare`/`decide`): a prepare stages the writeset as ONE ordinary MVCC
commit of a \x00!prep/<txid> record — WAL durability and synchronous
replica ship come for free — and write-locks the staged keys until the
decision. The coordinator's decision lives in a first-writer-wins
commit-log row on the meta shard (`txn_mark`); a participant whose
coordinator went quiet resolves through that record, claiming abort when
none exists.

Connection model: each transaction pins ONE pooled connection for its
lifetime, so the server's per-connection snapshot accounting is exact —
a dying client's pins are released on disconnect, and releases can never
land on a different connection than the snap that created them. Across
a failover, read-only transactions transparently re-pin a snapshot on
the new primary; write transactions abort with a RetryableKvError.
"""

from __future__ import annotations

import os
import queue
import random
import re
import socket
import socketserver
import struct
import sys
import threading
import zlib
from collections import Counter
from typing import Callable, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import RetryableKvError, SdbError
from surrealdb_tpu_torch.kvs import net
from surrealdb_tpu_torch.kvs.api import Backend, BackendTx
from surrealdb_tpu_torch.kvs.mem import CONFLICT_MSG, VersionedStore
from surrealdb_tpu_torch.kvs.net import (
    MAX_FRAME,  # noqa: F401 — re-export; net.recv_frame enforces it
    STOP,
    _Conn,
    parse_addr as _parse_addr,
    recv_frame as _recv_frame,
    send_frame as _send_frame,
)

_HDR = struct.Struct(">I")

# on-disk durability format (WAL + snapshot): files open with an 8-byte
# magic, then frames of `u32 body_len | u32 crc32(body) | body`. A crc
# mismatch is treated exactly like a torn tail — replay stops there,
# the file truncates to the last good frame, and wal_crc_errors counts
# it — so disk corruption is never silently applied. Files without the
# magic are legacy (pre-CRC) logs: read without verification once, then
# compacted to the checksummed format.
_LOG_MAGIC = b"SKVCRC01"

# -- sharding metadata keyspace (kvs/shard.py rides these) ------------------
# Internal keys live under the \x00 prefix: every user-visible key this
# package generates starts with "/" (key/__init__.py), so the internal
# namespace sorts before all data, never collides, and is exempt from
# shard-range enforcement (a prepare record must live on its participant
# shard regardless of that shard's assigned range).
SHARD_CFG_KEY = b"\x00!shardcfg"  # this server's (beg, end, epoch)
SHARD_MAP_KEY = b"\x00!shardmap"  # cluster shard map (meta shard only)
PREP_PREFIX = b"\x00!prep/"  # staged 2PC writesets, one per txid
TXNLOG_PREFIX = b"\x00!txnlog/"  # coordinator decisions (meta shard)
# durable freshness credential: [lineage_node_id, seq, era], stamped by
# the primary into every replicated writeset. `era` increments at every
# promotion/boot-as-primary, `seq` is the replication sequence — so
# (era, seq) totally orders replicas by how much acked history they
# hold, and the order SURVIVES restarts (the row recovers from the
# WAL). Elections use it to never promote a stale replica over a
# fresher live one — the in-memory applied_seq resets on reboot and
# must not be trusted for that.
REPL_STATE_KEY = b"\x00!replstate"
INF_END = b"\xff" * 9  # "end of keyspace" sentinel (matches compaction)


def _repl_rank(raw) -> tuple[int, int]:
    """(era, seq) promotion rank from a replstate row (decoded list or
    raw bytes); (-1, -1) when absent/corrupt."""
    try:
        if raw is None:
            return (-1, -1)
        if isinstance(raw, (bytes, bytearray, memoryview)):
            raw = _decode(bytes(raw))
        _lineage, seq, era = raw
        return (int(era), int(seq))
    except Exception:
        return (-1, -1)


def _encode(msg) -> bytes:
    from surrealdb_tpu_torch import wire

    return wire.encode(msg)


def _decode(b: bytes):
    from surrealdb_tpu_torch import wire

    return wire.decode(b)


def _frame_crc(body: bytes) -> bytes:
    """One checksummed log frame: u32 len | u32 crc32(body) | body."""
    return _HDR.pack(len(body)) + _HDR.pack(
        zlib.crc32(body) & 0xFFFFFFFF
    ) + body


# ---------------------------------------------------------------------------
# retry policy (client side)
# ---------------------------------------------------------------------------


def is_retryable(e: BaseException) -> bool:
    """Transport-level errors are retryable; logical errors (conflicts,
    auth, type errors) must surface immediately — resending a commit the
    server REJECTED can never succeed, and resending one it ACCEPTED
    would double-apply."""
    if isinstance(e, RetryableKvError):
        return True
    if isinstance(e, SdbError):
        m = str(e)
        # "wrong shard epoch" / "shard unavailable" are topology errors:
        # retryable, and the router marks its shard map stale the moment
        # one arrives — reads refresh + re-route inline, an aborted
        # write transaction's retry starts against the refreshed map
        # "not replicated": the primary refused to ack because no
        # replica was attached to receive the write — retryable, and the
        # retry rides the same rediscovery path as a failover
        # "follower too stale": the replica refused to serve a
        # bounded-staleness read it could not prove closed — retryable,
        # and the pool's fallback ladder (other replica -> primary)
        # normally absorbs it before it ever reaches this classifier
        return ("kv not primary" in m or "kv connection lost" in m
                or "kv service unreachable" in m
                or "kv wrong shard epoch" in m
                or "kv shard unavailable" in m
                or "kv follower too stale" in m
                or "not replicated" in m)
    if isinstance(e, (ConnectionError, socket.timeout, TimeoutError)):
        return True
    if isinstance(e, OSError):
        return True
    return False


class RetryPolicy:
    """Deadline-aware bounded exponential backoff with jitter.

    Delay for attempt i is `base * 2^i` capped at `max`, scaled by a
    uniform jitter factor in [1 - jitter, 1]; the final sleep is trimmed
    so the total time under `run()` never exceeds `deadline_s` by more
    than one attempt's duration. Clock/sleep/rng are injectable for
    deterministic tests (and the simulator); the defaults read the
    ambient seam clock (kvs/net.py)."""

    def __init__(self, deadline_s: Optional[float] = None,
                 base_ms: Optional[float] = None,
                 max_ms: Optional[float] = None,
                 jitter: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 rng: Callable[[], float] = random.random):
        self.deadline_s = (cnf.KV_RETRY_DEADLINE_S if deadline_s is None
                           else deadline_s)
        self.base_ms = cnf.KV_RETRY_BASE_MS if base_ms is None else base_ms
        self.max_ms = cnf.KV_RETRY_MAX_MS if max_ms is None else max_ms
        j = cnf.KV_RETRY_JITTER if jitter is None else jitter
        self.jitter = min(max(j, 0.0), 1.0)
        self.clock = net.mono if clock is None else clock
        self.sleep = net.sleep_s if sleep is None else sleep
        self.rng = rng

    def backoff_bounds(self, attempt: int) -> tuple[float, float]:
        """(min, max) sleep in seconds for a given attempt index."""
        d = min(self.max_ms, self.base_ms * (2 ** min(attempt, 32))) / 1000.0
        return d * (1.0 - self.jitter), d

    def backoff(self, attempt: int) -> float:
        lo, hi = self.backoff_bounds(attempt)
        return lo + (hi - lo) * self.rng()

    def effective_deadline_s(self) -> float:
        """The policy deadline capped by the calling QUERY's remaining
        budget (inflight thread-local): KV retries must never outlive
        the query that issued them — a nearly-expired query fails fast
        instead of burning its last millisecond on backoff sleeps."""
        from surrealdb_tpu_torch.inflight import remaining as _q_remaining

        q = _q_remaining()
        if q is None:
            return self.deadline_s
        return min(self.deadline_s, max(q, 0.0))

    def run(self, fn, telemetry=None, on_retry=None):
        """Call `fn` until it succeeds, a non-retryable error surfaces,
        or the deadline expires (raises RetryableKvError chaining the
        last transport error). The effective deadline is
        min(policy deadline, calling query's remaining budget), and a
        cancelled query stops retrying immediately.

        `on_retry(e, attempt)` runs before each retry; returning True
        skips the backoff sleep for that attempt. It exists for callers
        whose retried operation can be FIXED between attempts (e.g.
        refreshing a stale shard map on "wrong shard epoch") — such
        errors are topology, not congestion, so the corrected attempt
        should go out immediately instead of burning the caller's
        deadline inside an exponential backoff. (The shard router's
        in-transaction paths refresh inline instead: a consumed
        snapshot can't be retried at this level.)

        Happy-path fast path: a first attempt that succeeds against a
        healthy link pays NONE of the retry machinery — no clock read,
        no deadline math, no inflight-budget lookup. The full policy
        engages only once the first attempt fails retryably (the retry
        deadline then counts from the first failure, which only ever
        GRANTS a sliver more budget than counting from entry)."""
        try:
            return fn()
        except BaseException as e:
            if not is_retryable(e):
                raise
            first_exc = e
        from surrealdb_tpu_torch.inflight import cancelled as _q_cancelled

        deadline_s = self.effective_deadline_s()
        start = self.clock()
        attempt = 0
        exc: BaseException = first_exc
        while True:
            # `exc` holds the latest retryable failure (attempt index
            # `attempt`): check budget, back off, try again
            elapsed = self.clock() - start
            remaining = deadline_s - elapsed
            if remaining <= 0 or _q_cancelled():
                if telemetry is not None:
                    telemetry.inc("kv_deadline_exhausted")
                raise RetryableKvError(
                    f"kv operation failed after {attempt + 1} attempts "
                    f"over {elapsed:.2f}s (deadline {deadline_s}s): "
                    f"{exc}"
                ) from exc
            if telemetry is not None:
                telemetry.inc("kv_retries")
            skip_backoff = False
            if on_retry is not None:
                try:
                    skip_backoff = bool(on_retry(exc, attempt))
                except BaseException:
                    pass  # a failed refresh falls back to backoff
            if not skip_backoff:
                self.sleep(min(self.backoff(attempt), remaining))
            attempt += 1
            try:
                return fn()
            except BaseException as e:
                if not is_retryable(e):
                    raise
                exc = e


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _ConnState:
    """Per-connection protocol state, transport-independent: the real
    socket handler and the simulator's in-process connection both carry
    one of these through `KvEngine.handle_frame`."""

    __slots__ = ("owned", "authed", "fsnaps")

    def __init__(self, authed: bool):
        # snapshots held by THIS connection, as a multiset: several txns
        # pooled onto one connection can legitimately pin the same version
        self.owned: Counter = Counter()
        self.authed = authed
        # snapshots pinned through the follower-read proof
        # (snap_follower): the ONLY snaps a replica will serve
        # get/range against — an exact-read snap never lands here
        self.fsnaps: set = set()


class _KvHandler(socketserver.BaseRequestHandler):
    """Thin socket loop: framing + connection bookkeeping. All protocol
    logic lives in KvEngine so the simulator shares it verbatim."""

    def handle(self):
        srv: KvServer = self.server
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with srv.conn_lock:
            srv.active_conns.add(self.request)
        cstate = srv.new_conn_state()
        try:
            while True:
                try:
                    req = _decode(_recv_frame(self.request))
                except ConnectionError:
                    break
                resp, close = srv.handle_frame(req, cstate)
                _send_frame(self.request, _encode(resp))
                if close:
                    break
        finally:
            with srv.conn_lock:
                srv.active_conns.discard(self.request)
            srv.conn_closed(cstate)


class _EngineDispatch:
    """Protocol dispatch half of the engine (split out only to keep the
    class bodies reviewable; KvEngine inherits it)."""

    def new_conn_state(self) -> _ConnState:
        return _ConnState(not self.secret)

    def conn_closed(self, cstate: _ConnState) -> None:
        # a dying client must not pin MVCC chains forever
        for snap, cnt in cstate.owned.items():
            for _ in range(cnt):
                self.vs.release(snap)

    def handle_frame(self, req, cstate: _ConnState):
        """One request frame -> (response, close_connection)."""
        if not cstate.authed:
            if (isinstance(req, list) and len(req) == 2
                    and req[0] == "auth"
                    and req[1] == self.secret):
                cstate.authed = True
                return ["ok", None], False
            return ["err", "kv auth required"], True
        try:
            resp = self._dispatch(self.vs, req, cstate)
        except SdbError as e:
            resp = ["err", str(e)]
        except Exception as e:  # internal — surface, keep serving
            resp = ["err", f"kv internal error: {e}"]
        return resp, False

    # ops every client read path goes through: they must be served by
    # the PRIMARY. A replica answering them would hand a freshly
    # connected client stale snapshots forever — the pool only
    # rediscovers on failure, and the deterministic simulator caught
    # exactly that as acked writes "missing" from a final scan served
    # by a demoted stale replica. (`rel` stays open: releasing a pin
    # taken while this node WAS primary must work after a demotion.)
    # The ONE sanctioned exception is a follower read: get/range
    # against a snapshot that was pinned through the closed-timestamp
    # proof (`snap_follower`) — see _follower_read_allowed, which
    # fails closed.
    _PRIMARY_READS = ("get", "get_latest", "range", "snap", "shard_items")

    def _follower_read_allowed(self, op, req, cstate) -> bool:
        """True when a non-primary node may serve this read: only
        `get`/`range`, and only against a snapshot this connection
        pinned through the follower-read proof (cstate.fsnaps). A bare
        `snap`, `get_latest`, or `shard_items` is NEVER follower-served
        — each would leave a client on stale snapshots forever."""
        if op == "get":
            return req[2] in cstate.fsnaps
        if op == "range":
            return req[3] in cstate.fsnaps
        return False

    def _dispatch(self, vs, req, cstate):
        srv = self
        owned = cstate.owned
        op = req[0]
        if op in srv._PRIMARY_READS and srv.role != "primary" \
                and not srv._follower_read_allowed(op, req, cstate):
            raise SdbError(srv.not_primary_msg())
        if op == "get":
            srv.shard_check_keys((req[1],))
            return ["ok", vs.read(req[1], req[2])]
        if op == "get_latest":
            # latest committed value, no snapshot pin: shard-map and
            # commit-log reads want current metadata, not a snapshot
            return ["ok", vs.read_latest(req[1])]
        if op == "range":
            _op, beg, end, snap, limit, reverse = req
            srv.shard_check_range(beg, end)
            if beg[:1] != b"\x00":
                # internal \x00-prefixed metadata (shard cfg, staged
                # prepares, commit log, TSO) is invisible to data scans:
                # an unsharded store has no such rows, and a sharded one
                # must scan byte-identically to it. The whole reserved
                # namespace sorts first, so clamping beg excludes it
                # exactly (limits stay precise in both directions).
                beg = max(beg, b"\x01")
                end = max(end, beg)
            items = vs.range_items(beg, end, snap, limit, bool(reverse))
            return ["ok", [[k, v] for k, v in items]]
        if op == "snap":
            snap = vs.snapshot()
            owned[snap] += 1
            return ["ok", snap]
        if op == "snap_follower":
            # bounded-staleness read pin: prove the requested timestamp
            # is closed under this node's era, then pin. Proof + pin
            # run under wal_lock so a resync/era bump cannot slide in
            # between and hand back a floor older than the pinned state.
            _op, req_ts, min_closed, min_era = req[:4]
            min_epoch = int(req[4]) if len(req) > 4 else 0
            with srv.wal_lock:
                closed, era = srv.follower_read_proof(
                    req_ts, min_closed, min_era, min_epoch
                )
                snap = vs.snapshot()
            owned[snap] += 1
            cstate.fsnaps.add(snap)
            return ["ok", [snap, closed, era]]
        if op == "rel":
            snap = req[1]
            if owned[snap] > 0:
                owned[snap] -= 1
                if not owned[snap]:
                    del owned[snap]
                    cstate.fsnaps.discard(snap)
                vs.release(snap)
            return ["ok", None]
        if op == "commit":
            _op, pairs, snap = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            writes = {k: v for k, v in pairs}
            # vs.commit releases the snapshot itself (success OR conflict),
            # so drop our bookkeeping entry unconditionally
            if owned[snap] > 0:
                owned[snap] -= 1
                if not owned[snap]:
                    del owned[snap]
            else:
                raise SdbError("kv commit: unknown snapshot")
            # apply, WAL append, and replica ship happen under ONE lock
            # hold: recovery replays commits in exactly apply order, and
            # an acked write is on every attached replica
            with srv.wal_lock:
                try:
                    srv._require_primary()
                    srv._require_replicated()
                    srv.shard_check_keys(writes)
                    srv.check_locks(writes)
                except SdbError:
                    vs.release(snap)  # vs.commit would have released it
                    raise
                ver = vs.commit(writes, snap)  # SdbError on conflict
                delivered = srv._publish(writes)
                # durability gate, post-ship half: the ack promises the
                # write is on every replica attached at commit time —
                # if every link died mid-ship, refuse the ack (the write
                # IS local + WAL'd, so the client must treat the
                # outcome as unknown and retry idempotently)
                if delivered == 0 and srv._needs_replica():
                    raise SdbError(
                        "kv commit not replicated (no replica attached); "
                        "outcome uncertain — retry only with idempotent "
                        "writes"
                    )
            return ["ok", ver]
        if op == "prepare":
            # 2PC phase 1: validate + stage this participant's writeset
            _op, txid, pairs, snap, meta_addrs = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            writes = {
                bytes(k): (None if v is None else bytes(v))
                for k, v in pairs
            }
            # prepare consumes the snapshot exactly like commit does
            if owned[snap] > 0:
                owned[snap] -= 1
                if not owned[snap]:
                    del owned[snap]
            else:
                raise SdbError("kv prepare: unknown snapshot")
            srv.prepare_txn(str(txid), writes, snap, list(meta_addrs))
            return ["ok", None]
        if op == "decide":
            # 2PC phase 2 (or abort): apply/drop a staged writeset
            _op, txid, decision = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            if decision not in ("commit", "abort"):
                raise SdbError(f"kv decide: bad decision {decision!r}")
            return ["ok", srv.decide_txn(str(txid), decision)]
        if op == "txn_mark":
            # commit-log decision record (meta shard): first writer wins,
            # everyone else learns the recorded decision
            _op, txid, want = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            if want not in ("commit", "abort"):
                raise SdbError(f"kv txn_mark: bad decision {want!r}")
            return ["ok", srv.txn_mark(str(txid), want)]
        if op == "shard_set":
            _op, beg, end, epoch = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            srv.shard_set(
                bytes(beg), None if end is None else bytes(end), int(epoch)
            )
            return ["ok", None]
        if op == "shard_items":
            # admin (split copy): latest items in a range, IGNORING the
            # shard bounds — the fenced-off slice is exactly what moves.
            # Paged: the response stops at `limit` items or ~8MB of
            # values, whichever first; the caller continues from the
            # last returned key until an empty page. One giant slice
            # must never have to fit in a single MAX_FRAME response.
            _op, beg, end = req[:3]
            limit = req[3] if len(req) > 3 else None
            # internal \x00 rows never move with a slice; clamping keeps
            # `limit` exact (the reserved namespace sorts first)
            beg = max(bytes(beg), b"\x01")
            snap2 = vs.snapshot()
            try:
                items = vs.range_items(
                    beg, INF_END if end is None else bytes(end),
                    snap2, limit, False,
                )
            finally:
                vs.release(snap2)
            out, total = [], 0
            for k, v in items:
                out.append([k, v])
                total += len(k) + len(v)
                if total >= (8 << 20):
                    break
            return ["ok", out]
        if op == "shard_purge":
            # admin (post-split GC): tombstone the moved, now-unroutable
            # slice on the source group
            _op, beg, end = req
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            return ["ok", srv.shard_purge(
                bytes(beg), None if end is None else bytes(end)
            )]
        if op == "seed":
            if srv.role != "primary":
                raise SdbError(srv.not_primary_msg())
            with srv.wal_lock:
                srv._require_primary()
                srv._require_replicated()
                with vs.lock:
                    for k, v in req[1]:
                        vs.seed(k, v)
                writes = {k: v for k, v in req[1]}
                srv._publish(writes)
            return ["ok", None]
        if op == "ping":
            return ["ok", "pong"]
        if op == "status":
            return ["ok", srv.status()]
        if op == "promote":
            srv.promote(reason="admin")
            return ["ok", "primary"]
        if op == "repl_hello":
            _op, pid, paddr, seq = req
            return ["ok", srv.repl_hello(pid, paddr, seq)]
        if op == "repl_apply":
            if len(req) >= 5:
                # blob+crc form: the replica verifies byte integrity
                # BEFORE apply (see KvServer.repl_apply). A 6th element
                # carries the frame's closed timestamp.
                _op, pid, seq, blob, crc = req[:5]
                closed = float(req[5]) if len(req) > 5 else None
                return ["ok", srv.repl_apply(pid, seq, None,
                                             bytes(blob), int(crc),
                                             closed=closed)]
            _op, pid, seq, pairs = req  # legacy unchecked form
            return ["ok", srv.repl_apply(pid, seq, pairs)]
        if op == "repl_sync":
            _op, pid, seq, items = req[:4]
            closed = float(req[4]) if len(req) > 4 else None
            return ["ok", srv.repl_sync(pid, seq, items, closed=closed)]
        if op == "repl_ping":
            _op, pid = req[:2]
            if srv.role == "replica" and pid == srv.repl_primary_id:
                srv.note_repl_traffic()
                # heartbeat closed-timestamp: adopt only when this
                # replica has applied EVERYTHING the primary shipped —
                # with frames still in flight the stamp closes a prefix
                # we do not hold yet
                if len(req) >= 4 and int(req[2]) == srv.applied_seq:
                    with srv.wal_lock:
                        if pid == srv.repl_primary_id \
                                and int(req[2]) == srv.applied_seq:
                            srv.closed_ts = max(srv.closed_ts,
                                                float(req[3]))
            return ["ok", srv.applied_seq]
        raise SdbError(f"unknown kv op {op!r}")


class _ReplLink:
    """Primary-side link to ONE replica. `send()` runs on the committing
    thread under the server's wal_lock (synchronous ship, in commit
    order); a background thread owns (re)attachment including the full
    resync, plus the idle heartbeat that keeps the replica's failover
    timer quiet between commits."""

    def __init__(self, server: "KvEngine", addr_str: str):
        self.server = server
        self.addr_str = addr_str
        self.addr = _parse_addr(addr_str)
        self.conn = None
        self.attached = False
        self._backoff = 0.05
        self._handle = server.runtime.every(
            server.ping_interval_s, self._tick,
            name=f"kv-repl-{addr_str}", immediate=True,
        )

    def _tick(self):
        if self.attached:
            try:
                with self.server.wal_lock:
                    if self.attached and self.conn is not None:
                        # heartbeat carries (repl_seq, closed): under
                        # wal_lock every commit this primary ever acked
                        # is in a frame <= repl_seq, so "now" is closed
                        # — the replica's staleness stays bounded by
                        # one ping interval even when writes pause
                        self.conn.call(
                            ["repl_ping", self.server.node_id,
                             self.server.repl_seq,
                             self.server.advance_closed()]
                        )
            except Exception:
                self._detach()
            return self.server.ping_interval_s
        try:
            self._attach()
            self._backoff = 0.05
            return self.server.ping_interval_s
        except Exception:
            delay = self._backoff
            self._backoff = min(delay * 2, 2.0)
            return delay

    def _attach(self):
        c = self.server.transport.connect(
            self.addr, self.server.secret,
            timeout=self.server.connect_timeout_s,
        )
        try:
            # the handshake + cutover run under wal_lock so the replica's
            # adopted seq and the shipped stream can't interleave
            with self.server.wal_lock:
                have = c.call([
                    "repl_hello", self.server.node_id,
                    self.server.advertise, self.server.repl_seq,
                ])
                if have != self.server.repl_seq:
                    items = self.server.vs.latest_items()
                    c.call([
                        "repl_sync", self.server.node_id,
                        self.server.repl_seq,
                        [[k, v] for k, v in items],
                        self.server.advance_closed(),
                    ])
                    self.server.counters["repl_resyncs"] += 1
                self.conn = c
                self.attached = True
                # durability gate arming: from here on an ack requires
                # at least one attached replica (see _require_replicated)
                self.server.ever_attached = True
        except BaseException:
            c.close()
            raise

    def send(self, seq: int, blob: bytes, crc: int,
             closed: float) -> bool:
        # caller holds wal_lock. The writeset ships as one encoded blob
        # + crc32 so the replica can verify byte integrity BEFORE apply
        # (a corrupted frame detaches the link; reattach full-resyncs).
        # `closed` is the frame's closed timestamp (see _publish).
        if not self.attached or self.conn is None:
            return False
        try:
            self.conn.call(
                ["repl_apply", self.server.node_id, seq, blob, crc,
                 closed]
            )
            return True
        except Exception:
            self._detach()
            return False

    def _detach(self):
        self.attached = False
        c, self.conn = self.conn, None
        if c is not None:
            c.close()

    def stop(self):
        self._handle.cancel()
        self._detach()


class _Replicator:
    def __init__(self, server: "KvEngine", peer_addrs: list[str]):
        self.links = [_ReplLink(server, a) for a in peer_addrs]

    def ship(self, seq: int, blob: bytes, crc: int,
             closed: float) -> int:
        """Returns how many replicas acked the frame."""
        return sum(
            1 for link in self.links if link.send(seq, blob, crc, closed)
        )

    def attached_count(self) -> int:
        return sum(1 for link in self.links if link.attached)

    def stop(self):
        for link in self.links:
            link.stop()


class KvEngine(_EngineDispatch):
    """Transport-independent KV server: MVCC state, WAL durability,
    replication, lease failover, sharding, and 2PC — everything except
    sockets and threads, which arrive through the kvs/net.py seam
    (`clock`, `runtime`, `transport`). `KvServer` mounts this engine on
    a real ThreadingTCPServer; a deterministic simulator can mount the
    SAME engine on a virtual-time scheduler and an in-process
    message-scheduling transport."""

    # WAL compaction threshold: beyond this the recovery path rewrites
    # the snapshot file and truncates the log
    WAL_COMPACT_BYTES = 64 << 20

    def _engine_init(self, advertise: str, secret: Optional[str] = None,
                     data_dir: Optional[str] = None, fsync: bool = True,
                     role: str = "primary",
                     peers: Optional[list[str]] = None,
                     self_index: Optional[int] = None,
                     auto_failover: bool = True,
                     failover_timeout_s: Optional[float] = None,
                     lease_ttl_s: Optional[float] = None,
                     clock: Optional[net.Clock] = None,
                     runtime: Optional[net.Runtime] = None,
                     transport: Optional[net.Transport] = None,
                     node_id: Optional[str] = None,
                     trace=None,
                     join_existing: bool = False):
        import uuid as _uuid

        self.clock = clock or net.ambient_clock()
        self.runtime = runtime or net.REAL_RUNTIME
        self.transport = transport or net.REAL_TRANSPORT
        self.trace = trace  # callable(dict) | None — simulator event tap
        self.vs = VersionedStore()
        self.secret = secret
        self.data_dir = data_dir
        self.fsync = fsync
        self.wal = None
        self.wal_lock = self.runtime.rlock()
        # -- cluster identity / replication state --
        self.node_id = node_id or str(_uuid.uuid4())
        self.role = role
        self.peers: list[str] = []
        self.self_index: Optional[int] = None
        self.advertise = advertise
        self.primary_addr: Optional[str] = None  # replica's best guess
        self.repl: Optional[_Replicator] = None
        self.repl_seq = 0  # primary: last shipped sequence number
        self.applied_seq = 0  # replica: last applied sequence number
        # closed timestamp (wall domain): primary = last stamp it
        # published; replica = highest stamp adopted from the stream.
        # Volatile by design — a rebooted replica serves NO follower
        # read until the live stream re-proves a closed prefix.
        self.closed_ts = 0.0
        self.repl_primary_id: Optional[str] = None
        self.last_repl = self.clock.monotonic()  # boot grace (monitor)
        self.failover_timeout_s = (cnf.KV_FAILOVER_TIMEOUT_S
                                   if failover_timeout_s is None
                                   else failover_timeout_s)
        self.lease_ttl_s = (cnf.KV_LEASE_TTL_S if lease_ttl_s is None
                            else lease_ttl_s)
        self.ping_interval_s = max(0.05, self.failover_timeout_s / 3.0)
        self.connect_timeout_s = cnf.KV_CONNECT_TIMEOUT_S
        self.resolve_interval_s = cnf.KV_2PC_RESOLVE_INTERVAL_S
        self.auto_failover = auto_failover
        # durability gate: once a replica has attached, acks require at
        # least one attached replica, and an expired un-renewable lease
        # steps this primary down (split-brain bound)
        self.ever_attached = False
        self.lease_valid_until = self.clock.wall() + self.lease_ttl_s
        # election cooldown after a step-down: the demoted node is
        # usually rank-tied with (and lower-indexed than) its peers, so
        # without a pause it wins every re-election straight back into
        # whatever made it step down — a primary flip-flop that starves
        # the healthy replica forever (found by the one-way-partition
        # regression test)
        self.election_pause_until = 0.0
        self.counters: Counter = Counter()
        self._renew_handle: Optional[net.LoopHandle] = None
        self._monitor_handle: Optional[net.LoopHandle] = None
        self._resolver_handle: Optional[net.LoopHandle] = None
        # -- sharding / 2PC state (kvs/shard.py) --
        # shard = (beg, end|None, epoch); None = unsharded, serve all keys
        self.shard: Optional[tuple] = None
        self.staged: dict = {}  # txid -> {key: val|None} (prepared)
        self.staged_meta: dict = {}  # txid -> (meta_addrs, staged_at_mono)
        self.locks: dict = {}  # key -> txid holding a prepared write
        self.orphan_grace_s = cnf.KV_2PC_ORPHAN_GRACE_S
        if data_dir:
            self._recover()
        self._load_shard_state()
        # primacy era/lineage (stamped into every replicated writeset
        # via _publish): a fresh primacy starts past every era this
        # store has ever seen
        self.era = _repl_rank(self.vs.read_latest(REPL_STATE_KEY))[0] + 1
        self.lineage_id = self.node_id
        if peers is not None:
            self.configure_cluster(peers, self_index, role=role,
                                   auto_failover=auto_failover,
                                   join_existing=join_existing)

    def _trace(self, ev: str, **fields):
        if self.trace is not None:
            fields.update(ev=ev, node=self.node_id, addr=self.advertise,
                          t=round(self.clock.monotonic(), 6))
            self.trace(fields)

    # -- cluster wiring ------------------------------------------------------

    def configure_cluster(self, peers: list[str],
                          self_index: Optional[int] = None,
                          role: Optional[str] = None,
                          auto_failover: bool = True,
                          join_existing: bool = False):
        """Attach this server to a replica set. `peers` lists every
        member (including this one) as host:port in PROMOTION-RANK order:
        on primary death the lowest-ranked live replica promotes. Safe to
        call after construction (tests bind port 0 first).

        With `join_existing`, a configured-primary probes its peers
        first and joins as a REPLICA when one of them already serves as
        primary — the restart-after-crash path: rebooting a failed
        primary with its stale config must not mint a second primary
        next to the replica that promoted in the meantime."""
        self.peers = list(peers)
        if self_index is None:
            try:
                self_index = self.peers.index(self.advertise)
            except ValueError:
                raise SdbError(
                    f"kv peers {peers!r} do not include this server "
                    f"({self.advertise}); pass self_index explicitly"
                )
        self.self_index = self_index
        self.advertise = self.peers[self_index]
        if role is not None:
            self.role = role
        self.auto_failover = auto_failover
        others = [a for i, a in enumerate(self.peers) if i != self_index]
        if self.role == "primary" and join_existing and others:
            for a in others:
                st = self.transport.status_of(
                    _parse_addr(a), self.secret,
                    timeout=self.connect_timeout_s,
                )
                if st is not None and st.get("role") == "primary":
                    self.role = "replica"
                    self.primary_addr = a
                    self.note_repl_traffic()
                    self._trace("join_as_replica", primary=a)
                    break
        if self.role == "primary":
            self.primary_addr = self.advertise
            self.lease_valid_until = self.clock.wall() + self.lease_ttl_s
            # quorum-capable groups (3+) arm the durability gate from
            # the first moment: nothing is acked — data write, 2PC
            # stage, or commit-log record — until a replica holds it.
            # 2-member groups keep the original availability contract (a
            # promoted survivor serves alone).
            self.ever_attached = len(self.peers) >= 3
            with self.wal_lock:
                # fresh primacy: advance past every era this store has
                # seen and make the credential durable immediately
                self.era = _repl_rank(
                    self.vs.read_latest(REPL_STATE_KEY)
                )[0] + 1
                self.lineage_id = self.node_id
                if others:
                    self._publish({})
            if others and self.repl is None:
                self.repl = _Replicator(self, others)
            self._start_renewal()
        elif auto_failover:
            self._start_monitor()

    def not_primary_msg(self) -> str:
        hint = self.primary_addr or "unknown"
        return f"kv not primary (role={self.role}, primary={hint})"

    def _needs_replica(self) -> bool:
        """True when the durability gate is armed: this primary has
        peers, has had a replica attached at least once this
        incarnation, but has none attached right now."""
        return bool(
            len(self.peers) > 1 and self.ever_attached
            and (self.repl is None or self.repl.attached_count() == 0)
        )

    def _require_primary(self) -> None:
        """Role re-check under wal_lock. The dispatch-level role check
        runs BEFORE the lock is acquired, and a demotion can land in
        between — the deterministic simulator found exactly that
        interleaving staging a 2PC prepare on a just-demoted node,
        where the stage is later wiped by the resync from the new
        primary (a half-applied cross-shard commit)."""
        if self.role != "primary":
            raise SdbError(self.not_primary_msg())

    def _require_replicated(self) -> None:
        """Durability gate, entry half: once this primary has ever had a
        replica attached, an acked write must reach at least one replica
        — with every link down, refuse (retryably) instead of acking a
        write that would be wiped by a resync after a peer promotes."""
        if self._needs_replica():
            self.counters["writes_unreplicated_refused"] += 1
            raise SdbError(
                "kv write not replicated (no replica attached); "
                "retrying via rediscovery"
            )

    def note_repl_traffic(self):
        self.last_repl = self.clock.monotonic()

    # -- follower reads: closed-timestamp publication + proof ---------------

    def advance_closed(self) -> float:
        """Primary side, caller holds wal_lock: advance and return the
        published closed timestamp. Commits are serialized under
        wal_lock and shipped before their ack, so at this instant every
        write this primary has ever acknowledged lives in a frame at or
        below the current repl_seq — 'now' is closed. Monotone-maxed so
        a wall-clock step backwards can never regress the stamp."""
        self.closed_ts = max(self.closed_ts, self.clock.wall())
        return self.closed_ts

    def follower_read_proof(self, req_ts, min_closed, min_era,
                            min_epoch: int = 0):
        """The closed-timestamp proof gating EVERY follower-served read:
        return (closed_ts, era)
        when this node can serve a read-only snapshot at `req_ts`, else
        raise the typed retryable "kv follower too stale" error.

        - On the PRIMARY the proof is trivial: it owns the log, so its
          state is closed through 'now' (the fallback path lands here).
        - On a replica: `closed_ts >= max(req_ts, min_closed)` proves
          the requested prefix was fully applied; the durable era
          (\\x00!replstate) must reach `min_era` — a replica still on a
          superseded lineage may hold rolled-back writes and miss acked
          ones, so it must never serve a session that already observed
          the newer era; and the replicated shard-config epoch must
          reach the CLIENT's routing epoch `min_epoch` — a slice moved
          onto this group by a split arrives as `seed` frames stamped
          at COPY time, not at the rows' original ack times, so only a
          replica that has applied the epoch fence (which ships after
          the copy, in frame order) provably holds the migrated rows.
        Floors come back to the client, which folds them into the
        session high-water mark (monotone reads).
        """
        from surrealdb_tpu_torch import cnf as _cnf

        if self.role == "primary":
            return self.advance_closed(), self.era
        era = _repl_rank(self.vs.read_latest(REPL_STATE_KEY))[0]
        want = max(float(req_ts), float(min_closed or 0.0))
        if _cnf.KV_FOLLOWER_PROOF_DISABLED:
            # mutation-test hook: LIE that the prefix is closed — the
            # DST follower-read invariant must catch what this serves
            return max(self.closed_ts, want), max(era, int(min_era or 0))
        epoch_ok = (int(min_epoch or 0) <= 0
                    or (self.shard is not None
                        and int(self.shard[2]) >= int(min_epoch)))
        if self.closed_ts < want or era < int(min_era or 0) \
                or not epoch_ok:
            self.counters["follower_reads_rejected_stale"] += 1
            raise SdbError(
                f"kv follower too stale: closed={self.closed_ts:.6f} "
                f"era={era} epoch="
                f"{None if self.shard is None else self.shard[2]} "
                f"cannot prove requested={float(req_ts):.6f} "
                f"floor=({float(min_closed or 0.0):.6f}, "
                f"{int(min_era or 0)}, epoch>={int(min_epoch or 0)})"
            )
        self.counters["follower_reads_served"] += 1
        return self.closed_ts, era

    def status(self) -> dict:
        # counter writers are unsynchronized; a key insert during the
        # copy raises RuntimeError — retry the snapshot, don't error the
        # status op (a failed probe reads as a dead peer to surveys)
        counters: dict = {}
        for _ in range(3):
            try:
                counters = {k: int(v) for k, v in self.counters.items()}
                break
            except RuntimeError:
                continue
        from surrealdb_tpu_torch.node import KV_PRIMARY_LEASE, store_lease_read

        # the lease row + lineage ride the status reply so a candidate
        # replica's promotion survey can (a) respect a lease it no
        # longer has a fresh copy of and (b) defer to a peer replica
        # that applied more of the dead primary's stream
        try:
            lease = store_lease_read(self.vs, KV_PRIMARY_LEASE)
        except Exception:
            lease = None
        rs = self.vs.read_latest(REPL_STATE_KEY)
        if rs is not None:
            try:
                rs = _decode(bytes(rs))
            except Exception:
                rs = None
        return {
            "role": self.role,
            "node_id": self.node_id,
            "electable": bool(
                self.role == "replica"
                and self.clock.monotonic() >= self.election_pause_until
            ),
            "version": self.vs.version,
            "repl_seq": self.repl_seq,
            "applied_seq": self.applied_seq,
            # follower-read serving state: the closed timestamp this
            # node can prove, its lag behind 'now', and whether a
            # bounded-staleness read could be served here at all
            "closed_ts": self.closed_ts,
            "closed_lag_s": (0.0 if self.role == "primary"
                             else max(self.clock.wall()
                                      - self.closed_ts, 0.0)),
            "follower_serving": bool(self.role == "replica"
                                     and self.closed_ts > 0.0),
            "repl_primary_id": self.repl_primary_id,
            "repl_state": rs,  # durable [lineage, seq, era] credential
            "lease": None if lease is None else [lease[0], lease[1]],
            "primary": (self.advertise if self.role == "primary"
                        else self.primary_addr),
            "attached_replicas": (self.repl.attached_count()
                                  if self.repl else 0),
            "shard": (None if self.shard is None
                      else [self.shard[0], self.shard[1], self.shard[2]]),
            "staged_txns": len(self.staged),
            "counters": counters,
        }

    # -- sharding: range enforcement + 2PC participant ----------------------

    def wrong_shard_msg(self) -> str:
        beg, end, epoch = self.shard
        return (f"kv wrong shard epoch: this group serves "
                f"[{beg!r}, {'inf' if end is None else repr(end)}) at "
                f"epoch {epoch}; refresh the shard map")

    def shard_check_keys(self, keys) -> None:
        """Reject keys outside this server's assigned range (a client
        routing with a stale shard map). Internal \\x00-prefixed keys are
        exempt: prepare records / commit-log rows / the shard map itself
        must land wherever their role requires."""
        if self.shard is None:
            return
        beg, end, _epoch = self.shard
        for k in keys:
            if k[:1] == b"\x00":
                continue
            if k < beg or (end is not None and k >= end):
                raise SdbError(self.wrong_shard_msg())

    def shard_check_range(self, beg: bytes, end: bytes) -> None:
        if self.shard is None or beg[:1] == b"\x00":
            return
        sbeg, send, _epoch = self.shard
        if beg < sbeg or (send is not None and end > send):
            raise SdbError(self.wrong_shard_msg())

    def check_locks(self, writes) -> None:
        """A key staged by an in-flight 2PC prepare is write-locked until
        its decision lands: conflicting optimistic commits abort
        retryably (by then the resolver or coordinator has decided)."""
        if self.locks and any(k in self.locks for k in writes):
            raise SdbError(CONFLICT_MSG)

    def prepare_txn(self, txid: str, writes: dict, snap: int,
                    meta_addrs: list) -> None:
        """Phase 1: validate the writeset at `snap` (same optimistic
        check as commit), then stage it as one MVCC commit of a single
        \\x00!prep/<txid> record — WAL append and synchronous replica
        ship ride the normal commit path, so a staged prepare survives
        primary failover exactly like an acked write."""
        prep_key = PREP_PREFIX + txid.encode()
        blob = _encode([txid, [[k, v] for k, v in writes.items()],
                        list(meta_addrs), self.clock.wall()])
        with self.wal_lock:
            with self.vs.lock:
                try:
                    self._require_primary()
                    self._require_replicated()
                    self.shard_check_keys(writes)
                    for k in writes:
                        if self.locks.get(k, txid) != txid:
                            raise SdbError(CONFLICT_MSG)
                        chain = self.vs.chains.get(k)
                        if chain is not None and chain[-1][0] > snap:
                            raise SdbError(CONFLICT_MSG)
                except SdbError:
                    self.vs.release(snap)
                    raise
                self.vs.commit({prep_key: blob}, snap)
            self.staged[txid] = writes
            self.staged_meta[txid] = (list(meta_addrs),
                                      self.clock.monotonic())
            for k in writes:
                self.locks[k] = txid
            delivered = self._publish({prep_key: blob})
            if delivered == 0 and self._needs_replica():
                # an unreplicated stage would vanish when a peer
                # promotes: a coordinator that then logged COMMIT would
                # half-apply the transaction. Undo the stage locally and
                # refuse — the coordinator claims its abort record.
                self.decide_txn(txid, "abort")
                raise SdbError(
                    "kv prepare not replicated (no replica attached); "
                    "transaction aborted and can be retried"
                )
            self.counters["twopc_prepares"] += 1
        self._start_resolver()

    def decide_txn(self, txid: str, decision: str) -> str:
        """Phase 2: apply (commit) or drop (abort) a staged writeset and
        release its locks. Idempotent: an unknown txid means the
        decision already landed here (returns "unknown")."""
        prep_key = PREP_PREFIX + txid.encode()
        with self.wal_lock:
            self._require_primary()
            writes = self.staged.pop(txid, None)
            self.staged_meta.pop(txid, None)
            if writes is None:
                return "unknown"
            for k in writes:
                if self.locks.get(k) == txid:
                    del self.locks[k]
            full: dict = {prep_key: None}
            if decision == "commit":
                full.update(writes)
            # fresh snapshot: locked keys could not have advanced (locks
            # block commits AND prepares), so this never conflicts
            snap = self.vs.snapshot()
            self.vs.commit(full, snap)
            self._publish(full)
            self.counters[f"twopc_{decision}s"] += 1
            return decision

    def txn_mark(self, txid: str, want: str) -> str:
        """Commit-log decision record (meta shard): write `want` only if
        no decision exists yet; return the decision that actually stands.
        This single first-writer-wins row is what makes the coordinator's
        commit and a participant's orphan-abort mutually exclusive."""
        key = TXNLOG_PREFIX + txid.encode()
        with self.wal_lock:
            self._require_primary()
            cur = self.vs.read_latest(key)
            if cur is not None:
                # first-writer-wins early return — but the caller may
                # only ACT on a decision that is held by a replica: a
                # retry after a refused first write must not slip the
                # record past the durability gate (the record would die
                # with this node and a participant's resolver would
                # claim the opposite decision)
                if self._needs_replica():
                    raise SdbError(
                        "kv txn_mark not replicated (no replica "
                        "attached); retry reads the recorded decision"
                    )
                return bytes(cur).decode()
            val = want.encode()
            snap = self.vs.snapshot()
            self.vs.commit({key: val}, snap)
            delivered = self._publish({key: val})
            if delivered == 0 and self._needs_replica():
                # the decision record is THE commit point — an
                # unreplicated one could be lost to a meta failover
                # while the coordinator acts on it. Leave the local row
                # (first-writer-wins keeps retries convergent) but
                # refuse the ack so the caller re-reads the standing
                # decision through rediscovery.
                raise SdbError(
                    "kv txn_mark not replicated (no replica attached); "
                    "retry reads the recorded decision"
                )
            self.counters["txn_marks"] += 1
            return want

    def shard_set(self, beg: bytes, end: Optional[bytes],
                  epoch: int) -> None:
        """Assign/replace this group's served range behind an epoch
        fence. Persisted + replicated as a \\x00!shardcfg row so a
        promoted replica keeps enforcing the same bounds."""
        with self.wal_lock:
            self._require_primary()
            self._require_replicated()
            for k in self.locks:
                if k < beg or (end is not None and k >= end):
                    raise SdbError(
                        "kv shard set: a staged 2pc transaction holds "
                        "keys outside the new range; retry once it "
                        "resolves"
                    )
            blob = _encode([beg, end, int(epoch)])
            snap = self.vs.snapshot()
            self.vs.commit({SHARD_CFG_KEY: blob}, snap)
            self.shard = (bytes(beg),
                          None if end is None else bytes(end), int(epoch))
            self._publish({SHARD_CFG_KEY: blob})
            self.counters["shard_sets"] += 1

    def shard_purge(self, beg: bytes, end: Optional[bytes]) -> int:
        """Tombstone every key in [beg, end) — post-split GC of the
        moved slice on the source group. Internal keys are kept."""
        hi = INF_END if end is None else end
        with self.wal_lock:
            self._require_primary()
            self._require_replicated()
            snap = self.vs.snapshot()
            try:
                items = self.vs.range_items(beg, hi, snap, None, False)
            finally:
                self.vs.release(snap)
            writes = {k: None for k, _v in items if k[:1] != b"\x00"}
            if not writes:
                return 0
            snap = self.vs.snapshot()
            self.vs.commit(writes, snap)
            self._publish(writes)
            return len(writes)

    def _load_shard_state(self) -> None:
        """Adopt the persisted shard config and rebuild the staged-2PC
        table + lock set from \\x00!prep/ records. Runs at construction
        (post-recovery) and again on promotion — a promoted replica has
        the prep records in its keyspace (they replicated like any
        commit) but not the primary's in-memory tables."""
        raw = self.vs.read_latest(SHARD_CFG_KEY)
        if raw is not None:
            beg, end, epoch = _decode(bytes(raw))
            self.shard = (bytes(beg),
                          None if end is None else bytes(end), int(epoch))
        snap = self.vs.snapshot()
        try:
            items = self.vs.range_items(
                PREP_PREFIX, PREP_PREFIX + b"\xff", snap, None, False
            )
        finally:
            self.vs.release(snap)
        for _k, blob in items:
            txid, pairs, meta, _ts = _decode(bytes(blob))
            writes = {
                bytes(k): (None if v is None else bytes(v))
                for k, v in pairs
            }
            self.staged[txid] = writes
            # age from now: recovery time shouldn't insta-orphan a txn
            # whose coordinator is still deciding
            self.staged_meta[txid] = (list(meta), self.clock.monotonic())
            for k in writes:
                self.locks[k] = txid
        if self.staged and self.role == "primary":
            self._start_resolver()

    # -- 2PC orphan resolver -------------------------------------------------

    def _start_resolver(self):
        if self._resolver_handle is not None:
            return
        self._resolver_handle = self.runtime.every(
            self.resolve_interval_s, self._resolver_tick,
            name="kv-2pc-resolver",
        )

    def _resolver_tick(self):
        """Drive staged prepares whose coordinator went quiet to the
        decision recorded in the meta shard's commit log. Claims ABORT
        with first-writer-wins semantics when no record exists — a
        coordinator that died before logging its decision can never
        commit afterwards, so every participant converges on abort."""
        try:
            if self.role != "primary":
                return
            now = self.clock.monotonic()
            with self.wal_lock:
                orphans = [
                    (txid, list(meta))
                    for txid, (meta, ts) in self.staged_meta.items()
                    if now - ts >= self.orphan_grace_s
                ]
            for txid, meta in orphans:
                decision = self._resolve_decision(txid, meta)
                if decision in ("commit", "abort"):
                    self.decide_txn(txid, decision)
                    self.counters["twopc_resolved"] += 1
        except Exception:
            # resolver must never die; next tick retries
            self.counters["twopc_resolver_errors"] += 1

    def _resolve_decision(self, txid: str, meta_addrs: list):
        """Ask the meta shard for the recorded decision, claiming abort
        if none exists. Network I/O — never called under wal_lock."""
        for a in meta_addrs:
            try:
                c = self.transport.connect(
                    _parse_addr(a), self.secret,
                    timeout=self.connect_timeout_s,
                )
            except (OSError, SdbError):
                continue
            try:
                return c.call(["txn_mark", txid, "abort"])
            except (OSError, SdbError):
                continue  # replica / unreachable: try the next member
            finally:
                c.close()
        return None

    # -- replication (replica side) -----------------------------------------

    def repl_hello(self, primary_id: str, primary_addr: str, seq: int):
        with self.wal_lock:
            if self.role != "replica":
                raise SdbError(f"kv not replica (role={self.role})")
            self.primary_addr = primary_addr
            self.note_repl_traffic()
            if primary_id != self.repl_primary_id:
                # new primary lineage: our applied state is of unknown
                # provenance — demand a full resync
                self.repl_primary_id = primary_id
                self.applied_seq = -1
            return self.applied_seq

    def repl_apply(self, primary_id: str, seq: int, pairs,
                   blob: Optional[bytes] = None,
                   crc: Optional[int] = None,
                   closed: Optional[float] = None):
        if blob is not None:
            # verify BEFORE taking locks or touching state: a corrupted
            # frame must never be applied (the sender's link detaches on
            # the error and reattachment full-resyncs)
            if zlib.crc32(blob) & 0xFFFFFFFF != crc:
                self.counters["repl_crc_errors"] += 1
                raise SdbError(
                    f"kv repl: frame crc mismatch at seq {seq}"
                )
            pairs = _decode(blob)
        with self.wal_lock:
            if self.role != "replica":
                raise SdbError(f"kv not replica (role={self.role})")
            if primary_id != self.repl_primary_id:
                raise SdbError("kv repl: unknown primary (hello required)")
            self.note_repl_traffic()
            if seq <= self.applied_seq:
                # duplicate frame (retransmit / fault injection): the
                # sequence number makes application idempotent
                self.counters["repl_dups"] += 1
                return self.applied_seq
            if seq != self.applied_seq + 1:
                raise SdbError(
                    f"kv repl gap: have {self.applied_seq}, got {seq}"
                )
            writes = {
                bytes(k): (None if v is None else bytes(v))
                for k, v in pairs
            }
            self.vs.commit(writes, self.vs.snapshot())
            self.log_commit(writes)
            self._note_prep_writes(writes)
            self._note_shard_cfg(writes)
            self.applied_seq = seq
            if closed is not None:
                # the frame's stamp closes everything up to THIS seq,
                # which is now fully applied
                self.closed_ts = max(self.closed_ts, closed)
            self.counters["repl_applied"] += 1
            return self.applied_seq

    def repl_sync(self, primary_id: str, seq: int, items,
                  closed: Optional[float] = None):
        with self.wal_lock:
            if self.role != "replica":
                raise SdbError(f"kv not replica (role={self.role})")
            if primary_id != self.repl_primary_id:
                raise SdbError("kv repl: unknown primary (hello required)")
            self.note_repl_traffic()
            new = {bytes(k): bytes(v) for k, v in items}
            with self.vs.lock:
                existing = list(self.vs.chains)
            # express the state transfer as one MVCC commit (tombstones
            # for keys the primary no longer has) so concurrent replica
            # reads keep their snapshots
            writes: dict = {k: None for k in existing if k not in new}
            writes.update(new)
            if writes:
                self.vs.commit(writes, self.vs.snapshot())
                self.log_commit(writes)
            # full state transfer: rebuild the staged-2PC mirror
            # wholesale from the transferred prep rows
            self.staged.clear()
            self.staged_meta.clear()
            self.locks.clear()
            self._note_prep_writes(new)
            self._note_shard_cfg(new)
            self.applied_seq = seq
            if closed is not None:
                self.closed_ts = max(self.closed_ts, closed)
            self.counters["repl_synced"] += 1
            return self.applied_seq

    def _note_shard_cfg(self, writes: dict):
        """Adopt a replicated shard-config row into the in-memory fence
        as it streams in. Before follower reads this could wait for
        promotion (_load_shard_state) — a replica never served reads.
        Now the REPLICA enforces range fencing and proves the epoch in
        the follower-read proof, so its fence must track its keyspace
        continuously."""
        raw = writes.get(SHARD_CFG_KEY)
        if raw is None:
            return
        try:
            beg, end, epoch = _decode(bytes(raw))
        except Exception:
            return  # robust: an undecodable row is reload's job
        self.shard = (bytes(beg),
                      None if end is None else bytes(end), int(epoch))

    def _note_prep_writes(self, writes: dict):
        """Mirror replicated 2PC stage state in memory as prep rows
        stream in, so a replica's staged/locks tables track its
        keyspace continuously instead of only at promotion-time reload
        (a stale mirror would report phantom staged transactions)."""
        for k, v in writes.items():
            if not k.startswith(PREP_PREFIX):
                continue
            txid = k[len(PREP_PREFIX):].decode()
            if v is None:
                w = self.staged.pop(txid, None)
                self.staged_meta.pop(txid, None)
                for kk in (w or ()):
                    if self.locks.get(kk) == txid:
                        del self.locks[kk]
                continue
            try:
                _txid, pairs, meta, _ts = _decode(bytes(v))
            except Exception:
                continue  # robust: an undecodable row is reload's job
            w = {
                bytes(a): (None if b is None else bytes(b))
                for a, b in pairs
            }
            self.staged[txid] = w
            self.staged_meta[txid] = (list(meta), self.clock.monotonic())
            for kk in w:
                self.locks[kk] = txid

    # -- replication (primary side) -----------------------------------------

    def _ship(self, writes: dict) -> int:
        """Ship one committed writeset to every attached replica.
        Caller holds wal_lock; ships are strictly in commit order.
        Returns how many replicas acked the frame."""
        if self.repl is None:
            return 0
        self.repl_seq += 1
        blob = _encode([[k, v] for k, v in writes.items()])
        delivered = self.repl.ship(self.repl_seq, blob,
                                   zlib.crc32(blob) & 0xFFFFFFFF,
                                   self.advance_closed())
        self.counters["repl_shipped"] += 1
        return delivered

    def _publish(self, writes: dict) -> int:
        """Primary-side durability + replication choke point: stamp the
        durable freshness credential into the writeset, append ONE WAL
        frame, ship to the replicas (which therefore adopt the same
        credential atomically with the data). Caller holds wal_lock and
        has already applied `writes` to the MVCC store. Returns the
        replica ack count."""
        if len(self.peers) <= 1:
            # unclustered: nothing to rank against, keep frames lean
            self.log_commit(writes)
            return self._ship(writes)
        full = dict(writes)
        blob = _encode([self.lineage_id, self.repl_seq + 1, self.era])
        # fresh snapshot: the internal row can never conflict
        self.vs.commit({REPL_STATE_KEY: blob}, self.vs.snapshot())
        full[REPL_STATE_KEY] = blob
        self.log_commit(full)
        return self._ship(full)

    def _start_renewal(self):
        if self._renew_handle is not None or not self.peers:
            return
        self._renew_handle = self.runtime.every(
            max(0.05, self.lease_ttl_s / 3.0), self._renew_tick,
            name="kv-lease-renew", immediate=True,
        )

    def _renew_tick(self):
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch.kvs.api import serialize
        from surrealdb_tpu_torch.node import KV_PRIMARY_LEASE

        key = K.task_lease(KV_PRIMARY_LEASE)
        try:
            with self.wal_lock:
                if self.role != "primary":
                    self._renew_handle = None
                    return STOP
                now_w = self.clock.wall()
                # step-down: we once had a replica attached, none are
                # reachable now, and the last renewal any replica can
                # have seen has expired — a peer may legitimately hold
                # the lease already, so continuing to serve writes here
                # is split-brain. Demote; the monitor takes over.
                if (self._needs_replica()
                        and now_w >= self.lease_valid_until):
                    self.demote(reason="lease_expired")
                    self._renew_handle = None
                    return STOP
                val = serialize(
                    (self.node_id, now_w + self.lease_ttl_s)
                )
                try:
                    self.vs.commit({key: val}, self.vs.snapshot())
                except SdbError:
                    return None  # raced a client write of the lease row
                delivered = self._publish({key: val})
                # the lease is only as fresh as the last renewal a
                # replica ACKED — an unshipped renewal extends nothing
                if delivered > 0 or len(self.peers) <= 1 \
                        or not self.ever_attached:
                    self.lease_valid_until = now_w + self.lease_ttl_s
                self.counters["lease_renewals"] += 1
        except Exception:
            pass  # renewal must never die; next tick retries

    def _start_monitor(self):
        if self._monitor_handle is not None:
            return
        self._monitor_handle = self.runtime.every(
            max(0.05, self.failover_timeout_s / 4.0), self._monitor_tick,
            name="kv-failover-monitor",
        )

    def _monitor_tick(self):
        from surrealdb_tpu_torch.node import (
            KV_PRIMARY_LEASE, store_lease_acquire, store_lease_read,
        )

        try:
            if self.role != "replica":
                self._monitor_handle = None
                return STOP
            my_rank = _repl_rank(self.vs.read_latest(REPL_STATE_KEY))
            if self.repl_primary_id is None and my_rank == (-1, -1):
                # never attached to ANY primary AND no recovered
                # credential: this store has no lineage, so
                # self-promotion at boot would mint a second (empty)
                # primary if the real one is merely slow to start. (A
                # rebooted member that recovered data from its WAL has
                # a credential and may stand for election.)
                return
            idle = self.clock.monotonic() - self.last_repl
            if idle < self.failover_timeout_s:
                return
            if self.clock.monotonic() < self.election_pause_until:
                return  # fresh step-down: let a peer win this round
            # lease gate: the old primary's lease row replicated into
            # OUR keyspace — promotion waits until it expires
            now_w = self.clock.wall()
            row = store_lease_read(self.vs, KV_PRIMARY_LEASE)
            if row is not None and row[0] != self.node_id \
                    and row[1] > now_w:
                return
            # peer survey: follow an existing primary; respect a FRESHER
            # copy of the lease a reachable peer still holds (this
            # replica may have detached long before the primary died —
            # its own lease copy going stale proves nothing); defer to
            # any live replica with a higher durable (era, seq)
            # credential — promoting a stale replica over a fresher
            # live one would resync the fresher one's acked writes
            # away — breaking ties by rank; and require a member quorum
            # for groups of 3+ so two mutually-partitioned replicas
            # can't both claim the lease.
            found = None
            defer = False
            lease_held = False
            live = 1  # self
            for i, a in enumerate(self.peers):
                if i == self.self_index:
                    continue
                st = self.transport.status_of(
                    _parse_addr(a), self.secret,
                    timeout=self.connect_timeout_s,
                )
                if st is None:
                    continue
                live += 1
                if st.get("role") == "primary":
                    found = a
                    break
                lr = st.get("lease")
                if (lr and lr[0] != self.node_id
                        and float(lr[1]) > now_w):
                    lease_held = True
                if st.get("role") == "replica":
                    peer_rank = _repl_rank(st.get("repl_state"))
                    if peer_rank > my_rank:
                        # strictly fresher — defer even to a paused
                        # peer (its pause expires; promoting a staler
                        # store now could resync acked history away)
                        defer = True
                    elif (peer_rank == my_rank and i < self.self_index
                            and st.get("electable", True)):
                        # rank tie breaks by index, but never in favor
                        # of a peer sitting out its post-step-down
                        # cooldown — that deference would deadlock the
                        # election into a primary flip-flop
                        defer = True
            if found is not None:
                self.primary_addr = found
                self.note_repl_traffic()  # it will hello us shortly
                return
            if lease_held or defer:
                return
            if len(self.peers) >= 3 and live <= len(self.peers) // 2:
                self.counters["promotion_quorum_blocked"] += 1
                return
            if store_lease_acquire(self.vs, KV_PRIMARY_LEASE,
                                   self.node_id, self.lease_ttl_s):
                self.promote(reason="lease")
                self._monitor_handle = None
                return STOP
        except Exception:
            pass  # monitor must never die; next tick retries

    def promote(self, reason: str = "admin"):
        """Become the primary: accept writes, replicate to the remaining
        peers, renew the primary lease. Idempotent."""
        with self.wal_lock:
            if self.role == "primary":
                return
            self.role = "primary"
            self.repl_seq = 0  # new lineage — peers will full-resync
            self.primary_addr = self.advertise
            self.counters["promotions"] += 1
            self.counters[f"promotions_{reason}"] += 1
            # durability gate: quorum-capable groups arm it immediately
            # (an elected primary acks nothing until a replica holds
            # it); 2-member groups serve alone per the original contract
            self.ever_attached = len(self.peers) >= 3
            self.lease_valid_until = self.clock.wall() + self.lease_ttl_s
            # new primacy era, durable before the first write is served
            self.era = _repl_rank(
                self.vs.read_latest(REPL_STATE_KEY)
            )[0] + 1
            self.lineage_id = self.node_id
            self._publish({})
            if self._monitor_handle is not None:
                self._monitor_handle.cancel()
                self._monitor_handle = None
            others = [a for i, a in enumerate(self.peers)
                      if i != self.self_index]
            if others and self.repl is None:
                self.repl = _Replicator(self, others)
            self._start_renewal()
            # adopt the replicated shard config and staged-2PC state:
            # prep records arrived as ordinary writesets, the in-memory
            # lock/stage tables did not
            self.staged.clear()
            self.staged_meta.clear()
            self.locks.clear()
            self._load_shard_state()
            self._trace("promote", reason=reason)

    def demote(self, reason: str = "admin"):
        """Step down to replica: stop accepting writes, drop the
        replication links, forget the lineage (the next primary's hello
        forces a full resync), and rejoin the failover monitor.
        Idempotent. The step-down path (`_renew_tick`) invokes this when
        the primary's lease expired without any replica acking a
        renewal — past that point a peer may hold the lease, so serving
        writes here would be split-brain."""
        with self.wal_lock:
            if self.role != "primary":
                return
            self.role = "replica"
            self.counters["demotions"] += 1
            self.counters[f"demotions_{reason}"] += 1
            self.primary_addr = None
            if self.repl is not None:
                self.repl.stop()
                self.repl = None
            self.repl_seq = 0
            self.repl_primary_id = None  # next hello = full resync
            self.applied_seq = -1
            self.ever_attached = False
            self.note_repl_traffic()  # boot-grace the failover timer
            # stand aside for one full failover window: let a healthy
            # peer win the next election instead of re-promoting into
            # the same partition
            self.election_pause_until = (
                self.clock.monotonic()
                + self.failover_timeout_s + self.lease_ttl_s
            )
            if self._renew_handle is not None:
                self._renew_handle.cancel()
                self._renew_handle = None
            self._trace("demote", reason=reason)
        if self.auto_failover:
            self._start_monitor()

    def engine_close(self):
        """Stop every background loop and replication link."""
        for h in (self._renew_handle, self._monitor_handle,
                  self._resolver_handle):
            if h is not None:
                h.cancel()
        self._renew_handle = None
        self._monitor_handle = None
        self._resolver_handle = None
        if self.repl is not None:
            self.repl.stop()

    # -- durability (reference role: TiKV's raft-log + snapshot
    # persistence, core/src/kvs/tikv/mod.rs:32-103 durability contract;
    # single-owner redo log here) --------------------------------------

    def _snap_path(self):
        return os.path.join(self.data_dir, "snapshot.kv")

    def _wal_path(self):
        return os.path.join(self.data_dir, "wal.log")

    def _scan_log(self, path, what: str, apply):
        """Stream verified frames of a WAL/snapshot file into `apply`
        (one decoded frame at a time — a multi-GB log must never be
        materialized as a list on top of the store it seeds).

        Stops at a torn tail OR a crc mismatch (counted as
        wal_crc_errors and warned — corruption must never be applied
        silently). Returns (legacy, clean_end): `clean_end` is the byte
        offset after the last verified frame (the truncation point for
        replay recovery); `legacy` marks a pre-CRC file (read
        unverified once, compacted right after)."""
        with open(path, "rb") as f:
            head = f.read(len(_LOG_MAGIC))
            legacy = head != _LOG_MAGIC
            if legacy:
                f.seek(0)
            clean = f.tell()
            while True:
                hdr = f.read(4 if legacy else 8)
                if len(hdr) < (4 if legacy else 8):
                    break
                (n,) = _HDR.unpack(hdr[:4])
                body = f.read(n)
                if len(body) < n:
                    break  # torn write from a crash — ignore the tail
                if not legacy:
                    (want,) = _HDR.unpack(hdr[4:8])
                    if zlib.crc32(body) & 0xFFFFFFFF != want:
                        self.counters["wal_crc_errors"] += 1
                        print(
                            f"kv: {what} crc mismatch at offset {clean} "
                            f"of {path} — truncating (torn-tail "
                            f"semantics; later records are lost)",
                            file=sys.stderr, flush=True,
                        )
                        break
                try:
                    frame = _decode(body)
                except Exception:
                    # undecodable bytes that passed crc can only be a
                    # legacy-format torn record: stop, don't apply
                    self.counters["wal_crc_errors"] += 1
                    break
                apply(frame)
                clean = f.tell()
        return legacy, clean

    def _recover(self):
        os.makedirs(self.data_dir, exist_ok=True)
        sp, wp = self._snap_path(), self._wal_path()
        legacy_any = False
        wal_dirty = False
        snap_dirty = False
        replayed = 0
        with self.vs.lock:
            if os.path.exists(sp):
                def seed(pairs):
                    for k, v in pairs:
                        self.vs.seed(bytes(k), bytes(v))

                legacy, clean = self._scan_log(sp, "snapshot", seed)
                legacy_any |= legacy
                # a corrupt snapshot tail must be folded away NOW, or
                # every restart re-hits (and re-warns about) the same
                # bad frame as if fresh corruption kept appearing
                snap_dirty = clean < os.path.getsize(sp)
            if os.path.exists(wp):
                def commit(pairs):
                    nonlocal replayed
                    writes = {
                        bytes(k): (None if v is None else bytes(v))
                        for k, v in pairs
                    }
                    self.vs.commit(writes, self.vs.snapshot())
                    replayed += 1

                legacy, clean = self._scan_log(wp, "wal", commit)
                legacy_any |= legacy
                wal_dirty = clean < os.path.getsize(wp)
        # fold the replayed log into the snapshot so restarts stay
        # O(data); also rewrites torn/corrupt tails and upgrades legacy
        # (pre-CRC) files to the checksummed format
        if replayed or legacy_any or wal_dirty or snap_dirty or (
            os.path.exists(wp)
            and os.path.getsize(wp) > self.WAL_COMPACT_BYTES
        ):
            self._compact()
        else:
            self.wal = open(wp, "ab")
            if self.wal.tell() == 0:
                self.wal.write(_LOG_MAGIC)
                self.wal.flush()

    def _compact(self):
        """Write the live keyspace to snapshot.kv and truncate the WAL."""
        sp, wp = self._snap_path(), self._wal_path()
        tmp = sp + ".tmp"
        with self.vs.lock:
            snap = self.vs.snapshot()
        try:
            with open(tmp, "wb") as f:
                f.write(_LOG_MAGIC)
                batch = []
                for k, v in self.vs.range_items(b"", b"\xff" * 9, snap,
                                                None, False):
                    batch.append([k, v])
                    if len(batch) >= 512:
                        f.write(_frame_crc(_encode(batch)))
                        batch = []
                if batch:
                    f.write(_frame_crc(_encode(batch)))
                f.flush()
                os.fsync(f.fileno())
        finally:
            self.vs.release(snap)
        os.replace(tmp, sp)
        # the rename must be durable BEFORE the WAL truncates — otherwise
        # a crash could pair the OLD snapshot with an EMPTY log
        dfd = os.open(self.data_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        if self.wal is not None:
            self.wal.close()
        self.wal = open(wp, "wb")
        self.wal.write(_LOG_MAGIC)
        self.wal.flush()
        os.fsync(self.wal.fileno())

    def log_commit(self, writes: dict):
        """Append one committed writeset to the WAL (with its crc32) —
        called BEFORE the client sees the ok, so an acknowledged commit
        survives a crash and corruption is detected at replay."""
        if self.wal is None:
            return
        fr = _frame_crc(_encode([[k, v] for k, v in writes.items()]))
        with self.wal_lock:
            self.wal.write(fr)
            self.wal.flush()
            if self.fsync:
                os.fsync(self.wal.fileno())
            if self.wal.tell() > self.WAL_COMPACT_BYTES:
                self._compact()

    def crash_close(self):
        """Simulated hard death: drop file handles without an orderly
        shutdown (per-commit flushes already reached the OS, matching
        what a SIGKILL leaves on disk) and halt the background loops.
        In-memory state is simply discarded by the caller."""
        self.engine_close()
        if self.wal is not None:
            try:
                self.wal.close()
            except OSError:
                pass
            self.wal = None


class StandaloneKvEngine(KvEngine):
    """A KvEngine with no socket server attached — the deterministic
    simulator's node: the sim transport delivers decoded request frames
    straight into `handle_frame` from virtual-time scheduler tasks."""

    def __init__(self, advertise: str, **kw):
        self._engine_init(advertise, **kw)


class KvServer(socketserver.ThreadingTCPServer, KvEngine):
    """The real KV service: KvEngine mounted on a ThreadingTCPServer."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, secret: Optional[str] = None,
                 data_dir: Optional[str] = None, fsync: bool = True,
                 role: str = "primary", peers: Optional[list[str]] = None,
                 self_index: Optional[int] = None,
                 auto_failover: bool = True,
                 failover_timeout_s: Optional[float] = None,
                 lease_ttl_s: Optional[float] = None,
                 join_existing: bool = False):
        socketserver.ThreadingTCPServer.__init__(self, addr, _KvHandler)
        self.conn_lock = threading.Lock()
        self.active_conns: set = set()
        host, port = self.server_address[:2]
        self._engine_init(
            f"{host}:{port}", secret=secret, data_dir=data_dir,
            fsync=fsync, role=role, peers=peers, self_index=self_index,
            auto_failover=auto_failover,
            failover_timeout_s=failover_timeout_s,
            lease_ttl_s=lease_ttl_s, join_existing=join_existing,
        )

    def server_close(self):
        self.engine_close()
        socketserver.ThreadingTCPServer.server_close(self)

    def kill(self):
        """Test helper: simulate hard process death in-process — stop
        the accept loop, halt every background thread, and sever every
        live connection mid-frame. The WAL is left exactly as a SIGKILL
        would leave it (no flush, no orderly shutdown)."""
        self.shutdown()
        self.server_close()
        with self.conn_lock:
            conns, self.active_conns = list(self.active_conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


def serve_kv(host="127.0.0.1", port=8100, block=True,
             secret: Optional[str] = None,
             data_dir: Optional[str] = None, fsync: bool = True,
             role: str = "primary", peers: Optional[list[str]] = None,
             self_index: Optional[int] = None,
             failover_timeout_s: Optional[float] = None,
             lease_ttl_s: Optional[float] = None) -> KvServer:
    if secret is None:
        secret = os.environ.get("SURREAL_KV_SECRET") or None
    if data_dir is None:
        data_dir = os.environ.get("SURREAL_KV_DATA_DIR") or None
    srv = KvServer((host, port), secret=secret, data_dir=data_dir,
                   fsync=fsync, role=role, peers=peers,
                   self_index=self_index,
                   failover_timeout_s=failover_timeout_s,
                   lease_ttl_s=lease_ttl_s)
    if block:
        # the bound port: `--bind host:0` takes a free one
        print(f"surrealdb-tpu kv service on {host}:{srv.server_address[1]}"
              + f" ({srv.role})"
              + (" (authenticated)" if secret else ""))
        srv.serve_forever()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


def _status_of(addr, secret, timeout: float = 1.0) -> Optional[dict]:
    """Probe one server's status; None when unreachable/unresponsive.
    (Real-transport convenience wrapper; seam-aware callers go through
    their Transport's `status_of`.)"""
    return net.REAL_TRANSPORT.status_of(addr, secret, timeout=timeout)


def _is_not_primary(e: BaseException) -> bool:
    return "kv not primary" in str(e)


def _is_wrong_shard(e: BaseException) -> bool:
    return "kv wrong shard epoch" in str(e)


def _is_follower_stale(e: BaseException) -> bool:
    return "kv follower too stale" in str(e)


def follower_reads_enabled() -> bool:
    return str(cnf.KV_FOLLOWER_READS).lower() not in ("off", "0",
                                                      "false", "no")


class _Pool:
    """Failover-aware connection pool. A transaction CHECKS OUT one
    connection for its whole lifetime (snapshot accounting correctness);
    short one-shot ops borrow + return per call.

    The pool tracks the believed-primary index into `addrs`; when a
    connection dies or a server answers "kv not primary", the pool is
    marked suspect and the next acquire runs a status sweep to locate
    the promoted primary. A primary change bumps the pool epoch, which
    poisons every pooled connection to the old primary."""

    def __init__(self, addrs, secret=None, size=64,
                 policy: Optional[RetryPolicy] = None, telemetry=None,
                 op_timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None,
                 transport: Optional[net.Transport] = None):
        if isinstance(addrs, tuple):
            addrs = [addrs]
        self.addrs: list[tuple[str, int]] = list(addrs)
        self.secret = secret
        self.size = size
        self.policy = policy or RetryPolicy()
        self.transport = transport or net.REAL_TRANSPORT
        self.telemetry = telemetry
        self.op_timeout = (cnf.KV_OP_TIMEOUT_S if op_timeout is None
                           else op_timeout)
        self.connect_timeout = (cnf.KV_CONNECT_TIMEOUT_S
                                if connect_timeout is None
                                else connect_timeout)
        self.q: queue.LifoQueue = queue.LifoQueue()
        self.count = 0
        self.lock = threading.Lock()
        self.primary_i = 0
        self.epoch = 0
        self._suspect = False
        # held across status probes — must come from the transport so
        # the simulator can park a task that blocks on it
        self.discover_lock = self.transport.make_lock()
        # -- follower reads (closed-timestamp bounded staleness) ----------
        # session-monotonic floor: the highest (closed_ts, era) any
        # follower pin through this pool has observed. Every later pin
        # must prove at least this much — one session's bounded-stale
        # reads never travel backwards in time, even across replicas
        # and elections.
        self.follower_floor: tuple[float, int] = (0.0, 0)
        self._f_rr = 0  # deterministic replica rotation cursor
        self._f_conns: dict = {}  # addr index -> [idle follower conns]
        # last follower-serving observation per member address — INFO
        # FOR SYSTEM's replication section reads this CACHE, never the
        # network (a sick cluster must not stall a diagnostic)
        self.repl_observed: dict = {}

    # -- telemetry ----------------------------------------------------------
    def _inc(self, name: str):
        if self.telemetry is not None:
            self.telemetry.inc(name)

    # -- failover -----------------------------------------------------------
    def _mark_suspect(self):
        # with a single configured address there is nothing to discover:
        # the reconnect itself is the probe (and the status round-trip
        # would only add latency to every transient drop)
        if len(self.addrs) > 1:
            self._suspect = True

    def _set_primary(self, i: int):
        with self.lock:
            if i != self.primary_i:
                self.primary_i = i
                self.epoch += 1  # old-primary conns are poison now
                self._inc("kv_failovers")
            self._suspect = False

    def _addr_index(self, addr_str) -> Optional[int]:
        if not addr_str or not isinstance(addr_str, str):
            return None
        try:
            a = _parse_addr(addr_str)
        except SdbError:
            return None
        try:
            return self.addrs.index(a)
        except ValueError:
            return None

    def _locate_primary(self):
        """One status sweep over the configured addresses; follows a
        replica's primary hint. Raises RetryableKvError when no primary
        answers (the caller's retry policy supplies the backoff)."""
        with self.discover_lock:
            if not self._suspect:
                return  # another thread already re-located the primary
            n = len(self.addrs)
            for step in range(n):
                i = (self.primary_i + step) % n
                st = self.transport.status_of(
                    self.addrs[i], self.secret,
                    timeout=self.connect_timeout,
                )
                if st is None:
                    continue
                if st.get("role") == "primary":
                    self._set_primary(i)
                    return
                j = self._addr_index(st.get("primary"))
                if j is not None and j != i:
                    st2 = self.transport.status_of(
                        self.addrs[j], self.secret,
                        timeout=self.connect_timeout,
                    )
                    if st2 is not None and st2.get("role") == "primary":
                        self._set_primary(j)
                        return
            raise RetryableKvError(
                "kv service unreachable: no primary among "
                + ",".join(f"{h}:{p}" for h, p in self.addrs)
            )

    # -- checkout/return ----------------------------------------------------
    def _fail(self, c: Optional[_Conn], e) -> RetryableKvError:
        """Shared transport-failure cleanup for a checked-out conn:
        drop it, mark the pool suspect, build the error to raise."""
        if c is not None:
            self.drop(c)
        self._mark_suspect()
        return RetryableKvError(f"kv connection lost: {e}")

    def _new_conn(self) -> _Conn:
        # snapshot (addr, epoch) together: reading them at different
        # times could tag a connection to the OLD primary with the NEW
        # epoch, letting it slip past the epoch poisoning
        with self.lock:
            addr = self.addrs[self.primary_i]
            epoch = self.epoch
        try:
            c = self.transport.connect(
                addr, self.secret, timeout=self.op_timeout,
                connect_timeout=self.connect_timeout,
            )
        except OSError as e:
            with self.lock:
                self.count -= 1
            self._mark_suspect()
            raise RetryableKvError(f"kv service unreachable: {e}")
        except BaseException:
            with self.lock:
                self.count -= 1
            raise
        c.epoch = epoch
        return c

    def acquire(self) -> _Conn:
        while True:
            try:
                c = self.q.get_nowait()
            except queue.Empty:
                break
            if c.epoch == self.epoch:
                return c
            self.drop(c)  # pooled conn to a demoted/old primary
        if self._suspect:
            self._locate_primary()  # raises RetryableKvError when down
        with self.lock:
            if self.count < self.size:
                self.count += 1
                create = True
            else:
                create = False
        if create:
            return self._new_conn()
        # Bounded wait: a statement can hold one pooled conn while
        # allocating a sequence batch on a second — blocking forever here
        # would deadlock the process at pool exhaustion. Wait in slices,
        # re-checking capacity: drop() frees a slot without queueing.
        deadline = self.policy.clock() + 30.0
        while True:
            try:
                # seam-owned wait: event-driven q.get for real sockets,
                # virtual-time parking under the simulator
                c = self.transport.queue_get(self.q, 0.25)
                if c.epoch == self.epoch:
                    return c
                self.drop(c)
            except queue.Empty:
                pass
            with self.lock:
                if self.count < self.size:
                    self.count += 1
                    create = True
                else:
                    create = False
                in_use = self.count
            if create:
                return self._new_conn()
            if self.policy.clock() >= deadline:
                raise SdbError(
                    f"kv connection pool exhausted ({in_use} in use; "
                    f"waited 30s)"
                )

    def release(self, c: _Conn):
        if c.epoch != self.epoch:
            self.drop(c)
            return
        self.q.put(c)

    def drop(self, c: _Conn):
        c.close()
        with self.lock:
            self.count -= 1

    def close(self):
        with self.lock:
            fconns, self._f_conns = self._f_conns, {}
        for conns in fconns.values():
            for c in conns:
                c.close()
        while True:
            try:
                c = self.q.get_nowait()
            except queue.Empty:
                return
            self.drop(c)

    # -- follower reads (bounded-staleness checkout) -------------------------
    # Follower connections live OUTSIDE the primary pool's accounting:
    # they are keyed by member index, never counted against `size`, and
    # never epoch-poisoned (a failover does not invalidate a replica
    # conn — the proof decides serve/reject, not the topology guess).

    #: an observation older than this is treated as unknown, so a
    #: replica that once looked stale gets re-probed instead of being
    #: starved forever off an aging cache entry
    FOLLOWER_OBS_TTL_S = 2.0

    def _follower_candidates(self) -> list[int]:
        """Member indexes to try for a follower pin — freshest-first by
        the observation cache (a replica whose last observed closed_ts
        is below the session floor would only burn a round trip on a
        guaranteed rejection), unknown/aged members optimistically
        first so they get probed, rotation breaking ties so load still
        spreads. The primary is the FALLBACK, tried separately through
        the normal pool."""
        with self.lock:
            p = self.primary_i
            n = len(self.addrs)
            start = self._f_rr
            self._f_rr += 1
            obs = {a: v["closed_ts"] for a, v in
                   self.repl_observed.items()
                   if net.wall() - v["at"] <= self.FOLLOWER_OBS_TTL_S}
        reps = [i for i in range(n) if i != p]
        if not reps:
            return []
        k = start % len(reps)
        reps = reps[k:] + reps[:k]

        def freshness(i):
            h, pt = self.addrs[i]
            # unknown/aged = +inf: optimistic, try it and learn
            return obs.get(f"{h}:{pt}", float("inf"))

        return sorted(reps, key=freshness, reverse=True)

    def _f_acquire(self, i: int):
        with self.lock:
            conns = self._f_conns.get(i)
            if conns:
                return conns.pop()
        c = self.transport.connect(
            self.addrs[i], self.secret, timeout=self.op_timeout,
            connect_timeout=self.connect_timeout,
        )
        c.follower_i = i
        return c

    def follower_release(self, c):
        with self.lock:
            conns = self._f_conns.setdefault(c.follower_i, [])
            if len(conns) < 8:
                conns.append(c)
                return
        c.close()

    def follower_drop(self, c):
        c.close()

    def _note_observation(self, i: int, closed: float, era: int):
        """Record a member's (closed, era) in the observation cache —
        candidate ordering + INFO FOR SYSTEM read it. Never touches
        the session floor (a REJECTION tells us about the member, not
        about anything this session has observed)."""
        h, p = self.addrs[i]
        with self.lock:
            self.repl_observed[f"{h}:{p}"] = {
                "closed_ts": float(closed), "era": int(era),
                "at": net.wall(),
            }

    def _note_follower(self, i: int, closed: float, era: int):
        with self.lock:
            self.follower_floor = (
                max(self.follower_floor[0], closed),
                max(self.follower_floor[1], era),
            )
        self._note_observation(i, closed, era)

    def lease_follower_snapshot(self, staleness_s: float,
                                min_epoch: int = 0):
        """Check out a connection AND pin a bounded-staleness read-only
        snapshot: each replica in rotation is asked to PROVE the
        requested timestamp closed under the session's (closed, era)
        floor (`snap_follower`); a second replica is the hedge against
        the first being slow/stale; the primary — whose proof is
        trivial — is the final fallback, through the normal
        failover-following pool. Returns (conn, snap, closed, follower).
        Raises FollowerTooStale when NOBODY could serve: stale data is
        never silently substituted."""
        from surrealdb_tpu_torch.err import FollowerTooStale

        def once():
            req_ts = max(net.wall() - float(staleness_s), 0.0)
            with self.lock:
                floor_c, floor_e = self.follower_floor
            for i in self._follower_candidates():
                try:
                    c = self._f_acquire(i)
                except (OSError, SdbError):
                    continue  # unreachable member: next candidate
                try:
                    snap, closed, era = c.call(
                        ["snap_follower", req_ts, floor_c, floor_e,
                         int(min_epoch)]
                    )
                except (ConnectionError, OSError):
                    self.follower_drop(c)
                    continue
                except SdbError as e:
                    # too stale / mid-promotion / auth: the CONN is
                    # healthy (the server answered) — keep it, move on.
                    # A stale rejection names the member's closed_ts:
                    # feed it to the candidate ordering so the next pin
                    # does not burn a round trip on the same rejection.
                    if _is_follower_stale(e):
                        m = re.search(r"closed=([0-9.]+) era=(-?\d+)",
                                      str(e))
                        if m is not None:
                            self._note_observation(
                                i, float(m.group(1)), int(m.group(2))
                            )
                    self.follower_release(c)
                    continue
                self._note_follower(i, float(closed), int(era))
                self._inc("follower_reads_served")
                return c, int(snap), float(closed), True
            # primary fallback (trivial proof; floor still enforced)
            self._inc("follower_read_fallbacks")
            c = self.acquire()
            try:
                snap, closed, era = c.call(
                    ["snap_follower", req_ts, floor_c, floor_e,
                     int(min_epoch)]
                )
            except (ConnectionError, OSError) as e:
                raise self._fail(c, e)
            except SdbError as e:
                if _is_not_primary(e):
                    raise self._fail(c, e)
                self.release(c)
                if _is_follower_stale(e):
                    # believed-primary is a stale replica: rediscover
                    self._mark_suspect()
                    raise FollowerTooStale(str(e))
                raise
            # the fallback read OBSERVES the primary's prefix: fold its
            # (closed, era) into the session floor like any follower
            # pin, or a later replica pin could legally serve a prefix
            # OLDER than what this session just saw (non-monotone) —
            # and an old-lineage replica could outlive an era bump the
            # session already observed
            with self.lock:
                self.follower_floor = (
                    max(self.follower_floor[0], float(closed)),
                    max(self.follower_floor[1], int(era)),
                )
            return c, int(snap), float(closed), False

        return self.policy.run(once, telemetry=self.telemetry)

    # -- one-shot ops with retry/failover -----------------------------------
    def _call_once(self, msg):
        c = self.acquire()
        try:
            out = c.call(msg)
        except (ConnectionError, OSError) as e:
            raise self._fail(c, e)
        except SdbError as e:
            if _is_not_primary(e):
                raise self._fail(c, e)
            self.release(c)
            raise
        except BaseException:
            self.release(c)
            raise
        self.release(c)
        return out

    def call(self, msg, policy: Optional[RetryPolicy] = None):
        return (policy or self.policy).run(
            lambda: self._call_once(msg), telemetry=self.telemetry
        )

    def lease_snapshot(self) -> tuple[_Conn, int]:
        """Check out a connection AND pin a snapshot on it, retrying
        through failover: a transaction starts against whichever server
        is primary when the policy converges."""

        def once():
            c = self.acquire()
            try:
                snap = c.call(["snap"])
            except (ConnectionError, OSError) as e:
                raise self._fail(c, e)
            except SdbError as e:
                if _is_not_primary(e):
                    raise self._fail(c, e)
                self.release(c)
                raise
            except BaseException:
                self.release(c)
                raise
            return c, snap

        return self.policy.run(once, telemetry=self.telemetry)


class RemoteTx(BackendTx):
    """Client transaction: server snapshot + local write overlay (mirror
    of MemTx with reads over the wire). Holds one pooled connection for
    its lifetime. Read-only transactions survive a primary failover by
    re-pinning a fresh snapshot on the new primary (documented weakening:
    the snapshot moves forward across the failover); write transactions
    abort with a RetryableKvError."""

    def __init__(self, backend: "RemoteBackend", write: bool,
                 max_staleness: Optional[float] = None,
                 min_shard_epoch: int = 0):
        # `done` first: if construction dies below, __del__ must not
        # trip on a half-built object (GC-time AttributeError)
        self.done = False
        self.writes: dict[bytes, Optional[bytes]] = {}
        self.savepoints: list[dict] = []
        self.conn: Optional[_Conn] = None
        self.snap = None
        self.pool = backend.pool
        self.write = write
        # bounded-staleness follower read: read-only only, and only
        # when the pool actually has replicas to offload onto. The
        # default (None) takes EXACTLY the old primary-pinned path.
        self.staleness = None if write else max_staleness
        self.min_shard_epoch = int(min_shard_epoch or 0)
        self.follower = False
        self.closed_ts: Optional[float] = None
        try:
            if self.staleness is not None \
                    and len(self.pool.addrs) > 1 \
                    and follower_reads_enabled():
                (self.conn, self.snap, self.closed_ts,
                 self.follower) = self.pool.lease_follower_snapshot(
                    self.staleness, self.min_shard_epoch
                )
            else:
                self.conn, self.snap = self.pool.lease_snapshot()
        except BaseException:
            self.done = True
            raise

    def _drop_conn(self):
        if self.conn is not None:
            if getattr(self.conn, "follower_i", None) is not None:
                self.pool.follower_drop(self.conn)
            else:
                self.pool.drop(self.conn)
            self.conn = None

    def _return_conn(self):
        if self.conn is not None:
            if getattr(self.conn, "follower_i", None) is not None:
                self.pool.follower_release(self.conn)
            else:
                self.pool.release(self.conn)
            self.conn = None

    def _fail_conn(self, c, e) -> RetryableKvError:
        """Transport-failure cleanup routing: a follower conn's death
        says nothing about the primary (no suspect mark, no pool-slot
        accounting); a pool conn takes the normal failover path."""
        if getattr(c, "follower_i", None) is not None:
            self.pool.follower_drop(c)
            return RetryableKvError(f"kv connection lost: {e}")
        return self.pool._fail(c, e)

    def _repin(self):
        """Re-pin this read-only transaction: follower transactions
        re-prove on the next candidate under the session floor (the
        snapshot only ever moves FORWARD); exact reads re-pin on the
        current primary."""
        self.pool._inc("kv_txn_failovers")
        if self.staleness is not None and len(self.pool.addrs) > 1 \
                and follower_reads_enabled():
            (self.conn, self.snap, self.closed_ts,
             self.follower) = self.pool.lease_follower_snapshot(
                self.staleness, self.min_shard_epoch
            )
        else:
            self.conn, self.snap = self.pool.lease_snapshot()

    def _call(self, build):
        """Run `build(snap)` against the pinned connection. On transport
        failure: writers abort retryably (their overlay is client-side,
        but the snapshot lineage is gone); readers fail over to the new
        primary transparently."""
        if self.conn is None:
            raise RetryableKvError("transaction connection lost")
        try:
            return self.conn.call(build(self.snap))
        except (ConnectionError, OSError, SdbError) as e:
            transport = not isinstance(e, SdbError) or _is_not_primary(e)
            if not transport:
                raise
            c, self.conn = self.conn, None
            err = self._fail_conn(c, e)
            if self.write:
                self.done = True
                raise RetryableKvError(
                    f"write transaction aborted and can be retried: {err}"
                )
            self._repin()
            try:
                return self.conn.call(build(self.snap))
            except (ConnectionError, OSError) as e2:
                self.done = True
                c, self.conn = self.conn, None
                raise self._fail_conn(c, e2)

    def _check(self):
        if self.done:
            raise SdbError("transaction is finished")

    def get(self, key: bytes) -> Optional[bytes]:
        self._check()
        if key in self.writes:
            return self.writes[key]
        return self._call(lambda snap: ["get", key, snap])

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
            items = self._call(
                lambda snap: ["range", beg, end, snap, limit, bool(reverse)]
            )
            for k, v in items:
                yield k, v
            return
        # overlay present: fetch the FULL committed range (a server-side
        # limit could truncate keys the overlay deletes/shadows), merge,
        # then apply the limit — mirror of MemTx.scan
        items = self._call(lambda snap: ["range", beg, end, snap, None,
                                         False])
        base = {k: v for k, v in items}
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
        if not self.writes:
            try:
                if self.conn is not None:
                    self.conn.call(["rel", snap])
            except (ConnectionError, OSError):
                was_follower = getattr(self.conn, "follower_i",
                                       None) is not None
                self._drop_conn()  # server released pins on disconnect
                if not was_follower:
                    self.pool._mark_suspect()
            finally:
                self._return_conn()
            return
        if self.conn is None:
            raise RetryableKvError(
                "kv connection lost before commit; transaction aborted "
                "and can be retried"
            )
        try:
            self.conn.call(
                ["commit", [[k, v] for k, v in self.writes.items()], snap]
            )
        except (ConnectionError, OSError) as e:
            c, self.conn = self.conn, None
            self.pool._fail(c, e)
            raise RetryableKvError(
                f"kv connection lost during commit; OUTCOME UNKNOWN — "
                f"retry only with idempotent writes: {e}"
            )
        except SdbError as e:
            if _is_not_primary(e):
                c, self.conn = self.conn, None
                self.pool._fail(c, e)
                raise RetryableKvError(
                    f"kv primary changed; transaction aborted and can be "
                    f"retried: {e}"
                )
            if "not replicated" in str(e):
                # the primary applied the write but refused the ack
                # (durability gate: no replica attached to receive it)
                self._return_conn()
                self.pool._mark_suspect()
                raise RetryableKvError(
                    f"kv commit unreplicated; OUTCOME UNKNOWN — retry "
                    f"only with idempotent writes: {e}"
                )
            self._return_conn()
            raise
        except BaseException:
            # even a KeyboardInterrupt must not leak the pool slot
            self._return_conn()
            raise
        self._return_conn()

    def prepare_2pc(self, txid: str, meta_addrs: list) -> None:
        """Phase 1 of a cross-shard commit (kvs/shard.py coordinator):
        ship the buffered writeset for validation + staging on this
        shard's primary. Consumes the snapshot exactly like commit; the
        sub-transaction is finished client-side afterwards — its fate is
        sealed by the coordinator's commit-log record and delivered via
        one-shot ["decide"] calls (which follow failovers)."""
        self._check()
        self.done = True
        snap, self.snap = self.snap, None
        if self.conn is None:
            raise RetryableKvError(
                "kv connection lost before prepare; transaction aborted "
                "and can be retried"
            )
        try:
            self.conn.call([
                "prepare", txid,
                [[k, v] for k, v in self.writes.items()], snap,
                list(meta_addrs),
            ])
        except (ConnectionError, OSError) as e:
            # outcome unknown: the prepare may have staged server-side.
            # The coordinator claims an ABORT record before giving up,
            # so an orphaned stage converges to abort via the resolver.
            c, self.conn = self.conn, None
            self.pool._fail(c, e)
            raise RetryableKvError(
                f"kv connection lost during prepare; transaction "
                f"aborted and can be retried: {e}"
            )
        except SdbError as e:
            if _is_not_primary(e):
                c, self.conn = self.conn, None
                self.pool._fail(c, e)
                raise RetryableKvError(
                    f"kv primary changed during prepare; transaction "
                    f"aborted and can be retried: {e}"
                )
            self._return_conn()
            raise  # conflict / wrong shard: surface to the coordinator
        except BaseException:
            self._return_conn()
            raise
        self._return_conn()

    def cancel(self):
        if self.done:
            return
        self.done = True
        self.writes.clear()
        snap, self.snap = self.snap, None
        try:
            if snap is not None and self.conn is not None:
                self.conn.call(["rel", snap])
        except (SdbError, ConnectionError, OSError):
            self._drop_conn()  # connection gone — server released pins
        finally:
            self._return_conn()

    def __del__(self):
        if not self.done:
            try:
                self.cancel()
            except Exception:
                pass


class RemoteBackend(Backend):
    """Client backend over one KV primary plus optional replicas.

    `addr` is `host:port` or a comma-separated replica-set list
    (`h1:p1,h2:p2,...`); the pool discovers which member is primary and
    follows promotions automatically."""

    def __init__(self, addr: str, secret: Optional[str] = None,
                 telemetry=None, policy: Optional[RetryPolicy] = None,
                 op_timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None,
                 transport: Optional[net.Transport] = None):
        addrs = [_parse_addr(a.strip())
                 for a in addr.split(",") if a.strip()]
        if not addrs:
            raise SdbError(
                f"remote:// address must be host:port[,host:port...], "
                f"got {addr!r}"
            )
        if secret is None:
            secret = os.environ.get("SURREAL_KV_SECRET") or None
        self.pool = _Pool(addrs, secret=secret, policy=policy,
                          telemetry=telemetry, op_timeout=op_timeout,
                          connect_timeout=connect_timeout,
                          transport=transport)
        self.lock = threading.RLock()
        # fail fast (bounded by the connect timeout, not the full retry
        # deadline) when no service member is reachable at construction.
        # Inherits clock/sleep/rng so simulated runs stay virtual-time.
        boot = RetryPolicy(
            deadline_s=min(self.pool.policy.deadline_s,
                           self.pool.connect_timeout),
            base_ms=self.pool.policy.base_ms,
            max_ms=self.pool.policy.max_ms,
            clock=self.pool.policy.clock,
            sleep=self.pool.policy.sleep,
            rng=self.pool.policy.rng,
        )
        self.pool.call(["ping"], policy=boot)

    #: Datastore checks this before forwarding a READ AT /
    #: max_staleness bound — local backends serve latest (trivially
    #: within any bound) and never see the parameter
    supports_staleness = True

    def transaction(self, write: bool,
                    max_staleness: Optional[float] = None,
                    min_shard_epoch: int = 0) -> RemoteTx:
        return RemoteTx(self, write, max_staleness=max_staleness,
                        min_shard_epoch=min_shard_epoch)

    def replication_info(self) -> dict:
        """Follower-read serving state for INFO FOR SYSTEM's
        `replication` section — served from the pool's OBSERVATION
        CACHE (each follower pin records the serving node's closed_ts
        and era), never from fresh network I/O: this is the diagnostic
        you read when the cluster is sick."""
        p = self.pool
        with p.lock:
            floor_c, floor_e = p.follower_floor
            observed = {a: dict(v) for a, v in p.repl_observed.items()}
            primary = p.addrs[p.primary_i]
        now = net.wall()
        for v in observed.values():
            v["observed_age_s"] = round(now - v.pop("at"), 3)
            v["closed_lag_s"] = round(max(now - v["closed_ts"], 0.0), 3)
            v["follower_serving"] = True
        return {
            "addrs": [f"{h}:{pt}" for h, pt in p.addrs],
            "primary": f"{primary[0]}:{primary[1]}",
            "floor_closed_ts": floor_c,
            "floor_era": floor_e,
            "observed": observed,
        }

    def replication_lag_s(self) -> float:
        """Worst observed closed-timestamp lag across members (gauge
        `repl_closed_ts_lag_s`); -1.0 before any follower read."""
        p = self.pool
        with p.lock:
            obs = [v["closed_ts"] for v in p.repl_observed.values()]
        if not obs:
            return -1.0
        return max(net.wall() - min(obs), 0.0)

    def close(self) -> None:
        self.pool.close()
