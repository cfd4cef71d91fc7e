"""Cluster node registry, heartbeats, task leases, dead-node GC, and
the KV service's own store-level leases and TSO windows (the reference
package's `node.py`).

Reference: core/src/dbs/node.rs:17-25 (node rows + heartbeat),
surrealdb/src/engine/tasks.rs:48-56 (membership refresh / check /
cleanup background loops), core/src/kvs/tasklease.rs:44 (single-winner
cluster task leases). Nodes are stateless database processes over the
shared KV (kvs/remote.py); everything here coordinates THROUGH the KV —
no node-to-node RPC, exactly like the reference — and reads time
through the ambient clock of `kvs/net.py`.
"""

from __future__ import annotations

import threading
import uuid

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.kvs import net
from surrealdb_tpu_torch.err import SdbError


class TaskLease:
    """Single-winner cluster lease: a named KV row (holder, expiry).
    `try_acquire` wins only when the row is absent or expired — losers
    skip the task this round. Optimistic commit conflicts mean some OTHER
    node won the race, which is also a loss."""

    def __init__(self, ds, name: str, ttl_s: float = 30.0):
        self.ds = ds
        self.name = name
        self.ttl_s = ttl_s

    def try_acquire(self) -> bool:
        txn = self.ds.transaction(write=True)
        try:
            now = net.wall()
            row = txn.get_val(K.task_lease(self.name))
            if row is not None:
                holder, expiry = row
                if holder != self.ds.node_id and expiry > now:
                    txn.cancel()
                    return False
            txn.set_val(
                K.task_lease(self.name), (self.ds.node_id, now + self.ttl_s)
            )
            txn.commit()
            return True
        except SdbError:
            txn.cancel()
            return False


# -- store-level leases (KV-service failover) -------------------------------
# The KV primary/replica layer (kvs/remote.py) rides the SAME lease rows
# as TaskLease, but operates on a raw VersionedStore: the KV service IS
# the coordination substrate, so its own election can't go through a
# Datastore client. Row format is identical — (holder, expiry) under
# K.task_lease(name) — which means DB-level observers can read the KV
# primary lease with ordinary transactions.

KV_PRIMARY_LEASE = "kv-primary"


def store_lease_read(vs, name: str):
    """Read (holder, expiry) for a lease row straight off a
    VersionedStore, or None when absent."""
    from surrealdb_tpu_torch.kvs.api import deserialize

    snap = vs.snapshot()
    try:
        raw = vs.read(K.task_lease(name), snap)
    finally:
        vs.release(snap)
    if raw is None:
        return None
    try:
        row = deserialize(raw)
        return (row[0], float(row[1]))
    except Exception:
        return None


def store_lease_acquire(vs, name: str, holder: str, ttl_s: float) -> bool:
    """Single-winner lease acquire/renew over a raw VersionedStore:
    wins only when the row is absent, expired, or already ours; an
    optimistic commit conflict means another contender won the race.
    Same semantics as TaskLease.try_acquire, one layer down."""
    from surrealdb_tpu_torch.kvs.api import deserialize, serialize

    now = net.wall()
    key = K.task_lease(name)
    snap = vs.snapshot()
    committing = False
    try:
        raw = vs.read(key, snap)
        if raw is not None:
            try:
                row = deserialize(raw)
                cur_holder, expiry = row[0], float(row[1])
            except Exception:
                cur_holder, expiry = None, 0.0  # corrupt row: claimable
            if cur_holder is not None and cur_holder != holder \
                    and expiry > now:
                return False
        # commit() releases the snapshot itself, success OR conflict —
        # releasing again could drop another txn's pin at the same version
        committing = True
        vs.commit({key: serialize((holder, now + ttl_s))}, snap)
        return True
    except SdbError:
        return False
    finally:
        if not committing:
            vs.release(snap)


# -- TSO sequence windows (sharded versionstamps) ---------------------------
# A sharded datastore can't run per-node HLC versionstamps: two nodes'
# clocks would interleave inconsistently across shards and break SHOW
# CHANGES ordering. Instead every node leases a WINDOW of stamps from a
# single counter row on the meta shard (PD-style TSO, reference role:
# PD's timestamp oracle). Window starts embed wall-clock millis in the
# same [44-bit ms | 20-bit counter] layout as the HLC, so stamps remain
# comparable to datetime-derived changefeed bounds.

KV_TSO_KEY = b"\x00!tso"  # meta-shard counter row: last handed-out stamp


def lease_tso_window(txn_factory, n: int, retries: int = 32):
    """Allocate `n` globally-unique, strictly-increasing versionstamps
    via one optimistic read-bump-commit on the meta shard. Returns
    [start, end) — windows never overlap, and a window start never
    regresses below wall-clock millis << 20. Conflicts (other nodes
    refilling concurrently) retry bounded; transport errors surface
    through the caller's retry policy."""
    last_err = None
    for _attempt in range(retries):
        txn = txn_factory()
        try:
            raw = txn.get(KV_TSO_KEY)
            last = int(raw.decode()) if raw else 0
            start = max(int(net.wall() * 1000) << 20, last + 1)
            txn.set(KV_TSO_KEY, str(start + n).encode())
            txn.commit()
            return start, start + n
        except SdbError as e:
            try:
                txn.cancel()
            except SdbError:
                pass
            if "conflict" not in str(e).lower():
                raise
            last_err = e
    raise SdbError(
        f"kv tso: window lease lost {retries} optimistic races; "
        f"last error: {last_err}"
    )


def heartbeat(ds) -> None:
    """Write this node's registry row: (last-seen ts, device state).
    The device state rides the heartbeat so cluster-level monitoring
    sees which nodes are serving accelerated paths and which have
    degraded to host execution (device/supervisor.py states). Legacy
    bare-float rows are still read by membership_check."""
    from surrealdb_tpu_torch.device import get_supervisor

    txn = ds.transaction(write=True)
    try:
        txn.set_val(
            K.node(ds.node_id), (net.wall(), get_supervisor().state)
        )
        txn.commit()
    except SdbError:
        txn.cancel()


def _hb_ts(row) -> float:
    """Heartbeat timestamp from a registry row (tuple or legacy float)."""
    if isinstance(row, (tuple, list)) and row:
        return float(row[0])
    try:
        return float(row)
    except (TypeError, ValueError):
        return 0.0


def membership_check(ds, stale_s: float = 30.0) -> list[str]:
    """Expire nodes whose heartbeat is older than `stale_s` and GC their
    persisted live-query registrations (reference: tasks.rs cleanup +
    node.rs archive/delete). Returns the expired node ids."""
    lease = TaskLease(ds, "membership_check", ttl_s=stale_s / 2)
    if not lease.try_acquire():
        return []
    now = net.wall()
    txn = ds.transaction(write=True)
    try:
        dead = []
        for k, seen in txn.scan_vals(*K.prefix_range(K.node_prefix())):
            nid, _ = K.dec_str(k, len(K.node_prefix()))
            if nid != ds.node_id and now - _hb_ts(seen) > stale_s:
                dead.append(nid)
                txn.delete(k)
        if dead:
            dead_set = set(dead)
            # drop dead nodes' live queries wherever they registered them
            beg, end = K.prefix_range(b"/!lq")
            for k, sub in list(txn.scan_vals(beg, end)):
                if getattr(sub, "node", None) in dead_set:
                    txn.delete(k)
        txn.commit()
        return dead
    except SdbError:
        txn.cancel()
        return []


class NodeTasks:
    """Background loops: heartbeat + membership check + changefeed GC
    hook. Started by served/clustered datastores (reference engine
    tasks); embedded single-process datastores don't need them."""

    def __init__(self, ds, interval_s: float = 10.0, stale_s: float = 30.0):
        self.ds = ds
        self.interval_s = interval_s
        self.stale_s = stale_s
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return
        heartbeat(self.ds)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="surreal-node-tasks"
        )
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                heartbeat(self.ds)
                membership_check(self.ds, self.stale_s)
            except Exception:
                pass  # KV hiccups must not kill the loop; next tick retries

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # deregister so peers don't wait out the stale window
        txn = self.ds.transaction(write=True)
        try:
            txn.delete(K.node(self.ds.node_id))
            txn.commit()
        except SdbError:
            txn.cancel()


def make_node_id() -> str:
    return str(uuid.uuid4())
