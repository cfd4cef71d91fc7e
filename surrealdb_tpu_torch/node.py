"""Cluster node registry, heartbeats, task leases, dead-node GC (the
reference package's `node.py`, without the KV service's own store-level
leases and sequence windows: the remote and sharded engines are not
ported).

Reference: core/src/dbs/node.rs:17-25 (node rows + heartbeat),
surrealdb/src/engine/tasks.rs:48-56 (membership refresh / check /
cleanup background loops), core/src/kvs/tasklease.rs:44 (single-winner
cluster task leases). Everything here coordinates THROUGH the KV — no
node-to-node RPC, exactly like the reference — and reads time through
the ambient clock of `kvs/net.py`.
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
