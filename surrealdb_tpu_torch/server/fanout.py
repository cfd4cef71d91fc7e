"""Non-blocking live-query fan-out (the reference package's
`server/fanout.py`; reference: the bounded `async_channel` owned by the
Datastore at ds.rs:118 plus the read/write-split WebSocket session actor
of rpc/websocket.rs:47).

Three stages, each decoupled by a bounded queue so a slow consumer can
never stall a committing writer:

1. **Capture** (write path, `exec/document.py::notify_lives`): when the
   subscription registry has any entry for the mutated `(ns, db, tb)`,
   the mutation is snapshotted into the transaction's `_live_events`
   buffer. No matching, no sockets, no handler calls — one index lookup
   and an append. Events publish only if the transaction COMMITS
   (`exec/executor.py`); a statement rolled back to its savepoint
   truncates its events.

2. **Dispatch** (post-commit workers): `FanoutHub.publish` shards the
   committed events by `(ns, db, tb)` across `LIVE_DISPATCH_WORKERS`
   queues — one table always lands on one worker, so every subscription
   observes its table's commits in commit order. Workers evaluate each
   subscription's condition/projection against the snapshotted docs
   (with a fresh read transaction for record access); an evaluation
   error poisons ONLY that subscription (typed ERROR notification,
   `live_eval_errors` counter) — never the write, which already
   committed.

3. **Delivery** (per-session writer threads): each WebSocket session
   registers a `SessionOutbox` — a bounded deque drained by a dedicated
   writer thread that coalesces bursts into one socket write
   (`LIVE_DELIVERY_BATCH` frames per sendall). Enqueue never blocks: a
   full queue triggers the slow-consumer policy (`SURREAL_LIVE_OVERFLOW`
   = notify | disconnect). Teardown (drain / KILL / disconnect) rides a
   `CancelEvent` whose waker pokes the writer's condition, so a parked
   writer unwinds immediately instead of at its next timeout.

Determinism: the hub also runs in **manual** mode (no threads) where
`pump_dispatch()` / `SessionOutbox.pump()` drive the same protocol code
synchronously, so a test can interleave the pumps itself and check the
delivery invariant: every committed matching write is delivered exactly
once in commit order, or the session is explicitly flagged overflowed.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.inflight import CancelEvent

OVERFLOW = "OVERFLOW"  # typed slow-consumer notification action
ERROR = "ERROR"  # typed poisoned-subscription notification action

# Registration/capture watermark: dispatch is ASYNC, so without it a
# subscription registered between an event's commit and its dispatch
# would receive an event from before it existed. Events stamp a sequence
# at capture; subscriptions stamp one at registration; dispatch skips
# events older than the subscription. itertools.count is atomic under
# the GIL.
_watermark = itertools.count(1)

_warned: set = set()
_warn_lock = threading.Lock()


def _warn_once(key: str, msg: str):
    with _warn_lock:
        if key in _warned:
            return
        _warned.add(key)
    import sys

    print(f"surrealdb-tpu: warning: {msg}", file=sys.stderr, flush=True)


class LiveEvent:
    """One committed mutation, snapshotted on the write path."""

    __slots__ = ("ns", "db", "tb", "rid", "before", "after", "action",
                 "seq")

    def __init__(self, ns, db, tb, rid, before, after, action):
        self.ns = ns
        self.db = db
        self.tb = tb
        self.rid = rid
        self.before = before
        self.after = after
        self.action = action  # CREATE | UPDATE | DELETE
        # stamped by FanoutHub.publish at COMMIT time: a subscription
        # registered while the writing transaction was still open must
        # receive the event (it committed after the registration), and
        # one registered after the commit must not (no history replay)
        self.seq = 0

    @property
    def table_key(self):
        return (self.ns, self.db, self.tb)


class SubscriptionRegistry:
    """Live subscriptions indexed by `(ns, db, tb)` — matching is a dict
    lookup, not a linear scan of every subscription on the node.

    Keeps the mapping surface of the plain dict it replaced
    (`ds.live_queries`): `len`, `in`, `get`, `pop`, `values`, ... all
    work, so telemetry and the KILL path are unchanged."""

    def __init__(self):
        self._lock = threading.RLock()
        self._subs: dict = {}  # lid -> SubscriptionDef
        self._by_table: dict = {}  # (ns,db,tb) -> {lid: sub}

    def __setitem__(self, lid, sub):
        sub._fanout_seq = next(_watermark)
        with self._lock:
            old = self._subs.get(lid)
            if old is not None:
                tb = self._by_table.get((old.ns, old.db, old.tb))
                if tb is not None:
                    tb.pop(lid, None)
            self._subs[lid] = sub
            self._by_table.setdefault(
                (sub.ns, sub.db, sub.tb), {}
            )[lid] = sub

    def pop(self, lid, default=None):
        with self._lock:
            sub = self._subs.pop(lid, None)
            if sub is None:
                return default
            tb = self._by_table.get((sub.ns, sub.db, sub.tb))
            if tb is not None:
                tb.pop(lid, None)
                if not tb:
                    del self._by_table[(sub.ns, sub.db, sub.tb)]
            return sub

    def get(self, lid, default=None):
        with self._lock:
            return self._subs.get(lid, default)

    def count_for(self, ns, db, tb) -> int:
        # the write-path fast gate: one dict lookup per mutated record
        t = self._by_table.get((ns, db, tb))
        return len(t) if t else 0

    def for_table(self, ns, db, tb) -> list:
        with self._lock:
            t = self._by_table.get((ns, db, tb))
            return list(t.values()) if t else []

    def clear(self):
        with self._lock:
            self._subs.clear()
            self._by_table.clear()

    def values(self):
        with self._lock:
            return list(self._subs.values())

    def items(self):
        with self._lock:
            return list(self._subs.items())

    def keys(self):
        with self._lock:
            return list(self._subs.keys())

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, lid):
        with self._lock:
            return lid in self._subs

    def __len__(self):
        return len(self._subs)

    def __bool__(self):
        return bool(self._subs)


class SessionOutbox:
    """One session's bounded outbound notification queue + its dedicated
    writer. `enqueue` is always non-blocking: a full queue triggers the
    overflow policy. The writer thread (real mode) or `pump()` (manual
    mode) drains batches toward `send_batch`."""

    __slots__ = ("hub", "send_batch", "close_conn", "label", "depth",
                 "policy", "lock", "cond", "q", "cancel", "lids",
                 "overflows", "dropped", "sent", "send_errors", "_thread")

    def __init__(self, hub, send_batch, close_conn=None, label="",
                 depth=None, policy=None):
        self.hub = hub
        self.send_batch = send_batch  # callable(list[Notification])
        self.close_conn = close_conn  # callable() forcing the socket down
        self.label = label
        self.depth = depth if depth is not None else cnf.LIVE_QUEUE_DEPTH
        self.policy = policy or cnf.LIVE_OVERFLOW_POLICY
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        self.q: deque = deque()
        # teardown flag: drain / disconnect / overflow-disconnect flip
        # it; the waker pokes the condition so a parked writer unwinds
        # immediately
        self.cancel = CancelEvent()
        self.cancel.add_waker(self._wake)
        self.lids: set = set()  # live ids bound to this session
        self.overflows = 0
        self.dropped = 0
        self.sent = 0
        self.send_errors = 0
        self._thread: Optional[threading.Thread] = None

    @property
    def closed(self) -> bool:
        return self.cancel.is_set()

    def _wake(self):
        with self.lock:
            self.cond.notify_all()

    # -- enqueue side (dispatch workers) ------------------------------------
    def enqueue(self, note) -> bool:
        """Queue one notification; never blocks. Returns False when the
        outbox is closed (caller drops the notification)."""
        kick = None
        with self.cond:
            if self.closed:
                return False
            if len(self.q) >= self.depth:
                kick = self._overflow_locked()
                if kick is None:
                    self.q.append(note)
                    self.cond.notify()
            else:
                self.q.append(note)
                # wake the writer only on the empty→non-empty edge: it
                # keeps popping batches while the queue is non-empty,
                # so a burst needs ONE futex wake, not one per note
                if len(self.q) == 1:
                    self.cond.notify()
        if kick is not None:
            # disconnect policy: the note died with the session — run
            # the socket close outside the lock
            kick()
        return kick is None

    def force_overflow(self):
        """Apply the overflow policy now (dispatch-backlog overload)."""
        with self.cond:
            if self.closed:
                return
            kick = self._overflow_locked()
        if kick is not None:
            kick()

    def _overflow_locked(self):
        """Overflow policy under self.lock. Returns a thunk to run
        outside the lock (disconnect), or None (notify policy)."""
        tel = self.hub.telemetry
        if self.policy == "disconnect":
            self.overflows += 1
            self.dropped += len(self.q)
            self.q.clear()
            if tel is not None:
                tel.inc("live_overflow_disconnects")
            self.cancel.set()  # waker notifies the writer

            def kick(close=self.close_conn):
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
            return kick
        # notify policy: drop the backlog, tell every bound live id.
        # Typed ERROR tombstones survive the reset — a poisoned
        # subscription's one-and-only death notice must not vanish into
        # the very overflow that delayed it.
        keep = [n for n in self.q if n.action == ERROR]
        n = len(self.q) - len(keep)
        self.q.clear()
        self.q.extend(keep)
        self.dropped += n
        self.overflows += 1
        if tel is not None:
            tel.inc("live_overflows")
        from surrealdb_tpu_torch.kvs.ds import Notification

        for lid in sorted(self.lids):
            self.q.append(Notification(lid, OVERFLOW, None,
                                       {"dropped": n}))
        self.cond.notify()
        return None

    # -- drain side (writer thread / manual pump) ---------------------------
    def _pop_batch_locked(self, max_n: int) -> list:
        batch = []
        while self.q and len(batch) < max_n:
            batch.append(self.q.popleft())
        return batch

    def pump(self, max_n: Optional[int] = None) -> int:
        """Manual-mode drain: deliver up to one batch synchronously.
        Returns the number of notifications sent."""
        with self.cond:
            batch = self._pop_batch_locked(
                max_n or cnf.LIVE_DELIVERY_BATCH
            )
        if not batch:
            return 0
        self._deliver(batch)
        return len(batch)

    def _deliver(self, batch: list):
        try:
            self.send_batch(batch)
            self.sent += len(batch)
        except Exception:
            # the session socket is gone (or the consumer's TCP window
            # slammed shut on close): this outbox is dead — the read
            # loop / sweep GCs the subscriptions
            self.send_errors += 1
            if self.hub.telemetry is not None:
                self.hub.telemetry.inc("live_send_errors")
            self.cancel.set()

    def _writer(self):
        while True:
            with self.cond:
                while not self.q and not self.closed:
                    self.cond.wait()
                batch = self._pop_batch_locked(cnf.LIVE_DELIVERY_BATCH)
                done = self.closed and not self.q and not batch
            if batch:
                self._deliver(batch)
                continue
            if done:
                return

    def start_writer(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._writer, daemon=True,
                name=f"surreal-live-writer-{self.label or hex(id(self))}",
            )
            self._thread.start()

    def close(self, flush: bool = False, timeout: float = 2.0):
        """Stop the outbox. With `flush`, give the writer up to
        `timeout` seconds to deliver what is already queued first."""
        if flush and self._thread is not None:
            end = time.monotonic() + timeout
            while self.q and time.monotonic() < end:
                time.sleep(0.005)
        with self.cond:
            if not flush:
                self.q.clear()
            self.cancel.set()

    def join(self, timeout: float = 2.0):
        if self._thread is not None:
            self._thread.join(timeout)

    def queue_len(self) -> int:
        return len(self.q)


class FanoutHub:
    """The fan-out spine owned by one Datastore: post-commit dispatch
    workers + session outbox routing + the in-process delivery surface
    (bounded `ds.notifications` + embedded handler callbacks)."""

    def __init__(self, ds, workers: Optional[int] = None,
                 manual: bool = False, runtime=None):
        self.ds = ds
        self.telemetry = getattr(ds, "telemetry", None)
        self.manual = manual
        self.nworkers = max(1, workers or cnf.LIVE_DISPATCH_WORKERS)
        self._qlock = threading.RLock()
        self._qcond = threading.Condition(self._qlock)
        # held across commit+publish of live-observed transactions
        # (executor.commit_and_publish): without it two racing writers
        # could publish in the opposite order of their commits and a
        # subscriber's last-seen state would diverge from the table
        self.commit_order_lock = threading.Lock()
        # per-worker wake conditions over the SAME lock: a publish only
        # wakes the workers whose queues received groups (the shared
        # _qcond is the flush/stop barrier)
        self._wconds = [threading.Condition(self._qlock)
                        for _ in range(self.nworkers)]
        # per-worker FIFO of (table_key, [LiveEvent]) groups; manual
        # mode collapses to worker 0 so pump order == publish order
        self._queues: list[deque] = [deque()
                                     for _ in range(self.nworkers)]
        self._outstanding = 0  # groups queued or being dispatched
        self._stopped = False
        self._started = False
        self._start_lock = threading.Lock()
        self._routes: dict = {}  # lid -> SessionOutbox
        self._sessions: list[SessionOutbox] = []
        self._notif_dropped = 0
        self._handler_errors = 0
        self._sweep_handle = None
        self._runtime = runtime
        if self.telemetry is not None:
            self.telemetry.register_gauge(
                "live_sessions",
                lambda: sum(1 for s in list(self._sessions)
                            if not s.closed),
            )
            self.telemetry.register_gauge(
                "live_dispatch_backlog",
                lambda: sum(len(q) for q in self._queues),
            )
            # drop/error tallies live as plain ints bumped on the
            # delivery path (no telemetry lock per note) and render as
            # counters at scrape time
            self.telemetry.register_counter(
                "notifications_dropped", lambda: self._notif_dropped
            )
            self.telemetry.register_counter(
                "notify_handler_errors", lambda: self._handler_errors
            )
        # resource governance: the dispatch backlog + session outboxes
        # are tracked push-path state. Their "eviction" is the typed
        # slow-consumer overflow policy (never silent), which is why
        # the `push` kind sits LAST in the eviction priority order —
        # every rebuildable cache goes first.
        from surrealdb_tpu_torch import resource as _resource

        self._mem_acct = _resource.register(
            "push", "live-fanout", self._mem_bytes,
            evict=self._mem_evict, owner=self,
        )

    # -- resource accounting ------------------------------------------------

    # estimated bytes per queued notification/event: payload dicts are
    # user-shaped, so this is an accounting constant, not a measurement
    NOTE_EST_BYTES = 512
    # estimated events per undispatched table-group (capture batches
    # are one transaction's writes; deep groups are rare)
    GROUP_EST_EVENTS = 8

    def _mem_bytes(self) -> int:
        # LOCK-FREE estimate: this runs inside every accountant
        # usage() poll — admission, sync checkpoints, /metrics — and
        # must never contend the dispatch lock or walk backlog event
        # lists. len(deque) and the int read are GIL-atomic; the list
        # snapshot tolerates racing (un)registration.
        queued = 0
        for s in tuple(self._sessions):
            queued += len(s.q)
        backlog_groups = max(self._outstanding, 0)
        return (queued + backlog_groups * self.GROUP_EST_EVENTS) \
            * self.NOTE_EST_BYTES

    def _mem_evict(self):
        """Accountant pressure: apply the overflow policy to the
        sessions holding the deepest queues (typed OVERFLOW per bound
        live id / disconnect — the client always learns it lost a
        window). The dispatch backlog keeps its own cap."""
        with self._qlock:
            sessions = sorted(
                (s for s in self._sessions if not s.closed),
                key=lambda s: -s.queue_len(),
            )
        for ob in sessions[:max(1, len(sessions) // 2)]:
            if ob.queue_len() > 0:
                ob.force_overflow()

    # -- publish (called post-commit by the executor) -----------------------
    def publish(self, events: list):
        """Hand a committed transaction's live events to the dispatch
        workers. Never blocks: past LIVE_DISPATCH_BACKLOG queued groups
        the backlog is dropped and affected subscriptions get a typed
        OVERFLOW (push overload must shed, not queue unboundedly)."""
        if not events:
            return
        # commit-time watermark: one stamp covers the whole transaction
        seq = next(_watermark)
        for ev in events:
            ev.seq = seq
        if len(events) == 1:  # the auto-commit single-write fast path
            k = events[0].table_key
            groups = [(k, events)]
            by_key = {k: events}
        else:
            groups = []  # preserve first-seen table order
            by_key = {}
            for ev in events:
                g = by_key.get(ev.table_key)
                if g is None:
                    g = by_key[ev.table_key] = []
                    groups.append((ev.table_key, g))
                g.append(ev)
        if not self.manual and not self._started:
            self._start_workers()
        overflowed_keys = None
        with self._qcond:
            if self._stopped:
                return
            backlog = sum(len(q) for q in self._queues)
            if backlog + len(groups) > cnf.LIVE_DISPATCH_BACKLOG:
                overflowed_keys = set(by_key)
                for q in self._queues:
                    for key, _g in q:
                        overflowed_keys.add(key)
                    self._outstanding -= len(q)
                    q.clear()
                if self.telemetry is not None:
                    self.telemetry.inc("live_dispatch_overflows")
            touched = set()
            for key, g in groups:
                w = 0 if self.manual \
                    else (hash(key) % self.nworkers)
                self._queues[w].append((key, g))
                touched.add(w)
            self._outstanding += len(groups)
            for w in touched:
                self._wconds[w].notify()
        if overflowed_keys:
            self._overflow_tables(overflowed_keys)

    def _overflow_tables(self, keys):
        """Dispatch-backlog overload: every outbox subscribed to an
        affected table takes an overflow reset."""
        reg = self.ds.live_queries
        hit = set()
        for ns, db, tb in keys:
            for sub in reg.for_table(ns, db, tb):
                ob = self._routes.get(sub.id)
                if ob is not None and id(ob) not in hit:
                    hit.add(id(ob))
                    ob.force_overflow()

    # -- dispatch workers ---------------------------------------------------
    def _start_workers(self):
        with self._start_lock:
            if self._started:
                return
            self._started = True
            for i in range(self.nworkers):
                threading.Thread(
                    target=self._worker, args=(i,), daemon=True,
                    name=f"surreal-live-dispatch-{i}",
                ).start()

    def _worker(self, i: int):
        q = self._queues[i]
        wcond = self._wconds[i]
        while True:
            # hold the condition we wait on — wcond wraps the shared
            # _qlock, so this is the same mutual exclusion as _qcond,
            # and the wait visibly releases the lock it holds
            with wcond:
                while not q and not self._stopped:
                    wcond.wait()
                if self._stopped and not q:
                    return
                key, events = q.popleft()
            try:
                self._dispatch_guarded(key, events)
            finally:
                with self._qcond:
                    self._outstanding -= 1
                    self._qcond.notify_all()

    def pump_dispatch(self, max_groups: int = 1) -> int:
        """Manual-mode dispatch: process up to `max_groups` queued
        table-groups synchronously. Returns groups processed."""
        n = 0
        while n < max_groups:
            with self._qcond:
                if not self._queues[0]:
                    break
                key, events = self._queues[0].popleft()
            try:
                self._dispatch_guarded(key, events)
            finally:
                with self._qcond:
                    self._outstanding -= 1
                    self._qcond.notify_all()
            n += 1
        return n

    def _dispatch_guarded(self, key, events: list):
        """A dispatch failure (read-txn open during a KV failover, a
        backend closing mid-flight) must never kill the worker thread —
        the group's subscribers get an honest OVERFLOW (they lost a
        window) and the worker lives to serve the next commit."""
        try:
            self._dispatch(key, events)
        except Exception:
            if self.telemetry is not None:
                self.telemetry.inc("live_dispatch_errors")
            try:
                self._overflow_tables({key})
            except Exception:
                pass

    def dispatch_backlog(self) -> int:
        with self._qlock:
            return sum(len(q) for q in self._queues)

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every published event has been matched and routed
        (NOT until sockets drained — per-session delivery stays async).
        Manual mode pumps inline. The drain_notifications() barrier."""
        if self.manual:
            while self.pump_dispatch(64):
                pass
            return True
        end = time.monotonic() + timeout
        with self._qcond:
            while self._outstanding > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._qcond.wait(left)
        return True

    # -- matching -----------------------------------------------------------
    @staticmethod
    def _is_trivial(sub) -> bool:
        """`LIVE SELECT * FROM tb` — no condition, whole-doc payload:
        the overwhelmingly common shape, dispatched without a Ctx, a
        session, or a read transaction."""
        if sub.cond is not None:
            return False
        e = sub.expr
        return e is None or (isinstance(e, list) and len(e) == 1
                             and e[0][0] == "*")

    def _dispatch(self, key, events: list):
        from surrealdb_tpu_torch.kvs.ds import Notification
        from surrealdb_tpu_torch.val import copy_value

        ns, db, tb = key
        reg = self.ds.live_queries
        subs = reg.for_table(ns, db, tb)
        if not subs:
            return
        # membership is re-checked once per GROUP (one transaction's
        # events), not per (sub, event): a KILL landing mid-group may
        # see up to the rest of that one batch, and in exchange a
        # 1000-subscriber table doesn't take the registry lock
        # subs×events times per commit
        alive = [s for s in subs if s.id in reg]
        txn = None  # opened lazily: only non-trivial subs need reads
        try:
            for ev in events:
                live = [s for s in alive
                        if getattr(s, "_fanout_seq", 0) <= ev.seq]
                if not live:
                    continue
                doc = ev.after if ev.action != "DELETE" else ev.before
                shared = len(live) == 1  # the capture snapshot is ours
                for sub in live:
                    if self._is_trivial(sub):
                        # fast path: the event already snapshotted the
                        # doc at capture; a lone subscriber can take it
                        # as-is, fan-out>1 copies per subscriber (the
                        # pre-spine per-sub-copy semantics)
                        payload = doc if shared else copy_value(doc)
                        self.deliver(Notification(
                            sub.id, ev.action, ev.rid, payload
                        ))
                        continue
                    if txn is None:
                        txn = self.ds.transaction(write=False)
                    try:
                        note = self._eval_subscription(sub, ev, txn)
                    except Exception as e:
                        self._poison(sub, e)
                        try:
                            alive.remove(sub)
                        except ValueError:
                            pass
                        continue
                    if note is not None:
                        self.deliver(note)
        finally:
            if txn is not None:
                try:
                    txn.cancel()
                except Exception:
                    pass

    def _eval_subscription(self, sub, ev: LiveEvent, txn):
        """Match one subscription against one committed event; returns a
        Notification or None. Ported from the old in-transaction
        doc-pipeline stage (doc/lives.rs:29 process_table_lives) — now
        running post-commit against snapshotted docs + a read txn."""
        from surrealdb_tpu_torch.exec.context import Ctx
        from surrealdb_tpu_torch.exec.eval import evaluate, is_truthy
        from surrealdb_tpu_torch.kvs.ds import Notification, Session
        from surrealdb_tpu_torch.val import copy_value

        doc = ev.after if ev.action != "DELETE" else ev.before
        sess = Session(ns=ev.ns, db=ev.db,
                       auth_level=sub.auth_level or "owner",
                       rid=sub.rid)
        ctx = Ctx(self.ds, sess, txn)
        c = ctx.with_doc(doc, ev.rid)
        c.vars.update(sub.session_vars)
        c.vars["before"] = ev.before
        c.vars["after"] = ev.after
        c.vars["event"] = ev.action
        if sub.cond is not None and not is_truthy(evaluate(sub.cond, c)):
            return None
        if sub.expr == "diff":
            from surrealdb_tpu_torch.utils.patch import diff

            payload = diff(
                ev.before if isinstance(ev.before, dict) else {},
                ev.after if isinstance(ev.after, dict) else {},
            )
        elif isinstance(sub.expr, list):
            if len(sub.expr) == 1 and sub.expr[0][0] == "*":
                payload = copy_value(doc)
            else:
                from surrealdb_tpu_torch.exec.statements import expr_name

                payload = {}
                for expr, alias in sub.expr:
                    if expr == "*":
                        if isinstance(doc, dict):
                            payload.update(copy_value(doc))
                        continue
                    payload[alias or expr_name(expr)] = evaluate(expr, c)
        else:
            payload = copy_value(doc)
        return Notification(sub.id, ev.action, ev.rid, payload)

    def _poison(self, sub, err: Exception):
        """A condition/projection error poisons ONLY this subscription:
        it is removed (typed + counted), its session is told, and the
        committed write is untouched (it already committed)."""
        from surrealdb_tpu_torch.kvs.ds import Notification

        if self.telemetry is not None:
            self.telemetry.inc("live_eval_errors")
        self.ds.live_queries.pop(sub.id, None)
        try:
            txn = self.ds.transaction(write=True)
            try:
                from surrealdb_tpu_torch import key as K

                txn.delete(K.lq_def(sub.ns, sub.db, sub.tb, sub.id))
                txn.commit()
            except Exception:
                txn.cancel()
        except Exception:
            pass
        self.deliver(Notification(sub.id, ERROR, None,
                                  f"live query failed: {err}"))
        self.unbind(sub.id)

    # -- delivery (the enqueue-only Datastore.notify target) ----------------
    def deliver(self, note):
        """Route one notification: bounded in-proc buffer, embedded
        handler callbacks (counted, never trusted), bound session
        outbox. Runs on a dispatch worker — never on a writer's commit
        path, and never does socket I/O itself."""
        ds = self.ds
        ob = self._routes.get(note.live_id)
        # the in-process buffer serves EMBEDDED consumers
        # (drain_notifications); a note routed to a session outbox is
        # delivered there — buffering it too would pin payloads forever
        # on a served node where nothing ever drains, then read healthy
        # delivery as drops once the cap hits
        dropped = False
        if ob is None:
            # under ds.lock: bounded buffer bookkeeping ONLY — no
            # handler calls, no counters, no I/O (rule 7)
            with ds.lock:
                dropped = len(ds.notifications) >= cnf.NOTIFY_BUFFER_CAP
                if not dropped:
                    ds.notifications.append(note)
        handlers = list(ds.notification_handlers)
        if dropped:
            self._notif_dropped += 1
            _warn_once(
                "notif-cap",
                f"in-process notification buffer full "
                f"(NOTIFY_BUFFER_CAP={cnf.NOTIFY_BUFFER_CAP}); "
                f"dropping — call drain_notifications() or subscribe "
                f"over a session",
            )
        for h in handlers:
            try:
                h(note)
            except Exception as e:
                self._handler_errors += 1
                _warn_once(
                    f"handler-{type(e).__name__}",
                    f"notification handler raised "
                    f"{type(e).__name__}: {e}",
                )
        if ob is not None:
            ob.enqueue(note)

    # -- session registration / routing -------------------------------------
    def register_session(self, send_batch, close_conn=None, label="",
                         depth=None, policy=None) -> SessionOutbox:
        ob = SessionOutbox(self, send_batch, close_conn=close_conn,
                           label=label, depth=depth, policy=policy)
        with self._qlock:
            self._sessions.append(ob)
        if not self.manual:
            ob.start_writer()
            self._ensure_sweep()
        return ob

    def unregister_session(self, ob: SessionOutbox,
                           flush: bool = False):
        ob.close(flush=flush)
        with self._qlock:
            for lid in list(ob.lids):
                if self._routes.get(lid) is ob:
                    del self._routes[lid]
            ob.lids.clear()
            try:
                self._sessions.remove(ob)
            except ValueError:
                pass

    def bind(self, lid: str, ob: SessionOutbox):
        lid = str(lid)
        with self._qlock:
            self._routes[lid] = ob
            ob.lids.add(lid)

    def unbind(self, lid: str):
        lid = str(lid)
        with self._qlock:
            ob = self._routes.pop(lid, None)
            if ob is not None:
                ob.lids.discard(lid)

    # -- dead-session sweep (satellite: the live-query leak) ----------------
    def _ensure_sweep(self):
        from surrealdb_tpu_torch.kvs import net

        def tick():
            # Runtime.every interprets a NUMERIC return as the next
            # delay — returning the collected count here would spin
            # the loop hot at delay=0
            self.sweep_dead_sessions()

        # under _start_lock: two racing session registrations must not
        # start two sweep loops (only the stored handle gets cancelled)
        with self._start_lock:
            if self._sweep_handle is not None:
                return
            rt = self._runtime or net.REAL_RUNTIME
            self._sweep_handle = rt.every(
                cnf.LIVE_SWEEP_INTERVAL_S, tick,
                name="surreal-live-sweep",
            )

    def sweep_dead_sessions(self) -> int:
        """GC live queries bound to outboxes that died without KILL
        (the session-close path normally handles this; the sweep is the
        backstop for sessions torn down non-gracefully). Returns the
        number of live queries collected."""
        with self._qlock:
            dead = [lid for lid, ob in self._routes.items() if ob.closed]
            self._sessions = [s for s in self._sessions if not s.closed]
        if dead:
            self.ds.gc_session_lives(dead)
        return len(dead)

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: float = 5.0) -> bool:
        """Flush dispatch, then give each session writer a chance to
        deliver its queue before teardown (the SIGTERM drain path)."""
        ok = self.flush(timeout)
        with self._qlock:
            sessions = list(self._sessions)
        for ob in sessions:
            ob.close(flush=True, timeout=max(timeout / 2, 0.5))
        return ok

    def close_all(self):
        """Hard stop: dispatch workers exit, session writers wake and
        unwind (CancelEvent wakers — immediate, not next-timeout)."""
        with self._qcond:
            self._stopped = True
            for q in self._queues:
                self._outstanding -= len(q)
                q.clear()
            self._qcond.notify_all()
            for wc in self._wconds:
                wc.notify_all()
        with self._qlock:
            sessions = list(self._sessions)
            self._sessions = []
            self._routes.clear()
        for ob in sessions:
            ob.close()
        if self._sweep_handle is not None:
            self._sweep_handle.cancel()
            self._sweep_handle = None
        self._mem_acct.close()

    def stats(self) -> dict:
        with self._qlock:
            sessions = list(self._sessions)
        return {
            "sessions": sum(1 for s in sessions if not s.closed),
            "dispatch_backlog": self.dispatch_backlog(),
            "routes": len(self._routes),
            "notif_dropped": self._notif_dropped,
            "handler_errors": self._handler_errors,
            "overflows": sum(s.overflows for s in sessions),
            "sent": sum(s.sent for s in sessions),
        }
