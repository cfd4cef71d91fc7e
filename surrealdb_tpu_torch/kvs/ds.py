"""Datastore facade (the reference package's `kvs/ds.py`, trimmed to the
embedded datastore the port runs).

A `Datastore` owns its storage backend (`memory`: the in-memory MVCC
store; `file://path` or `skv://path`: the same store over a WAL and a
snapshot in that directory), the catalog cache, the parsed-statement
cache and the engine caches: `vector_indexes` ((ns, db, tb, ix) ->
TpuVectorIndex), `index_builds` (background `DEFINE INDEX` builds),
`graph_engine` ((ns, db, node_tb, edge_tb, dir) -> CsrGraph),
`graph_versions` ((ns, db, tb) -> write counter), the full-text result
cache (`_ft_cache`, a `resource.BudgetedLRU` registered with the memory
accountant) and the columnar caches of `exec/batch.py` and `col.py`. A file-backed store keeps its
engines' persisted ANN graphs in `ann_snapshot_dir`
(`<store>/.ann-cache`), so a restart reloads them instead of rebuilding.
`ml_cache` holds the parsed models of `ml::` calls, and `slow_log` the
statements that took `SURREAL_SLOW_QUERY_THRESHOLD_MS` or longer (INFO
FOR SYSTEM lists its last 50).

`execute()` parses SurrealQL (with a cache of parsed texts) and runs the
statement loop of `exec/executor.py`, under a `QueryHandle` of the
datastore's in-flight registry; the device supervisor reads that handle's
budget and cancellation, and records its `device_rpc` stage, through
`bind_serving`. The supervisor itself starts on the first query that
needs the card.

The live half: `live_queries` (a `server.fanout.SubscriptionRegistry`,
indexed by table), the fan-out hub `fanout` (post-commit dispatch and
per-session outboxes), the bounded in-process buffer `notifications`
with `drain_notifications()`, the embedded `notification_handlers`, and
`gc_session_lives` for a session that went away without KILL. A served
datastore starts the node's heartbeat and membership tasks
(`start_node_tasks`, `node.py`). Changefeeds and the remote, sharded
and LSM engines are not ported.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import NotPorted, SdbError
from surrealdb_tpu_torch.kvs.api import Transaction


class Session:
    """Per-connection session (reference: dbs/session.rs)."""

    def __init__(self, ns=None, db=None, auth_level="none", rid=None, ac=None):
        self.ns = ns
        self.db = db
        self.auth_level = auth_level  # owner | editor | viewer | record | none
        self.rid = rid  # record-auth identity (RecordId)
        self.ac = ac  # access method name
        self.token = None  # verified JWT claims ($token / $session.tk)
        # the base the authenticated principal is scoped to: root | ns | db
        self.auth_base = "root"
        # a secured server's session: while anonymous (auth level none)
        # its statements fail the IAM check unless guests are allowed
        self.guests_refused = False
        self.planner_strategy = None  # None | "all-ro" | "compute-only"
        self.redact_volatile_explain_attrs = False
        self.import_mode = False  # OPTION IMPORT: DEFINEs overwrite
        # session-level follower-read default (seconds): a local store
        # serves the latest state, which is within any bound
        self.max_staleness: Optional[float] = None
        self.variables: dict[str, Any] = {}

    @property
    def is_owner(self):
        return self.auth_level == "owner"


class Notification:
    """A live-query notification (CREATE/UPDATE/DELETE action on a record)."""

    __slots__ = ("live_id", "action", "record", "result")

    def __init__(self, live_id, action, record, result):
        self.live_id = live_id
        self.action = action  # CREATE | UPDATE | DELETE
        self.record = record  # RecordId
        self.result = result  # value payload

    def __repr__(self):
        return f"Notification({self.action} {self.record} -> {self.result!r})"


class QueryResult:
    """One statement's outcome."""

    __slots__ = ("result", "error", "time_ns", "partial")

    def __init__(self, result=None, error: Optional[str] = None, time_ns: int = 0):
        self.result = result
        self.error = error
        self.time_ns = time_ns
        self.partial = None  # a sharded KNN's missing shards (not ported)

    @property
    def ok(self):
        return self.error is None

    def unwrap(self):
        if self.error is not None:
            raise SdbError(self.error)
        return self.result

    def __repr__(self):
        if self.error is not None:
            return f"QueryResult(error={self.error!r})"
        return f"QueryResult({self.result!r})"


def _bind_serving():
    """Plug this package's in-flight registry and stage timer into the
    device supervisor, unless a caller has bound a serving stack of its
    own: a query's budget and cancellation reach its device dispatches,
    the batcher wakes a parked rider through the query's handle, and
    each dispatch is timed as the `device_rpc` stage."""
    from surrealdb_tpu_torch.device import supervisor as SV

    if SV.serving_bound():
        return
    from surrealdb_tpu_torch import inflight, telemetry

    SV.bind_serving(remaining=inflight.remaining,
                    cancelled=inflight.cancelled,
                    stage_record=telemetry.stage_record,
                    current=inflight.current)


class Datastore:
    """An embedded datastore over one storage backend: `memory` or a
    directory (`file://path`, `skv://path`)."""

    STORAGE_VERSION = 1  # on-disk format version (reference kvs/version/)

    def __init__(self, path: str = "memory", strict: bool = False,
                 capabilities=None, check_version: bool = True):
        from surrealdb_tpu_torch.capabilities import Capabilities
        from surrealdb_tpu_torch.inflight import InflightRegistry
        from surrealdb_tpu_torch.telemetry import Telemetry

        self.path = path
        self.strict = strict
        self.capabilities = capabilities or Capabilities.from_env()
        self.telemetry = Telemetry()
        # persisted ANN artifacts (idx/cagra.py save_index): only a
        # disk-backed store has a place for them
        self.ann_snapshot_dir = None
        if path in ("memory", "mem://", "mem", "pymem", "pymem://"):
            from surrealdb_tpu_torch.kvs.mem import MemBackend

            self.backend = MemBackend()
        elif path.startswith("file://") or path.startswith("skv://"):
            from surrealdb_tpu_torch.kvs.file import FileBackend

            store = path.split("://", 1)[1]
            self.backend = FileBackend(store)
            base = store if os.path.isdir(store) \
                else os.path.dirname(os.path.abspath(store))
            # beside the data: a restart reloads a graph build in seconds
            self.ann_snapshot_dir = os.path.join(base, ".ann-cache")
        else:
            raise NotPorted(f"datastore path {path!r} is not ported "
                            f"(only 'memory', 'file://' and 'skv://')")
        self.lock = threading.RLock()
        # live subscriptions, indexed by (ns,db,tb): the write path
        # gates on count_for() instead of scanning every subscription
        from surrealdb_tpu_torch.server.fanout import (
            FanoutHub,
            SubscriptionRegistry,
        )

        self.live_queries = SubscriptionRegistry()
        self.notifications: list[Notification] = []  # in-proc, bounded
        self.notification_handlers: list = []  # callables(Notification)
        # the notification fan-out spine: post-commit dispatch workers +
        # per-session bounded outboxes (threads spawn lazily on first
        # publish: a datastore that never runs LIVE pays nothing)
        self.fanout = FanoutHub(self)
        self.vector_indexes: dict = {}
        self.index_builds: dict = {}  # (ns,db,tb,ix) -> building status
        self.graph_engine = None
        self.graph_versions: dict = {}
        # (ns, db, name) -> [next, end): the id range this node claimed
        # from a sequence's state row (fnc/misc_fns.py sequence::nextval)
        self.sequences: dict = {}
        # full-text result cache: bounded LRU (entry + byte caps), so a
        # hot mixed read/write table does not keep one dead entry per
        # write version; registered with the memory accountant below
        from surrealdb_tpu_torch import resource as _resource

        self._ft_cache = _resource.BudgetedLRU(cnf.FT_CACHE_ENTRIES,
                                               cnf.FT_CACHE_BYTES)
        self._mem_ft = _resource.register(
            "ft", "ft-cache", self._ft_cache_bytes,
            evict=self._ft_cache_evict, owner=self,
        )
        self.telemetry.register_counter(
            "ft_cache_evictions", lambda: self._ft_cache.evictions
        )
        self.metrics = {
            "transactions": 0, "commits": 0, "cancels": 0,
            "statements": 0, "statement_errors": 0, "slow_queries": 0,
        }
        # the slow-query log (reference kvs/slowlog.rs): statements at or
        # past the threshold, as (ms, label) pairs; 0 turns it off
        try:
            self.slow_log_threshold_ms = float(
                os.environ.get("SURREAL_SLOW_QUERY_THRESHOLD_MS", "0") or 0
            )
        except ValueError:
            self.slow_log_threshold_ms = 0.0
        self.slow_log: list = []
        # parsed models of `ml::` calls: (ns, db, name, version, hash) ->
        # SurmlFile (ml/__init__.py compute_model)
        self.ml_cache: dict = {}
        # parsed-statement cache: repeated query texts (same SQL,
        # different $vars) skip the parser; ASTs hold no execution state
        self._ast_cache: dict = {}
        self._ast_cache_cap = cnf.AST_CACHE_SIZE
        # cluster identity (reference dbs/node.rs); the heartbeat and
        # membership loops start only for a served datastore
        from surrealdb_tpu_torch.node import make_node_id

        self.node_id = make_node_id()
        self.node_tasks = None
        self.inflight = InflightRegistry(self.telemetry)
        # the device supervisor's health gauges and the memory
        # accountant's, for /metrics (closures: registering spawns
        # nothing)
        from surrealdb_tpu_torch.device import attach_telemetry

        attach_telemetry(self.telemetry)
        _resource.attach_telemetry(self.telemetry)
        self._hlc_wall = 0  # HLC: last physical millis issued
        self._hlc_count = 0  # HLC: logical counter within the millisecond
        # columnar executor state (exec/batch.py) and brute-scan vector
        # columns (col.py): caches over the record keyspace
        self._table_columns: dict = {}
        self._vector_columns: dict = {}
        # statement-scoped RNG (ORDER BY RAND)
        import random as _rnd

        self.rng = _rnd.Random()
        from surrealdb_tpu_torch.exec.batch import counters as _col_counters

        self._columnar_counters = _col_counters(self)
        # shared decoded-catalog cache (version, dict)
        self._catalog_ver = 0
        self._catalog_shared = (0, {})
        self._stamp_storage_version(check_version)

    # -- resource accounting (resource.py) ------------------------------------
    def _ft_cache_bytes(self) -> int:
        return int(self._ft_cache.nbytes)

    def _ft_cache_evict(self):
        # drop the coldest half: the next identical search re-runs the
        # posting walk (a pure cache: the KV truth is untouched)
        self._ft_cache.shrink(0.5)

    def start_node_tasks(self, interval_s: float = 10.0,
                         stale_s: float = 30.0):
        """Start heartbeat + membership-check loops (reference
        engine/tasks.rs:48-56). Idempotent."""
        from surrealdb_tpu_torch.node import NodeTasks

        if self.node_tasks is None:
            self.node_tasks = NodeTasks(self, interval_s, stale_s)
            self.node_tasks.start()
        return self.node_tasks

    # -- transactions -------------------------------------------------------
    def transaction(self, write: bool = True,
                    max_staleness: Optional[float] = None) -> Transaction:
        """Open a transaction. A local store serves the latest state,
        so `max_staleness` never changes what a read sees."""
        self.metrics["transactions"] += 1
        with self.lock:
            t = Transaction(self.backend.transaction(write), write)
            t._ds = self
            t._shared_cat = self._catalog_shared
        return t

    def context(self, ns: str, db: str, write: bool = False):
        """A context over a fresh transaction, for the engines' direct
        callers (the caller commits or cancels `ctx.txn`)."""
        from surrealdb_tpu_torch.exec.context import Ctx

        return Ctx(self, Session(ns, db, auth_level="owner"),
                   self.transaction(write))

    def record_statement(self, ok: bool, time_ns: int, label: str = ""):
        self.metrics["statements"] += 1
        if not ok:
            self.metrics["statement_errors"] += 1
        ms = time_ns / 1e6
        if self.slow_log_threshold_ms and ms >= self.slow_log_threshold_ms:
            self.metrics["slow_queries"] += 1
            self.slow_log.append((round(ms, 3), label[:200]))
            if len(self.slow_log) > 1000:
                del self.slow_log[:500]

    # -- execution ----------------------------------------------------------
    def execute(
        self,
        sql: str,
        ns: Optional[str] = None,
        db: Optional[str] = None,
        vars: Optional[dict] = None,
        session: Optional[Session] = None,
        deadline: Optional[float] = None,
        handle=None,
    ) -> list[QueryResult]:
        """Parse and run a SurrealQL query; one QueryResult per statement.

        `deadline` is an absolute `time.monotonic()` point bounding every
        statement; `handle` is a pre-opened `QueryHandle` when the caller
        needs to cancel from outside. A nested execute on the same thread
        inherits the enclosing query's handle."""
        from surrealdb_tpu_torch import inflight as _inflight
        from surrealdb_tpu_torch.err import ParseError
        from surrealdb_tpu_torch.exec.executor import Executor
        from surrealdb_tpu_torch.syn import parse
        from surrealdb_tpu_torch.telemetry import stage_record

        _bind_serving()
        # a caller holding the Datastore object has root access by
        # construction (like the reference's local engine)
        sess = session or Session(ns=ns, db=db, auth_level="owner")
        if ns is not None:
            sess.ns = ns
        if db is not None:
            sess.db = db
        stmts = self._ast_cache.get(sql)
        if stmts is None:
            t_parse = time.perf_counter_ns()
            try:
                stmts = parse(sql, capabilities=self.capabilities)
                stage_record("parse", time.perf_counter_ns() - t_parse)
            except ParseError as e:
                # a parse error fails the whole query (reference behaviour)
                return [QueryResult(error=str(e))]
            if len(stmts) > cnf.MAX_STATEMENTS_PER_QUERY:
                return [QueryResult(
                    error="The query contains too many statements"
                )]
            with self.lock:
                if len(self._ast_cache) >= self._ast_cache_cap:
                    self._ast_cache.clear()
                self._ast_cache[sql] = stmts
        own = None
        if handle is None:
            cur = _inflight.current()
            if cur is not None:
                handle = cur  # nested execute: ride the enclosing query
                if cur.edge:
                    # a server route opened it before the SQL was known
                    cur.refine(sess.ns, sess.db, sql)
            else:
                own = handle = self.inflight.open(
                    sess.ns, sess.db, sql, deadline
                )
        elif deadline is not None and handle.deadline is None:
            handle.deadline = deadline
        try:
            with _inflight.activate(handle):
                ex = Executor(self, sess)
                return ex.execute(stmts, vars or {})
        finally:
            if own is not None:
                self.inflight.close(own)

    def query(self, sql: str, ns="test", db="test", vars=None):
        """Convenience: execute and unwrap every statement's result."""
        return [r.unwrap() for r in self.execute(sql, ns=ns, db=db, vars=vars)]

    def query_one(self, sql: str, ns="test", db="test", vars=None):
        out = self.query(sql, ns=ns, db=db, vars=vars)
        return out[-1] if out else None

    # -- notifications ------------------------------------------------------
    def notify(self, notification: Notification):
        """Enqueue-only delivery: the fan-out hub appends to the bounded
        in-process buffer, invokes embedded handlers (errors counted,
        never swallowed silently), and routes to the bound session
        outbox. No socket I/O, no unbounded growth, and nothing here
        runs on a committing writer's thread — the doc pipeline captures
        events and the post-commit dispatch workers call this."""
        self.fanout.deliver(notification)

    def drain_notifications(self) -> list[Notification]:
        # barrier: anything already committed must be matched and
        # routed before the drain returns (the embedded consumer's
        # read-your-own-writes contract survives async dispatch)
        self.fanout.flush()
        with self.lock:
            out = self.notifications
            self.notifications = []
        return out

    def gc_session_lives(self, lids) -> int:
        """Drop a dead session's live queries: registry entries, outbox
        routes, and the persisted `!lq` catalog rows (the reference GCs
        these from engine/tasks.rs:49-51; without it a session that died
        without KILL pays match cost on every write forever)."""
        lids = [str(x) for x in lids]
        subs = []
        for lid in lids:
            self.fanout.unbind(lid)
            sub = self.live_queries.pop(lid, None)
            if sub is not None:
                subs.append((lid, sub))
        if not subs:
            return 0
        from surrealdb_tpu_torch import key as K

        try:
            txn = self.transaction(write=True)
        except SdbError:
            # KV unavailable: the registry is clean, rows sweep later
            self.telemetry.inc("live_gc_collected", len(subs))
            return len(subs)
        committed = False
        try:
            for lid, sub in subs:
                txn.delete(K.lq_def(sub.ns, sub.db, sub.tb, lid))
            txn.commit()
            committed = True
        except SdbError:
            pass  # rows survive until the next sweep
        finally:
            # ANY non-commit exit must release the write transaction:
            # the periodic sweep swallows errors, so a leaked handle
            # would recur every interval
            if not committed:
                try:
                    txn.cancel()
                except SdbError:
                    pass
        self.telemetry.inc("live_gc_collected", len(subs))
        return len(subs)

    def _stamp_storage_version(self, check: bool = True):
        """Stamp new stores; refuse to open any other format version."""
        from surrealdb_tpu_torch import key as K

        txn = self.transaction(write=True)
        try:
            cur = txn.get(K.storage_version())
            if cur is None:
                txn.set(K.storage_version(),
                        str(self.STORAGE_VERSION).encode())
                txn.commit()
                return
            txn.cancel()
            if not check:
                return
            have = int(cur.decode() or 1)
            if have != self.STORAGE_VERSION:
                raise SdbError(
                    f"The storage version {have} is not the version this "
                    f"build supports ({self.STORAGE_VERSION})"
                )
        except SdbError:
            raise
        except BaseException:
            txn.cancel()
            raise

    def next_versionstamp(self) -> int:
        """Hybrid logical clock versionstamp (reference kvs/clock.rs
        HlcTimeStamp): [44-bit wall millis | 20-bit logical counter],
        monotonic even when the wall clock stalls or steps back."""
        with self.lock:
            wall = int(time.time() * 1000)
            if wall > self._hlc_wall:
                self._hlc_wall = wall
                self._hlc_count = 0
            else:
                self._hlc_count += 1
                if self._hlc_count >= (1 << 20):
                    self._hlc_wall += 1
                    self._hlc_count = 0
            return (self._hlc_wall << 20) | self._hlc_count

    def close(self):
        """Stop the node's tasks, the fan-out's workers and outboxes and
        the engines' segment maintenance workers, then close the backend
        (a file store compacts its WAL into the snapshot)."""
        if self.node_tasks is not None:
            self.node_tasks.stop()
        self.fanout.close_all()
        for eng in list(self.vector_indexes.values()):
            if getattr(eng, "_segs", None) is not None:
                eng._segs.close()
        self.backend.close()
