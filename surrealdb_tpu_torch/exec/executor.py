"""Statement loop + transaction management (reference: dbs/executor.rs).

Each statement outside BEGIN/COMMIT runs in its own transaction; inside an
explicit transaction all statements share one, and a failure poisons the
remainder until COMMIT/CANCEL (reference Executor behaviour)."""

from __future__ import annotations

import time

from surrealdb_tpu_torch.err import (
    BreakException,
    ContinueException,
    ReturnException,
    SdbError,
    ThrownError,
)
from surrealdb_tpu_torch.exec.context import Ctx
from surrealdb_tpu_torch.exec.statements import eval_statement
from surrealdb_tpu_torch.expr.ast import (
    BeginStmt,
    CancelStmt,
    CommitStmt,
    LetStmt,
    OptionStmt,
    UseStmt,
)
from surrealdb_tpu_torch.kvs.ds import QueryResult
from surrealdb_tpu_torch.val import NONE


class Executor:
    def __init__(self, ds, session):
        self.ds = ds
        self.session = session

    def _read_staleness(self, stmt, shared_vars):
        """Bounded-staleness opt-in for ONE auto-transaction statement:
        a SELECT's `READ AT <duration>` clause, else the session-level
        `max_staleness` default. Returns seconds or None (exact read —
        the default, byte-identical to the primary-pinned path)."""
        from surrealdb_tpu_torch.expr.ast import SelectStmt

        if not isinstance(stmt, SelectStmt):
            return None
        expr = getattr(stmt, "read_at", None)
        if expr is None:
            return self.session.max_staleness
        from surrealdb_tpu_torch.exec.eval import evaluate
        from surrealdb_tpu_torch.val import Duration, render

        # READ AT is resolved BEFORE the transaction opens (it decides
        # which kind to open), so it evaluates txn-free: literals and
        # $params only, like the reference's statement-level options —
        # anything that needs the store (a subquery, an idiom) is a
        # TYPED error, not an internal crash on the missing txn
        ctx = Ctx(self.ds, self.session, None, executor=self)
        ctx.vars.update(shared_vars)
        try:
            d = evaluate(expr, ctx)
        except SdbError:
            raise
        except Exception:
            raise SdbError(
                "READ AT expects a literal duration or $param "
                "(subqueries and record access are not allowed here)"
            )
        if isinstance(d, Duration):
            return max(d.to_seconds(), 0.0)
        if isinstance(d, (int, float)) and not isinstance(d, bool):
            return max(float(d), 0.0)
        raise SdbError(
            f"READ AT expects a duration but found {render(d)}"
        )

    def _commit_and_publish(self, txn):
        """Commit, then hand the transaction's captured live events to
        the fan-out dispatch workers (server/fanout.py). A transaction
        with events commits under the hub's commit-order lock: publish
        order must equal commit order, and a GIL handoff between
        commit() and publish() would let a racing writer's later commit
        publish first (subscriber state diverging from the table with
        no OVERFLOW). Unwatched transactions — no captured events —
        commit without the lock. A cancelled transaction publishes
        nothing, so subscribers never see uncommitted mutations."""
        events = getattr(txn, "_live_events", None)
        if not events:
            txn.commit()
            return
        txn._live_events = None
        fanout = self.ds.fanout
        with fanout.commit_order_lock:
            txn.commit()
            fanout.publish(events)

    @staticmethod
    def _truncate_lives(txn, n: int):
        events = getattr(txn, "_live_events", None)
        if events is not None and len(events) > n:
            del events[n:]

    def execute(self, stmts: list, vars: dict) -> list[QueryResult]:
        tel = self.ds.telemetry
        root = tel.start("query", statements=len(stmts))
        try:
            return self._execute(stmts, vars, tel)
        finally:
            tel.end(root)

    def _execute(self, stmts: list, vars: dict, tel) -> list[QueryResult]:
        from surrealdb_tpu_torch import inflight as _inflight
        from surrealdb_tpu_torch.exec.statements import _ensure_ns_db
        from surrealdb_tpu_torch.telemetry import stage_record

        results: list[QueryResult] = []
        self.import_mode = False  # OPTION IMPORT, scoped to this run
        # the edge deadline + cancel flag ride the thread's QueryHandle
        # (kvs/ds.py execute registers it); every statement ctx inherits
        handle = _inflight.current()
        txn = None  # explicit transaction, if open
        ensured_nsdb = False
        failed = False  # explicit txn poisoned
        returned = False  # top-level RETURN inside the txn: skip to COMMIT
        buffered: list[int] = []  # result idxs inside current explicit txn
        shared_vars = dict(self.session.variables)
        shared_vars.update(vars)
        for stmt in stmts:
            t0 = time.perf_counter_ns()
            if isinstance(stmt, BeginStmt):
                if txn is None:
                    txn = self.ds.transaction(write=True)
                    failed = False
                    returned = False
                    buffered = []
                    results.append(QueryResult(result=NONE))
                else:
                    results.append(
                        QueryResult(
                            error="Cannot BEGIN a transaction within a transaction"
                        )
                    )
                continue
            if isinstance(stmt, CommitStmt):
                if txn is not None:
                    if failed:
                        txn.cancel()
                        for i in buffered:
                            if results[i].error is None:
                                results[i] = QueryResult(
                                    error="The query was not executed due to a failed transaction"
                                )
                        results.append(
                            QueryResult(
                                error="Cannot COMMIT: the transaction was aborted due to a prior error"
                            )
                        )
                    else:
                        self._commit_and_publish(txn)
                        results.append(QueryResult(result=NONE))
                    txn = None
                else:
                    results.append(
                        QueryResult(
                            error="Invalid statement: Cannot COMMIT without starting a transaction"
                        )
                    )
                continue
            if isinstance(stmt, CancelStmt):
                if txn is not None:
                    txn.cancel()
                    for i in buffered:
                        results[i] = QueryResult(
                            error="The query was not executed due to a cancelled transaction"
                        )
                    txn = None
                    results.append(QueryResult(result=NONE))
                else:
                    results.append(
                        QueryResult(
                            error="Invalid statement: Cannot CANCEL without starting a transaction"
                        )
                    )
                continue
            if txn is not None and returned:
                # a top-level RETURN ends the transaction's statement run:
                # the rest (until COMMIT/CANCEL) neither executes nor
                # reports (statements/return/breaks_nested_execution)
                continue
            if txn is not None and failed:
                # statements after the failing one report the transaction as
                # cancelled (the failure itself reported the real error)
                results.append(
                    QueryResult(
                        error="The query was not executed due to a cancelled transaction"
                    )
                )
                continue
            if handle is not None and handle.cancel.is_set():
                # a KILL / disconnect / drain cancels the REMAINING
                # statements too — they never start, and an open explicit
                # transaction is poisoned exactly as if the cancel had
                # landed DURING a statement (COMMIT must not persist a
                # half-done transaction the client was told was cancelled)
                handle.mark_cancelled()
                failed = txn is not None or failed
                results.append(QueryResult(error="The query was cancelled"))
                continue
            if handle is not None and handle.deadline is not None and \
                    time.monotonic() > handle.deadline:
                handle.mark_timed_out()
                failed = txn is not None or failed
                results.append(QueryResult(
                    error="The query was not executed because it "
                          "exceeded the timeout"
                ))
                continue
            own_txn = txn is None
            # pre-statement live-event watermark (savepoint rollback
            # truncates to it; set before the try so an error raised
            # ahead of new_save_point still finds it bound)
            n_lives = len(getattr(txn, "_live_events", None) or ()) \
                if txn is not None else 0
            try:
                if own_txn:
                    t_txn = time.perf_counter_ns()
                    # READ AT / session max_staleness: the statement
                    # runs READ-ONLY and may be served by a replica
                    # that proves the bound (closed-timestamp follower
                    # reads, kvs/remote.py). Exact statements take the
                    # unchanged write=True path.
                    stale_s = self._read_staleness(stmt, shared_vars)
                    if stale_s is not None:
                        cur = self.ds.transaction(
                            write=False, max_staleness=stale_s
                        )
                    else:
                        cur = self.ds.transaction(write=True)
                    stage_record("txn_open",
                                 time.perf_counter_ns() - t_txn)
                else:
                    if getattr(stmt, "read_at", None) is not None:
                        raise SdbError(
                            "READ AT cannot be used inside an "
                            "explicit transaction"
                        )
                    cur = txn
            except SdbError as e:
                # a transaction that cannot OPEN (remote KV unreachable /
                # retry deadline exhausted) is a per-statement error, not
                # a crashed query: the worker thread must be reclaimed
                # and the client must see the typed message
                self.ds.record_statement(
                    False, time.perf_counter_ns() - t0, type(stmt).__name__
                )
                results.append(QueryResult(error=str(e)))
                continue
            ctx = Ctx(self.ds, self.session, cur, executor=self)
            if handle is not None:
                ctx.deadline = handle.deadline
                ctx.cancel = handle.cancel
                ctx.inflight = handle
            ctx.vars.update(shared_vars)
            try:
                if self.session.auth_level == "none" \
                        and self.session.guests_refused and not getattr(
                            self.ds.capabilities, "guest_access", False):
                    # an anonymous session of a server started without
                    # --unauthenticated runs nothing unless guests are
                    # allowed (SURREAL_CAPS_ALLOW_GUESTS, SurrealDB's
                    # --allow-guests); signin/signup/authenticate are
                    # rpc methods and routes, not statements
                    raise SdbError("IAM error: Not enough permissions to "
                                   "perform this action")
                if self.session.ns and self.session.db and not ensured_nsdb:
                    # non-strict mode lazily registers the session ns/db in
                    # the catalog (reference kvs get_or_add_ns/db); once per
                    # run — inside the error envelope: a partitioned KV
                    # must surface as a statement error, not a crash.
                    # A follower-read statement holds a READ-ONLY txn,
                    # so the one-time registration commits separately.
                    if not getattr(cur, "write", True):
                        wtx = self.ds.transaction(write=True)
                        try:
                            _ensure_ns_db(Ctx(self.ds, self.session,
                                              wtx, executor=self))
                            wtx.commit()
                        except BaseException:
                            wtx.cancel()
                            raise
                    else:
                        _ensure_ns_db(ctx)
                if not own_txn:
                    # savepoints only matter inside an explicit
                    # transaction (a failing statement rolls back to the
                    # last one); an auto-commit statement cancels its
                    # whole transaction on error, so the happy path
                    # skips the create/release pair entirely
                    cur.new_save_point()
                sp = tel.start(type(stmt).__name__)
                t_eval = time.perf_counter_ns()
                try:
                    out = eval_statement(stmt, ctx)
                finally:
                    eval_ns = time.perf_counter_ns() - t_eval
                    stage_record("stmt_eval", eval_ns)
                    tel.end(sp)
                if not own_txn:
                    cur.release_last_save_point()
                # persist session-level vars (LET/USE at top level)
                if isinstance(stmt, (LetStmt,)):
                    shared_vars = dict(ctx.vars)
                    self.session.variables[stmt.name] = ctx.vars.get(stmt.name)
                elif isinstance(stmt, UseStmt):
                    pass  # session mutated in place
                if own_txn:
                    self._commit_and_publish(cur)
                ensured_nsdb = True
                dt = time.perf_counter_ns() - t0
                # envelope = statement machinery around the evaluation
                # (txn plumbing, cancel/deadline gates, result wrap)
                stage_record("stmt_envelope", max(dt - eval_ns, 0))
                self.ds.record_statement(True, dt, type(stmt).__name__)
                qr = QueryResult(result=out, time_ns=dt)
                results.append(qr)
                if not own_txn:
                    buffered.append(len(results) - 1)
            except ReturnException as r:
                if own_txn:
                    self._commit_and_publish(cur)
                results.append(
                    QueryResult(result=r.value, time_ns=time.perf_counter_ns() - t0)
                )
                if not own_txn:
                    buffered.append(len(results) - 1)
                    returned = True
            except (BreakException, ContinueException):
                msg = ("Invalid control flow statement, break or continue statement "
                       "found outside of loop.")
                if own_txn:
                    cur.cancel()
                results.append(QueryResult(error=msg))
            except (SdbError, ThrownError) as e:
                if own_txn:
                    cur.cancel()
                else:
                    cur.rollback_to_save_point()
                    self._truncate_lives(cur, n_lives)
                    failed = True
                self.ds.record_statement(
                    False, time.perf_counter_ns() - t0, type(stmt).__name__
                )
                results.append(QueryResult(error=str(e)))
                if not own_txn:
                    buffered.append(len(results) - 1)
            except RecursionError:
                if own_txn:
                    cur.cancel()
                results.append(QueryResult(error="Max computation depth exceeded"))
            except Exception as e:  # internal error — surface, don't crash
                if own_txn:
                    cur.cancel()
                else:
                    cur.rollback_to_save_point()
                    self._truncate_lives(cur, n_lives)
                    failed = True
                results.append(
                    QueryResult(error=f"Internal error: {e.__class__.__name__}: {e}")
                )
                if not own_txn:
                    buffered.append(len(results) - 1)
        if txn is not None:
            # unterminated explicit transaction: cancel
            txn.cancel()
            for i in buffered:
                results[i] = QueryResult(
                    error="The query was not executed due to a cancelled transaction"
                )
        return results
