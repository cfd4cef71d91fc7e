"""Execution context (reference: core/src/ctx/ + dbs/options.rs).

A lightweight chain: each scope (statement, document, closure) gets a child
context sharing the datastore/transaction handles, with its own variable
bindings and current-document pointer.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from surrealdb_tpu_torch.err import SdbError


class Ctx:
    __slots__ = (
        "ds", "session", "txn", "vars", "doc", "doc_id", "parent_doc",
        "executor", "ns", "db", "knn", "record_cache", "deadline",
        "timeout_dur", "write_version", "depth",
        "perms_enabled", "version", "_cond_consumed", "_cf_seq", "_in_perm_check",
        "_brute_knn_k", "_strict_readonly", "_stream_cols", "_no_link_fetch", "_script_depth",
        "cancel", "inflight",
    )

    def __init__(self, ds, session, txn, executor=None):
        self.ds = ds
        self.session = session
        self.txn = txn
        self.executor = executor
        self.vars: dict[str, Any] = {}
        self.doc = None  # current document value ($this)
        self.doc_id = None  # RecordId of current document
        self.parent_doc = None
        self.ns = session.ns
        self.db = session.db
        self.knn: Optional[dict] = None  # record-key -> distance (KnnContext)
        self.record_cache: dict = {}
        self.deadline: Optional[float] = None
        self.timeout_dur = None
        self.version = None  # VERSION clause timestamp
        self.write_version = None  # CREATE/INSERT ... VERSION (epoch ns)
        self.depth = 0
        self.perms_enabled = False  # row-level permissions active
        self._in_perm_check = False  # evaluating a PERMISSIONS clause
        self._cond_consumed = False  # planner handled the WHERE clause
        self._cf_seq = 0
        self._brute_knn_k = None  # brute KNN global k (multi-source trim)
        self._strict_readonly = False  # REPLACE: dropped readonly errors
        self._stream_cols = None  # (ColumnCache, src) — exec/stream.py
        # ORDER BY keys evaluate pre-FETCH with no record-link traversal
        # (reference: sort compares computed values without db access)
        self._no_link_fetch = False
        self._script_depth = 0  # nested script frames (budget: 15)
        # cooperative cancellation: a threading.Event set by KILL
        # <query-id>, client disconnect, or server drain; checked at
        # every check_deadline() site alongside the deadline itself
        self.cancel = None
        self.inflight = None  # the owning QueryHandle (inflight.py)

    def child(self) -> "Ctx":
        c = Ctx.__new__(Ctx)
        c.ds = self.ds
        c.session = self.session
        c.txn = self.txn
        c.executor = self.executor
        c.vars = dict(self.vars)
        c.doc = self.doc
        c.doc_id = self.doc_id
        c.parent_doc = self.parent_doc
        c.ns = self.ns
        c.db = self.db
        c.knn = self.knn
        c.record_cache = self.record_cache
        c.deadline = self.deadline
        c.timeout_dur = self.timeout_dur
        c.version = self.version
        c.write_version = self.write_version
        c.depth = self.depth + 1
        c.perms_enabled = self.perms_enabled
        c._cond_consumed = False
        c._cf_seq = 0
        c._brute_knn_k = self._brute_knn_k
        c._strict_readonly = self._strict_readonly
        c._in_perm_check = self._in_perm_check
        c._stream_cols = self._stream_cols
        c._no_link_fetch = self._no_link_fetch
        c._script_depth = self._script_depth
        c.cancel = self.cancel
        c.inflight = self.inflight
        from surrealdb_tpu_torch import cnf

        if c.depth > cnf.MAX_COMPUTATION_DEPTH:
            raise SdbError("Max computation depth exceeded")
        return c

    def with_doc(self, doc, doc_id=None) -> "Ctx":
        c = self.child()
        # $parent = the enclosing context's (possibly pinned) $this —
        # fixed at the time the enclosing statement started, like $this
        pin = self.vars.get("this", self.doc)
        c.parent_doc = pin
        c.doc = doc
        c.doc_id = doc_id
        c.vars["parent"] = pin
        c.vars["this"] = doc
        return c

    def check_deadline(self):
        if self.cancel is not None and self.cancel.is_set():
            from surrealdb_tpu_torch.err import QueryCancelled

            if self.inflight is not None:
                self.inflight.mark_cancelled()
            raise QueryCancelled("The query was cancelled")
        if self.deadline is not None and time.monotonic() > self.deadline:
            from surrealdb_tpu_torch.err import QueryTimeout

            suffix = (
                f": {self.timeout_dur.render()}"
                if self.timeout_dur is not None else ""
            )
            if self.inflight is not None:
                self.inflight.mark_timed_out()
            raise QueryTimeout(
                "The query was not executed because it exceeded the "
                f"timeout{suffix}"
            )

    def need_ns_db(self):
        # empty-string names are legal (`USE NS ```) — only None is unset
        if self.ns is None or self.db is None:
            raise SdbError(
                "Specify a namespace and database to use"
            )
        return self.ns, self.db
