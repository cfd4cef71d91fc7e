"""The datastore and execution context the index engines run against
(the reference package's `kvs/ds.py` `Datastore` and `exec/context.py`
`Ctx`, trimmed to the engines' needs).

A `Datastore` holds the in-memory MVCC backend, the process-atomic
`lock` the vector write path allocates versions under, and the engine
caches: `vector_indexes` ((ns, db, tb, ix) -> TpuVectorIndex),
`graph_engine` ((ns, db, node_tb, edge_tb, dir) -> CsrGraph) and
`graph_versions` ((ns, db, tb) -> write counter). The SQL stack (parser,
executor, planner, catalog) is not ported.
"""

from __future__ import annotations

import threading

from surrealdb_tpu_torch.err import NotPorted, SdbError
from surrealdb_tpu_torch.kvs.api import Transaction


class Session:
    """Per-connection session: the namespace and database in use."""

    def __init__(self, ns=None, db=None):
        self.ns = ns
        self.db = db


class Datastore:
    """An embedded datastore over one storage backend (`memory`)."""

    def __init__(self, path: str = "memory"):
        if path not in ("memory", "mem://"):
            raise NotPorted(f"datastore path {path!r} is not ported "
                            f"(only 'memory')")
        from surrealdb_tpu_torch.kvs.mem import MemBackend

        self.backend = MemBackend()
        self.lock = threading.RLock()
        self.vector_indexes: dict = {}
        self.graph_engine = None
        self.graph_versions: dict = {}

    def transaction(self, write: bool = True) -> Transaction:
        return Transaction(self.backend.transaction(write), write)

    def context(self, ns: str, db: str, write: bool = False) -> "Ctx":
        """A context over a fresh transaction (the caller commits or
        cancels `ctx.txn`)."""
        return Ctx(self, Session(ns, db), self.transaction(write))


class Ctx:
    """Execution context: the datastore, the session and the open
    transaction."""

    __slots__ = ("ds", "session", "txn", "ns", "db")

    def __init__(self, ds, session, txn):
        self.ds = ds
        self.session = session
        self.txn = txn
        self.ns = session.ns
        self.db = session.db

    def need_ns_db(self):
        # empty-string names are legal: only None is unset
        if self.ns is None or self.db is None:
            raise SdbError("Specify a namespace and database to use")
        return self.ns, self.db
