"""The datastore and execution context the index engines run against
(the reference package's `kvs/ds.py` `Datastore` and `exec/context.py`
`Ctx`, trimmed to the engines' needs).

A `Datastore` holds its storage backend (`memory`: the in-memory MVCC
store; `file://path` or `skv://path`: the same store over a WAL and a
snapshot in that directory), the process-atomic `lock` the vector write
path allocates versions under, and the engine caches: `vector_indexes`
((ns, db, tb, ix) -> TpuVectorIndex), `graph_engine` ((ns, db, node_tb,
edge_tb, dir) -> CsrGraph) and `graph_versions` ((ns, db, tb) -> write
counter). A file-backed store keeps its engines' persisted ANN graphs
in `ann_snapshot_dir` (`<store>/.ann-cache`), so a restart reloads them
instead of rebuilding. The SQL stack (parser, executor, planner,
catalog) is not ported.
"""

from __future__ import annotations

import os
import threading

from surrealdb_tpu_torch.err import NotPorted, SdbError
from surrealdb_tpu_torch.kvs.api import Transaction


class Session:
    """Per-connection session: the namespace and database in use."""

    def __init__(self, ns=None, db=None):
        self.ns = ns
        self.db = db


class Datastore:
    """An embedded datastore over one storage backend: `memory` or a
    directory (`file://path`, `skv://path`)."""

    def __init__(self, path: str = "memory"):
        # persisted ANN artifacts (idx/cagra.py save_index): only a
        # disk-backed store has a place for them
        self.ann_snapshot_dir = None
        if path in ("memory", "mem://"):
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
        self.vector_indexes: dict = {}
        self.graph_engine = None
        self.graph_versions: dict = {}

    def close(self):
        """Stop the engines' segment maintenance workers, then close the
        backend (a file store compacts its WAL into the snapshot)."""
        for eng in list(self.vector_indexes.values()):
            if eng._segs is not None:
                eng._segs.close()
        self.backend.close()

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
