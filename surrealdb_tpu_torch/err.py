"""Error types (the reference package's `err.py`, trimmed to what the
index engines and the KV engines raise)."""


class SdbError(Exception):
    """Base error; the message is what a query's caller sees."""


class NotPorted(SdbError):
    """A path of the reference that this package does not run yet
    (a `cond` predicate, a sharded store, a value type the engines
    never hold). Raised where that path would engage, so no
    query is ever served by another path in its place."""


class StorageFullError(SdbError):
    """The storage engine could not make a write durable (ENOSPC, a
    failed fsync) and has entered typed read-only mode: reads keep
    serving from the durable state, and every write fails with this
    error until space is freed and `kvs/file.py FileBackend.try_recover`
    succeeds. The refused write was never applied, so a retry after
    recovery is safe (the message says when a crash before recovery
    could replay it)."""
