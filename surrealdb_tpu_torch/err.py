"""Error types (the reference package's `err.py`, trimmed to what the
index engines raise)."""


class SdbError(Exception):
    """Base error; the message is what a query's caller sees."""


class NotPorted(SdbError):
    """A path of the reference that this package does not run yet
    (segmented ANN, a `cond` predicate, a sharded store, a value type
    the engines never hold). Raised where that path would engage, so no
    query is ever served by another path in its place."""
