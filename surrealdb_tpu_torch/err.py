"""Error types (reference: core/src/err/)."""


class SdbError(Exception):
    """Base error; message is what the RPC surface returns."""


class NotPorted(SdbError):
    """A path of the reference that this package does not run (a
    statement, a function, an index kind or a storage engine left out of
    the port). Raised where that path would engage, naming it, so no
    query is ever served by another path in its place."""


class RetryableKvError(SdbError):
    """Transport-level KV failure: the transaction did not observe torn
    state and may be retried from the top. For an in-flight commit the
    outcome is UNKNOWN (the server may have applied it before the
    connection died) — retries must be idempotent at the application
    level, exactly like the reference's retryable TiKV errors."""


class QueryTimeout(SdbError):
    """The query ran past its deadline (statement TIMEOUT, the edge
    X-Surreal-Timeout budget, or the server default). The message keeps
    the reference wording so conformance goldens match."""


class QueryCancelled(SdbError):
    """The query was cooperatively cancelled: KILL <query-id>, client
    disconnect, or server drain. Retryable from the client's view."""


class ShedError(SdbError):
    """Admission control rejected the request before execution (queue
    full, deadline unreachable, or the server is draining). Maps to
    HTTP 503 + Retry-After; the work was never started, so a retry is
    always safe."""

    def __init__(self, msg, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class StorageFullError(SdbError):
    """The storage engine could not make a write durable (ENOSPC, a
    failed fsync) and the node has entered typed READ-ONLY mode: reads
    and replication keep serving from the already-durable state, every
    write fails with this error until space is freed and recovery
    succeeds (kvs/file.py `try_recover`). The write was not applied to
    the running node, so retrying after the operator frees space is
    safe — with one caveat the message calls out when it applies: if
    the refused bytes could not be truncated from the WAL AND the node
    crashes before recovery, replay may apply them (the same OUTCOME
    UNKNOWN contract as an in-flight remote commit), so retries must
    be idempotent at the application level."""


class FollowerTooStale(RetryableKvError):
    """A bounded-staleness follower read could not be served: no replica
    could prove the requested timestamp closed under the session's
    (closed_ts, era) floor, and the primary fallback failed too. The
    read observed NOTHING (the proof runs before any snapshot is
    pinned), so a retry — which rides primary rediscovery — is always
    safe. Stale data is never silently served in place of this error."""


class KnnShardUnavailable(SdbError):
    """A scatter-gather KNN query could not get an answer from every
    index shard within its per-shard budgets (SURREAL_KNN_PARTIAL=error
    policy). `shards` names the missing shard(s) — range + replica
    addresses — so the client and the operator both see WHICH slice of
    the index the answer would have been blind to. Retryable: the shard
    group may be mid-failover."""

    def __init__(self, msg, shards=()):
        super().__init__(msg)
        self.shards = list(shards)


class ParseError(SdbError):
    def __init__(self, msg, line=None, col=None):
        if line is not None:
            msg = f"Parse error: {msg} at line {line}, column {col}"
        super().__init__(msg)
        self.line = line
        self.col = col


class TypeError_(SdbError):
    pass


class ThrownError(SdbError):
    """User `THROW` statement."""


class BreakException(Exception):
    """Control flow: BREAK inside FOR/WHILE."""


class ContinueException(Exception):
    """Control flow: CONTINUE inside FOR."""


class ReturnException(Exception):
    """Control flow: RETURN inside a block/function."""

    def __init__(self, value):
        self.value = value
