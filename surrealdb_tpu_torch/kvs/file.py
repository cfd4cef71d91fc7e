"""File-backed storage engine (the reference package's `kvs/file.py`):
an append-only WAL plus snapshot compaction over the in-memory MVCC
store.

Commits append pickled write batches to `wal.bin`; opening replays
`snapshot.bin` and then the log into a `VersionedStore`, ignoring a torn
tail; `compact()` rewrites the snapshot and truncates the log, every
`WAL_COMPACT_BATCHES` commits and at `close()`. Durability is an fsync
per commit, appended under the store lock after conflict validation and
before the writes become visible (`VersionedStore.commit`'s
`pre_apply`). Transactions get the mem engine's snapshot isolation and
write-write conflict detection.

Both files are the reference's format, byte for byte: a directory
written by either package opens in the other. The port reads them
through a restricted unpickler: a snapshot or a WAL batch must be a
dict of `bytes` keys to `bytes` or None values, and anything else (a
pickled class, another shape) refuses the whole directory with an
`SdbError`, where the reference's plain `pickle.load` would take it.

Disk full: an ENOSPC or a failed fsync on the WAL (or a failed snapshot
rewrite) never acknowledges a write that is not durable. The engine
enters typed read-only mode: the failing commit raises
`StorageFullError` before its writes become visible, reads keep
serving, and `try_recover()` reopens writes once a compaction succeeds
again. The fsync paths are the seam methods `_sync_wal` and
`_sync_snapshot`, where a test injects the error.
"""

from __future__ import annotations

import os
import pickle

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SdbError, StorageFullError
from surrealdb_tpu_torch.kvs.api import Backend
from surrealdb_tpu_torch.kvs.mem import MemTx, VersionedStore

# rewrite the snapshot and truncate the WAL after this many committed
# batches, so crash recovery never replays an unbounded log
WAL_COMPACT_BATCHES = cnf.WAL_COMPACT_BATCHES


class _Refused(pickle.UnpicklingError):
    """A stored batch that is not a dict of bytes -> bytes | None."""


class _BatchUnpickler(pickle.Unpickler):
    """Resolves no global at all: a snapshot or WAL batch holds only
    builtin containers, bytes and None."""

    def find_class(self, module, name):
        raise _Refused(f"stored batch references {module}.{name}")


def _load_batch(f) -> dict:
    """The next pickled batch of `f`, checked to be a dict of bytes keys
    to bytes or None values; EOFError at the end of the file."""
    batch = _BatchUnpickler(f).load()
    if not isinstance(batch, dict) or not all(
        type(k) is bytes and (v is None or type(v) is bytes)
        for k, v in batch.items()
    ):
        raise _Refused("stored batch is not a dict of bytes -> bytes|None")
    return batch


class FileBackend(Backend):
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.snap_path = os.path.join(path, "snapshot.bin")
        self.wal_path = os.path.join(path, "wal.bin")
        self.vs = VersionedStore()
        self.lock = self.vs.lock
        self._load()
        self.wal = open(self.wal_path, "ab")
        self._wal_batches = 0
        # typed read-only mode: the reason string of the storage error
        # that tripped it, or None when writes are healthy
        self.read_only: str | None = None

    def _load(self):
        try:
            if os.path.exists(self.snap_path):
                with open(self.snap_path, "rb") as f:
                    for k, v in _load_batch(f).items():
                        self.vs.seed(k, v)
            if os.path.exists(self.wal_path):
                with open(self.wal_path, "rb") as f:
                    while True:
                        try:
                            batch = _load_batch(f)
                        except EOFError:
                            break
                        except _Refused:
                            raise
                        except Exception:
                            break  # torn tail write
                        for k, v in batch.items():
                            self.vs.seed(k, v)
        except _Refused as e:
            raise SdbError(f"datastore {self.path!r} refused: {e}") from e

    def transaction(self, write: bool):
        return FileTx(self, write)

    # -- durability seams (a test injects ENOSPC here) ----------------------
    def _sync_wal(self):
        self.wal.flush()
        os.fsync(self.wal.fileno())

    def _sync_snapshot(self, f):
        f.flush()
        os.fsync(f.fileno())

    def _enter_read_only(self, err: BaseException):
        """Flip to typed read-only mode (idempotent: the FIRST failure
        names the cause)."""
        if self.read_only is None:
            self.read_only = f"{type(err).__name__}: {err}"

    def try_recover(self) -> bool:
        """Attempt to leave read-only mode: a successful snapshot
        rewrite (which also truncates the possibly torn WAL tail) proves
        the volume can hold the data again. Safe to call at any time;
        returns True when writes are healthy."""
        if self.read_only is None:
            return True
        try:
            # reopen the WAL first: the handle may be positioned after
            # a torn, unsynced tail write
            self.wal.close()
            self.wal = open(self.wal_path, "ab")
            self.compact()
        except (StorageFullError, OSError):
            return False
        self.read_only = None
        return True

    def compact(self):
        with self.lock:
            tmp = self.snap_path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(dict(self.vs.latest_items()), f,
                                protocol=5)
                    # the snapshot is fsynced before the WAL it replaces
                    # is dropped, all under the commit lock
                    self._sync_snapshot(f)
                os.replace(tmp, self.snap_path)
                self.wal.close()
                open(self.wal_path, "wb").close()
                self.wal = open(self.wal_path, "ab")
                self._wal_batches = 0
            except OSError as e:
                # a failed rewrite leaves the OLD snapshot + WAL intact
                # (tmp + rename): nothing durable was lost
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                self._enter_read_only(e)
                raise StorageFullError(
                    f"snapshot compaction failed ({e}); the node is "
                    f"read-only until space is freed (try_recover)"
                ) from e

    def close(self):
        try:
            if self.read_only is None:
                self.compact()
        except StorageFullError:
            pass  # already durable in the WAL; close what we hold
        self.wal.close()


class FileTx(MemTx):
    def commit(self):
        self._check()
        store: FileBackend = self.store
        if store.read_only is not None and self.writes:
            # typed read-only mode: fail the write BEFORE it becomes
            # visible; reads keep working
            self.done = True
            self._release()
            raise StorageFullError(
                f"storage is read-only ({store.read_only}); writes "
                f"fail until space is freed and recovery succeeds"
            )
        self.done = True

        def wal_append():
            pos = store.wal.tell()
            try:
                pickle.dump(self.writes, store.wal, protocol=5)
                store._sync_wal()
            except OSError as e:
                # the batch was REFUSED: truncate back so a crash before
                # recovery cannot replay bytes that may have reached the
                # disk ahead of the failed fsync
                ambiguous = False
                try:
                    store.wal.truncate(pos)
                    store.wal.seek(pos)
                except OSError:
                    # the refused record may survive COMPLETE in the WAL:
                    # a crash before try_recover()'s compaction would
                    # replay it. Say so.
                    ambiguous = True
                store._enter_read_only(e)
                raise StorageFullError(
                    f"WAL append failed ({e}); the node is read-only "
                    f"until space is freed (try_recover)"
                    + (". OUTCOME UNKNOWN after a crash: the refused "
                       "batch could not be truncated from the WAL and "
                       "may be replayed — recover before restarting"
                       if ambiguous else "")
                ) from e
            store._wal_batches += 1

        snap, self.snap = self.snap, None
        if self.writes:
            self.vs.commit(self.writes, snap, pre_apply=wal_append)
            if store._wal_batches >= WAL_COMPACT_BATCHES:
                try:
                    store.compact()
                except StorageFullError:
                    # THIS commit is already durable in the WAL; the
                    # failed compaction only flipped read-only mode for
                    # future writes
                    pass
        else:
            self.vs.release(snap)
