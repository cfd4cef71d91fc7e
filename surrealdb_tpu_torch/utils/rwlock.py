"""A small reader-writer lock for the scoring hot path.

The pipelined cross-query batcher (device/batcher.py) may run two
scoring kernels concurrently; both only READ the index's host arrays,
while cache sync (which mutates them, sometimes in place) must be
exclusive. A plain RLock would serialize the kernels and defeat the
pipeline. Writer-preference: a waiting writer blocks NEW readers, so a
steady query stream cannot starve cache sync forever.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = None  # owning thread while write-held
        self._writer_depth = 0
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        me = threading.current_thread()
        with self._cond:
            if self._writer is me:
                # write lock implies read permission (sync paths call
                # back into readers)
                self._writer_depth += 1
                reentrant_write = True
            else:
                reentrant_write = False
                while self._writer is not None or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                if reentrant_write:
                    self._writer_depth -= 1
                else:
                    self._readers -= 1
                    if self._readers == 0:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.current_thread()
        with self._cond:
            if self._writer is me:  # reentrant
                self._writer_depth += 1
            else:
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
                self._writer_depth = 1
        try:
            yield
        finally:
            with self._cond:
                self._writer_depth -= 1
                if self._writer_depth == 0:
                    self._writer = None
                    self._cond.notify_all()
