"""Pure-Python stand-ins for the `sortedcontainers` types the KV layer
uses (`SortedDict`, `SortedList`): the reference package's
`utils/sortedcompat.py`, with the key index of `SortedDict` kept sorted
lazily. `kvs/mem.py` prefers the real package when it is installed.

`SortedDict` appends new keys to a pending list and drops deleted ones
into a set; the first ordered read merges both into the sorted index
(one `sorted` over two runs, linear). A bulk ingest of N keys followed
by a scan costs O(N log N) once instead of an O(N) insert per key.
`irange` returns a copy of the key segment, so callers may mutate the
dict while they iterate.
"""

from __future__ import annotations

import bisect
from typing import Iterator

_MISSING = object()


class SortedList:
    """Ascending multiset backed by bisect over a plain list."""

    def __init__(self, iterable=()):
        self._l = sorted(iterable)

    def add(self, value) -> None:
        bisect.insort(self._l, value)

    def remove(self, value) -> None:
        i = bisect.bisect_left(self._l, value)
        if i < len(self._l) and self._l[i] == value:
            del self._l[i]
        else:
            raise ValueError(f"{value!r} not in list")

    def __getitem__(self, i):
        return self._l[i]

    def __len__(self) -> int:
        return len(self._l)


class SortedDict:
    """Dict with a lazily merged sorted key index."""

    def __init__(self, *args, **kwargs):
        self._d = dict(*args, **kwargs)
        self._keys = sorted(self._d)  # sorted; may hold keys in _gone
        self._new: set = set()        # live keys not yet in _keys
        self._gone: set = set()       # keys in _keys no longer live

    def _flush(self):
        if self._gone:
            gone = self._gone
            self._keys = [k for k in self._keys if k not in gone]
            self._gone = set()
        if self._new:
            self._keys = sorted(self._keys + sorted(self._new))
            self._new = set()

    def __setitem__(self, key, value) -> None:
        if key not in self._d:
            if key in self._gone:
                self._gone.discard(key)
            else:
                self._new.add(key)
        self._d[key] = value

    def __delitem__(self, key) -> None:
        del self._d[key]
        if key in self._new:
            self._new.discard(key)
        else:
            self._gone.add(key)

    def __getitem__(self, key):
        return self._d[key]

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, default=None):
        return self._d.get(key, default)

    def pop(self, key, default=_MISSING):
        if key in self._d:
            v = self._d[key]
            del self[key]
            return v
        if default is _MISSING:
            raise KeyError(key)
        return default

    def items(self):
        self._flush()
        return [(k, self._d[k]) for k in self._keys]

    def irange(self, minimum=None, maximum=None,
               inclusive: tuple[bool, bool] = (True, True),
               reverse: bool = False) -> Iterator:
        self._flush()
        keys = self._keys
        if minimum is None:
            lo = 0
        elif inclusive[0]:
            lo = bisect.bisect_left(keys, minimum)
        else:
            lo = bisect.bisect_right(keys, minimum)
        if maximum is None:
            hi = len(keys)
        elif inclusive[1]:
            hi = bisect.bisect_right(keys, maximum)
        else:
            hi = bisect.bisect_left(keys, maximum)
        seg = keys[lo:hi]
        if reverse:
            seg.reverse()
        return iter(seg)
