"""The values the index engines hold (the reference package's
`val/__init__.py`, trimmed): the NONE sentinel and record ids.

- NONE  -> the `NONE` singleton (absence of a value)
- NULL  -> Python ``None``
- Bool, Number, String, Array, Object, Bytes -> ``bool``, ``int`` |
  ``float`` | ``decimal.Decimal``, ``str``, ``list``, ``dict``, ``bytes``
- RecordId -> the class below

The reference's other value types (durations, datetimes, uuids, sets,
geometries, ranges, ...) are not ported: the key and CBOR codecs raise
`NotPorted` where one would appear.
"""

from __future__ import annotations

from decimal import Decimal


class _NoneType:
    """The SurrealQL NONE value (absence); distinct from NULL (None)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "NONE"

    def __bool__(self):
        return False

    def __reduce__(self):
        return (_NoneType, ())

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


NONE = _NoneType()

_NUM = (int, float, Decimal)


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def id_eq(a, b) -> bool:
    """SurrealQL equality over the values a record id holds: numbers
    compare across int/float/Decimal, everything else by type and
    content."""
    if _is_num(a) or _is_num(b):
        return _is_num(a) and _is_num(b) and a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(id_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(id_eq(a[k], b[k]) for k in a)
    if type(a) is not type(b):
        return False
    return a == b


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, bytearray):
        return bytes(v)
    return v


class RecordId:
    """A record pointer `table:id`; id is an int, str, list or dict."""

    __slots__ = ("tb", "id")

    def __init__(self, tb: str, id):
        self.tb = tb
        self.id = id

    def __eq__(self, other):
        return (isinstance(other, RecordId) and self.tb == other.tb
                and id_eq(self.id, other.id))

    def __hash__(self):
        return hash(("RecordId", self.tb, _hashable(self.id)))

    def __repr__(self):
        return f"RecordId({self.tb}:{self.id!r})"
