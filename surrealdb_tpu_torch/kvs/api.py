"""Transaction contract and storage encoding (the reference package's
`kvs/api.py`, trimmed to the operations the index engines call).

Storage encoding: header byte 0x01 = the CBOR value encoding
(`wire.encode`); header 0x00 = pickle (protocol 5) for what CBOR
refuses, such as the op-log tuples `("set", id, bytes)` of a vector
index; headerless pickle (0x80...) also reads. `serialize` falls back
exactly where the reference's does, so both write the same bytes.

The pickle branch reads through a restricted unpickler: only builtin
containers and stdlib value types resolve, so a stored value that names
any other class (one of the reference package's own, say) raises; it
never decodes to something else.

The reference's `Transaction` also keeps catalog history (`/%` keys
stamped with the wall clock) for every `/!` key it writes, index state
included, and caches catalog reads. Neither is ported: nothing here
reads that history, and the typed reads return the same values.
"""

from __future__ import annotations

import io
import pickle
from typing import Iterator, Optional

from surrealdb_tpu_torch import wire
from surrealdb_tpu_torch.err import SdbError


class BackendTx:
    """A single transaction against an ordered keyspace."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, val: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def scan(self, beg: bytes, end: bytes, limit: Optional[int] = None,
             reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        """Iterate (key, value) for beg <= key < end in key order."""
        raise NotImplementedError

    def keys(self, beg, end, limit=None, reverse=False):
        for k, _v in self.scan(beg, end, limit, reverse):
            yield k

    def delete_range(self, beg: bytes, end: bytes) -> None:
        for k in list(self.keys(beg, end)):
            self.delete(k)

    def commit(self) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        raise NotImplementedError


class Backend:
    """A storage engine: a factory of transactions over one keyspace."""

    def transaction(self, write: bool) -> BackendTx:
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Value (de)serialization
# ---------------------------------------------------------------------------


def serialize(v) -> bytes:
    try:
        return b"\x01" + wire.encode(v)
    except (SdbError, ValueError, KeyError, TypeError):
        return b"\x00" + pickle.dumps(v, protocol=5)


def deserialize(b: bytes):
    if b[:1] == b"\x01":
        return wire.decode_value(b[1:])
    if b[:1] == b"\x00":
        return _restricted_loads(b[1:])
    return _restricted_loads(b)


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only stdlib value types; any other global raises."""

    _ALLOWED_EXACT = {
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "complex"), ("builtins", "bytearray"),
        ("collections", "OrderedDict"), ("decimal", "Decimal"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED_EXACT:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"stored value references disallowed type {module}.{name}")


def _restricted_loads(b: bytes):
    return _RestrictedUnpickler(io.BytesIO(b)).load()


class Transaction:
    """Typed transaction wrapper over a raw `BackendTx` (the reference's
    `kvs/api.py Transaction`, without its catalog cache and history)."""

    def __init__(self, btx: BackendTx, write: bool):
        self.btx = btx
        self.write = write
        self.closed = False

    # raw ops -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        return self.btx.get(key)

    def set(self, key: bytes, val: bytes) -> None:
        self.btx.set(key, val)

    def delete(self, key: bytes) -> None:
        self.btx.delete(key)

    def scan(self, beg, end, limit=None, reverse=False):
        return self.btx.scan(beg, end, limit, reverse)

    def keys(self, beg, end, limit=None, reverse=False):
        return self.btx.keys(beg, end, limit, reverse)

    def delete_range(self, beg, end):
        return self.btx.delete_range(beg, end)

    # typed ops ------------------------------------------------------------
    def get_val(self, key: bytes):
        raw = self.btx.get(key)
        return None if raw is None else deserialize(raw)

    def set_val(self, key: bytes, v) -> None:
        self.btx.set(key, serialize(v))

    def scan_vals(self, beg, end, limit=None, reverse=False):
        for k, raw in self.btx.scan(beg, end, limit, reverse):
            yield k, deserialize(raw)

    # lifecycle ------------------------------------------------------------
    def commit(self):
        if not self.closed:
            self.btx.commit()
            self.closed = True

    def cancel(self):
        if not self.closed:
            self.btx.cancel()
            self.closed = True
