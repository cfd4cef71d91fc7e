"""Carry state across into the port.

`datastore_from_items(items)` puts (key, value) byte pairs, the
committed state of a reference datastore's KV store, into a port
`Datastore`: the port's index engines then read exactly the bytes the
reference's read (records, `he` vectors, the pickled `hl` op log, `vn`,
the `~` graph keys).

`host_from_snapshot(snapshot, device)` builds a torch `DeviceHost` from
plain numpy state, the same arrays a reference runner's stores hold:

    {"vec": {key: {"tag", "vecs", "valid", "metric", "mink_p", "cfg"}},
     "csr": {key: {"tag", "rows", "cols", "n_nodes"}}}

Every store is installed under its tag, so frames a serving process
sends for those (key, tag) pairs are answered without a re-ship.
"""

from __future__ import annotations

import numpy as np

from surrealdb_tpu_torch.device.csrstore import CsrStore
from surrealdb_tpu_torch.device.handlers import DeviceHost
from surrealdb_tpu_torch.device.vecstore import VecStore
from surrealdb_tpu_torch.kvs.ds import Datastore


def datastore_from_items(items) -> Datastore:
    """A memory `Datastore` holding `items`, an iterable of (key bytes,
    value bytes) pairs, as committed state."""
    ds = Datastore("memory")
    vs = ds.backend.vs
    for k, v in items:
        vs.seed(bytes(k), bytes(v))
    return ds


def host_from_snapshot(snapshot: dict, device="cuda") -> DeviceHost:
    host = DeviceHost(device)
    for key, s in snapshot.get("vec", {}).items():
        vecs = np.ascontiguousarray(s["vecs"])
        host._admit(VecStore.estimate_device_bytes(
            vecs.shape[0], vecs.shape[1], vecs.dtype.itemsize, s["metric"],
            s["cfg"]), keep_key=key)
        st = VecStore(key, vecs, np.asarray(s["valid"]), s["metric"],
                      s.get("mink_p", 3.0), s["cfg"], host.device)
        host._install_vec(key, s["tag"], st)
    for key, s in snapshot.get("csr", {}).items():
        rows = np.ascontiguousarray(s["rows"], dtype=np.int32)
        cols = np.ascontiguousarray(s["cols"], dtype=np.int32)
        host._admit(int(rows.nbytes + cols.nbytes), keep_key=key)
        host.csr[key] = (list(s["tag"]),
                         CsrStore(key, rows, cols, int(s["n_nodes"]),
                                  host.device))
    return host
