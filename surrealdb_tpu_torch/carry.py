"""Carry device state across into the port.

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
