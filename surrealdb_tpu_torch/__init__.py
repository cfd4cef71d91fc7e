"""PyTorch/CUDA port of the surrealdb_tpu device path.

`device/` holds the torch device runner: a server that speaks the
reference runner's frame protocol, keeps the vector and CSR stores in
GPU memory and answers their ops with hand-written CUDA kernels
(`csrc/`, built at first use). `ops/` holds the kernels' Python
wrappers beside their plain PyTorch versions.

`Datastore` (`kvs/ds.py`) is the embedded datastore: `execute`, `query`
and `query_one` run SurrealQL (`syn/` parses, `exec/` plans and runs,
`idx/` and `graph/` serve KNN and graph hops) over the port's KV store,
and LIVE SELECT pushes its notifications through `server/fanout.py`.
`server/` serves a datastore over HTTP and WebSocket RPC (`rpc.py`),
`sdk/` is its client, and `python -m surrealdb_tpu_torch start` starts
it. `iam.py` signs users in (root, namespace, database and record
access) and verifies their tokens.

Importing the package (or any module of it) loads no kernel and never
initialises CUDA; the entry points run on the card unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package imports nothing of the SQL stack
    if name == "Datastore":
        from surrealdb_tpu_torch.kvs.ds import Datastore

        return Datastore
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
