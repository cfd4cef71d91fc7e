"""The port's twin of `tests/shard_harness.py`: in-process KV groups of
either package, a shard topology over them, and the 2-shard smoke's
statements, run through both packages for the sharded comparison tests
(`test_torch_shard.py`, `test_torch_shardvec.py`)."""

from __future__ import annotations

import contextlib
import importlib


def pkg(name: str, mod: str):
    """A module of the reference (`ref`) or the port (`port`)."""
    root = {"ref": "surrealdb_tpu", "port": "surrealdb_tpu_torch"}[name]
    return importlib.import_module(f"{root}.{mod}")


@contextlib.contextmanager
def sharded_cluster(name, split_keys, members_per_group: int = 1,
                    orphan_grace_s=None):
    """len(split_keys)+1 in-process KV groups of package `name` with the
    shard topology initialised over them; yields (servers_by_group,
    addrs_by_group). Each group is `members_per_group` KvServers (the
    primary first), wired as `--peers` would wire them."""
    serve_kv = pkg(name, "kvs.remote").serve_kv
    init_topology = pkg(name, "kvs.shard").init_topology
    groups = []
    try:
        for _g in range(len(split_keys) + 1):
            servers = [serve_kv("127.0.0.1", 0, block=False, fsync=False,
                                role="primary" if i == 0 else "replica")
                       for i in range(members_per_group)]
            addrs = [f"127.0.0.1:{s.server_address[1]}" for s in servers]
            if members_per_group > 1:
                for i, s in enumerate(servers):
                    s.configure_cluster(addrs, self_index=i)
            if orphan_grace_s is not None:
                for s in servers:
                    s.orphan_grace_s = orphan_grace_s
            groups.append((servers, addrs))
        init_topology([addrs for _s, addrs in groups],
                      [bytes(k) for k in split_keys])
        yield [s for s, _a in groups], [a for _s, a in groups]
    finally:
        for servers, _addrs in groups:
            for s in servers:
                with contextlib.suppress(Exception):
                    s.shutdown()
                    s.server_close()


# the reference's two_shard_smoke, statement by statement: (sql, ns, db)
SMOKE = [
    ("CREATE p:1 SET name = 'alice'", "a", "a"),
    ("CREATE q:1 SET name = 'bob'", "z", "z"),
    ("SELECT VALUE name FROM p", "a", "a"),
    ("SELECT VALUE name FROM q", "z", "z"),
    ("BEGIN; CREATE p:2 SET n = 2; THROW 'x'; COMMIT", "z", "z"),
    ("SELECT * FROM p", "z", "z"),
]


def smoke_results(ds):
    """The smoke's statements through `ds`: each statement's (error,
    repr of the result)."""
    out = []
    for sql, ns, db in SMOKE:
        out.append([(r.error, None if r.error else repr(r.result))
                    for r in ds.execute(sql, ns=ns, db=db)])
    return out
