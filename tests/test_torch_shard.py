"""The port's range-sharded KV (`kvs/shard.py`, `Datastore("shard://")`,
`kv-admin`, `/kv/topology`, the SDK's `remote://`) against the
reference's.

The shard map encodes byte for byte as the reference's; a 2-shard store
answers the reference's 2-shard smoke as the reference does; a
cross-shard transaction commits by 2PC and a single-shard one does not;
both coordinator-crash cases of the reference's `test_shard.py` end as
its do; `split_shard` while a client serves keeps scans stitched and
exact; the TSO windows of a sharded datastore and INFO FOR SYSTEM's
topology; `kv-admin` prints what the reference's prints. Inputs come
from seeded generators; everything compares exactly.
"""

import json
import random
import time
import urllib.request

import pytest

from torch_shard_harness import pkg, sharded_cluster, smoke_results

BOTH = ("ref", "port")


def _backend(name, meta, **kw):
    return pkg(name, "kvs.shard").ShardedBackend(meta, **kw)


@pytest.mark.parametrize("splits", [[], [b"m"], [b"/*n", b"/*t", b"\xfe"]])
def test_shard_map_encoding_is_the_references(splits):
    maps = {}
    for name in BOTH:
        S = pkg(name, "kvs.shard")
        bounds = [b""] + splits + [None]
        shards = [S.Shard(bounds[i], bounds[i + 1],
                          (f"127.0.0.1:{9000 + i}", f"127.0.0.1:{9100 + i}"),
                          i + 1) for i in range(len(splits) + 1)]
        maps[name] = S.ShardMap(7, shards)
    raw = maps["port"].encode()
    assert raw == maps["ref"].encode()
    back = pkg("ref", "kvs.shard").ShardMap.decode(raw)
    again = pkg("port", "kvs.shard").ShardMap.decode(maps["ref"].encode())
    assert again.encode() == back.encode() == raw
    assert [(s.beg, s.end, s.addrs, s.epoch) for s in again.shards] == \
        [(s.beg, s.end, s.addrs, s.epoch) for s in back.shards]


def test_topology_written_by_one_package_is_read_by_the_other():
    for writer, reader in (("ref", "port"), ("port", "ref")):
        with sharded_cluster(writer, [b"m"]) as (_srvs, addrs):
            m = pkg(reader, "kvs.shard").read_topology(addrs[0][0])
            assert [(s.beg, s.end, list(s.addrs)) for s in m.shards] == [
                (b"", b"m", addrs[0]), (b"m", None, addrs[1])]


def test_two_shard_smoke_answers_as_the_reference():
    got = {}
    for name in BOTH:
        with sharded_cluster(name, [b"/*n"]) as (srvs, addrs):
            ds = pkg(name, "kvs.ds").Datastore(f"shard://{addrs[0][0]}")
            try:
                res = smoke_results(ds)
                info = ds.query("INFO FOR SYSTEM")[0]
                shards = info["shards"]["shards"]
                got[name] = (res, [s["begin"] for s in shards],
                             info["shards"]["epoch"],
                             srvs[1][0].counters.get("twopc_prepares", 0))
            finally:
                ds.close()
    assert got["port"] == got["ref"]
    res, begins, epoch, prepares = got["port"]
    assert res[2] == [(None, "['alice']")] and res[3] == [(None, "['bob']")]
    assert res[5][0][0] == "The table 'p' does not exist"
    assert begins == ["", "/*n"] and epoch == 1 and prepares >= 1


def test_cross_shard_commit_by_2pc_and_single_shard_fast_path():
    got = {}
    for name in BOTH:
        with sharded_cluster(name, [b"m"]) as (srvs, addrs):
            a, b = srvs[0][0], srvs[1][0]
            be1, be2 = _backend(name, addrs[0][0]), _backend(name,
                                                             addrs[0][0])
            try:
                tx = be1.transaction(True)
                tx.set(b"alpha", b"1")
                tx.set(b"zeta", b"2")
                tx.commit()  # cross-shard: 2PC
                tx = be2.transaction(False)
                seen = [tx.get(b"alpha"), tx.get(b"zeta")]
                tx.cancel()
                placed = [a.vs.read_latest(b"alpha"),
                          b.vs.read_latest(b"zeta"),
                          a.vs.read_latest(b"zeta")]
                prep = [s.counters.get("twopc_prepares", 0) for s in (a, b)]
                for i in range(5):
                    tx = be1.transaction(True)
                    tx.set(f"a{i}".encode(), b"v")
                    tx.commit()
                prep2 = [s.counters.get("twopc_prepares", 0) for s in (a, b)]
                got[name] = (seen, placed, prep, prep2)
            finally:
                be1.close()
                be2.close()
    assert got["port"] == got["ref"]
    assert got["port"] == ([b"1", b"2"], [b"1", b"2", None], [1, 1], [1, 1])


@pytest.mark.parametrize("point", ["after_prepare", "after_mark"])
def test_coordinator_crash_ends_as_the_references(point):
    """The coordinator vanishes after every prepare (no decision: both
    participants resolve to abort) or right after the commit-log record
    (the record is the commit point: both resolve to commit)."""
    got = {}
    for name in BOTH:
        crash = pkg(name, "kvs.shard")._SimulatedCrash
        with sharded_cluster(name, [b"m"], orphan_grace_s=0.4) as (
                srvs, addrs):
            a, b = srvs[0][0], srvs[1][0]
            be = _backend(name, addrs[0][0])
            try:
                tx = be.transaction(True)
                tx.set(b"a1", b"x")
                tx.set(b"z1", b"x")
                tx._crash_point = point
                with pytest.raises(crash):
                    tx.commit()
                staged = bool(a.staged) and bool(b.staged)
                deadline = time.monotonic() + 10
                while (a.staged or b.staged) and time.monotonic() < deadline:
                    time.sleep(0.05)
                tx = be.transaction(False)
                vals = [tx.get(b"a1"), tx.get(b"z1")]
                tx.cancel()
                # locks released: the same keys commit cleanly now
                tx = be.transaction(True)
                tx.set(b"a1", b"v")
                tx.set(b"z1", b"v")
                tx.commit()
                got[name] = (staged or point == "after_mark",
                             bool(a.staged or b.staged), vals,
                             [s.counters.get("twopc_aborts", 0) for s in (a, b)],
                             [s.counters.get("twopc_commits", 0)
                              for s in (a, b)])
            finally:
                be.close()
    assert got["port"] == got["ref"]
    staged, left, vals, _aborts, _commits = got["port"]
    assert staged and not left
    assert vals == ([None, None] if point == "after_prepare"
                    else [b"x", b"x"])


def test_scans_stay_stitched_and_exact_through_a_split():
    """Random keys over a 3-shard store scan byte-identically to an
    unsharded store; a `split_shard` while the same client serves moves
    a slice behind the epoch fence, and the stale client's reads and
    scans stay exact and ordered across the new boundary."""
    from surrealdb_tpu_torch.kvs.mem import MemBackend
    from surrealdb_tpu_torch.kvs.remote import serve_kv
    from surrealdb_tpu_torch.kvs.shard import split_shard
    from surrealdb_tpu_torch.telemetry import Telemetry

    rng = random.Random(0x5EED)
    keys = sorted({bytes(rng.randrange(97, 123)
                         for _ in range(rng.randrange(1, 7)))
                   for _ in range(160)})
    data = {k: bytes(rng.randrange(256) for _ in range(rng.randrange(1, 12)))
            for k in keys}
    splits = sorted(rng.sample(keys[10:-10], 2))
    ref = MemBackend()
    tx = ref.transaction(True)
    for k, v in data.items():
        tx.set(k, v)
    tx.commit()
    spare = serve_kv("127.0.0.1", 0, block=False, fsync=False)
    tel = Telemetry()
    with sharded_cluster("port", splits) as (_srvs, addrs):
        be = _backend("port", addrs[0][0], telemetry=tel)
        try:
            tx = be.transaction(True)
            for k, v in data.items():
                tx.set(k, v)
            tx.commit()

            def windows(n):
                rt, st = ref.transaction(False), be.transaction(False)
                try:
                    assert list(st.scan(b"", b"\xff")) == \
                        list(rt.scan(b"", b"\xff"))
                    for _q in range(n):
                        beg, end = sorted((rng.choice(keys),
                                           rng.choice(keys)))
                        end += b"\x00"
                        limit = rng.choice([None, 1, 3, 10])
                        reverse = rng.random() < 0.4
                        assert list(st.scan(beg, end, limit, reverse)) == \
                            list(rt.scan(beg, end, limit, reverse)), (
                                beg, end, limit, reverse)
                finally:
                    rt.cancel()
                    st.cancel()

            windows(30)
            cut = keys[len(keys) * 3 // 4]
            m = split_shard(addrs[0][0], cut,
                            [f"127.0.0.1:{spare.server_address[1]}"])
            assert len(m.shards) == 4 and m.epoch == 2
            # the stale client: point reads re-route inline (a scan
            # that crosses the fence aborts retryably instead)
            before = tel.get("kv_shard_map_refreshes")
            tx = be.transaction(False)
            assert [tx.get(k) for k in keys] == [data[k] for k in keys]
            tx.cancel()
            assert tel.get("kv_shard_map_refreshes") > before
            windows(30)
            assert be.shard_map().epoch == 2
            moved = [k for k, _v in spare.vs.latest_items()
                     if k[:1] != b"\x00"]
            assert moved and min(moved) >= cut
        finally:
            be.close()
            spare.shutdown()
            spare.server_close()


def test_tso_windows_of_a_sharded_datastore():
    from surrealdb_tpu_torch.kvs.ds import Datastore

    with sharded_cluster("port", [b"m"]) as (_srvs, addrs):
        ds = Datastore(f"shard://{addrs[0][0]}")
        try:
            v1 = ds.next_versionstamp()
            v2 = ds.next_versionstamp()
            assert v2 == v1 + 1  # same window while fresh
            old_end = ds._tso_end
            ds._tso_expiry = 0.0  # force expiry
            v3 = ds.next_versionstamp()
            assert v3 >= old_end, "expired window remainder was drained"
            assert v1 >> 20 >= int(time.time() * 1000) - 60_000
        finally:
            ds.close()


def test_kv_admin_prints_what_the_reference_prints(capsys):
    """`kv-admin init`, `split` and `topology` through each package's
    CLI against running KV servers: the same map, printed alike (the
    addresses aside)."""
    out = {}
    for name in BOTH:
        serve_kv = pkg(name, "kvs.remote").serve_kv
        main = pkg(name, "__main__").main
        srvs = [serve_kv("127.0.0.1", 0, block=False, fsync=False)
                for _ in range(3)]
        addrs = [f"127.0.0.1:{s.server_address[1]}" for s in srvs]
        try:
            rc = [main(["kv-admin", "init", "--groups",
                        f"{addrs[0]};{addrs[1]}", "--shard-ranges", "m"]),
                  main(["kv-admin", "split", "t", "--meta", addrs[0],
                        "--to", addrs[2]]),
                  main(["kv-admin", "topology", "--meta", addrs[0]])]
            text = capsys.readouterr().out
            for i, a in enumerate(addrs):
                text = text.replace(a, f"<g{i}>")
            out[name] = (rc, text)
        finally:
            for s in srvs:
                s.shutdown()
                s.server_close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == [0, 0, 0]
    assert "shard map epoch 2: 3 range(s)" in out["port"][1]


def test_kv_topology_route_answers_as_the_reference():
    """GET /kv/topology on a sharded store's server: the reference's
    status and map for a signed-in root, its 401 for an anonymous
    request; `{}` on an unsharded store."""
    import base64

    got = {}
    for name in BOTH:
        S = pkg(name, "server")
        with sharded_cluster(name, [b"/*n"]) as (_srvs, addrs):
            out = []
            for path in (f"shard://{addrs[0][0]}", "memory"):
                ds = pkg(name, "kvs.ds").Datastore(path)
                ds.query("DEFINE USER root ON ROOT PASSWORD 'root' ROLES "
                         "OWNER")
                srv = S.make_server(ds, "127.0.0.1", 0)
                import threading

                threading.Thread(target=srv.serve_forever,
                                 daemon=True).start()
                base = f"http://127.0.0.1:{srv.server_address[1]}"
                try:
                    for auth in (None, "root:root"):
                        hdrs = {} if auth is None else {
                            "Authorization": "Basic " + base64.b64encode(
                                auth.encode()).decode()}
                        req = urllib.request.Request(base + "/kv/topology",
                                                     headers=hdrs)
                        try:
                            with urllib.request.urlopen(req, timeout=30) as r:
                                out.append((r.status, json.loads(r.read())))
                        except urllib.error.HTTPError as e:
                            out.append((e.code, json.loads(e.read())))
                finally:
                    srv.shutdown()
                    srv.server_close()
                    ds.close()
            for i, a in enumerate(addrs):
                out = json.loads(json.dumps(out).replace(a[0], f"<g{i}>"))
            got[name] = out
    assert got["port"] == got["ref"]
    anon, root, _anon_mem, root_mem = got["port"]
    assert anon[0] == 401 and root[0] == 200 and root_mem == [200, {}]
    assert [s["begin"] for s in root[1]["shards"]] == ["", "/*n"]
