"""The port's remote KV engine (`kvs/remote.py`, `kvs/net.py`, the store
leases and TSO windows of `node.py`) against the reference's.

- The codec: a message's CBOR body (`_encode`) and its checksummed log
  frame (`_frame_crc`) are byte-equal in both packages.
- The wire, both ways: one script of transactions (sets, deletes,
  ranges, a write-write conflict, savepoints, a cancelled transaction)
  runs through each package's `RemoteBackend` against each package's
  `serve_kv`; every crossing gives the same results and conflicts as the
  same-package pairs, and the servers' stores end equal key for key and
  byte for byte.
- The disk: each package opens a data directory the other wrote (WAL
  and snapshot), and the WAL cases of the reference's
  `test_wal_integrity.py` (a torn tail, a CRC failure mid-log, the
  snapshot CRC, a legacy WAL without CRCs) end the same in both.
- Replication and failover: the follower-read proof accepts and refuses
  the same requests in both packages; `RetryPolicy`'s backoff schedule
  from a seeded `random.Random` is the reference's; a primary killed
  (SIGKILL, the port's `kv` subprocesses) under write load loses no
  acknowledged write.
- The KV service imports neither torch nor numpy, and the memory kill
  switch (`mem.py`) refuses a statement as the reference's does.

Inputs are made from a seed with numpy; everything compares exactly
(these paths hold no floating-point arithmetic).
"""

import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import surrealdb_tpu.kvs.remote as RR
import surrealdb_tpu_torch.kvs.remote as PR
from surrealdb_tpu import wire as rwire
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch import wire as pwire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"ref": RR, "port": PR}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(*srvs):
    for s in srvs:
        try:
            s.shutdown()
            s.server_close()
        except OSError:
            pass


# -- the codec -----------------------------------------------------------------

def _messages():
    rng = np.random.default_rng(7)
    keys = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(1, 24, 6)]
    return [
        ["status"],
        ["get", keys[0], 17],
        ["range", keys[1], keys[2], 3, 100, True],
        ["commit", 9, [[keys[3], keys[4]], [keys[5], None]], [keys[0]]],
        ["repl_apply", 12, 3, 1.5e9, [[keys[1], b"v" * 300]]],
        ["ok", {"role": "primary", "seq": 4, "counters": {"a": 1}}],
        ["err", "kv not primary"],
        [[keys[2], b"x"], [keys[3], b""]],
    ]


@pytest.mark.parametrize("i", range(8))
def test_codec_is_the_references(i):
    msg = _messages()[i]
    body = PR._encode(msg)
    assert body == RR._encode(msg)
    assert PR._frame_crc(body) == RR._frame_crc(body)
    assert pwire.decode(body) == rwire.decode(body) == msg
    assert PR._LOG_MAGIC == RR._LOG_MAGIC


# -- the wire, both ways ------------------------------------------------------------

def _script(be):
    """One script of transactions through a `RemoteBackend`; returns
    each step's outcome (values, scans, error texts)."""
    rng = np.random.default_rng(11)
    out = []

    def step(fn):
        try:
            out.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001 — the text is the outcome
            out.append(("err", type(e).__name__, str(e)))

    keys = [b"/k/%03d" % i for i in range(40)]
    vals = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(40)]

    def fill():
        tx = be.transaction(True)
        for k, v in zip(keys, vals):
            tx.set(k, v)
        tx.commit()

    def read_some():
        tx = be.transaction(False)
        try:
            return [tx.get(keys[3]), tx.get(b"/missing"),
                    list(tx.scan(b"/k/010", b"/k/020")),
                    list(tx.scan(b"/k/", b"/k/\xff", limit=5, reverse=True))]
        finally:
            tx.cancel()

    def deletes():
        tx = be.transaction(True)
        tx.delete(keys[0])
        tx.delete_range(b"/k/030", b"/k/035")
        tx.commit()
        t2 = be.transaction(False)
        try:
            return [k for k, _v in t2.scan(b"/k/", b"/k/\xff")]
        finally:
            t2.cancel()

    def conflict():
        t1, t2 = be.transaction(True), be.transaction(True)
        t1.set(keys[5], b"one")
        t2.set(keys[5], b"two")
        t1.commit()
        try:
            t2.commit()
        except Exception as e:  # noqa: BLE001
            return ["conflict", str(e)]
        return ["no conflict"]

    def savepoints():
        tx = be.transaction(True)
        tx.set(b"/s/1", b"a")
        tx.new_save_point()
        tx.set(b"/s/2", b"b")
        tx.rollback_to_save_point()
        tx.new_save_point()
        tx.set(b"/s/3", b"c")
        tx.release_last_save_point()
        seen = [tx.get(b"/s/1"), tx.get(b"/s/2"), tx.get(b"/s/3")]
        tx.commit()
        t2 = be.transaction(False)
        try:
            return seen + [list(t2.scan(b"/s/", b"/s/\xff"))]
        finally:
            t2.cancel()

    def cancelled():
        tx = be.transaction(True)
        tx.set(b"/c/1", b"gone")
        tx.cancel()
        t2 = be.transaction(False)
        try:
            return t2.get(b"/c/1")
        finally:
            t2.cancel()

    def read_only_write():
        tx = be.transaction(False)
        try:
            tx.set(b"/ro", b"x")
            tx.commit()
        finally:
            tx.cancel()

    for fn in (fill, read_some, deletes, conflict, savepoints, cancelled,
               read_only_write, read_some):
        step(fn)
    return out


def _user_items(srv):
    """The server's keyspace less its internal `\\x00` rows (lease and
    replication state: wall-clock values)."""
    return [(k, v) for k, v in srv.vs.latest_items() if not k.startswith(b"\x00")]


def test_wire_crossings_give_the_same_results_and_bytes():
    outcomes, stores = {}, {}
    for client in ("ref", "port"):
        for server in ("ref", "port"):
            srv = PKG[server].serve_kv("127.0.0.1", 0, block=False,
                                       fsync=False)
            be = PKG[client].RemoteBackend(
                f"127.0.0.1:{srv.server_address[1]}")
            try:
                outcomes[client, server] = _script(be)
                stores[client, server] = _user_items(srv)
            finally:
                be.close()
                _stop(srv)
    want = outcomes["ref", "ref"]
    assert any(o[0] == "err" for o in want)  # the read-only write
    assert want[3] == ("ok", ["conflict", want[3][1][1]])
    for pair, got in outcomes.items():
        assert got == want, pair
    for pair, items in stores.items():
        assert items == stores["ref", "ref"], pair
    assert len(stores["ref", "ref"]) == 40 - 1 - 5 + 2


def test_remote_datastore_sql_matches_reference():
    """SurrealQL over `remote://` in both packages, each against the
    other package's KV server: the same results, the same record bytes."""
    from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore

    sql = ("DEFINE TABLE p SCHEMALESS; CREATE p:1 SET name = 'a', n = 1; "
           "CREATE p:2 SET name = 'b', n = 2; UPDATE p:1 SET n += 5; "
           "SELECT name, n FROM p ORDER BY n; DELETE p:2; "
           "SELECT VALUE id FROM p; BEGIN; CREATE p:3; THROW 'x'; COMMIT; "
           "SELECT count() FROM p GROUP ALL")
    res = {}
    for name, DS, server in (("port", PortDatastore, RR),
                             ("ref", RefDatastore, PR)):
        srv = server.serve_kv("127.0.0.1", 0, block=False, fsync=False)
        ds = DS(f"remote://127.0.0.1:{srv.server_address[1]}")
        try:
            out = ds.execute(sql, ns="t", db="t")
            res[name] = [(r.error, repr(r.result) if r.error is None
                          else None) for r in out]
            pre = PK.record_prefix("t", "t", "p")
            recs = [(k, v) for k, v in srv.vs.latest_items()
                    if k.startswith(pre)]
            res[name + "_recs"] = recs
        finally:
            ds.close()
            _stop(srv)
    assert res["port"] == res["ref"]
    assert res["port_recs"] == res["ref_recs"] and res["port_recs"]


# -- the disk ------------------------------------------------------------------------

def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _boot(mod, data_dir):
    srv = mod.KvServer(("127.0.0.1", 0), data_dir=data_dir, fsync=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _write_dir(mod, data_dir, n=10, compact=False):
    srv = mod.serve_kv("127.0.0.1", 0, block=False, data_dir=data_dir,
                       fsync=False)
    be = mod.RemoteBackend(f"127.0.0.1:{srv.server_address[1]}")
    for i in range(n):
        tx = be.transaction(True)
        tx.set(b"/v/%02d" % i, b"%d" % i)
        if i % 3 == 2:
            tx.delete(b"/v/%02d" % (i - 1))
        tx.commit()
    be.close()
    if compact:
        srv.WAL_COMPACT_BYTES = 1
        with srv.wal_lock:
            srv._compact()
    items = _user_items(srv)
    srv.kill()
    return items


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("compact", [False, True], ids=["wal", "snapshot"])
def test_data_dir_opens_in_the_other_package(tmp_path, writer, reader,
                                             compact):
    d = str(tmp_path)
    items = _write_dir(PKG[writer], d, compact=compact)
    for name in ("wal.log",) + (("snapshot.kv",) if compact else ()):
        with open(os.path.join(d, name), "rb") as f:
            assert f.read(8) == PR._LOG_MAGIC
    srv = _boot(PKG[reader], d)
    try:
        assert srv.counters["wal_crc_errors"] == 0
        assert _user_items(srv) == items and len(items) == 7
    finally:
        srv.kill()


def _wal_case(mod, d, case):
    """One of the reference's WAL integrity cases in package `mod`:
    (crc errors at the first reboot, the surviving values, crc errors at
    a second reboot)."""
    _write_dir(mod, d, compact=(case == "snapshot_crc"))
    if case == "tail":
        _flip(os.path.join(d, "wal.log"), -3)
    elif case == "midlog":
        # a byte inside the body of the middle frame (u32 len | u32 crc
        # | body after the 8-byte magic)
        wp = os.path.join(d, "wal.log")
        raw = open(wp, "rb").read()
        pos, starts = 8, []
        while pos + 8 <= len(raw):
            starts.append(pos)
            pos += 8 + int.from_bytes(raw[pos:pos + 4], "big")
        _flip(wp, starts[len(starts) // 2] + 10)
    elif case == "snapshot_crc":
        _flip(os.path.join(d, "snapshot.kv"), -5)
    srv = _boot(mod, d)
    first = (srv.counters["wal_crc_errors"], _user_items(srv))
    srv.kill()
    srv = _boot(mod, d)
    second = (srv.counters["wal_crc_errors"], _user_items(srv))
    srv.kill()
    return first, second


@pytest.mark.parametrize("case", ["tail", "midlog", "snapshot_crc"])
def test_wal_integrity_cases_end_as_the_references(tmp_path, case):
    got = {}
    for name, mod in PKG.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _wal_case(mod, str(d), case)
    assert got["port"] == got["ref"]
    (errs, items), (errs2, _items2) = got["port"]
    assert errs >= 1
    # detected, never applied: the store holds a prefix of the writes
    assert len(items) < 7
    if case == "tail":
        # the torn last record is gone, every earlier write survived,
        # and the healed log reboots clean
        assert len(items) == 6 and errs2 == 0
    if case == "snapshot_crc":
        assert errs2 == 0


def test_legacy_wal_reads_and_upgrades_as_the_references(tmp_path):
    import struct

    got = {}
    for name, mod in PKG.items():
        d = tmp_path / name
        d.mkdir()
        frames = b""
        for i in range(3):
            body = rwire.encode([[b"/k%d" % i, b"v%d" % i]])
            frames += struct.pack(">I", len(body)) + body
        (d / "wal.log").write_bytes(frames)
        srv = _boot(mod, str(d))
        first = _user_items(srv)
        srv.kill()
        assert (d / "wal.log").read_bytes()[:8] == PR._LOG_MAGIC
        srv = _boot(mod, str(d))
        got[name] = (first, _user_items(srv), srv.counters["wal_crc_errors"])
        srv.kill()
    assert got["port"] == got["ref"]
    assert got["port"][0] == [(b"/k%d" % i, b"v%d" % i) for i in range(3)]


# -- replication, follower reads and failover ----------------------------------------

def _replica_engine(mod):
    eng = mod.StandaloneKvEngine("test:0", role="replica",
                                 auto_failover=False)
    eng.vs.commit({mod.REPL_STATE_KEY: mod._encode(["lin", 7, 3])},
                  eng.vs.snapshot())
    eng.closed_ts = 100.0
    return eng


# the proof table of the reference's test_follower_reads.py: (requested
# ts, session floor, era floor, epoch floor, the replica's shard epoch)
PROOF_CASES = [
    (99.0, 0.0, 0, 0, None), (100.0, 0.0, 0, 0, None),
    (100.5, 0.0, 0, 0, None), (50.0, 0.0, 0, 0, None),
    (50.0, 100.5, 0, 0, None), (50.0, 100.0, 0, 0, None),
    (50.0, 0.0, 3, 0, None), (50.0, 0.0, 4, 0, None),
    (50.0, 0.0, 0, 2, None), (50.0, 0.0, 0, 2, 2), (50.0, 0.0, 0, 3, 2),
]


@pytest.mark.parametrize("case", PROOF_CASES, ids=str)
def test_follower_read_proof_table(case):
    req, floor, era, epoch, shard_epoch = case
    got = {}
    for name, mod in PKG.items():
        eng = _replica_engine(mod)
        if shard_epoch is not None:
            eng.shard = (b"", None, shard_epoch)
        try:
            got[name] = ("ok", eng.follower_read_proof(req, floor, era,
                                                       min_epoch=epoch))
        except Exception as e:  # noqa: BLE001
            got[name] = ("err", type(e).__name__, str(e))
        got[name] += (dict(eng.counters),)
    assert got["port"] == got["ref"]


def test_follower_dispatch_refuses_unproven_reads_as_the_reference():
    frames = [["snap"], ["get_latest", b"/k/1"],
              ["snap_follower", 99.0, 0.0, 0], ["get", b"/k/1", None],
              ["range", b"/k/", b"/k/\xff", None, None, False],
              ["get", b"/k/1", 999], ["rel", None], ["get", b"/k/1", None]]
    got = {}
    for name, mod in PKG.items():
        eng = _replica_engine(mod)
        eng.vs.commit({b"/k/1": b"v1"}, eng.vs.snapshot())
        cstate = eng.new_conn_state()
        snap, out = None, []
        for f in frames:
            f = [snap if x is None and i == len(f) - 1 and f[0] in (
                "get", "rel") else x for i, x in enumerate(f)]
            if f[0] == "range":
                f[3] = snap
            resp, _ = eng.handle_frame(f, cstate)
            if f[0] == "snap_follower" and resp[0] == "ok":
                snap = resp[1][0]
                resp = ["ok", resp[1][1:]]
            out.append(resp)
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][3] == ["ok", b"v1"]


@pytest.mark.parametrize("jitter", [0.0, 0.5, 0.9])
def test_retry_backoff_schedule_is_the_references(jitter):
    sched = {}
    for name, mod in PKG.items():
        rnd = random.Random(1234)
        pol = mod.RetryPolicy(deadline_s=60, base_ms=25, max_ms=1000,
                              jitter=jitter, rng=rnd.random)
        sched[name] = [(pol.backoff_bounds(i), pol.backoff(i))
                       for i in range(16)]
    assert sched["port"] == sched["ref"]


def test_retry_classification_is_the_references():
    import surrealdb_tpu.err as RE
    import surrealdb_tpu_torch.err as PE

    texts = ["kv not primary", "kv connection lost", "kv conflict",
             "kv wrong shard epoch 3", "kv shard unavailable",
             "kv follower too stale", "write not replicated", "auth"]
    for t in texts:
        assert PR.is_retryable(PE.SdbError(t)) == RR.is_retryable(
            RE.SdbError(t)), t
    for e in (ConnectionResetError("x"), socket.timeout(), OSError("y"),
              ValueError("z")):
        assert PR.is_retryable(e) == RR.is_retryable(e)
    assert PR.is_retryable(PE.RetryableKvError("x"))


def test_tso_windows_and_store_leases_as_the_references():
    """node.py's store-level lease and TSO window helpers over each
    package's store: the same winners, and disjoint increasing windows."""
    import surrealdb_tpu.node as RN
    import surrealdb_tpu_torch.node as PN
    from surrealdb_tpu.kvs.mem import VersionedStore as RVS
    from surrealdb_tpu_torch.kvs.mem import VersionedStore as PVS

    got = {}
    for name, N, VS, mod in (("ref", RN, RVS, RR), ("port", PN, PVS, PR)):
        vs = VS()
        seq = [N.store_lease_acquire(vs, N.KV_PRIMARY_LEASE, "a", 30.0),
               N.store_lease_acquire(vs, N.KV_PRIMARY_LEASE, "b", 30.0),
               N.store_lease_acquire(vs, N.KV_PRIMARY_LEASE, "a", 30.0),
               N.store_lease_read(vs, N.KV_PRIMARY_LEASE)[0]]
        srv = mod.serve_kv("127.0.0.1", 0, block=False, fsync=False)
        be = mod.RemoteBackend(f"127.0.0.1:{srv.server_address[1]}")
        try:
            w = [N.lease_tso_window(lambda: be.transaction(True), 8)
                 for _ in range(3)]
        finally:
            be.close()
            _stop(srv)
        assert all(b[0] == a[1] or b[0] > a[1] for a, b in zip(w, w[1:]))
        assert all(e - s == 8 for s, e in w)
        got[name] = seq
    assert got["port"] == got["ref"] == [True, False, True, "a"]
    assert PN.KV_TSO_KEY == RN.KV_TSO_KEY


def _spawn_kv(port, role, peers, data_dir, extra=()):
    """A `python -m surrealdb_tpu_torch kv` member: a real process, so a
    SIGKILL is a real death."""
    p = subprocess.Popen(
        [sys.executable, "-m", "surrealdb_tpu_torch", "kv",
         "--bind", f"127.0.0.1:{port}", "--role", role,
         "--peers", ",".join(peers), "--failover-timeout", "1.0",
         "--lease-ttl", "0.8", "--data-dir", data_dir, "--no-fsync",
         *extra],
        cwd=ROOT, env={**os.environ, "SURREAL_DEVICE": "off"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    for _ in range(150):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return p
        except OSError:
            time.sleep(0.1)
    p.kill()
    raise RuntimeError(f"kv {role} on :{port} did not come up")


def test_kill_primary_promote_zero_acked_loss(tmp_path):
    """The reference's failover contract through the port's `kv`
    processes: SIGKILL the primary under concurrent write load; the
    replica promotes itself through the lease; every write acknowledged
    before the kill is readable after the promotion."""
    from surrealdb_tpu_torch.err import RetryableKvError

    p1, p2 = _free_port(), _free_port()
    peers = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    prim = _spawn_kv(p1, "primary", peers, str(tmp_path / "p"))
    repl = _spawn_kv(p2, "replica", peers, str(tmp_path / "r"))
    be = None
    try:
        be = PR.RemoteBackend(
            ",".join(peers), connect_timeout=0.5,
            policy=PR.RetryPolicy(deadline_s=20, base_ms=25, max_ms=500))
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            st = PR._status_of(("127.0.0.1", p1), None)
            if st and st.get("attached_replicas") == 1:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("replica never attached")
        acked, lock = [], threading.Lock()

        def worker(w):
            for i in range(12):
                key = f"w{w}:{i}".encode()
                while True:
                    try:
                        tx = be.transaction(True)
                        tx.set(key, b"v")
                        tx.commit()
                        break
                    except RetryableKvError:
                        continue  # idempotent write: safe to re-run
                with lock:
                    acked.append(key)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        while True:
            with lock:
                if len(acked) >= 10:
                    break
            time.sleep(0.005)
        prim.send_signal(signal.SIGKILL)
        prim.wait()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads), "writers hung"
        st = PR._status_of(("127.0.0.1", p2), None)
        assert st is not None and st["role"] == "primary", st
        assert st["counters"].get("promotions_lease") == 1, st
        tx = be.transaction(False)
        present = {k for k, _v in tx.scan(b"w", b"x")}
        tx.cancel()
        missing = [k for k in acked if k not in present]
        assert not missing and len(acked) == 72, missing[:10]
    finally:
        if be is not None:
            be.close()
        for proc in (prim, repl):
            proc.kill()
            proc.wait()


# -- the KV service stays free of torch and numpy ---------------------------------------

_WRAP = ("import runpy, sys, atexit\n"
         "def _mods():\n"
         "    heavy = sorted(m for m in ('torch', 'numpy', 'jax') "
         "if m in sys.modules)\n"
         "    sys.stdout.write('MODULES ' + ','.join(heavy) + '\\n')\n"
         "    sys.stdout.flush()\n"
         "atexit.register(_mods)\n"
         "import signal\n"
         "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
         "sys.argv = ['surrealdb_tpu_torch'] + sys.argv[1:]\n"
         "runpy.run_module('surrealdb_tpu_torch', run_name='__main__')\n")


def test_kv_service_imports_neither_torch_nor_numpy(tmp_path):
    """`kv` and `kv-admin topology` start as a user starts them (`python
    -m surrealdb_tpu_torch ...`, here through a wrapper that prints which
    of torch, numpy and jax are loaded when the process exits): none is.
    Importing `kvs.remote` and `kvs.shard` loads none either."""
    env = {**os.environ, "SURREAL_DEVICE": "off"}
    port = _free_port()
    kv = subprocess.Popen(
        [sys.executable, "-c", _WRAP, "kv", "--bind", f"127.0.0.1:{port}",
         "--data-dir", str(tmp_path / "d"), "--no-fsync"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        for _ in range(150):
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=0.2).close()
                break
            except OSError:
                time.sleep(0.1)
        PR.serve_kv  # noqa: B018 — the module under test is loaded here
        from surrealdb_tpu_torch.kvs.shard import init_topology

        init_topology([[f"127.0.0.1:{port}"]], [])
        adm = subprocess.run(
            [sys.executable, "-c", _WRAP, "kv-admin", "topology", "--meta",
             f"127.0.0.1:{port}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
        assert adm.returncode == 0, adm.stderr
        assert "shard map epoch" in adm.stdout and "1 range(s)" in adm.stdout
        assert "MODULES \n" in adm.stdout
    finally:
        kv.send_signal(signal.SIGTERM)
        out, err = kv.communicate(timeout=30)
    assert f"kv service on 127.0.0.1:{port} (primary)".encode() in out, err
    assert b"MODULES \n" in out, out
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, surrealdb_tpu_torch.kvs.remote, "
         "surrealdb_tpu_torch.kvs.shard, surrealdb_tpu_torch.__main__; "
         "print(sorted(m for m in ('torch', 'numpy', 'jax') "
         "if m in sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert probe.stdout.strip() == "[]", probe


# -- the memory kill switch ---------------------------------------------------------

def test_memory_threshold_refuses_as_the_reference(monkeypatch):
    from surrealdb_tpu import cnf as rcnf
    from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
    from surrealdb_tpu_torch import cnf as pcnf
    from surrealdb_tpu_torch import mem as PM
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore

    sql = "CREATE a:1 SET v = 1; SELECT * FROM a"
    got = {}
    for name, DS, c in (("ref", RefDatastore, rcnf),
                        ("port", PortDatastore, pcnf)):
        ds = DS("memory")
        try:
            monkeypatch.setattr(c, "MEMORY_THRESHOLD", 1)  # floors at 1 MiB
            refused = [(r.error, r.result) for r in ds.execute(sql, ns="t",
                                                               db="t")]
            monkeypatch.setattr(c, "MEMORY_THRESHOLD", 0)
            allowed = [(r.error, repr(r.result))
                       for r in ds.execute(sql, ns="t", db="t")]
        finally:
            ds.close()
        got[name] = (refused, allowed)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [(PM.MEMORY_THRESHOLD_MSG, None)] * 2
    assert got["port"][1][0][0] is None
    assert PM.current_rss() > 1 << 20
