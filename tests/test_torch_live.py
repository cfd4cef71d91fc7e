"""The port's live queries (`server/fanout.py`, the LIVE / KILL
statements, the capture on the write path and the publish at commit)
against the reference's: the same script runs through the reference's
`Datastore("memory")` and the port's, and the two deliver the same
notifications in the same order.

Each case runs twice: with the hub's dispatch workers and session writer
threads (`threads`), and in the hub's manual mode (`manual`), where the
test pumps dispatch and delivery itself, so every interleaving is the
same in both packages and the overflow cases compare exactly.

Tolerance: a notification compares as (action, record, result),
normalised as `torch_sql_harness.norm` does (floats to atol 1e-4, rtol
1e-5, everything else exactly); live query ids are random uuids, so
they are compared only as "the same subscription" within one package.
"""

import threading
import time

import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
from surrealdb_tpu.server import fanout as RFO
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore
from surrealdb_tpu_torch.server import fanout as PFO
from torch_sql_harness import norm, same

NS, DB = "test", "test"


def _wait(pred, timeout=5.0, every=0.01):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _live(ds, sql):
    out = ds.execute(sql, ns=NS, db=DB)
    assert out[-1].error is None, out[-1].error
    return str(out[-1].result.u)


def _note(n, lids):
    """A notification as (subscription, action, record, result); the
    subscription as its index in `lids` (the uuids differ between the
    packages)."""
    return (lids.index(str(n.live_id)) if str(n.live_id) in lids else None,
            n.action, norm(n.record), norm(n.result))


class Side:
    """One package's datastore, its hub in the case's mode."""

    def __init__(self, ds, fanout_mod, mode):
        self.ds = ds
        self.mode = mode
        if mode == "manual":
            ds.fanout.close_all()
            ds.fanout = fanout_mod.FanoutHub(ds, manual=True)

    def flush(self):
        assert self.ds.fanout.flush(5.0), "dispatch backlog failed to drain"

    def pump(self, ob):
        """Deliver an outbox's queue (manual mode), or wait until its
        writer thread has (threads)."""
        if self.mode == "manual":
            while ob.pump():
                pass
        else:
            assert _wait(lambda: ob.queue_len() == 0)


@pytest.fixture(params=["threads", "manual"])
def pair(request):
    ref = Side(RefDatastore("memory"), RFO, request.param)
    port = Side(PortDatastore("memory"), PFO, request.param)
    try:
        yield ref, port
    finally:
        ref.ds.close()
        port.ds.close()


def _both(pair, scenario):
    """Run `scenario(side)` on both sides; assert equal observations."""
    ref, port = pair
    r = scenario(ref)
    p = scenario(port)
    same(r, p)
    return p


# -- the registry ---------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_subscription_registry_index(pkg):
    if pkg == "port":
        from surrealdb_tpu_torch.catalog import SubscriptionDef
        reg = PFO.SubscriptionRegistry()
    else:
        from surrealdb_tpu.catalog import SubscriptionDef
        reg = RFO.SubscriptionRegistry()
    a = SubscriptionDef(id="a", ns="n", db="d", tb="t1")
    b = SubscriptionDef(id="b", ns="n", db="d", tb="t1")
    c = SubscriptionDef(id="c", ns="n", db="d", tb="t2")
    reg["a"], reg["b"], reg["c"] = a, b, c
    assert len(reg) == 3 and "a" in reg and reg.get("c") is c
    assert reg.count_for("n", "d", "t1") == 2
    assert reg.count_for("n", "d", "t2") == 1
    assert reg.count_for("n", "d", "zz") == 0
    assert {s.id for s in reg.for_table("n", "d", "t1")} == {"a", "b"}
    assert reg.pop("a") is a and reg.pop("a") is None
    assert reg.count_for("n", "d", "t1") == 1
    # registration stamps the watermark (no history replay)
    assert b._fanout_seq > 0
    reg.clear()
    assert len(reg) == 0 and reg.count_for("n", "d", "t2") == 0


# -- embedded delivery (post-commit dispatch) -----------------------------------


def test_commit_order_exactly_once(pair):
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        lid = _live(side.ds, "LIVE SELECT * FROM ord")
        for i in range(25):
            side.ds.query(f"CREATE ord:{i} SET v = {i}", ns=NS, db=DB)
        side.ds.query("UPDATE ord:3 SET v = 99; DELETE ord:4", ns=NS, db=DB)
        side.flush()
        return [_note(n, [lid]) for n in got]

    out = _both(pair, run)
    assert [n[3]["v"] for n in out[:25]] == list(range(25))
    assert [n[1] for n in out] == ["CREATE"] * 25 + ["UPDATE", "DELETE"]


def test_projection_condition_and_diff(pair):
    """A condition, a projection and DIFF are matched after the commit
    against the snapshotted documents, in both packages alike."""
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        lids = [_live(side.ds, "LIVE SELECT v, v * 2 AS w FROM prj "
                               "WHERE v > 1"),
                _live(side.ds, "LIVE SELECT DIFF FROM prj"),
                _live(side.ds, "LIVE SELECT id FROM prj")]
        side.ds.query("CREATE prj:1 SET v = 1; CREATE prj:2 SET v = 2; "
                      "UPDATE prj:1 SET v = 5, x = 'a'; DELETE prj:2",
                      ns=NS, db=DB)
        side.flush()
        return [_note(n, lids) for n in got]

    out = _both(pair, run)
    assert {n[0] for n in out} == {0, 1, 2}


def test_sub_registered_mid_transaction_receives_commit(pair):
    """The watermark is stamped at COMMIT: a subscription registered
    while the writing transaction is still open receives the event."""
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        pre = _live(side.ds, "LIVE SELECT * FROM mid")
        out = side.ds.execute(
            "BEGIN; CREATE mid:1 SET v = 1; LIVE SELECT * FROM mid; COMMIT;",
            ns=NS, db=DB)
        assert all(r.error is None for r in out), [r.error for r in out]
        mid = str(out[2].result.u)
        side.flush()
        assert _wait(lambda: len(got) == 2)
        return sorted(_note(n, [pre, mid]) for n in got)

    out = _both(pair, run)
    assert [n[0] for n in out] == [0, 1]


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_live_binds_outbox_atomically(pkg):
    """Routing binds inside the LIVE statement itself (through
    session.live_outbox), never later at the rpc layer."""
    if pkg == "port":
        from surrealdb_tpu_torch.kvs.ds import Session
        ds = PortDatastore("memory")
    else:
        from surrealdb_tpu.kvs.ds import Session
        ds = RefDatastore("memory")
    try:
        ob = ds.fanout.register_session(lambda notes: None)
        sess = Session(ns=NS, db=DB, auth_level="owner")
        sess.live_outbox = ob
        out = ds.execute("LIVE SELECT * FROM ab", session=sess)
        lid = str(out[-1].result.u)
        assert lid in ob.lids
        assert ds.fanout._routes.get(lid) is ob
    finally:
        ds.close()


def test_cancelled_and_failed_txns_never_notify(pair):
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        lid = _live(side.ds, "LIVE SELECT * FROM ctx")
        res = []
        for sql in ("BEGIN; CREATE ctx:a SET v = 1; CANCEL;",
                    "BEGIN; CREATE ctx:b SET v = 2; THROW 'boom'; COMMIT;",
                    # a failed statement rolls back to its savepoint and
                    # its captured events go with it
                    "BEGIN; CREATE ctx:d SET v = 4; CREATE ctx:d SET v = 5; "
                    "COMMIT;",
                    "CREATE ctx:c SET v = 3"):
            res.append([r.error for r in side.ds.execute(sql, ns=NS,
                                                         db=DB)])
        side.flush()
        return res, [_note(n, [lid]) for n in got]

    res, notes = _both(pair, run)
    assert [n[3]["v"] for n in notes] == [3], \
        "uncommitted mutations leaked to subscribers"


def test_kill_stops_delivery(pair):
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        lid = _live(side.ds, "LIVE SELECT * FROM klt")
        side.ds.query("CREATE klt:1 SET v = 1", ns=NS, db=DB)
        side.flush()
        assert _wait(lambda: len(got) == 1)
        t0 = time.monotonic()
        out = side.ds.execute("KILL $id", ns=NS, db=DB, vars={"id": lid})
        kill_ms = (time.monotonic() - t0) * 1000
        assert out[-1].error is None
        assert kill_ms < 250, f"KILL took {kill_ms:.0f}ms"
        side.ds.query("CREATE klt:2 SET v = 2", ns=NS, db=DB)
        side.flush()
        time.sleep(0.05)
        assert lid not in side.ds.live_queries
        # a second KILL of the same id, and of an unknown id
        again = side.ds.execute("KILL $id", ns=NS, db=DB, vars={"id": lid})
        bad = side.ds.execute("KILL 'nope'", ns=NS, db=DB)
        return ([_note(n, [lid]) for n in got],
                again[0].error is not None, bad[0].error)

    notes, again_failed, bad = _both(pair, run)
    assert len(notes) == 1, "killed live query still delivered"
    assert again_failed and "nope" in bad


def test_kill_falls_back_to_inflight_query(pair):
    """KILL of a normal query's id cancels it (the in-flight registry)."""
    def run(side):
        ds = side.ds
        out = {}

        def victim():
            out["r"] = ds.execute("SLEEP 20s; RETURN 1", ns=NS, db=DB)

        t = threading.Thread(target=victim, daemon=True)
        t.start()
        assert _wait(lambda: any("SLEEP" in q["statement"]
                                 for q in ds.inflight.snapshot()))
        qid = next(q["id"] for q in ds.inflight.snapshot()
                   if "SLEEP" in q["statement"])
        killed = ds.execute(f"KILL '{qid}'", ns=NS, db=DB)
        t.join(timeout=5)
        assert not t.is_alive()
        return killed[0].error, [r.error for r in out["r"]]

    _both(pair, run)


def test_eval_error_poisons_only_that_subscription(pair):
    def run(side):
        got = []
        side.ds.notification_handlers.append(got.append)
        good = _live(side.ds, "LIVE SELECT * FROM psn")
        bad = _live(side.ds,
                    "LIVE SELECT * FROM psn WHERE string::len(v) > 0")
        out = side.ds.execute("CREATE psn:1 SET v = 7", ns=NS, db=DB)
        assert out[-1].error is None, "eval error must NEVER fail the write"
        side.flush()
        assert _wait(lambda: len(got) >= 2)
        assert side.ds.telemetry.get("live_eval_errors") == 1
        alive = (bad in side.ds.live_queries, good in side.ds.live_queries)
        side.ds.query("CREATE psn:2 SET v = 8", ns=NS, db=DB)
        side.flush()
        assert _wait(lambda: len(got) >= 3)
        return [_note(n, [good, bad]) for n in got], alive

    notes, alive = _both(pair, run)
    assert alive == (False, True)
    assert [(n[0], n[1]) for n in notes] == [
        (0, "CREATE"), (1, "ERROR"), (0, "CREATE")]
    assert "string::len" in notes[1][3]


def test_notifications_buffer_bounded(pair, monkeypatch):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "NOTIFY_BUFFER_CAP", 5)

    def run(side):
        ds = side.ds
        lid = _live(ds, "LIVE SELECT * FROM cap")
        for i in range(20):
            ds.query(f"CREATE cap:{i}", ns=NS, db=DB)
        side.flush()
        held = len(ds.notifications)
        dropped = ds.telemetry.get("notifications_dropped")
        drained = [_note(n, [lid]) for n in ds.drain_notifications()]
        ds.query("CREATE cap:zz", ns=NS, db=DB)
        side.flush()
        return held, dropped, drained, len(ds.notifications)

    held, dropped, drained, after = _both(pair, run)
    assert held == 5 and dropped == 15 and after == 1
    assert [n[2] for n in drained] == [("rid", "cap", i) for i in range(5)]


# -- the outbox's overflow policies ---------------------------------------------


def _frozen_session(side, depth, policy=None, close_conn=None):
    got, gate = [], threading.Event()

    def send(notes):
        gate.wait(10)
        got.extend(notes)

    ob = side.ds.fanout.register_session(send, depth=depth, policy=policy,
                                         close_conn=close_conn)
    return ob, got, gate


def test_overflow_notify_policy(pair):
    def run(side):
        ds = side.ds
        ob, got, gate = _frozen_session(side, depth=4)
        lid = _live(ds, "LIVE SELECT * FROM ovn")
        ds.fanout.bind(lid, ob)
        for i in range(30):
            ds.query(f"CREATE ovn:{i} SET v = {i}", ns=NS, db=DB)
        side.flush()
        assert ds.telemetry.get("live_overflows") >= 1
        assert ob.dropped > 0 and not ob.closed
        gate.set()
        side.pump(ob)
        # the laggard recovered: fresh writes flow again
        n0 = len(got)
        ds.query("CREATE ovn:zz SET v = 99", ns=NS, db=DB)
        side.flush()
        side.pump(ob)
        assert _wait(lambda: len(got) > n0)
        notes = [_note(n, [lid]) for n in got]
        if side.mode == "manual":
            # one interleaving in both packages: the whole sequence
            return notes, ob.dropped, ob.overflows
        return notes[-1], None, None

    notes, _d, _o = _both(pair, run)
    last = notes[-1] if isinstance(notes, list) else notes
    assert last[1] == "CREATE" and last[3]["v"] == 99


def test_overflow_disconnect_policy(pair):
    def run(side):
        kicked = threading.Event()
        ob, _got, gate = _frozen_session(
            side, depth=4, policy="disconnect", close_conn=kicked.set)
        lid = _live(side.ds, "LIVE SELECT * FROM ovd")
        side.ds.fanout.bind(lid, ob)
        for i in range(30):
            side.ds.query(f"CREATE ovd:{i}", ns=NS, db=DB)
        side.flush()
        assert kicked.wait(5), "laggard was never kicked"
        gate.set()
        return (ob.closed,
                side.ds.telemetry.get("live_overflow_disconnects") >= 1)

    assert _both(pair, run) == (True, True)


def test_error_tombstone_survives_overflow(pair):
    """A poisoned subscription's typed ERROR must not vanish into a
    later queue reset."""
    def run(side):
        ob, got, gate = _frozen_session(side, depth=4)
        bad = _live(side.ds,
                    "LIVE SELECT * FROM tmb WHERE string::len(v) > 0")
        good = _live(side.ds, "LIVE SELECT * FROM tmb")
        side.ds.fanout.bind(bad, ob)
        side.ds.fanout.bind(good, ob)
        for i in range(30):
            side.ds.query(f"CREATE tmb:{i} SET v = {i}", ns=NS, db=DB)
        side.flush()
        gate.set()
        side.pump(ob)
        notes = [_note(n, [good, bad]) for n in got]
        assert any(n[0] == 1 and n[1] == "ERROR" for n in notes), \
            "poison tombstone was dropped by the overflow reset"
        return notes if side.mode == "manual" else None

    _both(pair, run)


def test_drain_flushes_pending_deliveries(pair):
    def run(side):
        got = []

        def slow_send(notes):
            time.sleep(0.01)
            got.extend(notes)

        ob = side.ds.fanout.register_session(slow_send, depth=512)
        lid = _live(side.ds, "LIVE SELECT * FROM drn")
        side.ds.fanout.bind(lid, ob)
        for i in range(40):
            side.ds.query(f"CREATE drn:{i} SET v = {i}", ns=NS, db=DB)
        assert side.ds.fanout.drain(timeout=10)
        if side.mode == "manual":
            side.pump(ob)  # the queue survives the close (flush=True)
        assert _wait(lambda: len(got) == 40), \
            f"drain lost queued notifications ({len(got)}/40)"
        assert ob.closed
        ob.join()
        return [_note(n, [lid]) for n in got]

    out = _both(pair, run)
    assert [n[3]["v"] for n in out] == list(range(40))


def test_concurrent_writers_publish_in_commit_order(pair):
    """Four writers race on one table: every subscriber sees each
    writer's rows in its commit order (the hub's commit-order lock), and
    the table's last state matches the last notification per record."""
    def run(side):
        ds = side.ds
        got = []
        ds.notification_handlers.append(got.append)
        lid = _live(ds, "LIVE SELECT * FROM race")

        def w(wi):
            for j in range(30):
                # a write-write conflict commits nothing (and publishes
                # nothing): the writer retries the same row
                while True:
                    r = ds.execute(f"UPSERT race:{j % 5} SET w = {wi}, "
                                   f"j = {j}", ns=NS, db=DB)[0]
                    if r.error is None:
                        break
                    assert "conflict" in r.error, r.error

        ts = [threading.Thread(target=w, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        side.flush()
        last = {}
        seen = {}
        for n in got:
            wi, j = n.result["w"], n.result["j"]
            assert seen.get(wi, -1) < j, "a writer's rows out of order"
            seen[wi] = j
            last[n.record.id] = (wi, j)
        rows = ds.query("SELECT * FROM race ORDER BY id", ns=NS, db=DB)[0]
        assert {r["id"].id: (r["w"], r["j"]) for r in rows} == last
        return len(got), sorted(last), lid is not None

    assert _both(pair, run)[0] == 120


# -- disconnect GC and the sweep ------------------------------------------------


def test_disconnect_gc_and_sweep(pair):
    """A WebSocket session closing without KILL leaves no live query
    behind (the session-close path); the periodic sweep is the backstop
    for an outbox that closed without its session unwinding."""
    def run(side):
        if side.ds.__class__ is PortDatastore:
            from surrealdb_tpu_torch import key as K
            from surrealdb_tpu_torch.sdk import connect
            from surrealdb_tpu_torch.server import make_server
        else:
            from surrealdb_tpu import key as K
            from surrealdb_tpu.sdk import connect
            from surrealdb_tpu.server import make_server
        ds = side.ds
        srv = make_server(ds, "127.0.0.1", 0, unauthenticated=True,
                          max_inflight=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            db = connect(f"ws://127.0.0.1:{srv.server_address[1]}",
                         fmt="json")
            db.use(NS, DB)
            db.live("gone", lambda n: None)
            held = len(ds.live_queries)
            db.close()  # dies without KILL
            assert _wait(lambda: len(ds.live_queries) == 0), \
                "session close leaked its live query"
            txn = ds.transaction(write=False)
            rows = list(txn.scan(*K.prefix_range(K.lq_prefix(NS, DB,
                                                             "gone"))))
            txn.cancel()
        finally:
            srv.shutdown()
        got = []
        ob = ds.fanout.register_session(got.extend)
        lid = _live(ds, "LIVE SELECT * FROM swp")
        ds.fanout.bind(lid, ob)
        ob.cancel.set()  # a hard death (no unregister ran)
        swept = ds.fanout.sweep_dead_sessions()
        return held, rows, swept, lid in ds.live_queries, \
            ds.telemetry.get("live_gc_collected")

    assert _both(pair, run) == (1, [], 1, False, 2)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_sweep_tick_returns_none(pkg):
    """Runtime.every treats a NUMERIC tick return as the next delay: a
    tick that leaked its count would spin the sweep loop hot."""
    ds = PortDatastore("memory") if pkg == "port" else RefDatastore("memory")
    captured = {}

    class FakeRuntime:
        def every(self, interval, tick, name="t", immediate=False):
            captured["tick"] = tick

            class H:
                def cancel(self):
                    pass
            return H()

    try:
        ds.fanout._runtime = FakeRuntime()
        ds.fanout.register_session(lambda notes: None)
        assert captured["tick"]() is None
    finally:
        ds.close()


def test_port_runtime_seam():
    """kvs/net.py: the ambient clock swaps for a block; a periodic tick
    runs, takes a numeric return as its next delay and stops on STOP."""
    from surrealdb_tpu_torch.kvs import net

    class Fixed(net.Clock):
        def wall(self):
            return 123.0

        def monotonic(self):
            return 7.0

        def sleep(self, s):
            pass

    with net.use_clock(Fixed()):
        assert net.wall() == 123.0 and net.mono() == 7.0
    assert net.wall() != 123.0
    ticks = []

    def tick():
        ticks.append(time.monotonic())
        return net.STOP if len(ticks) == 3 else 0.01

    net.REAL_RUNTIME.every(10.0, tick, name="t", immediate=True)
    assert _wait(lambda: len(ticks) == 3)
    time.sleep(0.05)
    assert len(ticks) == 3


# -- INFO FOR SYSTEM's live block and the node tasks -----------------------------


def test_info_live_block_and_node_rows(pair):
    def run(side):
        ds = side.ds
        ob = ds.fanout.register_session(lambda notes: None)
        lid = _live(ds, "LIVE SELECT * FROM inf")
        ds.fanout.bind(lid, ob)
        ds.query("CREATE inf:1", ns=NS, db=DB)
        side.flush()
        side.pump(ob)
        live = ds.query("INFO FOR SYSTEM", ns=NS, db=DB)[0]["live"]
        tb = ds.query("INFO FOR TABLE inf", ns=NS, db=DB)[0]
        return live, tb["lives"]

    live, lives = _both(pair, run)
    assert live["subscriptions"] == 1 and live["routes"] == 1
    assert live["sent"] == 1


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_node_tasks_and_dead_node_gc(pkg):
    """A served node heartbeats; membership_check expires a stale node
    and drops the live queries it registered (one lease winner)."""
    if pkg == "port":
        from surrealdb_tpu_torch import key as K
        from surrealdb_tpu_torch import node as N
        ds = PortDatastore("memory")
    else:
        from surrealdb_tpu import key as K
        from surrealdb_tpu import node as N
        ds = RefDatastore("memory")
    try:
        tasks = ds.start_node_tasks(interval_s=60.0)
        assert ds.start_node_tasks() is tasks
        lid = _live(ds, "LIVE SELECT * FROM nd")
        # a dead node's heartbeat row and one of its live queries
        txn = ds.transaction(write=True)
        txn.set_val(K.node("dead"), (0.0, "off"))
        sub = txn.get_val(K.lq_def(NS, DB, "nd", lid))
        sub.node = "dead"
        txn.set_val(K.lq_def(NS, DB, "nd", lid), sub)
        txn.commit()
        assert N.membership_check(ds, stale_s=30.0) == ["dead"]
        txn = ds.transaction(write=False)
        nodes = [k for k, _ in txn.scan(*K.prefix_range(K.node_prefix()))]
        lqs = list(txn.scan(*K.prefix_range(K.lq_prefix(NS, DB, "nd"))))
        txn.cancel()
        assert nodes == [K.node(ds.node_id)] and lqs == []
        assert N.TaskLease(ds, "x", 30.0).try_acquire()
    finally:
        ds.close()
