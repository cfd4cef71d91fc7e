"""The port's CsrGraph against the reference's on the same KV bytes:
builds from the `~` graph keys and from edge records (the self-table
case too), `replay` of added edges, `hop_bag_idx` / `hop_bag`, and
`multi_hop` in frontier and union modes through each package's batcher
over an inline host (the port's DeviceHost on the CPU): the masks are
bit-equal to the numpy multi-hop."""

import threading

import jax
import numpy as np
import pytest

from surrealdb_tpu import Datastore as RefDatastore
from surrealdb_tpu import key as RK
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.exec.context import Ctx as RefCtx
from surrealdb_tpu.graph import csr as rcsr
from surrealdb_tpu.kvs.api import serialize as ref_serialize
from surrealdb_tpu.kvs.ds import Session as RefSession
from surrealdb_tpu.val import RecordId as RefRid
from surrealdb_tpu_torch.carry import datastore_from_items
from surrealdb_tpu_torch.device import supervisor as portsup
from surrealdb_tpu_torch.graph import csr as pcsr

DIRS = ("out", "in", "both")


@pytest.fixture()
def sups(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    old_r = refsup.set_supervisor(refsup.DeviceSupervisor(mode="inline"))
    old_p = portsup.set_supervisor(
        portsup.DeviceSupervisor("inline", device="cpu"))
    yield
    refsup.reset_supervisor()
    refsup.set_supervisor(old_r)
    portsup.reset_supervisor()
    portsup.set_supervisor(old_p)


def _items(ds):
    t = ds.transaction(write=False)
    try:
        return list(t.scan(b"", b"\xff" * 9))
    finally:
        t.cancel()


def _node(i):
    return i if i % 3 else f"p{i}"  # int and str ids, interleaved


def _graph_ds(n, e, seed, keys=True, node_tb="person", edge_tb="knows"):
    """A reference datastore with `e` random edges between `n` nodes,
    written as bench.py writes them (the record, then the four `~` keys
    when `keys`); a few edges lead to another table."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ds = RefDatastore("memory")
    t = ds.transaction(write=True)
    for i in range(n):
        t.set(RK.record("b", "b", node_tb, _node(i)),
              ref_serialize({"id": RefRid(node_tb, _node(i))}))
    for j in range(e):
        s, d = _node(int(src[j])), _node(int(dst[j]))
        dtb = "city" if j % 17 == 5 else node_tb
        t.set(RK.record("b", "b", edge_tb, j), ref_serialize({
            "id": RefRid(edge_tb, j), "in": RefRid(node_tb, s),
            "out": RefRid(dtb, d)}))
        if keys:
            t.set(RK.graph("b", "b", node_tb, s, RK.DIR_OUT, edge_tb, j), b"")
            t.set(RK.graph("b", "b", edge_tb, j, RK.DIR_IN, node_tb, s), b"")
            t.set(RK.graph("b", "b", edge_tb, j, RK.DIR_OUT, dtb, d), b"")
            t.set(RK.graph("b", "b", dtb, d, RK.DIR_IN, edge_tb, j), b"")
    t.commit()
    return ds


class Pair:
    def __init__(self, rds):
        self.rds = rds
        self.pds = datastore_from_items(_items(rds))

    def ctxs(self):
        return (RefCtx(self.rds, RefSession("b", "b"),
                       self.rds.transaction(write=False)),
                self.pds.context("b", "b"))

    def csr(self, node_tb, edge_tb, direction):
        rc, pc = self.ctxs()
        return (rcsr.get_csr(self.rds, rc, node_tb, edge_tb, direction),
                pcsr.get_csr(self.pds, pc, node_tb, edge_tb, direction))


def _same(rg, pg):
    assert pg.node_ids == rg.node_ids
    np.testing.assert_array_equal(pg.rows, rg.rows)
    np.testing.assert_array_equal(pg.cols, rg.cols)
    assert pg.rows.dtype == rg.rows.dtype == np.int32
    assert [(e.tb, e.id) for e in pg.edge_ids] == \
        [(e.tb, e.id) for e in rg.edge_ids]
    assert pg.version == rg.version


@pytest.mark.parametrize("keys", [True, False], ids=["graph_keys", "docs"])
@pytest.mark.parametrize("direction", DIRS)
def test_build_matches_reference(sups, direction, keys):
    p = Pair(_graph_ds(300, 2000, 1, keys=keys))
    rg, pg = p.csr("person", "knows", direction)
    _same(rg, pg)
    assert len(pg.rows) > 1000
    assert pcsr.peek_csr(p.pds, "b", "b", "person", "knows",
                         direction) is pg


def test_self_table_takes_the_doc_scan(sups):
    p = Pair(_graph_ds(200, 800, 2, node_tb="n", edge_tb="n"))
    for direction in DIRS:
        _same(*p.csr("n", "n", direction))


def test_replay_of_added_edges(sups):
    p = Pair(_graph_ds(100, 400, 3))
    gk = ("b", "b", "knows")
    for ds, mod in ((p.rds, rcsr), (p.pds, pcsr)):
        mod.get_csr(ds, p.ctxs()[0 if mod is rcsr else 1], "person",
                    "knows", "both")
    ops1 = [("add", 900, "person", 5, "person", "p9"),
            ("add", 901, "person", 1000, "person", 7),   # a new node
            ("add", 902, "person", 5, "city", 1)]        # not this CSR's
    ops2 = [("add", 903, "person", "new", "person", 1000)]
    for ds, mod in ((p.rds, rcsr), (p.pds, pcsr)):
        mod.oplog_push(ds, gk, 1, ops1)
        mod.oplog_push(ds, gk, 2, ops2)
        ds.graph_versions[gk] = 2
    assert pcsr.oplog_slice(p.pds, gk, 0, 2) == \
        rcsr.oplog_slice(p.rds, gk, 0, 2)
    rg, pg = p.csr("person", "knows", "both")
    _same(rg, pg)
    assert pg._built and len(pg.rows) == len(rg.rows)
    # an unreplayable write clears the log: a full rebuild
    for ds, mod in ((p.rds, rcsr), (p.pds, pcsr)):
        mod.oplog_push(ds, gk, 3, None)
        ds.graph_versions[gk] = 3
    assert pcsr.oplog_slice(p.pds, gk, 2, 3) is None
    _same(*p.csr("person", "knows", "both"))


def test_hop_bag_matches_reference(sups):
    p = Pair(_graph_ds(300, 2000, 4))
    rg, pg = p.csr("person", "knows", "out")
    starts = [_node(i) for i in (1, 3, 4, 250, 299)] + ["missing"]
    for hops in (0, 1, 2, 3):
        np.testing.assert_array_equal(pg.hop_bag_idx(starts, hops),
                                      rg.hop_bag_idx(starts, hops))
    np.testing.assert_array_equal(pg.hop_bag_idx([_node(1)], 2),
                                  rg.hop_bag_idx([_node(1)], 2))
    assert pg.hop_bag(starts) == rg.hop_bag(starts)


@pytest.mark.parametrize("union", [False, True], ids=["frontier", "union"])
def test_multi_hop_masks_bit_equal(sups, union):
    p = Pair(_graph_ds(400, 1600, 5))
    rg, pg = p.csr("person", "knows", "out")
    mode = "union" if union else "frontier"
    n = pg.n_nodes()
    for hops in (1, 2, 3):
        for starts in ([_node(1)], [_node(i) for i in range(0, 400, 37)],
                       ["missing"]):
            got = pg.multi_hop(starts, hops, mode)
            assert got == rg.multi_hop(starts, hops, mode)
            mask = np.zeros(n, bool)
            for s in starts:
                i = pg.node_index.get(pcsr.K.enc_value(s))
                if i is not None:
                    mask[i] = True
            want = pg._host_multi_hop(mask, hops, union)
            assert got == [pg.node_ids[i] for i in np.nonzero(want)[0]]
    st = portsup.get_supervisor().counters
    assert st["device_fallbacks"] == 0


def test_concurrent_riders_share_frames(sups):
    """8 threads' traversals coalesce through the batcher; every answer
    equals its own numpy multi-hop."""
    p = Pair(_graph_ds(400, 1600, 6))
    _rg, pg = p.csr("person", "knows", "out")
    from surrealdb_tpu_torch.device.batcher import BATCH_STATS

    before = BATCH_STATS.to_dict()
    got, errors = {}, []

    def client(t):
        try:
            for r in range(4):
                s = _node(t * 40 + r)
                got[(t, r)] = pg.multi_hop([s], 3, "union" if r % 2
                                           else "frontier")
        except Exception as e:  # collected, then checked
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and len(got) == 32
    for (t, r), ids in got.items():
        mask = np.zeros(pg.n_nodes(), bool)
        mask[pg.node_index[pcsr.K.enc_value(_node(t * 40 + r))]] = True
        want = pg._host_multi_hop(mask, 3, bool(r % 2))
        assert ids == [pg.node_ids[i] for i in np.nonzero(want)[0]]
    after = BATCH_STATS.to_dict()
    assert after["riders"] - before["riders"] == 32
