"""The port's KV layer against the reference's: keys, stored values and
scan order are byte-equal (`he` vectors, pickled `hl` op-log tuples,
`vn`, records holding RecordIds, the four graph keys of an edge), the
pickle branch reads only stdlib types, and the in-memory engine keeps
the reference's order and snapshot semantics with or without
`sortedcontainers`."""

import datetime
import pickle
import uuid
from decimal import Decimal

import numpy as np
import pytest

from surrealdb_tpu import Datastore as RefDatastore
from surrealdb_tpu import key as RK
from surrealdb_tpu.kvs.api import serialize as ref_serialize
from surrealdb_tpu.kvs.mem import MemBackend as RefMemBackend
from surrealdb_tpu.val import NONE as RNONE
from surrealdb_tpu.val import Datetime as RDatetime
from surrealdb_tpu.val import RecordId as RRid
from surrealdb_tpu.val import Uuid as RUuid
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch.catalog import IndexDef
from surrealdb_tpu_torch.carry import datastore_from_items
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.idx.vector import vector_index_update
from surrealdb_tpu_torch.kvs import mem as pmem
from surrealdb_tpu_torch.kvs.api import deserialize, serialize
from surrealdb_tpu_torch.kvs.ds import Datastore
from surrealdb_tpu_torch.utils import sortedcompat
from surrealdb_tpu_torch.expr.ast import Idiom, PField
from surrealdb_tpu_torch.val import NONE, RecordId
from surrealdb_tpu_torch.val import Datetime as PDatetime
from surrealdb_tpu_torch.val import Uuid as PUuid

IDS = [0, 1, -1, 7, 2 ** 53 + 1, -(2 ** 60), 1.5, -0.25, "a", "", "x\x00y",
       "ü", [1, "a"], [], {"b": 1, "a": [2.0, "z"]}, True, False, None,
       b"\x00\x01raw"]


def _pair(v):
    """The same value in both packages' types."""
    if v is NONE:
        return RNONE
    if isinstance(v, RecordId):
        return RRid(v.tb, _pair(v.id))
    if isinstance(v, list):
        return [_pair(x) for x in v]
    if isinstance(v, dict):
        return {k: _pair(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_pair(x) for x in v)
    return v


def _all_items(ds):
    t = ds.transaction(write=False)
    try:
        return list(t.scan(b"", b"\xff" * 9))
    finally:
        t.cancel()


@pytest.mark.parametrize("idv", IDS + [NONE, RecordId("t", 3)],
                         ids=lambda v: repr(v)[:24])
def test_key_encodings_byte_equal(idv):
    rv = _pair(idv)
    enc = PK.enc_value(idv)
    assert enc == RK.enc_value(rv)
    assert PK.record("n", "d", "tb", idv) == RK.record("n", "d", "tb", rv)
    for d in (PK.DIR_IN, PK.DIR_OUT):
        assert PK.graph("n", "d", "tb", idv, d, "e", 5) == \
            RK.graph("n", "d", "tb", rv, d, "e", 5)
    assert PK.ix_state("n", "d", "tb", "ix", b"he", enc) == \
        RK.ix_state("n", "d", "tb", "ix", b"he", enc)
    dec, pos = PK.dec_value(enc, 0)
    assert pos == len(enc) and PK.enc_value(dec) == enc
    assert PK.enc_value(dec) == RK.enc_value(RK.dec_value(enc, 0)[0])


def test_key_prefixes_and_u64_byte_equal():
    assert PK.record_prefix("n", "d", "t") == RK.record_prefix("n", "d", "t")
    assert PK.graph_tb_prefix("n", "d", "t") == \
        RK.graph_tb_prefix("n", "d", "t")
    assert PK.prefix_range(b"/!x") == RK.prefix_range(b"/!x")
    for v in (0, 1, 255, 2 ** 40 + 3):
        assert PK.enc_u64(v) == RK.enc_u64(v)
    assert (PK.dec_str(PK.enc_str("a\x00b"), 0)
            == RK.dec_str(RK.enc_str("a\x00b"), 0))


def test_unported_key_values_raise():
    """The key values the engines once refused (uuids, datetimes) now
    encode byte for byte as the reference's and decode back."""
    u = uuid.UUID(int=5)
    k = RK.enc_value(RUuid(u))
    assert PK.enc_value(PUuid(u)) == k
    v, end = PK.dec_value(k, 0)
    assert isinstance(v, PUuid) and v == PUuid(u) and end == len(k)
    when = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
    k = RK.enc_value(RDatetime(when))
    assert PK.enc_value(PDatetime(when)) == k
    v, _ = PK.dec_value(k, 0)
    assert v == PDatetime(when)


VALUES = [
    np.arange(8, dtype=np.float32).tobytes(),            # an `he` vector
    ("set", 5, np.ones(4, np.float32).tobytes()),        # `hl` entries
    ("set", "k", b"\x00" * 12), ("set", [1, "a"], b"ab"),
    ("del", 9, None), ("del", "k", None),
    0, 1, 2 ** 40, 4096,                                  # `vn`
    {"id": RecordId("t", 1)}, {"id": RecordId("t", "x"), "emb": [0.5, 1.0]},
    {"id": RecordId("knows", 3), "in": RecordId("person", 1),
     "out": RecordId("person", 2)},
    NONE, None, True, -7, 1.25, "s", Decimal("1.50"), [NONE, {"a": None}],
]


@pytest.mark.parametrize("v", VALUES, ids=lambda v: repr(v)[:28])
def test_stored_values_byte_equal(v):
    raw = serialize(v)
    assert raw == ref_serialize(_pair(v))
    back = deserialize(raw)
    assert serialize(back) == raw
    assert deserialize(ref_serialize(_pair(v))) == v or v is NONE


def test_hl_entries_are_pickle_and_records_cbor():
    assert serialize(("set", 5, b"x"))[:1] == b"\x00"
    assert serialize({"id": RecordId("t", 1)})[:1] == b"\x01"
    assert serialize(b"abc")[:1] == b"\x01"


def test_pickle_branch_is_restricted():
    # a stored value naming a reference class decodes to the port's
    # counterpart of the same module path and name (a directory the
    # reference wrote opens here), and never to None
    when = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
    raw = ref_serialize(("set", RDatetime(when), b""))
    assert raw[:1] == b"\x00"
    assert deserialize(raw) == ("set", PDatetime(when), b"")
    # a reference type with no counterpart here still raises
    from surrealdb_tpu.kvs.lsm import LsmBackend

    with pytest.raises(pickle.UnpicklingError):
        deserialize(b"\x00" + pickle.dumps(LsmBackend, protocol=5))
    evil = b"\x00" + pickle.dumps(print, protocol=5)
    with pytest.raises(pickle.UnpicklingError):
        deserialize(evil)
    assert deserialize(b"\x00" + pickle.dumps({1, 2}, protocol=5)) == {1, 2}


def test_pickle_mapped_reference_function_is_refused():
    """Only the reference's classes map to the port's: a stored value
    naming a reference function, whose name the port also defines,
    raises and is never called."""
    from surrealdb_tpu.kvs import api as ref_api

    raw = b"\x00" + pickle.dumps(ref_api.serialize, protocol=5)
    assert b"surrealdb_tpu.kvs.api" in raw
    with pytest.raises(pickle.UnpicklingError, match="not a type"):
        deserialize(raw)
    reduce = b"\x00" + pickle.dumps(_CallsReferenceFunction(), protocol=5)
    with pytest.raises(pickle.UnpicklingError, match="not a type"):
        deserialize(reduce)


class _CallsReferenceFunction:
    """Pickles as a call of the reference's `serialize` on load."""

    def __reduce__(self):
        from surrealdb_tpu.kvs import api as ref_api

        return ref_api.serialize, ("x",)


def test_unported_value_tags_raise():
    """A stored datetime (once refused) decodes to the port's Datetime,
    and re-encodes to the reference's bytes."""
    when = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
    raw = ref_serialize({"when": RDatetime(when)})
    got = deserialize(raw)
    assert got == {"when": PDatetime(when)}
    assert serialize(got) == raw


def test_write_path_bytes_equal_the_sql_path():
    """The reference's SQL write path and the port's vector_index_update
    given the same documents write the same `he`, `hl` and `vn` bytes:
    creates, an overwrite, a delete, a str id."""
    rds = RefDatastore("memory")
    rds.query("DEFINE TABLE t; DEFINE INDEX ix ON t FIELDS emb HNSW "
              "DIMENSION 3 DIST COSINE TYPE F32", ns="b", db="b")
    steps = [(1, None, [1, 2, 3]), ("a", None, [0.5, 2, 3]),
             (2, None, [1, 1, 1]), (1, [1, 2, 3], [3, 2, 1]),
             ("a", [0.5, 2, 3], None)]
    sql = {None: "DELETE t:{id}", "set": "UPSERT t:{id} SET emb = {v}"}
    idef = IndexDef("ix", "t", [Idiom([PField("emb")])], ["emb"],
                    hnsw={"dimension": 3, "distance": "cosine",
                          "vector_type": "f32"})
    pds = Datastore()
    for idv, before, after in steps:
        rid = f"'{idv}'" if isinstance(idv, str) else idv
        q = (sql[None].format(id=rid) if after is None
             else sql["set"].format(id=rid, v=after))
        rds.query(q, ns="b", db="b")
        ctx = pds.context("b", "b", write=True)
        vector_index_update(
            idef, RecordId("t", idv),
            NONE if before is None else {"emb": before},
            NONE if after is None else {"emb": after}, ctx)
        ctx.txn.commit()
    pre = PK.ix_state("b", "b", "t", "ix", b"")
    ref = [(k, v) for k, v in _all_items(rds) if k.startswith(pre)]
    got = [(k, v) for k, v in _all_items(pds) if k.startswith(pre)]
    assert len(ref) == 1 + 2 + len(steps)  # vn, two live he, the log
    assert got == ref


def test_graph_keys_byte_equal_the_relate_path():
    rds = RefDatastore("memory")
    rds.query("CREATE person:1; CREATE person:2; "
              "RELATE person:1->knows:7->person:2", ns="b", db="b")
    pres = (PK.graph_tb_prefix("b", "b", "person"),
            PK.graph_tb_prefix("b", "b", "knows"))
    got = {k for k, _v in _all_items(rds) if k.startswith(pres)}
    want = {
        PK.graph("b", "b", "person", 1, PK.DIR_OUT, "knows", 7),
        PK.graph("b", "b", "knows", 7, PK.DIR_IN, "person", 1),
        PK.graph("b", "b", "knows", 7, PK.DIR_OUT, "person", 2),
        PK.graph("b", "b", "person", 2, PK.DIR_IN, "knows", 7),
    }
    assert got == want


@pytest.fixture(params=["sortedcontainers", "fallback"])
def port_mem(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(pmem, "SortedDict", sortedcompat.SortedDict)
        monkeypatch.setattr(pmem, "SortedList", sortedcompat.SortedList)
    return request.param


def test_scan_order_mixed_ids_equals_reference(port_mem):
    rng = np.random.default_rng(3)
    ids = [int(i) for i in rng.integers(-50, 50, 40)] + \
        [f"s{i}" for i in rng.integers(0, 99, 40)] + \
        [[int(i), "x"] for i in rng.integers(0, 9, 5)] + [2.5, -0.5]
    order = rng.permutation(len(ids))
    rb, pb = RefMemBackend(), pmem.MemBackend()
    for batch in np.array_split(order, 4):
        rt, pt = rb.transaction(True), pb.transaction(True)
        for i in batch:
            k = PK.ix_state("b", "b", "t", "ix", b"he",
                            PK.enc_value(ids[i]))
            rt.set(k, b"v%d" % i)
            pt.set(k, b"v%d" % i)
            rt.set(PK.record("b", "b", "t", ids[i]), b"r")
            pt.set(PK.record("b", "b", "t", ids[i]), b"r")
        rt.commit()
        pt.commit()
    dt, dpt = rb.transaction(True), pb.transaction(True)
    for i in order[:10]:
        for t in (dt, dpt):
            t.delete(PK.record("b", "b", "t", ids[i]))
    dt.commit()
    dpt.commit()
    r, p = rb.transaction(False), pb.transaction(False)
    assert list(p.scan(b"", b"\xff")) == list(r.scan(b"", b"\xff"))
    assert list(p.scan(b"/*", b"/+", limit=7, reverse=True)) == \
        list(r.scan(b"/*", b"/+", limit=7, reverse=True))


def test_mvcc_snapshot_and_conflict(port_mem):
    b = pmem.MemBackend()
    t = b.transaction(True)
    t.set(b"k1", b"a")
    t.commit()
    reader = b.transaction(False)
    w1, w2 = b.transaction(True), b.transaction(True)
    w1.set(b"k1", b"b")
    w1.set(b"k2", b"c")
    w1.commit()
    assert reader.get(b"k1") == b"a" and reader.get(b"k2") is None
    assert list(reader.scan(b"", b"\xff")) == [(b"k1", b"a")]
    w2.set(b"k1", b"z")
    with pytest.raises(SdbError):
        w2.commit()
    with pytest.raises(SdbError):
        reader.set(b"k3", b"x")
    d = b.transaction(True)
    d.delete(b"k1")
    d.set(b"k0", b"y")
    assert [k for k, _ in d.scan(b"", b"\xff")] == [b"k0", b"k2"]
    d.commit()
    reader.cancel()
    assert list(b.transaction(False).scan(b"", b"\xff")) == \
        [(b"k0", b"y"), (b"k2", b"c")]


def test_sortedcompat_matches_sortedcontainers():
    from sortedcontainers import SortedDict

    rng = np.random.default_rng(9)
    a, b = SortedDict(), sortedcompat.SortedDict()
    for step in range(3000):
        k = bytes([int(x) for x in rng.integers(0, 6, 3)])
        op = rng.integers(0, 4)
        if op == 0 and k in a:
            del a[k]
            del b[k]
        elif op == 1:
            assert a.pop(k, None) == b.pop(k, None)
        else:
            a[k] = step
            b[k] = step
        if step % 97 == 0:
            lo, hi = sorted(bytes([int(x)]) for x in rng.integers(0, 6, 2))
            for inc in ((True, False), (True, True), (False, False)):
                for rev in (False, True):
                    assert list(a.irange(lo, hi, inclusive=inc,
                                         reverse=rev)) == \
                        list(b.irange(lo, hi, inclusive=inc, reverse=rev))
    assert list(a.items()) == b.items() and len(a) == len(b)


def test_datastore_from_items_carries_every_byte():
    rds = RefDatastore("memory")
    rds.query("DEFINE TABLE t; DEFINE INDEX ix ON t FIELDS emb HNSW "
              "DIMENSION 2 DIST EUCLIDEAN; CREATE t:1 SET emb = [1, 2]; "
              "CREATE t:'x' SET emb = [0, 1]; RELATE t:1->e:1->t:'x'",
              ns="b", db="b")
    items = _all_items(rds)
    pds = datastore_from_items(items)
    assert _all_items(pds) == items
    ctx = pds.context("b", "b")
    vn = ctx.txn.get_val(PK.ix_state("b", "b", "t", "ix", b"vn"))
    assert vn == 2
    assert ctx.txn.get_val(PK.record("b", "b", "t", 1))["id"] == \
        RecordId("t", 1)
