"""The shared harness of the SurrealQL comparison tests
(`test_torch_query.py`, `test_torch_search.py`, `test_torch_explain.py`):
the `both` fixture, a reference and a port datastore over each package's
inline supervisor with the device floor lowered in both, and the
normalising comparison of results and KV items.

Tolerance: results are normalised to plain Python (a `RecordId` becomes
`("rid", tb, id)`, a datetime its epoch nanoseconds, a catalog
definition its class name and fields) and floats compare with atol 1e-4,
rtol 1e-5; everything else, error texts included, compares exactly.
KV items compare key for key; values byte for byte, except values
written by pickle (catalog definitions and index op-log tuples name
their package's classes), which compare decoded and normalised. Two key
families hold the wall clock of the write in their last 8 bytes, the
catalog history (`/%` + the catalog key + time) and a record's version
history (`/*ns*db*tb%id` + time): both compare without those 8 bytes,
in the order of the writes, values as above. A full-text index's write
version (`bv`) starts from the wall clock in each package: the fixture
gives both packages the same base, so the value is the same count of
writes past it.
"""

import dataclasses
import math
import types
from decimal import Decimal

import jax
import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.device import supervisor as refsup
from surrealdb_tpu.idx import fulltext as RF
from surrealdb_tpu.idx import vector as RV
from surrealdb_tpu.kvs.api import deserialize as ref_deserialize
from surrealdb_tpu.kvs.ds import Datastore as RefDatastore
from surrealdb_tpu.kvs.ds import Session as RefSession
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import key as PK
from surrealdb_tpu_torch.device import supervisor as portsup
from surrealdb_tpu_torch.device.handlers import DeviceHost as PortHost
from surrealdb_tpu_torch.idx import fulltext as PF
from surrealdb_tpu_torch.idx import vector as PV
from surrealdb_tpu_torch.kvs.api import deserialize as port_deserialize
from surrealdb_tpu_torch.kvs.ds import Datastore as PortDatastore
from surrealdb_tpu_torch.kvs.ds import Session as PortSession

ATOL, RTOL = 1e-4, 1e-5
NS, DB = "t", "t"
DIM = 16
MIN_ROWS = 64
FT_VERSION_BASE = 1 << 60


@pytest.fixture()
def both(monkeypatch):
    """A reference and a port datastore, each over its package's inline
    supervisor, with the device floor lowered in both packages."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "KNN_DEVICE_MIN_ROWS", MIN_ROWS)
        monkeypatch.setattr(c, "KNN_ANN_MODE", "off")
        monkeypatch.setattr(c, "KNN_SEG_MODE", "off")
        monkeypatch.setattr(c, "KNN_HOST_BATCH", "device")
    for m in (RV, PV):
        monkeypatch.setattr(m, "DEVICE_MIN_ROWS", MIN_ROWS)
    # one base for the full-text write version in both packages
    clock = types.SimpleNamespace(time_ns=lambda: FT_VERSION_BASE)
    for m in (RF, PF):
        monkeypatch.setattr(m, "time", clock)
    old_r = refsup.set_supervisor(refsup.DeviceSupervisor(mode="inline"))
    sup = portsup.DeviceSupervisor("inline", device="cpu")
    host = PortHost("cpu")
    ops = []
    handle = host.handle

    def recording(op, meta, bufs):
        ops.append(op)
        return handle(op, meta, bufs)

    host.handle = recording
    sup._inline_host = host
    old_p = portsup.set_supervisor(sup)
    pair = Both()
    pair.ops = ops
    try:
        yield pair
    finally:
        pair.close()
        refsup.reset_supervisor()
        refsup.set_supervisor(old_r)
        portsup.reset_supervisor()
        portsup.set_supervisor(old_p)


# -- normalising and comparing ------------------------------------------------


def norm(v):
    """A value of either package as plain Python."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, Decimal):
        return ("dec", str(v))
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (set, frozenset)):
        return ("pyset", sorted(repr(norm(x)) for x in v))
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tolist())
    name = type(v).__name__
    if name == "_NoneType":
        return ("NONE",)
    if name == "RecordId":
        return ("rid", v.tb, norm(v.id))
    if name == "Datetime":
        return ("dt", v.epoch_ns())
    if name in ("Duration", "Uuid", "Table", "Range", "Geometry", "SSet",
                "File", "Regex", "Closure"):
        return (name, v.render())
    if dataclasses.is_dataclass(v):
        return (name, {f.name: norm(getattr(v, f.name))
                       for f in dataclasses.fields(v)})
    if hasattr(v, "__dict__"):
        return (name, {k: norm(x) for k, x in vars(v).items()})
    if hasattr(v, "__slots__"):
        return (name, {k: norm(getattr(v, k, None)) for k in v.__slots__})
    return (name, repr(v))


def same(a, b, path="$"):
    """Assert two normalised values equal, floats to the tolerance."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool), \
            f"{path}: {a!r} != {b!r}"
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), f"{path}: {a} != {b}"
            return
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL) or a == b, \
            f"{path}: {a!r} != {b!r}"
        return
    assert type(a) is type(b), f"{path}: {a!r} != {b!r}"
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def _results(rs):
    return [("err", r.error) if r.error is not None else ("ok", norm(r.result))
            for r in rs]


def _untimed(k):
    """A catalog or record history key without its 8 bytes of
    wall-clock time."""
    if k.startswith(b"/%"):
        return k[:-8]
    if k.startswith(b"/*"):
        pos = 2
        for _ in range(3):
            _s, pos = PK.dec_str(k, pos)
            pos += 1
        if k[pos - 1:pos] == b"%":
            return k[:-8]
    return k


def _items(ds):
    t = ds.transaction(write=False)
    try:
        return [(_untimed(k), v) for k, v in t.scan(b"", b"\xff" * 9)]
    finally:
        t.cancel()


class Both:
    def __init__(self):
        self.ref = RefDatastore("memory")
        self.port = PortDatastore("memory")

    def close(self):
        self.ref.close()
        self.port.close()

    def run(self, sql, vars=None, **session):
        """Run `sql` on both; assert the same results; return the port's
        QueryResults. Keyword arguments set attributes of both sessions
        (`planner_strategy`, `redact_volatile_explain_attrs`)."""
        rs = ps = None
        if session:
            rs = RefSession(ns=NS, db=DB, auth_level="owner")
            ps = PortSession(ns=NS, db=DB, auth_level="owner")
            for k, v in session.items():
                setattr(rs, k, v)
                setattr(ps, k, v)
        r = self.ref.execute(sql, ns=NS, db=DB, vars=vars, session=rs)
        p = self.port.execute(sql, ns=NS, db=DB, vars=vars, session=ps)
        same(_results(r), _results(p))
        return p

    def ok(self, sql, vars=None, **session):
        """`run`, and every statement succeeded."""
        out = self.run(sql, vars, **session)
        for r in out:
            assert r.error is None, r.error
        return [r.result for r in out]

    def same_items(self):
        ri, pi = _items(self.ref), _items(self.port)
        assert [k for k, _ in ri] == [k for k, _ in pi]
        for (k, rv), (_k, pv) in zip(ri, pi):
            if rv != pv:
                assert rv[:1] == pv[:1] == b"\x00", repr(k)
                same(norm(ref_deserialize(rv)), norm(port_deserialize(pv)),
                     repr(k))
