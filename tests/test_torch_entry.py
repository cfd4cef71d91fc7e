"""The port's entry points (`surrealdb_tpu_torch/entry.py`)
against the reference's `__graft_entry__.py` on the CPU.

`entry(device="cpu")`'s fn against the reference `entry()`'s fn (the
suite pins JAX to the CPU): distances within atol=1e-4, rtol=1e-5, ids
equal wherever the reference separates neighbours by more. The
reference probe's `hop` is copied here and held bit for bit against the
port's `probe_hop`. `dryrun_multichip(n, device="cpu")` prints one
`MULTICHIP` line with its stages. Without a GPU, `entry()` on the card
raises `DeviceUnavailable` within the init watchdog and leaves no
runner behind.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ref_entry
from surrealdb_tpu_torch import entry as port_entry
from surrealdb_tpu_torch.device.supervisor import DeviceUnavailable

from test_torch_ops import assert_knn_match


def test_entry_fn_matches_reference():
    rfn, (rxs, rqs) = ref_entry.entry()
    rd, ri = rfn(rxs, rqs)
    # the (k+1)-th neighbour, for the separation of the k-th
    _, (xs11, qs11) = ref_entry.entry()
    from surrealdb_tpu.ops.topk import knn_search

    rd11, ri11 = knn_search(xs11, qs11, 11, "cosine")
    np.testing.assert_array_equal(np.asarray(rd11)[:, :10], np.asarray(rd))
    fn, (xs, qs) = port_entry.entry(device="cpu")
    assert xs.device.type == qs.device.type == "cpu"
    assert xs.shape == (4096, 128) and qs.shape == (8, 128)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(rqs))
    gd, gi = fn(xs, qs)
    assert str(gi.dtype) == "torch.int32" and gi.shape == (8, 10)
    assert_knn_match(np.asarray(rd11), np.asarray(ri11), gd.numpy(),
                     gi.numpy(), 10)


def _reference_hop(indices, n_nodes):
    """`__graft_entry__.py` `hop` (:223), as written there."""
    indptr = np.arange(n_nodes + 1, dtype=np.int32) * 2
    frontier = np.zeros((n_nodes,), dtype=bool)
    frontier[:4] = True

    @jax.jit
    def hop(indptr, indices, frontier):
        deg = indptr[1:] - indptr[:-1]
        starts = indptr[:-1]
        max_deg = 2
        offs = jnp.arange(max_deg)[None, :]
        gather_idx = jnp.clip(starts[:, None] + offs, 0, indices.shape[0] - 1)
        neigh = indices[gather_idx]  # [n_nodes, max_deg]
        mask = (offs < deg[:, None]) & frontier[:, None]
        contrib = jnp.where(mask, 1, 0)
        return jnp.zeros(frontier.shape[0], dtype=jnp.int32).at[
            neigh.reshape(-1)
        ].add(contrib.reshape(-1)) > 0

    return np.asarray(hop(indptr, indices, frontier))


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_probe_hop_matches_reference(n_devices):
    n_nodes = 64 * n_devices
    rng = np.random.default_rng(0)
    # the dryrun's draws: rows, queries, then the edges
    rng.normal(size=(n_nodes, 32))
    rng.normal(size=(4, 32))
    indices = rng.integers(0, n_nodes, size=(2 * n_nodes,)).astype(np.int32)
    want = _reference_hop(indices, n_nodes)
    got = port_entry.probe_hop(indices, "cpu").numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert want.any()
    # a frontier node's self-loop and duplicate edges
    indices[:2] = 0
    indices[6:8] = n_nodes - 1
    assert np.array_equal(port_entry.probe_hop(indices, "cpu").numpy(),
                          _reference_hop(indices, n_nodes))


def _multichip_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("MULTICHIP: ")]
    assert len(lines) == 1, out
    return json.loads(lines[0][len("MULTICHIP: "):])


@pytest.mark.parametrize("n_devices,stages", [
    (4, ["sharded_rank_rescore", "graph_hop", "device_mesh_store",
         "hier_mesh"]),
    (1, ["sharded_rank_rescore", "graph_hop", "device_mesh_store"]),
])
def test_dryrun_multichip_on_the_cpu(capsys, n_devices, stages):
    port_entry.dryrun_multichip(n_devices, device="cpu")
    st = _multichip_line(capsys.readouterr().out)
    assert st["stages"] == stages
    assert st["probe"] == "dryrun_multichip"
    assert st["n_devices"] == st["n_devices_used"] == n_devices
    assert st["mesh_shape"] == [n_devices]
    assert st["sharded_kernel_ran"] is True
    assert st["fallback_reason"] is None
    assert st["platform"] == "cpu" and st["physical_cards"] == 1


def test_dryrun_multichip_prints_its_line_on_failure(capsys):
    """Three devices do not split into two hosts: the line still
    prints, with the reference's error as the fallback reason."""
    with pytest.raises(ValueError, match="3 devices do not split into 2"):
        port_entry.dryrun_multichip(3, device="cpu")
    st = _multichip_line(capsys.readouterr().out)
    assert st["stages"] == ["sharded_rank_rescore", "graph_hop",
                            "device_mesh_store"]
    assert st["fallback_reason"].startswith("ValueError: 3 devices")


def _runner_children():
    me = str(os.getpid())
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == me and b"surrealdb_tpu_torch.device.runner" in cmd:
            out.append(int(pid))
    return out


def test_entry_on_the_card_raises_without_a_gpu(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the guard passes")
    monkeypatch.setenv("SURREAL_BACKEND_INIT_TIMEOUT_S", "60")
    monkeypatch.setattr(port_entry, "_BACKEND_GUARDED", False)
    for call in (port_entry.entry, lambda: port_entry.dryrun_multichip(2)):
        with pytest.raises(DeviceUnavailable):
            call()
        assert not _runner_children()
        assert port_entry._BACKEND_GUARDED is False
