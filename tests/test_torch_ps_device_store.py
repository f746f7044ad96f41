"""The device-resident PS store (``ps/device_store.py``, a shard's
``--ps_device``) on the CPU device, against the JAX package's
``DeviceEmbeddingTable`` fed the same ids: lazily minted rows in any
order (bitwise), ``missing_ids``, ``evict_rows`` with the free list
keeping the arena at the warm size, and the snapshot round trip. Then
the port's device plane against its host plane through
``PserverServicer``, bitwise, as ``tests/test_ps_device_parity.py``
holds the reference's (SGD, momentum, Adam, Adagrad; duplicate ids,
lazy init, a dense push and pull), and the device plane against the
reference's within the optimizers' stated tolerance."""

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.ps.device_store import (
    DeviceEmbeddingTable as JDeviceTable,
)
from elasticdl_tpu.ps.embedding_table import EmbeddingTable as JTable
from elasticdl_tpu.ps.parameters import Parameters as JParameters
from elasticdl_tpu.ps.servicer import PserverServicer as JServicer
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.ps.device_store import DeviceEmbeddingTable
from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer

DIM = 6

# name: (torch factory, optax transformation, tolerance of the device
# plane against the reference's, relative L2)
OPTIMIZERS = {
    "sgd": (lambda p: torch.optim.SGD(p, lr=0.1), optax.sgd(0.1), 1e-6),
    "momentum": (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
                 optax.sgd(0.1, momentum=0.9), 1e-6),
    # b2 = 0.9375 is exact in float32 (test_torch_ps_store.py's reason)
    "adam": (lambda p: torch.optim.Adam(p, lr=0.01, betas=(0.9, 0.9375)),
             optax.adam(0.01, b2=0.9375), 1e-5),
    "adagrad": (lambda p: torch.optim.Adagrad(
        p, lr=0.1, initial_accumulator_value=0.1, eps=1e-10),
        optax.adagrad(0.1, initial_accumulator_value=0.1, eps=1e-10), 1e-5),
}


def _device(name="emb", initializer="uniform", dim=DIM):
    return DeviceEmbeddingTable(name, dim, initializer, device="cpu")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- the table against the reference's ----------------------------------------


@pytest.mark.parametrize("initializer", ["uniform", "normal", "zeros",
                                         "0.25"])
def test_lazy_rows_match_the_references_in_any_order(initializer):
    rng = np.random.default_rng(0)
    stream = [rng.integers(0, 500, 40) for _ in range(4)]
    port, ref = _device(initializer=initializer), JDeviceTable(
        "emb", DIM, initializer)
    host = EmbeddingTable("emb", DIM, initializer)
    for ids in stream:
        got = port.get(ids)
        assert got.dtype == np.float32 and got.shape == (len(ids), DIM)
        assert np.array_equal(got, np.asarray(ref.get(ids)))
        assert np.array_equal(got, host.get(ids))
    # a fresh table minting the same ids in the other order
    reverse = _device(initializer=initializer)
    for ids in stream[::-1]:
        reverse.get(ids[::-1])
    everything = np.unique(np.concatenate(stream))
    assert np.array_equal(reverse.get(everything), port.get(everything))
    assert len(port) == len(reverse) == len(ref) == everything.size


@pytest.mark.parametrize("kind", ["device", "host"])
def test_missing_ids_mint_nothing_as_the_references(kind):
    port = _device(initializer="ones") if kind == "device" else \
        EmbeddingTable("x", DIM, "ones")
    ref = JDeviceTable("x", DIM, "ones") if kind == "device" else \
        JTable("x", DIM, "ones")
    for t in (port, ref):
        t.get(np.arange(10, dtype=np.int64))
    assert port.missing_ids([5, 99, 3, 100]) == ref.missing_ids(
        [5, 99, 3, 100]) == [99, 100]
    assert len(port) == len(ref) == 10
    assert port.evict_rows([3, 4, 777]) == ref.evict_rows([3, 4, 777]) == 2
    assert len(port) == len(ref) == 8
    assert port.missing_ids([3, 5]) == [3]


def test_evicted_slots_are_reused_before_the_arena_grows():
    port, ref = _device(initializer="ones"), JDeviceTable("x", DIM, "ones")
    for t in (port, ref):
        t.get(np.arange(10, dtype=np.int64))
    freed = {port._slots[3], port._slots[4]}
    port.evict_rows([3, 4])
    ref.evict_rows([3, 4])
    assert set(port._free) == freed
    # a reused slot is written (minted) before it is read
    got = port.get(np.asarray([100, 101], dtype=np.int64))
    assert np.array_equal(got, np.ones((2, DIM), np.float32))
    assert np.array_equal(got, np.asarray(ref.get([100, 101])))
    assert not port._free and port._next == ref._next == 10
    assert {port._slots[100], port._slots[101]} == freed


def test_the_free_list_keeps_the_arena_at_the_warm_size():
    """128 distinct ids cycled through 8 slots at a time: without reuse
    the arena would double past its 64-row minimum."""
    port, ref = _device(initializer="zeros"), JDeviceTable(
        "x", DIM, "zeros")
    for batch in range(16):
        ids = np.arange(batch * 8, batch * 8 + 8, dtype=np.int64)
        for t in (port, ref):
            t.get(ids)
            t.evict_rows(ids[:6])
    assert port.capacity == int(ref._arena.shape[0]) == 64
    assert len(port) == len(ref) == 32
    # past the minimum it doubles, as the reference's does
    port.get(np.arange(1000, 1100, dtype=np.int64))
    ref.get(np.arange(1000, 1100, dtype=np.int64))
    assert port.capacity == int(ref._arena.shape[0]) == 256


def test_set_keeps_the_last_write_of_a_duplicate():
    port, ref = _device(initializer="zeros"), JDeviceTable(
        "x", DIM, "zeros")
    ids = np.array([4, 9, 4, 2], np.int64)
    rows = np.arange(4 * DIM, dtype=np.float32).reshape(4, DIM)
    port.set(ids, rows)
    ref.set(ids, rows)
    want = np.asarray(ref.get([2, 4, 9]))
    assert np.array_equal(port.get([2, 4, 9]), want)
    assert np.array_equal(want[1], rows[2])


@pytest.mark.parametrize("direction", ["device_to_host", "host_to_device",
                                       "device_to_reference"])
def test_snapshot_round_trip(direction):
    rng = np.random.default_rng(5)
    source = _device() if direction != "host_to_device" else \
        EmbeddingTable("emb", DIM, "uniform")
    ids = rng.integers(0, 300, 50)
    source.get(ids)
    source.set(ids[:10], rng.normal(size=(10, DIM)).astype(np.float32))
    if isinstance(source, DeviceEmbeddingTable):
        source.evict_rows(ids[10:15])  # slots on the free list
    snap_ids, snap_rows = source.snapshot()
    assert snap_ids.dtype == np.int64 and snap_rows.dtype == np.float32
    target = {"device_to_host": EmbeddingTable("emb", DIM, "uniform"),
              "host_to_device": _device(),
              "device_to_reference": JDeviceTable("emb", DIM, "uniform"),
              }[direction]
    target.load_snapshot(snap_ids, snap_rows)
    assert len(target) == len(source)
    back_ids, back_rows = target.snapshot()
    order, back = np.argsort(snap_ids), np.argsort(back_ids)
    assert np.array_equal(snap_ids[order], back_ids[back])
    assert np.array_equal(snap_rows[order], back_rows[back])
    # rows minted after the restore are the source's too
    probe = np.unique(np.concatenate([ids, [999, 1000]]))
    assert np.array_equal(np.asarray(target.get(probe)), source.get(probe))


def test_an_arena_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEmbeddingTable("emb", DIM, "uniform")
    with pytest.raises(RuntimeError, match="CUDA"):
        Parameters(device=True)


# -- the device plane against the host plane, through the servicer ----------


def _stream(steps=6, seed=3):
    """Dense and sparse gradients; odd steps carry duplicate ids."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        ids = rng.choice(50, size=12, replace=(step % 2 == 1))
        out.append({
            "w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "ids": ids.astype(np.int64),
            "rows": rng.standard_normal((12, DIM)).astype(np.float32),
        })
    return out


def _drive(servicer, stream, cls=Tensor, sync_two=False):
    dense0 = {"w": np.arange(128, dtype=np.float32).reshape(16, 8) / 7.0,
              "b": np.linspace(-1.0, 1.0, 8, dtype=np.float32)}
    servicer.push_model({
        "version": 0,
        "params": [cls(n, v.copy()) for n, v in dense0.items()],
        "embedding_infos": [{"name": "emb", "dim": DIM,
                             "initializer": "normal"}],
    })
    for step, g in enumerate(stream):
        version = step // 2 if sync_two else step
        resp = servicer.push_gradient({
            "model_version": version,
            "gradients": [cls("w", g["w"].copy()), cls("b", g["b"].copy()),
                          cls("emb", g["rows"].copy(),
                              indices=g["ids"].copy())],
        })
        assert resp["accepted"]


def _pulled(servicer, ids):
    pull = servicer.pull_variable({})
    dense = {t.name: np.asarray(t.values) for t in pull["params"]}
    rows = np.asarray(servicer.pull_embedding_vector(
        {"name": "emb", "ids": ids})["rows"])
    return pull["version"], dense, rows


def _port(opt, device, use_async, grads_to_wait=1):
    return PserverServicer(
        Parameters(device=device), grads_to_wait, OPTIMIZERS[opt][0], "cpu",
        use_async=use_async,
    )


@pytest.mark.parametrize("mode", ["async", "sync_over_two"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_the_device_plane_matches_the_host_plane_bitwise(opt, mode):
    use_async = mode == "async"
    wait = 1 if use_async else 2
    host = _port(opt, None, use_async, wait)
    device = _port(opt, "cpu", use_async, wait)
    stream = _stream()
    for s in (host, device):
        _drive(s, stream, sync_two=not use_async)
    assert isinstance(device._parameters.embedding_params["emb"],
                      DeviceEmbeddingTable)
    assert all(isinstance(v, torch.Tensor) for v in
               device._parameters.non_embedding_params.values())
    ids = np.arange(60, dtype=np.int64)  # with ids never pushed
    hv, hd, hr = _pulled(host, ids)
    dv, dd, dr = _pulled(device, ids)
    assert hv == dv == (6 if use_async else 3)
    assert hd.keys() == dd.keys()
    for name in hd:
        assert np.array_equal(hd[name], dd[name]), name
    assert np.array_equal(hr, dr)
    # every table, rows and slots, in the same id order
    hp, dp = host._parameters, device._parameters
    assert hp.embedding_params.keys() == dp.embedding_params.keys()
    assert len(hp.embedding_params) > 1 or opt == "sgd"
    for name, table in hp.embedding_params.items():
        h_ids, h_rows = table.snapshot()
        d_ids, d_rows = dp.embedding_params[name].snapshot()
        assert np.array_equal(h_ids, d_ids), name
        assert np.array_equal(h_rows, d_rows), name


def test_a_device_snapshot_restores_into_either_store():
    host, device = _port("adam", None, True), _port("adam", "cpu", True)
    stream = _stream(steps=4)
    for s in (host, device):
        _drive(s, stream)
    h_state = host._parameters.snapshot_state()
    d_state = device._parameters.snapshot_state()
    assert h_state["version"] == d_state["version"] == 4
    for name in h_state["dense"]:
        assert np.array_equal(h_state["dense"][name],
                              d_state["dense"][name])
    for name in h_state["tables"]:
        for key in ("ids", "rows"):
            assert np.array_equal(h_state["tables"][name][key],
                                  d_state["tables"][name][key])
    ids = np.arange(60, dtype=np.int64)
    want = _pulled(host, ids)
    for state, device_store in ((h_state, "cpu"), (d_state, None)):
        params = Parameters(device=device_store)
        params.restore_state(state)
        got = _pulled(PserverServicer(params, 1, OPTIMIZERS["adam"][0],
                                      "cpu", use_async=True), ids)
        assert got[0] == want[0]
        for name in want[1]:
            assert np.array_equal(got[1][name], want[1][name])
        assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_the_device_plane_matches_the_references(opt):
    port = _port(opt, "cpu", True)
    ref = JServicer(JParameters(device=True), 1, OPTIMIZERS[opt][1],
                    use_async=True)
    stream = _stream(steps=4)
    _drive(port, stream)
    _drive(ref, stream, cls=JTensor)
    ids = np.arange(60, dtype=np.int64)
    pv, pd, pr = _pulled(port, ids)
    rv, rd, rr = _pulled(ref, ids)
    tol = OPTIMIZERS[opt][2]
    assert pv == rv == 4
    for name in rd:
        assert _rel_l2(pd[name], rd[name]) <= tol, name
    assert _rel_l2(pr, rr) <= tol


def test_lazy_rows_through_the_stores_match_in_any_order():
    for initializer in ("normal", "uniform"):
        host, device = Parameters(), Parameters(device="cpu")
        ref = JParameters(device=True)
        infos = [EmbeddingTableInfo("emb", 6, initializer)]
        from elasticdl_tpu.ps.parameters import EmbeddingTableInfo as JInfo

        host.init_from_model(0, {}, infos)
        device.init_from_model(0, {}, infos)
        ref.init_from_model(0, {}, [JInfo("emb", 6, initializer)])
        host.get_embedding_param("emb", np.asarray([9, 3, 27]))
        device.get_embedding_param("emb", np.asarray([0, 27, 14]))
        everything = np.asarray([0, 3, 9, 14, 27], dtype=np.int64)
        got = device.get_embedding_param("emb", everything)
        assert np.array_equal(got, host.get_embedding_param(
            "emb", everything))
        assert np.array_equal(got, np.asarray(ref.get_embedding_param(
            "emb", everything)))
