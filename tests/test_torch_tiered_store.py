"""The tiered embedding store (``ps/tiered_store.py``, a shard's
``--ps_warm_rows``/``--ps_spill_dir``), case by case as
``tests/test_tiered_store.py`` holds the JAX package's:

- values: a tiered table reads bitwise as the untiered table it wraps
  and as the reference's tiered table, across demotions and promotions,
  over the host store and over the device arena;
- crash consistency: spill segments written by either package read back
  in the other's ``read_shard_snapshot`` (and re-attach there), a torn or
  manifest-less segment is invisible, a row sealed but not yet indexed
  stays warm, a re-attach after a restart serves the newest generation;
- signals: rows an apply pinned, or a read holds, are never spilled;
- ``stats()`` counts as the reference's on one sequence; ``close()``;
- ``Parameters(tier_config=...)``, the servicer's apply notes and its
  ``tiered`` counters, and a shard built through ``ps.main``'s flags.

Most cases stop the background demoter (``close()``) and drive
``_demote_once()`` so each spill is deterministic."""

import collections
import logging
import os
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.ps.embedding_table import EmbeddingTable as JTable
from elasticdl_tpu.ps.snapshot import (
    read_shard_snapshot as j_read,
    write_shard_snapshot as j_write,
)
from elasticdl_tpu.ps.tiered_store import TieredEmbeddingTable as JTiered
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.ps.device_store import DeviceEmbeddingTable
from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.ps.snapshot import (
    read_shard_snapshot,
    snapshot_versions,
    write_shard_snapshot,
)
from elasticdl_tpu_torch.ps.tiered_store import TieredEmbeddingTable

DIM = 4
INNERS = ["host", "device"]


def _inner(kind, name="emb", init="zeros"):
    if kind == "device":
        return DeviceEmbeddingTable(name, DIM, init, device="cpu")
    return EmbeddingTable(name, DIM, init)


def _tiered(tmp_path, warm_rows=8, name="emb", init="zeros", kind="host",
            background=False, cls=TieredEmbeddingTable, inner=None):
    if inner is None:
        inner = JTable(name, DIM, init) if cls is JTiered else _inner(
            kind, name, init)
    t = cls(inner, os.path.join(str(tmp_path), "spill-" + name), warm_rows)
    if not background:
        t.close()  # the cases drive _demote_once() themselves
    return t


def _rows_for(ids, base=0.0):
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    return (ids.astype(np.float32)[:, None] + np.float32(base)) * np.ones(
        (1, DIM), np.float32)


def _fill(t, n, base=0.0):
    ids = np.arange(n, dtype=np.int64)
    rows = _rows_for(ids, base)
    t.set(ids, rows)
    return ids, rows


def _drain(t):
    while t._demote_once():
        pass


def _warm_ids(t):
    inner = t._inner
    return set(getattr(inner, "embedding_vectors", None)
               or getattr(inner, "_slots"))


# -- values -------------------------------------------------------------------


@pytest.mark.parametrize("kind", INNERS)
def test_spill_then_cold_pull_roundtrip(tmp_path, kind):
    t = _tiered(tmp_path, warm_rows=8, kind=kind)
    ids, rows = _fill(t, 32)
    _drain(t)
    s = t.stats()
    assert s["spilled_rows"] > 0 and s["spill_segments"] > 0
    assert t.stats()["warm_rows"] <= 8 and len(t) == 32
    warm = _warm_ids(t)
    assert not warm & set(t._disk) and set(t._ticks) == warm
    np.testing.assert_array_equal(t.get(ids), rows)
    s = t.stats()
    assert s["cold_pull_rows"] > 0 and s["cold_pull_segments"] > 0
    assert s["promoted_rows"] > 0 and s["disk_rows"] == 0


def test_cold_pulls_are_batched_per_segment(tmp_path):
    t = _tiered(tmp_path, warm_rows=4)
    _fill(t, 16)
    _drain(t)
    segments = t.stats()["spill_segments"]
    assert segments >= 1
    cold = sorted(t._disk)
    t.get(np.asarray(cold, dtype=np.int64))
    s = t.stats()
    assert s["cold_pull_segments"] <= segments
    assert s["cold_pull_rows"] == len(cold)


@pytest.mark.parametrize("kind", INNERS)
def test_values_match_the_untiered_and_the_reference_tables(tmp_path, kind):
    t = _tiered(tmp_path / "port", warm_rows=4, init="uniform", kind=kind)
    ref = _tiered(tmp_path / "ref", warm_rows=4, init="uniform", cls=JTiered)
    plain = EmbeddingTable("emb", DIM, "uniform")
    batches = [[1, 2, 3], [10, 11, 12, 13, 14], [1, 50, 60, 2],
               [70, 80, 90, 11, 3], [5, 6, 7, 8, 9, 10]]
    for batch in batches:
        got = t.get(batch)
        np.testing.assert_array_equal(got, plain.get(batch))
        np.testing.assert_array_equal(got, np.asarray(ref.get(batch)))
        _drain(t)
        _drain(ref)
    update = _rows_for([2, 60, 90], base=0.5)
    for table in (t, plain, ref):
        table.set([2, 60, 90], update)
    _drain(t)
    _drain(ref)
    sids, srows = t.snapshot()
    for other in (plain, ref):
        pids, prows = other.snapshot()
        so, po = np.argsort(sids), np.argsort(pids)
        np.testing.assert_array_equal(sids[so], pids[po])
        np.testing.assert_array_equal(srows[so], prows[po])
    assert t.stats()["disk_rows"] > 0


def test_warm_write_supersedes_disk_copy(tmp_path):
    t = _tiered(tmp_path, warm_rows=2)
    _fill(t, 6)
    _drain(t)
    cold = sorted(t._disk)
    assert cold
    new = np.full((1, DIM), 55.0, np.float32)
    t.set([cold[0]], new)
    assert cold[0] not in t._disk
    np.testing.assert_array_equal(t.get([cold[0]]), new)


# -- snapshots across tier configurations ----------------------------------


@pytest.mark.parametrize("kind", INNERS)
def test_snapshot_roundtrip_tiered_to_plain(tmp_path, kind):
    t = _tiered(tmp_path, warm_rows=4, kind=kind)
    ids, rows = _fill(t, 16)
    _drain(t)
    assert t.stats()["disk_rows"] > 0
    sids, srows = t.snapshot()
    assert len(sids) == 16
    plain = EmbeddingTable("emb", DIM, "zeros")
    plain.load_snapshot(sids, srows)
    np.testing.assert_array_equal(plain.get(list(ids)), rows)


def test_snapshot_roundtrip_plain_to_tiered(tmp_path):
    plain = EmbeddingTable("emb", DIM, "zeros")
    ids = np.arange(16, dtype=np.int64)
    rows = _rows_for(ids, base=7.0)
    plain.set(ids, rows)
    t = _tiered(tmp_path, warm_rows=4)
    _fill(t, 6, base=100.0)  # rows before the restore, some spilled
    _drain(t)
    assert snapshot_versions(t._dir)
    t.load_snapshot(*plain.snapshot())
    assert t.stats()["disk_rows"] == 0 and not snapshot_versions(t._dir)
    np.testing.assert_array_equal(t.get(ids), rows)
    _drain(t)
    assert t.stats()["disk_rows"] > 0
    np.testing.assert_array_equal(t.get(ids), rows)


# -- crash consistency -------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_segments_cross_between_the_packages(tmp_path, writer):
    """A spill directory one package wrote is read by the other's
    ``read_shard_snapshot`` and re-attached by the other's tier."""
    cls, other = (TieredEmbeddingTable, JTiered) if writer == "port" \
        else (JTiered, TieredEmbeddingTable)
    t = _tiered(tmp_path, warm_rows=2, cls=cls)
    ids, rows = _fill(t, 8, base=3.0)
    _drain(t)
    cold = dict(t._disk)
    assert cold
    for gen in sorted(set(cold.values())):
        seg = os.path.join(t._dir, "snap_v%d" % gen)
        for read in (read_shard_snapshot, j_read):
            snap = read(seg)["tables"]["emb"]
            for i, row in zip(snap["ids"], snap["rows"]):
                np.testing.assert_array_equal(row, rows[int(i)])
    again = _tiered(tmp_path, warm_rows=2, cls=other)
    assert dict(again._disk) == cold
    ids_cold = sorted(cold)
    np.testing.assert_array_equal(np.asarray(again.get(ids_cold)),
                                  _rows_for(ids_cold, base=3.0))


def test_reattach_serves_spilled_rows_newest_generation_wins(tmp_path):
    t = _tiered(tmp_path, warm_rows=2)
    ids, _ = _fill(t, 4)
    _drain(t)
    t.get(ids)
    t.set(ids, _rows_for(ids, base=100.0))
    _drain(t)
    assert len(snapshot_versions(t._dir)) >= 2
    cold_now = dict(t._disk)
    assert cold_now
    t2 = _tiered(tmp_path, warm_rows=2)
    for i, gen in cold_now.items():
        assert t2._disk[i] == gen
    cold = sorted(cold_now)
    np.testing.assert_array_equal(t2.get(cold), _rows_for(cold, base=100.0))


def test_torn_and_manifestless_segments_previous_generation_serves(
    tmp_path,
):
    t = _tiered(tmp_path, warm_rows=2)
    ids, _ = _fill(t, 4)
    _drain(t)
    gen1 = snapshot_versions(t._dir)
    assert gen1
    t.get(ids)
    t.set(ids, _rows_for(ids, base=100.0))
    _drain(t)
    newest = max(snapshot_versions(t._dir))
    assert newest > max(gen1)
    torn = os.path.join(t._dir, "tmp-snap_v%d.123" % (newest + 1))
    os.makedirs(torn)
    with open(os.path.join(torn, "table.0.npz"), "wb") as f:
        f.write(b"torn bytes")
    os.remove(os.path.join(t._dir, "snap_v%d" % newest, "manifest.json"))
    t2 = _tiered(tmp_path, warm_rows=2)
    cold = sorted(t2._disk)
    assert cold and all(gen < newest for gen in t2._disk.values())
    np.testing.assert_array_equal(t2.get(cold), _rows_for(cold))


def test_crash_between_seal_and_index_keeps_row_warm(tmp_path):
    t = _tiered(tmp_path, warm_rows=8)
    _, rows = _fill(t, 4)
    write_shard_snapshot(t._dir, {
        "version": 50, "initialized": True, "dense": {},
        "tables": {"emb": {"ids": np.array([0], dtype=np.int64),
                           "rows": np.full((1, DIM), 123.0, np.float32),
                           "dim": DIM, "initializer": "zeros",
                           "is_slot": False}},
    })
    np.testing.assert_array_equal(t.get([0]), rows[:1])
    sids, srows = t.snapshot()
    assert int((sids == 0).sum()) == 1
    np.testing.assert_array_equal(srows[sids == 0], rows[:1])


def test_failed_segment_write_keeps_rows_warm(tmp_path, monkeypatch):
    import elasticdl_tpu_torch.ps.tiered_store as ts

    t = _tiered(tmp_path, warm_rows=2)
    ids, rows = _fill(t, 6)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ts, "write_shard_snapshot", boom)
    assert t._demote_once() == 0
    assert t.stats()["warm_rows"] == 6 and t.stats()["disk_rows"] == 0
    np.testing.assert_array_equal(t.get(ids), rows)


def test_row_touched_mid_spill_stays_warm(tmp_path, monkeypatch):
    import elasticdl_tpu_torch.ps.tiered_store as ts

    t = _tiered(tmp_path, warm_rows=2)
    _fill(t, 6)
    real = ts.write_shard_snapshot
    hit = {}

    def touching_write(directory, state, **kw):
        seg = next(iter(state["tables"].values()))
        hit["victim"] = int(np.asarray(seg["ids"]).reshape(-1)[0])
        # the write holds no lock: a concurrent set is legal here
        t.set([hit["victim"]], np.full((1, DIM), 777.0, np.float32))
        return real(directory, state, **kw)

    monkeypatch.setattr(ts, "write_shard_snapshot", touching_write)
    t._demote_once()
    victim = hit["victim"]
    assert victim not in t._disk and victim in t._inner.embedding_vectors
    np.testing.assert_array_equal(
        t.get([victim]), np.full((1, DIM), 777.0, np.float32))


# -- the signals --------------------------------------------------------------


def test_note_applied_pins_recent_rows_against_demotion(tmp_path):
    t = _tiered(tmp_path, warm_rows=2)
    _fill(t, 8)
    t.note_applied([0, 1], version=5)
    _drain(t)
    assert {0, 1} <= set(t._inner.embedding_vectors)
    assert 0 not in t._disk and 1 not in t._disk
    assert t.stats()["disk_rows"] == 6
    # the pin ring keeps _PIN_VERSIONS (2) behind the newest note
    t.note_applied([0], version=30)
    _drain(t)
    assert 1 in t._disk and 0 not in t._disk


def test_read_pins_block_eviction(tmp_path):
    t = _tiered(tmp_path, warm_rows=2)
    _fill(t, 6)
    with t._mu:
        t._pins.update([3])
    _drain(t)
    assert 3 in t._inner.embedding_vectors and 3 not in t._disk
    with t._mu:
        t._pins.subtract([3])
        t._pins += collections.Counter()
    t.set([100, 101], _rows_for([100, 101]))
    _drain(t)
    assert 3 in t._disk


def test_cold_note_applied_never_fabricates_a_warm_victim(tmp_path):
    t = _tiered(tmp_path, warm_rows=2)
    _fill(t, 6)
    _drain(t)
    cold = sorted(t._disk)
    assert cold
    t.note_applied(cold, version=9)
    assert not set(cold) & set(t._ticks)
    t.set([100, 101], _rows_for([100, 101], base=50.0))
    _drain(t)
    np.testing.assert_array_equal(t.get(cold), _rows_for(cold))


def test_hit_rate_signal_sets_eviction_depth(tmp_path):
    t = _tiered(tmp_path, warm_rows=10)
    _fill(t, 12)
    with t._mu:
        assert t._demote_target_locked() == 9  # no pulls: hit rate 1.0
    _drain(t)
    assert t.stats()["warm_rows"] == 9
    t.get(sorted(t._disk))
    _drain(t)
    while True:
        s = t.stats()
        pulls = s["warm_hit_rows"] + s["cold_pull_rows"]
        if pulls and s["warm_hit_rows"] / pulls < 0.98:
            break
        cold = sorted(t._disk)
        assert cold, "expected cold rows to pull"
        t.get(cold)
        _drain(t)
    with t._mu:
        assert t._demote_target_locked() == 10


# -- the device arm -------------------------------------------------------------


def test_device_tiered_ensure_rows_promotes_before_lazy_init(tmp_path):
    t = _tiered(tmp_path, warm_rows=2, kind="device")
    ids = np.arange(6, dtype=np.int64)
    t.set(ids, _rows_for(ids, base=3.0))
    _drain(t)
    cold = sorted(t._disk)
    assert cold
    slots = t.ensure_rows(np.asarray(cold, dtype=np.int64))
    assert len(slots) == len(cold) and not set(cold) & set(t._disk)
    np.testing.assert_array_equal(
        t.gather_slots(slots).numpy(), _rows_for(cold, base=3.0))
    np.testing.assert_array_equal(t.get(cold), _rows_for(cold, base=3.0))


def test_device_free_list_keeps_arena_at_warm_size(tmp_path):
    inner = _inner("device")
    t = _tiered(tmp_path, warm_rows=8, inner=inner)
    for batch in range(16):
        t.get(np.arange(batch * 8, batch * 8 + 8, dtype=np.int64))
        _drain(t)
    assert inner.capacity == 64 and len(t) == 128


def test_host_missing_and_evict_rows():
    e, ref = EmbeddingTable("x", 3, "zeros"), JTable("x", 3, "zeros")
    for t in (e, ref):
        t.get([1, 2, 3])
    assert e.missing_ids([2, 9]) == ref.missing_ids([2, 9]) == [9]
    assert len(e) == 3
    assert e.evict_rows([1, 9]) == ref.evict_rows([1, 9]) == 1
    assert 1 not in e.embedding_vectors
    e.clear()
    assert len(e) == 0


# -- counters, close ------------------------------------------------------------


@pytest.mark.parametrize("kind", INNERS)
def test_stats_count_as_the_references(tmp_path, kind):
    t = _tiered(tmp_path / "port", warm_rows=4, init="uniform", kind=kind)
    ref = _tiered(tmp_path / "ref", warm_rows=4, init="uniform", cls=JTiered)
    rng = np.random.default_rng(9)
    for step in range(6):
        ids = rng.integers(0, 40, 10)
        for table in (t, ref):
            table.get(ids)
            table.note_applied(ids[:3], version=step)
            _drain(table)
    assert t.stats() == ref.stats()
    assert set(t.stats()) == {
        "warm_rows", "disk_rows", "spilled_rows", "spill_segments",
        "cold_pull_rows", "cold_pull_segments", "promoted_rows",
        "warm_hit_rows"}
    assert t.stats()["cold_pull_rows"] > 0


def test_close_stops_the_demoter(tmp_path):
    t = _tiered(tmp_path, warm_rows=2, background=True)
    thread = t._thread
    assert thread.is_alive()
    t.close()
    assert not thread.is_alive() and t._thread is None
    t.close()  # a second close is a no-op
    _fill(t, 6)  # the table still serves, without spilling
    time.sleep(0.05)
    assert t.stats()["spilled_rows"] == 0 and t.stats()["warm_rows"] == 6


def test_the_background_demoter_spills_the_overflow(tmp_path):
    t = _tiered(tmp_path, warm_rows=4, background=True)
    try:
        ids, rows = _fill(t, 20)
        deadline = time.time() + 10
        while t.stats()["disk_rows"] == 0 and time.time() < deadline:
            t.signal_pressure()
            time.sleep(0.02)
        assert t.stats()["disk_rows"] > 0 and t.stats()["warm_rows"] <= 4
        np.testing.assert_array_equal(t.get(ids), rows)
    finally:
        t.close()


# -- the store, the servicer, the shard --------------------------------------


def test_parameters_tier_config_wraps_row_and_slot_tables(tmp_path):
    p = Parameters(tier_config={"warm_rows": 4,
                                "spill_dir": str(tmp_path / "spill")})
    try:
        p.init_from_model(0, {"w": np.zeros((2, 2), np.float32)},
                          [EmbeddingTableInfo("emb", DIM, "zeros")])
        assert isinstance(p.embedding_params["emb"], TieredEmbeddingTable)
        p.create_slot_params(["m"], {"m": 0.0})
        assert isinstance(p.embedding_params["emb-m"], TieredEmbeddingTable)
        assert os.path.isdir(str(tmp_path / "spill" / "emb-m"))
        old = p.embedding_params["emb"]
        p.restore_state(p.snapshot_state())
        assert isinstance(p.embedding_params["emb"], TieredEmbeddingTable)
        assert old._thread is None  # closed before its directory is reused
    finally:
        p.close()
    with pytest.raises(ValueError, match="spill_dir"):
        Parameters(tier_config={"warm_rows": 4})


@pytest.mark.parametrize("device", [None, "cpu"])
def test_servicer_forwards_apply_notes_and_reports_tier_stats(
    tmp_path, device
):
    p = Parameters(device=device, tier_config={
        "warm_rows": 4, "spill_dir": str(tmp_path / "spill")})
    s = PserverServicer(p, 1, lambda ps: torch.optim.SGD(
        ps, lr=0.1, momentum=0.9), "cpu")
    try:
        s.push_model({"version": 0,
                      "params": [Tensor("w", np.ones((2, 2), np.float32))],
                      "embedding_infos": [{"name": "emb", "dim": DIM}]})
        for step in range(4):
            ids = np.arange(step * 8, step * 8 + 8, dtype=np.int64)
            s.push_gradient({"model_version": step, "gradients": [
                Tensor("emb", np.ones((8, DIM), np.float32), indices=ids)]})
        table = p.embedding_params["emb"]
        slot = p.embedding_params["emb-momentum_buffer"]
        # the note reached the rows and the slot table alike
        assert table._applied and slot._applied
        assert table._applied[-1] == (4, set(range(24, 32)))
        deadline = time.time() + 10.0
        while time.time() < deadline and table.stats()["disk_rows"] == 0:
            table.signal_pressure()
            time.sleep(0.02)
        resp = s.ps_status({})
        assert resp["tiered"]["spilled_rows"] > 0
        assert resp["tiered"]["disk_rows"] > 0
        assert resp["tables"]["emb"] == 32
        with table._mu:
            cold = sorted(table._disk)
        assert cold
        out = s.pull_embedding_vector(
            {"name": "emb", "ids": np.asarray(cold, dtype=np.int64)})
        assert np.asarray(out["rows"]).shape == (len(cold), DIM)
        assert s.ps_status({})["tiered"]["cold_pull_rows"] > 0
    finally:
        p.close()


def test_a_shard_is_built_from_the_tier_flags(tmp_path):
    """``ps.main``'s arguments on the CPU: ``--ps_device --ps_warm_rows
    --ps_spill_dir`` give a device store tiered under ``<dir>/ps-{id}``,
    whose ``ps_status`` reports ``tiered``."""
    from elasticdl_tpu_torch.common.args import parse_ps_args
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
    from tests.test_torch_ps_job import DEEPFM, SMALL

    spill = tmp_path / "spill"
    server = ParameterServer(parse_ps_args([
        "--ps_id", "1", "--port", "1", "--model_zoo", "", "--model_def",
        DEEPFM, "--model_params", SMALL, "--device", "cpu", "--ps_device",
        "true", "--ps_warm_rows", "4", "--ps_spill_dir", str(spill)]))
    try:
        params = server.parameters
        assert params.device == torch.device("cpu")
        assert params.tier_config["spill_dir"] == str(spill / "ps-1")
        server.servicer.push_model({
            "version": 0, "params": [],
            "embedding_infos": [{"name": "embedding", "dim": 8}]})
        table = params.embedding_params["embedding"]
        assert isinstance(table, TieredEmbeddingTable)
        assert isinstance(table._inner, DeviceEmbeddingTable)
        server.servicer.pull_embedding_vector(
            {"name": "embedding", "ids": np.arange(16)})
        status = server.servicer.ps_status({})
        assert status["tiered"]["warm_hit_rows"] == 16
        assert os.path.isdir(str(spill / "ps-1" / "embedding"))
    finally:
        server.stop()
    assert table._thread is None  # the stop closed the demoters


def test_one_tier_flag_alone_runs_untiered_with_a_warning(tmp_path, caplog):
    from elasticdl_tpu_torch.common.args import parse_ps_args
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
    from tests.test_torch_ps_job import DEEPFM, SMALL

    logger = logging.getLogger("elasticdl_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        server = ParameterServer(parse_ps_args([
            "--ps_id", "0", "--port", "1", "--model_zoo", "", "--model_def",
            DEEPFM, "--model_params", SMALL, "--device", "cpu",
            "--ps_warm_rows", "4"]))
    finally:
        logger.removeHandler(caplog.handler)
    assert server.parameters.tier_config is None
    assert server.parameters.device is None
    assert "running untiered" in caplog.text
    server.stop()
