"""The PS fleet: placement hashing against the JAX package's, the port's
shard servicer against ``elasticdl_tpu.ps.servicer.PserverServicer`` fed
the same pushes (sync over two with a stale rejection, async with
staleness modulation; SGD with momentum and Adam), the ``PSClient``
fan-out and reconnect protocol over in-process shards, shard snapshots
(the port's round trip, the torn-newest fallthrough, a snapshot the JAX
package wrote), the DeepFM job on two in-process shards against the
master-held job, what stays out raising by name, and a two-shard fleet
of real processes over sockets."""

import os
import sys
import threading
import time

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.hash_utils import (
    int_to_id as j_int_to_id,
    scatter_embedding_vector as j_scatter,
    string_to_id as j_string_to_id,
)
from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.ps.optimizer_wrapper import OptimizerWrapper as JWrapper
from elasticdl_tpu.ps.parameters import Parameters as JParameters
from elasticdl_tpu.ps.servicer import PserverServicer as JServicer
from elasticdl_tpu.ps.snapshot import write_shard_snapshot as j_write
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.hash_utils import (
    int_to_id,
    scatter_embedding_vector,
    string_to_id,
)
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.ps.snapshot import (
    ShardSnapshotter,
    read_shard_snapshot,
    snapshot_path,
    write_shard_snapshot,
)
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_torch_ps_job import (
    DEEPFM,
    PORT_ZOO,
    REPO,
    SMALL,
    _free_port,
    _identity_shuffle,
    write_frappe,
)

MODEL = {"w": (4, 3), "b": (3,), "v": (2, 5)}
OPTS = {
    "momentum": (
        lambda lr: (lambda p: torch.optim.SGD(p, lr=lr, momentum=0.9)),
        lambda lr: optax.sgd(lr, momentum=0.9), 1e-6,
    ),
    "adam": (
        lambda lr: (
            lambda p: torch.optim.Adam(p, lr=lr, betas=(0.9, 0.9375))),
        lambda lr: optax.adam(lr, b1=0.9, b2=0.9375), 1e-5,
    ),
}


def _model(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in MODEL.items()}


def _infos():
    return [{"name": "emb", "dim": 3, "initializer": "uniform"},
            {"name": "bias", "dim": 1, "initializer": "zeros"}]


def _push(rng):
    """One worker's push: dense gradients and two tables' row gradients
    (duplicate ids)."""
    ids = rng.integers(0, 60, 9)
    return {
        "w": (rng.normal(size=(4, 3)).astype(np.float32), None),
        "b": (rng.normal(size=(3,)).astype(np.float32), None),
        "v": (rng.normal(size=(2, 5)).astype(np.float32), None),
        "emb": (rng.normal(size=(9, 3)).astype(np.float32), ids),
        "bias": (rng.normal(size=(3, 1)).astype(np.float32), ids[:3]),
    }


def _req(cls, push, version):
    return {"model_version": version,
            "gradients": [cls(k, v, i) for k, (v, i) in push.items()]}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- placement -------------------------------------------------------------


def test_placement_matches_the_reference():
    # the dense names of the zoo's DeepFM and MNIST CNN, and the tables
    names = ["Dense_0/kernel", "Dense_0/bias", "Dense_1/kernel",
             "Dense_1/bias", "Conv_0/kernel", "Conv_1/bias",
             "GroupNorm_0/scale", "embedding", "id_bias"]
    for n in (1, 2, 3, 7):
        assert [string_to_id(x, n) for x in names] == [
            j_string_to_id(x, n) for x in names]
    ids = np.random.default_rng(0).integers(0, 1 << 40, 10000)
    assert [int_to_id(i, 2) for i in ids[:500]] == [
        j_int_to_id(i, 2) for i in ids[:500]]
    values = np.arange(10000 * 2, dtype=np.float32).reshape(10000, 2)
    got, want = scatter_embedding_vector(values, ids, 3), j_scatter(
        values, ids, 3)
    assert sorted(got) == sorted(want)
    for shard in want:
        assert np.array_equal(got[shard][0], want[shard][0])
        assert np.array_equal(got[shard][1], want[shard][1])
        assert np.all(got[shard][1] % 3 == shard)


# -- the shard servicer against the reference's ----------------------------


def _pair(opt, use_async=False, grads_to_wait=1, modulation=False, lr=0.1):
    make_port, make_ref, _ = OPTS[opt]
    port = PserverServicer(
        Parameters(), grads_to_wait, make_port(lr), "cpu",
        lr_staleness_modulation=modulation, use_async=use_async,
        shard_epoch=3,
    )
    ref = JServicer(
        JParameters(), grads_to_wait, make_ref(lr),
        lr_staleness_modulation=modulation, use_async=use_async,
    )
    model = _model()
    for s, cls in ((port, Tensor), (ref, JTensor)):
        s.push_model({"version": 0, "embedding_infos": _infos(),
                      "params": [cls(k, v) for k, v in model.items()]})
        # first write wins
        s.push_model({"version": 0, "params": [
            cls(k, np.zeros_like(v)) for k, v in model.items()]})
    return port, ref


def _assert_same(port, ref, ids, tol):
    got, want = port.pull_variable({}), ref.pull_variable({})
    assert got["version"] == want["version"] and got["shard_epoch"] == 3
    want_dense = {t.name: t.values for t in want["params"]}
    assert sorted(t.name for t in got["params"]) == sorted(want_dense)
    for t in got["params"]:
        assert _rel_l2(t.values, want_dense[t.name]) <= tol, t.name
    for table in ("emb", "bias"):
        req = {"name": table, "ids": ids}
        assert _rel_l2(port.pull_embedding_vector(req)["rows"],
                       ref.pull_embedding_vector(req)["rows"]) <= tol, table


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sync_servicer_matches_the_reference(opt):
    port, ref = _pair(opt, grads_to_wait=2)
    rng = np.random.default_rng(1)
    seen = []
    for version in (0, 0, 1, 1, 2, 2):
        push = _push(rng)
        seen.extend(push["emb"][1])
        got = port.push_gradient(_req(Tensor, push, version))
        want = ref.push_gradient(_req(JTensor, push, version))
        assert (got["accepted"], got["version"]) == (
            want["accepted"], want["version"])
    assert port.ps_status({})["version"] == 3
    # a stale push is rejected
    push = _push(rng)
    got = port.push_gradient(_req(Tensor, push, 1))
    assert (got["accepted"], got["version"]) == (False, 3)
    assert not ref.push_gradient(_req(JTensor, push, 1))["accepted"]
    _assert_same(port, ref, np.unique(seen), OPTS[opt][2])


class _ModulatedReference:
    """The reference's apply at ``lr * multiplier`` per apply, its
    optimizer state carried across (its jitted steps bake the multiplier
    in when they are traced)."""

    def __init__(self, ref, make_ref, lr):
        self._ref, self._make, self._lr = ref, make_ref, lr
        self.apply_lock = threading.Lock()
        self._dense_state, self._non_row = None, {}

    def apply_gradients(self, dense_grads=None, embedding_grads=None):
        wrapper = JWrapper(
            self._make(self._lr * self._ref._lr_modulation.get_multiplier()),
            self._ref._parameters,
        )
        wrapper._dense_opt_state = self._dense_state
        wrapper._non_row_state = self._non_row
        wrapper.apply_gradients(dense_grads=dense_grads,
                                embedding_grads=embedding_grads)
        self._dense_state = wrapper._dense_opt_state
        self._non_row = wrapper._non_row_state


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_async_servicer_matches_the_reference(opt):
    port, ref = _pair(opt, use_async=True, modulation=True)
    ref._optimizer = _ModulatedReference(ref, OPTS[opt][1], 0.1)
    rng = np.random.default_rng(2)
    seen = []
    # request versions 0, 0, 0, 1, 4: staleness 1, 1, 2, 2, 1
    for version in (0, 0, 0, 1, 4):
        push = _push(rng)
        seen.extend(push["emb"][1])
        got = port.push_gradient(_req(Tensor, push, version))
        want = ref.push_gradient(_req(JTensor, push, version))
        assert (got["accepted"], got["version"]) == (
            want["accepted"], want["version"])
    assert port.ps_status({})["version"] == 5
    assert port._lr_modulation.get_multiplier() == 1.0
    _assert_same(port, ref, np.unique(seen), OPTS[opt][2])


def test_status_counts_applies_and_rows():
    port, _ = _pair("momentum")
    port.push_gradient(_req(Tensor, _push(np.random.default_rng(3)), 0))
    status = port.ps_status({})
    assert status["initialized"] and status["version"] == 1
    assert len(status["apply_ms"]["dense"]) == 1
    assert len(status["apply_ms"]["sparse"]) == 1
    assert status["tables"]["emb"] == status["tables"]["emb-momentum_buffer"]
    assert status["table_bytes"] > 0


# -- the client -------------------------------------------------------------


def _fleet(n, opt="momentum", epoch=1, **kwargs):
    return [PserverServicer(Parameters(), 1, OPTS[opt][0](0.1), "cpu",
                            shard_epoch=epoch, **kwargs) for _ in range(n)]


def _drive_client(n, **client_kwargs):
    """Push the model and three gradients through a client of ``n``
    in-process shards; the pulled dense model and rows."""
    model = _model()
    infos = [EmbeddingTableInfo(i["name"], i["dim"], i["initializer"])
             for i in _infos()]
    shards = _fleet(n)
    client = PSClient(shards, **client_kwargs)
    try:
        client.push_model(model, infos)
        rng = np.random.default_rng(4)
        for version in range(3):
            push = _push(rng)
            dense = {k: v for k, (v, i) in push.items() if i is None}
            sparse = [Tensor(k, v, i) for k, (v, i) in push.items()
                      if i is not None]
            assert client.push_gradient(dense, sparse, version) == (
                True, version + 1)
        ready, version, named = client.pull_dense()
        assert ready and version == 3
        ids = np.arange(60)
        rows = client.pull_embedding_vectors_multi(
            {"emb": ids, "bias": ids[::-1]})
        for shard, s in enumerate(shards):
            params = s._parameters
            assert set(params.non_embedding_params) == {
                k for k in model if string_to_id(k, n) == shard}
            table = params.embedding_params["emb"]
            assert all(i % n == shard for i in table.embedding_vectors)
    finally:
        client.close()
    return named, rows


def _assert_same_pulls(a, b):
    (a_named, a_rows), (b_named, b_rows) = a, b
    assert set(a_named) == set(b_named) and set(a_rows) == set(b_rows)
    for k in a_named:
        assert np.array_equal(a_named[k], b_named[k]), k
    for k in a_rows:
        assert np.array_equal(a_rows[k], b_rows[k]), k


def test_fan_out_equals_one_shard():
    _assert_same_pulls(_drive_client(1), _drive_client(2))


def test_the_serial_client_equals_the_fan_out():
    """``--ps_fanout false`` runs the legs one after another on the
    caller's thread, with the same result."""
    _assert_same_pulls(_drive_client(2), _drive_client(2, fanout=False))


class _Leg:
    """A shard stub whose pull fails after a delay, counting finishes."""

    def __init__(self, delay, err, finished):
        self.delay, self.err, self.finished = delay, err, finished

    def pull_variable(self, req):
        time.sleep(self.delay)
        self.finished.append(self.err)
        raise self.err

    def ps_status(self, req):
        return {"shard_epoch": 1, "version": 0, "initialized": True}


def test_the_lowest_failing_shard_raises_after_every_leg():
    finished = []
    first, second = RuntimeError("shard 0"), RuntimeError("shard 1")
    client = PSClient([_Leg(0.3, first, finished),
                       _Leg(0.0, second, finished)])
    try:
        with pytest.raises(RuntimeError, match="shard 0"):
            client.pull_dense()
        assert finished == [second, first]
    finally:
        client.close()


def test_a_new_shard_epoch_triggers_the_re_push_once():
    shards = _fleet(2, epoch=1)
    client = PSClient(shards, push_inflight=1)
    model = _model()
    infos = [EmbeddingTableInfo("emb", 3)]
    calls = []

    def on_reset(ids):
        calls.append(ids)
        client.push_model(model, infos)

    client.set_on_shard_reset(on_reset)
    client.push_model(model, infos)
    assert client.pull_dense()[0]
    # shard 1 comes back empty under a new epoch
    shards[1] = PserverServicer(Parameters(), 1, OPTS["momentum"][0](0.1),
                                "cpu", shard_epoch=2)
    client._ps[1] = shards[1]
    assert client.pull_dense() == (False, -1, {})
    assert client.shard_epochs == {0: 1, 1: 2}
    ready, _, named = client.pull_dense()
    assert ready and sorted(named) == sorted(model)
    assert client.pull_dense()[0]
    assert calls == [[1]]
    assert [r[:3] for r in client.relaunches] == [(1, 1, 2)]


def test_a_push_in_flight_across_a_relaunch_is_dropped():
    shards = _fleet(2, epoch=1)
    client = PSClient(shards, push_inflight=1)
    client.push_model(_model(), [EmbeddingTableInfo("emb", 3)])
    gate = threading.Event()
    real = shards[0].push_gradient

    def slow_push(req):
        gate.wait(5)
        raise RuntimeError("the dead incarnation")

    shards[0].push_gradient = slow_push
    grads = {"w": np.ones((4, 3), np.float32)}
    assert client.push_gradient(grads, [], 0) == (True, -1)
    # the relaunch is seen on another call's reply, then the push fails
    client._note_shard_reply(0, {"shard_epoch": 2, "version": 0,
                                 "initialized": True})
    gate.set()
    assert client.drain() == (True, -1)
    shards[0].push_gradient = real
    client.close()


# -- snapshots --------------------------------------------------------------


def _trained_shard(tmp_path, every=0):
    snap = ShardSnapshotter(str(tmp_path), every_versions=every, keep=2)
    port = PserverServicer(Parameters(), 1, OPTS["momentum"][0](0.1), "cpu",
                           snapshotter=snap if every else None)
    port.push_model({"version": 0, "embedding_infos": _infos(),
                     "params": [Tensor(k, v) for k, v in _model().items()]})
    rng = np.random.default_rng(5)
    for version in range(8):
        port.push_gradient(_req(Tensor, _push(rng), version))
    return port, snap


def test_snapshot_round_trip_is_bitwise(tmp_path):
    port, snap = _trained_shard(tmp_path / "s", every=4)
    snap.wait()
    restored = Parameters()
    ShardSnapshotter(str(tmp_path / "s"), every_versions=4).restore_into(
        restored)
    want = port._parameters.snapshot_state()
    got = restored.snapshot_state()
    assert got["version"] == want["version"] == 8 and got["initialized"]
    for k in want["dense"]:
        assert np.array_equal(got["dense"][k], want["dense"][k])
    assert sorted(got["tables"]) == sorted(want["tables"]) == [
        "bias", "bias-momentum_buffer", "emb", "emb-momentum_buffer"]
    for name, t in want["tables"].items():
        order = np.argsort(t["ids"])
        gorder = np.argsort(got["tables"][name]["ids"])
        assert np.array_equal(got["tables"][name]["ids"][gorder],
                              t["ids"][order])
        assert np.array_equal(got["tables"][name]["rows"][gorder],
                              t["rows"][order])
    # both versions kept (keep 2), published manifest-last
    assert sorted(os.listdir(tmp_path / "s")) == ["snap_v4", "snap_v8"]
    snap.close()


def test_a_torn_newest_snapshot_falls_through(tmp_path):
    port, snap = _trained_shard(tmp_path / "s", every=4)
    snap.close()
    torn = snapshot_path(str(tmp_path / "s"), 8)
    with open(os.path.join(torn, "table.0.npz"), "wb") as f:
        f.write(b"torn")
    restored = Parameters()
    version = ShardSnapshotter(
        str(tmp_path / "s"), every_versions=4).restore_into(restored)
    assert version == 4 and restored.version == 4
    older = read_shard_snapshot(snapshot_path(str(tmp_path / "s"), 4))
    for k, v in older["dense"].items():
        assert np.array_equal(restored.non_embedding_params[k], v)
    # a disabled snapshotter restores nothing
    assert ShardSnapshotter(str(tmp_path / "s")).restore_into(
        Parameters()) is None


def test_a_reference_snapshot_restores_into_the_port(tmp_path):
    ref = JServicer(JParameters(), 1, optax.sgd(0.1, momentum=0.9))
    ref.push_model({"version": 0, "embedding_infos": _infos(),
                    "params": [JTensor(k, v) for k, v in _model().items()]})
    rng = np.random.default_rng(6)
    for version in range(3):
        ref.push_gradient(_req(JTensor, _push(rng), version))
    state = ref._parameters.snapshot_state()
    j_write(str(tmp_path), state, ps_id=0, shard_epoch=1)
    restored = Parameters()
    assert ShardSnapshotter(str(tmp_path), every_versions=1).restore_into(
        restored) == 3
    for k, v in state["dense"].items():
        assert np.array_equal(restored.non_embedding_params[k], v)
    for name in ("emb", "bias"):
        ids = state["tables"][name]["ids"]
        assert np.array_equal(restored.get_embedding_param(name, ids),
                              state["tables"][name]["rows"])
    # and the port's own writer reads back through the reference's reader
    from elasticdl_tpu.ps.snapshot import read_shard_snapshot as j_read

    again = write_shard_snapshot(str(tmp_path / "p"),
                                 restored.snapshot_state())
    back = j_read(again)
    assert back["version"] == 3
    for k, v in state["dense"].items():
        assert np.array_equal(back["dense"][k], v)


# -- the job on two in-process shards -----------------------------------------


def _held_job(shards):
    t_task_d = TaskDispatcher(shards, {}, {}, 32, 1)
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    master = MasterServicer(1, 32, tzoo.optimizer(), t_task_d, device="cpu")
    worker = Worker(worker_id=0, job_type=JobType.TRAINING_ONLY,
                    minibatch_size=32, model_zoo=PORT_ZOO, model_def=DEEPFM,
                    model_params=SMALL, stub=master, device="cpu")
    worker.run()
    return master, worker


def test_the_fleet_job_matches_the_held_job(monkeypatch, tmp_path):
    """DeepFM on two in-process shards against the master-held job from
    the same seed: bitwise on the dense model and the rows; each shard
    holds exactly its ids."""
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "3")
    monkeypatch.setattr(TDataset, "shuffle", _identity_shuffle)
    f = write_frappe(str(tmp_path), 128, 300)
    held, _ = _held_job({f: (0, 128)})

    task_d = TaskDispatcher({f: (0, 128)}, {}, {}, 32, 1)
    master = MasterServicer(1, 32, None, task_d, coordinates_only=False,
                            device="cpu")
    shards = [PserverServicer(Parameters(), 1, tzoo.optimizer(), "cpu",
                              shard_epoch=1) for _ in range(2)]
    client = PSClient(shards)
    worker = Worker(worker_id=0, job_type=JobType.TRAINING_ONLY,
                    minibatch_size=32, model_zoo=PORT_ZOO, model_def=DEEPFM,
                    model_params=SMALL, stub=master, device="cpu",
                    ps_client=client)
    losses = worker.run()
    client.close()
    assert task_d.finished() and len(losses) == 4
    ready, version, dense = PSClient(shards).pull_dense()
    assert ready and version == 4
    _, want = held.get_model(4)
    assert sorted(dense) == sorted(want)
    for k in want:
        assert np.array_equal(dense[k], want[k]), k
    store = held.embedding_store.embedding_params
    for table in ("embedding", "id_bias"):
        ids = np.array(sorted(store[table].embedding_vectors))
        for shard, s in enumerate(shards):
            mine = s._parameters.embedding_params[table].embedding_vectors
            assert all(i % 2 == shard for i in mine)
        got = PSClient(shards).pull_embedding_vectors(table, ids)
        assert np.array_equal(got, held.pull_embedding_vectors(table, ids))


# -- what stays out ---------------------------------------------------------


@pytest.mark.parametrize(
    "flags,outcome",
    [(["--ps_device", "true"], "built"),
     (["--ps_warm_rows", "8", "--ps_spill_dir", "{tmp}"], "built"),
     (["--ps_telemetry_port", "0"], "serves"),
     (["--ps_shm", "on"], "unknown")],
    ids=["ps_device", "tiered", "telemetry", "shm"],
)
def test_unported_shard_planes_raise_by_name(flags, outcome, tmp_path):
    """No shard plane is refused any more: a shard builds from
    ``--ps_device`` and the tier flags, and one with
    ``--ps_telemetry_port 0`` serves its registry on ``/metrics`` and
    ``serving`` on ``/healthz``. The shard has no ``--ps_shm``, as the
    reference's has none (it always offers the shared-memory endpoint):
    the parser leaves it among the unknown flags, as the reference's
    does."""
    import urllib.request

    from elasticdl_tpu_torch.common.args import parse_ps_args
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer

    import socket

    with socket.socket() as probe:
        probe.bind(("", 0))
        port = probe.getsockname()[1]
    argv = ["--ps_id", "0", "--port", str(port), "--model_zoo", "",
            "--model_def", DEEPFM, "--device", "cpu"]
    argv += [f.replace("{tmp}", str(tmp_path)) for f in flags]
    if outcome == "unknown":
        from elasticdl_tpu.common import args as ref_args

        args = parse_ps_args(argv)
        assert not hasattr(args, "ps_shm")
        assert not hasattr(ref_args.parse_ps_args(argv), "ps_shm")
        return
    server = ParameterServer(parse_ps_args(argv))
    try:
        if outcome == "serves":
            server.prepare()
            base = "http://127.0.0.1:%d" % server.ps_telemetry_port
            server.servicer.rpc_methods()["ps_status"]({})
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                text = r.read().decode()
            assert ('edl_rpc_server_latency_seconds_count{role="ps",'
                    'method="ps_status"}') in text
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                assert r.read().decode().strip() == "serving"
        else:
            assert server.ps_telemetry_port is None
    finally:
        server.stop()


def test_the_hot_row_cache_raises_in_the_client():
    """The client's cache is ported: ``--hot_row_cache_rows`` builds it,
    its window bound to ``--get_model_steps`` by default, as the
    reference's worker binds it."""
    from elasticdl_tpu_torch.worker.main import make_ps_client
    from elasticdl_tpu_torch.common.args import parse_worker_args

    args = parse_worker_args([
        "--worker_id", "0", "--job_type", "training_only",
        "--ps_addrs", "localhost:1,localhost:2", "--model_zoo", "",
        "--model_def", DEEPFM, "--minibatch_size", "8",
        "--hot_row_cache_rows", "64", "--device", "cpu"])
    client = make_ps_client(args)
    try:
        assert client.hot_row_cache._max_rows == 64
        assert client.hot_row_cache._window == 1
    finally:
        client.close()


def test_a_shard_on_cuda_without_a_card_raises(monkeypatch):
    from elasticdl_tpu_torch.ps.parameter_server import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--ps_id", "0", "--port", "1", "--model_zoo", "",
              "--model_def", DEEPFM])


# -- a fleet of processes -----------------------------------------------------


def test_a_two_shard_fleet_of_processes_trains(tmp_path):
    """``master.main --num_ps_pods 2``, two ``ps.main`` shards and a
    ``worker.main --ps_addrs`` over sockets, under the instance manager:
    every task is done once (the master's journal)."""
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )

    data = tmp_path / "data"
    write_frappe(str(data), 256, 5000)
    mport, pports = _free_port(), [_free_port(), _free_port()]
    journal = str(tmp_path / "journal")
    py = [sys.executable, "-m"]
    common = ["--model_zoo", "", "--model_def", DEEPFM, "--model_params",
              SMALL, "--device", "cpu", "--log_level", "WARNING"]
    master_argv = py + [
        "elasticdl_tpu_torch.master.main", "--job_name", "j",
        "--training_data", str(data), "--minibatch_size", "32",
        "--num_minibatches_per_task", "2", "--num_ps_pods", "2",
        "--port", str(mport), "--master_journal_dir", journal] + common

    def ps_command(i):
        return py + ["elasticdl_tpu_torch.ps.main", "--ps_id", str(i),
                     "--port", str(pports[i])] + common

    def worker_command(worker_id, device):
        return py + [
            "elasticdl_tpu_torch.worker.main", "--worker_id",
            str(worker_id), "--job_type", "training_only",
            "--master_addr", "localhost:%d" % mport, "--ps_addrs",
            ",".join("localhost:%d" % p for p in pports),
            "--minibatch_size", "32", "--master_failover_s", "30",
        ] + common

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_MASTER_POLL_SECS="1")
    manager = LocalInstanceManager(
        None, 1, worker_command, ["cpu"], num_ps=2, ps_command=ps_command,
        env=env, master_command=lambda: master_argv,
    )
    try:
        manager.start_master()
        manager.start_all_ps()
        manager.start_workers()
        assert manager.wait(timeout=240)
        deadline = time.monotonic() + 30
        while manager.live_master() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert manager.exit_codes == {0: 0}
        assert manager.master_exit_codes == [0]
        assert sorted(manager.live_ps()) == [0, 1]
    finally:
        manager.stop_relaunch_and_remove_all_pods()
    state = MasterJournal(journal).replay()
    assert state.counters["done"] == 256 // 64 and not state.pending
    # the SIGTERM at the end drained each shard (exit 75)
    assert manager.ps_exit_codes == {0: [75], 1: [75]}


def test_the_instance_manager_relaunches_a_killed_shard(tmp_path):
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )

    script = tmp_path / "shard.py"
    script.write_text("import time\nwhile True: time.sleep(0.1)\n")
    manager = LocalInstanceManager(
        None, 0, None, [], num_ps=2,
        ps_command=lambda i: [sys.executable, str(script)],
    )
    try:
        manager.start_all_ps()
        manager.kill_ps(1)
        deadline = time.monotonic() + 20
        while len(manager.ps_spawned_at.get(1, [])) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert manager.ps_exit_codes[1] == [-9]
        assert sorted(manager.live_ps()) == [0, 1]
    finally:
        manager.stop_relaunch_and_remove_all_pods()
