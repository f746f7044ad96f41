"""The ParameterServerStrategy job on the master-held model, whole: the
in-process DeepFM job against the JAX package's ``Worker`` +
``MasterServicer`` from one set of weights; the command line with no
strategy flag; evaluation rounds, the export with its tables, and the
``evaluate`` / ``predict`` jobs under the strategy; the two-worker async
job that survives a worker kill; and the dense MNIST model."""

import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.master.checkpoint_service import (
    CheckpointService as JCheckpointService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.nn.model_api import init_variables, split_variables
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch import cli
from elasticdl_tpu_torch.common.constants import GetModelMethod, JobType
from elasticdl_tpu_torch.common.model_utils import load_from_checkpoint_file
from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.worker.worker import Worker
from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo
from tests.in_process_master import InProcessMaster
from tests.test_utils import MODEL_ZOO_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
DEEPFM = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
SMALL = "embedding_dim=8,fc_unit=8"


def write_frappe(directory, n, vocab, seed=0):
    """``n`` DeepFM records (10 ids from ``vocab``, a tenth of them 0, and
    a 0/1 label) in one file under ``directory``; returns the file."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "f0")
    with RecordIOWriter(path) as w:
        for _ in range(n):
            ids = rng.integers(1, vocab, 10)
            ids[rng.random(10) < 0.1] = 0
            w.write(encode_example({
                "feature": ids.astype(np.int64),
                "label": np.array([rng.integers(0, 2)], np.int64),
            }))
    return path


def _identity_shuffle(self, *args, **kwargs):
    return self


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize(
    "use_async,get_model_steps", [(False, 1), (True, 2)],
    ids=["sync", "async_ssp"],
)
def test_deepfm_job_matches_the_jax_job(monkeypatch, tmp_path, use_async,
                                        get_model_steps):
    """Sync, and async with SSP local updates every other step (the
    worker's own optimizer between pulls)."""
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "3")
    monkeypatch.setattr(JDataset, "shuffle", _identity_shuffle)
    monkeypatch.setattr(TDataset, "shuffle", _identity_shuffle)
    f = write_frappe(str(tmp_path), 128, 300)
    shards = {f: (0, 128)}
    # one set of weights: the flax init of the PS-plane DeepFM
    model = jzoo.custom_model(embedding_dim=8, fc_unit=8)
    params, _ = split_variables(init_variables(
        model, jax.random.PRNGKey(0),
        {"feature": np.ones((2, 10), np.int64)}))
    init_var = {k: np.asarray(v) for k, v in
                pytree_to_named_arrays(params).items()}
    assert sorted(init_var) == ["Dense_0/bias", "Dense_0/kernel",
                                "Dense_1/bias", "Dense_1/kernel"]

    j_master = JServicer(1, 32, optax.sgd(0.1), JDispatcher(
        shards, {}, {}, 32, 1), init_var=init_var,
        checkpoint_service=JCheckpointService("", 0, 0, False),
        use_async=use_async)
    JWorker(worker_id=0, job_type="training_only", minibatch_size=32,
            model_zoo=MODEL_ZOO_PATH, model_def=DEEPFM, model_params=SMALL,
            stub=InProcessMaster(j_master),
            get_model_steps=get_model_steps).run()

    t_task_d = TaskDispatcher(shards, {}, {}, 32, 1)
    t_master = MasterServicer(1, 32, _port_optimizer(), t_task_d,
                              init_var=init_var, use_async=use_async,
                              device="cpu")
    worker = Worker(worker_id=0, job_type=JobType.TRAINING_ONLY,
                    minibatch_size=32, model_zoo=PORT_ZOO, model_def=DEEPFM,
                    model_params=SMALL, stub=t_master,
                    get_model_steps=get_model_steps, device="cpu")
    losses = worker.run()
    assert t_task_d.finished() and len(losses) == 4
    assert t_master.get_model_version() == j_master.get_model_version() == 4
    _, got = t_master.get_model(4)
    _, want = j_master.get_model(4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-5, k
    store = t_master.embedding_store.embedding_params
    assert sorted(store) == ["embedding", "id_bias"]
    for table in ("embedding", "id_bias"):
        ids = np.array(sorted(store[table].embedding_vectors))
        assert sorted(j_master._embedding_store.embedding_params[
            table].embedding_vectors) == list(ids)
        assert _rel_l2(
            t_master.pull_embedding_vectors(table, ids),
            j_master.pull_embedding_vectors(table, ids)) <= 1e-5, table


def _port_optimizer():
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    return tzoo.optimizer()


def test_the_command_line_trains_without_a_strategy_flag(tmp_path):
    data = tmp_path / "data"
    write_frappe(str(data), 128, 5000)
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.cli", "train",
         "--job_name", "j", "--model_zoo", "elasticdl_tpu_torch/model_zoo",
         "--model_def", DEEPFM, "--training_data", str(data),
         "--minibatch_size", "32", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Loss is" in proc.stderr and "0 still outstanding" in proc.stderr


class _Capture:
    def __init__(self):
        self.rows = []

    def process(self, predictions, worker_id):
        self.rows.append(np.asarray(predictions["probs"]))


def test_rounds_export_and_scoring_jobs(monkeypatch, tmp_path):
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    write_frappe(str(tmp_path / "data"), 128, 400)
    write_frappe(str(tmp_path / "val"), 64, 400, seed=1)
    base = ["--job_name", "j", "--model_zoo", "", "--model_def", DEEPFM,
            "--model_params", SMALL, "--minibatch_size", "32",
            "--device", "cpu"]
    jobs = []
    assert cli.main(["train"] + base + [
        "--training_data", str(tmp_path / "data"),
        "--validation_data", str(tmp_path / "val"),
        "--evaluation_steps", "2", "--checkpoint_dir", str(tmp_path / "ck"),
        "--checkpoint_steps", "2", "--output", str(tmp_path / "out"),
    ], jobs=jobs) == 0
    master = jobs[0].master
    assert not master.master_servicer.coordinates_only
    rounds = master.evaluation_service.published
    assert [r["version"] for r in rounds] == [2, 4], rounds
    assert all(0 <= r["metrics"]["probs"]["auc"] <= 1 for r in rounds)
    # the eval checkpoints are gone once their rounds published
    eval_dir = master.checkpoint_service._eval_checkpoint_dir
    assert eval_dir and not os.listdir(eval_dir)
    export = os.path.join(tmp_path / "out", os.listdir(tmp_path / "out")[0])
    version, named = load_from_checkpoint_file(export)
    assert version == 4
    assert {"Dense_0/kernel", "edl_embedding:embedding:ids",
            "edl_embedding:id_bias:rows"} <= set(named)
    # the rows the export carries are the store's
    store = master.master_servicer
    ids = named["edl_embedding:embedding:ids"]
    assert np.array_equal(named["edl_embedding:embedding:rows"],
                          store.pull_embedding_vectors("embedding", ids))

    assert cli.main(["evaluate"] + base + [
        "--validation_data", str(tmp_path / "val"),
        "--checkpoint_filename_for_init", export], jobs=jobs) == 0
    scored = jobs[1].master.evaluation_service.published
    assert scored[0]["version"] == 4
    assert scored[0]["metrics"] == rounds[-1]["metrics"]

    capture = _Capture()
    monkeypatch.setattr(tzoo, "PredictionOutputsProcessor", capture,
                        raising=False)
    assert cli.main(["predict"] + base + [
        "--prediction_data", str(tmp_path / "val"),
        "--checkpoint_filename_for_init", export], jobs=jobs) == 0
    probs = np.concatenate(capture.rows)
    assert probs.shape == (64, 1) and np.all((probs > 0) & (probs < 1))


def test_two_worker_async_job_survives_a_worker_kill(monkeypatch, tmp_path):
    from elasticdl_tpu_torch.master import task_dispatcher as td

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    done = []
    mark = td.TaskDispatcher._mark_done_locked

    def spy(self, task, meta):
        done.append((task.shard_name, task.start, task.end, int(task.type)))
        return mark(self, task, meta)

    monkeypatch.setattr(td.TaskDispatcher, "_mark_done_locked", spy)
    write_frappe(str(tmp_path / "data"), 1536, 5000)
    jobs, result = [], []

    def run():
        result.append(cli.main([
            "train", "--job_name", "j", "--model_zoo", "",
            "--model_def", DEEPFM, "--model_params", SMALL,
            "--training_data", str(tmp_path / "data"),
            "--minibatch_size", "32", "--num_minibatches_per_task", "2",
            "--num_workers", "2", "--use_async", "true",
            "--get_model_steps", "2", "--restart_policy", "Always",
            "--device", "cpu", "--log_level", "WARNING",
        ], jobs=jobs))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 200
    while not jobs and time.monotonic() < deadline:
        time.sleep(0.05)
    master = jobs[0].master
    while master.master_servicer.get_model_version() < 8:
        assert thread.is_alive() and time.monotonic() < deadline
        time.sleep(0.02)
    master.instance_manager.kill_worker(1)
    thread.join(timeout=max(1.0, deadline - time.monotonic()))
    assert not thread.is_alive() and result == [0]
    codes = master.instance_manager.exit_codes
    assert codes[1] == -9 and codes[0] == 0 and codes[2] == 0, codes
    assert master.task_d.finished()
    # every training task done exactly once
    assert len(done) == len(set(done)) == 1536 // 64
    # each accepted gradient advanced the version once; the killed
    # worker's requeued task was trained again
    assert master.master_servicer.get_model_version() >= 1536 // 32


def test_the_mnist_job_trains_in_process(tmp_path):
    from elasticdl_tpu_torch.data.example import encode_example as enc

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    with RecordIOWriter(str(data / "f0")) as w:
        for _ in range(64):
            w.write(enc({
                "image": rng.random(784, dtype=np.float32) * 255,
                "label": np.array([rng.integers(0, 10)], np.int64),
            }))
    jobs = []
    assert cli.main([
        "train", "--job_name", "j", "--distribution_strategy", "Local",
        "--model_zoo", "", "--model_def",
        "mnist_functional_api.mnist_functional_api.custom_model",
        "--training_data", str(data), "--validation_data", str(data),
        "--evaluation_steps", "2", "--minibatch_size", "16",
        "--device", "cpu",
    ], jobs=jobs) == 0
    job = jobs[0]
    assert job.master.master_servicer.get_model_version() == 4
    assert len(job.losses) == 4 and np.all(np.isfinite(job.losses))
    _, model = job.master.master_servicer.get_model(4)
    assert {"Conv_0/kernel", "Dense_0/kernel", "GroupNorm_0/scale"} <= set(
        model)
    assert job.master.master_servicer.embedding_store.embedding_params == {}
    assert [r["version"] for r in job.master.evaluation_service.published
            ] == [2, 4]


@pytest.mark.parametrize(
    "flag",
    [["--embedding_plane", "hybrid"], ["--master_shm", "on"]],
    ids=["hybrid", "master_shm"],
)
def test_unported_planes_of_the_strategy_raise_by_name(tmp_path, flag):
    """Both are accepted: the shared-memory master channel on the held
    model (its workers' ``get_model`` rides the ring), and the hybrid
    trainer on the fleet's master (its workers keep the dense model and
    pull only the PS-plane tables' rows)."""
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.common.args import parse_master_args

    hybrid = "hybrid" in flag
    write_frappe(str(tmp_path), 64, 300)
    args = parse_master_args([
        "--job_name", "j", "--model_zoo", "", "--model_def", DEEPFM,
        "--training_data", str(tmp_path), "--minibatch_size", "8",
        "--num_ps_pods", "2" if hybrid else "0", "--device", "cpu"] + flag)
    master = Master(args)
    if hybrid:
        assert not master.holds_model and master.args.embedding_plane == (
            "hybrid")
        return
    assert master.holds_model and master.args.master_shm == "on"


def test_the_master_of_the_fleet_holds_no_model(tmp_path):
    """``--num_ps_pods`` > 0: the master dispatches, holds no model or
    optimizer, and forms no membership, as the reference's."""
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.master import Master

    write_frappe(str(tmp_path / "data"), 64, 300)
    master = Master(parse_master_args([
        "--job_name", "j", "--model_zoo", "", "--model_def", DEEPFM,
        "--training_data", str(tmp_path / "data"), "--minibatch_size", "8",
        "--num_ps_pods", "2", "--num_standby_workers", "1",
        "--device", "cpu"]))
    assert not master.holds_model and master.membership is None
    servicer = master.master_servicer
    assert not servicer.coordinates_only and servicer.embedding_store is None
    assert servicer.get_model(0) == (0, {})
    assert master.task_d.queue_depths()["todo"] == 4


@pytest.mark.parametrize(
    "flag", [["--num_standby_workers", "1"], ["--hot_row_cache_rows", "64"]],
    ids=["standby", "hot_row_cache"],
)
def test_the_held_model_runs_with_flags_the_reference_ignores(tmp_path, flag):
    """Standbys need membership and the hot-row cache a PS client: on
    the held model both are accepted and have no effect."""
    write_frappe(str(tmp_path / "data"), 64, 300)
    jobs = []
    assert cli.main([
        "train", "--job_name", "j", "--model_zoo", "", "--model_def",
        DEEPFM, "--model_params", SMALL, "--training_data",
        str(tmp_path / "data"), "--minibatch_size", "32",
        "--device", "cpu"] + flag, jobs=jobs) == 0
    assert jobs[0].master.master_servicer.get_model_version() == 2


class _Restartable:
    """A master stub whose servicer is replaced after the second
    gradient by a fresh one (empty model and tables, the version clock
    restored as a journal replay restores it), with the channel's epoch
    change fired."""

    def __init__(self, servicer, make_fresh):
        self.servicer, self._make_fresh = servicer, make_fresh
        self._on_epoch_change, self._reports = None, 0
        self.model_after_change = None

    def set_on_master_epoch_change(self, callback):
        self._on_epoch_change = callback

    def report_gradient(self, gradients, model_version):
        out = self.servicer.report_gradient(gradients, model_version)
        self._reports += 1
        if self._reports == 2:
            fresh = self._make_fresh()
            fresh.restore_version(self.servicer.get_model_version())
            self.servicer = fresh
            self._on_epoch_change(1, 2)
            self.model_after_change = fresh.get_model(2)[1]
        return out

    def __getattr__(self, name):
        return getattr(self.servicer, name)


def test_the_held_model_re_pushes_on_a_new_master_epoch(tmp_path):
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    f = write_frappe(str(tmp_path), 128, 300)
    task_d = TaskDispatcher({f: (0, 128)}, {}, {}, 32, 1)

    def make():
        return MasterServicer(1, 32, tzoo.optimizer(), task_d, device="cpu")

    stub = _Restartable(make(), make)
    worker = Worker(worker_id=0, job_type=JobType.TRAINING_ONLY,
                    minibatch_size=32, model_zoo=PORT_ZOO, model_def=DEEPFM,
                    model_params=SMALL, stub=stub, device="cpu")
    losses = worker.run()
    assert task_d.finished() and len(losses) == 4
    # the re-push landed at once: the fresh master had the model and the
    # tables before the next gradient
    assert sorted(stub.model_after_change) == [
        "Dense_0/bias", "Dense_0/kernel", "Dense_1/bias", "Dense_1/kernel"]
    assert stub.servicer.get_model_version() == 4
    assert {"embedding", "id_bias"} <= set(
        stub.servicer.embedding_store.embedding_params)


def test_streaming_exports_keep_the_newest_and_score_as_the_model(tmp_path):
    """``--export_dir --export_every_versions 2 --export_keep 2`` on the
    held MNIST model: the worker's pulled version passes the cadence at
    v1, v3, v5 and v7 (the reference's clock, which starts at -1), the
    two newest are kept, and the newest, served by the watcher, scores as
    the model at v7."""
    from elasticdl_tpu_torch.common.model_utils import build_model
    from elasticdl_tpu_torch.common.convert import to_state_dict
    from elasticdl_tpu_torch.data.example import encode_example as enc
    from elasticdl_tpu_torch.serving.scorer import (
        ModelDirectoryWatcher,
        Scorer,
    )

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    os.makedirs(data)
    with RecordIOWriter(str(data / "f0")) as w:
        for _ in range(128):
            w.write(enc({
                "image": rng.random(784, dtype=np.float32) * 255,
                "label": np.array([rng.integers(0, 10)], np.int64),
            }))
    model_def = "mnist_functional_api.mnist_functional_api.custom_model"
    jobs = []
    assert cli.main([
        "train", "--job_name", "j", "--distribution_strategy", "Local",
        "--model_zoo", "", "--model_def", model_def,
        "--training_data", str(data), "--minibatch_size", "16",
        "--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_steps", "1",
        "--export_dir", str(tmp_path / "ex"), "--export_every_versions", "2",
        "--export_keep", "2", "--device", "cpu",
    ], jobs=jobs) == 0
    job = jobs[0]
    assert job.master.master_servicer.get_model_version() == 8
    assert [v for v, _ in job.worker.exports] == [1, 3, 5, 7]
    assert sorted(os.listdir(tmp_path / "ex")) == [
        "v0000000005", "v0000000007"]
    _, at_v7 = job.master.master_servicer.get_model(7, GetModelMethod.FIXED)
    scorer = Scorer()
    watcher = ModelDirectoryWatcher(str(tmp_path / "ex"), scorer,
                                    device="cpu")
    assert watcher.poll_once() == 7
    images = rng.random((8, 28, 28), dtype=np.float32) * 255
    got, version = scorer.score({"image": images})
    assert version == 7
    model = build_model(model_def)
    model.load_state_dict(to_state_dict(at_v7))
    with torch.no_grad():
        want = model.eval()({"image": torch.from_numpy(images)})
    assert torch.equal(got, want)
    scorer.close()


@pytest.mark.parametrize("ps_device", ["false", "true"])
def test_a_serving_shard_warms_its_optimizer_off_the_store(ps_device):
    """Once it serves, a shard steps its optimizer once on a scratch row
    of its device, in the background; the store stays empty."""
    from elasticdl_tpu_torch.common.args import parse_ps_args
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer

    server = ParameterServer(parse_ps_args([
        "--ps_id", "0", "--port", str(_free_port()), "--model_zoo", "",
        "--model_def", DEEPFM, "--device", "cpu", "--ps_device", ps_device]))
    try:
        server.prepare()
        server._warm_thread.join(60)
        assert not server._warm_thread.is_alive()
        status = server.servicer.ps_status({})
        assert status["version"] == 0 and not status["initialized"]
        assert not server.parameters.non_embedding_params
        assert not server.parameters.embedding_params
    finally:
        server.stop()


@pytest.mark.parametrize("entry", ["ps_main", "ps_addrs"])
def test_the_fleet_entry_points_serve(tmp_path, entry):
    """A shard built by ``ps.main``'s flags serves over sockets, and the
    worker's ``--ps_addrs`` client pushes and pulls through two."""
    from elasticdl_tpu_torch.common.args import parse_ps_args
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
    from elasticdl_tpu_torch.worker.main import make_ps_client
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    servers = []
    try:
        for i in range(2 if entry == "ps_addrs" else 1):
            server = ParameterServer(parse_ps_args([
                "--ps_id", str(i), "--port", str(_free_port()),
                "--model_zoo", "", "--model_def", DEEPFM,
                "--device", "cpu"]))
            server.prepare()
            servers.append(server)
        addrs = ["localhost:%d" % s.port for s in servers]
        if entry == "ps_main":
            stub = BoundPS(addrs[0], deadline_s=10)
            status = stub.ps_status({})
            stub.close()
            assert status["initialized"] is False
            assert status["shard_epoch"] == servers[0].shard_epoch
            return
        client = make_ps_client(parse_worker_args([
            "--worker_id", "0", "--job_type", "training_only",
            "--ps_addrs", ",".join(addrs), "--model_zoo", "",
            "--model_def", DEEPFM, "--minibatch_size", "8",
            "--device", "cpu"]))
        model = {"a": np.ones((2, 3), np.float32),
                 "b": np.arange(4, dtype=np.float32)}
        client.push_model(model, [])
        ready, version, named = client.pull_dense()
        client.close()
        assert ready and version == 0
        for k, v in model.items():
            assert np.array_equal(named[k], v)
    finally:
        for server in servers:
            server.stop()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
