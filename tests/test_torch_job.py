"""The port's single-process ALLREDUCE job against the JAX package's.

- The task dispatcher, the data reader and the task data service take the
  same inputs in both packages and must give the same task lists under one
  seed, the same requeue after a failure report and after
  ``recover_tasks``, the same deferred SAVE_MODEL task, the same shards of
  a RecordIO directory and the same record accounting per task, a failed
  step included.
- Job journeys on ``mnist_subclass``, mirroring
  ``tests/test_allreduce_worker.py``: the job completes at version 16, an
  accumulation tail pads, evaluation- and prediction-only jobs are
  refused by ``AllReduceWorker`` (the elastic worker's drain serves them,
  tests/test_torch_eval_only.py), a second job resumes from the sharded checkpoint, a failing
  step requeues its task, and the command line finishes a job (exit code
  0) and continues its version on a second run.
- Job-level parity: float32 ResNet-50 on 32x32 records, one epoch of
  three tasks of one batch of 8, through the JAX ``AllReduceWorker`` and
  the port's, from one set of weights (the JAX trainer's init,
  converted), with the datasets' shuffle patched to the identity and
  both dispatchers seeded. Per-step losses rtol 1e-4 (they read 1.1e-6);
  each final parameter tensor within 1e-5 plus 1e-3 of its largest
  magnitude (the largest difference reads 8.7e-8); the same version, and
  the same task reports in the same order. The batch is 8 because a
  training step's BatchNorm over the last stage's n values per channel
  amplifies the packages' float32 summation-order noise as n falls: at
  batch 4 the losses part by 4.7e-3 within six steps
  (tests/test_torch_resnet.py has the mechanism).
"""

import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.constants import JobType as JJobType
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.data import data_reader as jreader
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.master.checkpoint_service import (
    CheckpointService as JCheckpointService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JDispatcher,
)
from elasticdl_tpu.worker.allreduce_worker import (
    AllReduceWorker as JWorker,
)
from elasticdl_tpu.worker.task_data_service import (
    TaskDataService as JTaskDataService,
)
from elasticdl_tpu_torch import api
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.constants import JobType, TaskType
from elasticdl_tpu_torch.common.sharded_checkpoint import (
    ShardedCheckpointManager,
    load_sharded_to_host,
)
from elasticdl_tpu_torch.data import data_reader as treader
from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
from tests.in_process_master import InProcessMaster
from tests.test_utils import MODEL_ZOO_PATH, DatasetName, create_recordio_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
MNIST = "mnist_subclass.mnist_subclass.CustomModel"
RESNET = "imagenet_resnet50.imagenet_resnet50.custom_model"


def _task_info(task):
    return (task.shard_name, task.start, task.end, int(task.type))


def _drain(dispatcher, worker_id=0):
    out = []
    while True:
        task_id, task = dispatcher.get(worker_id)
        if task is None:
            return out
        out.append((task_id, _task_info(task)))
        dispatcher.report(task_id, True)


SHARDS = {"a": (0, 100), "b": (5, 37)}


@pytest.fixture
def seeded(monkeypatch):
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "7")


@pytest.mark.parametrize("epochs", [1, 3])
def test_dispatcher_task_lists_match_under_one_seed(seeded, epochs):
    j = JDispatcher(SHARDS, {}, {}, 16, epochs)
    t = TaskDispatcher(SHARDS, {}, {}, 16, epochs)
    assert t.count_tasks(TaskType.TRAINING) == j.count_tasks(0)
    assert _drain(t) == _drain(j)
    assert t.finished() and j.finished()


def test_unseeded_dispatcher_follows_the_global_random(monkeypatch):
    monkeypatch.delenv("EDL_TASK_SHUFFLE_SEED", raising=False)
    random.seed(3)
    j = _drain(JDispatcher(SHARDS, {}, {}, 16, 2))
    random.seed(3)
    assert _drain(TaskDispatcher(SHARDS, {}, {}, 16, 2)) == j


def _failure_journey(dispatcher):
    out = []
    first_id, first = dispatcher.get(0)
    second_id, second = dispatcher.get(1)
    dispatcher.report(first_id, False)  # requeued
    out.append(_task_info(dispatcher.get(2)[1]))  # the failed task again
    dispatcher.recover_tasks(1)  # worker 1 died: its task requeues
    out.append(_task_info(dispatcher.get(3)[1]))
    out.append(dispatcher.queue_depths())
    out.extend(info for _, info in _drain(dispatcher, 4))
    return out


def test_dispatcher_requeue_and_recover_match(seeded):
    assert _failure_journey(TaskDispatcher(SHARDS, {}, {}, 16, 1)) == (
        _failure_journey(JDispatcher(SHARDS, {}, {}, 16, 1))
    )


def _save_model_journey(dispatcher):
    dispatcher.add_deferred_callback_create_save_model_task("/out")
    done = _drain(dispatcher)
    assert dispatcher.finished()
    assert dispatcher.invoke_deferred_callback()
    task_id, task = dispatcher.get(0)
    info = (_task_info(task), task.extended_config["saved_model_path"])
    assert not dispatcher.invoke_deferred_callback()
    dispatcher.report(task_id, True)
    return [i for _, i in done], info, dispatcher.finished()


def test_deferred_save_model_task_matches(seeded):
    got = _save_model_journey(TaskDispatcher(SHARDS, {}, {}, 16, 1))
    assert got == _save_model_journey(JDispatcher(SHARDS, {}, {}, 16, 1))
    assert got[1][0][3] == int(TaskType.SAVE_MODEL)


def test_servicer_waits_then_hands_out_save_model(seeded):
    def journey(servicer):
        seen = []
        while True:
            res = servicer.get_task(0)
            seen.append((res.shard_name, res.start, res.end, res.type))
            if not res.shard_name and res.type != TaskType.WAIT:
                return seen
            if res.shard_name:
                servicer.report_task_result(
                    res.task_id, "", {"model_version": len(seen)}
                )

    def make(disp, servicer_cls, **kw):
        d = disp({"s": (0, 40)}, {}, {}, 16, 1)
        d.add_deferred_callback_create_save_model_task("/out")
        return servicer_cls(1, 8, None, d, **kw)

    t = make(TaskDispatcher, MasterServicer)
    j = make(JDispatcher, JServicer, coordinates_only=True)
    assert journey(t) == journey(j)
    assert t.get_model_version() == j.get_model_version() > 0


@pytest.fixture
def record_dir(tmp_path):
    d = tmp_path / "records"
    d.mkdir()
    for i, n in enumerate((30, 17)):
        path = create_recordio_file(
            n, DatasetName.IMAGE_DEFAULT, (28, 28), temp_dir=str(d), seed=i
        )
        os.rename(path, str(d / ("shard-%d" % i)))
    return str(d)


def test_recordio_shards_and_records_match(record_dir):
    j = jreader.create_data_reader(record_dir)
    t = treader.create_data_reader(record_dir)
    shards = t.create_shards()
    assert shards == j.create_shards()
    for name, (start, count) in shards.items():
        task = type("T", (), {"shard_name": name, "start": 3, "end": count})
        assert [bytes(r) for r in t.read_records(task)] == [
            bytes(r) for r in j.read_records(task)
        ]
    t.close()


def test_checkpoint_service_ring_matches(tmp_path):
    from elasticdl_tpu_torch.master.checkpoint_service import (
        CheckpointService,
    )

    def ring(cls, root):
        svc = cls(str(root), 2, 2, False)
        for v in (2, 4, 6):
            svc.save(v, {"w": np.full((2, 3), v, np.float32)}, False)
        return (sorted(os.listdir(root)), svc.get_latest_checkpoint_version(),
                svc.get_checkpoint_model(6)[1]["w"].tolist())

    assert ring(CheckpointService, tmp_path / "t") == ring(
        JCheckpointService, tmp_path / "j"
    )


def test_odps_reader_is_not_ported(monkeypatch):
    for k in ("ODPS_PROJECT_NAME", "ODPS_ACCESS_ID", "ODPS_ACCESS_KEY"):
        monkeypatch.setenv(k, "x")
    with pytest.raises(NotImplementedError, match="ODPS"):
        treader.create_data_reader("table")


class _Recorder:
    """A worker for the task data service: tasks from a servicer, every
    report recorded (task id, error, fail count)."""

    def __init__(self, servicer):
        self.servicer = servicer
        self.reports = []

    def get_task(self, task_type=None):
        return self.servicer.get_task(0, task_type)

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        self.reports.append(
            (task_id, bool(err_msg),
             (exec_counters or {}).get("fail_count", 0))
        )
        self.servicer.report_task_result(task_id, err_msg, exec_counters)


def _accounting(record_dir, dispatcher_cls, servicer_cls, service_cls,
                fail_at, service_kw, **servicer_kw):
    """Consume every record in batches of 8, the batch ``fail_at`` failing
    (charged the rest of the head task, as the worker does) -> reports."""
    shards = treader.create_data_reader(record_dir).create_shards()
    d = dispatcher_cls(shards, {}, {}, 12, 1)
    worker = _Recorder(servicer_cls(1, 8, None, d, **servicer_kw))
    service = service_cls(
        worker, False, {"data_origin": record_dir}, **service_kw
    )
    n = 0
    while True:
        dataset = service.get_dataset()
        if dataset is None:
            break
        batch = []
        for record in dataset:
            batch.append(record)
            if len(batch) == 8:
                n += 1
                if n == fail_at:
                    count = service.remaining_records_in_head_task()
                    service.report_record_done(count, "step failed")
                else:
                    service.report_record_done(len(batch))
                batch = []
        if batch:
            service.report_record_done(len(batch))
    service.drain_acks()
    return worker.reports, d.finished()


@pytest.mark.parametrize(
    "service_kw",
    [{}, {"task_prefetch": 2}, {"ack_queue_size": 3},
     {"task_prefetch": 2, "ack_queue_size": 3}],
    ids=["serial", "prefetch", "ack_queue", "prefetch_ack_queue"],
)
def test_task_data_service_accounting_matches(seeded, record_dir,
                                              service_kw):
    t = _accounting(record_dir, TaskDispatcher, MasterServicer,
                    TaskDataService, 2, service_kw)
    j = _accounting(record_dir, JDispatcher, JServicer, JTaskDataService,
                    2, service_kw, coordinates_only=True)
    assert t == j
    reports, finished = t
    assert finished
    assert any(err for _, err, _ in reports)  # the failed task requeued


# ---------------------------------------------------------------------------
# job journeys (mnist_subclass on the CPU)
# ---------------------------------------------------------------------------


def _mnist_job(records=128, epochs=2, **worker_kw):
    f = create_recordio_file(records, DatasetName.IMAGE_DEFAULT, (28, 28))
    task_d = TaskDispatcher({f: (0, records)}, {}, {}, 64, epochs)
    master = MasterServicer(1, 16, None, task_d)
    worker = AllReduceWorker(
        worker_id=0,
        job_type=JobType.TRAINING_ONLY,
        minibatch_size=16,
        model_zoo=PORT_ZOO,
        model_def=MNIST,
        stub=master,
        device="cpu",
        **worker_kw,
    )
    return task_d, master, worker


def test_job_completes():
    task_d, master, worker = _mnist_job()
    losses = worker.run()
    assert task_d.finished()
    # 128 records x 2 epochs / batch 16
    assert worker.trainer.version == 16
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert master.get_model_version() == 16
    stats = worker.input_stats.snapshot()
    assert stats["tasks"] == 4 and stats["records"] == 256


def test_job_accum_pads_tail_batches():
    task_d, _, worker = _mnist_job(records=120, epochs=1, accum_steps=4)
    losses = worker.run()
    assert task_d.finished()
    # 120 records / batch 16 = 8 batches, one an 8-row tail
    assert worker.trainer.version == 8
    assert all(np.isfinite(losses))


@pytest.mark.parametrize(
    "job_type", [JobType.EVALUATION_ONLY, JobType.PREDICTION_ONLY]
)
def test_job_refuses_eval_and_predict_only(job_type):
    with pytest.raises(NotImplementedError, match="ParameterServer"):
        AllReduceWorker(
            worker_id=0, job_type=job_type, minibatch_size=16,
            model_zoo=PORT_ZOO, model_def=MNIST, stub=None, device="cpu",
        )


def test_job_resumes_from_sharded_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")

    def run_job():
        task_d, _, worker = _mnist_job(
            epochs=1, checkpoint_dir=ckpt_dir, checkpoint_steps=4
        )
        worker.run()
        assert task_d.finished()
        return worker.trainer

    t1 = run_job()
    assert t1.version == 8
    after_1 = ShardedCheckpointManager(ckpt_dir).versions()
    assert after_1 == [4, 8]
    t2 = run_job()
    assert t2.version == 16  # job 2 continued job 1's counter
    assert max(ShardedCheckpointManager(ckpt_dir).versions()) == 16
    # the newest checkpoint is the final state, bitwise
    version, leaves = load_sharded_to_host(os.path.join(ckpt_dir, "ckpt_v16"))
    assert version == 16
    for name, p in t2.train_state.params.items():
        assert torch.equal(leaves["params/" + name], p.detach())


def test_torn_newest_checkpoint_falls_back_to_older(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    _, _, w1 = _mnist_job(epochs=1, checkpoint_dir=ckpt_dir,
                          checkpoint_steps=4)
    w1.run()
    # tear v8: drop one shard file, keep its manifest
    newest = os.path.join(ckpt_dir, "ckpt_v8")
    victim = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    os.remove(os.path.join(newest, victim))
    _, _, w2 = _mnist_job(epochs=1, checkpoint_dir=ckpt_dir,
                          checkpoint_steps=4)
    w2.run()
    assert w2.trainer.version == 4 + 8  # resumed from v4


def test_failing_step_requeues_its_task():
    task_d, master, worker = _mnist_job(epochs=1)
    failed = []
    original = worker.trainer.train_step

    def fail_once(features, labels):
        if not failed:
            failed.append(True)
            raise RuntimeError("injected step failure")
        return original(features, labels)

    worker.trainer.train_step = fail_once
    reports = []
    report = master.report_task_result

    def spy(task_id, err="", counters=None):
        reports.append((task_id, err))
        return report(task_id, err, counters)

    master.report_task_result = spy
    losses = worker.run()
    assert task_d.finished()
    assert [err for _, err in reports if err] == ["injected step failure"]
    # the failed task ran again: more successful steps than one epoch's 8
    assert worker.trainer.version == len(losses) > 8


def _cli(tmp_path, data, *extra):
    cmd = [
        sys.executable, "-m", "elasticdl_tpu_torch.cli", "train",
        "--job_name", "cli", "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0", "--model_zoo", PORT_ZOO, "--model_def", MNIST,
        "--training_data", data, "--minibatch_size", "16",
        "--num_minibatches_per_task", "2", "--num_epochs", "1",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_steps", "4",
        "--output", str(tmp_path / "out"), "--device", "cpu",
    ] + list(extra)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(cmd, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=240)


def test_cli_runs_a_job_and_continues_it(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    f = create_recordio_file(64, DatasetName.IMAGE_DEFAULT, (28, 28),
                             temp_dir=str(data))
    for run, want in ((1, 4), (2, 8)):
        proc = _cli(tmp_path, str(data))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert max(ShardedCheckpointManager(
            str(tmp_path / "ckpt")).versions()) == want, run
    exports = os.listdir(tmp_path / "out")
    assert exports and os.path.exists(
        tmp_path / "out" / exports[0] / "MANIFEST.json"
    )
    assert os.path.exists(f)


@pytest.mark.parametrize(
    "flag",
    [
        ["--num_workers", "2"],
        ["--master_journal_dir", "j"],
        ["--telemetry_port", "0"],
        ["--distribution_strategy", "ParameterServerStrategy"],
        ["--docker_image_repository", "r"],
        ["--tensorboard_log_dir", "tb"],
    ],
)
def test_cli_refuses_unported_planes(tmp_path, flag):
    argv = [
        "train", "--job_name", "j", "--distribution_strategy",
        "AllreduceStrategy", "--model_zoo", PORT_ZOO, "--model_def", MNIST,
        "--training_data", str(tmp_path), "--minibatch_size", "16",
        "--device", "cpu",
    ] + flag
    with pytest.raises(NotImplementedError):
        api.cli_main(argv)


# ---------------------------------------------------------------------------
# job-level parity: ResNet-50 through both workers
# ---------------------------------------------------------------------------

PARITY_RECORDS, PARITY_BATCH = 24, 8


def _identity_shuffle(self, *args, **kwargs):
    return self


def _spy_reports(stub):
    """Record (failed, fail count) of every task report through ``stub``."""
    reports, report = [], stub.report_task_result

    def spy(task_id, err_msg="", exec_counters=None):
        reports.append(
            (bool(err_msg), (exec_counters or {}).get("fail_count", 0))
        )
        return report(task_id, err_msg, exec_counters)

    stub.report_task_result = spy
    return reports


def test_resnet_job_matches_jax_job(monkeypatch, tmp_path):
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as tzoo,
    )

    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "11")
    monkeypatch.setattr(JDataset, "shuffle", _identity_shuffle)
    monkeypatch.setattr(TDataset, "shuffle", _identity_shuffle)
    f = create_recordio_file(
        PARITY_RECORDS, DatasetName.IMAGENET, (32, 32, 3),
        temp_dir=str(tmp_path), seed=5,
    )
    shards = {f: (0, PARITY_RECORDS)}
    params = "num_classes=10,dtype='float32'"

    j_task_d = JDispatcher(shards, {}, {}, PARITY_BATCH, 1)
    j_stub = InProcessMaster(JServicer(
        1, PARITY_BATCH, None, j_task_d,
        checkpoint_service=JCheckpointService("", 0, 0, False),
        use_async=True,
    ))
    j_reports = _spy_reports(j_stub)
    jw = JWorker(
        worker_id=0, job_type=JJobType.TRAINING_ONLY,
        minibatch_size=PARITY_BATCH, model_zoo=MODEL_ZOO_PATH,
        model_def=RESNET, model_params=params, stub=j_stub,
        devices=jax.devices()[:1],
    )
    jw.trainer.init_from_batch((
        {"image": np.zeros((PARITY_BATCH, 32, 32, 3), np.uint8)},
        np.zeros((PARITY_BATCH, 1), np.int32),
    ))
    init = jw.trainer.get_host_state()
    j_losses = jw.run()
    j_final = jw.trainer.get_host_state()

    t_task_d = TaskDispatcher(shards, {}, {}, PARITY_BATCH, 1)
    t_master = MasterServicer(1, PARITY_BATCH, None, t_task_d)
    t_reports = _spy_reports(t_master)
    tw = AllReduceWorker(
        worker_id=0, job_type=JobType.TRAINING_ONLY,
        minibatch_size=PARITY_BATCH, model_zoo=PORT_ZOO, model_def=RESNET,
        model_params=params, stub=t_master, device="cpu",
    )
    tw.trainer.load_state(convert.to_train_state(
        pytree_to_named_arrays(init.params), tzoo.optimizer(),
        device="cpu", batch_stats=pytree_to_named_arrays(init.state),
    ))
    t_losses = tw.run()

    assert j_task_d.finished() and t_task_d.finished()
    steps = PARITY_RECORDS // PARITY_BATCH
    assert int(j_final.version) == tw.trainer.version == steps
    assert t_master.get_model_version() == steps
    assert t_reports == j_reports and len(t_reports) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    got = convert.from_train_state(tw.trainer.train_state)["params"]
    want = pytree_to_named_arrays(j_final.params)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        w = np.asarray(value, np.float64)
        err = np.abs(got[name].double().numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-5, (name, err)
