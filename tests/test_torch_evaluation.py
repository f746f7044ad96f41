"""The port's evaluation plane against the JAX package's.

- Every metric class: the same seeded labels and predictions through both
  ``metrics`` modules give equal results (``AUC`` within 1e-12), fed as
  numpy, as float32 tensors and, where the metric reads an argmax or a
  comparison, as bfloat16 tensors (the JAX side gets the same
  bf16-rounded values as float32, which is what the port widens them to).
- ``MetricsAccumulator`` single- and multi-output, ``_EvaluationJob``'s
  version pinning and its drop of a wrong-version report, and the
  service's rounds: a round pins a version number (no eval checkpoint is
  written), one round per gap of the step trigger under concurrent task
  reports, ``PeriodicTrigger`` start, fire and stop.
- The dispatcher completes an evaluation task's round outside its lock,
  and seeds an evaluation-only job's round with its task count.
- A TRAINING_WITH_EVALUATION MNIST job through the port's command line
  (``--device cpu``) and through the JAX ``AllReduceWorker``, from one set
  of weights (the JAX init, converted by ``common/convert.py``), with the
  datasets' shuffle and the model's dropout patched to the identity in
  both packages, the dispatchers seeded and SGD at 1e-3 in both (at the
  zoo's 0.01 the logits reach ~50 by step 4 on random labels, and the
  packages' float32 summation-order noise grows to 9e-4 by step 8): both
  publish rounds pinned to versions 4, 8 and 12 with equal summaries,
  and report outputs within rtol 1e-4 / atol 1e-5 (float32; they read
  ~4e-6 apart).
"""

import os
import threading
import time

import functools
import sys

import flax.linen as flax_nn
import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu import metrics as jmetrics
from elasticdl_tpu.common.constants import JobType as JJobType
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.master import evaluation_service as jeval
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
from elasticdl_tpu_torch import cli, metrics as tmetrics
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
from elasticdl_tpu_torch.master import evaluation_service as teval
from elasticdl_tpu_torch.master.checkpoint_service import CheckpointService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.model_zoo.mnist_subclass import (
    mnist_subclass as tmnist,
)
from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
from tests.in_process_master import InProcessMaster
from tests.test_utils import MODEL_ZOO_PATH, DatasetName, create_recordio_file

MNIST = "mnist_subclass.mnist_subclass.CustomModel"

# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

N = 257  # an odd count: no metric result lands on a round share


def _inputs(kind):
    """(labels, predictions) for each metric kind, from one seed."""
    rng = np.random.default_rng(11)
    if kind == "sparse":
        return rng.integers(0, 7, N), rng.standard_normal((N, 7))
    if kind == "onehot":
        return np.eye(7)[rng.integers(0, 7, N)], rng.standard_normal((N, 7))
    if kind == "binary":
        return rng.integers(0, 2, N), rng.random(N)
    if kind == "exact":
        return rng.integers(0, 3, N), rng.integers(0, 3, N)
    return rng.standard_normal(N), rng.standard_normal(N)  # regression


METRICS = [  # (class name, kwargs, input kind, bf16 feed is exact)
    ("Mean", {}, "regression", False),
    ("Sum", {}, "regression", False),
    ("Accuracy", {}, "exact", True),
    ("SparseCategoricalAccuracy", {}, "sparse", True),
    ("CategoricalAccuracy", {}, "onehot", True),
    ("BinaryAccuracy", {"threshold": 0.4}, "binary", True),
    ("MeanSquaredError", {}, "regression", False),
    ("AUC", {"num_thresholds": 50}, "binary", True),
]


def _feed(kind, feed, labels, preds):
    """The port's inputs and the JAX package's (the same values)."""
    if feed == "numpy":
        return (labels, preds), (labels, preds)
    dtype = torch.float32 if feed == "float32" else torch.bfloat16
    lt = torch.from_numpy(np.asarray(labels))
    pt = torch.from_numpy(np.asarray(preds)).to(dtype)
    if kind in ("onehot", "regression"):
        lt = lt.to(dtype)
    seen = tuple(t.float().numpy() if t.is_floating_point() else t.numpy()
                 for t in (lt, pt))
    return (lt, pt), seen


@pytest.mark.parametrize("feed", ["numpy", "float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,kwargs,kind,bf16_ok", METRICS, ids=[m[0] for m in METRICS]
)
def test_metric_matches_jax(name, kwargs, kind, bf16_ok, feed):
    if feed == "bfloat16" and not bf16_ok:
        kind = "binary"  # sums of bf16 values: fed the binary draw
    labels, preds = _inputs(kind)
    t, j = getattr(tmetrics, name)(**kwargs), getattr(jmetrics, name)(
        **kwargs
    )
    (tl, tp), (jl, jp) = _feed(kind, feed, labels, preds)
    for lo, hi in ((0, 100), (100, N)):  # two batches: streaming
        t.update_state(tl[lo:hi], tp[lo:hi])
        j.update_state(jl[lo:hi], jp[lo:hi])
    if name == "AUC":
        assert abs(t.result() - j.result()) <= 1e-12
    else:
        assert t.result() == j.result()
    t.reset_states()
    assert t.result() == 0.0


def test_as_metric_wraps_callables_and_refuses_values():
    fn = lambda labels, p: labels == p.argmax(1)  # noqa: E731
    labels, preds = _inputs("sparse")
    t, j = tmetrics.as_metric("acc", fn), jmetrics.as_metric("acc", fn)
    assert isinstance(t, tmetrics.Mean) and t.name == "acc"
    t.update_state(labels, preds)
    j.update_state(labels, preds)
    assert t.result() == j.result()
    for module in (tmetrics, jmetrics):
        with pytest.raises(TypeError):
            module.as_metric("x", 3)


def test_to_host_widens_bf16_exactly():
    x = torch.randn(5, 9).to(torch.bfloat16)
    host = tmetrics.to_host(x)
    assert host.dtype == np.float32
    assert torch.equal(torch.from_numpy(host).to(torch.bfloat16), x)
    assert np.array_equal(host.argmax(1), x.float().argmax(1).numpy())


# ---------------------------------------------------------------------------
# the accumulator, the round and the service
# ---------------------------------------------------------------------------


def _acc_spec(module):
    return {
        "accuracy": module.SparseCategoricalAccuracy(),
        "hit": lambda labels, p: labels.reshape(-1) == p.argmax(1),
    }


@pytest.mark.parametrize("nested", [False, True], ids=["single", "multi"])
def test_metrics_accumulator_matches_jax(nested):
    labels, preds = _inputs("sparse")
    rng = np.random.default_rng(2)
    other = rng.standard_normal(N)

    def spec(module):
        if not nested:
            return _acc_spec(module)
        return {"output": _acc_spec(module),
                "aux": {"mse": module.MeanSquaredError()}}

    t = teval.MetricsAccumulator(spec(tmetrics))
    j = jeval.MetricsAccumulator(spec(jmetrics))
    outputs = {"output": preds, "aux": other}
    for lo, hi in ((0, 64), (64, N)):
        batch = {k: v[lo:hi] for k, v in outputs.items()}
        t.update({k: torch.from_numpy(v) for k, v in batch.items()},
                 torch.from_numpy(labels[lo:hi]))
        j.update(batch, labels[lo:hi])
    assert t.nested == j.nested == nested
    assert t.summary() == j.summary()
    with pytest.raises(ValueError):
        teval.MetricsAccumulator({})


def test_evaluation_job_pins_its_version():
    def journey(module):
        job = module._EvaluationJob(
            {"accuracy": lambda labels, p: labels.reshape(-1) == p.argmax(1)},
            model_version=3,
            total_tasks=2,
        )
        outputs = {"output": np.eye(4, dtype=np.float32)}
        labels = np.arange(4)
        seen = [job.report_evaluation_metrics(3, outputs, labels,
                                              scored_version=3),
                job.report_evaluation_metrics(2, outputs, labels)]
        job.complete_task()
        seen.append(job.finished())
        job.complete_task()
        seen += [job.finished(), job.get_evaluation_summary(),
                 sorted(job.scored_versions)]
        return seen

    got = journey(teval)
    assert got == journey(jeval)
    assert got == [True, False, False, True, {"accuracy": 1.0}, [3]]


def _service_stack(module, servicer_cls, dispatcher_cls, eval_steps,
                   ckpt_dir="", records=64, **servicer_kw):
    task_d = dispatcher_cls({"t": (0, records)}, {"v": (0, 32)}, {}, 16, 1)
    svc = module.EvaluationService(
        (CheckpointService if module is teval else JCheckpointService)(
            ckpt_dir, 0, 0, True
        ),
        None, task_d, 0, 0, eval_steps, False,
        lambda: {"acc": lambda labels, p: labels == labels},
    )
    task_d.set_evaluation_service(svc)
    servicer = servicer_cls(1, 16, None, task_d, evaluation_service=svc,
                            **servicer_kw)
    return task_d, svc, servicer


def _eval_queue(task_d):
    out = []
    while True:
        task_id, task = task_d.get_eval_task(0)
        if task is None:
            return out
        out.append((task_id, task.shard_name, task.start, task.end,
                    task.model_version))


def test_round_pins_a_version_number_and_writes_no_checkpoint(tmp_path):
    def journey(module, servicer_cls, dispatcher_cls, ckpt_dir, **kw):
        task_d, svc, servicer = _service_stack(
            module, servicer_cls, dispatcher_cls, 4, ckpt_dir=ckpt_dir, **kw
        )
        assert servicer.coordinates_only
        seen = []
        for version in (2, 3, 5, 6, 9):
            task_id, _ = task_d.get(0)
            servicer.report_task_result(task_id, "",
                                        {"model_version": version})
            seen.append(_eval_queue(task_d))
            for task_id, *_ in seen[-1]:
                task_d.report(task_id, True)
        return seen, servicer.get_model_version()

    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    got = journey(teval, MasterServicer, TaskDispatcher, str(t_dir),
                  records=80)
    want = journey(jeval, JServicer, JDispatcher, str(j_dir), records=80,
                   coordinates_only=True)
    assert [[task[1:] for task in q] for q in got[0]] == [
        [task[1:] for task in q] for q in want[0]
    ]
    # rounds at 5 (the first gap of 4 past 0) and 9; 3 and 6 fall short
    pinned = [{task[-1] for task in q} for q in got[0]]
    assert pinned == [set(), set(), {5}, set(), {9}]
    assert got[1] == want[1] == 9
    # a coordinating master pins numbers: nothing is written
    assert not t_dir.exists() or not os.listdir(t_dir)


def test_wrong_version_report_is_dropped():
    task_d, svc, servicer = _service_stack(teval, MasterServicer,
                                           TaskDispatcher, 4)
    task_id, _ = task_d.get(0)
    servicer.report_task_result(task_id, "", {"model_version": 4})
    (eval_id, *_, version), _ = _eval_queue(task_d)
    assert version == 4
    labels = np.arange(4)
    outputs = {"output": np.eye(4)}
    assert servicer.report_evaluation_metrics(3, outputs, labels) == (
        False, 4
    )
    assert servicer.report_evaluation_metrics(4, outputs, labels) == (
        True, 4
    )


def test_gap_trigger_queues_one_round_per_gap_under_concurrent_reports():
    """Concurrent task reports each carry a version; every report that
    passes the unlocked pre-check is checked again under the master lock,
    so the pinned versions are at least one gap apart."""
    steps, top, threads = 4, 96, 8
    task_d, svc, servicer = _service_stack(
        teval, MasterServicer, TaskDispatcher, steps, records=16 * top
    )
    pinned = []
    orig = svc._snapshot_model_locked

    def spy(min_gap=1):
        queued = orig(min_gap)
        if queued:
            pinned.append(svc._last_snapshot_version)
        return queued

    svc._snapshot_model_locked = spy
    ids = [task_d.get(0)[0] for _ in range(top)]
    barrier = threading.Barrier(threads)

    def report(offset):
        barrier.wait()
        for v in range(1 + offset, top + 1, threads):
            servicer.report_task_result(ids[v - 1], "",
                                        {"model_version": v})

    workers = [threading.Thread(target=report, args=(i,))
               for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert pinned and pinned[0] >= steps and pinned[-1] > top - steps
    gaps = np.diff([0] + pinned)
    assert (gaps >= steps).all(), pinned
    # one round per gap: no gap holds two rounds, so at most top/steps
    assert len(pinned) <= top // steps
    assert servicer.get_model_version() == top


def test_periodic_trigger_starts_fires_and_stops():
    fired = []
    trigger = teval.PeriodicTrigger(lambda: fired.append(time.time()),
                                    delay_secs=0.05, interval_secs=0.05,
                                    poll_secs=0.01)
    t0 = time.time()
    trigger.start()
    deadline = time.time() + 10
    while len(fired) < 3 and time.time() < deadline:
        time.sleep(0.01)
    trigger.stop()
    assert not trigger._thread.is_alive()
    assert len(fired) >= 3 and fired[0] - t0 >= 0.05
    assert all(b - a >= 0.05 - 1e-3 for a, b in zip(fired, fired[1:]))
    count = len(fired)
    time.sleep(0.1)
    assert len(fired) == count  # stopped: no more firing


def test_time_trigger_skips_a_finished_job_and_stops_with_the_master():
    task_d = TaskDispatcher({}, {}, {}, 16, 1)  # nothing to do: finished
    svc = teval.EvaluationService(None, None, task_d, 0, 1, 0, False,
                                  lambda: {"a": tmetrics.Mean()})
    servicer = MasterServicer(1, 16, None, task_d, evaluation_service=svc)
    svc.add_evaluation_task(is_time_based_eval=True)
    assert svc._round is None and servicer.get_model_version() == 0
    assert svc.trigger is not None
    svc.start()
    svc.stop()
    assert not svc.trigger._thread.is_alive()


class _LockProbe:
    """An evaluation service whose ``complete_task`` reads the
    dispatcher (taking its lock): it would deadlock under the lock."""

    def __init__(self, task_d):
        self.task_d = task_d
        self.completed = 0
        self.eval_only = None

    def init_eval_only_job(self, n):
        self.eval_only = n

    def complete_task(self):
        self.task_d.queue_depths()
        self.completed += 1


@pytest.mark.parametrize("dispatcher_cls", [TaskDispatcher, JDispatcher],
                         ids=["port", "jax"])
def test_dispatcher_completes_eval_tasks_outside_its_lock(dispatcher_cls):
    task_d = dispatcher_cls({}, {"v": (0, 40)}, {}, 16, 1)
    probe = _LockProbe(task_d)
    task_d.set_evaluation_service(probe)
    assert probe.eval_only == 3  # an evaluation-only job: 3 tasks
    done = threading.Event()

    def drain():
        for task_id, *_ in _eval_queue(task_d):
            task_d.report(task_id, True)
        done.set()

    threading.Thread(target=drain, daemon=True).start()
    assert done.wait(10), "complete_task ran under the dispatcher lock"
    assert probe.completed == 3 and task_d.finished()


# ---------------------------------------------------------------------------
# a TRAINING_WITH_EVALUATION job through both packages
# ---------------------------------------------------------------------------

BATCH, TRAIN_RECORDS, VAL_RECORDS = 16, 192, 64  # 12 steps, 2 eval tasks


def _identity(self, *args, **kwargs):
    return self


LR = 1e-3


def _sgd_at_lr(sgd, learning_rate, *args, **kwargs):
    return sgd(LR, *args, **kwargs)


def _flax_no_dropout(self, x, *args, **kwargs):
    return x


def _torch_no_dropout(x, *args, **kwargs):
    return x


def _capture_reports(cls, monkeypatch):
    """Every report_evaluation_metrics call on ``cls`` instances:
    (version, outputs, labels)."""
    seen = []
    orig = cls.report_evaluation_metrics

    def spy(self, version, outputs, labels, scored_version=None):
        seen.append((version, {k: np.asarray(v) for k, v in outputs.items()},
                     np.asarray(labels)))
        return orig(self, version, outputs, labels,
                    scored_version=scored_version)

    monkeypatch.setattr(cls, "report_evaluation_metrics", spy)
    return seen


@pytest.fixture
def eval_job_data(tmp_path):
    train, val = tmp_path / "train", tmp_path / "val"
    train.mkdir()
    val.mkdir()
    create_recordio_file(TRAIN_RECORDS, DatasetName.IMAGE_DEFAULT, (28, 28),
                         temp_dir=str(train), seed=1)
    create_recordio_file(VAL_RECORDS, DatasetName.IMAGE_DEFAULT, (28, 28),
                         temp_dir=str(val), seed=2)
    return str(train), str(val)


def _jax_eval_job(train, val):
    from elasticdl_tpu.common.model_utils import (
        get_module_file_path,
        load_module,
    )
    from elasticdl_tpu.data.data_reader import create_data_reader

    def shards(d):
        return create_data_reader(d, records_per_task=2 * BATCH).create_shards()

    task_d = JDispatcher(shards(train), shards(val), {}, 2 * BATCH, 1)
    zoo = load_module(get_module_file_path(MODEL_ZOO_PATH, MNIST))
    svc = jeval.EvaluationService(
        JCheckpointService("", 0, 0, False), None, task_d, 0, 0, 4, False,
        zoo.eval_metrics_fn,
    )
    task_d.set_evaluation_service(svc)
    servicer = JServicer(1, BATCH, None, task_d,
                         checkpoint_service=JCheckpointService("", 0, 0,
                                                               False),
                         evaluation_service=svc, coordinates_only=True)
    published = []
    orig = svc._publish_summary

    def capture(round_):
        published.append((round_.model_version,
                          round_.get_evaluation_summary()))
        return orig(round_)

    svc._publish_summary = capture
    worker = JWorker(
        worker_id=0, job_type=JJobType.TRAINING_WITH_EVALUATION,
        minibatch_size=BATCH, model_zoo=MODEL_ZOO_PATH, model_def=MNIST,
        stub=InProcessMaster(servicer), devices=jax.devices()[:1],
    )
    worker.trainer.init_from_batch((
        {"image": np.zeros((BATCH, 28, 28), np.float32)},
        np.zeros((BATCH, 1), np.int32),
    ))
    init = worker.trainer.get_host_state()
    worker.run()
    assert task_d.finished()
    return init, published, int(worker.trainer.get_host_state().version)


def test_training_with_evaluation_matches_jax(monkeypatch, eval_job_data,
                                              tmp_path):
    train, val = eval_job_data
    # SGD at the zoo's 0.01 overshoots on random labels (logits ~50 by
    # step 4), which amplifies the packages' float32 summation-order
    # noise step by step: both packages train at LR instead
    monkeypatch.setattr(optax, "sgd", functools.partial(_sgd_at_lr,
                                                        optax.sgd))
    monkeypatch.setattr(tmnist, "optimizer",
                        functools.partial(tmnist.optimizer, lr=LR))
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "5")
    monkeypatch.setattr(JDataset, "shuffle", _identity)
    monkeypatch.setattr(TDataset, "shuffle", _identity)
    monkeypatch.setattr(flax_nn.Dropout, "__call__", _flax_no_dropout)
    monkeypatch.setattr(torch.nn.functional, "dropout", _torch_no_dropout)
    j_reports = _capture_reports(JServicer, monkeypatch)
    t_reports = _capture_reports(MasterServicer, monkeypatch)

    init, j_published, j_version = _jax_eval_job(train, val)
    converted = convert.to_train_state(
        pytree_to_named_arrays(init.params), tmnist.optimizer(),
        device="cpu",
    )
    # the port's trainer starts from the same weights
    monkeypatch.setattr(AllReduceTrainer, "init_from_batch",
                        lambda self, batch: self.load_state(converted))
    jobs = []
    rc = cli.main([
        "train", "--job_name", "j", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "0", "--model_zoo", "",
        "--model_def", MNIST, "--training_data", train,
        "--validation_data", val, "--evaluation_steps", "4",
        "--minibatch_size", str(BATCH), "--num_minibatches_per_task", "2",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_steps",
        "4", "--device", "cpu",
    ], jobs=jobs)
    job = jobs[0]
    assert rc == 0 and job.master.task_d.finished()
    assert job.worker.trainer.version == j_version == 12
    published = job.master.evaluation_service.published
    assert [p["version"] for p in published] == [4, 8, 12]
    assert [(p["version"], p["metrics"]) for p in published] == j_published
    # two tasks per round, each scored at the round's version
    assert [r[0] for r in t_reports] == [r[0] for r in j_reports] == [
        4, 4, 8, 8, 12, 12
    ]
    for (_, t_out, t_lab), (_, j_out, j_lab) in zip(t_reports, j_reports):
        assert np.array_equal(t_lab, j_lab)
        np.testing.assert_allclose(t_out["output"], j_out["output"],
                                   rtol=1e-4, atol=1e-5)
    assert job.master.evaluation_service.trigger is None
