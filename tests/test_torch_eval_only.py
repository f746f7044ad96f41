"""The port's evaluation-only and prediction-only jobs against the JAX
package's.

The port runs them through its command line (``evaluate`` / ``predict``,
``--device cpu``): ``LocalJob`` routes them to the ported
``ElasticAllReduceWorker`` drain. The JAX package runs them through its
``Master`` and its ``ElasticAllReduceWorker``. Both score one set of
weights (the JAX init of ``mnist_subclass``, or of ResNet-50 at 32x32
and 10 classes in float32):

- from a sharded checkpoint, each package's own (``ckpt_v7``, the same
  weights written by each package's ``save_sharded``; the two layouts do
  not cross), and past a torn newest directory;
- from a ``model.chkpt`` file and from an export directory that the JAX
  package wrote (artifacts cross between the packages); ResNet-50 scores
  the export with fresh BatchNorm statistics and BatchNorm in eval mode,
  as the JAX drain does.

The published metrics must be equal, the reported outputs within rtol
1e-4 / atol 1e-5 (float32), and a capturing processor must see every
prediction record once, its outputs within the same tolerance of the JAX
drain's. Without a model source the master raises ``ValueError`` and the
command line exits 2, as the JAX package's does (``--checkpoint_dir``
counts only under AllreduceStrategy); an empty ``--checkpoint_dir`` makes
the drain give up with an error.
"""

import os
import threading

import jax
import numpy as np
import pytest

from elasticdl_tpu import api as japi
from elasticdl_tpu.common.args import parse_master_args as jparse
from elasticdl_tpu.common.constants import JobType as JJobType
from elasticdl_tpu.common.model_utils import (
    get_model_spec as jget_model_spec,
    save_checkpoint_to_file as jsave_chkpt,
)
from elasticdl_tpu.common.sharded_checkpoint import (
    save_sharded as jsave_sharded,
)
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.master.master import Master as JMaster
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.nn.model_api import init_variables as jinit
from elasticdl_tpu.nn.model_api import split_variables as jsplit
from elasticdl_tpu.worker.elastic_allreduce_worker import (
    ElasticAllReduceWorker as JElasticWorker,
)
from elasticdl_tpu_torch import cli
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.sharded_checkpoint import (
    save_sharded,
    train_state_leaves,
)
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.model_zoo.mnist_subclass import (
    mnist_subclass as tmnist,
)
from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
    ElasticAllReduceWorker,
)
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)
from tests.test_utils import MODEL_ZOO_PATH, DatasetName, create_recordio_file

MNIST = "mnist_subclass.mnist_subclass.CustomModel"
RESNET = "imagenet_resnet50.imagenet_resnet50.custom_model"
RESNET_PARAMS = "num_classes=10,dtype='float32'"
BATCH = 16
RTOL, ATOL = 1e-4, 1e-5


def _jax_weights(model_def, model_params, features):
    spec = jget_model_spec(
        model_zoo=MODEL_ZOO_PATH, model_def=model_def,
        model_params=model_params, dataset_fn="dataset_fn", loss="loss",
        optimizer="optimizer", eval_metrics_fn="eval_metrics_fn",
    )
    return jsplit(jinit(spec.model, jax.random.PRNGKey(3), features))


def _mnist_weights():
    return _jax_weights(MNIST, "", {"image": np.zeros((1, 28, 28),
                                                      np.float32)})


def _records(tmp_path, name, n, dataset=DatasetName.IMAGE_DEFAULT,
             shape=(28, 28)):
    d = tmp_path / name
    d.mkdir()
    create_recordio_file(n, dataset, shape, temp_dir=str(d), seed=4)
    return str(d)


def _jargv(data_flag, data, model_def=MNIST, model_params="", extra=()):
    return [
        "--job_name", "j", "--model_zoo", MODEL_ZOO_PATH,
        "--model_def", model_def, "--model_params", model_params,
        "--minibatch_size", str(BATCH), "--num_minibatches_per_task", "2",
        "--num_epochs", "1", "--training_data", "", data_flag, data,
        "--num_workers", "1", "--num_ps_pods", "0", "--port", "0",
        "--distribution_strategy", "AllreduceStrategy",
    ] + list(extra)


def _targv(data_flag, data, model_def=MNIST, model_params="", extra=()):
    return [
        "--job_name", "j", "--model_zoo", "", "--model_def", model_def,
        "--model_params", model_params, "--minibatch_size", str(BATCH),
        "--num_minibatches_per_task", "2", "--num_epochs", "1", data_flag,
        data, "--distribution_strategy", "AllreduceStrategy",
        "--device", "cpu",
    ] + list(extra)


class _Capture(BasePredictionOutputsProcessor):
    def __init__(self):
        self.chunks = []

    def process(self, predictions, worker_id):
        self.chunks.append((worker_id, np.asarray(predictions)))


def _spy_outputs(cls, monkeypatch):
    seen = []
    orig = cls.report_evaluation_metrics

    def spy(self, version, outputs, labels, scored_version=None):
        seen.append((np.asarray(outputs["output"]), np.asarray(labels),
                     scored_version))
        return orig(self, version, outputs, labels,
                    scored_version=scored_version)

    monkeypatch.setattr(cls, "report_evaluation_metrics", spy)
    return seen


def _run_jax(job_type, argv, worker_kw, processor=None):
    """The JAX package's scoring job: its Master and its elastic worker's
    drain in this process; returns the published summaries."""
    master = JMaster(jparse(argv))
    assert master.job_type == job_type
    published = []
    if master.evaluation_service is not None:
        orig = master.evaluation_service._publish_summary

        def capture(round_):
            published.append(round_.get_evaluation_summary())
            return orig(round_)

        master.evaluation_service._publish_summary = capture
    worker = JElasticWorker(
        worker_id=0, job_type=job_type, minibatch_size=BATCH,
        model_zoo=MODEL_ZOO_PATH, model_def=master.args.model_def,
        model_params=master.args.model_params,
        stub=master.master_servicer, **worker_kw,
    )
    if processor is not None:
        worker._prediction_outputs_processor = processor
    runner = threading.Thread(target=master.run, kwargs={"poll_secs": 0.2},
                              daemon=True)
    runner.start()
    worker.run()
    runner.join(timeout=60)
    assert not runner.is_alive() and master.task_d.finished()
    return published


def _run_port(verb, argv):
    jobs = []
    assert cli.main([verb] + argv, jobs=jobs) == 0
    job = jobs[0]
    assert job.master.task_d.finished()
    return job


def _assert_same_outputs(got, want):
    assert len(got) == len(want) > 0
    for (t_out, t_lab, _), (j_out, j_lab, _) in zip(got, want):
        assert np.array_equal(t_lab, j_lab)
        np.testing.assert_allclose(t_out, j_out, rtol=RTOL, atol=ATOL)


def _port_sharded(directory, params, version):
    """The JAX MNIST weights as the port's sharded checkpoint
    ``directory`` (the model has no BatchNorm statistics)."""
    ts = convert.to_train_state(
        pytree_to_named_arrays(params), tmnist.optimizer(), version=version,
        device="cpu",
    )
    save_sharded(directory, train_state_leaves(ts), version)


# ---------------------------------------------------------------------------
# evaluation-only
# ---------------------------------------------------------------------------


def test_eval_only_from_sharded_checkpoints_matches_jax(monkeypatch,
                                                        tmp_path):
    val = _records(tmp_path, "val", 64)
    params, state = _mnist_weights()
    t_ckpt, j_ckpt = tmp_path / "t_ckpt", tmp_path / "j_ckpt"
    _port_sharded(str(t_ckpt / "ckpt_v7"), params, 7)
    jsave_sharded(str(j_ckpt / "ckpt_v7"), {"params": params,
                                            "state": state}, version=7)
    j_out = _spy_outputs(JServicer, monkeypatch)
    t_out = _spy_outputs(MasterServicer, monkeypatch)
    want = _run_jax(
        JJobType.EVALUATION_ONLY,
        _jargv("--validation_data", val,
               extra=("--checkpoint_dir", str(j_ckpt))),
        {"checkpoint_dir": str(j_ckpt)},
    )
    job = _run_port("evaluate", _targv(
        "--validation_data", val, extra=("--checkpoint_dir", str(t_ckpt))
    ))
    published = job.master.evaluation_service.published
    assert [p["metrics"] for p in published] == want and len(want) == 1
    assert published[0]["scored_versions"] == [7]
    assert {s for *_, s in t_out} == {s for *_, s in j_out} == {7}
    _assert_same_outputs(t_out, j_out)
    assert isinstance(job.worker, ElasticAllReduceWorker)


def test_eval_only_falls_through_a_torn_newest_checkpoint(tmp_path):
    val = _records(tmp_path, "val", 32)
    params, _ = _mnist_weights()
    ckpt = tmp_path / "ckpt"
    _port_sharded(str(ckpt / "ckpt_v4"), params, 4)
    _port_sharded(str(ckpt / "ckpt_v8"), params, 8)
    newest = ckpt / "ckpt_v8"
    os.remove(newest / sorted(f for f in os.listdir(newest)
                              if f.endswith(".npy"))[0])
    job = _run_port("evaluate", _targv(
        "--validation_data", val, extra=("--checkpoint_dir", str(ckpt))
    ))
    assert job.master.evaluation_service.published[0][
        "scored_versions"] == [4]


@pytest.mark.parametrize("artifact", ["chkpt_file", "export_dir"])
def test_eval_only_from_a_jax_artifact_matches_jax(monkeypatch, tmp_path,
                                                   artifact):
    val = _records(tmp_path, "val", 64)
    params, _ = _mnist_weights()
    if artifact == "chkpt_file":
        path = str(tmp_path / "model.chkpt")
        jsave_chkpt(pytree_to_named_arrays(params), 11, path)
    else:
        from elasticdl_tpu.common.export import export_model

        path = str(tmp_path / "export")
        export_model(path, params, 11)
    j_out = _spy_outputs(JServicer, monkeypatch)
    t_out = _spy_outputs(MasterServicer, monkeypatch)
    flag = ("--checkpoint_filename_for_init", path)
    want = _run_jax(JJobType.EVALUATION_ONLY,
                    _jargv("--validation_data", val, extra=flag),
                    {"checkpoint_filename_for_init": path})
    job = _run_port("evaluate", _targv("--validation_data", val, extra=flag))
    published = job.master.evaluation_service.published
    assert [p["metrics"] for p in published] == want
    assert published[0]["scored_versions"] == [11]
    _assert_same_outputs(t_out, j_out)


def test_resnet_eval_only_from_a_jax_export_matches_jax(monkeypatch,
                                                        tmp_path):
    """Fresh BatchNorm statistics (an export carries none) and BatchNorm
    in eval mode, in both packages."""
    from elasticdl_tpu.common.export import export_model

    val = _records(tmp_path, "val", 32, DatasetName.IMAGENET, (32, 32, 3))
    params, state = _jax_weights(
        RESNET, RESNET_PARAMS,
        {"image": np.zeros((1, 32, 32, 3), np.uint8)},
    )
    assert state["batch_stats"]  # the export below drops them
    path = str(tmp_path / "export")
    export_model(path, params, 3)
    j_out = _spy_outputs(JServicer, monkeypatch)
    t_out = _spy_outputs(MasterServicer, monkeypatch)
    flag = ("--checkpoint_filename_for_init", path)
    want = _run_jax(
        JJobType.EVALUATION_ONLY,
        _jargv("--validation_data", val, RESNET, RESNET_PARAMS, flag),
        {"checkpoint_filename_for_init": path},
    )
    job = _run_port("evaluate", _targv("--validation_data", val, RESNET,
                                       RESNET_PARAMS, flag))
    assert [p["metrics"] for p in job.master.evaluation_service.published] \
        == want
    _assert_same_outputs(t_out, j_out)
    # the port scored fresh statistics: zero means, unit variances
    _, state = job.worker._eval_params
    assert all(float(b.abs().sum()) == 0 for n, b in state.items()
               if n.endswith("running_mean"))
    assert not job.worker._model.training  # BatchNorm in eval mode


# ---------------------------------------------------------------------------
# prediction-only
# ---------------------------------------------------------------------------


def test_predict_only_delivers_every_record_once_and_matches_jax(
    monkeypatch, tmp_path
):
    records = 72  # a ragged last batch
    pred = _records(tmp_path, "pred", records)
    params, _ = _mnist_weights()
    path = str(tmp_path / "model.chkpt")
    jsave_chkpt(pytree_to_named_arrays(params), 5, path)
    flag = ("--checkpoint_filename_for_init", path)
    j_capture = _Capture()
    _run_jax(JJobType.PREDICTION_ONLY,
             _jargv("--prediction_data", pred, extra=flag),
             {"checkpoint_filename_for_init": path}, processor=j_capture)
    t_capture = _Capture()
    monkeypatch.setattr(tmnist, "PredictionOutputsProcessor", t_capture,
                        raising=False)
    job = _run_port("predict", _targv("--prediction_data", pred,
                                      extra=flag))
    assert job.master.job_type == JobType.PREDICTION_ONLY
    got = np.concatenate([c for _, c in t_capture.chunks])
    want = np.concatenate([c for _, c in j_capture.chunks])
    assert got.shape == want.shape == (records, 10)
    assert {w for w, _ in t_capture.chunks} == {0}
    assert all(c.dtype == np.float32 for _, c in t_capture.chunks)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_a_failing_processor_fail_reports_its_task(monkeypatch, tmp_path):
    pred = _records(tmp_path, "pred", 32)
    params, _ = _mnist_weights()
    path = str(tmp_path / "model.chkpt")
    jsave_chkpt(pytree_to_named_arrays(params), 5, path)

    class Broken(BasePredictionOutputsProcessor):
        def process(self, predictions, worker_id):
            raise RuntimeError("sink is full")

    monkeypatch.setattr(tmnist, "PredictionOutputsProcessor", Broken,
                        raising=False)
    reports = []
    orig = MasterServicer.report_task_result

    def spy(self, task_id, err_message="", exec_counters=None):
        reports.append(err_message)
        return orig(self, task_id, err_message, exec_counters)

    monkeypatch.setattr(MasterServicer, "report_task_result", spy)
    # one batch per task: the failed batch completes (and fails) its task
    with pytest.raises(RuntimeError, match="sink is full"):
        cli.main(["predict"] + _targv(
            "--prediction_data", pred,
            extra=("--checkpoint_filename_for_init", path,
                   "--num_minibatches_per_task", "1"),
        ))
    assert reports and reports[0] == "sink is full"


# ---------------------------------------------------------------------------
# refusals and the give-up path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "data_flag,job_type",
    [("--validation_data", JobType.EVALUATION_ONLY),
     ("--prediction_data", JobType.PREDICTION_ONLY)],
)
def test_master_refuses_a_scoring_job_without_a_model_source(
    tmp_path, data_flag, job_type
):
    data = _records(tmp_path, "data", 16)
    with pytest.raises(ValueError, match="scores a saved model"):
        Master(parse_master_args(_targv(data_flag, data)
                                 + ["--training_data", ""]))
    with pytest.raises(ValueError, match="scores a saved model"):
        JMaster(jparse(_jargv(data_flag, data)))
    with pytest.raises(ValueError, match="scores a saved model"):
        ElasticAllReduceWorker(0, job_type, BATCH, "", MNIST, device="cpu")


@pytest.mark.parametrize(
    "verb,argv",
    [
        ("evaluate", ["--checkpoint_dir", "c"]),  # no --validation_data
        ("evaluate", ["--validation_data", "v"]),  # no model source
        ("predict", ["--checkpoint_filename_for_init", "f"]),  # no data
        ("predict", ["--prediction_data", "p"]),  # no model source
        # --checkpoint_dir counts only under AllreduceStrategy
        ("evaluate", ["--validation_data", "v", "--checkpoint_dir", "c",
                      "--distribution_strategy", "ParameterServerStrategy"]),
        ("predict", ["--prediction_data", "p", "--checkpoint_dir", "c",
                     "--distribution_strategy", "ParameterServerStrategy"]),
    ],
)
def test_cli_gate_exits_2_as_the_jax_cli_does(verb, argv):
    base = ["--job_name", "j", "--model_zoo", "", "--model_def", MNIST]
    if "--distribution_strategy" not in argv:
        base += ["--distribution_strategy", "AllreduceStrategy"]
    assert cli.main([verb] + base + argv) == 2
    assert getattr(japi, verb)(base + argv) == 2


@pytest.mark.parametrize(
    "job_type",
    [JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION],
)
def test_elastic_worker_refuses_training_jobs_by_name(job_type, tmp_path):
    """The elastic worker routes a training job by the reference's
    probes of ``param_shardings``: it refuses by name what splits
    parameters over a ``pipe`` axis, not ported (the LM's
    pipeline_stages=2: the stage stacks on the collective plane, ROADMAP
    A9.3, and with evaluation rounds their in-plane evaluation), trains
    the LM's tensor_parallel=2 on the pjit dense plane and deepfm_edl's
    vocabulary-split tables on the collective plane, and trains on the
    replicated plane what splits nothing: a zoo whose ``mesh_axes``
    alone names a layout, as the reference's does, and the LM without
    tensor_parallel."""
    lm = "transformer_lm.transformer_lm.custom_model"
    with pytest.raises(NotImplementedError,
                       match="pipeline_stages.*A9.3") as refused:
        ElasticAllReduceWorker(0, job_type, BATCH, "", lm,
                               model_params="pipeline_stages=2",
                               checkpoint_dir="c", device="cpu")
    assert ("_collective_evaluate" in str(refused.value)) == (
        job_type == JobType.TRAINING_WITH_EVALUATION
    )
    tp = ElasticAllReduceWorker(0, job_type, BATCH, "", lm,
                                model_params="tensor_parallel=2",
                                checkpoint_dir="c", device="cpu")
    assert tp.trainer.is_sharded and tp._host_model_factory is None
    edl = ElasticAllReduceWorker(
        0, job_type, BATCH, "",
        "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
        model_params="vocab_size=97,embedding_dim=8,fc_unit=8",
        checkpoint_dir="c", device="cpu")
    assert edl.trainer.is_sharded and edl._host_model_factory is not None
    zoo = tmp_path / "zoo" / "meshed"
    zoo.mkdir(parents=True)
    (zoo / "meshed.py").write_text(
        "from elasticdl_tpu_torch.model_zoo.mnist_subclass.mnist_subclass "
        "import *  # noqa\n\n\ndef mesh_axes(n):\n    return {'data': n}\n"
    )
    for zoo_dir, model_def in ((str(tmp_path / "zoo"),
                                "meshed.meshed.CustomModel"),
                               ("", MNIST), ("", lm)):
        worker = ElasticAllReduceWorker(0, job_type, BATCH, zoo_dir,
                                        model_def, checkpoint_dir="c",
                                        device="cpu")
        assert worker.trainer is not None, model_def
        assert not worker.trainer.is_sharded, model_def


def test_eval_only_gives_up_on_an_empty_checkpoint_dir(tmp_path):
    val = _records(tmp_path, "val", 32)
    empty = tmp_path / "ckpt"
    empty.mkdir()
    jobs = []
    with pytest.raises(RuntimeError, match="cannot make progress"):
        cli.main(["evaluate"] + _targv(
            "--validation_data", val, extra=("--checkpoint_dir", str(empty))
        ), jobs=jobs)
    master = jobs[0].master
    assert master._stop_requested.is_set()
    assert not master.evaluation_service.published
    # the give-up fail-reported its task: it is queued again, not lost
    assert master.task_d.queue_depths()["eval_todo"] >= 1

