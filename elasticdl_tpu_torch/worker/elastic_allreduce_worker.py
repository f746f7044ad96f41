"""The scoring drain of ``elasticdl_tpu/worker/elastic_allreduce_worker.py``:
the worker that serves an ALLREDUCE job's evaluation-only and
prediction-only runs.

Such a job trains nothing, so it needs no collective, no membership and
no trainer state: its tasks drain against an inference forward (BatchNorm
on running statistics) over parameters loaded once from a saved model:

- the newest restorable sharded checkpoint under ``--checkpoint_dir``
  (``ckpt_v{N}``, a torn newest directory falling through to older
  ones), params and BatchNorm statistics both; or else
- ``--checkpoint_filename_for_init``: a ``.chkpt`` file or an export
  directory, in either package's naming (``common/convert.py`` maps the
  reference's parameter paths). An exported model carries no BatchNorm
  statistics in either package, so it scores with fresh ones, as the
  reference does.

Evaluation-only (``_run_eval_only``) drains the evaluation queue, each
task's outputs reported to the master's single round with the version
the params came from, until three rounds in a row find nothing; a task
still queued then means every attempt deferred (no scoreable params),
and the worker gives up with an error. Prediction-only
(``_run_predict_only``) streams the prediction tasks like training does,
retries a failed forward up to three times, and hands each batch's
outputs (host numpy, bf16 widened to float32) to the zoo's
``PredictionOutputsProcessor`` once; its failure fail-reports the task.

Every other job type raises ``NotImplementedError``: the collective half
of the elastic worker (membership, the elastic trainer, resizes) is not
ported yet.
"""

import time

import numpy as np

from elasticdl_tpu_torch.common.constants import (
    JobType,
    MetricsDictKey,
    Mode,
    TaskType,
)
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    load_zoo_module,
)
from elasticdl_tpu_torch.data.dataset import tree_map
from elasticdl_tpu_torch.metrics import to_host
from elasticdl_tpu_torch.worker.allreduce_worker import _first_leaf
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

_ATTEMPTS = 3  # drained rounds before the eval-only drain ends; forward
# attempts per prediction batch


class ElasticAllReduceWorker:
    def __init__(
        self,
        worker_id,
        job_type,
        minibatch_size,
        model_zoo,
        model_def,
        model_params=None,
        dataset_fn="dataset_fn",
        loss="loss",
        optimizer="optimizer",
        eval_metrics_fn="eval_metrics_fn",
        stub=None,
        data_reader_params=None,
        checkpoint_dir="",
        checkpoint_filename_for_init="",
        prediction_outputs_processor="PredictionOutputsProcessor",
        device="cuda",
    ):
        if job_type not in (JobType.EVALUATION_ONLY, JobType.PREDICTION_ONLY):
            raise NotImplementedError(
                "ElasticAllReduceWorker for %s jobs (membership, the "
                "elastic trainer) is not ported yet: only the "
                "evaluation-only and prediction-only drain is" % job_type
            )
        if not (checkpoint_dir or checkpoint_filename_for_init):
            raise ValueError(
                "%s on the allreduce plane scores a saved model: pass "
                "--checkpoint_dir (sharded checkpoints) or "
                "--checkpoint_filename_for_init (an exported model file)"
                % job_type
            )
        for hook in ("mesh_axes", "build_distributed_model"):
            if hasattr(load_zoo_module(model_def, model_zoo), hook):
                raise NotImplementedError(
                    "zoo module %s defines %s: a mesh or distributed model "
                    "is not ported yet" % (model_def, hook)
                )
        self._worker_id = worker_id
        self._job_type = job_type
        self._minibatch_size = minibatch_size
        self._stub = stub
        self._device = resolve_device(device)
        spec = get_model_spec(
            model_zoo=model_zoo,
            model_def=model_def,
            model_params=model_params,
            dataset_fn=dataset_fn,
            loss=loss,
            optimizer=optimizer,
            eval_metrics_fn=eval_metrics_fn,
            prediction_outputs_processor=prediction_outputs_processor,
        )
        self._dataset_fn = spec.dataset_fn
        self._model = spec.model
        self._prediction_outputs_processor = spec.prediction_outputs_processor
        self._init_ckpt_file = checkpoint_filename_for_init
        self._checkpoint_dir = checkpoint_dir
        self._ckpt = None
        if checkpoint_dir:
            from elasticdl_tpu_torch.common.sharded_checkpoint import (
                ShardedCheckpointManager,
            )

            # read-only: a scoring job loads checkpoints, never writes
            self._ckpt = ShardedCheckpointManager(checkpoint_dir)
        self._task_data_service = TaskDataService(
            self, False, data_reader_params=data_reader_params
        )
        self._forward_fn = None
        self._eval_params = None  # (params, state) on the device
        self._eval_scored_version = None  # the version they came from

    # master surface used by TaskDataService
    def get_task(self, task_type=None):
        return self._stub.get_task(self._worker_id, task_type)

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        return self._stub.report_task_result(task_id, err_msg, exec_counters)

    def run(self):
        if self._job_type == JobType.EVALUATION_ONLY:
            return self._run_eval_only()
        return self._run_predict_only()

    # -- the two drains ------------------------------------------------------

    def _run_eval_only(self):
        """Drain the evaluation queue against the saved params until
        ``_ATTEMPTS`` rounds in a row find nothing; give up with an error
        if a task is still queued then."""
        drained_rounds = 0
        while True:
            executed = self._evaluate_only()
            task = self.get_task()  # the non-evaluation queue: job end
            if task.shard_name:
                # not this drain's work: hand it back, failed, untouched
                self.report_task_result(
                    task.task_id,
                    err_msg="eval-only worker cannot run task type %s"
                    % task.type,
                )
            if not executed and not task.shard_name:
                drained_rounds += 1
                if drained_rounds >= _ATTEMPTS:
                    break
                time.sleep(0.5)
            else:
                drained_rounds = 0
        leftover = self.get_task(TaskType.EVALUATION)
        if leftover.shard_name:
            self.report_task_result(
                leftover.task_id,
                err_msg="eval-only worker giving up: no scoreable params",
            )
            raise RuntimeError(
                "evaluation-only job cannot make progress: eval tasks "
                "keep deferring (is --checkpoint_dir empty / "
                "--checkpoint_filename_for_init unreadable, or does the "
                "checkpoint's parameter structure mismatch the model "
                "built from --model_params?)"
            )
        return []

    def _run_predict_only(self):
        """Stream the prediction tasks, forward each batch with the saved
        params (up to ``_ATTEMPTS`` tries) and hand the outputs to the
        zoo's processor once; a failed batch fail-reports its task and
        ends the job with an error."""
        if self._prediction_outputs_processor is None:
            logger.warning(
                "prediction_outputs_processor is not defined in the "
                "model definition. Prediction outputs are not processed."
            )
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                break
            dataset = self._dataset_fn(
                dataset,
                Mode.PREDICTION,
                self._task_data_service.data_reader.metadata,
            )
            dataset = (
                dataset.batch(self._minibatch_size)
                .prefetch(1)
                .device_prefetch(self._device)
            )
            for features in dataset:
                count = int(_first_leaf(features).shape[0])
                err_msg, outputs = "", None
                for attempt in range(_ATTEMPTS):
                    err_msg = ""
                    try:
                        outputs = self._serving_forward(features)
                        break
                    except RuntimeError as e:
                        # e.g. no restorable checkpoint yet
                        logger.warning(
                            "prediction batch deferred (attempt %d): %s",
                            attempt + 1,
                            e,
                        )
                        err_msg = str(e)
                        if attempt < _ATTEMPTS - 1:
                            time.sleep(0.5)
                if not err_msg and self._prediction_outputs_processor:
                    # once: a replay would write records to the sink twice
                    try:
                        self._prediction_outputs_processor.process(
                            tree_map(to_host, outputs), self._worker_id
                        )
                    except RuntimeError as e:
                        logger.warning(
                            "prediction outputs processor failed: %s", e
                        )
                        err_msg = str(e)
                self._task_data_service.report_record_done(count, err_msg)
                if err_msg:
                    raise RuntimeError(
                        "prediction-only job cannot make progress: %s"
                        % err_msg
                    )
        return []

    # -- scoring -------------------------------------------------------------

    def _serving_forward(self, features):
        """Inference forward over the saved params, loaded on first use.
        (Sharded-parameter zoos, which the reference scores through a
        host twin, are not ported.)"""
        if self._eval_params is None:
            self._load_eval_only_params()
        if self._forward_fn is None:
            from elasticdl_tpu_torch.training.step import make_forward_fn

            self._forward_fn = make_forward_fn(self._model)
        params, state = self._eval_params
        return self._forward_fn(params, state, features)

    def _template(self):
        """The model on the device, initialized: its parameter names and
        shapes, and fresh BatchNorm statistics."""
        from elasticdl_tpu_torch.nn.model_api import (
            init_variables,
            split_variables,
        )
        from elasticdl_tpu_torch.parallel.trainer import place_module

        place_module(self._model, self._device)
        return split_variables(init_variables(self._model, 0))

    def _adopt(self, params, state, template, source):
        """``params``/``state`` on the device, checked against the
        model's names and shapes (RuntimeError on a mismatch: the task
        defers)."""
        for what, got, want in zip(("params", "state"), (params, state),
                                   template):
            if sorted(got) != sorted(want):
                raise RuntimeError(
                    "%s has %s %s, the model %s"
                    % (source, what, sorted(got), sorted(want))
                )
            for name, value in got.items():
                if tuple(value.shape) != tuple(want[name].shape):
                    raise RuntimeError(
                        "%s: %s %s has shape %s, the model %s"
                        % (source, what, name, tuple(value.shape),
                           tuple(want[name].shape))
                    )
        return tuple(
            {n: t.to(self._device) for n, t in part.items()}
            for part in (params, state)
        )

    def _load_eval_only_params(self):
        """The newest restorable sharded checkpoint, else the exported
        model file (params only: the BatchNorm statistics are fresh)."""
        template = self._template()
        if self._ckpt is not None:
            from elasticdl_tpu_torch.common.sharded_checkpoint import (
                load_sharded_to_host,
                split_train_state_leaves,
            )

            for directory in self._ckpt.dirs_newest_first():
                try:
                    _, leaves = load_sharded_to_host(directory)
                    params, state, _, version = split_train_state_leaves(
                        leaves, list(template[0])
                    )
                    self._eval_params = self._adopt(
                        params, state, template, directory
                    )
                except Exception:
                    logger.warning(
                        "eval restore skipped checkpoint %s",
                        directory,
                        exc_info=True,
                    )
                    continue
                self._eval_scored_version = version
                logger.info(
                    "scoring checkpoint v%d (%s)", version, directory
                )
                return
        if self._init_ckpt_file:
            from elasticdl_tpu_torch.common import convert
            from elasticdl_tpu_torch.common.model_utils import (
                load_from_checkpoint_file,
            )

            # a .chkpt file or an export directory
            try:
                version, named = load_from_checkpoint_file(
                    self._init_ckpt_file
                )
                params = convert.to_state_dict(named)
            except (OSError, ValueError, KeyError) as e:
                raise RuntimeError(
                    "cannot read %s: %s" % (self._init_ckpt_file, e)
                ) from e
            self._eval_params = self._adopt(
                params, template[1], template, self._init_ckpt_file
            )
            self._eval_scored_version = version
            logger.info(
                "scoring exported model v%d from %s (fresh BatchNorm "
                "statistics)",
                version,
                self._init_ckpt_file,
            )
            return
        raise RuntimeError(
            "no restorable checkpoint in %r for evaluation"
            % self._checkpoint_dir
        )

    # -- evaluation tasks ----------------------------------------------------

    def _evaluate_only(self):
        """Score every queued evaluation task; True if any completed. A
        deferred task (no scoreable params) requeued: stop grabbing."""
        executed = False
        while True:
            task = self.get_task(TaskType.EVALUATION)
            if not task.shard_name:
                break
            if not self._process_eval_task(task):
                break
            executed = True
        return executed

    def _process_eval_task(self, task):
        """True when the task completed (or fail-reported for a retry);
        False when it deferred."""
        eval_info = self._task_data_service.get_validation_dataset(task)
        if not eval_info:
            return False
        dataset, model_version, task_id = eval_info
        dataset = self._dataset_fn(
            dataset,
            Mode.EVALUATION,
            self._task_data_service.data_reader.metadata,
        )
        dataset = dataset.batch(self._minibatch_size).device_prefetch(
            self._device
        )
        out_chunks, label_chunks = {}, []
        try:
            for features, labels in dataset:
                outputs = self._serving_forward(features)
                if not isinstance(outputs, dict):
                    outputs = {MetricsDictKey.MODEL_OUTPUT: outputs}
                # one copy to the host per batch (bf16 widened to float32)
                for k, v in outputs.items():
                    out_chunks.setdefault(k, []).append(to_host(v))
                label_chunks.append(to_host(labels))
        except RuntimeError as e:
            # e.g. no checkpoint yet: the task requeues, and a later
            # round redoes it
            logger.warning("eval task %d deferred: %s", task_id, e)
            self.report_task_result(task_id, err_msg=str(e))
            return False
        self._report_eval_outputs(
            task_id, model_version, out_chunks, label_chunks
        )
        return True

    def _report_eval_outputs(
        self, task_id, model_version, out_chunks, label_chunks
    ):
        """Publish one eval task's outputs and complete it; a failure to
        report fail-reports the task for a retry."""
        try:
            if out_chunks:
                self._stub.report_evaluation_metrics(
                    model_version,
                    {k: np.concatenate(v) for k, v in out_chunks.items()},
                    np.concatenate(label_chunks),
                    scored_version=self._eval_scored_version,
                )
            self.report_task_result(task_id)
        except Exception as e:
            logger.warning("eval task %d report failed: %s", task_id, e)
            self.report_task_result(task_id, err_msg=str(e))

