"""ALLREDUCE-strategy worker, the counterpart of
``elasticdl_tpu/worker/allreduce_worker.py``: it pulls tasks from the
master like every worker, but the parameters never leave the device: each
minibatch is one fused step of ``AllReduceTrainer`` on the card. The
master runs as a pure control plane (tasks, evaluation rounds,
SAVE_MODEL); this worker writes the sharded checkpoints, since only it
holds the state.

The input pipeline is the reference's (the zoo's ``dataset_fn``, then
``batch`` and ``prefetch(1)``) plus ``device_prefetch`` onto the
trainer's device, so the copy of batch N+1 overlaps the step on batch N.

A TRAINING_WITH_EVALUATION job drains the evaluation queue before each
training batch and after each task round (``_evaluate_only``): each
evaluation task is scored by an inference forward of the current state
(BatchNorm on its running statistics), its outputs brought to the host
once per batch and reported to the master's round with the version the
round pinned.

The mesh is the reference's: ``mesh_axes(n, ...)``, where the zoo has
it, gives its shape for the worker's one card (n = 1), else one
``data`` axis (``parallel/mesh.create_mesh``). A zoo module with
``build_distributed_model(mesh, ...)`` gets its model from that hook,
and ``param_shardings(mesh, ...)``, if the zoo has it, gives the trainer
each parameter's spec, which must be whole on that mesh (DeepFM's HBM
tables: a parameter on the card, its checkpoint leaf and export name
its own). A layout one card cannot hold raises the zoo's own error
(the LM's ``tensor_parallel=2``: "1 devices do not divide into
tensor_parallel=2"); tensor parallelism trains through
``AllReduceTrainer`` on the ranks of a world (``parallel/trainer.py``).
Evaluation-only and prediction-only jobs are refused, as in the
reference: the elastic worker's drain (``elastic_allreduce_worker.py``)
serves them.
"""

import os
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import (
    JobType,
    MetricsDictKey,
    Mode,
    SaveModelConfig,
    TaskType,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    load_zoo_module,
)
from elasticdl_tpu_torch.data.dataset import tree_map
from elasticdl_tpu_torch.metrics import to_host
from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService


def _pad_rows(x, pad):
    """``x`` with its last row repeated ``pad`` times."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


class AllReduceWorker:
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
        devices=None,
        data_reader_params=None,
        seed=0,
        accum_steps=1,
        precision=None,
        checkpoint_dir="",
        checkpoint_steps=0,
        keep_checkpoint_max=0,
        remat="",
        device="cuda",
    ):
        if job_type in (JobType.EVALUATION_ONLY, JobType.PREDICTION_ONLY):
            raise NotImplementedError(
                "%s is not served by the single-process ALLREDUCE loop; "
                "evaluation_only runs via the elastic worker "
                "(checkpoint-scored), prediction under "
                "ParameterServerStrategy" % job_type
            )
        self._worker_id = worker_id
        self._job_type = job_type
        self._minibatch_size = minibatch_size
        self._accum_steps = max(1, accum_steps)
        self._stub = stub
        zoo_module = load_zoo_module(model_def, model_zoo)
        distributed = hasattr(zoo_module, "build_distributed_model")
        spec = get_model_spec(
            model_zoo=model_zoo,
            model_def=model_def,
            model_params=model_params,
            dataset_fn=dataset_fn,
            loss=loss,
            optimizer=optimizer,
            eval_metrics_fn=eval_metrics_fn,
            build=not distributed,
        )
        self._dataset_fn = spec.dataset_fn
        from elasticdl_tpu_torch.training.step import parse_remat

        mesh, param_specs = None, None
        if distributed or hasattr(zoo_module, "mesh_axes"):
            # the zoo's mesh, and its model for the ALLREDUCE strategy
            # (the reference's ModelHandler rewrite), for the one card
            from elasticdl_tpu_torch.common.device import resolve_device
            from elasticdl_tpu_torch.common.model_utils import (
                get_dict_from_params_str,
            )
            from elasticdl_tpu_torch.parallel.mesh import create_mesh

            params_dict = get_dict_from_params_str(model_params) or {}
            mesh_shape = None
            if hasattr(zoo_module, "mesh_axes"):
                mesh_shape = zoo_module.mesh_axes(
                    len(devices) if devices else 1, **params_dict
                )
            mesh = create_mesh(mesh_shape, devices=[resolve_device(device)])
        if distributed:
            spec.model = zoo_module.build_distributed_model(
                mesh=mesh, **params_dict
            )
            if hasattr(zoo_module, "param_shardings"):
                param_specs = zoo_module.param_shardings(
                    mesh, **params_dict
                )
        self.trainer = AllReduceTrainer(
            spec.model, spec.loss, spec.optimizer(), devices=devices,
            seed=seed, mesh=mesh, param_specs=param_specs,
            accum_steps=accum_steps, precision=precision,
            remat=parse_remat(remat), device=device,
        )
        self._model = spec.model
        self._forward_fn = None
        from elasticdl_tpu_torch.common.export import export_provenance

        self._export_meta = export_provenance(
            model_zoo, model_def, model_params
        )
        self._task_data_service = TaskDataService(
            self,
            self._job_type == JobType.TRAINING_WITH_EVALUATION,
            data_reader_params=data_reader_params,
        )
        # in ALLREDUCE mode the parameters live on this worker, so the
        # worker (not the master) writes the checkpoints
        self._ckpt = None
        self._last_ckpt_version = 0
        self._restore_attempted = False
        if checkpoint_dir and checkpoint_steps:
            from elasticdl_tpu_torch.common.sharded_checkpoint import (
                ShardedCheckpointManager,
            )

            self._ckpt = ShardedCheckpointManager(
                checkpoint_dir, checkpoint_steps, keep_checkpoint_max
            )
            self._ckpt.set_expected_writers(1)

    # master surface used by TaskDataService
    def get_task(self, task_type=None):
        return self._stub.get_task(self._worker_id, task_type)

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        from elasticdl_tpu_torch.worker.reporting import with_model_version

        return self._stub.report_task_result(
            task_id, err_msg, with_model_version(self.trainer, exec_counters)
        )

    @property
    def input_stats(self):
        return self._task_data_service.stats

    # -- steps --------------------------------------------------------------

    def _pad_to_devices(self, features, labels):
        """Pad a partial batch to a multiple of devices x accum_steps by
        repeating its last example (the microbatch split needs whole
        microbatches); returns the true row count too."""
        n = self.trainer.num_devices * self._accum_steps
        b = int(_first_leaf(features).shape[0])
        pad = (-b) % n
        if pad == 0:
            return features, labels, b
        pad_fn = lambda x: _pad_rows(x, pad)  # noqa: E731
        return tree_map(pad_fn, features), tree_map(pad_fn, labels), b

    def _maybe_restore(self):
        """Resume from the newest restorable checkpoint once the state
        exists (first batch), falling through to older ones: a torn
        newest directory must not wedge a resume, and without this a
        restarted job would start over and overwrite the versions."""
        if self._ckpt is None or self._restore_attempted:
            return
        self._restore_attempted = True
        for directory in self._ckpt.dirs_newest_first():
            try:
                restored = self.trainer.restore_sharded(directory)
                self._last_ckpt_version = restored
                logger.info(
                    "resumed from checkpoint v%d (%s)", restored, directory
                )
                return
            except Exception:
                logger.warning(
                    "checkpoint %s unrestorable; trying older",
                    directory,
                    exc_info=True,
                )

    def _train_batch(self, dataset_batch):
        features, labels = dataset_batch
        features, labels, count = self._pad_to_devices(features, labels)
        if self.trainer.train_state is None:
            self.trainer.init_from_batch((features, labels))
            self._maybe_restore()
        # the per-step fetch keeps failure accounting exact: a failed
        # step surfaces on its own batch, before its records are reported
        loss = self.trainer.train_step(features, labels)
        return float(loss), count

    def _forward(self, features):
        """Inference forward of the current state (BatchNorm on its
        running statistics)."""
        if self._forward_fn is None:
            from elasticdl_tpu_torch.training.step import make_forward_fn

            self._forward_fn = make_forward_fn(self._model)
        ts = self.trainer.train_state
        return self._forward_fn(ts.params, ts.state, features)

    # -- evaluation ---------------------------------------------------------

    def _process_eval_task(self, task):
        eval_info = self._task_data_service.get_validation_dataset(task)
        if not eval_info:
            return
        eval_dataset, model_version, task_id = eval_info
        eval_dataset = self._dataset_fn(
            eval_dataset,
            Mode.EVALUATION,
            self._task_data_service.data_reader.metadata,
        )
        eval_dataset = (
            eval_dataset.batch(self._minibatch_size)
            .prefetch(1)
            .device_prefetch(self.trainer.device)
        )
        out_chunks, label_chunks = {}, []
        for features, labels in eval_dataset:
            outputs = self._forward(features)
            if not isinstance(outputs, dict):
                outputs = {MetricsDictKey.MODEL_OUTPUT: outputs}
            # one copy to the host per batch (bf16 widened to float32)
            for k, v in outputs.items():
                out_chunks.setdefault(k, []).append(to_host(v))
            label_chunks.append(to_host(labels))
        if out_chunks:
            self._stub.report_evaluation_metrics(
                model_version,
                {k: np.concatenate(v) for k, v in out_chunks.items()},
                np.concatenate(label_chunks),
            )
        self.report_task_result(task_id, "")

    def _evaluate_only(self):
        """Score every queued evaluation task; False if there was none.
        Before the first step there is no state to score: the tasks wait
        for the next call."""
        if self.trainer.train_state is None:
            return False
        executed = False
        while True:
            task = self.get_task(TaskType.EVALUATION)
            if not task.shard_name:
                break
            self._process_eval_task(task)
            executed = True
        return executed

    def _process_save_model_task_if_needed(self):
        """Export the trained state for a parked SAVE_MODEL task. One
        prediction-mode batch of the task's records is the example the
        serving member is traced from, on this worker's card, as the
        reference traces its serving function."""
        task, dataset = (
            self._task_data_service.get_save_model_task_and_dataset()
        )
        if task is None:
            return
        saved_model_path = os.path.join(
            task.extended_config.get(SaveModelConfig.SAVED_MODEL_PATH),
            str(int(time.time())),
        )
        from elasticdl_tpu_torch.common.export import (
            example_batch_for_export,
            export_train_state,
        )

        example = example_batch_for_export(
            dataset,
            self._dataset_fn,
            self._task_data_service.data_reader.metadata,
            self._minibatch_size,
            Mode.PREDICTION,
        )
        export_train_state(
            saved_model_path,
            self.trainer.get_host_state(),
            model=self._model,
            metadata=self._export_meta,
            example_features=example,
            serving_ts=self.trainer.train_state,
        )
        logger.info("Exported model to %s", saved_model_path)
        self.report_task_result(task_id=task.task_id, err_msg="")

    # -- main loop ----------------------------------------------------------

    def run(self):
        """Train on every task the master hands out, scoring the
        evaluation tasks between steps; returns the losses."""
        losses = []
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                break
            dataset = self._dataset_fn(
                dataset,
                Mode.TRAINING,
                self._task_data_service.data_reader.metadata,
            )
            dataset = (
                dataset.batch(self._minibatch_size)
                .prefetch(1)
                .device_prefetch(self.trainer.device)
            )
            with_evaluation = (
                self._job_type == JobType.TRAINING_WITH_EVALUATION
            )
            batches = 0
            for dataset_batch in dataset:
                batches += 1
                if with_evaluation:
                    self._evaluate_only()
                err_msg = ""
                try:
                    loss, count = self._train_batch(dataset_batch)
                    losses.append(loss)
                except Exception as e:  # report, don't die: task requeues
                    err_msg = str(e)
                    logger.exception("train step failed")
                    # drain exactly the head task so that it fail-reports
                    # and requeues now; with no task pending, charge the
                    # batch size
                    count = (
                        self._task_data_service.remaining_records_in_head_task()
                        or len(dataset_batch[1])
                    )
                self._task_data_service.report_record_done(count, err_msg)
                self._save_ckpt_if_due()
            if with_evaluation:
                self._evaluate_only()
            self._process_save_model_task_if_needed()
            if batches == 0:
                time.sleep(0.2)
        self._save_ckpt_if_due(final=True)
        return losses

    def _save_ckpt_if_due(self, final=False):
        """Write a sharded checkpoint at the version cadence, and once at
        the job's end."""
        if self._ckpt is None or not self._ckpt.is_enabled():
            return
        version = self.trainer.version
        if version <= self._last_ckpt_version:
            return
        if final or version - self._last_ckpt_version >= self._ckpt.steps:
            self._ckpt.save(self.trainer.train_state, version)
            self._last_ckpt_version = version
