"""The master of the single-process ALLREDUCE job, the counterpart of
``elasticdl_tpu/master/master.py``: it builds the task dispatcher from the
data reader's shards, infers the job type from the data flags, keeps the
checkpoint service, the evaluation service (for a job with
``--validation_data`` or an evaluation trigger) and the coordinating
servicer, queues the deferred SAVE_MODEL task when ``--output`` is set,
and polls ``finished()``.

The worker holds the servicer directly, in the same process, so the
master starts no RPC server: no remote worker exists until the
multi-process job is ported (the reference's ``prepare()`` starts one
that this job never dials). Every other plane of the reference's master
raises ``NotImplementedError`` by name when its flag asks for it: the
dispatch journal (``--master_journal_dir``), the telemetry endpoint and
event sink (``--telemetry_port``, ``--telemetry_events_path``), the
flight recorder (``EDL_FLIGHT_RECORDER_DIR``), TensorBoard
(``--tensorboard_log_dir``), membership and the instance managers
(``--num_workers > 0``) and the parameter-server strategy.
"""

import os
import threading

from elasticdl_tpu_torch.common.constants import DistributionStrategy, JobType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    get_dict_from_params_str,
    load_zoo_module,
)
from elasticdl_tpu_torch.data.data_reader import create_data_reader
from elasticdl_tpu_torch.master.checkpoint_service import CheckpointService
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher


def _not_ported(plane, flag):
    return NotImplementedError(
        "%s is not ported yet (asked for by %s)" % (plane, flag)
    )


def _make_task_dispatcher(
    training_data,
    validation_data,
    prediction_data,
    records_per_task,
    num_epochs,
    data_reader_params=None,
    journal=None,
    streaming=False,
):
    def _shards(origin):
        if not origin:
            return {}
        reader = create_data_reader(
            data_origin=origin,
            records_per_task=records_per_task,
            **(data_reader_params or {}),
        )
        return reader.create_shards()

    return TaskDispatcher(
        _shards(training_data),
        _shards(validation_data),
        _shards(prediction_data),
        records_per_task,
        num_epochs,
        journal=journal,
        streaming=streaming,
    )


def refuse_unported_planes(args):
    """Raise for each flag that asks for a plane this master lacks."""
    strategy = getattr(args, "distribution_strategy", "")
    if strategy != DistributionStrategy.ALLREDUCE:
        raise _not_ported(
            "the %s strategy" % strategy, "--distribution_strategy"
        )
    checks = (
        ("the master dispatch journal", "--master_journal_dir",
         getattr(args, "master_journal_dir", "")),
        ("the telemetry endpoint", "--telemetry_port",
         getattr(args, "telemetry_port", None) is not None),
        ("the telemetry event sink", "--telemetry_events_path",
         getattr(args, "telemetry_events_path", "")),
        ("the flight recorder", "EDL_FLIGHT_RECORDER_DIR",
         os.environ.get("EDL_FLIGHT_RECORDER_DIR")),
        ("TensorBoard", "--tensorboard_log_dir",
         getattr(args, "tensorboard_log_dir", "")),
        ("membership and the instance managers (worker processes)",
         "--num_workers > 0", getattr(args, "num_workers", 0) > 0),
    )
    for plane, flag, asked in checks:
        if asked:
            raise _not_ported(plane, flag)


class Master:
    def __init__(self, args):
        self.args = args
        self.job_type = Master._get_job_type(args)
        if self.job_type in (
            JobType.EVALUATION_ONLY,
            JobType.PREDICTION_ONLY,
        ) and not (
            getattr(args, "checkpoint_dir", "")
            or getattr(args, "checkpoint_filename_for_init", "")
        ):
            raise ValueError(
                "%s under AllreduceStrategy scores a saved model: pass "
                "--checkpoint_dir (sharded checkpoints) or "
                "--checkpoint_filename_for_init (exported model file)"
                % self.job_type
            )
        refuse_unported_planes(args)
        records_per_task = (
            args.minibatch_size * args.num_minibatches_per_task
        )
        self.task_d = _make_task_dispatcher(
            getattr(args, "training_data", ""),
            getattr(args, "validation_data", ""),
            getattr(args, "prediction_data", ""),
            records_per_task,
            args.num_epochs,
            get_dict_from_params_str(getattr(args, "data_reader_params", "")),
            streaming=bool(getattr(args, "streaming_tasks", False)),
        )
        self.checkpoint_service = CheckpointService(
            getattr(args, "checkpoint_dir", ""),
            getattr(args, "checkpoint_steps", 0),
            getattr(args, "keep_checkpoint_max", 0),
            False,
        )
        self.model_module = load_zoo_module(
            args.model_def, getattr(args, "model_zoo", "")
        )
        self.evaluation_service = self._create_evaluation_service(args)
        if self.evaluation_service:
            self.task_d.set_evaluation_service(self.evaluation_service)
        if getattr(args, "output", "") and self._job_has_training():
            self.task_d.add_deferred_callback_create_save_model_task(
                args.output
            )
        self.master_servicer = MasterServicer(
            args.grads_to_wait,
            args.minibatch_size,
            None,
            self.task_d,
            checkpoint_service=self.checkpoint_service,
            evaluation_service=self.evaluation_service,
        )
        self._stop_requested = threading.Event()

    @staticmethod
    def _get_job_type(args):
        has_training = bool(getattr(args, "training_data", ""))
        has_validation = bool(getattr(args, "validation_data", ""))
        has_prediction = bool(getattr(args, "prediction_data", ""))
        has_eval_trigger = bool(
            getattr(args, "evaluation_steps", 0)
            or getattr(args, "evaluation_throttle_secs", 0)
        )
        if has_prediction and not has_training:
            return JobType.PREDICTION_ONLY
        if has_validation and not has_training:
            return JobType.EVALUATION_ONLY
        if has_training and (has_validation or has_eval_trigger):
            return JobType.TRAINING_WITH_EVALUATION
        return JobType.TRAINING_ONLY

    def _job_has_training(self):
        return self.job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        )

    def _create_evaluation_service(self, args):
        if self.job_type == JobType.TRAINING_ONLY:
            return None
        name = args.eval_metrics_fn
        eval_metrics_fn = getattr(self.model_module, name, None)
        if eval_metrics_fn is None:
            raise ValueError(
                "the model module of %s defines no %s" % (args.model_def, name)
            )
        return EvaluationService(
            self.checkpoint_service,
            None,
            self.task_d,
            getattr(args, "evaluation_start_delay_secs", 0),
            getattr(args, "evaluation_throttle_secs", 0),
            getattr(args, "evaluation_steps", 0),
            self.job_type == JobType.EVALUATION_ONLY,
            eval_metrics_fn,
        )

    def prepare(self):
        """Start the evaluation service's timer, if any. There is no RPC
        server to start (see the module doc)."""
        if self.evaluation_service:
            self.evaluation_service.start()
        logger.info("Master ready (in-process, %s)", self.job_type)

    def run(self, poll_secs=30):
        """Poll until all tasks are done, queuing the deferred SAVE_MODEL
        task when they are; returns 0. The evaluation service's timer
        stops with it."""
        try:
            while not self._stop_requested.is_set():
                if self.task_d.finished():
                    if self.task_d.invoke_deferred_callback():
                        continue  # a SAVE_MODEL task was just queued
                    break
                self._stop_requested.wait(poll_secs)
        finally:
            self._stop_evaluation()
        return 0

    def request_stop(self):
        self._stop_requested.set()
        self._stop_evaluation()

    def _stop_evaluation(self):
        if self.evaluation_service:
            self.evaluation_service.stop()
