"""The master's control plane, the ``coordinates_only`` part of
``elasticdl_tpu/master/servicer.py``: what an ALLREDUCE job's master
serves, where the parameters live on the worker.

- ``get_task`` hands out the dispatcher's next task, or WAIT while tasks
  are still in flight or a deferred SAVE_MODEL task was just queued;
- ``report_task_result`` takes the worker's model version from the
  report's ``exec_counters`` (the master applies no gradients, so task
  reports are its only version clock), drives the evaluation service's
  step trigger when that version advances, and reports the task to the
  dispatcher, a failure queuing it again;
- ``report_evaluation_metrics`` hands a worker's outputs and labels to
  the evaluation service's running round;
- ``get_model_version`` and ``restore_version``.

Not ported yet: the master-held model (``optimizer`` not None, the
master-KV and PS planes) and the journal.
"""

import threading

from elasticdl_tpu_torch.common.constants import TaskExecCounterKey, TaskType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger


class TaskResponse:
    """The get_task reply."""

    def __init__(
        self,
        task_id=-1,
        shard_name="",
        start=0,
        end=0,
        type=None,
        model_version=-1,
        minibatch_size=0,
        extended_config=None,
    ):
        self.task_id = task_id
        self.shard_name = shard_name
        self.start = start
        self.end = end
        self.type = type
        self.model_version = model_version
        self.minibatch_size = minibatch_size
        self.extended_config = extended_config or {}


class MasterServicer:
    def __init__(
        self,
        grads_to_wait,
        minibatch_size,
        optimizer,
        task_d,
        checkpoint_service=None,
        evaluation_service=None,
        coordinates_only=True,
        journal=None,
    ):
        """``optimizer`` must be None: the port's master holds no model.
        ``grads_to_wait`` is the reference's sync-SGD setting, accepted
        and unused by a coordinating master."""
        if optimizer is not None or not coordinates_only:
            raise NotImplementedError(
                "a master that holds the model (master-KV or PS plane) is "
                "not ported yet: the ALLREDUCE master coordinates only"
            )
        if journal is not None:
            raise NotImplementedError(
                "the master dispatch journal is not ported yet"
            )
        del grads_to_wait
        self._task_d = task_d
        self._lock = threading.Lock()
        self._minibatch_size = minibatch_size
        self._version = 0
        self._checkpoint_service = checkpoint_service
        self._evaluation_service = evaluation_service
        if evaluation_service:
            evaluation_service.set_master_servicer(self)

    @property
    def coordinates_only(self):
        """Always True here: the master dispatches tasks and applies no
        gradients, so its version advances only through the workers'
        reports, and an evaluation round pins a version number rather
        than an eval checkpoint."""
        return True

    @property
    def lock(self):
        """The version lock. The evaluation service checks and updates
        its trigger under it, so the step trigger and the timer thread
        share one lock order."""
        return self._lock

    def get_task(self, worker_id, task_type=None):
        """The next task as a TaskResponse; WAIT while the job is not
        finished (or a deferred SAVE_MODEL task was just queued), an
        empty response once it is."""
        res = TaskResponse(
            model_version=self._version, minibatch_size=self._minibatch_size
        )
        if task_type == TaskType.EVALUATION:
            task_id, task = self._task_d.get_eval_task(worker_id)
        else:
            task_id, task = self._task_d.get(worker_id)
        if task:
            res.task_id = task_id
            res.shard_name = task.shard_name
            res.start = task.start
            res.end = task.end
            res.type = task.type
            res.extended_config = dict(task.extended_config)
            if task.type == TaskType.EVALUATION:
                res.model_version = task.model_version
        elif (not self._task_d.finished()) or (
            self._task_d.invoke_deferred_callback()
        ):
            res.type = TaskType.WAIT
        return res

    def report_task_result(self, task_id, err_message="", exec_counters=None):
        if exec_counters and TaskExecCounterKey.MODEL_VERSION in exec_counters:
            reported = int(exec_counters[TaskExecCounterKey.MODEL_VERSION])
            with self._lock:
                advanced = reported > self._version
                self._version = max(self._version, reported)
            if advanced and self._evaluation_service:
                # task reports are this master's only version clock, so
                # they drive the step trigger (taking the lock: this
                # thread does not hold it)
                self._evaluation_service.add_evaluation_task_if_needed(
                    master_locking=True
                )
        if err_message:
            logger.warning("Worker reported error: " + err_message)
            self._task_d.report(task_id, False, exec_counters=exec_counters)
        else:
            self._task_d.report(task_id, True, exec_counters=exec_counters)

    def report_evaluation_metrics(
        self, model_version, model_outputs, labels, scored_version=None
    ):
        """Returns (accepted, current version). ``scored_version`` is the
        version the worker's params were loaded from where it could not
        score ``model_version`` exactly."""
        accepted = self._evaluation_service.report_evaluation_metrics(
            model_version,
            model_outputs,
            labels,
            scored_version=scored_version,
        )
        return accepted, self._version

    def get_model_version(self):
        return self._version

    def restore_version(self, version):
        """Resume a version clock (never moves it back)."""
        with self._lock:
            self._version = max(self._version, int(version))
