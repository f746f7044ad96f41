"""Dynamic task dispatch, the counterpart of
``elasticdl_tpu/master/task_dispatcher.py``.

The data is cut into tasks of ``records_per_task`` records over named
shards; any worker can take any task. Failed or orphaned tasks are
queued again (``report(success=False)``, ``recover_tasks``). Training
epochs are created lazily when the todo queue drains, and a deferred
SAVE_MODEL task is appended once all training tasks are done. Evaluation
tasks wait in their own queue; each one that succeeds counts down the
evaluation service's running round (``set_evaluation_service``).

The task order is the reference's: each epoch's tasks are shuffled with
``random.Random(EDL_TASK_SHUFFLE_SEED).shuffle`` when that variable is
set, else with the global ``random.shuffle``, so one seed gives both
packages the same order. Not ported yet: the dispatch journal of the
master recovery plane (``journal`` must be None) and the recovery that
replays it.
"""

import os
import random
import threading
import time

from elasticdl_tpu_torch.common.constants import (
    SaveModelConfig,
    TaskType,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling


class Task:
    """One unit of dispatchable work: records [start, end) of a shard."""

    __slots__ = (
        "shard_name",
        "start",
        "end",
        "type",
        "model_version",
        "extended_config",
    )

    def __init__(self, shard_name, start, end, type, model_version=-1, **kw):
        self.shard_name = shard_name
        self.start = start
        self.end = end
        self.type = type
        self.model_version = model_version
        self.extended_config = kw

    def _info(self):
        return (
            self.shard_name,
            self.start,
            self.end,
            self.type,
            self.model_version,
        )

    def __repr__(self):
        return "Task%s" % (self._info(),)


class TaskDispatcher:
    """Creates and dispatches Tasks; tracks each task's lifecycle.

    The shards dicts map shard_name -> (start_index, num_records)."""

    def __init__(
        self,
        training_shards,
        evaluation_shards,
        prediction_shards,
        records_per_task,
        num_epochs,
        journal=None,
        streaming=False,
    ):
        if journal is not None:
            raise NotImplementedError(
                "the master dispatch journal (recovery plane) is not "
                "ported yet"
            )
        self._lock = threading.Lock()
        self._num_epochs = num_epochs
        self._epoch = 0
        # unbounded stream: while on, every drained todo queue rolls a
        # new epoch, until set_streaming(False) lets the job finish
        self._streaming = bool(streaming)
        self._training_shards = training_shards
        self._evaluation_shards = evaluation_shards
        self._prediction_shards = prediction_shards
        self._records_per_task = records_per_task
        seed = os.environ.get("EDL_TASK_SHUFFLE_SEED")
        self._shuffle = (
            random.Random(int(seed)).shuffle if seed else random.shuffle
        )

        self._todo = []
        self._doing = {}  # task_id -> (worker_id, Task)
        self._task_id = 0
        self._eval_todo = []
        self._evaluation_service = None
        self._tasks_done_deferred_callbacks = []
        # every Task gets a trace id at its first dispatch (kept across
        # requeues: the same Task object returns to todo); each dispatch
        # records (trace, attempt, t0) for the per-task timeline event
        self._trace_seq = 0
        self._dispatch_meta = {}  # task_id -> (trace_id, attempt, t0)

        if self._training_shards:
            logger.info("Epoch %d begins", self._epoch)
            self.create_tasks(TaskType.TRAINING)
        elif self._evaluation_shards:
            self.create_tasks(TaskType.EVALUATION)
        elif self._prediction_shards:
            self.create_tasks(TaskType.PREDICTION)

    def _shards_of(self, task_type):
        if task_type == TaskType.TRAINING:
            return self._training_shards
        if task_type == TaskType.EVALUATION:
            return self._evaluation_shards
        return self._prediction_shards

    def create_tasks(self, task_type, model_version=-1):
        """Generate and queue one task set."""
        with self._lock:
            self._create_tasks_locked(task_type, model_version)

    def _create_tasks_locked(self, task_type, model_version=-1):
        logger.info(
            "Generating %s task set (model version %d)",
            TaskType(task_type).name.lower(),
            model_version,
        )
        tasks = []
        for shard_name, (shard_start, shard_count) in self._shards_of(
            task_type
        ).items():
            shard_max = shard_start + shard_count
            for start in range(shard_start, shard_max, self._records_per_task):
                tasks.append(
                    Task(
                        shard_name=shard_name,
                        start=start,
                        end=min(start + self._records_per_task, shard_max),
                        type=task_type,
                        model_version=model_version,
                        _epoch=self._epoch,
                    )
                )
        if task_type == TaskType.TRAINING:
            self._shuffle(tasks)
            self._todo.extend(tasks)
        elif task_type == TaskType.EVALUATION:
            self._eval_todo.extend(tasks)
        else:
            self._todo.extend(tasks)

    def count_tasks(self, task_type):
        """Number of tasks one create_tasks(task_type) call would create."""
        return sum(
            len(range(start, start + count, self._records_per_task))
            for start, count in self._shards_of(task_type).values()
        )

    def _stamp_dispatch(self, task_id, task):
        """Assign or keep the trace id; record the dispatch (lock held)."""
        trace = task.extended_config.get("trace_id")
        attempt = 0
        if trace is None:
            self._trace_seq += 1
            trace = "t%06d" % self._trace_seq
            task.extended_config["trace_id"] = trace
        else:
            attempt = task.extended_config.get("_attempt", 0)
        task.extended_config["_attempt"] = attempt
        self._dispatch_meta[task_id] = (trace, attempt, time.monotonic())

    def get_eval_task(self, worker_id):
        """Return the next evaluation (task_id, Task), or (-1, None)."""
        with self._lock:
            if not self._eval_todo:
                return -1, None
            self._task_id += 1
            task = self._eval_todo.pop()
            self._doing[self._task_id] = (worker_id, task)
            self._stamp_dispatch(self._task_id, task)
            return self._task_id, task

    def _create_save_model_task(self, saved_model_path):
        """Append one SAVE_MODEL task carrying a small data shard: the
        export takes its example batch from it."""
        shards = self._training_shards
        assert shards
        shard_name, (shard_start, shard_count) = next(iter(shards.items()))
        self._todo.append(
            Task(
                shard_name=shard_name,
                start=shard_start,
                end=shard_start + min(self._records_per_task, shard_count),
                type=TaskType.SAVE_MODEL,
                _epoch=self._epoch,
                **{SaveModelConfig.SAVED_MODEL_PATH: saved_model_path},
            )
        )

    def add_deferred_callback_create_save_model_task(self, saved_model_path):
        self._tasks_done_deferred_callbacks.append(
            lambda: self._create_save_model_task(saved_model_path)
        )

    def invoke_deferred_callback(self):
        """Pop and invoke one deferred callback; False if none remain."""
        if not self._tasks_done_deferred_callbacks:
            return False
        with self._lock:
            if not self._tasks_done_deferred_callbacks:
                return False
            self._tasks_done_deferred_callbacks.pop()()
            return True

    def set_streaming(self, active):
        """Flip the unbounded-stream mode; turning it off aborts nothing."""
        with self._lock:
            self._streaming = bool(active)

    @property
    def streaming(self):
        with self._lock:
            return self._streaming

    def get(self, worker_id):
        """Return the next (task_id, Task), or (-1, None) when drained.
        Rolls over to the next training epoch when todo empties."""
        with self._lock:
            if not self._todo and self._training_shards and (
                self._streaming or self._epoch < self._num_epochs - 1
            ):
                self._epoch += 1
                self._create_tasks_locked(TaskType.TRAINING)
                logger.info("Epoch %d begins", self._epoch)
            if not self._todo:
                return -1, None
            self._task_id += 1
            task = self._todo.pop()
            self._doing[self._task_id] = (worker_id, task)
            self._stamp_dispatch(self._task_id, task)
            return self._task_id, task

    def report(self, task_id, success, exec_counters=None):
        """Report task completion; a failure queues the task again.
        ``exec_counters`` (from the worker's ack) rides into the per-task
        timeline event (``consume_s``, the worker's own wall time). A
        successful evaluation task completes its round's task after the
        lock is released."""
        evaluation_task_completed = False
        with self._lock:
            worker_id, task = self._doing.pop(task_id, (-1, None))
            meta = self._dispatch_meta.pop(task_id, None)
            if not task:
                logger.warning(
                    "Report for untracked task id %d; ignoring", task_id
                )
            elif not success:
                task.extended_config["_attempt"] = (
                    task.extended_config.get("_attempt", 0) + 1
                )
                if task.type == TaskType.EVALUATION:
                    self._eval_todo.append(task)
                else:
                    self._todo.append(task)
            elif (
                task.type == TaskType.EVALUATION
                and self._evaluation_service is not None
            ):
                evaluation_task_completed = True
            else:
                logger.info(
                    "Task %d done; %d still outstanding",
                    task_id,
                    len(self._todo) + len(self._doing),
                )
        if task and meta:
            trace, attempt, t0 = meta
            timeline = {
                "trace_id": trace,
                "task_id": task_id,
                "worker_id": worker_id,
                "attempt": attempt,
                "shard": task.shard_name,
                "dispatch_to_report_s": round(time.monotonic() - t0, 6),
            }
            if exec_counters and "consume_s" in exec_counters:
                timeline["consume_s"] = exec_counters["consume_s"]
            profiling.events.emit(
                "task_done" if success else "task_requeued", **timeline
            )
        if evaluation_task_completed:
            self._evaluation_service.complete_task()

    def queue_depths(self):
        with self._lock:
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "eval_todo": len(self._eval_todo),
            }

    def finished(self):
        """True when no todo/eval/doing tasks remain (under the lock: a
        lock-free read could fall between get()'s pop from todo and its
        insert into doing)."""
        with self._lock:
            return (
                not self._todo and not self._eval_todo and not self._doing
            )

    def recover_tasks(self, worker_id):
        """Queue again all in-flight tasks of a dead worker."""
        with self._lock:
            ids = [
                tid
                for tid, (wid, _) in self._doing.items()
                if wid == worker_id
            ]
        for tid in ids:
            self.report(tid, False)

    def set_evaluation_service(self, evaluation_service):
        """Attach the evaluation service; an evaluation-only job's single
        round counts every evaluation task queued at construction."""
        with self._lock:
            self._evaluation_service = evaluation_service
            if self._evaluation_shards and not self._training_shards:
                evaluation_service.init_eval_only_job(len(self._eval_todo))
