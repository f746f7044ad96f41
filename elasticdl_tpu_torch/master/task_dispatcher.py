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
packages the same order.

With a ``journal`` (``master/journal.py``) every lifecycle transition
appends a record: each epoch's task set, each dispatch (its trace id,
attempt and boot-stable key), each completion, requeue and deduped
replay. A relaunched master fast-forwards a fresh dispatcher with
:meth:`TaskDispatcher.apply_recovery` before it serves. Task ids are
minted per boot, so an ack naming a task of a dead boot is resolved by
the trace id it carries (``exec_counters``), and an ack the dead boot
already counted is deduped.
"""

import os
import random
import threading
import time

from elasticdl_tpu_torch.common.constants import (
    SaveModelConfig,
    TaskExecCounterKey,
    TaskType,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.master.journal import task_key
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
        # appends are enqueues only (the journal's writer thread owns the
        # IO), so they may run under the ledger lock
        self._journal = journal
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
        # recovery tables (apply_recovery): traces a previous boot
        # completed, trace -> (type, epoch), the dedup set of replayed
        # acks pruned at each rollover; and the recovered tasks not yet
        # done, addressable by their traces
        self._done_traces = {}
        self._trace_lookup = {}  # trace -> Task

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
                        # the epoch the task belongs to: its journal key
                        _epoch=self._epoch,
                    )
                )
        if task_type == TaskType.TRAINING:
            self._shuffle(tasks)
            self._todo.extend(tasks)
            self._j("epoch", epoch=self._epoch)
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

    def _j(self, kind, **fields):
        if self._journal is not None:
            self._journal.append(kind, **fields)

    def _task_key(self, task):
        """The task's boot-stable journal key: what it covers, with the
        epoch it was created in, not its per-boot id."""
        return task_key(
            task.type,
            task.extended_config.get("_epoch", self._epoch),
            task.shard_name,
            task.start,
            task.end,
        )

    @staticmethod
    def _task_xc(task):
        """The extended config a relaunched master cannot regenerate from
        its arguments: the SAVE_MODEL task's path."""
        if task.type != TaskType.SAVE_MODEL:
            return None
        path = task.extended_config.get(SaveModelConfig.SAVED_MODEL_PATH)
        return {SaveModelConfig.SAVED_MODEL_PATH: path} if path else None

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
        self._j(
            "dispatch",
            task=task_id,
            trace=trace,
            attempt=attempt,
            key=list(self._task_key(task)),
            xc=self._task_xc(task),
        )

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
        Rolls over to the next training epoch when todo empties. The
        dispatch is a ``master/dispatch`` span bound to the task's trace
        after the stamp, so a worker's ``_sctx``-carrying ``get_task``
        shows the ledger time inside the caller's trace."""
        sp = profiling.span("master/dispatch", worker=worker_id)
        with sp:
            task_id, task = self._get_next(worker_id)
            if task is not None:
                sp.set_trace(task.extended_config.get("trace_id"))
            return task_id, task

    def _get_next(self, worker_id):
        with self._lock:
            if not self._todo and self._training_shards and (
                self._streaming or self._epoch < self._num_epochs - 1
            ):
                self._epoch += 1
                self._create_tasks_locked(TaskType.TRAINING)
                # a rolled-over epoch's traces can receive no more
                # replayed acks: the dedup set keeps one epoch's worth
                train = int(TaskType.TRAINING)
                self._done_traces = {
                    t: te
                    for t, te in self._done_traces.items()
                    if te[0] != train or te[1] >= self._epoch
                }
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
        timeline event (``consume_s``, the worker's own wall time) and
        carries the worker's view of the task's ``trace_id`` and
        ``attempt``: an ack held across a master relaunch names a task id
        of the dead boot, and its trace resolves it here, marking the
        recovered task done once or deduping an ack the dead boot already
        counted. A successful evaluation task completes its round's task
        after the lock is released. The report is a ``master/report``
        span bound to the ack's trace."""
        sp = profiling.span(
            "master/report", task=task_id, success=bool(success)
        )
        with sp:
            self._report(task_id, success, exec_counters, sp)

    def _report(self, task_id, success, exec_counters, sp):
        evaluation_task_completed = False
        counters = exec_counters or {}
        ack_trace = counters.get(TaskExecCounterKey.TRACE_ID)
        if ack_trace is not None:
            sp.set_trace(str(ack_trace))
        with self._lock:
            worker_id, task = self._doing.pop(task_id, (-1, None))
            meta = self._dispatch_meta.pop(task_id, None)
            if (
                task is not None
                and ack_trace is not None
                and meta is not None
                and str(ack_trace) != meta[0]
            ):
                # the id belongs to another boot and collides with a live
                # dispatch: hand the live task back, resolve by trace
                self._doing[task_id] = (worker_id, task)
                self._dispatch_meta[task_id] = meta
                logger.warning(
                    "ack for task id %d names trace %s but the live "
                    "dispatch is %s; resolving by trace",
                    task_id,
                    ack_trace,
                    meta[0],
                )
                task, meta = None, None
            if not task:
                if ack_trace is not None:
                    self._report_by_trace_locked(
                        str(ack_trace),
                        counters.get(TaskExecCounterKey.ATTEMPT, -1),
                        success,
                    )
                else:
                    logger.warning(
                        "Report for untracked task id %d; ignoring", task_id
                    )
            elif not success:
                task.extended_config["_attempt"] = (
                    task.extended_config.get("_attempt", 0) + 1
                )
                if meta is not None:
                    self._j(
                        "requeue",
                        trace=meta[0],
                        attempt=task.extended_config["_attempt"],
                        key=list(self._task_key(task)),
                    )
                if task.type == TaskType.EVALUATION:
                    self._eval_todo.append(task)
                else:
                    self._todo.append(task)
            elif (
                task.type == TaskType.EVALUATION
                and self._evaluation_service is not None
            ):
                self._mark_done_locked(task, meta)
                evaluation_task_completed = True
            else:
                self._mark_done_locked(task, meta)
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
            if "consume_s" in counters:
                timeline["consume_s"] = counters["consume_s"]
            # _ship=False: master-side events are already home; only a
            # worker process's events ride its snapshots upstream
            profiling.events.emit(
                "task_done" if success else "task_requeued",
                _ship=False,
                **timeline,
            )
        if evaluation_task_completed:
            self._evaluation_service.complete_task()

    def _mark_done_locked(self, task, meta):
        """Journal a completion and retire its trace (lock held): the
        trace joins the dedup set, so a replay of this ack is a no-op."""
        trace = meta[0] if meta else task.extended_config.get("trace_id")
        attempt = (
            meta[1] if meta else task.extended_config.get("_attempt", 0)
        )
        if trace is None:
            return
        key = self._task_key(task)
        self._done_traces[trace] = (key[0], key[1])
        self._trace_lookup.pop(trace, None)
        self._j("done", trace=trace, attempt=attempt, key=list(key))

    def _report_by_trace_locked(self, trace, attempt, success):
        """Resolve an ack whose task id this boot never minted: dedup it
        against the done set, or mark the recovered task done once,
        wherever it sits now (lock held)."""
        if trace in self._done_traces:
            self._j("dup", trace=trace, attempt=attempt)
            logger.info("replayed ack for already-done trace %s deduped",
                        trace)
            return
        task = self._trace_lookup.get(trace)
        if task is None:
            logger.warning(
                "ack names unknown trace %s (job arguments changed across "
                "the relaunch?); ignoring",
                trace,
            )
            return
        if not success:
            # the recovered task is queued for dispatch already; a stale
            # failure ack must not queue it twice
            logger.info("stale failure ack for recovered trace %s ignored",
                        trace)
            return
        # still in todo, dispatched again (doing: the second worker's ack
        # will dedup), or in the evaluation queue
        removed = False
        for queue in (self._todo, self._eval_todo):
            if task in queue:
                queue.remove(task)
                removed = True
                break
        if not removed:
            for tid, (_, t) in list(self._doing.items()):
                if t is task:
                    del self._doing[tid]
                    self._dispatch_meta.pop(tid, None)
                    removed = True
                    break
        if not removed:
            logger.warning(
                "recovered trace %s resolved but its task was not queued; "
                "marking done anyway",
                trace,
            )
        key = self._task_key(task)
        self._done_traces[trace] = (key[0], key[1])
        self._trace_lookup.pop(trace, None)
        self._j("done", trace=trace, attempt=attempt, key=list(key))
        logger.info("recovered task (trace %s) marked done by a replayed ack",
                    trace)

    def apply_recovery(self, state):
        """Fast-forward this fresh dispatcher to a journal's
        :class:`~elasticdl_tpu_torch.master.journal.RecoveryState`,
        once at boot, before the RPC server serves: the epoch in
        progress regenerates and its done keys are filtered out, tasks
        in flight at the crash requeue exactly once under their old
        traces (so late acks resolve), stragglers of earlier epochs and
        the SAVE_MODEL task are rebuilt from their keys, and the dedup
        set is installed."""
        with self._lock:
            self._trace_seq = max(self._trace_seq, state.trace_seq)
            # mint task ids past every id an earlier boot handed out, so
            # a late ack's old id never names a fresh dispatch
            self._task_id = max(self._task_id, state.task_seq)
            self._done_traces = dict(state.done_traces)
            if state.epoch > self._epoch and self._training_shards:
                # the crash came in epoch E: regenerate exactly its set
                self._todo = [
                    t for t in self._todo if t.type != TaskType.TRAINING
                ]
                self._epoch = state.epoch
                self._create_tasks_locked(TaskType.TRAINING)
                logger.info("recovery: resuming training epoch %d",
                            self._epoch)
            dropped = 0
            kept = []
            for t in self._todo:
                if self._task_key(t) in state.done_keys:
                    dropped += 1
                else:
                    kept.append(t)
            self._todo = kept
            by_key = {
                p["key"]: (trace, p["attempt"], p.get("xc"))
                for trace, p in state.pending.items()
            }
            requeued = []
            for t in self._todo:
                k = self._task_key(t)
                if k in by_key:
                    trace, attempt, _ = by_key.pop(k)
                    t.extended_config["trace_id"] = trace
                    t.extended_config["_attempt"] = attempt + 1
                    self._trace_lookup[trace] = t
                    requeued.append((trace, attempt + 1, k))
            # pending tasks no regenerated key matches: an earlier
            # epoch's straggler or a SAVE_MODEL task. Rebuilt from their
            # keys, they requeue once too. Evaluation tasks are dropped:
            # their rounds pin versions a relaunch cannot honour, and the
            # evaluation service triggers new rounds.
            dropped_eval = set()
            for k, (trace, attempt, xc) in list(by_key.items()):
                del by_key[k]
                if k[0] == int(TaskType.EVALUATION):
                    logger.info(
                        "recovery: dropping in-flight evaluation task "
                        "(trace %s); the evaluation service re-triggers",
                        trace,
                    )
                    dropped_eval.add(trace)
                    continue
                task = Task(
                    shard_name=k[2],
                    start=k[3],
                    end=k[4],
                    type=TaskType(k[0]),
                    _epoch=k[1],
                    **(xc or {}),
                )
                task.extended_config["trace_id"] = trace
                task.extended_config["_attempt"] = attempt + 1
                self._todo.append(task)
                self._trace_lookup[trace] = task
                requeued.append((trace, attempt + 1, k))
            # a SAVE_MODEL task the dead boot minted (done or requeued)
            # must not be minted again by its deferred callback
            save = int(TaskType.SAVE_MODEL)
            saves_minted = sum(
                1 for k in state.done_keys if k[0] == save
            ) + sum(1 for t in self._todo if t.type == TaskType.SAVE_MODEL)
            for _ in range(
                min(saves_minted, len(self._tasks_done_deferred_callbacks))
            ):
                self._tasks_done_deferred_callbacks.pop()
            for trace, attempt, k in requeued:
                self._j("requeue", trace=trace, attempt=attempt,
                        key=list(k), recovery=True)
            unresolved = sorted(
                set(state.pending) - set(self._trace_lookup) - dropped_eval
            )
        if unresolved:
            logger.warning(
                "recovery: %d pending trace(s) matched no regenerated task "
                "(did records_per_task or the data arguments change across "
                "the relaunch?): %s",
                len(unresolved),
                unresolved[:8],
            )
        profiling.events.emit(
            "master_recovery",
            _ship=False,
            epoch=state.epoch,
            done_tasks=len(state.done_keys),
            requeued=len(requeued),
            deduped_counter=state.counters.get("deduped", 0),
        )
        logger.info(
            "recovery: epoch %d, %d done task(s) retired, %d in-flight "
            "task(s) requeued with their traces",
            state.epoch,
            dropped,
            len(requeued),
        )

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

    def job_done(self):
        """True once the job has nothing left: no task queued or in
        flight, no training epoch to roll over, and no deferred callback
        (the SAVE_MODEL task) still to invoke."""
        with self._lock:
            return (
                not self._todo and not self._eval_todo and not self._doing
                and not self._tasks_done_deferred_callbacks
                and not (self._training_shards and (
                    self._streaming or self._epoch < self._num_epochs - 1))
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
