"""Evaluation rounds on the master, the counterpart of
``elasticdl_tpu/master/evaluation_service.py``.

Workers report raw model outputs and labels for a round pinned to one
model version, and the master adds up the metrics (host numpy
accumulators, ``elasticdl_tpu_torch/metrics``), so training that races
ahead never mixes into a round. A round starts every ``eval_steps``
model versions (the step trigger, driven by the servicer as task reports
advance the version) or from a timer (:class:`PeriodicTrigger`, every
``throttle_secs``). An evaluation-only job has one round, unpinned
(version -1), over every evaluation task.

A coordinating master (an ALLREDUCE job's parameters live on the
worker) pins a version *number*, and the worker scores it with its own
state. A master that holds the model (the ParameterServerStrategy job)
pins an eval checkpoint of that model (``save_eval_checkpoint``); the
workers fetch it with ``get_model`` FIXED, and the round's checkpoint is
removed once the round is published. With a ``tensorboard_service``
(``--tensorboard_log_dir``) each published round's metrics are written
as TensorBoard scalars at the round's version.
"""

import threading
import time
from collections import deque

from elasticdl_tpu_torch.common.constants import MetricsDictKey, TaskType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.metrics import Metric, as_metric, to_host


class MetricsAccumulator:
    """Streaming metric aggregation over worker-reported batches.

    Accepts either ``{metric_name: metric}`` (single-output models, keyed
    under MetricsDictKey.MODEL_OUTPUT) or ``{output_name: {name: metric}}``
    and normalizes both into a flat triple list up front.
    """

    def __init__(self, metrics_spec):
        if not metrics_spec:
            raise ValueError(
                "Evaluation metrics dictionary must not be empty."
            )
        self.nested = isinstance(next(iter(metrics_spec.values())), dict)
        spec = (
            metrics_spec
            if self.nested
            else {MetricsDictKey.MODEL_OUTPUT: metrics_spec}
        )
        self._triples = []
        for output_key, metrics in spec.items():
            for name, metric in metrics.items():
                if not isinstance(metric, Metric):
                    metric = as_metric(name, metric)
                self._triples.append((output_key, name, metric))

    def update(self, model_outputs, labels):
        labels = to_host(labels)
        for output_key, _, metric in self._triples:
            outputs = model_outputs.get(output_key)
            if outputs is not None:
                metric.update_state(labels, to_host(outputs))

    def summary(self):
        if self.nested:
            out = {}
            for output_key, name, metric in self._triples:
                out.setdefault(output_key, {})[name] = metric.result()
            return out
        return {
            name: metric.result() for _, name, metric in self._triples
        }


class _EvaluationJob:
    """One round: a pinned version, its accumulator and a task
    countdown."""

    def __init__(self, metrics_dict, model_version, total_tasks=-1):
        self.model_version = model_version
        self._remaining = total_tasks
        self._acc = MetricsAccumulator(metrics_dict)
        self._report_lock = threading.Lock()
        self.published = False
        # the versions the scoring params were loaded from, where a
        # worker could not score the pinned version exactly (an
        # evaluation-only job scores a checkpoint's version): shown in
        # the published summary
        self.scored_versions = set()

    def complete_task(self):
        self._remaining -= 1

    def finished(self):
        return self._remaining <= 0

    def report_evaluation_metrics(
        self, version, model_outputs, labels, scored_version=None
    ):
        if self.model_version >= 0 and version != self.model_version:
            logger.error(
                "Drop a wrong version evaluation: request %d, receive %d"
                % (self.model_version, version)
            )
            return False
        # reports may come from several threads: the accumulators are
        # read-modify-write state
        with self._report_lock:
            self._acc.update(model_outputs, labels)
            if scored_version is not None and scored_version >= 0:
                self.scored_versions.add(int(scored_version))
        return True

    def get_evaluation_summary(self):
        return self._acc.summary()


class PeriodicTrigger:
    """Fire ``fn`` at most once per ``interval_secs``, starting after
    ``delay_secs``, polling every ``poll_secs``. ``stop`` ends the thread
    and waits for it."""

    def __init__(self, fn, delay_secs, interval_secs, poll_secs=5):
        self._fn = fn
        self._not_before = time.time() + delay_secs
        self._interval = interval_secs
        self._poll = poll_secs
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="edl-eval-trigger"
        )

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if (
            self._thread.is_alive()
            and self._thread is not threading.current_thread()
        ):
            self._thread.join()

    def _loop(self):
        last_fired = None
        while not self._stop.is_set():
            now = time.time()
            due = now >= self._not_before and (
                last_fired is None or now - last_fired >= self._interval
            )
            if due:
                self._fn()
                last_fired = now
            self._stop.wait(self._poll)


class EvaluationService:
    def __init__(
        self,
        checkpoint_service,
        tensorboard_service,
        task_d,
        start_delay_secs,
        throttle_secs,
        eval_steps,
        eval_only,
        eval_metrics_fn,
    ):
        """``checkpoint_service`` holds the eval checkpoints of a master
        that holds the model."""
        self._checkpoint_service = checkpoint_service
        self._tensorboard_service = tensorboard_service
        self._task_d = task_d
        self._eval_metrics_fn = eval_metrics_fn
        self._eval_steps = eval_steps
        self._eval_only = eval_only
        self._master_servicer = None

        self._lock = threading.Lock()
        self._round = None  # the running _EvaluationJob, if any
        self._pending_versions = deque()  # pinned, awaiting a round
        self._last_snapshot_version = -1
        # every published round, in order: {"version", "scored_versions",
        # "metrics"}
        self.published = []

        # None when time-based evaluation is off
        self.trigger = (
            PeriodicTrigger(
                lambda: self.add_evaluation_task(is_time_based_eval=True),
                start_delay_secs,
                throttle_secs,
            )
            if throttle_secs > 0 and not eval_only
            else None
        )

    def start(self):
        if self.trigger:
            self.trigger.start()

    def stop(self):
        if self.trigger:
            self.trigger.stop()

    def set_master_servicer(self, master_servicer):
        self._master_servicer = master_servicer

    # -- round creation ------------------------------------------------------

    def init_eval_only_job(self, num_task):
        self._round = _EvaluationJob(self._eval_metrics_fn(), -1, num_task)

    def add_evaluation_task_if_needed(self, master_locking):
        """The step trigger: a round every ``eval_steps`` versions.

        A coordinating master learns versions in jumps from the workers'
        task reports, so the trigger there is gap-based: an exact modulo
        could never hit."""
        version = self._master_servicer.get_model_version()
        if not self._eval_steps:
            return
        if getattr(self._master_servicer, "coordinates_only", False):
            # the gap is checked again under the master lock in
            # _snapshot_model_locked (min_gap): this unlocked read only
            # saves taking the lock on every report
            due = version - max(0, self._last_snapshot_version) >= (
                self._eval_steps
            )
            min_gap = self._eval_steps
        else:
            due = version % self._eval_steps == 0
            min_gap = 1
        if due:
            self.add_evaluation_task(
                is_time_based_eval=False,
                master_locking=master_locking,
                min_gap=min_gap,
            )

    def add_evaluation_task(
        self, is_time_based_eval, master_locking=True, min_gap=1
    ):
        """Pin the current model version and queue a round on it.

        The version guard and its update run under the master servicer's
        lock, so the timer thread and the step trigger cannot both pass
        the guard for one version and queue two rounds; the servicer's
        lock, not a second one, keeps one lock order between the two
        services."""
        if is_time_based_eval and self._task_d.finished():
            return
        if master_locking:
            with self._master_servicer.lock:
                queued = self._snapshot_model_locked(min_gap)
        else:
            queued = self._snapshot_model_locked(min_gap)
        if queued:
            self.try_to_create_new_job()

    def _snapshot_model_locked(self, min_gap=1):
        """Pin the version (master lock held). ``min_gap`` checks the
        step cadence again under the lock: concurrent task reports can
        both pass the unlocked check."""
        version = self._master_servicer.get_model_version()
        if (
            self._last_snapshot_version >= 0
            and version - self._last_snapshot_version < min_gap
        ):
            return False
        if getattr(self._master_servicer, "coordinates_only", False):
            snapshot = version
        else:
            snapshot = self._master_servicer.save_eval_checkpoint(
                locking=False
            )
            if snapshot is None:
                return False  # the write failed: nothing to evaluate
        with self._lock:
            self._pending_versions.append(snapshot)
        self._last_snapshot_version = snapshot
        return True

    def try_to_create_new_job(self):
        """Promote the oldest pending version to the running round."""
        with self._lock:
            if self._round is not None or not self._pending_versions:
                return False
            version = self._pending_versions.popleft()
            # publish the round before its tasks, so that a fast worker
            # never completes a task while no round exists; the task
            # count is taken before the tasks are queued (reading the
            # queue afterwards races concurrent get_eval_task calls)
            task_count = self._task_d.count_tasks(TaskType.EVALUATION)
            self._round = _EvaluationJob(
                self._eval_metrics_fn(), version, task_count
            )
            self._task_d.create_tasks(TaskType.EVALUATION, version)
            return True

    # -- worker-facing reporting --------------------------------------------

    def report_evaluation_metrics(
        self, version, model_outputs, labels, scored_version=None
    ):
        round_ = self._round
        if round_ is None:
            return False
        return round_.report_evaluation_metrics(
            version, model_outputs, labels, scored_version=scored_version
        )

    def complete_task(self):
        # the countdown is decremented under the lock, and exactly one
        # caller owns the finish (publishing and clearing the round)
        with self._lock:
            round_ = self._round
            if round_ is None:
                return
            round_.complete_task()
            if not round_.finished() or round_.published:
                return
            round_.published = True
            if not self._eval_only:
                self._round = None
        self._publish_summary(round_)
        if not self._eval_only:
            if not getattr(self._master_servicer, "coordinates_only", True):
                try:
                    self._checkpoint_service.remove_eval_checkpoint(
                        round_.model_version
                    )
                except OSError:
                    logger.warning(
                        "eval checkpoint v%d already gone",
                        round_.model_version,
                    )
            self.try_to_create_new_job()

    def _publish_summary(self, round_):
        metrics = round_.get_evaluation_summary()
        if self._tensorboard_service and metrics:
            self._tensorboard_service.write_dict_to_summary(
                metrics, version=round_.model_version
            )
        shown_version = (
            round_.model_version
            if round_.model_version >= 0
            else self._master_servicer.get_model_version()
        )
        self.published.append(
            {
                "version": shown_version,
                "scored_versions": sorted(round_.scored_versions),
                "metrics": metrics,
            }
        )
        skew = round_.scored_versions - {round_.model_version}
        if skew:
            logger.info(
                "Evaluation metrics[v=%d, scored from v=%s]: %s"
                % (shown_version, sorted(round_.scored_versions), metrics)
            )
        else:
            logger.info(
                "Evaluation metrics[v=%d]: %s" % (shown_version, metrics)
            )
