"""The master of a job, the counterpart of
``elasticdl_tpu/master/master.py``: it builds the task dispatcher from the
data reader's shards, infers the job type from the data flags, keeps the
checkpoint service, the evaluation service (for a job with
``--validation_data`` or an evaluation trigger) and the servicer, queues
the deferred SAVE_MODEL task when ``--output`` is set, and polls
``finished()``.

Under the AllreduceStrategy the servicer coordinates and the membership
of the elastic plane forms the workers' worlds. Under the
ParameterServerStrategy with no PS pods (``--num_ps_pods 0``, which the
local mode forces) and under the Local strategy the master holds the
model: the servicer applies the zoo's optimizer (``--optimizer``) on
``--device``, keeps the elastic embedding tables, restores
``--checkpoint_filename_for_init`` and writes an eval checkpoint per
evaluation round; there is no membership. Under the
ParameterServerStrategy with ``--num_ps_pods`` > 0 the model lives on
the PS fleet (``ps/parameter_server.py``, dialed by the workers'
``--ps_addrs``): the master dispatches tasks and holds no model and no
optimizer, as the reference's does. Without membership, standby workers
(``--num_standby_workers``) have nothing to join and are not started,
and the hot-row cache (``--hot_row_cache_rows``) lives only in the
fleet's PS client: under the held model both flags are accepted and
logged as having no effect, as the reference runs.

With ``--master_journal_dir`` the dispatcher, the servicer's version
clock and the membership append to a write-ahead journal
(``master/journal.py``). ``prepare()`` replays it before the server
binds, so no call meets a half-restored ledger (``master_status``
reports ``state``, ``serving`` by then, the journal's counts and what
the replay restored): done tasks stay done, tasks in flight at the crash
requeue once under their traces, the version clock and the membership
epoch continue. Every boot mints a ``master_epoch``
(a counter in the journal directory) that stamps every reply.

``prepare()`` then starts the RPC server (``master/rpc_service.py`` over
the socket transport of ``rpc/socket_transport.py``, its model replies
narrowed by ``--wire_dtype``) on ``--port`` (0 or
unset: a port the OS picks, exposed as ``port``; a fixed port a killed
predecessor held is bound again), then the PS processes and workers of
the instance manager, if one is attached, and its standby workers
(``--num_standby_workers``). A single-process job's worker holds the
servicer directly and never dials it. ``run()`` polls until every task
is done, lingers so that remote workers learn there is no more work, and
``stop()`` ends the workers and the server. A process entry
(:func:`main`) drains on SIGTERM: the journal is flushed, then the
master stops and exits 75, which an external supervisor answers with a
relaunch.

The telemetry plane (``master/telemetry.py``, docs/observability.md):
a ``JobTelemetry`` always aggregates the workers' ``report_telemetry``
snapshots (their gauges, events and spans) with the live task-queue
depth; ``--telemetry_port`` serves ``/metrics``, ``/events``, ``/trace``
and ``/healthz`` (``restoring`` while the journal replays, then
``serving``); ``--telemetry_events_path`` appends every job event as a
JSON line; ``--tensorboard_log_dir`` writes the evaluation rounds'
metrics and, every 15 s, the registry's scalars as TensorBoard event
files; the flight recorder is armed at ``<master_journal_dir>/postmortem``
(or ``EDL_FLIGHT_RECORDER_DIR``). The speculative compile plane
(``--speculative_compile true``) raises ``NotImplementedError`` by name.

The RPC server always offers the shared-memory endpoint
(``rpc/shm_transport.py``): a co-located worker's ``MasterClient``
negotiates a ring and pulls ``get_model`` through it; every other call
passes the endpoint untouched. A stop reclaims every attached ring.
"""

import os
import threading
import time

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
from elasticdl_tpu_torch.master.telemetry import (
    JobTelemetry,
    TelemetryHTTPServer,
    TelemetryTBExporter,
)
from elasticdl_tpu_torch.master.tensorboard_service import TensorboardService
from elasticdl_tpu_torch.utils import profiling

# how long the master waits, after the last task, for its worker
# processes to exit on their own (their last checkpoint writes landing)
WORKER_EXIT_GRACE_S = 60


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


def master_holds_model(args):
    """True where the master holds the model: the ParameterServerStrategy
    with no PS pods, or the Local strategy."""
    strategy = getattr(args, "distribution_strategy", "")
    return (
        strategy == DistributionStrategy.PARAMETER_SERVER
        and getattr(args, "num_ps_pods", 0) <= 0
    ) or strategy == DistributionStrategy.LOCAL


def log_ignored_flags(args):
    """Log the flags that have no effect on this job, as the reference
    runs them: standbys without membership (every strategy but
    ALLREDUCE), the hot-row cache without a PS client (the held
    model)."""
    strategy = getattr(args, "distribution_strategy", "")
    if (
        strategy != DistributionStrategy.ALLREDUCE
        and getattr(args, "num_standby_workers", 0)
    ):
        logger.info(
            "--num_standby_workers %d has no effect under %s: standby "
            "workers join the elastic allreduce membership",
            args.num_standby_workers, strategy,
        )
    if master_holds_model(args) and getattr(args, "hot_row_cache_rows", 0):
        logger.info(
            "--hot_row_cache_rows %d has no effect on the master-held "
            "model: the cache lives in the PS fleet's client",
            args.hot_row_cache_rows,
        )


def refuse_unported_planes(args):
    """Raise for each flag that asks for a plane this master lacks."""
    strategy = getattr(args, "distribution_strategy", "")
    if strategy not in (
        DistributionStrategy.ALLREDUCE,
        DistributionStrategy.PARAMETER_SERVER,
        DistributionStrategy.LOCAL,
    ):
        raise _not_ported(
            "the %s strategy" % strategy, "--distribution_strategy"
        )
    if getattr(args, "speculative_compile", False):
        raise _not_ported(
            "the speculative compile plane (ROADMAP A9.2.2)",
            "--speculative_compile",
        )


def world_size_multiple(args):
    """The multiple every formed world rounds down to, the overflow
    members staying live as spares (the reference's derivation): a
    pipelined or tensor-parallel model needs worlds whose process count
    divides its stages or its ``model`` axis, from ``--model_params``
    (``pipeline_stages``, ``tensor_parallel`` and its solver floor
    ``min_tensor_parallel``), one device per worker process, and only
    with more than one worker; ``EDL_WORLD_SIZE_MULTIPLE`` overrides.
    A multiple larger than ``--num_workers`` (every world would round
    down to 0) raises ValueError."""
    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )

    stages = 0
    tp = 0
    try:
        mp = get_dict_from_params_str(
            getattr(args, "model_params", "") or ""
        ) or {}
        stages = int(mp.get("pipeline_stages", 0) or 0)
        tp = int(mp.get("tensor_parallel", 0) or 0)
        tp = max(tp, int(mp.get("min_tensor_parallel", 0) or 0))
    except (TypeError, ValueError):
        pass
    raw_workers = int(getattr(args, "num_workers", 0) or 0)
    need = max(stages, tp)
    multiple = need if need > 1 and raw_workers > 1 else 1
    env_multiple = os.environ.get("EDL_WORLD_SIZE_MULTIPLE")
    if env_multiple:
        multiple = max(1, int(env_multiple))
    num_workers = max(1, raw_workers)
    if multiple > num_workers:
        raise ValueError(
            "num_workers=%d cannot hold a world-size multiple "
            "of %d (pipeline_stages=%d / tensor_parallel=%d "
            "would round every world down to 0 processes). "
            "Raise num_workers, lower the parallelism degree, "
            "or — on multi-device hosts where it divides each "
            "worker's devices — set EDL_WORLD_SIZE_MULTIPLE "
            "to the true process multiple."
            % (num_workers, multiple, stages, tp)
        )
    return multiple


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
        log_ignored_flags(args)
        records_per_task = (
            args.minibatch_size * args.num_minibatches_per_task
        )
        from elasticdl_tpu_torch.master.journal import (
            MasterJournal,
            mint_master_epoch,
        )

        # the journal is replayed by prepare(), before the server serves
        journal_dir = getattr(args, "master_journal_dir", "") or ""
        self.journal = (
            MasterJournal(
                journal_dir,
                fsync_interval_s=float(
                    getattr(args, "master_journal_fsync_ms", 50)
                ) / 1000.0,
                segment_records=int(
                    getattr(args, "master_journal_segment_records", 4096)
                ),
            )
            if journal_dir
            else None
        )
        # this incarnation's boot id, stamped on every RPC reply
        self.master_epoch = mint_master_epoch(journal_dir or None)
        # the flight recorder's postmortems land next to the journal
        # (durable across the relaunch); EDL_FLIGHT_RECORDER_DIR
        # overrides for journal-less masters
        fr_dir = os.environ.get("EDL_FLIGHT_RECORDER_DIR") or (
            os.path.join(journal_dir, "postmortem") if journal_dir else ""
        )
        self._owns_flight_recorder = bool(fr_dir)
        if fr_dir:
            profiling.flight_recorder.arm(fr_dir)
        self._health = "restoring"
        self.task_d = _make_task_dispatcher(
            getattr(args, "training_data", ""),
            getattr(args, "validation_data", ""),
            getattr(args, "prediction_data", ""),
            records_per_task,
            args.num_epochs,
            get_dict_from_params_str(getattr(args, "data_reader_params", "")),
            journal=self.journal,
            streaming=bool(getattr(args, "streaming_tasks", False)),
        )
        self.holds_model = master_holds_model(args)
        # a master that holds the model pins each evaluation round to an
        # eval checkpoint of it
        self.checkpoint_service = CheckpointService(
            getattr(args, "checkpoint_dir", ""),
            getattr(args, "checkpoint_steps", 0),
            getattr(args, "keep_checkpoint_max", 0),
            self.holds_model and self.job_type != JobType.TRAINING_ONLY,
        )
        self.model_module = load_zoo_module(
            args.model_def, getattr(args, "model_zoo", "")
        )
        self.tb_service = self._create_tensorboard_service(args)
        self.evaluation_service = self._create_evaluation_service(args)
        if self.evaluation_service:
            self.task_d.set_evaluation_service(self.evaluation_service)
        if getattr(args, "output", "") and self._job_has_training():
            self.task_d.add_deferred_callback_create_save_model_task(
                args.output
            )
        optimizer = None
        if self.holds_model:
            optimizer = getattr(self.model_module, args.optimizer, None)
            if optimizer is None:
                raise ValueError(
                    "the model module of %s defines no %s"
                    % (args.model_def, args.optimizer)
                )
            optimizer = optimizer()
        # the job-wide telemetry plane: fleet aggregation is always on
        # (report cadence, not a hot path); the HTTP endpoint and the
        # JSONL sink are opt-in flags
        self.telemetry = JobTelemetry(task_dispatcher=self.task_d)
        events_path = getattr(args, "telemetry_events_path", "")
        self._owns_event_sink = bool(events_path)
        if events_path:
            profiling.events.attach_file(events_path)
        self._telemetry_http = None
        self._telemetry_tb = None
        self.telemetry_port = None
        self.master_servicer = MasterServicer(
            args.grads_to_wait,
            args.minibatch_size,
            optimizer,
            self.task_d,
            checkpoint_service=self.checkpoint_service,
            evaluation_service=self.evaluation_service,
            journal=self.journal,
            checkpoint_filename_for_init=(
                getattr(args, "checkpoint_filename_for_init", "")
                if self.holds_model
                else None
            ),
            lr_staleness_modulation=getattr(
                args, "lr_staleness_modulation", False
            ),
            use_async=getattr(args, "use_async", False),
            # the fleet's master holds no model and applies nothing
            coordinates_only=(
                getattr(args, "distribution_strategy", "")
                == DistributionStrategy.ALLREDUCE
            ),
            device=getattr(args, "device", "cuda"),
            telemetry=self.telemetry,
        )
        from elasticdl_tpu_torch.master.membership_service import (
            MembershipService,
        )

        # membership epochs of the elastic plane; the PS workers form no
        # world
        allreduce = (
            getattr(args, "distribution_strategy", "")
            == DistributionStrategy.ALLREDUCE
        )
        self.membership = None if not allreduce else MembershipService(
            expected_workers=max(1, getattr(args, "num_workers", 0)),
            base_port=getattr(args, "comm_base_port", 0),
            # a cold worker start can exceed the default grace on a
            # loaded host; a partial first world costs a re-form
            form_grace_secs=float(
                os.environ.get("EDL_FORM_GRACE_SECS", "30")
            ),
            world_size_multiple=world_size_multiple(args),
            journal=self.journal,
        )
        self.recovery = None  # what the journal's replay restored
        self.instance_manager = None
        self._server = None
        self._shm_registry = None
        self._rpc_service = None
        self.port = None
        self._stopped = False
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
            self.tb_service,
            self.task_d,
            getattr(args, "evaluation_start_delay_secs", 0),
            getattr(args, "evaluation_throttle_secs", 0),
            getattr(args, "evaluation_steps", 0),
            self.job_type == JobType.EVALUATION_ONLY,
            eval_metrics_fn,
        )

    @staticmethod
    def _create_tensorboard_service(args):
        logdir = getattr(args, "tensorboard_log_dir", "")
        if not logdir:
            return None
        service = TensorboardService(logdir)
        service.start()
        return service

    def _recover_from_journal(self):
        """Replay the journal and fast-forward the ledger, the version
        clock and the membership epoch, before the server serves."""
        if self.journal is None:
            return
        state = self.journal.replay()
        self.task_d.apply_recovery(state)
        self.master_servicer.restore_version(state.version)
        if state.member_epoch > 0 and self.membership is not None:
            self.membership.seed_epoch(state.member_epoch)
        self.recovery = {
            "replay_s": self.journal.replay_seconds,
            "records": self.journal.replayed_records,
            "epoch": state.epoch,
            "version": state.version,
            "member_epoch": state.member_epoch,
            "pending": len(state.pending),
        }
        # the boot is a compaction point: a fresh segment headed by the
        # post-recovery state, and the writer thread
        self.journal.start()

    def _master_status(self):
        status = {
            "state": self._health,
            "finished": self.task_d.finished(),
            "task_queues": self.task_d.queue_depths(),
        }
        if self.journal is not None:
            status["journal"] = self.journal.counts()
            status["recovery"] = self.recovery
        return status

    def prepare(self):
        """Replay the journal, then start the evaluation service's timer,
        the RPC server and the instance manager's workers. The telemetry
        endpoint binds first, so a probe reads ``restoring`` while the
        journal replays."""
        telemetry_port = getattr(self.args, "telemetry_port", None)
        if telemetry_port is not None and telemetry_port >= 0:
            self._telemetry_http = TelemetryHTTPServer(
                self.telemetry,
                port=telemetry_port,
                health_fn=lambda: self._health,
            )
            self.telemetry_port = self._telemetry_http.port
        self._recover_from_journal()
        if self.evaluation_service:
            self.evaluation_service.start()
        from elasticdl_tpu_torch.master.rpc_service import MasterRpcService
        from elasticdl_tpu_torch.rpc.shm_transport import install_shm_endpoint
        from elasticdl_tpu_torch.rpc.socket_transport import serve

        port = getattr(self.args, "port", None)
        self._rpc_service = MasterRpcService(
            self.master_servicer,
            membership=self.membership,
            master_epoch=self.master_epoch,
            status_fn=self._master_status,
            wire_dtype=getattr(self.args, "wire_dtype", ""),
        )
        methods, self._shm_registry = install_shm_endpoint(
            self._rpc_service.rpc_methods()
        )
        self._server = serve(methods, port if port else 0)
        self.port = self._server.port
        self._health = "serving"
        logger.info(
            "Master RPC server started on port %d (master_epoch %d, %s)",
            self.port,
            self.master_epoch,
            self.job_type,
        )
        logdir = getattr(self.args, "tensorboard_log_dir", "")
        if logdir:
            self._telemetry_tb = TelemetryTBExporter(
                logdir, step_fn=self.master_servicer.get_model_version
            )
        if self.instance_manager:
            self.instance_manager.start_all_ps()
            self.instance_manager.start_workers()

    def run(self, poll_secs=30):
        """Poll until all tasks are done, queuing the deferred SAVE_MODEL
        task when they are; then stop. Returns 0."""
        try:
            while not self._stop_requested.is_set():
                if self.task_d.finished():
                    if self.task_d.invoke_deferred_callback():
                        continue  # a SAVE_MODEL task was just queued
                    self._linger_for_pollers()
                    break
                self._stop_requested.wait(poll_secs)
        finally:
            self.stop()
        return 0

    def _linger_for_pollers(self):
        """Serve past the last report while remote workers may still
        poll: a worker learns "no more tasks" only from a get_task reply.
        The instance manager's workers are waited for (up to
        ``WORKER_EXIT_GRACE_S``), so that none is stopped while
        its last checkpoint writes land; other remote pollers get
        up to ``EDL_MASTER_EXIT_GRACE_S`` (3 s), ending early once every
        member has announced its leave (a PS job has no membership and
        lingers the whole grace). In-process jobs never dial the server
        and exit at once."""
        if self.instance_manager is not None:
            if not self.instance_manager.wait(timeout=WORKER_EXIT_GRACE_S):
                logger.warning(
                    "workers still running %.0fs after the last task; "
                    "stopping them",
                    WORKER_EXIT_GRACE_S,
                )
            return
        grace = float(os.environ.get("EDL_MASTER_EXIT_GRACE_S", "3"))
        if (
            grace > 0
            and self._rpc_service is not None
            and self._rpc_service.served_get_task
        ):
            deadline = time.monotonic() + grace
            while (
                (self.membership is None or self.membership.members())
                and time.monotonic() < deadline
                and not self._stop_requested.wait(0.1)
            ):
                pass

    def request_stop(self):
        self._stop_requested.set()
        self._stop_evaluation()

    def _stop_evaluation(self):
        if self.evaluation_service:
            self.evaluation_service.stop()

    def stop(self):
        """Stop the evaluation timer, the workers and the server; safe to
        call twice."""
        if self._stopped:
            return
        self._stopped = True
        self._stop_evaluation()
        if self.tb_service:
            self.tb_service.close()
        if self._telemetry_tb:
            self._telemetry_tb.close()
            self._telemetry_tb = None
        if self._telemetry_http:
            self._telemetry_http.close()
            self._telemetry_http = None
        self.telemetry.close()
        if self._owns_event_sink:
            # the EventLog is process-wide: a later in-process job must
            # not keep appending to this job's file
            profiling.events.close_file()
            self._owns_event_sink = False
        if self._owns_flight_recorder:
            # same hygiene: a later in-process job must not dump into
            # this job's directory
            profiling.flight_recorder.disarm()
            self._owns_flight_recorder = False
        if self.instance_manager:
            self.instance_manager.stop_relaunch_and_remove_all_pods()
        if self._server:
            self._server.stop()
            self._server = None
        if self._shm_registry is not None:
            # SIGKILLed workers' rings included: their atexit never ran
            self._shm_registry.close()
            self._shm_registry = None
        if self.journal is not None:
            # flushed and fsynced: a clean stop is a consistent replay
            self.journal.close()

    def install_drain_handler(self):
        """SIGTERM (a preemption notice) flushes the journal, stops the
        master and exits 75, the code an external supervisor relaunches
        without spending its crash budget. Installed only by the process
        entry."""
        import signal
        import sys

        def _drain(signum, frame):
            logger.warning("SIGTERM: draining the journal, then stopping")
            try:
                if self.journal is not None:
                    self.journal.flush()
            except Exception as err:  # noqa: BLE001 — exit regardless
                logger.error("journal drain failed: %s", err)
            self.stop()
            sys.exit(75)

        signal.signal(signal.SIGTERM, _drain)


def main(argv=None):
    """``python -m elasticdl_tpu_torch.master.main ...`` (or
    ``.master.master``): a master process for workers, and PS shards,
    started elsewhere (``--num_workers`` is then the membership's
    expected count; none are launched here)."""
    from elasticdl_tpu_torch.common.args import parse_master_args

    args = parse_master_args(argv)
    logger.setLevel(args.log_level)
    # name this process in every span id and postmortem header (entry
    # points only: in-process masters keep the owning process's tag)
    profiling.spans.set_process("master")
    master = Master(args)
    master.prepare()
    master.install_drain_handler()
    return master.run(
        poll_secs=float(os.environ.get("EDL_MASTER_POLL_SECS", "30"))
    )


if __name__ == "__main__":
    import sys

    sys.exit(main())
