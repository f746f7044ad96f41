"""The ``train``, ``evaluate`` and ``predict`` entries of the port's
command line, the counterpart of ``elasticdl_tpu/api.py``'s local mode:

    python -m elasticdl_tpu_torch.cli train \\
        --distribution_strategy AllreduceStrategy --num_workers 0 \\
        --job_name J --model_zoo Z --model_def M --training_data D \\
        --minibatch_size B [--validation_data V --evaluation_steps N] \\
        [--device cuda|cpu] ...
    python -m elasticdl_tpu_torch.cli evaluate ... --validation_data V \\
        --checkpoint_dir C           # or --checkpoint_filename_for_init F
    python -m elasticdl_tpu_torch.cli predict ... --prediction_data P \\
        --checkpoint_filename_for_init F      # or --checkpoint_dir C

Without ``--distribution_strategy`` (the ParameterServerStrategy, as in
the reference) or with ``Local``, the master holds the model: ``train``
with ``--num_workers 0`` runs it and one parameter-server worker
(``worker/worker.py``) in this process, and with ``--num_workers N`` the
master serves N worker processes over the socket plane; ``evaluate`` and
``predict`` score the model the master restores from
``--checkpoint_filename_for_init``. The local mode launches no PS pods
(``--num_ps_pods`` is set to 0, as in the reference).

Under the AllreduceStrategy, ``train`` with ``--num_workers 0`` runs the
master (task dispatcher, checkpoint service, evaluation service, the
coordinating servicer) and one ``AllReduceWorker`` in this process:
``Master(args)``, ``prepare()``, the worker's ``run()``, then the
master's ``run()``, which queues the deferred SAVE_MODEL task and
returns once every task is done. With
``--num_workers N > 0`` the master serves its RPC plane and a
``LocalInstanceManager`` starts N worker processes (``python -m
elasticdl_tpu_torch.worker.main``, the master's flags relayed, the
device included), watches them, relaunches crashed ones and hands their
tasks back; the elastic workers train in one process world that
re-forms at every membership change; ``--num_standby_workers K`` keeps
K more started and parked, each promoted in place of a dead worker. With
``--validation_data`` the worker scores an evaluation round between its
steps each time the version advances ``--evaluation_steps`` past the
last round. ``evaluate`` and ``predict`` run an evaluation-only or
prediction-only job: the same master, and the elastic worker's scoring
drain (``worker/elastic_allreduce_worker.py``) over a saved model. Both
need their data flag and a model source, or they exit 2
(``--checkpoint_dir`` counts only under AllreduceStrategy).

Every flag of the reference parses. Values the port cannot honour yet
raise ``NotImplementedError``: ``--docker_image_repository`` (cluster
submission), and, through the master, ``--speculative_compile true``
(``master.refuse_unported_planes``). ``--telemetry_port``,
``--telemetry_events_path`` and ``--tensorboard_log_dir`` run the
master's telemetry plane (``master/telemetry.py``).
"""

import os
import sys

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str


class LocalJob:
    """One job on this host: ``master`` is built at once, the in-process
    ``worker`` (with ``--num_workers 0``) by :meth:`run`, which returns
    the master's exit code and keeps the worker's losses in ``losses``."""

    def __init__(self, args):
        from elasticdl_tpu_torch.master.master import Master

        if getattr(args, "num_ps_pods", 0) > 0:
            # the reference's local mode launches no PS fleet either
            logger.info(
                "local mode ignores --num_ps_pods=%d", args.num_ps_pods
            )
            args.num_ps_pods = 0
        resolve_device(args.device)
        self.args = args
        self.master = Master(args)
        self.worker = None
        self.losses = None

    def _make_worker(self):
        args = self.args
        common = dict(
            worker_id=0,
            job_type=self.master.job_type,
            minibatch_size=args.minibatch_size,
            model_zoo=args.model_zoo,
            model_def=args.model_def,
            model_params=args.model_params,
            dataset_fn=args.dataset_fn,
            loss=args.loss,
            optimizer=args.optimizer,
            eval_metrics_fn=args.eval_metrics_fn,
            stub=self.master.master_servicer,
            data_reader_params=get_dict_from_params_str(
                args.data_reader_params
            ),
            device=args.device,
        )
        if self.master.holds_model:
            from elasticdl_tpu_torch.common.args import (
                warn_accum_unsupported,
            )
            from elasticdl_tpu_torch.worker.worker import Worker

            warn_accum_unsupported(args, "the in-process PS worker")
            return Worker(
                get_model_steps=args.get_model_steps,
                precision=args.precision_policy or None,
                prediction_outputs_processor=args.prediction_outputs_processor,
                task_prefetch=args.task_prefetch,
                task_ack_queue=args.task_ack_queue,
                loss_log_steps=args.loss_log_steps,
                export_dir=args.export_dir,
                export_every_versions=args.export_every_versions,
                export_keep=args.export_keep,
                telemetry_report_secs=args.telemetry_report_secs,
                **common,
            )
        if self.master.job_type in (
            JobType.EVALUATION_ONLY,
            JobType.PREDICTION_ONLY,
        ):
            # nothing to train: the elastic worker's drain scores the
            # saved model
            from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
                ElasticAllReduceWorker,
            )

            return ElasticAllReduceWorker(
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_filename_for_init=args.checkpoint_filename_for_init,
                prediction_outputs_processor=args.prediction_outputs_processor,
                **common,
            )
        from elasticdl_tpu_torch.worker.allreduce_worker import (
            AllReduceWorker,
        )

        return AllReduceWorker(
            accum_steps=args.grad_accum_steps,
            precision=args.precision_policy or None,
            remat=args.remat,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_steps=args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
            **common,
        )

    def _worker_command(self, worker_id, device):
        from elasticdl_tpu_torch.common.args import (
            build_arguments_from_parsed_result,
        )

        return [
            sys.executable,
            "-m",
            "elasticdl_tpu_torch.worker.main",
            "--worker_id",
            str(worker_id),
            "--job_type",
            self.master.job_type,
            "--master_addr",
            "localhost:%d" % self.master.port,
            "--device",
            device,
        ] + build_arguments_from_parsed_result(
            self.args,
            filter_args={
                "port",
                "num_workers",
                "training_data",
                "validation_data",
                "prediction_data",
                "job_name",
                "device",
            },
        )

    def _run_workers(self):
        """The multi-process job: the master serves, N worker processes
        train; returns the master's exit code once every task is done."""
        from elasticdl_tpu_torch.master.local_instance_manager import (
            LocalInstanceManager,
        )
        from elasticdl_tpu_torch.parallel.distributed import worker_devices

        env = dict(os.environ)
        root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        # the workers share this host: the coordinator address they
        # advertise must be one the siblings can dial
        env.setdefault("EDL_COMM_HOST", "localhost")
        self.master.instance_manager = LocalInstanceManager(
            self.master.task_d,
            self.args.num_workers,
            self._worker_command,
            worker_devices(self.args.device, self.args.num_workers),
            restart_policy=self.args.restart_policy,
            env=env,
            membership=self.master.membership,
            num_standby=self.args.num_standby_workers,
        )
        self.master.prepare()
        return self.master.run(poll_secs=1)

    def run(self):
        if self.args.num_workers > 0:
            return self._run_workers()
        self.master.prepare()
        try:
            self.worker = self._make_worker()
            self.losses = self.worker.run()
        except BaseException:
            # the master would otherwise wait on the failed worker's
            # tasks: stop it, then surface the worker's error
            self.master.request_stop()
            self.master.run(poll_secs=0.2)
            raise
        return self.master.run(poll_secs=0.2)


def _run_job(args, jobs):
    logger.setLevel(args.log_level)
    if getattr(args, "docker_image_repository", ""):
        raise NotImplementedError(
            "cluster submission (--docker_image_repository) is not ported "
            "yet; leave it empty to run the job here"
        )
    job = LocalJob(args)
    if jobs is not None:
        jobs.append(job)
    return job.run()


def train(argv, jobs=None):
    """Parse ``argv`` and run the job; ``jobs``, a list, receives the
    :class:`LocalJob` (callers in this process read its outcome)."""
    return _run_job(parse_master_args(argv), jobs)


def _has_flag(argv, flag):
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def _flag_value(argv, flag):
    for i, a in enumerate(argv):
        if a == flag:
            return argv[i + 1] if i + 1 < len(argv) else None
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _serving_job(argv, jobs, verb, data_flag):
    """The gate and launch of a scoring-only job (evaluate / predict): it
    needs its data flag and a model source, a checkpoint file or, under
    AllreduceStrategy only (whose workers read sharded checkpoints),
    ``--checkpoint_dir``; else exit code 2. The master checks the model
    source again."""
    if not _has_flag(argv, data_flag):
        print("edl %s requires %s" % (verb, data_flag), file=sys.stderr)
        return 2
    allreduce = _flag_value(argv, "--distribution_strategy") == (
        "AllreduceStrategy"
    )
    if not (
        _has_flag(argv, "--checkpoint_filename_for_init")
        or (allreduce and _has_flag(argv, "--checkpoint_dir"))
    ):
        print(
            "edl %s requires --checkpoint_filename_for_init "
            "(or, under AllreduceStrategy, --checkpoint_dir with "
            "sharded checkpoints)" % verb,
            file=sys.stderr,
        )
        return 2
    argv = list(argv)
    if not _has_flag(argv, "--training_data"):
        argv += ["--training_data", ""]
    return _run_job(parse_master_args(argv), jobs)


def evaluate(argv, jobs=None):
    """An evaluation-only job."""
    return _serving_job(argv, jobs, "evaluate", "--validation_data")


def predict(argv, jobs=None):
    """A prediction-only job."""
    return _serving_job(argv, jobs, "predict", "--prediction_data")


_SUBCOMMANDS = {
    "train": train,
    "evaluate": evaluate,
    "predict": predict,
}


def cli_main(argv, jobs=None):
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: edl {train|evaluate|predict} [flags]", file=sys.stderr)
        return 0 if argv else 2
    fn = _SUBCOMMANDS.get(argv[0])
    if fn is None:
        print("unknown subcommand %r" % argv[0], file=sys.stderr)
        return 2
    return fn(argv[1:], jobs=jobs)
