"""The ``train``, ``evaluate`` and ``predict`` entries of the port's
command line, the counterpart of ``elasticdl_tpu/api.py``'s local mode
for one process:

    python -m elasticdl_tpu_torch.cli train \\
        --distribution_strategy AllreduceStrategy --num_workers 0 \\
        --job_name J --model_zoo Z --model_def M --training_data D \\
        --minibatch_size B [--validation_data V --evaluation_steps N] \\
        [--device cuda|cpu] ...
    python -m elasticdl_tpu_torch.cli evaluate ... --validation_data V \\
        --checkpoint_dir C           # or --checkpoint_filename_for_init F
    python -m elasticdl_tpu_torch.cli predict ... --prediction_data P \\
        --checkpoint_filename_for_init F      # or --checkpoint_dir C

``train`` runs the master (task dispatcher, checkpoint service,
evaluation service, the coordinating servicer) and one
``AllReduceWorker`` in this process: ``Master(args)``, ``prepare()``, the
worker's ``run()``, then the master's ``run()``, which queues the
deferred SAVE_MODEL task and returns once every task is done. With
``--validation_data`` the worker scores an evaluation round between its
steps each time the version advances ``--evaluation_steps`` past the
last round. ``evaluate`` and ``predict`` run an evaluation-only or
prediction-only job: the same master, and the elastic worker's scoring
drain (``worker/elastic_allreduce_worker.py``) over a saved model. Both
need their data flag and a model source, or they exit 2
(``--checkpoint_dir`` counts only under AllreduceStrategy).

Every flag of the reference parses. Values this slice cannot honour
raise ``NotImplementedError``: ``--docker_image_repository`` (cluster
submission), and, through the master, the parameter-server strategy,
``--num_workers > 0``, ``--master_journal_dir``, ``--telemetry_port`` and
``--tensorboard_log_dir``.
"""

import sys

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str


class LocalJob:
    """One single-process ALLREDUCE job: ``master`` is built at once,
    ``worker`` by :meth:`run`, which returns the master's exit code and
    keeps the worker's losses in ``losses``."""

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

    def run(self):
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
