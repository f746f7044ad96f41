"""The ``train`` entry of the port's command line, the counterpart of
``elasticdl_tpu/api.py``'s local mode for one process:

    python -m elasticdl_tpu_torch.cli train \\
        --distribution_strategy AllreduceStrategy --num_workers 0 \\
        --job_name J --model_zoo Z --model_def M --training_data D \\
        --minibatch_size B [--device cuda|cpu] ...

runs the master (task dispatcher, checkpoint service, the coordinating
servicer) and one ``AllReduceWorker`` in this process: ``Master(args)``,
``prepare()``, the worker's ``run()``, then the master's ``run()``, which
queues the deferred SAVE_MODEL task and returns once every task is done.

Every flag of the reference parses. Values this slice cannot honour
raise ``NotImplementedError``: ``--docker_image_repository`` (cluster
submission), and, through the master, the parameter-server strategy,
``--num_workers > 0``, ``--validation_data``/``--evaluation_steps``,
``--master_journal_dir`` and ``--telemetry_port``. The ``evaluate`` and
``predict`` subcommands (the elastic worker's checkpoint-scored serving
drain) are not ported yet either.
"""

import sys

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import JobType
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
        self.args = args
        self.master = Master(args)
        if self.master.job_type in (
            JobType.EVALUATION_ONLY,
            JobType.PREDICTION_ONLY,
        ):
            raise NotImplementedError(
                "%s jobs (the elastic worker's checkpoint-scored drain) "
                "are not ported yet" % self.master.job_type
            )
        self.worker = None
        self.losses = None

    def run(self):
        from elasticdl_tpu_torch.worker.allreduce_worker import (
            AllReduceWorker,
        )

        args = self.args
        self.master.prepare()
        try:
            self.worker = AllReduceWorker(
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
                accum_steps=args.grad_accum_steps,
                precision=args.precision_policy or None,
                remat=args.remat,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_steps=args.checkpoint_steps,
                keep_checkpoint_max=args.keep_checkpoint_max,
                device=args.device,
            )
            self.losses = self.worker.run()
        except BaseException:
            # the master would otherwise wait on the failed worker's
            # tasks: stop it, then surface the worker's error
            self.master.request_stop()
            self.master.run(poll_secs=0.2)
            raise
        return self.master.run(poll_secs=0.2)


def train(argv, jobs=None):
    """Parse ``argv`` and run the job; ``jobs``, a list, receives the
    :class:`LocalJob` (callers in this process read its outcome)."""
    args = parse_master_args(argv)
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


def _not_ported_subcommand(name):
    def run(argv, jobs=None):
        raise NotImplementedError(
            "edl %s (the elastic worker's checkpoint-scored drain) is not "
            "ported yet" % name
        )

    return run


_SUBCOMMANDS = {
    "train": train,
    "evaluate": _not_ported_subcommand("evaluate"),
    "predict": _not_ported_subcommand("predict"),
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
