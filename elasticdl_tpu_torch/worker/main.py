"""A worker process, the counterpart of ``elasticdl_tpu/worker/main.py``:

    python -m elasticdl_tpu_torch.worker.main --worker_id N \\
        --job_type training_only --master_addr HOST:PORT \\
        --distribution_strategy AllreduceStrategy --device cuda ...

The master's instance manager starts it with the master's own flags
relayed (``common/args.build_arguments_from_parsed_result``). Under the
AllreduceStrategy it runs the elastic worker
(``worker/elastic_allreduce_worker.py``) against the master over the
socket transport, with SIGTERM draining it. A clean end announces the
leave to the membership before exiting 0, so the exit is not read as a
death; a drained worker exits hard with ``PREEMPTED_EXIT_CODE`` (75),
which the instance manager answers with a replacement.

Not ported, each raising ``NotImplementedError``: the parameter-server
worker (``--distribution_strategy ParameterServerStrategy``, ``--ps_addrs``)
and pre-warmed standby workers (``--standby``).
"""

import os
import sys

from elasticdl_tpu_torch.common.args import parse_worker_args
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str


def main(argv=None):
    args = parse_worker_args(argv)
    logger.setLevel(args.log_level)
    if args.distribution_strategy != "AllreduceStrategy" or args.ps_addrs:
        raise NotImplementedError(
            "the parameter-server worker is not ported yet (asked for by "
            "--distribution_strategy %s%s)"
            % (args.distribution_strategy,
               ", --ps_addrs" if args.ps_addrs else "")
        )
    if args.standby:
        raise NotImplementedError(
            "standby workers are not ported yet (asked for by --standby)"
        )
    from elasticdl_tpu_torch.master.rpc_service import MasterClient
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    stub = MasterClient(args.master_addr)
    worker = ElasticAllReduceWorker(
        worker_id=args.worker_id,
        job_type=args.job_type,
        minibatch_size=args.minibatch_size,
        model_zoo=args.model_zoo,
        model_def=args.model_def,
        model_params=args.model_params,
        dataset_fn=args.dataset_fn,
        loss=args.loss,
        optimizer=args.optimizer,
        eval_metrics_fn=args.eval_metrics_fn,
        stub=stub,
        data_reader_params=get_dict_from_params_str(args.data_reader_params),
        comm_host=args.comm_host or None,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        checkpoint_filename_for_init=args.checkpoint_filename_for_init,
        prediction_outputs_processor=args.prediction_outputs_processor,
        precision=args.precision_policy or None,
        accum_steps=args.grad_accum_steps,
        remat=args.remat,
        device=args.device,
    )
    worker.enable_drain_on_sigterm()
    worker.run()
    if worker.preempted:
        # hard exit: the drained world is being torn down by every
        # member at once, and the checkpoint writes already landed
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(ElasticAllReduceWorker.PREEMPTED_EXIT_CODE)
    # announce the clean end before exiting, so the membership leaves
    # this exit off the dead list
    try:
        stub.leave_comm_world(args.worker_id)
    except Exception:
        logger.debug("leave announcement missed", exc_info=True)
    stub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
