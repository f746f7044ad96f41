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
which the instance manager answers with a replacement. Every call to
the master goes through the failover channel with ``--master_failover_s``
of outage budget: a master that is relaunched within it is ridden out, a
master that stays away longer ends the worker with the channel's error.

With ``--standby true`` the process is a pre-warmed spare, its
``--worker_id`` a token: it imports the worker and the zoo module and,
where the device it will train on is known already (a card shared by
every worker, or one named by index), creates its CUDA context and loads
cuDNN and cuBLAS with one small convolution. Then it parks, polling the
master's ``standby_poll``, until a promotion names its worker id and
device; it then trains as that worker, and its timeline's ``standby``
event records what it warmed and how long it parked.

Under the ParameterServerStrategy (the default) and the Local strategy
it runs the parameter-server worker (``worker/worker.py``): against the
master-held model, or with ``--ps_addrs host:port,...`` against the PS
fleet through a ``PSClient`` over one ``BoundPS`` per shard
(``--rpc_deadline_s``, ``--rpc_retries``, ``--ps_fanout``,
``--ps_push_inflight``, ``--wire_dtype``). No world forms, so a
relaunched worker just asks for tasks. ``--standby`` has no effect there
and is logged, as the reference ignores it; ``--grad_accum_steps`` and
``--remat``, which the PS worker does not honor, draw a warning.
``--export_dir`` with ``--export_every_versions`` writes streaming
exports.

``--ps_shm`` (``auto`` by default) negotiates a shared-memory ring with
each co-located shard (``--ps_shm_slots`` x ``--ps_shm_slot_mb``), and
``--master_shm`` (``auto``) one with a co-located master for
``get_model``; cross-host, or on any failure to attach, the socket path
stays (``rpc/shm_transport.py``). The worker closes every channel at
exit, which unlinks its rings.

Telemetry (docs/observability.md): every span and postmortem of the
process names it ``worker-N``; ``EDL_FLIGHT_RECORDER_DIR`` arms the
flight recorder (a worker owns no durable directory of its own); the
worker ships a snapshot (its rates, input-plane counters, events and
spans) behind its task reports every ``--telemetry_report_secs``.
``EDL_PROFILE_DIR`` writes a ``torch.profiler`` Chrome trace there: of
the whole run for the parameter-server worker, of each world for the
elastic one (it starts once the world forms).
"""

import os
import sys
import time

from elasticdl_tpu_torch.common.args import (
    parse_worker_args,
    warn_accum_unsupported,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str


def main(argv=None):
    from elasticdl_tpu_torch.utils import profiling

    args = parse_worker_args(argv)
    logger.setLevel(args.log_level)
    profiling.spans.set_process("worker-%d" % args.worker_id)
    profiling.maybe_arm_flight_recorder()
    if args.distribution_strategy != "AllreduceStrategy":
        # the elastic worker traces each world itself, once it forms
        with profiling.maybe_profile():
            return _ps_main(args)
    from elasticdl_tpu_torch.master.rpc_service import MasterClient
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    stub = MasterClient(args.master_addr, failover_s=args.master_failover_s,
                        shm=args.master_shm)
    worker_id, device, standby = args.worker_id, args.device, None
    if args.standby:
        worker_id, device, standby = _park(stub, args)
        profiling.spans.set_process("worker-%d" % worker_id)
    worker = ElasticAllReduceWorker(
        worker_id=worker_id,
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
        replica_refresh_steps=args.replica_refresh_steps,
        task_prefetch=args.task_prefetch,
        device=device,
        telemetry_report_secs=args.telemetry_report_secs,
    )
    if standby is not None:
        worker.record_event("standby", **standby)
    worker.enable_drain_on_sigterm()
    worker.run()
    if worker.preempted:
        # hard exit: the drained world is being torn down by every
        # member at once, and the checkpoint writes already landed
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(ElasticAllReduceWorker.PREEMPTED_EXIT_CODE)
    # announce the clean end before exiting, so the membership leaves
    # this exit off the dead list; a master already gone is not waited
    # out for the whole failover budget
    try:
        stub.leave_comm_world(
            worker_id, budget_s=min(stub.outage_budget_s, 10.0)
        )
    except Exception:
        logger.debug("leave announcement missed", exc_info=True)
    stub.close()
    return 0


def make_ps_client(args):
    """The fleet's ``PSClient`` from ``--ps_addrs`` and its flags; None
    without shards."""
    from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient

    addrs = [a for a in args.ps_addrs.split(",") if a]
    if not addrs:
        return None
    deadline_s = args.rpc_deadline_s if args.rpc_deadline_s > 0 else None
    stubs = [
        BoundPS(a, deadline_s=deadline_s, retries=args.rpc_retries,
                shm=args.ps_shm, shm_slots=args.ps_shm_slots,
                shm_slot_mb=args.ps_shm_slot_mb)
        for a in addrs
    ]
    # the cache's staleness bound defaults to the SSP window the worker
    # already trains under between model pulls
    window = args.hot_row_staleness_window
    if window <= 0:
        window = args.get_model_steps
    return PSClient(
        stubs,
        wire_dtype=args.wire_dtype,
        hot_row_cache_rows=args.hot_row_cache_rows,
        staleness_window=window,
        fanout=args.ps_fanout,
        push_inflight=args.ps_push_inflight,
    )


def ps_worker(args, stub, ps_client):
    """The parameter-server worker of ``args`` over the master ``stub``
    and the fleet's ``ps_client`` (None: the master-held model)."""
    from elasticdl_tpu_torch.worker.worker import Worker

    return Worker(
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
        prediction_outputs_processor=args.prediction_outputs_processor,
        stub=stub,
        get_model_steps=args.get_model_steps,
        data_reader_params=get_dict_from_params_str(args.data_reader_params),
        precision=args.precision_policy or None,
        task_prefetch=args.task_prefetch,
        task_ack_queue=args.task_ack_queue,
        loss_log_steps=args.loss_log_steps,
        device=args.device,
        ps_client=ps_client,
        export_dir=args.export_dir,
        export_every_versions=args.export_every_versions,
        export_keep=args.export_keep,
        embedding_plane=args.embedding_plane,
        telemetry_report_secs=args.telemetry_report_secs,
    )


def master_client(args):
    """The worker's ``MasterClient``: ``--master_failover_s`` of outage
    budget, ``--wire_dtype`` and ``--master_shm``."""
    from elasticdl_tpu_torch.master.rpc_service import MasterClient

    return MasterClient(
        args.master_addr, failover_s=args.master_failover_s,
        wire_dtype=args.wire_dtype, shm=args.master_shm,
    )


def close_clients(stub, ps_client):
    """Settle the push window, then close every shard's channel and the
    master's (which unlinks their rings)."""
    try:
        if ps_client is not None:
            ps_client.close()
            for bound in ps_client.stubs:
                bound.close()
    finally:
        stub.close()


def _ps_main(args):
    """The parameter-server worker, on the master-held model or on the
    fleet. ``--standby`` has no effect here, as in the reference: a
    standby parks only on the elastic allreduce membership."""
    if args.standby:
        logger.info(
            "--standby has no effect under %s: standby workers park on "
            "the elastic allreduce membership; running as worker %d",
            args.distribution_strategy, args.worker_id,
        )
    warn_accum_unsupported(args, "the parameter-server worker")
    ps_client = make_ps_client(args)
    stub = master_client(args)
    try:
        ps_worker(args, stub, ps_client).run()
    finally:
        close_clients(stub, ps_client)
    return 0


def _warm(args):
    """What a standby can do before it knows its worker id: the imports
    (the zoo's, and torch's compile stack, which every torch optimizer's
    constructor imports on its first call: seconds that would otherwise
    fall inside the join) and, where its device is known already, the
    CUDA context with cuDNN and cuBLAS loaded. Returns the seconds of
    each step."""
    import torch

    from elasticdl_tpu_torch.common.model_utils import load_zoo_module

    t0 = time.perf_counter()
    load_zoo_module(args.model_def, args.model_zoo)
    warmed = {"zoo_s": time.perf_counter() - t0, "context_s": None}
    t0 = time.perf_counter()
    torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.0)
    warmed["optimizer_s"] = time.perf_counter() - t0
    device = torch.device(args.device)
    if device.type == "cuda" and (
        device.index is not None or torch.cuda.device_count() <= 1
    ):
        from elasticdl_tpu_torch.common.device import resolve_device

        t0 = time.perf_counter()
        dev = resolve_device(args.device)
        x = torch.ones(1, 3, 16, 16, device=dev)
        y = torch.nn.functional.conv2d(x, torch.ones(4, 3, 3, 3, device=dev))
        (y.flatten(1) @ y.flatten(1).T).sum().item()
        warmed["context_s"] = time.perf_counter() - t0
    return warmed


def _park(stub, args):
    """Warm, then poll ``standby_poll`` until the master promotes this
    standby; returns (worker id, device, the timeline's standby event).
    A master that stays away past the failover budget ends it."""
    token = args.worker_id
    warmed = _warm(args)
    logger.info("standby %d warmed (%s); parking", token, warmed)
    parked_at = time.time()
    while True:
        worker_id, device = stub.standby_poll(token)
        if worker_id is not None:
            break
        time.sleep(0.25)
    logger.info("standby %d promoted to worker %d on %s", token, worker_id,
                device or args.device)
    return int(worker_id), device or args.device, dict(
        token=token, warmed=warmed, parked_at=parked_at,
        promoted_at=time.time(),
    )


if __name__ == "__main__":
    sys.exit(main())
