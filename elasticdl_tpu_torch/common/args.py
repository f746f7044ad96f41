"""Command-line arguments of the port, from ``elasticdl_tpu/common/args.py``:

- ``parse_scorer_args``: the scorer process's subset, plus ``--device``;
- ``parse_master_args``: the master's (and the local job's) full flag
  set, copied from the reference, plus ``--device``, with the
  reference's cross-flag validation;
- ``parse_worker_args``: a worker process's flags, plus ``--device``;
  the master relays its own parsed flags to each worker it launches
  through ``build_arguments_from_parsed_result``.

Flags of planes not ported yet still parse, so one argv serves both
packages; the entry points raise when a flag asks for a missing plane
(:func:`~elasticdl_tpu_torch.serving.main.build_scorer`,
:func:`~elasticdl_tpu_torch.api.train`). Unknown flags are ignored, as in
the reference.
"""

import argparse

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


def non_neg_int(value):
    ivalue = int(value)
    if ivalue < 0:
        raise argparse.ArgumentTypeError(
            "%s is not a non-negative integer" % value
        )
    return ivalue


def pos_int(value):
    ivalue = int(value)
    if ivalue <= 0:
        raise argparse.ArgumentTypeError(
            "%s is not a positive integer" % value
        )
    return ivalue


def warn_accum_unsupported(args, plane="this training plane"):
    """Warn when ``--grad_accum_steps`` or ``--remat`` is set on a plane
    that ignores it: only the ALLREDUCE trainers accumulate gradients
    and rematerialize (``training/step.make_train_step``), the
    parameter-server worker runs without either, and silence would let a
    user believe their activation memory was bounded."""
    if getattr(args, "grad_accum_steps", 1) > 1:
        logger.warning(
            "--grad_accum_steps=%d is only honored by the ALLREDUCE "
            "strategy (single- and multi-process); %s runs WITHOUT "
            "gradient accumulation",
            args.grad_accum_steps,
            plane,
        )
    if getattr(args, "remat", ""):
        logger.warning(
            "--remat=%s is only honored by the ALLREDUCE strategy; %s "
            "runs WITHOUT activation rematerialization (memory will "
            "NOT be bounded as requested)",
            args.remat,
            plane,
        )


def parse_scorer_args(scorer_args=None):
    """One scorer pod: answers ``score`` from the newest export artifact
    under ``--export_dir`` on ``--device``."""
    parser = argparse.ArgumentParser(
        description="ElasticDL scorer (PyTorch/CUDA)"
    )
    parser.add_argument("--scorer_id", type=int, default=0)
    parser.add_argument(
        "--export_dir",
        required=True,
        help="Export root the trainer writes versioned artifacts under; "
        "the scorer watches it and hot-swaps to the newest MANIFEST.json",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device to score on: 'cuda' (the default; raises without a "
        "card) or 'cpu'",
    )
    parser.add_argument(
        "--ps_addrs",
        default="",
        help="Comma-separated PS shard addresses serving the model's "
        "PS-resident embedding tables (empty for a dense model)",
    )
    parser.add_argument(
        "--port",
        type=non_neg_int,
        default=0,
        help="Scorer RPC port (0 binds ephemeral)",
    )
    parser.add_argument(
        "--scorer_transport",
        default="grpc",
        choices=["grpc", "socket"],
        help="The scorer's RPC wire: gRPC, the reference's, or the port's "
        "socket transport (the same frames) for a host without grpcio",
    )
    parser.add_argument(
        "--scorer_telemetry_port",
        type=int,
        default=-1,
        help="Serve this scorer's /metrics + /healthz + /events + "
        "/trace on this port (0 = ephemeral, -1 disables): the "
        "request-latency histogram, the batcher's families and the "
        "cache hit rate (docs/serving.md)",
    )
    parser.add_argument(
        "--serving_staleness_versions",
        type=pos_int,
        default=2,
        help="Freshness bound: a served embedding row is never more than "
        "this many shard versions behind the newest version this scorer "
        "has seen (the hot-row cache's window, kept cheap by the delta "
        "sync)",
    )
    parser.add_argument(
        "--serving_sync_interval_s",
        type=float,
        default=0.5,
        help="Delta-sync poll cadence against each PS shard's "
        "serving_status; doubles, up to 8 s, while no shard answers",
    )
    parser.add_argument(
        "--hot_row_cache_rows",
        type=pos_int,
        default=65536,
        help="Read-through hot-row cache capacity (rows), shared by the "
        "request path and the delta sync",
    )
    parser.add_argument(
        "--watch_interval_s",
        type=float,
        default=1.0,
        help="Export-directory poll cadence for new model versions",
    )
    parser.add_argument(
        "--serve_max_batch",
        type=non_neg_int,
        default=64,
        help="Micro-batching row budget: concurrent score requests "
        "coalesce into one forward against power-of-two buckets up to "
        "this; 0 or 1 scores every request inline",
    )
    parser.add_argument(
        "--serve_batch_timeout_ms",
        type=float,
        default=2.0,
        help="A coalesced batch dispatches at a full bucket or this many "
        "ms after its oldest request enqueued, whichever is first",
    )
    parser.add_argument(
        "--serve_p99_slo_ms",
        type=float,
        default=0.0,
        help="Shed ({'error': 'overloaded'}) when the predicted queue "
        "wait exceeds this; 0 disables",
    )
    parser.add_argument(
        "--serve_queue_rows",
        type=non_neg_int,
        default=0,
        help="Hard cap on queued rows before shedding queue_full "
        "(0 -> 8 x --serve_max_batch)",
    )
    parser.add_argument(
        "--model_zoo",
        default="",
        help="Directory to load the artifact's model_def module from; "
        "empty resolves it against the port's own zoo",
    )
    parser.add_argument(
        "--rpc_deadline_s",
        type=float,
        default=20.0,
        help="Deadline of each PS call on the scorer's pull path "
        "(0 disables)",
    )
    parser.add_argument(
        "--rpc_retries",
        type=non_neg_int,
        default=3,
        help="Bounded UNAVAILABLE resends (doubling backoff) of the "
        "scorer's idempotent PS reads",
    )
    parser.add_argument(
        "--ps_shm",
        default="auto",
        choices=["auto", "on", "off"],
        help="Shared-memory payload transport toward co-located PS "
        "shards (rpc/shm_transport.py), same negotiation and fallback as "
        "the worker's flag",
    )
    parser.add_argument(
        "--log_level",
        default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
    )
    args, _unknown = parser.parse_known_args(args=scorer_args)
    return args


# -- the master's flags, as the reference defines them --------------------


def add_bool_param(parser, name, default, help):
    parser.add_argument(
        name,
        nargs="?",
        const=not default,
        default=default,
        type=lambda x: x.lower() in ["true", "yes", "t", "y"],
        help=help,
    )


def add_common_params(parser):
    """Client-common params (reference args.py:100-209)."""
    add_common_args_between_master_and_worker(parser)
    parser.add_argument(
        "--docker_image_repository",
        default="",
        help="Image repository for the job images",
    )
    parser.add_argument("--image_base", default="", help="Base docker image")
    parser.add_argument("--job_name", help="Job name", required=True)
    parser.add_argument(
        "--master_resource_request",
        default="cpu=0.1,memory=1024Mi",
        help="Master resource request",
    )
    parser.add_argument(
        "--master_resource_limit",
        default="",
        help="Master resource limit; defaults to the request",
    )
    parser.add_argument(
        "--num_workers", type=int, default=0, help="Number of workers"
    )
    parser.add_argument(
        "--num_standby_workers",
        type=non_neg_int,
        default=0,
        help="Pre-warmed spare workers (elastic allreduce): parked "
        "after paying their cold start, promoted on a death so "
        "recovery is membership-only",
    )
    parser.add_argument(
        "--worker_resource_request",
        default="cpu=1,memory=4096Mi",
        help="Worker resource request (a TPU worker requests tpu=N here)",
    )
    parser.add_argument(
        "--worker_resource_limit", default="", help="Worker resource limit"
    )
    parser.add_argument(
        "--master_pod_priority", default="", help="Master pod priority"
    )
    parser.add_argument(
        "--worker_pod_priority", default="", help="Worker pod priority"
    )
    parser.add_argument(
        "--volume",
        default="",
        help='Volume spec, e.g. "claim_name=c1,mount_path=/path1"',
    )
    parser.add_argument(
        "--image_pull_policy",
        default="Always",
        help="Image pull policy of the job pods",
    )
    parser.add_argument(
        "--restart_policy", default="Never", help="Pod restart policy"
    )
    parser.add_argument(
        "--envs",
        default="",
        help="Env vars for the job pods, e.g. 'a=b,c=d'",
    )
    parser.add_argument(
        "--extra_pypi_index", default="", help="Extra pypi index url"
    )
    parser.add_argument(
        "--namespace",
        default="default",
        help="Kubernetes namespace for the job pods",
    )
    parser.add_argument(
        "--num_minibatches_per_task",
        type=pos_int,
        default=2,
        help="Number of minibatches per task",
    )
    parser.add_argument(
        "--cluster_spec",
        default="",
        help="Python module rewriting pod/service specs for private clouds",
    )
    parser.add_argument("--docker_base_url", default="unix://var/run/docker.sock")
    parser.add_argument("--docker_tlscert", default="")
    parser.add_argument("--docker_tlskey", default="")
    parser.add_argument(
        "--num_ps_pods", type=int, default=1, help="Number of PS pods"
    )
    parser.add_argument(
        "--ps_resource_request",
        default="cpu=1,memory=4096Mi",
        help="PS resource request",
    )
    parser.add_argument(
        "--ps_resource_limit", default="", help="PS resource limit"
    )
    parser.add_argument("--ps_pod_priority", default="")


def add_train_params(parser):
    """Training params (reference args.py:212-330)."""
    parser.add_argument(
        "--tensorboard_log_dir",
        default="",
        help="Directory for scalar summaries",
    )
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument(
        "--grads_to_wait",
        type=pos_int,
        default=1,
        help="Gradients to accumulate before a sync update",
    )
    parser.add_argument("--training_data", default="", required=True)
    parser.add_argument("--validation_data", default="")
    parser.add_argument(
        "--evaluation_steps",
        type=non_neg_int,
        default=0,
        help="Evaluate every this many model versions",
    )
    parser.add_argument(
        "--evaluation_start_delay_secs", type=non_neg_int, default=100
    )
    parser.add_argument(
        "--evaluation_throttle_secs", type=non_neg_int, default=0
    )
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument(
        "--keep_checkpoint_max", type=non_neg_int, default=0
    )
    parser.add_argument(
        "--replica_refresh_steps",
        type=non_neg_int,
        default=8,
        help="Sharded elastic jobs: refresh the in-HBM replica of each "
        "rank's table shards every this many versions (bounded-"
        "staleness no-disk recovery); 0 disables the replica plane",
    )
    parser.add_argument("--checkpoint_filename_for_init", default="")
    parser.add_argument(
        "--output", default="", help="Trained-model export path"
    )
    add_bool_param(
        parser,
        "--streaming_tasks",
        False,
        "Treat the training data as an unbounded stream: the task "
        "dispatcher rolls a fresh epoch over the shards whenever the "
        "todo queue drains, ignoring --num_epochs, until the job is "
        "stopped — the train half of the train->export->serve loop "
        "(docs/serving.md)",
    )
    add_bool_param(
        parser,
        "--use_async",
        False,
        "Apply gradients asynchronously (host-PS mode only; the ALLREDUCE "
        "strategy is always synchronous in-step)",
    )
    add_bool_param(
        parser,
        "--lr_staleness_modulation",
        False,
        "Modulate learning rate by 1/staleness in async mode",
    )
    # accepted by the master too so the k8s instance manager's argv
    # relay carries the durability config to every PS pod
    add_ps_snapshot_params(parser)


def add_ps_snapshot_params(parser):
    """PS shard durability flags (docs/ps_recovery.md); shared by the
    PS entry and the master (which relays them to PS pods)."""
    parser.add_argument(
        "--ps_snapshot_versions",
        type=non_neg_int,
        default=0,
        help="Durability cadence (docs/ps_recovery.md): snapshot each "
        "PS shard's dense params + embedding/slot tables every N "
        "optimizer versions, off the apply path, and restore the "
        "newest valid snapshot at (re)boot. 0 (default) disables; "
        "requires --ps_snapshot_dir. A crash rolls the shard back at "
        "most N versions instead of to step-0 init",
    )
    parser.add_argument(
        "--ps_snapshot_dir",
        default="",
        help="Base directory for per-shard snapshot state (the shard "
        "writes under <dir>/ps-<id>/). Must survive the pod relaunch "
        "(a persistent volume on k8s; any local path for the "
        "single-host instance manager)",
    )
    parser.add_argument(
        "--ps_snapshot_keep",
        type=pos_int,
        default=2,
        help="Snapshot ring retention: keep this many published "
        "versions; older ones are evicted only after a newer one "
        "published",
    )
    parser.add_argument(
        "--ps_warm_rows",
        type=non_neg_int,
        default=0,
        help="Tiered store (docs/tiered_store.md): per-table warm-tier "
        "row budget on each PS shard. Rows past the budget spill to "
        "disk segments (coldest first, recently-applied rows pinned) "
        "and promote back on demand, so a table can be far larger "
        "than the shard's memory tier. 0 (default) disables; requires "
        "--ps_spill_dir. Composes with --ps_device (the tier wraps "
        "the arena) and with snapshots (a spill segment IS a snapshot "
        "shard; snapshot/restore round-trips across tier configs)",
    )
    parser.add_argument(
        "--ps_spill_dir",
        default="",
        help="Base directory for tiered-store spill segments (the "
        "shard writes under <dir>/ps-<id>/<table>/). Needs only "
        "shard-lifetime durability — segments are re-attached on "
        "relaunch when present, and a cadence-snapshot restore "
        "supersedes them",
    )
    parser.add_argument(
        "--ps_telemetry_port",
        type=int,
        default=-1,
        help="Serve each PS shard's own metric registry (RPC service "
        "histograms under role=ps, edl_ps_snapshot_age_seconds, ...) "
        "plus /events, /trace, and /healthz at this port — parity "
        "with the master's TelemetryHTTPServer (docs/observability.md)"
        ". 0 = ephemeral (exposed as ParameterServer."
        "ps_telemetry_port); -1 (default) disables. Distinct from the "
        "master's --telemetry_port on purpose: the master relays its "
        "own flags to PS pods, and a shared name would make every "
        "co-located shard fight the master for one port",
    )


def add_common_args_between_master_and_worker(parser):
    """Shared master/worker params (reference args.py:418-500)."""
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument(
        "--log_level",
        default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
    )
    parser.add_argument("--dataset_fn", default="dataset_fn")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument("--model_def", required=True)
    parser.add_argument("--model_params", default="")
    parser.add_argument(
        "--get_model_steps",
        type=pos_int,
        default=1,
        help="Pull the model every this many steps (SSP local updates)",
    )
    parser.add_argument("--data_reader_params", default="")
    parser.add_argument(
        "--distribution_strategy",
        default="ParameterServerStrategy",
        choices=["ParameterServerStrategy", "AllreduceStrategy", "Local"],
        help="ParameterServerStrategy keeps the reference's host-PS "
        "semantics; AllreduceStrategy is the TPU-native in-step XLA "
        "collective path",
    )
    parser.add_argument(
        "--grad_accum_steps",
        type=pos_int,
        default=1,
        help="Gradient accumulation: split each minibatch into this "
        "many microbatches inside the jitted step (activation memory "
        "drops to one microbatch; one optimizer update per minibatch)",
    )
    parser.add_argument(
        "--remat",
        default="",
        help="Activation rematerialization on the ALLREDUCE planes: "
        "'full' (jax.checkpoint the whole forward) or a "
        "jax.checkpoint_policies name (e.g. "
        "dots_with_no_batch_dims_saveable); trades recompute FLOPs for "
        "HBM so deeper models / longer sequences fit per chip",
    )
    parser.add_argument(
        "--precision_policy",
        default="",
        choices=["", "float32", "mixed_bfloat16", "bfloat16"],
        help="Mixed-precision policy for the train step (default: the "
        "model's own dtype behavior; mixed_bfloat16 = f32 master "
        "weights, bf16 compute — the standard TPU recipe)",
    )
    parser.add_argument(
        "--wire_dtype",
        default="",
        choices=["", "bfloat16"],
        help="Compress f32 model pulls and gradient pushes to this "
        "dtype on the wire (PS-mode hot path); receivers upcast back "
        "to f32 before any optimizer math",
    )
    parser.add_argument(
        "--export_dir",
        default="",
        help="Streaming serving exports (docs/serving.md): the worker "
        "writes a complete export artifact (common/export.py, "
        "MANIFEST.json last) under this directory every "
        "--export_every_versions model versions, for the scorer "
        "fleet's ModelDirectoryWatcher to hot-swap in. Distinct from "
        "--output, the end-of-job SAVE_MODEL export",
    )
    parser.add_argument(
        "--export_every_versions",
        type=non_neg_int,
        default=0,
        help="Export the dense graph every this many model versions "
        "when --export_dir is set; 0 disables the cadence",
    )
    parser.add_argument(
        "--export_keep",
        type=pos_int,
        default=4,
        help="Versioned export artifacts to retain under --export_dir "
        "(oldest pruned after each export; scorers mid-load of a "
        "pruned artifact retry on the next watcher poll)",
    )
    parser.add_argument(
        "--hot_row_cache_rows",
        type=int,
        default=0,
        help="PS mode: keep an LRU of this many recently pulled "
        "embedding rows on the worker, served locally instead of over "
        "gRPC while fresh (0 disables; see docs/sparse_fast_path.md)",
    )
    parser.add_argument(
        "--hot_row_staleness_window",
        type=int,
        default=0,
        help="How many PS model versions a hot-row cache entry may lag "
        "before it is re-pulled; 0 (default) binds it to the SSP "
        "window, --get_model_steps",
    )
    add_bool_param(
        parser,
        "--ps_fanout",
        True,
        "Issue the per-shard RPCs of each logical PS call concurrently "
        "(one round trip per call instead of one per shard); false "
        "restores the serial loop (docs/dense_overlap.md)",
    )
    parser.add_argument(
        "--ps_push_inflight",
        type=non_neg_int,
        default=0,
        help="PS mode: allow this many gradient pushes in flight "
        "behind the compute (1 = double buffering; 0 = synchronous "
        "push). The window drains at every model pull and task "
        "boundary, so staleness stays inside the SSP window "
        "(docs/dense_overlap.md); pair with async PS "
        "(--use_async), where late stale-rejections cannot occur",
    )
    parser.add_argument(
        "--rpc_deadline_s",
        type=float,
        default=60.0,
        help="Deadline in seconds for each PS data-plane RPC: a dead "
        "PS pod fails the call (DEADLINE_EXCEEDED into the worker's "
        "minibatch retry loop) instead of hanging forever. 0 disables. "
        "Control-plane master RPCs are NOT bounded (a worker parked on "
        "get_task must block)",
    )
    parser.add_argument(
        "--rpc_retries",
        type=non_neg_int,
        default=2,
        help="Retries (doubling backoff) for UNAVAILABLE PS data-plane "
        "RPCs — the shape a restarting PS pod presents; deadline "
        "expiry is never retried at this layer",
    )
    parser.add_argument(
        "--ps_shm",
        default="auto",
        choices=["auto", "on", "off"],
        help="Shared-memory payload transport toward PS pods "
        "co-located on this host (rpc/shm_transport.py): 'auto' (default) "
        "negotiates per channel at first call and silently keeps the "
        "bytes path cross-host or on attach failure; 'off' never "
        "negotiates",
    )
    parser.add_argument(
        "--ps_shm_slots",
        type=pos_int,
        default=4,
        help="Slots per negotiated shm ring (one ring per PS channel); "
        "calls beyond the pool fall back to the bytes path per call",
    )
    parser.add_argument(
        "--ps_shm_slot_mb",
        type=pos_int,
        default=8,
        help="Slot payload size in MiB: one slot must hold one logical "
        "request or reply (a dense pull partition, a per-shard "
        "gradient push); larger payloads ride the bytes path",
    )
    parser.add_argument(
        "--master_shm",
        default="auto",
        choices=["auto", "on", "off"],
        help="Shared-memory payload path for the master channel's "
        "get_model replies when the master pod is co-located on this "
        "host (rpc/shm_transport.py): same negotiation and silent bytes-path "
        "fallback as --ps_shm; only the reply-heavy model pull rides "
        "slots — requests stay on the bytes path",
    )
    parser.add_argument(
        "--embedding_plane",
        default="ps",
        choices=["ps", "hybrid"],
        help="Comm-plane trainer mode (docs/embedding_planes.md): 'ps' "
        "round-trips dense parameters through the PS fleet (the "
        "classic parameter-server loop); 'hybrid' keeps dense "
        "parameters (HBM-plane tables included) in the local/"
        "allreduce world and uses the PS fleet only for PS-plane "
        "embedding tables, with the per-batch pull overlapped behind "
        "the previous batch's compute",
    )
    parser.add_argument(
        "--task_prefetch",
        type=non_neg_int,
        default=1,
        help="Keep this many shard tasks fetched ahead of the one being "
        "consumed: a background fetcher overlaps the master get_task "
        "round trip and the cold first-record read with training on "
        "the current task (docs/input_pipeline.md). 0 restores the "
        "serial fetch-then-read loop",
    )
    parser.add_argument(
        "--task_ack_queue",
        type=non_neg_int,
        default=8,
        help="Queue up to this many completed-task acknowledgments "
        "instead of reporting each on the training hot loop; the queue "
        "drains at every task/eval/checkpoint boundary (and inline on "
        "overflow). Failure acks always flush immediately. 0 restores "
        "synchronous per-task acks",
    )
    add_bool_param(
        parser,
        "--speculative_compile",
        False,
        "Elastic allreduce plane: AOT-compile the train step for likely "
        "next world sizes (current±1 and membership-service hints) on a "
        "background thread during steady-state training, so a resize to "
        "a pre-compiled size pays state re-placement only; pair with "
        "EDL_COMPILE_CACHE_DIR so relaunched processes skip XLA "
        "compiles too (docs/compile_plane.md). Not ported: true raises "
        "NotImplementedError (ROADMAP A9.2.2)",
    )
    parser.add_argument(
        "--telemetry_report_secs",
        type=float,
        default=5.0,
        help="Workers piggyback a compact telemetry snapshot "
        "(step/examples rates, input-plane counters, pending events) "
        "on the master channel at most every this many seconds "
        "(docs/observability.md); 0 disables worker telemetry "
        "reporting. EDL_METRICS=0 disables ALL telemetry recording",
    )
    parser.add_argument(
        "--loss_log_steps",
        type=non_neg_int,
        default=20,
        help="Log the training loss every this many accepted "
        "minibatches; each log costs a device->host sync, so the "
        "per-step logging of the reference is off the hot path. 0 "
        "disables loss logging",
    )
    parser.add_argument(
        "--master_failover_s",
        type=float,
        default=120.0,
        help="Worker-side master failover budget in seconds "
        "(docs/master_recovery.md): UNAVAILABLE master RPCs retry "
        "with capped backoff for up to this long — the window a "
        "SIGKILLed master needs to relaunch and replay its journal — "
        "instead of killing the worker. Task acks replayed against "
        "the new incarnation dedup by (trace_id, attempt). 0 restores "
        "the historical die-on-outage behavior",
    )


def parse_master_args(master_args=None):
    parser = argparse.ArgumentParser(
        description="ElasticDL master (PyTorch/CUDA)"
    )
    # port 0 = pick a free port (the chosen one is exposed as Master.port);
    # None = "not set": cluster mode uses 50001, local mode uses 0
    parser.add_argument("--port", type=non_neg_int, default=None)
    parser.add_argument("--worker_image", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument(
        "--prediction_outputs_processor",
        default="PredictionOutputsProcessor",
    )
    parser.add_argument(
        "--telemetry_port",
        type=non_neg_int,
        default=None,
        help="Serve the job telemetry registry as Prometheus text on "
        "http://master:PORT/metrics (plus /events as JSONL); 0 binds "
        "an ephemeral port (exposed as Master.telemetry_port); unset "
        "disables the endpoint (aggregation still runs)",
    )
    parser.add_argument(
        "--telemetry_events_path",
        default="",
        help="Append the master's structured job-event log (resize, "
        "task requeue/timeline, worker join/leave, PS shard failure) "
        "as JSON lines to this file; empty disables the file sink "
        "(the in-memory tail still serves /events)",
    )
    parser.add_argument(
        "--comm_base_port",
        type=non_neg_int,
        default=0,
        help="Allreduce-plane coordinator port base; each membership "
        "epoch binds base+epoch%%64 on rank 0's host. 0 picks ephemeral "
        "ports (single-host jobs)",
    )
    parser.add_argument(
        "--master_journal_dir",
        default="",
        help="Master recovery plane (docs/master_recovery.md): append "
        "a write-ahead journal of task lifecycle transitions, epoch "
        "boundaries, the model-version clock, and membership changes "
        "under this directory; a relaunched master (same args, same "
        "dir) replays it before serving so done tasks stay done and "
        "in-flight tasks requeue exactly once. Empty disables "
        "durability (a master crash kills the job, the historical "
        "behavior)",
    )
    parser.add_argument(
        "--master_journal_fsync_ms",
        type=float,
        default=50.0,
        help="Batched fsync cadence of the journal writer thread: "
        "appends are enqueue-only on the RPC path and at most this "
        "many milliseconds of accepted transitions can be lost to a "
        "hard kill (a lost 'done' re-trains that task; accounting "
        "stays exactly-once either way)",
    )
    parser.add_argument(
        "--master_journal_segment_records",
        type=pos_int,
        default=4096,
        help="Rotate + compact the journal after this many records: a "
        "fresh segment opens with a state snapshot (write-to-temp + "
        "atomic rename, the PR-10 manifest discipline) and the "
        "superseded chain is unlinked, bounding replay time and disk",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device the job trains on: 'cuda' (the default; raises "
        "without a card) or 'cpu'",
    )
    add_common_params(parser)
    add_train_params(parser)
    args, unknown = parser.parse_known_args(args=master_args)
    _validate(args)
    return args


def _validate(args):
    """Cross-flag validation (reference args.py:547-556)."""
    if getattr(args, "use_async", False) and args.grads_to_wait > 1:
        args.grads_to_wait = 1
        logger.warning(
            "grads_to_wait is forced to 1 for async SGD"
        )
    if not getattr(args, "use_async", False):
        if getattr(args, "get_model_steps", 1) > 1:
            args.get_model_steps = 1
            logger.warning(
                "get_model_steps is forced to 1 for sync SGD"
            )


def parse_ps_args(ps_args=None):
    """The flags of a parameter-server shard (``ps/main.py``)."""
    parser = argparse.ArgumentParser(
        description="ElasticDL parameter server (PyTorch/CUDA)"
    )
    parser.add_argument("--ps_id", type=non_neg_int, required=True)
    parser.add_argument("--port", type=pos_int, required=True)
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", required=True)
    parser.add_argument("--model_params", default="")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--grads_to_wait", type=pos_int, default=1)
    add_bool_param(parser, "--use_async", False, "")
    add_bool_param(parser, "--lr_staleness_modulation", False, "")
    add_bool_param(
        parser, "--ps_device", False,
        "Device-resident shard: the dense parameters and every table's "
        "rows live on --device (one arena per table)",
    )
    parser.add_argument(
        "--wire_dtype", default="", choices=["", "bfloat16"]
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Where the shard's applies run: cuda (the default; raises "
        "without a card) or cpu",
    )
    add_ps_snapshot_params(parser)
    parser.add_argument(
        "--log_level",
        default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
    )
    args, _unknown = parser.parse_known_args(args=ps_args)
    return args


def parse_worker_args(worker_args=None):
    """A worker process (``python -m elasticdl_tpu_torch.worker.main``)."""
    parser = argparse.ArgumentParser(
        description="ElasticDL worker (PyTorch/CUDA)"
    )
    parser.add_argument("--worker_id", type=int, required=True)
    parser.add_argument("--job_type", required=True)
    parser.add_argument("--master_addr", default="")
    parser.add_argument("--ps_addrs", default="", help="Comma-separated")
    parser.add_argument(
        "--comm_host",
        default="",
        help="Host other allreduce workers can reach this process at "
        "(the coordinator address when it is rank 0); defaults to "
        "$EDL_COMM_HOST or the hostname",
    )
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument(
        "--replica_refresh_steps", type=non_neg_int, default=8
    )
    add_bool_param(
        parser,
        "--standby",
        False,
        help="Start as a pre-warmed spare: warm up, park until the master "
        "promotes this process, then train under the worker id (and on "
        "the device) the promotion names; --worker_id is the standby's "
        "token",
    )
    parser.add_argument(
        "--checkpoint_filename_for_init",
        default="",
        help="Exported model file evaluation-only allreduce workers "
        "score (relayed from the master's flag of the same name)",
    )
    parser.add_argument(
        "--keep_checkpoint_max", type=non_neg_int, default=0
    )
    parser.add_argument(
        "--prediction_outputs_processor",
        default="PredictionOutputsProcessor",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device the worker trains on: 'cuda' (the default; raises "
        "without a card) or 'cpu'",
    )
    add_common_args_between_master_and_worker(parser)
    args, _unknown = parser.parse_known_args(args=worker_args)
    return args


def build_arguments_from_parsed_result(args, filter_args=None):
    """Parsed flags -> an argv that parses back to them (the master
    relays its own flags to the workers it launches); ``filter_args``
    names flags to leave out, and unset (None) ones are left out too."""
    items = vars(args).items()
    if filter_args:
        items = [(k, v) for k, v in items if k not in filter_args]
    arguments = []
    for key, value in items:
        if value is None:
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        arguments.extend(["--" + key, str(value)])
    return arguments
