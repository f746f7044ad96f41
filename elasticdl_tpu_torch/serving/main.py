"""Scorer process entry: one pod of the serving fleet, on one device.

    python -m elasticdl_tpu_torch.serving.main --export_dir E \\
        [--ps_addrs A,B] [--device cuda] [--scorer_transport socket] \\
        [--scorer_telemetry_port 0]

Boot order: with ``--ps_addrs``, the PS channels (a deadline and bounded
resends of the idempotent reads) and one hot-row cache shared by the
request path and the delta sync; then the scorer and the export-directory
watcher (the first artifact makes ``score`` answer), the delta sync, and
the server. A scorer answers ``scorer_status`` immediately and ``score``
errors cleanly until the first export lands. SIGTERM drains: the
micro-batcher stops admitting and answers everything already queued,
then the RPC plane stops, the watcher and the sync join, the channels
close, and the process exits 0.

An artifact with the port's serving member (``serving_fn.pt2``) is
served through it, on ``--device``, with no rebuild and no zoo lookup:
``--model_zoo`` is read only for an artifact without the member (a
params-only one, a PS-plane model's, or the reference's with a JAX
member; ``serving/scorer.py``).
"""

import logging
import signal
import sys
import threading

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


def build_scorer(args):
    """The scorer stack from parsed args -> ``(scorer, watcher, sync,
    bound channels, batcher)``. ``sync`` is None and the channels empty
    without ``--ps_addrs``; ``batcher`` is None when ``--serve_max_batch
    <= 1``. Each PS channel negotiates the shared-memory wire with a
    co-located shard under ``--ps_shm auto`` or ``on``. Raises when
    ``--device cuda`` finds no card."""
    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.nn.comm_plane import HotRowCache
    from elasticdl_tpu_torch.serving.batcher import MicroBatcher
    from elasticdl_tpu_torch.serving.delta_sync import EmbeddingDeltaSync
    from elasticdl_tpu_torch.serving.scorer import (
        ModelDirectoryWatcher,
        Scorer,
    )
    from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient

    device = resolve_device(args.device)
    bound, ps_client, cache, sync = [], None, None, None
    addrs = [a for a in (args.ps_addrs or "").split(",") if a]
    if addrs:
        cache = HotRowCache(
            args.hot_row_cache_rows, window=args.serving_staleness_versions
        )
        bound = [
            BoundPS(
                addr,
                deadline_s=args.rpc_deadline_s or None,
                retries=args.rpc_retries,
                shm=args.ps_shm,
            )
            for addr in addrs
        ]
        ps_client = PSClient(bound, cache=cache)
    scorer = Scorer(
        ps_client=ps_client,
        staleness_versions=args.serving_staleness_versions,
        model_zoo=args.model_zoo or None,
    )
    watcher = ModelDirectoryWatcher(
        args.export_dir,
        scorer,
        interval_s=args.watch_interval_s,
        model_zoo=args.model_zoo or None,
        device=device,
    )
    if ps_client is not None:
        sync = EmbeddingDeltaSync(
            ps_client, cache, interval_s=args.serving_sync_interval_s
        )
    batcher = None
    if args.serve_max_batch > 1:
        batcher = MicroBatcher(
            scorer,
            max_batch=args.serve_max_batch,
            timeout_ms=args.serve_batch_timeout_ms,
            p99_slo_ms=args.serve_p99_slo_ms,
            queue_rows=args.serve_queue_rows,
        )
        # hot swaps warm every bucket shape, never a request
        scorer.set_warm_batch_sizes(batcher.buckets)
    return scorer, watcher, sync, bound, batcher


def main(argv=None):
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.server import ScorerServer
    from elasticdl_tpu_torch.utils import profiling

    args = parse_scorer_args(argv)
    logger.setLevel(getattr(logging, args.log_level))
    profiling.spans.set_process("scorer-%d" % args.scorer_id)
    profiling.maybe_arm_flight_recorder()

    scorer, watcher, sync, bound, batcher = build_scorer(args)
    server = ScorerServer(scorer, port=args.port, batcher=batcher,
                          transport=args.scorer_transport,
                          telemetry_port=args.scorer_telemetry_port)
    watcher.start()
    if sync is not None:
        sync.start()

    stop = threading.Event()

    def _drain(signum, frame):
        if not stop.is_set():
            logger.warning("SIGTERM: draining the scorer")
            stop.set()

    signal.signal(signal.SIGTERM, _drain)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        logger.warning("scorer stopping")
    finally:
        server.stop()
        watcher.stop()
        if sync is not None:
            sync.stop()
        scorer.close()
        for channel in bound:
            channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
