"""Scorer process entry: one pod of the serving fleet, on one device.

    python -m elasticdl_tpu_torch.serving.main --export_dir E [--device cuda]

Boot order: build the scorer, start the export-directory watcher (the
first artifact makes ``score`` answer), then serve. A scorer answers
``scorer_status`` immediately and ``score`` errors cleanly until the
first export lands. SIGTERM drains: the micro-batcher stops admitting
and answers everything already queued, then the RPC plane stops, the
watcher joins, and the process exits 0.
"""

import logging
import signal
import sys
import threading

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


def build_scorer(args):
    """The scorer stack from parsed args -> ``(scorer, watcher, batcher)``;
    ``batcher`` is None when ``--serve_max_batch <= 1``. Raises for the
    planes not ported yet (PS-resident embeddings, telemetry HTTP) and
    when ``--device cuda`` finds no card."""
    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.serving.batcher import MicroBatcher
    from elasticdl_tpu_torch.serving.scorer import (
        ModelDirectoryWatcher,
        Scorer,
    )

    if any(a for a in (args.ps_addrs or "").split(",")):
        raise NotImplementedError(
            "--ps_addrs: the scorer's PS/embedding plane is not ported "
            "yet; the PyTorch scorer serves dense models only"
        )
    if args.scorer_telemetry_port >= 0:
        raise NotImplementedError(
            "--scorer_telemetry_port: the telemetry HTTP endpoint is not "
            "ported yet"
        )
    device = resolve_device(args.device)
    scorer = Scorer()
    watcher = ModelDirectoryWatcher(
        args.export_dir,
        scorer,
        interval_s=args.watch_interval_s,
        model_zoo=args.model_zoo or None,
        device=device,
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
    return scorer, watcher, batcher


def main(argv=None):
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.server import ScorerServer
    from elasticdl_tpu_torch.utils import profiling

    args = parse_scorer_args(argv)
    logger.setLevel(getattr(logging, args.log_level))
    profiling.spans.set_process("scorer-%d" % args.scorer_id)

    scorer, watcher, batcher = build_scorer(args)
    server = ScorerServer(scorer, port=args.port, batcher=batcher)
    watcher.start()

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
        scorer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
