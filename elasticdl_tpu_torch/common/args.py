"""Command-line arguments of the port's scorer process: the scorer subset
of ``elasticdl_tpu/common/args.py`` (``parse_scorer_args``), plus
``--device``.

Flags of planes not ported yet (``--ps_addrs``, ``--scorer_telemetry_port``)
still parse, so one argv serves both packages, and
:func:`~elasticdl_tpu_torch.serving.main.build_scorer` raises when they
ask for the missing plane. Unknown flags are ignored, as in the reference.
"""

import argparse


def non_neg_int(value):
    ivalue = int(value)
    if ivalue < 0:
        raise argparse.ArgumentTypeError(
            "%s is not a non-negative integer" % value
        )
    return ivalue


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
        help="PS shard addresses for PS-resident embedding tables "
        "(not ported yet: must be empty)",
    )
    parser.add_argument(
        "--port",
        type=non_neg_int,
        default=0,
        help="Scorer RPC port (0 binds ephemeral)",
    )
    parser.add_argument(
        "--scorer_telemetry_port",
        type=int,
        default=-1,
        help="Telemetry HTTP endpoint (not ported yet: must be -1)",
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
        "--log_level",
        default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
    )
    args, _unknown = parser.parse_known_args(args=scorer_args)
    return args
