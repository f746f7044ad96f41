"""tracetool — per-step critical-path breakdown of a /trace export; the
port of ``elasticdl_tpu/tools/tracetool.py``.

The master's ``/trace`` endpoint (docs/observability.md "Distributed
tracing") serves Chrome trace-event JSON built from the job's span
ring. This tool answers the question the raw timeline makes you
eyeball: *where does a step's wall time actually go, and which phase
dominates the slow steps?*

Model: every worker minibatch runs under one ``"step"`` span (the
trace root is the dispatcher's task trace id); its direct children are
the named phases — ``step/pull_model``, ``step/compute`` (which nests
``step/embedding_pull``), ``step/grad_push``, ``step/local_update``.
The breakdown sums direct-child durations per step:

- **attribution** (a.k.a. coverage): child-time / step-time — how much
  of the step's wall clock the named phases explain. The on-card check
  requires >= 90% on a live job; low attribution means an
  uninstrumented phase is eating the step.
- **phase shares**: each phase's share of total step time across the
  capture — the marginal-cost signal an autoscaling policy needs (a
  fleet whose steps are dominated by ``task/wait`` gains
  nothing from more workers; one dominated by ``step/compute`` does).
- **slow-step focus**: the steps at/above the p99 duration, each with
  its dominant phase — the "why slow" answer for the tail.

Usage::

    python -m elasticdl_tpu_torch.tools.tracetool trace.json
    curl -s master:PORT/trace | python -m elasticdl_tpu_torch.tools.tracetool -
    python -m elasticdl_tpu_torch.tools.tracetool trace.json --json

Accepts the ``{"traceEvents": [...]}`` document or a bare event list,
and (for convenience in tests) raw span-record lists from
``SpanLog.tail()``.
"""

import json
import sys

STEP_SPAN = "step"

# the phases the worker step loop emits as DIRECT children of "step"
# (docs/observability.md span schema); anything else parented on a step
# still counts toward attribution — the list only orders the report
KNOWN_PHASES = (
    "step/pull_model",
    "step/compute",
    "step/grad_push",
    "step/local_update",
)


def _spans_from_doc(doc):
    """Normalize input into span-record dicts.

    Accepts the Chrome trace document (``{"traceEvents": [...]}``), a
    bare trace-event list, or a list of SpanLog records (already
    ``{"name", "span", "parent", "dur", ...}``-shaped).
    """
    if isinstance(doc, dict):
        doc = doc.get("traceEvents", [])
    out = []
    for ev in doc:
        if not isinstance(ev, dict):
            continue
        if "ph" in ev:  # chrome trace event
            if ev.get("ph") != "X":
                continue  # metadata / instant events carry no duration
            args = ev.get("args") or {}
            out.append(
                {
                    "name": ev.get("name", "?"),
                    "dur": float(ev.get("dur", 0.0)) / 1e6,
                    "ts": float(ev.get("ts", 0.0)) / 1e6,
                    "span": args.get("span"),
                    "parent": args.get("parent"),
                    "trace": args.get("trace"),
                    "proc": ev.get("pid"),
                }
            )
        elif "dur" in ev:  # raw SpanLog record
            out.append(
                {
                    "name": ev.get("name", "?"),
                    "dur": float(ev.get("dur", 0.0)),
                    "ts": float(ev.get("ts", 0.0)),
                    "span": ev.get("span"),
                    "parent": ev.get("parent"),
                    "trace": ev.get("trace"),
                    "proc": ev.get("proc"),
                }
            )
    return out


def _nearest_rank(sorted_xs, pct):
    n = len(sorted_xs)
    rank = -(-pct * n // 100)
    return sorted_xs[max(0, min(n - 1, int(rank) - 1))]


def critical_path(doc):
    """Decompose a trace into the per-step breakdown.

    Returns ``{"steps", "total_step_s", "attribution", "phases":
    {name: {"total_s", "share", "count"}}, "slowest": [...],
    "p99_s"}`` — ``attribution`` is the fraction of total step wall
    time explained by direct-child spans (the >=90% gate), and
    ``slowest`` lists the steps at/above the p99 duration with each
    one's dominant phase flagged.
    """
    spans = _spans_from_doc(doc)
    steps = [s for s in spans if s["name"] == STEP_SPAN and s["span"]]
    children = {}  # parent span id -> [child record]
    for s in spans:
        if s.get("parent"):
            children.setdefault(s["parent"], []).append(s)

    phase_totals = {}
    phase_counts = {}
    per_step = []
    total_step = 0.0
    total_attributed = 0.0
    for step in steps:
        dur = step["dur"]
        total_step += dur
        attributed = 0.0
        by_phase = {}
        for child in children.get(step["span"], ()):
            attributed += child["dur"]
            by_phase[child["name"]] = (
                by_phase.get(child["name"], 0.0) + child["dur"]
            )
            phase_totals[child["name"]] = (
                phase_totals.get(child["name"], 0.0) + child["dur"]
            )
            phase_counts[child["name"]] = (
                phase_counts.get(child["name"], 0) + 1
            )
        # a child can only overlap its parent in pathological clock
        # cases; clamp so one bad record cannot push coverage past 1
        attributed = min(attributed, dur)
        total_attributed += attributed
        dominant = max(by_phase, key=by_phase.get) if by_phase else None
        per_step.append(
            {
                "trace": step.get("trace"),
                "span": step.get("span"),
                "proc": step.get("proc"),
                "dur_s": round(dur, 6),
                "attribution": round(attributed / dur, 4) if dur else 0.0,
                "dominant": dominant,
                "phases": {
                    k: round(v, 6) for k, v in sorted(by_phase.items())
                },
            }
        )

    durs = sorted(s["dur_s"] for s in per_step) or [0.0]
    p99 = _nearest_rank(durs, 99)
    slowest = sorted(
        (s for s in per_step if s["dur_s"] >= p99),
        key=lambda s: -s["dur_s"],
    )[:16]
    ordered = {}
    for name in list(KNOWN_PHASES) + sorted(
        k for k in phase_totals if k not in KNOWN_PHASES
    ):
        if name in phase_totals:
            ordered[name] = {
                "total_s": round(phase_totals[name], 6),
                "share": round(
                    phase_totals[name] / total_step, 4
                )
                if total_step
                else 0.0,
                "count": phase_counts[name],
            }
    return {
        "steps": len(per_step),
        "total_step_s": round(total_step, 6),
        "attribution": round(total_attributed / total_step, 4)
        if total_step
        else 0.0,
        "p99_s": round(p99, 6),
        "phases": ordered,
        "slowest": slowest,
    }


def format_report(report):
    """The human-readable table for the CLI."""
    lines = [
        "steps: %d   total step wall: %.3fs   attribution: %.1f%%"
        % (
            report["steps"],
            report["total_step_s"],
            100.0 * report["attribution"],
        ),
        "",
        "phase breakdown (share of total step wall time):",
    ]
    for name, info in report["phases"].items():
        lines.append(
            "  %-28s %8.3fs  %5.1f%%  (%d spans)"
            % (name, info["total_s"], 100.0 * info["share"], info["count"])
        )
    if report["slowest"]:
        lines.append("")
        lines.append(
            "slowest steps (>= p99 = %.3fs), dominant phase flagged:"
            % report["p99_s"]
        )
        for s in report["slowest"]:
            lines.append(
                "  trace=%-10s %8.3fs  dominant=%-24s attributed %5.1f%%"
                % (
                    s.get("trace"),
                    s["dur_s"],
                    s.get("dominant"),
                    100.0 * s["attribution"],
                )
            )
    return "\n".join(lines)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if not argv:
        print(__doc__.strip().splitlines()[0])
        print(
            "usage: python -m elasticdl_tpu_torch.tools.tracetool "
            "<trace.json | -> [--json]"
        )
        return 2
    src = argv[0]
    try:
        if src == "-":
            doc = json.load(sys.stdin)
        else:
            with open(src, encoding="utf-8") as f:
                doc = json.load(f)
    except (OSError, ValueError) as err:
        print("tracetool: cannot read %s: %s" % (src, err))
        return 2
    report = critical_path(doc)
    if not report["steps"]:
        print("tracetool: no %r spans in %s" % (STEP_SPAN, src))
        return 1
    if as_json:
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
