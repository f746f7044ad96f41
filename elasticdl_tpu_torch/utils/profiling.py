"""Process telemetry: the port of ``elasticdl_tpu/utils/profiling.py``.

One small surface that any worker, master, shard, scorer or test uses
without plumbing:

- :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (``trace-<pid>-<n>.json``, Perfetto-loadable) into a
  directory; :func:`annotate` — a named ``record_function`` range for
  host-side phases, so task pulls, the input pipeline and step dispatch
  separate in that timeline.
- :func:`step_timer` — rolling wall-clock step statistics.
- :data:`counters` — a process-wide named-counter registry
  (:class:`Counters`), surfaced in the exposition as
  ``edl_counter{name=...}``.
- :data:`metrics` — the process-wide :class:`MetricsRegistry`: labeled
  counters, gauges and fixed-bucket histograms with bounded label
  cardinality, scrape-time collectors, and the Prometheus text
  exposition (format 0.0.4, byte for byte the reference's).
- :data:`events` — the process-wide :class:`EventLog`: structured job
  events with monotonic ids, an optional JSONL file sink, and a bounded
  pending buffer that workers drain into their telemetry snapshots so
  the master's log aggregates the whole fleet.
- :data:`spans` — the process-wide :class:`SpanLog`: cross-process
  tracing. :func:`span` opens one timed operation with trace, span and
  parent ids; the context follows a per-thread stack and rides the wire
  as the ``_sctx`` field that RPC clients inject. Worker spans ship to
  the master on ``report_telemetry``; ``/trace`` exports them as Chrome
  trace-event JSON (:func:`chrome_trace`).
- :data:`flight_recorder` — the crash :class:`FlightRecorder`: a
  failure-shaped event (a PS shard failure, a master epoch change, a
  task requeue) freezes the last spans and events to a postmortem JSONL.

Environment: ``EDL_PROFILE_DIR`` turns on the profiler trace
(:func:`maybe_profile`, :func:`maybe_start_trace`); ``EDL_METRICS=0``
turns every telemetry write (metrics, events, spans, the recorder) into
a no-op; ``EDL_FLIGHT_RECORDER_DIR`` arms the flight recorder in any
process (:func:`maybe_arm_flight_recorder`). The reference's XLA dump
(``EDL_XLA_DUMP_DIR``) has no counterpart without XLA.
"""

import bisect
import contextlib
import glob
import itertools
import json
import os
import re
import threading
import time
from collections import deque

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


_trace = None  # the open (profiler, directory), None when no trace is open
_trace_seq = itertools.count(1)


def _start(log_dir):
    global _trace
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, log_dir)
    logger.info("profiler trace started -> %s", log_dir)


def _stop():
    global _trace
    if _trace is None:
        return
    (prof, log_dir), _trace = _trace, None
    path = os.path.join(
        log_dir, "trace-%d-%d.json" % (os.getpid(), next(_trace_seq))
    )
    try:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
    except Exception:  # noqa: BLE001 — a trace never fails the job
        logger.warning("stopping profiler trace failed", exc_info=True)


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace into ``log_dir``."""
    _start(log_dir)
    try:
        yield log_dir
    finally:
        _stop()


def annotate(name):
    """Host-phase range visible in the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)


def maybe_profile():
    """Context from env: EDL_PROFILE_DIR -> trace, else no-op."""
    log_dir = os.environ.get("EDL_PROFILE_DIR")
    if log_dir:
        return trace(log_dir)
    return contextlib.nullcontext()


def maybe_start_trace():
    """Start the env-selected trace mid-run (no-op if active or unset).

    An elastic worker traces per membership epoch: it stops before its
    process group is torn down and starts again once the next world
    forms, one trace file per world."""
    log_dir = os.environ.get("EDL_PROFILE_DIR")
    if not log_dir or _trace is not None:
        return False
    _start(log_dir)
    return True


def maybe_stop_trace():
    _stop()


# ---------------------------------------------------------------------------
# telemetry switch
# ---------------------------------------------------------------------------

_metrics_on = os.environ.get("EDL_METRICS", "1") != "0"


def metrics_enabled():
    """False disables every telemetry write (EDL_METRICS=0; the off arm of
    the overhead A/B). Metric objects still exist — their
    record methods just return immediately."""
    return _metrics_on


def set_metrics_enabled(on):
    global _metrics_on
    _metrics_on = bool(on)


# ---------------------------------------------------------------------------
# metrics registry: labeled counters / gauges / fixed-bucket histograms
# ---------------------------------------------------------------------------

# Prometheus-standard latency buckets, seconds. Fixed at histogram
# creation: the hot path does one bisect + two list increments, never a
# rebucket.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    out = _NAME_SANITIZE.sub("_", name)
    return "_" + out if out[:1].isdigit() else out


def _prom_label_value(value):
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


class _Metric:
    """One metric family: name + label names + a series per distinct
    label-value tuple. One small lock per family; series creation is
    rare, series updates are a dict hit + an increment.

    Label cardinality is bounded: past ``max_series`` distinct label
    tuples, further new tuples collapse into one ``(overflow)`` series
    so a runaway label (e.g. a task id used as a label) cannot grow
    memory without bound. The bound is per family, counted once —
    crossing it is a telemetry bug worth logging, not crashing on."""

    OVERFLOW = "(overflow)"

    def __init__(self, name, help_text, label_names, max_series):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._max_series = max_series
        self._lock = threading.Lock()
        self._series = {}
        self._overflowed = False

    def _key(self, labels):
        if not self.label_names:
            return ()
        return tuple(str(labels.get(n, "")) for n in self.label_names)

    def _series_for(self, key):
        """Locate/create the series slot for ``key`` (lock held)."""
        slot = self._series.get(key)
        if slot is None:
            if len(self._series) >= self._max_series:
                if not self._overflowed:
                    self._overflowed = True
                    logger.warning(
                        "metric %s exceeded %d label series; further "
                        "new label values collapse into %s",
                        self.name,
                        self._max_series,
                        self.OVERFLOW,
                    )
                key = tuple(self.OVERFLOW for _ in key)
                slot = self._series.get(key)
                if slot is not None:
                    return slot
            slot = self._new_series()
            self._series[key] = slot
        return slot

    def series_count(self):
        with self._lock:
            return len(self._series)


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, value=1, **labels):
        if not _metrics_on:
            return
        key = self._key(labels)
        with self._lock:
            self._series_for(key)[0] += value

    def value(self, **labels):
        with self._lock:
            slot = self._series.get(self._key(labels))
            return slot[0] if slot else 0.0

    def _samples(self):
        for key, slot in self._series.items():
            yield self.name, key, slot[0]


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, value, **labels):
        if not _metrics_on:
            return
        key = self._key(labels)
        with self._lock:
            self._series_for(key)[0] = value

    def inc(self, value=1, **labels):
        if not _metrics_on:
            return
        key = self._key(labels)
        with self._lock:
            self._series_for(key)[0] += value

    def value(self, **labels):
        with self._lock:
            slot = self._series.get(self._key(labels))
            return slot[0] if slot else 0.0

    def _samples(self):
        for key, slot in self._series.items():
            yield self.name, key, slot[0]


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus ``le`` semantics: a bucket
    counts observations <= its upper edge; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name, help_text, label_names, max_series, buckets):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = buckets
        super().__init__(name, help_text, label_names, max_series)

    def _new_series(self):
        # [bucket_counts..., +Inf count] + [sum, count]
        return [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, value, **labels):
        if not _metrics_on:
            return
        idx = bisect.bisect_left(self.buckets, value)
        key = self._key(labels)
        with self._lock:
            slot = self._series_for(key)
            slot[0][idx] += 1
            slot[1] += value
            slot[2] += 1

    def data(self, **labels):
        """(bucket_counts, sum, count) — copies, for tests/export."""
        with self._lock:
            slot = self._series.get(self._key(labels))
            if slot is None:
                return None
            return list(slot[0]), slot[1], slot[2]

    def quantile(self, q, **labels):
        """Upper-bound estimate of the ``q`` quantile (0 < q <= 1):
        the smallest bucket edge whose cumulative count covers
        ``q * count``. Returns None for an empty series, and the last
        finite edge when the quantile lands in +Inf — a conservative
        (never-understated... up to the top edge) read that is exactly
        what SLO admission control wants (docs/serving.md)."""
        got = self.data(**labels)
        if got is None or got[2] == 0:
            return None
        counts, _, total = got
        need = q * total
        cum = 0
        for i, edge in enumerate(self.buckets):
            cum += counts[i]
            if cum >= need:
                return edge
        return self.buckets[-1]

    def _samples(self):
        for key, slot in self._series.items():
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += slot[0][i]
                yield "%s_bucket" % self.name, key + (
                    ("le", "%g" % edge),
                ), cum
            cum += slot[0][-1]
            yield "%s_bucket" % self.name, key + (("le", "+Inf"),), cum
            yield "%s_sum" % self.name, key, slot[1]
            yield "%s_count" % self.name, key, slot[2]


class MetricsRegistry:
    """Process-wide named metric families with Prometheus exposition.

    ``counter``/``gauge``/``histogram`` get-or-create a family; callers
    hold the returned object so the hot path never takes the registry
    lock. ``register_collector(fn)`` adds a scrape-time callable
    returning ``[(name, {label: value}, number)]`` — how live state
    (task-queue depth, the legacy ``Counters`` shim) joins the
    exposition without being written through the registry."""

    # per-family bound: generous enough for per-worker x per-stage
    # families on a large fleet (6 input stages x 100+ workers), small
    # enough to stop a runaway unbounded label (task ids, hostnames)
    MAX_SERIES = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []

    def _get_or_create(self, cls, name, help_text, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        "metric %r re-registered with a different "
                        "type/labels" % name
                    )
                return m
            m = cls(name, help_text, tuple(labels), self.MAX_SERIES, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_text="", labels=()):
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=()):
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(
        self, name, help_text="", labels=(),
        buckets=DEFAULT_LATENCY_BUCKETS,
    ):
        return self._get_or_create(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def register_collector(self, fn):
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self):
        """Every registered collector's samples (a failing collector is
        logged and skipped)."""
        with self._lock:
            collectors = list(self._collectors)
        out = []
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — one collector never blocks the rest
                logger.warning(
                    "metrics collector failed; skipped", exc_info=True
                )
        return out

    def reset(self):
        """Drop every family and collector (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    def snapshot(self):
        """{name: {label_tuple: value-or-(buckets, sum, count)}}."""
        with self._lock:
            families = list(self._metrics.values())
        out = {}
        for m in families:
            with m._lock:
                if isinstance(m, Histogram):
                    out[m.name] = {
                        k: (list(s[0]), s[1], s[2])
                        for k, s in m._series.items()
                    }
                else:
                    out[m.name] = {
                        k: s[0] for k, s in m._series.items()
                    }
        return out

    def prometheus_text(self):
        """The registry in Prometheus text exposition format 0.0.4."""
        with self._lock:
            families = sorted(
                self._metrics.values(), key=lambda m: m.name
            )
            collectors = list(self._collectors)
        lines = []
        for m in families:
            pname = _prom_name(m.name)
            if m.help:
                lines.append("# HELP %s %s" % (pname, m.help))
            lines.append("# TYPE %s %s" % (pname, m.kind))
            with m._lock:
                samples = list(m._samples())
            for sample_name, key, value in samples:
                label_pairs = []
                for i, v in enumerate(key):
                    if isinstance(v, tuple):  # histogram ("le", edge)
                        label_pairs.append(v)
                    else:
                        label_pairs.append((m.label_names[i], v))
                lines.append(
                    _format_sample(sample_name, label_pairs, value)
                )
        for fn in collectors:
            try:
                extra = list(fn())
            except Exception:
                logger.warning(
                    "metrics collector failed; skipped", exc_info=True
                )
                continue
            for name, labels, value in extra:
                lines.append(
                    _format_sample(
                        name, sorted((labels or {}).items()), value
                    )
                )
        return "\n".join(lines) + "\n"


def _format_sample(name, label_pairs, value):
    body = ",".join(
        '%s="%s"' % (_prom_name(k), _prom_label_value(v))
        for k, v in label_pairs
    )
    if isinstance(value, float) and value == int(value):
        value = int(value)
    return "%s%s %s" % (
        _prom_name(name), "{%s}" % body if body else "", value
    )


metrics = MetricsRegistry()


def instrument_service_methods(methods, role, registry=None):
    """Wrap an rpc_methods() dict so every handler records its service
    time into ``edl_rpc_server_latency_seconds{role, method}``.

    One wrap point covers every transport: rpc.core.serve and the
    in-process direct-call path both go through the returned dict, so
    master get_task latency and PS push/pull service time become
    visible without touching any call site."""
    hist = (registry or metrics).histogram(
        "edl_rpc_server_latency_seconds",
        "RPC service time by servicer role and method",
        labels=("role", "method"),
    )
    errors = (registry or metrics).counter(
        "edl_rpc_server_errors_total",
        "RPC handler exceptions by servicer role and method",
        labels=("role", "method"),
    )

    def wrap(name, fn):
        rpc_span = "rpc/" + name

        def handler(*args, **kwargs):
            if not _metrics_on:
                return fn(*args, **kwargs)
            # cross-process tracing: a dict request carrying the
            # caller's "_sctx" context gets a server span joined to the
            # caller's trace (docs/observability.md); requests without
            # context (or non-dict in-process calls) record nothing
            sp = span_from_wire(
                args[0] if args else None, rpc_span, role=role
            )
            t0 = time.perf_counter()
            try:
                with sp:
                    return fn(*args, **kwargs)
            except Exception:
                errors.inc(role=role, method=name)
                raise
            finally:
                hist.observe(
                    time.perf_counter() - t0, role=role, method=name
                )

        return handler

    return {name: wrap(name, fn) for name, fn in methods.items()}


# ---------------------------------------------------------------------------
# structured job events
# ---------------------------------------------------------------------------


class EventLog:
    """Process-wide structured event log with monotonic ids.

    ``emit`` assigns the next id, appends to a bounded in-memory ring
    (``tail`` reads it), writes one JSON line to the attached file sink
    if any, and parks a copy on the bounded *pending* buffer that
    :meth:`drain_pending` empties — the worker telemetry snapshot ships
    pending events to the master, whose JobTelemetry re-logs them via
    :meth:`ingest` (ship=False, so aggregated events never re-enter a
    pending buffer and bounce forever in the in-process local mode
    where master and worker share this object)."""

    def __init__(self, capacity=2048, pending_capacity=256):
        self._lock = threading.Lock()
        self._next_id = 0
        self._ring = deque(maxlen=capacity)
        self._pending = deque(maxlen=pending_capacity)
        self._sink = None
        self._sink_path = None

    def attach_file(self, path):
        """Append JSON lines to ``path`` from now on (master-side)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # file IO outside the lock (no IO under a lock); swap under it
        sink = open(path, "a", encoding="utf-8")
        with self._lock:
            old, self._sink = self._sink, sink
            self._sink_path = path
        if old is not None:
            old.close()

    def close_file(self):
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
                self._sink_path = None

    def emit(self, kind, _ship=True, **fields):
        """Record one event; returns the event dict (with its id)."""
        if not _metrics_on:
            return None
        event = {"kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._next_id += 1
            event["id"] = self._next_id
            event["ts"] = round(time.time(), 6)
            self._ring.append(event)
            if _ship:
                self._pending.append(event)
            if self._sink is not None:
                try:
                    self._sink.write(
                        json.dumps(event, default=str) + "\n"
                    )
                    self._sink.flush()
                except OSError:
                    logger.warning(
                        "event sink write failed; detaching %s",
                        self._sink_path,
                    )
                    try:
                        self._sink.close()
                    except OSError:
                        pass
                    self._sink = None
        # OUTSIDE the lock: a triggering kind (PS shard failure, master
        # epoch change, task requeue, chaos kill) dumps the postmortem
        # rings to disk — IO that must never run under the event lock
        # (no IO under a lock), and the recorder re-reads the rings itself
        flight_recorder.on_event(event)
        return event

    def ingest(self, shipped_events, **extra):
        """Re-log events shipped from another process (new monotonic
        ids here; the origin's id/ts ride along as src_id/src_ts)."""
        for e in shipped_events or ():
            fields = {
                k: v
                for k, v in dict(e).items()
                if k not in ("id", "ts", "kind")
            }
            fields.update(extra)
            fields["src_id"] = e.get("id")
            fields["src_ts"] = e.get("ts")
            self.emit(e.get("kind", "unknown"), _ship=False, **fields)

    def drain_pending(self, max_n=64):
        """Pop up to ``max_n`` un-shipped events (worker piggyback)."""
        out = []
        with self._lock:
            while self._pending and len(out) < max_n:
                out.append(self._pending.popleft())
        return out

    def requeue(self, drained_events):
        """Put drained-but-unshipped events back at the head of the
        pending buffer — a failed report_telemetry must not lose them.
        If the buffer refilled meanwhile, the bounded deque sheds from
        the newest end; the requeued (older) events keep their slot."""
        if not drained_events:
            return
        with self._lock:
            self._pending.extendleft(reversed(list(drained_events)))

    def tail(self, n=100, since=None):
        """The last ``n`` events; with ``since`` only events whose
        monotonic id is strictly greater — the ``/events?since=<id>``
        cursor, so pollers stop re-reading the whole ring each scrape."""
        with self._lock:
            out = list(self._ring)
        if since is not None:
            since = int(since)
            out = [e for e in out if e.get("id", 0) > since]
        return out[-n:]

    def last_id(self):
        """The newest assigned event id (0 before the first emit) —
        what a ``?since=`` poller should resume from."""
        with self._lock:
            return self._next_id

    def reset(self):
        """Tests only: drop state, detach the sink, restart ids."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = None
            self._sink_path = None
            self._ring.clear()
            self._pending.clear()
            self._next_id = 0


events = EventLog()


# ---------------------------------------------------------------------------
# distributed tracing: cross-process spans (docs/observability.md)
# ---------------------------------------------------------------------------

_span_stack = threading.local()  # per-thread stack of OPEN spans


def _stack():
    stack = getattr(_span_stack, "v", None)
    if stack is None:
        stack = _span_stack.v = []
    return stack


def _json_scalar(v):
    return (
        v
        if isinstance(v, (str, int, float, bool, type(None)))
        else str(v)
    )


class _NullSpan:
    """The disabled-tracing span (EDL_METRICS=0): every operation is a
    no-op, so call sites never branch on the kill switch themselves."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **fields):
        return self

    def set_trace(self, trace_id):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation inside a cross-process trace.

    Identity: ``trace_id`` (the job-level correlation key — for task
    work this is the dispatcher's PR-6 task trace id, stable across
    requeues and a master relaunch), ``span_id`` (process-unique:
    ``<proc>/<seq>``), ``parent_id``. Timestamps: ``ts`` is wall clock
    at ``__enter__`` (what aligns processes in one timeline — same-host
    fleets align exactly, cross-host to NTP skew), the duration is a
    monotonic ``perf_counter`` pair. Use as a context manager; entering
    pushes onto the per-thread context stack so nested spans inherit
    trace and parent, and exiting records the finished span into the
    owning :class:`SpanLog`."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "fields",
        "_log",
        "_ts",
        "_t0",
        "_thread",
    )

    def __init__(self, log, name, trace_id, span_id, parent_id, fields):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.fields = fields
        self._log = log
        self._ts = None
        self._t0 = None
        self._thread = None

    def add(self, **fields):
        """Attach fields to the (still open) span."""
        self.fields.update(
            (k, _json_scalar(v)) for k, v in fields.items()
        )
        return self

    def set_trace(self, trace_id):
        """Late trace binding: a dispatch span learns its task's trace
        only after the stamp. First binding wins."""
        if self.trace_id is None and trace_id is not None:
            self.trace_id = trace_id
        return self

    def __enter__(self):
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._thread = threading.current_thread().name
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # exotic exit order: drop this span wherever it sits
            try:
                stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.fields.setdefault("error", exc_type.__name__)
        self._log._finish(self, dur)
        return False


class SpanLog:
    """Process-wide span recorder: bounded ring + pending ship buffer.

    Mirrors :class:`EventLog`'s shape on purpose: finished spans append
    to a bounded in-memory ring (the ``/trace`` endpoint and the flight
    recorder read it) and to a bounded *pending* buffer that the worker
    telemetry snapshot drains — spans piggyback on the same
    ``report_telemetry`` RPC as events, so no new wire surface exists
    for tracing. Span records are plain JSON-safe dicts::

        {"name", "trace", "span", "parent", "proc", "thread",
         "ts" (wall secs), "dur" (secs), ...user fields}

    ``set_process`` names this process in every span id and record
    (``worker-3`` / ``ps-1`` / ``master``; default ``pid-<pid>``) —
    process entry points set it, in-process test jobs keep the default.
    """

    def __init__(self, capacity=4096, pending_capacity=1024):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)
        self._pending = deque(maxlen=pending_capacity)
        self._seq = 0
        self._proc = "pid-%d" % os.getpid()
        # ingest dedup: a worker's report_telemetry retried through an
        # UNAVAILABLE-after-processing window re-ships the SAME spans;
        # span ids are process-scoped unique, so remembering the last
        # ring's worth of ingested ids makes ingestion idempotent
        # (bounded: the deque evicts, the set mirrors it)
        self._ingested_order = deque(maxlen=capacity)
        self._ingested = set()

    def set_process(self, proc):
        with self._lock:
            self._proc = str(proc)

    @property
    def process(self):
        with self._lock:
            return self._proc

    def begin(self, name, trace_id=None, parent_id=None, **fields):
        """Open a span; inherit trace/parent from the innermost open
        span on THIS thread unless given explicitly. Prefer the
        module-level :func:`span` (it honors the kill switch)."""
        stack = _stack()
        if stack:
            top = stack[-1]
            if parent_id is None:
                parent_id = top.span_id
            if trace_id is None:
                trace_id = top.trace_id
        with self._lock:
            self._seq += 1
            span_id = "%s/%d" % (self._proc, self._seq)
        return Span(
            self,
            str(name),
            trace_id if trace_id is None else str(trace_id),
            span_id,
            parent_id,
            {k: _json_scalar(v) for k, v in fields.items()},
        )

    def _finish(self, span, dur):
        rec = {
            "name": span.name,
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "thread": span._thread,
            "ts": round(span._ts, 6),
            "dur": round(dur, 6),
        }
        rec.update(span.fields)
        with self._lock:
            rec["proc"] = self._proc
            self._ring.append(rec)
            self._pending.append(rec)

    def ingest(self, shipped_spans, **extra):
        """Append spans shipped from another process to the ring (the
        master aggregating its fleet). Span ids are process-scoped
        unique, so records keep their identity; spans stamped with THIS
        process's tag are skipped — in the in-process local mode the
        worker and master share one SpanLog, and re-appending a drained
        span would duplicate it in the timeline. Already-seen span ids
        are skipped too: a snapshot resent through a connection-reset
        window (report_telemetry is retriable) must not double its
        spans into /trace and the tracetool breakdown."""
        if not shipped_spans:
            return
        with self._lock:
            own = self._proc
            for s in shipped_spans:
                if not isinstance(s, dict) or s.get("proc") == own:
                    continue
                sid = s.get("span")
                if sid is not None:
                    if sid in self._ingested:
                        continue
                    if len(self._ingested_order) == (
                        self._ingested_order.maxlen
                    ):
                        self._ingested.discard(
                            self._ingested_order.popleft()
                        )
                    self._ingested_order.append(sid)
                    self._ingested.add(sid)
                if extra:
                    s = dict(s)
                    s.update(extra)
                self._ring.append(s)

    def drain_pending(self, max_n=256):
        """Pop up to ``max_n`` un-shipped spans (worker piggyback)."""
        out = []
        with self._lock:
            while self._pending and len(out) < max_n:
                out.append(self._pending.popleft())
        return out

    def requeue(self, drained_spans):
        """Put drained-but-unshipped spans back (failed telemetry ship
        must not lose them; same contract as EventLog.requeue)."""
        if not drained_spans:
            return
        with self._lock:
            self._pending.extendleft(reversed(list(drained_spans)))

    def tail(self, n=4096):
        with self._lock:
            return list(self._ring)[-n:]

    def reset(self):
        """Tests only: drop state, restart ids (keeps the proc tag)."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._ingested_order.clear()
            self._ingested.clear()
            self._seq = 0


spans = SpanLog()


def span(name, trace_id=None, parent_id=None, **fields):
    """Open one timed span (context manager). Returns the no-op
    :data:`NULL_SPAN` when telemetry is disabled (EDL_METRICS=0), so
    the hot path pays one module-global read. Record around a
    dispatch, never inside the model's forward."""
    if not _metrics_on:
        return NULL_SPAN
    return spans.begin(
        name, trace_id=trace_id, parent_id=parent_id, **fields
    )


def current_span():
    """The innermost open span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def wire_span_context():
    """``[trace_id, span_id]`` of the innermost open TRACED span, or
    None — what rpc clients inject as the request's ``_sctx`` field so
    the serving process's spans join the caller's trace."""
    if not _metrics_on:
        return None
    stack = _stack()
    if not stack:
        return None
    top = stack[-1]
    if top.trace_id is None:
        return None
    return [top.trace_id, top.span_id]


def span_from_wire(req, name, **fields):
    """Server side of the propagation: a span parented on the request's
    ``_sctx`` context (see :func:`wire_span_context`), or NULL_SPAN
    when the request carries none — untraced RPCs record nothing, so
    the server ring holds only spans that join a real trace."""
    if not _metrics_on or not isinstance(req, dict):
        return NULL_SPAN
    sctx = req.get("_sctx")
    if not (isinstance(sctx, (list, tuple)) and len(sctx) == 2):
        return NULL_SPAN
    return spans.begin(
        name, trace_id=sctx[0], parent_id=sctx[1], **fields
    )


def chrome_trace(span_records):
    """Span records -> a Chrome trace-event JSON document (the
    Perfetto-loadable catapult format): one complete ``"X"`` event per
    span (microsecond wall timestamps), with ``process_name`` /
    ``thread_name`` metadata mapping the string proc/thread tags onto
    the integer pids/tids the format requires."""
    procs = {}
    threads = {}
    out = []
    for rec in span_records:
        if not isinstance(rec, dict):
            continue
        proc = str(rec.get("proc", "?"))
        pid = procs.setdefault(proc, len(procs) + 1)
        tname = str(rec.get("thread", "main"))
        tid = threads.setdefault((proc, tname), len(threads) + 1)
        args = {
            k: v
            for k, v in rec.items()
            if k not in ("name", "ts", "dur", "proc", "thread")
        }
        out.append(
            {
                "name": rec.get("name", "?"),
                "cat": "edl",
                "ph": "X",
                "ts": round(float(rec.get("ts", 0.0)) * 1e6, 3),
                "dur": round(float(rec.get("dur", 0.0)) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    meta = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": proc},
        }
        for proc, pid in procs.items()
    ] + [
        {
            "ph": "M",
            "name": "thread_name",
            "pid": procs[proc],
            "tid": tid,
            "args": {"name": tname},
        }
        for (proc, tname), tid in threads.items()
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# crash flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Freezes the last N spans + events to a postmortem JSONL when a
    failure-shaped job event fires (docs/observability.md "The crash
    flight recorder").

    Armed per process with a directory "next to the journal/snapshots"
    (the master arms ``<journal_dir>/postmortem``, a PS shard
    ``<snapshot_dir>/ps-<id>/postmortem``, any process via
    ``EDL_FLIGHT_RECORDER_DIR``). :meth:`on_event` is called by
    ``EventLog.emit`` AFTER its lock drops; a triggering kind dumps one
    ``postmortem-<seq>-<reason>.jsonl``: a header line, then the event
    tail, then the span tail — every line independently
    ``json.loads``-able. Dumps are rate-limited (``min_interval_s``)
    so a requeue storm cannot spam the disk, and pruned to ``keep``
    files newest-last."""

    TRIGGER_KINDS = frozenset(
        (
            "ps_shard_failure",
            "master_epoch_change",
            "master_recovery",
            "task_requeued",
            "chaos_kill",
            "chaos_term",
        )
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._dir = None
        self._keep = 8
        self._min_interval = 5.0
        self._tail = 256
        self._seq = 0
        self._last_mono = None

    def arm(self, directory, keep=8, min_interval_s=5.0, tail=256):
        """Point the recorder at ``directory`` (created if missing)."""
        directory = str(directory)
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dir = directory
            self._keep = max(1, int(keep))
            self._min_interval = max(0.0, float(min_interval_s))
            self._tail = max(1, int(tail))
            # a fresh arming is a fresh session: the rate limiter must
            # not carry a previous job's last-dump clock
            self._last_mono = None
        return self

    def disarm(self):
        with self._lock:
            self._dir = None

    @property
    def armed(self):
        with self._lock:
            return self._dir is not None

    def on_event(self, event):
        """EventLog.emit hook (runs OUTSIDE the event lock)."""
        if event and event.get("kind") in self.TRIGGER_KINDS:
            self.trigger(event.get("kind"), event)

    def trigger(self, reason, trigger_event=None):
        """Dump one postmortem now; returns its path (None when
        disarmed, rate-limited, or the write failed)."""
        if not _metrics_on:
            return None
        with self._lock:
            d = self._dir
            if d is None:
                return None
            now = time.monotonic()
            if (
                self._last_mono is not None
                and now - self._last_mono < self._min_interval
            ):
                return None
            self._last_mono = now
            self._seq += 1
            seq = self._seq
            keep = self._keep
            tail = self._tail
        # all IO below runs OUTSIDE the recorder lock (no IO under a lock); the
        # ring tails are independently consistent snapshots
        safe_reason = _NAME_SANITIZE.sub("_", str(reason))[:40]
        path = os.path.join(
            d, "postmortem-%03d-%s.jsonl" % (seq, safe_reason)
        )
        header = {
            "postmortem": str(reason),
            "ts": round(time.time(), 6),
            "proc": spans.process,
            "seq": seq,
        }
        if trigger_event is not None:
            header["trigger"] = {
                k: _json_scalar(v) for k, v in trigger_event.items()
            }
        event_tail = events.tail(tail)
        span_tail = spans.tail(tail)
        lines = [header]
        lines.extend({"type": "event", **e} for e in event_tail)
        lines.extend({"type": "span", **s} for s in span_tail)
        try:
            with open(path, "w", encoding="utf-8") as f:
                for obj in lines:
                    f.write(json.dumps(obj, default=str) + "\n")
        except OSError:
            logger.warning(
                "flight recorder dump to %s failed", path, exc_info=True
            )
            return None
        self._prune(d, keep)
        logger.warning(
            "flight recorder: %s -> %s (%d events, %d spans)",
            reason,
            path,
            len(event_tail),
            len(span_tail),
        )
        return path

    @staticmethod
    def _prune(directory, keep):
        dumps = sorted(
            glob.glob(os.path.join(directory, "postmortem-*.jsonl"))
        )
        for stale in dumps[:-keep]:
            try:
                os.remove(stale)
            except OSError:
                pass


flight_recorder = FlightRecorder()


def maybe_arm_flight_recorder(directory=None):
    """Arm the process flight recorder from ``directory`` or the
    ``EDL_FLIGHT_RECORDER_DIR`` env (worker pods have no durable
    directory of their own, so the env is their switch). Returns
    whether the recorder is armed."""
    d = directory or os.environ.get("EDL_FLIGHT_RECORDER_DIR")
    if d:
        flight_recorder.arm(d)
    return flight_recorder.armed


class Counters:
    """Process-wide named counters (int or float accumulators).

    Cheap enough for hot-path increments (one small lock, no device
    interaction); consumers read a consistent copy via
    :meth:`snapshot`. Namespacing is by convention:
    ``"compile_plane/hits"``, ``"compile_plane/aot_compile_s"``.

    Kept as a compatible shim over the telemetry plane: the registry
    exposes every named counter as ``edl_counter{name="..."}`` via a
    collector (see module bottom), so legacy callers keep this API and
    still land in ``/metrics``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}

    def inc(self, name, value=1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + value

    def get(self, name, default=0):
        with self._lock:
            return self._counts.get(name, default)

    def snapshot(self, prefix=None):
        with self._lock:
            if prefix is None:
                return dict(self._counts)
            return {
                k: v
                for k, v in self._counts.items()
                if k.startswith(prefix)
            }

    def reset(self, prefix=None):
        with self._lock:
            if prefix is None:
                self._counts.clear()
            else:
                for k in [k for k in self._counts if k.startswith(prefix)]:
                    del self._counts[k]


counters = Counters()


def _counters_collector():
    """Bridge the legacy Counters shim into the exposition."""
    return [
        ("edl_counter", {"name": name}, value)
        for name, value in sorted(counters.snapshot().items())
    ]


metrics.register_collector(_counters_collector)


def _nearest_rank(xs, pct):
    """Nearest-rank percentile (ceil indexing) over SORTED ``xs``.

    ``xs[ceil(pct/100 * n) - 1]`` — the textbook definition; the old
    ``xs[n // 2]`` / ``xs[int(n * 0.99)]`` indices were biased high for
    small n (for n=2 they returned the max as the median)."""
    n = len(xs)
    rank = -(-pct * n // 100)  # ceil(pct*n/100) without floats
    return xs[max(0, min(n - 1, int(rank) - 1))]


class step_timer:
    """Rolling wall-clock stats for the hot loop (mean/p50/p99 ms)."""

    def __init__(self, capacity=1024):
        self._times = []
        self._capacity = capacity
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self._capacity:
                self._times = self._times[-self._capacity :]
        self._last = now

    def stats(self):
        if not self._times:
            return {}
        xs = sorted(self._times)
        n = len(xs)
        return {
            "steps": n,
            "mean_ms": 1e3 * sum(xs) / n,
            "p50_ms": 1e3 * _nearest_rank(xs, 50),
            "p90_ms": 1e3 * _nearest_rank(xs, 90),
            "p99_ms": 1e3 * _nearest_rank(xs, 99),
            "max_ms": 1e3 * xs[-1],
        }
