"""Process telemetry for the serving path: the parts of
``elasticdl_tpu/utils/profiling.py`` the scorer uses.

- a metrics registry of labeled counters and fixed-bucket histograms
  (Prometheus ``le`` semantics, bounded label cardinality, scrape-time
  collectors, ``quantile`` for SLO admission control);
- a structured event log with monotonic ids (``events.emit``);
- a span log naming this process (``spans.set_process``) and the
  server-side RPC span joined to a caller's trace context;
- :func:`instrument_service_methods`, which records every RPC handler's
  service time.

``EDL_METRICS=0`` turns every record call into a no-op. Not ported yet:
gauges and the Prometheus text exposition (they serve the telemetry
endpoint), the device profiler hooks and the flight recorder.
"""

import bisect
import os
import threading
import time
from collections import deque

from elasticdl_tpu_torch.common.log_utils import default_logger as logger

_metrics_on = os.environ.get("EDL_METRICS", "1") != "0"


DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _Metric:
    """One family: a series per distinct label tuple, one lock. Past
    ``max_series`` tuples, new ones collapse into an ``(overflow)``
    series."""

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


class Histogram(_Metric):
    """Fixed-bucket histogram: a bucket counts observations <= its
    upper edge; +Inf is implicit."""

    kind = "histogram"

    def __init__(self, name, help_text, label_names, max_series, buckets):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = buckets
        super().__init__(name, help_text, label_names, max_series)

    def _new_series(self):
        # [bucket_counts..., +Inf count], sum, count
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
        """(bucket_counts, sum, count) copies, or None."""
        with self._lock:
            slot = self._series.get(self._key(labels))
            if slot is None:
                return None
            return list(slot[0]), slot[1], slot[2]

    def quantile(self, q, **labels):
        """Upper-bound estimate of the ``q`` quantile: the smallest
        bucket edge whose cumulative count covers ``q * count`` (the
        last finite edge when it lands in +Inf); None when empty."""
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


class MetricsRegistry:
    """Process-wide named metric families plus scrape-time collectors
    (callables returning ``[(name, {label: value}, number)]``)."""

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


metrics = MetricsRegistry()


# ---------------------------------------------------------------------------
# structured events
# ---------------------------------------------------------------------------


class EventLog:
    """Bounded in-memory ring of event dicts with monotonic ids."""

    def __init__(self, capacity=2048):
        self._lock = threading.Lock()
        self._next_id = 0
        self._ring = deque(maxlen=capacity)

    def emit(self, kind, **fields):
        """Record one event; returns it (with its id), None when off."""
        if not _metrics_on:
            return None
        event = {"kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._next_id += 1
            event["id"] = self._next_id
            event["ts"] = round(time.time(), 6)
            self._ring.append(event)
        return event

    def tail(self, n=100, since=None):
        with self._lock:
            out = list(self._ring)
        if since is not None:
            out = [e for e in out if e.get("id", 0) > int(since)]
        return out[-n:]


events = EventLog()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """The span of an untraced request or a disabled plane: a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation joined to a caller's trace."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "fields",
                 "_log", "_ts", "_t0")

    def __init__(self, log, name, trace_id, span_id, parent_id, fields):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.fields = fields
        self._log = log
        self._ts = None
        self._t0 = None

    def __enter__(self):
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.fields.setdefault("error", exc_type.__name__)
        self._log._finish(self, time.perf_counter() - self._t0)
        return False


class SpanLog:
    """Bounded ring of finished span records; ``set_process`` names
    this process in every span id (``scorer-0``)."""

    def __init__(self, capacity=4096):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)
        self._seq = 0
        self._proc = "pid-%d" % os.getpid()

    def set_process(self, proc):
        with self._lock:
            self._proc = str(proc)

    @property
    def process(self):
        with self._lock:
            return self._proc

    def begin(self, name, trace_id=None, parent_id=None, **fields):
        with self._lock:
            self._seq += 1
            span_id = "%s/%d" % (self._proc, self._seq)
        return Span(self, str(name), trace_id, span_id, parent_id, fields)

    def _finish(self, span, dur):
        rec = {
            "name": span.name,
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "ts": round(span._ts, 6),
            "dur": round(dur, 6),
        }
        rec.update(span.fields)
        with self._lock:
            rec["proc"] = self._proc
            self._ring.append(rec)

    def tail(self, n=4096):
        with self._lock:
            return list(self._ring)[-n:]


spans = SpanLog()


def span_from_wire(req, name, **fields):
    """A server span parented on the request's ``_sctx`` context
    (``[trace_id, span_id]``), or the no-op span when it has none."""
    if not _metrics_on or not isinstance(req, dict):
        return NULL_SPAN
    sctx = req.get("_sctx")
    if not (isinstance(sctx, (list, tuple)) and len(sctx) == 2):
        return NULL_SPAN
    return spans.begin(name, trace_id=sctx[0], parent_id=sctx[1], **fields)


def instrument_service_methods(methods, role, registry=None):
    """Wrap ``{name: fn(request)}`` so every handler records its service
    time into ``edl_rpc_server_latency_seconds{role, method}`` and its
    exceptions into ``edl_rpc_server_errors_total``."""
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
            sp = span_from_wire(args[0] if args else None, rpc_span, role=role)
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
