"""Master-side job telemetry: fleet aggregation + /metrics + events; the
port of ``elasticdl_tpu/master/telemetry.py``.

The layer between per-process signals and a job-wide view
(docs/observability.md): workers piggyback compact telemetry snapshots
on their existing master RPC channel (``report_telemetry``, sent behind
task reports at a low cadence), and :class:`JobTelemetry` aggregates
them into the process metrics registry —

- per-worker gauges (``edl_worker_examples_per_sec{worker=...}``,
  steps/sec, input-plane stage seconds, consumer-starved ratio,
  hot-row cache hit rate),
- job-level aggregates (``edl_job_examples_per_sec`` summed over
  workers heard from recently),
- live task-queue depth straight from the dispatcher at scrape time
  (a registry collector, so the gauge can never go stale),
- worker-shipped events re-logged into the master's
  :data:`profiling.events` JSONL stream with this process's monotonic
  ids (resize begin/end, PS shard failures — plus the master's own task
  requeue/timeline and worker join/leave events).

:class:`TelemetryHTTPServer` serves the registry as Prometheus text on
``/metrics`` (plus ``/events`` as a JSONL tail and ``/healthz``);
:class:`TelemetryTBExporter` mirrors registry scalars into the
TensorBoard event-file format next to the loss curves
(common/tb_events.py), gated on ``--tensorboard_log_dir``.

Everything here is scrape/report cadence — nothing touches a training
hot loop.
"""

import http.server
import json
import threading
import time
import urllib.parse

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling

# a worker silent for longer than this drops out of job aggregates
# (its last gauges stay visible, labeled, for post-mortems)
STALE_WORKER_SECS = 60.0


class ProcessTelemetry:
    """The single-process telemetry surface for TelemetryHTTPServer.

    A PS shard (or any process with no fleet to aggregate) serves its
    OWN registry/events/spans behind ``--ps_telemetry_port`` with this
    adapter — /metrics, /events (with the ?since cursor), and /trace
    all answer from the process-wide singletons in utils/profiling
    (docs/observability.md, docs/ps_recovery.md). :class:`JobTelemetry`
    extends it with fleet aggregation, so the master and PS endpoints
    share one implementation of every read surface."""

    def __init__(self, registry=None, event_log=None, span_log=None):
        self._registry = registry or profiling.metrics
        self._events = event_log or profiling.events
        self._spans = span_log or profiling.spans

    def prometheus_text(self):
        return self._registry.prometheus_text()

    def events_tail(self, n=200, since=None):
        return self._events.tail(n, since=since)

    def trace_events(self, trace_id=None, n=4096):
        """The span ring as Chrome trace-event JSON — what ``GET
        /trace`` serves and ``tools/tracetool.py`` decomposes into a
        per-step critical-path breakdown. ``trace_id`` filters to one
        task trace."""
        recs = self._spans.tail(n)
        if trace_id:
            recs = [r for r in recs if r.get("trace") == trace_id]
        return profiling.chrome_trace(recs)


class JobTelemetry(ProcessTelemetry):
    """Aggregates worker telemetry snapshots into the metrics registry.

    ``task_dispatcher`` (optional) feeds the live task-queue-depth
    collector; ``registry``/``event_log`` default to the process-wide
    singletons in utils/profiling.
    """

    def __init__(
        self,
        task_dispatcher=None,
        registry=None,
        event_log=None,
        span_log=None,
    ):
        super().__init__(
            registry=registry, event_log=event_log, span_log=span_log
        )
        self._task_d = task_dispatcher
        self._lock = threading.Lock()
        self._workers = {}  # worker_id -> (snapshot, monotonic recv time)

        r = self._registry
        self._g_examples = r.gauge(
            "edl_worker_examples_per_sec",
            "Examples/sec reported by each worker over its last "
            "telemetry interval",
            labels=("worker",),
        )
        self._g_steps = r.gauge(
            "edl_worker_steps_per_sec",
            "Training steps/sec reported by each worker",
            labels=("worker",),
        )
        self._g_input = r.gauge(
            "edl_worker_input_stage_seconds",
            "Input-plane stage seconds per worker since its last "
            "stream boundary "
            "(task_starved/read/parse/batch/consumer_starved/ack)",
            labels=("worker", "stage"),
        )
        self._g_starved = r.gauge(
            "edl_worker_consumer_starved_ratio",
            "Fraction of the last telemetry interval the worker's "
            "train loop spent waiting on an empty input buffer",
            labels=("worker",),
        )
        self._g_hot_row = r.gauge(
            "edl_worker_hot_row_hit_rate",
            "Hot-row embedding cache hit rate per worker",
            labels=("worker",),
        )
        self._g_job_examples = r.gauge(
            "edl_job_examples_per_sec",
            "Job-wide examples/sec (sum over workers reporting within "
            "the staleness window)",
        )
        self._g_job_workers = r.gauge(
            "edl_job_reporting_workers",
            "Workers heard from within the staleness window",
        )
        self._c_reports = r.counter(
            "edl_telemetry_reports_total",
            "Worker telemetry snapshots ingested",
            labels=("worker",),
        )
        if task_dispatcher is not None:
            r.register_collector(self._collect_queue_depth)

    def close(self):
        """Detach the scrape-time collector (repeated in-process
        masters — tests, the local API — must not accumulate stale
        dispatcher references on the process registry)."""
        self._registry.unregister_collector(self._collect_queue_depth)

    # -- ingestion ----------------------------------------------------------

    def ingest(self, snapshot):
        """One worker snapshot (worker/telemetry.py builds it)."""
        if not isinstance(snapshot, dict):
            return
        worker = str(snapshot.get("worker_id", "?"))
        now = time.monotonic()
        with self._lock:
            self._workers[worker] = (snapshot, now)
        self._c_reports.inc(worker=worker)
        self._g_examples.set(
            float(snapshot.get("examples_per_sec", 0.0)), worker=worker
        )
        self._g_steps.set(
            float(snapshot.get("steps_per_sec", 0.0)), worker=worker
        )
        input_totals = snapshot.get("input") or {}
        for field, value in input_totals.items():
            if field.endswith("_s"):
                self._g_input.set(
                    float(value), worker=worker, stage=field[:-2]
                )
        if "consumer_starved_ratio" in snapshot:
            self._g_starved.set(
                float(snapshot["consumer_starved_ratio"]), worker=worker
            )
        if snapshot.get("hot_row_hit_rate") is not None:
            self._g_hot_row.set(
                float(snapshot["hot_row_hit_rate"]), worker=worker
            )
        shipped = snapshot.get("events")
        if shipped:
            self._events.ingest(shipped, worker=worker)
        shipped_spans = snapshot.get("spans")
        if shipped_spans:
            # worker spans join the master's span ring (ids stay
            # process-scoped unique), so /trace serves one job-wide
            # timeline (docs/observability.md)
            self._spans.ingest(shipped_spans)
        self._update_job_aggregates(now)

    def _update_job_aggregates(self, now):
        with self._lock:
            live = [
                snap
                for snap, t in self._workers.values()
                if now - t <= STALE_WORKER_SECS
            ]
        self._g_job_examples.set(
            sum(float(s.get("examples_per_sec", 0.0)) for s in live)
        )
        self._g_job_workers.set(len(live))

    def worker_snapshots(self):
        with self._lock:
            return {w: snap for w, (snap, _) in self._workers.items()}

    # -- scrape-time state --------------------------------------------------

    def _collect_queue_depth(self):
        depths = self._task_d.queue_depths()
        return [
            ("edl_task_queue_depth", {"queue": q}, n)
            for q, n in sorted(depths.items())
        ]

    def prometheus_text(self):
        self._update_job_aggregates(time.monotonic())
        return self._registry.prometheus_text()
    # events_tail / trace_events inherited from ProcessTelemetry: the
    # master's span ring already holds its own + every worker's
    # shipped spans (ingest above), so the read surface is identical


class _TelemetryHandler(http.server.BaseHTTPRequestHandler):
    # the server instance injects .telemetry (and optionally
    # .health_fn) on the handler class
    telemetry = None
    health_fn = None

    def do_GET(self):
        code = 200
        path, _, query = self.path.partition("?")
        params = urllib.parse.parse_qs(query)
        if path == "/metrics":
            body = self.telemetry.prometheus_text().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/events":
            # ?since=<id>: the EventLog's monotonic ids are the cursor,
            # so a poller resumes from its last seen id instead of
            # re-reading the whole ring each scrape
            since = None
            if "since" in params:
                try:
                    since = int(params["since"][0])
                except (ValueError, IndexError):
                    self.send_error(400, "since must be an integer id")
                    return
            body = (
                "\n".join(
                    json.dumps(e, default=str)
                    for e in self.telemetry.events_tail(since=since)
                )
                + "\n"
            ).encode("utf-8")
            ctype = "application/x-ndjson"
        elif path == "/trace":
            # Chrome trace-event JSON (open in Perfetto / chrome://
            # tracing, or feed tools/tracetool.py); ?trace_id= filters
            # to one task trace
            if not hasattr(self.telemetry, "trace_events"):
                self.send_error(404)
                return
            trace_id = (params.get("trace_id") or [None])[0]
            body = json.dumps(
                self.telemetry.trace_events(trace_id=trace_id),
                default=str,
            ).encode("utf-8")
            ctype = "application/json"
        elif path == "/healthz":
            # recovery-plane readiness (docs/master_recovery.md): a
            # relaunched master serves "restoring" (503) while its
            # journal replays, so probes don't route traffic — or
            # declare the pod dead — against a half-restored ledger;
            # "serving" (200) only once the RPC plane is up
            state = "serving"
            if self.health_fn is not None:
                try:
                    state = str(self.health_fn())
                except Exception:  # noqa: BLE001 — a probe must answer
                    state = "unknown"
            code = 200 if state in ("serving", "ok") else 503
            body, ctype = (state + "\n").encode("utf-8"), "text/plain"
        else:
            self.send_error(404)
            return
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.debug("telemetry http: " + fmt, *args)


class TelemetryHTTPServer:
    """Serves /metrics (Prometheus text), /events (JSONL, ?since=id
    cursor), /trace (Chrome trace-event JSON), /healthz.

    ``port=0`` binds an ephemeral port (exposed as ``.port``). The
    serving thread is a daemon AND joined in :meth:`close`."""

    def __init__(self, telemetry, port=0, host="", health_fn=None):
        handler = type(
            "_BoundTelemetryHandler",
            (_TelemetryHandler,),
            {
                "telemetry": telemetry,
                # staticmethod: a bare function stored as a class attr
                # would bind as a method and receive the handler as a
                # spurious first argument
                "health_fn": (
                    staticmethod(health_fn)
                    if health_fn is not None
                    else None
                ),
            },
        )
        self._server = self._bind(host, port, handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name="edl-telemetry-http",
        )
        self._thread.start()
        logger.info("telemetry /metrics endpoint on port %d", self.port)

    @staticmethod
    def _bind(host, port, handler, retries=20, backoff_s=0.25):
        """Bind, riding out a predecessor's lingering socket.

        A RELAUNCHED master re-binds the same fixed telemetry port its
        killed predecessor held; allow_reuse_address clears TIME_WAIT,
        but the old process (or its half-dead kernel socket) can hold
        the port for a beat longer — retry briefly instead of failing
        the whole boot over a probe endpoint."""
        last_err = None
        for _ in range(max(1, retries)):
            try:
                return http.server.ThreadingHTTPServer(
                    (host, port), handler
                )
            except OSError as err:
                last_err = err
                if port == 0:
                    raise  # ephemeral bind failing is not a relaunch race
                time.sleep(backoff_s)
        raise last_err

    def close(self):
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()


class TelemetryTBExporter:
    """Mirrors registry scalars into TensorBoard event files.

    One scalar per counter/gauge series (labels joined into the tag)
    plus count/sum/mean per histogram series, written every
    ``interval_s`` under ``telemetry/...`` tags — so fleet counters
    land in the same dashboard as the loss curves the evaluation
    service already writes. ``step_fn`` supplies the global step
    (default: the master's model version)."""

    def __init__(
        self, logdir, registry=None, step_fn=None, interval_s=15.0
    ):
        from elasticdl_tpu_torch.common.tb_events import EventFileWriter

        self._registry = registry or profiling.metrics
        self._step_fn = step_fn or (lambda: self._flushes)
        self._interval = interval_s
        self._writer = EventFileWriter(
            logdir, filename_suffix=".telemetry"
        )
        self._flushes = 0
        # the exporter thread and close()'s final flush both run
        # flush(); without this the _flushes bump is a lost-update and
        # two flushes can interleave add_scalars at the same step
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="edl-telemetry-tb"
        )
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.flush()
            except Exception:
                logger.warning(
                    "telemetry TB flush failed", exc_info=True
                )

    def flush(self):
        with self._flush_lock:
            self._do_flush()

    def _do_flush(self):
        snap = self._registry.snapshot()
        scalars = []
        for name, series in sorted(snap.items()):
            for key, value in series.items():
                tag = "telemetry/" + name
                if key:
                    tag += "/" + "_".join(str(k) for k in key)
                if isinstance(value, tuple):  # histogram
                    _, total, count = value
                    scalars.append((tag + "/count", float(count)))
                    scalars.append((tag + "/sum", float(total)))
                    if count:
                        scalars.append(
                            (tag + "/mean", float(total) / count)
                        )
                else:
                    scalars.append((tag, float(value)))
        self._flushes += 1
        try:
            step = int(self._step_fn())
        except Exception:
            step = self._flushes
        self._writer.add_scalars(scalars, step)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self.flush()  # final snapshot so short jobs still export
        except Exception:
            logger.debug("final telemetry TB flush failed", exc_info=True)
        self._writer.close()
