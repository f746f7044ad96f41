"""The port's telemetry plane against the reference's
(``elasticdl_tpu/utils/profiling.py``, ``master/telemetry.py``,
``worker/telemetry.py``, ``common/tb_events.py``): the same calls from
numpy-seeded inputs give the same Prometheus exposition byte for byte,
the same TensorBoard records, and the same job view after the same
worker snapshots; the flight recorder's triggers, rate limit and pruning;
``EDL_METRICS=0`` recording nothing; and the LM scorer serving its
``/metrics`` beside replies within the JAX scorer's tolerance."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import export as jexport
from elasticdl_tpu.common import tb_events as jtb
from elasticdl_tpu.master import telemetry as jtele
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu.serving.scorer import ScorerModel as JaxScorerModel
from elasticdl_tpu.utils import profiling as jprof
from elasticdl_tpu.worker import telemetry as jwtele
from elasticdl_tpu_torch.common import tb_events as ttb
from elasticdl_tpu_torch.common.args import parse_scorer_args
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str
from elasticdl_tpu_torch.data.input_stats import InputPlaneStats
from elasticdl_tpu_torch.master import telemetry as ttele
from elasticdl_tpu_torch.master.tensorboard_service import TensorboardService
from elasticdl_tpu_torch.rpc.socket_transport import Client
from elasticdl_tpu_torch.serving.main import build_scorer
from elasticdl_tpu_torch.serving.server import ScorerServer
from elasticdl_tpu_torch.utils import profiling as tprof
from elasticdl_tpu_torch.worker import telemetry as twtele
from model_zoo.transformer_lm import transformer_lm as jzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = [("reference", jprof), ("port", tprof)]


# ---------------------------------------------------------------------------
# the registry's exposition
# ---------------------------------------------------------------------------


def _drive_registry(prof, seed, max_series=None):
    """One registry driven by the same seeded calls: labeled counters
    (a label value that needs escaping), gauges, histograms on the
    default and on custom buckets with observations exactly on the
    edges, a family without help, a collector; ``max_series`` bounds
    the cardinality so that new label values overflow."""
    registry = prof.MetricsRegistry()
    if max_series is not None:
        registry.MAX_SERIES = max_series
    rng = np.random.default_rng(seed)
    requests = registry.counter(
        "edl_test_requests_total", "Requests by outcome",
        labels=("outcome", "role"),
    )
    depth = registry.gauge("edl_test_depth", "Queue depth", labels=("q",))
    latency = registry.histogram(
        "edl_test_latency_seconds", "Latency by method", labels=("method",)
    )
    rows = registry.histogram(
        "edl_test_rows", "Rows per batch", buckets=(8, 1, 4, 2)
    )
    plain = registry.counter("edl_test_plain_total")
    edges = list(prof.DEFAULT_LATENCY_BUCKETS)
    outcomes = ("ok", "error", "shed")
    for _ in range(300):
        requests.inc(
            float(rng.integers(1, 4)),
            outcome=outcomes[rng.integers(3)],
            role='we"ird\\\nrole' if rng.random() < 0.2 else "scorer",
        )
        depth.set(float(rng.normal()), q="q%d" % rng.integers(6))
        depth.inc(0.5, q="q0")
        value = (
            edges[rng.integers(len(edges))]
            if rng.random() < 0.3
            else float(rng.exponential(0.3))
        )
        latency.observe(value, method="m%d" % rng.integers(9))
        rows.observe(float(rng.integers(0, 12)))
    plain.inc()
    registry.register_collector(
        lambda: [("edl_test_collected", {"b": "2", "a": "x"}, 3.0),
                 ("edl_test_collected", {}, 0.25)]
    )
    return registry


@pytest.mark.parametrize("max_series", [None, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_the_references_byte_for_byte(seed, max_series):
    ref = _drive_registry(jprof, seed, max_series)
    got = _drive_registry(tprof, seed, max_series)
    text = got.prometheus_text()
    assert text == ref.prometheus_text()
    assert got.snapshot() == ref.snapshot()
    if max_series is not None:
        assert 'method="(overflow)"' in text
        # the bound, and the one series the rest collapse into
        assert got._metrics["edl_test_latency_seconds"].series_count() == 5
    assert '# TYPE edl_test_latency_seconds histogram' in text
    assert 'edl_test_rows_bucket{le="+Inf"} 300' in text


def test_the_registry_refuses_a_family_registered_twice_differently():
    registry = tprof.MetricsRegistry()
    registry.counter("edl_x_total", labels=("a",))
    assert registry.counter("edl_x_total", labels=("a",)) is (
        registry.counter("edl_x_total", labels=("a",))
    )
    with pytest.raises(ValueError, match="re-registered"):
        registry.gauge("edl_x_total", labels=("a",))
    with pytest.raises(ValueError, match="re-registered"):
        registry.counter("edl_x_total", labels=("b",))


def test_quantile_and_the_counters_shim_match():
    for name, prof in BOTH:
        registry = prof.MetricsRegistry()
        hist = registry.histogram("edl_q", buckets=(0.1, 0.2, 0.5))
        for v in (0.05, 0.15, 0.15, 0.4, 0.9):
            hist.observe(v)
        assert hist.quantile(0.5) == 0.2, name
        assert hist.quantile(0.99) == 0.5, name
        assert registry.histogram("edl_empty").quantile(0.5) is None
    counters = tprof.Counters()
    counters.inc("compile_plane/hits", 2)
    counters.inc("other", 1.5)
    assert counters.snapshot("compile_plane/") == {"compile_plane/hits": 2}
    counters.reset("compile_plane/")
    assert counters.snapshot() == {"other": 1.5}
    # the process shim surfaces in the exposition
    tprof.counters.inc("telemetry_test/probe", 3)
    try:
        assert 'edl_counter{name="telemetry_test/probe"} 3' in (
            tprof.metrics.prometheus_text())
    finally:
        tprof.counters.reset("telemetry_test/")
    timer = tprof.step_timer()
    assert timer.stats() == {}
    for _ in range(5):
        timer.tick()
    assert timer.stats()["steps"] == 4


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------


def _drive_events(prof, path):
    log = prof.EventLog(capacity=16, pending_capacity=4)
    log.attach_file(path)
    for i in range(6):
        log.emit("tick", n=i)
    log.emit("local", _ship=False, n=99)
    drained = log.drain_pending(3)
    log.requeue(drained[1:])
    log.ingest([{"kind": "remote", "id": 7, "ts": 1.5, "x": 1}], worker="3")
    out = {
        "pending": [e["n"] for e in log.drain_pending()],
        "since": [(e["kind"], e.get("n"), e.get("src_id"))
                  for e in log.tail(since=5)],
        "last_id": log.last_id(),
    }
    log.close_file()
    with open(path) as f:
        out["file"] = [
            {k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in f
        ]
    return out


def test_the_event_log_matches_the_reference(tmp_path):
    ref = _drive_events(jprof, str(tmp_path / "ref" / "events.jsonl"))
    got = _drive_events(tprof, str(tmp_path / "port" / "events.jsonl"))
    assert got == ref
    # the bounded buffer shed 0 and 1; the drained 2 was shipped, 3 and 4
    # were put back
    assert got["pending"] == [3, 4, 5]
    assert len(got["file"]) == 8


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------


def _scalars(seed):
    rng = np.random.default_rng(seed)
    return [
        [("loss/%d" % j, float(rng.normal())) for j in range(3)]
        + [("acc", float(rng.random()))]
        for _ in range(5)
    ]


@pytest.mark.parametrize("writer,reader", [(ttb, jtb), (jtb, ttb)],
                         ids=["port_to_reference", "reference_to_port"])
def test_an_event_file_reads_back_in_the_other_package(tmp_path, writer,
                                                       reader):
    rng_data = os.urandom(257)
    assert ttb.masked_crc32c(rng_data) == jtb.masked_crc32c(rng_data)
    assert ttb.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value
    w = writer.EventFileWriter(str(tmp_path), filename_suffix=".t")
    steps = _scalars(3)
    for step, scalars in enumerate(steps):
        w.add_scalars(scalars, step * 10, wall_time=1000.0 + step)
    w.close()
    got = reader.read_events(w.path)
    assert got[0][2] == []  # the file_version record
    for (wall, step, scalars), want, i in zip(got[1:], steps, range(5)):
        assert wall == 1000.0 + i and step == i * 10
        assert [t for t, _ in scalars] == [t for t, _ in want]
        # simple_value is a float32
        np.testing.assert_array_equal(
            np.float32([v for _, v in scalars]),
            np.float32([v for _, v in want]),
        )
    for wall, step, scalars in ((5.0, 3, steps[0]), (7.5, 2**40, [])):
        assert ttb.encode_scalar_event(wall, step, scalars) == (
            jtb.encode_scalar_event(wall, step, scalars)
        )
        assert ttb.frame_record(b"xyz") == jtb.frame_record(b"xyz")


def test_a_torn_or_corrupt_event_file(tmp_path):
    w = ttb.EventFileWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1, wall_time=2.0)
    w.close()
    with open(w.path, "rb") as f:
        blob = f.read()
    torn = str(tmp_path / "torn")
    with open(torn, "wb") as f:
        f.write(blob[:-3])
    assert len(ttb.read_events(torn)) == len(jtb.read_events(torn)) == 1
    bad = bytearray(blob)
    bad[-6] ^= 0xFF
    with open(torn, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ValueError, match="corrupt"):
        ttb.read_events(torn)


def test_the_tensorboard_service_writes_both_surfaces(tmp_path):
    service = TensorboardService(str(tmp_path))
    service.write_dict_to_summary(
        {"accuracy": np.float32(0.5), "out": {"auc": 0.25}}, version=8
    )
    service.close()
    (tb,) = [n for n in os.listdir(tmp_path) if "tfevents" in n]
    (_, step, scalars), = jtb.read_events(str(tmp_path / tb))[1:]
    assert step == 8 and scalars == [("accuracy", 0.5), ("out/auc", 0.25)]
    with open(tmp_path / "scalars.jsonl") as f:
        assert [json.loads(line)["tag"] for line in f] == [
            "accuracy", "out/auc"]


# ---------------------------------------------------------------------------
# the job view
# ---------------------------------------------------------------------------


class _Depths:
    def queue_depths(self):
        return {"todo": 3, "doing": 1, "eval_todo": 0}


def _snapshot(seed):
    rng = np.random.default_rng(seed)
    return {
        "worker_id": 1,
        "interval_s": 1.0,
        "steps_per_sec": round(float(rng.random() * 10), 3),
        "examples_per_sec": round(float(rng.random() * 1e4), 3),
        "input": {"read_s": 0.25, "parse_s": 1.5, "tasks": 3},
        "consumer_starved_ratio": 0.125,
        "hot_row_hit_rate": 0.5,
        "events": [{"kind": "ps_shard_failure", "id": 4, "ts": 2.0,
                    "addr": "h:1"}],
        "spans": [
            {"name": "step", "trace": "t-1", "span": "worker-1/%d" % i,
             "parent": None, "proc": "worker-1", "thread": "main",
             "ts": 10.0 + i, "dur": 0.5}
            for i in range(3)
        ],
    }


def _job(package):
    prof = jprof if package == "reference" else tprof
    tele = jtele if package == "reference" else ttele
    return tele.JobTelemetry(
        task_dispatcher=_Depths(), registry=prof.MetricsRegistry(),
        event_log=prof.EventLog(), span_log=prof.SpanLog(),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_the_job_view_matches_the_reference_and_counts_a_resend_once(seed):
    jobs = {name: _job(name) for name, _ in BOTH}
    snap = _snapshot(seed)
    for job in jobs.values():
        job.ingest(json.loads(json.dumps(snap)))
        job.ingest(json.loads(json.dumps(snap)))  # a resent snapshot
        job.ingest("not a snapshot")
    text = jobs["port"].prometheus_text()
    assert text == jobs["reference"].prometheus_text()
    assert 'edl_worker_examples_per_sec{worker="1"} %s' % (
        snap["examples_per_sec"]) in text
    assert 'edl_task_queue_depth{queue="todo"} 3' in text
    assert 'edl_telemetry_reports_total{worker="1"} 2' in text
    assert 'edl_worker_input_stage_seconds{worker="1",stage="parse"} 1.5' \
        in text
    # the resent spans are counted once
    trace = jobs["port"].trace_events()
    assert trace == jobs["reference"].trace_events()
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == 3
    events = jobs["port"].events_tail()
    assert [e["kind"] for e in events] == ["ps_shard_failure"] * 2
    assert events[0]["worker"] == "1" and events[0]["src_id"] == 4
    for job in jobs.values():
        job.close()
    assert "edl_task_queue_depth" not in jobs["port"].prometheus_text()


def test_the_endpoint_serves_every_surface():
    job = _job("port")
    job.ingest(_snapshot(0))
    health = {"state": "restoring"}
    server = ttele.TelemetryHTTPServer(
        job, port=0, health_fn=lambda: health["state"]
    )
    base = "http://127.0.0.1:%d" % server.port

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.headers.get("Content-Type"), r.read().decode()

    try:
        ctype, body = get("/metrics")
        assert ctype.startswith("text/plain; version=0.0.4")
        assert body == job.prometheus_text()
        _, body = get("/events?since=0")
        assert [json.loads(line)["kind"] for line in body.splitlines()] == [
            "ps_shard_failure"]
        _, body = get("/events?since=1")
        assert body.strip() == ""
        _, body = get("/trace?trace_id=t-1")
        assert len([e for e in json.loads(body)["traceEvents"]
                    if e["ph"] == "X"]) == 3
        with pytest.raises(urllib.error.HTTPError) as err:
            get("/healthz")
        assert err.value.code == 503
        health["state"] = "serving"
        assert get("/healthz")[1] == "serving\n"
        for bad in ("/nothing", "/events?since=x"):
            with pytest.raises(urllib.error.HTTPError):
                get(bad)
    finally:
        server.close()
        job.close()


def test_a_worker_snapshot_carries_what_the_reference_ships():
    """The port's WorkerTelemetry and the reference's, given the same
    batches and input counters, ship the same rates' keys, the same
    input stages, and the drained events and spans."""
    snaps = {}
    for name, prof, wtele in (("reference", jprof, jwtele),
                              ("port", tprof, twtele)):
        if name == "reference":
            from elasticdl_tpu.data.input_stats import (
                InputPlaneStats as Stats,
            )
        else:
            Stats = InputPlaneStats
        stats = Stats()
        stats.add("read_s", 0.5)
        stats.count("tasks", 2)
        tele = wtele.WorkerTelemetry(
            7, stats=stats, interval_s=3600, registry=prof.MetricsRegistry()
        )
        assert tele.maybe_snapshot() is None  # the interval has not passed
        for _ in range(4):
            tele.on_batch(16)
        prof.events.drain_pending(10**6)
        prof.spans.drain_pending(10**6)
        prof.events.emit("telemetry_probe", n=1)
        with prof.span("probe", trace_id="t"):
            pass
        snaps[name] = tele.maybe_snapshot(force=True)
    ref, got = snaps["reference"], snaps["port"]
    assert set(ref) == set(got)
    for key in ("worker_id", "steps_total", "examples_total"):
        assert got[key] == ref[key]
    assert got["input"]["read_s"] == ref["input"]["read_s"] == 0.5
    assert set(ref["input"]) <= set(got["input"])  # the port adds h2d_s
    assert [e["kind"] for e in got["events"]] == ["telemetry_probe"]
    assert [s["name"] for s in got["spans"]] == ["probe"]


class _FailingStub:
    def report_telemetry(self, snapshot):
        raise ConnectionError("master gone")


def test_a_failed_ship_requeues_its_events_and_spans():
    tprof.events.drain_pending(10**6)
    tprof.spans.drain_pending(10**6)
    tele = twtele.WorkerTelemetry(0, interval_s=0.001)
    tprof.events.emit("kept", n=1)
    with tprof.span("kept", trace_id="t"):
        pass
    assert not tele.ship(_FailingStub(), force=True)
    assert [e["kind"] for e in tprof.events.drain_pending()] == ["kept"]
    assert [s["name"] for s in tprof.spans.drain_pending()] == ["kept"]
    assert not tele.ship(object(), force=True)  # a stub without the RPC


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _record(prof, directory, monkeypatch):
    """Triggers, a rate limit and pruning through the process recorder:
    the file names it left and each dump's line kinds."""
    rec = prof.flight_recorder
    rec.arm(directory, keep=2, min_interval_s=3600.0, tail=8)
    try:
        prof.events.emit("tick")  # not a trigger
        assert not os.listdir(directory)
        with prof.span("before-the-kill", trace_id="t"):
            pass
        prof.events.emit("ps_shard_failure", addr="h:1", method="push")
        prof.events.emit("task_requeued", task=3)  # rate-limited
        assert rec.trigger("manual") is None
        rec.arm(directory, keep=2, min_interval_s=0.0, tail=8)
        for reason in ("task_requeued", "master_epoch_change"):
            prof.events.emit(reason)
    finally:
        rec.disarm()
    assert rec.trigger("disarmed") is None
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            lines = [json.loads(line) for line in f]
        out[name] = (lines[0]["postmortem"], lines[0]["trigger"]["kind"],
                     [line.get("type") for line in lines[1:]])
    return out


def test_the_flight_recorder_matches_the_reference(tmp_path, monkeypatch):
    ref = _record(jprof, str(tmp_path / "ref"), monkeypatch)
    got = _record(tprof, str(tmp_path / "port"), monkeypatch)
    assert list(got) == list(ref) == [
        "postmortem-002-task_requeued.jsonl",
        "postmortem-003-master_epoch_change.jsonl",
    ]
    assert [v[:2] for v in got.values()] == [v[:2] for v in ref.values()]
    for reason, kind, types in got.values():
        assert set(types) == {"event", "span"} and len(types) <= 16


def test_the_first_dump_holds_the_failure_and_its_spans(tmp_path):
    rec = tprof.flight_recorder
    rec.arm(str(tmp_path), min_interval_s=0.0)
    try:
        with tprof.span("ps/apply", trace_id="t-9"):
            pass
        tprof.events.emit("ps_shard_failure", addr="h:2", code="x")
    finally:
        rec.disarm()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["trigger"]["addr"] == "h:2"
    assert any(ln.get("type") == "span" and ln["name"] == "ps/apply"
               for ln in lines)
    assert tprof.maybe_arm_flight_recorder() is False  # no directory
    try:
        assert tprof.maybe_arm_flight_recorder(str(tmp_path / "x"))
    finally:
        rec.disarm()


# ---------------------------------------------------------------------------
# the profiler hooks
# ---------------------------------------------------------------------------


def test_the_profiler_hooks_write_a_chrome_trace(tmp_path, monkeypatch):
    """``trace`` (and ``EDL_PROFILE_DIR``'s ``maybe_profile``) write a
    ``torch.profiler`` Chrome trace holding the ``annotate`` range;
    ``maybe_start_trace`` starts one trace at a time."""
    with tprof.trace(str(tmp_path / "a")):
        with tprof.annotate("edl/task/t-1/train"):
            torch.ones(8).sum()
    monkeypatch.setenv("EDL_PROFILE_DIR", str(tmp_path / "b"))
    with tprof.maybe_profile():
        assert tprof.maybe_start_trace() is False  # one is open
        torch.ones(8).sum()
    assert tprof.maybe_start_trace() is True
    tprof.maybe_stop_trace()
    tprof.maybe_stop_trace()  # nothing open: a no-op
    (a,) = os.listdir(tmp_path / "a")
    with open(tmp_path / "a" / a) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "edl/task/t-1/train" in names
    assert len(os.listdir(tmp_path / "b")) == 2
    monkeypatch.delenv("EDL_PROFILE_DIR")
    assert tprof.maybe_start_trace() is False


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def test_metrics_off_records_nothing(tmp_path):
    registry = tprof.MetricsRegistry()
    counter = registry.counter("edl_off_total")
    hist = registry.histogram("edl_off_seconds")
    gauge = registry.gauge("edl_off")
    methods = tprof.instrument_service_methods(
        {"m": lambda req: "done"}, role="test", registry=registry
    )
    tprof.flight_recorder.arm(str(tmp_path), min_interval_s=0.0)
    tprof.set_metrics_enabled(False)
    try:
        assert not tprof.metrics_enabled()
        counter.inc()
        hist.observe(0.1)
        gauge.set(3)
        assert tprof.events.emit("ps_shard_failure") is None
        sp = tprof.span("step", trace_id="t")
        assert sp is tprof.NULL_SPAN
        with sp:
            assert tprof.wire_span_context() is None
        assert tprof.span_from_wire({"_sctx": ["t", "s"]}, "x") is (
            tprof.NULL_SPAN)
        assert methods["m"]({"_sctx": ["t", "s"]}) == "done"
        assert tprof.flight_recorder.trigger("off") is None
        assert twtele.WorkerTelemetry(0, interval_s=1).maybe_snapshot(
            force=True) is None
    finally:
        tprof.set_metrics_enabled(True)
        tprof.flight_recorder.disarm()
    assert registry.snapshot() == {
        "edl_off_total": {}, "edl_off_seconds": {}, "edl_off": {},
        "edl_rpc_server_latency_seconds": {},
        "edl_rpc_server_errors_total": {},
    }
    assert not os.listdir(tmp_path)


def test_the_environment_switch_turns_the_plane_off():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from elasticdl_tpu_torch.utils import profiling as p\n"
        "c = p.metrics.counter('edl_env_total'); c.inc()\n"
        "print(p.metrics_enabled(), c.value(), p.events.emit('x'),"
        " p.span('s') is p.NULL_SPAN)\n" % REPO
    )
    env = dict(os.environ, EDL_METRICS="0")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "0.0", "None", "True"]


# ---------------------------------------------------------------------------
# the scorer's endpoint, end to end
# ---------------------------------------------------------------------------

MODEL_DEF = "transformer_lm.transformer_lm.custom_model"
MODEL_PARAMS = (
    "vocab_size=128,num_layers=2,num_heads=4,head_dim=16,embed_dim=64,"
    "mlp_dim=256"
)
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _tokens(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, size=(rows, 64)).astype(np.int32)


def test_the_lm_scorer_serves_its_metrics_beside_the_jax_replies(tmp_path):
    """``--scorer_telemetry_port 0``: the small LM, exported by the JAX
    package, scored through the port's socket server and micro-batcher
    within the JAX scorer's tolerance; mid-round the endpoint reads
    ``serving`` and ``/metrics`` carries the server's, scorer's and
    batcher's families, one latency count per request; a request sent
    inside a span joins its trace in ``/trace``."""
    model = jzoo.custom_model(**get_dict_from_params_str(MODEL_PARAMS))
    params = init_variables(
        model, jax.random.PRNGKey(0), {"tokens": _tokens(1, 0)[:, :8]}
    )["params"]
    path = str(tmp_path / ("v%010d" % 1))
    jexport.export_model(
        path, params, 1,
        metadata=jexport.export_provenance(
            os.path.join(REPO, "model_zoo"), MODEL_DEF, MODEL_PARAMS),
    )
    args = parse_scorer_args([
        "--export_dir", str(tmp_path), "--device", "cpu",
        "--serve_max_batch", "4", "--scorer_telemetry_port", "0",
    ])
    scorer, watcher, _, _, batcher = build_scorer(args)
    server = ScorerServer(scorer, batcher=batcher, transport="socket",
                          telemetry_port=args.scorer_telemetry_port)
    base = "http://127.0.0.1:%d" % server.telemetry_port
    client = Client("localhost:%d" % server.port, deadline_s=60)
    hist = tprof.metrics.histogram(
        "edl_rpc_server_latency_seconds", labels=("role", "method"))
    before = (hist.data(role="scorer", method="score") or ([], 0, 0))[2]
    try:
        assert watcher.poll_once() == 1
        want = JaxScorerModel(path, model_zoo=os.path.join(REPO, "model_zoo"))
        for i in range(3):
            features = {"tokens": _tokens(2, seed=10 + i)}
            with tprof.span("client", trace_id="req-%d" % i):
                reply = client.call("score", **features)
            got = reply["output"]
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_allclose(
                got, np.asarray(want.predict(features)), **F32_TOL)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.read().decode().strip() == "serving"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        for family in ("edl_rpc_server_latency_seconds_bucket",
                       "edl_scorer_requests_total",
                       "edl_scorer_request_latency_seconds",
                       "edl_scorer_batch_size", "edl_scorer_batches_total",
                       "edl_scorer_queue_depth", "edl_scorer_model_version"):
            assert family in text, family
        assert hist.data(role="scorer", method="score")[2] - before == 3
        with urllib.request.urlopen(base + "/trace?trace_id=req-2",
                                    timeout=10) as r:
            spans = [e for e in json.loads(r.read())["traceEvents"]
                     if e["ph"] == "X"]
        by_name = {e["name"]: e for e in spans}
        assert set(by_name) == {"client", "rpc/score"}
        assert by_name["rpc/score"]["args"]["parent"] == (
            by_name["client"]["args"]["span"])
    finally:
        client.close()
        server.stop()
        scorer.close()
