"""Cross-process tracing in the port against the reference: the span log
and its wire context (``_sctx``), the Chrome trace export, the
tracetool's critical path, ``_sctx`` parenting spans across the two
packages over a shared-memory ring (gRPC control channel), and an
in-process PS job whose ``/trace`` the tracetool attributes."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu.tools import tracetool as jtool
from elasticdl_tpu.utils import profiling as jprof
from elasticdl_tpu_torch import cli
from elasticdl_tpu_torch.common.tensor import release_message
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.rpc.shm_transport import (
    ShmChannel,
    install_shm_endpoint,
)
from elasticdl_tpu_torch.tools import tracetool as ttool
from elasticdl_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEEPFM = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"


# ---------------------------------------------------------------------------
# the span log
# ---------------------------------------------------------------------------


def _drive_spans(prof):
    """The same nesting, late binding, errors, threads and ingestion
    through one package's span machinery; the records it keeps."""
    log = prof.SpanLog(capacity=64, pending_capacity=8)
    log.set_process("worker-3")

    def begin(name, **kw):
        return log.begin(name, **kw)

    with begin("step", trace_id="t-1", examples=8):
        with begin("step/compute", obj=object()) as inner:
            inner.add(rows=np.int64(4))
        with begin("step/grad_push"):
            pass
    dispatch = begin("master/dispatch", worker=1)
    with dispatch:
        dispatch.set_trace("t-2").set_trace("t-3")
    try:
        with begin("step/fails", trace_id="t-4"):
            raise KeyError("x")
    except KeyError:
        pass
    seen = {}

    def other_thread():
        with begin("off-thread") as sp:
            seen["parent"] = sp.parent_id

    with begin("outer", trace_id="t-5"):
        t = threading.Thread(target=other_thread, name="edl-other")
        t.start()
        t.join(timeout=10)
    shipped = [
        {"name": "remote", "span": "ps-0/%d" % i, "parent": None,
         "trace": "t-1", "proc": "ps-0", "ts": 1.0, "dur": 0.5}
        for i in range(3)
    ]
    log.ingest(shipped)
    log.ingest(shipped)  # a resend: ingested once
    log.ingest([{"name": "own", "span": "worker-3/1", "proc": "worker-3"}])
    drained = log.drain_pending(3)
    log.requeue(drained[1:])
    pending = [s["name"] for s in log.drain_pending()]
    records = [
        {k: v for k, v in r.items() if k not in ("ts", "dur")}
        for r in log.tail()
    ]
    return records, pending, seen["parent"]


def test_the_span_log_keeps_what_the_references_keeps():
    ref = _drive_spans(jprof)
    got = _drive_spans(tprof)
    assert got == ref
    records, pending, off_parent = got
    by_name = {r["name"]: r for r in records}
    assert by_name["step/compute"]["parent"] == by_name["step"]["span"]
    assert by_name["step/compute"]["trace"] == "t-1"
    assert by_name["step/compute"]["rows"] == "4"  # not a JSON scalar
    assert isinstance(by_name["step/compute"]["obj"], str)
    assert by_name["master/dispatch"]["trace"] == "t-2"  # first binding
    assert by_name["step/fails"]["error"] == "KeyError"
    assert off_parent is None  # the context does not cross threads
    assert by_name["off-thread"]["thread"] == "edl-other"
    assert sum(r["name"] == "remote" for r in records) == 3
    assert "own" not in by_name
    # seven spans finished here; the first drained one was shipped
    assert pending == ["step/grad_push", "step", "master/dispatch",
                       "step/fails", "off-thread", "outer"]


def test_the_wire_context_is_the_innermost_traced_span():
    assert tprof.wire_span_context() is None
    with tprof.span("untraced"):
        assert tprof.wire_span_context() is None
        with tprof.span("step", trace_id="t-7") as sp:
            assert tprof.current_span() is sp
            assert tprof.wire_span_context() == ["t-7", sp.span_id]
            with tprof.span_from_wire(
                {"_sctx": ["t-7", sp.span_id]}, "rpc/x"
            ) as server:
                assert server.parent_id == sp.span_id
    assert tprof.current_span() is None
    for bad in (None, [], {"_sctx": "t"}, {"_sctx": [1, 2, 3]}, {}):
        assert tprof.span_from_wire(bad, "rpc/x") is tprof.NULL_SPAN


# ---------------------------------------------------------------------------
# the trace export and the tracetool
# ---------------------------------------------------------------------------


def _span_document(seed, steps=40):
    """A seeded job's span records: per step a ``step`` root and its
    phases (one nested grandchild, one step with an unexplained gap,
    an error), across two workers and their threads."""
    rng = np.random.default_rng(seed)
    recs, seq = [], 0
    for i in range(steps):
        proc = "worker-%d" % (i % 2)
        seq += 1
        root = "%s/%d" % (proc, seq)
        ts = 100.0 + i
        phases = {
            "step/pull_model": float(rng.uniform(0.01, 0.05)),
            "step/compute": float(rng.uniform(0.02, 0.2)),
            "step/grad_push": float(rng.uniform(0.01, 0.08)),
        }
        if i % 5 == 0:
            phases["step/var_init"] = float(rng.uniform(0.1, 0.3))
        gap = float(rng.uniform(0.0, 0.3)) if i == 7 else 0.001
        recs.append({"name": "step", "trace": "task-%d" % (i // 4),
                     "span": root, "parent": None, "proc": proc,
                     "thread": "MainThread", "ts": ts,
                     "dur": round(sum(phases.values()) + gap, 6),
                     "examples": 16, "task": i // 4})
        t = ts
        for name, dur in phases.items():
            seq += 1
            span = "%s/%d" % (proc, seq)
            recs.append({"name": name, "trace": "task-%d" % (i // 4),
                         "span": span, "parent": root, "proc": proc,
                         "thread": "MainThread", "ts": round(t, 6),
                         "dur": round(dur, 6)})
            if name == "step/compute":
                seq += 1
                recs.append({"name": "step/embedding_pull",
                             "trace": "task-%d" % (i // 4),
                             "span": "%s/%d" % (proc, seq), "parent": span,
                             "proc": proc, "thread": "MainThread",
                             "ts": round(t, 6), "dur": round(dur / 3, 6)})
            t += dur
    recs.append({"name": "ps/apply", "trace": "task-0", "span": "ps-1/1",
                 "parent": recs[3]["span"], "proc": "ps-1",
                 "thread": "Thread-2", "ts": 100.01, "dur": 0.004,
                 "sync": True, "error": "RuntimeError"})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_and_the_critical_path_match_the_reference(seed):
    recs = _span_document(seed)
    doc = tprof.chrome_trace(recs)
    assert doc == jprof.chrome_trace(recs)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta if e["name"] == "process_name"} \
        == {"worker-0", "worker-1", "ps-1"}
    for source in (recs, doc, doc["traceEvents"]):
        report = ttool.critical_path(source)
        assert report == jtool.critical_path(source)
        assert ttool.format_report(report) == jtool.format_report(report)
    report = ttool.critical_path(doc)
    assert report["steps"] == 40
    assert list(report["phases"])[:3] == [
        "step/pull_model", "step/compute", "step/grad_push"]
    assert "step/embedding_pull" not in report["phases"]  # a grandchild
    assert 0.9 <= report["attribution"] <= 1.0
    slow = report["slowest"][0]
    assert slow["dur_s"] == report["p99_s"] and slow["dominant"]


def test_the_tracetool_command_line(tmp_path):
    doc = tprof.chrome_trace(_span_document(0))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "elasticdl_tpu_torch.tools.tracetool"]
    proc = subprocess.run(run + [str(path), "--json"], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == jtool.critical_path(doc)
    proc = subprocess.run(run + ["-"], input=json.dumps(doc),
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode == 0 and "attribution" in proc.stdout
    assert ttool.main([]) == 2
    assert ttool.main([str(tmp_path / "missing.json")]) == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert ttool.main([str(empty)]) == 1


# ---------------------------------------------------------------------------
# _sctx across the packages, over a shared-memory ring
# ---------------------------------------------------------------------------


def _pull_dense(req):
    return {"echo": float(np.asarray(req["x"]).sum())}


def _spans_named(prof, name, trace):
    return [r for r in prof.spans.tail() if r["name"] == name
            and r["trace"] == trace]


def test_a_port_clients_span_parents_the_references_server_span():
    pytest.importorskip("grpc")
    from elasticdl_tpu.rpc import core as jcore
    from elasticdl_tpu.rpc import shm_transport as jshm
    from elasticdl_tpu_torch.rpc.core import Client as GrpcClient

    methods, registry = jshm.install_shm_endpoint(
        jprof.instrument_service_methods({"pull_dense": _pull_dense},
                                         role="ps"))
    server = jcore.serve(methods, 0)
    client = GrpcClient("localhost:%d" % server._edl_port, deadline_s=30)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        with tprof.span("step/pull_model", trace_id="port-ring") as ring_sp:
            reply = chan.call("pull_dense", x=np.ones(8, np.float32))
        assert chan.state == "on" and chan.stats["shm"] == 1
        assert reply["echo"] == 8.0
        release_message(reply)
        with tprof.span("step/pull_model", trace_id="port-grpc") as inline:
            assert client.call("pull_dense", x=np.ones(2))["echo"] == 2.0
        (ring,) = _spans_named(jprof, "rpc/pull_dense", "port-ring")
        assert ring["parent"] == ring_sp.span_id and ring["role"] == "ps"
        (grpc_rec,) = _spans_named(jprof, "rpc/pull_dense", "port-grpc")
        assert grpc_rec["parent"] == inline.span_id
        # outside a traced span nothing is injected, nothing recorded
        before = len(jprof.spans.tail())
        release_message(chan.call("pull_dense", x=np.ones(1)))
        assert len(jprof.spans.tail()) == before
    finally:
        chan.close()
        client.close()
        server.stop(None)
        registry.close()


def test_a_reference_clients_span_parents_the_ports_server_span():
    pytest.importorskip("grpc")
    from elasticdl_tpu.common.tensor import release_message as j_release
    from elasticdl_tpu.rpc import core as jcore
    from elasticdl_tpu.rpc import shm_transport as jshm
    from elasticdl_tpu_torch.rpc.core import serve as grpc_serve

    methods, registry = install_shm_endpoint(
        tprof.instrument_service_methods({"pull_dense": _pull_dense},
                                         role="ps"))
    server = grpc_serve(methods, 0)
    client = jcore.Client("localhost:%d" % server._edl_port)
    chan = jshm.ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        with jprof.span("step/pull_model", trace_id="ref-ring") as sp:
            reply = chan.call("pull_dense", x=np.ones(4, np.float32))
        assert chan.state == "on" and chan.stats["shm"] == 1
        assert reply["echo"] == 4.0
        j_release(reply)
        (rec,) = _spans_named(tprof, "rpc/pull_dense", "ref-ring")
        assert rec["parent"] == sp.span_id and rec["role"] == "ps"
    finally:
        chan.close()
        client.close()
        server.stop(None)
        registry.close()


# ---------------------------------------------------------------------------
# an in-process PS job's /trace
# ---------------------------------------------------------------------------


def _write_frappe(directory, n, vocab=5000, seed=0):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            ids = rng.integers(1, vocab, 10)
            w.write(encode_example({
                "feature": ids.astype(np.int64),
                "label": np.array([rng.integers(0, 2)], np.int64),
            }))


def test_an_in_process_ps_jobs_trace_is_attributed(tmp_path, monkeypatch):
    """``--telemetry_port 0`` on the PS job (the master-held DeepFM, the
    worker in process): ``/trace``, read as the master stops, holds one
    ``step`` span per minibatch whose direct children explain at least
    90 % of its wall time, as the reference's gate asks; ``/metrics``
    carries the dispatcher's queue depth and the master's RPC plane is
    instrumented; the events file holds every task's timeline."""
    data = tmp_path / "data"
    _write_frappe(str(data), 256)
    scraped = {}
    stop = Master.stop

    def scrape_then_stop(self):
        if self.telemetry_port is not None and not scraped:
            base = "http://127.0.0.1:%d" % self.telemetry_port
            for path in ("/trace", "/metrics"):
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    scraped[path] = r.read().decode()
        stop(self)

    monkeypatch.setattr(Master, "stop", scrape_then_stop)
    tprof.spans.reset()
    events = tmp_path / "events.jsonl"
    jobs = []
    assert cli.main([
        "train", "--job_name", "j", "--model_zoo", "", "--model_def",
        DEEPFM, "--model_params", "embedding_dim=8,fc_unit=8",
        "--training_data", str(data), "--minibatch_size", "16",
        "--num_minibatches_per_task", "4", "--device", "cpu",
        "--telemetry_port", "0", "--telemetry_events_path", str(events),
    ], jobs=jobs) == 0
    doc = json.loads(scraped["/trace"])
    report = ttool.critical_path(doc)
    assert report == jtool.critical_path(doc)
    assert report["steps"] == 16, report
    assert report["attribution"] >= 0.9, ttool.format_report(report)
    for phase in ("step/pull_model", "step/compute", "step/grad_push"):
        assert report["phases"][phase]["count"] == 16, phase
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"master/dispatch", "master/report", "task/wait"} <= names
    assert "edl_task_queue_depth" in scraped["/metrics"]
    with open(events) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("task_done") == 4, kinds
