"""The port's job plane: the socket transport
(``elasticdl_tpu_torch/rpc/socket_transport.py``) and the master's RPC
service and client over it (``master/rpc_service.py``).

- Messages with tensors (float32, int64, bfloat16, a list of named
  tensors), bytes and JSON fields round-trip bitwise, from several
  threads at once over one client's connection pool.
- A handler's error reaches the caller (``INTERNAL``, with its text); an
  unknown method is ``UNIMPLEMENTED``; the 256 MB cap (shrunk here)
  refuses an oversized request at the client, an oversized request frame
  at the server and an oversized reply; a refused connection is
  ``UNAVAILABLE`` after the client's retries.
- ``MasterClient`` through ``MasterRpcService`` answers as the servicer
  and the membership called directly do, under one dispatcher seed; so do
  the methods of the master-held model (``get_model``,
  ``report_variable``, ``report_gradient``, ``push_embedding_info``,
  ``pull_embedding_vectors``, ``export_embedding_tables``), and worker
  telemetry, not ported, raises by name.
- The master process (``python -m elasticdl_tpu_torch.master.master``)
  serves its plane and exits 75 on SIGTERM.

Every test runs with ``grpc`` unimportable (``sys.modules["grpc"]`` set
to None): nothing on the job plane may need it.
"""

import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.master.membership_service import MembershipService
from elasticdl_tpu_torch.master.rpc_service import (
    MasterClient,
    MasterRpcService,
)
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import socket_transport as st


@pytest.fixture(autouse=True)
def no_grpc(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError):
        import grpc  # noqa: F401


@pytest.fixture
def echo_server():
    def echo(req):
        return dict(req)

    def fail(req):
        raise ValueError("bad request %s" % req.get("n"))

    server = st.serve({"echo": echo, "fail": fail}, 0)
    yield server
    server.stop()


def _client(server, **kw):
    return st.Client("localhost:%d" % server.port, **kw)


def test_tensor_messages_round_trip_bitwise(echo_server):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i64 = rng.integers(-(2 ** 40), 2 ** 40, (7,), dtype=np.int64)
    bf16 = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)
                            ).to(torch.bfloat16)
    named = [Tensor("a", f32[0]), Tensor("b", i64[:3])]
    client = _client(echo_server)
    reply = client.call(
        "echo", f32=f32, i64=i64, bf16=bf16, named=named, raw=b"\x00\xff",
        meta={"k": [1, 2.5, "s", None]}, n=3,
    )
    assert reply["f32"].dtype == np.float32
    assert np.array_equal(reply["f32"], f32)
    assert np.array_equal(reply["i64"], i64)
    assert reply["bf16"].dtype == torch.bfloat16
    assert torch.equal(reply["bf16"], bf16)
    assert [t.name for t in reply["named"]] == ["a", "b"]
    assert np.array_equal(reply["named"][1].values, i64[:3])
    assert reply["raw"] == b"\x00\xff"
    assert reply["meta"] == {"k": [1, 2.5, "s", None]} and reply["n"] == 3
    client.close()


def test_concurrent_calls_share_the_pool(echo_server):
    client = _client(echo_server)
    results, errors = {}, []

    def caller(i):
        try:
            for j in range(20):
                r = client.call("echo", i=i, j=j, x=np.full(64, i, np.int32))
                assert r["i"] == i and r["j"] == j
                assert np.array_equal(r["x"], np.full(64, i, np.int32))
            results[i] = True
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and len(results) == 8
    client.close()


def test_handler_error_reaches_the_caller(echo_server):
    client = _client(echo_server)
    with pytest.raises(st.RpcError, match="ValueError: bad request 7") as e:
        client.call("fail", n=7)
    assert e.value.code == "INTERNAL"
    # the connection serves the next call
    assert client.call("echo", n=1)["n"] == 1
    with pytest.raises(st.RpcError) as e:
        client.call("nope")
    assert e.value.code == "UNIMPLEMENTED"
    client.close()


def test_size_cap_holds_both_ways(monkeypatch, echo_server):
    monkeypatch.setattr(st, "MAX_MESSAGE_BYTES", 4096)
    client = _client(echo_server)
    # the client refuses an oversized request before sending it
    with pytest.raises(st.RpcError) as e:
        client.call("echo", x=np.zeros(4096, np.uint8))
    assert e.value.code == "RESOURCE_EXHAUSTED"
    # the server refuses an oversized request frame without reading it
    with socket.create_connection(("localhost", echo_server.port)) as s:
        name = b"echo"
        s.sendall(struct.pack("<I", len(name)) + name
                  + struct.pack("<Q", 10 ** 9))
        status, length = struct.unpack("<BQ", st._recv_exact(s, 9))
        text = bytes(st._recv_exact(s, length)).decode()
    assert st._CODES[status] == "RESOURCE_EXHAUSTED" and "cap" in text
    # a reply over the cap comes back as an error, not a torn frame
    server = st.serve({"big": lambda req: {"x": np.zeros(8192, np.uint8)}},
                      0)
    try:
        with pytest.raises(st.RpcError) as e:
            _client(server).call("big")
        assert e.value.code == "RESOURCE_EXHAUSTED"
    finally:
        server.stop()
    client.close()


def test_refused_connection_is_unavailable_after_retries(monkeypatch):
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    sleeps = []
    monkeypatch.setattr(st.time, "sleep", sleeps.append)
    client = st.Client("localhost:%d" % port, retries=2, backoff_s=0.1)
    with pytest.raises(st.RpcError) as e:
        client.call("echo")
    assert e.value.code == "UNAVAILABLE"
    assert sleeps == [0.1, 0.2]
    with pytest.raises(st.RpcError):
        client.call("echo", _retriable=False)
    assert sleeps == [0.1, 0.2]


def test_deadline_is_not_retried():
    gate = threading.Event()
    server = st.serve({"slow": lambda req: gate.wait(5) and {}}, 0)
    try:
        client = st.Client("localhost:%d" % server.port, deadline_s=0.2,
                           retries=3)
        t0 = time.monotonic()
        with pytest.raises(st.RpcError) as e:
            client.call("slow")
        assert e.value.code == "DEADLINE_EXCEEDED"
        assert time.monotonic() - t0 < 2.0
    finally:
        gate.set()
        server.stop()


SHARDS = {"a": (0, 64), "b": (0, 32)}


def _plane(monkeypatch):
    """(servicer, membership) under one dispatcher seed."""
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "3")
    task_d = TaskDispatcher(dict(SHARDS), {}, {}, 16, 1)
    return (
        MasterServicer(1, 16, None, task_d),
        MembershipService(expected_workers=2, form_grace_secs=60),
    )


def _task_fields(res):
    return (res.task_id, res.shard_name, res.start, res.end,
            None if res.type is None else int(res.type), res.model_version,
            res.minibatch_size, res.extended_config)


def test_master_client_answers_as_the_servicer(monkeypatch):
    direct, direct_m = _plane(monkeypatch)
    remote, remote_m = _plane(monkeypatch)
    service = MasterRpcService(remote, membership=remote_m, master_epoch=42)
    server = st.serve(service.rpc_methods(), 0)
    client = MasterClient("localhost:%d" % server.port)
    try:
        got, want = [], []
        for step in range(8):
            a = client.get_task(step % 2)
            b = direct.get_task(step % 2)
            got.append(_task_fields(a))
            want.append(_task_fields(b))
            counters = {"model_version": step + 1}
            client.report_task_result(a.task_id, "", counters)
            direct.report_task_result(b.task_id, "", counters)
        assert got == want
        assert client.master_epoch == 42 and service.served_get_task
        assert remote.get_model_version() == direct.get_model_version() == 8
        # WAIT and the end of the job cross the wire as they are
        assert _task_fields(client.get_task(0)) == _task_fields(
            direct.get_task(0))
        assert _task_fields(client.get_task(1, TaskType.EVALUATION)) == (
            _task_fields(direct.get_task(1, TaskType.EVALUATION)))
        # the membership verbs
        for wid, kw in ((0, {}), (1, {}), (0, {}), (1, {}),
                        (0, {"awaiting": False})):
            r = client.get_comm_world(wid, "h%d" % wid, **kw)
            w = direct_m.get_world(wid, "h%d" % wid, **kw)
            assert r.pop("master_epoch") == 42
            r.pop("coordinator", None)
            w.pop("coordinator", None)
            assert r == w
        client.leave_comm_world(1)
        direct_m.remove(1, departing=True)
        assert remote_m.epoch == direct_m.epoch == 2
        status = client.master_status()
        assert status["master_epoch"] == 42 and status["version"] == 8
        # the standby pool's poll: parked, then promoted with a device
        assert client.standby_poll(7) == (None, None)
        remote_m.standby.activate(5, device="cuda:1")
        assert client.standby_poll(7) == (5, "cuda:1")
        # a worker's telemetry snapshot is accepted: a no-op without a
        # JobTelemetry, ingested into the servicer's when it has one
        client.report_telemetry({"worker_id": 3})
        from elasticdl_tpu_torch.master.telemetry import JobTelemetry
        from elasticdl_tpu_torch.utils.profiling import (
            EventLog,
            MetricsRegistry,
            SpanLog,
        )

        registry = MetricsRegistry()
        remote.telemetry = JobTelemetry(
            registry=registry, event_log=EventLog(), span_log=SpanLog()
        )
        client.report_telemetry(
            {"worker_id": 3, "examples_per_sec": 12.5}
        )
        assert registry.gauge(
            "edl_worker_examples_per_sec", labels=("worker",)
        ).value(worker="3") == 12.5
    finally:
        client.close()
        server.stop()
    _held_model_methods_answer_as_the_servicer()


def _held_model_servicer():
    from elasticdl_tpu_torch.master.checkpoint_service import (
        CheckpointService,
    )

    return MasterServicer(
        1, 16, lambda p: torch.optim.SGD(p, lr=0.1),
        TaskDispatcher(dict(SHARDS), {}, {}, 16, 1),
        checkpoint_service=CheckpointService("", 0, 0, False), device="cpu",
    )


def _held_model_methods_answer_as_the_servicer():
    """The master-held model's methods through the socket plane give what
    the servicer gives when called directly."""
    from elasticdl_tpu_torch.common.constants import GetModelMethod
    from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo

    direct, remote = _held_model_servicer(), _held_model_servicer()
    server = st.serve(MasterRpcService(remote).rpc_methods(), 0)
    client = MasterClient("localhost:%d" % server.port)
    rng = np.random.default_rng(0)
    model = {"w": rng.normal(size=(3, 2)).astype(np.float32),
             "b": rng.normal(size=(2,)).astype(np.float32)}
    try:
        for stub in (client, direct):
            stub.report_variable(model)
            stub.push_embedding_info([EmbeddingTableInfo("emb", 4, "uniform")])
        ids = np.array([7, 3, 7, 1], np.int64)
        assert np.array_equal(client.pull_embedding_vectors("emb", ids),
                              direct.pull_embedding_vectors("emb", ids))
        for version in (0, 1):
            grads = [Tensor("w", rng.normal(size=(3, 2)).astype(np.float32)),
                     Tensor("emb", rng.normal(size=(4, 4)).astype(np.float32),
                            ids)]
            assert client.report_gradient(grads, version) == (
                direct.report_gradient(grads, version))
        assert client.report_gradient(grads, 0) == (False, 2)
        for method in (GetModelMethod.MINIMUM, GetModelMethod.FIXED):
            got, want = client.get_model(2, method), direct.get_model(2, method)
            assert got[0] == want[0] == 2 and sorted(got[1]) == ["b", "w"]
            for k in want[1]:
                assert np.array_equal(got[1][k], want[1][k])
        got, want = client.export_embedding_tables(), (
            direct.export_embedding_tables())
        assert sorted(got) == sorted(want) == [
            "edl_embedding:emb:ids", "edl_embedding:emb:rows"]
        for k in want:
            assert np.array_equal(got[k], want[k])
        # the bf16 wire: the server applies the bf16-rounded gradient
        bf16 = MasterClient("localhost:%d" % server.port,
                            wire_dtype="bfloat16")
        try:
            rounded = [Tensor(t.name, torch.from_numpy(t.values).to(
                torch.bfloat16).float().numpy(), t.indices) for t in grads]
            assert bf16.report_gradient(grads, 2) == (
                direct.report_gradient(rounded, 2))
            got, want = bf16.get_model(3), direct.get_model(3)
            for k in want[1]:
                assert np.array_equal(got[1][k], want[1][k])
        finally:
            bf16.close()
    finally:
        client.close()
        server.stop()


def test_master_client_relays_evaluation_outputs(monkeypatch):
    servicer, membership = _plane(monkeypatch)
    seen = []

    def report(version, outputs, labels, scored_version=None):
        seen.append((version, outputs, labels, scored_version))
        return True, servicer.get_model_version()

    servicer.report_evaluation_metrics = report
    server = st.serve(
        MasterRpcService(servicer, membership=membership).rpc_methods(), 0
    )
    client = MasterClient("localhost:%d" % server.port)
    try:
        out = np.arange(6, dtype=np.float32).reshape(3, 2)
        labels = np.array([1, 0, 1], np.int32)
        assert client.report_evaluation_metrics(
            4, {"output": out}, labels, scored_version=3
        ) == (True, 0)
        version, outputs, got_labels, scored = seen[0]
        assert (version, scored) == (4, 3)
        assert np.array_equal(outputs["output"], out)
        assert np.array_equal(got_labels, labels)
    finally:
        client.close()
        server.stop()


def test_master_process_serves_then_drains_on_sigterm(tmp_path):
    """``python -m elasticdl_tpu_torch.master.master``: the master serves
    its socket plane (master_status answers) while its tasks wait for
    workers, and a SIGTERM stops it with exit code 75."""
    import os
    import re
    import signal
    import subprocess

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = tmp_path / "data"
    data.mkdir()
    with RecordIOWriter(str(data / "f0")) as w:
        for i in range(8):
            w.write(encode_example({"image": np.zeros(784, np.float32),
                                    "label": np.array([i % 10], np.int64)}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.master.master",
         "--job_name", "m", "--distribution_strategy", "AllreduceStrategy",
         "--num_workers", "2", "--model_zoo", "", "--model_def",
         "mnist_subclass.mnist_subclass.CustomModel", "--training_data",
         str(data), "--minibatch_size", "4", "--port", "0"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stderr=subprocess.PIPE, text=True,
    )
    try:
        port = None
        deadline = time.time() + 60
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"RPC server started on port (\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "the master never served"
        client = MasterClient("localhost:%d" % port)
        status = client.master_status()
        assert status["state"] == "serving" and not status["finished"]
        assert status["task_queues"]["todo"] == 1  # 8 records, 8 a task
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
