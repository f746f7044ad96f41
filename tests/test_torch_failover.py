"""The worker's failover channel to the master
(``elasticdl_tpu_torch/rpc/failover.py`` under ``MasterClient``), the
counterpart of the channel cases of ``tests/test_master_journal.py``:

- a client rides out a real master process's SIGKILL and relaunch on
  its fixed port, sees ``master_epoch`` advance and its hook fire once,
  and the relaunched master has replayed its journal;
- a budget of 0 raises at once, with no resend;
- an expired deadline is never resent;
- the epoch hook fires once per change;
- a connection that ends before the first reply byte is resent; one cut
  after it is resent only for the deduped ack and the reads, and raises
  ``DATA_LOSS`` for the rest;
- a ``report_task_result`` whose reply a master SIGKILL cut is resent to
  the relaunch and deduped against the journal;
- a fixed port a dead server still holds is bound once it lets go;
- a worker (or a parked standby) whose master stays away past its
  budget exits non-zero;
- a master told to drain (SIGTERM) exits 75 with its journal written.
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.master.rpc_service import MasterClient
from elasticdl_tpu_torch.rpc import failover
from elasticdl_tpu_torch.rpc import socket_transport as st
from elasticdl_tpu_torch.rpc.core import pack_message

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _master_argv(port, data, journal):
    return [
        sys.executable, "-m", "elasticdl_tpu_torch.master.master",
        "--job_name", "m", "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0", "--model_zoo", "", "--model_def",
        "mnist_subclass.mnist_subclass.CustomModel", "--training_data",
        str(data), "--minibatch_size", "4", "--port", str(port),
        "--master_journal_dir", str(journal), "--master_journal_fsync_ms",
        "5",
    ]


def _wait_serving(port, timeout=60):
    deadline = time.time() + timeout
    while True:
        probe = MasterClient("localhost:%d" % port)
        try:
            return probe.master_status()
        except st.RpcError:
            assert time.time() < deadline, "the master never served"
            time.sleep(0.1)
        finally:
            probe.close()


def _write_mnist(data, n):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    with RecordIOWriter(str(data / "f0")) as w:
        for i in range(n):
            w.write(encode_example({"image": np.zeros(784, np.float32),
                                    "label": np.array([i % 10], np.int64)}))


def test_the_channel_rides_out_a_master_kill_and_relaunch(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_mnist(data, 16)
    port = _free_port()
    argv = _master_argv(port, data, tmp_path / "journal")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(argv, cwd=REPO, env=env,
                              stderr=subprocess.DEVNULL)]
    client = MasterClient("localhost:%d" % port, failover_s=60)
    changes = []
    client.set_on_master_epoch_change(lambda a, b: changes.append((a, b)))
    try:
        first = _wait_serving(port)
        assert first["state"] == "serving"
        assert first["recovery"]["records"] == 0  # a fresh journal
        task = client.get_task(0)  # in flight at the kill
        assert task.shard_name and client.master_epoch == first[
            "master_epoch"]
        time.sleep(0.2)  # past the journal's fsync cadence
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=10)
        got = []
        caller = threading.Thread(
            target=lambda: got.append(client.get_task(1)), daemon=True
        )
        caller.start()
        time.sleep(1.0)  # the call retries against the dead port
        assert caller.is_alive() and not got
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                      stderr=subprocess.DEVNULL))
        caller.join(60)
        assert got and got[0].shard_name
        assert client.master_epoch == first["master_epoch"] + 1
        assert changes == [(first["master_epoch"], client.master_epoch)]
        status = client.master_status()
        # the relaunch replayed the dispatch and requeued it once
        assert status["recovery"]["pending"] == 1
        assert status["recovery"]["records"] >= 2
        assert status["journal"]["dispatched"] == 2
        assert status["journal"]["requeued"] == 1
    finally:
        client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def test_a_budget_of_zero_raises_at_once(monkeypatch):
    sleeps = []
    monkeypatch.setattr(failover.time, "sleep", sleeps.append)
    client = MasterClient("localhost:%d" % _free_port(), failover_s=0)
    t0 = time.monotonic()
    with pytest.raises(st.RpcError) as e:
        client.get_task(0)
    assert e.value.code == "UNAVAILABLE"
    assert time.monotonic() - t0 < 1.0 and sleeps == []
    # a positive budget resends the same call until it is spent
    # (the backoff doubles from 0.2 s while it fits the budget)
    client = MasterClient("localhost:%d" % _free_port(), failover_s=0.5)
    with pytest.raises(st.RpcError) as e:
        client.get_task(0)
    assert e.value.code == "UNAVAILABLE" and sleeps == [0.2, 0.4]


def test_a_timed_out_call_is_never_resent():
    calls = []
    gate = threading.Event()

    def slow(req):
        calls.append(req)
        gate.wait(5)
        return {}

    server = st.serve({"slow": slow}, 0)
    channel = failover.MasterFailoverChannel(
        "localhost:%d" % server.port, outage_budget_s=30,
        attempt_deadline_s=0.2,
    )
    try:
        t0 = time.monotonic()
        with pytest.raises(st.RpcError) as e:
            channel.call("slow")
        assert e.value.code == "DEADLINE_EXCEEDED"
        assert time.monotonic() - t0 < 2.0 and len(calls) == 1
    finally:
        gate.set()
        channel.close()
        server.stop()


def test_the_epoch_hook_fires_once_per_change():
    seen = []
    channel = failover.MasterFailoverChannel(
        "localhost:1", on_epoch_change=lambda a, b: seen.append((a, b))
    )
    for epoch in (4, 4, None, 5, 5, 7):
        channel.note_reply({} if epoch is None else {"master_epoch": epoch})
    assert seen == [(4, 5), (5, 7)] and channel.master_epoch == 7


def _read_request(conn):
    (n,) = struct.unpack("<I", st._recv_exact(conn, 4))
    name = bytes(st._recv_exact(conn, n)).decode()
    (m,) = struct.unpack("<Q", st._recv_exact(conn, 8))
    st._recv_exact(conn, m)
    return name


def _raw_server(behaviours):
    """A listener answering its i-th connection by ``behaviours[i]``:
    "drop" closes after reading the request, "cut" sends 3 reply bytes
    then closes, "reply" answers properly."""
    listener = socket.socket()
    listener.bind(("localhost", 0))
    listener.listen(8)
    served = []

    def loop():
        for how in behaviours:
            conn, _ = listener.accept()
            served.append((how, _read_request(conn)))
            if how == "cut":
                conn.sendall(b"\x00\x05\x00")
            elif how == "reply":
                payload = pack_message({"master_epoch": 3, "ok": True})
                st._send_reply(conn, 0, payload)
                time.sleep(0.2)
            conn.close()
        listener.close()

    threading.Thread(target=loop, daemon=True).start()
    return listener.getsockname()[1], served


# each master call, and whether a reply cut after its first byte is sent
# again: the deduped ack and the pure reads are, the rest raise DATA_LOSS
_CUT_RESENT = [
    ("report_task_result", True),
    ("get_comm_world", True),
    ("standby_poll", True),
    ("master_status", True),
    ("get_model", True),
    ("pull_embedding_vectors", True),
    ("export_embedding_tables", True),
    ("get_task", False),
    ("report_gradient", False),
    ("report_variable", False),
    ("push_embedding_info", False),
    ("report_evaluation_metrics", False),
    ("leave_comm_world", False),
]


@pytest.mark.parametrize("method,resent", _CUT_RESENT)
def test_a_drop_before_the_reply_is_resent_a_cut_reply_is_not(
    method, resent
):
    """A drop before the first reply byte is resent for every call; a
    cut after it only for the calls in ``RESEND_AFTER_CUT``."""
    assert (method in failover.RESEND_AFTER_CUT) == resent
    port, served = _raw_server(["drop", "reply"])
    channel = failover.MasterFailoverChannel(
        "localhost:%d" % port, outage_budget_s=10
    )
    assert channel.call(method)["ok"]
    assert served == [("drop", method), ("reply", method)]
    port, served = _raw_server(["cut", "reply"])
    channel = failover.MasterFailoverChannel(
        "localhost:%d" % port, outage_budget_s=10
    )
    if resent:
        assert channel.call(method)["ok"]
        assert served == [("cut", method), ("reply", method)]
    else:
        with pytest.raises(st.RpcError) as e:
            channel.call(method)
        assert e.value.code == "DATA_LOSS"
        time.sleep(0.1)
        assert served == [("cut", method)]


def test_a_cut_reply_is_not_resent_past_the_budget():
    port, served = _raw_server(["cut", "reply"])
    channel = failover.MasterFailoverChannel(
        "localhost:%d" % port, outage_budget_s=0
    )
    with pytest.raises(st.RpcError) as e:
        channel.call("report_task_result")
    assert e.value.code == "DATA_LOSS"
    assert served == [("cut", "report_task_result")]


class _CuttingProxy:
    """A TCP relay to ``localhost:target`` that, once armed for a method,
    forwards that call's request, relays the first byte of its reply,
    cuts the caller's connection and runs ``on_cut`` (the test's master
    SIGKILL)."""

    def __init__(self, target, method, on_cut):
        self.target, self.method, self.on_cut = target, method, on_cut
        self.armed = False
        self.cuts = 0
        self._listener = socket.socket()
        self._listener.bind(("localhost", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn):
        upstream = None
        try:
            while True:
                (n,) = struct.unpack("<I", st._recv_exact(conn, 4))
                name = st._recv_exact(conn, n)
                (m,) = struct.unpack("<Q", st._recv_exact(conn, 8))
                body = st._recv_exact(conn, m)
                if upstream is None:
                    upstream = socket.create_connection(
                        ("localhost", self.target)
                    )
                upstream.sendall(struct.pack("<I", n) + bytes(name)
                                 + struct.pack("<Q", m) + bytes(body))
                head = st._recv_exact(upstream, 9)
                status, length = struct.unpack("<BQ", bytes(head))
                payload = st._recv_exact(upstream, length)
                if self.armed and bytes(name).decode() == self.method:
                    self.armed = False
                    self.cuts += 1
                    conn.sendall(bytes(head)[:1])
                    conn.close()
                    self.on_cut()
                    return
                conn.sendall(bytes(head) + bytes(payload))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            if upstream is not None:
                upstream.close()

    def close(self):
        self._listener.close()


def test_a_cut_task_report_is_resent_to_the_relaunch_and_deduped(
    tmp_path,
):
    """The master is SIGKILLed once it has sent the first byte of a
    ``report_task_result`` reply (the done record fsynced). The worker's
    channel resends the ack to the master relaunched at the same address
    with the journal, which dedupes it by trace id: the journal counts
    the task done once and the resend as one ``dup``."""
    from elasticdl_tpu_torch.common.constants import TaskExecCounterKey
    from elasticdl_tpu_torch.master.journal import MasterJournal

    data = tmp_path / "data"
    data.mkdir()
    _write_mnist(data, 16)
    port = _free_port()
    journal = tmp_path / "journal"
    argv = _master_argv(port, data, journal)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(argv, cwd=REPO, env=env,
                              stderr=subprocess.DEVNULL)]

    def kill_and_relaunch():
        time.sleep(0.2)  # past the journal's fsync cadence
        procs[-1].send_signal(signal.SIGKILL)
        procs[-1].wait(timeout=10)
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                      stderr=subprocess.DEVNULL))

    proxy = _CuttingProxy(port, "report_task_result", kill_and_relaunch)
    client = MasterClient("localhost:%d" % proxy.port, failover_s=60)
    try:
        first = _wait_serving(port)
        task = client.get_task(0)
        trace = task.extended_config["trace_id"]
        proxy.armed = True
        client.report_task_result(
            task.task_id, exec_counters={TaskExecCounterKey.TRACE_ID: trace}
        )
        assert proxy.cuts == 1 and len(procs) == 2
        assert client.master_epoch == first["master_epoch"] + 1
        status = client.master_status()
        assert status["journal"]["done"] == 1
        assert status["journal"]["deduped"] == 1
    finally:
        client.close()
        proxy.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    state = MasterJournal(str(journal)).replay()
    assert state.counters["done"] == 1 and state.counters["deduped"] == 1
    assert not state.pending and trace in state.done_traces


def test_a_fixed_port_is_bound_once_its_holder_lets_go(monkeypatch):
    holder = socket.socket()
    holder.bind(("", 0))
    holder.listen(1)
    port = holder.getsockname()[1]
    threading.Timer(0.6, holder.close).start()
    t0 = time.monotonic()
    server = st.SocketServer({"echo": lambda req: req}, port=port)
    try:
        assert server.port == port and time.monotonic() - t0 >= 0.5
        client = st.Client("localhost:%d" % port)
        assert client.call("echo", x=1)["x"] == 1
        client.close()
    finally:
        server.stop()
    # a port that stays held fails once the bind's time is up
    monkeypatch.setattr(st, "BIND_TIMEOUT_S", 0.3)
    with pytest.raises(OSError):
        blocker = socket.socket()
        blocker.bind(("", 0))
        blocker.listen(1)
        try:
            st.SocketServer({}, port=blocker.getsockname()[1])
        finally:
            blocker.close()


@pytest.mark.parametrize("standby", [False, True])
def test_a_worker_whose_master_stays_away_exits_non_zero(standby):
    """Past ``--master_failover_s`` the channel's error ends the worker
    (a parked standby too) with a non-zero exit; it never waits on."""
    argv = [
        sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
        "--worker_id", "0", "--job_type", "training_only",
        "--distribution_strategy", "AllreduceStrategy", "--master_addr",
        "localhost:%d" % _free_port(), "--master_failover_s", "1",
        "--model_zoo", "", "--model_def",
        "mnist_subclass.mnist_subclass.CustomModel", "--minibatch_size",
        "4", "--device", "cpu", "--standby", "true" if standby else "false",
    ]
    proc = subprocess.run(argv, cwd=REPO, env=dict(os.environ,
                                                   PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode not in (0, 75)
    assert "UNAVAILABLE" in proc.stderr


def test_sigterm_flushes_the_journal_and_exits_75(tmp_path):
    """A master told to drain exits 75 with its journal written: the
    next boot replays the dispatch it made."""
    from elasticdl_tpu_torch.master.journal import MasterJournal

    data = tmp_path / "data"
    data.mkdir()
    _write_mnist(data, 16)
    port = _free_port()
    argv = _master_argv(port, data, tmp_path / "journal")
    proc = subprocess.Popen(argv, cwd=REPO, env=dict(os.environ,
                                                     PYTHONPATH=REPO),
                            stderr=subprocess.DEVNULL)
    try:
        _wait_serving(port)
        client = MasterClient("localhost:%d" % port)
        assert client.get_task(0).shard_name
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    state = MasterJournal(str(tmp_path / "journal")).replay()
    assert state.counters["dispatched"] == 1 and len(state.pending) == 1


def test_the_supervisor_relaunches_a_drained_master_without_its_budget(
    tmp_path,
):
    """The external-supervisor form: a master SIGTERMed by
    ``terminate_master`` drains its journal and exits 75, and the
    manager relaunches it at once, spending none of its crash budget;
    the relaunch serves the next ``master_epoch`` on the same port."""
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )

    data = tmp_path / "data"
    data.mkdir()
    _write_mnist(data, 16)
    port = _free_port()
    argv = _master_argv(port, data, tmp_path / "journal")
    manager = LocalInstanceManager(
        None, 0, None, [], max_relaunches=0,
        env=dict(os.environ, PYTHONPATH=REPO),
        master_command=lambda: argv,
    )
    manager.start_master()
    try:
        first = _wait_serving(port)
        manager.terminate_master()
        deadline = time.time() + 60
        second = None
        while time.time() < deadline:
            second = _wait_serving(port)
            if second["master_epoch"] != first["master_epoch"]:
                break
            time.sleep(0.1)
        assert second["master_epoch"] == first["master_epoch"] + 1
        assert manager.master_exit_codes == [75] and manager.live_master()
    finally:
        manager.stop_relaunch_and_remove_all_pods(grace_s=5)
