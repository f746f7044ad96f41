"""The port's scripted fault plane (``tools/chaos.py``) against the
reference's ``tests/test_chaos.py`` cases that need no JAX:

- ``seeded_schedule`` equals the reference's for the same seed, op by
  op (kind, shard, version), and is reproducible;
- ``ScriptedFaultPS`` over the port's in-process shard
  (``PserverServicer`` behind a ``PSClient`` without fan-out): the
  partition window is deterministic, a kill at a version latches until
  ``revive`` and fires once, a reject window rejects one push;
- ``FleetChaos`` against a fake manager (a kill fires once at its
  version crossing, a master kill at its done-task count, a schedule of
  master ops without the master probe is refused, the kill is a
  ``chaos_kill`` event) and against a real fleet: two ``ps.main`` shard
  processes under the ``LocalInstanceManager``, shard 1 SIGKILLed once
  its version reaches 3 and relaunched at its address.
"""

import os
import socket
import sys
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.tools.chaos import (
    ChaosOp,
    ChaosPartitionError,
    FleetChaos,
    ScriptedFaultPS,
    seeded_schedule,
)
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.worker.ps_client import PSClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEEPFM = "deepfm_functional_api.deepfm_functional_api.custom_model"
SMALL = "embedding_dim=4,fc_unit=8,vocab_size=100"


def _sgd(params):
    import torch

    return torch.optim.SGD(params, lr=0.1)


def make_servicer(epoch, use_async=True):
    return PserverServicer(Parameters(), 1, _sgd, "cpu", use_async=use_async,
                           shard_epoch=epoch)


def push_model(client, n_dense=4, dims=4):
    model = {
        "w%d" % i: np.full((2, 2), float(i + 1), np.float32)
        for i in range(n_dense)
    }
    client.push_model(model, [EmbeddingTableInfo("emb", dims)])


def _grad():
    return [Tensor("emb", np.ones((1, 4), np.float32), indices=np.array([0]))]


def _wait(cond, what, limit_s=5.0):
    deadline = time.monotonic() + limit_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# -- the schedule ------------------------------------------------------------


@pytest.mark.parametrize("seed,num_ps,kinds,max_version,n_ops", [
    (42, 4, ("kill",), 9, 3),
    (0, 2, ("kill", "term"), 16, 5),
    (7, 3, ("term", "kill", "kill_master"), 30, 8),
])
def test_seeded_schedule_equals_the_references_bitwise(seed, num_ps, kinds,
                                                       max_version, n_ops):
    from elasticdl_tpu.tools.chaos import seeded_schedule as jschedule

    got = seeded_schedule(seed, num_ps, kinds, max_version, n_ops)
    want = jschedule(seed, num_ps, kinds, max_version, n_ops)
    assert [(o.kind, o.shard, o.at_version) for o in got] == [
        (o.kind, o.shard, o.at_version) for o in want
    ]
    assert [repr(o) for o in got] == [repr(o) for o in want]


def test_seeded_schedule_is_reproducible():
    a = seeded_schedule(42, num_ps=4, max_version=9, n_ops=3)
    b = seeded_schedule(42, num_ps=4, max_version=9, n_ops=3)
    assert [(o.kind, o.shard, o.at_version) for o in a] == [
        (o.kind, o.shard, o.at_version) for o in b
    ]
    c = seeded_schedule(43, num_ps=4, max_version=9, n_ops=3)
    assert [(o.shard, o.at_version) for o in a] != [
        (o.shard, o.at_version) for o in c
    ] or [o.kind for o in a] != [o.kind for o in c]
    with pytest.raises(ValueError, match="unknown chaos op"):
        ChaosOp("explode", 0)


# -- the in-process shard ----------------------------------------------------


def test_scripted_fault_ps_partition_window_is_deterministic():
    s = make_servicer(1)
    faulty = ScriptedFaultPS(
        s, [ChaosOp("partition", 0, at_call=2, n_calls=2)], shard=0
    )
    client = PSClient([faulty], fanout=False)
    push_model(client, n_dense=1)  # call 0 (push_model)
    client.pull_dense()  # call 1
    for _ in range(2):  # calls 2, 3: the window
        with pytest.raises(ChaosPartitionError):
            client.pull_dense()
    ok, _, _ = client.pull_dense()  # call 4: window closed
    assert ok
    assert [op.kind for op, _ in faulty.executed] == [
        "partition",
        "partition",
    ]
    client.close()


def test_scripted_fault_ps_kill_at_version_latches_until_revive():
    s = make_servicer(1)
    faulty = ScriptedFaultPS(
        s, [ChaosOp("kill", 0, at_version=2)], shard=0
    )
    client = PSClient([faulty], fanout=False)
    push_model(client, n_dense=1)
    client.push_gradient({}, _grad(), 0)  # version 1
    client.push_gradient({}, _grad(), 1)  # version 2
    with pytest.raises(ChaosPartitionError):
        client.push_gradient({}, _grad(), 2)  # at_version crossed: dead
    with pytest.raises(ChaosPartitionError):
        client.pull_dense()  # stays dead (latched)
    with pytest.raises(ChaosPartitionError):
        faulty.ps_status({})  # a dead pod answers nothing
    # the relaunch: a restored incarnation whose version is past the
    # kill; the one-shot op must not fire again
    restored = make_servicer(2)
    restored._parameters.version = 5
    faulty.revive(restored)
    assert faulty.ps_status({})["shard_epoch"] == 2
    client.pull_dense()  # a counted call: would re-kill without the latch
    assert [op.kind for op, _ in faulty.executed] == ["kill"]
    client.close()


def test_scripted_fault_ps_reject_window():
    s = make_servicer(1)
    faulty = ScriptedFaultPS(
        s, [ChaosOp("reject", 0, at_call=1, n_calls=1)], shard=0
    )
    client = PSClient([faulty], fanout=False)
    push_model(client, n_dense=1)
    accepted, _ = client.push_gradient({}, _grad(), 0)
    assert not accepted  # forced rejection, still applied/forwarded
    accepted, _ = client.push_gradient({}, _grad(), 1)
    assert accepted
    client.close()


def test_scripted_fault_ps_delay_window_sleeps_and_forwards():
    s = make_servicer(1)
    faulty = ScriptedFaultPS(
        s, [ChaosOp("delay", 0, at_call=1, n_calls=1, delay_s=0.2)],
        shard=0,
    )
    client = PSClient([faulty], fanout=False)
    push_model(client, n_dense=1)
    start = time.monotonic()
    ok, _, named = client.pull_dense()
    assert ok and sorted(named) == ["w0"]
    assert time.monotonic() - start >= 0.2
    assert [op.kind for op, _ in faulty.executed] == ["delay"]
    client.close()


# -- the fleet level, against a fake manager ---------------------------------


def test_fleet_chaos_fires_once_at_version_crossing():
    killed = []

    class Manager:
        def kill_ps(self, shard):
            killed.append(("kill", shard))

        def terminate_ps(self, shard):
            killed.append(("term", shard))

    versions = {0: 0, 1: 0}
    chaos = FleetChaos(
        Manager(),
        lambda shard: {"version": versions[shard]},
        [ChaosOp("kill", 0, at_version=3)],
        poll_s=0.01,
    ).start()
    try:
        versions[0] = 2
        time.sleep(0.05)
        assert killed == []  # below the trigger
        versions[0] = 3
        _wait(chaos.done, "the kill never fired")
        time.sleep(0.05)  # no double fire on later polls
        assert killed == [("kill", 0)]
        (op, trigger, _), = chaos.executed
        assert op.kind == "kill" and trigger == 3
    finally:
        chaos.stop()


def test_fleet_chaos_master_op_fires_at_done_count():
    executed = []

    class Manager:
        def kill_master(self):
            executed.append("kill_master")

        def terminate_master(self):
            executed.append("term_master")

    status = {"version": 0, "journal": {"done": 0}}
    chaos = FleetChaos(
        Manager(),
        lambda shard: {},
        [ChaosOp("kill_master", -1, at_done=3)],
        poll_s=0.01,
        master_status_fn=lambda: status,
    ).start()
    try:
        time.sleep(0.05)
        assert executed == []
        status["journal"]["done"] = 3
        _wait(chaos.done, "the master kill never fired")
        time.sleep(0.05)
        assert executed == ["kill_master"]
    finally:
        chaos.stop()


def test_fleet_chaos_refuses_master_ops_without_the_master_probe():
    with pytest.raises(ValueError, match="master_status_fn"):
        FleetChaos(object(), lambda shard: {},
                   [ChaosOp("term_master", -1, at_version=1)])


def test_an_executed_op_is_a_chaos_event_and_a_probe_failure_polls_again():
    calls = []

    class Manager:
        def terminate_ps(self, shard):
            calls.append(shard)

    probes = {"n": 0}

    def status_fn(shard):
        probes["n"] += 1
        if probes["n"] < 3:
            raise ConnectionError("shard still booting")
        return {"version": 5}

    before = profiling.events.last_id()
    chaos = FleetChaos(Manager(), status_fn,
                       [ChaosOp("term", 1, at_version=4)],
                       poll_s=0.01).start()
    try:
        _wait(chaos.done, "the term never fired")
    finally:
        chaos.stop()
    assert calls == [1] and probes["n"] >= 3
    events = [e for e in profiling.events.tail(50, since=before)
              if e["kind"] == "chaos_term"]
    assert events and events[-1]["target"] == "ps"
    assert events[-1]["shard"] == 1


# -- the fleet level, against real shard processes ---------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_fleet_chaos_kills_a_real_shard_at_its_version(tmp_path):
    """Two ``ps.main`` shards under the instance manager; a client pushes
    gradients until shard 1 reports version 3, where ``FleetChaos``
    SIGKILLs it once; the manager relaunches it on its port, where it
    serves a new incarnation."""
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    ports = [_free_port(), _free_port()]
    common = ["--model_zoo", "", "--model_def", DEEPFM, "--model_params",
              SMALL, "--device", "cpu", "--log_level", "WARNING",
              "--use_async", "true"]

    def ps_command(i):
        return [sys.executable, "-m", "elasticdl_tpu_torch.ps.main",
                "--ps_id", str(i), "--port", str(ports[i])] + common

    manager = LocalInstanceManager(
        None, 0, None, [], num_ps=2, ps_command=ps_command,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    stubs = [BoundPS("localhost:%d" % p, deadline_s=10) for p in ports]

    def status(shard):
        return stubs[shard].ps_status({})

    def serving(shard):
        try:
            return status(shard)
        except Exception:  # noqa: BLE001 - still booting
            return None

    chaos = None
    try:
        manager.start_all_ps()
        _wait(lambda: serving(0) and serving(1), "shards never served", 120)
        first_epoch = status(1)["shard_epoch"]
        chaos = FleetChaos(manager, status,
                           [ChaosOp("kill", 1, at_version=3)],
                           poll_s=0.02).start()
        client = PSClient(stubs, fanout=False)
        push_model(client, n_dense=2)
        for v in range(3):
            client.push_gradient(
                {}, [Tensor("emb", np.ones((2, 4), np.float32),
                            indices=np.array([0, 1]))], v)
        _wait(chaos.done, "the kill never fired", 30)
        (op, trigger, _), = chaos.executed
        assert (op.kind, op.shard, trigger) == ("kill", 1, 3)
        _wait(lambda: len(manager.ps_spawned_at.get(1, [])) >= 2,
              "shard 1 was not relaunched", 60)
        assert manager.ps_exit_codes[1] == [-9]
        _wait(lambda: (serving(1) or {}).get("shard_epoch", first_epoch)
              != first_epoch, "the relaunch never served", 120)
        assert status(1)["shard_epoch"] > first_epoch
        assert 0 not in manager.ps_exit_codes  # shard 0 untouched
    finally:
        if chaos is not None:
            chaos.stop()
        for stub in stubs:
            stub.close()
        manager.stop_relaunch_and_remove_all_pods()


@pytest.mark.parametrize("late", ["worker", "standby", "ps", "master"])
def test_nothing_starts_once_the_manager_has_stopped(late):
    """A relaunch (worker, shard, master) or a standby refill that the
    watcher thread runs after the stop starts no process: the stop has
    already collected the processes it ends, and one started after it
    would outlive the job."""
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )

    started = []

    def command(*_):
        started.append(late)
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    class Pool:
        """The membership's standby pool, as much as the manager uses."""

        def parked_count(self):
            return 0

        def forget(self, token):
            pass

    class Membership:
        standby = Pool()

        def set_fencer(self, fn):
            pass

    manager = LocalInstanceManager(
        None, 1, command, ["cpu"], num_ps=1, ps_command=command,
        membership=Membership() if late == "standby" else None,
        num_standby=1, master_command=command,
    )
    manager.stop_relaunch_and_remove_all_pods(grace_s=1)
    late_start = {
        "worker": manager._start_worker,
        "standby": manager._start_standby,
        "ps": lambda: manager._spawn(("ps", 0), command(0)),
        "master": lambda: manager._spawn(("master", 0), command()),
    }[late]
    late_start()
    assert not manager._procs
    assert not manager.spawned_at and not manager.ps_spawned_at
