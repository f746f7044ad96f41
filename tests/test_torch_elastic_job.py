"""The port's multi-process elastic ALLREDUCE job on the CPU: the command
line with ``--num_workers 2 --device cpu`` on the MNIST CNN, the master
in a launcher process, two worker processes (``python -m
elasticdl_tpu_torch.worker.main``) in a gloo world.

- The clean job: exit code 0, every task done once (the dispatcher's
  successful reports, SAVE_MODEL included), both workers exit 0, both
  ranks end with the same state bits at a version equal to their steps
  with a live rank, the newest checkpoint restores bitwise (its state's
  digest recorded when it was saved), the export exists with its
  serving member; for the MNIST CNN and for the CIFAR-10 CNN
  (``cifar10_subclass`` on cifar-shaped records, the reference's
  "cifar10_subclass (allreduce mode)").
- The kill drill: worker 1 is SIGKILLed once the version reaches 4; the
  survivor's step breaks, the world re-forms, the relaunched worker joins
  with the survivor's state bits, and the job completes with every task
  done once and the live ranks bitwise equal.
- The SIGTERM drain: worker 0 (rank 0, the checkpoint writer) drains on
  a preemption notice: its checkpoint writes land, it exits 75 and is
  replaced, and the job completes with every task done once.
- Resume: a second job on the first one's checkpoints starts both ranks
  at its newest version.
- Placement: the workers get a card each only when the host has enough
  (an NCCL world), else share ``cuda`` (a gloo world), with the card
  count patched; a relaunched worker takes its predecessor's card.
- The master SIGKILL drill: the master runs as its own process
  (``python -m elasticdl_tpu_torch.master.master`` with a journal and a
  fixed port) and two worker processes dial it, all three supervised by
  one ``LocalInstanceManager`` in its external-supervisor form; the
  master is SIGKILLed at version 4 and relaunched. Neither worker exits
  during the outage, ``master_epoch`` advances, the workers re-form with
  the relaunched master, the journal counts every task done once (done =
  tasks x epochs, pending 0), and the ranks end equal.
- The standby drill: with ``--num_standby_workers 1`` the killed
  worker's place goes to the warmed standby (its timeline's ``standby``
  event), the survivor re-forms once at full size, and a fresh standby
  refills the pool.
- Evaluation while training: ``--validation_data`` with
  ``--evaluation_steps``: rounds are published at versions > 0, each over
  every validation record, and every task is done once.

Each job runs in a launcher process under its own wall-clock limit (a hang
fails the test, and the launcher's process group, workers included, is
killed). The workers' ``EDL_WORKER_TIMELINE_DIR`` events carry their
digests and steps; ports come from the OS.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = "mnist_subclass.mnist_subclass.CustomModel"
CIFAR10 = "cifar10_subclass.cifar10_subclass.CustomModel"
RECORDS = 2048  # over the zoo's 1024-record shuffle buffer: both get data
BATCH = 16
PER_TASK = 2  # minibatches per task
LIMIT_S = 100

LAUNCHER = textwrap.dedent(
    """
    import json, os, sys, threading, time
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, cfg["repo"])
    os.environ["EDL_WORKER_TIMELINE_DIR"] = cfg["timeline"]
    from elasticdl_tpu_torch import cli

    jobs, rc = [], []
    runner = threading.Thread(
        target=lambda: rc.append(cli.main(cfg["argv"], jobs=jobs)),
        daemon=True,
    )
    runner.start()
    while not jobs and runner.is_alive():
        time.sleep(0.01)
    master = jobs[0].master
    done = []
    report = master.task_d.report

    def counting(task_id, success, exec_counters=None):
        if success:
            done.append(task_id)
        return report(task_id, success, exec_counters)

    master.task_d.report = counting
    if cfg.get("hold_wait"):
        # one worker is told WAIT, where it would learn the job has no
        # more tasks, for a few seconds: its peer learns it first
        from elasticdl_tpu_torch.common.constants import TaskType

        held_id, hold_s = cfg["hold_wait"]
        servicer = master.master_servicer
        get_task = servicer.get_task
        first_held = []

        def holding(worker_id, task_type=None):
            res = get_task(worker_id, task_type)
            if (worker_id == held_id and task_type != TaskType.EVALUATION
                    and not res.shard_name and res.type != TaskType.WAIT):
                first_held[:] = first_held or [time.time()]
                if time.time() < first_held[0] + hold_s:
                    res.type = TaskType.WAIT
            return res

        servicer.get_task = holding
    acted = None
    if cfg["action"]:
        while (master.master_servicer.get_model_version() < 4
               and runner.is_alive()):
            time.sleep(0.02)
        acted = time.time()
        getattr(master.instance_manager, cfg["action"])(cfg["victim"])
    runner.join()
    manager = master.instance_manager
    evaluation = master.evaluation_service
    print(json.dumps({
        "rc": rc[0] if rc else None,
        "done": done,
        "finished": master.task_d.finished(),
        "exit_codes": {str(k): v for k, v in manager.exit_codes.items()},
        "standby_exit_codes": {
            str(k): v for k, v in manager.standby_exit_codes.items()},
        "promotions": manager.promotions,
        "cold_relaunches": manager.cold_relaunches,
        "published": evaluation.published if evaluation else [],
        "acted": acted,
    }, default=float))
    """
)

# the master as a process of its own, supervised with its workers by one
# LocalInstanceManager outside it; the master is SIGKILLed at version 4
SUPERVISOR = textwrap.dedent(
    """
    import json, os, socket, sys, time
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, cfg["repo"])
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )
    from elasticdl_tpu_torch.master.rpc_service import MasterClient

    def status():
        probe = MasterClient("localhost:%d" % cfg["port"])
        try:
            return probe.master_status()
        except Exception:
            return None
        finally:
            probe.close()

    env = dict(os.environ, PYTHONPATH=cfg["repo"], EDL_COMM_HOST="localhost",
               EDL_MASTER_POLL_SECS="1", EDL_MASTER_EXIT_GRACE_S="60",
               EDL_WORKER_TIMELINE_DIR=cfg["timeline"])
    manager = LocalInstanceManager(
        None, 2,
        lambda wid, dev: cfg["worker"] + ["--worker_id", str(wid),
                                          "--device", dev],
        ["cpu", "cpu"], env=env, master_command=lambda: cfg["master"],
    )
    manager.start_master()
    while status() is None:
        time.sleep(0.1)
    before = status()
    manager.start_workers()
    while (status() or {}).get("version", 0) < 4:
        time.sleep(0.02)
    # the journal writes its records on a batched cadence: kill once
    # version 4 is on disk, or the relaunch rightly replays an older one
    while MasterJournal(cfg["journal"]).replay().version < 4:
        time.sleep(0.02)
    live_at_kill = manager.live_workers()
    manager.kill_master()
    killed = time.time()
    after = None
    while after is None or after["master_epoch"] == before["master_epoch"]:
        after = status()
        time.sleep(0.05)
    serving_s = time.time() - killed
    live_after = manager.live_workers()
    manager.wait()
    deadline = time.time() + 60
    while manager.live_master() and time.time() < deadline:
        time.sleep(0.1)
    master_exits = list(manager.master_exit_codes)
    manager.stop_relaunch_and_remove_all_pods(grace_s=5)
    print(json.dumps({
        "before": before, "after": after, "serving_s": serving_s,
        "live_at_kill": live_at_kill, "live_after": live_after,
        "exit_codes": {str(k): v for k, v in manager.exit_codes.items()},
        "master_exit_codes": master_exits, "killed": killed,
    }))
    """
)


def _write_records(data_dir, pixels=784):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(data_dir)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(data_dir, "f0")) as w:
        for _ in range(RECORDS):
            w.write(encode_example({
                "image": rng.random(pixels, dtype=np.float32) * 255,
                "label": np.array([rng.integers(0, 10)], np.int64),
            }))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic-job") / "data")
    _write_records(d)
    return d


@pytest.fixture(scope="module")
def cifar_data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic-job-cifar") / "data")
    _write_records(d, pixels=32 * 32 * 3)
    return d


def _launch(script, cfg):
    """Run ``script`` with ``cfg`` under the wall limit, its process group
    killed at the end; its last stdout line as JSON, and its stderr."""
    # one compute thread a process: the workers share this host's cores
    # with the other test processes
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=env,
    )
    try:
        stdout, stderr = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the job did not finish within %d s" % LIMIT_S)
    finally:
        try:  # the workers too, should any outlive the launcher
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, stderr[-4000:]
    result = json.loads(stdout.strip().splitlines()[-1])
    result["stderr"] = stderr
    return result


def _run_job(tmp, data_dir, epochs=1, action=None, victim=None,
             ckpt="ckpt", name="run", extra=(), model_def=MNIST,
             hold_wait=None):
    out = os.path.join(tmp, name)
    argv = [
        "train", "--job_name", "elastic", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "2", "--model_zoo", "",
        "--model_def", model_def, "--training_data", data_dir,
        "--minibatch_size", str(BATCH), "--num_minibatches_per_task",
        str(PER_TASK), "--num_epochs", str(epochs),
        "--checkpoint_dir", os.path.join(tmp, ckpt),
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "3",
        "--output", os.path.join(out, "export"), "--restart_policy",
        "Always", "--device", "cpu", "--log_level", "WARNING",
    ] + list(extra)
    cfg = dict(repo=REPO, argv=argv, action=action, victim=victim,
               timeline=os.path.join(out, "timeline"), hold_wait=hold_wait)
    result = _launch(LAUNCHER, cfg)
    result["timeline"] = _timeline(cfg["timeline"])
    result["export"] = glob.glob(
        os.path.join(out, "export", "*", "MANIFEST.json")
    )
    return result


def _timeline(root):
    events = {}
    for path in glob.glob(os.path.join(root, "worker-*.jsonl")):
        wid = int(os.path.basename(path)[len("worker-"):-len(".jsonl")])
        with open(path) as f:
            events[wid] = [json.loads(line) for line in f]
    return events


def _events(events, kind):
    return [e for e in events if e["event"] == kind]


def _tasks(epochs):
    return RECORDS // (BATCH * PER_TASK) * epochs + 1  # + SAVE_MODEL


def _assert_every_task_once(result, epochs):
    assert result["rc"] == 0 and result["finished"]
    assert len(result["done"]) == len(set(result["done"])) == _tasks(epochs)
    assert result["export"]
    # the SAVE_MODEL artifact carries the serving member
    for path in result["export"]:
        with open(path) as f:
            assert json.load(f)["artifacts"]["torch_serving_fn"]


def _final(events):
    (final,) = _events(events, "final")
    return final


def _checkpoint_digest(directory, model_def=MNIST):
    """(version, digest) of a checkpoint restored into a fresh model."""
    from elasticdl_tpu_torch.common.model_utils import load_zoo_module
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    zoo = load_zoo_module(model_def)
    fresh = AllReduceTrainer(zoo.CustomModel(), zoo.loss, zoo.optimizer(),
                             seed=3, device="cpu")
    fresh.init_from_batch(None)
    version = fresh.restore_sharded(directory)
    return version, state_digest(fresh.train_state)


@pytest.mark.parametrize("model_def", [MNIST, CIFAR10],
                         ids=["mnist_subclass", "cifar10_subclass"])
def test_clean_job_trains_in_lockstep_and_checkpoints(tmp_path, model_def,
                                                      request):
    data = request.getfixturevalue(
        "cifar_data_dir" if model_def == CIFAR10 else "data_dir")
    r = _run_job(str(tmp_path), data, model_def=model_def)
    _assert_every_task_once(r, 1)
    assert r["exit_codes"] == {"0": 0, "1": 0}
    tl = r["timeline"]
    finals = [_final(tl[w]) for w in (0, 1)]
    assert finals[0]["digest"] == finals[1]["digest"]
    assert finals[0]["version"] == finals[1]["version"] > 0
    for w in (0, 1):
        (est,) = _events(tl[w], "established")
        assert est["size"] == 2 and est["backend"] == "gloo"
        assert est["rank"] == w
        live_steps = [s for s in _events(tl[w], "step") if s["live"] > 0]
        assert len(live_steps) == finals[w]["version"]
        assert not _events(tl[w], "world_broken")
    # rank 0 wrote the checkpoints; the newest restores bitwise
    saved = {c["version"]: c["digest"]
             for c in _events(tl[0], "checkpoint")}
    assert saved and not _events(tl[1], "checkpoint")
    newest = max(saved)
    version, digest = _checkpoint_digest(
        os.path.join(str(tmp_path), "ckpt", "ckpt_v%d" % newest), model_def
    )
    assert version == newest and digest == saved[newest]


def test_kill_drill_reforms_and_completes(tmp_path, data_dir):
    r = _run_job(str(tmp_path), data_dir, epochs=3, action="kill_worker",
                 victim=1)
    _assert_every_task_once(r, 3)
    assert r["exit_codes"]["1"] == -signal.SIGKILL
    assert r["exit_codes"]["0"] == 0 and r["exit_codes"]["2"] == 0
    tl = r["timeline"]
    # the survivor's step broke once, and it re-formed alone
    broken = _events(tl[0], "world_broken")
    assert broken and broken[0]["t"] >= r["acted"]
    worlds = _events(tl[0], "established")
    assert [w["size"] for w in worlds][:2] == [2, 1]
    # the relaunched worker joined with the survivor's state bits
    joined = _events(tl[2], "established")
    assert joined, "the relaunched worker never joined"
    survivor = {w["epoch"]: w for w in worlds}
    for w in joined:
        assert w["digest"] == survivor[w["epoch"]]["digest"]
        assert w["version"] == survivor[w["epoch"]]["version"] > 0
    assert _final(tl[0])["digest"] == _final(tl[2])["digest"]


def test_each_worker_fetches_a_task_ahead_and_every_task_runs_once(
        tmp_path, data_dir):
    """``--task_prefetch`` (1 by default) reaches the elastic worker: each
    worker holds a task fetched ahead of the one it consumes, and the
    tasks held by the killed worker and those fetched ahead when the job
    ends still run exactly once."""
    r = _run_job(str(tmp_path), data_dir, epochs=2, action="kill_worker",
                 victim=1)
    _assert_every_task_once(r, 2)
    assert r["exit_codes"]["1"] == -signal.SIGKILL
    tl = r["timeline"]
    # the survivor and the relaunched worker fed tasks fetched ahead
    assert _final(tl[0])["fetched_ahead"] > 0
    assert _final(tl[2])["fetched_ahead"] > 0


def test_sigterm_drains_rank_zero_and_replaces_it(tmp_path, data_dir):
    r = _run_job(str(tmp_path), data_dir, epochs=2,
                 action="terminate_worker", victim=0)
    _assert_every_task_once(r, 2)
    assert r["exit_codes"]["0"] == 75  # drained, not crashed
    assert "2" in r["exit_codes"]  # the replacement ran
    tl = r["timeline"]
    assert not _events(tl[0], "world_broken")
    assert not _events(tl[1], "world_broken")
    # the drained rank 0 landed its checkpoint writes before exiting
    written = _events(tl[0], "checkpoint_writes")
    assert written and "4" in written[0]["write_s"]
    assert os.path.isdir(os.path.join(str(tmp_path), "ckpt"))


def test_second_job_resumes_from_the_checkpoints(tmp_path, data_dir):
    first = _run_job(str(tmp_path), data_dir, name="first")
    saved = max(c["version"]
                for c in _events(first["timeline"][0], "checkpoint"))
    second = _run_job(str(tmp_path), data_dir, name="second")
    _assert_every_task_once(second, 1)
    tl = second["timeline"]
    starts = [_events(tl[w], "established")[0] for w in (0, 1)]
    assert starts[0]["version"] == starts[1]["version"] == saved
    assert starts[0]["digest"] == starts[1]["digest"]
    assert _final(tl[0])["version"] > saved


# ---------------------------------------------------------------------------
# placement: a card per worker, or one shared, and the backend that follows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "device,workers,cards,want",
    [
        ("cpu", 2, 0, ["cpu", "cpu"]),
        ("cuda", 2, 1, ["cuda", "cuda"]),  # one card, shared: gloo
        ("cuda", 2, 2, ["cuda:0", "cuda:1"]),  # a card each: NCCL
        ("cuda", 2, 4, ["cuda:0", "cuda:1"]),
        ("cuda", 4, 2, ["cuda"] * 4),
        ("cuda:3", 1, 4, ["cuda:3"]),
    ],
)
def test_workers_get_a_card_each_only_when_the_host_has_enough(
    monkeypatch, device, workers, cards, want
):
    import torch

    from elasticdl_tpu_torch.parallel.distributed import (
        choose_backend,
        worker_devices,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = worker_devices(device, workers)
    assert got == want
    own_cards = len(set(got)) == len(got) and got[0].startswith("cuda:")
    assert {choose_backend(torch.device(d)) for d in got} == {
        "nccl" if own_cards else "gloo"
    }


def test_a_card_named_by_index_is_refused_for_several_workers():
    from elasticdl_tpu_torch.parallel.distributed import worker_devices

    with pytest.raises(ValueError, match="pass --device cuda"):
        worker_devices("cuda:0", 2)


def test_a_relaunched_worker_takes_the_card_of_the_one_it_replaces():
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )

    class Dispatcher:
        def recover_tasks(self, worker_id):
            pass

    placed = {}

    def command(worker_id, device):
        placed[worker_id] = device
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    manager = LocalInstanceManager(
        Dispatcher(), 2, command, ["cuda:0", "cuda:1"]
    )
    manager.start_workers()
    try:
        for victim, replacement in ((1, 2), (0, 3)):
            manager.kill_worker(victim)
            deadline = time.monotonic() + 30
            while replacement not in placed and time.monotonic() < deadline:
                time.sleep(0.02)
        assert placed == {0: "cuda:0", 1: "cuda:1", 2: "cuda:1",
                          3: "cuda:0"}
    finally:
        manager.stop_relaunch_and_remove_all_pods(grace_s=1)


# ---------------------------------------------------------------------------
# the master SIGKILL drill, standby promotion, evaluation while training
# ---------------------------------------------------------------------------


def test_master_sigkill_drill_rides_out_the_outage(tmp_path, data_dir):
    import socket

    from elasticdl_tpu_torch.master.journal import MasterJournal

    epochs = 2
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    journal = str(tmp_path / "journal")
    common = [
        "--model_zoo", "", "--model_def", MNIST, "--minibatch_size",
        str(BATCH), "--log_level", "WARNING",
    ]
    master = [
        sys.executable, "-m", "elasticdl_tpu_torch.master.master",
        "--job_name", "drill", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "0", "--training_data",
        data_dir, "--num_minibatches_per_task", str(PER_TASK),
        "--num_epochs", str(epochs), "--port", str(port),
        "--master_journal_dir", journal, "--master_journal_fsync_ms", "20",
    ] + common
    worker = [
        sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
        "--job_type", "training_only", "--distribution_strategy",
        "AllreduceStrategy", "--master_addr", "localhost:%d" % port,
        "--master_failover_s", "60", "--checkpoint_dir",
        str(tmp_path / "ckpt"), "--checkpoint_steps", "4",
    ] + common
    timeline = str(tmp_path / "timeline")
    r = _launch(SUPERVISOR, dict(repo=REPO, port=port, master=master,
                                 journal=journal,
                                 worker=worker, timeline=timeline))
    # neither worker exited during the outage; the job ended cleanly
    assert r["live_at_kill"] == r["live_after"] == [0, 1]
    assert r["exit_codes"] == {"0": 0, "1": 0}
    assert r["master_exit_codes"] == [-signal.SIGKILL, 0]
    assert r["after"]["master_epoch"] == r["before"]["master_epoch"] + 1
    assert r["after"]["recovery"]["records"] > 0
    assert r["after"]["version"] >= 4  # the version clock continued
    # every task done once by the journal's count
    state = MasterJournal(journal).replay()
    tasks = RECORDS // (BATCH * PER_TASK)
    assert state.counters["done"] == tasks * epochs and not state.pending
    tl = _timeline(timeline)
    for w in (0, 1):
        assert _events(tl[w], "master_relaunched")
        # the workers left the old world and formed one with the new
        # master, at its seeded epoch, at full size
        worlds = _events(tl[w], "established")
        assert worlds[-1]["size"] == 2
        assert worlds[-1]["epoch"] > worlds[0]["epoch"]
    finals = [_final(tl[w]) for w in (0, 1)]
    assert finals[0]["digest"] == finals[1]["digest"]
    # one version a step with a live rank; the first of the two workers
    # (the first boot expects one) stepped alone before the other joined
    assert finals[0]["version"] == max(
        sum(1 for s in _events(tl[w], "step") if s["live"] > 0)
        for w in (0, 1)
    )


def test_the_world_ends_together_when_one_worker_waits_longer(tmp_path,
                                                             data_dir):
    """Worker 1 is told WAIT for 3 s where it would learn that no task is
    left, so worker 0 learns it first. The two end at one step, in the
    world they trained in: worker 0 steps on with no data until worker
    1's stream ends too. (Were each to end on its own stream, worker 0
    would leave while worker 1 still stepped: a broken collective and a
    world of one at the job's end.)"""
    r = _run_job(str(tmp_path), data_dir, hold_wait=(1, 3.0))
    _assert_every_task_once(r, 1)
    assert r["exit_codes"] == {"0": 0, "1": 0}
    tl = r["timeline"]
    for w in (0, 1):
        assert not _events(tl[w], "world_broken"), _events(tl[w],
                                                            "world_broken")
        assert _events(tl[w], "established")[-1]["size"] == 2
    finals = [_final(tl[w]) for w in (0, 1)]
    assert finals[0]["digest"] == finals[1]["digest"]
    assert finals[0]["version"] == finals[1]["version"] > 0
    # both stepped, with no data, through the held seconds
    idle = [s for s in _events(tl[0], "step") if s["live"] == 0]
    assert len(idle) >= 5, len(idle)


def test_a_warmed_standby_takes_the_dead_workers_place(tmp_path, data_dir):
    r = _run_job(str(tmp_path), data_dir, epochs=2, action="kill_worker",
                 victim=1, extra=("--num_standby_workers", "1"))
    _assert_every_task_once(r, 2)
    assert r["exit_codes"]["1"] == -signal.SIGKILL
    # the standby (token 2) was promoted to worker 3; token 4 refilled
    assert [p[:2] for p in r["promotions"]] == [[3, 2]]
    assert not r["cold_relaunches"]
    assert r["exit_codes"]["0"] == r["exit_codes"]["3"] == 0
    tl = r["timeline"]
    (standby,) = _events(tl[3], "standby")
    assert standby["token"] == 2 and standby["promoted_at"] >= r["acted"]
    # one re-form at full size: the bump waited for the promoted worker
    sizes = [w["size"] for w in _events(tl[0], "established")]
    assert sizes[:2] == [2, 2], sizes
    joined = _events(tl[3], "established")
    assert joined[0]["size"] == 2
    assert _final(tl[0])["digest"] == _final(tl[3])["digest"]


def test_evaluation_rounds_run_while_the_workers_train(tmp_path, data_dir):
    val = str(tmp_path / "val")
    os.makedirs(val)
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    rng = np.random.default_rng(1)
    with RecordIOWriter(os.path.join(val, "f0")) as w:
        for _ in range(64):
            w.write(encode_example({
                "image": rng.random(784, dtype=np.float32) * 255,
                "label": np.array([rng.integers(0, 10)], np.int64),
            }))
    r = _run_job(str(tmp_path), data_dir, extra=(
        "--validation_data", val, "--evaluation_steps", "16"))
    rounds = r["published"]
    assert [p["version"] for p in rounds][:3] == [16, 32, 48]
    assert all(p["version"] > 0 and 0 <= p["metrics"]["accuracy"] <= 1
               for p in rounds)
    # every round scored every validation record, at a version > 0
    tl = r["timeline"]
    scored = [e for w in tl for e in _events(tl[w], "eval")]
    by_round = {}
    for e in scored:
        assert e["scored_version"] >= e["version"] > 0
        by_round[e["version"]] = by_round.get(e["version"], 0) + e["rows"]
    assert by_round == {p["version"]: 64 for p in rounds}
    # training tasks, SAVE_MODEL and two evaluation tasks a round, once
    assert r["rc"] == 0 and r["finished"]
    assert len(r["done"]) == len(set(r["done"])) == _tasks(1) + 2 * len(
        rounds)
    finals = [_final(tl[w]) for w in (0, 1)]
    assert finals[0]["digest"] == finals[1]["digest"]
