"""The port's dispatch journal (``elasticdl_tpu_torch/master/journal.py``)
and the dispatcher's recovery, against the reference's.

- One seeded sequence of dispatches, acks, failures, replayed acks,
  version reports and membership changes goes through the JAX
  ``TaskDispatcher``/``MasterServicer``/``MembershipService`` over a JAX
  ``MasterJournal``, and through the port's: both write equal records
  (the head records' wall clock aside), across a second boot that
  replays the first, and both replay to equal ``RecoveryState``s.
- The port replays a journal directory the JAX package wrote (rotated
  segments included) to the JAX package's state, and its dispatcher
  recovers the same tasks under the same traces.
- The cases of the reference's ``tests/test_master_journal.py``, each
  run through both packages: a torn tail, replay twice equals once,
  requeue exactly once with the trace, replayed-ack dedup, exactly-once
  accounting across a kill, a crash mid-epoch, segment rotation, the
  version and member fold, monotonic ``master_epoch``s, the shuffle
  seed, SAVE_MODEL recovery, the pure fold.
- Acks held in the port's ``TaskDataService`` queue across a master boot
  reach the new boot and resolve by their traces.
"""

import glob
import json
import os
import time
import types

import numpy as np
import pytest

from elasticdl_tpu.master import journal as jax_journal
from elasticdl_tpu.master import membership_service as jax_membership
from elasticdl_tpu.master import servicer as jax_servicer
from elasticdl_tpu.master import task_dispatcher as jax_dispatcher
from elasticdl_tpu_torch.common.constants import TaskExecCounterKey, TaskType
from elasticdl_tpu_torch.master import journal as torch_journal
from elasticdl_tpu_torch.master import membership_service as torch_membership
from elasticdl_tpu_torch.master import servicer as torch_servicer
from elasticdl_tpu_torch.master import task_dispatcher as torch_dispatcher

PACKAGES = {
    "jax": types.SimpleNamespace(
        journal=jax_journal, dispatcher=jax_dispatcher,
        servicer=jax_servicer, membership=jax_membership,
    ),
    "torch": types.SimpleNamespace(
        journal=torch_journal, dispatcher=torch_dispatcher,
        servicer=torch_servicer, membership=torch_membership,
    ),
}
SHARDS = {"data.edlr": (0, 120)}
RECORDS_PER_TASK = 12  # 10 tasks per epoch


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def make_dispatcher(pkg, journal, num_epochs=2, shards=None):
    return pkg.dispatcher.TaskDispatcher(
        dict(shards if shards is not None else SHARDS), {}, {},
        RECORDS_PER_TASK, num_epochs, journal=journal,
    )


def boot(pkg, tmpdir, num_epochs=2, **journal_kw):
    """One master boot without the RPC plane: replay, recover, start."""
    journal = pkg.journal.MasterJournal(str(tmpdir), **journal_kw)
    state = journal.replay()
    d = make_dispatcher(pkg, journal, num_epochs=num_epochs)
    d.apply_recovery(state)
    journal.start()
    return journal, d, state


def ack_counters(task):
    return {
        TaskExecCounterKey.TRACE_ID: task.extended_config["trace_id"],
        TaskExecCounterKey.ATTEMPT: task.extended_config.get("_attempt", 0),
    }


def _records(directory):
    """Every record of the chain, in order, the wall clock dropped."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "seg-*.jsonl"))):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                rec.pop("wrote_unix", None)
                out.append(rec)
    return out


def _state(state):
    rec = state.to_record()
    rec.pop("wrote_unix")
    return rec


# ---------------------------------------------------------------------------
# the same events through both packages
# ---------------------------------------------------------------------------


def _drive(pkg, directory, seed, steps, held):
    """One boot driven by ``seed``'s events; ``held`` carries (old task
    id, counters) of completed acks into the next boot, whose replays
    must dedup. Returns the boot's records and the acks it held."""
    rng = np.random.default_rng(seed)
    journal, d, _ = boot(pkg, directory, fsync_interval_s=0.005)
    servicer = pkg.servicer.MasterServicer(
        1, RECORDS_PER_TASK, None, d, coordinates_only=True, journal=journal
    )
    membership = pkg.membership.MembershipService(
        expected_workers=2, form_grace_secs=600, journal=journal
    )
    for tid, counters in held:  # acks replayed against this boot
        servicer.report_task_result(tid, "", dict(counters))
    doing, done, version = [], [], 0
    for _ in range(steps):
        op = int(rng.integers(0, 7))
        if op <= 1:
            tid, task = d.get(worker_id=int(rng.integers(0, 3)))
            if task is not None:
                doing.append((tid, task))
        elif op in (2, 3) and doing:
            tid, task = doing.pop(int(rng.integers(0, len(doing))))
            counters = ack_counters(task)
            if op == 2:
                version += 1
                counters[TaskExecCounterKey.MODEL_VERSION] = version
                servicer.report_task_result(tid, "", counters)
                done.append((tid, counters))
            else:
                servicer.report_task_result(tid, "failed", counters)
        elif op == 4 and done:
            # a replayed ack of a task this boot already counted
            tid, counters = done[int(rng.integers(0, len(done)))]
            d.report(tid + 1000, True, exec_counters=dict(counters))
        elif op == 5:
            membership.register(int(rng.integers(0, 4)), "h")
        elif op == 6:
            membership.remove(int(rng.integers(0, 4)), exit_code=-9)
    journal.close()
    return _records(directory), done[:3] + [
        (tid, ack_counters(task)) for tid, task in doing[:2]
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_events_write_equal_records_and_replay_equal(
    tmp_path, monkeypatch, seed
):
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", str(seed + 5))
    got = {}
    for name, pkg in sorted(PACKAGES.items()):
        directory = str(tmp_path / name)
        first, held = _drive(pkg, directory, seed, 100, [])
        second, _ = _drive(pkg, directory, seed + 100, 60, held)
        state = pkg.journal.MasterJournal(directory).replay()
        got[name] = (first, second, _state(state))
    assert got["torch"] == got["jax"]
    first, second, state = got["torch"]
    kinds = {r["k"] for r in first + second}
    assert {"state", "epoch", "dispatch", "done", "requeue", "dup",
            "version", "member"} <= kinds
    # the second boot opens on the compaction of the first, which folds
    # its recovery's requeues of the tasks in flight at the crash
    assert second[0]["k"] == "state" and second[0]["pending"]
    assert state["counters"]["done"] > 0


def test_the_port_replays_a_jax_journal_to_the_jax_state(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "9")
    directory = str(tmp_path)
    jax = PACKAGES["jax"]
    journal, d, _ = boot(jax, directory, fsync_interval_s=0.005,
                         segment_records=16)
    for i in range(14):  # epoch 0 drained, epoch 1 under way
        tid, task = d.get(worker_id=i % 2)
        if i % 5 != 4:
            d.report(tid, True, exec_counters=ack_counters(task))
    journal.append("version", version=11)
    journal.append("member", event="join", worker=3, epoch=6)
    deadline = time.time() + 10
    while journal.counts()["unflushed"] and time.time() < deadline:
        time.sleep(0.02)
    journal.close()
    heads = [_records(directory)[0]["k"]]
    assert heads == ["state"]  # a rotation published a compaction
    want = jax.journal.MasterJournal(directory).replay()
    got = torch_journal.MasterJournal(directory).replay()
    assert _state(got) == _state(want)
    assert got.version == 11 and got.member_epoch == 6 and got.pending

    def recovered(pkg, state):
        d = make_dispatcher(pkg, None)
        d.apply_recovery(state)
        return [(t.shard_name, t.start, t.end, int(t.type),
                 t.extended_config.get("trace_id"),
                 t.extended_config.get("_attempt"))
                for t in d._todo]

    assert recovered(PACKAGES["torch"], got) == recovered(jax, want)


# ---------------------------------------------------------------------------
# the reference's cases, through both packages
# ---------------------------------------------------------------------------


def test_fresh_boot_is_empty_recovery(pkg, tmp_path):
    journal, d, state = boot(pkg, tmp_path)
    assert state.done_keys == set() and state.pending == {}
    assert d.queue_depths()["todo"] == 10
    journal.close()


def test_done_tasks_stay_done_across_relaunch(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    for _ in range(3):
        tid, _task = d.get(worker_id=1)
        d.report(tid, True)
    journal.close()
    journal2, d2, state = boot(pkg, tmp_path)
    assert len(state.done_keys) == 3
    assert d2.queue_depths()["todo"] == 7
    journal2.close()


def test_inflight_tasks_requeue_exactly_once_with_their_trace(pkg,
                                                              tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    dispatched = [d.get(worker_id=1) for _ in range(4)]
    d.report(dispatched[0][0], True)
    traces = {tid: t.extended_config["trace_id"] for tid, t in dispatched}
    attempts = {tid: t.extended_config["_attempt"] for tid, t in dispatched}
    journal.close()  # the crash: 3 tasks in flight
    journal2, d2, _ = boot(pkg, tmp_path)
    depths = d2.queue_depths()
    assert depths["todo"] == 9 and depths["doing"] == 0
    todo = {t.extended_config.get("trace_id"): t.extended_config.get(
        "_attempt") for t in d2._todo if t.extended_config.get("trace_id")}
    for tid, _task in dispatched[1:]:
        assert todo[traces[tid]] == attempts[tid] + 1
    assert journal2.counts()["requeued"] == 3
    journal2.close()


def test_replay_twice_equals_once(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    for _ in range(3):
        tid, _t = d.get(worker_id=1)
        d.report(tid, True)
    d.get(worker_id=1)  # one in flight
    journal.close()
    j = pkg.journal.MasterJournal(str(tmp_path))
    once, twice = j.replay(), j.replay()
    assert _state(once) == _state(twice)
    other = pkg.journal.MasterJournal(str(tmp_path)).replay()
    assert _state(other) == _state(once)


def test_torn_final_record_is_dropped(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    tid1, _ = d.get(worker_id=1)
    d.get(worker_id=1)
    d.report(tid1, True)
    journal.close()
    segs = sorted(glob.glob(str(tmp_path / "seg-*.jsonl")))
    with open(segs[-1], "ab") as f:
        f.write(b'{"k": "done", "trace": "t0000')
    journal2, d2, state = boot(pkg, tmp_path)
    assert len(state.done_keys) == 1 and len(state.pending) == 1
    assert d2.queue_depths()["todo"] == 9
    journal2.close()


def test_replayed_ack_resolves_and_dedups(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    done_tid, done_task = d.get(worker_id=1)
    inflight_tid, inflight_task = d.get(worker_id=1)
    d.report(done_tid, True, exec_counters=ack_counters(done_task))
    journal.close()
    journal2, d2, _ = boot(pkg, tmp_path)
    before = d2.queue_depths()["todo"]
    # the held ack replays with the dead boot's task id and its trace
    d2.report(inflight_tid, True, exec_counters=ack_counters(inflight_task))
    assert d2.queue_depths()["todo"] == before - 1
    d2.report(inflight_tid, True, exec_counters=ack_counters(inflight_task))
    assert d2.queue_depths()["todo"] == before - 1
    d2.report(done_tid, True, exec_counters=ack_counters(done_task))
    counts = journal2.counts()
    assert counts["deduped"] == 2 and counts["done"] == 2
    journal2.close()


def test_full_job_exactly_once_accounting_across_a_kill(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    for _ in range(6):
        tid, _t = d.get(worker_id=1)
        d.report(tid, True)
    d.get(worker_id=1)  # in flight at the kill
    journal.close()
    journal2, d2, _ = boot(pkg, tmp_path)
    while True:
        tid, task = d2.get(worker_id=1)
        if task is None:
            break
        d2.report(tid, True, exec_counters=ack_counters(task))
    assert d2.finished()
    counts = journal2.counts()
    assert counts["done"] == 20 and counts["pending"] == 0, counts
    journal2.close()


def test_a_crash_mid_second_epoch_resumes_that_epoch(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path)
    for _ in range(14):  # epoch 0, then 4 of epoch 1
        tid, _t = d.get(worker_id=1)
        d.report(tid, True)
    journal.close()
    journal2, d2, state = boot(pkg, tmp_path)
    assert state.epoch == 1 and d2._epoch == 1
    assert d2.queue_depths()["todo"] == 6
    journal2.close()


def test_segment_rotation_compacts_and_replays_identically(pkg, tmp_path):
    journal = pkg.journal.MasterJournal(
        str(tmp_path), fsync_interval_s=0.005, segment_records=32
    )
    state = journal.replay()
    d = make_dispatcher(pkg, journal, num_epochs=4)
    d.apply_recovery(state)
    journal.start()
    done = 0
    for _ in range(30):
        tid, task = d.get(worker_id=1)
        if task is None:
            break
        d.report(tid, True)
        done += 1
        time.sleep(0.002)  # let the writer rotate between batches
    deadline = time.time() + 10
    while journal.counts()["unflushed"] and time.time() < deadline:
        time.sleep(0.02)
    journal.close()
    segs = glob.glob(str(tmp_path / "seg-*.jsonl"))
    assert len(segs) <= 2, "rotation unlinks superseded segments"
    with open(sorted(segs)[0], "rb") as f:
        assert json.loads(f.readline())["k"] == "state"
    replayed = pkg.journal.MasterJournal(str(tmp_path)).replay()
    assert replayed.counters["done"] == done and not replayed.pending


def test_version_and_member_epoch_fold(pkg, tmp_path):
    journal = pkg.journal.MasterJournal(str(tmp_path))
    journal.replay()
    journal.start()
    journal.append("version", version=3)
    journal.append("version", version=7)
    journal.append("member", event="join", worker=1, epoch=2)
    journal.append("member", event="leave", worker=1, epoch=5)
    journal.flush()
    journal.close()
    state = pkg.journal.MasterJournal(str(tmp_path)).replay()
    assert state.version == 7 and state.member_epoch == 5


def test_master_epoch_mint_is_monotonic(pkg, tmp_path):
    e1 = pkg.journal.mint_master_epoch(str(tmp_path))
    e2 = pkg.journal.mint_master_epoch(str(tmp_path))
    assert e2 == e1 + 1
    assert pkg.journal.mint_master_epoch(None) > 0


def test_task_shuffle_seed_pins_task_order(pkg, monkeypatch):
    def order(seed):
        monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", str(seed))
        return [t._info() for t in make_dispatcher(pkg, None)._todo]

    assert order(11) == order(11)
    assert order(11) != order(12)


def test_save_model_task_recovers_from_the_journal(pkg, tmp_path):
    journal, d, _ = boot(pkg, tmp_path, num_epochs=1)
    d.add_deferred_callback_create_save_model_task(str(tmp_path / "export"))
    for _ in range(10):
        tid, _t = d.get(worker_id=1)
        d.report(tid, True)
    assert d.invoke_deferred_callback()
    _, save_task = d.get(worker_id=1)
    assert save_task.type == TaskType.SAVE_MODEL
    journal.close()  # the crash, with the export in flight
    journal2, d2, _ = boot(pkg, tmp_path, num_epochs=1)
    # rebuilt from its journaled config; the callback does not fire again
    saves = [t for t in d2._todo if t.type == TaskType.SAVE_MODEL]
    assert len(saves) == 1
    assert saves[0].extended_config.get("saved_model_path") == str(
        tmp_path / "export")
    assert not d2.invoke_deferred_callback()
    tid, task = d2.get(worker_id=1)
    assert task.type == TaskType.SAVE_MODEL
    d2.report(tid, True, exec_counters=ack_counters(task))
    assert d2.finished()
    journal2.close()


def test_recovery_state_is_a_pure_fold_that_skips_unknown_kinds(pkg):
    s = pkg.journal.RecoveryState()
    key = [0, 0, "f", 0, 12]
    s.apply({"k": "dispatch", "trace": "t000005", "attempt": 0, "key": key})
    s.apply({"k": "some_future_kind", "x": 1})
    s.apply({"k": "done", "trace": "t000005", "attempt": 0, "key": key})
    assert s.trace_seq == 5
    assert pkg.journal.task_key(0, 0, "f", 0, 12) in s.done_keys
    assert s.pending == {}


# ---------------------------------------------------------------------------
# held acks across a master boot
# ---------------------------------------------------------------------------


def test_held_acks_reach_the_next_boot_and_resolve_by_trace(tmp_path):
    """The worker's ack queue holds acks past a master's death; drained
    against the relaunched master, they name the dead boot's task ids
    and resolve by their traces: each task done once, none dispatched
    again."""
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter
    from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

    data = tmp_path / "data"
    data.mkdir()
    with RecordIOWriter(str(data / "f0")) as w:
        for i in range(48):
            w.write(b"record-%d" % i)
    shards = {str(data / "f0"): (0, 48)}  # 4 tasks of 12

    class Worker:
        def __init__(self, d):
            self.d = d

        def get_task(self, task_type=None):
            tid, task = self.d.get(0)
            return _response(tid, task)

        def report_task_result(self, task_id, err_msg="",
                               exec_counters=None):
            self.d.report(task_id, not err_msg, exec_counters=exec_counters)

    journal_dir = str(tmp_path / "journal")

    def master_boot():
        journal = torch_journal.MasterJournal(journal_dir)
        state = journal.replay()
        d = torch_dispatcher.TaskDispatcher(shards, {}, {}, 12, 1,
                                            journal=journal)
        d.apply_recovery(state)
        journal.start()
        return journal, d, state

    journal, d, _ = master_boot()
    worker = Worker(d)
    tds = TaskDataService(worker, False, ack_queue_size=8,
                          data_reader_params={"data_origin": str(data)})
    consumed = 0
    for _ in tds.get_dataset():
        consumed += 1
        if consumed % 6 == 0:
            tds.report_record_done(6)
    assert consumed == 48
    assert journal.counts()["done"] == 0  # every ack is still held
    journal.close()  # the master dies

    journal2, d2, state = master_boot()
    assert len(state.pending) == 4
    worker.d = d2
    tds.drain_acks()
    counts = journal2.counts()
    assert counts["done"] == 4 and counts["pending"] == 0, counts
    assert d2.get(0) == (-1, None) and d2.finished()
    journal2.close()


def _response(task_id, task):
    from elasticdl_tpu_torch.master.servicer import TaskResponse

    if task is None:
        return TaskResponse()
    return TaskResponse(
        task_id=task_id, shard_name=task.shard_name, start=task.start,
        end=task.end, type=task.type,
        extended_config=dict(task.extended_config),
    )
