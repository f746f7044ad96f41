"""The port's ``MembershipService`` against the reference's
(``elasticdl_tpu/master/membership_service.py``).

Each script is the same sequence of register, remove, leave and
get_world calls, with a patched clock, fed to both services; every
reply is recorded with its coordinator address replaced by its order of
first appearance (the ports differ, since each epoch picks a free one).
Epochs, readiness, ranks, world sizes and members, coordinator changes,
dead lists, spares and the members fenced must be equal call for call.
The scripts are those of ``tests/test_elastic_allreduce.py:41-176``
(epochs and growth, the dead list of real crashes, the confirm timeout,
the form grace), plus a kill-and-relaunch journey and a drain, the
standby pool, a death's bump deferred for a promoted standby (kept, and
timed out), and a relaunched master's seeded epoch. Each service also
writes its ``member`` records to a journal, which must be equal.
"""

import time

import pytest

from elasticdl_tpu.master.membership_service import (
    MembershipService as JMembership,
)
from elasticdl_tpu_torch.master.membership_service import (
    MembershipService as TMembership,
)


class _Clock:
    def __init__(self):
        self.now = 1_000_000.0

    def __call__(self):
        return self.now


def _normalize(reply, coordinators):
    out = dict(reply)
    if out.get("coordinator") is not None:
        out["coordinator"] = coordinators.setdefault(
            out["coordinator"], len(coordinators)
        )
    return out


class _Journal:
    def __init__(self):
        self.records = []

    def append(self, kind, **fields):
        self.records.append(dict(fields, k=kind))


def _play(cls, kwargs, script, clock):
    journal = _Journal()
    m = cls(journal=journal, **kwargs)
    fenced = []
    m.set_fencer(fenced.append)
    coordinators = {}
    log = []
    for op in script:
        kind = op[0]
        if kind == "get":
            _, wid, kw = op
            log.append(("get", wid, _normalize(m.get_world(wid, **kw),
                                               coordinators)))
        elif kind == "remove":
            _, wid, kw = op
            m.remove(wid, **kw)
            log.append(("remove", wid, m.epoch))
        elif kind == "advance":
            clock.now += op[1]
        elif kind == "seed":
            m.seed_epoch(op[1])
        elif kind == "pool":
            # ("pool", verb, argument): the standby pool's verbs
            _, verb, arg = op
            got = getattr(m.standby, verb)(*(() if arg is None else (arg,)))
            log.append(("pool", verb, arg, got, m.standby.parked_count()))
        elif kind == "train_all":
            # every member of the current world confirms, then trains
            for _ in range(op[1]):
                members = [w for w, _ in m._world]
                for wid in members:
                    m.get_world(wid)
                for wid in members:
                    m.get_world(wid, awaiting=False)
            log.append(("train_all", m.epoch))
        else:
            raise ValueError(kind)
        log.append(("epoch", m.epoch))
    log.append(("fenced", fenced))
    log.append(("journal", journal.records))
    return log


def G(wid, **kw):
    return ("get", wid, kw)


def R(wid, **kw):
    return ("remove", wid, kw)


SCRIPTS = {
    # test_membership_epochs: quorum, two-phase confirm, a death shrinks,
    # a relaunch parks in the lobby until formation completes, growth,
    # the coordinator rotates, a later joiner bumps at once
    "epochs": (
        dict(expected_workers=2, form_grace_secs=60),
        [G(0), G(1), G(0)] + [G(1)] * 2 + [G(0), G(1)]
        + [R(0)] + [G(1)] * 2
        + [G(2), G(2), G(1, awaiting=False), G(1), G(2)] + [G(2)] * 2
        + [G(1)] * 2
        + [G(1, awaiting=False), G(2, awaiting=False), G(3), G(3)],
    ),
    # test_membership_dead_list_only_real_crashes: announced clean exits
    # stay off the dead list, every other exit lands on it, and deaths
    # are pruned once the epochs move past the window
    "dead_list": (
        dict(expected_workers=3, form_grace_secs=60),
        [G(0), G(1), G(2), G(0)]
        + [R(0, departing=True), R(0, exit_code=0), G(1)]
        + [R(1, departing=True), R(1, exit_code=75), G(2)]
        + [R(2), G(3)]
        + [G(19), R(19, exit_code=0), G(3)]
        + [G(20), R(20, exit_code=75), G(3)]
        + [G(21), R(21, departing=True), R(21, exit_code=139), G(3)]
        + sum(([G(j), ("train_all", 5)] for j in range(4, 11)), [])
        + [G(3)],
    ),
    # test_membership_unconfirmed_member_dropped_after_timeout: a member
    # that stops polling is dropped (and fenced) after the confirm window
    "confirm_timeout": (
        dict(expected_workers=2, form_grace_secs=60,
             confirm_timeout_secs=0.3),
        [G(0), G(1), ("advance", 3.0), G(1), G(1), G(1)],
    ),
    # test_membership_grace_forms_partial_world
    "form_grace": (
        dict(expected_workers=3, form_grace_secs=0.2),
        [G(0), ("advance", 0.3), G(0), G(0)],
    ),
    # a job's journey: two workers train, one is killed, the survivor
    # re-forms alone, the relaunch joins once the survivor trains, and
    # the grown world trains; then a drain and a clean end
    "kill_and_relaunch": (
        dict(expected_workers=2, form_grace_secs=30),
        [G(0, awaiting=False), G(1, awaiting=False), G(0), G(1), G(0),
         G(1), G(0, awaiting=False), G(1, awaiting=False)]
        + [R(1, exit_code=-9), G(0, awaiting=False), G(0), G(0)]
        + [G(2, awaiting=False), G(2), G(0, awaiting=False), G(0),
           G(2), G(0), G(2), G(0, awaiting=False), G(2, awaiting=False)]
        + [R(2, departing=True), G(2, awaiting=False),
           G(0, awaiting=False), G(0), G(0)]
        + [R(2, exit_code=75), G(0, awaiting=False),
           R(0, departing=True), R(0, exit_code=0), G(3)],
    ),
    # the standby pool: tokens park on their first poll, an activation
    # takes one, its poll returns the worker id, a forgotten token is
    # gone, and with none parked an activation finds nothing
    "standby_pool": (
        dict(expected_workers=1, form_grace_secs=60),
        [("pool", "poll", 10), ("pool", "poll", 11),
         ("pool", "activate", 5), ("pool", "poll", 10),
         ("pool", "poll", 11), ("pool", "forget", 11),
         ("pool", "activate", 6), ("pool", "poll", 11),
         ("pool", "activate", 7), ("pool", "parked_count", None)],
    ),
    # a death with a standby on its way: the member leaves the live set
    # and joins the dead list at once, the bump waits, and the promoted
    # worker's registration forms the full world in one bump
    "deferred_bump": (
        dict(expected_workers=2, form_grace_secs=60),
        [G(0), G(1), G(0), G(1), G(0, awaiting=False),
         G(1, awaiting=False)]
        + [R(1, exit_code=-9, defer_bump_secs=6.0),
           G(0, awaiting=False), ("advance", 2.0), G(0, awaiting=False)]
        + [G(3, awaiting=False), G(0, awaiting=False), G(0), G(3),
           G(0), G(3), G(0, awaiting=False), G(3, awaiting=False)],
    ),
    # the promoted standby never registers: the deadline bumps without
    # it, and it joins later as ordinary growth
    "deferred_bump_deadline": (
        dict(expected_workers=2, form_grace_secs=60),
        [G(0), G(1), G(0), G(1), G(0, awaiting=False),
         G(1, awaiting=False)]
        + [R(1, exit_code=-9, defer_bump_secs=6.0),
           G(0, awaiting=False), ("advance", 7.0), G(0, awaiting=False),
           G(0), G(0), G(0, awaiting=False), G(3, awaiting=False),
           G(0, awaiting=False), G(3), G(0)],
    ),
    # a relaunched master: its service starts past the journaled epoch
    "seeded_epoch": (
        dict(expected_workers=2, form_grace_secs=60),
        [("seed", 7), G(0, awaiting=False), G(1, awaiting=False), G(0),
         G(1), G(0), ("seed", 3), G(1, awaiting=False)],
    ),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_membership_matches_reference(monkeypatch, name):
    kwargs, script = SCRIPTS[name]
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    want = _play(JMembership, kwargs, script, clock)
    clock.now = 1_000_000.0
    got = _play(TMembership, kwargs, script, clock)
    assert got == want
    # the script exercises what it names
    replies = [entry[2] for entry in got if entry[0] == "get"]
    assert not replies or any(r["ready"] for r in replies)
    if name == "dead_list":
        assert any(r["dead"] for r in replies)
    if name == "confirm_timeout":
        assert got[-2] == ("fenced", [0])
    if name.startswith("deferred_bump"):
        assert ("remove", 1, 1) in got  # no bump at the death itself
    if name == "seeded_epoch":
        assert min(r["epoch"] for r in replies) == 7
        assert all(r["epoch"] == 8 for r in replies if r["ready"])
    if name == "standby_pool":
        assert ("pool", "poll", 10, 5, 1) in got


def test_a_relaunched_master_waits_for_the_world_a_worker_names():
    """The port's membership (no reference counterpart): before its
    first world forms, a worker may name the size and epoch of the world
    it is still in; a relaunched master told ``expected_workers=1`` then
    forms one world of both workers, not one of the first poller, past
    the epoch they name."""
    m = TMembership(expected_workers=1, form_grace_secs=60)
    m.seed_epoch(5)
    first = m.get_world(0, awaiting=False, world_size=2)
    assert not first["ready"] and m.epoch == 5
    m.get_world(1, awaiting=False, world_size=2)
    assert m.epoch == 6
    replies = [m.get_world(w) for w in (0, 1, 0)]
    assert replies[-1]["ready"] and replies[-1]["members"] == [0, 1]
    # a formed world ignores the hint
    m.get_world(0, awaiting=False)
    m.get_world(1, awaiting=False)
    m.get_world(2, awaiting=False, world_size=9, world_epoch=40)
    assert m.epoch == 7 and m._expected == 2
    # a journal that missed bumps: the epoch a worker names is passed
    m = TMembership(expected_workers=1, form_grace_secs=60)
    m.seed_epoch(5)
    m.get_world(0, awaiting=False, world_size=2, world_epoch=9)
    m.get_world(1, awaiting=False, world_size=2, world_epoch=9)
    assert m.epoch == 10
