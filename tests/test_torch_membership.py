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
the form grace), plus a kill-and-relaunch journey and a drain.
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


def _play(cls, kwargs, script, clock):
    m = cls(**kwargs)
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
    assert any(r["ready"] for r in replies)
    if name == "dead_list":
        assert any(r["dead"] for r in replies)
    if name == "confirm_timeout":
        assert got[-1] == ("fenced", [0])
