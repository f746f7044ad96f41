"""Membership epochs for the elastic allreduce plane, the counterpart of
``elasticdl_tpu/master/membership_service.py``.

The master is the one agreement point of the collective plane: every
worker holds a slot in one process world, so survivors and joiners must
agree on a world (size, ranks, coordinator address) before any
collective runs. The service speaks three verbs:

- ``register(worker_id, host)``: a worker process announces itself; the
  world grows at the next epoch bump;
- ``remove(worker_id)``: a death reported by the instance manager, or a
  worker's graceful leave; the world shrinks;
- ``get_world(worker_id)``: a poll that returns the current epoch's world
  for that worker, or ``ready=False`` while it forms.

Epoch rules, as the reference's. The first world forms when ``expected``
workers have registered, or ``form_grace_secs`` after the first one did.
Every later membership change bumps the epoch and recomputes the world
as the sorted live set: ranks ascend with the worker id, relaunched
workers get fresh, higher ids, so rank 0 is the longest-lived survivor,
the source of the state broadcast after a re-form. Deaths bump at once;
growth is coalesced, a joiner parking in a lobby while a formation is in
flight. Formation is two-phase: ``ready`` stays False until every member
has polled the new epoch from its await loop, and a member that does not
within ``confirm_timeout_secs`` is dropped (and fenced). Each epoch gets
a fresh coordinator port.

A relaunched master's service is empty: :meth:`MembershipService.seed_epoch`
starts it past the journaled epoch (``member`` records, one per join and
leave). Before its first world forms, a worker's poll may name the size
and epoch of the world it is still in (``world_size``, ``world_epoch``):
the service then waits for that many (the form grace still bounds the
wait) and forms past that epoch. A relaunched master is told neither
the old world's size nor, since bumps that no join or leave caused are
not journaled, its epoch.

:class:`StandbyPool` holds the pre-warmed spare workers. A death that a
standby will replace defers its bump (``defer_bump_secs``) until the
promoted worker registers, so the survivors re-form once, at full size.
The reply of a promotion carries the device of the slot it fills, which
the standby does not know while it is parked.
"""

import socket
import threading
import time

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling

# How long a death bump may wait for a promoted standby's registration.
# It stays below the survivors' wait for a bump after a broken collective
# (the worker's epoch_poll_secs, 10 s by default).
DEATH_BUMP_DEFER_SECS = 6.0


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class StandbyPool:
    """Pre-warmed spare workers, parked until a death needs one. A
    standby polls :meth:`poll` with its token and stays out of the
    membership until :meth:`activate` hands it a worker id (and the
    device of the slot it fills); the poll then returns that id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parked = {}  # token -> assigned worker id (None: parked)
        self._devices = {}  # token -> the device its promotion names

    def poll(self, token):
        """The standby's heartbeat: registers the token on its first call
        and returns the assigned worker id once activated, else None."""
        with self._lock:
            if token not in self._parked:
                self._parked[token] = None
            return self._parked[token]

    def device(self, token):
        """The device the promotion of ``token`` named (None if none)."""
        with self._lock:
            return self._devices.get(token)

    def activate(self, worker_id, device=None):
        """Hand ``worker_id`` to a parked standby; its token, or None when
        no standby has polled yet (one still in its cold start gives no
        head start)."""
        with self._lock:
            for token, assigned in self._parked.items():
                if assigned is None:
                    self._parked[token] = worker_id
                    self._devices[token] = device
                    return token
            return None

    def forget(self, token):
        with self._lock:
            self._parked.pop(token, None)
            self._devices.pop(token, None)

    def parked_count(self):
        with self._lock:
            return sum(1 for v in self._parked.values() if v is None)


class MembershipService:
    # process exit codes whose *announced* exits are protocol-clean:
    # 0 = completion after global quiescence, 75 = graceful drain
    CLEAN_EXIT_CODES = (0, 75)

    def __init__(
        self,
        expected_workers,
        base_port=0,
        form_grace_secs=30.0,
        confirm_timeout_secs=None,
        stale_form_secs=None,
        world_size_multiple=1,
        journal=None,
    ):
        """``base_port=0`` picks ephemeral coordinator ports (one host);
        otherwise epoch N's coordinator binds ``base_port + N % 64`` on
        rank 0's host. ``world_size_multiple`` rounds every formed world
        down to a multiple, the overflow members staying live as spares
        (``{"spare": True}``); the replicated plane uses 1. ``journal``
        gets a ``member`` record at each join and leave."""
        self._expected = max(1, expected_workers)
        self._world_multiple = max(1, int(world_size_multiple))
        self._base_port = base_port
        self._form_grace_secs = form_grace_secs
        from elasticdl_tpu_torch.parallel.distributed import (
            world_init_timeout,
        )

        if confirm_timeout_secs is None:
            # above the workers' formation timeout, so a member stuck in
            # a stale formation fails and re-polls before it is fenced
            confirm_timeout_secs = world_init_timeout() + 5.0
        self._confirm_timeout = confirm_timeout_secs
        if stale_form_secs is None:
            stale_form_secs = confirm_timeout_secs + world_init_timeout()
        self._stale_form_secs = stale_form_secs
        self._lock = threading.Lock()
        self._live = {}  # worker_id -> advertised host
        # a relaunched master seeds this past the journaled epoch
        self._epoch = 0
        self._journal = journal
        self._world = []  # [(worker_id, host)] of the current epoch
        self._coordinator = None
        self._formed_initial = False
        self._first_register_time = None
        self._confirmed = set()  # members that polled the current epoch
        self._world_ready = False
        self._bump_time = None
        self._last_poll = {}  # worker_id -> wall time of last poll
        self._fencer = None
        self._formed = set()  # members seen training in the current epoch
        self._lobby = {}  # joiners parked while a formation is in flight
        # members that announced their leave (id -> epoch of the
        # announcement): not re-registered, and their clean exits stay
        # off the dead list
        self._departing = {}
        # ids removed because their process died (id -> epoch at death):
        # the survivors' abort probe fires only for these, never for a
        # growth bump or a drain
        self._dead = {}
        self.standby = StandbyPool()
        self._pending_bump_deadline = None  # a deferred death bump

    def set_fencer(self, fencer):
        """``fencer(worker_id)`` forcibly ends a member dropped for not
        confirming (a wedged process would otherwise hold its tasks)."""
        self._fencer = fencer

    @property
    def epoch(self):
        return self._epoch

    def members(self):
        """The ids registered now (live or waiting in the lobby)."""
        with self._lock:
            return sorted(set(self._live) | set(self._lobby))

    def seed_epoch(self, floor):
        """Start past a previous incarnation's journaled epoch (at boot,
        before the RPC plane serves)."""
        with self._lock:
            self._epoch = max(self._epoch, int(floor))

    def _formation_in_flight(self):
        """True while the current world is still coming up: the confirm
        phase is open, or not every member has been seen training."""
        if not self._world:
            return False
        ids = set(w for w, _ in self._world)
        return not self._world_ready or not ids <= self._formed

    def _bump_locked(self):
        self._pending_bump_deadline = None
        # prune deaths and departures no lagging member can still
        # reference (members trail by at most a couple of epochs)
        self._dead = {
            w: e for w, e in self._dead.items() if e >= self._epoch - 4
        }
        self._departing = {
            w: e
            for w, e in self._departing.items()
            if e >= self._epoch - 4
        }
        self._live.update(self._lobby)
        self._lobby = {}
        self._epoch += 1
        self._world = sorted(self._live.items())
        if self._world_multiple > 1:
            usable = (
                len(self._world)
                // self._world_multiple
                * self._world_multiple
            )
            if usable == 0 and self._world:
                logger.warning(
                    "world rounds down to 0 of %d live members "
                    "(world_size_multiple=%d): training is PAUSED "
                    "until the pool refills",
                    len(self._world),
                    self._world_multiple,
                )
            self._world = self._world[:usable]
        self._confirmed = set()
        self._formed = set()
        self._world_ready = not self._world
        self._bump_time = time.time()
        if self._world:
            rank0_host = self._world[0][1]
            port = (
                self._base_port + self._epoch % 64
                if self._base_port
                else _free_port()
            )
            self._coordinator = "%s:%d" % (rank0_host, port)
        else:
            self._coordinator = None
        logger.info(
            "membership epoch %d: world=%s coordinator=%s",
            self._epoch,
            [w for w, _ in self._world],
            self._coordinator,
        )

    def register(self, worker_id, host="localhost", world_size=0,
                 world_epoch=0):
        """Add a member. ``world_size``/``world_epoch``: the world the
        worker is still in, which a relaunched master waits for, and
        forms past, before its first world forms."""
        epoch = self._register_locked(worker_id, host, world_size,
                                      world_epoch)
        if epoch is None:
            return
        # emitted outside the lock: the event sink's write is disk IO
        profiling.events.emit(
            "worker_join", _ship=False, worker_id=worker_id, host=host,
            epoch=epoch,
        )
        if self._journal is not None:
            self._journal.append(
                "member", event="join", worker=worker_id, epoch=epoch
            )

    def _register_locked(self, worker_id, host, world_size, world_epoch):
        """The transition; the epoch the new member serves in, or None
        when nothing changed."""
        with self._lock:
            if worker_id in self._departing:
                # a draining member polls until it sees its own bump;
                # re-adding it would re-grow the world it is leaving
                return None
            self._dead.pop(worker_id, None)  # evidently alive
            if not self._formed_initial:
                self._expected = max(self._expected, int(world_size))
                self._epoch = max(self._epoch, int(world_epoch))
            if (
                self._live.get(worker_id) == host
                or self._lobby.get(worker_id) == host
            ):
                return None
            if self._first_register_time is None:
                self._first_register_time = time.time()
            if not self._formed_initial:
                self._live[worker_id] = host
                if len(self._live) >= self._expected:
                    self._formed_initial = True
                    self._bump_locked()
            elif self._formation_in_flight():
                # growth coalesces: bumping now would strand members that
                # already took the ready spec in a stale formation
                self._live.pop(worker_id, None)
                self._lobby[worker_id] = host
            else:
                # a promoted standby's registration also ends a deferred
                # death bump here: one re-form at full size
                self._live[worker_id] = host
                self._bump_locked()
            return self._epoch

    def remove(self, worker_id, departing=False, defer_bump_secs=0,
               exit_code=None):
        """Drop a member and bump. ``departing=True`` is the worker's own
        announced leave (before its process exits): the id is also kept
        from registering again. ``exit_code`` is the exit the instance
        manager saw. The dead list errs toward dead: an exit is left off
        only when it is clean (0 or 75) and the worker announced it.
        ``defer_bump_secs > 0``: a warmed standby is being promoted for
        this death, so the bump waits (at most that long) for its
        registration; the member leaves the live set and joins the dead
        list at once, so the survivors' abort probes still fire."""
        epoch = self._remove_locked(
            worker_id, departing, defer_bump_secs, exit_code
        )
        if epoch is None:
            return
        profiling.events.emit(
            "worker_leave", _ship=False, worker_id=worker_id,
            departing=departing, exit_code=exit_code, epoch=epoch,
        )
        if self._journal is not None:
            self._journal.append(
                "member", event="leave", worker=worker_id, epoch=epoch
            )

    def _remove_locked(self, worker_id, departing, defer_bump_secs,
                       exit_code):
        with self._lock:
            if departing:
                self._departing[worker_id] = self._epoch
            elif not (
                exit_code in self.CLEAN_EXIT_CODES
                and worker_id in self._departing
            ):
                self._dead[worker_id] = self._epoch
            self._lobby.pop(worker_id, None)
            if worker_id not in self._live:
                return None
            del self._live[worker_id]
            if self._formed_initial:
                if (
                    defer_bump_secs > 0
                    and self._pending_bump_deadline is None
                ):
                    self._pending_bump_deadline = (
                        time.time() + defer_bump_secs
                    )
                    logger.info(
                        "death of %d: bump deferred up to %.1fs for a "
                        "standby promotion",
                        worker_id,
                        defer_bump_secs,
                    )
                    return self._epoch
                # deaths re-form at once: survivors in the broken
                # collective fail fast and re-poll
                self._bump_locked()
            return self._epoch

    def get_world(self, worker_id, host="localhost", awaiting=True,
                  world_size=0, world_epoch=0):
        """Poll and register in one verb (workers call it in a loop).

        ``awaiting=True``: the caller waits in its await loop and forms
        the world as soon as it is ``ready``, so the poll confirms the
        epoch. Polls from the training loop pass False: the worker has
        seen the bump but must leave its current world first.
        ``world_size`` and ``world_epoch`` are :meth:`register`'s."""
        self.register(worker_id, host, world_size, world_epoch)
        now = time.time()
        to_fence = []
        try:
            return self._get_world_locked(
                worker_id, now, awaiting, to_fence
            )
        finally:
            # fence outside the lock: a slow kill must not stall polls
            if to_fence and self._fencer is not None:
                for w in to_fence:
                    try:
                        self._fencer(w)
                    except Exception:
                        logger.warning(
                            "fencing worker %d failed", w, exc_info=True
                        )

    def _get_world_locked(self, worker_id, now, awaiting, to_fence):
        with self._lock:
            self._last_poll[worker_id] = now
            if (
                self._pending_bump_deadline is not None
                and now >= self._pending_bump_deadline
            ):
                # the promoted standby did not register in time: re-form
                # without it (it joins later as ordinary growth)
                self._bump_locked()
            if not self._formed_initial:
                grace_over = (
                    self._first_register_time is not None
                    and now - self._first_register_time
                    > self._form_grace_secs
                )
                if grace_over and self._live:
                    logger.warning(
                        "forming world with %d/%d workers after grace",
                        len(self._live),
                        self._expected,
                    )
                    self._formed_initial = True
                    self._bump_locked()
                else:
                    return {"epoch": self._epoch, "ready": False,
                            "dead": sorted(self._dead)}
            ids = [w for w, _ in self._world]
            if worker_id not in ids:
                # in the lobby, removed but alive (register re-added or
                # parked it), or a spare of the world-size rounding
                if self._lobby and self._world_ready:
                    # staleness valve: a formation this late will break
                    # anyway; stop holding the joiners
                    if now - self._bump_time > self._stale_form_secs:
                        self._bump_locked()
                return {
                    "epoch": self._epoch,
                    "ready": False,
                    "spare": worker_id in self._live,
                    "dead": sorted(self._dead),
                }
            if self._world_ready and not awaiting:
                # the training loop's per-step poll: this member formed
                # the current world
                if worker_id not in self._formed:
                    self._formed.add(worker_id)
                    if not self._formation_in_flight() and self._lobby:
                        # formation done and joiners wait: grow now
                        self._bump_locked()
                        return {"epoch": self._epoch, "ready": False,
                                "dead": sorted(self._dead)}
            if not self._world_ready:
                if awaiting:
                    self._confirmed.add(worker_id)
                if set(ids) <= self._confirmed:
                    self._world_ready = True
                elif now - self._bump_time > self._confirm_timeout:
                    # drop members that went quiet (dead, or wedged in a
                    # stale formation); they re-join by their next poll
                    lagging = [
                        w
                        for w in ids
                        if w not in self._confirmed
                        and now - self._last_poll.get(w, 0) > 2.0
                    ]
                    if lagging:
                        logger.warning(
                            "world %d: dropping unresponsive members %s",
                            self._epoch,
                            lagging,
                        )
                        for w in lagging:
                            self._live.pop(w, None)
                        self._bump_locked()
                        to_fence.extend(lagging)
                        return {"epoch": self._epoch, "ready": False,
                                "dead": sorted(self._dead)}
                    self._bump_time = now  # responsive but slow: wait on
                if not self._world_ready:
                    return {"epoch": self._epoch, "ready": False,
                            "dead": sorted(self._dead)}
            return {
                "epoch": self._epoch,
                "ready": True,
                "coordinator": self._coordinator,
                "num_processes": len(ids),
                "process_id": ids.index(worker_id),
                "members": ids,
                "dead": sorted(self._dead),
                "live": len(self._live) + len(self._lobby),
            }
