"""Deterministic scripted fault plane for PS-fleet chaos drives, the
counterpart of ``elasticdl_tpu/tools/chaos.py``.

Scripted, seeded, replayable fault schedules at two levels:

- :class:`ScriptedFaultPS` wraps any in-process PS-interface object (a
  ``PserverServicer``, a ``BoundPS``) with a deterministic per-call fault
  script: delay / partition (error) / reject windows keyed by call
  index, and kill-at-version keyed by the shard's reported optimizer
  version.
- :class:`FleetChaos` drives real fleets: a poller watches each shard's
  ``ps_status`` version (or the master's ``master_status``) and executes
  :class:`ChaosOp` entries (SIGKILL / SIGTERM at a version, or at a
  count of done tasks) against a
  :class:`~elasticdl_tpu_torch.master.local_instance_manager.
  LocalInstanceManager` (``kill_ps``/``terminate_ps``/``kill_master``/
  ``terminate_master``), logging every executed op for post-run
  asserts. Each executed op is a ``chaos_kill``/``chaos_term`` event of
  ``utils/profiling``, which the flight recorder triggers on.

:func:`seeded_schedule` derives a reproducible schedule from a seed (the
reference's draws, so one seed gives both packages the same schedule),
so a failing chaos run is a (seed, schedule) pair anyone can replay.
"""

import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling


class ChaosPartitionError(RuntimeError):
    """Raised by a ScriptedFaultPS call landing in a partition window
    (the in-process stand-in for a dead/unreachable pod; over sockets
    the same outage surfaces as ``PSRpcError``)."""


class ChaosOp:
    """One scripted fault.

    ``kind``: ``"kill"`` (SIGKILL, no drain) / ``"term"`` (SIGTERM,
    drain snapshot + exit 75) for the PS fleet level;
    ``"kill_master"`` / ``"term_master"`` for scripted MASTER outages
    (SIGKILL loses the un-fsynced journal tail, SIGTERM drains it and
    exits 75); ``"delay"`` /
    ``"partition"`` / ``"reject"`` for the in-process call level.
    ``shard``: target PS id (ignored by master ops — pass -1).
    ``at_version``: fleet ops fire when the target's reported version
    reaches this. ``at_done``: master ops may instead fire when the
    master's journal counts this many DONE tasks — the natural
    mid-job trigger for a control plane whose version clock idles in
    PS-pod mode. ``at_call``/``n_calls``: call-level ops apply to
    calls ``[at_call, at_call + n_calls)`` of the wrapped shard.
    ``delay_s``: sleep for ``delay`` ops.
    """

    __slots__ = ("kind", "shard", "at_version", "at_done", "at_call",
                 "n_calls", "delay_s")

    MASTER_KINDS = ("kill_master", "term_master")

    def __init__(self, kind, shard, at_version=None, at_call=None,
                 n_calls=1, delay_s=0.0, at_done=None):
        if kind not in (
            "kill", "term", "delay", "partition", "reject",
            "kill_master", "term_master",
        ):
            raise ValueError("unknown chaos op kind %r" % kind)
        self.kind = kind
        self.shard = int(shard)
        self.at_version = at_version
        self.at_done = at_done
        self.at_call = at_call
        self.n_calls = int(n_calls)
        self.delay_s = float(delay_s)

    def __repr__(self):
        return (
            "ChaosOp(%r, shard=%d, at_version=%r, at_done=%r, "
            "at_call=%r, n_calls=%d, delay_s=%g)"
            % (self.kind, self.shard, self.at_version, self.at_done,
               self.at_call, self.n_calls, self.delay_s)
        )


def seeded_schedule(seed, num_ps, kinds=("kill",), max_version=16,
                    n_ops=1):
    """A reproducible fleet schedule: ``n_ops`` ops drawn from
    ``kinds``, each targeting a seeded shard at a seeded version in
    ``[2, max_version]``. Same seed -> same schedule, forever."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        ops.append(
            ChaosOp(
                str(rng.choice(list(kinds))),
                int(rng.integers(num_ps)),
                at_version=int(rng.integers(2, max_version + 1)),
            )
        )
    return ops


class ScriptedFaultPS:
    """Deterministic in-process fault wrapper, with windowed and
    version-keyed faults.

    Call indices count EVERY forwarded method call of this shard, in
    arrival order; with the client's fan-out pool a test that needs
    exact windows drives the client single-threaded (fanout=False) or
    keys faults on ``at_version`` instead. ``kill`` ops raise
    :class:`ChaosPartitionError` from the first call AT/after the
    shard's reported version crossing ``at_version`` — permanently,
    until :meth:`revive` (the relaunch) is called.
    """

    def __init__(self, inner, ops=(), shard=0):
        self._inner = inner
        self._shard = shard
        self._ops = [op for op in ops if op.shard == shard]
        self._mu = threading.Lock()
        self._n_calls = 0
        self._killed = False
        # version-keyed kill/term ops fire ONCE: without the latch,
        # revive() would be re-killed immediately whenever the restored
        # incarnation's version is still >= at_version (a cadence
        # snapshot can publish exactly at the kill version)
        self._fired = set()  # id(op) of executed one-shot ops
        self.executed = []  # (op, call_index) log for asserts

    def revive(self, inner=None):
        """The relaunch: clear the kill latch (and optionally swap in
        the restored incarnation's servicer)."""
        with self._mu:
            self._killed = False
            if inner is not None:
                self._inner = inner

    @property
    def inner(self):
        return self._inner

    def _version(self):
        try:
            status = self._inner.ps_status({})
            return int(status.get("version", -1))
        except Exception:  # noqa: BLE001 — stub without ps_status
            return -1

    def _forward(self, method, req):
        if method == "ps_status":
            # the reconnect protocol probes ps_status after every
            # data-plane failure; letting probes consume call indices
            # (or trip windowed faults) would make the scripted windows
            # depend on how many probes the client happened to issue.
            # The kill latch still applies — a dead pod answers nothing.
            with self._mu:
                if self._killed:
                    raise ChaosPartitionError(
                        "shard %d is killed (chaos script)" % self._shard
                    )
            return self._inner.ps_status(req)
        with self._mu:
            n = self._n_calls
            self._n_calls += 1
            killed = self._killed
        if killed:
            raise ChaosPartitionError(
                "shard %d is killed (chaos script)" % self._shard
            )
        version = None
        reject_op = None
        for op in self._ops:
            in_call_window = (
                op.at_call is not None
                and op.at_call <= n < op.at_call + op.n_calls
            )
            if op.kind in ("kill", "term") and op.at_version is not None:
                if id(op) in self._fired:
                    continue
                if version is None:
                    version = self._version()
                if version >= op.at_version:
                    with self._mu:
                        self._killed = True
                        self._fired.add(id(op))
                    self.executed.append((op, n))
                    raise ChaosPartitionError(
                        "shard %d killed at version %d (chaos script %r)"
                        % (self._shard, version, op)
                    )
            elif op.kind == "partition" and in_call_window:
                self.executed.append((op, n))
                raise ChaosPartitionError(
                    "shard %d partitioned for call %d (chaos script %r)"
                    % (self._shard, n, op)
                )
            elif op.kind == "delay" and in_call_window:
                self.executed.append((op, n))
                time.sleep(op.delay_s)
            elif op.kind == "reject" and in_call_window:
                reject_op = op
        resp = getattr(self._inner, method)(req)
        if reject_op is not None and method == "push_gradient":
            self.executed.append((reject_op, n))
            resp = dict(resp)
            resp["accepted"] = False
        return resp

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(req):
            return self._forward(method, req)

        return call


class FleetChaos:
    """Executes a fleet-level schedule against live processes.

    ``manager``: anything with ``kill_ps(id)`` / ``terminate_ps(id)``
    (the LocalInstanceManager, or a harness's own process table behind
    a small adapter) — plus ``kill_master()`` / ``terminate_master()``
    when the schedule carries master ops. ``status_fn(shard) -> dict``
    reads a shard's ``ps_status`` (version + epoch);
    ``master_status_fn() -> dict`` reads the master's ``master_status``
    probe (version + journal counters) and is required only for master
    ops. The poller fires each op ONCE when its trigger first crosses —
    ``at_version`` against the target's reported version, ``at_done``
    (master ops) against the journal's cumulative done-task count —
    then logs it in :attr:`executed`. Deterministic given a
    deterministic trigger stream: the op fires at the first poll
    observing the crossing, and the trigger itself does not depend on
    wall clock.
    """

    _FLEET_KINDS = ("kill", "term", "kill_master", "term_master")

    def __init__(self, manager, status_fn, schedule, poll_s=0.1,
                 master_status_fn=None):
        self._manager = manager
        self._status_fn = status_fn
        self._master_status_fn = master_status_fn
        self._schedule = list(schedule)
        if master_status_fn is None and any(
            op.kind in ChaosOp.MASTER_KINDS for op in self._schedule
        ):
            # without the probe the trigger can never cross and the
            # poller would spin silently until the harness times out
            raise ValueError(
                "schedule contains master ops but no master_status_fn "
                "was provided (the at_done/at_version trigger polls "
                "the master_status probe)"
            )
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread = None
        self.executed = []  # (op, observed_trigger, unix_time)

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="edl-fleet-chaos", daemon=True
        )
        self._thread.start()
        return self

    def _probe(self, op):
        """(trigger_value, crossed) for ``op``, or None when the
        target's probe failed (poll again)."""
        if op.kind in ChaosOp.MASTER_KINDS:
            status = self._master_status_fn() or {}
            if op.at_done is not None:
                done = int(
                    (status.get("journal") or {}).get("done", -1)
                )
                return done, done >= op.at_done
            version = int(status.get("version", -1))
            return version, (
                op.at_version is not None and version >= op.at_version
            )
        status = self._status_fn(op.shard) or {}
        version = int(status.get("version", -1))
        return version, (
            op.at_version is not None and version >= op.at_version
        )

    def _execute(self, op):
        if op.kind == "kill":
            self._manager.kill_ps(op.shard)
        elif op.kind == "term":
            self._manager.terminate_ps(op.shard)
        elif op.kind == "kill_master":
            self._manager.kill_master()
        else:
            self._manager.terminate_master()
        # the kill is itself a job event: it lands in the harness
        # process's event log AND (chaos_kill/chaos_term are flight-
        # recorder trigger kinds) freezes a postmortem timeline of the
        # seconds before the kill — every chaos drill leaves a readable
        # record of its own fault injection
        profiling.events.emit(
            "chaos_kill" if "kill" in op.kind else "chaos_term",
            op=op.kind,
            shard=op.shard,
            target="master" if op.kind in ChaosOp.MASTER_KINDS else "ps",
        )

    def _run(self):
        pending = [
            op
            for op in self._schedule
            if op.kind in self._FLEET_KINDS
        ]
        while pending and not self._stop.is_set():
            for op in list(pending):
                try:
                    trigger, crossed = self._probe(op)
                except Exception:  # noqa: BLE001 — target busy/down
                    logger.debug(
                        "chaos: status probe for %r failed; polling "
                        "again",
                        op,
                        exc_info=True,
                    )
                    continue
                if crossed:
                    logger.warning(
                        "chaos: executing %r (observed trigger %d)",
                        op,
                        trigger,
                    )
                    self._execute(op)
                    self.executed.append((op, trigger, time.time()))
                    pending.remove(op)
            self._stop.wait(self._poll_s)

    def done(self):
        """True once every scheduled fleet op has executed."""
        return len(self.executed) == len(
            [
                op
                for op in self._schedule
                if op.kind in self._FLEET_KINDS
            ]
        )

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
