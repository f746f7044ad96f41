"""Worker processes on this host, watched and relaunched: the counterpart
of ``elasticdl_tpu/master/local_instance_manager.py`` for the workers of
an elastic ALLREDUCE job.

Each worker is a new interpreter started with ``subprocess`` (exec,
never fork: every worker owns its CUDA context). A watcher thread per
process waits for its exit, hands its in-flight tasks back to the
dispatcher (``recover_tasks``), tells the membership (which bumps the
epoch so the survivors re-form), and relaunches a crashed worker under a
fresh, higher id while ``restart_policy`` allows and the budget of
``max_relaunches`` lasts. A drained worker (exit 75) is replaced without
spending that budget; a completed one (exit 0) is not replaced.

**Standby workers** (``num_standby``). Each is a worker process started
with ``--standby true``: it pays its cold start, then parks in the
membership's ``StandbyPool``. A worker's death promotes a parked one
instead of a cold relaunch: it gets the next worker id and the dead
slot's device, the membership defers the death's bump until it
registers, and a fresh standby refills the pool (on a refill budget of
its own). A death no parked standby can take is relaunched cold, and the
log says so.

**The external-supervisor form** (``master_command``): run outside the
master, the manager also owns the master process. A master that exits
75 (it drained its journal under SIGTERM) is relaunched without spending
the budget; a crash is relaunched on the budget, to replay its journal.
In this form ``task_d`` and ``membership`` may be None: the master's own
boot recovers its tasks.

**Parameter servers** (``num_ps`` with ``ps_command``): ``start_all_ps``
spawns shard ``i`` as ``ps_command(i)``. A shard that exits is relaunched
under the same id, so at the same address, where the workers dial it
again (the local form of the reference's relaunch with the same id and
service name): a drain (exit 75, its final snapshot written) spends no
budget, a crash spends the shared relaunch budget. ``kill_ps`` and
``terminate_ps`` inject the two faults.
"""

import signal
import subprocess
import threading
import time

from elasticdl_tpu_torch.common.constants import InstanceManagerStatus
from elasticdl_tpu_torch.common.log_utils import default_logger as logger

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL: a graceful drain
_MASTER = ("master", 0)


class LocalInstanceManager:
    def __init__(
        self,
        task_d,
        num_workers,
        worker_command,
        devices,
        num_ps=0,
        ps_command=None,
        restart_policy="Always",
        max_relaunches=3,
        env=None,
        membership=None,
        num_standby=0,
        master_command=None,
    ):
        """``worker_command(worker_id, device) -> argv``. Worker ids grow
        monotonically across relaunches, as the reference's
        next_worker_id; a standby's token comes from the same counter.
        ``membership``: worker exits also go to the MembershipService,
        which fences unresponsive members through :meth:`kill_worker`.
        ``devices``: the device of each of the ``num_workers`` slots
        (``distributed.worker_devices``); a relaunched or promoted worker
        takes the slot, and so the card, of the one it replaces.
        ``master_command() -> argv``: the external-supervisor form.
        ``ps_command(ps_id) -> argv``: a shard of the ``num_ps``."""
        if num_ps and ps_command is None:
            raise ValueError("num_ps shards need a ps_command")
        self._num_ps = num_ps
        self._ps_command = ps_command
        self._task_d = task_d
        self._membership = membership
        if membership is not None:
            membership.set_fencer(self.kill_worker)
        self._num_workers = num_workers
        self._worker_command = worker_command
        self._master_command = master_command
        self._restart_policy = restart_policy
        self._max_relaunches = max_relaunches
        self._env = env
        self._devices = devices
        # standbys park in the membership's pool: none without one
        self._num_standby = num_standby if membership is not None else 0
        self._standby_refill_budget = max_relaunches
        self._slot_of = {}  # live or starting worker id -> its slot
        self._lock = threading.Lock()
        self._procs = {}  # (kind, id) -> Popen
        self._rekeyed = {}  # id(proc) -> its key after a promotion
        self.exit_codes = {}  # worker id -> last observed returncode
        self.standby_exit_codes = {}  # standby token -> returncode
        self.master_exit_codes = []  # each master incarnation's exit
        self.ps_exit_codes = {}  # ps id -> its incarnations' exits
        self.ps_spawned_at = {}  # ps id -> its incarnations' start times
        self.spawned_at = {}  # worker id or standby token -> start time
        # (worker id, standby token, wall time) of each promotion
        self.promotions = []
        self.cold_relaunches = []  # (worker id, wall time)
        self.standby_tokens = []  # every standby started, in order
        self._next_worker_id = 0
        self._relaunches = 0
        self._stopping = False
        self.status = InstanceManagerStatus.PENDING

    def _spawn(self, key, argv):
        """Start ``argv`` as ``key``; None once the manager is stopping.
        The check and the start share one hold of the lock: a relaunch
        or a standby refill racing :meth:`stop_relaunch_and_remove_all_pods`
        either starts before the stop collects the processes, or not at
        all (a process started after it would outlive the job)."""
        with self._lock:
            if self._stopping:
                return None
            proc = subprocess.Popen(argv, env=self._env)
            self._procs[key] = proc
            if key[0] == "ps":
                self.ps_spawned_at.setdefault(key[1], []).append(time.time())
            elif key != _MASTER:
                self.spawned_at[key[1]] = time.time()
        threading.Thread(
            target=self._watch, args=(key, proc), daemon=True
        ).start()
        return proc

    def start_master(self):
        """Spawn the supervised master (the external-supervisor form)."""
        if self._master_command is None:
            raise ValueError(
                "no master_command: this manager supervises no master"
            )
        self._spawn(_MASTER, self._master_command())

    def start_all_ps(self):
        """Spawn every PS shard."""
        for ps_id in range(self._num_ps):
            self._spawn(("ps", ps_id), self._ps_command(ps_id))

    def start_workers(self):
        for _ in range(self._num_workers):
            self._start_worker()
        for _ in range(self._num_standby):
            self._start_standby()
        self.status = InstanceManagerStatus.RUNNING

    def _start_worker(self):
        with self._lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            # the lowest slot no live worker holds: a replacement starts
            # after the exit it replaces, so its card is free again
            held = set(self._slot_of.values())
            slot = min(set(range(len(self._devices))) - held)
            self._slot_of[worker_id] = slot
        self._spawn(("worker", worker_id),
                    self._worker_command(worker_id, self._devices[slot]))
        return worker_id

    def _standby_device(self):
        """A standby's device before its promotion: the slots' shared
        one, or the bare ``cuda`` where each slot has a card (the
        promotion then names the card)."""
        shared = set(self._devices)
        return self._devices[0] if len(shared) == 1 else "cuda"

    def _start_standby(self):
        with self._lock:
            if self._stopping:
                return None
            token = self._next_worker_id
            self._next_worker_id += 1
            self.standby_tokens.append(token)
        argv = list(
            self._worker_command(token, self._standby_device())
        ) + ["--standby", "true"]
        self._spawn(("standby", token), argv)
        return token

    def _promote_standby(self, slot):
        """Hand the next worker id and ``slot``'s device to a parked
        standby; the new id, or None when none is parked. The promoted
        process is re-keyed so that kill and terminate by worker id reach
        it, and a fresh standby refills the pool."""
        if self._membership is None or not self._num_standby:
            return None
        with self._lock:
            new_id = self._next_worker_id
            self._next_worker_id += 1
        token = self._membership.standby.activate(
            new_id, device=self._devices[slot]
        )
        if token is None:
            return None
        with self._lock:
            proc = self._procs.pop(("standby", token), None)
            if proc is None:
                # it died between activate and now: an assigned token
                # must not outlive its process
                self._membership.standby.forget(token)
                return None
            self._procs[("worker", new_id)] = proc
            self._rekeyed[id(proc)] = ("worker", new_id)
            self._slot_of[new_id] = slot
            self.promotions.append((new_id, token, time.time()))
        self._start_standby()
        return new_id

    def _replace(self, slot, why):
        """A warmed standby for the dead slot, else a cold relaunch (the
        log says which); the new worker id."""
        new_id = self._promote_standby(slot)
        if new_id is not None:
            logger.info("Promoted a warmed standby as worker %d (%s)",
                        new_id, why)
            return new_id
        if self._num_standby:
            logger.warning(
                "no warmed standby to promote (%s): relaunching cold", why
            )
        new_id = self._start_worker()
        with self._lock:
            self.cold_relaunches.append((new_id, time.time()))
        logger.info("Relaunched worker as id %d (%s)", new_id, why)
        return new_id

    # -- the elasticity loop ------------------------------------------------

    def _watch(self, key, proc):
        returncode = proc.wait()
        with self._lock:
            key = self._rekeyed.pop(id(proc), key)
            kind, instance_id = key
            if kind == "worker":
                self.exit_codes[instance_id] = returncode
            elif kind == "standby":
                self.standby_exit_codes[instance_id] = returncode
            elif kind == "ps":
                self.ps_exit_codes.setdefault(instance_id, []).append(
                    returncode
                )
            else:
                self.master_exit_codes.append(returncode)
            if self._procs.get(key) is not proc or self._stopping:
                return
            del self._procs[key]
            slot = self._slot_of.pop(instance_id, None) \
                if kind == "worker" else None
        if kind == "standby":
            self._standby_exited(instance_id)
        elif kind == "worker":
            self._worker_exited(instance_id, slot, returncode)
        elif kind == "ps":
            self._ps_exited(instance_id, returncode)
        else:
            self._master_exited(returncode)

    def _standby_exited(self, token):
        """A spare died before its promotion: forget its token and refill
        on the standbys' own budget (a spare that always crashes must not
        fork-loop the host, nor spend the workers' budget)."""
        self._membership.standby.forget(token)
        with self._lock:
            refill = not self._stopping and self._standby_refill_budget > 0
            if refill:
                self._standby_refill_budget -= 1
        if refill:
            self._start_standby()
        else:
            logger.warning("standby %d died; the pool is not refilled",
                           token)

    def _worker_exited(self, worker_id, slot, returncode):
        if self._task_d is not None:
            # a dead worker's in-flight tasks go back on the todo queue
            self._task_d.recover_tasks(worker_id)
        if self._membership is not None:
            from elasticdl_tpu_torch.master.membership_service import (
                DEATH_BUMP_DEFER_SECS,
            )

            with self._lock:
                budget_left = self._relaunches < self._max_relaunches
            # a warmed standby will be promoted: the survivors re-form
            # once, with it, instead of shrinking and growing again
            will_promote = (
                returncode != 0
                and self._restart_policy != "Never"
                and self._membership.standby.parked_count() > 0
                and (returncode == PREEMPTED_EXIT_CODE or budget_left)
            )
            # the membership leaves an announced clean exit off the dead
            # list; any other exit wedges the survivors like a crash
            self._membership.remove(
                worker_id,
                defer_bump_secs=DEATH_BUMP_DEFER_SECS if will_promote else 0,
                exit_code=returncode,
            )
        if returncode == 0:
            logger.info("Worker %d completed", worker_id)
            return
        if returncode == PREEMPTED_EXIT_CODE:
            # benign: a drain does not spend the crash-relaunch budget
            if self._restart_policy != "Never":
                self._replace(slot, "worker %d drained" % worker_id)
            return
        logger.warning("Worker %d exited with %d; recovering tasks",
                       worker_id, returncode)
        spend = False
        if self._restart_policy != "Never":
            # check and spend at once: two watchers racing here must not
            # both pass the budget check
            with self._lock:
                if self._relaunches < self._max_relaunches:
                    self._relaunches += 1
                    spend = True
        if spend:
            self._replace(slot, "worker %d exited %d"
                          % (worker_id, returncode))

    def _ps_exited(self, ps_id, returncode):
        """Relaunch the shard under its id: a drain (75) on no budget, a
        crash on the shared budget; none under ``Never``."""
        with self._lock:
            relaunch = not self._stopping and self._restart_policy != "Never"
            if relaunch and returncode != PREEMPTED_EXIT_CODE:
                relaunch = self._relaunches < self._max_relaunches
                if relaunch:
                    self._relaunches += 1
        if relaunch:
            logger.warning("PS %d exited with %d; relaunching the same id",
                           ps_id, returncode)
            self._spawn(("ps", ps_id), self._ps_command(ps_id))
        else:
            logger.error("PS %d exited with %d and is not relaunched",
                         ps_id, returncode)

    def _master_exited(self, returncode):
        if returncode == 0:
            logger.info("Master completed (the job finished)")
            return
        with self._lock:
            relaunch = not self._stopping and self._restart_policy != "Never"
            if relaunch and returncode != PREEMPTED_EXIT_CODE:
                # a crash spends the budget; a drain (75) does not
                relaunch = self._relaunches < self._max_relaunches
                if relaunch:
                    self._relaunches += 1
        if relaunch:
            logger.warning("Master exited with %d; relaunching it to "
                           "replay its journal", returncode)
            self._spawn(_MASTER, self._master_command())
        else:
            logger.error("Master exited with %d and is not relaunched "
                         "(budget spent, stopping, or policy Never)",
                         returncode)

    # -- control ------------------------------------------------------------

    def _proc(self, key):
        with self._lock:
            return self._procs.get(key)

    def _signal(self, key, sig):
        proc = self._proc(key)
        if proc is not None:
            try:
                proc.send_signal(sig)
            except OSError:
                pass

    def kill_worker(self, worker_id):
        """Fault injection and fencing: SIGKILL one live worker."""
        self._signal(("worker", worker_id), signal.SIGKILL)

    def terminate_worker(self, worker_id):
        """Deliver a preemption notice (SIGTERM): the elastic worker
        drains (checkpoint, announced leave, exit 75) and the watcher
        replaces it."""
        self._signal(("worker", worker_id), signal.SIGTERM)

    def kill_ps(self, ps_id):
        """Fault injection: SIGKILL one shard. No drain snapshot runs: the
        relaunch restores the last cadence snapshot, or boots empty."""
        self._signal(("ps", ps_id), signal.SIGKILL)

    def terminate_ps(self, ps_id):
        """SIGTERM one shard: it writes a final snapshot and exits 75,
        and is relaunched without spending the budget."""
        self._signal(("ps", ps_id), signal.SIGTERM)

    def live_ps(self):
        with self._lock:
            return [k[1] for k, p in self._procs.items()
                    if k[0] == "ps" and p.poll() is None]

    def kill_master(self):
        """Fault injection: SIGKILL the supervised master. No journal
        drain runs; the relaunch replays what the fsync cadence made
        durable."""
        self._signal(_MASTER, signal.SIGKILL)

    def terminate_master(self):
        """SIGTERM the supervised master: it drains its journal and exits
        75, and is relaunched without spending the budget."""
        self._signal(_MASTER, signal.SIGTERM)

    def live_master(self):
        proc = self._proc(_MASTER)
        return proc is not None and proc.poll() is None

    def live_workers(self):
        with self._lock:
            return [k[1] for k, p in self._procs.items()
                    if k[0] == "worker" and p.poll() is None]

    def wait(self, timeout=None):
        """Block until every worker process has exited, relaunches
        included (parked standbys and the master aside); False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.live_workers():
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.1)
        return True

    def stop_relaunch_and_remove_all_pods(self, grace_s=10.0):
        """Stop relaunching and end every process: SIGTERM, then SIGKILL
        for one still alive ``grace_s`` later."""
        with self._lock:
            self._stopping = True
            procs = list(self._procs.values())
            self._procs.clear()
        self.status = InstanceManagerStatus.FINISHED
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
