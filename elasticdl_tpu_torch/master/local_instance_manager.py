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

Not ported, each raising ``NotImplementedError``: supervising parameter
servers (``num_ps``, ``ps_command``) or the master itself
(``master_command``), and pre-warmed standby workers (``num_standby``).
"""

import signal
import subprocess
import threading
import time

from elasticdl_tpu_torch.common.constants import InstanceManagerStatus
from elasticdl_tpu_torch.common.log_utils import default_logger as logger

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL: a graceful drain


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
        next_worker_id. ``membership``: worker exits also go to the
        MembershipService, which fences unresponsive members through
        :meth:`kill_worker`. ``devices``: the device of each of the
        ``num_workers`` slots (``distributed.worker_devices``); a
        relaunched worker takes the slot, and so the card, of the one it
        replaces."""
        for asked, plane in (
            (num_ps or ps_command, "parameter-server supervision"),
            (master_command, "master supervision"),
            (num_standby, "standby workers"),
        ):
            if asked:
                raise NotImplementedError("%s is not ported yet" % plane)
        self._task_d = task_d
        self._membership = membership
        if membership is not None:
            membership.set_fencer(self.kill_worker)
        self._num_workers = num_workers
        self._worker_command = worker_command
        self._restart_policy = restart_policy
        self._max_relaunches = max_relaunches
        self._env = env
        self._devices = devices
        self._slot_of = {}  # live or starting worker id -> its slot
        self._lock = threading.Lock()
        self._procs = {}  # worker id -> Popen
        self.exit_codes = {}  # worker id -> last observed returncode
        self.spawned_at = {}  # worker id -> wall time of its start
        self._next_worker_id = 0
        self._relaunches = 0
        self._stopping = False
        self.status = InstanceManagerStatus.PENDING

    def _spawn(self, worker_id, slot):
        argv = self._worker_command(worker_id, self._devices[slot])
        proc = subprocess.Popen(argv, env=self._env)
        with self._lock:
            self._procs[worker_id] = proc
            self.spawned_at[worker_id] = time.time()
        threading.Thread(
            target=self._watch, args=(worker_id, proc), daemon=True
        ).start()
        return proc

    def start_workers(self):
        for _ in range(self._num_workers):
            self._start_worker()
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
        self._spawn(worker_id, slot)
        return worker_id

    # -- the elasticity loop ------------------------------------------------

    def _watch(self, worker_id, proc):
        returncode = proc.wait()
        with self._lock:
            self.exit_codes[worker_id] = returncode
            if self._procs.get(worker_id) is not proc or self._stopping:
                return
            del self._procs[worker_id]
            del self._slot_of[worker_id]
        # a dead worker's in-flight tasks go back on the todo queue
        self._task_d.recover_tasks(worker_id)
        if self._membership is not None:
            # the membership leaves an announced clean exit off the dead
            # list; any other exit wedges the survivors like a crash
            self._membership.remove(worker_id, exit_code=returncode)
        if returncode == 0:
            logger.info("Worker %d completed", worker_id)
            return
        if returncode == PREEMPTED_EXIT_CODE:
            # benign: a drain does not spend the crash-relaunch budget
            if self._restart_policy != "Never":
                new_id = self._start_worker()
                logger.info(
                    "Worker %d drained under a preemption notice; "
                    "relaunched as id %d",
                    worker_id,
                    new_id,
                )
            return
        logger.warning(
            "Worker %d exited with %d; recovering tasks",
            worker_id,
            returncode,
        )
        spend = False
        if self._restart_policy != "Never":
            # check and spend at once: two watchers racing here must not
            # both pass the budget check
            with self._lock:
                if self._relaunches < self._max_relaunches:
                    self._relaunches += 1
                    spend = True
        if spend:
            logger.info("Relaunched worker as id %d", self._start_worker())

    # -- control ------------------------------------------------------------

    def _proc(self, worker_id):
        with self._lock:
            return self._procs.get(worker_id)

    def kill_worker(self, worker_id):
        """Fault injection and fencing: SIGKILL one live worker."""
        proc = self._proc(worker_id)
        if proc is not None:
            try:
                proc.send_signal(signal.SIGKILL)
            except OSError:
                pass

    def terminate_worker(self, worker_id):
        """Deliver a preemption notice (SIGTERM): the elastic worker
        drains (checkpoint, announced leave, exit 75) and the watcher
        relaunches a replacement."""
        proc = self._proc(worker_id)
        if proc is not None:
            proc.terminate()

    def live_workers(self):
        with self._lock:
            return [w for w, p in self._procs.items() if p.poll() is None]

    def wait(self, timeout=None):
        """Block until every worker process has exited, relaunches
        included; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.live_workers():
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.1)
        return True

    def stop_relaunch_and_remove_all_pods(self, grace_s=10.0):
        """Stop relaunching and end every worker: SIGTERM, then SIGKILL
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
