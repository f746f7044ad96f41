"""Background-thread checkpoint writes, the counterpart of
``elasticdl_tpu/common/async_checkpoint.py``.

A save splits into two phases with very different costs:

1. device -> host snapshot: bounded by the copy over PCIe, and it must
   finish before the next step, because the optimizer updates the
   parameters and its state in place
   (``common/sharded_checkpoint.snapshot_leaves``);
2. disk IO: the slow part, with no dependency on device state.

:class:`AsyncCheckpointer` runs phase 2 on one worker thread: saves stay
ordered (version N reaches the disk before N+1, ring eviction is
serialized) and training blocks only for phase 1. An error of the worker
is kept and raised again on the training thread at the next
``submit``/``wait``, so a failing disk never fails silently.
"""

import queue
import threading

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


class AsyncCheckpointer:
    """Runs submitted IO jobs on one background thread, in order.

    ``max_pending`` bounds the queue: when the disk falls behind,
    ``submit`` blocks rather than piling up host snapshots (each queued
    job holds a full copy of the model in host memory)."""

    def __init__(self, max_pending=2, name="async-ckpt"):
        self._queue = queue.Queue(maxsize=max_pending)
        self._error = None
        self._error_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._closed = False
        self._thread.start()

    def _run(self):
        while True:
            job = self._queue.get()
            label = ""
            try:
                if job is None:
                    return
                fn, label = job
                fn()
            except Exception as e:  # noqa: BLE001 - relayed to the caller
                logger.error("async checkpoint %s failed: %s", label, e)
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                # drop the closure before blocking on the next get(): it
                # holds the snapshot, a full host copy of the model
                job = fn = None
                self._queue.task_done()

    def _raise_pending(self):
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, fn, label=""):
        """Queue ``fn`` (pure IO, no device access) for the worker thread.
        Raises the error of an earlier job first."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        self._queue.put((fn, label))

    def wait(self):
        """Block until every submitted job has finished; raise the first
        failure. Call before restoring from the same directory and at
        teardown."""
        self._queue.join()
        self._raise_pending()

    def close(self):
        """Drain the outstanding jobs and stop the worker thread."""
        if self._closed:
            return
        self._queue.join()
        self._closed = True
        self._queue.put(None)
        self._thread.join()
        self._raise_pending()
