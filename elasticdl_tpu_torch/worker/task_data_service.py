"""Turns the master's task queue into one continuous record stream, the
counterpart of ``elasticdl_tpu/worker/task_data_service.py``.

The worker sees one iterable of records, while underneath this service
pulls shard tasks from the master on demand, remembers in an in-flight
ledger which tasks the consumed records belong to, and acknowledges each
task once the worker has consumed its record range
(``report_record_done``). A failed step charges the rest of the head
task (``remaining_records_in_head_task``) so that exactly that task
fail-reports and is queued again. Control tasks are handled inline: a
WAIT ends the current stream so the worker polls again, and a SAVE_MODEL
task is parked for the export path. An evaluation task is read on its own
(``get_validation_dataset``), outside the training stream.

- ``task_prefetch=N`` runs a background fetcher that keeps up to N
  tasks fetched ahead of the one being consumed, their first records
  read on a small pool; an abandoned round hands every fetched task back
  exactly once.
- ``ack_queue_size=M`` queues success acks, drained at task boundaries
  (``drain_acks``) or on overflow; a failure ack flushes at once.
"""

import concurrent.futures
import itertools
import queue
import threading
import time
from collections import deque

from elasticdl_tpu_torch.common.constants import TaskExecCounterKey, TaskType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.data.data_reader import create_data_reader
from elasticdl_tpu_torch.data.dataset import Dataset, create_dataset_from_tasks
from elasticdl_tpu_torch.data.input_stats import InputPlaneStats
from elasticdl_tpu_torch.utils import profiling

_ABANDON_MSG = "round abandoned (spare park)"
_SENTINEL = object()


def _task_span(task):
    """Number of records a shard task covers."""
    return task.end - task.start


class _TaskFetcher:
    """Background task prefetcher for one stream round: a fetch thread
    pulls tasks in order onto an unbounded queue (depth is a semaphore
    the consumer releases as it pops, so puts never block), and a warm
    pool reads each fetched task's first records. ``shutdown`` cancels
    the loop and hands every unconsumed task back exactly once."""

    def __init__(self, service, gen_id, depth):
        self._service = service
        self._gen_id = gen_id
        self._q = queue.Queue()
        self._slots = threading.Semaphore(max(1, depth))
        self._cancel = threading.Event()
        # serializes puts against shutdown's cancel and drain
        self._offer_lock = threading.Lock()
        self._warm_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, depth) + 1,
            thread_name_prefix="edl-task-warm",
        )
        self._thread = threading.Thread(
            target=self._fetch_loop,
            daemon=True,
            name="edl-task-fetcher",
        )

    def start(self):
        self._thread.start()

    def _offer(self, item):
        with self._offer_lock:
            if self._cancel.is_set():
                return False
            self._q.put(item)
            return True

    def _fetch_loop(self):
        service = self._service
        try:
            while not self._cancel.is_set():
                if not self._slots.acquire(timeout=0.2):
                    continue
                with service._ledger_lock:
                    task = service._primed_task
                    service._primed_task = None
                if task is None:
                    task = service._worker.get_task()
                with service._ledger_lock:
                    stale = service._round_id != self._gen_id
                if stale or self._cancel.is_set():
                    self._hand_back(task)
                    return
                records = None
                if task.shard_name and task.type != TaskType.SAVE_MODEL:
                    try:
                        records = self._warm_pool.submit(
                            service._warm_records, task
                        )
                    except RuntimeError:
                        # shutdown closed the pool: the round is abandoned
                        self._hand_back(task)
                        return
                if not self._offer((task, records)):
                    self._hand_back(task)
                    return
                if not task.shard_name:
                    return  # WAIT or exhausted ends the round's fetching
                service.fetched_ahead += 1
        except BaseException as e:  # propagate into the consumer
            self._offer(e)

    def _hand_back(self, task):
        if task is not None and task.shard_name:
            self._service._worker.report_task_result(
                task.task_id, _ABANDON_MSG
            )

    def next_item(self):
        """The next fetched (task, records) in fetch order; None once the
        round is shut down. Re-raises a fetcher-side exception."""
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._cancel.is_set():
                    return None
                continue
            if isinstance(item, BaseException):
                raise item
            self._slots.release()
            task, warm = item
            if warm is None:
                return task, None
            try:
                records = warm.result()
            except concurrent.futures.CancelledError:
                self._hand_back(task)
                return None
            except BaseException:
                # popped but never in the ledger: hand it back here
                self._service._worker.report_task_result(
                    task.task_id, "prefetch read failed"
                )
                raise
            return task, records

    def shutdown(self):
        """Cancel the fetch loop and hand back every queued task
        (idempotent)."""
        with self._offer_lock:
            self._cancel.set()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, BaseException):
                continue
            task, _ = item
            self._hand_back(task)
        self._warm_pool.shutdown(wait=False, cancel_futures=True)


class TaskDataService:
    """One worker's bridge between master tasks and its input stream.

    ``worker`` exposes ``get_task()`` and ``report_task_result(task_id,
    err_msg, exec_counters=)``."""

    def __init__(
        self,
        worker,
        training_with_evaluation,
        data_reader_params=None,
        task_prefetch=0,
        ack_queue_size=0,
        prefetch_warm_records=32,
        data_reader=None,
        stats=None,
    ):
        self._worker = worker
        self._training_with_evaluation = training_with_evaluation
        self._ledger_lock = threading.Lock()
        self._stream_open = True  # may get_dataset() hand out a new stream?
        self._parked_export_task = None
        self._clear_ledger()
        if data_reader is not None:
            self.data_reader = data_reader
        else:
            reader_kwargs = dict(data_reader_params or {})
            self.data_reader = create_data_reader(
                data_origin=reader_kwargs.pop("data_origin", None),
                **reader_kwargs,
            )
        # the first task is peeked once to prime the reader's metadata,
        # then replayed into the stream so no records are lost
        self._primed_task = None
        self._metadata_primed = False
        # bumped (under the ledger lock) whenever an open round is
        # abandoned; stale producers notice and step aside
        self._round_id = 0
        self._task_prefetch = max(0, int(task_prefetch))
        self._prefetch_warm_records = max(0, int(prefetch_warm_records))
        self._fetcher = None
        self.fetched_ahead = 0  # tasks the background fetcher fetched
        self._ack_queue_size = max(0, int(ack_queue_size))
        self._ack_queue = deque()
        self._ack_lock = threading.Lock()
        self._ack_flush_needed = False
        self.stats = stats if stats is not None else InputPlaneStats()

    # ------------------------------------------------------------------
    # in-flight ledger
    # ------------------------------------------------------------------

    def _clear_ledger(self):
        self._inflight = deque()  # tasks whose records are being consumed
        self._record_cursor = 0  # records consumed against head of ledger
        self._bad_records = 0  # failed records charged to the head task

    def get_current_task(self):
        """The ledger's head task: the one the next record belongs to."""
        return self._inflight[0] if self._inflight else None

    def remaining_records_in_head_task(self):
        """Unconsumed record count of the ledger's head task (0 if empty):
        what a failed step charges so that exactly that task fail-reports."""
        with self._ledger_lock:
            if not self._inflight:
                return 0
            return max(0, _task_span(self._inflight[0]) - self._record_cursor)

    def _acknowledge(self, task, err_msg, outbox):
        """Queue one finished task's ack (ledger lock held; never sends
        from here)."""
        counters = (
            {TaskExecCounterKey.FAIL_COUNT: self._bad_records}
            if self._bad_records
            else None
        )
        t0 = getattr(task, "_edl_consume_t0", None)
        if t0 is not None:
            counters = dict(counters or {})
            counters["consume_s"] = round(time.perf_counter() - t0, 6)
        trace = (getattr(task, "extended_config", None) or {}).get(
            "trace_id"
        )
        if trace is not None:
            counters = dict(counters or {})
            counters[TaskExecCounterKey.TRACE_ID] = trace
            counters[TaskExecCounterKey.ATTEMPT] = task.extended_config.get(
                "_attempt", 0
            )
        if err_msg:
            logger.warning(
                "task %d finished with %d/%d bad records; last error: %s",
                task.task_id,
                self._bad_records,
                _task_span(task),
                err_msg,
            )
        self._bad_records = 0
        if self._ack_queue_size:
            with self._ack_lock:
                self._ack_queue.append((task.task_id, err_msg, counters))
            if err_msg:
                self._ack_flush_needed = True
            return
        outbox.append((task.task_id, err_msg, counters))

    def _send_ack(self, task_id, err_msg, counters):
        with profiling.span(
            "task/ack",
            trace_id=(counters or {}).get(TaskExecCounterKey.TRACE_ID),
        ), self.stats.timed("ack_s"):
            self._worker.report_task_result(
                task_id, err_msg, exec_counters=counters
            )

    def drain_acks(self):
        """Send every queued ack to the master, in order."""
        while True:
            with self._ack_lock:
                if not self._ack_queue:
                    return
                ack = self._ack_queue.popleft()
            self._send_ack(*ack)

    def _drain_acknowledged(self, err_msg, outbox):
        """Pop every ledger task the cursor has moved past (one batch can
        complete several small tasks); a failure tally rides out with the
        first task drained."""
        while self._inflight and self._record_cursor >= _task_span(
            self._inflight[0]
        ):
            done = self._inflight.popleft()
            self._record_cursor -= _task_span(done)
            self._acknowledge(done, err_msg, outbox)

    def report_record_done(self, count, err_msg=""):
        """Advance the cursor by ``count`` consumed records."""
        outbox = []
        with self._ledger_lock:
            self._record_cursor += count
            if err_msg:
                self._bad_records += count
            self._drain_acknowledged(err_msg, outbox)
        # acks go out after the ledger lock is released
        for ack in outbox:
            self._send_ack(*ack)
        if self._ack_queue_size:
            flush = self._ack_flush_needed
            self._ack_flush_needed = False
            with self._ack_lock:
                overflow = len(self._ack_queue) > self._ack_queue_size
            if overflow or flush:
                self.drain_acks()

    def requeue_inflight(self, err_msg):
        """Fail-report every in-flight (and primed) task so the master
        queues them again, and abandon the open round so the next
        ``get_dataset`` starts clean."""
        with self._ledger_lock:
            self._round_id += 1
            inflight = list(self._inflight)
            self._clear_ledger()
            if self._primed_task is not None:
                inflight.append(self._primed_task)
                self._primed_task = None
            fetcher, self._fetcher = self._fetcher, None
        self.drain_acks()
        if fetcher is not None:
            fetcher.shutdown()
        for task in inflight:
            self._worker.report_task_result(task.task_id, err_msg)
        self._stream_open = True

    # ------------------------------------------------------------------
    # dataset construction
    # ------------------------------------------------------------------

    def get_validation_dataset(self, eval_task):
        """(dataset, model_version, task_id) for one evaluation task, or
        None."""
        if not eval_task:
            return None
        return (
            create_dataset_from_tasks([eval_task], self.data_reader),
            eval_task.model_version,
            eval_task.task_id,
        )

    def get_save_model_task_and_dataset(self):
        task, self._parked_export_task = self._parked_export_task, None
        if task is None:
            return None, None
        return task, create_dataset_from_tasks([task], self.data_reader)

    def _prime_reader_metadata(self):
        """Peek the first task (one record) so the reader can expose its
        metadata; the task is replayed by the stream."""
        if self._metadata_primed:
            return
        task = self._worker.get_task()
        if task.shard_name:
            with self._ledger_lock:
                self._primed_task = task
            for _ in self.data_reader.read_records(task):
                break
        self._metadata_primed = True

    def get_dataset(self):
        """A Dataset spanning every task the master will hand out, or
        None."""
        if not self._stream_open:
            return None
        self.drain_acks()
        with self._ledger_lock:
            if self._inflight:
                logger.error(
                    "refusing a new dataset: %d in-flight tasks are still "
                    "unacknowledged",
                    len(self._inflight),
                )
                return None
            self._clear_ledger()
        self._prime_reader_metadata()
        self._stream_open = False
        return Dataset.from_generator(self._record_stream, stats=self.stats)

    def _warm_records(self, task, warm=None):
        """A record iterator for ``task`` with its first ``warm`` records
        already read (on the calling, fetcher, thread)."""
        if warm is None:
            warm = self._prefetch_warm_records
        it = iter(self.data_reader.read_records(task))
        head = []
        # the dispatcher's trace id labels the warm read, so a timeline
        # joins it to the same task's train span on the consumer thread
        trace_id = (getattr(task, "extended_config", None) or {}).get(
            "trace_id", "untraced"
        )
        with profiling.annotate(
            "edl/task/%s/warm" % trace_id
        ), profiling.span(
            "task/warm", trace_id=trace_id, records=warm
        ), self.stats.timed("read_s"):
            for _ in range(max(0, warm)):
                rec = next(it, _SENTINEL)
                if rec is _SENTINEL:
                    return iter(head)
                head.append(rec)
        return itertools.chain(head, it)

    def _append_to_ledger(self, task, gen_id):
        """Append ``task`` to the ledger; False (the task handed back) if
        the round went stale, checked under the same hold."""
        with self._ledger_lock:
            stale = self._round_id != gen_id
            if not stale:
                task._edl_consume_t0 = time.perf_counter()
                self._inflight.append(task)
        if stale:
            self._worker.report_task_result(task.task_id, _ABANDON_MSG)
        return not stale

    def _yield_records(self, records):
        """Yield a task's records, charging reader time (accumulated
        locally, added once per task) to ``read_s``."""
        stats = self.stats
        it = iter(records)
        read_s = 0.0
        n = 0
        perf = time.perf_counter
        try:
            while True:
                t0 = perf()
                record = next(it, _SENTINEL)
                read_s += perf() - t0
                if record is _SENTINEL:
                    return
                if record is not None:
                    n += 1
                    yield record
        finally:
            stats.add("read_s", read_s)
            stats.count("records", n)

    def _handle_control_task(self, task):
        """WAIT pauses the stream (the worker polls again), exhaustion
        ends it."""
        if task.type == TaskType.WAIT:
            self._stream_open = True
            logger.info("record stream paused (WAIT); will re-poll")
        else:
            logger.info("task queue exhausted; record stream ends")

    def _record_stream(self):
        """Generator: pull tasks until the master says stop, yield
        records."""
        gen_id = self._round_id
        if self._task_prefetch > 0:
            yield from self._record_stream_prefetched(gen_id)
            return
        while True:
            with self._ledger_lock:
                task, self._primed_task = self._primed_task, None
            if task is None:
                with profiling.span("task/wait"), self.stats.timed(
                    "task_starved_s"
                ):
                    task = self._worker.get_task()
            if self._round_id != gen_id:
                if task.shard_name:
                    self._worker.report_task_result(
                        task.task_id, _ABANDON_MSG
                    )
                return
            if not task.shard_name:
                self._handle_control_task(task)
                return
            if task.type == TaskType.SAVE_MODEL:
                self._parked_export_task = task
                continue
            if not self._append_to_ledger(task, gen_id):
                return
            self.stats.count("tasks")
            yield from self._yield_records(
                self.data_reader.read_records(task)
            )

    def _record_stream_prefetched(self, gen_id):
        """The ``task_prefetch`` consumer: the same consuming semantics as
        the serial path, over tasks from the background fetcher."""
        fetcher = _TaskFetcher(self, gen_id, self._task_prefetch)
        with self._ledger_lock:
            if self._round_id != gen_id:
                return
            self._fetcher = fetcher
        fetcher.start()
        try:
            while True:
                with profiling.span("task/wait"), self.stats.timed(
                    "task_starved_s"
                ):
                    item = fetcher.next_item()
                if item is None:
                    return
                task, records = item
                if not task.shard_name:
                    self._handle_control_task(task)
                    return
                if task.type == TaskType.SAVE_MODEL:
                    self._parked_export_task = task
                    continue
                if not self._append_to_ledger(task, gen_id):
                    return
                self.stats.count("tasks")
                yield from self._yield_records(records)
        finally:
            with self._ledger_lock:
                if self._fetcher is fetcher:
                    self._fetcher = None
            fetcher.shutdown()
