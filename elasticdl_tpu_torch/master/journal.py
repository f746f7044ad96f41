"""The master's dispatch journal and its boot-time replay, the counterpart
of ``elasticdl_tpu/master/journal.py``.

Without it the master is the one process whose death ends the job: its
task ledger (which record ranges trained, which were in flight), the
model-version clock and the membership epoch die with it. The journal is
the durable half of the master's recovery; the worker half is the
failover channel (``rpc/failover.py``) under ``MasterClient``.

- **Write-ahead, off the hot path.** :meth:`MasterJournal.append` only
  enqueues under a small lock; a writer thread drains the buffer on a
  batched fsync cadence (``fsync_interval_s``), so the dispatcher's
  ledger lock is never held across a disk write. Lock order: dispatcher
  lock -> journal ``_mu``; the file IO runs under ``_io`` alone, and
  ``_io`` is always taken before ``_mu``.
- **Atomic segment rotation.** Past ``segment_records`` records the
  writer folds the replay state into a fresh ``state`` record, writes it
  to a ``tmp-`` file, fsyncs, and renames it to the next
  ``seg-%08d.jsonl``. Older segments are unlinked only after the rename;
  a crash mid-rotation leaves a temp file (ignored) or the old chain.
- **Newest-valid replay.** A boot walks the segments newest first for
  one that opens with a ``state`` record, then applies everything from
  there on. A torn final line (the batch a crash caught mid-write) is
  dropped with a warning. Replay is a pure fold: replaying one chain
  twice gives equal :class:`RecoveryState`s.
- **Epochs.** Every boot mints a ``master_epoch`` (a counter persisted
  in the journal directory) that every master reply carries, so the
  workers see the restart.

Record kinds (one JSON object a line, kind in ``k``)::

    state     segment-opening compaction of everything below
    epoch     a training epoch began (epoch)
    dispatch  task handed to a worker (task, trace, attempt, key, xc)
    done      task completed (trace, attempt, key)
    requeue   task queued again: a worker failure or boot-time recovery
    dup       a replayed ack deduped against an already-done trace
    version   model-version advance (version)
    member    membership change (event, worker, epoch)

``key`` names a task by what it covers, ``[type, epoch, shard_name,
start, end]``, not by its per-boot ``task_id``: a relaunched master with
the same arguments regenerates the same key space. ``trace`` is the
task's trace id, kept across requeues and across boots, and so the dedup
key of an ack replayed against the new incarnation.

The records, their fields and the segment files are the reference's, so
either package replays the other's journal directory.
"""

import glob
import json
import os
import threading
import time

from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling

_SEG_PREFIX = "seg-"
_TMP_PREFIX = "tmp-"
_FORMAT_VERSION = 1


def mint_master_epoch(journal_dir=None):
    """A fresh boot id for this master incarnation, strictly different
    from every earlier one: with a journal directory, a persisted
    counter (read, +1, atomic rewrite of ``epoch.json``, the reference's
    ``ps.snapshot.mint_shard_epoch``) so ids stay small and monotonic
    across relaunches; without one, a time-derived id."""
    if not journal_dir:
        return int(time.time_ns() % (1 << 53)) or 1
    os.makedirs(journal_dir, exist_ok=True)
    path = os.path.join(journal_dir, "epoch.json")
    prev = 0
    try:
        with open(path) as f:
            prev = int(json.load(f).get("epoch", 0))
    except (OSError, ValueError):
        prev = 0
    epoch = prev + 1
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": epoch}, f)
    os.replace(tmp, path)
    return epoch


def task_key(task_type, epoch, shard_name, start, end):
    """The boot-stable identity of one task (see the module docstring)."""
    return (int(task_type), int(epoch), str(shard_name), int(start),
            int(end))


class RecoveryState:
    """The fold of one journal chain: what the next boot restores.

    ``done_keys``: keys completed in the epoch in progress (earlier
    training epochs completed wholesale; their keys are dropped at each
    ``epoch`` record). ``pending``: trace -> {attempt, key, xc} of tasks
    dispatched and not done, which the boot requeues exactly once.
    ``done_traces``: trace -> (type, key epoch), the dedup set of
    replayed acks, pruned at each rollover like ``done_keys``.
    """

    def __init__(self):
        self.epoch = 0
        self.version = 0
        self.trace_seq = 0
        self.task_seq = 0  # the highest task id any incarnation minted
        self.member_epoch = 0
        self.done_keys = set()
        self.done_traces = {}
        self.pending = {}
        self.counters = {
            "dispatched": 0,
            "done": 0,
            "requeued": 0,
            "deduped": 0,
        }

    def apply(self, rec):
        kind = rec.get("k")
        if kind == "state":
            self._load(rec)
        elif kind == "epoch":
            e = int(rec.get("epoch", 0))
            if e > self.epoch:
                self.epoch = e
                # done keys of completed earlier training epochs can
                # never regenerate; pending entries survive (an earlier
                # epoch's straggler still requeues at recovery)
                train = int(TaskType.TRAINING)
                self.done_keys = {
                    key
                    for key in self.done_keys
                    if key[0] != train or key[1] >= e
                }
                self.done_traces = {
                    t: te
                    for t, te in self.done_traces.items()
                    if te[0] != train or te[1] >= e
                }
        elif kind == "dispatch":
            trace = rec["trace"]
            self._note_trace(trace)
            try:
                self.task_seq = max(self.task_seq, int(rec.get("task", 0)))
            except (TypeError, ValueError):
                pass
            if trace not in self.done_traces:
                self.pending[trace] = {
                    "attempt": int(rec.get("attempt", 0)),
                    "key": tuple(rec["key"]),
                    "xc": rec.get("xc"),
                }
            self.counters["dispatched"] += 1
        elif kind == "done":
            trace = rec["trace"]
            self._note_trace(trace)
            if trace not in self.done_traces:
                key = tuple(rec["key"])
                self.done_traces[trace] = (key[0], key[1])
                self.done_keys.add(key)
                self.pending.pop(trace, None)
                self.counters["done"] += 1
        elif kind == "requeue":
            trace = rec["trace"]
            self._note_trace(trace)
            if trace in self.pending:
                self.pending[trace]["attempt"] = int(
                    rec.get("attempt", self.pending[trace]["attempt"])
                )
            self.counters["requeued"] += 1
        elif kind == "dup":
            self.counters["deduped"] += 1
        elif kind == "version":
            self.version = max(self.version, int(rec.get("version", 0)))
        elif kind == "member":
            self.member_epoch = max(
                self.member_epoch, int(rec.get("epoch", 0))
            )
        # unknown kinds are skipped: a newer writer's informational
        # records must not wedge an older reader's replay

    def _note_trace(self, trace):
        try:
            self.trace_seq = max(self.trace_seq, int(str(trace)[1:]))
        except (TypeError, ValueError):
            pass

    def to_record(self):
        return {
            "k": "state",
            "format": _FORMAT_VERSION,
            "epoch": self.epoch,
            "version": self.version,
            "trace_seq": self.trace_seq,
            "task_seq": self.task_seq,
            "member_epoch": self.member_epoch,
            "counters": dict(self.counters),
            "done_traces": sorted(
                [t, te[0], te[1]] for t, te in self.done_traces.items()
            ),
            "done_keys": sorted(list(k) for k in self.done_keys),
            "pending": [
                [trace, p["attempt"], list(p["key"]), p["xc"]]
                for trace, p in sorted(self.pending.items())
            ],
            "wrote_unix": round(time.time(), 3),
        }

    def _load(self, rec):
        self.epoch = int(rec.get("epoch", 0))
        self.version = int(rec.get("version", 0))
        self.trace_seq = int(rec.get("trace_seq", 0))
        self.task_seq = int(rec.get("task_seq", 0))
        self.member_epoch = int(rec.get("member_epoch", 0))
        self.counters.update(rec.get("counters") or {})
        self.done_traces = {
            t: (ty, ep) for t, ty, ep in rec.get("done_traces") or []
        }
        self.done_keys = {
            tuple(key) for key in rec.get("done_keys") or []
        }
        self.pending = {
            trace: {"attempt": int(a), "key": tuple(key), "xc": xc}
            for trace, a, key, xc in rec.get("pending") or []
        }


def _segment_indices(journal_dir):
    out = []
    for path in glob.glob(
        os.path.join(journal_dir, _SEG_PREFIX + "*.jsonl")
    ):
        stem = os.path.basename(path)[len(_SEG_PREFIX):-len(".jsonl")]
        try:
            out.append(int(stem))
        except ValueError:
            continue
    return sorted(out)


def _seg_path(journal_dir, idx):
    return os.path.join(journal_dir, "%s%08d.jsonl" % (_SEG_PREFIX, idx))


class MasterJournal:
    """Write-ahead journal of one master's dispatch state.

    Lifecycle: construct -> :meth:`replay` (a read-only fold of the chain
    on disk) -> the dispatcher applies the recovery -> :meth:`start`
    (opens a fresh segment headed by the post-recovery compaction, so
    the boot is itself a compaction point, and starts the writer).
    ``append`` before ``start`` only folds into the state in memory,
    which the boot segment's head record carries.
    """

    def __init__(self, journal_dir, fsync_interval_s=0.05,
                 segment_records=4096):
        self._dir = journal_dir
        os.makedirs(journal_dir, exist_ok=True)
        self._fsync_interval = max(0.001, float(fsync_interval_s))
        self._segment_records = max(16, int(segment_records))
        self._mu = threading.Lock()  # buffer, state and counters
        self._io = threading.Lock()  # file handle and fsync
        self._buf = []
        self._state = RecoveryState()
        self._records_in_segment = 0
        self._seg_idx = 0
        self._file = None
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._thread = None
        self._append_seq = 0  # appends accepted
        self._flushed_seq = 0  # appends fsynced
        # what the last replay read: records applied, and its seconds
        self.replayed_records = 0
        self.replay_seconds = 0.0

    @property
    def directory(self):
        return self._dir

    # -- replay (at boot, before serving) ------------------------------------

    def replay(self):
        """Fold the chain on disk into a :class:`RecoveryState`, from the
        newest segment that opens with a ``state`` record (the oldest
        segment when none does). A torn final line is dropped with a
        warning; a torn line anywhere else ends the fold there. The
        journal adopts the state, so the next compaction includes it."""
        t0 = time.perf_counter()
        indices = _segment_indices(self._dir)
        start_at = 0
        for pos in range(len(indices) - 1, -1, -1):
            head = self._read_head(_seg_path(self._dir, indices[pos]))
            if head is not None and head.get("k") == "state":
                start_at = pos
                break
        state = RecoveryState()
        applied = 0
        for pos in range(start_at, len(indices)):
            path = _seg_path(self._dir, indices[pos])
            last_segment = pos == len(indices) - 1
            with open(path, "rb") as f:
                lines = f.read().split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            for i, line in enumerate(lines):
                try:
                    rec = json.loads(line)
                except ValueError:
                    if last_segment and i == len(lines) - 1:
                        logger.warning(
                            "journal %s: dropping torn final record", path
                        )
                        continue
                    logger.warning(
                        "journal %s: torn record at line %d; replay "
                        "stops there",
                        path,
                        i + 1,
                    )
                    self._adopt(state, indices, applied, t0)
                    return state
                state.apply(rec)
                applied += 1
        self._adopt(state, indices, applied, t0)
        return state

    def _adopt(self, state, indices, applied, t0):
        with self._mu:
            self._state = state
            self._seg_idx = (indices[-1] if indices else 0) + 1
        self.replayed_records = applied
        self.replay_seconds = time.perf_counter() - t0

    @staticmethod
    def _read_head(path):
        try:
            with open(path, "rb") as f:
                line = f.readline()
            return json.loads(line)
        except (OSError, ValueError):
            return None

    # -- the write side ------------------------------------------------------

    def start(self):
        """Open the boot segment (headed by the post-recovery compaction)
        and start the writer thread. Idempotent."""
        if self._thread is not None:
            return self
        self._rotate()
        self._thread = threading.Thread(
            target=self._writer_loop, daemon=True, name="edl-master-journal"
        )
        self._thread.start()
        return self

    def append(self, kind, **fields):
        """Enqueue one record; never touches the disk (the writer thread
        owns all IO). Safe under the dispatcher's ledger lock."""
        rec = {"k": kind}
        rec.update(fields)
        with self._mu:
            self._state.apply(rec)
            self._buf.append(rec)
            self._append_seq += 1
        self._wake.set()

    def flush(self):
        """Write and fsync everything appended so far (the SIGTERM drain
        and the tests). ``_io`` is taken before the buffer drains: a
        rotation between the drain and its write would fold the drained
        records into the new head state and leave their lines in the
        chain as well, applying them twice on the next replay."""
        with self._io:
            with self._mu:
                batch, self._buf = self._buf, []
                seq = self._append_seq
            self._write_io(batch)
        with self._mu:
            self._records_in_segment += len(batch)
            self._flushed_seq = max(self._flushed_seq, seq)

    def counts(self):
        """The cumulative counters, the live pending count and the
        appends not yet on disk (``master_status``)."""
        with self._mu:
            out = dict(self._state.counters)
            out["pending"] = len(self._state.pending)
            out["unflushed"] = self._append_seq - self._flushed_seq
        return out

    def close(self):
        if self._closed.is_set():
            return
        self._closed.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.flush()
        with self._io:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- the writer ----------------------------------------------------------

    def _writer_loop(self):
        while not self._closed.is_set():
            self._wake.wait(self._fsync_interval)
            self._wake.clear()
            # everything queued since the last tick: one write, one fsync
            with self._mu:
                batch, self._buf = self._buf, []
                seq = self._append_seq
                rotate = (
                    self._records_in_segment + len(batch)
                    > self._segment_records
                )
            if rotate:
                # the compaction (taken under _mu) already folds the
                # drained batch, so the batch itself is dropped
                self._rotate()
                continue
            if batch:
                self._write_batch(batch, seq)

    def _write_batch(self, batch, seq):
        with self._io:
            # the fsync cadence is the master's one recurring disk wait:
            # a span per batch shows a slow disk in the same /trace
            # timeline as the dispatch and report spans it can stall
            with profiling.span(
                "master/journal_fsync", records=len(batch)
            ):
                self._write_io(batch)
        with self._mu:
            self._records_in_segment += len(batch)
            self._flushed_seq = max(self._flushed_seq, seq)

    def _write_io(self, batch):
        # _io held by the caller
        f = self._ensure_file()
        if batch:
            f.write(
                b"".join(
                    json.dumps(rec, default=str).encode("utf-8") + b"\n"
                    for rec in batch
                )
            )
        f.flush()
        os.fsync(f.fileno())

    def _ensure_file(self):
        # _io held by the caller; _seg_idx is owned by _mu
        if self._file is None:
            with self._mu:
                idx = self._seg_idx
            self._file = open(_seg_path(self._dir, idx), "ab")
        return self._file

    def _rotate(self):
        """Publish a fresh segment opened by the current compaction,
        atomically (write to a temp file, rename), then unlink the chain
        it supersedes. ``_io`` is held across the whole snapshot and
        publish, so a concurrent flush lands entirely before (its
        records are in the snapshot) or entirely after (into the new
        segment), never into a segment the publish then unlinks."""
        with self._io:
            with self._mu:
                # still-buffered records are folded into the snapshot
                self._buf = []
                snap = self._state.to_record()
                self._seg_idx += 1
                next_idx = self._seg_idx
                self._records_in_segment = 1
                self._flushed_seq = self._append_seq
            final = _seg_path(self._dir, next_idx)
            tmp = os.path.join(
                self._dir,
                "%s%08d.%d.jsonl" % (_TMP_PREFIX, next_idx, os.getpid()),
            )
            if self._file is not None:
                self._file.close()
                self._file = None
            with open(tmp, "wb") as f:
                f.write(json.dumps(snap, default=str).encode("utf-8") + b"\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            self._file = open(final, "ab")
        for idx in _segment_indices(self._dir):
            if idx < next_idx:
                try:
                    os.remove(_seg_path(self._dir, idx))
                except OSError:
                    pass
        for stale in glob.glob(os.path.join(self._dir, _TMP_PREFIX + "*")):
            try:
                os.remove(stale)
            except OSError:
                pass
