"""The tiered embedding store, the port of
``elasticdl_tpu/ps/tiered_store.py``: a shard's table no longer has to fit
in its warm tier. :class:`TieredEmbeddingTable` wraps the shard's
resident store (the host :class:`~elasticdl_tpu_torch.ps.embedding_table.
EmbeddingTable`, or the ``--ps_device`` arena of
:class:`~elasticdl_tpu_torch.ps.device_store.DeviceEmbeddingTable`),
spills cold rows to disk segments, and promotes them back on demand.
With the worker's ``HotRowCache`` (``nn/comm_plane.py``) a row lives in
one of three tiers::

    HotRowCache (worker) -> warm store (host dict / device arena)
                         -> disk segments (this module)

- **A spill segment is a snapshot shard.** Segments are written with
  ``ps/snapshot.write_shard_snapshot`` and read with
  ``read_shard_snapshot``, one table a segment, the generation as its
  version. A torn segment (a ``tmp-`` directory, or one without its
  manifest) is invisible to re-attach and to reads, so the previous
  generation serves; the packages read each other's segments.
- **Re-attach.** A table built over a spill directory indexes the sealed
  segments already there, oldest first, so an id spilled twice resolves
  to its newest generation.
- **The demoter** runs on a background thread: it captures the victim
  rows under the tier lock, writes and seals the segment with no lock
  held, then evicts only the victims untouched since the capture (a row
  written meanwhile stays warm, and its stale copy is never indexed). A
  SIGKILL anywhere in a demotion loses no row.
- **Victims** are the oldest-touched warm rows, leaving out the rows a
  read holds, the rows of the apply in flight, and the rows the last
  ``_PIN_VERSIONS`` versions applied to (:meth:`note_applied`, which the
  shard's servicer calls on every apply). The warm hit rate sets the
  depth: a table that almost never misses is demoted to 90 % of its
  budget, one that misses only down to the budget.
- **Batched cold pulls.** The cold ids of a read are grouped by segment,
  and each segment is opened once (``cold_pull_segments`` counts the
  opens, ``cold_pull_rows`` the rows).

Warm and disk hold disjoint ids: a promotion or an overwrite unindexes
the disk copy in the lock hold that writes warm, and a demotion indexes a
row on disk in the hold that evicts it. Demotion moves rows and changes
no value, so :meth:`snapshot` (warm and disk, warm winning) equals the
untiered table's, and :meth:`load_snapshot` lands everything warm and
drops the old segments. An id indexed on disk is never minted afresh:
every read promotes before it touches the warm store.

The counters, which :meth:`stats` reads, reach the process registry
through a scrape-time collector (``edl_tiered_*{table}``, the
reference's families), and each spill emits a ``tiered_spill`` event.
"""

import collections
import os
import threading

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.ps.snapshot import (
    read_shard_snapshot,
    remove_snapshot_dir,
    snapshot_path,
    snapshot_versions,
    write_shard_snapshot,
)

# at most this many rows a segment: bounded files, a short window between
# the capture and the eviction
_SPILL_BATCH = 4096
# the rows the last this many applied versions wrote are never victims
_PIN_VERSIONS = 2
# a table whose warm hit rate is at least this keeps _SLACK of its budget
_SLACK_HIT_RATE = 0.98
_SLACK = 0.9


def _id_list(indices):
    return [int(i) for i in np.asarray(indices, dtype=np.int64).reshape(-1)]


class TieredEmbeddingTable:
    """A warm table with a disk tier behind it, on the same surface.

    ``inner``: the warm store (with ``missing_ids``/``evict_rows``);
    ``spill_dir``: this table's segment directory; ``warm_rows``: the
    warm budget in rows. The sealed segments already in ``spill_dir``
    are re-attached.

    Lock order: the tier lock ``_mu`` before the inner table's. No disk
    IO runs under ``_mu``.
    """

    def __init__(self, inner, spill_dir, warm_rows):
        if warm_rows <= 0:
            raise ValueError("warm_rows must be positive")
        self._inner = inner
        self._dir = spill_dir
        self._warm_rows = int(warm_rows)
        self._mu = threading.Lock()
        self._ticks = {}  # warm id -> last touch
        self._tick = 0
        self._disk = {}  # id -> the generation of the segment holding it
        self._seg_live = {}  # generation -> rows indexed in it
        self._gen = 1
        self._pins = collections.Counter()  # ids held by reads in flight
        self._apply_pins = frozenset()  # the apply in flight's ids
        self._applied = collections.deque()  # (version, ids) of applies
        self._gc_pending = collections.deque()  # segment dirs to delete
        self._spilled_rows = 0
        self._spill_segments = 0
        self._cold_pull_rows = 0
        self._cold_pull_segments = 0
        self._promoted_rows = 0
        self._warm_hit_rows = 0
        os.makedirs(self._dir, exist_ok=True)
        self._reattach()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._demote_loop,
            name="tiered-demoter-%s" % self.name,
            daemon=True,
        )
        self._thread.start()
        profiling.metrics.register_collector(self._collect)

    # -- the inner table's identity -------------------------------------------

    @property
    def name(self):
        return self._inner.name

    @property
    def dim(self):
        return self._inner.dim

    @property
    def initializer_name(self):
        return self._inner.initializer_name

    @property
    def is_slot(self):
        return self._inner.is_slot

    def __len__(self):
        """Every row the table holds, warm or on disk."""
        with self._mu:
            return len(self._inner) + len(self._disk)

    # -- re-attach ------------------------------------------------------------

    def _segment_path(self, gen):
        return snapshot_path(self._dir, gen)

    def _reattach(self):
        """Index the sealed segments a previous incarnation left, oldest
        first (the newest generation of an id wins); an unsealed one is
        not listed by ``snapshot_versions``."""
        gens = snapshot_versions(self._dir)
        for gen in gens:
            try:
                state = read_shard_snapshot(self._segment_path(gen))
            except Exception as err:  # noqa: BLE001 - skip a torn segment
                logger.warning(
                    "tiered %s: segment v%d unreadable at re-attach (%s); "
                    "the previous generation serves", self.name, gen, err,
                )
                continue
            for snap in state["tables"].values():
                for i in _id_list(snap["ids"]):
                    old = self._disk.get(i)
                    if old is not None:
                        self._seg_live[old] -= 1
                    self._disk[i] = gen
                    self._seg_live[gen] = self._seg_live.get(gen, 0) + 1
        for gen, live in list(self._seg_live.items()):
            if live <= 0:
                del self._seg_live[gen]
                self._gc_pending.append(self._segment_path(gen))
        if gens:
            self._gen = max(gens) + 1
        if self._disk:
            logger.info(
                "tiered %s: re-attached %d disk rows in %d segments",
                self.name, len(self._disk), len(self._seg_live),
            )

    # -- bookkeeping (under _mu) ------------------------------------------------

    def _touch_locked(self, ids):
        # _ticks is the warm ids' recency index: a disk id gets no entry,
        # or the demoter would take it for a warm victim and seal a
        # freshly minted row over the real one
        self._tick += 1
        t = self._tick
        for i in ids:
            if i not in self._disk:
                self._ticks[i] = t

    def _seg_deref_locked(self, gen):
        live = self._seg_live.get(gen, 0) - 1
        if live > 0:
            self._seg_live[gen] = live
        else:
            self._seg_live.pop(gen, None)
            self._gc_pending.append(self._segment_path(gen))

    def _cold_plan_locked(self, ids):
        """The disk ids of ``ids`` grouped by segment: one read each."""
        plan = {}
        for i in ids:
            gen = self._disk.get(i)
            if gen is not None:
                plan.setdefault(gen, []).append(i)
        return plan

    def _install_promoted_locked(self, got):
        """Write read-back rows warm and unindex them from disk."""
        if not got:
            return
        ids = np.fromiter(got.keys(), dtype=np.int64, count=len(got))
        self._inner.set(ids, np.stack(list(got.values())))
        for i in got:
            gen = self._disk.pop(i, None)
            if gen is not None:
                self._seg_deref_locked(gen)
        self._touch_locked(got.keys())
        self._promoted_rows += len(got)

    def _maybe_wake(self):
        if len(self._inner) > self._warm_rows or self._gc_pending:
            self._wake.set()

    # -- promotion --------------------------------------------------------------

    def _read_segment_rows(self, gen, wanted, count=True):
        """``{id: row}`` of the ``wanted`` ids in segment ``gen`` (one
        read), or None if the segment is gone or unreadable."""
        try:
            state = read_shard_snapshot(self._segment_path(gen))
        except Exception as err:  # noqa: BLE001 - the caller re-plans
            logger.warning(
                "tiered %s: segment v%d unreadable (%s); re-planning",
                self.name, gen, err,
            )
            return None
        want = set(wanted)
        got = {}
        for snap in state["tables"].values():
            rows = np.asarray(snap["rows"], dtype=np.float32)
            for pos, i in enumerate(_id_list(snap["ids"])):
                if i in want:
                    got[i] = rows[pos]
        if count:
            with self._mu:
                self._cold_pull_segments += 1
                self._cold_pull_rows += len(got)
        return got

    def _promote(self, uniq):
        """Bring every disk id of ``uniq`` warm. A concurrent promotion
        may delete a planned segment mid-read, so it plans again; ids
        still indexed to a segment that stays unreadable are unindexed
        (logged as an error) on the last attempt, and minted afresh."""
        for attempt in range(3):
            with self._mu:
                plan = self._cold_plan_locked(uniq)
            if not plan:
                return
            for gen, ids in sorted(plan.items()):
                got = self._read_segment_rows(gen, ids)
                with self._mu:
                    if got is None:
                        if attempt == 2:
                            stuck = [
                                i for i in ids if self._disk.get(i) == gen
                            ]
                            for i in stuck:
                                del self._disk[i]
                                self._seg_deref_locked(gen)
                            if stuck:
                                logger.error(
                                    "tiered %s: segment v%d unreadable with "
                                    "%d rows indexed; they are minted "
                                    "afresh", self.name, gen, len(stuck),
                                )
                        continue
                    self._install_promoted_locked({
                        i: row for i, row in got.items()
                        if self._disk.get(i) == gen
                    })

    # -- the table surface ------------------------------------------------------

    def get(self, indices):
        if len(indices) == 0:
            return None
        ids = _id_list(indices)
        uniq = list(dict.fromkeys(ids))
        with self._mu:
            self._pins.update(uniq)
            self._touch_locked(uniq)
            cold = sum(1 for i in uniq if i in self._disk)
            self._warm_hit_rows += len(uniq) - cold
        try:
            self._promote(uniq)
            out = self._inner.get(ids)
        finally:
            with self._mu:
                self._pins.subtract(uniq)
                self._pins += collections.Counter()  # drop the zeros
        self._maybe_wake()
        return out

    def set(self, indices, values):
        uniq = list(dict.fromkeys(_id_list(indices)))
        with self._mu:
            self._inner.set(indices, values)
            for i in uniq:
                gen = self._disk.pop(i, None)
                if gen is not None:
                    # written while cold: the warm row supersedes the
                    # segment's copy
                    self._seg_deref_locked(gen)
            self._touch_locked(uniq)
        self._maybe_wake()

    def clear(self):
        with self._mu:
            self._inner.clear()
            self._ticks.clear()
            self._disk.clear()
            self._seg_live.clear()
        for gen in snapshot_versions(self._dir):
            remove_snapshot_dir(self._segment_path(gen))

    def snapshot(self):
        """``(ids, rows)`` of every row, warm or on disk: the warm cut and
        the disk plan are taken in one lock hold, the segments read with
        none held, and ids whose segment vanished meanwhile (promoted,
        values unchanged) read back through :meth:`get`."""
        with self._mu:
            warm_ids, warm_rows = self._inner.snapshot()
            plan = {}
            for i, gen in self._disk.items():
                plan.setdefault(gen, []).append(i)
        dim = int(self.dim or 0)
        parts_ids = [np.asarray(warm_ids, dtype=np.int64)]
        parts_rows = [np.asarray(warm_rows, dtype=np.float32)]
        lost = []
        for gen, ids in sorted(plan.items()):
            got = self._read_segment_rows(gen, ids, count=False)
            if got is None:
                lost.extend(ids)
                continue
            hit = [i for i in ids if i in got]
            lost.extend(i for i in ids if i not in got)
            if hit:
                parts_ids.append(np.asarray(hit, dtype=np.int64))
                parts_rows.append(np.stack([got[i] for i in hit]))
        if lost:
            lost = np.asarray(lost, dtype=np.int64)
            parts_ids.append(lost)
            parts_rows.append(np.asarray(self.get(lost), dtype=np.float32))
        ids = np.concatenate(parts_ids)
        if ids.size == 0:
            return ids, np.zeros((0, dim), np.float32)
        rows = np.concatenate([p.reshape(-1, dim) for p in parts_rows])
        # warm first: np.unique's return_index keeps the first occurrence
        _, first = np.unique(ids, return_index=True)
        return ids[first], rows[first]

    def load_snapshot(self, ids, rows):
        """Restore a cut (the tier is not part of the format, so a tiered
        cut restores into a plain table and back): everything lands warm,
        the old segments are deleted, and the demoter spills the
        overflow again."""
        with self._mu:
            self._disk.clear()
            self._seg_live.clear()
            self._ticks.clear()
        for gen in snapshot_versions(self._dir):
            remove_snapshot_dir(self._segment_path(gen))
        with self._mu:
            self._inner.load_snapshot(ids, rows)
            self._touch_locked(_id_list(ids))
        self._wake.set()

    # -- the device plane (the arena's) ---------------------------------------

    def ensure_rows(self, unique_ids):
        """Promote, then hand over to the arena, so a disk id reaches it
        before the arena's lazy init could mint it. The ids become the
        apply's pins (applies are serialized by the optimizer wrapper),
        so no victim's slot is freed and reused while this apply still
        scatters into it."""
        uniq = _id_list(unique_ids)
        with self._mu:
            self._apply_pins = frozenset(uniq)
            self._touch_locked(uniq)
            cold = sum(1 for i in uniq if i in self._disk)
            self._warm_hit_rows += len(uniq) - cold
        self._promote(uniq)
        self._maybe_wake()
        return self._inner.ensure_rows(unique_ids)

    def gather_slots(self, slots):
        return self._inner.gather_slots(slots)

    def scatter_slots(self, slots, rows):
        return self._inner.scatter_slots(slots, rows)

    def sync(self):
        return self._inner.sync()

    # -- the signals ------------------------------------------------------------

    def note_applied(self, ids, version):
        """An apply of ``version`` wrote these rows: touch them and pin
        them against demotion for ``_PIN_VERSIONS`` versions."""
        uniq = set(_id_list(ids))
        version = int(version)
        with self._mu:
            self._touch_locked(uniq)
            self._applied.append((version, uniq))
            floor = version - _PIN_VERSIONS
            while self._applied and self._applied[0][0] < floor:
                self._applied.popleft()

    def signal_pressure(self):
        """After an apply: wake the demoter (never blocks)."""
        self._maybe_wake()

    # -- demotion -----------------------------------------------------------------

    def _demote_target_locked(self):
        pulls = self._warm_hit_rows + self._cold_pull_rows
        hit = (self._warm_hit_rows / pulls) if pulls else 1.0
        if hit >= _SLACK_HIT_RATE:
            return int(self._warm_rows * _SLACK)
        return self._warm_rows

    def _demote_once(self):
        """One spill; returns the rows demoted. (1) Under ``_mu``: pick
        the victims and copy their rows. (2) With no lock: write and seal
        the segment. (3) Under ``_mu``: evict the victims untouched since
        (1) and index them on disk."""
        with self._mu:
            overflow = len(self._inner) - self._demote_target_locked()
            if overflow <= 0:
                return 0
            excluded = set(self._pins)
            excluded.update(self._apply_pins)
            for _, applied in self._applied:
                excluded.update(applied)
            candidates = [i for i in self._ticks if i not in excluded]
            candidates.sort(key=self._ticks.__getitem__)
            victims = candidates[: min(overflow, _SPILL_BATCH)]
            # a ticked id with no warm row must not reach inner.get, which
            # would mint a row and seal it: drop its stale tick
            missing = set(self._inner.missing_ids(victims))
            if missing:
                for i in missing:
                    self._ticks.pop(i, None)
                victims = [i for i in victims if i not in missing]
            if not victims:
                return 0
            vids = np.asarray(victims, dtype=np.int64)
            rows = np.array(self._inner.get(vids), dtype=np.float32)
            tick_snap = {i: self._ticks[i] for i in victims}
            gen = self._gen
            self._gen += 1
            seg_state = {
                "version": gen,
                "initialized": True,
                "dense": {},
                "tables": {
                    self.name: {
                        "ids": vids,
                        "rows": rows,
                        "dim": int(self.dim or 0),
                        "initializer": self.initializer_name,
                        "is_slot": bool(self.is_slot),
                    }
                },
            }
        try:
            seg_dir = write_shard_snapshot(self._dir, seg_state)
        except Exception as err:  # noqa: BLE001 - a spill is best effort
            logger.warning(
                "tiered %s: segment write failed (%s); the rows stay warm",
                self.name, err,
            )
            return 0
        with self._mu:
            clean = [
                i for i in victims
                if self._ticks.get(i) == tick_snap[i]
                and i not in self._pins
                and i not in self._apply_pins
            ]
            if not clean:
                self._gc_pending.append(seg_dir)
                return 0
            self._inner.evict_rows(clean)
            for i in clean:
                del self._ticks[i]
                self._disk[i] = gen
            self._seg_live[gen] = len(clean)
            self._spilled_rows += len(clean)
            self._spill_segments += 1
        profiling.events.emit(
            "tiered_spill", table=self.name, rows=len(clean), generation=gen
        )
        return len(clean)

    def _drain_gc(self):
        while True:
            try:
                victim = self._gc_pending.popleft()
            except IndexError:
                return
            remove_snapshot_dir(victim)

    def _demote_loop(self):
        while True:
            self._wake.wait()
            self._wake.clear()
            self._drain_gc()
            if self._stop.is_set():
                return
            try:
                while not self._stop.is_set() and self._demote_once():
                    pass
            except Exception:  # noqa: BLE001 - the demoter lives on
                logger.warning(
                    "tiered %s: a demotion failed", self.name, exc_info=True
                )
            self._drain_gc()

    # -- counters, teardown -------------------------------------------------------

    def stats(self):
        with self._mu:
            return {
                "warm_rows": len(self._inner),
                "disk_rows": len(self._disk),
                "spilled_rows": self._spilled_rows,
                "spill_segments": self._spill_segments,
                "cold_pull_rows": self._cold_pull_rows,
                "cold_pull_segments": self._cold_pull_segments,
                "promoted_rows": self._promoted_rows,
                "warm_hit_rows": self._warm_hit_rows,
            }

    def _collect(self):
        s = self.stats()
        labels = {"table": self.name}
        pulls = s["warm_hit_rows"] + s["cold_pull_rows"]
        return [
            ("edl_tiered_warm_rows", labels, s["warm_rows"]),
            ("edl_tiered_disk_rows", labels, s["disk_rows"]),
            ("edl_tiered_spilled_rows_total", labels, s["spilled_rows"]),
            ("edl_tiered_cold_pull_rows_total", labels,
             s["cold_pull_rows"]),
            ("edl_tiered_cold_pull_segments_total", labels,
             s["cold_pull_segments"]),
            ("edl_tiered_promoted_rows_total", labels, s["promoted_rows"]),
            ("edl_tiered_warm_hit_rate", labels,
             (s["warm_hit_rows"] / pulls) if pulls else 1.0),
        ]

    def close(self):
        """Stop the demoter and delete the dead segments; the rows stay
        where they are (durability is the snapshots')."""
        if self._thread is None:
            return
        profiling.metrics.unregister_collector(self._collect)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10.0)
        self._thread = None
        self._drain_gc()
