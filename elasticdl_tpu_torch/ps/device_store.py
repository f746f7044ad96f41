"""The device-resident embedding store, the port of
``elasticdl_tpu/ps/device_store.py``: one ``(capacity, dim)`` float32
arena per table on the shard's device, and a host ``{id: slot}`` index.

The host :class:`~elasticdl_tpu_torch.ps.embedding_table.EmbeddingTable`
is a dict of rows: every pull walks the ids one by one and every apply
crosses each row host to device and back. Here:

- the apply's rows are one ``index_select`` of the arena and go back by
  one ``index_copy_`` (``ensure_rows`` -> ``gather_slots`` ->
  ``scatter_slots``), never leaving the device;
- lazy init fills only the missing slots, from the host table's
  id-seeded initializer (``embedding_table._make_initializer``), so a
  host shard and a device shard mint bitwise-equal fresh rows in any
  order;
- the arena grows by doubling from 64 rows, and a slot comes off the
  free list (filled by ``evict_rows``, the tiered store's demotion)
  before the high-water mark moves, so a table that cycles rows through
  the disk tier keeps its arena at the warm size.

Nothing is padded to a power of two, as the reference pads to bound
``jit`` recompiles: eager PyTorch compiles nothing. ``index_copy_`` with
a repeated index is undefined, so a scatter takes unique slots: ``set``
keeps the last write of a duplicated id, and the optimizer wrapper
combines duplicates before it scatters.

Every method takes the table lock, so an async apply's scatter and a
concurrent pull's gather serialize. :meth:`sync` waits on the device's
stream: a reply must not read rows a scatter has not written yet. The
host-facing methods (``get``, ``snapshot``) copy to host memory, which
waits for the stream by itself.
"""

import threading

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.tensor import device_from_host_view
from elasticdl_tpu_torch.ps.embedding_table import _make_initializer

_MIN_CAPACITY = 64


def next_pow2(n):
    """The least power of two >= ``n`` (and >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _id_list(indices):
    return [int(i) for i in np.asarray(indices, dtype=np.int64).reshape(-1)]


class DeviceEmbeddingTable:
    """:class:`EmbeddingTable`'s surface (``get``/``set``/``clear``/
    ``missing_ids``/``evict_rows``/``snapshot``/``load_snapshot``/
    ``__len__``) with the rows on ``device``, plus the device plane the
    optimizer wrapper drives: ``ensure_rows``/``gather_slots``/
    ``scatter_slots``/``sync``. ``device`` defaults to the card and
    raises without one."""

    def __init__(self, name, dim=None, initializer=None, is_slot=False,
                 device="cuda"):
        self.name = name
        self.dim = dim
        self.initializer_name = initializer
        self.is_slot = is_slot
        self.device = resolve_device(device)
        self._initializer = _make_initializer(initializer)
        self._lock = threading.Lock()
        self._slots = {}  # id -> arena row
        self._arena = None  # (capacity, dim) float32 on self.device
        self._free = []  # evicted arena rows, reused before growing
        self._next = 0  # high-water mark: the first row never assigned

    @property
    def capacity(self):
        return 0 if self._arena is None else int(self._arena.shape[0])

    def _index(self, slots):
        return torch.as_tensor(
            np.asarray(slots, dtype=np.int64), device=self.device
        )

    def _to_device(self, rows):
        # every caller copies the result into the arena at once, so an
        # aliased import of a writable request view is safe
        return device_from_host_view(
            np.ascontiguousarray(rows, dtype=np.float32), self.device
        )

    # -- the device plane ----------------------------------------------------

    def _grow_locked(self, need):
        cap = self.capacity
        if self._arena is not None and need <= cap:
            return
        if self.dim is None:
            raise ValueError(
                "DeviceEmbeddingTable %r used before its dim is known"
                % self.name
            )
        new = torch.zeros(
            (max(_MIN_CAPACITY, next_pow2(need)), int(self.dim)),
            dtype=torch.float32,
            device=self.device,
        )
        if cap:
            new[:cap] = self._arena
        self._arena = new

    def _materialize_locked(self, ids, init=True):
        """Assign slots to the unseen ids of ``ids`` (free list first,
        then the high-water mark); ``init`` fills them from the id-seeded
        initializer in one ``index_copy_``. Without ``init`` the caller
        (``set``) writes them in the same lock hold, so a reused slot is
        always written before it is read."""
        missing = [i for i in dict.fromkeys(ids) if i not in self._slots]
        if not missing:
            return
        m = len(missing)
        alloc = []
        while self._free and len(alloc) < m:
            alloc.append(self._free.pop())
        fresh_n = m - len(alloc)
        if fresh_n:
            self._grow_locked(self._next + fresh_n)
            alloc.extend(range(self._next, self._next + fresh_n))
            self._next += fresh_n
        if init:
            fresh = self._initializer(
                np.asarray(missing, dtype=np.int64), self.dim
            )
            self._arena.index_copy_(
                0, self._index(alloc), self._to_device(fresh)
            )
        for pos, i in enumerate(missing):
            self._slots[i] = alloc[pos]

    def ensure_rows(self, unique_ids):
        """The slots of ``unique_ids`` (missing rows minted), as an int64
        tensor on the arena's device."""
        ids = _id_list(unique_ids)
        with self._lock:
            self._materialize_locked(ids)
            return self._index([self._slots[i] for i in ids])

    def gather_slots(self, slots):
        """The rows at ``slots``: one ``index_select``, a fresh tensor."""
        with self._lock:
            return self._arena.index_select(0, slots)

    def scatter_slots(self, slots, rows):
        """Write ``rows`` at ``slots`` (unique) with one ``index_copy_``."""
        with self._lock:
            self._arena.index_copy_(0, slots, rows)

    def sync(self):
        """Wait until every queued arena write has run on the device."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- the host-facing surface --------------------------------------------

    def get(self, indices):
        """Rows for ``indices`` (missing ones minted), ``(n, dim)``
        float32 in host memory: one gather and one copy to host."""
        if len(indices) == 0:
            return None
        ids = _id_list(indices)
        with self._lock:
            self._materialize_locked(ids)
            out = self._arena.index_select(
                0, self._index([self._slots[i] for i in ids])
            )
            return out.to("cpu").numpy()

    def set(self, indices, values):
        """Write whole rows; the last write of a duplicated id wins, as in
        the host table."""
        ids = _id_list(indices)
        values = np.asarray(values, dtype=np.float32)
        last = {}
        for pos, i in enumerate(ids):
            last[i] = pos
        uniq = list(last)
        with self._lock:
            self._materialize_locked(uniq, init=False)
            self._arena.index_copy_(
                0,
                self._index([self._slots[i] for i in uniq]),
                self._to_device(values[[last[i] for i in uniq]]),
            )

    def clear(self):
        with self._lock:
            self._slots = {}
            self._arena = None
            self._free = []
            self._next = 0

    def missing_ids(self, indices):
        """The ids of ``indices`` with no slot: a membership probe that
        mints nothing."""
        with self._lock:
            return [int(i) for i in indices if int(i) not in self._slots]

    def evict_rows(self, indices):
        """Put these rows' slots on the free list (the tiered store has
        sealed them into a segment first); returns how many were held.
        Nothing is written: a freed slot is unreachable until a reuse
        writes it."""
        dropped = 0
        with self._lock:
            for i in indices:
                slot = self._slots.pop(int(i), None)
                if slot is not None:
                    self._free.append(slot)
                    dropped += 1
        return dropped

    def snapshot(self):
        """``(ids int64 (n,), rows float32 (n, dim))`` in host memory,
        copied under the table lock (one gather in slot order, one copy
        to host: the slots are recycled, so rows are not contiguous)."""
        with self._lock:
            n = len(self._slots)
            ids = np.fromiter(self._slots.keys(), dtype=np.int64, count=n)
            if n == 0:
                return ids, np.zeros((0, int(self.dim or 0)), np.float32)
            rows = self._arena.index_select(
                0, self._index(list(self._slots.values()))
            ).to("cpu").numpy()
        return ids, rows

    def load_snapshot(self, ids, rows):
        """Replace every row with a snapshot's ``(ids, rows)``, packed
        into slots ``0..n-1``."""
        rows = np.asarray(rows, dtype=np.float32)
        ids = _id_list(ids)
        with self._lock:
            self._slots = {}
            self._arena = None
            self._free = []
            self._next = 0
            if not ids:
                return
            self._grow_locked(len(ids))
            self._arena[: len(ids)] = self._to_device(rows)
            self._slots = {i: pos for pos, i in enumerate(ids)}
            self._next = len(ids)

    def __len__(self):
        return len(self._slots)
