"""Host-side embedding table with lazy row initialization, the port of
``elasticdl_tpu/ps/embedding_table.py``.

Rows materialize on first ``get`` from a named initializer; slot tables
(optimizer state rows) use a constant initializer; a slot table is named
``"{layer}-{slot}"``.

Lazy init is order-independent: a row's initial value is a pure numpy
function of ``(id, column, initializer, seed)`` (a splitmix64 hash drives
the uniform and normal draws), never of the order rows materialize in.
So the same id mints the same row in every shard, after every restore,
and in both packages: the port's rows are bitwise the reference's.
"""

import threading

import numpy as np

# splitmix64 constants (Steele et al.): the increment is the golden
# ratio; a second odd constant separates the column axis so (id, col)
# pairs never collide by construction of a linear relation
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_WEYL = np.uint64(0xBF58476D1CE4E5B9)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x):
    z = x
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def _unit_from_ids(ids, dim, salt):
    """``(n, dim)`` uniforms in [0, 1) — a pure function of
    ``(id, column, salt)``, vectorized. float64 mantissa precision (53
    hash bits per draw) so the downstream float32 cast is exact."""
    ids64 = np.asarray(ids, dtype=np.int64).reshape(-1, 1)
    cols = np.arange(int(dim), dtype=np.uint64).reshape(1, -1)
    with np.errstate(over="ignore"):
        # negative ids wrap deterministically through the uint64 view
        x = _splitmix64(
            ids64.astype(np.uint64) * _GOLDEN
            + cols * _WEYL
            + np.uint64(salt)
        )
    return (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _make_initializer(name, seed=0):
    """Vectorized per-id initializer: ``init(ids, dim) -> (n, dim) f32``.

    The value of row ``i`` depends only on ``(i, name, seed)`` — NOT on
    how many rows initialized before it — so lazy init commutes with
    any materialization order (pinned by
    tests/test_ps_store.py::test_lazy_init_is_order_independent)."""
    name = (name or "uniform").lower()

    if name in ("uniform", "random_uniform"):

        def uniform(ids, dim):
            u = _unit_from_ids(ids, dim, 2 * seed + 1)
            return (-0.05 + 0.1 * u).astype(np.float32)

        return uniform
    if name in ("normal", "random_normal"):

        def normal(ids, dim):
            # Box-Muller on two independent per-(id, col) draws
            u1 = _unit_from_ids(ids, dim, 2 * seed + 1)
            u2 = _unit_from_ids(ids, dim, 2 * seed + 2)
            u1 = np.maximum(u1, np.finfo(np.float64).tiny)
            z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
            return (0.05 * z).astype(np.float32)

        return normal
    if name.startswith("zero"):
        return lambda ids, dim: np.zeros((len(ids), dim), dtype=np.float32)
    if name.startswith("ones"):
        return lambda ids, dim: np.ones((len(ids), dim), dtype=np.float32)
    try:
        const = float(name)
        return lambda ids, dim: np.full(
            (len(ids), dim), const, dtype=np.float32
        )
    except ValueError:
        raise ValueError("Unknown embedding initializer %r" % name)


class EmbeddingTable:
    def __init__(self, name, dim=None, initializer=None, is_slot=False):
        """``initializer``: name string; slot tables pass the constant
        value as a string."""
        self.name = name
        self.dim = dim
        self.initializer_name = initializer
        self.is_slot = is_slot
        self._initializer = _make_initializer(initializer)
        self._lock = threading.Lock()
        self.embedding_vectors = {}

    def get(self, indices):
        """Rows for ``indices`` (lazy-init missing ones). -> (n, dim)."""
        if len(indices) == 0:
            return None
        ids = [int(i) for i in indices]
        with self._lock:
            missing = [
                i
                for i in dict.fromkeys(ids)
                if i not in self.embedding_vectors
            ]
            if missing:
                # one vectorized fill for all missing rows; each row's
                # value is a function of its id alone (order-free)
                fresh = self._initializer(
                    np.asarray(missing, dtype=np.int64), self.dim
                )
                for pos, i in enumerate(missing):
                    self.embedding_vectors[i] = fresh[pos]
            return np.stack([self.embedding_vectors[i] for i in ids])

    def set(self, indices, values):
        values = np.asarray(values)
        with self._lock:
            for pos, i in enumerate(indices):
                self.embedding_vectors[int(i)] = values[pos].copy()

    def clear(self):
        with self._lock:
            self.embedding_vectors.clear()

    def missing_ids(self, indices):
        """The ids of ``indices`` with no row yet: a membership probe
        that mints nothing (the tiered store routes ids with it)."""
        with self._lock:
            return [
                int(i) for i in indices
                if int(i) not in self.embedding_vectors
            ]

    def evict_rows(self, indices):
        """Drop these rows (the tiered store's demotion, once it has
        sealed them into a disk segment); returns how many were held. A
        later lookup mints the row afresh unless a tier above serves
        it."""
        dropped = 0
        with self._lock:
            for i in indices:
                if self.embedding_vectors.pop(int(i), None) is not None:
                    dropped += 1
        return dropped

    def snapshot(self):
        """Consistent (ids, rows) copy of every materialized row.

        Captured under the table lock, so a concurrent ``set`` from an
        async apply can never tear one row across the copy. Returns
        ``(ids int64 (n,), rows float32 (n, dim))`` — empty arrays for
        a table no lookup has touched yet (lazy init means an untouched
        table has nothing durable to lose)."""
        with self._lock:
            ids = np.fromiter(
                self.embedding_vectors.keys(),
                dtype=np.int64,
                count=len(self.embedding_vectors),
            )
            if ids.size == 0:
                rows = np.zeros((0, int(self.dim or 0)), np.float32)
            else:
                rows = np.stack(
                    [
                        np.asarray(v, dtype=np.float32)
                        for v in self.embedding_vectors.values()
                    ]
                )
        return ids, rows

    def load_snapshot(self, ids, rows):
        """Replace the rows with a snapshot's ``(ids, rows)``."""
        rows = np.asarray(rows, dtype=np.float32)
        with self._lock:
            self.embedding_vectors = {
                int(i): rows[pos].copy() for pos, i in enumerate(ids)
            }

    def __len__(self):
        return len(self.embedding_vectors)


def get_slot_table_name(layer_name, slot_name):
    """The slot table of ``layer_name``'s optimizer slot ``slot_name``."""
    return layer_name + "-" + slot_name
