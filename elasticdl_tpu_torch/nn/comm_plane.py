"""Per-table embedding planes, the counterpart of
``elasticdl_tpu/nn/comm_plane.py``.

A model that mixes planes names one per table: ``"ps"`` (the elastic
``nn/embedding.Embedding``: rows in the master's store or on the PS
fleet, pulled per batch, sparse gradients pushed) or ``"hbm"`` (the table
a real parameter on the device, ``nn/hbm_embedding.py``).
:func:`resolve_table_planes` parses the zoo-facing ``embedding_plane=ps|
hbm|hybrid|"table:plane/table:plane"`` spec with the reference's rules
and errors, and :func:`make_embedding` builds one table's layer from its
plane.

:class:`CommPlane` is the one interface the worker's embedding data
path talks to, ``plan -> pull -> push -> drain``:

- :func:`plan_lookup_multi`, the batch-wide unique plan: one pull of a
  layer's unique ids over all its calls, each call keeping its positions
  into the shared rows buffer, so the step's row gradients come back
  already combined, one row per unique id;
- :class:`MasterStorePlane` pulls the planned rows from the master's
  store, one call per table (its sparse gradients ride
  ``report_gradient`` with the dense ones); :class:`PsPlane` pulls them
  from the PS fleet in one fan-out over every (table, shard) leg
  (``worker/ps_client.py``) and pushes the sparse gradients alone (the
  hybrid trainer's push). An HBM-plane table is looked up and updated
  inside the step; its :class:`HbmPlane` (``in_graph``) pulls and
  pushes nothing;
- the worker copies the pulled ``(k, dim)`` rows to the card as they
  are. The reference pads them to a power-of-two bucket to bound XLA
  recompiles; eager PyTorch has none to bound, and the pushed
  ``(ids, rows)`` are the unique ids and their rows either way;
- :meth:`CommPlane.drain` settles the fleet client's push window.

:class:`EmbeddingPullPipeline` is the hybrid trainer's overlapped pull:
the worker plans the next batch on its own thread and hands the fan-out
to the pipeline's one thread, so it runs while the current batch
computes.

:class:`HotRowCache` is the worker's tier above the PS fleet: an LRU of
pulled rows, each tagged with its shard's version, served in place of a
pull while it lags that shard's newest seen version by at most a window.
A scorer's delta sync (``serving/delta_sync.py``) keeps it fresh through
``refresh_table`` (drop the rows a delta names, re-tag the rest) and
``invalidate_table`` (an incomplete delta's fallback), and reads its
staleness from ``max_live_lag``.
"""

import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PLANES = ("ps", "hbm")


def resolve_table_planes(spec, tables, hybrid_default=None):
    """Parse an ``embedding_plane`` spec into {table_name: plane}.

    Accepted forms:

    - ``"ps"`` / ``"hbm"``: every table on that plane.
    - ``"hybrid"``: per-table via ``hybrid_default`` (the zoo's
      declared split).
    - ``"table:plane/table:plane"`` explicit per-table entries
      (``/``-separated because ``,`` already delimits model_params);
      unlisted tables get ``ps``.
    """
    tables = list(tables)
    if spec in PLANES:
        return {t: spec for t in tables}
    if spec == "hybrid":
        if not hybrid_default:
            raise ValueError(
                "embedding_plane='hybrid' needs the model to declare a "
                "per-table split (hybrid_default)"
            )
        missing = [t for t in tables if t not in hybrid_default]
        if missing:
            raise ValueError(
                "hybrid plane split missing tables %r" % (missing,)
            )
        return {t: hybrid_default[t] for t in tables}
    out = {t: "ps" for t in tables}
    for entry in str(spec).split("/"):
        entry = entry.strip()
        if not entry:
            continue
        table, sep, plane = entry.partition(":")
        if not sep or plane not in PLANES:
            raise ValueError(
                "bad embedding_plane entry %r (want 'table:ps' or "
                "'table:hbm', '/'-separated; or one of %s, 'hybrid')"
                % (entry, "/".join(PLANES))
            )
        if table not in out:
            raise ValueError(
                "embedding_plane names unknown table %r (model tables: %r)"
                % (table, tables)
            )
        out[table] = plane
    return out


def make_embedding(
    plane,
    output_dim,
    name,
    vocab_size=None,
    mesh=None,
    axis="data",
    mask_zero=False,
    combiner=None,
    collective=False,
    embedding_initializer="uniform",
    **hbm_kwargs,
):
    """Build one table's embedding layer from its plane name: ``"ps"`` ->
    the elastic :class:`~elasticdl_tpu_torch.nn.embedding.Embedding`
    (unbounded vocabulary, rows pulled per batch); ``"hbm"`` ->
    :class:`~elasticdl_tpu_torch.nn.hbm_embedding.HbmEmbedding` (the
    table a trainable parameter on the card; ``hbm_kwargs`` such as
    ``capacity`` and ``dedup`` pass through to it). The caller assigns
    the layer to its attribute ``name``, the table's name."""
    if plane == "ps":
        from elasticdl_tpu_torch.nn.embedding import Embedding

        return Embedding(
            output_dim=output_dim,
            embedding_initializer=embedding_initializer,
            mask_zero=mask_zero,
            combiner=combiner,
        )
    if plane == "hbm":
        from elasticdl_tpu_torch.nn.hbm_embedding import HbmEmbedding

        if vocab_size is None:
            raise ValueError(
                "hbm-plane table %r needs a declared vocab_size (the "
                "table is a real parameter)" % name
            )
        return HbmEmbedding(
            vocab_size=vocab_size,
            features=output_dim,
            mesh=mesh,
            axis=axis,
            mask_zero=mask_zero,
            collective=collective,
            **hbm_kwargs,
        )
    raise ValueError(
        "unknown embedding plane %r (want one of %s)"
        % (plane, "/".join(PLANES))
    )


def plan_lookup_multi(ids_list):
    """One layer's plan over all its calls in one forward: (unique ids
    (k,), [positions per call, int32, shaped like the call's ids]). Each
    call gathers from the one pulled buffer, so only unique rows cross
    and the step's row gradients come back combined."""
    arrays = [np.asarray(ids) for ids in ids_list]
    flat = np.concatenate([a.reshape(-1).astype(np.int64) for a in arrays])
    unique, inverse = np.unique(flat, return_inverse=True)
    inverse = inverse.reshape(-1)
    idxs, off = [], 0
    for a in arrays:
        idxs.append(inverse[off:off + a.size].reshape(a.shape).astype(np.int32))
        off += a.size
    return unique, idxs


class CommPlane:
    """A table's plane: a host plane pulls rows before the step and
    pushes the combined row gradients after it; an ``in_graph`` plane
    (:class:`HbmPlane`) looks up and updates inside the step."""

    name = "abstract"
    in_graph = False

    def pull(self, ids_by_table):
        """{table: unique ids} -> {table: (k, dim) rows} in one round."""
        raise NotImplementedError

    def push(self, sparse_tensors, version):
        """Send the combined row gradients; ``(accepted, version)``."""
        raise NotImplementedError

    def drain(self):
        """Settle the pushes in flight; ``(accepted, version)``, or
        ``(True, -1)`` for a plane without a push window."""
        return True, -1

    @property
    def cache(self):
        """The shared :class:`HotRowCache`, or None."""
        return None

    def close(self):
        """Release the plane's resources (threads, channels)."""


class MasterStorePlane(CommPlane):
    """The master-held store: a pull is one ``pull_embedding_vectors``
    call per table. Sparse gradients travel with the dense ones in
    ``report_gradient``, so :meth:`push` has no path of its own.
    ``stub_fn`` gives the master stub at call time."""

    name = "ps"  # the host pull's semantics; the storage differs

    def __init__(self, stub_fn):
        self._stub_fn = stub_fn

    def pull(self, ids_by_table):
        stub = self._stub_fn()
        return {
            name: np.asarray(
                stub.pull_embedding_vectors(name, ids), dtype=np.float32
            )
            for name, ids in ids_by_table.items()
        }

    def push(self, sparse_tensors, version):
        raise NotImplementedError(
            "master-store sparse gradients ride report_gradient with the "
            "dense tensors; push() has no separate wire path here"
        )


class PsPlane(CommPlane):
    """The PS fleet's plane over a ``worker.ps_client.PSClient``: a pull
    is one fan-out round, a push sends the sparse tensors alone (the
    hybrid trainer keeps the dense half off the fleet), and
    :meth:`drain` settles the push window. After a shard relaunch the
    client abandons the pushes in flight: a drain drops their outcome
    and never resends them. A pull with ``service_reinit=False`` (the
    pull pipeline's) leaves a pending re-push to a shard that came back
    empty to the worker thread's next call."""

    name = "ps"

    def __init__(self, ps_client):
        self._client = ps_client

    @property
    def client(self):
        return self._client

    @property
    def cache(self):
        return getattr(self._client, "hot_row_cache", None)

    def pull(self, ids_by_table, service_reinit=True):
        return self._client.pull_embedding_vectors_multi(
            ids_by_table, service_reinit=service_reinit
        )

    def push(self, sparse_tensors, version):
        return self._client.push_gradient({}, sparse_tensors, version)

    def drain(self):
        return self._client.drain()

    def close(self):
        if hasattr(self._client, "close"):
            self._client.close()


class HbmPlane(CommPlane):
    """The in-graph HBM plane: the table is a (vocab-split) parameter
    and its lookup and update run inside the step
    (``nn/hbm_embedding.py``: the ``all_to_all`` routing with
    ``padded_unique``'s dedup, the in-graph twin of
    :func:`plan_lookup_multi`). ``pull`` and ``push`` never run; the
    plane lets a planner treat every table alike, and holds a cache a
    serving worker may share."""

    name = "hbm"
    in_graph = True

    def __init__(self, shared_cache=None):
        self._cache = shared_cache

    @property
    def cache(self):
        return self._cache

    def pull(self, ids_by_table):
        raise RuntimeError(
            "hbm tables are looked up inside the jitted step (a2a "
            "collective); there is no host-side pull to perform"
        )

    def push(self, sparse_tensors, version):
        raise RuntimeError(
            "hbm table gradients apply inside the jitted step; there "
            "is no host-side push to perform"
        )


class EmbeddingPullPipeline:
    """The next batch's row pull, run on one background thread while the
    current batch computes (the hybrid trainer).

    The worker plans the lookahead batch on its own thread (the capture
    pass runs the model) and submits only the fan-out. Entries are keyed
    by the batch object's identity; at most ``depth`` are staged, the
    oldest evicted first. A staged pull misses at most the worker's own
    push of the batch in flight: one optimizer step of staleness.

    :meth:`invalidate` drops every staged pull exactly once: it waits
    each out (no pull is left touching the client's cache) and swallows
    its error, so a requeued task's staged pull is never served to a
    later batch. ``served`` and ``dropped`` count consumed and discarded
    pulls; ``pull_s`` sums the background pulls' seconds and
    ``last_pull_s`` is the last consumed one's.
    """

    def __init__(self, depth=2):
        self._mu = threading.Lock()
        self._pool = None
        self._depth = max(1, int(depth))
        self._entries = OrderedDict()  # id(batch) -> (batch, plan, future)
        self._closed = False
        self.dropped = 0
        self.served = 0
        self.pull_s = 0.0
        self.last_pull_s = 0.0

    def _get_pool(self):
        with self._mu:
            if self._closed:
                raise RuntimeError("EmbeddingPullPipeline is closed")
            if self._pool is None:
                # one thread: pulls run in order, and the client's
                # fan-out pool gives the per-shard concurrency
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="edl-emb-pull"
                )
            return self._pool

    def submit(self, key_obj, plan, pull_fn):
        """Stage ``pull_fn()`` for the batch ``key_obj``; ``plan`` comes
        back with its rows. Entries past the depth are dropped, oldest
        first."""
        fut = self._get_pool().submit(self._timed_pull, pull_fn)
        with self._mu:
            self._entries[id(key_obj)] = (key_obj, plan, fut)
            evicted = []
            while len(self._entries) > self._depth:
                evicted.append(self._entries.popitem(last=False)[1])
        for _, _, old in evicted:
            self._drop(old)

    def _timed_pull(self, pull_fn):
        t0 = time.perf_counter()
        try:
            return pull_fn(), time.perf_counter() - t0
        finally:
            with self._mu:
                self.pull_s += time.perf_counter() - t0

    def consume(self, key_obj):
        """``(plan, rows)`` staged for this batch, or None. Waits for a
        pull still in flight (the tail of the overlapped round trip) and
        raises its error."""
        with self._mu:
            entry = self._entries.pop(id(key_obj), None)
        if entry is None:
            return None
        _, plan, fut = entry
        rows, self.last_pull_s = fut.result()
        self.served += 1
        return plan, rows

    def invalidate(self):
        """Drop every staged pull; returns how many."""
        with self._mu:
            entries = list(self._entries.values())
            self._entries = OrderedDict()
        for _, _, fut in entries:
            self._drop(fut)
        return len(entries)

    def _drop(self, fut):
        try:
            fut.result()
        except Exception:  # noqa: BLE001 - an abandoned pull's outcome
            from elasticdl_tpu_torch.common.log_utils import (
                default_logger,
            )

            default_logger.debug(
                "an abandoned staged embedding pull failed; dropped",
                exc_info=True,
            )
        self.dropped += 1

    def close(self):
        """Drop what is staged and stop the thread; :meth:`submit`
        raises after it."""
        self.invalidate()
        with self._mu:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class HotRowCache:
    """The worker's LRU of pulled embedding rows, keyed ``(table, id)``,
    at most ``max_rows`` of them.

    Each entry carries the version of the shard it came from; the client
    notes the newest version it has seen of each shard (from pull and
    push replies alike), and an entry more than ``window`` versions
    behind that is a miss (and dropped). A row served from here is
    therefore at most ``window`` of its shard's optimizer steps stale,
    the bound the SSP window (``get_model_steps``) already trains under.
    Push replies note versions from the client's fan-out threads while
    the worker probes, so every method takes one lock. ``hits`` and
    ``misses`` count probes; :meth:`table_stats` splits them, with the
    capacity evictions, by table.
    """

    def __init__(self, max_rows, window=1):
        if max_rows <= 0:
            raise ValueError("max_rows must be positive")
        if window < 0:
            raise ValueError("window must be >= 0")
        self._max_rows = max_rows
        self._window = window
        self._mu = threading.Lock()
        self._rows = OrderedDict()  # (table, id) -> (shard, version, row)
        self._latest = {}  # shard -> newest version seen
        self._table_stats = {}  # table -> [hits, misses, evictions]
        self.hits = 0
        self.misses = 0

    def note_version(self, shard, version):
        """A reply of shard ``shard`` carried ``version``."""
        if version is None or version < 0:
            return
        with self._mu:
            if version > self._latest.get(shard, -1):
                self._latest[shard] = version

    def invalidate_shard(self, shard, version=None):
        """Drop every entry of ``shard`` and set its version clock to
        ``version`` (the relaunched shard's; None forgets the shard):
        the reconnect protocol's part. A restored shard's rows are not
        the dead incarnation's, and the dead one's high-water version
        would make every fresh entry a miss. Returns the entries
        dropped."""
        with self._mu:
            victims = [
                key for key, (entry_shard, _, _) in self._rows.items()
                if entry_shard == shard
            ]
            for key in victims:
                del self._rows[key]
            if version is not None and version >= 0:
                self._latest[shard] = version
            else:
                self._latest.pop(shard, None)
            return len(victims)

    def invalidate_table(self, name, below_version=None):
        """Drop ``name``'s entries tagged below ``below_version`` (all of
        them with None), and nothing else: no other table's rows, no
        version clock. The delta sync's fallback when a table's delta is
        incomplete, which is no relaunch. Tags of every shard are held
        to the one version, which can only drop too much. Returns the
        entries dropped."""
        with self._mu:
            victims = [
                key for key, (_, version, _) in self._rows.items()
                if key[0] == name
                and (below_version is None or version < below_version)
            ]
            for key in victims:
                del self._rows[key]
            return len(victims)

    def refresh_table(self, name, shard, version, changed_ids, since):
        """Apply one table's delta from ``shard``: its entries whose id is
        in ``changed_ids``, or whose tag is below ``since`` (the delta
        says nothing of them), drop; every other entry of (``name``,
        ``shard``) is unchanged through ``version`` and is re-tagged to
        it. The shard's clock moves to ``version``. Returns
        ``(dropped ids, re-tagged count)``: the sync re-pulls the
        dropped ids."""
        changed = {int(i) for i in changed_ids}
        dropped, retagged = [], 0
        with self._mu:
            for key in list(self._rows):
                entry_shard, entry_version, row = self._rows[key]
                if key[0] != name or entry_shard != shard:
                    continue
                if key[1] in changed or entry_version < since:
                    del self._rows[key]
                    dropped.append(key[1])
                else:
                    self._rows[key] = (shard, version, row)
                    retagged += 1
            if version > self._latest.get(shard, -1):
                self._latest[shard] = version
        return dropped, retagged

    def max_live_lag(self):
        """The most versions a hit could lag its shard's newest seen
        version now: the largest ``latest - tag`` over the entries inside
        the window (one past it is a miss). Never above the window: the
        scorer's ``staleness_versions``."""
        with self._mu:
            worst = 0
            for shard, version, _ in self._rows.values():
                lag = self._latest.get(shard, -1) - version
                if 0 < lag <= self._window and lag > worst:
                    worst = lag
            return worst

    def get(self, name, row_id):
        """The cached row, or None (a miss; a stale entry is dropped)."""
        with self._mu:
            return self._get_locked(name, row_id)

    def get_rows(self, name, row_ids):
        """One probe per id under one lock hold; None for each miss."""
        with self._mu:
            return [self._get_locked(name, r) for r in row_ids]

    def _stat_locked(self, name):
        stat = self._table_stats.get(name)
        if stat is None:
            stat = self._table_stats[name] = [0, 0, 0]
        return stat

    def _get_locked(self, name, row_id):
        key = (name, int(row_id))
        entry = self._rows.get(key)
        if entry is not None:
            shard, version, row = entry
            if version < self._latest.get(shard, -1) - self._window:
                del self._rows[key]
                entry = None
        if entry is None:
            self.misses += 1
            self._stat_locked(name)[1] += 1
            return None
        self._rows.move_to_end(key)
        self.hits += 1
        self._stat_locked(name)[0] += 1
        return row

    def put(self, name, row_id, shard, version, row):
        if version is None:
            return  # an unversioned reply: nothing to tag the row with
        with self._mu:
            self._put_locked(name, row_id, shard, version, row)

    def put_rows(self, name, row_ids, shard, version, rows):
        """One pulled batch under one lock hold."""
        if version is None:
            return
        with self._mu:
            for row_id, row in zip(row_ids, rows):
                self._put_locked(name, row_id, shard, version, row)

    def _put_locked(self, name, row_id, shard, version, row):
        key = (name, int(row_id))
        # a copy: the row is a view of the whole reply, which a kept view
        # would pin
        self._rows[key] = (shard, version, np.array(row, np.float32))
        self._rows.move_to_end(key)
        while len(self._rows) > self._max_rows:
            victim, _ = self._rows.popitem(last=False)
            self._stat_locked(victim[0])[2] += 1  # charged to the victim

    def table_stats(self):
        """``{table: {"hits", "misses", "evictions"}}``, copied."""
        with self._mu:
            return {
                name: {"hits": s[0], "misses": s[1], "evictions": s[2]}
                for name, s in self._table_stats.items()
            }

    def __len__(self):
        with self._mu:
            return len(self._rows)
