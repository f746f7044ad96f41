"""The scorer's delta sync, the port of
``elasticdl_tpu/serving/delta_sync.py``: it keeps the scorer's hot-row
cache fresh from the live PS fleet.

The scorer reads embedding rows through a ``nn/comm_plane.HotRowCache``
whose window bounds every hit to ``--serving_staleness_versions`` shard
versions behind the newest version seen. Without a delta feed that bound
holds only by attrition: each version advance ages every entry of the
shard, so under training the cache churns on exactly the head rows it is
there for. Each round this sync, per shard:

- polls ``serving_status`` (each table's newest written version, the
  shard's ``shard_epoch``);
- for a table that moved, pulls ``pull_embedding_delta`` (the ids written
  since its sync point) and calls ``HotRowCache.refresh_table``: those
  rows drop (and are pulled again, hot), every other entry is re-tagged
  to the shard's version;
- re-tags a table that did not move the same way (every apply is noted,
  so no noted update means no row moved);
- on an incomplete delta (the shard's log was pruned past the sync
  point) drops only that table's stale rows (``invalidate_table``);
- on a new ``shard_epoch`` (a relaunch) starts the shard's sync points
  afresh: the client's reconnect protocol has already dropped the
  shard's entries inside ``serving_status``;
- notes the shard's version on the cache, so entries age against the
  real clock even while no request pulls.

Both reads are idempotent, so the scorer's channels resend them, and a
round that fails on every shard doubles the interval up to
``max_interval_s``.
"""

import threading

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


class EmbeddingDeltaSync:
    """A background poller over one ``PSClient`` and its cache.
    ``refresh_rows`` pulls the dropped (hot) rows again in the same
    round, so the head rows stay cached across updates."""

    def __init__(self, ps_client, cache, interval_s=0.5, max_interval_s=8.0,
                 refresh_rows=True):
        self._client = ps_client
        self._cache = cache
        self._interval = float(interval_s)
        self._max_interval = max(float(max_interval_s), self._interval)
        self._refresh_rows = bool(refresh_rows)
        self._mu = threading.Lock()
        self._synced = {}  # shard -> {table: newest version reflected}
        self._epochs = {}  # shard -> last shard_epoch seen
        self._stop = threading.Event()
        self._thread = None
        self.rounds = 0
        self.rows_dropped = 0
        self.rows_retagged = 0
        self.rows_refreshed = 0
        self.tables_invalidated = 0
        self.last_error = None

    def sync_once(self):
        """One round over every shard -> ``{shards_ok, shards_failed}``.
        Also called directly (tests, a warm-up), so every field it
        changes is changed under the lock."""
        ok = failed = 0
        for shard in range(self._client.num_ps):
            try:
                self._sync_shard(shard)
                ok += 1
            except Exception as err:  # noqa: BLE001 - counted, backed off
                failed += 1
                with self._mu:
                    self.last_error = str(err)
                logger.debug("delta sync of shard %d failed: %s", shard, err)
        with self._mu:
            self.rounds += 1
        return {"shards_ok": ok, "shards_failed": failed}

    def _sync_point(self, shard, epoch, table):
        """``table``'s sync point on ``shard``; a new epoch forgets the
        shard's points first (the dead incarnation's clock means nothing
        to the restored one)."""
        with self._mu:
            if self._epochs.get(shard) != epoch:
                self._epochs[shard] = epoch
                self._synced[shard] = {}
            return self._synced.setdefault(shard, {}).get(table)

    def _set_sync_point(self, shard, table, version):
        with self._mu:
            self._synced.setdefault(shard, {})[table] = int(version)

    def _count(self, **deltas):
        with self._mu:
            for field, n in deltas.items():
                setattr(self, field, getattr(self, field) + n)

    def _sync_shard(self, shard):
        status = self._client.serving_status(shard)
        epoch = status.get("shard_epoch")
        shard_version = int(status.get("version", -1))
        for table, last in status["tables"].items():
            prev = self._sync_point(shard, epoch, table)
            if prev is None:
                # the baseline: entries cached before it keep their pull
                # tags, and refresh_table drops those below it
                prev = int(last)
                self._set_sync_point(shard, table, prev)
            changed = np.zeros((0,), np.int64)
            covered = prev
            if int(last) > prev:
                ids, covered, complete = self._client.pull_embedding_delta(
                    shard, table, prev
                )
                if not complete:
                    dropped = self._cache.invalidate_table(
                        table, below_version=covered
                    )
                    self._count(tables_invalidated=1, rows_dropped=dropped)
                    self._set_sync_point(shard, table, covered)
                    continue
                changed = ids
            # re-tag up to the shard's version, not the table's newest
            # write: the table's rows are unchanged through it, and a
            # quiet table's entries would otherwise age out on the other
            # tables' advances
            dropped_ids, retagged = self._cache.refresh_table(
                table, shard, max(shard_version, int(covered)), changed,
                since=prev,
            )
            self._count(rows_dropped=len(dropped_ids), rows_retagged=retagged)
            self._set_sync_point(shard, table, covered)
            if self._refresh_rows and dropped_ids:
                # the pull puts them back tagged with its reply's version
                self._client.pull_embedding_vectors(
                    table, np.asarray(dropped_ids, dtype=np.int64)
                )
                self._count(rows_refreshed=len(dropped_ids))
        if shard_version >= 0 and self._cache is not None:
            self._cache.note_version(shard, shard_version)

    def synced_versions(self):
        """{shard: {table: version}}, copied."""
        with self._mu:
            return {s: dict(t) for s, t in self._synced.items()}

    def start(self):
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="edl-delta-sync"
            )
            self._thread.start()

    def _run(self):
        interval = self._interval
        while not self._stop.wait(interval):
            try:
                result = self.sync_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.warning("delta sync round failed", exc_info=True)
                result = {"shards_ok": 0}
            if result.get("shards_ok"):
                interval = self._interval
            else:
                interval = min(interval * 2.0, self._max_interval)

    def stop(self):
        self._stop.set()
        with self._mu:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)

    def staleness_gauge(self):
        """The cache's ``max_live_lag`` (0 without a cache)."""
        return self._cache.max_live_lag() if self._cache is not None else 0
