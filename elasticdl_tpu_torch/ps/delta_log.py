"""Which rows of each embedding table every optimizer version wrote, the
port of ``elasticdl_tpu/ps/delta_log.py``: the scorer's freshness feed.

A scorer serves rows read through its ``HotRowCache`` from the live
shards. Without this log every version advance ages every cached entry
of the shard, so under training the whole cache churns although a
power-law workload rewrites only the head rows. The shard notes each
apply's ids here, and ``serving_status``/``pull_embedding_delta``
(``ps/servicer.py``) answer "what moved since version S": the scorer
drops or refreshes exactly those rows and re-tags every other entry
fresh (``serving/delta_sync.py``).

Bounded: at most ``keep_versions`` entries and ``max_rows`` ids per
table. A since-version below the pruned floor is answered with
``complete=False``, and the scorer drops that table's stale rows
instead of trusting a partial answer.

``note`` runs on the servicer's apply path and the reads on its handler
threads; all of them take one lock, and none does IO.
"""

import threading
from collections import deque

import numpy as np


def _host_ids(ids):
    """A copy of ``ids`` as a flat int64 numpy array: a torch tensor (on
    the card under ``--ps_device``) crosses to the host in one copy."""
    if hasattr(ids, "detach"):
        ids = ids.detach().to("cpu").numpy()
    return np.array(ids, dtype=np.int64, copy=True).reshape(-1)


class DeltaLog:
    def __init__(self, base_version=0, keep_versions=1024, max_rows=1 << 20):
        if keep_versions <= 0:
            raise ValueError("keep_versions must be positive")
        self._keep = int(keep_versions)
        self._max_rows = int(max_rows)
        self._base = int(base_version)
        self._mu = threading.Lock()
        self._entries = {}  # table -> deque[(version, ids)], oldest first
        self._rows = {}  # table -> ids retained
        # table -> the oldest since-version answered completely; at boot
        # the base: everything older predates this incarnation's log
        self._floor = {}
        self._last = {}  # table -> newest version with a noted update

    def note(self, table, ids, version):
        """``ids`` of ``table`` were written at ``version``; an empty
        update is dropped. The ids are copied: an async apply hands over
        a view of the request's buffer."""
        ids = _host_ids(ids)
        if ids.size == 0:
            return
        version = int(version)
        with self._mu:
            q = self._entries.setdefault(table, deque())
            self._floor.setdefault(table, self._base)
            q.append((version, ids))
            self._rows[table] = self._rows.get(table, 0) + ids.size
            if version > self._last.get(table, -1):
                self._last[table] = version
            while len(q) > self._keep or self._rows[table] > self._max_rows:
                old_version, old_ids = q.popleft()
                self._rows[table] -= old_ids.size
                # since(S) needs every entry above S: a dropped entry
                # makes every S below its version unanswerable
                if old_version > self._floor[table]:
                    self._floor[table] = old_version

    def since(self, table, since_version):
        """``(unique ids written after since_version, covered version,
        complete)``. ``covered`` is the newest version the answer covers
        (``since_version`` when nothing moved); ``complete`` is False
        when ``since_version`` lies below the retained window, and the
        caller must take the whole table as moved."""
        since_version = int(since_version)
        with self._mu:
            q = self._entries.get(table)
            floor = self._floor.get(table, self._base)
            last = self._last.get(table, -1)
            if since_version < floor:
                return (np.zeros((0,), np.int64),
                        max(last, since_version), False)
            if not q:
                return np.zeros((0,), np.int64), since_version, True
            chunks = [ids for v, ids in q if v > since_version]
        if not chunks:
            return np.zeros((0,), np.int64), since_version, True
        return (np.unique(np.concatenate(chunks)),
                max(last, since_version), True)

    def table_versions(self):
        """{table: newest version with a noted update}."""
        with self._mu:
            return dict(self._last)

    def floors(self):
        """{table: oldest since-version answered completely}."""
        with self._mu:
            return {t: self._floor.get(t, self._base) for t in self._entries}
