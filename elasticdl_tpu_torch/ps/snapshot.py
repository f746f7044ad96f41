"""A PS shard's snapshots and its restore at relaunch, the port of
``elasticdl_tpu/ps/snapshot.py``, with the same on-disk layout, so a
snapshot the reference wrote restores here (its dense parameters and
row tables; slot tables carry torch's state names here and optax's
there, so those rows do not cross)::

    <ps_snapshot_dir>/ps-{id}/
      epoch.json           # the boot counter (mint_shard_epoch)
      snap_v{N}/
        manifest.json      # written last: version, dense names, tables
        dense.npz          # {name: float32 array}
        table.{i}.npz      # ids and rows of one embedding or slot table

- **Capture at submit.** ``maybe_snapshot`` copies the store
  (``Parameters.snapshot_state``) under the optimizer's apply lock, so
  a snapshot never cuts an apply; only the disk write runs on the
  background thread of ``common/async_checkpoint.AsyncCheckpointer``.
- **Atomic publication.** Everything goes into a ``tmp-`` directory,
  the manifest last, then one ``os.replace`` to ``snap_v{N}``.
- **Newest valid restore.** A boot walks the published snapshots newest
  first and falls through any it cannot read.
- **Shard epochs.** Every boot mints a fresh ``shard_epoch`` (a counter
  in ``epoch.json`` where the shard has a directory), which every reply
  carries, so a client sees the relaunch.

The tiered store's spill segments (``ps/tiered_store.py``) are this
layout too: one table a segment, its generation as the version, written
with :func:`write_shard_snapshot` and read with
:func:`read_shard_snapshot`; :func:`snapshot_versions`,
:func:`snapshot_path` and :func:`remove_snapshot_dir` are what it builds
on.
"""

import contextlib
import glob
import json
import os
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling

_SNAP_PREFIX = "snap_v"
_TMP_PREFIX = "tmp-"
_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def mint_shard_epoch(shard_dir=None):
    """A fresh boot id, different from every earlier one: a counter
    persisted in ``shard_dir`` (read, +1, atomic rewrite), or without one
    a time-derived id."""
    if not shard_dir:
        return int(time.time_ns() % (1 << 53)) or 1
    os.makedirs(shard_dir, exist_ok=True)
    path = os.path.join(shard_dir, "epoch.json")
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


def snapshot_versions(shard_dir):
    """The published (manifest-bearing) versions in ``shard_dir``,
    oldest first."""
    out = []
    for d in glob.glob(os.path.join(shard_dir, _SNAP_PREFIX + "*")):
        if not os.path.isfile(os.path.join(d, _MANIFEST)):
            continue
        try:
            out.append(int(os.path.basename(d)[len(_SNAP_PREFIX):]))
        except ValueError:
            continue
    return sorted(out)


def snapshot_path(shard_dir, version):
    return os.path.join(shard_dir, "%s%d" % (_SNAP_PREFIX, int(version)))


def remove_snapshot_dir(directory):
    """Delete one snapshot (or spill segment) directory; best effort,
    never raises."""
    for f in glob.glob(os.path.join(directory, "*")):
        try:
            os.remove(f)
        except OSError:
            pass
    try:
        os.rmdir(directory)
    except OSError:
        pass


def write_shard_snapshot(shard_dir, state, ps_id=0, shard_epoch=0):
    """Publish one ``Parameters.snapshot_state`` capture atomically;
    returns its directory."""
    version = int(state["version"])
    final = snapshot_path(shard_dir, version)
    tmp = os.path.join(
        shard_dir,
        "%s%s%d.%d" % (_TMP_PREFIX, _SNAP_PREFIX, version, os.getpid()),
    )
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "dense.npz"), **state["dense"])
    tables_meta = []
    for i, (name, snap) in enumerate(sorted(state["tables"].items())):
        np.savez(
            os.path.join(tmp, "table.%d.npz" % i),
            ids=snap["ids"],
            rows=snap["rows"],
        )
        tables_meta.append({
            "name": name,
            "file": "table.%d.npz" % i,
            "dim": int(snap["dim"]),
            "initializer": snap["initializer"],
            "is_slot": bool(snap["is_slot"]),
            "rows": int(np.asarray(snap["ids"]).size),
        })
    manifest = {
        "format": _FORMAT_VERSION,
        "version": version,
        "initialized": bool(state.get("initialized", True)),
        "ps_id": int(ps_id),
        "shard_epoch": int(shard_epoch),
        "dense": sorted(state["dense"]),
        "tables": tables_meta,
        "wrote_unix": round(time.time(), 3),
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(final):
        # the same version again (a drain right after a cadence
        # snapshot): clear the way for the atomic rename
        remove_snapshot_dir(final)
    os.replace(tmp, final)
    return final


def read_shard_snapshot(directory):
    """One published snapshot back in ``snapshot_state`` form; raises on
    any missing or inconsistent piece."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, "dense.npz")) as z:
        dense = {name: z[name] for name in manifest["dense"]}
    tables = {}
    for meta in manifest["tables"]:
        with np.load(os.path.join(directory, meta["file"])) as z:
            ids, rows = z["ids"], z["rows"]
        if ids.shape[0] != meta["rows"] or rows.shape[0] != meta["rows"]:
            raise ValueError(
                "snapshot table %s row count mismatch (%d ids, %d rows, "
                "manifest %d)"
                % (meta["name"], ids.shape[0], rows.shape[0], meta["rows"])
            )
        tables[meta["name"]] = {
            "ids": ids,
            "rows": rows,
            "dim": meta["dim"],
            "initializer": meta["initializer"],
            "is_slot": meta["is_slot"],
        }
    return {
        "version": int(manifest["version"]),
        "initialized": bool(manifest.get("initialized", True)),
        "dense": dense,
        "tables": tables,
    }


class ShardSnapshotter:
    """Snapshots of one shard's ``ps.Parameters`` every
    ``every_versions`` versions (0: off), ``keep`` of them retained; a
    snapshot is evicted only once a newer one is published."""

    def __init__(self, shard_dir, ps_id=0, every_versions=0, keep=2):
        self._dir = shard_dir
        self._ps_id = int(ps_id)
        self._every = max(0, int(every_versions)) if shard_dir else 0
        self._keep = max(1, int(keep))
        self._mu = threading.Lock()
        self._last_submitted = -1
        self._last_published = -1.0  # unix time of the last publish
        self._shard_epoch = 0
        self._async = None
        if self._every:
            os.makedirs(self._dir, exist_ok=True)
            from elasticdl_tpu_torch.common.async_checkpoint import (
                AsyncCheckpointer,
            )

            self._async = AsyncCheckpointer(name="ps-snap-%d" % ps_id)
            # the age is collector-only: a Gauge series beside it would
            # emit a second sample under the same name and labels
            profiling.metrics.register_collector(self._collect_age)

    def _collect_age(self):
        """``edl_ps_snapshot_age_seconds{ps_id}`` at scrape time (none
        before the first publish)."""
        with self._mu:
            last = self._last_published
        if last <= 0:
            return []
        return [(
            "edl_ps_snapshot_age_seconds",
            {"ps_id": str(self._ps_id)},
            round(time.time() - last, 3),
        )]

    @property
    def every_versions(self):
        return self._every

    def set_shard_epoch(self, epoch):
        with self._mu:
            self._shard_epoch = int(epoch)

    def is_enabled(self):
        return self._async is not None

    def maybe_snapshot(self, parameters, apply_lock=None):
        """After a version bump: capture once the version has moved
        ``every_versions`` past the last capture (an interval, not an
        exact multiple, so two concurrent applies cannot skip a mark),
        and queue the write. True if it captured."""
        if not self.is_enabled():
            return False
        version = int(parameters.version)
        with self._mu:
            if version - max(0, self._last_submitted) < self._every:
                return False
            self._last_submitted = version
        state = self._capture(parameters, apply_lock)
        if not state["initialized"]:
            return False
        self._async.submit(
            lambda: self._write(state), label="ps_snap_v%d" % version
        )
        return True

    def snapshot_now(self, parameters, apply_lock=None):
        """Capture and write synchronously (the SIGTERM drain); the
        published directory, or None when off or uninitialized (an empty
        snapshot would make the relaunch ignore the workers' re-push)."""
        if not self.is_enabled():
            return None
        state = self._capture(parameters, apply_lock)
        if not state["initialized"]:
            return None
        with self._mu:
            self._last_submitted = int(state["version"])
        return self._write(state)

    @staticmethod
    def _capture(parameters, apply_lock):
        with apply_lock if apply_lock is not None else (
            contextlib.nullcontext()
        ):
            return parameters.snapshot_state()

    def _write(self, state):
        t0 = time.perf_counter()
        with self._mu:
            epoch = self._shard_epoch
        final = write_shard_snapshot(
            self._dir, state, ps_id=self._ps_id, shard_epoch=epoch
        )
        with self._mu:
            self._last_published = time.time()
        self._evict()
        profiling.events.emit(
            "ps_shard_snapshot",
            ps_id=self._ps_id,
            version=state["version"],
            write_s=round(time.perf_counter() - t0, 4),
        )
        logger.info(
            "ps %d: published snapshot v%d to %s in %.3f s",
            self._ps_id, state["version"], final, time.perf_counter() - t0,
        )
        return final

    def _evict(self):
        versions = snapshot_versions(self._dir)
        while len(versions) > self._keep:
            remove_snapshot_dir(snapshot_path(self._dir, versions.pop(0)))
        for tmp in glob.glob(os.path.join(self._dir, _TMP_PREFIX + "*")):
            # a crashed predecessor's torn write, never restorable
            if os.path.isdir(tmp):
                remove_snapshot_dir(tmp)

    def restore_into(self, parameters):
        """Install the newest snapshot that reads back whole; returns its
        version, or None (off, or nothing restorable). A shard with
        snapshots off never restores a directory's old snapshots: first
        write wins, so it would ignore the workers' model."""
        if not self.is_enabled() or not os.path.isdir(self._dir):
            return None
        t0 = time.perf_counter()
        for version in reversed(snapshot_versions(self._dir)):
            directory = snapshot_path(self._dir, version)
            try:
                state = read_shard_snapshot(directory)
            except Exception as err:  # noqa: BLE001 - fall through older
                logger.warning(
                    "ps %d: snapshot %s unreadable (%s); trying older",
                    self._ps_id, directory, err,
                )
                continue
            parameters.restore_state(state)
            with self._mu:
                self._last_submitted = version
                self._last_published = time.time()
            profiling.events.emit(
                "ps_shard_restore_local",
                ps_id=self._ps_id,
                version=version,
                restore_s=round(time.perf_counter() - t0, 4),
            )
            logger.info(
                "ps %d: restored snapshot v%d (%d dense, %d tables)",
                self._ps_id, version, len(state["dense"]),
                len(state["tables"]),
            )
            return version
        return None

    def wait(self):
        """Block until every queued write is published."""
        if self._async is not None:
            self._async.wait()

    def close(self):
        if self._async is not None:
            profiling.metrics.unregister_collector(self._collect_age)
            self._async.close()
            self._async = None
