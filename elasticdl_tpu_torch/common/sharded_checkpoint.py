"""Sharded checkpoints, in the layout of
``elasticdl_tpu/common/sharded_checkpoint.py``: one directory per
version, each process writing the array shards it holds plus a JSON
manifest, written last and renamed into place so that a crash mid-save
leaves a directory without a manifest, which restores skip::

    ckpt_v{N}/
      manifest-{proc}.json   # leaves this process wrote: shape, dtype,
                             #   per-shard global index -> data file
      shard files *.npy      # one per (leaf, shard)

The port trains on one device, so it writes one process's manifest and
one shard per leaf (``<path>.p0.s0.npy``). bfloat16 is stored as its
uint16 bits and read back by view, without ``ml_dtypes``.

A train state's leaves are named ``params/<name>``, ``state/<name>``
(BatchNorm statistics), ``opt_state/<param name>/<slot>`` (the torch
optimizer's per-parameter state: SGD's ``momentum_buffer``, AdamW's
``exp_avg``/``exp_avg_sq``/``step``) and ``version``.
:class:`ShardedCheckpointManager` keeps the reference's cadence and ring
retention, and evicts a version only once a newer one is complete.

A save is the reference's two phases: a snapshot of the leaves on the
host, then :func:`write_snapshot`, pure file IO. The synchronous path
(:func:`save_sharded`) feeds the writer one leaf at a time, each copied
to the host as it is written. With ``async_io`` the manager first takes
the whole snapshot (:func:`snapshot_leaves`: every device-to-host copy
queued into pinned memory, then one wait on a CUDA event) and writes it
on a background thread (``common/async_checkpoint.py``); the files are
byte-identical either way.
"""

import glob
import json
import os
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import default_logger as logger

_MANIFEST_PREFIX = "manifest-"
PROCESS_INDEX = 0  # one process holds the whole state


def _to_numpy(t):
    """(array to save, dtype name) of a tensor."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr, dtype_name):
    # np.array, not np.ascontiguousarray: that makes a 0-d array 1-d
    arr = np.array(arr, order="C")
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def train_state_leaves(ts):
    """A port ``TrainState`` -> {path: tensor} (see the module doc)."""
    leaves = {"params/" + n: p for n, p in ts.params.items()}
    leaves.update({"state/" + n: b for n, b in (ts.state or {}).items()})
    names = list(ts.params)
    opt_state = ts.opt_state.state_dict()["state"]
    for idx, slots in opt_state.items():
        for slot, value in slots.items():
            if value is None:
                continue
            if not isinstance(value, torch.Tensor):
                value = torch.tensor(value)
            leaves["opt_state/%s/%s" % (names[idx], slot)] = value
    leaves["version"] = torch.tensor(int(ts.version), dtype=torch.int64)
    return leaves


def split_train_state_leaves(leaves, param_names):
    """{path: tensor} -> (params, state, optimizer state by parameter
    index, version): the parts a trainer rebuilds its state from."""
    params, state, opt = {}, {}, {}
    index = {n: i for i, n in enumerate(param_names)}
    for path, value in leaves.items():
        head, _, rest = path.partition("/")
        if head == "params":
            params[rest] = value
        elif head == "state":
            state[rest] = value
        elif head == "opt_state":
            name, _, slot = rest.rpartition("/")
            opt.setdefault(index[name], {})[slot] = value
    return params, state, opt, int(leaves["version"])


def snapshot_leaves(leaves):
    """Phase 1 of an asynchronous save: {path: tensor} -> [(path, host
    tensor)], owned copies that later in-place updates cannot reach.

    Every copy of a card tensor is queued first, into pinned host memory
    with ``non_blocking=True``, so the transfers overlap; one CUDA event
    recorded after them is waited on before returning. The wait is what
    makes the snapshot safe: the optimizer updates the parameters in
    place, and a copy still in flight when the next step runs would
    write torn state. A host tensor is cloned."""
    snap, streams = [], {}
    for path, value in leaves.items():
        t = value.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            streams.setdefault(t.device, torch.cuda.current_stream(t.device))
        else:
            host = t.clone()
        snap.append((path, host))
    for stream in streams.values():
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
    return snap


def write_snapshot(directory, entries, version=0):
    """Phase 2 of a save: write ``entries`` ((path, tensor) pairs, a
    snapshot list or a lazy iterable) into ``directory``, one leaf at a
    time (peak host memory is about one leaf beyond the entries), the
    manifest last."""
    os.makedirs(directory, exist_ok=True)
    pid = PROCESS_INDEX
    # clear this process's files of an earlier write to the directory
    for stale in glob.glob(
        os.path.join(directory, "*.p%d.s*.npy" % pid)
    ) + glob.glob(os.path.join(directory, "%s%d.json" % (_MANIFEST_PREFIX, pid))):
        try:
            os.remove(stale)
        except OSError:
            pass
    manifest = {"version": int(version), "leaves": {}}
    for path, value in entries:
        arr, dtype = _to_numpy(value)
        fname = "%s.p%d.s0.npy" % (path.replace("/", "."), pid)
        np.save(os.path.join(directory, fname), arr)
        manifest["leaves"][path] = {
            "shape": list(arr.shape),
            "dtype": dtype,
            "shards": [
                {"slices": [[0, int(d)] for d in arr.shape], "file": fname}
            ],
        }
    manifest_path = os.path.join(
        directory, "%s%d.json" % (_MANIFEST_PREFIX, pid)
    )
    tmp_path = manifest_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_path, manifest_path)
    logger.info(
        "sharded checkpoint: process %d wrote %d leaves to %s",
        pid,
        len(manifest["leaves"]),
        directory,
    )


def save_sharded(directory, leaves, version=0):
    """Write {path: tensor} into ``directory`` synchronously: each leaf
    is copied to the host as it is written."""
    write_snapshot(directory, leaves.items(), version)


def _merged_manifest(directory):
    version, leaves = 0, {}
    paths = sorted(
        glob.glob(os.path.join(directory, _MANIFEST_PREFIX + "*.json"))
    )
    if not paths:
        raise FileNotFoundError("no checkpoint manifests in %s" % directory)
    for p in paths:
        with open(p) as f:
            m = json.load(f)
        version = max(version, m["version"])
        for leaf_path, entry in m["leaves"].items():
            merged = leaves.setdefault(
                leaf_path,
                {"shape": entry["shape"], "dtype": entry["dtype"], "shards": []},
            )
            merged["shards"].extend(entry["shards"])
    return version, leaves


def _read_leaf(directory, entry):
    """The full array of one leaf, assembled from its shard files; raises
    when the shards do not cover it (a torn or partial checkpoint)."""
    shape = entry["shape"]
    dtype = np.uint16 if entry["dtype"] == "bfloat16" else entry["dtype"]
    out = np.zeros(shape, dtype=dtype)
    covered = 0
    for shard in entry["shards"]:
        src = np.load(os.path.join(directory, shard["file"]))
        dst = tuple(slice(s, e) for s, e in shard["slices"])
        out[dst] = src
        covered += int(np.prod([e - s for s, e in shard["slices"]]))
    total = int(np.prod(shape))
    if covered < total:
        raise ValueError(
            "checkpoint shards cover %d/%d elements (missing process "
            "manifests?)" % (covered, total)
        )
    return _to_tensor(out, entry["dtype"])


def load_sharded_to_host(directory):
    """(version, {path: CPU tensor}) of a checkpoint directory."""
    version, leaves = _merged_manifest(directory)
    return version, {
        path: _read_leaf(directory, entry) for path, entry in leaves.items()
    }


class ShardedCheckpointManager:
    """Ring-retention directory manager: a checkpoint every
    ``checkpoint_steps`` versions, the newest ``keep_max`` directories
    kept.

    With ``async_io=True`` a save blocks only for the device-to-host
    snapshot; the file writes and the ring eviction run on a background
    thread, and ``write_seconds[version]`` records each write's duration.
    Call :meth:`wait` before restoring, :meth:`close` at teardown."""

    def __init__(
        self, base_dir, checkpoint_steps=0, keep_max=0, async_io=False
    ):
        self._base = base_dir
        self._steps = checkpoint_steps
        self._keep_max = keep_max
        self._expected_writers = None
        self._async = None
        self.write_seconds = {}
        if async_io:
            from elasticdl_tpu_torch.common.async_checkpoint import (
                AsyncCheckpointer,
            )

            self._async = AsyncCheckpointer()

    def set_expected_writers(self, n):
        """Processes writing each version: the bar a newer version must
        meet before an older one is evicted."""
        self._expected_writers = max(1, int(n)) if n else None

    @property
    def steps(self):
        return self._steps

    def is_enabled(self):
        return bool(self._steps)

    def _dir_for(self, version):
        return os.path.join(self._base, "ckpt_v%d" % version)

    def _manifest_count(self, directory):
        return len(
            glob.glob(os.path.join(directory, _MANIFEST_PREFIX + "*.json"))
        )

    def _evict(self, expected_writers):
        """Drop the oldest versions past ``keep_max``, each only once a
        newer version is complete, so the last restorable state is never
        deleted while a newer one is torn. ``expected_writers`` travels
        with the save it belongs to: an asynchronous write may land after
        the worker set a new world's count."""
        kept = sorted(self.versions())
        while len(kept) > self._keep_max:
            victim_dir = self._dir_for(kept[0])
            counts = {
                v: self._manifest_count(self._dir_for(v)) for v in kept
            }
            need = expected_writers or max(1, *counts.values())
            if not any(counts[v] >= need for v in kept[1:]):
                break
            kept.pop(0)
            for f in glob.glob(os.path.join(victim_dir, "*")):
                os.remove(f)
            os.rmdir(victim_dir)

    def save(self, train_state, version):
        """Write ``train_state`` (a port TrainState) as version
        ``version``; returns the directory. Asynchronously, it returns
        once the snapshot is on the host."""
        directory = self._dir_for(version)
        leaves = train_state_leaves(train_state)
        expected = self._expected_writers
        if self._async is None:
            t0 = time.perf_counter()
            save_sharded(directory, leaves, version)
            self.write_seconds[version] = time.perf_counter() - t0
            if self._keep_max:
                self._evict(expected)
            return directory
        snap = snapshot_leaves(leaves)

        def write():
            t0 = time.perf_counter()
            write_snapshot(directory, snap, version)
            self.write_seconds[version] = time.perf_counter() - t0
            if self._keep_max:
                self._evict(expected)

        self._async.submit(write, label="ckpt_v%d" % version)
        return directory

    def wait(self):
        """Land the in-flight asynchronous saves (a no-op when
        synchronous); raises the first write error."""
        if self._async is not None:
            self._async.wait()

    def close(self):
        if self._async is not None:
            self._async.close()
            self._async = None

    def versions(self):
        """Versions with at least one complete manifest."""
        out = []
        for d in glob.glob(os.path.join(self._base, "ckpt_v*")):
            if not glob.glob(os.path.join(d, _MANIFEST_PREFIX + "*.json")):
                continue
            try:
                out.append(int(os.path.basename(d)[len("ckpt_v"):]))
            except ValueError:
                continue
        return sorted(out)

    def dirs_newest_first(self):
        """Candidate restore directories, newest first: callers fall
        through to an older one when a newer one does not load."""
        return [
            self._dir_for(v) for v in sorted(self.versions(), reverse=True)
        ]
