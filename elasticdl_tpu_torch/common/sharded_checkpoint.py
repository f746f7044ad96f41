"""Sharded checkpoints, in the layout of
``elasticdl_tpu/common/sharded_checkpoint.py``: one directory per
version, each process writing the array shards it holds plus a JSON
manifest, written last and renamed into place so that a crash mid-save
leaves a directory without a manifest, which restores skip::

    ckpt_v{N}/
      manifest-{proc}.json   # leaves this process wrote: shape, dtype,
                             #   per-shard global index -> data file
      shard files *.npy      # one per (leaf, shard)

A process writes one shard per leaf it holds (``<path>.p<proc>.s0.npy``)
with the part's global index: on one device process 0 writes every
leaf whole; over a tensor-parallel world each rank writes its part of a
split leaf, and a replicated leaf is written once, by the rank that
holds its first replica (``parallel/trainer.py``). A restore assembles
any part of a leaf from the shards that cover it (:class:`_LeafReader`,
the reference's), so a checkpoint written over T ranks restores onto
any other T. A leaf whose dim 0 the elastic plane zero-pads to a world
size (``PadDim0``: deepfm_edl's vocabulary-split tables and their
optimizer slots) is stored padded, its manifest entry recording the
logical rows (``logical_dim0``): a restore into another padding reads
only the logical rows and zeros past them, and a host load clips the
padding off. bfloat16 is stored as its uint16 bits and read back by
view, without ``ml_dtypes``.

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
PROCESS_INDEX = 0  # the writer on one device


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


def write_snapshot(directory, entries, version=0, process_index=None,
                   layout=None, logical_dim0=None):
    """Phase 2 of a save: write ``entries`` ((path, tensor) pairs, a
    snapshot list or a lazy iterable) into ``directory``, one leaf at a
    time (peak host memory is about one leaf beyond the entries), the
    manifest last, as ``manifest-<process_index>.json``. ``layout``
    ({path: (global shape, this part's slices)}) places a part in its
    leaf; a leaf it does not name is whole. ``logical_dim0`` ({path:
    rows}) records the true rows of a leaf whose dim 0 this world
    zero-pads (``PadDim0``): a host load clips the padding off, and a
    restore into another padding reads only the logical rows."""
    os.makedirs(directory, exist_ok=True)
    pid = PROCESS_INDEX if process_index is None else int(process_index)
    layout = layout or {}
    logical_dim0 = logical_dim0 or {}
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
        shape, slices = layout.get(path, (arr.shape, None))
        if slices is None:
            slices = [slice(0, int(d)) for d in arr.shape]
        entry = manifest["leaves"][path] = {
            "shape": [int(d) for d in shape],
            "dtype": dtype,
            "shards": [{
                "slices": [[int(sl.start), int(sl.stop)] for sl in slices],
                "file": fname,
            }],
        }
        if path in logical_dim0:
            entry["logical_dim0"] = int(logical_dim0[path])
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


def save_sharded(directory, leaves, version=0, process_index=None,
                 layout=None, logical_dim0=None):
    """Write {path: tensor} into ``directory`` synchronously: each leaf
    is copied to the host as it is written (``process_index``,
    ``layout`` and ``logical_dim0`` as in :func:`write_snapshot`)."""
    write_snapshot(directory, leaves.items(), version, process_index, layout,
                   logical_dim0)


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
            if "logical_dim0" in entry:
                merged["logical_dim0"] = entry["logical_dim0"]
    return version, leaves


def _index_to_slices(index, shape):
    """Normalized [(start, stop), ...] of a part's global index."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else sl.start
        stop = dim if sl.stop is None else sl.stop
        out.append((int(start), int(stop)))
    return out


class _LeafReader:
    """Assembles any requested part of a leaf from its shard files."""

    def __init__(self, directory, entry):
        self._dir = directory
        self._entry = entry
        self._cache = {}

    def _shard_array(self, fname):
        if fname not in self._cache:
            self._cache[fname] = np.load(os.path.join(self._dir, fname))
        return self._cache[fname]

    def read(self, index):
        """The part ``index`` (a slice per dim) of the leaf as a CPU
        tensor; raises when the shards do not cover it (a torn or
        partial checkpoint). The part may reach past the stored rows, or
        past the logical rows of a padded leaf (another world's
        padding): those rows read zero, and only the logical rows are
        read from the files."""
        entry = self._entry
        want = _index_to_slices(index, entry["shape"])
        dtype = np.uint16 if entry["dtype"] == "bfloat16" else entry["dtype"]
        out = np.zeros([stop - start for start, stop in want], dtype=dtype)
        # the extent that holds data: the stored shape, dim 0 clipped to
        # the logical rows
        extent = [int(d) for d in entry["shape"]]
        if extent and "logical_dim0" in entry:
            extent[0] = min(extent[0], int(entry["logical_dim0"]))
        want_in = [(ws, max(ws, min(we, d)))
                   for (ws, we), d in zip(want, extent)]
        covered = 0
        for shard in entry["shards"]:
            have = [tuple(sl) for sl in shard["slices"]]
            inter = [
                (max(ws, hs), min(we, he))
                for (ws, we), (hs, he) in zip(want_in, have)
            ]
            if any(s >= e for s, e in inter):
                continue
            src = self._shard_array(shard["file"])
            src_sl = tuple(
                slice(s - hs, e - hs) for (s, e), (hs, _) in zip(inter, have)
            )
            dst_sl = tuple(
                slice(s - ws, e - ws) for (s, e), (ws, _) in zip(inter, want)
            )
            out[dst_sl] = src[src_sl]
            covered += int(np.prod([e - s for s, e in inter], dtype=np.int64))
        total = int(np.prod([e - s for s, e in want_in], dtype=np.int64))
        if covered < total:
            raise ValueError(
                "checkpoint shards cover %d/%d elements of the requested "
                "part (missing process manifests?)" % (covered, total)
            )
        return _to_tensor(out, entry["dtype"])


def load_sharded_to_host(directory, parts=None, prefix=""):
    """(version, {path: CPU tensor}) of a checkpoint directory: every
    leaf whole (a padded leaf clipped to its logical rows), or the part
    ``parts[path]`` (a slice per dim) of a leaf that ``parts`` names;
    with ``prefix`` (``"params/"``), only the leaves whose path starts
    with it."""
    version, leaves = _merged_manifest(directory)
    parts = parts or {}
    out = {}
    for path, entry in leaves.items():
        if not path.startswith(prefix):
            continue
        index = parts.get(path)
        if index is None:
            shape = list(entry["shape"])
            if shape and "logical_dim0" in entry:
                shape[0] = min(shape[0], int(entry["logical_dim0"]))
            index = tuple(slice(0, d) for d in shape)
        out[path] = _LeafReader(directory, entry).read(index)
    return version, out


def leaf_shapes(directory):
    """{path: global shape} of a checkpoint's leaves as stored (a padded
    leaf with its padding), from its manifests alone."""
    return {
        path: tuple(entry["shape"])
        for path, entry in _merged_manifest(directory)[1].items()
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
        self._logical_dim0 = None
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

    def set_logical_dim0(self, by_path):
        """{leaf path: logical rows} of the leaves this world pads, for
        the manifests of the saves that follow (None: none padded)."""
        self._logical_dim0 = dict(by_path) if by_path else None

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

    def save(self, train_state, version, parts=None):
        """Write ``train_state`` (a port TrainState) as version
        ``version``; returns the directory. ``parts`` (``(leaves,
        layout, process index)``, a sharded trainer's
        ``checkpoint_parts()``) writes this process's parts instead.
        Asynchronously, it returns once the snapshot is on the host."""
        directory = self._dir_for(version)
        if parts is None:
            leaves, layout, pid = train_state_leaves(train_state), None, None
        else:
            leaves, layout, pid = parts
        expected = self._expected_writers
        logical = self._logical_dim0
        if self._async is None:
            t0 = time.perf_counter()
            save_sharded(directory, leaves, version, pid, layout, logical)
            self.write_seconds[version] = time.perf_counter() - t0
            if self._keep_max:
                self._evict(expected)
            return directory
        snap = snapshot_leaves(leaves)

        def write():
            t0 = time.perf_counter()
            write_snapshot(directory, snap, version, pid, layout, logical)
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
