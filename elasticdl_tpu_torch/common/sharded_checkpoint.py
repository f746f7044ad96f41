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
"""

import glob
import json
import os

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


def save_sharded(directory, leaves, version=0):
    """Write {path: tensor} into ``directory``, one leaf at a time (peak
    host memory is about one leaf), the manifest last."""
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
    for path, value in leaves.items():
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
    kept. Asynchronous writes (``async_io``) are not ported yet."""

    def __init__(
        self, base_dir, checkpoint_steps=0, keep_max=0, async_io=False
    ):
        if async_io:
            raise NotImplementedError(
                "asynchronous checkpoint writes are not ported yet"
            )
        self._base = base_dir
        self._steps = checkpoint_steps
        self._keep_max = keep_max
        self._expected_writers = None

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

    def _evict(self):
        """Drop the oldest versions past ``keep_max``, each only once a
        newer version is complete, so the last restorable state is never
        deleted while a newer one is torn."""
        kept = sorted(self.versions())
        while len(kept) > self._keep_max:
            victim_dir = self._dir_for(kept[0])
            counts = {
                v: self._manifest_count(self._dir_for(v)) for v in kept
            }
            need = self._expected_writers or max(1, *counts.values())
            if not any(counts[v] >= need for v in kept[1:]):
                break
            kept.pop(0)
            for f in glob.glob(os.path.join(victim_dir, "*")):
                os.remove(f)
            os.rmdir(victim_dir)

    def save(self, train_state, version):
        """Write ``train_state`` (a port TrainState) as version
        ``version``; returns the directory."""
        directory = self._dir_for(version)
        save_sharded(directory, train_state_leaves(train_state), version)
        if self._keep_max:
            self._evict()
        return directory

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
