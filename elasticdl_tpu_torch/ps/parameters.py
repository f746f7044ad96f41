"""The parameter store, the port of ``Parameters()`` in
``elasticdl_tpu/ps/parameters.py``: the dense parameters of a PS shard
(``non_embedding_params``, ``{name: float32 ndarray}``) with its
``version`` and ``initialized`` flag, and the embedding tables as
``{layer: EmbeddingTable}``, slot tables named ``"{layer}-{slot}"``.

- ``init_from_model``: the first pushed model initializes the shard
  (first write wins), tables registered first;
- ``check_grad``: a dense gradient must match its parameter's shape, an
  embedding gradient must be indexed and as wide as its table;
- ``to_named_arrays``: a copy of the dense parameters, taken under the
  store's lock;
- ``snapshot_state`` / ``restore_state``: what a shard snapshot
  (``ps/snapshot.py``) persists and restores: version, dense parameters,
  every table with its rows.

The master-held model uses only the tables (its dense model is the
servicer's own).

``device`` (a shard's ``--ps_device``) makes the store device-resident:
the dense parameters are tensors on that device and every table is a
``ps/device_store.DeviceEmbeddingTable`` arena there; a device that is
not there raises, and nothing falls back to the host store.
``tier_config`` (``{"warm_rows": n, "spill_dir": d}``) wraps every table,
rows and slots, in a ``ps/tiered_store.TieredEmbeddingTable`` spilling
to ``d/<table>``; it wraps the arena where both are asked for. Snapshots,
replies and minted rows are the same bits either way.
"""

import os
import threading

import numpy as np
import torch

from elasticdl_tpu_torch.ps.embedding_table import (
    EmbeddingTable,
    get_slot_table_name,
)


def _host(value):
    """A float32 ndarray copy of a dense parameter, host or device."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32, copy=True).numpy()
    return np.array(value, dtype=np.float32)


class EmbeddingTableInfo:
    """What a worker pushes before it uses an elastic embedding layer:
    the table's name, row width and initializer."""

    def __init__(self, name, dim, initializer="uniform"):
        self.name = name
        self.dim = dim
        self.initializer = initializer


class Parameters:
    def __init__(self, device=None, tier_config=None):
        """``device``: None (or False) for the host store; a device name,
        or True for the card, for the device-resident store.
        ``tier_config``: ``{"warm_rows": int, "spill_dir": str}``."""
        from elasticdl_tpu_torch.common.device import resolve_device

        if device is True:
            device = "cuda"
        self.device = resolve_device(device) if device else None
        if tier_config and not (
            int(tier_config.get("warm_rows") or 0) > 0
            and tier_config.get("spill_dir")
        ):
            raise ValueError(
                "tier_config needs a positive warm_rows and a spill_dir, "
                "got %r" % (tier_config,)
            )
        self.tier_config = dict(tier_config) if tier_config else None
        self.version = 0
        self.initialized = False
        self.non_embedding_params = {}
        self.embedding_params = {}
        self._lock = threading.Lock()

    def _new_table(self, name, dim, initializer, is_slot=False):
        if self.device is not None:
            from elasticdl_tpu_torch.ps.device_store import (
                DeviceEmbeddingTable,
            )

            table = DeviceEmbeddingTable(
                name, dim, initializer, is_slot=is_slot, device=self.device
            )
        else:
            table = EmbeddingTable(name, dim, initializer, is_slot=is_slot)
        if self.tier_config:
            from elasticdl_tpu_torch.ps.tiered_store import (
                TieredEmbeddingTable,
            )

            table = TieredEmbeddingTable(
                table,
                spill_dir=os.path.join(
                    self.tier_config["spill_dir"], name.replace("/", "_")
                ),
                warm_rows=int(self.tier_config["warm_rows"]),
            )
        return table

    def _dense_value(self, arr):
        """A dense parameter as the store keeps it: a float32 ndarray, or
        a tensor on the store's device."""
        host = np.array(arr, dtype=np.float32)
        if self.device is None:
            return host
        return torch.from_numpy(host).to(self.device)

    def close(self):
        """Stop the tiered tables' demoters (nothing to stop otherwise)."""
        with self._lock:
            tables = list(self.embedding_params.values())
        for table in tables:
            closer = getattr(table, "close", None)
            if closer is not None:
                closer()

    def get_non_embedding_param(self, name, default=None):
        return self.non_embedding_params.get(name, default)

    def get_embedding_param(self, name, indices):
        if name not in self.embedding_params:
            raise ValueError(
                "Please initialize embedding param %s first!" % name
            )
        return self.embedding_params[name].get(indices)

    def set_embedding_param(self, name, indices, values):
        if name not in self.embedding_params:
            raise ValueError(
                "Please initialize embedding param %s first!" % name
            )
        self.embedding_params[name].set(indices, values)

    def check_grad(self, grad):
        """Validate a ``Tensor`` gradient against what it updates."""
        name = grad.name
        param = self.get_non_embedding_param(name)
        if param is None:
            if name not in self.embedding_params:
                raise ValueError("Name error: %s is not in Parameters" % name)
            if grad.indices is None:
                raise ValueError(
                    "Embedding gradient %s must be indexed" % name
                )
            dim = self.embedding_params[name].dim
            if grad.values.shape[1] != dim:
                raise ValueError(
                    "Incompatible embedding dimension for %s: %d vs %d"
                    % (name, grad.values.shape[1], dim)
                )
            return True
        if grad.indices is not None:
            if grad.values.shape[1] != param.shape[1]:
                raise ValueError(
                    "Incompatible indexed slice dimension for %s" % name
                )
            if int(np.max(grad.indices)) >= param.shape[0]:
                raise ValueError("Grad indices out of range for %s" % name)
        elif tuple(grad.values.shape) != param.shape:
            raise ValueError("Incompatible gradient dimension for %s" % name)
        return True

    def init_from_model(self, version, dense_params, embedding_infos):
        """First write wins: the first pushed model initializes the
        shard. Returns True if this call initialized it."""
        self.init_embedding_params(embedding_infos)
        with self._lock:
            if self.initialized:
                return False
            self.non_embedding_params = {
                name: self._dense_value(arr)
                for name, arr in dense_params.items()
            }
            self.version = max(0, int(version))
            self.initialized = True
            return True

    def init_embedding_params(self, embedding_infos):
        """Create the missing tables; a name that exists always wins. The
        tables are built with no lock held (a tiered table reads its
        segments from disk); one that loses the race is closed."""
        candidates = {
            info.name: self._new_table(info.name, info.dim, info.initializer)
            for info in embedding_infos or ()
            if info.name not in self.embedding_params
        }
        losers = []
        with self._lock:
            for name, table in candidates.items():
                if name in self.embedding_params:
                    losers.append(table)
                else:
                    self.embedding_params[name] = table
        for table in losers:
            closer = getattr(table, "close", None)
            if closer is not None:
                closer()

    def create_slot_params(self, slot_names, init_values):
        """Create a slot table per embedding table for each of
        ``slot_names``, filled lazily with ``init_values[slot]``."""
        embedding_dims = {
            name: table.dim
            for name, table in self.embedding_params.items()
            if not table.is_slot
        }
        for layer_name, dim in embedding_dims.items():
            for slot_name in slot_names:
                key = get_slot_table_name(layer_name, slot_name)
                if key not in self.embedding_params:
                    self.embedding_params[key] = self._new_table(
                        key,
                        dim,
                        initializer=str(init_values.get(slot_name, 0.0)),
                        is_slot=True,
                    )

    def to_named_arrays(self):
        """A host copy of the dense parameters, taken under the lock (an
        async apply rebinds the dict)."""
        with self._lock:
            return {k: _host(v) for k, v in self.non_embedding_params.items()}

    def set_non_embedding_params(self, named):
        """Install the dense parameters an apply produced."""
        with self._lock:
            self.non_embedding_params = named

    # -- durability (ps/snapshot.py) --------------------------------------

    def snapshot_state(self):
        """A self-contained copy of everything a shard snapshot keeps:
        version, initialized, the dense parameters and each table's rows
        with its width, initializer and slot flag."""
        with self._lock:
            version = int(self.version)
            initialized = bool(self.initialized)
            dense = {
                k: _host(v) for k, v in self.non_embedding_params.items()
            }
            tables = list(self.embedding_params.items())
        table_snaps = {}
        for name, table in tables:
            ids, rows = table.snapshot()
            table_snaps[name] = {
                "ids": ids,
                "rows": rows,
                "dim": int(table.dim or 0),
                "initializer": table.initializer_name,
                "is_slot": bool(table.is_slot),
            }
        return {
            "version": version,
            "initialized": initialized,
            "dense": dense,
            "tables": table_snaps,
        }

    def restore_state(self, state):
        """Install a :meth:`snapshot_state` capture (a shard's boot): the
        tables keep their initializers, so rows minted after the restore
        are the ones the crashed shard would have minted. Tiered tables
        are replaced by tables over the same spill directories, so the
        outgoing demoters stop first."""
        if self.tier_config:
            self.close()
        tables = {}
        for name, snap in state["tables"].items():
            table = self._new_table(
                name,
                snap["dim"],
                initializer=snap["initializer"],
                is_slot=snap["is_slot"],
            )
            table.load_snapshot(snap["ids"], snap["rows"])
            tables[name] = table
        dense = {
            k: self._dense_value(v) for k, v in state["dense"].items()
        }
        with self._lock:
            self.non_embedding_params = dense
            self.embedding_params = tables
            self.version = int(state["version"])
            self.initialized = bool(state.get("initialized", True))
