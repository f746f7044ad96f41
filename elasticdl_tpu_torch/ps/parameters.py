"""The host parameter store, the port of ``Parameters()`` in
``elasticdl_tpu/ps/parameters.py``, as the master-held model uses it:
embedding tables as ``{layer: EmbeddingTable}``, slot tables named
``"{layer}-{slot}"``, first-write-wins table registration, and the
embedding gradients' checks.

Not ported, each raising ``NotImplementedError`` by name: the
device-resident store (``Parameters(device=True)``, the reference's
``--ps_device``) and the tiered store (``tier_config``). The dense
parameters, which the reference's PS fleet keeps here, come with that
fleet.
"""

import threading

from elasticdl_tpu_torch.ps.embedding_table import (
    EmbeddingTable,
    get_slot_table_name,
)


class EmbeddingTableInfo:
    """What a worker pushes before it uses an elastic embedding layer:
    the table's name, row width and initializer."""

    def __init__(self, name, dim, initializer="uniform"):
        self.name = name
        self.dim = dim
        self.initializer = initializer


class Parameters:
    """The embedding tables of the master-held model. The dense model is
    the servicer's own (``master/servicer.py``), which also checks dense
    gradients; the reference's dense half of this store serves its PS
    fleet, which is not ported."""

    def __init__(self, device=False, tier_config=None):
        if device:
            raise NotImplementedError(
                "the device-resident parameter store (Parameters(device="
                "True), --ps_device) is not ported yet"
            )
        if tier_config:
            raise NotImplementedError(
                "the tiered embedding store (tier_config, --ps_warm_rows/"
                "--ps_spill_dir) is not ported yet"
            )
        self.embedding_params = {}
        self._lock = threading.Lock()

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
        """Validate an embedding ``Tensor`` gradient: it must name a
        table, be indexed and be as wide as its table."""
        name = grad.name
        if name not in self.embedding_params:
            raise ValueError("Name error: %s is not in Parameters" % name)
        if grad.indices is None:
            raise ValueError("Embedding gradient %s must be indexed" % name)
        dim = self.embedding_params[name].dim
        if grad.values.shape[1] != dim:
            raise ValueError(
                "Incompatible embedding dimension for %s: %d vs %d"
                % (name, grad.values.shape[1], dim)
            )
        return True

    def init_embedding_params(self, embedding_infos):
        """Create the missing tables; a name that exists always wins."""
        with self._lock:
            for info in embedding_infos or ():
                if info.name not in self.embedding_params:
                    self.embedding_params[info.name] = EmbeddingTable(
                        info.name, info.dim, info.initializer
                    )

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
                    self.embedding_params[key] = EmbeddingTable(
                        key,
                        dim,
                        initializer=str(init_values.get(slot_name, 0.0)),
                        is_slot=True,
                    )
