"""The embedding service's lookup/update facade, the port of
``elasticdl_tpu/master/embedding_service.py``: keys ``"{layer}-{id}"``
over a ``ps.Parameters`` store, the shape of the original service's
static API (a Redis cluster there; the rows live in the master's store or
on the PS fleet here, as in the reference)."""

import numpy as np

from elasticdl_tpu_torch.ps.parameters import Parameters


class EmbeddingService:
    """``lookup_embedding``/``update_embedding`` over ``parameters`` (a
    fresh host store by default)."""

    def __init__(self, parameters=None):
        self._parameters = parameters or Parameters()

    @property
    def parameters(self):
        return self._parameters

    def lookup_embedding(self, keys):
        """``"{layer}-{id}"`` keys -> (rows, unknown keys). Rows are
        minted lazily, so no key is unknown."""
        values = []
        for key in keys:
            layer, _, row_id = key.rpartition("-")
            values.append(
                self._parameters.get_embedding_param(layer, [int(row_id)])[0]
            )
        return values, []

    def update_embedding(self, keys, values):
        for key, value in zip(keys, values):
            layer, _, row_id = key.rpartition("-")
            self._parameters.set_embedding_param(
                layer, [int(row_id)], np.asarray(value)[None]
            )
