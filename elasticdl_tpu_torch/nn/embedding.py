"""The elastic embedding layer, the port of ``elasticdl_tpu/nn/embedding.py``:
a layer whose table lives outside the worker (the master's store),
unbounded in its vocabulary, that reads only the rows a batch touches
and hands back their gradients; with ``mask_zero`` and the ``sum`` /
``mean`` / ``sqrtn`` combiners.

The lookup is hoisted out of the step, as in the reference:

1. :func:`capture_embedding_ids` runs a forward that stops once every
   elastic layer has been called: each layer records its ids (and its
   declared initializer) and returns zeros, so nothing is pulled;
2. the worker plans one unique-id pull per layer over all its calls
   (``nn/comm_plane.plan_lookup_multi``) and pulls the rows, one per
   unique id;
3. the step binds each layer's rows buffer (a tensor on the card) and its
   per-call position indices (:func:`bind_rows`); inside ``forward`` the
   layer is a plain gather from its buffer. A layer called twice gathers
   from one buffer, so its row gradients add up;
4. autograd gives the gradient of each rows buffer, the batch's row
   gradients per unique id, which the worker sends as indexed slices.

``forward`` never pulls: a layer called with no rows bound raises.
Bindings are per thread.
"""

import contextlib
import threading

import numpy as np
import torch
import torch.nn as nn

_BINDING = threading.local()


class Embedding(nn.Module):
    """Elastic embedding: its rows are per-batch inputs, not parameters.
    ``output_dim`` is the row width; rows materialize lazily in the store
    from ``embedding_initializer`` (``ps/embedding_table.py``)."""

    def __init__(
        self,
        output_dim,
        embedding_initializer="uniform",
        mask_zero=False,
        combiner=None,
    ):
        super().__init__()
        if combiner not in (None, "sum", "mean", "sqrtn"):
            raise ValueError("Unknown combiner %r" % combiner)
        self.output_dim = output_dim
        self.embedding_initializer = embedding_initializer
        self.mask_zero = mask_zero
        self.combiner = combiner

    def forward(self, ids):
        binding = getattr(_BINDING, "current", None)
        if binding is None:
            raise RuntimeError(
                "elastic Embedding called with no rows bound: its rows "
                "come from the parameter-server worker's pull "
                "(nn/embedding.bind_rows), never from forward"
            )
        return binding.lookup(self, ids)

    def init_parameters(self, generator):
        """No parameters: the rows are minted by the store."""
        del generator
        return self

    def output_shape(self, ids_shape):
        if self.combiner is None:
            return tuple(ids_shape) + (self.output_dim,)
        return tuple(ids_shape[:-1]) + (self.output_dim,)

    def combine(self, emb, ids):
        """``mask_zero`` and the combiner over gathered rows ``emb``."""
        if self.mask_zero:
            emb = emb * (ids != 0).to(emb.dtype)[..., None]
        if self.combiner is None:
            return emb
        if self.mask_zero:
            counts = (ids != 0).sum(dim=-1, keepdim=True).clamp(min=1)
        else:
            counts = torch.full(
                ids.shape[:-1] + (1,), ids.shape[-1], device=ids.device
            )
        counts = counts.to(emb.dtype)
        total = emb.sum(dim=-2)
        if self.combiner == "sum":
            return total
        if self.combiner == "mean":
            return total / counts
        return total / torch.sqrt(counts)


def embedding_layers(module):
    """{path name: layer} of ``module``'s elastic Embedding layers, the
    path being the module name (``embedding``, ``tower.0.emb``), the
    store's table name."""
    return {
        name: m for name, m in module.named_modules()
        if isinstance(m, Embedding)
    }


@contextlib.contextmanager
def _bound(binding):
    prev = getattr(_BINDING, "current", None)
    _BINDING.current = binding
    try:
        yield binding
    finally:
        _BINDING.current = prev


class _CaptureDone(Exception):
    """Ends the capture forward once every call has reported."""


class _Capture:
    def __init__(self, module, expected_count, layer_info):
        self.paths = {id(m): p for p, m in embedding_layers(module).items()}
        self.expected_count = expected_count
        self.layer_info = layer_info
        self.captured = {}
        self.calls = 0

    def lookup(self, layer, ids):
        path = self.paths[id(layer)]
        host = (
            ids.detach().to("cpu").numpy()
            if isinstance(ids, torch.Tensor)
            else np.asarray(ids)
        )
        self.captured.setdefault(path, []).append(host)
        self.calls += 1
        if self.layer_info is not None:
            self.layer_info[path] = (
                layer.output_dim, layer.embedding_initializer
            )
        if self.expected_count is not None and (
            self.calls >= self.expected_count
        ):
            raise _CaptureDone()
        device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
        return torch.zeros(layer.output_shape(host.shape), device=device)


def capture_embedding_ids(
    module, params, state, features, expected_count=None, layer_info=None
):
    """{path: [ids ndarray per call, in call order]} of every elastic
    layer in one forward of ``features``. The layers return zeros; with
    ``expected_count`` (the total number of calls) the forward stops at
    the last call, so the layers after the embeddings never run. A dict
    ``layer_info`` is filled with {path: (output_dim, initializer)}."""
    from elasticdl_tpu_torch.nn.model_api import apply_model

    capture = _Capture(module, expected_count, layer_info)
    try:
        with _bound(capture), torch.no_grad():
            apply_model(module, params, state, features, training=False)
    except _CaptureDone:
        pass
    return capture.captured


class _Rows:
    def __init__(self, module, rows, idx):
        self.paths = {id(m): p for p, m in embedding_layers(module).items()}
        self.rows = rows
        self.idx = idx
        self.calls = {}

    def lookup(self, layer, ids):
        path = self.paths[id(layer)]
        i = self.calls.get(path, 0)
        self.calls[path] = i + 1
        slots = self.idx[path]
        if i >= len(slots):
            raise ValueError(
                "Embedding %s called %d times, planned for %d"
                % (path, i + 1, len(slots))
            )
        table = self.rows[path]
        position = slots[i]
        emb = table.index_select(0, position.reshape(-1)).reshape(
            tuple(position.shape) + (table.shape[-1],)
        )
        ids = torch.as_tensor(ids, device=table.device)
        return layer.combine(emb, ids)


@contextlib.contextmanager
def bind_rows(module, rows, idx):
    """For the block, each elastic layer of ``module`` gathers from
    ``rows[path]`` (``(k, dim)``) at ``idx[path][call]`` (its
    call's positions into the buffer, shaped like the ids)."""
    with _bound(_Rows(module, rows, idx)):
        yield
