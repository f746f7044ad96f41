"""Tensor-parallel rules and batch specs, the counterpart of
``elasticdl_tpu/parallel/sharding.py``.

The reference maps the transformer's parameter pytree onto a ``data x
model x seq`` mesh by name patterns over the flax paths, and XLA splits
the arrays by the specs. The port's rules name the same parameters by
their ``state_dict`` keys, on the ``nn.Linear`` layouts that
``common/convert.py`` maps the flax kernels to:

- ``query``/``key``/``value.weight`` (H*Dh, D): dim 0, the heads. The
  rows are head-major (flax's (D, H, Dh) kernel flattened), so an even
  cut of dim 0 is H/T whole heads (the reference's ``P(None, "model",
  None)``);
- ``out.weight`` (D, H*Dh): dim 1, the heads (``P("model", None,
  None)`` on (H, Dh, D));
- ``mlp_up.weight`` (F, D) and ``mlp_up.bias`` (F,): dim 0, the hidden
  units; ``mlp_down.weight`` (D, F): dim 1;
- ``embed.weight`` (V, D): dim 0, the vocabulary (the tied head too).

Anything the rules do not name replicates: the RMSNorm scales,
``mlp_down.bias``, a mixture of experts' gate and stacks.

Each rank of a :class:`~elasticdl_tpu_torch.parallel.mesh.WorldMesh`
holds its part of a split parameter (:func:`shard_params`); the model
over such a mesh (``model_zoo/transformer_lm``) builds its layers at
those shapes.
"""

import torch

from elasticdl_tpu_torch.parallel.mesh import PartitionSpec as P
from elasticdl_tpu_torch.parallel.mesh import (
    axis_of,
    flatten_specs,
    shard_slices,
)

# the rules as the nested suffix specs a zoo's ``param_shardings``
# returns: a parameter whose name ends with a key path gets that key's
# spec (``parallel/mesh.resolve_specs``)
_TP_SUFFIX_SPECS = {
    "query": {"weight": P("model", None)},
    "key": {"weight": P("model", None)},
    "value": {"weight": P("model", None)},
    "out": {"weight": P(None, "model")},
    "mlp_up": {"weight": P("model", None), "bias": P("model")},
    "mlp_down": {"weight": P(None, "model")},
    "embed": {"weight": P("model", None)},
}
_TP_RULES = flatten_specs(_TP_SUFFIX_SPECS)  # {key path: spec}


def tp_param_specs():
    """The TP rules as nested suffix specs; a fresh copy each call."""
    return {k: dict(v) for k, v in _TP_SUFFIX_SPECS.items()}


def tp_degree_candidates(model_dim_sizes, max_degree=None):
    """The TP degrees a model admits: each degree that divides every
    model-split dim (heads, MLP hidden, vocabulary), ascending, 1
    always included."""
    dims = sorted({int(d) for d in model_dim_sizes if int(d) > 0})
    if not dims:
        return (1,)
    limit = dims[0]
    if max_degree:
        limit = min(limit, int(max_degree))
    return tuple(
        deg for deg in range(1, limit + 1) if all(d % deg == 0 for d in dims)
    )


def _drop_missing_axes(spec, mesh):
    axes = set(mesh.axis_names)
    return P(*(a if a in axes else None for a in spec))


def param_spec(name, mesh):
    """The spec of the parameter ``name`` on ``mesh`` (the TP rules; a
    replicated ``P()`` for a name they do not match)."""
    for key, spec in _TP_RULES.items():
        if name == key or name.endswith("." + key):
            return _drop_missing_axes(spec, mesh)
    return P()


def shard_params(mesh, state_dict, specs=None):
    """This rank's part of each tensor of a whole ``state_dict`` by
    ``specs`` ({name: spec}; a name it lacks stays whole) or, without
    it, by the TP rules. Views of the whole tensors; a ``PadDim0``
    tensor whose dim 0 the mesh does not divide is zero-padded first."""
    from elasticdl_tpu_torch.parallel.mesh import PadDim0, padded_dim0

    def spec(name):
        if specs is None:
            return param_spec(name, mesh)
        return specs.get(name) or P()

    out = {}
    for name, t in state_dict.items():
        sp = spec(name)
        if isinstance(sp, PadDim0):
            rows = padded_dim0(t.shape[0], sp, mesh.shape)
            if rows != t.shape[0]:
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                              + tuple(t.shape[1:]))])
        out[name] = t[shard_slices(sp, tuple(t.shape), mesh)]
    return out


def gather_part(t, spec, mesh):
    """The whole tensor of this rank's part ``t`` split by ``spec`` (one
    axis per split dim): an all-gather over each split dim's axis (every
    rank of the axis must call it). ``spec`` None: ``t`` is whole."""
    from elasticdl_tpu_torch.parallel import collectives
    from elasticdl_tpu_torch.parallel.mesh import PadDim0

    if isinstance(spec, PadDim0):
        spec = spec.spec
    for dim, entry in enumerate(spec or ()):
        if isinstance(entry, (tuple, list)):
            raise NotImplementedError(
                "gathering a dim split over several axes (%r)" % (entry,)
            )
        ax = axis_of(mesh, entry)
        if ax is not None:
            t = collectives.all_gather(t.contiguous(), ax, dim)
    return t


def batch_spec(mesh, seq_sharded=False):
    """The activations' spec: the batch on ``data``, the length on
    ``seq`` when ``seq_sharded``."""
    axes = set(mesh.axis_names)
    data = "data" if "data" in axes else None
    seq = "seq" if (seq_sharded and "seq" in axes) else None
    return P(data, seq)


def shard_batch_dp_sp(mesh, batch, seq_sharded=False):
    """This rank's rows (its ``data`` part) and, with ``seq_sharded``,
    columns (its ``seq`` part) of every array of ``batch``, a dict,
    list or tuple tree; every ``model`` rank gets the same."""
    from elasticdl_tpu_torch.parallel.spmd import shard_batch

    return shard_batch(batch, None, mesh, "seq" if seq_sharded else None)[0]
