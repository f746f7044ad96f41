"""Parameter names and layouts between the reference and the port.

The reference names a parameter by its ``/``-joined flax path
(``pytree_to_named_arrays``: ``block_0/query/kernel`` of shape
``(768, 12, 64)``); export artifacts and checkpoints carry those names.
The port's modules hold ``nn.Linear`` weights as ``(out, in)`` under
``state_dict`` keys. :func:`to_state_dict` and :func:`to_named` map one
to the other for the transformer LM, so one set of weights feeds both
packages and artifacts cross between them unchanged.

Layouts:

- ``dense``: a flax ``Dense`` kernel ``(in, out)`` is the transposed
  ``nn.Linear`` weight ``(out, in)``.
- ``heads_out``: a ``DenseGeneral`` kernel ``(E, H, D)`` (q/k/v
  projections) is ``(H*D, E)`` once its head axes are flattened.
- ``heads_in``: the output projection's ``(H, D, E)`` is ``(E, H*D)``.
"""

import re

import numpy as np
import torch

_RULES = (  # (reference path, state_dict key, layout)
    ("embed/embedding", "embed.weight", None),
    ("block_{i}/RMSNorm_0/scale", "blocks.{i}.attn_norm.weight", None),
    ("block_{i}/RMSNorm_1/scale", "blocks.{i}.mlp_norm.weight", None),
    ("block_{i}/{proj}/kernel", "blocks.{i}.{proj}.weight", "heads_out"),
    ("block_{i}/out/kernel", "blocks.{i}.out.weight", "heads_in"),
    ("block_{i}/{mlp}/kernel", "blocks.{i}.{mlp}.weight", "dense"),
    ("block_{i}/{mlp}/bias", "blocks.{i}.{mlp}.bias", None),
    ("RMSNorm_0/scale", "norm.weight", None),
)
_FIELDS = {
    "i": r"(?P<i>\d+)",
    "proj": r"(?P<proj>query|key|value)",
    "mlp": r"(?P<mlp>mlp_up|mlp_down)",
}


def _regex(template):
    out = re.escape(template)
    for field, group in _FIELDS.items():
        out = out.replace(re.escape("{%s}" % field), group)
    return re.compile(out)


_COMPILED = [
    (_regex(ref), _regex(key), ref, key, layout)
    for ref, key, layout in _RULES
]


def _match(name, side):
    for rule in _COMPILED:
        m = rule[side].fullmatch(name)
        if m is not None:
            return rule, m.groupdict()
    raise KeyError("no parameter mapping for %r" % name)


def _as_torch(value):
    """numpy (bf16 from ml_dtypes included, read by its bits) or torch
    -> an owned CPU torch tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu")
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16
        )
    return torch.from_numpy(np.array(arr, copy=True))


def to_state_dict(named):
    """{reference path: array} -> {state_dict key: torch tensor}."""
    state = {}
    for name, value in named.items():
        (_, _, _, key, layout), fields = _match(name, 0)
        t = _as_torch(value)
        if layout == "heads_out":
            t = t.reshape(t.shape[0], -1).T
        elif layout == "heads_in":
            t = t.reshape(-1, t.shape[-1]).T
        elif layout == "dense":
            t = t.T
        state[key.format(**fields)] = t.contiguous()
    return state


def to_named(state_dict, num_heads, head_dim):
    """{state_dict key: tensor} -> {reference path: CPU torch tensor in
    the reference's layout}."""
    named = {}
    for key, value in state_dict.items():
        (_, _, ref, _, layout), fields = _match(key, 1)
        t = value.detach().to("cpu")
        if layout == "heads_out":
            t = t.T.reshape(t.shape[1], num_heads, head_dim)
        elif layout == "heads_in":
            t = t.T.reshape(num_heads, head_dim, t.shape[0])
        elif layout == "dense":
            t = t.T
        named[ref.format(**fields)] = t.contiguous()
    return named
