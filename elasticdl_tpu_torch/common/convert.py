"""Parameter names and layouts between the reference and the port.

The reference names a parameter by its ``/``-joined flax path
(``pytree_to_named_arrays``: ``block_0/query/kernel`` of shape
``(768, 12, 64)``); export artifacts and checkpoints carry those names.
The port's modules hold ``nn.Linear`` weights as ``(out, in)`` under
``state_dict`` keys. :func:`to_state_dict` and :func:`to_named` map one
to the other for the transformer LM and the convolutional zoo models
(ResNet-50, the MNIST CNN), so one set of weights feeds both packages and
artifacts cross between them unchanged.

flax names a layer by its creation order: ResNet-50's stem is
``Conv_0``/``BatchNorm_0``, its blocks ``BottleneckBlock_{0..15}`` with
``Conv_{0..3}``/``BatchNorm_{0..3}`` inside (in a projection block the
shortcut is ``Conv_3``/``BatchNorm_3``), its head ``Dense_0``; the port
names them ``conv{j}``/``norm{j}``, ``blocks.{i}`` and ``head``. BatchNorm
``scale``/``bias`` are the norm's weight and bias, and the ``batch_stats``
``mean``/``var`` (model state, named ``batch_stats/...``) its
``running_mean``/``running_var`` buffers.

Layouts:

- ``dense``: a flax ``Dense`` kernel ``(in, out)`` is the transposed
  ``nn.Linear`` weight ``(out, in)``.
- ``heads_out``: a ``DenseGeneral`` kernel ``(E, H, D)`` (q/k/v
  projections) is ``(H*D, E)`` once its head axes are flattened.
- ``heads_in``: the output projection's ``(H, D, E)`` is ``(E, H*D)``.
- ``conv``: a ``Conv`` kernel ``(kh, kw, in, out)`` is the ``(out, in, kh,
  kw)`` convolution weight.

Gradients, Adam moments and the SGD momentum trace have their parameter's
layout, so they cross by the same rules. :func:`load_adam_state` and
:func:`adam_state_named` carry optax's Adam state (``mu``, ``nu``,
``count``) into a torch ``AdamW``'s (``exp_avg``, ``exp_avg_sq``,
``step``) and back; :func:`load_sgd_state` and :func:`sgd_state_named`
carry ``optax.sgd``'s momentum ``trace`` into SGD's ``momentum_buffer``
and back. So a reference train state (params, batch statistics and the
optimizer's state) converts into the port's (:func:`to_train_state`) and
back (:func:`from_train_state`).
"""

import re

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device

_RULES = (  # (reference path, state_dict key, layout)
    ("embed/embedding", "embed.weight", None),
    ("block_{i}/RMSNorm_0/scale", "blocks.{i}.attn_norm.weight", None),
    ("block_{i}/RMSNorm_1/scale", "blocks.{i}.mlp_norm.weight", None),
    ("block_{i}/{proj}/kernel", "blocks.{i}.{proj}.weight", "heads_out"),
    ("block_{i}/out/kernel", "blocks.{i}.out.weight", "heads_in"),
    ("block_{i}/{mlp}/kernel", "blocks.{i}.{mlp}.weight", "dense"),
    ("block_{i}/{mlp}/bias", "blocks.{i}.{mlp}.bias", None),
    ("RMSNorm_0/scale", "norm.weight", None),
    # the convolutional models (ResNet-50, the MNIST CNN)
    ("Conv_{j}/kernel", "conv{j}.weight", "conv"),
    ("Conv_{j}/bias", "conv{j}.bias", None),
    ("BatchNorm_{j}/scale", "norm{j}.weight", None),
    ("BatchNorm_{j}/bias", "norm{j}.bias", None),
    ("BottleneckBlock_{i}/Conv_{j}/kernel", "blocks.{i}.conv{j}.weight",
     "conv"),
    ("BottleneckBlock_{i}/BatchNorm_{j}/scale", "blocks.{i}.norm{j}.weight",
     None),
    ("BottleneckBlock_{i}/BatchNorm_{j}/bias", "blocks.{i}.norm{j}.bias",
     None),
    ("GroupNorm_0/scale", "group_norm.weight", None),
    ("GroupNorm_0/bias", "group_norm.bias", None),
    ("Dense_0/kernel", "head.weight", "dense"),
    ("Dense_0/bias", "head.bias", None),
    ("batch_stats/BatchNorm_{j}/{stat}", "norm{j}.running_{stat}", None),
    ("batch_stats/BottleneckBlock_{i}/BatchNorm_{j}/{stat}",
     "blocks.{i}.norm{j}.running_{stat}", None),
)
_FIELDS = {
    "i": r"(?P<i>\d+)",
    "j": r"(?P<j>\d+)",
    "stat": r"(?P<stat>mean|var)",
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
        elif layout == "conv":
            t = t.permute(3, 2, 0, 1)
        state[key.format(**fields)] = t.contiguous()
    return state


def to_named(state_dict, num_heads=None, head_dim=None):
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
        elif layout == "conv":
            t = t.permute(2, 3, 1, 0)
        named[ref.format(**fields)] = t.contiguous()
    return named


def load_adam_state(opt, params, mu, nu, count):
    """Set the torch Adam/AdamW ``opt`` (bound to ``params``, {state_dict
    key: tensor}) to optax's Adam state: ``mu`` and ``nu`` as {reference
    path: array}, ``count`` the step count."""
    mu, nu = to_state_dict(mu), to_state_dict(nu)
    for key, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[key].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[key].to(device=p.device, dtype=p.dtype),
        }


def adam_state_named(opt, params, num_heads=None, head_dim=None):
    """The torch Adam/AdamW state of ``params`` as optax's: ``(mu, nu,
    count)`` with the moments as {reference path: CPU tensor}. A
    parameter the optimizer has not stepped yet has zero moments."""
    mu, nu, count = {}, {}, 0
    for key, p in params.items():
        st = opt.state.get(p)
        if st:
            mu[key], nu[key] = st["exp_avg"], st["exp_avg_sq"]
            count = int(st["step"])
        else:
            mu[key] = nu[key] = torch.zeros_like(p)
    return (
        to_named(mu, num_heads, head_dim),
        to_named(nu, num_heads, head_dim),
        count,
    )


def load_sgd_state(opt, params, trace):
    """Set the torch SGD ``opt`` (bound to ``params``, {state_dict key:
    tensor}) to ``optax.sgd``'s momentum ``trace`` ({reference path:
    array})."""
    trace = to_state_dict(trace)
    for key, p in params.items():
        opt.state[p] = {
            "momentum_buffer": trace[key].to(device=p.device, dtype=p.dtype)
        }


def sgd_state_named(opt, params):
    """The torch SGD momentum buffers of ``params`` as optax's ``trace``
    ({reference path: CPU tensor}); zeros for a parameter not stepped
    yet, as optax initializes it."""
    trace = {}
    for key, p in params.items():
        buf = (opt.state.get(p) or {}).get("momentum_buffer")
        trace[key] = torch.zeros_like(p) if buf is None else buf
    return to_named(trace)


def to_train_state(named_params, optimizer, adam=None, version=0,
                   device="cuda", batch_stats=None, trace=None):
    """A reference train state -> the port's ``TrainState`` on
    ``device`` (the card unless the caller names the CPU; raises where
    there is no card): ``named_params`` {reference path: array},
    ``optimizer`` the zoo's factory, ``adam`` optional ``(mu, nu,
    count)``, ``batch_stats`` the model state ({``batch_stats/...`` path:
    array}), ``trace`` optax.sgd's momentum trace."""
    from elasticdl_tpu_torch.training.step import TrainState

    device = resolve_device(device)
    params = {
        k: v.to(device) for k, v in to_state_dict(named_params).items()
    }
    state = {
        k: v.to(device) for k, v in to_state_dict(batch_stats or {}).items()
    }
    ts = TrainState.create(params, state, optimizer, version=version)
    if adam is not None:
        load_adam_state(ts.opt_state, ts.params, *adam)
    if trace is not None:
        load_sgd_state(ts.opt_state, ts.params, trace)
    return ts


def from_train_state(ts, num_heads=None, head_dim=None):
    """The port's ``TrainState`` -> ``{"params", "batch_stats", "version"}``
    plus the optimizer's state in the reference's names and layouts:
    ``"trace"`` for SGD, ``"mu"``, ``"nu"`` and ``"count"`` for Adam."""
    out = {
        "params": to_named(ts.params, num_heads, head_dim),
        "batch_stats": to_named(ts.state or {}),
        "version": ts.version,
    }
    if isinstance(ts.opt_state, torch.optim.SGD):
        out["trace"] = sgd_state_named(ts.opt_state, ts.params)
    else:
        out["mu"], out["nu"], out["count"] = adam_state_named(
            ts.opt_state, ts.params, num_heads, head_dim
        )
    return out
