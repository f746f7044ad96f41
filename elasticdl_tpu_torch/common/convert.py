"""Parameter names and layouts between the reference and the port.

The reference names a parameter by its ``/``-joined flax path
(``pytree_to_named_arrays``: ``block_0/query/kernel`` of shape
``(768, 12, 64)``); export artifacts and checkpoints carry those names.
The port's modules hold ``nn.Linear`` weights as ``(out, in)`` under
``state_dict`` keys. :func:`to_state_dict` and :func:`to_named` map one
to the other, so one set of weights feeds both packages and artifacts
cross between them unchanged.

Each architecture has its own weight map (``WEIGHT_MAPS``): the
transformer LM, ResNet-50, the MNIST CNN, the CIFAR-10 CNN and DeepFM.
flax's creation-order names collide between them (``Dense_0`` is the
head of a CNN and the output layer of DeepFM; ``GroupNorm_0`` is the MNIST CNN's
only norm and the CIFAR-10 CNN's first of six), so a map holds one
architecture's names alone. A set of names takes the first map, in the
order of ``WEIGHT_MAPS``, that covers every one of them. Each model's full
set is covered by its own map first: the MNIST CNN's (one ``GroupNorm_0``)
is also covered by the CIFAR-10 CNN's map, which therefore comes after it.

flax names a layer by its creation order: ResNet-50's stem is
``Conv_0``/``BatchNorm_0``, its blocks ``BottleneckBlock_{0..15}`` with
``Conv_{0..3}``/``BatchNorm_{0..3}`` inside (in a projection block the
shortcut is ``Conv_3``/``BatchNorm_3``), its head ``Dense_0``; the port
names them ``conv{j}``/``norm{j}``, ``blocks.{i}`` and ``head``. BatchNorm
``scale``/``bias`` are the norm's weight and bias, and the ``batch_stats``
``mean``/``var`` (model state, named ``batch_stats/...``) its
``running_mean``/``running_var`` buffers. The CIFAR-10 CNN's
``Conv_{0..5}``/``GroupNorm_{0..5}`` are ``conv{j}``/``group_norm{j}``.
DeepFM's tables are ``embedding`` and ``id_bias`` (flax ``Embed_0`` and
``Embed_1``, or the HBM plane's ``embedding/table`` and ``id_bias/table``:
neither is transposed), its ``Dense_1``/``Dense_0`` ``tower``/``out`` (the
outer ``Dense(1)`` is created first); the
HBM plane's ``metrics/<table>/a2a_overflow`` counter is dropped (the port
keeps that count outside the ``state_dict``, ``nn/hbm_embedding.py``).

Layouts:

- ``dense``: a flax ``Dense`` kernel ``(in, out)`` is the transposed
  ``nn.Linear`` weight ``(out, in)`` (the MoE gate's too). The stacked
  expert weights ``experts_up`` (E, D, F) and ``experts_down`` (E, F,
  D) keep their layout, and the ``aux_loss`` collection's
  ``moe_balance`` is the block's ``aux_loss.moe_balance`` buffer.
- ``heads_out``: a ``DenseGeneral`` kernel ``(E, H, D)`` (q/k/v
  projections) is ``(H*D, E)`` once its head axes are flattened.
- ``heads_in``: the output projection's ``(H, D, E)`` is ``(E, H*D)``.
- ``conv``: a ``Conv`` kernel ``(kh, kw, in, out)`` is the ``(out, in, kh,
  kw)`` convolution weight.

Over a tensor-parallel mesh each rank holds its part of the split
parameters under the same keys: :func:`shard_state_dict` cuts a whole
``state_dict`` to this rank's parts, :func:`gather_state_dict` joins the
ranks' parts back (``parallel/sharding.py`` has the rules).

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

_TRANSFORMER_LM = (  # (reference path, state_dict key, layout)
    ("embed/embedding", "embed.weight", None),
    ("block_{i}/RMSNorm_0/scale", "blocks.{i}.attn_norm.weight", None),
    ("block_{i}/RMSNorm_1/scale", "blocks.{i}.mlp_norm.weight", None),
    ("block_{i}/{proj}/kernel", "blocks.{i}.{proj}.weight", "heads_out"),
    ("block_{i}/out/kernel", "blocks.{i}.out.weight", "heads_in"),
    ("block_{i}/{mlp}/kernel", "blocks.{i}.{mlp}.weight", "dense"),
    ("block_{i}/{mlp}/bias", "blocks.{i}.{mlp}.bias", None),
    # the mixture of experts: the gate a Dense, the stacks as they are
    ("block_{i}/moe_mlp/gate/kernel", "blocks.{i}.moe_mlp.gate.weight",
     "dense"),
    ("block_{i}/moe_mlp/{experts}", "blocks.{i}.moe_mlp.{experts}", None),
    ("aux_loss/block_{i}/moe_mlp/moe_balance",
     "blocks.{i}.moe_mlp.aux_loss.moe_balance", None),
    ("RMSNorm_0/scale", "norm.weight", None),
)
_CONV = (
    ("Conv_{j}/kernel", "conv{j}.weight", "conv"),
    ("Conv_{j}/bias", "conv{j}.bias", None),
)
_HEAD = (
    ("Dense_0/kernel", "head.weight", "dense"),
    ("Dense_0/bias", "head.bias", None),
)
_RESNET50 = _CONV + _HEAD + (
    ("BatchNorm_{j}/scale", "norm{j}.weight", None),
    ("BatchNorm_{j}/bias", "norm{j}.bias", None),
    ("BottleneckBlock_{i}/Conv_{j}/kernel", "blocks.{i}.conv{j}.weight",
     "conv"),
    ("BottleneckBlock_{i}/BatchNorm_{j}/scale", "blocks.{i}.norm{j}.weight",
     None),
    ("BottleneckBlock_{i}/BatchNorm_{j}/bias", "blocks.{i}.norm{j}.bias",
     None),
    ("batch_stats/BatchNorm_{j}/{stat}", "norm{j}.running_{stat}", None),
    ("batch_stats/BottleneckBlock_{i}/BatchNorm_{j}/{stat}",
     "blocks.{i}.norm{j}.running_{stat}", None),
)
_MNIST = _CONV + _HEAD + (
    ("GroupNorm_0/scale", "group_norm.weight", None),
    ("GroupNorm_0/bias", "group_norm.bias", None),
)
_CIFAR10 = _CONV + _HEAD + (
    ("GroupNorm_{j}/scale", "group_norm{j}.weight", None),
    ("GroupNorm_{j}/bias", "group_norm{j}.bias", None),
)
_DEEPFM = (
    # deepfm_functional_api's flax nn.Embed tables
    ("Embed_0/embedding", "embedding.weight", None),
    ("Embed_1/embedding", "id_bias.weight", None),
    # deepfm_edl_embedding's HbmEmbedding tables
    ("{table}/table", "{table}.table", None),
    # the a2a overflow counter: dropped (kept outside the state_dict)
    ("metrics/{table}/a2a_overflow", None, None),
    # ``nn.Dense(1)(nn.Dense(fc_unit)(x))`` creates the outer, one-wide
    # layer first: it is Dense_0, the fc_unit tower Dense_1
    ("Dense_0/kernel", "out.weight", "dense"),
    ("Dense_0/bias", "out.bias", None),
    ("Dense_1/kernel", "tower.weight", "dense"),
    ("Dense_1/bias", "tower.bias", None),
)
# one weight map per architecture; a set of names takes the first map, in
# this order, that covers all of them (mnist's before cifar10's, which
# also covers the MNIST CNN's names)
WEIGHT_MAPS = {
    "transformer_lm": _TRANSFORMER_LM,
    "resnet50": _RESNET50,
    "mnist": _MNIST,
    "cifar10": _CIFAR10,
    "deepfm": _DEEPFM,
}
_FIELDS = {
    "i": r"(?P<i>\d+)",
    "j": r"(?P<j>\d+)",
    "stat": r"(?P<stat>mean|var)",
    "proj": r"(?P<proj>query|key|value)",
    "mlp": r"(?P<mlp>mlp_up|mlp_down)",
    "experts": r"(?P<experts>experts_up|experts_down)",
    "table": r"(?P<table>embedding|id_bias)",
}


def _regex(template):
    if template is None:
        return None
    out = re.escape(template)
    for field, group in _FIELDS.items():
        out = out.replace(re.escape("{%s}" % field), group)
    return re.compile(out)


_COMPILED = {
    arch: [
        (_regex(ref), _regex(key), ref, key, layout)
        for ref, key, layout in rules
    ]
    for arch, rules in WEIGHT_MAPS.items()
}


def _match_in(rules, name, side):
    for rule in rules:
        if rule[side] is not None:
            m = rule[side].fullmatch(name)
            if m is not None:
                return rule, m.groupdict()
    return None


def _rules(names, side):
    """The rules of the first map that covers every name."""
    names = list(names)
    for rules in _COMPILED.values():
        if all(_match_in(rules, n, side) for n in names):
            return rules
    raise KeyError(
        "no parameter mapping for %r: no one weight map covers them all"
        % (names,)
    )


def _match(rules, name, side):
    found = _match_in(rules, name, side)
    if found is None:
        raise KeyError("no parameter mapping for %r" % name)
    return found


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
    rules = _rules(named, 0) if named else ()
    for name, value in named.items():
        (_, _, _, key, layout), fields = _match(rules, name, 0)
        if key is None:
            continue
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


def to_named(state_dict, num_heads=None, head_dim=None, keep_device=False):
    """{state_dict key: tensor} -> {reference path: CPU torch tensor in
    the reference's layout}; with ``keep_device``, each stays where it
    was."""
    named = {}
    rules = _rules(state_dict, 1) if state_dict else ()
    for key, value in state_dict.items():
        (_, _, ref, _, layout), fields = _match(rules, key, 1)
        t = value.detach() if keep_device else value.detach().to("cpu")
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


def reference_layouts(keys):
    """{state_dict key: (reference path, layout)} of ``keys``: the names
    and layouts of :func:`to_named`, without the tensors."""
    keys = list(keys)
    rules = _rules(keys, 1) if keys else ()
    out = {}
    for key in keys:
        (_, _, ref, _, layout), fields = _match(rules, key, 1)
        out[key] = (ref.format(**fields), layout)
    return out


def to_reference_spec(spec, layout, ndim):
    """A partition spec of a ``state_dict`` tensor of ``ndim`` dims ->
    the spec of the reference's kernel, one entry per dim (the head
    axis of a flattened head dim carries its split)."""
    entries = tuple(spec or ())
    entries += (None,) * (ndim - len(entries))
    if layout == "heads_out":
        return (entries[1], entries[0], None)
    if layout == "heads_in":
        return (entries[1], None, entries[0])
    if layout == "dense":
        return entries[::-1]
    if layout == "conv":
        return (entries[2], entries[3], entries[1], entries[0])
    return entries


def shard_state_dict(state_dict, specs, mesh):
    """{state_dict key: whole tensor} -> this rank's parts on ``mesh``
    (a ``parallel/mesh.WorldMesh``): ``specs`` is the nested or flat
    {key: spec} form a zoo's ``param_shardings`` gives (None: the TP
    rules); a key no spec covers stays whole. Owned copies."""
    from elasticdl_tpu_torch.parallel.mesh import resolve_specs
    from elasticdl_tpu_torch.parallel.sharding import shard_params

    flat = resolve_specs(state_dict, specs) if specs is not None else None
    return {
        k: v.clone()
        for k, v in shard_params(mesh, dict(state_dict), flat).items()
    }


def gather_state_dict(state_dict, specs, mesh):
    """The inverse of :func:`shard_state_dict`: this rank's parts ->
    the whole tensors, the same on every rank (an all-gather over each
    split dim's axis; every rank must call it)."""
    from elasticdl_tpu_torch.parallel.mesh import resolve_specs
    from elasticdl_tpu_torch.parallel.sharding import gather_part, param_spec

    flat = resolve_specs(state_dict, specs) if specs is not None else None
    return {
        k: gather_part(
            v, param_spec(k, mesh) if flat is None else flat.get(k), mesh)
        for k, v in state_dict.items()
    }


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
        k: v.to(device)
        for k, v in to_state_dict(named_params).items()
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
