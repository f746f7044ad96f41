"""Decoder-only transformer LM, the port of
``model_zoo/transformer_lm/transformer_lm.py`` (its plain build).

The same function as the flax model: RMSNorm (eps 1e-6, statistics in
float32), rotary position embedding over each head computed in float32,
causal attention through :func:`pick_causal_attention` (the flash kernel
from L = 1024 at 128-divisible lengths, plain attention otherwise), a
dense GELU MLP (tanh approximation, flax's default) and a head tied to
the token embedding. Parameters are float32; ``dtype`` is the compute
dtype, to which weights are cast at use, as flax's ``promote_dtype``
does — so a bf16 model returns bf16 logits.

``state_dict`` keys map to the reference's parameter paths through
common/convert.py. The training contract is the reference's: ``loss``
(next-token cross entropy on the model's output dtype, so on bf16 logits
for a bf16 model), ``optimizer`` (AdamW with optax's defaults: weight
decay 1e-4 on every parameter), ``dataset_fn`` (64-token records) and
``eval_metrics_fn``.

With ``num_experts`` every block's MLP is a top-k mixture of experts
(:class:`MoEMlp`): on one device, or a mesh without an ``expert`` axis,
the dense fallback (every expert runs every token, the gate combines
them); over a :class:`~elasticdl_tpu_torch.parallel.mesh.WorldMesh` with
an ``expert`` axis, the routed form (``parallel/expert.make_moe_fn``).
While training it writes the Switch load-balancing loss into the
``aux_loss`` collection, which the step adds to the task loss.

With ``mesh`` and ``seq_axis`` the model runs on this rank's shard of
the sequence: rotary positions are the global ones (the rank's offset
plus ``arange``) and attention is the ring over the axis
(``parallel/ring_attention.make_ring_attention``). The step builder
shards the batch and the next-token targets (``parallel/spmd.py``).

With a ``mesh`` whose ``model`` axis has T > 1 ranks the model is
tensor-parallel, Megatron-LM's layout of the reference's TP rules
(``parallel/sharding.py``): each rank holds its part of the split
parameters under the same ``state_dict`` names. ``query``/``key``/
``value`` give this rank's H/T heads, which run the causal attention
(the flash kernels) alone; ``out`` and ``mlp_down`` take the heads' and
the hidden units' part and their partial outputs are summed over
``model`` in float32 before the cast (``mlp_down``'s bias added once,
after the sum); ``mlp_up`` gives this rank's hidden units. The
embedding holds the rank's V/T vocabulary rows: the lookup is masked to
them and summed over ``model``, and the tied head gives the rank's
vocabulary part of the logits, which the step's loss takes as it is
(``parallel/spmd.make_loss``: a vocabulary-parallel cross entropy).
The norms replicate; their input's gradient is summed over ``model``
(``collectives.sum_grad``), so every replicated parameter's gradient
comes out the same on every ``model`` rank. A mixture of experts over
``model`` runs its dense fallback replicated, as the reference's rules
leave its stacks whole. :func:`param_shardings`, :func:`mesh_axes` and
:func:`build_distributed_model` are the reference's hooks.

Not ported yet, each raising by name: pipeline stages over a ``pipe``
axis (ROADMAP A9.3), experts over an ``expert`` axis together with
``model``, and the mixture of experts over a sequence-sharded mesh
(A9.6).
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.ops.flash_attention import pick_causal_attention
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import axis_of


def _rotary(x, positions):
    """Rotary position embedding over the last (head) dim, in float32,
    cast back to ``x``'s dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        10000.0
        ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., None].float() * freqs  # (B, L, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(
        x.dtype
    )


class RMSNorm(nn.Module):
    def __init__(self, dim, dtype, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.weight.float())).to(
            self.dtype
        )


def _dense(layer, x, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


class MoEMlp(nn.Module):
    """Mixture-of-experts MLP (the reference's ``MoEMlp``): a bias-free
    ``gate`` (D -> E), stacked expert weights ``experts_up`` (E, D, F)
    and ``experts_down`` (E, F, D), each expert ``gelu(x @ up) @ down``
    (tanh approximation) in the compute dtype, top-k routed.

    On a mesh with an ``expert`` axis of more than one rank the tokens
    route over it (``make_moe_fn``, the batch split over ``data`` where
    the mesh has it); otherwise every expert runs every token and the
    gate combines them (``reference_moe``'s function, batched over the
    stacks: :meth:`_dense_moe`). A training forward writes
    ``aux_loss_coef`` times the load-balancing loss to the ``aux_loss``
    collection (the buffer ``aux_loss.moe_balance``, through
    ``apply_model``'s state collector); an eval forward writes
    nothing."""

    # the parameters a routed MoE splits over the expert axis: each
    # rank's gradient is its own expert's slice (parallel/spmd.py sums
    # them over the axis)
    EXPERT_SHARDED = ("experts_up", "experts_down")

    def __init__(self, embed_dim, num_experts, mlp_dim, dtype, mesh=None,
                 capacity_factor=2.0, num_selected=1, aux_loss_coef=0.01):
        super().__init__()
        self.num_experts = num_experts
        self.dtype = dtype
        self.mesh = mesh
        self.capacity_factor = capacity_factor
        self.num_selected = num_selected
        self.aux_loss_coef = aux_loss_coef
        self.gate = nn.Linear(embed_dim, num_experts, bias=False)
        self.experts_up = nn.Parameter(
            torch.empty(num_experts, embed_dim, mlp_dim)
        )
        self.experts_down = nn.Parameter(
            torch.empty(num_experts, mlp_dim, embed_dim)
        )
        self.aux_loss = nn.Module()
        # not in state_dict: a value of the last training forward, never
        # a weight (the reference's aux_loss collection is not exported)
        self.aux_loss.register_buffer(
            "moe_balance", torch.zeros(()), persistent=False
        )
        self._state_collector = None  # set by apply_model

    def _expert_fn(self, params, tokens):
        up = tokens.to(self.dtype) @ params["up"].to(self.dtype)
        return F.gelu(up, approximate="tanh") @ params["down"].to(self.dtype)

    def forward(self, h):
        from elasticdl_tpu_torch.parallel.expert import (
            load_balancing_loss,
            make_moe_fn,
        )

        d = h.shape[-1]
        e = self.num_experts
        gate_logits = _dense(self.gate, h, self.dtype)
        tokens = h.reshape(-1, d)
        logits_flat = gate_logits.reshape(-1, e)
        expert_axis = axis_of(self.mesh, "expert")
        data_axis = axis_of(self.mesh, "data")
        if self._state_collector is not None:
            prefix, updates = self._state_collector
            updates[prefix + "aux_loss.moe_balance"] = (
                self.aux_loss_coef
                * load_balancing_loss(logits_flat, data_axis)
            )
        stacked = {"up": self.experts_up, "down": self.experts_down}
        if expert_axis is not None:
            moe = make_moe_fn(
                self.mesh,
                self._expert_fn,
                expert_axis="expert",
                batch_axis="data" if data_axis is not None else None,
                capacity_factor=self.capacity_factor,
                num_selected=self.num_selected,
            )
            out = moe(stacked, tokens, logits_flat)
        else:
            out = self._dense_moe(tokens, logits_flat)
        return out.reshape(h.shape).to(h.dtype)

    def _dense_moe(self, tokens, logits):
        """``reference_moe`` over the stacked weights: every expert's
        ``_expert_fn`` on every token as two batched products (one
        launch each for all E experts, and a graph E times smaller to
        export), combined by the top-k gate."""
        from elasticdl_tpu_torch.parallel.expert import topk_gate

        x = tokens.to(self.dtype)
        up = torch.einsum("td,edf->etf", x, self.experts_up.to(self.dtype))
        outs = torch.einsum(
            "etf,efd->etd", F.gelu(up, approximate="tanh"),
            self.experts_down.to(self.dtype),
        )  # (E, T, D)
        idx, gate = topk_gate(logits, self.num_selected)
        t = torch.arange(tokens.shape[0], device=tokens.device)
        return sum(
            outs[idx[:, j], t] * gate[:, j, None].to(tokens.dtype)
            for j in range(self.num_selected)
        )


def _row_parallel(partial, axis):
    """The sum over ``axis`` of this rank's partial output, in float32,
    cast back to the partial's dtype."""
    return collectives.all_reduce(partial.float(), axis).to(partial.dtype)


class Block(nn.Module):
    """One decoder block; with ``model_axis`` (a mesh :class:`Axis` of T
    ranks) its ``num_heads`` and ``mlp_dim`` are this rank's parts."""

    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, dtype,
                 num_experts=0, mesh=None, moe_capacity_factor=2.0,
                 moe_num_selected=1, moe_aux_loss_coef=0.01,
                 model_axis=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.model_axis = model_axis
        inner = num_heads * head_dim
        self.attn_norm = RMSNorm(embed_dim, dtype)
        self.query = nn.Linear(embed_dim, inner, bias=False)
        self.key = nn.Linear(embed_dim, inner, bias=False)
        self.value = nn.Linear(embed_dim, inner, bias=False)
        self.out = nn.Linear(inner, embed_dim, bias=False)
        self.mlp_norm = RMSNorm(embed_dim, dtype)
        if num_experts:
            self.moe_mlp = MoEMlp(
                embed_dim, num_experts, mlp_dim, dtype, mesh=mesh,
                capacity_factor=moe_capacity_factor,
                num_selected=moe_num_selected,
                aux_loss_coef=moe_aux_loss_coef,
            )
        else:
            self.mlp_up = nn.Linear(embed_dim, mlp_dim)
            self.mlp_down = nn.Linear(mlp_dim, embed_dim)

    def forward(self, x, positions, attention_fn):
        b, l, _ = x.shape
        tp = self.model_axis
        heads = (b, l, self.num_heads, self.head_dim)
        h = self.attn_norm(x)
        if tp is not None:
            h = collectives.sum_grad(h, tp)
        q = _rotary(_dense(self.query, h, self.dtype).view(heads), positions)
        k = _rotary(_dense(self.key, h, self.dtype).view(heads), positions)
        v = _dense(self.value, h, self.dtype).view(heads)
        attn = attention_fn(q, k, v)
        out = _dense(self.out, attn.reshape(b, l, -1), self.dtype)
        x = x + (out if tp is None else _row_parallel(out, tp))
        h = self.mlp_norm(x)
        if hasattr(self, "moe_mlp"):
            return x + self.moe_mlp(h)
        if tp is None:
            h = F.gelu(_dense(self.mlp_up, h, self.dtype), approximate="tanh")
            return x + _dense(self.mlp_down, h, self.dtype)
        h = collectives.sum_grad(h, tp)
        h = F.gelu(_dense(self.mlp_up, h, self.dtype), approximate="tanh")
        down = F.linear(h, self.mlp_down.weight.to(self.dtype))
        return x + (_row_parallel(down, tp)
                    + self.mlp_down.bias.to(self.dtype))


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab_size=1024,
        num_layers=2,
        num_heads=4,
        head_dim=16,
        embed_dim=64,
        mlp_dim=256,
        dtype=torch.float32,
        use_flash=True,
        mesh=None,
        seq_axis=None,
        num_experts=0,
        moe_capacity_factor=2.0,
        moe_num_selected=1,
        moe_aux_loss_coef=0.01,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.use_flash = use_flash
        self.mesh = mesh
        self.seq_axis = seq_axis if mesh is not None else None
        # tensor parallelism: this rank's parts of the heads, the hidden
        # units and the vocabulary
        self.model_axis = axis_of(mesh, "model")
        t = self.model_axis.size if self.model_axis is not None else 1
        for what, n in (("num_heads", num_heads), ("mlp_dim", mlp_dim),
                        ("vocab_size", vocab_size)):
            if n % t and not (what == "mlp_dim" and num_experts):
                raise ValueError(
                    "%s=%d does not split over a 'model' axis of %d"
                    % (what, n, t)
                )
        vocab_part = vocab_size // t
        self.vocab_start = (
            self.model_axis.index * vocab_part if t > 1 else 0
        )
        self.embed = nn.Embedding(vocab_part, embed_dim)
        self.blocks = nn.ModuleList(
            Block(
                embed_dim, num_heads // t, head_dim,
                mlp_dim if num_experts else mlp_dim // t, dtype,
                num_experts=num_experts, mesh=mesh,
                moe_capacity_factor=moe_capacity_factor,
                moe_num_selected=moe_num_selected,
                moe_aux_loss_coef=moe_aux_loss_coef,
                model_axis=self.model_axis,
            )
            for _ in range(num_layers)
        )
        self.norm = RMSNorm(embed_dim, dtype)

    def forward(self, features, attention_fn=None):
        """``features``: a ``{"tokens": (B, L) ints}`` dict or the token
        array itself -> (B, L, vocab) logits in the compute dtype.
        ``attention_fn(q, k, v)`` overrides the causal attention the
        length picks (a check swaps in the kernel's plain version). On a
        sequence axis, the tokens are this rank's shard: positions start
        at its offset and attention is the ring. On a ``model`` axis the
        logits are this rank's vocabulary part, (B, L, vocab / T)."""
        tokens = features["tokens"] if isinstance(features, dict) else features
        device = self.embed.weight.device
        if not isinstance(tokens, torch.Tensor):
            # wire arrays are read-only views: one owned copy
            tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
        tokens = tokens.to(device=device, dtype=torch.long)
        b, l = tokens.shape
        offset = 0
        if self.seq_axis is not None:
            from elasticdl_tpu_torch.parallel.ring_attention import (
                make_ring_attention,
            )

            seq = axis_of(self.mesh, self.seq_axis)
            offset = seq.index * l if seq is not None else 0
            if attention_fn is None:
                attention_fn = make_ring_attention(
                    self.mesh, self.seq_axis, causal=True,
                    use_flash=self.use_flash,
                )
        positions = (offset + torch.arange(l, device=device)).expand(b, l)
        if attention_fn is None:
            attention_fn = pick_causal_attention(l, self.use_flash)
        table = self.embed.weight.to(self.dtype)
        tp = self.model_axis
        if tp is None:
            x = F.embedding(tokens, table)
        else:
            # this rank's vocabulary rows: the others' tokens look up 0
            local = tokens - self.vocab_start
            mine = (local >= 0) & (local < table.shape[0])
            x = F.embedding(torch.where(mine, local, 0), table)
            x = collectives.all_reduce(x * mine[..., None].to(x.dtype), tp)
        for block in self.blocks:
            x = block(x, positions, attention_fn)
        x = self.norm(x)
        if tp is not None:
            x = collectives.sum_grad(x, tp)
        # weight-tied head
        return F.linear(x, table)

    def param_layout(self):
        """{parameter name: spec} of the parameters this model splits
        over its ``model`` axis (empty without one)."""
        from elasticdl_tpu_torch.parallel.sharding import param_spec

        if self.model_axis is None:
            return {}
        out = {}
        for name, _ in self.named_parameters():
            spec = param_spec(name, self.mesh)
            if any(spec):
                out[name] = spec
        return out

    def init_parameters(self, generator):
        """Seeded weights (see :func:`init_parameters`); the hook
        ``nn/model_api.init_variables`` calls."""
        return init_parameters(self, generator)


def init_parameters(model, generator):
    """Random weights from ``generator`` at the reference's init scales:
    linear kernels and the embedding ~ N(0, 1/fan_in), biases 0, norm
    scales 1; the stacked expert weights (E, in, out) take flax's
    ``lecun_normal`` fan-in for that shape, E x in; buffers 0. Draws on
    the generator's device, then copies in. A tensor-parallel model
    draws each split parameter whole and keeps its part, so it starts
    from the weights the whole model draws from the same seed."""
    from elasticdl_tpu_torch.parallel.mesh import global_shape, shard_slices

    dev = generator.device
    layout = model.param_layout() if hasattr(model, "param_layout") else {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith(".bias"):
                param.zero_()
            elif "norm" in name:
                param.fill_(1.0)
            else:
                spec = layout.get(name)
                shape = tuple(param.shape)
                if spec is not None:
                    shape = global_shape(spec, shape, model.mesh)
                fan_in = shape[-1]
                if name.split(".")[-1] in MoEMlp.EXPERT_SHARDED:
                    fan_in = shape[0] * shape[1]
                draw = torch.empty(shape, device=dev).normal_(
                    0.0, fan_in ** -0.5, generator=generator
                )
                if spec is not None:
                    draw = draw[shard_slices(spec, shape, model.mesh)]
                param.copy_(draw)
        for buf in model.buffers():
            # the aux_loss buffers: no value before a training forward
            buf.zero_()
    return model


def custom_model(
    vocab_size=1024,
    num_layers=2,
    num_heads=4,
    head_dim=16,
    embed_dim=64,
    mlp_dim=256,
    dtype="float32",
    mesh=None,
    seq_axis=None,
    use_flash=True,
    num_experts=0,
    moe_capacity_factor=2.0,
    moe_num_selected=1,
    moe_aux_loss_coef=0.01,
    # placement-only params of the reference's distributed hooks,
    # accepted so one --model_params string serves both packages
    pipeline_stages=0,
    microbatches=0,
    tensor_parallel=0,
    min_tensor_parallel=0,
    shard_vocab=False,
):
    _check_mesh(mesh, seq_axis, num_experts)
    return TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        head_dim=head_dim,
        embed_dim=embed_dim,
        mlp_dim=mlp_dim,
        dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        use_flash=use_flash,
        mesh=mesh,
        seq_axis=seq_axis,
        num_experts=num_experts,
        moe_capacity_factor=moe_capacity_factor,
        moe_num_selected=moe_num_selected,
        moe_aux_loss_coef=moe_aux_loss_coef,
    )


def _check_mesh(mesh, seq_axis, num_experts):
    """Raise by name for the mesh forms that are not ported: a ``pipe``
    axis that splits, an ``expert`` axis with a ``model`` axis, and
    experts over a split sequence."""
    if mesh is None:
        return
    shape = mesh.shape
    if shape.get("pipe", 1) > 1:
        raise NotImplementedError(
            "transformer_lm with pipeline stages over a 'pipe' axis of %d "
            "is not ported yet (ROADMAP A9.3)" % shape["pipe"]
        )
    if shape.get("expert", 1) > 1 and shape.get("model", 1) > 1:
        raise NotImplementedError(
            "transformer_lm with experts over an 'expert' axis and tensor "
            "parallelism over a 'model' axis together is not ported yet "
            "(ROADMAP A9.6)"
        )
    if seq_axis is not None and seq_axis not in shape:
        raise ValueError("mesh %r has no axis %r" % (mesh, seq_axis))
    if num_experts and seq_axis is not None and shape[seq_axis] > 1:
        raise NotImplementedError(
            "transformer_lm with experts over a sequence-sharded mesh is "
            "not ported yet (ROADMAP A9.6)"
        )


def build_distributed_model(
    mesh, pipeline_stages=0, microbatches=0, dtype="float32", **params
):
    """Zoo hook for the ALLREDUCE trainers: the model over ``mesh`` (on
    a ``model`` axis, its tensor-parallel form; pair with
    :func:`param_shardings` and :func:`mesh_axes`). The pipelined form
    (``pipeline_stages > 1``) raises."""
    for placement in ("shard_vocab", "tensor_parallel", "min_tensor_parallel"):
        params.pop(placement, None)
    if int(pipeline_stages) > 1:
        raise NotImplementedError(
            "transformer_lm with pipeline_stages=%d (PipelinedTransformerLM)"
            " is not ported yet (ROADMAP A9.3)" % int(pipeline_stages)
        )
    return custom_model(mesh=mesh, dtype=dtype, **params)


def param_shardings(
    mesh,
    pipeline_stages=0,
    shard_vocab=False,
    tensor_parallel=0,
    min_tensor_parallel=0,
    num_experts=0,
    **_params,
):
    """With ``tensor_parallel > 1`` the TP rules (``parallel/sharding.
    tp_param_specs``) as suffix specs over ``model`` (a mixture of
    experts has no ``mlp_up``/``mlp_down``: its stacks replicate); with
    ``pipeline_stages > 1`` the stacked stages over ``pipe``; with
    ``shard_vocab`` the embedding's rows over ``data``. ``mesh=None`` is
    the probe: does this configuration split anything? None when not.
    The reference's checks and messages."""
    from elasticdl_tpu_torch.parallel.mesh import PartitionSpec as P

    specs = {}
    tp = max(int(tensor_parallel), int(min_tensor_parallel))
    if tp > 1 and int(pipeline_stages) > 1:
        raise ValueError(
            "tensor_parallel and pipeline_stages cannot combine yet: "
            "the pjit dense path and the collective pipeline use "
            "different step builders — pick one"
        )
    if tp > 1 and shard_vocab:
        raise ValueError(
            "shard_vocab is redundant with tensor_parallel (the TP "
            "rules already vocab-shard the embed table, over 'model')"
        )
    if tp > 1 and (mesh is None or "model" in mesh.axis_names):
        from elasticdl_tpu_torch.parallel.sharding import tp_param_specs

        specs.update(tp_param_specs())
        if num_experts:
            specs.pop("mlp_up")
            specs.pop("mlp_down")
    if int(pipeline_stages) > 1 and (
        mesh is None or "pipe" in mesh.axis_names
    ):
        specs["pipe"] = {"stages": {"**": P("pipe")}}
    if shard_vocab and (mesh is None or "data" in mesh.axis_names):
        specs["embed"] = {"weight": P("data", None)}
    return specs or None


def mesh_axes(
    n_devices,
    pipeline_stages=0,
    tensor_parallel=0,
    min_tensor_parallel=0,
    **_params,
):
    """Zoo hook: the mesh shape of this configuration, the reference's
    answers: ``{"data": n / T, "model": T}`` (row-major: consecutive
    ranks fill the model axis), ``{"data": n / S, "pipe": S}``, or None
    (the default all-data mesh)."""
    stages = int(pipeline_stages)
    tp = max(int(tensor_parallel), int(min_tensor_parallel))
    if tp > 1:
        if stages > 1:
            raise ValueError(
                "tensor_parallel does not combine with pipeline_stages"
            )
        if n_devices % tp:
            raise ValueError(
                "%d devices do not divide into tensor_parallel=%d"
                % (n_devices, tp)
            )
        return {"data": n_devices // tp, "model": tp}
    if stages > 1:
        if n_devices % stages:
            raise ValueError(
                "%d devices do not divide into %d pipeline stages"
                % (n_devices, stages)
            )
        return {"data": n_devices // stages, "pipe": stages}
    return None


def loss(output, labels):
    """Next-token cross entropy; position 0 predicts token 1, etc. Runs
    in the output's dtype (optax's ``softmax_cross_entropy_with_integer_
    labels`` on the output as it comes)."""
    logits = output[:, :-1]
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    targets = labels.to(device=output.device, dtype=torch.long)[:, 1:]
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
    )


def _adamw(params, lr):
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def optimizer(lr=3e-3):
    """A factory ``params -> AdamW`` with ``optax.adamw(lr)``'s settings:
    b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter
    (norm scales and biases included; torch's own default is 1e-2)."""
    return functools.partial(_adamw, lr=lr)


def dataset_fn(dataset, mode, _):
    def _parse_data(record):
        r = parse_example(record, {"tokens": FixedLenFeature([64], np.int64)})
        tokens = r["tokens"].astype(np.int32)
        features = {"tokens": tokens}
        if mode == Mode.PREDICTION:
            return features
        return features, tokens

    dataset = dataset.map(_parse_data)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024)
    return dataset


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def eval_metrics_fn():
    def _token_accuracy(labels, predictions):
        pred = np.argmax(_numpy(predictions)[:, :-1], axis=-1)
        tgt = _numpy(labels)[:, 1:]
        return (pred == tgt).reshape(-1)

    return {"token_accuracy": _token_accuracy}
