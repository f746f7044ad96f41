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

Not ported yet (ROADMAP A9): a ``model`` axis (tensor parallelism),
pipeline stages over a ``pipe`` axis, and the mixture of experts over a
sequence-sharded mesh; each raises by name.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.ops.flash_attention import pick_causal_attention
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


class Block(nn.Module):
    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, dtype,
                 num_experts=0, mesh=None, moe_capacity_factor=2.0,
                 moe_num_selected=1, moe_aux_loss_coef=0.01):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
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
        heads = (b, l, self.num_heads, self.head_dim)
        h = self.attn_norm(x)
        q = _rotary(_dense(self.query, h, self.dtype).view(heads), positions)
        k = _rotary(_dense(self.key, h, self.dtype).view(heads), positions)
        v = _dense(self.value, h, self.dtype).view(heads)
        attn = attention_fn(q, k, v)
        x = x + _dense(self.out, attn.reshape(b, l, -1), self.dtype)
        h = self.mlp_norm(x)
        if hasattr(self, "moe_mlp"):
            return x + self.moe_mlp(h)
        h = F.gelu(_dense(self.mlp_up, h, self.dtype), approximate="tanh")
        return x + _dense(self.mlp_down, h, self.dtype)


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
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(
                embed_dim, num_heads, head_dim, mlp_dim, dtype,
                num_experts=num_experts, mesh=mesh,
                moe_capacity_factor=moe_capacity_factor,
                moe_num_selected=moe_num_selected,
                moe_aux_loss_coef=moe_aux_loss_coef,
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
        at its offset and attention is the ring."""
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
        x = F.embedding(tokens, table)
        for block in self.blocks:
            x = block(x, positions, attention_fn)
        x = self.norm(x)
        # weight-tied head
        return F.linear(x, table)

    def init_parameters(self, generator):
        """Seeded weights (see :func:`init_parameters`); the hook
        ``nn/model_api.init_variables`` calls."""
        return init_parameters(self, generator)


def init_parameters(model, generator):
    """Random weights from ``generator`` at the reference's init scales:
    linear kernels and the embedding ~ N(0, 1/fan_in), biases 0, norm
    scales 1; the stacked expert weights (E, in, out) take flax's
    ``lecun_normal`` fan-in for that shape, E x in; buffers 0. Draws on
    the generator's device, then copies in."""
    dev = generator.device
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith(".bias"):
                param.zero_()
            elif "norm" in name:
                param.fill_(1.0)
            else:
                fan_in = param.shape[-1]
                if name.split(".")[-1] in MoEMlp.EXPERT_SHARDED:
                    fan_in = param.shape[0] * param.shape[1]
                draw = torch.empty(param.shape, device=dev).normal_(
                    0.0, fan_in ** -0.5, generator=generator
                )
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
    """Raise by name for the mesh forms that are not ported: a ``model``
    or ``pipe`` axis that splits, and experts over a split sequence."""
    if mesh is None:
        return
    shape = mesh.shape
    for axis, what in (("model", "tensor parallelism over a 'model' axis"),
                       ("pipe", "pipeline stages over a 'pipe' axis")):
        if shape.get(axis, 1) > 1:
            raise NotImplementedError(
                "transformer_lm with %s of %d is not ported yet (ROADMAP "
                "A9)" % (what, shape[axis])
            )
    if seq_axis is not None and seq_axis not in shape:
        raise ValueError("mesh %r has no axis %r" % (mesh, seq_axis))
    if num_experts and seq_axis is not None and shape[seq_axis] > 1:
        raise NotImplementedError(
            "transformer_lm with experts over a sequence-sharded mesh is "
            "not ported yet (ROADMAP A9)"
        )


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
