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
``eval_metrics_fn``. Not ported yet: mixture-of-experts MLPs, the mesh
and sequence-parallel (ring) forms, and the pipelined model.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.ops.flash_attention import pick_causal_attention


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


class Block(nn.Module):
    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, dtype):
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
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.use_flash = use_flash
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, head_dim, mlp_dim, dtype)
            for _ in range(num_layers)
        )
        self.norm = RMSNorm(embed_dim, dtype)

    def forward(self, features, attention_fn=None):
        """``features``: a ``{"tokens": (B, L) ints}`` dict or the token
        array itself -> (B, L, vocab) logits in the compute dtype.
        ``attention_fn(q, k, v)`` overrides the causal attention the
        length picks (a check swaps in the kernel's plain version)."""
        tokens = features["tokens"] if isinstance(features, dict) else features
        device = self.embed.weight.device
        if not isinstance(tokens, torch.Tensor):
            # wire arrays are read-only views: one owned copy
            tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
        tokens = tokens.to(device=device, dtype=torch.long)
        b, l = tokens.shape
        positions = torch.arange(l, device=device).expand(b, l)
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
    scales 1. Draws on the generator's device, then copies in."""
    dev = generator.device
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith(".bias"):
                param.zero_()
            elif "norm" in name:
                param.fill_(1.0)
            else:
                fan_in = param.shape[-1]
                draw = torch.empty(param.shape, device=dev).normal_(
                    0.0, fan_in ** -0.5, generator=generator
                )
                param.copy_(draw)
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
    if num_experts:
        raise NotImplementedError(
            "transformer_lm with num_experts > 0 (MoE) is not ported yet"
        )
    if mesh is not None or seq_axis is not None:
        raise NotImplementedError(
            "transformer_lm over a mesh / sequence axis is not ported yet"
        )
    return TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        head_dim=head_dim,
        embed_dim=embed_dim,
        mlp_dim=mlp_dim,
        dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        use_flash=use_flash,
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
