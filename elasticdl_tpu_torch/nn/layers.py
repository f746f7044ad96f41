"""Counterparts of the flax layers the port's zoo models use.

- :class:`Conv`: ``nn.Conv`` over NCHW with XLA's "SAME" padding (an
  uneven pad is applied explicitly) or an explicit one; the weight is
  cast to the compute dtype at use, in ``torch.channels_last``, so that
  cuDNN takes its NHWC kernels for channels_last activations.
- :class:`BatchNorm`: ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``. A
  training forward normalizes with the batch's own statistics, computed
  in float32 (``torch.native_batch_norm``, output in the compute dtype,
  as flax's ``_normalize`` casts), and the running averages move as
  ``0.9 * running + 0.1 * batch`` with the *biased* batch variance, where
  ``torch.nn.BatchNorm2d`` keeps the unbiased one (and counts batches,
  which flax does not). The new averages leave through
  ``nn/model_api.apply_model``'s state collector; the buffers passed in
  are never written.
- :func:`max_pool_same`: ``nn.max_pool(..., padding="SAME")``, which pads
  with -inf where XLA puts the padding (at an even size, one row and
  column after the input and none before) and then pools.
- :func:`lecun_normal_`: flax's default kernel init.
- :class:`Embed`: ``nn.Embed``, a ``(num_embeddings, features)`` table
  looked up by :func:`take_rows`; :func:`embed_normal_` is its init.
- :func:`take_rows`: ``jnp.take(table, ids, axis=0)``, a gather whose
  gradient is the dense table gradient, as ``jnp.take``'s is under
  ``jit``, with the reference's handling of ids outside the table.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def as_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def same_pads(size, kernel, stride):
    """(before, after) padding of XLA's "SAME" along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: ``padding`` is "SAME" or explicit
    ``(pad_h, pad_w)``; the weight is ``(out, in, kh, kw)``."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME",
                 bias=False, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel = kernel
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.kernel, self.stride)
            pw = same_pads(x.shape[3], self.kernel, self.stride)
        else:
            ph = (self.padding[0],) * 2
            pw = (self.padding[1],) * 2
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        else:
            pad = (ph[0], pw[0])
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, self.stride, pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over channel dim 1 (see the module doc)."""

    def __init__(self, features, dtype=torch.float32, momentum=0.9,
                 eps=1e-5, zero_scale=False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.zero_scale = zero_scale
        self._state_collector = None  # set by apply_model

    def forward(self, x):
        x = x.to(self.dtype)
        # statistics and the affine in at least float32, as flax's
        # force_float32_reductions keeps them
        stat = torch.promote_types(self.dtype, torch.float32)
        weight, bias = self.weight.to(stat), self.bias.to(stat)
        if not self.training:
            return torch.native_batch_norm(
                x, weight, bias, self.running_mean.to(stat),
                self.running_var.to(stat), False, 0.0, self.eps,
            )[0]
        y, mean, invstd = torch.native_batch_norm(
            x, weight, bias, None, None, True, 0.0, self.eps
        )
        if self._state_collector is not None:
            prefix, updates = self._state_collector
            with torch.no_grad():
                # the biased batch variance, from 1 / sqrt(var + eps)
                var = (invstd.pow(-2) - self.eps).clamp_min(0.0)
                m = self.momentum
                updates[prefix + "running_mean"] = (
                    m * self.running_mean + (1 - m) * mean
                )
                updates[prefix + "running_var"] = (
                    m * self.running_var + (1 - m) * var
                )
        return y


def max_pool_same(x, kernel=3, stride=2):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: -inf
    padding where XLA puts it, then an unpadded pool."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return F.max_pool2d(x, kernel, stride)


def lecun_normal_(weight, fan_in, generator):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(weight.shape, device=generator.device)
    nn.init.trunc_normal_(
        draw, 0.0, std, -2 * std, 2 * std, generator=generator
    )
    weight.copy_(draw)


def embed_normal_(table, generator):
    """flax's ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``
    of a ``(rows, features)`` table: a plain normal of variance 1 /
    features."""
    draw = torch.randn(table.shape, device=generator.device,
                       generator=generator)
    table.copy_(draw.mul_(1.0 / math.sqrt(table.shape[1])))


def take_rows(table, ids, mode="fill"):
    """The rows of ``table`` at ``ids`` (any shape) -> ids.shape + (D,).

    ``mode="fill"`` is ``jnp.take``'s default: an id in [-V, 0) counts
    from the end, any other id outside [0, V) reads a row of NaN.
    ``mode="zero"``: an id outside [0, V) reads a row of zeros, as the
    reference's vocab-sharded ``psum`` lookup does (no shard owns it).
    An id outside the table passes no gradient. The ids are checked on
    the device, with no host sync: the plain gather would fault on the
    card."""
    n = table.shape[0]
    ids = ids.long()
    if mode == "fill":
        ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    fill = float("nan") if mode == "fill" else 0.0
    return rows.where(inside[..., None], rows.new_full((), fill))


class Embed(nn.Module):
    """flax ``nn.Embed``: ``weight`` is the ``(num_embeddings, features)``
    table (the reference's ``embedding``, untransposed)."""

    def __init__(self, num_embeddings, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids):
        return take_rows(self.weight, ids)

    def init_parameters(self, generator):
        with torch.no_grad():
            embed_normal_(self.weight, generator)
        return self
