"""Plain attention, the counterpart of ``reference_attention`` in
``elasticdl_tpu/parallel/ring_attention.py``.

Only the single-device reference is ported so far: it is what
:func:`~elasticdl_tpu_torch.ops.flash_attention.pick_causal_attention`
returns below the flash threshold. The sequence-sharded ring is a later
slice of the port.
"""

import torch


def _causal_bias(lq, lk, dtype, device):
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lk, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    lowest = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=device)
    return torch.where(q_pos >= k_pos, zero, lowest)


def reference_attention(q, k, v, causal=False):
    """Plain attention over (B, L, H, D): scores in the input dtype,
    softmax and the value product in float32, output in the input dtype
    (the reference's order of casts)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s + _causal_bias(q.shape[1], k.shape[1], q.dtype, q.device)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
