"""Ring attention, the counterpart of
``elasticdl_tpu/parallel/ring_attention.py``: exact attention over
sequence-sharded inputs.

Each rank of a mesh's ``seq`` axis keeps its Q shard resident while the
K/V shards rotate around the ring (``parallel/collectives.ring_shift``,
the reference's ``ppermute``); partial outputs merge with the
online-softmax recurrence, so no (L, L) score matrix is formed.

- :func:`ring_attention`: the plain ring. Each block's scores and
  softmax statistics are formed in float32 (:func:`_block_attend`) and
  merged unnormalized (:func:`_merge`); autograd differentiates through
  the rotation.
- :func:`ring_flash_attention`: each visible block is one launch of the
  flash forward (``ops/flash_attention.flash_fwd``), merged by its
  logsumexp (:func:`_merge_normalized`). The backward is one
  ``torch.autograd.Function`` that rotates K/V again with their gradient
  accumulators and runs the two backward kernels per block against the
  global ``out`` and ``lse``, with ``delta = rowsum(dO * O)`` taken once
  from the global output. Causal blocks are all-or-nothing
  (:func:`_block_cases`): the diagonal, fully visible, or skipped. So
  rank ``r`` of ``n`` launches ``r + 1`` forwards per layer and as many
  of each backward kernel, the reference's imbalance.
- :func:`make_ring_attention`: the model's attention over a mesh's
  ``seq`` axis; shard lengths the kernel cannot tile take the plain
  ring, as in the reference.
- :func:`reference_attention`: plain attention on one device.

On CUDA tensors a block launches the kernels; on CPU tensors it computes
their plain versions (``plain_flash_with_lse``, ``plain_flash_bwd``),
the tests' path through the same Function.
"""

import torch

from elasticdl_tpu_torch.parallel import collectives


def _causal_bias(lq, lk, dtype, device, q_offset=0, k_offset=0):
    q_pos = q_offset + torch.arange(lq, device=device)[:, None]
    k_pos = k_offset + torch.arange(lk, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    lowest = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=device)
    return torch.where(q_pos >= k_pos, zero, lowest)


def _block_attend(q, k, v, bias=None):
    """Scores + flash statistics for one (Q_block, KV_block) pair.

    q: (B, Lq, H, D), k/v: (B, Lk, H, D). Returns (out_unnorm, row_max,
    row_sum) with out_unnorm = exp(s - row_max) @ v, all in float32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1)  # (B, H, Lq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)  # (B, H, Lq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two flash partials (associative online-softmax combine)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = (
        o1 * a1.permute(0, 2, 1)[..., None]
        + o2 * a2.permute(0, 2, 1)[..., None]
    )
    l = l1 * a1 + l2 * a2
    return o, m, l


def ring_attention(q, k, v, axis, causal=False):
    """Exact attention with K/V rotating around ``axis`` (a mesh
    :class:`Axis`); q, k, v: this rank's (B, L_local, H, D) shards.
    Returns (B, L_local, H, D) in q's dtype."""
    n = axis.size
    my_idx = axis.index
    b, l_local, h, d = q.shape
    o = torch.zeros((b, l_local, h, d), dtype=torch.float32, device=q.device)
    m = torch.full(
        (b, h, l_local), torch.finfo(torch.float32).min,
        dtype=torch.float32, device=q.device,
    )
    l = torch.zeros((b, h, l_local), dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for step in range(n):
        bias = None
        if causal:
            # the K/V block now held came from rank (my_idx - step) % n
            src = (my_idx - step) % n
            bias = _causal_bias(
                l_local, kk.shape[1], q.dtype, q.device,
                my_idx * l_local, src * l_local,
            )
        bo, bm, bl = _block_attend(q, kk, vv, bias)
        o, m, l = _merge(o, m, l, bo, bm, bl)
        if step < n - 1:
            kk = collectives.ring_shift(kk, axis)
            vv = collectives.ring_shift(vv, axis)
    out = o / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def _merge_normalized(o1, lse1, o2, lse2):
    """Merge two *normalized* partial attentions by their logsumexps."""
    lse = torch.logaddexp(lse1, lse2)
    # both sides empty (fully masked so far): weights 0, not NaN
    finite = torch.isfinite(lse)
    safe = torch.where(finite, lse, torch.zeros_like(lse))
    zero = torch.zeros_like(lse)
    w1 = torch.where(finite, torch.exp(lse1 - safe), zero)
    w2 = torch.where(finite, torch.exp(lse2 - safe), zero)
    o = (
        o1 * w1.permute(0, 2, 1)[..., None]
        + o2 * w2.permute(0, 2, 1)[..., None]
    )
    return o, lse


def _block_cases(src, my_idx, causal):
    """Ring blocks see equal-size shards, so causal masking is all-or-
    nothing per block: ``"diag"`` (src == my), ``"full"`` (src < my, or
    not causal), or ``"skip"`` (src > my)."""
    if not causal:
        return "full"
    if src == my_idx:
        return "diag"
    return "full" if src < my_idx else "skip"


def _block_fwd(q, kk, vv, block_causal, plain):
    from elasticdl_tpu_torch.ops import flash_attention as fa

    if plain:
        return fa.plain_flash_with_lse(q, kk, vv, block_causal)
    return fa.flash_fwd(q, kk, vv, block_causal)


def _block_bwd(q, kk, vv, out, lse, g, delta, block_causal, plain):
    from elasticdl_tpu_torch.ops import flash_attention as fa

    if plain or not q.is_cuda:
        return fa.plain_flash_bwd(q, kk, vv, out, lse, g, block_causal)
    dq = fa.flash_bwd_dq(q, kk, vv, g, lse, delta, block_causal)
    dk, dv = fa.flash_bwd_dkv(q, kk, vv, g, lse, delta, block_causal)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    """The kernel ring: forward per block by the flash forward, merged
    by lse; backward per block by the two backward kernels against the
    global lse and out, the gradient accumulators of K/V rotating with
    them until each is home. ``plain`` runs every block through the
    kernels' plain versions (a check holds the kernel ring against it)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, plain):
        n, my_idx = axis.size, axis.index
        b, l_local, h, d = q.shape
        o = torch.zeros(
            (b, l_local, h, d), dtype=torch.float32, device=q.device
        )
        lse = torch.full(
            (b, h, l_local), float("-inf"), dtype=torch.float32,
            device=q.device,
        )
        kk, vv = k, v
        for step in range(n):
            case = _block_cases((my_idx - step) % n, my_idx, causal)
            if case != "skip":
                o_b, lse_b = _block_fwd(q, kk, vv, case == "diag", plain)
                o, lse = _merge_normalized(o, lse, o_b.float(), lse_b)
            if step < n - 1:
                kk = collectives.ring_shift_raw(kk, axis)
                vv = collectives.ring_shift_raw(vv, axis)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.plain = axis, causal, plain
        return out

    @staticmethod
    def backward(ctx, g):
        from elasticdl_tpu_torch.ops.flash_attention import flash_delta

        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, plain = ctx.axis, ctx.causal, ctx.plain
        n, my_idx = axis.size, axis.index
        delta = None
        if q.is_cuda and not plain:
            delta = flash_delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dvv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kk, vv = k, v
        for step in range(n):
            case = _block_cases((my_idx - step) % n, my_idx, causal)
            if case != "skip":
                dq_b, dk_b, dv_b = _block_bwd(
                    q, kk, vv, out, lse, g, delta, case == "diag", plain
                )
                dq += dq_b.float()
                dkk += dk_b.float()
                dvv += dv_b.float()
            # the accumulators travel WITH their K/V blocks: after n
            # shifts each is home again
            if step < n - 1:
                kk = collectives.ring_shift_raw(kk, axis)
                vv = collectives.ring_shift_raw(vv, axis)
            dkk = collectives.ring_shift_raw(dkk, axis)
            dvv = collectives.ring_shift_raw(dvv, axis)
        return (
            dq.to(q.dtype), dkk.to(k.dtype), dvv.to(v.dtype),
            None, None, None,
        )


def ring_flash_attention(q, k, v, axis, causal=False, block_q=None,
                         block_k=None, plain=False):
    """Ring attention whose per-block compute is the flash kernels; q,
    k, v: this rank's (B, L_local, H, D) shards over ``axis``. Block
    sizes are the reference's, checked against the shard length."""
    from elasticdl_tpu_torch.ops.flash_attention import (
        _block_sizes,
        auto_blocks,
    )

    block_q, block_k = auto_blocks(q.shape[1], k.shape[1], block_q, block_k)
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    return _RingFlash.apply(q, k, v, axis, bool(causal), bool(plain))


def make_ring_attention(mesh, seq_axis="seq", causal=False, use_flash=True,
                        block_q=128, block_k=128):
    """``(q, k, v) -> out`` over ``mesh[seq_axis]``, on this rank's
    (B, L_local, H, D) shards (its slice of the batch over ``data`` too,
    where the mesh has that axis: each data slice rings alone).

    ``use_flash`` (default) runs the flash kernels per block with the
    blockwise ring backward; shard lengths the kernel cannot tile take
    the plain ring. On a mesh with a ``model`` axis the heads are split
    over it (the reference's ``P(data, seq, model, None)``): this rank's
    q, k, v already hold its heads, so the ring runs over its ``seq``
    group alone, each ``model`` slice its own ring."""
    from elasticdl_tpu_torch.parallel.mesh import Axis, WorldMesh

    if isinstance(mesh, WorldMesh):
        axis = mesh.axis(seq_axis)
    elif seq_axis in mesh.shape:
        # a one-device mesh: a ring of one
        axis = Axis(seq_axis, 1, 0, (0,), None)
    else:
        raise ValueError("mesh %r has no axis %r" % (mesh, seq_axis))

    def _ring(q, k, v):
        from elasticdl_tpu_torch.ops.flash_attention import divisible

        if use_flash and divisible(q.shape[1], k.shape[1], block_q, block_k):
            return ring_flash_attention(
                q, k, v, axis, causal=causal, block_q=block_q,
                block_k=block_k,
            )
        # shard lengths the kernel can't tile keep the plain ring
        return ring_attention(q, k, v, axis, causal=causal)

    return _ring


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
