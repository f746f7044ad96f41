"""Flash attention, forward and backward: hand-written Hopper kernels
and their plain PyTorch twins.

The counterpart of ``elasticdl_tpu/ops/flash_attention.py``. Same public
names and contract: ``(B, L, H, D)`` tensors, ``flash_attention_with_lse``
returning ``(out, lse)`` with ``lse`` of shape ``(B, H, L)`` in float32,
lengths that do not divide the block sizes rejected with ``ValueError``,
and :func:`pick_causal_attention` choosing the kernel from ``L >= 1024``
with 128-divisible lengths, plain attention otherwise.

Both public functions go through one ``torch.autograd.Function``
(:class:`_FlashWithLse`, the counterpart of the reference's
``custom_vjp``): the forward saves ``q, k, v, out, lse`` and never an
(L, L) tensor; the backward computes ``delta = rowsum(dO * O) - g_lse``
and then dQ, and dK with dV, blockwise.

- On CUDA tensors the forward launches ``csrc/flash_fwd.cu`` and the
  backward the two kernels of ``csrc/flash_bwd.cu`` (built at first use,
  see ``ops/build.py``), or raises; nothing falls back.
- On CPU tensors they compute :func:`plain_flash_with_lse` and
  :func:`plain_flash_bwd`, the same functions in float32 — the tests'
  path, through the same Function.
"""

import ctypes
import functools
import threading

import torch

NEG_INF = -1e30  # the TPU kernel's mask value, kept for identical lse


class LaunchCounter:
    """Counts kernel launches, and the shapes they were launched at, so
    a run can show that its main path went through the kernel."""

    def __init__(self):
        self._mu = threading.Lock()
        self._count = 0
        self._shapes = {}

    def add(self, shape):
        with self._mu:
            self._count += 1
            self._shapes[shape] = self._shapes.get(shape, 0) + 1

    @property
    def count(self):
        with self._mu:
            return self._count

    def shapes(self):
        """{(B, Lq, Lk, H, D, dtype name, causal): launches}."""
        with self._mu:
            return dict(self._shapes)

    def reset(self):
        with self._mu:
            self._count = 0
            self._shapes = {}


launches = LaunchCounter()  # flash_fwd
bwd_dq_launches = LaunchCounter()  # flash_bwd_dq
bwd_dkv_launches = LaunchCounter()  # flash_bwd_dkv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel(source, symbol, n_pointers):
    """The C entry ``symbol`` of ``csrc/<source>``: ``n_pointers`` device
    pointers, then dims, strides, dtype, causal, scale and the stream."""
    from elasticdl_tpu_torch.ops.build import load_library

    fn = getattr(load_library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, fn, tensors, dims, strided, dtype, causal, scale):
    """Call ``fn`` on the current stream of the tensors' card; raise on a
    refused launch."""
    device = tensors[0].device
    dims = (ctypes.c_longlong * len(dims))(*dims)
    strides = [s for t in strided for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in tensors), dims, strides,
            _DTYPE_CODES[dtype], int(bool(causal)), scale, stream,
        )
    if err != 0:
        raise RuntimeError(
            "%s kernel launch failed: cudaError %d (%s)"
            % (name, err, torch.cuda.get_device_name(device))
        )


def _shape_key(q, lk, causal):
    b, lq, h, d = q.shape
    return (b, lq, lk, h, d, str(q.dtype).replace("torch.", ""), bool(causal))


def plain_flash_with_lse(q, k, v, causal=False):
    """The kernel's function in plain PyTorch: masked softmax attention
    computed in float32 from the inputs, ``out`` cast back to the input
    dtype, ``lse`` = logsumexp of the scaled, masked scores."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(lq, device=q.device)[:, None]
        k_pos = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.permute(
        0, 2, 1, 3
    )
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_delta(out, g, g_lse=None):
    """``rowsum(dO * O) - g_lse`` as (B, H, L) float32, dO cast to the
    output's dtype first (the reference's ``_flash_bwd`` preamble). An
    lse cotangent folds in here: d lse / d s = p, so
    ``ds = p * (dp - delta + g_lse)``."""
    # one float32 copy of dO, multiplied by O in place (exact products)
    prod = g.to(out.dtype).to(torch.float32, copy=True).mul_(out)
    delta = prod.sum(-1).permute(0, 2, 1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def plain_flash_bwd(q, k, v, out, lse, g, causal=False, g_lse=None):
    """Both backward kernels' function in plain PyTorch, in float32:
    ``p = exp(s * scale - lse)`` recomputed from the inputs, ``dp = dO
    V^T``, ``ds = p * (dp - delta)``, then ``dq = ds K * scale``, ``dk =
    ds^T Q * scale`` and ``dv = p^T dO``, each cast to its input's
    dtype."""
    d = q.shape[-1]
    scale = d ** -0.5
    delta = flash_delta(out, g, g_lse)
    qf, kf, vf = q.float(), k.float(), v.float()
    gf = g.to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            "flash kernel needs q, k, v on one CUDA device; got %s/%s/%s"
            % (q.device, k.device, v.device)
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or (
        v.dtype != q.dtype
    ):
        raise ValueError(
            "flash kernel takes float32 or bfloat16 q/k/v of one dtype; "
            "got %s/%s/%s" % (q.dtype, k.dtype, v.dtype)
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel takes (B, L, H, D) tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            "k/v shape %s does not match q shape %s"
            % (tuple(k.shape), tuple(q.shape))
        )
    if d % 8 or d > 128:
        raise ValueError(
            "flash kernel takes head_dim a multiple of 8 up to 128, got %d"
            % d
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                "flash kernel needs a unit-stride head dim (%s strides %s)"
                % (name, t.stride())
            )


def _flash_fwd_kernel(q, k, v, causal):
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    _check_kernel_inputs(q, k, v)
    check_alignment(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", _kernel("flash_fwd.cu", "edl_flash_fwd", 5),
        (q, k, v, out, lse), (b, h, lq, lk, d), (q, k, v, out), q.dtype,
        causal, d ** -0.5,
    )
    launches.add(_shape_key(q, lk, causal))
    return out, lse


def aligned_16(t):
    """True when 16-byte copies can read ``t`` as the bf16 kernels read
    their (B, L, H, D) inputs: its data pointer and every stride but the
    head dim's (the last) are multiples of 16 bytes."""
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s * item % 16 == 0 for s in t.stride()[:-1]
    )


def check_alignment(q, k, v):
    """Raise ``ValueError`` for bf16 q, k or v that is not
    :func:`aligned_16`: the bf16 forward and backward kernels read them
    in 16-byte copies. The f32 kernels load scalars and take any such
    view."""
    if q.dtype != torch.bfloat16:
        return
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not aligned_16(t):
            raise ValueError(
                "bf16 flash kernels read %s in 16-byte copies: "
                "its data pointer and its batch, sequence and head "
                "strides must be multiples of 16 bytes (pointer %% 16 = "
                "%d, strides %s of 2-byte elements)"
                % (name, t.data_ptr() % 16, t.stride())
            )


def _bwd_inputs(q, k, v, g, lse):
    """Checked kernel inputs of the backward (:func:`check_alignment`):
    dO in q's dtype with a unit-stride head dim, in bf16 copied where
    16-byte copies cannot read it; lse contiguous."""
    _check_kernel_inputs(q, k, v)
    check_alignment(q, k, v)
    g = g.to(q.dtype)
    if g.shape != q.shape:
        raise ValueError(
            "dO shape %s does not match q %s"
            % (tuple(g.shape), tuple(q.shape))
        )
    if g.stride(3) != 1 or (g.dtype == torch.bfloat16 and not aligned_16(g)):
        g = g.clone(memory_format=torch.contiguous_format)
    return g, lse.contiguous()


def flash_bwd_dq(q, k, v, g, lse, delta, causal):
    """dq by ``csrc/flash_bwd.cu``'s first kernel, on the current
    stream; ``delta`` from :func:`flash_delta`."""
    g, lse = _bwd_inputs(q, k, v, g, lse)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(
        "flash_bwd_dq", _kernel("flash_bwd.cu", "edl_flash_bwd_dq", 7),
        (q, k, v, g, lse, delta, dq), (b, h, lq, lk, d), (q, k, v, g, dq),
        q.dtype, causal, d ** -0.5,
    )
    bwd_dq_launches.add(_shape_key(q, lk, causal))
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal):
    """(dk, dv) by ``csrc/flash_bwd.cu``'s second kernel, on the current
    stream."""
    g, lse = _bwd_inputs(q, k, v, g, lse)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(
        "flash_bwd_dkv", _kernel("flash_bwd.cu", "edl_flash_bwd_dkv", 8),
        (q, k, v, g, lse, delta, dk, dv), (b, h, lq, lk, d),
        (q, k, v, g, dk, dv), q.dtype, causal, d ** -0.5,
    )
    bwd_dkv_launches.add(_shape_key(q, lk, causal))
    return dk, dv


class _FlashWithLse(torch.autograd.Function):
    """(out, lse) with the blockwise backward; an lse cotangent (a z-loss,
    a ring merge) propagates through ``delta``. Autograd passes ``None``
    for an output the loss did not use: it counts as zero."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = plain_flash_with_lse(q, k, v, causal)
        else:
            out, lse = _flash_fwd_kernel(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        if q.device.type == "cpu":
            dq, dk, dv = plain_flash_bwd(
                q, k, v, out, lse, g, ctx.causal, g_lse
            )
        else:
            delta = flash_delta(out, g, g_lse)
            dq = flash_bwd_dq(q, k, v, g, lse, delta, ctx.causal)
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def divisible(lq, lk, block_q, block_k):
    """True when these lengths tile into these block sizes."""
    bq, bk = min(block_q, lq), min(block_k, lk)
    return not (lq % bq or lk % bk)


def _block_sizes(lq, lk, block_q, block_k):
    block_q = min(block_q, lq)
    block_k = min(block_k, lk)
    if lq % block_q or lk % block_k:
        raise ValueError(
            "sequence lengths (%d, %d) must divide block sizes (%d, %d)"
            % (lq, lk, block_q, block_k)
        )
    return block_q, block_k


def auto_blocks(lq, lk, block_q=None, block_k=None):
    """The reference's block-size resolution, kept so the same lengths
    are accepted and rejected. The CUDA kernel tiles by its own 64-row
    tiles; these sizes decide only what :func:`_block_sizes` accepts."""
    if block_q is None:
        block_q = next(
            (b for b in (1024, 512, 256, 128) if lq % b == 0), 128
        )
    if block_k is None:
        block_k = next(
            (b for b in (1024, 512, 256, 128) if lk % b == 0), 128
        )
    return block_q, block_k


def flash_attention_with_lse(
    q, k, v, causal=False, block_q=None, block_k=None
):
    """(B, L, H, D) attention returning (out, lse (B, H, L) float32).

    CUDA tensors launch the kernels; CPU tensors take the plain versions.
    Differentiable in q, k and v, through both outputs.
    """
    block_q, block_k = auto_blocks(
        q.shape[1], k.shape[1], block_q, block_k
    )
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    return _FlashWithLse.apply(q, k, v, bool(causal))


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None):
    """(B, L, H, D) attention; trains with the blockwise backward."""
    out, _ = flash_attention_with_lse(q, k, v, causal, block_q, block_k)
    return out


def pick_causal_attention(seq_len, use_flash=True, min_flash_len=1024):
    """Causal attention fn for a model at this sequence length: the
    flash kernel from ``min_flash_len`` up at 128-divisible lengths,
    plain attention otherwise — the reference's rule, unchanged until
    this card's own threshold is measured."""
    if (
        use_flash
        and seq_len >= min_flash_len
        and divisible(seq_len, seq_len, 128, 128)
    ):
        return lambda q, k, v: flash_attention(q, k, v, True)
    from elasticdl_tpu_torch.parallel.ring_attention import (
        reference_attention,
    )

    return functools.partial(reference_attention, causal=True)
