"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch twin.

The counterpart of ``elasticdl_tpu/ops/flash_attention.py``. Same public
names and contract: ``(B, L, H, D)`` tensors, ``flash_attention_with_lse``
returning ``(out, lse)`` with ``lse`` of shape ``(B, H, L)`` in float32,
lengths that do not divide the block sizes rejected with ``ValueError``,
and :func:`pick_causal_attention` choosing the kernel from ``L >= 1024``
with 128-divisible lengths, plain attention otherwise.

- On a CUDA tensor the wrapper launches ``csrc/flash_fwd.cu`` (built at
  first use, see ``ops/build.py``) or raises; it never falls back.
- On a CPU tensor it computes :func:`plain_flash_with_lse`, the same
  function as masked softmax attention in float32 — the tests' path.

Only the forward is ported: the blockwise backward kernels serve
training, a later slice of the port.
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


launches = LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_fwd.cu"


def _library():
    from elasticdl_tpu_torch.ops.build import load_library

    lib = load_library(_SOURCE)
    fn = lib.edl_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    fn = _library()
    dims = (ctypes.c_longlong * 5)(b, h, lq, lk, d)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dims, strides, _DTYPE_CODES[q.dtype],
            int(bool(causal)), d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_fwd kernel launch failed: cudaError %d (%s)"
            % (err, torch.cuda.get_device_name(q.device))
        )
    launches.add(
        (b, lq, lk, h, d, str(q.dtype).replace("torch.", ""), bool(causal))
    )
    return out, lse


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

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    block_q, block_k = auto_blocks(
        q.shape[1], k.shape[1], block_q, block_k
    )
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return plain_flash_with_lse(q, k, v, causal)
    return _flash_fwd_kernel(q, k, v, causal)


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None):
    """(B, L, H, D) attention through the flash forward."""
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
