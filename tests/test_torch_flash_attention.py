"""The port's flash attention (its plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode, and the port's plain
attention against the JAX reference attention."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.parallel import ring_attention as jring
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.parallel import ring_attention as tring

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_ATOL = 0.1


def _qkv(b=2, l=64, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((b, l, h, d)).astype(np.float32)
        for _ in range(3)
    )


def _to_jax(arrays, dtype):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


def _to_torch(arrays, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


SHAPES = [
    dict(b=2, l=64, h=2, d=16),
    dict(b=1, l=64, h=2, d=96),
]


@pytest.mark.parametrize("shape", SHAPES, ids=["d16", "d96"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_matches_jax_f32(shape, causal):
    arrays = _qkv(**shape)
    j_out, j_lse = jfa.flash_attention_with_lse(
        *_to_jax(arrays, jnp.float32), causal, 16, 16
    )
    t_out, t_lse = tfa.flash_attention_with_lse(
        *_to_torch(arrays, torch.float32), causal, 16, 16
    )
    assert t_out.dtype == torch.float32 and t_lse.dtype == torch.float32
    assert tuple(t_lse.shape) == tuple(j_lse.shape)
    np.testing.assert_allclose(_np(t_out), _np(j_out), **F32_TOL)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_bf16(causal):
    arrays = _qkv()
    j_out, j_lse = jfa.flash_attention_with_lse(
        *_to_jax(arrays, jnp.bfloat16), causal, 16, 16
    )
    t_out, t_lse = tfa.flash_attention_with_lse(
        *_to_torch(arrays, torch.bfloat16), causal, 16, 16
    )
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=BF16_ATOL)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), atol=BF16_ATOL)


def test_flash_attention_is_the_out_of_with_lse():
    q, k, v = _to_torch(_qkv(), torch.float32)
    out = tfa.flash_attention(q, k, v, True, 16, 16)
    want, _ = tfa.flash_attention_with_lse(q, k, v, True, 16, 16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_lengths_that_do_not_divide_raise():
    arrays = _qkv(l=60)
    with pytest.raises(ValueError):
        jfa.flash_attention(*_to_jax(arrays, jnp.float32), False, 16, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(*_to_torch(arrays, torch.float32), False, 16, 16)


@pytest.mark.parametrize("length", [60, 64, 96])
@pytest.mark.parametrize("blocks", [(16, 16), (None, None), (32, 64)])
def test_same_lengths_accepted_and_rejected(length, blocks):
    arrays = _qkv(b=1, l=length, h=1, d=8)

    def accepts(fn, qkv):
        try:
            fn(*qkv, False, *blocks)
        except ValueError:
            return False
        return True

    assert accepts(
        tfa.flash_attention, _to_torch(arrays, torch.float32)
    ) == accepts(jfa.flash_attention, _to_jax(arrays, jnp.float32))


@pytest.mark.parametrize("seq_len", [64, 1024, 1000, 2048])
def test_pick_causal_attention_picks_the_same_branch(seq_len):
    def is_plain(fn):
        return isinstance(fn, functools.partial)

    assert is_plain(tfa.pick_causal_attention(seq_len)) == is_plain(
        jfa.pick_causal_attention(seq_len)
    )
    assert is_plain(tfa.pick_causal_attention(seq_len, use_flash=False))


def test_pick_causal_attention_flash_branch_computes_causal_attention():
    arrays = _qkv(l=1024, h=1, d=8, b=1)
    fn = tfa.pick_causal_attention(1024)
    got = fn(*_to_torch(arrays, torch.float32))
    want = jring.reference_attention(*_to_jax(arrays, jnp.float32), True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "dtype", ["float32", "bfloat16"]
)
def test_reference_attention_matches_jax(causal, dtype):
    arrays = _qkv()
    want = jring.reference_attention(
        *_to_jax(arrays, getattr(jnp, dtype)), causal=causal
    )
    got = tring.reference_attention(
        *_to_torch(arrays, getattr(torch, dtype)), causal=causal
    )
    assert str(got.dtype) == "torch." + dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL)


def test_plain_flash_is_not_counted_as_a_kernel_launch():
    tfa.launches.reset()
    tfa.flash_attention_with_lse(*_to_torch(_qkv(), torch.float32), True)
    assert tfa.launches.count == 0


def test_kernel_input_checks_reject_what_the_kernel_does_not_take():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check_kernel_inputs(q, q, q)


def _offset_view(shape, dtype, offset):
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_contiguous_input_is_16_byte_aligned(dtype):
    assert tfa.aligned_16(torch.zeros(2, 64, 2, 16, dtype=dtype))
    assert tfa.aligned_16(_offset_view((2, 64, 2, 16), dtype, 16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_view_at_an_offset_of_one_element_is_not_aligned(dtype):
    view = _offset_view((2, 64, 2, 16), dtype, 1)
    assert view.is_contiguous()
    assert not tfa.aligned_16(view)


def test_a_row_stride_off_the_8_element_grid_is_not_aligned():
    sliced = torch.zeros(2, 64, 1, 20, dtype=torch.bfloat16)[..., :16]
    assert sliced.stride(3) == 1 and sliced.stride(1) == 20
    assert not tfa.aligned_16(sliced)
    # the same slice at a row stride of 24 elements (48 bytes) passes
    assert tfa.aligned_16(
        torch.zeros(2, 64, 1, 24, dtype=torch.bfloat16)[..., :16]
    )


def test_the_model_s_head_views_are_aligned():
    """q/k/v as the model makes them: a (B, L, H*D) projection viewed as
    (B, L, H, D) heads."""
    proj = torch.zeros(2, 64, 2 * 16, dtype=torch.bfloat16)
    assert tfa.aligned_16(proj.view(2, 64, 2, 16))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_an_unaligned_bf16_input_is_refused_by_name(which):
    qkv = {n: torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
           for n in ("q", "k", "v")}
    qkv[which] = _offset_view((2, 64, 2, 16), torch.bfloat16, 1)
    with pytest.raises(ValueError, match=r"read %s in 16-byte" % which):
        tfa.check_alignment(qkv["q"], qkv["k"], qkv["v"])


def test_an_unaligned_f32_input_is_accepted():
    """The f32 kernels load scalars: an offset of one element is fine."""
    view = _offset_view((2, 64, 2, 16), torch.float32, 1)
    assert not tfa.aligned_16(view)
    tfa.check_alignment(view, view, view)


@pytest.fixture
def fwd_launches(monkeypatch):
    """``_flash_fwd_kernel`` on CPU tensors, its device check and its
    launch stubbed out: each launch it would make is recorded instead."""
    made = []
    monkeypatch.setattr(tfa, "_check_kernel_inputs", lambda q, k, v: None)
    monkeypatch.setattr(tfa, "_kernel", lambda *args: None)
    monkeypatch.setattr(tfa, "_launch", lambda name, *args: made.append(name))
    monkeypatch.setattr(tfa, "launches", tfa.LaunchCounter())
    return made


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_the_forward_refuses_an_unaligned_bf16_input_before_launching(
    which, fwd_launches
):
    qkv = {n: torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
           for n in ("q", "k", "v")}
    qkv[which] = _offset_view((2, 64, 2, 16), torch.bfloat16, 1)
    with pytest.raises(ValueError, match=r"read %s in 16-byte" % which):
        tfa._flash_fwd_kernel(qkv["q"], qkv["k"], qkv["v"], True)
    assert fwd_launches == [] and tfa.launches.count == 0


@pytest.mark.parametrize(
    "dtype,offset", [(torch.float32, 1), (torch.bfloat16, 0)]
)
def test_the_forward_launches_on_an_unaligned_f32_or_aligned_bf16_view(
    dtype, offset, fwd_launches
):
    view = _offset_view((2, 64, 2, 16), dtype, offset)
    out, lse = tfa._flash_fwd_kernel(view, view, view, True)
    assert fwd_launches == ["flash_fwd"] and tfa.launches.count == 1
    assert out.shape == view.shape and out.dtype == dtype
    assert tuple(lse.shape) == (2, 2, 64) and lse.dtype == torch.float32


def test_jax_interpret_mode_is_what_runs_here():
    assert jax.default_backend() == "cpu"
    assert jfa._use_interpret()


def _jax_grads(fn, arrays, dtype):
    return jax.grad(fn, argnums=(0, 1, 2))(*_to_jax(arrays, dtype))


def _port_grads(fn, arrays, dtype):
    qkv = [t.requires_grad_(True) for t in _to_torch(arrays, dtype)]
    return torch.autograd.grad(fn(*qkv), qkv)


GRAD_TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
            "bfloat16": dict(rtol=0.1, atol=0.1)}


@pytest.mark.parametrize("shape", SHAPES, ids=["d16", "d96"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradients_match_jax(shape, causal, dtype):
    """dq, dk, dv of the port's autograd Function (the plain backward on
    the CPU) against jax.grad through the Pallas kernels (interpret)."""
    arrays = _qkv(**shape)

    def j_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, 16, 16)
        return (out.astype(jnp.float32) ** 2).sum()

    def t_loss(q, k, v):
        return (tfa.flash_attention(q, k, v, causal, 16, 16).float() ** 2).sum()

    want = _jax_grads(j_loss, arrays, getattr(jnp, dtype))
    got = _port_grads(t_loss, arrays, getattr(torch, dtype))
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + dtype
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_jax(causal):
    """A loss on the lse output (a z-loss) propagates through delta, as
    in the reference (tests/test_flash_attention.py's lse case)."""
    arrays = _qkv(l=32)

    def j_loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(q, k, v, causal, 16, 16)
        return (out ** 2).sum() + 0.1 * (lse ** 2).sum()

    def t_loss(q, k, v):
        out, lse = tfa.flash_attention_with_lse(q, k, v, causal, 16, 16)
        return (out ** 2).sum() + 0.1 * (lse ** 2).sum()

    want = _jax_grads(j_loss, arrays, jnp.float32)
    got = _port_grads(t_loss, arrays, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL["float32"])


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gradients_equal_autograd_through_the_plain_forward(
    dtype, causal, with_lse
):
    arrays = _qkv()

    def loss(fn):
        def f(q, k, v):
            out, lse = fn(q, k, v)
            total = (out.float() ** 2).sum()
            return total + 0.1 * (lse ** 2).sum() if with_lse else total

        return f

    got = _port_grads(
        loss(lambda q, k, v: tfa.flash_attention_with_lse(q, k, v, causal)),
        arrays, getattr(torch, dtype),
    )
    want = _port_grads(
        loss(lambda q, k, v: tfa.plain_flash_with_lse(q, k, v, causal)),
        arrays, getattr(torch, dtype),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL[dtype])


def test_plain_flash_bwd_is_the_function_backward():
    q, k, v, g = _to_torch(_qkv() + (_qkv(seed=1)[0],), torch.float32)
    out, lse = tfa.plain_flash_with_lse(q, k, v, True)
    g_lse = torch.from_numpy(
        np.random.default_rng(2).standard_normal(lse.shape).astype(np.float32)
    )
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out2, lse2 = tfa.flash_attention_with_lse(*qkv, True)
    got = torch.autograd.grad((out2, lse2), qkv, (g, g_lse))
    want = tfa.plain_flash_bwd(q, k, v, out, lse, g, True, g_lse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_saves_no_dense_scores():
    """The Function saves q, k, v, out and lse: nothing with two
    sequence-length dims (the reference pins the same of its jaxpr)."""
    length = 64
    q, k, v = (
        t.requires_grad_(True) for t in _to_torch(_qkv(l=length), torch.float32)
    )
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tfa.flash_attention(q, k, v, True, 16, 16)
    assert shapes and all(s.count(length) < 2 for s in shapes), shapes
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


def test_plain_backward_is_not_counted_as_a_kernel_launch():
    tfa.bwd_dq_launches.reset()
    tfa.bwd_dkv_launches.reset()
    q, k, v = (t.requires_grad_(True) for t in _to_torch(_qkv(), torch.float32))
    tfa.flash_attention(q, k, v, True).sum().backward()
    assert tfa.bwd_dq_launches.count == 0
    assert tfa.bwd_dkv_launches.count == 0
