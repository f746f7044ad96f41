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


def test_jax_interpret_mode_is_what_runs_here():
    assert jax.default_backend() == "cpu"
    assert jfa._use_interpret()
