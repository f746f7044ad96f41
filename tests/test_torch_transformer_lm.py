"""The port's transformer LM against the flax model, one set of weights
(made by the flax model's own init, converted to a ``state_dict``), on
both attention branches: plain at L=64, the flash kernel at L=1024 (the
Pallas kernel in interpret mode on the JAX side, the kernel's plain
version on the port's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    transformer_lm as tzoo,
)
from elasticdl_tpu_torch.ops import flash_attention as tfa
from model_zoo.transformer_lm import transformer_lm as jzoo

CFG = dict(
    vocab_size=128, num_layers=2, num_heads=4, head_dim=16, embed_dim=64,
    mlp_dim=256,
)


def _tokens(length, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], size=(batch, length)).astype(
        np.int32
    )


def _both(dtype, seed=0):
    """(flax model, its params, the port's model holding them)."""
    jm = jzoo.custom_model(dtype=dtype, **CFG)
    variables = init_variables(
        jm, jax.random.PRNGKey(seed), {"tokens": _tokens(8)}
    )
    params = variables["params"]
    tm = tzoo.custom_model(dtype=dtype, **CFG)
    tm.load_state_dict(convert.to_state_dict(pytree_to_named_arrays(params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("length", [64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_the_flax_model(dtype, length):
    jm, params, tm = _both(dtype)
    tokens = _tokens(length)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, {"tokens": tokens}
    )
    tfa.launches.reset()
    with torch.inference_mode():
        got = tm({"tokens": tokens})
    assert str(got.dtype) == "torch." + str(want.dtype)
    assert tuple(got.shape) == (2, length, CFG["vocab_size"])
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, atol=0.1)
    assert tfa.launches.count == 0  # CPU tensors take the plain version


def test_flash_branch_matches_the_plain_branch():
    _, _, tm = _both("float32")
    tokens = _tokens(1024, batch=1)
    plain = tfa.pick_causal_attention(1024, use_flash=False)
    with torch.inference_mode():
        flash_out = tm({"tokens": tokens})
        plain_out = tm({"tokens": tokens}, attention_fn=plain)
    torch.testing.assert_close(flash_out, plain_out, rtol=2e-4, atol=2e-4)


def test_state_dict_round_trips_to_the_reference_names():
    _, params, tm = _both("float32")
    named = pytree_to_named_arrays(params)
    back = convert.to_named(tm.state_dict(), CFG["num_heads"], CFG["head_dim"])
    assert sorted(back) == sorted(named)
    for name, value in named.items():
        np.testing.assert_array_equal(back[name].numpy(), np.asarray(value))


def test_init_parameters_is_seeded():
    a = tzoo.init_parameters(
        tzoo.custom_model(**CFG), torch.Generator().manual_seed(3)
    )
    b = tzoo.init_parameters(
        tzoo.custom_model(**CFG), torch.Generator().manual_seed(3)
    )
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


class _Mesh:
    """A mesh's shape alone: the forms that raise do so before any
    collective."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize(
    "kwargs",
    [dict(mesh=_Mesh(expert=2, model=2), num_experts=2),
     dict(mesh=_Mesh(pipe=2)),
     dict(mesh=_Mesh(seq=2), seq_axis="seq", num_experts=4)],
)
def test_unported_forms_raise(kwargs):
    with pytest.raises(NotImplementedError,
                       match="not ported yet.*ROADMAP A9"):
        tzoo.custom_model(**CFG, **kwargs)


def test_placement_params_are_accepted_and_ignored():
    m = tzoo.custom_model(
        **CFG, pipeline_stages=2, microbatches=4, tensor_parallel=2,
        min_tensor_parallel=2, shard_vocab=True,
    )
    assert len(m.blocks) == CFG["num_layers"]
