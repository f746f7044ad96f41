"""Export artifacts and tensor frames cross between the JAX package and
the port both ways, and the port decodes bf16 without ``ml_dtypes``."""

import os
import subprocess
import sys
import textwrap

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import export as jexport
from elasticdl_tpu.common import tensor as jtensor
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu_torch.common import export as texport
from elasticdl_tpu_torch.common import tensor as ttensor
from elasticdl_tpu_torch.common.convert import to_named, to_state_dict
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    transformer_lm as tzoo,
)
from model_zoo.transformer_lm import transformer_lm as jzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DEF = "transformer_lm.transformer_lm.custom_model"
MODEL_PARAMS = (
    "vocab_size=64,num_layers=1,num_heads=2,head_dim=8,embed_dim=16,"
    "mlp_dim=32"
)


def _jax_params(seed=0):
    model = jzoo.custom_model(**get_dict_from_params_str(MODEL_PARAMS))
    tokens = np.zeros((1, 8), np.int32)
    return init_variables(model, jax.random.PRNGKey(seed), {"tokens": tokens})[
        "params"
    ]


def _values(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    if x.dtype == ml_dtypes.bfloat16:
        return np.asarray(x, dtype=np.float32)
    return np.asarray(x)


def test_jax_artifact_loads_in_the_port(tmp_path):
    params = _jax_params()
    jexport.export_model(
        str(tmp_path), params, 7,
        metadata=jexport.export_provenance("", MODEL_DEF, MODEL_PARAMS),
    )
    loaded = texport.load_export(str(tmp_path))
    assert loaded.version == 7
    assert loaded.metadata["model_def"] == MODEL_DEF
    named = pytree_to_named_arrays(params)
    assert sorted(loaded.named) == sorted(named)
    for name, value in named.items():
        np.testing.assert_array_equal(loaded.named[name], np.asarray(value))
    # and the weights drop into the port's module unchanged
    model = tzoo.custom_model(**get_dict_from_params_str(MODEL_PARAMS))
    model.load_state_dict(to_state_dict(loaded.named))


def test_port_artifact_loads_in_jax_with_identical_arrays(tmp_path):
    model = tzoo.init_parameters(
        tzoo.custom_model(**get_dict_from_params_str(MODEL_PARAMS)),
        torch.Generator().manual_seed(1),
    )
    named = to_named(model.state_dict(), 2, 8)
    manifest = texport.export_model(
        str(tmp_path), named, 3,
        metadata=texport.export_provenance("", MODEL_DEF, MODEL_PARAMS),
    )
    assert manifest["artifacts"]["params"] is None
    assert manifest["artifacts"]["serving_fn"] is None
    loaded = jexport.load_export(str(tmp_path))
    assert loaded.version == 3 and not loaded.has_serving_fn()
    got = pytree_to_named_arrays(loaded.params)
    assert sorted(got) == sorted(named)
    for name, value in named.items():
        np.testing.assert_array_equal(np.asarray(got[name]), value.numpy())
    # the JAX structure matches what the flax model initializes
    want = pytree_to_named_arrays(_jax_params())
    for name, value in want.items():
        assert np.asarray(got[name]).shape == np.asarray(value).shape, name


def _frames_jax_to_port(arrays):
    data = jtensor.serialize_tensors(
        jtensor.Tensor(name, value) for name, value in arrays.items()
    )
    return {t.name: t.values for t in ttensor.deserialize_tensors(data)}


def _frames_port_to_jax(arrays):
    data = ttensor.serialize_tensors(
        ttensor.Tensor(name, value) for name, value in arrays.items()
    )
    return {t.name: t.values for t in jtensor.deserialize_tensors(data)}


ARRAYS = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "i32": np.arange(6, dtype=np.int32),
    "i64": np.array([[1, -2], [3, 4]], np.int64),
    "bf16": (np.linspace(-3, 3, 10).astype(ml_dtypes.bfloat16)),
    "scalar": np.float32(2.5),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_frames_cross_both_ways(name):
    value = ARRAYS[name]
    got = _frames_jax_to_port({name: value})[name]
    if name == "bf16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_values(got), _values(value))
    port_value = got
    back = _frames_port_to_jax({name: port_value})[name]
    assert np.asarray(back).dtype == np.asarray(value).dtype
    np.testing.assert_array_equal(_values(back), _values(value))


def test_sparse_frames_keep_their_indices():
    values = np.ones((2, 3), np.float32)
    data = jtensor.Tensor("emb", values, np.array([5, 9])).to_bytes()
    got = ttensor.deserialize_tensor(data)
    assert got.is_indexed_slices()
    np.testing.assert_array_equal(got.indices, [5, 9])
    back = jtensor.deserialize_tensor(bytes(got.to_bytes()))
    np.testing.assert_array_equal(back.indices, [5, 9])
    np.testing.assert_array_equal(back.values, values)


def test_bf16_frames_decode_without_ml_dtypes(tmp_path):
    """A bf16 frame written by the JAX package decodes in a process where
    ``ml_dtypes`` (and JAX) cannot be imported."""
    value = np.linspace(-2, 2, 16).astype(ml_dtypes.bfloat16).reshape(4, 4)
    frame = tmp_path / "frame.bin"
    frame.write_bytes(bytes(jtensor.Tensor("w", value).to_bytes()))
    expect = np.asarray(value, dtype=np.float32)
    np.save(tmp_path / "expect.npy", expect)
    code = textwrap.dedent(
        """
        import sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("ml_dtypes", "jax", "elasticdl_tpu"):
                    raise ImportError(name)

        sys.meta_path.insert(0, _Block())
        sys.path.insert(0, %r)
        import numpy as np, torch
        from elasticdl_tpu_torch.common import tensor
        t = tensor.deserialize_tensor(open(%r, "rb").read())
        assert t.values.dtype == torch.bfloat16, t.values.dtype
        assert np.array_equal(t.values.float().numpy(), np.load(%r))
        again = tensor.deserialize_tensor(bytes(t.to_bytes()))
        assert torch.equal(again.values, t.values)
        print("ok")
        """
        % (REPO, str(frame), str(tmp_path / "expect.npy"))
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_named_arrays_nest_like_the_reference():
    named = {"a/b/c": np.zeros(1), "a/d": np.ones(2), "e": np.ones(3)}
    want = jtensor.named_arrays_to_nested(named)
    got = ttensor.named_arrays_to_nested(named)
    assert jax.tree_util.tree_structure(got) == (
        jax.tree_util.tree_structure(want)
    )


def test_params_str_parses_like_the_reference():
    from elasticdl_tpu.common.model_utils import (
        get_dict_from_params_str as jparse,
    )

    s = "a=1,b='x',c=2.5,d=True,e=plain"
    assert get_dict_from_params_str(s) == jparse(s)
    assert get_dict_from_params_str("") is None
