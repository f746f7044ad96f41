"""The compressed tensor wire against ``elasticdl_tpu.rpc.wire_compression``
on the same numpy-seeded tensors: the same names marked, the same bf16
words in the frames (rounding ties, infinities and subnormals
included), the same float32 values after the widening, and the
in-process pass-through that keeps the full float32 values."""

import numpy as np
import pytest
import torch

from elasticdl_tpu.common.tensor import (
    Tensor as JTensor,
    deserialize_tensor as j_deserialize,
    serialize_tensor as j_serialize,
)
from elasticdl_tpu.rpc.wire_compression import (
    compress_tensors as j_compress,
    decompress_tensors as j_decompress,
)
from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    deserialize_tensor,
    serialize_tensor,
)
from elasticdl_tpu_torch.rpc.core import pack_message, unpack_message
from elasticdl_tpu_torch.rpc.wire_compression import (
    compress_tensors,
    decompress_tensors,
)


def _tensors(seed, cls):
    rng = np.random.default_rng(seed)
    dense = (rng.standard_normal((6, 5)) * 1e3).astype(np.float32)
    # ties of the bf16 rounding, the extremes, a subnormal
    dense[0, :5] = np.array(
        [1.00390625, 1.01171875, np.inf, -np.inf, 1e-40], np.float32)
    rows = rng.standard_normal((4, 3)).astype(np.float32)
    ids = rng.integers(0, 100, 4)
    return [cls("dense", dense), cls("rows", rows, ids),
            cls("labels", rng.integers(0, 9, 5).astype(np.int64))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_carry_the_references_bf16_words(seed):
    port, names = compress_tensors(_tensors(seed, Tensor), "bfloat16")
    ref, ref_names = j_compress(_tensors(seed, JTensor), "bfloat16")
    assert names == ref_names == ["dense", "rows"]
    for p, r in zip(port, ref):
        assert bytes(serialize_tensor(p)) == bytes(j_serialize(r)), p.name
    # widened back, the values agree to the bit
    got = decompress_tensors(
        [deserialize_tensor(serialize_tensor(t)) for t in port], names)
    want = j_decompress(
        [j_deserialize(j_serialize(t)) for t in ref], ref_names)
    for g, w in zip(got, want):
        assert np.asarray(g.values).dtype == np.asarray(w.values).dtype
        assert np.array_equal(np.asarray(g.values), np.asarray(w.values),
                              equal_nan=True), g.name
        if w.indices is not None:
            assert np.array_equal(g.indices, w.indices)


def test_a_message_rides_the_socket_frames_narrowed():
    tensors, names = compress_tensors(_tensors(3, Tensor), "bfloat16")
    msg = unpack_message(pack_message(
        {"gradients": tensors, "compressed_f32": names}))
    assert msg["compressed_f32"] == names
    assert msg["gradients"][0].values.dtype == torch.bfloat16
    got = decompress_tensors(msg["gradients"], msg["compressed_f32"])
    dense = _tensors(3, Tensor)[0].values
    want = torch.from_numpy(dense).to(torch.bfloat16).float().numpy()
    assert got[0].values.dtype == np.float32
    assert np.array_equal(got[0].values, want)
    assert got[2].values.dtype == np.int64


def test_in_process_keeps_the_full_float32():
    tensors = _tensors(4, Tensor)
    marked, names = compress_tensors(tensors, "bfloat16")
    out = decompress_tensors(marked, names)
    for a, b in zip(tensors, out):
        assert np.array_equal(a.values, b.values)
        assert b.wire_dtype is None
    # no compression: nothing marked
    same, none = compress_tensors(tensors, "")
    assert none == [] and all(t.wire_dtype is None for t in same)
    with pytest.raises(ValueError, match="unsupported"):
        compress_tensors(tensors, "float16")
