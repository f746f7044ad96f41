"""Structured record codec, the counterpart of
``elasticdl_tpu/data/example.py``: an example is a dict of named arrays
serialized with the frame codec (``common/tensor.py``), and
:func:`parse_example` casts and reshapes against ``FixedLenFeature``
specs. Bytes written by either package parse in the other.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    deserialize_tensors,
    serialize_tensors,
)


class FixedLenFeature:
    """Spec for a fixed-shape feature (tf.io.FixedLenFeature analog)."""

    def __init__(self, shape, dtype, default_value=None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.default_value = default_value

    def __repr__(self):
        return "FixedLenFeature(%s, %s)" % (self.shape, self.dtype)


def encode_example(features):
    """Serialize {name: array-like} to bytes."""
    tensors = []
    for name in sorted(features):
        value = features[name]
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        tensors.append(Tensor(name, value))
    return serialize_tensors(tensors)


def decode_example(data):
    """Deserialize bytes back to {name: array} without a spec (bf16
    features come back as ``torch.bfloat16`` tensors)."""
    return {t.name: t.values for t in deserialize_tensors(data)}


def parse_example(data, feature_spec):
    """Parse one serialized example against {name: FixedLenFeature}.

    Returns {name: ndarray} with each value cast and reshaped to its
    spec. Missing features fall back to ``default_value`` (or raise);
    extra features in the record are ignored."""
    raw = decode_example(data)
    out = {}
    for name, spec in feature_spec.items():
        if name in raw:
            value = raw[name]
            if isinstance(value, torch.Tensor):
                value = value.float().numpy()
            arr = np.asarray(value)
            try:
                arr = arr.reshape(spec.shape)
            except ValueError:
                raise ValueError(
                    "feature %r has %d elements, spec shape %s"
                    % (name, arr.size, spec.shape)
                )
            out[name] = arr.astype(spec.dtype, copy=False)
        elif spec.default_value is not None:
            out[name] = np.full(
                spec.shape, spec.default_value, dtype=spec.dtype
            )
        else:
            raise KeyError("feature %r missing from example" % name)
    return out
