"""Wire dtype names <-> numpy and torch dtypes.

The same names as ``elasticdl_tpu/common/dtypes.py``, so frames cross
between the two packages. ``bfloat16`` needs no ``ml_dtypes``: numpy has
no bf16, so bf16 payloads travel as raw 16-bit words and decode to
``torch.bfloat16`` tensors. Every other dtype decodes to numpy.
"""

import numpy as np
import torch

BFLOAT16 = "bfloat16"

# wire name -> numpy dtype (bf16 excluded: numpy has none)
_NAME_TO_NP = {
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "uint8": np.dtype(np.uint8),
    "uint16": np.dtype(np.uint16),
    "uint32": np.dtype(np.uint32),
    "uint64": np.dtype(np.uint64),
    "float16": np.dtype(np.float16),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "bool": np.dtype(np.bool_),
}
_NP_TO_NAME = {v: k for k, v in _NAME_TO_NP.items()}

_TORCH_TO_NAME = {
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.uint8: "uint8",
    torch.float16: "float16",
    torch.float32: "float32",
    torch.float64: "float64",
    torch.bool: "bool",
    torch.bfloat16: BFLOAT16,
}


def dtype_name(dtype):
    """Wire name of a numpy or torch dtype; raises on unsupported ones."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NAME:
            raise ValueError("Unsupported tensor dtype: %s" % dtype)
        return _TORCH_TO_NAME[dtype]
    dtype = np.dtype(dtype)
    if dtype not in _NP_TO_NAME:
        raise ValueError("Unsupported tensor dtype: %s" % dtype)
    return _NP_TO_NAME[dtype]


def dtype_name_to_numpy(name):
    """numpy dtype of a wire name; ``bfloat16`` maps to its raw 16-bit
    storage (``uint16``) — callers view those words as torch bf16."""
    if name == BFLOAT16:
        return np.dtype(np.uint16)
    if name not in _NAME_TO_NP:
        raise ValueError("Unsupported wire dtype name: %s" % name)
    return _NAME_TO_NP[name]
