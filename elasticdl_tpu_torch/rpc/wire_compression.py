"""The compressed tensor wire (``--wire_dtype bfloat16``), the port of
``elasticdl_tpu/rpc/wire_compression.py``.

The sender marks its float32 tensors and lists their names in the
message's ``compressed_f32`` field; the frame writer
(``common/tensor.plan_tensor_frame``) narrows a marked payload to bf16
words, the same bytes the reference writes. The receiver widens exactly
the listed names back to float32 before any optimizer sees them. Tensors
of any other dtype pass untouched both ways, and an in-process call (no
frames) keeps the full float32 values: only the mark is shed.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.dtypes import BFLOAT16
from elasticdl_tpu_torch.common.tensor import Tensor


def compress_tensors(tensors, wire_dtype):
    """``(tensors, compressed names)``: float32 payloads marked to ride
    the wire as ``wire_dtype``; a no-op for an empty ``wire_dtype``."""
    if not wire_dtype or wire_dtype == "float32":
        return list(tensors), []
    if wire_dtype != BFLOAT16:
        raise ValueError("unsupported wire_dtype %r" % (wire_dtype,))
    out, names = [], []
    for t in tensors:
        values = t.values
        f32 = values is not None and (
            values.dtype == torch.float32
            if isinstance(values, torch.Tensor)
            else values.dtype == np.float32
        )
        if f32:
            marked = Tensor(t.name, values, t.indices)
            marked.wire_dtype = BFLOAT16
            out.append(marked)
            names.append(t.name)
        else:
            out.append(t)
    return out, names


def decompress_tensors(tensors, compressed_names):
    """Widen the payloads of ``compressed_names`` back to float32 numpy
    arrays; payloads already float32 (an in-process call) pass through
    with their mark shed."""
    if not compressed_names:
        return list(tensors)
    names = set(compressed_names)
    out = []
    for t in tensors:
        if t.name not in names or t.values is None:
            out.append(t)
        elif isinstance(t.values, torch.Tensor):
            out.append(
                Tensor(t.name, t.values.to("cpu", torch.float32).numpy(),
                       t.indices)
            )
        else:
            out.append(
                Tensor(t.name, np.asarray(t.values, dtype=np.float32),
                       t.indices)
            )
    return out
