"""Named-tensor wire codec (the frame format of
``elasticdl_tpu/common/tensor.py``, byte for byte).

A frame is ``magic | u8 version | u32 header_len | header json | values |
indices``: the header carries name, dtype and shape (plus an indices
count for sparse tensors), the payloads are raw C-order little-endian
buffers. Frames written by either package decode in the other.

A sparse ``Tensor`` (``indices`` set) is an IndexedSlices analog: the
sync accumulator sums them by concatenation (``+``), and
:func:`combine_indexed_slices` merges duplicate ids, as the reference.

Values may be numpy arrays or torch tensors. A torch tensor is copied to
the host once, inside the frame write. ``bfloat16`` travels as raw
16-bit words: decoding returns a ``torch.bfloat16`` tensor (numpy has no
bf16 and this package does not use ``ml_dtypes``); every other dtype
decodes to a READ-ONLY ``np.frombuffer`` view pinned to the received
buffer, as in the reference.

A tensor marked with ``wire_dtype = "bfloat16"`` (``rpc/wire_compression``)
whose payload is float32 is narrowed to bf16 words (round to nearest
even, as the reference's ``ml_dtypes`` cast) when its frame is planned.
"""

import json
import struct

import numpy as np
import torch

from elasticdl_tpu_torch.common.dtypes import (
    BFLOAT16,
    dtype_name,
    dtype_name_to_numpy,
)

_MAGIC = b"EDLT"
_VERSION = 1
_FIXED = 9  # magic(4) + version(1) + header_len(4)


def host_words(values):
    """(C-contiguous numpy array of the payload's bytes, wire name).
    bf16 torch tensors become their uint16 storage words."""
    if isinstance(values, torch.Tensor):
        t = values.detach().to("cpu").contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(values)
    return arr, dtype_name(arr.dtype)


class Tensor:
    """A named array (numpy or torch), optionally sparse: ``indices``
    non-None means ``values[i]`` updates row ``indices[i]``.
    ``wire_dtype``: the dtype a float32 payload rides the wire as (None:
    its own)."""

    wire_dtype = None

    def __init__(self, name=None, values=None, indices=None):
        self.name = name
        if values is None or isinstance(values, torch.Tensor):
            self.values = values
        else:
            self.values = np.asarray(values)
        self.indices = (
            None if indices is None else np.asarray(indices, dtype=np.int64)
        )
        if self.indices is not None and self.values is not None:
            if len(self.indices) != self.values.shape[0]:
                raise ValueError(
                    "indices length %d != values rows %d"
                    % (len(self.indices), self.values.shape[0])
                )

    def is_indexed_slices(self):
        return self.indices is not None

    def __add__(self, other):
        """Sparse tensors concatenate (duplicate ids are resolved at apply
        time); dense tensors add elementwise. ``0 + t`` is ``t``, so
        ``sum(tensors)`` works."""
        if not isinstance(other, Tensor):
            if isinstance(other, int) and other == 0:
                return self
            return NotImplemented
        if self.is_indexed_slices() != other.is_indexed_slices():
            raise ValueError("cannot add sparse and dense tensors")
        if self.is_indexed_slices():
            return Tensor(
                self.name,
                np.concatenate([self.values, other.values], axis=0),
                np.concatenate([self.indices, other.indices], axis=0),
            )
        return Tensor(self.name, self.values + other.values)

    __radd__ = __add__

    def to_bytes(self):
        return serialize_tensor(self)


def combine_indexed_slices(indices, values):
    """Sum the rows of duplicate ids: ``(unique_indices, summed_values)``,
    ``unique_indices`` sorted (``np.unique`` order). Duplicate-free input
    is only reordered (no additions), so a pre-combined gradient combines
    to itself bit for bit."""
    indices = np.asarray(indices, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    unique, inverse = np.unique(indices, return_inverse=True)
    if len(unique) == len(indices):
        order = np.argsort(indices, kind="stable")
        return unique, values[order]
    combined = np.zeros((len(unique), values.shape[1]), dtype=np.float32)
    np.add.at(combined, inverse.reshape(-1), values)
    return unique, combined


def _is_f32(values):
    if isinstance(values, torch.Tensor):
        return values.dtype == torch.float32
    return values is not None and values.dtype == np.float32


def plan_tensor_frame(t):
    """``(header_bytes, host_values, indices, total_bytes)`` of one
    frame; ``host_values`` is the payload as C-order host words."""
    values = t.values
    if t.wire_dtype == BFLOAT16 and _is_f32(values):
        values = torch.as_tensor(values).to(torch.bfloat16)
    host, name = host_words(values)
    header = {"name": t.name, "dtype": name, "shape": list(host.shape)}
    if t.indices is not None:
        header["num_indices"] = int(t.indices.shape[0])
    hdr = json.dumps(header).encode("utf-8")
    total = _FIXED + len(hdr) + host.nbytes
    if t.indices is not None:
        total += t.indices.shape[0] * 8
    return hdr, host, t.indices, total


def write_tensor_frame(plan, buf, off=0):
    """Write one planned frame into ``buf`` at ``off``; returns the
    offset past the frame."""
    if not isinstance(buf, memoryview):
        buf = memoryview(buf)
    hdr, host, indices, _total = plan
    struct.pack_into("<4sBI", buf, off, _MAGIC, _VERSION, len(hdr))
    off += _FIXED
    buf[off : off + len(hdr)] = hdr
    off += len(hdr)
    for arr in (host,) if indices is None else (host, indices):
        if arr.nbytes:
            dest = np.frombuffer(buf[off : off + arr.nbytes], dtype=arr.dtype)
            np.copyto(dest.reshape(arr.shape), arr)
        off += arr.nbytes
    return off


def serialize_tensor(t):
    plan = plan_tensor_frame(t)
    buf = bytearray(plan[3])
    write_tensor_frame(plan, buf)
    return buf


def _readonly(data):
    view = data if isinstance(data, memoryview) else memoryview(data)
    return view if view.readonly else view.toreadonly()


def deserialize_tensor(data):
    view = _readonly(data)
    if view[:4] != _MAGIC:
        raise ValueError("bad tensor frame magic")
    ver, hlen = struct.unpack_from("<BI", view, 4)
    if ver != _VERSION:
        raise ValueError("unsupported tensor frame version %d" % ver)
    off = _FIXED
    header = json.loads(bytes(view[off : off + hlen]))
    off += hlen
    name = header["dtype"]
    dtype = dtype_name_to_numpy(name)
    shape = tuple(header["shape"])
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    values = np.frombuffer(view[off : off + nbytes], dtype=dtype).reshape(
        shape
    )
    if name == BFLOAT16:
        # torch tensors cannot alias a read-only buffer: one owned copy
        values = torch.from_numpy(values.view(np.int16).copy()).view(
            torch.bfloat16
        )
    off += nbytes
    indices = None
    if "num_indices" in header:
        n = header["num_indices"]
        indices = np.frombuffer(view[off : off + 8 * n], dtype=np.int64)
    return Tensor(header["name"], values, indices)


def serialize_tensors(tensors):
    """Frames with a u64 length prefix each, in one buffer."""
    plans = [plan_tensor_frame(t) for t in tensors]
    buf = bytearray(sum(8 + p[3] for p in plans))
    off = 0
    for plan in plans:
        struct.pack_into("<Q", buf, off, plan[3])
        off = write_tensor_frame(plan, buf, off + 8)
    return buf


def deserialize_tensors(data):
    view = _readonly(data)
    off = 0
    tensors = []
    while off < len(view):
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        tensors.append(deserialize_tensor(view[off : off + n]))
        off += n
    return tensors


def named_arrays_to_nested(named):
    """Nest {path_name: value} into plain dicts by the "/" convention of
    the reference's ``pytree_to_named_arrays``."""
    tree = {}
    for name, value in named.items():
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree
