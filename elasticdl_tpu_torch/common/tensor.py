"""Named-tensor wire codec (the frame format of
``elasticdl_tpu/common/tensor.py``, byte for byte).

A frame is ``magic | u8 version | u32 header_len | header json | values |
indices``: the header carries name, dtype and shape (plus an indices
count for sparse tensors), the payloads are raw C-order little-endian
buffers. Frames written by either package decode in the other.

A sparse ``Tensor`` (``indices`` set) is an IndexedSlices analog: the
sync accumulator sums them by concatenation (``+``), and
:func:`combine_indexed_slices` merges duplicate ids, as the reference.

**One copy out.** Values may be numpy arrays or torch tensors, on the
host or on the card. Planning a frame reads only shape and dtype; the
frame write is the payload's one copy, straight out of its buffer into
the frame (or a shared-memory slot): ``np.copyto`` for a numpy array,
``torch.frombuffer(dest).view(shape).copy_(src)`` for a tensor, which for
a CUDA tensor is the one device-to-host copy. A tensor marked with
``wire_dtype = "bfloat16"`` (``rpc/wire_compression``) whose payload is
float32 narrows to bf16 words inside that same ``copy_`` (round to
nearest even, as the reference's ``ml_dtypes`` cast). The PS worker
hands its dense gradients and parameters over on the card, so their
frame write is their one copy out; its sparse row gradients are staged
to the host first, where the client combines them and splits them by
shard.

**Decoding copies nothing.** ``bfloat16`` travels as raw 16-bit words
and decodes to a ``torch.bfloat16`` tensor (numpy has no bf16 and this
package does not use ``ml_dtypes``): one owned copy from a read-only
buffer, an alias under ``writable=True``. Every other dtype decodes to a
READ-ONLY ``np.frombuffer`` view pinned to the received buffer. A
consumer that keeps a decoded tensor past its message calls
:meth:`Tensor.materialize`. :class:`WireArena` is the buffer's lifetime
handle: advisory for a socket or gRPC reply, whose views hold their
buffer alive, and load-bearing for a shared-memory slot
(``rpc/shm_transport.py``), where ``release()`` recycles the slot.
"""

import json
import struct
import warnings

import numpy as np
import torch

from elasticdl_tpu_torch.common.dtypes import (
    BFLOAT16,
    dtype_name,
    dtype_name_to_numpy,
    dtype_name_to_torch,
)

_MAGIC = b"EDLT"
_VERSION = 1
_FIXED = 9  # magic(4) + version(1) + header_len(4)


def is_device_array(x):
    """True for a torch tensor on a device other than the CPU: the
    planner reads only its shape and dtype, and its one copy to the host
    is the frame write."""
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _torch_view(arr):
    """A torch tensor over a numpy array's buffer, no copy. A read-only
    array is wrapped all the same (the tensor is only ever a copy
    source), without torch's warning about it."""
    if any(s < 0 for s in arr.strides):
        arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def device_host_view(values):
    """A host numpy array of a payload's wire words: zero-copy for a
    numpy array or a CPU tensor, the one device-to-host copy for a
    tensor on the card; bf16 as its uint16 words."""
    if not isinstance(values, torch.Tensor):
        return np.asarray(values)
    t = values.detach()
    if is_device_array(t):
        t = t.to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def device_from_host_view(arr, device):
    """The inverse bridge: a tensor on ``device`` over a host payload, as
    a decoded slot view enters a ``--ps_device`` shard's apply.

    A writable float32 C-contiguous numpy view imports with
    ``torch.from_numpy``, which ALIASES the buffer on the CPU, then one
    ``.to(device)`` (the one host-to-device copy on the card). The
    caller consumes everything computed from the import before the
    buffer recycles (the shm endpoint overwrites the request slot with
    the reply once the handler returns). A read-only or other view gets
    one owned copy; a tensor is moved as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    device = torch.device(device)
    flags = arr.flags
    if flags.writeable and flags.c_contiguous and arr.dtype == np.float32:
        return torch.from_numpy(arr).to(device)
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, copy=True))
    return _torch_view(arr).to(device)


class Tensor:
    """A named array (numpy or torch), optionally sparse: ``indices``
    non-None means ``values[i]`` updates row ``indices[i]``.
    ``wire_dtype``: the dtype a float32 payload rides the wire as (None:
    its own); a mark only, the values are never converted here."""

    wire_dtype = None
    # a bf16 payload decoded as an alias of a writable frame: a torch
    # tensor cannot say whose memory it is
    _wire_alias = False

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

    def materialize(self):
        """An owned, writable twin of a decoded tensor, for a consumer
        that keeps it past its message's arena or writes to it. A payload
        over a buffer no array owns (a frame's bytes, a shared-memory
        slot; read-only or, under ``writable=True``, writable) is
        copied; one that owns its memory (built locally, a torch tensor,
        materialized before) is kept, so the call costs nothing but at
        the decode edge."""
        v_owned = self.values is None or (
            _owns(self.values) and not self._wire_alias
        )
        i_owned = self.indices is None or _owns(self.indices)
        if v_owned and i_owned:
            return self
        return Tensor(
            self.name,
            self.values if v_owned else (
                self.values.clone() if isinstance(self.values, torch.Tensor)
                else self.values.copy()
            ),
            self.indices if i_owned else self.indices.copy(),
        )

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


def _owns(x):
    """False for a numpy array over memory no array owns (a view of a
    frame or a slot, read-only or not); a torch tensor owns its memory
    unless a decode marked it (``Tensor._wire_alias``)."""
    if isinstance(x, torch.Tensor):
        return True
    if not x.flags.writeable:
        return False
    while isinstance(x, np.ndarray) and not x.flags.owndata:
        x = x.base
    return x is None or isinstance(x, np.ndarray)


def _itemsize(name):
    return 2 if name == BFLOAT16 else dtype_name_to_numpy(name).itemsize


def plan_tensor_frame(t):
    """The exact layout of one frame, from metadata alone:
    ``(header_bytes, values, wire name, indices, total_bytes)``. A torch
    tensor on the card is not touched: its copy to the host happens in
    :func:`write_tensor_frame`."""
    values = t.values
    name = dtype_name(values.dtype)
    if t.wire_dtype == BFLOAT16 and name == "float32":
        name = BFLOAT16
    shape = [int(d) for d in values.shape]
    header = {"name": t.name, "dtype": name, "shape": shape}
    indices = t.indices
    if indices is not None:
        header["num_indices"] = int(indices.shape[0])
    hdr = json.dumps(header).encode("utf-8")
    total = _FIXED + len(hdr) + int(np.prod(shape, dtype=np.int64)) * (
        _itemsize(name)
    )
    if indices is not None:
        total += indices.shape[0] * 8
    return hdr, values, name, indices, total


def _write_array(buf, off, arr, name):
    """The payload's one copy into ``buf[off:]`` as C-order ``name``
    words; returns the offset past it. A tensor (or a float32 array
    narrowing to bf16) copies through ``torch.frombuffer(...).copy_``,
    the narrowing fused into that copy; any other array through
    ``np.copyto``. Both walk strided sources without staging."""
    shape = tuple(int(d) for d in arr.shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(name)
    if not nbytes:
        return off
    dest = buf[off : off + nbytes]
    if isinstance(arr, torch.Tensor) or name == BFLOAT16:
        src = arr.detach() if isinstance(arr, torch.Tensor) else (
            _torch_view(arr)
        )
        torch.frombuffer(dest, dtype=dtype_name_to_torch(name)).view(
            shape
        ).copy_(src)
    else:
        np.copyto(
            np.frombuffer(dest, dtype=dtype_name_to_numpy(name)).reshape(
                shape
            ),
            arr,
            casting="unsafe",
        )
    return off + nbytes


def write_tensor_frame(plan, buf, off=0):
    """Write one planned frame into ``buf`` (a writable buffer) at
    ``off``; returns the offset past the frame."""
    if not isinstance(buf, memoryview):
        # a bytearray slice copies: every write goes through one view
        buf = memoryview(buf)
    hdr, values, name, indices, _total = plan
    struct.pack_into("<4sBI", buf, off, _MAGIC, _VERSION, len(hdr))
    off += _FIXED
    buf[off : off + len(hdr)] = hdr
    off += len(hdr)
    off = _write_array(buf, off, values, name)
    if indices is not None:
        off = _write_array(buf, off, indices, "int64")
    return off


def serialize_tensor(t):
    plan = plan_tensor_frame(t)
    buf = bytearray(plan[4])
    write_tensor_frame(plan, buf)
    return buf


def _readonly(data):
    view = data if isinstance(data, memoryview) else memoryview(data)
    return view if view.readonly else view.toreadonly()


def deserialize_tensor(data, writable=False):
    """Decode one frame without copying: values and indices are views of
    ``data``, read-only unless ``writable=True`` and ``data`` itself is
    writable (the ``--ps_device`` shard's slot requests, which enter the
    device through :func:`device_from_host_view`; :meth:`Tensor.
    materialize` copies writable views as it copies read-only ones). A
    bf16 payload is a ``torch.bfloat16`` tensor: an alias of a
    writable buffer, one owned copy of a read-only one."""
    view = (
        _readonly(data) if not writable
        else (data if isinstance(data, memoryview) else memoryview(data))
    )
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
    alias = False
    if name == BFLOAT16:
        words = values.view(np.int16)
        alias = words.flags.writeable
        if not alias:
            # torch tensors cannot alias a read-only buffer
            words = words.copy()
        values = torch.from_numpy(words).view(torch.bfloat16)
    off += nbytes
    indices = None
    if "num_indices" in header:
        n = header["num_indices"]
        indices = np.frombuffer(view[off : off + 8 * n], dtype=np.int64)
    t = Tensor(header["name"], values, indices)
    t._wire_alias = alias
    return t


def serialize_tensors(tensors):
    """Frames with a u64 length prefix each, in one buffer."""
    plans = [plan_tensor_frame(t) for t in tensors]
    buf = bytearray(sum(8 + p[4] for p in plans))
    off = 0
    for plan in plans:
        struct.pack_into("<Q", buf, off, plan[4])
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


class WireArena:
    """The lifetime handle of the buffer a decoded message's views pin.

    On the socket and gRPC paths the views hold their buffer alive
    themselves, so ``release()`` is advisory: views of this or any other
    message stay valid after it. On the shared-memory path
    (``rpc/shm_transport.py``) ``release()`` RECYCLES the slot and the
    views turn to garbage at the next call, which is why a consumer that
    keeps a decoded tensor materializes it first. ``__del__`` is the
    backstop: a dropped reply never leaks its slot."""

    __slots__ = ("_buf", "_on_release", "released")

    def __init__(self, buf, on_release=None):
        self._buf = buf
        self._on_release = on_release
        self.released = False

    def release(self):
        if self.released:
            return
        self.released = True
        self._buf = None
        callback, self._on_release = self._on_release, None
        if callback is not None:
            callback()

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 - a destructor at teardown
            pass


def release_message(msg):
    """Release the arena pinning a decoded message's buffer (a no-op for
    a message without one: an in-process dict, a handler's request).
    After it, tensors decoded from a shared-memory reply are invalid."""
    if isinstance(msg, dict):
        arena = msg.pop("_wire_arena", None)
        if arena is not None:
            arena.release()


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
