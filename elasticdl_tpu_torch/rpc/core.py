"""RPC transport: gRPC with self-describing byte frames, no codegen.

The wire format of ``elasticdl_tpu/rpc/core.py``: a message is a dict
whose values are JSON scalars/lists, arrays (numpy or torch), ``Tensor``
objects, lists of Tensors or bytes, packed as ``u32 header_len | header
json | u32 n_segments | (u64 len | segment)*`` with arrays riding as
tensor frames (common/tensor.py). Handlers are generic bytes-in/bytes-out
methods, so either package's client can call either package's server.

``grpc`` is imported only where a server or channel is made, so nothing
that merely packs messages needs it. Not ported yet: the shared-memory
transport and the failover channel.
"""

import json
import struct
import time
from concurrent import futures

import numpy as np
import torch

from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    deserialize_tensor,
    plan_tensor_frame,
    write_tensor_frame,
)
from elasticdl_tpu_torch.utils import profiling

_SERVICE = "elasticdl_tpu.Rpc"
MAX_MESSAGE_BYTES = 256 * 1024 * 1024
_GRPC_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]


def pack_message(msg):
    """dict -> one exactly-sized ``bytearray``."""
    header = {}
    segments = []  # ("frame", plan, n) | ("raw", bytes_like, n)

    def add_frame(t):
        plan = plan_tensor_frame(t)
        segments.append(("frame", plan, plan[3]))
        return len(segments) - 1

    for key, value in msg.items():
        if isinstance(value, Tensor):
            header[key] = {"t": "tensor", "i": add_frame(value)}
        elif isinstance(value, (np.ndarray, torch.Tensor)):
            header[key] = {"t": "array", "i": add_frame(Tensor(key, value))}
        elif (
            isinstance(value, (list, tuple))
            and value
            and isinstance(value[0], Tensor)
        ):
            header[key] = {"t": "tensors", "i": [add_frame(t) for t in value]}
        elif isinstance(value, (bytes, bytearray, memoryview)):
            value = memoryview(value).cast("B")
            segments.append(("raw", value, len(value)))
            header[key] = {"t": "bytes", "i": len(segments) - 1}
        else:
            header[key] = {"t": "json", "v": value}
    hdr = json.dumps(header).encode("utf-8")
    buf = bytearray(8 + len(hdr) + sum(8 + n for _, _, n in segments))
    view = memoryview(buf)
    struct.pack_into("<I", view, 0, len(hdr))
    off = 4
    view[off : off + len(hdr)] = hdr
    off += len(hdr)
    struct.pack_into("<I", view, off, len(segments))
    off += 4
    for kind, payload, nbytes in segments:
        struct.pack_into("<Q", view, off, nbytes)
        off += 8
        if kind == "frame":
            off = write_tensor_frame(payload, view, off)
        else:
            view[off : off + nbytes] = payload
            off += nbytes
    return buf


def unpack_message(data):
    """bytes-like -> dict. Array fields decode to read-only numpy views
    of ``data`` (``torch.bfloat16`` tensors for bf16 frames)."""
    view = memoryview(data)
    if not view.readonly:
        view = view.toreadonly()
    (hlen,) = struct.unpack_from("<I", view, 0)
    header = json.loads(bytes(view[4 : 4 + hlen]))
    off = 4 + hlen
    (nseg,) = struct.unpack_from("<I", view, off)
    off += 4
    segments = []
    for _ in range(nseg):
        (slen,) = struct.unpack_from("<Q", view, off)
        off += 8
        segments.append(view[off : off + slen])
        off += slen
    msg = {}
    for key, spec in header.items():
        kind = spec["t"]
        if kind == "json":
            msg[key] = spec["v"]
        elif kind == "bytes":
            msg[key] = bytes(segments[spec["i"]])
        elif kind == "tensor":
            msg[key] = deserialize_tensor(segments[spec["i"]])
        elif kind == "array":
            msg[key] = deserialize_tensor(segments[spec["i"]]).values
        elif kind == "tensors":
            msg[key] = [deserialize_tensor(segments[i]) for i in spec["i"]]
        else:
            raise ValueError("unknown field kind %r" % kind)
    return msg


class _GenericHandler:
    def __init__(self, methods):
        import grpc

        self._grpc = grpc
        self._methods = methods

    def service(self, handler_call_details):
        name = handler_call_details.method.rsplit("/", 1)[-1]
        fn = self._methods.get(name)
        if fn is None:
            return None

        def handler(request_bytes, context):
            reply = fn(unpack_message(request_bytes))
            return bytes(pack_message(reply if reply is not None else {}))

        return self._grpc.unary_unary_rpc_method_handler(
            handler,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )


def serve(methods, port, max_workers=64):
    """Start a gRPC server exposing ``methods`` {name: fn(dict)->dict};
    returns it, with the bound port as ``server._edl_port``."""
    import grpc

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=_GRPC_OPTIONS,
        handlers=(_GenericHandler(methods),),
    )
    chosen = server.add_insecure_port("[::]:%d" % port)
    if chosen == 0:
        raise RuntimeError("failed to bind RPC server port %d" % port)
    server.start()
    server._edl_port = chosen
    return server


class Client:
    """``client.call("method", **fields)`` -> reply dict.

    ``deadline_s``: the call's deadline (None blocks). Failures raise
    ``grpc.RpcError``; both scorer RPCs are idempotent, so a caller may
    retry on its own policy."""

    def __init__(self, addr, deadline_s=None):
        import grpc

        self._grpc = grpc
        self._deadline_s = deadline_s if deadline_s else None
        self._latency = profiling.metrics.histogram(
            "edl_rpc_client_latency_seconds",
            "Client-observed RPC latency by method (successes only)",
            labels=("method",),
        )
        self._errors = profiling.metrics.counter(
            "edl_rpc_client_errors_total",
            "Client-observed RPC failures by method and gRPC status code",
            labels=("method", "code"),
        )
        self._channel = grpc.insecure_channel(addr, options=_GRPC_OPTIONS)
        self._stubs = {}

    def call(self, rpc_name, **fields):
        stub = self._stubs.get(rpc_name)
        if stub is None:
            stub = self._channel.unary_unary(
                "/%s/%s" % (_SERVICE, rpc_name),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            stub = self._stubs.setdefault(rpc_name, stub)
        request = bytes(pack_message(fields))
        t0 = time.perf_counter()
        try:
            reply = stub(request, timeout=self._deadline_s)
        except self._grpc.RpcError as err:
            code = err.code() if callable(getattr(err, "code", None)) else None
            self._errors.inc(
                method=rpc_name,
                code=code.name if code is not None else "UNKNOWN",
            )
            raise
        self._latency.observe(time.perf_counter() - t0, method=rpc_name)
        return unpack_message(reply)

    def close(self):
        self._channel.close()
