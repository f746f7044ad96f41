"""RPC transport: gRPC with self-describing byte frames, no codegen.

The wire format of ``elasticdl_tpu/rpc/core.py``: a message is a dict
whose values are JSON scalars/lists, arrays (numpy or torch), ``Tensor``
objects, lists of Tensors or bytes, packed as ``u32 header_len | header
json | u32 n_segments | (u64 len | segment)*`` with arrays riding as
tensor frames (common/tensor.py). Handlers are generic bytes-in/bytes-out
methods, so either package's client can call either package's server.

Packing is two steps: :func:`plan_message` lays the message out from
metadata alone (:class:`MessagePlan`, every length known), and
:func:`pack_message_into` writes it into any writable buffer with one
copy per payload: a ``bytearray`` here and in the socket transport, a
shared-memory slot in ``rpc/shm_transport.py``. :func:`unpack_message`
decodes without copying (read-only views of the buffer) and carries the
buffer's :class:`~elasticdl_tpu_torch.common.tensor.WireArena` under
``"_wire_arena"``.

``grpc`` is imported only where a server or channel is made, so nothing
that merely packs messages needs it. The failover channel of the master
is ``rpc/failover.py``, over the socket transport.
"""

import json
import struct
import time
from concurrent import futures

import numpy as np
import torch

from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    WireArena,
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


class MessagePlan:
    """The exact layout of one packed message: ``segments`` holds
    ``("frame", tensor frame plan, n)`` or ``("raw", bytes-like, n)``
    entries, ``total`` the message's bytes, so a writer allocates once
    and copies each payload once."""

    __slots__ = ("header", "segments", "total")

    def __init__(self, header, segments, total):
        self.header = header
        self.segments = segments
        self.total = total



def client_metrics():
    """The client-side families every client of the process shares
    (docs/observability.md): (latency histogram, error counter, retry
    counter), with the reference's names, labels and help."""
    return (
        profiling.metrics.histogram(
            "edl_rpc_client_latency_seconds",
            "Client-observed RPC latency by method "
            "(per attempt, successes only)",
            labels=("method",),
        ),
        profiling.metrics.counter(
            "edl_rpc_client_errors_total",
            "Client-observed RPC failures by method and "
            "gRPC status code (per attempt)",
            labels=("method", "code"),
        ),
        profiling.metrics.counter(
            "edl_rpc_client_retries_total",
            "UNAVAILABLE retries by method",
            labels=("method",),
        ),
    )


def inject_span_context(fields):
    """Cross-process tracing (docs/observability.md): the innermost open
    span's ``[trace_id, span_id]`` rides as the ``_sctx`` field, so the
    serving process's ``rpc/<method>`` span joins the caller's trace.
    A field already there (a shared-memory call injects into the slot's
    payload, whose control message needs no copy) and a ``_shm_req``
    control message are left as they are."""
    if "_sctx" in fields or "_shm_req" in fields:
        return
    sctx = profiling.wire_span_context()
    if sctx is not None:
        fields["_sctx"] = sctx

def plan_message(msg):
    """dict -> :class:`MessagePlan`, reading only the payloads'
    metadata (a tensor on the card is not touched)."""
    header = {}
    segments = []

    def add_frame(t):
        plan = plan_tensor_frame(t)
        segments.append(("frame", plan, plan[4]))
        return len(segments) - 1

    for key, value in msg.items():
        if key == "_wire_arena":
            continue  # the decode side's lifetime handle, never a field
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
            # len() of a typed memoryview counts elements: size in bytes
            value = memoryview(value).cast("B")
            segments.append(("raw", value, len(value)))
            header[key] = {"t": "bytes", "i": len(segments) - 1}
        else:
            header[key] = {"t": "json", "v": value}
    hdr = json.dumps(header).encode("utf-8")
    total = 8 + len(hdr) + sum(8 + n for _, _, n in segments)
    return MessagePlan(hdr, segments, total)


def pack_message_into(plan, buf, off=0):
    """Write a planned message into ``buf`` (a writable buffer) at
    ``off``; returns the offset past it."""
    if not isinstance(buf, memoryview):
        buf = memoryview(buf)  # bytearray slices copy; views do not
    hdr = plan.header
    struct.pack_into("<I", buf, off, len(hdr))
    off += 4
    buf[off : off + len(hdr)] = hdr
    off += len(hdr)
    struct.pack_into("<I", buf, off, len(plan.segments))
    off += 4
    for kind, payload, nbytes in plan.segments:
        struct.pack_into("<Q", buf, off, nbytes)
        off += 8
        if kind == "frame":
            off = write_tensor_frame(payload, buf, off)
        else:
            buf[off : off + nbytes] = payload
            off += nbytes
    return off


def pack_message(msg):
    """dict -> one exactly-sized ``bytearray`` (plan, then pack)."""
    plan = plan_message(msg)
    buf = bytearray(plan.total)
    pack_message_into(plan, buf)
    return buf


def unpack_message(data, arena=None, writable=False):
    """bytes-like -> dict without copying: array fields decode to views
    of ``data`` (read-only unless ``writable`` and ``data`` is writable;
    ``torch.bfloat16`` tensors for bf16 frames), ``bytes`` fields to
    ``bytes``. ``arena`` rides along under ``"_wire_arena"``
    (``common/tensor.release_message``)."""
    view = data if isinstance(data, memoryview) else memoryview(data)
    if not view.readonly and not writable:
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
            msg[key] = deserialize_tensor(segments[spec["i"]], writable)
        elif kind == "array":
            msg[key] = deserialize_tensor(segments[spec["i"]], writable).values
        elif kind == "tensors":
            msg[key] = [
                deserialize_tensor(segments[i], writable) for i in spec["i"]
            ]
        else:
            raise ValueError("unknown field kind %r" % kind)
    if arena is not None:
        msg["_wire_arena"] = arena
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
        self._latency, self._errors, _ = client_metrics()
        self._channel = grpc.insecure_channel(addr, options=_GRPC_OPTIONS)
        self._stubs = {}

    def call(self, rpc_name, _retriable=True, _plan=None, **fields):
        """One attempt. ``_retriable``: the transports' common signature
        (this client never resends); ``_plan``: a :class:`MessagePlan`
        of ``fields`` already made (the shared-memory channel's fallback
        does not plan a message twice)."""
        stub = self._stubs.get(rpc_name)
        if stub is None:
            stub = self._channel.unary_unary(
                "/%s/%s" % (_SERVICE, rpc_name),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            stub = self._stubs.setdefault(rpc_name, stub)
        if _plan is None:
            inject_span_context(fields)
        plan = _plan if _plan is not None else plan_message(fields)
        buf = bytearray(plan.total)
        pack_message_into(plan, buf)
        # grpc sends exactly ``bytes``: the transport's one handoff copy
        request = bytes(buf)
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
        return unpack_message(reply, arena=WireArena(reply))

    def close(self):
        self._channel.close()
