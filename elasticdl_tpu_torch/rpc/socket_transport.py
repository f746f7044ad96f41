"""The job plane's transport: the port's message frames
(``rpc/core.pack_message``/``unpack_message``) over stdlib TCP sockets.

The reference's master serves gRPC (``elasticdl_tpu/rpc/core.py``); the
machines the port runs on need not have ``grpcio``, so the master and
its worker processes talk over plain sockets instead. The frames are the
reference's, so a handler receives and returns the same dicts either
way; the wire is not gRPC, and a JAX worker cannot dial the port's
master (nor the reverse).

One call on one connection::

    request  u32 name_len | name (utf-8) | u64 frame_len | frame
    reply    u8 status | u64 payload_len | payload

A status of 0 carries the reply frame; any other status carries the
error's text (utf-8), raised at the caller as :class:`RpcError` with the
code below. A refused connection, or a reset or end of stream before the
first reply byte, is ``UNAVAILABLE`` (the master never answered; the
failover channel of ``rpc/failover.py`` may send the call again); one
after it is ``DATA_LOSS``, and an expired deadline is
``DEADLINE_EXCEEDED``, neither of which is ever sent again. The server runs one thread per connection, a connection
carries any number of calls in turn, and a client keeps a small pool of
idle connections so that calls from several threads do not queue behind
each other. Frames over ``MAX_MESSAGE_BYTES`` (256 MB, the reference's
cap) are refused on either side.
"""

import socket
import struct
import threading
import time

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.rpc.core import (
    MAX_MESSAGE_BYTES,
    client_metrics,
    inject_span_context,
    pack_message,
    pack_message_into,
    plan_message,
    unpack_message,
)

_OK = 0
_CODES = {
    1: "INTERNAL",  # the handler raised
    2: "UNIMPLEMENTED",  # no such method
    3: "RESOURCE_EXHAUSTED",  # over the size cap
}
_STATUS = {code: status for status, code in _CODES.items()}
# how long a fixed port a killed predecessor held may linger before the
# bind gives up
BIND_TIMEOUT_S = 30.0


class RpcError(RuntimeError):
    """A failed call. ``code`` names the failure as gRPC's status codes
    do: ``UNAVAILABLE`` (refused or reset connection), ``DEADLINE_EXCEEDED``,
    ``INTERNAL`` (the handler raised; the message is its error),
    ``UNIMPLEMENTED`` and ``RESOURCE_EXHAUSTED``."""

    def __init__(self, code, message):
        super().__init__("%s: %s" % (code, message))
        self.code = code


class _ReplyCut(ConnectionError):
    """The connection broke after the first reply byte arrived."""


def _recv_exact(sock, n):
    """``n`` bytes from ``sock``; raises ConnectionResetError on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionResetError("connection closed by the peer")
        got += k
    return buf


def _send_reply(sock, status, payload):
    sock.sendall(struct.pack("<BQ", status, len(payload)))
    sock.sendall(payload)


class SocketServer:
    """Serves ``methods`` ({name: fn(dict) -> dict}) on ``host:port``
    (port 0 binds one the OS picks, exposed as :attr:`port`)."""

    def __init__(self, methods, port=0, host=""):
        """A fixed ``port`` a killed predecessor held may linger for a
        while: its bind is retried for up to ``BIND_TIMEOUT_S``."""
        self._methods = dict(methods)
        self._listener = _bind(host, port)
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._conns = set()
        self._stopped = False
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._acceptor.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # the listener was closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stopped:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_connection,
                args=(conn,),
                name="rpc-conn",
                daemon=True,
            ).start()

    def _serve_connection(self, conn):
        try:
            while True:
                try:
                    (name_len,) = struct.unpack("<I", _recv_exact(conn, 4))
                except (ConnectionError, OSError):
                    return  # the client hung up between calls
                name = bytes(_recv_exact(conn, name_len)).decode("utf-8")
                (frame_len,) = struct.unpack("<Q", _recv_exact(conn, 8))
                if frame_len > MAX_MESSAGE_BYTES:
                    # the request is not read: answer, then drop the line
                    _send_reply(
                        conn,
                        _STATUS["RESOURCE_EXHAUSTED"],
                        b"request of %d bytes over the %d-byte cap"
                        % (frame_len, MAX_MESSAGE_BYTES),
                    )
                    return
                frame = _recv_exact(conn, frame_len)
                status, payload = self._dispatch(name, frame)
                _send_reply(conn, status, payload)
        except (ConnectionError, OSError):
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, name, frame):
        fn = self._methods.get(name)
        if fn is None:
            return _STATUS["UNIMPLEMENTED"], (
                "no method %r" % name
            ).encode("utf-8")
        try:
            reply = fn(unpack_message(frame))
            payload = pack_message(reply if reply is not None else {})
        except Exception as e:  # noqa: BLE001 - relayed to the caller
            logger.warning("rpc %s failed", name, exc_info=True)
            return _STATUS["INTERNAL"], (
                "%s: %s" % (type(e).__name__, e)
            ).encode("utf-8")
        if len(payload) > MAX_MESSAGE_BYTES:
            return _STATUS["RESOURCE_EXHAUSTED"], (
                "reply of %d bytes over the %d-byte cap"
                % (len(payload), MAX_MESSAGE_BYTES)
            ).encode("utf-8")
        return _OK, payload

    def stop(self):
        """Stop accepting and close every connection."""
        with self._lock:
            self._stopped = True
            conns = list(self._conns)
        try:
            # wakes the acceptor's accept(), which a close alone does not
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._acceptor.join(timeout=5)


def _bind(host, port):
    deadline = time.monotonic() + BIND_TIMEOUT_S
    while True:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            listener.bind((host, port))
            return listener
        except OSError as e:
            listener.close()
            if not port or time.monotonic() >= deadline:
                raise
            logger.warning("port %d still held (%s); retrying the bind",
                           port, e)
            time.sleep(0.5)


def serve(methods, port=0):
    """Start a :class:`SocketServer` for ``methods`` on ``port`` (0: one
    the OS picks); returns it."""
    return SocketServer(methods, port)


class Client:
    """``client.call("method", **fields)`` -> reply dict, over the socket
    transport, with the reference ``Client``'s knobs.

    ``deadline_s``: each attempt's deadline (None blocks: a worker parked
    on a busy master must wait). ``retries``/``backoff_s``: a refused or
    reset connection (``UNAVAILABLE``) is retried up to ``retries`` times,
    the backoff doubling from ``backoff_s``; an expired deadline is not
    retried, nor is a call with ``_retriable=False``. Each attempt is
    counted in the reference's client families: its latency (successes),
    its error code, each retry."""

    def __init__(self, addr, deadline_s=None, retries=0, backoff_s=0.2):
        host, _, port = addr.rpartition(":")
        self._addr = (host or "localhost", int(port))
        self._deadline_s = deadline_s if deadline_s else None
        self._retries = retries
        self._backoff_s = backoff_s
        self._latency, self._errors, self._retried = client_metrics()
        self._lock = threading.Lock()
        self._idle = []
        self._closed = False

    def _connection(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("the RPC client is closed")
            if self._idle:
                return self._idle.pop()
        sock = socket.create_connection(self._addr)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _release(self, sock):
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        sock.close()

    def _attempt(self, name, frame):
        sock = self._connection()
        try:
            sock.settimeout(self._deadline_s)
            name_b = name.encode("utf-8")
            sock.sendall(
                struct.pack("<I", len(name_b)) + name_b
                + struct.pack("<Q", len(frame))
            )
            sock.sendall(frame)
            first = sock.recv(1)
            if not first:
                raise ConnectionResetError("connection closed by the peer")
            try:
                rest = _recv_exact(sock, 8)
                status, length = struct.unpack("<BQ", bytes(first) + rest)
                if length > MAX_MESSAGE_BYTES:
                    raise RpcError(
                        "RESOURCE_EXHAUSTED",
                        "reply of %d bytes over the cap" % length,
                    )
                payload = _recv_exact(sock, length)
            except (ConnectionError, OSError) as e:
                if isinstance(e, socket.timeout):
                    raise
                raise _ReplyCut(str(e)) from e
        except BaseException:
            sock.close()
            raise
        self._release(sock)
        if status != _OK:
            raise RpcError(
                _CODES.get(status, "UNKNOWN"), bytes(payload).decode("utf-8")
            )
        # the views hold the reply's buffer alive: no arena is needed
        # (release_message is a no-op without one)
        return unpack_message(payload)

    def call(self, rpc_name, _retriable=True, _plan=None, **fields):
        """``_plan``: a ``rpc.core.MessagePlan`` of ``fields`` already
        made (the shared-memory channel's fallback does not plan a
        message twice). A ``_shm_req`` control message is an ordinary
        field; the caller's span context rides as ``_sctx``
        (``rpc.core.inject_span_context``)."""
        if _plan is None:
            inject_span_context(fields)
        plan = _plan if _plan is not None else plan_message(fields)
        if plan.total > MAX_MESSAGE_BYTES:
            raise RpcError(
                "RESOURCE_EXHAUSTED",
                "request of %d bytes over the %d-byte cap"
                % (plan.total, MAX_MESSAGE_BYTES),
            )
        frame = bytearray(plan.total)
        pack_message_into(plan, frame)
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                reply = self._attempt(rpc_name, frame)
            except socket.timeout as e:
                self._errors.inc(method=rpc_name, code="DEADLINE_EXCEEDED")
                raise RpcError(
                    "DEADLINE_EXCEEDED",
                    "%s after %ss" % (rpc_name, self._deadline_s),
                ) from e
            except _ReplyCut as e:
                # the master answered, then the line broke: the call may
                # have taken effect, so it is not sent again
                self._errors.inc(method=rpc_name, code="DATA_LOSS")
                raise RpcError(
                    "DATA_LOSS", "%s reply from %s:%d cut: %s"
                    % (rpc_name, self._addr[0], self._addr[1], e)
                ) from e
            except RpcError as e:
                self._errors.inc(method=rpc_name, code=e.code)
                raise
            except (ConnectionError, OSError) as e:
                self._errors.inc(method=rpc_name, code="UNAVAILABLE")
                if not (_retriable and attempt < self._retries):
                    raise RpcError(
                        "UNAVAILABLE", "%s to %s:%d: %s"
                        % (rpc_name, self._addr[0], self._addr[1], e)
                    ) from e
                self._retried.inc(method=rpc_name)
                time.sleep(self._backoff_s * (2 ** attempt))
                attempt += 1
                continue
            self._latency.observe(time.perf_counter() - t0, method=rpc_name)
            return reply

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            sock.close()
