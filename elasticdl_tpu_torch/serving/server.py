"""The scorer's RPC surface: ``score`` + ``scorer_status``.

The port of ``elasticdl_tpu/serving/server.py``. Requests are dict
messages (rpc/core.py) whose non-underscore fields are the feature
arrays; replies carry the output plus the ``model_version`` that scored
it, or ``{"error": ...}`` when the plane is degraded or shedding
(``overloaded`` + ``reason``). Both RPCs are idempotent reads, so a
client may retry freely.

Outputs leave the device here: a reply holds a CPU tensor (a bf16 model's
logits stay bf16 and travel as a ``bfloat16`` frame). The server speaks
gRPC, the reference's wire, or (``transport="socket"``) the port's socket
transport (``rpc/socket_transport.py``) with the same frames, for a host
without ``grpcio``. On either, the shared-memory endpoint
(``rpc/shm_transport.py``) is always offered, as in the reference: a
co-located client's ``ShmChannel`` sends its requests and takes its
replies through a ring of slots. With ``telemetry_port >= 0`` the
server also serves ``/metrics``, ``/events``, ``/trace`` and ``/healthz``
(``loading`` until the first model installs, then ``serving``,
``draining`` through stop) from this process's registry.
"""

import threading

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.serving.batcher import Overloaded
from elasticdl_tpu_torch.utils import profiling


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu")
    return np.asarray(value)


class ScorerServicer:
    """Dict-method servicer over one :class:`~elasticdl_tpu_torch.serving.
    scorer.Scorer`, served through rpc.core or called in-process. With a
    :class:`~elasticdl_tpu_torch.serving.batcher.MicroBatcher`, ``score``
    goes through its coalescing queue instead of the scorer directly."""

    def __init__(self, scorer, batcher=None):
        self._scorer = scorer
        self._batcher = batcher

    def score(self, req):
        """Score the request's feature arrays -> ``output`` (or
        ``out:<name>`` fields for dict outputs) and ``model_version``;
        ``{"error": ...}`` on failure."""
        features = {
            k: v if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in req.items()
            if not k.startswith("_")
        }
        if not features:
            self._scorer.note_error("bad_request")
            return {"error": "score request carried no feature arrays"}
        try:
            if self._batcher is not None:
                out, version = self._batcher.submit(features)
            else:
                out, version = self._scorer.score(features)
        except Overloaded as err:
            self._scorer.note_error("overloaded")
            return {"error": "overloaded", "reason": err.reason}
        except Exception as err:  # noqa: BLE001 — degraded, reported
            logger.warning("score request failed: %s", err)
            return {"error": str(err)[:500]}
        reply = {"model_version": int(version)}
        if isinstance(out, dict):
            for name, value in out.items():
                reply["out:%s" % name] = _to_host(value)
        else:
            reply["output"] = _to_host(out)
        return reply

    def scorer_status(self, req):
        """Read-only probe: current model version and in-flight ledger."""
        return self._scorer.status()

    def rpc_methods(self):
        return profiling.instrument_service_methods(
            {
                "score": self.score,
                "scorer_status": self.scorer_status,
            },
            role="scorer",
        )


class ScorerServer:
    """One scorer process's RPC server and telemetry endpoint.
    ``port=0`` binds an ephemeral port (exposed as ``.port``);
    ``transport`` is ``"grpc"`` or ``"socket"``; ``telemetry_port >= 0``
    serves the process registry over HTTP (exposed as
    ``.telemetry_port``); ``stop`` drains the batcher before the
    transport goes, the attached rings and the endpoint after it."""

    def __init__(self, scorer, port=0, batcher=None, transport="grpc",
                 telemetry_port=-1):
        from elasticdl_tpu_torch.rpc.shm_transport import install_shm_endpoint

        if transport not in ("grpc", "socket"):
            raise ValueError("transport must be 'grpc' or 'socket'")
        self._scorer = scorer
        self._batcher = batcher
        self.servicer = ScorerServicer(scorer, batcher=batcher)
        self._draining = threading.Event()
        self._telemetry_http = None
        if telemetry_port is not None and telemetry_port >= 0:
            from elasticdl_tpu_torch.master.telemetry import (
                ProcessTelemetry,
                TelemetryHTTPServer,
            )

            self._telemetry_http = TelemetryHTTPServer(
                ProcessTelemetry(),
                port=telemetry_port,
                health_fn=self._health,
            )
            self.telemetry_port = self._telemetry_http.port
        methods, self._shm_registry = install_shm_endpoint(
            self.servicer.rpc_methods()
        )
        if transport == "grpc":
            from elasticdl_tpu_torch.rpc.core import serve

            self._server = serve(methods, port)
            self.port = self._server._edl_port
        else:
            from elasticdl_tpu_torch.rpc.socket_transport import serve

            self._server = serve(methods, port)
            self.port = self._server.port
        self._transport = transport
        if batcher is not None:
            batcher.start()
        logger.info(
            "scorer %s server on port %d%s", transport, self.port,
            (" (telemetry on %d)" % self.telemetry_port
             if self._telemetry_http is not None else ""),
        )

    def _health(self):
        if self._draining.is_set():
            return "draining"
        return "serving" if self._scorer.model_version >= 0 else "loading"

    def stop(self):
        self._draining.set()
        if self._batcher is not None:
            # drain before the transport goes: new submits shed as
            # "draining", queued requests get their replies
            self._batcher.stop(drain=True)
            self._batcher.close()
            self._batcher = None
        if self._server is not None:
            if self._transport == "grpc":
                self._server.stop(grace=None)
            else:
                self._server.stop()
            self._server = None
        if self._shm_registry is not None:
            self._shm_registry.close()
            self._shm_registry = None
        if self._telemetry_http is not None:
            self._telemetry_http.close()
            self._telemetry_http = None
