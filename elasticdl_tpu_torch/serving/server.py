"""The scorer's RPC surface: ``score`` + ``scorer_status``.

The port of ``elasticdl_tpu/serving/server.py``. Requests are dict
messages (rpc/core.py) whose non-underscore fields are the feature
arrays; replies carry the output plus the ``model_version`` that scored
it, or ``{"error": ...}`` when the plane is degraded or shedding
(``overloaded`` + ``reason``). Both RPCs are idempotent reads, so a
client may retry freely.

Outputs leave the device here: a reply holds a CPU tensor (a bf16 model's
logits stay bf16 and travel as a ``bfloat16`` frame). Not ported yet: the
shared-memory endpoint and the telemetry HTTP endpoint.
"""

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
    """One scorer process's RPC server. ``port=0`` binds an ephemeral
    port (exposed as ``.port``); ``stop`` drains the batcher before the
    transport goes."""

    def __init__(self, scorer, port=0, batcher=None):
        from elasticdl_tpu_torch.rpc.core import serve

        self._scorer = scorer
        self._batcher = batcher
        if batcher is not None:
            batcher.start()
        self.servicer = ScorerServicer(scorer, batcher=batcher)
        self._server = serve(self.servicer.rpc_methods(), port)
        self.port = self._server._edl_port
        logger.info("scorer RPC server on port %d", self.port)

    def stop(self):
        if self._batcher is not None:
            # drain before the transport goes: new submits shed as
            # "draining", queued requests get their replies
            self._batcher.stop(drain=True)
            self._batcher.close()
            self._batcher = None
        if self._server is not None:
            self._server.stop(grace=None)
            self._server = None
