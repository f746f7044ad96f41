"""The master's RPC surface and the worker's client for it, the
counterpart of ``elasticdl_tpu/master/rpc_service.py``, over the port's
socket transport (``rpc/socket_transport.py``).

:class:`MasterRpcService` wraps the coordinating ``MasterServicer`` and
the ``MembershipService`` as dict-message handlers; every reply carries
this master's ``master_epoch``. :class:`MasterClient` gives a worker
process the servicer's method surface over a connection to them, so the
workers run the same code against a remote master as against the
in-process servicer.

The methods an ALLREDUCE job calls are served: ``get_task``,
``report_task_result``, ``report_evaluation_metrics``, ``master_status``,
``get_comm_world``, ``leave_comm_world`` and ``standby_poll``; and those
of the master-held model (a ParameterServerStrategy job): ``get_model``,
``report_variable``, ``report_gradient``, ``push_embedding_info``,
``pull_embedding_vectors`` and ``export_embedding_tables``, with the
fields of the reference's messages and tensors in tensor frames. With
``wire_dtype`` ``bfloat16`` (``rpc/wire_compression.py``) the master's
``get_model`` reply and the client's gradients ride the wire as bf16,
widened to float32 on receipt, as in the reference. Worker telemetry
snapshots (``report_telemetry``) go to the servicer's ``JobTelemetry``,
a no-op without one.

The client sends every call through the failover channel
(``rpc/failover.py``): with ``failover_s`` > 0 it rides out a master
restart for that long, a master that stays away longer ends the worker
with the channel's error, and ``set_on_master_epoch_change`` hooks each
restart it sees. With ``shm`` ``"auto"`` (or ``"on"``) it negotiates a
shared-memory ring with a co-located master (``rpc/shm_transport.py``)
and sends ``get_model`` alone through it, as the reference does: the
master keeps decoded request tensors past its reply (the held model,
the sync accumulator), so requests stay on the socket path.
"""

import numpy as np

from elasticdl_tpu_torch.common.constants import GetModelMethod, TaskType
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import Tensor, release_message
from elasticdl_tpu_torch.master.servicer import TaskResponse
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo
from elasticdl_tpu_torch.rpc.wire_compression import (
    compress_tensors,
    decompress_tensors,
)
from elasticdl_tpu_torch.utils import profiling

class MasterRpcService:
    """Server side: dict-message handlers around a MasterServicer and the
    membership. ``master_epoch`` stamps every reply; ``status_fn`` adds
    to the ``master_status`` probe; ``wire_dtype`` narrows the model
    replies."""

    def __init__(
        self, servicer, membership=None, master_epoch=0, status_fn=None,
        wire_dtype="",
    ):
        self._s = servicer
        self._wire_dtype = wire_dtype
        self._membership = membership
        self._master_epoch = int(master_epoch)
        self._status_fn = status_fn
        # True once a remote worker polled for work: the master's run
        # loop then lingers after the last task so the last poller
        # learns "no more tasks" from a live master
        self.served_get_task = False

    def get_task(self, req):
        self.served_get_task = True
        task_type = req.get("task_type")
        res = self._s.get_task(
            req.get("worker_id", -1),
            TaskType(task_type) if task_type is not None else None,
        )
        return {
            "task_id": res.task_id,
            "shard_name": res.shard_name,
            "start": res.start,
            "end": res.end,
            "type": int(res.type) if res.type is not None else None,
            "model_version": res.model_version,
            "minibatch_size": res.minibatch_size,
            "extended_config": res.extended_config,
        }

    def report_task_result(self, req):
        self._s.report_task_result(
            req.get("task_id", -1),
            req.get("err_message", ""),
            req.get("exec_counters") or None,
        )
        return {}

    def master_status(self, req):
        """This master's boot id, serving state and version, plus what
        ``status_fn`` adds; answers even if ``status_fn`` fails."""
        status = {
            "master_epoch": self._master_epoch,
            "state": "serving",
            "version": self._s.get_model_version(),
        }
        if self._status_fn is not None:
            try:
                status.update(self._status_fn() or {})
            except Exception:
                logger.warning(
                    "master_status status_fn failed", exc_info=True
                )
        return status

    def get_model(self, req):
        version, named = self._s.get_model(
            req.get("version", 0), GetModelMethod(req.get("method", 0))
        )
        params, compressed = compress_tensors(
            [Tensor(n, v) for n, v in sorted(named.items())],
            self._wire_dtype,
        )
        return {
            "version": version,
            "params": params,
            "compressed_f32": compressed,
        }

    def report_variable(self, req):
        self._s.report_variable(
            {t.name: t.values for t in req.get("params", [])}
        )
        return {}

    def report_gradient(self, req):
        accepted, version = self._s.report_gradient(
            decompress_tensors(
                req.get("gradients", []), req.get("compressed_f32")
            ),
            req.get("model_version", -1),
        )
        return {"accepted": accepted, "version": version}

    def push_embedding_info(self, req):
        self._s.push_embedding_info(
            [
                EmbeddingTableInfo(
                    i["name"], i["dim"], i.get("initializer", "uniform")
                )
                for i in req.get("embedding_infos", [])
            ]
        )
        return {}

    def pull_embedding_vectors(self, req):
        rows = self._s.pull_embedding_vectors(
            req["name"], np.asarray(req["ids"], dtype=np.int64)
        )
        return {"rows": rows}

    def export_embedding_tables(self, req):
        named = self._s.export_embedding_tables()
        return {
            "params": [Tensor(n, v) for n, v in sorted(named.items())],
            "compressed_f32": [],
        }

    def report_telemetry(self, req):
        self._s.report_telemetry(req.get("snapshot") or {})
        return {}

    def report_evaluation_metrics(self, req):
        outputs = {t.name: t.values for t in req.get("model_outputs", [])}
        accepted, version = self._s.report_evaluation_metrics(
            req.get("model_version", -1),
            outputs,
            req.get("labels"),
            scored_version=req.get("scored_version"),
        )
        return {"accepted": accepted, "version": version}

    def get_comm_world(self, req):
        """The membership poll of the elastic allreduce plane. A spare's
        reply also says whether the job has finished (``job_finished``):
        a parked spare holds no work, and exits once nothing is left."""
        if self._membership is None:
            return {"epoch": -1, "ready": False}
        reply = self._membership.get_world(
            req.get("worker_id", -1),
            req.get("host", "localhost"),
            awaiting=req.get("awaiting", True),
            world_size=int(req.get("world_size", 0) or 0),
            world_epoch=int(req.get("world_epoch", 0) or 0),
        )
        if reply.get("spare"):
            reply = dict(reply, job_finished=self._s.job_finished())
        return reply

    def leave_comm_world(self, req):
        """A worker's announced leave (a drain, or its clean end): bump
        the epoch before its process exits."""
        if self._membership is not None:
            self._membership.remove(
                req.get("worker_id", -1), departing=True
            )
        return {}

    def standby_poll(self, req):
        """A parked standby's heartbeat: the worker id (and the device)
        of its promotion once the instance manager promotes it, else a
        None id."""
        if self._membership is None:
            return {"worker_id": None, "device": None}
        pool = self._membership.standby
        token = int(req.get("token", -1))
        return {"worker_id": pool.poll(token), "device": pool.device(token)}

    def _stamp_epoch(self, fn):
        epoch = self._master_epoch

        def handler(req):
            reply = fn(req)
            if isinstance(reply, dict) and "master_epoch" not in reply:
                reply["master_epoch"] = epoch
            return reply

        return handler

    def rpc_methods(self):
        """The handlers, each stamped with the epoch and recording its
        service time into ``edl_rpc_server_latency_seconds{role="master"}``
        (and the ``rpc/<method>`` span of a caller's trace)."""
        methods = {
            name: self._stamp_epoch(fn)
            for name, fn in {
                "get_task": self.get_task,
                "get_comm_world": self.get_comm_world,
                "leave_comm_world": self.leave_comm_world,
                "standby_poll": self.standby_poll,
                "master_status": self.master_status,
                "report_task_result": self.report_task_result,
                "report_evaluation_metrics": self.report_evaluation_metrics,
                "get_model": self.get_model,
                "report_variable": self.report_variable,
                "report_gradient": self.report_gradient,
                "push_embedding_info": self.push_embedding_info,
                "pull_embedding_vectors": self.pull_embedding_vectors,
                "export_embedding_tables": self.export_embedding_tables,
                "report_telemetry": self.report_telemetry,
            }.items()
        }
        return profiling.instrument_service_methods(methods, role="master")


class MasterClient:
    """Worker side: the servicer's method surface over the failover
    channel. Calls carry no deadline (a worker parked on a busy master
    waits); a refused or reset connection, and a cut reply of a call in
    ``failover.RESEND_AFTER_CUT``, is sent again for up to
    ``failover_s`` seconds (0: once). ``wire_dtype`` narrows the
    gradients it sends. ``shm``: ``"auto"`` or ``"on"`` sends
    ``get_model`` through a shared-memory ring negotiated with a
    co-located master (``shm_slots`` x ``shm_slot_mb``), the socket path
    otherwise; ``"off"`` (the default for direct constructions) never
    negotiates."""

    def __init__(self, addr, failover_s=0.0, wire_dtype="", shm="off",
                 shm_slots=4, shm_slot_mb=8):
        from elasticdl_tpu_torch.rpc.failover import MasterFailoverChannel

        if shm not in ("auto", "on", "off", "", None, False):
            raise ValueError("shm must be 'auto', 'on' or 'off'")
        self._wire_dtype = wire_dtype
        self._client = MasterFailoverChannel(
            addr,
            outage_budget_s=failover_s,
            on_epoch_change=self._on_epoch_change,
        )
        self._epoch_change_cb = None
        self._shm = None
        if shm in ("auto", "on"):
            from elasticdl_tpu_torch.rpc.shm_transport import ShmChannel

            self._shm = ShmChannel(
                self._client, n_slots=shm_slots, slot_mb=shm_slot_mb
            )

    @property
    def shm_channel(self):
        """The ``ShmChannel`` of ``get_model`` (None when off)."""
        return self._shm

    @property
    def master_epoch(self):
        """The serving master's boot id, as last seen (None before the
        first reply)."""
        return self._client.master_epoch

    @property
    def outage_budget_s(self):
        return self._client.outage_budget_s

    def set_on_master_epoch_change(self, callback):
        """``callback(old_epoch, new_epoch)`` fires once per master
        restart the channel sees."""
        self._epoch_change_cb = callback

    def _on_epoch_change(self, old, new):
        if self._epoch_change_cb is not None:
            self._epoch_change_cb(old, new)

    def _call(self, _method, _budget_s=None, **fields):
        return self._client.call(_method, _budget_s=_budget_s, **fields)

    def get_task(self, worker_id, task_type=None):
        resp = self._call(
            "get_task",
            worker_id=worker_id,
            task_type=int(task_type) if task_type is not None else None,
        )
        return TaskResponse(
            task_id=resp["task_id"],
            shard_name=resp["shard_name"],
            start=resp["start"],
            end=resp["end"],
            type=TaskType(resp["type"]) if resp["type"] is not None else None,
            model_version=resp["model_version"],
            minibatch_size=resp["minibatch_size"],
            extended_config=resp.get("extended_config") or {},
        )

    def report_task_result(self, task_id, err_message="", exec_counters=None):
        self._call(
            "report_task_result",
            task_id=int(task_id),
            err_message=err_message,
            exec_counters=exec_counters,
        )

    def get_model(self, version, method=GetModelMethod.MINIMUM):
        if self._shm is None:
            resp = self._call(
                "get_model", version=int(version), method=int(method)
            )
        else:
            resp = self._shm.call(
                "get_model", version=int(version), method=int(method)
            )
            # a slot reply decodes outside the failover channel (its
            # control reply carries only the slot spec): the epoch watch
            # is fed by hand, so a relaunch is still seen
            self._client.note_reply(resp)
        try:
            params = decompress_tensors(
                resp.get("params", []), resp.get("compressed_f32")
            )
            # the worker keeps these arrays across steps: owned copies,
            # made before a slot's reply is released
            return resp["version"], {
                t.name: np.array(t.values) for t in params
            }
        finally:
            release_message(resp)

    def report_telemetry(self, snapshot):
        # telemetry is lossy-tolerant (a failed snapshot requeues its
        # events and spans), so its outage budget is capped: a worker's
        # final forced ship at job end must not park behind a master
        # that already exited cleanly
        self._call(
            "report_telemetry",
            _budget_s=min(self._client.outage_budget_s, 10.0),
            snapshot=snapshot,
        )

    def report_variable(self, named_arrays):
        self._call(
            "report_variable",
            params=[Tensor(n, v) for n, v in named_arrays.items()],
        )

    def report_gradient(self, gradients, model_version):
        grads, compressed = compress_tensors(
            list(gradients), self._wire_dtype
        )
        resp = self._call(
            "report_gradient",
            gradients=grads,
            model_version=int(model_version),
            compressed_f32=compressed,
        )
        return resp["accepted"], resp["version"]

    def push_embedding_info(self, embedding_infos):
        self._call(
            "push_embedding_info",
            embedding_infos=[
                {"name": i.name, "dim": i.dim, "initializer": i.initializer}
                for i in embedding_infos
            ],
        )

    def pull_embedding_vectors(self, layer_name, ids):
        resp = self._call(
            "pull_embedding_vectors",
            name=layer_name,
            ids=np.asarray(ids, dtype=np.int64),
        )
        return resp["rows"]

    def export_embedding_tables(self):
        resp = self._call("export_embedding_tables")
        return {t.name: np.array(t.values) for t in resp.get("params", [])}

    def master_status(self):
        """One attempt: a probe must not ride out an outage."""
        return self._call("master_status", _budget_s=0.0)

    def report_evaluation_metrics(
        self, model_version, model_outputs, labels, scored_version=None
    ):
        kwargs = {}
        if scored_version is not None:
            kwargs["scored_version"] = int(scored_version)
        resp = self._call(
            "report_evaluation_metrics",
            model_version=int(model_version),
            model_outputs=[
                Tensor(n, np.asarray(v)) for n, v in model_outputs.items()
            ],
            labels=np.asarray(labels),
            **kwargs,
        )
        return resp["accepted"], resp["version"]

    def get_comm_world(self, worker_id, host="localhost", awaiting=True,
                       world_size=0, world_epoch=0, budget_s=None):
        """The membership poll; ``world_size`` and ``world_epoch`` name
        the last world the worker formed (0: none), ``budget_s`` caps
        this call's outage window (the abort probe's is 0)."""
        return self._call(
            "get_comm_world",
            _budget_s=budget_s,
            worker_id=int(worker_id),
            host=host,
            awaiting=awaiting,
            world_size=int(world_size),
            world_epoch=int(world_epoch),
        )

    def leave_comm_world(self, worker_id, budget_s=None):
        return self._call(
            "leave_comm_world", _budget_s=budget_s, worker_id=int(worker_id)
        )

    def standby_poll(self, token):
        """(worker id, device) of this standby's promotion, or (None,
        None) while it stays parked."""
        resp = self._call("standby_poll", token=int(token))
        return resp["worker_id"], resp.get("device")

    def close(self):
        if self._shm is not None:
            self._shm.close()
        self._client.close()
