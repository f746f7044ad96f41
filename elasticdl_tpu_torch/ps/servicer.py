"""A parameter-server shard's service, the port of
``elasticdl_tpu/ps/servicer.py``, over the shard's ``ps.Parameters``:

- ``pull_variable``: the shard's dense parameters and whether they are
  initialized (sync mode copies them under the accumulation lock, so a
  pull never sees half an apply; async reads them as they are);
- ``pull_embedding_vector``: rows of one table, minted lazily, with the
  shard's version;
- ``push_model``: the first pushed model initializes the shard (first
  write wins); ``push_embedding_info`` registers tables;
- ``push_gradient``: async mode applies each push at once (the LR
  scaled by ``1 / max(1, version - request_version)`` with
  ``lr_staleness_modulation``); sync mode rejects a push older than the
  shard's version, sums ``grads_to_wait`` pushes (dense averaged,
  indexed slices concatenated, duplicates combined at the apply) and
  applies once. Each apply advances the version, then offers the
  snapshotter its cadence;
- ``ps_status``: version, initialized, the restored version and the
  snapshot cadence, plus the port's counters: each recent apply's
  dense and sparse milliseconds, each table's rows and their bytes, and
  the card's peak memory; a tiered store adds its tables' counters
  summed under ``tiered``.

- ``serving_status`` and ``pull_embedding_delta``: the scorer's reads
  (``serving/delta_sync.py``). Each apply notes the ids it wrote in a
  ``ps/delta_log.DeltaLog`` before its version becomes visible, so the
  first tells a scorer, per table that is not an optimizer slot, the
  newest version that wrote it (the log's floor beside it), and the
  second which ids moved after a given version.

Each apply tells the tables of every layer it wrote which ids its
version touched (``note_applied``: a tiered table pins them against
demotion).

Every reply carries the shard's ``shard_epoch``, so a client sees a
relaunch. Methods take and return dicts, so one object serves the
socket transport (``rpc_methods``) or an in-process caller. A whole
apply holds the optimizer's apply lock (the LR multiplier is one value
per modulator, and a snapshot must not cut an apply).
"""

import threading
import time
from collections import deque

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import Tensor, device_host_view
from elasticdl_tpu_torch.ps.delta_log import DeltaLog
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo
from elasticdl_tpu_torch.rpc.wire_compression import (
    compress_tensors,
    decompress_tensors,
)
from elasticdl_tpu_torch.utils import profiling


def _infos(req):
    return [
        EmbeddingTableInfo(
            i["name"], i["dim"], i.get("initializer", "uniform")
        )
        for i in req.get("embedding_infos", [])
    ]


def _on_host(tensors):
    """Payloads as host arrays: an in-process caller's torch tensors (a
    worker hands its dense gradients and parameters over on the card,
    for a frame write's one copy out) stage here. A decoded frame passes
    as it is: numpy, or a bf16 tensor the decompression widened."""
    return [
        Tensor(t.name, device_host_view(t.values), t.indices)
        if isinstance(t.values, torch.Tensor)
        and t.values.dtype != torch.bfloat16 else t
        for t in tensors
    ]


class PserverServicer:
    def __init__(
        self,
        parameters,
        grads_to_wait,
        optimizer,
        device,
        lr_staleness_modulation=False,
        use_async=False,
        wire_dtype="",
        snapshotter=None,
        shard_epoch=0,
        restored_version=None,
    ):
        """``optimizer``: the zoo's torch optimizer factory; ``device``:
        where the shard's applies run."""
        from elasticdl_tpu_torch.master.learning_rate_modulator import (
            add_lr_modulation_to_optimizer,
        )
        from elasticdl_tpu_torch.ps.optimizer_wrapper import (
            OptimizerWrapper,
        )

        self._parameters = parameters
        self._grads_to_wait = grads_to_wait
        self._wire_dtype = wire_dtype
        self._use_async = use_async
        self._lock = threading.Lock()
        self._lr_modulation = None
        if use_async and lr_staleness_modulation:
            optimizer, self._lr_modulation = add_lr_modulation_to_optimizer(
                optimizer
            )
        self._optimizer = OptimizerWrapper(optimizer, parameters, device)
        self._device = torch.device(device)
        self._dense_sum = {}
        self._indexed_sum = {}
        self._grad_n = 0
        self._snapshotter = snapshotter
        self._shard_epoch = int(shard_epoch)
        self._restored_version = (
            -1 if restored_version is None else int(restored_version)
        )
        # the rows each version wrote, for the scorers' delta sync; what
        # this boot restored is older than its log (a scorer drops that
        # shard's rows when it sees the new shard_epoch)
        self._delta = DeltaLog(base_version=parameters.version)
        # the recent applies' host milliseconds, dense and sparse
        self.apply_ms = {"dense": deque(maxlen=1024),
                         "sparse": deque(maxlen=1024)}

    def _reply(self, resp):
        resp["shard_epoch"] = self._shard_epoch
        return resp

    # -- applies -------------------------------------------------------------

    def _apply(self, dense, sparse, request_version):
        """One apply and its version bump, under the apply lock."""
        with self._optimizer.apply_lock:
            if self._lr_modulation is not None:
                staleness = max(
                    1, self._parameters.version - request_version
                )
                self._lr_modulation.set_multiplier(1.0 / staleness)
            try:
                t0 = time.perf_counter()
                if dense:
                    self._optimizer.apply_dense_gradients(dense)
                t1 = time.perf_counter()
                for name, t in sparse.items():
                    self._optimizer.apply_sparse_gradients(
                        name, t.indices, t.values
                    )
                t2 = time.perf_counter()
            finally:
                if self._lr_modulation is not None:
                    self._lr_modulation.set_multiplier(1.0)
            if dense:
                self.apply_ms["dense"].append((t1 - t0) * 1e3)
            if sparse:
                self.apply_ms["sparse"].append((t2 - t1) * 1e3)
            # noted before the version is visible: serving_status reads
            # the version first and the log after, so the log may run
            # ahead of the version but never behind it (a scorer would
            # re-tag rows this version wrote as unchanged). A sync
            # apply's summed slices repeat ids: the log keeps each once.
            version = self._parameters.version + 1
            for name, t in sparse.items():
                self._delta.note(
                    name,
                    t.indices if self._use_async else np.unique(t.indices),
                    version,
                )
                self._note_applied(name, t.indices, version)
            self._parameters.version = version

    def _note_applied(self, name, ids, version):
        """Tell a tiered table which rows ``version`` applied to (its
        demoter pins them): the layer's rows and every ``"{layer}-
        {slot}"`` table, which the same update wrote."""
        tables = self._parameters.embedding_params
        family = [tables.get(name)] + [
            t for key, t in list(tables.items())
            if t.is_slot and key.startswith(name + "-")
        ]
        for t in family:
            note = getattr(t, "note_applied", None)
            if note is not None:
                note(ids, version)

    def _maybe_snapshot(self):
        if self._snapshotter is not None:
            # the span times the capture's submit (the copy under the
            # apply lock); the disk write runs on the snapshotter's
            # thread, off every trace
            with profiling.span("ps/snapshot_submit"):
                self._snapshotter.maybe_snapshot(
                    self._parameters, apply_lock=self._optimizer.apply_lock
                )

    def drain_snapshot(self):
        """The SIGTERM drain's final snapshot: queued cadence writes land
        first, then the store as it is now; its directory, or None."""
        if self._snapshotter is None:
            return None
        with profiling.span("ps/snapshot_drain"):
            self._snapshotter.wait()
            return self._snapshotter.snapshot_now(
                self._parameters, apply_lock=self._optimizer.apply_lock
            )

    # -- RPC methods ---------------------------------------------------------

    def pull_variable(self, req):
        if not self._parameters.initialized:
            return self._reply({"model_init_status": False, "version": -1})
        if self._use_async:
            named = self._parameters.to_named_arrays()
            version = self._parameters.version
        else:
            with self._lock:
                named = self._parameters.to_named_arrays()
                version = self._parameters.version
        params, compressed = compress_tensors(
            [Tensor(n, v) for n, v in sorted(named.items())],
            self._wire_dtype,
        )
        return self._reply({
            "model_init_status": True,
            "version": version,
            "params": params,
            "compressed_f32": compressed,
        })

    def pull_embedding_vector(self, req):
        version = self._parameters.version
        ids = np.asarray(req["ids"], dtype=np.int64)
        if ids.size == 0:
            return self._reply({
                "rows": np.zeros((0, 0), np.float32), "version": version,
            })
        rows = self._parameters.get_embedding_param(req["name"], ids)
        return self._reply({"rows": rows, "version": version})

    def push_model(self, req):
        self._parameters.init_from_model(
            req.get("version", 0),
            {t.name: t.values for t in _on_host(req.get("params", []))},
            _infos(req),
        )
        return self._reply({})

    def push_embedding_info(self, req):
        self._parameters.init_embedding_params(_infos(req))
        return self._reply({})

    def push_gradient(self, req):
        version = int(req.get("model_version", -1))
        gradients = _on_host(decompress_tensors(
            req.get("gradients", []), req.get("compressed_f32")
        ))
        if self._use_async:
            dense, sparse = {}, {}
            for t in gradients:
                self._parameters.check_grad(t)
                if t.is_indexed_slices():
                    sparse[t.name] = t
                else:
                    dense[t.name] = t.values
            # nests under the rpc/push_gradient server span when the
            # caller shipped its span context: a trace shows the wire
            # against the apply
            with profiling.span("ps/apply"):
                self._apply(dense, sparse, version)
            self._maybe_snapshot()
            return self._reply(
                {"accepted": True, "version": self._parameters.version}
            )
        with self._lock:
            if version < self._parameters.version:
                logger.warning(
                    "Dropping stale gradient for version %d (current %d)",
                    version, self._parameters.version,
                )
                return self._reply({
                    "accepted": False, "version": self._parameters.version,
                })
            # the sums outlive this request, whose tensors may be views
            # of a shared-memory slot the client recycles after the
            # reply: the first round materializes, later rounds
            # allocate through ``+``
            for t in gradients:
                self._parameters.check_grad(t)
                if t.is_indexed_slices():
                    prev = self._indexed_sum.get(t.name)
                    self._indexed_sum[t.name] = (
                        t.materialize() if prev is None else prev + t
                    )
                else:
                    prev = self._dense_sum.get(t.name)
                    values = np.asarray(t.values, dtype=np.float32)
                    self._dense_sum[t.name] = (
                        values.copy() if prev is None else prev + values
                    )
            self._grad_n += 1
            applied = self._grad_n >= self._grads_to_wait
            if applied:
                dense = {
                    k: v / self._grads_to_wait
                    for k, v in self._dense_sum.items()
                }
                try:
                    with profiling.span("ps/apply", sync=True):
                        self._apply(dense, self._indexed_sum, version)
                finally:
                    self._dense_sum = {}
                    self._indexed_sum = {}
                    self._grad_n = 0
            reply = self._reply(
                {"accepted": True, "version": self._parameters.version}
            )
        if applied:
            self._maybe_snapshot()
        return reply

    def ps_status(self, req):
        """Liveness and identity (a client probes it after a failure),
        with the shard's apply times and table sizes."""
        tables, nbytes, tiered = {}, 0, None
        for name, table in list(self._parameters.embedding_params.items()):
            rows = len(table)
            tables[name] = rows
            nbytes += rows * (8 + 4 * int(table.dim or 0))
            stats = getattr(table, "stats", None)
            if stats is not None:
                tiered = tiered or {}
                for key, value in stats().items():
                    tiered[key] = tiered.get(key, 0) + int(value)
        extra = {} if tiered is None else {"tiered": tiered}
        return self._reply({
            "version": self._parameters.version,
            "initialized": bool(self._parameters.initialized),
            "restored_version": self._restored_version,
            "snapshot_every": (
                self._snapshotter.every_versions
                if self._snapshotter is not None
                else 0
            ),
            "apply_ms": {k: list(v) for k, v in self.apply_ms.items()},
            "tables": tables,
            "table_bytes": nbytes,
            "peak_mib": (
                torch.cuda.max_memory_allocated(self._device) / 2**20
                if self._device.type == "cuda"
                else None
            ),
            **extra,
        })

    def serving_status(self, req):
        """What a scorer's delta sync polls: the version, and per table
        that is not an optimizer slot the newest version that wrote it
        (``tables``) and the oldest since-version the log answers
        completely (``floors``). A table with no update noted since boot
        reports the base, the restored version (0 on a fresh boot): a
        row changes only through a noted apply."""
        # the version first, the log after (see _apply)
        version = self._parameters.version
        last = self._delta.table_versions()
        floors = self._delta.floors()
        base = max(self._restored_version, 0)
        tables, table_floors = {}, {}
        for name, table in list(self._parameters.embedding_params.items()):
            if table.is_slot:
                continue
            tables[name] = int(last.get(name, base))
            table_floors[name] = int(floors.get(name, base))
        return self._reply({
            "version": version,
            "initialized": bool(self._parameters.initialized),
            "tables": tables,
            "floors": table_floors,
        })

    def pull_embedding_delta(self, req):
        """The ids of ``req["name"]`` written after
        ``req["since_version"]``, the newest version the answer covers
        (the caller's next since-version) and whether it is complete: a
        since-version below the log's floor is not, and the scorer then
        drops the table's stale rows. A read: resending it is safe."""
        ids, covered, complete = self._delta.since(
            req["name"], int(req.get("since_version", -1))
        )
        return self._reply({
            "ids": ids, "version": int(covered), "complete": bool(complete),
        })

    def rpc_methods(self):
        """The handlers, each recording its service time into
        ``edl_rpc_server_latency_seconds{role="ps"}`` and opening the
        ``rpc/<method>`` span of a caller's trace."""
        return profiling.instrument_service_methods(
            {
                "pull_variable": self.pull_variable,
                "pull_embedding_vector": self.pull_embedding_vector,
                "push_model": self.push_model,
                "push_embedding_info": self.push_embedding_info,
                "push_gradient": self.push_gradient,
                "ps_status": self.ps_status,
                "serving_status": self.serving_status,
                "pull_embedding_delta": self.pull_embedding_delta,
            },
            role="ps",
        )
