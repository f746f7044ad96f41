"""The master's service, the counterpart of
``elasticdl_tpu/master/servicer.py``, in its two forms.

**Coordinating** (``optimizer`` None, an ALLREDUCE job): the parameters
live on the worker. ``report_task_result`` takes the worker's model
version from the report's ``exec_counters`` (task reports are this
master's only version clock) and drives the evaluation service's step
trigger when it advances; an evaluation round pins a version number.

**Master-held model** (``optimizer`` a torch optimizer factory, the
ParameterServerStrategy job with no PS pods, and the Local strategy):
the master holds the dense model as ``{name: float32 ndarray}`` and the
elastic embedding tables, with their optimizer slots, in a host
``ps.Parameters`` store.

- ``get_model`` MINIMUM replies with the current model; FIXED with the
  version's checkpoint, ``edl_embedding:`` keys filtered out;
- ``report_variable``: the first worker's variables initialize the model;
- ``report_gradient`` checks the version (sync mode rejects a stale
  gradient and raises for one from the future), rejects a dense gradient
  against an uninitialized model, checks every gradient's shape and
  indices, then applies: sync mode sums ``grads_to_wait`` reports (dense
  sums averaged, indexed slices concatenated) and applies once; async
  mode applies each report at once, all applies serialized under the
  lock, with ``lr_staleness_modulation`` scaling the step by ``1 /
  max(1, version - request_version)``. Each apply advances the version;
- ``push_embedding_info`` registers tables, ``pull_embedding_vectors``
  returns rows (minted lazily), ``export_embedding_tables`` the store as
  ``edl_embedding:{table}:ids`` / ``:rows`` arrays, which every
  checkpoint carries too, and ``--checkpoint_filename_for_init``
  restores;
- an evaluation round pins an eval checkpoint (``save_eval_checkpoint``).

The dense update runs on ``device`` (``--device``): the model crosses to
it for each apply and back, as the reference's jitted update runs on its
default backend; the embedding rows are updated by
``ps/optimizer_wrapper.py`` on the same device. ``get_model`` replies
with host arrays.

With a ``journal`` each advance of the version appends a ``version``
record, and ``restore_version`` resumes the clock of a relaunched master.
"""

import threading
import time
from collections import deque

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import (
    GetModelMethod,
    TaskExecCounterKey,
    TaskType,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import Tensor

# checkpoint keys carrying the elastic embedding tables (ids and rows,
# slot tables included); they restore the store and never reach workers
EMBEDDING_EXPORT_PREFIX = "edl_embedding:"


class TaskResponse:
    """The get_task reply."""

    def __init__(
        self,
        task_id=-1,
        shard_name="",
        start=0,
        end=0,
        type=None,
        model_version=-1,
        minibatch_size=0,
        extended_config=None,
    ):
        self.task_id = task_id
        self.shard_name = shard_name
        self.start = start
        self.end = end
        self.type = type
        self.model_version = model_version
        self.minibatch_size = minibatch_size
        self.extended_config = extended_config or {}


class MasterServicer:
    def __init__(
        self,
        grads_to_wait,
        minibatch_size,
        optimizer,
        task_d,
        checkpoint_service=None,
        evaluation_service=None,
        coordinates_only=None,
        journal=None,
        init_var=None,
        checkpoint_filename_for_init=None,
        lr_staleness_modulation=False,
        use_async=False,
        device="cuda",
        telemetry=None,
    ):
        """``telemetry``: the master's ``JobTelemetry``, which ingests
        the workers' ``report_telemetry`` snapshots (None: ignored).
        ``optimizer``: a torch optimizer factory (``params ->
        Optimizer``) for a master that holds the model, None for one that
        coordinates. ``coordinates_only`` defaults to ``optimizer is
        None``. ``device``: where the updates run (used only with an
        optimizer)."""
        if coordinates_only is None:
            coordinates_only = optimizer is None
        if coordinates_only and optimizer is not None:
            raise ValueError("a coordinating master applies no optimizer")
        self._coordinates_only = bool(coordinates_only)
        self._journal = journal
        self.telemetry = telemetry
        self._task_d = task_d
        self._lock = threading.Lock()
        self._minibatch_size = minibatch_size
        self._grad_to_wait = grads_to_wait
        self._use_async = use_async
        self._version = 0
        self._gradient_sum = {}
        self._gradient_sum_indexed = {}
        self._edl_embedding_gradients = {}
        self._grad_n = 0
        self._model = {}  # {name: float32 ndarray}
        self._dense_opt = None  # torch optimizer over _dense_params
        self._dense_params = None
        self._lr_modulation = None
        self._device = None
        self._embedding_store = None
        self._embedding_gradient_applier = None
        # the recent applies' host milliseconds, dense and sparse
        self.apply_ms = {"dense": deque(maxlen=4096),
                         "sparse": deque(maxlen=4096)}
        if optimizer is not None:
            from elasticdl_tpu_torch.common.device import resolve_device
            from elasticdl_tpu_torch.master.learning_rate_modulator import (
                add_lr_modulation_to_optimizer,
            )
            from elasticdl_tpu_torch.ps.optimizer_wrapper import (
                OptimizerWrapper,
            )
            from elasticdl_tpu_torch.ps.parameters import Parameters

            self._device = resolve_device(device)
            if use_async and lr_staleness_modulation:
                optimizer, self._lr_modulation = (
                    add_lr_modulation_to_optimizer(optimizer)
                )
            self._embedding_store = Parameters()
            self._embedding_gradient_applier = OptimizerWrapper(
                optimizer, self._embedding_store, self._device
            )
        self._opt = optimizer
        self._init_model(checkpoint_filename_for_init, init_var)
        self._checkpoint_service = checkpoint_service
        self._evaluation_service = evaluation_service
        if evaluation_service:
            evaluation_service.set_master_servicer(self)

    # -- the held model -----------------------------------------------------

    def set_model_var(self, name, value):
        """Add or set a model variable (a float32 array)."""
        value = np.asarray(value)
        if value.dtype != np.float32:
            raise ValueError("Value should be a float32 numpy array")
        self._model[name] = value
        self._dense_opt = None  # the structure changed: rebuild lazily

    def _export_embedding_tables(self):
        out = {}
        if self._embedding_store is None:
            return out
        for name, table in list(self._embedding_store.embedding_params.items()):
            ids, rows = table.snapshot()
            if ids.size == 0:
                continue
            out[EMBEDDING_EXPORT_PREFIX + name + ":ids"] = ids
            out[EMBEDDING_EXPORT_PREFIX + name + ":rows"] = rows
        return out

    def export_embedding_tables(self):
        """The store as ``{edl_embedding:{table}:ids|rows: array}``: what
        a checkpoint carries, and what a worker's SAVE_MODEL export adds
        to the dense parameters."""
        with self._lock:
            return self._export_embedding_tables()

    def _import_embedding_tables(self, named):
        """Restore the tables of a checkpoint's ``edl_embedding:`` keys
        into the store; returns the remaining (dense) arrays."""
        from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable

        dense, tables = {}, {}
        for key, arr in named.items():
            if not key.startswith(EMBEDDING_EXPORT_PREFIX):
                dense[key] = arr
                continue
            body = key[len(EMBEDDING_EXPORT_PREFIX):]
            table_name, _, kind = body.rpartition(":")
            tables.setdefault(table_name, {})[kind] = arr
        for table_name, parts in tables.items():
            rows = np.asarray(parts["rows"], dtype=np.float32)
            table = EmbeddingTable(
                table_name, int(rows.shape[1]), "uniform",
                is_slot="-" in table_name,
            )
            table.set(np.asarray(parts["ids"], dtype=np.int64), rows)
            self._embedding_store.embedding_params[table_name] = table
        return dense

    def _init_model(self, checkpoint_filename_for_init, init_var):
        if checkpoint_filename_for_init:
            from elasticdl_tpu_torch.common.model_utils import (
                load_from_checkpoint_file,
            )

            version, named = load_from_checkpoint_file(
                checkpoint_filename_for_init
            )
            self._version = version
            if self._embedding_store is not None:
                named = self._import_embedding_tables(named)
            for name, arr in named.items():
                self.set_model_var(name, np.array(arr, dtype=np.float32))
        elif init_var:
            for name, arr in init_var.items():
                self.set_model_var(name, np.array(arr, dtype=np.float32))

    # -- RPC handlers -------------------------------------------------------

    @property
    def coordinates_only(self):
        """True for an ALLREDUCE job's master: it dispatches tasks and
        applies no gradients, so its version advances only through the
        workers' reports, and an evaluation round pins a version number
        rather than an eval checkpoint."""
        return self._coordinates_only

    @property
    def lock(self):
        """The model and version lock. The evaluation service checks and
        updates its trigger under it, so the step trigger and the timer
        thread share one lock order."""
        return self._lock

    @property
    def embedding_store(self):
        return self._embedding_store

    def get_task(self, worker_id, task_type=None):
        """The next task as a TaskResponse; WAIT while the job is not
        finished (or a deferred SAVE_MODEL task was just queued), an
        empty response once it is."""
        res = TaskResponse(
            model_version=self._version, minibatch_size=self._minibatch_size
        )
        if task_type == TaskType.EVALUATION:
            task_id, task = self._task_d.get_eval_task(worker_id)
        else:
            task_id, task = self._task_d.get(worker_id)
        if task:
            res.task_id = task_id
            res.shard_name = task.shard_name
            res.start = task.start
            res.end = task.end
            res.type = task.type
            res.extended_config = dict(task.extended_config)
            if task.type == TaskType.EVALUATION:
                res.model_version = task.model_version
        elif (not self._task_d.finished()) or (
            self._task_d.invoke_deferred_callback()
        ):
            res.type = TaskType.WAIT
        return res

    def get_model(self, version, method=GetModelMethod.MINIMUM):
        """``(version, {name: array})``: the current model (MINIMUM, or
        FIXED at the current version), else the FIXED version's
        checkpoint without its tables (an empty dict if it has none)."""
        if not self._use_async:
            self._validate_model_version(version)
        if method == GetModelMethod.MINIMUM or version == self._version:
            if self._use_async:
                return self._get_model_no_lock()
            with self._lock:
                return self._get_model_no_lock()
        try:
            ckpt_version, named = (
                self._checkpoint_service.get_checkpoint_model(version)
            )
        except Exception:
            logger.error(
                "Failed to fetch checkpoint model for model version %s",
                version,
            )
            return self._version, {}
        return ckpt_version, {
            k: v
            for k, v in named.items()
            if not k.startswith(EMBEDDING_EXPORT_PREFIX)
        }

    def report_variable(self, named_arrays):
        """First write wins: the first worker's variables initialize the
        model."""
        with self._lock:
            if not self._model:
                for name, arr in named_arrays.items():
                    self.set_model_var(name, np.array(arr, dtype=np.float32))

    def report_gradient(self, gradients, model_version):
        """``gradients``: Tensors, dense or indexed. Returns
        ``(accepted, current version)``."""
        if not (
            self._use_async or self._validate_model_version(model_version)
        ):
            logger.warning(
                "Task result for outdated version %d dropped", model_version
            )
            return False, self._version
        dense, indexed, edl = {}, {}, {}
        for tensor in gradients:
            if not isinstance(tensor, Tensor):
                raise TypeError("gradients must be Tensor objects")
            name = tensor.name
            if name not in self._model:
                if tensor.is_indexed_slices() and (
                    self._embedding_store is not None
                ):
                    # an elastic embedding layer: its table lives in the
                    # store, registered by push_embedding_info
                    self._embedding_store.check_grad(tensor)
                    edl[name] = tensor
                    continue
                if not self._model:
                    # a gradient against an uninitialized model (a
                    # relaunched master whose store is empty): reject, so
                    # the worker's retry re-pulls and re-pushes its model
                    logger.warning(
                        "rejecting gradient for %s: model not initialized "
                        "(worker re-push expected)",
                        name,
                    )
                    return False, self._version
                raise ValueError(
                    "Gradient key: %s is not part of model" % name
                )
            param = self._model[name]
            if tensor.is_indexed_slices():
                if tensor.values.shape[1] != param.shape[1]:
                    raise ValueError(
                        "Gradient key: %s has incompatible indexed slice "
                        "dimension %d, expected %d"
                        % (name, tensor.values.shape[1], param.shape[1])
                    )
                max_index = int(tensor.indices.max())
                if max_index >= param.shape[0]:
                    raise ValueError(
                        "Gradient key: %s has wrong indices %d, out of "
                        "range %d" % (name, max_index, param.shape[0] - 1)
                    )
                indexed[name] = tensor
            else:
                if tuple(tensor.values.shape) != param.shape:
                    raise ValueError(
                        "Gradient key: %s has incompatible dimension" % name
                    )
                dense[name] = np.asarray(tensor.values, dtype=np.float32)
        with self._lock:
            self._process_gradients(edl, indexed, dense, model_version)
            return True, self._version

    def push_embedding_info(self, embedding_infos):
        """Register elastic embedding tables (existing names win)."""
        self._require_store().init_embedding_params(embedding_infos)

    def pull_embedding_vectors(self, layer_name, ids):
        """Rows of ``ids`` from the store, minted lazily."""
        return self._require_store().get_embedding_param(layer_name, ids)

    def _require_store(self):
        if self._embedding_store is None:
            raise ValueError(
                "this master holds no embedding store (a coordinating "
                "master): elastic embedding layers need the master-held "
                "model"
            )
        return self._embedding_store

    def report_task_result(self, task_id, err_message="", exec_counters=None):
        if (
            self._coordinates_only
            and exec_counters
            and TaskExecCounterKey.MODEL_VERSION in exec_counters
        ):
            reported = int(exec_counters[TaskExecCounterKey.MODEL_VERSION])
            with self._lock:
                advanced = reported > self._version
                self._version = max(self._version, reported)
            if advanced and self._journal is not None:
                self._journal.append("version", version=reported)
            if advanced and self._evaluation_service:
                # task reports are this master's only version clock, so
                # they drive the step trigger (taking the lock: this
                # thread does not hold it)
                self._evaluation_service.add_evaluation_task_if_needed(
                    master_locking=True
                )
        if err_message:
            logger.warning("Worker reported error: " + err_message)
            self._task_d.report(task_id, False, exec_counters=exec_counters)
        else:
            self._task_d.report(task_id, True, exec_counters=exec_counters)

    def report_telemetry(self, snapshot):
        """Low-frequency worker telemetry snapshot
        (docs/observability.md); ignored unless a JobTelemetry
        aggregator is attached."""
        if self.telemetry is not None:
            self.telemetry.ingest(snapshot)

    def report_evaluation_metrics(
        self, model_version, model_outputs, labels, scored_version=None
    ):
        """Returns (accepted, current version). ``scored_version`` is the
        version the worker's params were loaded from where it could not
        score ``model_version`` exactly."""
        accepted = self._evaluation_service.report_evaluation_metrics(
            model_version,
            model_outputs,
            labels,
            scored_version=scored_version,
        )
        return accepted, self._version

    # -- gradient application (the lock held) -------------------------------

    def _process_gradients(self, edl, indexed, dense, request_version):
        if not self._use_async:
            for mine, theirs in (
                (self._edl_embedding_gradients, edl),
                (self._gradient_sum_indexed, indexed),
                (self._gradient_sum, dense),
            ):
                for k, v in theirs.items():
                    mine[k] = mine[k] + v if k in mine else v
            self._grad_n += 1
            if self._grad_n < self._grad_to_wait:
                return
            dense = {
                k: v / self._grad_to_wait
                for k, v in self._gradient_sum.items()
            }
            edl = self._edl_embedding_gradients
            indexed = self._gradient_sum_indexed
        if self._lr_modulation is not None:
            staleness = max(1, self._version - request_version)
            self._lr_modulation.set_multiplier(1.0 / staleness)
        try:
            self._update_model(dense, indexed, edl)
        finally:
            if self._lr_modulation is not None:
                self._lr_modulation.set_multiplier(1.0)
            if not self._use_async:
                self._gradient_sum = {}
                self._gradient_sum_indexed = {}
                self._edl_embedding_gradients = {}
                self._grad_n = 0

    def _densify(self, dense, indexed):
        """The full gradient of every model variable: a missing one is
        zero; indexed slices add into a dense buffer, duplicates
        accumulating (``np.add.at``)."""
        out = {}
        for k, p in self._model.items():
            if k in dense:
                out[k] = dense[k]
            elif k in indexed:
                t = indexed[k]
                g = np.zeros_like(p)
                np.add.at(g, np.asarray(t.indices), np.asarray(t.values))
                out[k] = g
            else:
                out[k] = np.zeros_like(p)
        return out

    def _update_model(self, dense, indexed, edl):
        if edl:
            if self._embedding_gradient_applier is None:
                raise ValueError(
                    "Received elastic-embedding gradients but no embedding "
                    "gradient applier is configured"
                )
            t0 = time.perf_counter()
            self._embedding_gradient_applier.apply_gradients(
                embedding_grads=edl
            )
            self.apply_ms["sparse"].append((time.perf_counter() - t0) * 1e3)
        if (dense or indexed) and self._opt is None:
            raise ValueError(
                "master received dense gradients but holds no optimizer"
            )
        if dense or indexed:
            t0 = time.perf_counter()
            self._apply_dense(self._densify(dense, indexed))
            self.apply_ms["dense"].append((time.perf_counter() - t0) * 1e3)
        self._version += 1
        if self._journal is not None:
            self._journal.append("version", version=self._version)
        self._update_evaluation()
        self._update_checkpoint()

    def _apply_dense(self, grads):
        """One optimizer step over the whole model on the device; the
        model's host arrays are replaced, never written in place."""
        if self._dense_opt is None:
            self._dense_params = {
                k: torch.tensor(v, device=self._device).requires_grad_(True)
                for k, v in self._model.items()
            }
            self._dense_opt = self._opt(list(self._dense_params.values()))
        for k, p in self._dense_params.items():
            p.grad = torch.tensor(grads[k], device=self._device)
        self._dense_opt.step()
        self._model = {
            k: p.detach().to("cpu", copy=True).numpy()
            for k, p in self._dense_params.items()
        }

    # -- version and checkpoints --------------------------------------------

    def get_model_version(self):
        return self._version

    def job_finished(self):
        """True once the dispatcher has nothing left to hand out or to
        finish (``TaskDispatcher.job_done``)."""
        return self._task_d.job_done()

    def restore_version(self, version):
        """Resume a version clock (never moves it back): a relaunched
        master's journaled version."""
        with self._lock:
            self._version = max(self._version, int(version))

    def _get_model_no_lock(self):
        return self._version, {k: v.copy() for k, v in self._model.items()}

    def _validate_model_version(self, request_model_version):
        if request_model_version > self._version:
            err_msg = (
                "Model version %d not available yet, current version: %d"
                % (request_model_version, self._version)
            )
            logger.warning(err_msg)
            raise ValueError(err_msg)
        return request_model_version == self._version

    def _save_checkpoint(self, locking, is_eval_checkpoint):
        logger.info("Saving checkpoint for model version %d", self._version)
        if locking:
            self._lock.acquire()
        try:
            version, named = self._get_model_no_lock()
            named.update(self._export_embedding_tables())
            self._checkpoint_service.save(version, named, is_eval_checkpoint)
            return version
        except Exception:
            logger.exception(
                "Failed to save checkpoint file for model version %d",
                self._version,
            )
            return None
        finally:
            if locking:
                self._lock.release()

    def save_eval_checkpoint(self, locking=True):
        """Write the current model as an evaluation round's checkpoint;
        returns its version (None if the write failed)."""
        return self._save_checkpoint(locking, is_eval_checkpoint=True)

    def _update_evaluation(self):
        if self._evaluation_service:
            self._evaluation_service.add_evaluation_task_if_needed(
                master_locking=False
            )

    def _update_checkpoint(self):
        if (
            self._checkpoint_service
            and self._checkpoint_service.need_to_checkpoint(self._version)
        ):
            self._save_checkpoint(locking=False, is_eval_checkpoint=False)
