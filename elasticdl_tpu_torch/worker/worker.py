"""The parameter-server worker, the port of
``elasticdl_tpu/worker/worker.py``: the task loop of the
ParameterServerStrategy job, on the master-held model or, with a
``ps_client`` (``worker/ps_client.py``), on the PS fleet.

Per minibatch the worker pulls the model from the master (``get_model``),
plans and pulls the rows of its elastic embedding layers, runs forward
and backward on its device, and reports the dense gradients and each
layer's row gradients (indexed slices, one row per unique id) with
``report_gradient``. The master applies them, and may reject a stale
one: the worker then runs the minibatch again, up to
``MAX_MINIBATCH_RETRY_NUM`` (64) times, with a fresh model. With
``get_model_steps`` N > 1 (async jobs) it pulls the model every N
minibatches and in between advances its own copy with its own optimizer
and the dense gradients it just reported (SSP local updates).

The first minibatch creates the variables (the zoo's seeded init) and
runs one capture pass, which records each elastic layer's calls and
declared initializer; the worker then registers the tables
(``push_embedding_info``) before it reports its variables
(``report_variable``, first write wins on the master).

The lookup stays out of the step (``nn/embedding.py``): the capture pass
reads the batch's ids on the host, ``MasterStorePlane`` pulls the unique
rows, they are copied to the card, and the step gathers from them;
autograd gives the rows' gradients, one row per unique id, which are
reported with those ids.

Names cross as the reference's (``common/convert.py``: ``Dense_0/kernel``
and its ``(in, out)`` layout), so the master-held model, its checkpoints
and its exports are the reference's. A model no weight map covers crosses
under its ``state_dict`` names.

Evaluation tasks score the model version their round pinned (``get_model``
FIXED, from the round's eval checkpoint) and report outputs and labels;
prediction tasks hand their outputs to the zoo's processor; the
SAVE_MODEL task exports the master's model with the master's embedding
tables (``export_embedding_tables``) in ``model.chkpt``; a model without
elastic layers also gets the serving member (``common/export.py``),
traced on the worker's device from one prediction-mode batch of the
task's records, as the reference's does. Streaming exports stay
params-only, as the reference's do. Dropout draws
from a seed of ``(seed, worker_id, step)``.

**On the PS fleet** the model lives on the shards: ``get_model`` is the
client's ``pull_dense`` (every shard's partition; a fleet that reports
no model gets the worker's model pushed again first), the variables go
out with ``push_model`` (table infos included), the gradients with
``push_gradient``, and the rows with the client's fan-out
(``PsPlane``). A shard that came back empty after a relaunch gets the
model and infos pushed again (``_on_ps_shard_reset``). The client's push
window is drained at every boundary the reference drains it: an
evaluation task, the end of a round of tasks, a streaming export, the
SAVE_MODEL task and the end of the run. The SAVE_MODEL export holds the
dense model only, as the reference's does under the fleet.

**The hybrid trainer** (``embedding_plane="hybrid"``, on the fleet
only): the dense parameters, an HBM-plane table among them, stay on the
worker, which updates its own copy with its own optimizer on every
accepted minibatch; the fleet serves the PS-plane tables alone. The
worker pushes its model once (the shards keep it, unused) and never
pulls it: ``get_model`` does nothing, so evaluation and the SAVE_MODEL
export score and write the local copy, and the model version advances
from the sparse pushes' replies. With ``embedding_prefetch`` (the
default under hybrid) the next batch's rows are pulled on the
``EmbeddingPullPipeline``'s thread while the current batch computes: the
worker plans the lookahead batch on its own thread and submits only the
fan-out; a failed minibatch and the end of every round drop what is
staged. A round's first batch pulls inline; every later one is staged.
A worker that updates its own copy (under hybrid, or SSP's
``get_model_steps`` > 1) steps its optimizer once on a scratch tensor
before the first task, so torch's lazy loading stays out of the steps.

**On the master-held model**, a master relaunched with a new
``master_epoch`` (``--master_journal_dir``) gets the worker's table
infos and variables pushed again (``_on_master_epoch_change``); until
they land, the master rejects gradients and the worker retries.

**Streaming exports** (``export_dir`` with ``export_every_versions`` N):
once the model version has moved N past the last export, the worker
drains its pushes and writes a params-only artifact under
``<export_dir>/v<version>``, staged in a dot-directory and renamed into
place (the first of two workers wins) with the manifest written last;
``export_keep`` artifacts are kept. The scorer's ``ModelDirectoryWatcher``
serves them.
"""

import contextlib
import os
import time
import traceback

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import (
    MAX_MINIBATCH_RETRY_NUM,
    GetModelMethod,
    JobType,
    MetricsDictKey,
    Mode,
    SaveModelConfig,
    TaskType,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.metrics import to_host
from elasticdl_tpu_torch.nn.comm_plane import (
    EmbeddingPullPipeline,
    MasterStorePlane,
    PsPlane,
    plan_lookup_multi,
)
from elasticdl_tpu_torch.nn.embedding import (
    capture_embedding_ids,
    embedding_layers,
)
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo
from elasticdl_tpu_torch.training.step import fold_in
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.worker.allreduce_worker import _first_leaf
from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
    _flash_launches,
    _Timeline,
)
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
from elasticdl_tpu_torch.worker.telemetry import WorkerTelemetry


class _StepTimer:
    """One minibatch's split: host seconds of each phase, the device
    milliseconds of the compute (CUDA events; absent on the CPU) and
    ``t``, the wall time the step was accepted."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self.split = {}
        self._events = None
        self.pipelined = False  # the rows came from the pipeline

    def add(self, phase, seconds):
        self.split[phase] = self.split.get(phase, 0.0) + seconds

    def start_compute(self):
        if self._cuda:
            self._events = (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
            )
            self._events[0].record()

    def end_compute(self):
        if self._events is not None:
            self._events[1].record()

    def finish(self):
        self.split["t"] = time.time()
        if self._events is not None:
            self._events[1].synchronize()
            self.split["compute_device_ms"] = self._events[0].elapsed_time(
                self._events[1]
            )
        return self.split


class Worker:
    def __init__(
        self,
        worker_id,
        job_type,
        minibatch_size,
        model_zoo,
        model_def,
        model_params=None,
        dataset_fn="dataset_fn",
        loss="loss",
        optimizer="optimizer",
        eval_metrics_fn="eval_metrics_fn",
        prediction_outputs_processor="PredictionOutputsProcessor",
        stub=None,
        get_model_steps=1,
        data_reader_params=None,
        seed=0,
        precision=None,
        task_prefetch=1,
        task_ack_queue=8,
        loss_log_steps=20,
        device="cuda",
        ps_client=None,
        export_dir=None,
        export_every_versions=0,
        export_keep=4,
        embedding_plane="ps",
        embedding_prefetch=None,
        telemetry_report_secs=5.0,
    ):
        from elasticdl_tpu_torch.common.device import resolve_device

        # "ps": the parameter-server trainer (the dense model round-trips
        # through get_model and the gradient report); "hybrid": the dense
        # model stays on this worker and the fleet serves only the
        # PS-plane tables
        if embedding_plane not in ("ps", "hybrid"):
            raise ValueError(
                "embedding_plane must be 'ps' or 'hybrid', got %r"
                % (embedding_plane,)
            )
        self._dense_local = embedding_plane == "hybrid"
        if self._dense_local and ps_client is None:
            raise ValueError(
                "embedding_plane='hybrid' needs a ps_client: the PS "
                "fleet serves the sparse tables while dense stays local"
            )
        if self._dense_local and job_type in (
            JobType.EVALUATION_ONLY,
            JobType.PREDICTION_ONLY,
        ):
            # the local copy is made by training (get_model does
            # nothing): a scoring-only job would score the random init
            raise ValueError(
                "embedding_plane='hybrid' only supports training job "
                "types: %s has no training loop to populate the local "
                "dense replica" % job_type
            )

        self._worker_id = worker_id
        self._job_type = job_type
        self._minibatch_size = minibatch_size
        self._stub = stub
        self._ps_client = ps_client
        self._get_model_steps = max(1, int(get_model_steps))
        self._seed = seed
        self._loss_log_steps = max(0, int(loss_log_steps))
        self._device = resolve_device(device)
        self._sparse_plane = (
            PsPlane(ps_client)
            if ps_client is not None
            else MasterStorePlane(lambda: self._stub)
        )
        if stub is not None and hasattr(stub, "set_on_master_epoch_change"):
            stub.set_on_master_epoch_change(self._on_master_epoch_change)
        if ps_client is not None:
            # a hybrid worker never pulls the model, so a shard that came
            # back empty learns it (and the table infos) only from here
            ps_client.set_on_shard_reset(self._on_ps_shard_reset)
        if embedding_prefetch is None:
            embedding_prefetch = self._dense_local
        self._emb_pipeline = (
            EmbeddingPullPipeline()
            if embedding_prefetch and ps_client is not None
            else None
        )
        # dense tensors sent with gradients (0 under hybrid), and the
        # rounds of the task stream that held a batch
        self.dense_tensors_pushed = 0
        self.rounds = 0
        self._export_dir = export_dir or None
        self._export_every = max(0, int(export_every_versions))
        self._export_keep = max(1, int(export_keep))
        self._last_export_version = -1
        # (version, seconds) of each streaming export written
        self.exports = []
        spec = get_model_spec(
            model_zoo=model_zoo,
            model_def=model_def,
            model_params=model_params,
            dataset_fn=dataset_fn,
            loss=loss,
            optimizer=optimizer,
            eval_metrics_fn=eval_metrics_fn,
            prediction_outputs_processor=prediction_outputs_processor,
        )
        self._model = spec.model.to(self._device)
        self._dataset_fn = spec.dataset_fn
        self._loss = spec.loss
        self._opt_fn = spec.optimizer()
        self._prediction_outputs_processor = spec.prediction_outputs_processor
        from elasticdl_tpu_torch.common.export import export_provenance

        self._export_meta = export_provenance(
            model_zoo, model_def, model_params
        )
        from elasticdl_tpu_torch.training.step import (
            make_embedding_forward_fn,
            make_embedding_grad_fn,
            make_forward_fn,
            make_grad_fn,
        )

        self._grad_fn = make_grad_fn(self._model, self._loss, precision)
        self._forward_fn = make_forward_fn(self._model)
        self._emb_grad_fn = make_embedding_grad_fn(
            self._model, self._loss, precision
        )
        self._emb_forward_fn = make_embedding_forward_fn(self._model)

        self._params = None  # {state_dict key: tensor on the device}
        self._state = {}
        self._named_layout = None  # cross under the reference's names?
        self._model_version = -1
        self._var_created = False
        self._step_count = 0
        self._accepted_steps = 0
        # elastic embedding layers, learned at variable creation
        self._embedding_dims = {}  # {path: dim}
        self._embedding_initializers = {}  # {path: initializer name}
        self._embedding_num_calls = 0
        # SSP local updates: the worker's own optimizer and the last
        # accepted dense gradients
        self._local_opt = None
        self._non_embed_grads = None
        self._evaluation_result = {}
        self.losses = []
        # per accepted minibatch: {phase: host seconds, compute_device_ms}
        self.step_splits = []
        self._timer = None
        # JSON lines under EDL_WORKER_TIMELINE_DIR: start, each accepted
        # step with its split, each failed minibatch, each re-push, and
        # the end with the input plane's counters, the card's peak and
        # the hot-row cache's counters;
        # start, step and end carry the process's flash launches so far
        self._timeline = _Timeline(worker_id)
        self._task_data_service = TaskDataService(
            self,
            self._job_type == JobType.TRAINING_WITH_EVALUATION,
            data_reader_params=data_reader_params,
            task_prefetch=task_prefetch,
            ack_queue_size=task_ack_queue,
        )
        # job telemetry: per-batch rate accounting and low-frequency
        # snapshots shipped behind task reports (docs/observability.md)
        self._telemetry = WorkerTelemetry(
            worker_id,
            stats=self._task_data_service.stats,
            interval_s=telemetry_report_secs,
            ps_client=ps_client,
        )

    # -- the master's surface -----------------------------------------------

    @property
    def input_stats(self):
        return self._task_data_service.stats

    def get_task(self, task_type=None):
        return self._stub.get_task(self._worker_id, task_type)

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        result = self._stub.report_task_result(
            task_id, err_msg, exec_counters
        )
        # the piggyback point: a task ack already cost a master round
        # trip, so the (rate-limited) telemetry snapshot rides here
        self._telemetry.ship(self._stub)
        return result

    @contextlib.contextmanager
    def _timed(self, phase):
        """Charge the block's host seconds to ``phase`` of the running
        training step's split (none outside one); ``compute`` also
        brackets the block with CUDA events."""
        timer = self._timer
        if timer is None:
            yield
            return
        t0 = time.perf_counter()
        if phase == "compute":
            timer.start_compute()
        try:
            yield
        finally:
            if phase == "compute":
                timer.end_compute()
            timer.add(phase, time.perf_counter() - t0)

    def _to_wire(self, tensors, keep_device=False):
        """{state_dict key: tensor} -> {wire name: float32 ndarray}; with
        ``keep_device``, {wire name: float32 tensor where it was}: a PS
        push's frame write is then its one copy to the host."""
        from elasticdl_tpu_torch.common.convert import to_named

        if self._named_layout is None:
            try:
                to_named(tensors, *self._head_layout())
                self._named_layout = True
            except KeyError:
                self._named_layout = False
        if self._named_layout:
            tensors = to_named(
                tensors, *self._head_layout(), keep_device=keep_device
            )
        if keep_device:
            return {
                k: v.detach().to(torch.float32) for k, v in tensors.items()
            }
        return {
            k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in tensors.items()
        }

    def _from_wire(self, named):
        """{wire name: array} -> {state_dict key: CPU tensor}."""
        from elasticdl_tpu_torch.common.convert import to_state_dict

        if self._named_layout:
            return to_state_dict(named)
        return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}

    def _head_layout(self):
        return (
            getattr(self._model, "num_heads", None),
            getattr(self._model, "head_dim", None),
        )

    def get_model(self, version, method=GetModelMethod.MINIMUM):
        """Pull the master's model (MINIMUM: the current one; FIXED: that
        version), or on the fleet every shard's newest, into the worker's
        parameters. Under hybrid the worker's copy is the model: nothing
        is pulled."""
        if self._dense_local:
            return
        with profiling.span("step/pull_model"), self._timed("get_model"):
            if self._ps_client is not None:
                got_version, named = self._pull_dense()
            else:
                got_version, named = self._stub.get_model(version, method)
            if not named:
                return
            host = self._from_wire(named)
            if set(host) != set(self._params):
                raise ValueError(
                    "master model parameters do not match local structure"
                )
            with torch.no_grad():
                for k, v in host.items():
                    self._params[k].copy_(v)
            self._model_version = got_version

    def _pull_dense(self):
        """The fleet's model; a fleet that reports none (a shard came
        back empty) gets this worker's model first."""
        ready, version, named = self._ps_client.pull_dense()
        if not ready and self._params is not None:
            self.report_variable()
            ready, version, named = self._ps_client.pull_dense()
        return (version, named) if ready else (-1, {})

    def _on_ps_shard_reset(self, shards):
        """The client's hook: shards came back with no model. It runs on
        the worker thread only (the pull pipeline's thread leaves it
        pending), so the pushed model is never one torn by a local
        update."""
        if self._var_created and self._params is not None:
            logger.warning(
                "re-pushing the model and table infos after PS shard(s) "
                "%s relaunched without a snapshot", shards,
            )
            self.report_variable()
            self._timeline("repush", shards=list(shards))

    def _on_master_epoch_change(self, old_epoch, new_epoch):
        """The master channel's hook: a relaunched master is serving. On
        the master-held model its store may be empty, so the infos and
        variables go again (first write wins on the master); a failure
        here surfaces through the next call's retries."""
        if (
            self._ps_client is None
            and self._var_created
            and self._params is not None
        ):
            logger.warning(
                "re-pushing the model after a master relaunch (epoch %s "
                "-> %s)", old_epoch, new_epoch,
            )
            try:
                if self._embedding_dims:
                    self._stub.push_embedding_info(
                        self._embedding_table_infos()
                    )
                self.report_variable()
                self._timeline("repush", master_epoch=new_epoch)
            except Exception:  # noqa: BLE001 - the retries surface it
                logger.warning(
                    "model re-push after a master relaunch failed",
                    exc_info=True,
                )

    def _drain_ps_pushes(self):
        """Settle the fleet's push window. A shard failure here lost an
        already-reported gradient: logged, as a stale rejection is, and
        the next minibatch's pull meets the shard in the retry loop."""
        if self._ps_client is None:
            return
        try:
            with profiling.span("task/push_drain"):
                accepted, _ = self._sparse_plane.drain()
        except RuntimeError as err:
            logger.warning(
                "the gradient push window drained with a shard failure; "
                "its updates were dropped: %s", err,
            )
            return
        if not accepted:
            logger.warning(
                "the gradient push window drained with rejected pushes; "
                "those updates were dropped"
            )

    def _embedding_table_infos(self):
        return [
            EmbeddingTableInfo(
                path, dim, self._embedding_initializers.get(path, "uniform")
            )
            for path, dim in self._embedding_dims.items()
        ]

    def report_variable(self):
        # PS pushes keep the tensors on the card (the frame write is
        # their one copy out); the master stub takes host arrays, which
        # an in-process master keeps
        named = self._to_wire(
            self._params, keep_device=self._ps_client is not None
        )
        if self._ps_client is not None:
            self._ps_client.push_model(named, self._embedding_table_infos())
        else:
            self._stub.report_variable(named)

    def report_gradient(self, grads, sparse_tensors=None):
        named = self._to_wire(grads, keep_device=self._ps_client is not None)
        self.dense_tensors_pushed += len(named)
        if self._ps_client is not None:
            return self._ps_client.push_gradient(
                named, sparse_tensors, self._model_version
            )
        tensors = [Tensor(n, v) for n, v in named.items()]
        tensors.extend(sparse_tensors or ())
        return self._stub.report_gradient(tensors, self._model_version)

    def report_evaluation_metrics(self, model_outputs, labels):
        outputs = {
            name: np.concatenate(chunks) for name, chunks in model_outputs.items()
        }
        return self._stub.report_evaluation_metrics(
            self._model_version, outputs, np.concatenate(labels)
        )

    def report_prediction_outputs(self, predictions):
        if self._prediction_outputs_processor:
            from elasticdl_tpu_torch.data.dataset import tree_map

            self._prediction_outputs_processor.process(
                tree_map(to_host, predictions), self._worker_id
            )
        else:
            logger.warning(
                "prediction_outputs_processor is not defined in the model "
                "definition. Prediction outputs are not processed."
            )
        return True

    # -- variables ------------------------------------------------------------

    def _run_model_call_before_training(self, features):
        """Create the variables and learn the elastic layers (one capture
        pass); register the tables, then report the variables once."""
        if self._params is None:
            from elasticdl_tpu_torch.nn.model_api import (
                init_variables,
                split_variables,
            )

            generator = torch.Generator(device=self._device).manual_seed(
                self._seed
            )
            params, state = split_variables(
                init_variables(self._model, generator, features)
            )
            self._params = {
                k: p.detach().requires_grad_(False) for k, p in params.items()
            }
            self._state = state
            if embedding_layers(self._model):
                layer_info = {}
                captured = capture_embedding_ids(
                    self._model, self._params, self._state, features,
                    layer_info=layer_info,
                )
                self._embedding_dims = {
                    p: int(info[0]) for p, info in layer_info.items()
                }
                self._embedding_initializers = {
                    p: info[1] for p, info in layer_info.items()
                }
                self._embedding_num_calls = sum(
                    len(ids) for ids in captured.values()
                )
        if not self._var_created:
            if self._embedding_dims and self._ps_client is None:
                self._stub.push_embedding_info(self._embedding_table_infos())
            self.report_variable()
            self._var_created = True

    def _apply_local_dense(self, grads):
        """One step of the worker's own optimizer on its copy of the
        model: every accepted minibatch under hybrid, and the SSP local
        updates between pulls."""
        from elasticdl_tpu_torch.training.step import make_local_update_fn

        if self._local_opt is None:
            leaves = {
                k: p.requires_grad_(True) for k, p in self._params.items()
            }
            self._params = leaves
            self._local_opt = self._opt_fn(list(leaves.values()))
            self._local_update = make_local_update_fn()
        with torch.no_grad():
            self._local_update(grads, self._local_opt, self._params)

    def _warm_local_optimizer(self):
        """One zero-gradient step of the model's optimizer on a scratch
        tensor on the device, before the first task: the first local
        update (every step under hybrid, the SSP steps between pulls)
        then does not pay torch's lazy loading inside the job. The model
        is not touched."""
        try:
            scratch = torch.zeros(1, device=self._device, requires_grad=True)
            opt = self._opt_fn([scratch])
            scratch.grad = torch.zeros_like(scratch)
            opt.step()
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        except Exception as err:  # noqa: BLE001 - the first update raises it
            logger.warning("warming the local optimizer failed: %s", err)

    def _update_local_model(self):
        if self._non_embed_grads is None:
            return
        grads, self._non_embed_grads = self._non_embed_grads, None
        self._apply_local_dense(grads)

    # -- the elastic embedding path -------------------------------------------

    def _plan_embedding_lookups(self, features):
        """The capture pass and the unique plan: {path: (unique ids,
        positions per call)}. Runs on the worker thread only (it runs the
        model)."""
        captured = capture_embedding_ids(
            self._model, self._params, self._state, features,
            expected_count=self._embedding_num_calls,
        )
        return {
            path: plan_lookup_multi(ids_list)
            for path, ids_list in captured.items()
        }

    def _pull_embedding_rows(self, lookups, **kwargs):
        """One round for every layer's rows. The pipeline's thread passes
        ``service_reinit=False``: a re-push to a shard that came back
        empty reads the parameters that the worker thread updates in
        place, so it waits for that thread's next call. Until then a pull
        from that shard fails, and so does the batch it was staged for;
        its retry pulls inline."""
        return self._sparse_plane.pull(
            {path: unique for path, (unique, _) in lookups.items()}, **kwargs
        )

    def _kick_embedding_prefetch(self, batch, current):
        """Stage ``batch``'s pull so its fan-out overlaps the step of
        ``current``, the batch about to run: planned here, pulled on the
        pipeline's thread. Before the first step the variables are made
        from ``current`` first, so the second batch is staged too (the
        reference stages from the third); a failure there is left to
        ``current``'s own step, which makes them again. A planning error
        leaves the batch to pull inline."""
        if self._emb_pipeline is None:
            return
        if self._params is None:
            try:
                self._run_model_call_before_training(
                    current[0] if isinstance(current, tuple) else current
                )
            except Exception:  # noqa: BLE001 - the step retries it
                logger.warning(
                    "variable creation before the first step failed; the "
                    "step retries it", exc_info=True,
                )
                return
        if not self._embedding_dims:
            return
        features = batch[0] if isinstance(batch, tuple) else batch
        t0 = time.perf_counter()
        try:
            lookups = self._plan_embedding_lookups(features)
        except Exception:  # noqa: BLE001 - the batch pulls inline
            logger.warning(
                "embedding prefetch planning failed; next batch pulls "
                "inline", exc_info=True,
            )
            return
        plan_s = time.perf_counter() - t0
        self._emb_pipeline.submit(
            features,
            (lookups, plan_s),
            lambda lookups=lookups: self._pull_embedding_rows(
                lookups, service_reinit=False
            ),
        )

    def _prepare_embedding_batch(self, features):
        """Plan the ids and pull the rows: (rows on the device, idx on
        the device, {path: unique ids}). A pull staged for this very batch
        is consumed (the split's ``pull`` is then its tail wait and
        ``pull_bg`` the background pull); otherwise (the first batch, a
        retry after a rejection, a dropped round) it runs inline."""
        with profiling.span("step/embedding_pull") as sp:
            pre = None
            if self._emb_pipeline is not None:
                with self._timed("pull"):
                    pre = self._emb_pipeline.consume(features)
            if pre is not None:
                # the wait here is the tail of the overlapped pull
                sp.add(pipelined=True)
                (lookups, plan_s), pulled = pre
                if self._timer is not None:
                    self._timer.add("plan", plan_s)
                    self._timer.add(
                        "pull_bg", self._emb_pipeline.last_pull_s
                    )
                    self._timer.pipelined = True
            else:
                with self._timed("plan"):
                    lookups = self._plan_embedding_lookups(features)
                with self._timed("pull"):
                    pulled = self._pull_embedding_rows(lookups)
        rows, idx, plan = {}, {}, {}
        for path, (unique, idxs) in lookups.items():
            rows[path] = torch.tensor(pulled[path], device=self._device)
            idx[path] = [
                torch.from_numpy(i.astype(np.int64)).to(self._device)
                for i in idxs
            ]
            plan[path] = unique
        return rows, idx, plan

    @staticmethod
    def _sparse_grad_tensors(row_grads, plan):
        return [
            Tensor(
                path,
                row_grads[path].detach().to("cpu").numpy(),
                indices=unique,
            )
            for path, unique in plan.items()
        ]

    # -- compute ---------------------------------------------------------------

    def training_process(self, features, labels):
        self._step_count += 1
        rng = fold_in(
            self._seed * 100003 + self._worker_id, self._step_count
        )
        # step/compute: the rows' preparation (which nests
        # step/embedding_pull) and forward and backward; the device work
        # that outlives the dispatch lands in step/grad_push, where the
        # gradients leave the card
        with profiling.span("step/compute"):
            if self._embedding_dims:
                rows, idx, plan = self._prepare_embedding_batch(features)
                with self._timed("compute"):
                    loss, grads, row_grads, new_state, _ = (
                        self._emb_grad_fn(
                            self._params, rows, self._state, idx, features,
                            labels, rng,
                        )
                    )
                self._state = new_state
                return (
                    loss, grads, self._sparse_grad_tensors(row_grads, plan)
                )
            with self._timed("compute"):
                loss, grads, new_state, _ = self._grad_fn(
                    self._params, self._state, features, labels, rng
                )
            self._state = new_state
            return loss, grads, None

    def forward_process(self, features):
        if self._embedding_dims:
            rows, idx, _ = self._prepare_embedding_batch(features)
            return self._emb_forward_fn(
                self._params, rows, self._state, idx, features
            )
        return self._forward_fn(self._params, self._state, features)

    def _run_training_task(self, features, labels):
        loss, grads, sparse_grads = self.training_process(features, labels)
        if self._dense_local:
            # hybrid: only the PS-plane tables' row gradients go out; the
            # dense ones update this worker's copy once accepted
            accepted, version = True, -1
            if sparse_grads:
                with profiling.span("step/grad_push", sparse=True), \
                        self._timed("report"):
                    accepted, version = self._sparse_plane.push(
                        sparse_grads, max(self._model_version, 0)
                    )
            if version is not None and version >= 0:
                self._model_version = max(self._model_version, version)
            if accepted:
                with profiling.span("step/local_update"), \
                        self._timed("local_update"):
                    self._apply_local_dense(grads)
            return accepted, self._model_version, loss
        with profiling.span("step/grad_push"), self._timed("report"):
            accepted, min_model_version = self.report_gradient(
                grads, sparse_grads
            )
        if accepted and self._get_model_steps > 1:
            self._non_embed_grads = grads
        return accepted, min_model_version, loss

    def _collect_evaluation_result(self, outputs, labels):
        chunks = self._evaluation_result.setdefault(
            MetricsDictKey.MODEL_OUTPUT, {}
        )
        for k, v in outputs.items():
            chunks.setdefault(k, []).append(to_host(v))
        self._evaluation_result.setdefault(MetricsDictKey.LABEL, []).append(
            to_host(labels)
        )

    def _run_evaluation_task(self, features, labels):
        outputs = self.forward_process(features)
        if not isinstance(outputs, dict):
            outputs = {MetricsDictKey.MODEL_OUTPUT: outputs}
        self._collect_evaluation_result(outputs, labels)
        return True

    def _run_prediction_task(self, features):
        return self.report_prediction_outputs(self.forward_process(features))

    # -- the minibatch state machine -------------------------------------------

    def _process_minibatch(
        self, task_type, features, labels, min_model_version,
        train_with_local_model=False,
    ):
        if not self._var_created or self._params is None:
            # variable creation (the init pass and its report) takes
            # seconds on a cold device; its own span keeps the first
            # step's attribution whole
            with profiling.span("step/var_init"):
                self._run_model_call_before_training(features)
        for _ in range(MAX_MINIBATCH_RETRY_NUM):
            if task_type == TaskType.EVALUATION:
                if min_model_version == -1:
                    if self._model_version < 0:
                        self.get_model(0, GetModelMethod.MINIMUM)
                elif self._model_version != min_model_version:
                    self.get_model(min_model_version, GetModelMethod.FIXED)
                if self._run_evaluation_task(features, labels):
                    break
            elif task_type == TaskType.TRAINING:
                self._timer = _StepTimer(self._device)
                if not train_with_local_model:
                    self.get_model(
                        max(self._model_version, min_model_version),
                        GetModelMethod.MINIMUM,
                    )
                accepted, min_model_version, loss = self._run_training_task(
                    features, labels
                )
                if accepted:
                    self._accepted_steps += 1
                    self.step_splits.append(self._timer.finish())
                    self._timeline(
                        "step", version=min_model_version,
                        split=self.step_splits[-1],
                        pipelined=self._timer.pipelined,
                        launches=_flash_launches(),
                    )
                    self._timer = None
                    self.losses.append(loss)
                    if self._loss_log_steps and (
                        self._accepted_steps % self._loss_log_steps == 1
                        or self._loss_log_steps == 1
                    ):
                        logger.info(
                            "Loss is %f (accepted step %d)",
                            float(loss),
                            self._accepted_steps,
                        )
                    break
            elif task_type == TaskType.PREDICTION:
                if self._model_version != min_model_version:
                    self.get_model(min_model_version, GetModelMethod.FIXED)
                if self._run_prediction_task(features):
                    break
            else:
                raise RuntimeError("Unrecognized task type, %s" % task_type)
        else:
            raise RuntimeError("Worker got stuck")
        self._timer = None
        return min_model_version

    def _process_minibatch_and_report(
        self, dataset_batch, task_type, model_version,
        train_with_local_model=False,
    ):
        err_msg = ""
        try:
            if self._job_type == JobType.PREDICTION_ONLY:
                features, labels = dataset_batch, None
            else:
                features, labels = dataset_batch
            self._process_minibatch(
                task_type, features, labels, model_version,
                train_with_local_model,
            )
        except RuntimeError as err:
            err_msg = str(err)
            traceback.print_exc()
            self._timeline("failed", error=err_msg[:200])
        return err_msg

    @staticmethod
    def _batch_count(dataset_batch):
        leaf = _first_leaf(dataset_batch)
        shape = getattr(leaf, "shape", None)
        return int(shape[0]) if shape is not None else len(leaf)

    # -- evaluation and SAVE_MODEL tasks ----------------------------------------

    def _process_eval_task(self, task):
        logger.info("the evaluation task_id: %d", task.task_id)
        self._drain_ps_pushes()
        self._task_data_service.drain_acks()
        eval_info = self._task_data_service.get_validation_dataset(task)
        if not eval_info:
            return
        eval_dataset, model_version, task_id = eval_info
        eval_dataset = self._dataset_fn(
            eval_dataset,
            Mode.EVALUATION,
            self._task_data_service.data_reader.metadata,
        )
        eval_dataset = eval_dataset.batch(self._minibatch_size).prefetch(1)
        err_msg = ""
        for dataset_batch in eval_dataset:
            data_err_msg = self._process_minibatch_and_report(
                dataset_batch, TaskType.EVALUATION, model_version
            )
            if data_err_msg:
                err_msg = data_err_msg
                break
        if MetricsDictKey.MODEL_OUTPUT in self._evaluation_result:
            accepted, _ = self.report_evaluation_metrics(
                self._evaluation_result[MetricsDictKey.MODEL_OUTPUT],
                self._evaluation_result[MetricsDictKey.LABEL],
            )
            if not accepted:
                raise RuntimeError("Report evaluation metric failed!")
        self.report_task_result(task_id, err_msg)
        self._evaluation_result = {}

    def _process_save_model_task_if_needed(self):
        task, dataset = (
            self._task_data_service.get_save_model_task_and_dataset()
        )
        if task is None or dataset is None:
            return
        self._drain_ps_pushes()
        self._task_data_service.drain_acks()
        saved_model_path = os.path.join(
            task.extended_config.get(SaveModelConfig.SAVED_MODEL_PATH),
            str(int(time.time())),
        )
        logger.info("The path to export model is %s", saved_model_path)
        self.get_model(max(self._model_version, 0), GetModelMethod.MINIMUM)
        from elasticdl_tpu_torch.common.export import (
            example_batch_for_export,
            export_model,
            make_serving_module,
        )

        serving_module = example = None
        if not self._embedding_dims:
            # an elastic layer's rows are pulled per batch, outside the
            # graph: only a dense model ships the serving member, traced
            # from the pulled parameters on this worker's device
            example = example_batch_for_export(
                dataset,
                self._dataset_fn,
                self._task_data_service.data_reader.metadata,
                self._minibatch_size,
                Mode.PREDICTION,
            )
            serving_module = make_serving_module(
                self._model, self._params, self._state
            )
        # the master-held tables are not model parameters: get_model
        # leaves them out, so the export pulls them from the master (the
        # fleet's tables stay on the shards, as in the reference)
        extra_named = (
            self._stub.export_embedding_tables()
            if self._embedding_dims and self._ps_client is None
            else None
        )
        export_model(
            saved_model_path,
            self._to_wire(self._params),
            self._model_version,
            metadata=self._export_meta,
            extra_named=extra_named,
            serving_module=serving_module,
            example_features=example,
        )
        self.report_task_result(task_id=task.task_id, err_msg="")

    def _maybe_streaming_export(self):
        """Write a params-only artifact once the version has moved
        ``export_every_versions`` past the last one. A failure is logged
        and the cadence moves on (a full disk must not retry on every
        minibatch)."""
        if (
            not self._export_every
            or self._export_dir is None
            or self._params is None
            or self._model_version < 0
            or self._model_version
            < self._last_export_version + self._export_every
        ):
            return
        version = self._model_version
        t0 = time.perf_counter()
        try:
            with profiling.span("step/export", version=version):
                self._streaming_export(version)
            self.exports.append((version, time.perf_counter() - t0))
        except Exception:  # noqa: BLE001 - the next cadence point retries
            logger.warning(
                "streaming export of v%d failed; retrying at the next "
                "cadence point", version, exc_info=True,
            )
        self._last_export_version = version

    def _streaming_export(self, version):
        """Stage ``version``'s params-only artifact and rename it into
        place (another worker's rename of the same version wins)."""
        import shutil

        from elasticdl_tpu_torch.common.export import export_model

        self._drain_ps_pushes()
        final = os.path.join(self._export_dir, "v%010d" % version)
        staging = os.path.join(
            self._export_dir,
            ".staging-v%010d-w%s" % (version, self._worker_id),
        )
        export_model(
            staging, self._to_wire(self._params), version,
            metadata=self._export_meta,
        )
        try:
            os.rename(staging, final)
        except OSError:
            # another worker exported this version first
            shutil.rmtree(staging, ignore_errors=True)
        self._prune_exports()

    def _prune_exports(self):
        """Drop the oldest complete artifacts beyond ``export_keep``, and
        staging directories older than the oldest kept (a dead
        writer's)."""
        import shutil

        versions = sorted(
            d for d in os.listdir(self._export_dir)
            if d.startswith("v") and os.path.exists(
                os.path.join(self._export_dir, d, "MANIFEST.json"))
        )
        for stale in versions[: -self._export_keep]:
            shutil.rmtree(os.path.join(self._export_dir, stale),
                          ignore_errors=True)
        if versions:
            floor = versions[-self._export_keep:][0]
            for entry in os.listdir(self._export_dir):
                if entry.startswith(".staging-") and (
                    entry.split("-")[1] < floor
                ):
                    shutil.rmtree(os.path.join(self._export_dir, entry),
                                  ignore_errors=True)

    # -- the loops ---------------------------------------------------------------

    def _train_and_evaluate(self):
        train_with_local_model = False
        local_update_count = self._get_model_steps
        last_training_minibatch_failed = False
        evaluation_task_executed = False
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                break
            dataset = self._dataset_fn(
                dataset,
                Mode.TRAINING,
                self._task_data_service.data_reader.metadata,
            )
            dataset = dataset.batch(self._minibatch_size).prefetch(1)
            if self._var_created and not self._embedding_dims:
                # dense models: the next batch's copy to the card overlaps
                # this step; the elastic path reads its ids on the host
                dataset = dataset.device_prefetch(self._device)
            batches_seen = 0
            for dataset_batch, next_batch in self._lookahead_pairs(dataset):
                batches_seen += 1
                if next_batch is not None:
                    # the next batch's rows are pulled while this one
                    # computes
                    self._kick_embedding_prefetch(next_batch, dataset_batch)
                if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                    if self._evaluate_only():
                        evaluation_task_executed = True
                task = self._task_data_service.get_current_task()
                if (
                    evaluation_task_executed
                    or last_training_minibatch_failed
                    or local_update_count >= self._get_model_steps
                ):
                    local_update_count = 0
                    train_with_local_model = False
                else:
                    train_with_local_model = True
                batch_count = self._batch_count(dataset_batch)
                # the dispatcher's task trace id roots the per-minibatch
                # "step" span that tools/tracetool.py decomposes; its
                # children (pull_model, compute, grad_push, ...) inherit
                # trace and parent from the thread's span stack
                trace_id = (task.extended_config or {}).get(
                    "trace_id", "untraced"
                )
                with profiling.annotate(
                    "edl/task/%s/train" % trace_id
                ), profiling.span(
                    "step",
                    trace_id=trace_id,
                    task=getattr(task, "task_id", None),
                    examples=batch_count,
                ):
                    err_msg = self._process_minibatch_and_report(
                        dataset_batch,
                        task.type,
                        task.model_version,
                        train_with_local_model,
                    )
                self._telemetry.on_batch(batch_count)
                self._maybe_streaming_export()
                local_update_count += 1
                if err_msg:
                    last_training_minibatch_failed = True
                    if self._emb_pipeline is not None:
                        # the task requeues: what is staged for it is
                        # dropped once; whoever reruns it pulls afresh
                        self._emb_pipeline.invalidate()
                else:
                    last_training_minibatch_failed = False
                    if local_update_count < self._get_model_steps:
                        self._update_local_model()
                self._task_data_service.report_record_done(
                    batch_count, err_msg
                )
            del dataset
            self.rounds += batches_seen > 0
            if self._emb_pipeline is not None:
                # a pull staged past the stream's end has no batch
                self._emb_pipeline.invalidate()
            self._drain_ps_pushes()
            self._task_data_service.drain_acks()
            if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                evaluation_task_executed = self._evaluate_only()
            self._process_save_model_task_if_needed()
            if batches_seen == 0:
                time.sleep(0.2)

    @staticmethod
    def _lookahead_pairs(iterable):
        """``(batch, next batch)`` with a lookahead of one; the next batch
        is None on the last. The dataset already runs a batch ahead
        (``prefetch(1)``), and the task ledger moves on
        ``report_record_done``, not on iteration."""
        it = iter(iterable)
        try:
            cur = next(it)
        except StopIteration:
            return
        for nxt in it:
            yield cur, nxt
            cur = nxt
        yield cur, None

    def _evaluate_only(self):
        executed = False
        while True:
            task = self.get_task(TaskType.EVALUATION)
            if not task.shard_name:
                break
            self._process_eval_task(task)
            executed = True
        return executed

    def _predict_only(self):
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                break
            dataset = self._dataset_fn(
                dataset,
                Mode.PREDICTION,
                self._task_data_service.data_reader.metadata,
            )
            dataset = dataset.batch(self._minibatch_size).prefetch(1)
            for dataset_batch in dataset:
                task = self._task_data_service.get_current_task()
                batch_count = self._batch_count(dataset_batch)
                err_msg = self._process_minibatch_and_report(
                    dataset_batch, task.type, task.model_version
                )
                self._telemetry.on_batch(batch_count)
                self._task_data_service.report_record_done(
                    batch_count, err_msg
                )
            del dataset
            self._task_data_service.drain_acks()

    def run(self):
        """Fetch tasks from the master and train, evaluate or predict;
        returns the accepted minibatches' losses."""
        if self._job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        ) and (self._dense_local or self._get_model_steps > 1):
            self._warm_local_optimizer()
        self._timeline("start", launches=_flash_launches())
        try:
            if self._job_type == JobType.PREDICTION_ONLY:
                self._predict_only()
            elif self._job_type == JobType.EVALUATION_ONLY:
                self._evaluate_only()
            else:
                self._train_and_evaluate()
        finally:
            # the pipeline's thread must not outlive the run
            if self._emb_pipeline is not None:
                self._emb_pipeline.close()
        self._drain_ps_pushes()
        self._task_data_service.drain_acks()
        # the final flush: a short job still lands one snapshot
        self._telemetry.ship(self._stub, force=True)
        losses = [float(loss) for loss in self.losses]
        if self._timeline.enabled:
            self._timeline(
                "end", input_stats=self.input_stats.snapshot(),
                peak_mib=(
                    torch.cuda.max_memory_allocated(self._device) / 2**20
                    if self._device.type == "cuda"
                    else None
                ),
                losses_first_last=losses[:1] + losses[-1:],
                losses_finite=bool(np.all(np.isfinite(losses))),
                launches=_flash_launches(),
                hot_row_cache=self._cache_stats(),
                pipeline=self._pipeline_stats(),
                dense_tensors_pushed=self.dense_tensors_pushed,
                rounds=self.rounds,
                wire=self.wire_stats(),
            )
        return losses

    def wire_stats(self):
        """Each shared-memory channel's ``state`` and counts (``shm``,
        ``inline``, ``quarantined``): ``ps<i>`` per shard, ``master`` for
        ``get_model``; None where no channel was asked for."""
        from elasticdl_tpu_torch.rpc.shm_transport import ShmChannel

        named = [("master", self._stub)] + [
            ("ps%d" % i, stub) for i, stub in enumerate(
                getattr(self._ps_client, "stubs", None) or ())
        ]
        out = {}
        for name, stub in named:
            chan = getattr(stub, "shm_channel", None)
            if isinstance(chan, ShmChannel):
                out[name] = dict(chan.stats, state=chan.state)
        return out or None

    def _pipeline_stats(self):
        """The pull pipeline's counters, or None without one."""
        pipe = self._emb_pipeline
        if pipe is None:
            return None
        return {"served": pipe.served, "dropped": pipe.dropped,
                "pull_s": pipe.pull_s}

    def _cache_stats(self):
        """The PS client's hot-row cache counters, or None without one."""
        cache = getattr(self._ps_client, "hot_row_cache", None)
        if cache is None:
            return None
        return {"hits": cache.hits, "misses": cache.misses,
                "rows": len(cache), "tables": cache.table_stats()}
