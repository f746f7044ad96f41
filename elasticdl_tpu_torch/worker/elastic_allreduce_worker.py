"""The elastic multi-process ALLREDUCE worker, the counterpart of
``elasticdl_tpu/worker/elastic_allreduce_worker.py``: one worker process
of a job that survives workers joining and leaving mid-epoch.

**Training.** Each process pulls its own tasks from the master, exactly
as a single-process worker does, but trains through the weighted
lockstep step of ``parallel/elastic.py`` in a process world that the
master's membership re-forms at every change. With ``task_prefetch``
(the worker process passes ``--task_prefetch``, 1 by default) a
background fetcher keeps that many tasks fetched ahead of the one being
consumed; a fetched task that is never consumed goes back to the master
when its round ends, and a dead worker's with the dispatcher's recovery::

    prime (the first local batch in hand; its shapes gate membership)
    loop:
        await the world (the master's get_comm_world)
        establish (join, adopt rank 0's state by broadcast)
        step until: every member's task stream ended | an epoch bump |
        a broken collective
    finalize (land the checkpoints, export if the SAVE_MODEL task came)

The world ends at one step for every member: each step also carries
whether this member's task stream is still open (a WAIT from the master
keeps it open), so a member whose stream ended steps on with no data
until its peers' streams end too. The reference ends each member on its
own stream; its first member to end then breaks its peers' next
collective, and they finish in a world of one.

Every step polls the membership (``awaiting=False``) and hands the
polled epoch to the step, whose MAX over the members tells every rank at
the same step that the world is moving on; all ranks then leave at that
step and re-form. A peer's death instead breaks the step's collective:
the worker fail-reports the unapplied batch, leaves, waits for the
master's epoch bump, and re-forms; the state it keeps is the pre-step
one. Rank 0 writes the checkpoints, asynchronously, every
``checkpoint_steps`` versions. A SIGTERM (a preemption notice) drains:
the worker announces its leave, steps on until the world pauses, lands
its checkpoint writes and exits with ``PREEMPTED_EXIT_CODE``, which the
instance manager answers with a replacement.

**A master restart.** Every call to the master rides out an outage in
the failover channel (``MasterClient``): the per-step membership poll
blocks there while the master is away. Once a relaunched master answers
(its ``master_epoch`` changed), the world the worker is in was formed by
a membership the new master does not hold, so the step's epoch hint is
raised past the world's epoch: every rank pauses at the same step,
leaves, and the workers re-register with the new master, each naming the
size and epoch of the world it left, and form a new world past that
epoch. The trained state carries over; the acks of tasks
the dead master dispatched resolve by their trace ids.

**Evaluation in a training job.** In a ``training_with_evaluation`` job
each worker drains the queued evaluation tasks between its steps
(``_evaluate_only``) and once more in ``_finalize``. It scores each task
with the inference forward (BatchNorm on its running statistics) over a
snapshot of its replicated train state, taken at the version the
round pins where it can and cached per version, and reports the version
it scored (``scored_version``). Its peers wait for it in their next
step's all-reduce, as the reference's replicated plane does.

**Scoring.** Evaluation-only and prediction-only jobs train nothing, so
they need no collective, no membership and no trainer state: their tasks
drain against an inference forward (BatchNorm on running statistics)
over parameters loaded once from a saved model:

- the newest restorable sharded checkpoint under ``--checkpoint_dir``
  (``ckpt_v{N}``, a torn newest directory falling through to older
  ones), params and BatchNorm statistics both; or else
- ``--checkpoint_filename_for_init``: a ``.chkpt`` file or an export
  directory, in either package's naming (``common/convert.py`` maps the
  reference's parameter paths). The drain reads an artifact's
  ``model.chkpt``, which carries no BatchNorm statistics in either
  package (only the serving members do), so it scores with fresh ones,
  as the reference does.

Evaluation-only (``_run_eval_only``) drains the evaluation queue, each
task's outputs reported to the master's single round with the version
the params came from, until three rounds in a row find nothing; a task
still queued then means every attempt deferred (no scoreable params),
and the worker gives up with an error. Prediction-only
(``_run_predict_only``) streams the prediction tasks like training does,
retries a failed forward up to three times, and hands each batch's
outputs (host numpy, bf16 widened to float32) to the zoo's
``PredictionOutputsProcessor`` once; its failure fail-reports the task.

With ``EDL_WORKER_TIMELINE_DIR`` set, each worker appends its events to
``<dir>/worker-<id>.jsonl`` (one JSON object a line, host wall clock in
``t``): ``start``, each ``established`` world (with the state's digest
after the broadcast), each ``step`` (its ``host_step``, and in
``split`` the trainer's compute, all-reduce and rest seconds of the step
before it), each ``checkpoint`` (the snapshot's stall on the step path and
the digest of the state saved), ``checkpoint_writes`` (the background
writes' seconds), ``world_broken``, ``export`` (the SAVE_MODEL export's
seconds, and whether it wrote the serving member) and ``final`` (the
final state's digest, the process's flash-attention launches and the
tasks its fetcher fetched ahead, and on a card its peak memory). The
digests are ``parallel/elastic.state_digest`` (on the sharded plane, of
this rank's parts). A promoted standby's timeline also has a ``standby``
event, a parked spare's a ``spare`` event, a sharded step's event its
host ``staging`` (bytes and seconds of the exchanges staged through the
host, in all and by kind) and, on a card, the process's peak memory so
far (``peak_mib``), a collective-plane step's its ``routing`` (ids its
lookups routed against their occurrences), a sharded ``established``
event the bytes of this rank's split parameters (``split_bytes``), the
``final`` event the tables' overflow count (``overflow``), and a
training job's, one ``eval`` event per scored task.

A zoo with sharded parameters (``build_distributed_model``) is scored as
the reference scores it: through its host twin (``build_host_model``,
whole tables and plain gathers) against ``--checkpoint_dir``, the only
source the twin takes (without it the job raises ``ValueError``), or,
without a twin, through the degenerate ``build_distributed_model(
mesh=None)``. Both are built from the job's ``--model_params``.

A training job takes the reference's route by its probes of
``param_shardings`` (``mesh=None``: does this configuration split
anything, and over ``model``?), not by which hooks the zoo defines: a
configuration that splits nothing trains the plain module replicated
(the LM without ``tensor_parallel``, a zoo whose ``mesh_axes`` alone
names a layout).

**The pjit dense plane.** A configuration that splits the dense model
over ``model`` (the LM's ``tensor_parallel`` or ``min_tensor_parallel``)
trains sharded: the trainer gets the zoo's ``build_distributed_model``
and ``param_shardings`` as its builder, ``mesh_axes`` as the layout
fallback and a ``LayoutPlanner`` (``parallel/layout_solver.py``) that
picks each world's ``data x model`` layout. The master rounds every
world down to a multiple of the ``model`` axis; a worker left out is a
**spare**: it hands every task it fetched (prefetched ones included)
back to the master once, parks until a death promotes it (then primes
a fresh batch), and exits once the master says the job has finished.
Every rank writes its parts of each checkpoint (at the cadence, at
every pause, at the end), and every establish restores the newest
checkpoint all ranks can read (``restore_provider``). Evaluation is
in-plane (``_collective_evaluate``): at each step the ranks agree on
how many hold an evaluation task, and every rank takes part in every
tensor-parallel forward, feeding its last rows when it has none. The
SAVE_MODEL export is assembled whole from the final checkpoint and its
serving member traced from the whole model. A TP job needs
``--replica_refresh_steps 0``: the replica plane covers only leading-dim
splits, as the reference's.

**The collective plane.** A configuration that splits parameters
without a ``model`` axis, from a zoo with ``build_collective_model``
(deepfm_edl's vocabulary-split HBM tables), trains sharded the same way,
with the collective model as the builder (``_collective_hooks``: built
once on the meta device at construction, so an unsupported
configuration fails there), the zoo's ``mesh_axes`` where it has one,
and no layout planner. Each establish tells the checkpoint manager the
rows this world pads (``logical_dim0_by_path``), so host loads clip the
padding off. Every step reads the tables' overflow counts
(``_alarm_on_embedding_overflow``), and a step's timeline event carries
its ``routing`` (ids routed against their occurrences). Rounds are
scored in-plane; the SAVE_MODEL export is assembled from the final
checkpoint with the padding clipped and its member traced from the
host twin (``build_host_model``), which also scores a padded checkpoint
in a scoring job. Until the replica plane is ported (ROADMAP A2) such a
job needs ``--replica_refresh_steps 0`` and recovers from its per-rank
checkpoints. Refused at construction, with the reference's messages: an
``embedding_plane`` that puts a table on the PS plane
(``_refuse_ps_plane_tables``), and a zoo with sharded specs but no
``build_collective_model``.

Not ported, raising ``NotImplementedError``: a configuration that splits
parameters over a ``pipe`` axis (the LM's ``pipeline_stages``, ROADMAP
A9.3). A tensor-parallel checkpoint is scored whole on one device in a
scoring job: ``load_sharded_to_host`` assembles its parts.
"""

import json
import os
import socket
import sys
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.constants import (
    JobType,
    MetricsDictKey,
    Mode,
    SaveModelConfig,
    TaskType,
)
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    load_zoo_module,
)
from elasticdl_tpu_torch.data.dataset import tree_map
from elasticdl_tpu_torch.metrics import to_host
from elasticdl_tpu_torch.parallel import distributed
from elasticdl_tpu_torch.parallel.distributed import WorldBroken, WorldSpec
from elasticdl_tpu_torch.training.step import TrainState
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.worker.allreduce_worker import _first_leaf
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
from elasticdl_tpu_torch.worker.telemetry import WorkerTelemetry

_ATTEMPTS = 3  # drained rounds before the eval-only drain ends; forward
# attempts per prediction batch


def _flash_launches():
    """This process's flash-attention kernel launches, by kernel (none
    where the model never imported the kernels)."""
    fa = sys.modules.get("elasticdl_tpu_torch.ops.flash_attention")
    counters = {
        "flash_fwd": "launches",
        "flash_bwd_dq": "bwd_dq_launches",
        "flash_bwd_dkv": "bwd_dkv_launches",
    }
    return {
        name: getattr(fa, attr).count if fa is not None else 0
        for name, attr in counters.items()
    }


class _Timeline:
    """JSON lines of a worker's events under ``EDL_WORKER_TIMELINE_DIR``
    (off when unset); safe from any thread."""

    def __init__(self, worker_id):
        root = os.environ.get("EDL_WORKER_TIMELINE_DIR", "")
        self._path = (
            os.path.join(root, "worker-%d.jsonl" % worker_id) if root else None
        )
        self._worker_id = worker_id
        self._lock = threading.Lock()
        if self._path:
            os.makedirs(root, exist_ok=True)

    @property
    def enabled(self):
        return self._path is not None

    def __call__(self, event, **fields):
        if self._path is None:
            return
        line = json.dumps(
            dict(event=event, worker=self._worker_id, t=time.time(),
                 **fields)
        )
        with self._lock, open(self._path, "a") as f:
            f.write(line + "\n")


class ElasticAllReduceWorker:
    # distinct from 0 ("done, do not replace me") and from crash codes:
    # the instance manager relaunches a replacement for this exit
    PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL

    @staticmethod
    def _probe_specs(zoo_module, model_params):
        """The zoo's ``param_shardings(None, ...)`` (the reference's
        probe: answered from the params alone), or None when it has
        none."""
        from elasticdl_tpu_torch.common.model_utils import (
            get_dict_from_params_str,
        )

        ps = getattr(zoo_module, "param_shardings", None)
        if ps is None:
            return None
        return ps(None, **(get_dict_from_params_str(model_params) or {}))

    @classmethod
    def _zoo_wants_sharded_params(cls, zoo_module, model_params):
        """Does this configuration split parameters? A zoo with
        ``build_distributed_model`` and no ``param_shardings`` is taken
        to (the reference's conservative answer)."""
        if not hasattr(zoo_module, "param_shardings"):
            return hasattr(zoo_module, "build_distributed_model")
        return bool(cls._probe_specs(zoo_module, model_params))

    @classmethod
    def _zoo_wants_pjit_dense(cls, zoo_module, model_params):
        """Does this configuration split the dense model over the
        ``model`` axis (the reference's pjit dense plane)?"""
        from elasticdl_tpu_torch.parallel.mesh import flatten_specs, spec_axes

        specs = cls._probe_specs(zoo_module, model_params) or {}
        return any(
            "model" in spec_axes(spec)
            for spec in flatten_specs(specs).values()
        )

    @classmethod
    def _refuse_sharded_training(cls, zoo_module, model_def, model_params,
                                 job_type):
        """Raise for a training configuration the sharded planes cannot
        take: parameters split over a ``pipe`` axis (the LM's
        ``pipeline_stages``, ROADMAP A9.3), and, as the reference, a zoo
        whose configuration splits parameters without a ``model`` axis
        and has no ``build_collective_model``."""
        from elasticdl_tpu_torch.parallel.mesh import flatten_specs, spec_axes

        if not cls._zoo_wants_sharded_params(zoo_module, model_params):
            return
        if cls._zoo_wants_pjit_dense(zoo_module, model_params):
            return
        specs = flatten_specs(cls._probe_specs(zoo_module, model_params)
                              or {})
        if any("pipe" in spec_axes(sp) for sp in specs.values()):
            raise NotImplementedError(
                "zoo module %s splits parameters over a 'pipe' axis for "
                "this configuration (pipeline_stages): training the "
                "pipeline's stage stacks on the collective plane "
                "(PipelinedTransformerLM, parallel/pipeline.py) is not "
                "ported yet (ROADMAP A9.3)%s"
                % (
                    model_def,
                    ", nor its in-plane evaluation (_collective_evaluate)"
                    if job_type == JobType.TRAINING_WITH_EVALUATION else "",
                )
            )
        if (hasattr(zoo_module, "build_distributed_model")
                and not hasattr(zoo_module, "build_collective_model")):
            # training the plain replicated model instead would either
            # run out of memory or silently change the declared strategy
            raise NotImplementedError(
                "model %s declares sharded parameters for this config "
                "(param_shardings is non-empty) but no "
                "build_collective_model hook; the multi-process elastic "
                "plane needs the collective-lookup form — add "
                "build_collective_model (see "
                "model_zoo/deepfm_edl_embedding or "
                "model_zoo/transformer_lm) or run the "
                "single-process ALLREDUCE strategy" % model_def
            )

    @staticmethod
    def _refuse_ps_plane_tables(zoo_module, model_params):
        """The reference's per-table plane guard: a PS-plane table has no
        parameter (its rows are pulled per batch), which no elastic
        allreduce plane can serve; raised at construction, not after a
        world formed."""
        from elasticdl_tpu_torch.common.model_utils import (
            get_dict_from_params_str,
        )

        extra = get_dict_from_params_str(model_params) or {}
        plane_spec = str(extra.get("embedding_plane", "") or "")
        if not plane_spec:
            return
        tables = getattr(zoo_module, "TABLES", None)
        if tables:
            from elasticdl_tpu_torch.nn.comm_plane import resolve_table_planes

            planes = resolve_table_planes(
                plane_spec, tables,
                hybrid_default=getattr(zoo_module, "HYBRID_SPLIT", None),
            )
            has_ps_tables = "ps" in planes.values()
        else:
            has_ps_tables = plane_spec != "hbm"
        if has_ps_tables:
            raise NotImplementedError(
                "model config embedding_plane=%r places tables on "
                "the PS plane, which the elastic allreduce worker "
                "cannot serve; run PS-resident tables on the "
                "parameter-server worker (--embedding_plane=hybrid "
                "keeps dense local while the PS fleet serves the "
                "sparse tables)" % plane_spec
            )

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
        stub=None,
        data_reader_params=None,
        seed=0,
        comm_host=None,
        epoch_poll_secs=10.0,
        checkpoint_dir="",
        checkpoint_steps=0,
        keep_checkpoint_max=0,
        precision=None,
        accum_steps=1,
        checkpoint_filename_for_init="",
        prediction_outputs_processor="PredictionOutputsProcessor",
        remat="",
        replica_refresh_steps=8,
        task_prefetch=0,
        device="cuda",
        telemetry_report_secs=5.0,
    ):
        self._serving_only = job_type in (
            JobType.EVALUATION_ONLY,
            JobType.PREDICTION_ONLY,
        )
        zoo_module = load_zoo_module(model_def, model_zoo)
        self._refuse_ps_plane_tables(zoo_module, model_params)
        if not self._serving_only:
            self._refuse_sharded_training(
                zoo_module, model_def, model_params, job_type
            )
        if self._serving_only and not (
            checkpoint_dir or checkpoint_filename_for_init
        ):
            raise ValueError(
                "%s on the allreduce plane scores a saved model: pass "
                "--checkpoint_dir (sharded checkpoints) or "
                "--checkpoint_filename_for_init (an exported model file)"
                % job_type
            )
        # a zoo with a host twin (build_host_model) is scored through it
        # against sharded checkpoints; one without the twin with the
        # degenerate (mesh=None) distributed form
        host_twin = self._serving_only and hasattr(
            zoo_module, "build_host_model"
        )
        if host_twin and not checkpoint_dir:
            raise ValueError(
                "%s for sharded-parameter model %s needs --checkpoint_dir "
                "(sharded checkpoints); an exported model file cannot feed "
                "the host-twin forward" % (job_type, model_def)
            )
        distributed = self._serving_only and hasattr(
            zoo_module, "build_distributed_model"
        )
        self._worker_id = worker_id
        self._job_type = job_type
        self._minibatch_size = minibatch_size
        self._stub = stub
        self._device = resolve_device(device)
        spec = get_model_spec(
            model_zoo=model_zoo,
            model_def=model_def,
            model_params=model_params,
            dataset_fn=dataset_fn,
            loss=loss,
            optimizer=optimizer,
            eval_metrics_fn=eval_metrics_fn,
            prediction_outputs_processor=prediction_outputs_processor,
            build=not (host_twin or distributed),
        )
        self._dataset_fn = spec.dataset_fn
        self._model = spec.model
        if host_twin or distributed:
            from elasticdl_tpu_torch.common.model_utils import (
                get_dict_from_params_str,
            )

            extra = get_dict_from_params_str(model_params) or {}
            self._model = (
                zoo_module.build_host_model(**extra) if host_twin
                else zoo_module.build_distributed_model(mesh=None, **extra)
            )
        self._prediction_outputs_processor = spec.prediction_outputs_processor
        # the collective plane's export traces the host twin
        self._host_model_factory = None
        self._init_ckpt_file = checkpoint_filename_for_init
        self._checkpoint_dir = checkpoint_dir
        self._timeline = _Timeline(worker_id)
        self._ckpt = None
        self.trainer = None
        self._preempted = False
        if self._serving_only:
            if checkpoint_dir:
                from elasticdl_tpu_torch.common.sharded_checkpoint import (
                    ShardedCheckpointManager,
                )

                # read-only: a scoring job loads checkpoints, never writes
                self._ckpt = ShardedCheckpointManager(checkpoint_dir)
        else:
            hooks = self._pjit_dense_hooks(zoo_module, model_params)
            if not hooks:
                hooks = self._collective_hooks(zoo_module, model_params)
                if hooks and hasattr(zoo_module, "build_host_model"):
                    from elasticdl_tpu_torch.common.model_utils import (
                        get_dict_from_params_str,
                    )

                    extra = get_dict_from_params_str(model_params) or {}
                    self._host_model_factory = (
                        lambda: zoo_module.build_host_model(**extra)
                    )
            self._init_training(
                spec, seed, precision, accum_steps, remat, checkpoint_dir,
                checkpoint_steps, keep_checkpoint_max, hooks,
                replica_refresh_steps,
            )
            from elasticdl_tpu_torch.common.export import export_provenance

            self._export_meta = export_provenance(
                model_zoo, model_def, model_params
            )
        self._host = comm_host or os.environ.get("EDL_COMM_HOST", "")
        if not self._host:
            # an address the peers can dial: the hostname may not
            # resolve from a sibling, its address does
            hostname = socket.gethostname()
            try:
                self._host = socket.gethostbyname(hostname)
            except OSError:
                self._host = hostname
        self._epoch_poll_secs = epoch_poll_secs
        self._task_data_service = TaskDataService(
            self,
            job_type == JobType.TRAINING_WITH_EVALUATION,
            data_reader_params=data_reader_params,
            task_prefetch=task_prefetch,
        )
        # job telemetry: step and example rates and the resize events
        # ride the task-report channel (docs/observability.md)
        self._telemetry = WorkerTelemetry(
            worker_id,
            stats=self._task_data_service.stats,
            interval_s=telemetry_report_secs,
        )
        self._forward_fn = None
        self._eval_params = None  # (params, state) on the device
        self._eval_params_version = None  # a training job's snapshot's
        self._eval_scored_version = None  # the version they came from
        # master restarts seen by the channel, and the count when the
        # current world formed
        self._master_boots = 0
        self._world_master_boots = 0
        self._last_world = (0, 0)  # (size, epoch) of the last world formed
        if hasattr(stub, "set_on_master_epoch_change"):
            stub.set_on_master_epoch_change(self._on_master_epoch_change)

    @classmethod
    def _pjit_dense_hooks(cls, zoo_module, model_params):
        """The trainer's keyword arguments of the pjit dense plane for a
        configuration that splits over ``model``: the builder (the
        zoo's ``build_distributed_model`` on the meta device, built once
        the establish checks pass, and its ``param_shardings``), the
        zoo's ``mesh_axes`` and a layout planner over it (the memory
        budget from ``EDL_LAYOUT_MEM_BUDGET_MB``); empty otherwise."""
        if not cls._zoo_wants_pjit_dense(zoo_module, model_params):
            return {}
        from elasticdl_tpu_torch.common.model_utils import (
            get_dict_from_params_str,
        )
        from elasticdl_tpu_torch.parallel.layout_solver import LayoutPlanner

        extra = get_dict_from_params_str(model_params) or {}

        def builder(mesh):
            return (
                lambda: zoo_module.build_distributed_model(mesh, **extra),
                zoo_module.param_shardings(mesh, **extra),
            )

        mesh_axes_fn = None
        if hasattr(zoo_module, "mesh_axes"):
            def mesh_axes_fn(n):
                return zoo_module.mesh_axes(n, **extra)
        return dict(
            distributed_builder=builder, mesh_axes_fn=mesh_axes_fn,
            layout_planner=LayoutPlanner(fallback_axes_fn=mesh_axes_fn),
        )

    @classmethod
    def _collective_hooks(cls, zoo_module, model_params):
        """The trainer's keyword arguments of the collective plane for a
        configuration that splits parameters without a ``model`` axis
        (deepfm_edl's HBM tables): the builder (the zoo's
        ``build_collective_model`` over the world's mesh, on the meta
        device, and its ``param_shardings``) and the zoo's ``mesh_axes``;
        empty otherwise. The collective model is built once here, on
        the meta device, so an unsupported configuration fails at
        construction."""
        import torch

        if not (cls._zoo_wants_sharded_params(zoo_module, model_params)
                and hasattr(zoo_module, "build_collective_model")):
            return {}
        from elasticdl_tpu_torch.common.model_utils import (
            get_dict_from_params_str,
        )

        extra = get_dict_from_params_str(model_params) or {}
        with torch.device("meta"):
            zoo_module.build_collective_model(**extra)

        def builder(mesh):
            return (
                lambda: zoo_module.build_collective_model(mesh=mesh,
                                                          **extra),
                zoo_module.param_shardings(mesh, **extra),
            )

        mesh_axes_fn = None
        if hasattr(zoo_module, "mesh_axes"):
            def mesh_axes_fn(n):
                return zoo_module.mesh_axes(n, **extra)
        return dict(distributed_builder=builder, mesh_axes_fn=mesh_axes_fn)

    def _init_training(self, spec, seed, precision, accum_steps, remat,
                       checkpoint_dir, checkpoint_steps, keep_checkpoint_max,
                       pjit_dense, replica_refresh_steps):
        from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer
        from elasticdl_tpu_torch.training.step import parse_remat

        self.trainer = ElasticDPTrainer(
            spec.model, spec.loss, spec.optimizer(), seed=seed,
            precision=precision, accum_steps=accum_steps,
            remat=parse_remat(remat), device=self._device, **pjit_dense
        )
        # the replica plane's cadence reaches every rank alike through
        # the flag relay; the sharded establish refuses it where the
        # reference does
        self.trainer.mirror_steps = max(0, int(replica_refresh_steps))
        self.trainer.default_minibatch_size = self._minibatch_size
        # a collective waiting on a peer that died gives up once the
        # master lists the peer dead
        self.trainer.abort_check = self._world_moved_on
        if checkpoint_dir and checkpoint_steps:
            from elasticdl_tpu_torch.common.sharded_checkpoint import (
                ShardedCheckpointManager,
            )

            # async_io: a save blocks only for the device-to-host
            # snapshot; the file writes overlap the next steps
            self._ckpt = ShardedCheckpointManager(
                checkpoint_dir, checkpoint_steps, keep_checkpoint_max,
                async_io=True,
            )
            # replicated state: rank 0 alone writes each version (a
            # sharded world sets its size at each establish)
            self._ckpt.set_expected_writers(1)
            self.trainer.restore_provider = self._ckpt_dirs_newest_first
        elif self.trainer.is_sharded:
            logger.warning(
                "sharded-parameter elastic job without --checkpoint_steps:"
                " any membership change RE-INITIALIZES the model"
            )
        self._restore_attempted = False
        self._last_ckpt_version = 0
        self._batch_gen = None
        self._retry_batch = None
        self._unreported = []  # counts of stepped-but-unreported batches
        self._drained = False
        self._drain_announced = False
        self._drain_deadline = 0.0
        self._world_members = ()
        self._overflow_alarmed = 0

    def record_event(self, event, **fields):
        """Append ``event`` to this worker's timeline (when it is on)."""
        self._timeline(event, **fields)

    def _on_master_epoch_change(self, old, new):
        """The channel saw a relaunched master: the current world must be
        left and formed again with it."""
        self._master_boots += 1
        logger.warning("master relaunched (epoch %s -> %s)", old, new)
        self._timeline("master_relaunched", old=old, new=new)

    # master surface used by TaskDataService
    def get_task(self, task_type=None):
        return self._stub.get_task(self._worker_id, task_type)

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        if self.trainer is not None:
            from elasticdl_tpu_torch.worker.reporting import (
                with_model_version,
            )

            exec_counters = with_model_version(self.trainer, exec_counters)
        result = self._stub.report_task_result(
            task_id, err_msg, exec_counters
        )
        # piggyback the (rate-limited) telemetry snapshot: the resize
        # events reach the master's event log here
        self._telemetry.ship(self._stub)
        return result

    def run(self):
        try:
            if self._job_type == JobType.EVALUATION_ONLY:
                return self._run_eval_only()
            if self._job_type == JobType.PREDICTION_ONLY:
                return self._run_predict_only()
            return self._run()
        finally:
            # the final flush: a job shorter than the report interval
            # still lands one snapshot (best effort: the master may be
            # gone already)
            self._telemetry.ship(self._stub, force=True)
            # the trace is flushed on the crash path too
            profiling.maybe_stop_trace()
            # a crash skips _finalize; writes already queued must land
            self._drain_ckpt()

    # -- the two drains ------------------------------------------------------

    def _run_eval_only(self):
        """Drain the evaluation queue against the saved params until
        ``_ATTEMPTS`` rounds in a row find nothing; give up with an error
        if a task is still queued then."""
        drained_rounds = 0
        while True:
            executed = self._evaluate_only()
            task = self.get_task()  # the non-evaluation queue: job end
            if task.shard_name:
                # not this drain's work: hand it back, failed, untouched
                self.report_task_result(
                    task.task_id,
                    err_msg="eval-only worker cannot run task type %s"
                    % task.type,
                )
            if not executed and not task.shard_name:
                drained_rounds += 1
                if drained_rounds >= _ATTEMPTS:
                    break
                time.sleep(0.5)
            else:
                drained_rounds = 0
        leftover = self.get_task(TaskType.EVALUATION)
        if leftover.shard_name:
            self.report_task_result(
                leftover.task_id,
                err_msg="eval-only worker giving up: no scoreable params",
            )
            raise RuntimeError(
                "evaluation-only job cannot make progress: eval tasks "
                "keep deferring (is --checkpoint_dir empty / "
                "--checkpoint_filename_for_init unreadable, or does the "
                "checkpoint's parameter structure mismatch the model "
                "built from --model_params?)"
            )
        return []

    def _run_predict_only(self):
        """Stream the prediction tasks, forward each batch with the saved
        params (up to ``_ATTEMPTS`` tries) and hand the outputs to the
        zoo's processor once; a failed batch fail-reports its task and
        ends the job with an error."""
        if self._prediction_outputs_processor is None:
            logger.warning(
                "prediction_outputs_processor is not defined in the "
                "model definition. Prediction outputs are not processed."
            )
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                break
            dataset = self._dataset_fn(
                dataset,
                Mode.PREDICTION,
                self._task_data_service.data_reader.metadata,
            )
            dataset = (
                dataset.batch(self._minibatch_size)
                .prefetch(1)
                .device_prefetch(self._device)
            )
            for features in dataset:
                count = int(_first_leaf(features).shape[0])
                err_msg, outputs = "", None
                for attempt in range(_ATTEMPTS):
                    err_msg = ""
                    try:
                        outputs = self._serving_forward(features)
                        break
                    except RuntimeError as e:
                        # e.g. no restorable checkpoint yet
                        logger.warning(
                            "prediction batch deferred (attempt %d): %s",
                            attempt + 1,
                            e,
                        )
                        err_msg = str(e)
                        if attempt < _ATTEMPTS - 1:
                            time.sleep(0.5)
                if not err_msg and self._prediction_outputs_processor:
                    # once: a replay would write records to the sink twice
                    try:
                        self._prediction_outputs_processor.process(
                            tree_map(to_host, outputs), self._worker_id
                        )
                    except RuntimeError as e:
                        logger.warning(
                            "prediction outputs processor failed: %s", e
                        )
                        err_msg = str(e)
                self._task_data_service.report_record_done(count, err_msg)
                if err_msg:
                    raise RuntimeError(
                        "prediction-only job cannot make progress: %s"
                        % err_msg
                    )
        return []

    # -- scoring -------------------------------------------------------------

    def _serving_forward(self, features):
        """Inference forward over the saved params, loaded on first use
        (a sharded-parameter zoo's host twin is ``self._model``)."""
        if self._eval_params is None:
            self._load_eval_only_params()
        if self._forward_fn is None:
            from elasticdl_tpu_torch.training.step import make_forward_fn

            self._forward_fn = make_forward_fn(self._model)
        params, state = self._eval_params
        return self._forward_fn(params, state, features)

    def _template(self):
        """The model on the device, initialized: its parameter names and
        shapes, and fresh BatchNorm statistics."""
        from elasticdl_tpu_torch.nn.model_api import (
            init_variables,
            split_variables,
        )
        from elasticdl_tpu_torch.parallel.trainer import place_module

        place_module(self._model, self._device)
        return split_variables(init_variables(self._model, 0))

    def _adopt(self, params, state, template, source):
        """``params``/``state`` on the device, checked against the
        model's names and shapes (RuntimeError on a mismatch: the task
        defers)."""
        for what, got, want in zip(("params", "state"), (params, state),
                                   template):
            if sorted(got) != sorted(want):
                raise RuntimeError(
                    "%s has %s %s, the model %s"
                    % (source, what, sorted(got), sorted(want))
                )
            for name, value in got.items():
                if tuple(value.shape) != tuple(want[name].shape):
                    raise RuntimeError(
                        "%s: %s %s has shape %s, the model %s"
                        % (source, what, name, tuple(value.shape),
                           tuple(want[name].shape))
                    )
        return tuple(
            {n: t.to(self._device) for n, t in part.items()}
            for part in (params, state)
        )

    def _load_eval_only_params(self):
        """The newest restorable sharded checkpoint, else the exported
        model file (params only: the BatchNorm statistics are fresh)."""
        template = self._template()
        if self._ckpt is not None:
            from elasticdl_tpu_torch.common.sharded_checkpoint import (
                load_sharded_to_host,
                split_train_state_leaves,
            )

            for directory in self._ckpt.dirs_newest_first():
                try:
                    _, leaves = load_sharded_to_host(directory)
                    params, state, _, version = split_train_state_leaves(
                        leaves, list(template[0])
                    )
                    self._eval_params = self._adopt(
                        params, state, template, directory
                    )
                except Exception:
                    logger.warning(
                        "eval restore skipped checkpoint %s",
                        directory,
                        exc_info=True,
                    )
                    continue
                self._eval_scored_version = version
                logger.info(
                    "scoring checkpoint v%d (%s)", version, directory
                )
                return
        if self._init_ckpt_file:
            from elasticdl_tpu_torch.common import convert
            from elasticdl_tpu_torch.common.model_utils import (
                load_from_checkpoint_file,
            )

            # a .chkpt file or an export directory
            try:
                version, named = load_from_checkpoint_file(
                    self._init_ckpt_file
                )
                params = convert.to_state_dict(named)
            except (OSError, ValueError, KeyError) as e:
                raise RuntimeError(
                    "cannot read %s: %s" % (self._init_ckpt_file, e)
                ) from e
            self._eval_params = self._adopt(
                params, template[1], template, self._init_ckpt_file
            )
            self._eval_scored_version = version
            logger.info(
                "scoring exported model v%d from %s (fresh BatchNorm "
                "statistics)",
                version,
                self._init_ckpt_file,
            )
            return
        raise RuntimeError(
            "no restorable checkpoint in %r for evaluation"
            % self._checkpoint_dir
        )

    # -- evaluation tasks ----------------------------------------------------

    def _evaluate_only(self, final=False):
        """Score every queued evaluation task; True if any completed. A
        deferred task (no scoreable params) requeued: stop grabbing, or,
        with ``final`` (no later step retries), wait and try again, up to
        30 times. A training worker that has no state yet leaves the
        tasks to its peers."""
        if self.trainer is not None and not self.trainer.has_state:
            return False
        executed = False
        retries = 30 if final else 0
        while True:
            task = self.get_task(TaskType.EVALUATION)
            if not task.shard_name:
                break
            if not self._process_eval_task(task):
                if retries <= 0:
                    break
                retries -= 1
                time.sleep(1.0)
                continue
            executed = True
        return executed

    def _local_forward(self, features, pinned_version=None):
        """A training job's inference forward over a snapshot of its
        train state (params and BatchNorm statistics), taken at the
        current version and cached per version: a round's tasks scored
        at its pinned version all use one snapshot, even after training
        moves on. ``_eval_scored_version`` names the version scored. (A
        sharded world scores in-plane: :meth:`_collective_evaluate`.)"""
        if self._forward_fn is None:
            from elasticdl_tpu_torch.training.step import make_forward_fn

            self._forward_fn = make_forward_fn(self._model)
        if (
            pinned_version is None
            or self._eval_params_version != pinned_version
        ):
            version = self.trainer.version
            if self._eval_params_version != version:
                from elasticdl_tpu_torch.parallel.trainer import to_device

                host_ts = self.trainer.snapshot()
                if host_ts is None:
                    raise RuntimeError("no local train state for evaluation")
                self._eval_params = (
                    to_device(host_ts.params, self._device),
                    to_device(host_ts.state, self._device),
                )
                self._eval_params_version = version
        self._eval_scored_version = self._eval_params_version
        params, state = self._eval_params
        return self._forward_fn(params, state, features)

    def _process_eval_task(self, task):
        """True when the task completed (or fail-reported for a retry);
        False when it deferred."""
        eval_info = self._task_data_service.get_validation_dataset(task)
        if not eval_info:
            return False
        dataset, model_version, task_id = eval_info
        t0 = time.time()
        dataset = self._dataset_fn(
            dataset,
            Mode.EVALUATION,
            self._task_data_service.data_reader.metadata,
        )
        dataset = dataset.batch(self._minibatch_size).device_prefetch(
            self._device
        )
        out_chunks, label_chunks = {}, []
        try:
            for features, labels in dataset:
                outputs = (
                    self._serving_forward(features)
                    if self._serving_only
                    else self._local_forward(
                        features, pinned_version=model_version
                    )
                )
                if not isinstance(outputs, dict):
                    outputs = {MetricsDictKey.MODEL_OUTPUT: outputs}
                # one copy to the host per batch (bf16 widened to float32)
                for k, v in outputs.items():
                    out_chunks.setdefault(k, []).append(to_host(v))
                label_chunks.append(to_host(labels))
        except RuntimeError as e:
            # e.g. no checkpoint yet: the task requeues, and a later
            # round redoes it
            logger.warning("eval task %d deferred: %s", task_id, e)
            self.report_task_result(task_id, err_msg=str(e))
            return False
        self._report_eval_outputs(
            task_id, model_version, out_chunks, label_chunks
        )
        if self._timeline.enabled:
            self._timeline(
                "eval", task=task_id, version=model_version,
                scored_version=self._eval_scored_version,
                rows=sum(len(c) for c in label_chunks), t0=t0,
            )
        return True

    def _collective_evaluate(self, final=False):
        """In-plane evaluation on the sharded plane: every rank takes
        part in every tensor-parallel forward. Each round the ranks
        agree on how many hold a task (``eval_have_consensus``); a rank
        without one feeds its last rows and drops the output, until the
        count is 0. It scores the current parameters, at the version
        reported as scored. Called at the same step on every rank (and
        from ``_finalize``, which every rank enters from the same
        quiescent step); ``final`` waits out three empty rounds, so a
        task one rank fail-reported is not left behind. A task in hand
        when the world breaks is fail-reported: it queues again."""
        pending = None  # [task_id, version, batches, outputs, labels]
        empty_rounds = 0
        try:
            while True:
                if pending is None:
                    task = self.get_task(TaskType.EVALUATION)
                    if task.shard_name:
                        pending = self._start_eval_task(task)
                if self.trainer.eval_have_consensus(pending is not None) == 0:
                    empty_rounds += 1
                    if not final or empty_rounds >= _ATTEMPTS:
                        return
                    time.sleep(0.5)
                    continue
                empty_rounds = 0
                features, labels, count = None, None, 0
                if pending is not None:
                    features, labels, count = pending[2].pop(0)
                outputs = self.trainer.eval_step(features,
                                                 self._minibatch_size)
                if pending is None:
                    continue  # a dummy forward for a busy peer
                if not isinstance(outputs, dict):
                    outputs = {MetricsDictKey.MODEL_OUTPUT: outputs}
                for k, v in outputs.items():
                    pending[3].setdefault(k, []).append(to_host(v)[:count])
                pending[4].append(to_host(labels))
                if not pending[2]:
                    self._eval_scored_version = self.trainer.version
                    self._report_eval_outputs(*pending[:2], *pending[3:])
                    if self._timeline.enabled:
                        self._timeline(
                            "eval", task=pending[0], version=pending[1],
                            scored_version=self._eval_scored_version,
                            rows=sum(len(c) for c in pending[4]),
                        )
                    pending = None
        except Exception as e:
            if pending is not None:
                self.report_task_result(
                    pending[0], err_msg="collective evaluation failed: %s" % e
                )
            raise

    def _start_eval_task(self, task):
        """One evaluation task's batches for the lockstep rounds:
        ``[task_id, version, [(features, labels, rows)], {}, []]``, or
        None (the task fail-reported, or completed when empty)."""
        eval_info = self._task_data_service.get_validation_dataset(task)
        if not eval_info:
            return None
        dataset, model_version, task_id = eval_info
        dataset = self._dataset_fn(
            dataset,
            Mode.EVALUATION,
            self._task_data_service.data_reader.metadata,
        ).batch(self._minibatch_size)
        batches = []
        try:
            for features, labels in dataset:
                batches.append(
                    (features, labels, int(_first_leaf(features).shape[0]))
                )
        except Exception as e:
            logger.warning("eval task %d unreadable: %s", task_id, e)
            self.report_task_result(task_id, err_msg=str(e))
            return None
        if not batches:
            self.report_task_result(task_id)
            return None
        return [task_id, model_version, batches, {}, []]

    def _report_eval_outputs(
        self, task_id, model_version, out_chunks, label_chunks
    ):
        """Publish one eval task's outputs and complete it; a failure to
        report fail-reports the task for a retry."""
        try:
            if out_chunks:
                self._stub.report_evaluation_metrics(
                    model_version,
                    {k: np.concatenate(v) for k, v in out_chunks.items()},
                    np.concatenate(label_chunks),
                    scored_version=self._eval_scored_version,
                )
            self.report_task_result(task_id)
        except Exception as e:
            logger.warning("eval task %d report failed: %s", task_id, e)
            try:
                self.report_task_result(task_id, err_msg=str(e))
            except Exception:
                # the master is unreachable: its boot requeues the task
                logger.debug("fail-report of eval task %d failed too",
                             task_id, exc_info=True)


    # -- graceful preemption ------------------------------------------------

    def request_drain(self, *_signal_args):
        """SIGTERM handler: drain at the next batch boundary instead of
        dying mid-collective. The worker announces its leave, steps on
        until every member pauses at the same step, lands its checkpoint
        writes and exits with PREEMPTED_EXIT_CODE."""
        self._preempted = True
        logger.info(
            "preemption notice received; draining at the next batch "
            "boundary"
        )

    def enable_drain_on_sigterm(self):
        """Install the SIGTERM -> request_drain handler (main thread
        only: in-process workers leave signals to their host)."""
        import signal

        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, self.request_drain)

    @property
    def preempted(self):
        return self._preempted

    # -- data ---------------------------------------------------------------

    def _batches(self):
        """(features, labels) over every task round; None on a WAIT round
        (no data now, the job not finished), so the caller keeps the
        collective ticking; the end means no more training work here."""
        while True:
            dataset = self._task_data_service.get_dataset()
            if not dataset:
                return
            dataset = self._dataset_fn(
                dataset,
                Mode.TRAINING,
                self._task_data_service.data_reader.metadata,
            )
            dataset = (
                dataset.batch(self._minibatch_size)
                .prefetch(1)
                .device_prefetch(self.trainer.device)
            )
            got = False
            for batch in dataset:
                got = True
                yield batch
            if (
                not self.trainer.is_sharded
                or self._last_ckpt_version >= self.trainer.version
            ):
                # a sharded export is assembled from the checkpoint of
                # the current version (the SAVE_MODEL task comes once
                # training is over: every rank writes its final parts at
                # the quiescent step)
                self._process_save_model_task_if_needed()
            if not got:
                yield None

    def _next_batch(self):
        if self._retry_batch is not None:
            batch, self._retry_batch = self._retry_batch, None
            return batch
        if self._drained:
            return None
        try:
            return next(self._batch_gen)
        except StopIteration:
            self._drained = True
            return None

    # -- membership ---------------------------------------------------------

    def _poll_world(self, awaiting, budget_s=None):
        """The membership poll. It names the size and epoch of the last
        world this worker formed: a relaunched master waits for that many
        before its first world forms, and forms it past that epoch."""
        size, epoch = self._last_world
        return self._stub.get_comm_world(
            self._worker_id, self._host, awaiting=awaiting,
            world_size=size, world_epoch=epoch, budget_s=budget_s,
        )

    def _await_world(self):
        """Poll the master until a world holding this worker is ready; a
        WorldSpec, or None when the job finished (or a drain began)
        meanwhile.

        A ``spare`` reply means the world-size rounding left this live
        worker out of the world: it hands back everything it fetched,
        once (:meth:`_requeue_as_spare`), and parks here until a death
        promotes it, or until the master says the job has finished."""
        spare_flushed = False
        while True:
            if self._preempted:
                return None
            w = self._poll_world(awaiting=True)
            if w.get("ready"):
                self._world_members = tuple(w.get("members", ()))
                return WorldSpec(
                    coordinator=w["coordinator"],
                    num_processes=w["num_processes"],
                    process_id=w["process_id"],
                    epoch=w["epoch"],
                )
            if w.get("spare"):
                if not spare_flushed:
                    spare_flushed = True
                    self._requeue_as_spare()
                if w.get("job_finished"):
                    logger.info("parked spare: the job has finished")
                    return None
            if self._drained and self._retry_batch is None:
                return None
            time.sleep(0.2)

    def _requeue_as_spare(self):
        """Hand every in-flight task back to the master (fail-reported,
        so it queues again), prefetched ones included, drop the primed
        batch and abandon the open round: a spare trains nothing, and a
        world member finishes what it held. The batch stream restarts;
        a promotion primes from a fresh round."""
        msg = "parked as spare (world size rounding)"
        logger.info(
            "parked as spare (world-size rounding); requeueing in-flight "
            "work and abandoning the open round"
        )
        self._retry_batch = None
        self._flush_unreported(msg)
        self._task_data_service.requeue_inflight(msg)
        self._batch_gen = self._batches()
        self._timeline("spare", warmed=self._warm_for_promotion())

    def _warm_for_promotion(self):
        """What a parked spare can do ahead of its promotion, as a
        standby does (``worker/main._warm``): its optimizer's first
        construction (torch imports its compile stack there: seconds)
        and, on a card, the CUDA context with cuBLAS loaded. Returns the
        seconds."""
        import torch

        t0 = time.perf_counter()
        self._warm_optimizer()
        if self._device.type == "cuda":
            p = torch.zeros(2, device=self._device)
            (p[:, None] @ p[None, :]).sum().item()
        return time.perf_counter() - t0

    def _warm_optimizer(self):
        """Construct the zoo's optimizer once over a throwaway tensor: its
        first construction in a process imports torch's compile stack."""
        import torch

        self.trainer._optimizer([torch.zeros(2, requires_grad=True)])

    def _await_epoch_bump(self, stale_epoch):
        """After a broken collective: True once the master bumps the
        epoch; False if it does not within ``epoch_poll_secs`` (then the
        failure was no membership event and propagates)."""
        deadline = time.time() + self._epoch_poll_secs
        while time.time() < deadline:
            if self._poll_world(awaiting=False)["epoch"] != stale_epoch:
                return True
            time.sleep(0.3)
        return False

    def _world_moved_on(self):
        """The trainer's abort probe: True when a member of this world
        died (the instance manager's report, not a growth bump or a
        drain, which leave every member stepping)."""
        if distributed.current_spec() is None:
            return False
        try:
            # one attempt: a master outage must not hold the wait loop
            w = self._poll_world(awaiting=False, budget_s=0.0)
        except Exception:
            logger.debug("world probe failed", exc_info=True)
            return False
        dead = set(w.get("dead", ()))
        return any(
            m in dead for m in self._world_members if m != self._worker_id
        )

    # -- the run loop -------------------------------------------------------

    def _run(self):
        losses = []
        self._timeline("start", pid=os.getpid())
        # the first optimizer imports torch's compile stack (seconds):
        # that runs while this process registers, primes and waits for
        # its first world, not inside the world's establish
        threading.Thread(target=self._warm_optimizer, daemon=True,
                         name="edl-optimizer-warm").start()
        self._batch_gen = self._batches()
        # register before priming: the await loop's confirm comes later
        try:
            self._poll_world(awaiting=False)
        except Exception:
            logger.debug("pre-registration poll failed", exc_info=True)
        first = self._prime()
        if first is None:
            # no training data ever came: announce the leave, or the
            # members' formation waits out the confirm window on us
            self._announce_leave()
            self._finalize()
            return losses
        self._retry_batch = first
        while True:
            world = self._await_world()
            if world is None:
                break
            try:
                example = self._retry_batch or self.trainer._last_local
                if example is None:
                    # promoted after a spare park requeued everything:
                    # prime a fresh batch first
                    first = self._prime()
                    if first is None:
                        self._announce_leave()
                        break
                    self._retry_batch = example = first
                self._world_master_boots = self._master_boots
                self.trainer.establish(world, example_batch=example)
                if self._ckpt is not None and self.trainer.is_sharded:
                    # every rank writes its parts of each version, and
                    # the manifests record the rows this world pads
                    self._ckpt.set_expected_writers(world.num_processes)
                    self._ckpt.set_logical_dim0(
                        self.trainer.logical_dim0_by_path()
                    )
                if self.trainer.is_sharded:
                    # sharded state restores inside every establish
                    self._last_ckpt_version = max(0, self.trainer.version)
                elif (
                    self._ckpt is not None
                    and not self._restore_attempted
                ):
                    self._restore_attempted = True
                    # resume only when the whole world is new (the
                    # broadcast state is at version 0): a joiner of a
                    # live job holds the survivors' state already
                    if self.trainer.version == 0:
                        self._restore_latest_checkpoint()
            except WorldBroken:
                logger.warning(
                    "world %d broke during formation; re-polling",
                    world.epoch,
                )
                continue
            self._last_world = (world.num_processes, world.epoch)
            if self._timeline.enabled:
                self._timeline(
                    "established", epoch=world.epoch,
                    rank=world.process_id, size=world.num_processes,
                    backend=self.trainer.backend,
                    version=self.trainer.version,
                    digest=self.trainer.digest(),
                    mesh=self.trainer.mesh_shape,
                    split_bytes=self._split_bytes(),
                    **self.trainer.establish_times,
                )
            # one trace per world: started once it formed, stopped when
            # it is left
            profiling.maybe_start_trace()
            outcome = self._train_epoch(world, losses)
            if outcome in ("done", "preempted") or self._preempted:
                break
        self._finalize()
        return losses

    def _announce_leave(self):
        try:
            self._stub.leave_comm_world(self._worker_id)
        except Exception:
            logger.debug(
                "leave announcement missed; the confirm-timeout fencer "
                "clears this member",
                exc_info=True,
            )

    def _ckpt_dirs_newest_first(self):
        """Candidate checkpoint directories, newest first, once every
        in-flight save of this process has landed (a restore never reads
        a half-written one). More than one matters: a killed rank can
        leave the newest version torn while an older complete one sits
        behind it."""
        if self._ckpt is None:
            return []
        try:
            self._ckpt.wait()
        except Exception:
            logger.warning(
                "async checkpoint write failed; restoring from the "
                "previous complete checkpoint",
                exc_info=True,
            )
        return self._ckpt.dirs_newest_first()

    def _restore_latest_checkpoint(self):
        """Resume from the newest restorable checkpoint, falling through
        to older ones past a torn or corrupt directory."""
        self._ckpt.wait()  # an in-flight save must land first
        for directory in self._ckpt.dirs_newest_first():
            try:
                self._last_ckpt_version = self.trainer.restore_sharded(
                    directory
                )
                logger.info(
                    "resumed from checkpoint v%d (%s)",
                    self._last_ckpt_version,
                    directory,
                )
                return True
            except Exception:
                logger.warning(
                    "checkpoint %s unrestorable; trying older",
                    directory,
                    exc_info=True,
                )
        return False

    def _prime(self):
        """Block until the first local batch is in hand. A side thread
        keeps polling the membership meanwhile (``awaiting=False``): the
        worker is registered already, and a member whose polls go stale
        looks dead to the confirm-timeout fencer while its reader primes.
        The beats stop after 120 s, so a truly wedged reader is fenced."""
        done = threading.Event()
        deadline = time.time() + 120.0

        def beat():
            while time.time() < deadline and not done.wait(1.0):
                try:
                    self._poll_world(awaiting=False)
                except Exception:
                    logger.debug("liveness beat missed", exc_info=True)

        beater = threading.Thread(target=beat, daemon=True)
        beater.start()
        try:
            while True:
                if self._preempted:
                    return None
                batch = self._next_batch()
                if batch is not None:
                    return batch
                if self._drained:
                    return None
                time.sleep(0.2)
        finally:
            done.set()
            beater.join(timeout=5.0)

    def _flush_unreported(self, err_msg=""):
        """Report the records of stepped batches; with ``err_msg`` they
        count as failures and their task fail-reports and requeues once
        it drains (the reference's failed-minibatch accounting)."""
        pending, self._unreported = self._unreported, []
        for count in pending:
            self._task_data_service.report_record_done(count, err_msg)

    def _settle_and_leave(self, verdict, ok=True):
        """The epilogue of every pause: report the stepped records (as
        failures when the last step did not apply), then leave the
        world."""
        self._flush_unreported(
            "" if ok else "collective failed before the update"
        )
        if ok and self.trainer.is_sharded:
            # every member pauses at the same version: a checkpoint
            # written here makes the re-form's restore lossless
            self._save_ckpt_if_newer()
        profiling.maybe_stop_trace()  # the trace must not outlive its world
        self.trainer.leave()
        return verdict

    def _train_epoch(self, world, losses):
        while True:
            if self._preempted and not self._drain_announced:
                # the drain rides the ordinary re-form: announce the
                # leave so the master bumps now, then keep stepping until
                # every member sees the bump at the same step
                self._drain_announced = True
                self._drain_deadline = time.time() + self._epoch_poll_secs
                try:
                    self._stub.leave_comm_world(self._worker_id)
                except Exception:
                    logger.warning(
                        "drain announcement failed; will hard-leave",
                        exc_info=True,
                    )
            if (
                self._drain_announced
                and self._drain_deadline
                and time.time() > self._drain_deadline
            ):
                # the announcement never landed: leave anyway; the
                # survivors take the broken-collective path
                return self._settle_and_leave("preempted")
            if (
                self._job_type == JobType.TRAINING_WITH_EVALUATION
                and not self.trainer.is_sharded
            ):
                # the replicated plane scores a local snapshot whenever a
                # round is queued; the peers wait in their next step (a
                # sharded world evaluates in-plane, below)
                self._evaluate_only()
            w = self._poll_world(awaiting=False)
            if self._drain_announced and w["epoch"] != world.epoch:
                # the bump is visible: the pause lands within one step
                self._drain_deadline = 0.0
            epoch_hint = w["epoch"]
            if self._master_boots != self._world_master_boots:
                # a relaunched master does not hold this world: every
                # rank pauses at this step and forms one with it
                epoch_hint = max(epoch_hint, world.epoch + 1)
            batch = self._next_batch()
            try:
                if batch is None:
                    loss, n_active, count = self.trainer.train_step(
                        None, None, self._minibatch_size,
                        epoch_hint=epoch_hint, pending=not self._drained,
                    )
                else:
                    loss, n_active, count = self.trainer.train_step(
                        batch[0], batch[1], self._minibatch_size,
                        epoch_hint=epoch_hint, pending=not self._drained,
                    )
                    losses.append(loss)
            except Exception as err:
                logger.warning(
                    "collective step failed in world %d: %s",
                    world.epoch,
                    err,
                )
                self._timeline(
                    "world_broken", epoch=world.epoch, error=str(err)[:200]
                )
                # the unapplied batch fail-reports: its task requeues and
                # its records are read again by whoever takes it
                if batch is not None:
                    self._unreported.append(
                        int(_first_leaf(batch[1]).shape[0])
                    )
                self._settle_and_leave("reform", ok=False)
                if not self._await_epoch_bump(world.epoch):
                    raise
                return "reform"
            if batch is not None:
                self._unreported.append(count)
                self._telemetry.on_batch(count)
            self._flush_unreported()
            self._alarm_on_embedding_overflow()
            if self._timeline.enabled:
                self._timeline(
                    "step", epoch=world.epoch, version=self.trainer.version,
                    live=n_active, rows=count,
                    host_step=self.trainer.host_step,
                    split=self.trainer.step_times,
                    **({"staging": self.trainer.last_staging}
                       if self.trainer.is_sharded else {}),
                    **({"routing": self.trainer.last_routing}
                       if self.trainer.last_routing else {}),
                    **({"peak_mib": self._peak_mib()}
                       if self.trainer.is_sharded else {}),
                )
            if self.trainer.epoch_consensus > world.epoch:
                # every member reads this consensus at this same step:
                # the whole world pauses together
                logger.info(
                    "epoch bump %d -> %d; pausing",
                    world.epoch,
                    self.trainer.epoch_consensus,
                )
                return self._settle_and_leave("reform")
            self._save_ckpt_if_due(world)
            if (
                self.trainer.is_sharded
                and self._job_type == JobType.TRAINING_WITH_EVALUATION
            ):
                # in-plane evaluation of the version just reached (and
                # checkpointed): a lockstep protocol, so every rank runs
                # it here, at the same step of the world
                try:
                    self._collective_evaluate()
                except Exception as err:
                    logger.warning(
                        "collective evaluation failed in world %d: %s",
                        world.epoch, err,
                    )
                    self._settle_and_leave("reform", ok=False)
                    if not self._await_epoch_bump(world.epoch):
                        raise
                    return "reform"
            if n_active == 0:
                if self.trainer.is_sharded:
                    # land this rank's parts now: the export (one rank,
                    # in _finalize) needs every rank's manifest
                    self._save_ckpt_if_newer()
                # global quiescence: every rank sees it at the same step,
                # and the world ends at the first such step at which no
                # member's task stream is open. A rank whose stream ended
                # steps on with no data while a peer still waits on the
                # master (the reference ends each rank on its own stream:
                # the first to end leaves, and its peer's next collective
                # breaks into a world of one)
                if not self.trainer.pending_consensus:
                    return "done"
                time.sleep(0.2)

    def _peak_mib(self):
        """This process's peak card memory so far (MiB), None on the
        CPU."""
        if self._device.type != "cuda":
            return None
        import torch

        return torch.cuda.max_memory_allocated(self._device) / 2 ** 20

    def _split_bytes(self):
        """The bytes of this rank's parts of the split parameters (0 on
        the replicated plane)."""
        params = self.trainer.train_state.params
        return sum(params[n].numel() * params[n].element_size()
                   for n in self.trainer.param_specs)

    def _alarm_on_embedding_overflow(self):
        """Warn when the tables' routed lookups overflowed their buckets
        (ids trained on zero rows) since the last warning; the counts
        are the trainer's settled ones, a host read that waits for
        nothing."""
        if self.trainer._module is None:
            return
        from elasticdl_tpu_torch.nn.hbm_embedding import a2a_overflow_total

        total = a2a_overflow_total(self.trainer._module)
        if total and total > self._overflow_alarmed:
            logger.warning(
                "embedding a2a capacity overflow: %d ids have read zero "
                "rows since job start (+%d since last sync) — increase "
                "HbmEmbedding capacity (or leave it None for the exact "
                "worst case)",
                total,
                total - self._overflow_alarmed,
            )
            self._overflow_alarmed = total

    # -- checkpoints and the end --------------------------------------------

    def _save_ckpt_if_due(self, world):
        """A checkpoint once the version is at least
        ``checkpoint_steps`` past the last one (the versions agree
        across ranks): rank 0 alone on the replicated plane (it holds a
        full replica), every rank its parts on the sharded plane."""
        if (
            self._ckpt is None
            or (world.process_id != 0 and not self.trainer.is_sharded)
            or not self._ckpt.is_enabled()
        ):
            return
        if self.trainer.version - self._last_ckpt_version >= self._ckpt.steps:
            self._save_ckpt()

    def _save_ckpt_if_newer(self):
        """Checkpoint the state if its version moved past the last save
        (the sharded plane's pause, quiescence and end)."""
        if (
            self._ckpt is not None
            and self._ckpt.is_enabled()
            and self.trainer.has_state
            and self.trainer.version > self._last_ckpt_version
        ):
            self._save_ckpt()

    def _save_ckpt(self):
        version = self.trainer.version
        t0 = time.perf_counter()
        self._ckpt.save(
            self.trainer.train_state, version,
            parts=(self.trainer.checkpoint_parts()
                   if self.trainer.is_sharded else None),
        )
        snapshot_s = time.perf_counter() - t0
        if self._timeline.enabled:
            self._timeline(
                "checkpoint", version=version, snapshot_s=snapshot_s,
                digest=self.trainer.digest(),
            )
        self._last_ckpt_version = version

    def _drain_ckpt(self):
        """Land the queued checkpoint writes; an IO error is logged
        (teardown must not mask the original failure)."""
        if self._ckpt is None:
            return
        try:
            self._ckpt.close()
        except Exception:
            logger.warning(
                "asynchronous checkpoint writes failed at teardown",
                exc_info=True,
            )

    def _finalize(self):
        sharded = self.trainer.is_sharded and self.trainer.has_state
        if sharded and not self._preempted:
            # every rank lands its final parts: the export (one rank)
            # and a resume see the finished state
            self._save_ckpt_if_newer()
        self._drain_ckpt()
        if self._ckpt is not None and self._ckpt.write_seconds:
            # the background writes' seconds, by version
            self._timeline(
                "checkpoint_writes", write_s=self._ckpt.write_seconds
            )
        if not self._preempted:
            # a drained worker takes no more work (the last rounds, the
            # SAVE_MODEL task)
            if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                try:
                    if sharded:
                        # the world is still formed, and every rank
                        # enters here from the same quiescent step
                        self._collective_evaluate(final=True)
                    else:
                        self._evaluate_only(final=True)
                except Exception:
                    logger.warning("final evaluation round failed",
                                   exc_info=True)
            self._process_save_model_task_if_needed()
        profiling.maybe_stop_trace()
        if self._timeline.enabled and self.trainer.has_state:
            from elasticdl_tpu_torch.nn.hbm_embedding import (
                a2a_overflow_total,
            )

            self._timeline(
                "final", version=self.trainer.version,
                digest=self.trainer.digest(), launches=_flash_launches(),
                fetched_ahead=self._task_data_service.fetched_ahead,
                peak_mib=self._peak_mib(),
                overflow=a2a_overflow_total(self.trainer._module),
            )
        if distributed.current_spec() is not None:
            distributed.leave_world()

    def _process_save_model_task_if_needed(self):
        """Export the trained state for a parked SAVE_MODEL task, with the
        serving member traced on this worker's card from one
        prediction-mode batch of the task's records; a worker that never
        trained fail-reports it, for a worker with state."""
        task, dataset = (
            self._task_data_service.get_save_model_task_and_dataset()
        )
        if task is None:
            return
        serving_ts = self.trainer.train_state
        if self.trainer.is_sharded:
            host_ts = self._assemble_sharded_export()
            if host_ts is None:
                self.report_task_result(
                    task.task_id,
                    err_msg="no complete sharded checkpoint to export",
                )
                return
            # the member is traced from the whole model on this card:
            # the host twin on the collective plane
            from elasticdl_tpu_torch.parallel.trainer import (
                place_module,
                to_device,
            )

            if self._host_model_factory is not None:
                self._model = self._host_model_factory()
            place_module(self._model, self._device)
            serving_ts = TrainState(
                params=to_device(host_ts.params, self._device),
                state=to_device(host_ts.state, self._device),
                opt_state=None, version=host_ts.version,
            )
        else:
            host_ts = self.trainer.snapshot()
        if host_ts is None:
            self.report_task_result(
                task.task_id, err_msg="no local train state to export"
            )
            return
        saved_model_path = os.path.join(
            task.extended_config.get(SaveModelConfig.SAVED_MODEL_PATH),
            str(int(time.time())),
        )
        from elasticdl_tpu_torch.common.export import (
            example_batch_for_export,
            export_train_state,
        )

        example = example_batch_for_export(
            dataset,
            self._dataset_fn,
            self._task_data_service.data_reader.metadata,
            self._minibatch_size,
            Mode.PREDICTION,
        )
        t0 = time.perf_counter()
        manifest = export_train_state(
            saved_model_path, host_ts, model=self._model,
            metadata=self._export_meta, example_features=example,
            serving_ts=serving_ts,
        )
        self._timeline(
            "export", seconds=time.perf_counter() - t0,
            serving_member=bool(manifest["artifacts"]["torch_serving_fn"]),
        )
        logger.info("Exported model to %s", saved_model_path)
        self.report_task_result(task.task_id, err_msg="")

    def _assemble_sharded_export(self):
        """The whole model from the newest complete sharded checkpoint, a
        host ``TrainState`` (params, state, version), or None. The final
        checkpoint of a peer may still be landing: the newest directory
        is retried for up to 10 s before the previous complete one is
        taken."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            load_sharded_to_host,
            split_train_state_leaves,
        )

        names = [n for n, _ in self._model.named_parameters()]

        def load(directory):
            _, leaves = load_sharded_to_host(directory)
            params, state, _, version = split_train_state_leaves(
                leaves, names
            )
            return TrainState(params=params, state=state, opt_state=None,
                              version=version)

        dirs = self._ckpt_dirs_newest_first()
        if not dirs:
            return None
        last_err = None
        for _ in range(10):
            try:
                return load(dirs[0])
            except Exception as e:  # noqa: BLE001 - retried, then logged
                last_err = e
                time.sleep(1.0)
        logger.warning(
            "newest checkpoint %s never completed (%s); exporting the "
            "previous one", dirs[0], last_err,
        )
        for older in dirs[1:]:
            try:
                return load(older)
            except Exception:
                logger.debug("export skipped torn checkpoint %s", older,
                             exc_info=True)
        return None
