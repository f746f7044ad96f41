"""Multi-process elastic data-parallel training, the counterpart of
``elasticdl_tpu/parallel/elastic.py`` on its replicated plane: one
worker process is one device of the reference's mesh, the parameters are
replicated in every process, and each step's gradient exchange is a
collective of the ``torch.distributed`` world that
``parallel/distributed.py`` forms per membership epoch.

The reference's three problems, and the port's answers:

- **Lockstep with independent task queues.** Each process pulls its own
  tasks, so processes run out of data at different times, yet every
  process must join every collective. The step is weighted: each rank
  carries a weight ``w`` (its true rows over the padded rows, 0 without
  data), its gradient counts ``w / max(Σw, 1e-6)``, and the step returns
  the live count ``Σ(w > 0)``. A rank without data feeds its previous
  batch at weight 0 and keeps stepping until the live count is 0.
- **State continuity across epochs.** The state stays on the device while
  the world re-forms; :meth:`ElasticDPTrainer.establish` then broadcasts
  it from the lowest rank that holds one (rank 0, the longest-lived
  survivor): parameters, model state (BatchNorm statistics), the
  optimizer's state (SGD's momentum) and the version. A joiner offers
  nothing and receives them.
- **Failure visibility.** A peer's death fails the step's collective on
  every survivor; the worker sees :class:`WorldBroken`. The state is
  updated only after the collective returns, so the pre-step state is
  intact for the re-form.

One step carries its whole exchange in **one flattened SUM all-reduce**
(each gradient times ``w``, the loss times ``w``, each float state leaf
times ``w``, then ``w`` and ``w > 0``) plus one MAX of the members'
polled membership epochs and of whether their task streams are still
open; the sums are divided by ``max(Σw, 1e-6)``
afterwards, which equals the reference's scaling of each contribution by
``w / Σw``. Integer state leaves keep the rank's own values. With no live
rank the step changes nothing: no update, no version.

**The pjit dense plane** (a configuration whose ``param_shardings``
split the dense model over a ``model`` axis: the LM's tensor
parallelism). A ``distributed_builder`` hook (``mesh -> (module,
param_specs)``) makes the trainer sharded. Each establish lays the world
out as ``{"data": D, "model": T}`` (the layout solver's pick,
``parallel/layout_solver.py``, from a model profile that every process
derives alike; the zoo's ``mesh_axes`` before a profile exists), builds
this rank's part of the model on that ``WorldMesh``, refuses what the
reference refuses (``accum_steps > 1``, an optimizer that couples
leaves, split dims that do not divide the world, the replica plane on a
leaf split past dim 0; the messages name the reference's flax paths),
and restores the newest checkpoint whose parts every rank can read
(each rank reads only its own parts, whatever split wrote them),
falling back through older ones, else re-initializes from the seed. A
dead rank's parts are gone with it, so the sharded state is never
broadcast: the workers checkpoint at every pause, and every re-form
restores.

The weighted step there is the reference's ``make_pjit_train_step`` made
explicit. Each process's rows are one block of the global batch; the
``model`` ranks of a data group gather their blocks (and weights) and
run the tensor-parallel forward on the group's rows, so each block's
loss (vocabulary-parallel cross entropy, ``parallel/spmd.py``) is
weighted by its process's ``w`` inside the differentiated function.
The gradients, the weighted loss, ``w`` and ``w > 0`` then ride one flat
SUM over ``data`` (never over ``model``: a split parameter's gradient is
its part's, a replicated one's is already whole and bitwise the same on
every ``model`` rank), the epochs one MAX over the world, and the sums
are divided by ``max(Σw, 1e-6)``. With no live process the state and
the version stand still. Evaluation is in-plane: every rank takes part
in every tensor-parallel forward (:meth:`eval_step`), ranks without
work feeding their last rows until :meth:`eval_have_consensus` reads 0.

**The collective plane** (a configuration whose ``param_shardings``
split parameters over the world's ``data`` axis and not over ``model``:
deepfm_edl's vocabulary-split HBM tables, whose zoo builds the model with
``build_collective_model``). The world's mesh is ``{"data": n}`` (or the
zoo's ``mesh_axes``); the layout solver stays on the pjit plane. A spec
marked :class:`~elasticdl_tpu_torch.parallel.mesh.PadDim0` whose dim 0
the world does not divide is zero-padded up to the next multiple
(``padded_dim0``; the co-sharded optimizer slots pad with it), and the
logical rows are recorded (:meth:`ElasticDPTrainer.logical_dim0_by_path`)
for the checkpoints. The step is the reference's
``make_elastic_train_step`` made explicit: each rank's loss on its own
rows is scaled by its weight ``w`` inside the differentiated function,
so the row gradients that the lookups' ``all_to_all`` backward routes to
their owners carry their source rank's weight; a table split over
``data`` is then not reduced (its routed gradient is already the sum),
while the replicated leaves, the weighted loss, the weighted float
state, ``w``, ``w > 0`` and the layers' overflow counts ride one flat SUM
over the world and the epochs one MAX; the sums and the tables'
gradients are divided by ``max(Σw, 1e-6)`` after. A rank without data
joins every lookup at weight 0; with no live rank nothing moves.
``padded_dim0`` and ``dim0_shard_count``, the reference's, are in
``parallel/mesh.py``.

Not ported (each raising ``NotImplementedError`` where it would be
reached): the in-memory replica plane (``ShardMirror``, the mirror
refresh and assembly; ROADMAP A2), a split leaf that must also be
reduced over another axis (the pipeline's stage stacks over ``pipe``,
A9.3), the same-backend relayout (one process holding several devices,
A9.2.3) and the compile plane (A9.2.2). Every step ends in a host read
of its live count: no deferred loss fetches.
"""

import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.sharded_checkpoint import (
    split_train_state_leaves,
    train_state_leaves,
)
from elasticdl_tpu_torch.data.dataset import tree_map
from elasticdl_tpu_torch.parallel import distributed, layout_solver
from elasticdl_tpu_torch.parallel.mesh import PadDim0, padded_dim0, spec_axes
from elasticdl_tpu_torch.parallel.trainer import (
    AllReduceTrainer,
    place_module,
)
from elasticdl_tpu_torch.training.precision import get_policy
from elasticdl_tpu_torch.training.step import (
    TrainState,
    _apply,
    _loss_and_grads,
    accumulate_gradients,
    aux_loss_total,
    fold_in,
    make_remat_forward,
)
from elasticdl_tpu_torch.utils import profiling

_WAIT_POLL_S = 0.001  # collective completion poll
_ABORT_CHECK_S = 1.0  # how often a waiting collective asks abort_check

# the establish pause, scraped through /metrics: one observation per
# establish()
_RESIZE_PAUSE = profiling.metrics.histogram(
    "edl_resize_pause_seconds",
    "establish() wall seconds, world re-form through step-fn acquire",
    labels=("compile_phase",),
)


def _pad_rows(x, rows):
    """``x`` cut or padded to ``rows`` rows, the last row repeated."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    short = rows - x.shape[0]
    if short <= 0:
        return x[:rows]
    return torch.cat([x, x[-1:].expand(short, *x.shape[1:])])


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_digest(ts):
    """A bitwise fingerprint of the parameters and the model state,
    computed where they live: per tensor, in name order, the int64 sums
    (wrapping, so any summation order gives the same value) of its words
    and of its words times their position mod 65521, plus one; the
    sums, names and dtypes are then hashed. Equal bits give equal
    digests on any device; one flipped word changes them."""
    h = hashlib.sha256()
    sums = []
    for part in (ts.params, ts.state):
        for name in sorted(part):
            t = part[name].detach().contiguous().reshape(-1)
            words = t.view(_WORDS[t.element_size()]).to(torch.int64)
            pos = torch.arange(
                words.numel(), device=t.device, dtype=torch.int64
            ) % 65521 + 1
            sums.append(torch.stack([words.sum(), (words * pos).sum()]))
            h.update(("%s:%s;" % (name, t.dtype)).encode("utf-8"))
    if sums:
        h.update(repr(torch.stack(sums).cpu().tolist()).encode("utf-8"))
    return h.hexdigest()


# -- the sharded plane's specs, profile and refusals ---------------------------


def collect_sharded_paths(param_specs):
    """A nested ``param_specs`` dict -> {key path tuple: spec}; a
    :class:`PadDim0` marker is unwrapped (:func:`collect_paddable_paths`
    names the paths that carried one)."""
    paths = {}

    def walk(tree, prefix):
        if hasattr(tree, "items"):
            for key, sub in tree.items():
                walk(sub, prefix + (key,))
        else:
            paths[prefix] = tree.spec if isinstance(tree, PadDim0) else tree

    walk(param_specs or {}, ())
    return paths


def collect_paddable_paths(param_specs):
    """The key paths whose spec was marked :class:`PadDim0`."""
    paddable = set()

    def walk(tree, prefix):
        if hasattr(tree, "items"):
            for key, sub in tree.items():
                walk(sub, prefix + (key,))
        elif isinstance(tree, PadDim0):
            paddable.add(prefix)

    walk(param_specs or {}, ())
    return paddable


def spec_path_matches(spec_path, leaf_names):
    """True when a collected spec path claims a leaf's key path: by
    suffix (so an optimizer slot under its parameter's path matches),
    or, for a path ending in ``"**"``, when its prefix runs anywhere in
    the leaf's path."""
    names = tuple(leaf_names)
    if spec_path and spec_path[-1] == "**":
        prefix = tuple(spec_path[:-1])
        span = len(prefix)
        return not prefix or any(
            names[i:i + span] == prefix
            for i in range(len(names) - span + 1)
        )
    return names[-len(spec_path):] == tuple(spec_path)


def specs_use_axis(sharded_paths, axis):
    """True when any collected spec splits over ``axis``: the pjit dense
    plane is ``specs_use_axis(paths, "model")``."""
    return any(
        axis in spec_axes(spec) for spec in (sharded_paths or {}).values()
    )


def _path_spec(name, sharded_paths):
    """The spec of the ``state_dict`` key ``name``: the longest key path
    it ends with (a suffix spec covers every block's parameter)."""
    parts = tuple(name.split("."))
    best = None
    for path, spec in sharded_paths.items():
        if parts[-len(path):] == tuple(path) and (
            best is None or len(path) > len(best[0])
        ):
            best = (path, spec)
    return best[1] if best is not None else None


# the torch optimizer's per-parameter slots under optax's names
_OPTAX_SLOTS = {
    "exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace",
}


def _optimizer_slots(optimizer):
    """(slots of a parameter's shape, whether a scalar step count) of the
    torch optimizer the factory ``optimizer`` makes, by stepping it once
    on a two-element parameter."""
    p = torch.zeros(2, requires_grad=True)
    opt = optimizer([p])
    p.grad = torch.zeros(2)
    opt.step()
    state = opt.state[p]
    shaped = sorted(k for k, v in state.items()
                    if isinstance(v, torch.Tensor) and v.shape == p.shape)
    counts = any(isinstance(v, torch.Tensor) and v.dim() == 0
                 for v in state.values())
    return shaped, counts


def reference_state_leaves(module, param_specs, optimizer, pad_axes=None):
    """The train state the reference's pjit plane holds for ``module``
    (the whole model, on any device: only shapes are read) as ``[(path,
    shape, item size, spec)]``, under the reference's flax paths and
    layouts (``common/convert``): the parameters, optax's moments in
    their parameter's layout and spec (``mu``/``nu``, ``trace``), one
    int32 ``count`` for a step-counting optimizer, the model state and
    the int32 ``version``: the reference's ``build_state_specs`` over its
    abstract state, in one list. ``param_specs`` is the zoo's nested
    ``param_shardings`` answer. With ``pad_axes`` ({axis: size}, a
    world's mesh) a :class:`PadDim0` leaf's dim 0 is that world's padded
    rows (the reference's ``_pad_abstract``)."""
    from elasticdl_tpu_torch.common import convert

    paths = collect_sharded_paths(param_specs)
    paddable = collect_paddable_paths(param_specs)
    params = dict(module.named_parameters())
    names = convert.reference_layouts(params)
    heads = (getattr(module, "num_heads", None),
             getattr(module, "head_dim", None))
    meta = {k: torch.empty(p.shape, device="meta") for k, p in params.items()}
    shapes = {k: tuple(v.shape) for k, v in convert.to_named(
        meta, *heads, keep_device=True).items()}
    leaves, slot_leaves = [], []
    shaped, counts = _optimizer_slots(optimizer)
    for key, p in params.items():
        ref, layout = names[key]
        shape = shapes[ref]
        spec = convert.to_reference_spec(
            _path_spec(key, paths), layout, p.dim()
        )
        if pad_axes and spec and any(
            spec_path_matches(sp, key.split(".")) for sp in paddable
        ):
            shape = (padded_dim0(shape[0], spec, pad_axes),) + shape[1:]
        size = p.element_size()
        leaves.append(("params/" + ref, shape, size, spec))
        for slot in shaped:
            slot_leaves.append((
                "opt_state/%s/%s" % (_OPTAX_SLOTS.get(slot, slot), ref),
                shape, size, spec,
            ))
    if counts:
        leaves.append(("opt_state/count", (), 4, ()))
    leaves += slot_leaves
    buffers = {k: torch.empty(b.shape, dtype=b.dtype, device="meta")
               for k, b in module.named_buffers()}
    for ref, b in (convert.to_named(buffers, keep_device=True).items()
                   if buffers else ()):
        leaves.append(("state/" + ref, tuple(b.shape), b.element_size(), ()))
    leaves.append(("version", (), 4, ()))
    return leaves


def derive_model_profile(leaves):
    """:class:`layout_solver.ModelProfile` of :func:`reference_state_
    leaves`, the reference's ``derive_model_profile``: bytes of the
    leaves split over ``model`` and of the rest, activation bytes per
    row 4 x the sum of the split dims, 6 x the parameter count flops per
    row, and the TP degrees every split dim admits. A function of the
    model's structure alone, so every process derives the same."""
    from elasticdl_tpu_torch.parallel.sharding import tp_degree_candidates

    replicated_bytes = tp_bytes = 0.0
    model_dims = []
    for _, shape, itemsize, spec in leaves:
        nbytes = float(np.prod(shape)) * itemsize
        axes = tuple(spec or ())
        if "model" in axes:
            tp_bytes += nbytes
            model_dims.append(int(shape[axes.index("model")]))
        else:
            replicated_bytes += nbytes
    param_count = sum(
        float(np.prod(shape)) for path, shape, _, _ in leaves
        if path.startswith("params/")
    )
    return layout_solver.ModelProfile(
        replicated_bytes=replicated_bytes,
        tp_bytes=tp_bytes,
        activation_bytes_per_row=4.0 * float(sum(model_dims)),
        flops_per_row=6.0 * param_count,
        tp_degrees=tp_degree_candidates(model_dims),
    )


def optimizer_couples_leaves(optimizer):
    """Behavioural probe: does one leaf's update depend on another
    leaf's gradient? Two leaves of ones take gradients (0.5, 0.5), then
    (0.5, 64.0), each from a fresh optimizer; leaf a's update must not
    move. A cross-leaf transform (a global-norm clip) folds each rank's
    different parts into one scale and desynchronizes the replicated
    parameters. An optimizer the probe cannot drive passes."""

    def update_of_a(b_grad):
        a = torch.ones(4, requires_grad=True)
        b = torch.ones(4, requires_grad=True)
        opt = optimizer([a, b])
        a.grad = torch.full((4,), 0.5)
        b.grad = torch.full((4,), b_grad)
        opt.step()
        return a.detach() - 1.0

    try:
        u1, u2 = update_of_a(0.5), update_of_a(64.0)
    except Exception:
        logger.warning(
            "optimizer cross-leaf probe failed; skipping the sharded-"
            "plane coupling check",
            exc_info=True,
        )
        return False
    return not np.allclose(u1.numpy(), u2.numpy(), rtol=1e-6, atol=1e-8)


def _checkpoint_version(directory):
    """N of a ``ckpt_v{N}`` directory path (0 for any other name)."""
    import re

    m = re.match(r"ckpt_v(\d+)$", os.path.basename(str(directory)))
    return int(m.group(1)) if m else 0


def _staging_since(before):
    """``collectives.staging`` since the snapshot ``before``: the totals
    (``staged_bytes``, ``copy_s``, ``exchange_s``) and ``by_kind``
    ({kind: its exchanges, bytes and seconds})."""
    from elasticdl_tpu_torch.parallel import collectives

    after = collectives.staging.snapshot()
    by_kind = {
        kind: {key: v - before.get(kind, {}).get(key, 0)
               for key, v in stats.items()}
        for kind, stats in after.items()
    }
    by_kind = {kind: v for kind, v in by_kind.items() if v["exchanges"]}
    totals = {
        key: sum(v[key] for v in by_kind.values())
        for key in ("staged_bytes", "copy_s", "exchange_s")
    }
    return dict(totals, by_kind=by_kind)


class ElasticDPTrainer(AllReduceTrainer):
    """One process's handle on the elastic plane: replicated, or with a
    ``distributed_builder`` the pjit dense plane (see the module's
    text)."""

    def __init__(
        self,
        module,
        loss_fn,
        optimizer,
        seed=0,
        precision=None,
        accum_steps=1,
        remat=False,
        device="cuda",
        distributed_builder=None,
        restore_provider=None,
        mesh_axes_fn=None,
        layout_planner=None,
    ):
        """``distributed_builder``: ``mesh -> (module, param_specs)``,
        the zoo's hooks over a mesh (``mesh=None``: the whole model and
        the probe's specs); the module may come as a zero-argument
        callable, built once the establish checks have passed.
        ``restore_provider``: ``() -> [checkpoint directory, newest
        first]``, what a sharded establish restores from.
        ``mesh_axes_fn``: ``n -> {axis: size} | None``, the zoo's
        ``mesh_axes``; ``layout_planner`` (a :class:`layout_solver.
        LayoutPlanner`) re-solves the layout of each world and falls
        back to ``mesh_axes_fn`` before a profile exists."""
        super().__init__(
            module, loss_fn, optimizer, seed=seed, accum_steps=accum_steps,
            precision=precision, remat=remat, device=device,
        )
        self._loss_fn = loss_fn
        self._accum_steps = max(1, accum_steps)
        self._pol = get_policy(precision)
        self._remat = remat
        self._forward = make_remat_forward(module, remat)
        self._builder = distributed_builder
        self._planner = layout_planner
        if layout_planner is not None:
            if layout_planner.fallback_axes_fn is None:
                layout_planner.fallback_axes_fn = mesh_axes_fn
            mesh_axes_fn = layout_planner.axes_for
        self._mesh_axes_fn = mesh_axes_fn
        self.restore_provider = restore_provider
        self._sharded_paths = {}
        self._logical_rows = {}  # {parameter name: rows} of padded ones
        self._pjit_dense = False
        self._coupling_checked = False
        self._whole = None  # (whole model on meta, probe specs)
        self._mesh_shape = None  # {axis: size} of this world's mesh
        # the in-memory replica plane's cadence (0: off); the worker
        # sets it from --replica_refresh_steps
        self.mirror_steps = 0
        # the worker's fixed minibatch (the layout record's micro-batch
        # when no plan names one)
        self.default_minibatch_size = None
        # host staging of the last sharded step's exchanges (collectives
        # .staging: bytes, copy and exchange seconds)
        self.last_staging = {}
        # the collective plane's last step: ids its lookups routed (the
        # unique ones with dedup) and their occurrences, on this rank
        self.last_routing = {}
        self._spec = None
        self.backend = None
        self._last_local = None  # (features, labels) for weight-0 steps
        self.epoch_consensus = None  # newest epoch any member has seen
        # whether any member's task stream was still open at the step
        self.pending_consensus = False
        # the worker sets it to a "did one of my peers die?" probe; a
        # collective waiting on a dead peer then gives up
        self.abort_check = None
        # (host step, its timeline points) of the last step and of the
        # one before it, whose end the stream has passed
        self._marks = self._timed = None
        # the last establish's seconds: the world's formation, the
        # source rank's choice, and that with the state's broadcast
        self.establish_times = {}

    @property
    def has_state(self):
        return self._ts is not None

    @property
    def is_sharded(self):
        """True when the parameters split over the world's mesh (a
        ``distributed_builder`` was given)."""
        return bool(self._sharded_paths) or self._builder is not None

    @property
    def mesh_shape(self):
        """{axis: size} of this world's mesh (None before a sharded
        establish)."""
        return dict(self._mesh_shape) if self._mesh_shape else None

    # -- forming a world ----------------------------------------------------

    def _small(self, values, dtype):
        """A control tensor on the device the backend exchanges."""
        device = self._device if self.backend == "nccl" else "cpu"
        return torch.tensor(values, dtype=dtype, device=device)

    def _wait(self, works):
        """Wait for collective ``works``, asking ``abort_check`` now and
        then: a peer that died mid-collective raises WorldBroken."""
        next_check = time.monotonic() + _ABORT_CHECK_S
        try:
            while not all(w.is_completed() for w in works):
                if time.monotonic() >= next_check:
                    next_check = time.monotonic() + _ABORT_CHECK_S
                    if self.abort_check is not None and self.abort_check():
                        raise distributed.WorldBroken(
                            "a member of world epoch %d died mid-collective"
                            % self._spec.epoch
                        )
                time.sleep(_WAIT_POLL_S)
            for w in works:
                w.wait()
        except distributed.WorldBroken:
            raise
        except Exception as e:
            raise distributed.WorldBroken(
                "collective of world epoch %d failed: %s"
                % (self._spec.epoch, e)
            ) from e

    def _all_reduce(self, tensor, op):
        self._wait([dist.all_reduce(tensor, op=op, async_op=True)])

    def _replicated_source_rank(self):
        """Lowest rank holding state (the broadcast source), or -1 when
        nobody does."""
        mine = 1 if self._ts is not None else 0
        if self._spec.num_processes <= 1:
            return 0 if mine else -1
        flags = self._small([0] * self._spec.num_processes, torch.int64)
        flags[self._spec.process_id] = mine
        self._all_reduce(flags, dist.ReduceOp.SUM)
        ranks = [r for r, has in enumerate(flags.tolist()) if has]
        return min(ranks) if ranks else -1

    def _empty_state(self):
        """A train state with this model's structure and placement but no
        values worth keeping: a joiner's stand-in, overwritten by the
        broadcast."""
        place_module(self._module, self._device)
        return TrainState.create(
            dict(self._module.named_parameters()),
            dict(self._module.named_buffers()),
            self._optimizer,
        )

    def _broadcast_state(self, source):
        """Every rank adopts ``source``'s train state: the leaf list goes
        first (a joiner's optimizer has no momentum yet), then one flat
        buffer per dtype."""
        if self._spec.num_processes <= 1:
            return
        me = self._spec.process_id
        leaves = train_state_leaves(self._ts)
        manifest = [None]
        if me == source:
            manifest[0] = [
                (path, tuple(t.shape), t.dtype) for path, t in leaves.items()
            ]
        dist.broadcast_object_list(manifest, src=source)
        manifest = manifest[0]
        by_dtype = {}
        for path, shape, dtype in manifest:
            by_dtype.setdefault(dtype, []).append((path, shape))
        received = {}
        for dtype, entries in by_dtype.items():
            if me == source:
                flat = torch.cat([
                    leaves[path].detach().reshape(-1).to(self._device)
                    for path, _ in entries
                ])
            else:
                flat = torch.empty(
                    sum(int(torch.Size(s).numel()) for _, s in entries),
                    dtype=dtype, device=self._device,
                )
            self._wait([dist.broadcast(flat, src=source, async_op=True)])
            off = 0
            for path, shape in entries:
                n = int(torch.Size(shape).numel())
                received[path] = flat[off:off + n].reshape(shape).clone()
                off += n
        if me == source:
            return
        params, state, opt, version = split_train_state_leaves(
            received, list(self._ts.params)
        )
        groups = self._ts.opt_state.state_dict()["param_groups"]
        self._adopt(
            {n: params[n] for n in self._ts.params},
            state,
            {"state": opt, "param_groups": groups},
            version,
        )

    def establish(self, spec, example_batch=None):
        """Join ``spec``'s world and place the train state in it.

        Replicated: adopt the state of the world's lowest rank that has
        one. When nobody has state (the first world), every rank
        initializes from the trainer's seed, identically, and rank 0's
        copy is broadcast all the same. Sharded: lay the world's mesh
        out, build this rank's part of the model and restore (see
        :meth:`_establish_sharded`). Each establish emits the
        ``resize_begin`` and ``resize_end`` events (on the sharded
        plane with the old and new ``{"dp", "tp", "microbatch"}``) and
        observes ``edl_resize_pause_seconds`` (its ``compile_phase``
        label reads ``none``: nothing is compiled here)."""
        t0 = time.perf_counter()
        old_layout = None
        if self.is_sharded:
            old_layout = self._layout_fields()
            # the planner answers from the profile on every process,
            # from the very first establish on (its optimizer probe is
            # the process's first optimizer: torch imports its compile
            # stack there)
            self._maybe_derive_profile()
        t_profile = time.perf_counter()
        profiling.events.emit(
            "resize_begin",
            epoch=spec.epoch,
            rank=spec.process_id,
            world_size=spec.num_processes,
            **({"layout": old_layout} if self.is_sharded else {}),
        )
        self.backend = distributed.ensure_world(spec, self._device)
        self._spec = spec
        t_world = time.perf_counter()
        if self.is_sharded:
            source = -1
            self._establish_sharded(example_batch)
            self.establish_times = dict(
                self.establish_times, profile_s=t_profile - t0,
                world_s=t_world - t_profile,
                establish_s=time.perf_counter() - t0,
            )
        else:
            source = self._replicated_source_rank()
            t_source = time.perf_counter()
            if source < 0:
                if example_batch is None:
                    raise ValueError("the first establish() needs a batch")
                self.init_from_batch(example_batch)
                source = 0
            elif self._ts is None:
                self._ts = self._empty_state()
            self._broadcast_state(source)
            # source_s: the first collective of the world, so it holds
            # the wait for the slowest member to arrive
            self.establish_times = {
                "world_s": t_world - t0,
                "source_s": t_source - t_world,
                "broadcast_s": time.perf_counter() - t_world,
            }
        logger.info(
            "elastic plane established: epoch=%d rank=%d/%d backend=%s "
            "%s version=%d (%s)",
            spec.epoch,
            spec.process_id,
            spec.num_processes,
            self.backend,
            "mesh=%s" % self._mesh_shape if self.is_sharded
            else "source=%d" % source,
            self.version,
            ", ".join("%s %.2fs" % (k, v) for k, v in
                      self.establish_times.items()
                      if isinstance(v, float)),
        )
        profiling.events.emit(
            "resize_end",
            epoch=spec.epoch,
            rank=spec.process_id,
            world_size=spec.num_processes,
            backend=self.backend,
            compile_phase="none",
            **({"resize_layout": {"old": old_layout,
                                  "new": self._layout_fields()}}
               if self.is_sharded else {}),
            **{k: round(v, 3) for k, v in self.establish_times.items()
               if isinstance(v, float)},
        )
        _RESIZE_PAUSE.observe(time.perf_counter() - t0, compile_phase="none")

    # -- the sharded establish ----------------------------------------------

    def _layout_fields(self):
        """``{"dp", "tp", "microbatch"}`` of the current mesh (None
        before a sharded establish): the ``resize_layout`` record."""
        if self._mesh_shape is None:
            return None
        mb = None
        if self._planner is not None and self._planner.last_plan is not None:
            mb = int(self._planner.last_plan.layout.microbatch)
        elif self.default_minibatch_size:
            mb = int(self.default_minibatch_size)
        size = int(np.prod(list(self._mesh_shape.values())))
        return {
            "dp": int(self._mesh_shape.get("data", size)),
            "tp": int(self._mesh_shape.get("model", 1)),
            "microbatch": mb,
        }

    def _whole_model(self):
        """(the whole model, built on the meta device, and the probe's
        specs): ``distributed_builder(None)``, made once."""
        if self._whole is None:
            with torch.device("meta"):
                module, specs = self._builder(None)
                if not isinstance(module, torch.nn.Module):
                    module = module()
            self._whole = (module, specs)
        return self._whole

    def _reference_leaves(self, param_specs, pad_axes=None):
        """:func:`reference_state_leaves` of the whole model under
        ``param_specs`` (padded for the mesh ``pad_axes``)."""
        return reference_state_leaves(
            self._whole_model()[0], param_specs, self._optimizer,
            pad_axes=pad_axes,
        )

    def _maybe_derive_profile(self):
        """Feed the layout planner its model profile before the first
        mesh is laid out, from the whole model on the meta device and
        the probe's specs: a function of the model's structure, so a
        fresh joiner solves exactly as a survivor does."""
        planner = self._planner
        if planner is None or planner.profile is not None:
            return
        if self._builder is None:
            return
        try:
            specs = self._whole_model()[1]
            if not specs_use_axis(collect_sharded_paths(specs), "model"):
                return
            planner.set_profile(
                derive_model_profile(self._reference_leaves(specs))
            )
        except Exception:
            logger.warning(
                "layout-planner profile derivation failed; the static "
                "mesh_axes fallback stays in effect",
                exc_info=True,
            )

    def _world_mesh_for(self, n_devices):
        """The mesh shape ({axis: size}, insertion order the axis order)
        of a world of ``n_devices`` processes, one device each: the
        layout hook's answer (the planner's), else one ``data`` axis;
        None when that layout does not cover the world."""
        n_devices = int(n_devices)
        if n_devices <= 0:
            return None
        axes = self._mesh_axes_fn(n_devices) if self._mesh_axes_fn else None
        if not axes:
            return {"data": n_devices}
        axes = {name: int(size) for name, size in axes.items()}
        if int(np.prod(list(axes.values()))) != n_devices:
            return None
        return axes

    def _check_optimizer_coupling(self):
        """Refuse an optimizer that couples leaves on the sharded plane
        (once per trainer), unless ``EDL_ALLOW_CROSS_LEAF_OPT`` is set."""
        if self._coupling_checked or not self._sharded_paths:
            return
        self._coupling_checked = True
        if not optimizer_couples_leaves(self._optimizer):
            return
        if os.environ.get("EDL_ALLOW_CROSS_LEAF_OPT"):
            logger.warning(
                "cross-leaf optimizer on the sharded plane allowed by "
                "EDL_ALLOW_CROSS_LEAF_OPT=1; replicated parameters may "
                "silently desynchronize"
            )
            return
        raise ValueError(
            "the optimizer couples gradients across leaves (e.g. "
            "optax.clip_by_global_norm) but this job shards parameters "
            "across ranks: each rank would fold its own DIFFERENT local "
            "table-shard gradients into the coupled quantity and the "
            "replicated parameters would silently desynchronize. Use "
            "per-leaf transforms instead (e.g. optax.clip / "
            "optax.adaptive_grad_clip), or set "
            "EDL_ALLOW_CROSS_LEAF_OPT=1 if the coupling is known to "
            "exclude the sharded leaves."
        )

    def mirror_enabled(self):
        """True when the replica plane is asked for (a sharded job with
        ``mirror_steps``); the same answer on every rank."""
        return bool(self.mirror_steps) and self.is_sharded

    def _check_shard_divisibility(self, leaves):
        """Every split dim of a parameter (``leaves`` of
        :func:`reference_state_leaves`, the reference's names) divides
        its axis of this world's mesh, and with the replica plane on,
        no parameter is split past dim 0; the reference's messages."""
        problems, mirror_problems = [], []
        params = sorted(
            (path[len("params/"):], shape, spec)
            for path, shape, _, spec in leaves if path.startswith("params/")
        )
        params.sort(key=lambda leaf: tuple(leaf[0].split("/")))
        for path, shape, spec in params:
            for dim, axis_name in enumerate(spec or ()):
                if axis_name is None:
                    continue
                n = self._mesh_shape[axis_name]
                if shape[dim] % n:
                    problems.append(
                        "%s: dim %d (=%d) %% %d devices != 0"
                        % (path, dim, shape[dim], n)
                    )
                if dim != 0:
                    mirror_problems.append(path)
        if problems:
            raise ValueError(
                "sharded parameters do not divide the %d-device world: "
                "%s. For row tables whose extra rows are inert "
                "(embeddings), mark the spec PadDim0 in the zoo's "
                "param_shardings and the elastic plane pads/reshards "
                "automatically; otherwise pad the sharded dimension "
                "(e.g. vocab_size) to a multiple of every world size "
                "the job can shrink/grow to."
                % (int(np.prod(list(self._mesh_shape.values()))),
                   "; ".join(problems))
            )
        if mirror_problems and self.mirror_enabled():
            raise ValueError(
                "the replica plane (--replica_refresh_steps) supports "
                "only leading-dim sharded parameters, but these leaves "
                "shard a later dim: %s. Reshape so the sharded axis is "
                "dim 0, or disable the mirror (replica_refresh_steps=0) "
                "to fall back to checkpoint-based recovery."
                % "; ".join(mirror_problems)
            )

    def _check_sharded_layout(self, param_specs):
        """The establish refusals, in the reference's order, for the
        specs of this world's mesh (``_mesh_shape``), the divisibility
        checked at this world's padding."""
        self._sharded_paths = collect_sharded_paths(param_specs)
        self._pjit_dense = specs_use_axis(self._sharded_paths, "model")
        if self._pjit_dense and self._accum_steps > 1:
            raise ValueError(
                "accum_steps > 1 is not supported on the pjit dense "
                "plane yet: global-batch microbatching would regroup "
                "rows across devices and change the weighted-step "
                "semantics — use the replicated plane, or accum_steps=1"
            )
        if not self._pjit_dense:
            self._check_collective_reductions()
        self._check_optimizer_coupling()
        self._check_shard_divisibility(self._reference_leaves(
            param_specs, pad_axes=self._mesh_shape
        ))
        if self.mirror_enabled():
            raise NotImplementedError(
                "the in-memory replica plane (ShardMirror, "
                "refresh_mirror, _try_assemble_from_mirrors) is not "
                "ported yet (ROADMAP A2); pass --replica_refresh_steps 0 "
                "to fall back to checkpoint-based recovery"
            )

    def _check_collective_reductions(self):
        """On the collective plane a split leaf is reduced over the mesh
        axes it does not split (the reference's ``_unsharded_axes``);
        the port reduces every replicated leaf over the world and no
        split one, so a split leaf must split every axis of more than
        one rank (a ``pipe`` stage stack over ``data`` does not)."""
        wide = {a for a, n in self._mesh_shape.items() if n > 1}
        for path, spec in sorted(self._sharded_paths.items()):
            rest = sorted(wide - set(spec_axes(spec)))
            if spec_axes(spec) and rest:
                raise NotImplementedError(
                    "%s split over %s must also be reduced over %s: the "
                    "collective plane's reduction of a split leaf over "
                    "another axis (the pipeline's stage stacks) is not "
                    "ported yet (ROADMAP A9.3)"
                    % ("/".join(path), spec_axes(spec), rest)
                )

    def _world_min(self, flag):
        """The MIN of an int over the world (the flag itself alone)."""
        if self._spec.num_processes <= 1:
            return int(flag)
        t = self._small([int(flag)], torch.int64)
        self._all_reduce(t, dist.ReduceOp.MIN)
        return int(t.item())

    def _establish_sharded(self, example_batch):
        """Place the sharded state in this world: lay the mesh out (the
        planner's ``{"data", "model"}`` for this world size), check the
        layout, build this rank's part of the model on it, then restore
        the newest checkpoint every rank can read its parts of, falling
        back through older ones (a killed rank can leave the newest
        torn), else initialize from the seed (deterministic, logged). A
        restored or re-initialized version never falls below the newest
        checkpoint's, so later saves number past a torn directory."""
        from elasticdl_tpu_torch.parallel.mesh import (
            WorldMesh,
            create_mesh,
            global_shape,
        )
        from elasticdl_tpu_torch.parallel.trainer import _check_placement

        if example_batch is None and self._last_local is None:
            raise ValueError("the first establish() needs a batch")
        n = self._spec.num_processes
        axes = self._world_mesh_for(n)
        if axes is None:
            raise ValueError(
                "mesh_axes %r does not cover the %d-device world"
                % (self._mesh_axes_fn(n), n)
            )
        self._mesh_shape = axes
        was_live = self._host_step > 0
        self._ts = None
        t0 = time.perf_counter()
        try:
            # the axes' process groups: a rendezvous of every rank
            mesh = create_mesh(axes, devices=[self._device])
        except RuntimeError as e:
            raise distributed.WorldBroken(
                "the mesh of world epoch %d did not form: %s"
                % (self._spec.epoch, e)
            ) from e
        t_mesh = time.perf_counter()
        module, param_specs = self._builder(mesh)
        self._check_sharded_layout(param_specs)
        if not isinstance(module, torch.nn.Module):
            with torch.device("meta"):
                module = module()
        place_module(module, self._device)
        self._module = module
        self._forward = make_remat_forward(module, self._remat)
        self._split = _check_placement(
            module, mesh, param_specs, self._device
        )
        self._mesh = mesh if isinstance(mesh, WorldMesh) else None
        # the logical rows of the parameters this world pads
        whole = dict(self._whole_model()[0].named_parameters())
        self._logical_rows = {
            name: int(whole[name].shape[0])
            for name, p in module.named_parameters()
            if isinstance(self._split.get(name), PadDim0)
            and global_shape(self._split[name], tuple(p.shape), self._mesh)[0]
            != whole[name].shape[0]
        }
        self._ts = self._empty_state()
        t_build = time.perf_counter()
        candidates = (
            self.restore_provider() if self.restore_provider else None
        ) or []
        if isinstance(candidates, str):
            candidates = [candidates]
        floor = max(
            (_checkpoint_version(d) for d in candidates), default=0
        )
        restored = None
        for directory in candidates:
            try:
                read = self._read_sharded(directory)
            except Exception:
                read = None
                logger.warning(
                    "sharded checkpoint %s unrestorable onto this mesh",
                    directory, exc_info=True,
                )
            # every rank must restore the same checkpoint
            if self._world_min(read is not None):
                restored = directory
                self._adopt(*read)
                break
            logger.warning("checkpoint %s not restorable on every rank; "
                           "trying older", directory)
        if restored is None:
            if was_live:
                logger.warning(
                    "membership change with sharded parameters and no "
                    "restorable checkpoint: state RE-INITIALIZED "
                    "(enable --checkpoint_steps to bound this loss)"
                )
            self.init_from_batch(example_batch)
        else:
            logger.info("sharded state restored at v%d from %s",
                        self._ts.version, restored)
        if floor > self._ts.version:
            self._ts.version = floor
        self.establish_times = {
            "mesh_s": t_mesh - t0,
            "build_s": t_build - t_mesh,
            "restore_s": time.perf_counter() - t_build,
            "restored_from": restored,
            "restored_version": self._ts.version if restored else None,
        }

    # -- the weighted step --------------------------------------------------

    def local_rows(self, minibatch_size):
        """Fixed per-process rows: the minibatch padded to whole
        microbatches."""
        chunk = self._accum_steps
        return -(-minibatch_size // chunk) * chunk

    def _mark(self):
        """A point on the step's timeline that costs no host wait: an
        event on the card's stream, the host clock on the CPU (where
        every op has finished when it returns)."""
        if self._device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @property
    def host_step(self):
        """The number of steps this process has taken, all worlds."""
        return self._host_step

    @property
    def step_times(self):
        """The split of the step before the last one, in seconds:
        compute (forward, backward and the flat buffer), the flattened
        all-reduce, and the rest (state and the optimizer update), with
        its ``host_step``. That step's end is behind the last step's
        host read of the live count, so reading its events waits for
        nothing; on the card they are the stream's times."""
        if self._timed is None:
            return {}
        host_step, m = self._timed
        if self._device.type == "cuda":
            gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        else:
            gaps = [b - a for a, b in zip(m, m[1:])]
        return {
            "host_step": host_step,
            "compute_s": gaps[0],
            "allreduce_s": gaps[1],
            "rest_s": gaps[2],
            "step_s": sum(gaps),
        }

    def _grads(self, features, labels, rng):
        ts = self._ts

        def grads_of(state, f, l, r):
            loss, grads, new_state, _ = _loss_and_grads(
                self._forward, self._loss_fn, self._pol, ts.params, state,
                f, l, r,
            )
            return loss, grads, new_state

        if self._accum_steps == 1:
            return grads_of(ts.state, features, labels, rng)
        return accumulate_gradients(
            grads_of, ts.state, features, labels, rng, self._accum_steps,
            ts.params,
        )

    def train_step(self, features, labels, minibatch_size, epoch_hint=0,
                   pending=False):
        """One weighted lockstep step; ``features=None`` takes part at
        weight 0 on the previous batch. Returns (loss, live count, this
        process's true rows). ``epoch_hint`` is this process's last
        polled membership epoch and ``pending`` whether its task stream
        is still open; the step's MAX over the members lands in
        :attr:`epoch_consensus` and :attr:`pending_consensus`, the same
        values on every rank.

        Raises :class:`WorldBroken` when a collective fails; the state
        is then as it was before the step."""
        rows = self.local_rows(minibatch_size)
        if features is not None:
            count = int(_first_leaf(features).shape[0])
            pad = lambda x: _pad_rows(x, rows).to(self._device)  # noqa: E731
            local = (tree_map(pad, features), tree_map(pad, labels))
            self._last_local = local
            w = min(1.0, count / rows)
        else:
            count = 0
            if self._last_local is None:
                raise RuntimeError(
                    "cannot run a weight-0 step before the first data step"
                )
            local = self._last_local
            w = 0.0
        if self.is_sharded:
            return self._sharded_step(local, count, w, epoch_hint, pending)
        ts = self._ts
        self._host_step += 1
        # decorrelate stochastic layers (dropout) across the ranks
        rng = fold_in(
            fold_in(self._seed, self._host_step), self._spec.process_id
        )
        m0 = self._mark()
        loss, grads, new_state = self._grads(local[0], local[1], rng)
        # one flat f32 buffer: w*grads | w*loss | w*float state | w | w>0
        floats = [n for n, v in new_state.items() if v.is_floating_point()]
        sizes = [g.numel() for g in grads.values()]
        sizes += [1] + [new_state[n].numel() for n in floats] + [1, 1]
        flat = torch.empty(sum(sizes), dtype=torch.float32,
                           device=self._device)
        parts = list(flat.split(sizes))
        for part, g in zip(parts, grads.values()):
            torch.mul(g.reshape(-1), w, out=part)
        k = len(grads)
        torch.mul(loss.reshape(1).float(), w, out=parts[k])
        for part, n in zip(parts[k + 1:], floats):
            torch.mul(new_state[n].reshape(-1).float(), w, out=part)
        parts[-2].fill_(w)
        parts[-1].fill_(1.0 if w > 0 else 0.0)
        epoch = self._small([int(epoch_hint), int(bool(pending))],
                            torch.int64)
        m1 = self._mark()
        if self._spec.num_processes > 1:
            self._wait([
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, async_op=True),
                dist.all_reduce(epoch, op=dist.ReduceOp.MAX, async_op=True),
            ])
        m2 = self._mark()
        # the step's one host read: lockstep needs the live count
        tail = parts[-2].tolist() + parts[-1].tolist() + parts[k].tolist()
        w_sum, live, loss_sum = tail
        live = int(round(live))
        denom = max(w_sum, 1e-6)
        self.epoch_consensus, pending = epoch.tolist()
        self.pending_consensus = bool(pending)
        if live > 0:
            ts.state = dict(new_state)
            for part, n in zip(parts[k + 1:], floats):
                ts.state[n] = (part / denom).reshape(
                    new_state[n].shape
                ).to(new_state[n].dtype)
            _apply(
                ts.opt_state,
                ts.params,
                {n: part.div_(denom).reshape(p.shape)
                 for (n, p), part in zip(ts.params.items(), parts)},
            )
            ts.version += 1
        self._timed = self._marks
        self._marks = (self._host_step, (m0, m1, m2, self._mark()))
        return loss_sum / denom, live, count

    # -- the pjit dense plane's step and evaluation ---------------------------

    def _group_rows(self, tree):
        """``tree`` (this process's padded rows) -> the data group's
        rows: every ``model`` rank's block, in ``model`` order (the
        reference's flattened device order of the global batch)."""
        from elasticdl_tpu_torch.parallel import collectives
        from elasticdl_tpu_torch.parallel.mesh import axis_of

        model = axis_of(self._mesh, "model")
        if model is None:
            return tree
        return tree_map(
            lambda t: collectives.all_gather(t.contiguous(), model, 0), tree
        )

    def _block_losses(self, output, labels, blocks):
        """(blocks,) float32: each block's mean loss (a block is one
        process's rows). Over a ``model`` axis the output is this rank's
        vocabulary part and the loss the next-token cross entropy of
        ``spmd.vocab_parallel_ce``; otherwise the zoo's loss per
        block."""
        from elasticdl_tpu_torch.parallel import spmd
        from elasticdl_tpu_torch.parallel.mesh import axis_of

        model = axis_of(self._mesh, "model")
        if model is None:
            outs = torch.chunk(output, blocks)
            labs = torch.chunk(torch.as_tensor(labels), blocks)
            return torch.stack([
                self._loss_fn(o, l).float() for o, l in zip(outs, labs)
            ])
        labels = torch.as_tensor(labels).to(output.device).long()
        targets = torch.full_like(labels, spmd.IGNORE)
        targets[:, :-1] = labels[:, 1:]
        ce = spmd.vocab_parallel_ce(output, targets, model)
        per_block = ce.reshape(blocks, -1).sum(dim=1)
        rows, length = labels.shape[0] // blocks, labels.shape[1]
        return per_block / float(rows * (length - 1))

    def _sharded_step(self, local, count, w, epoch_hint, pending):
        """:meth:`train_step` on the pjit dense plane (see the module's
        text): returns (loss, live processes, this process's rows)."""
        from elasticdl_tpu_torch.parallel import collectives
        from elasticdl_tpu_torch.parallel.mesh import axis_of

        if not self._pjit_dense:
            return self._collective_step(local, count, w, epoch_hint, pending)
        ts = self._ts
        self._host_step += 1
        # one draw for the whole global batch, as the reference's
        rng = fold_in(self._seed, self._host_step)
        before = collectives.staging.snapshot()
        m0 = self._mark()
        try:
            weights = self._group_rows(
                torch.tensor([w], dtype=torch.float32, device=self._device)
            )
            features = self._group_rows(local[0])
            labels = self._group_rows(local[1])
            leaves = {
                n: p.detach().requires_grad_(True)
                for n, p in ts.params.items()
            }
            pol = self._pol
            with torch.enable_grad():
                p, f = leaves, features
                if pol is not None:
                    p = pol.cast_to_compute(p)
                    f = pol.cast_to_compute(features)
                output, new_state = self._forward(p, ts.state, f, rng)
                if pol is not None:
                    output = pol.cast_output(output)
                blocks = self._block_losses(output, labels, weights.numel())
                group_w = weights.sum()
                # the weights ride the loss: the gradient of each block
                # carries its process's weight from the start
                weighted = (blocks * weights).sum()
                total = weighted + group_w * aux_loss_total(new_state).to(
                    weighted.device)
                grads = torch.autograd.grad(
                    total, list(leaves.values()), allow_unused=True
                )
            new_state = {k: v.detach() for k, v in (new_state or {}).items()}
            floats = [n for n, v in new_state.items()
                      if v.is_floating_point()]
            grads = [
                torch.zeros_like(leaves[n]) if g is None else g
                for n, g in zip(leaves, grads)
            ]
            # one flat f32 buffer: grads | weighted loss | W*float state
            # | W | live, W and live this data group's
            sizes = [g.numel() for g in grads]
            sizes += [1] + [new_state[n].numel() for n in floats] + [1, 1]
            flat = torch.empty(sum(sizes), dtype=torch.float32,
                               device=self._device)
            parts = list(flat.split(sizes))
            for part, g in zip(parts, grads):
                part.copy_(g.reshape(-1))
            k = len(grads)
            parts[k].copy_(weighted.detach().reshape(1).float())
            for part, n in zip(parts[k + 1:], floats):
                torch.mul(new_state[n].reshape(-1).float(), group_w, out=part)
            parts[-2].copy_(group_w.reshape(1))
            parts[-1].copy_((weights > 0).sum().reshape(1).float())
            epoch = self._small([int(epoch_hint), int(bool(pending))],
                                torch.int64)
            m1 = self._mark()
            works = [dist.all_reduce(epoch, op=dist.ReduceOp.MAX,
                                     async_op=True)]
            data = axis_of(self._mesh, "data")
            if data is not None:
                works.append(dist.all_reduce(
                    flat, op=dist.ReduceOp.SUM, group=data.group,
                    async_op=True,
                ))
            if self._spec.num_processes > 1:
                self._wait(works)
        except distributed.WorldBroken:
            raise
        except RuntimeError as e:
            # the model's collectives raise on a peer's death
            raise distributed.WorldBroken(
                "sharded step of world epoch %d failed: %s"
                % (self._spec.epoch, e)
            ) from e
        m2 = self._mark()
        tail = parts[-2].tolist() + parts[-1].tolist() + parts[k].tolist()
        w_sum, live, loss_sum = tail
        live = int(round(live))
        denom = max(w_sum, 1e-6)
        self.epoch_consensus, pending = epoch.tolist()
        self.pending_consensus = bool(pending)
        if live > 0:
            ts.state = dict(new_state)
            for part, n in zip(parts[k + 1:], floats):
                ts.state[n] = (part / denom).reshape(
                    new_state[n].shape
                ).to(new_state[n].dtype)
            _apply(
                ts.opt_state,
                ts.params,
                {n: part.div_(denom).reshape(p.shape)
                 for (n, p), part in zip(ts.params.items(), parts)},
            )
            ts.version += 1
        self._timed = self._marks
        self._marks = (self._host_step, (m0, m1, m2, self._mark()))
        self.last_staging = _staging_since(before)
        return loss_sum / denom, live, count

    def _collective_layers(self):
        """The model's collective HBM tables (``nn/hbm_embedding``)."""
        from elasticdl_tpu_torch.nn.hbm_embedding import HbmEmbedding

        return [m for m in self._module.modules()
                if isinstance(m, HbmEmbedding) and m.collective]

    def _collective_grads(self, features, labels, w, rng):
        """(raw loss, {name: gradient of w x loss}, new state) of this
        rank's rows: the weight rides the loss, so the row gradients the
        lookups route to their owners carry it from the source."""
        ts = self._ts
        pol = self._pol

        def grads_of(state, f, l, r):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in ts.params.items()}
            with torch.enable_grad():
                p = leaves
                if pol is not None:
                    p = pol.cast_to_compute(p)
                    f = pol.cast_to_compute(f)
                output, new_state = self._forward(p, state, f, r)
                if pol is not None:
                    output = pol.cast_output(output)
                raw = self._loss_fn(output, l).float()
                raw = raw + aux_loss_total(new_state).to(raw.device)
                grads = torch.autograd.grad(
                    raw * w, list(leaves.values()), allow_unused=True
                )
            grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                     for n, g in zip(leaves, grads)}
            new_state = {k: v.detach() for k, v in (new_state or {}).items()}
            return raw.detach(), grads, new_state

        if self._accum_steps == 1:
            return grads_of(ts.state, features, labels, rng)
        return accumulate_gradients(
            grads_of, ts.state, features, labels, rng, self._accum_steps,
            ts.params,
        )

    def _collective_step(self, local, count, w, epoch_hint, pending):
        """:meth:`train_step` on the collective plane (see the module's
        text): returns (loss, live processes, this process's rows)."""
        from elasticdl_tpu_torch.parallel import collectives

        ts = self._ts
        self._host_step += 1
        # decorrelate stochastic layers across the ranks
        rng = fold_in(
            fold_in(self._seed, self._host_step), self._spec.process_id
        )
        layers = self._collective_layers()
        for layer in layers:
            layer.pending_overflow = None
        before = collectives.staging.snapshot()
        m0 = self._mark()
        try:
            loss, grads, new_state = self._collective_grads(
                local[0], local[1], w, rng
            )
            # one flat f32 buffer: w*grads of the replicated leaves |
            # w*loss | w*float state | w | w>0 | each table's overflow
            shared = [n for n in ts.params if n not in self._split]
            floats = [n for n, v in new_state.items()
                      if v.is_floating_point() and n not in self._split]
            sizes = [grads[n].numel() for n in shared]
            sizes += [1] + [new_state[n].numel() for n in floats]
            sizes += [1, 1] + [1] * len(layers)
            flat = torch.empty(sum(sizes), dtype=torch.float32,
                               device=self._device)
            parts = list(flat.split(sizes))
            for part, n in zip(parts, shared):
                part.copy_(grads[n].reshape(-1))
            k = len(shared)
            torch.mul(loss.reshape(1), w, out=parts[k])
            for part, n in zip(parts[k + 1:], floats):
                torch.mul(new_state[n].reshape(-1).float(), w, out=part)
            tail = k + 1 + len(floats)
            parts[tail].fill_(w)
            parts[tail + 1].fill_(1.0 if w > 0 else 0.0)
            for part, layer in zip(parts[tail + 2:], layers):
                if layer.pending_overflow is None:
                    part.zero_()
                else:
                    part.copy_(layer.pending_overflow.reshape(1))
            epoch = self._small([int(epoch_hint), int(bool(pending))],
                                torch.int64)
            m1 = self._mark()
            if self._spec.num_processes > 1:
                self._wait([
                    dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                    async_op=True),
                    dist.all_reduce(epoch, op=dist.ReduceOp.MAX,
                                    async_op=True),
                ])
        except distributed.WorldBroken:
            raise
        except RuntimeError as e:
            # the lookups' exchanges raise on a peer's death
            raise distributed.WorldBroken(
                "collective step of world epoch %d failed: %s"
                % (self._spec.epoch, e)
            ) from e
        m2 = self._mark()
        # the step's one host read: the loss, the live count, and the
        # tables' overflow and routing counts
        routing = [
            layer.last_routing[key] for layer in layers
            for key in ("routed", "occurrences")
            if layer.last_routing is not None
        ]
        read = torch.cat(
            [parts[k].double(), flat[sum(sizes[:tail]):].double()]
            + ([torch.stack(routing).double().to(flat.device)]
               if routing else [])
        ).tolist()
        loss_sum, w_sum, live = read[0], read[1], int(round(read[2]))
        denom = max(w_sum, 1e-6)
        self.epoch_consensus, pending = epoch.tolist()
        self.pending_consensus = bool(pending)
        for layer, n_over in zip(layers, read[3:3 + len(layers)]):
            layer.settle_overflow(int(round(n_over)))
        counts = read[3 + len(layers):]
        self.last_routing = {
            "routed": int(sum(counts[0::2])),
            "occurrences": int(sum(counts[1::2])),
        }
        if live > 0:
            for part, n in zip(parts[k + 1:], floats):
                new_state[n] = (part / denom).reshape(
                    new_state[n].shape
                ).to(new_state[n].dtype)
            ts.state = new_state  # int leaves keep this rank's values
            reduced = dict(zip(shared, parts))
            _apply(
                ts.opt_state,
                ts.params,
                {n: (reduced[n] if n in reduced else grads[n]).div_(
                    denom).reshape(p.shape)
                 for n, p in ts.params.items()},
            )
            ts.version += 1
        self._timed = self._marks
        self._marks = (self._host_step, (m0, m1, m2, self._mark()))
        self.last_staging = _staging_since(before)
        return loss_sum / denom, live, count

    def eval_have_consensus(self, have):
        """The number of ranks with evaluation work pending (a world
        SUM; every rank calls it at the same point)."""
        flag = self._small([1 if have else 0], torch.int64)
        if self._spec.num_processes > 1:
            self._all_reduce(flag, dist.ReduceOp.SUM)
        return int(flag.item())

    def eval_step(self, features, minibatch_size):
        """The inference forward of this process's evaluation rows on
        the current parameters, in which every rank of the mesh takes
        part; ``features=None`` feeds the last rows and its output is
        to be dropped. Returns this process's padded rows of the output,
        the whole vocabulary (the caller cuts its true rows)."""
        from elasticdl_tpu_torch.parallel import collectives
        from elasticdl_tpu_torch.parallel.mesh import axis_of
        from elasticdl_tpu_torch.nn.model_api import apply_model

        rows = self.local_rows(minibatch_size)
        if features is None:
            if self._last_local is None:
                raise RuntimeError(
                    "cannot run a dummy eval step before the first data "
                    "step"
                )
            features = self._last_local[0]
        pad = lambda x: _pad_rows(x, rows).to(self._device)  # noqa: E731
        group = self._group_rows(tree_map(pad, features))
        params, pol = self._ts.params, self._pol
        with torch.no_grad():
            if pol is not None:
                params = pol.cast_to_compute(params)
                group = pol.cast_to_compute(group)
            output, _ = apply_model(
                self._module, params, self._ts.state, group, training=False
            )
            if pol is not None:
                output = pol.cast_output(output)
        model = axis_of(self._mesh, "model")
        if model is None:
            return output
        whole = collectives.all_gather(output.contiguous(), model, -1)
        return whole[model.index * rows:(model.index + 1) * rows]

    # -- state on the host, checkpoints, leaving ----------------------------

    def snapshot(self):
        """The train state as owned host copies (the export's source), or
        None before any state exists. None on the sharded plane: a
        process holds its parts alone, and the sharded checkpoints are
        that plane's snapshots."""
        if self.is_sharded or self._ts is None:
            return None
        return self.get_host_state()

    def host_params(self):
        snap = self.snapshot()
        return snap.params if snap is not None else None

    def load_host_state(self, host_ts):
        """Adopt a host train state (``snapshot()``'s form: the optimizer
        state as its ``state_dict``, or the optimizer) before establish.
        A sharded trainer's state comes from its checkpoints
        (``restore_provider``), as the reference's does."""
        if self.is_sharded:
            raise ValueError(
                "a sharded trainer restores its state from sharded "
                "checkpoints at establish (restore_provider)"
            )
        opt = host_ts.opt_state
        if not isinstance(opt, dict):
            opt = opt.state_dict()
        self._adopt(host_ts.params, host_ts.state, opt, host_ts.version)

    def logical_dim0_by_path(self):
        """{checkpoint leaf path: logical rows} of the leaves this world
        pads (a ``PadDim0`` parameter and its co-sharded optimizer
        slots): what the checkpoint manager records so that a host load
        clips the padding off."""
        from elasticdl_tpu_torch.parallel.trainer import _leaf_spec

        if self._ts is None or not self._logical_rows:
            return {}
        out = {}
        for path, value in train_state_leaves(self._ts).items():
            head, _, rest = path.partition("/")
            name = rest if head == "params" else rest.rpartition("/")[0]
            if name in self._logical_rows and _leaf_spec(
                path, value, self._ts.params, self._split
            ) is not None:
                out[path] = self._logical_rows[name]
        return out

    def checkpoint_parts(self):
        """({path: tensor} this rank writes, {path: (global shape, its
        slices)}, this rank's manifest index): what a sharded checkpoint
        manager saves for this rank (``AllReduceTrainer.save_sharded``'s
        layout)."""
        mine, layout = self._leaf_layout(train_state_leaves(self._ts))
        return mine, layout, self._spec.process_id

    def digest(self):
        return state_digest(self._ts)

    def leave(self):
        """Leave the world at an epoch boundary. Replicated, the state
        stays on the device for the next one; sharded, it is dropped (a
        dead rank's parts are gone: the next establish restores the
        checkpoint the pause wrote)."""
        distributed.leave_world()
        self._spec = None
        if self.is_sharded:
            self._ts = None
            self._mesh = None
