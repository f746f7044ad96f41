"""Data-parallel trainer (the ALLREDUCE strategy), the counterpart of
``elasticdl_tpu/parallel/trainer.py`` on one device.

``train_step`` is what the single-process ALLREDUCE worker calls per
minibatch: the fused step of ``training/step.py`` over the train state,
which stays on the card between steps and is updated in place. The step
seed follows the reference's scheme (one draw per host step under the
trainer's seed).

``save_sharded``/``restore_sharded`` write and read the sharded
checkpoint layout (common/sharded_checkpoint.py): params, model state,
the optimizer's per-parameter state and the version.

A zoo's distributed hooks hand the trainer a ``mesh`` and its
``param_specs`` (``parallel/mesh.py``; nested, full names or the
reference's suffix specs). On a mesh of one device every spec must be
whole, and every parameter is placed whole on the card, as the
reference places a spec that splits nothing. On a ``WorldMesh`` (this
process one rank of a ``torch.distributed`` world, the mesh's device
its card) the specs may split a parameter over the mesh's axes: the
module then holds this rank's parts (the LM's tensor-parallel form,
whose own layout the specs must match), ``init_from_batch`` draws the
whole model from the seed and keeps the parts, the step runs over the
mesh (``training/step.py``, ``parallel/spmd.py``), the optimizer's
state co-shards with its parameter, :meth:`get_host_state` gathers the
parts, and :meth:`save_sharded`/:meth:`restore_sharded` write and read
each rank's parts with their global index, so a checkpoint restores
onto any other split of the same model. A ``PadDim0`` part is read at
this world's padded rows whatever padding wrote it, the rows past the
logical ones zero.

Not ported yet: more than one device in one process (``devices``), and
``resize`` of those devices in place (ROADMAP A9.2.3); both raise
``NotImplementedError``. A membership change of a world of processes is
the elastic plane's re-form (``parallel/elastic.py``), tensor-parallel
worlds included.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.nn.model_api import init_variables, split_variables
from elasticdl_tpu_torch.training.step import (
    TrainState,
    fold_in,
    make_train_step,
)


def _not_ported(what):
    return NotImplementedError("AllReduceTrainer %s is not ported yet" % what)


def to_device(tree, device):
    """numpy arrays and tensors of a dict/list/tuple tree -> tensors on
    ``device`` (non-blocking from pinned memory where the source is)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if not isinstance(tree, torch.Tensor):
        # wire arrays may be read-only views: one owned copy
        tree = torch.from_numpy(np.array(tree))
    return tree.to(device, non_blocking=True)


def place_module(module, device):
    """Move ``module`` to ``device``; a module built on the meta device
    gets uninitialized storage there (its init fills it)."""
    params = list(module.parameters())
    if params and params[0].is_meta:
        module.to_empty(device=device)
    else:
        module.to(device)


def _check_placement(module, mesh, param_specs, device):
    """Check ``param_specs`` against ``module`` and ``mesh``; returns
    {parameter name: spec} of the parameters they split. On a mesh of
    one device every spec must be whole; on a ``WorldMesh`` the specs
    name its axes and must match the module's own layout
    (``param_layout``) where it has one."""
    from elasticdl_tpu_torch.parallel.mesh import (
        WorldMesh,
        resolve_specs,
        spec_is_whole,
    )

    if mesh is None:
        if param_specs:
            raise _not_ported("placement by param_specs without a mesh")
        return {}
    if not isinstance(mesh, WorldMesh) and getattr(mesh, "size", None) != 1:
        raise _not_ported(
            "placement over a mesh of %s devices outside a world"
            % getattr(mesh, "size", "unknown")
        )
    if torch.device(mesh.device) != device:
        raise ValueError(
            "the mesh's device %s is not the trainer's %s"
            % (mesh.device, device)
        )
    specs = resolve_specs(
        [n for n, _ in module.named_parameters()], param_specs
    )
    split = {n: sp for n, sp in specs.items() if not spec_is_whole(sp, mesh)}
    if not isinstance(mesh, WorldMesh):
        # a mesh of one device splits nothing
        return {}
    layout = getattr(module, "param_layout", lambda: None)()
    if layout is not None and layout != split:
        raise ValueError(
            "param_specs split %s, the model %s on mesh %r"
            % (sorted(split), sorted(layout), mesh)
        )
    return split


def _leaf_spec(path, value, params, split):
    """The spec of a train-state leaf: a parameter's, and an optimizer
    slot's of its parameter's shape (AdamW's moments) that of its
    parameter; None (whole) for the rest."""
    head, _, rest = path.partition("/")
    if head == "params":
        return split.get(rest)
    if head == "opt_state":
        name = rest.rpartition("/")[0]
        if name in split and tuple(value.shape) == tuple(params[name].shape):
            return split[name]
    return None


class AllReduceTrainer:
    def __init__(
        self,
        module,
        loss_fn,
        optimizer,
        devices=None,
        seed=0,
        mesh=None,
        param_specs=None,
        accum_steps=1,
        precision=None,
        remat=False,
        device="cuda",
    ):
        """``optimizer`` is the zoo's factory ``params -> Optimizer``;
        ``accum_steps``/``precision``/``remat`` forward to
        :func:`training.step.make_train_step`. ``device`` is where the
        state lives (the card unless the caller names the CPU). One
        device splits no batch, so the reference's ``batch_axis`` has no
        counterpart."""
        from elasticdl_tpu_torch.parallel.mesh import WorldMesh

        if devices is not None and len(devices) != 1:
            raise _not_ported("over %d devices" % len(devices))
        self._device = resolve_device(device)
        self._split = _check_placement(
            module, mesh, param_specs, self._device
        )
        self._mesh = mesh if isinstance(mesh, WorldMesh) else None
        self._module = module
        self._optimizer = optimizer
        self._seed = seed
        self._step_fn = make_train_step(
            module,
            loss_fn,
            accum_steps=accum_steps,
            precision=precision,
            remat=remat,
            mesh=self._mesh,
            seq_axis=getattr(module, "seq_axis", None),
        )
        self._ts = None
        self._host_step = 0

    @property
    def device(self):
        return self._device

    @property
    def num_devices(self):
        return 1

    @property
    def train_state(self):
        return self._ts

    @property
    def version(self):
        return self._ts.version if self._ts is not None else -1


    def init_from_batch(self, global_batch):
        """Create the train state on the device: seeded weights (the
        trainer's seed), then the optimizer over them. The batch is taken
        for the reference's signature; a torch module knows its shapes."""
        place_module(self._module, self._device)
        variables = init_variables(self._module, self._seed, global_batch)
        params, state = split_variables(variables)
        self._ts = TrainState.create(params, state, self._optimizer)
        return self._ts

    def load_state(self, ts):
        """Adopt a train state (checkpoint restore, a converted reference
        state): its tensors move to this trainer's device, and its
        optimizer is rebuilt over the moved parameters with its state
        carried over."""
        self._adopt(
            ts.params, ts.state, ts.opt_state.state_dict(), ts.version
        )

    def _adopt(self, params, state, opt_state_dict, version):
        place_module(self._module, self._device)
        params = {
            n: p.detach().to(self._device).requires_grad_(True)
            for n, p in params.items()
        }
        opt = self._optimizer(list(params.values()))
        opt.load_state_dict(opt_state_dict)
        self._ts = TrainState(
            params=params,
            state={n: b.to(self._device) for n, b in state.items()},
            opt_state=opt,
            version=version,
        )

    def train_step(self, features, labels):
        """One step on one batch; returns the loss (a device scalar)."""
        if self._ts is None:
            self.init_from_batch((features, labels))
        features = to_device(features, self._device)
        labels = to_device(labels, self._device)
        self._host_step += 1
        rng = fold_in(self._seed, self._host_step)
        self._ts, loss = self._step_fn(self._ts, features, labels, rng)
        return loss

    def resize(self, devices):
        raise _not_ported(
            "resize (the devices of one process re-laid out in place, "
            "ROADMAP A9.2.3; a world of processes re-forms on the elastic "
            "plane, parallel/elastic.py)"
        )

    @property
    def param_specs(self):
        """{parameter name: spec} of the parameters split over the
        mesh (empty when nothing is split)."""
        return dict(self._split)

    def get_host_state(self):
        """The train state as owned host copies (for checkpointing):
        params and state as CPU tensors, ``opt_state`` as the optimizer's
        ``state_dict`` with its tensors copied to the CPU. Split
        parameters and their optimizer slots come whole, gathered over
        the mesh (every rank must call it)."""
        from elasticdl_tpu_torch.parallel.sharding import gather_part

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, dict):
                return {k: host(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(host(v) for v in x)
            return x

        ts = self._ts
        names = list(ts.params)
        opt = ts.opt_state.state_dict()
        if self._split:
            opt = dict(opt, state={
                idx: {slot: gather_part(v, _leaf_spec(
                    "opt_state/%s/%s" % (names[idx], slot), v, ts.params,
                    self._split), self._mesh)
                    if isinstance(v, torch.Tensor) else v
                    for slot, v in slots.items()}
                for idx, slots in opt["state"].items()
            })
        params = {
            n: gather_part(p, self._split.get(n), self._mesh)
            for n, p in ts.params.items()
        }
        return TrainState(
            params=host(params),
            state=host(ts.state),
            opt_state=host(opt),
            version=ts.version,
        )

    def _leaf_layout(self, leaves):
        """({path: tensor} this rank writes, {path: (global shape, its
        slices)} of its split leaves)."""
        from elasticdl_tpu_torch.parallel.mesh import (
            global_shape,
            holds_first_replica,
            shard_slices,
        )

        mine, layout = {}, {}
        for path, value in leaves.items():
            spec = _leaf_spec(path, value, self._ts.params, self._split)
            if not holds_first_replica(spec, self._mesh):
                continue
            mine[path] = value
            if spec is not None:
                whole = global_shape(spec, tuple(value.shape), self._mesh)
                layout[path] = (whole, shard_slices(spec, whole, self._mesh))
        return mine, layout

    def save_sharded(self, directory):
        """Write the train state into one sharded checkpoint directory:
        this rank's manifest and the leaves (or parts of leaves) it
        holds the first replica of."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            PROCESS_INDEX,
            save_sharded,
            train_state_leaves,
        )

        mine, layout = self._leaf_layout(train_state_leaves(self._ts))
        rank = self._mesh.rank if self._mesh is not None else PROCESS_INDEX
        save_sharded(directory, mine, self.version, rank, layout)

    def restore_sharded(self, directory):
        """Adopt the checkpoint in ``directory`` (the state must exist,
        e.g. from ``init_from_batch``: its optimizer settings are kept);
        returns the restored version. Raises, leaving the state as it
        was, when the checkpoint does not cover this model."""
        read = self._read_sharded(directory)
        self._adopt(*read)
        return read[3]

    def _read_sharded(self, directory):
        """(params, state, optimizer state dict, version) of this rank's
        parts of the checkpoint in ``directory``, checked against the
        state's names and shapes (raises when it does not cover them)."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            leaf_shapes,
            load_sharded_to_host,
            split_train_state_leaves,
        )
        from elasticdl_tpu_torch.parallel.mesh import (
            PadDim0,
            global_shape,
            shard_slices,
        )

        # this rank's part of each split leaf: a parameter, and an
        # optimizer slot of its parameter's whole shape. A PadDim0 leaf
        # is read at this world's padded rows, whatever padding wrote it
        # (the rows past its logical ones read zero)
        parts = {}
        for path, shape in (leaf_shapes(directory) if self._split
                            else {}).items():
            head, _, rest = path.partition("/")
            name = rest if head == "params" else rest.rpartition("/")[0]
            spec = self._split.get(name) if head in (
                "params", "opt_state") else None
            if spec is None:
                continue
            whole = global_shape(
                spec, tuple(self._ts.params[name].shape), self._mesh
            )
            padded = isinstance(spec, PadDim0) and shape[1:] == whole[1:]
            if padded:
                parts[path] = shard_slices(spec, whole, self._mesh)
            elif head == "params" or shape == whole:
                parts[path] = shard_slices(spec, shape, self._mesh)
        _, leaves = load_sharded_to_host(directory, parts)
        params, state, opt, version = split_train_state_leaves(
            leaves, list(self._ts.params)
        )
        for what, got, want in (
            ("params", params, self._ts.params),
            ("state", state, self._ts.state),
        ):
            if sorted(got) != sorted(want):
                raise KeyError(
                    "checkpoint %s has %s %s, the model %s"
                    % (directory, what, sorted(got), sorted(want))
                )
            for name, value in got.items():
                if tuple(value.shape) != tuple(want[name].shape):
                    raise ValueError(
                        "checkpoint %s: %s %s has shape %s, the model %s"
                        % (directory, what, name, tuple(value.shape),
                           tuple(want[name].shape))
                    )
        groups = self._ts.opt_state.state_dict()["param_groups"]
        return (
            {n: params[n] for n in self._ts.params},
            state,
            {"state": opt, "param_groups": groups},
            version,
        )
