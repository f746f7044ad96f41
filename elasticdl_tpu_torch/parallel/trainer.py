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

Not ported yet: more than one device (``resize``, sharded placement via
``param_specs`` or ``mesh``); each raises ``NotImplementedError``.
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
        if mesh is not None or param_specs:
            raise _not_ported("placement over a mesh (mesh/param_specs)")
        if devices is not None and len(devices) != 1:
            raise _not_ported("over %d devices" % len(devices))
        self._device = resolve_device(device)
        self._module = module
        self._optimizer = optimizer
        self._seed = seed
        self._step_fn = make_train_step(
            module,
            loss_fn,
            accum_steps=accum_steps,
            precision=precision,
            remat=remat,
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
        raise _not_ported("resize (membership change)")

    def get_host_state(self):
        """The train state as owned host copies (for checkpointing):
        params and state as CPU tensors, ``opt_state`` as the optimizer's
        ``state_dict`` with its tensors copied to the CPU."""

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, dict):
                return {k: host(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(host(v) for v in x)
            return x

        ts = self._ts
        return TrainState(
            params=host(ts.params),
            state=host(ts.state),
            opt_state=host(ts.opt_state.state_dict()),
            version=ts.version,
        )

    def save_sharded(self, directory):
        """Write the train state as one sharded checkpoint directory."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            save_sharded,
            train_state_leaves,
        )

        save_sharded(directory, train_state_leaves(self._ts), self.version)

    def restore_sharded(self, directory):
        """Adopt the checkpoint in ``directory`` (the state must exist,
        e.g. from ``init_from_batch``: its optimizer settings are kept);
        returns the restored version. Raises, leaving the state as it
        was, when the checkpoint does not cover this model."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            load_sharded_to_host,
            split_train_state_leaves,
        )

        _, leaves = load_sharded_to_host(directory)
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
        self._adopt(
            {n: params[n] for n in self._ts.params},
            state,
            {"state": opt, "param_groups": groups},
            version,
        )
        return version
