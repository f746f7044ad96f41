"""The model interface, the counterpart of ``elasticdl_tpu/nn/model_api.py``.

A zoo model is an ``nn.Module`` whose ``forward(features)`` takes what
the zoo's ``dataset_fn`` yields. The rest of the port treats it as two
name -> tensor dicts, the reference's two pytrees:

- ``params`` — ``named_parameters()``: trainable, differentiated;
- ``state``  — ``named_buffers()``: non-trainable (BatchNorm statistics).

:func:`apply_model` runs the module through ``torch.func.functional_call``
over those dicts, so a step can hand it parameters cast to the compute
dtype inside the differentiated function.

State is functional, as flax's mutable collections are: a layer never
writes the buffers it was handed. A training forward's new values
(BatchNorm's running statistics) go to the collector that
:func:`apply_model` installs on every module with a ``_state_collector``
attribute for the length of the call, and come back as ``new_state``; the
state passed in is left as it was. A rematerialized forward that runs
again during the backward finds no collector installed by the first
call, so the statistics move once per step.
"""

import contextlib

import torch
from torch.func import functional_call


def _generator(module, rng):
    if isinstance(rng, torch.Generator):
        return rng
    device = next(
        (t.device for t in module.parameters()), torch.device("cpu")
    )
    return torch.Generator(device=device).manual_seed(int(rng))


def init_variables(module, rng, features=None):
    """Seeded weights, written into ``module`` in place by its
    ``init_parameters(generator)`` hook; returns ``{"params": {name:
    tensor}, "state": {name: buffer}}``.

    ``rng`` is an int seed or a ``torch.Generator`` on the module's
    device. ``features`` is accepted for the reference's signature: a
    torch module knows its shapes already."""
    del features
    if not hasattr(module, "init_parameters"):
        raise TypeError(
            "%s has no init_parameters(generator) hook; the port's zoo "
            "models define one" % type(module).__name__
        )
    module.init_parameters(_generator(module, rng))
    return {
        "params": dict(module.named_parameters()),
        "state": dict(module.named_buffers()),
    }


def split_variables(variables):
    """variables -> (params, state)."""
    return dict(variables["params"]), dict(variables.get("state", {}))


def merge_variables(params, state):
    """(params, state) -> one name -> tensor dict for ``functional_call``."""
    return {**params, **(state or {})}


def _forked_rng(rng, module):
    if rng is None:
        return contextlib.nullcontext()
    devices = [t.device.index for t in module.parameters() if t.is_cuda][:1]
    ctx = torch.random.fork_rng(devices=devices)

    @contextlib.contextmanager
    def seeded():
        with ctx:
            torch.manual_seed(int(rng))
            yield

    return seeded()


def _stateful_modules(module):
    """[(buffer-name prefix, submodule)] of the layers that collect state
    updates."""
    return [
        (name + "." if name else "", m)
        for name, m in module.named_modules()
        if hasattr(m, "_state_collector")
    ]


def apply_model(module, params, state, features, training=False, rng=None):
    """Forward pass over the given tensors. Returns ``(output,
    new_state)``.

    ``training`` sets the module's mode for the call; the buffers a
    training forward moves (BatchNorm statistics) come back in
    ``new_state``, a new dict, with ``state`` untouched. ``rng`` (an int)
    seeds the forward's random draws (dropout) without touching the
    caller's generator."""
    module.train(training)
    updates = {}
    owners = _stateful_modules(module) if training else []
    for prefix, m in owners:
        m._state_collector = (prefix, updates)
    try:
        with _forked_rng(rng, module):
            output = functional_call(
                module, merge_variables(params, state), (features,)
            )
    finally:
        for _, m in owners:
            m._state_collector = None
    if updates:
        state = {**(state or {}), **updates}
    return output, state
