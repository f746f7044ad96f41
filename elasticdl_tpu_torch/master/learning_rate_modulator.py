"""Staleness-aware learning-rate modulation, the port of
``elasticdl_tpu/master/learning_rate_modulator.py``.

In async training the master scales each apply's update by
``1 / max(1, version - request_version)``. The reference scales an optax
transformation's updates by a thread-local multiplier. A torch optimizer
is stateful and shared, so here the multiplier scales every param
group's ``lr`` for the one ``step()`` and puts it back after. For SGD
(with or without momentum), Adam and AdamW that scales the step's update
exactly as the reference's wrapper does: their update is linear in
``lr`` (AdamW's decoupled decay included), and ``lr`` enters no state.

The multiplier is one value per modulator, not per thread: the caller
sets it and applies under one lock (the servicer's apply lock), and
resets it before releasing the lock.
"""

import contextlib


class LearningRateModulator:
    def __init__(self):
        self._multiplier = 1.0

    def set_multiplier(self, multiplier):
        self._multiplier = float(multiplier)

    def get_multiplier(self):
        return self._multiplier

    @contextlib.contextmanager
    def scaled(self, optimizer):
        """Scale ``optimizer``'s learning rates by the multiplier for the
        length of the block."""
        multiplier = self._multiplier
        if multiplier == 1.0:
            yield
            return
        saved = [group["lr"] for group in optimizer.param_groups]
        for group in optimizer.param_groups:
            group["lr"] = group["lr"] * multiplier
        try:
            yield
        finally:
            for group, lr in zip(optimizer.param_groups, saved):
                group["lr"] = lr


def add_lr_modulation_to_optimizer(optimizer):
    """Wrap the torch optimizer factory ``optimizer`` (``params ->
    Optimizer``): every optimizer it builds runs each ``step()`` at the
    modulator's multiplier. Returns ``(wrapped_factory, modulator)``."""
    modulation = LearningRateModulator()

    def factory(params):
        opt = optimizer(params)
        step = opt.step

        def modulated_step(*args, **kwargs):
            with modulation.scaled(opt):
                return step(*args, **kwargs)

        opt.step = modulated_step
        return opt

    return factory, modulation
