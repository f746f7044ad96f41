"""Step builders, the counterpart of ``elasticdl_tpu/training/step.py``.

- :func:`make_grad_fn`      — gradients only (they leave the device)
- :func:`make_train_step`   — forward, backward and the optimizer update;
  parameters never leave the device
- :func:`make_local_update_fn` — apply given gradients with the
  worker's own optimizer
- :func:`make_forward_fn`   — eval/predict forward

PyTorch runs eagerly: each builder returns a plain function, with no
compile step. Where the reference donates its state to the jitted step,
the port updates the parameters and the optimizer state in place.

Parameters are a ``{name: tensor}`` dict (``named_parameters``) and the
model runs through ``nn/model_api.apply_model``, so a precision policy
casts them inside the differentiated function and gradients stay in the
parameters' dtype. An optimizer is a factory ``params -> Optimizer``
(the zoo's ``optimizer(lr)``): a torch optimizer holds its parameters
from construction, which an optax transformation does not.
"""

import dataclasses

import torch

from elasticdl_tpu_torch.nn.model_api import apply_model
from elasticdl_tpu_torch.training.precision import get_policy

# jax.checkpoint_policies names, validated as the reference validates them
REMAT_POLICIES = (
    "checkpoint_dots",
    "checkpoint_dots_with_no_batch_dims",
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "everything_saveable",
    "nothing_saveable",
    "offload_dot_with_no_batch_dims",
    "save_and_offload_only_these_names",
    "save_any_names_but_these",
    "save_anything_except_these_names",
    "save_from_both_policies",
    "save_only_these_names",
)


@dataclasses.dataclass
class TrainState:
    """Training state on the device: ``params`` ({name: leaf tensor that
    requires grad}), ``state`` ({name: buffer}), ``opt_state`` (the
    optimizer, bound to ``params``) and ``version``, the model version
    counter, advanced by every step."""

    params: dict
    state: dict
    opt_state: object
    version: int = 0

    @classmethod
    def create(cls, params, state, optimizer, version=0):
        """``optimizer`` is a factory ``list of params -> Optimizer``, as
        the reference calls ``optimizer.init(params)`` here."""
        params = {
            name: p.detach().requires_grad_(True) for name, p in params.items()
        }
        return cls(
            params=params,
            state=dict(state or {}),
            opt_state=optimizer(list(params.values())),
            version=int(version),
        )


AUX_LOSS_COLLECTION = "aux_loss"


def aux_loss_total(state):
    """Sum of the model's auxiliary losses (the MoE load-balancing loss in
    the reference), a float32 scalar: buffers under ``aux_loss``. No
    ported model writes one yet, so this is 0 — a 0-dim CPU tensor, which
    adds to a loss on any device and, as in the reference, promotes a
    bf16 loss to float32."""
    total = torch.zeros((), dtype=torch.float32)
    for name, value in (state or {}).items():
        if name.split(".")[0] == AUX_LOSS_COLLECTION:
            total = total.to(value.device) + value.float().sum()
    return total


def fold_in(rng, i):
    """A seed for draw ``i`` under seed ``rng`` (``jax.random.fold_in``'s
    role; the numbers differ from JAX's). None stays None."""
    if rng is None:
        return None
    return (int(rng) * 1_000_003 + int(i) + 1) % (2 ** 63 - 1)


def _split_batch(tree, n):
    """Each leaf's leading dim cut into ``n`` equal parts -> list of n
    trees."""
    if isinstance(tree, dict):
        parts = {k: _split_batch(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_split_batch(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    rows = tree.shape[0]
    if rows % n:
        raise ValueError(
            "batch dim %d not divisible by accum_steps %d" % (rows, n)
        )
    step = rows // n
    return [tree[i * step : (i + 1) * step] for i in range(n)]


def accumulate_gradients(
    grads_of, init_state, features, labels, rng, accum_steps, params_template
):
    """Microbatch gradient accumulation shared by the step builders.

    ``grads_of(state, features_mb, labels_mb, rng_mb) -> (loss, grads,
    new_state)`` runs over ``accum_steps`` equal microbatches cut from the
    leading batch dim, in order; returns the mean ``(loss, grads,
    final_state)``. ``params_template`` shapes the gradient sums."""
    micro = zip(
        _split_batch(features, accum_steps), _split_batch(labels, accum_steps)
    )
    state = init_state
    grad_sum = {
        name: torch.zeros_like(p) for name, p in params_template.items()
    }
    loss_sum = None
    for i, (f, l) in enumerate(micro):
        loss_i, grads_i, state = grads_of(state, f, l, fold_in(rng, i))
        for name, g in grads_i.items():
            grad_sum[name].add_(g)
        loss_sum = loss_i if loss_sum is None else loss_sum + loss_i
    inv = 1.0 / accum_steps
    grads = {name: g.mul_(inv) for name, g in grad_sum.items()}
    return loss_sum * inv, grads, state


def _loss_and_grads(forward, loss_fn, pol, params, state, features, labels,
                    rng):
    """(loss, grads, new_state, output) of one differentiated forward.
    A parameter the loss does not reach gets a zero gradient, as under
    ``jax.value_and_grad``."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad():
        p = leaves
        features_c = features
        if pol is not None:
            p = pol.cast_to_compute(p)
            features_c = pol.cast_to_compute(features)
        output, new_state = forward(p, state, features_c, rng)
        if pol is not None:
            output = pol.cast_output(output)
        loss = loss_fn(output, labels) + aux_loss_total(new_state)
        grads = torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True
        )
    grads = {
        name: torch.zeros_like(leaves[name]) if g is None else g
        for name, g in zip(leaves, grads)
    }
    return loss.detach(), grads, new_state, output.detach()


def make_grad_fn(module, loss_fn, precision=None):
    """``(params, state, features, labels, rng) -> (loss, grads,
    new_state, output)``; ``precision`` as in :func:`make_train_step`
    (gradients come back in the parameters' dtype)."""
    pol = get_policy(precision)
    forward = make_remat_forward(module, False)

    def step(params, state, features, labels, rng=None):
        return _loss_and_grads(
            forward, loss_fn, pol, params, state, features, labels, rng
        )

    return step


def parse_remat(value):
    """CLI string -> the step builders' ``remat``: '' -> False,
    'full'/'true'/'1' -> True, anything else must name a
    ``jax.checkpoint_policies`` policy — validated here, so a typo fails
    at construction. The port trains only full remat: a named policy is
    refused by :func:`make_remat_forward`."""
    if not value:
        return False
    if str(value).lower() in ("full", "true", "1"):
        return True
    if str(value) not in REMAT_POLICIES:
        raise ValueError(
            "unknown remat policy %r (see jax.checkpoint_policies)"
            % (value,)
        )
    return str(value)


def make_remat_forward(module, remat):
    """The training forward ``(params, state, features, rng) -> (output,
    new_state)``, optionally rematerialized: with ``remat=True`` the
    whole forward runs under ``torch.utils.checkpoint`` (non-reentrant)
    and the backward recomputes its activations instead of keeping them,
    so each layer's forward kernels launch twice per step. Named
    ``jax.checkpoint_policies`` policies have no torch counterpart yet
    and raise ``NotImplementedError``: the port never silently trains
    without the remat it was asked for."""

    def forward(p, state, features, rng):
        return apply_model(module, p, state, features, training=True, rng=rng)

    if not remat:
        return forward
    if remat is not True:
        parse_remat(remat)
        raise NotImplementedError(
            "remat policy %r is not ported yet (only full remat)" % (remat,)
        )

    def remat_forward(p, state, features, rng):
        return torch.utils.checkpoint.checkpoint(
            forward, p, state, features, rng, use_reentrant=False
        )

    return remat_forward


def make_train_step(
    module,
    loss_fn,
    pmean_axis=None,
    accum_steps=1,
    precision=None,
    remat=False,
):
    """Fused step ``(train_state, features, labels, rng) -> (train_state,
    loss)`` that updates ``train_state`` in place.

    ``accum_steps > 1``: the batch's leading dim is ``accum_steps *
    micro``; each microbatch runs forward and backward in turn (bounding
    activation memory to one microbatch) and one optimizer update applies
    the mean gradient. ``precision``: a training.precision.Policy or
    preset name; parameters are cast to ``compute_dtype`` inside the
    differentiated function and the output to ``output_dtype`` before the
    loss. ``remat``: see :func:`make_remat_forward`.

    The step drives the optimizer in ``train_state.opt_state``, which
    ``TrainState.create`` bound to the parameters, so unlike the
    reference's builder this one takes no optimizer. ``pmean_axis`` (the
    cross-device mean) belongs to the multi-device slice and raises."""
    if pmean_axis is not None:
        raise NotImplementedError(
            "make_train_step(pmean_axis=...) is not ported yet"
        )
    pol = get_policy(precision)
    forward = make_remat_forward(module, remat)

    def grads_of(params, state, features, labels, rng):
        loss, grads, new_state, _ = _loss_and_grads(
            forward, loss_fn, pol, params, state, features, labels, rng
        )
        return loss, grads, new_state

    def step(ts, features, labels, rng=None):
        if accum_steps == 1:
            loss, grads, new_state = grads_of(
                ts.params, ts.state, features, labels, rng
            )
        else:
            loss, grads, new_state = accumulate_gradients(
                lambda state, f, l, r: grads_of(ts.params, state, f, l, r),
                ts.state,
                features,
                labels,
                rng,
                accum_steps,
                ts.params,
            )
        _apply(ts.opt_state, ts.params, grads)
        ts.state = new_state
        ts.version += 1
        return ts, loss

    return step


def _apply(opt, params, grads):
    for name, p in params.items():
        p.grad = grads[name].to(p.dtype)
    opt.step()


def make_local_update_fn():
    """``(grads, opt_state, params) -> (params, opt_state)``: the
    optimizer ``opt_state`` (bound to ``params``) applies ``grads``
    ({name: tensor}) in place. The reference's builder takes the optax
    transformation; here ``opt_state`` is the optimizer itself."""

    def update(grads, opt_state, params):
        _apply(opt_state, params, grads)
        return params, opt_state

    return update


def make_forward_fn(module):
    """Inference forward ``(params, state, features) -> output``."""

    def fwd(params, state, features):
        with torch.no_grad():
            output, _ = apply_model(
                module, params, state, features, training=False
            )
        return output

    return fwd
