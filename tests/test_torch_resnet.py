"""The port's ResNet-50 against the flax model of the JAX package, from one
set of weights (the flax init, perturbed so that every BatchNorm scale is
nonzero, converted by ``common/convert``) and the same numpy-seeded
images, on one JAX CPU device.

- ``BottleneckBlock``, projection with stride 2 and identity, train and
  eval mode, float32 and bfloat16: outputs and the updated batch
  statistics.
- ``ResNet50`` (10 classes, 32x32 images, batch 2, so the last stage
  normalizes over n = 2 values per channel): the eval forward in float32,
  and the eval forward and one SGD momentum train step (loss, every
  gradient, the updated statistics, the momentum trace and the
  parameters) in float64 compute, from one module-scoped JAX run. A
  training forward at n = 2 maps each channel's pair of values to about
  +-1, so a channel whose two values lie within the rounding noise of
  each other flips sign: in float32 the two packages' different
  summation orders (conv0 agrees bitwise, the stem's BatchNorm to 3e-5)
  grow through the 1024-channel stage to ~2e-3 and flip a few of the
  last stage's 2048 channels. In float64 that noise is ~1e-12, so the
  step compares the function itself; the head stays float32 in both
  (the reference's ``Dense(dtype=float32)``). The same near-coincident
  pairs make the step's gradients reach ~1e8 (the normalization's
  gradient goes as 1 / sigma), so gradients, the trace and the updated
  parameters are held per tensor, elementwise against the tensor's
  largest magnitude: the two packages agree to 6e-5 of it (at batch 8
  the gradients stay below ~1e2 and agree to 4e-7).
- Planted faults: symmetric max-pool padding and torch's unbiased running
  variance each fail the comparison.
- The converter's round trip is exact; a rematerialized step moves the
  statistics once.

Tolerances, (rtol, atol): float32 outputs and statistics (1e-4, 1e-5)
(oneDNN and XLA sum convolutions in different orders); bfloat16 outputs
(0.05, 0.05) and statistics (0.02, 0.02): one bf16 ulp is 2^-8 of a
value, and an ulp flipped in a convolution's output moves what follows it
by about that. The float64 step: loss and statistics (1e-6, 1e-7)
(they read 1.6e-7 and 4e-8); gradients, the trace and the parameters 5e-4
of each tensor's largest magnitude (they pass through the float32 head).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu.training import step as jstep
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
    imagenet_resnet50 as tzoo,
)
from elasticdl_tpu_torch.model_zoo.resnet50_subclass import (
    resnet50_model as tmodel,
)
from elasticdl_tpu_torch.nn import layers as tlayers
from elasticdl_tpu_torch.nn.model_api import apply_model
from elasticdl_tpu_torch.training import step as tstep
from model_zoo.imagenet_resnet50 import imagenet_resnet50 as jzoo
from model_zoo.resnet50_subclass import resnet50_model as jmodel

F32 = dict(out=(1e-4, 1e-5), stats=(1e-4, 1e-5))
BF16 = dict(out=(0.05, 0.05), stats=(0.02, 0.02))
F64 = dict(out=(1e-6, 1e-7), stats=(1e-6, 1e-7), scaled=5e-4)
LR, MOMENTUM = 0.02, 0.9


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=shape
    ).astype(np.uint8)


def _perturbed(variables, seed):
    """The flax variables with every BatchNorm scale and bias and every
    running statistic drawn at random (a fresh init zeroes each block's
    last scale, which would zero most gradients)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf, np.float32)
        if "'scale'" in name:
            return 1.0 + 0.2 * rng.standard_normal(leaf.shape, np.float32)
        if "'bias'" in name or "'mean'" in name:
            return 0.1 * rng.standard_normal(leaf.shape, np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def _split(variables):
    params = pytree_to_named_arrays(variables["params"])
    stats = pytree_to_named_arrays({"batch_stats": variables["batch_stats"]})
    return params, stats


def _port_vars(variables):
    params, stats = _split(variables)
    return convert.to_state_dict(params), convert.to_state_dict(stats)


def _close(got, want, tol, what):
    """{reference path: torch or numpy} vs {reference path: numpy}."""
    assert sorted(got) == sorted(want), what
    for name, value in want.items():
        g = got[name]
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, np.asarray(value, np.float32), *tol,
            err_msg="%s %s" % (what, name),
        )


def _close_scaled(got, want, tol, what):
    """Each tensor elementwise within ``tol`` of its largest magnitude."""
    assert sorted(got) == sorted(want), what
    for name, value in want.items():
        g = got[name].detach().double().numpy()
        w = np.asarray(value, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, "%s %s: %.3g of max %.3g" % (what, name, err, scale)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


BLOCK_CASES = [
    (proj, training, dtype)
    for proj in ("projection", "identity")
    for training in (True, False)
    for dtype in ("float32", "bfloat16")
]


@pytest.mark.parametrize("proj,training,dtype", BLOCK_CASES)
def test_bottleneck_block_matches_flax(proj, training, dtype):
    filters = 8
    if proj == "projection":
        cin, strides, shape = 16, 2, (2, 8, 8, 16)
    else:
        cin, strides, shape = 4 * filters, 1, (2, 6, 6, 4 * filters)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jb = jmodel.BottleneckBlock(
        filters, strides=strides, projection=proj == "projection",
        dtype=jax.numpy.dtype(dtype),
    )
    variables = _perturbed(jb.init(jax.random.PRNGKey(0), x), seed=2)
    if training:
        j_out, j_new = jb.apply(
            variables, x, training=True, mutable=["batch_stats"]
        )
    else:
        j_out, j_new = jb.apply(variables, x, training=False), None
    tb = tmodel.BottleneckBlock(
        cin, filters, strides=strides, projection=proj == "projection",
        dtype=dtype,
    )
    params, state = _port_vars(variables)
    t_in = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    t_out, t_new = apply_model(tb, params, state, t_in, training=training)
    tol = F32 if dtype == "float32" else BF16
    assert str(t_out.dtype) == "torch." + dtype
    np.testing.assert_allclose(
        _nhwc(t_out), np.asarray(j_out, np.float32), *tol["out"]
    )
    if training:
        want = pytree_to_named_arrays({"batch_stats": j_new["batch_stats"]})
        _close(convert.to_named(t_new), want, tol["stats"], "batch_stats")
        # the state handed in is left as it was
        for name, value in state.items():
            assert t_new[name] is not value


@pytest.fixture(scope="module")
def resnet_run():
    """One flax ResNet-50 (10 classes) on 32x32 images, batch 2: its
    perturbed init (float32 parameters), the float32 eval forward, and
    in float64 compute the eval forward and one SGD-momentum train step
    (one jitted step on the default, first, CPU device)."""
    images = _images((2, 32, 32, 3), seed=3)
    labels = np.array([[3], [7]], np.int32)
    jm = jmodel.ResNet50(num_classes=10)
    variables = _perturbed(
        init_variables(jm, jax.random.PRNGKey(0), images[:1]), seed=4
    )
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    eval_out_f32 = np.asarray(jm.apply(variables, images, training=False))
    with jax.enable_x64(True):
        jm = jmodel.ResNet50(num_classes=10, dtype=jax.numpy.float64)
        eval_out = np.asarray(jm.apply(variables, images, training=False))
        opt = jzoo.optimizer(LR, MOMENTUM)
        ts = jstep.TrainState.create(
            variables["params"], {"batch_stats": variables["batch_stats"]},
            opt,
        )
        step = jstep.make_train_step(jm, jzoo.loss, opt)
        new_ts, loss = step(
            ts, {"image": images}, labels, jax.random.PRNGKey(1)
        )
        new_ts = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), new_ts
        )
    trace = new_ts.opt_state[0].trace
    return {
        "images": images,
        "labels": labels,
        "variables": variables,
        "eval_out_f32": eval_out_f32,
        "eval_out": eval_out,
        "loss": float(loss),
        "params": pytree_to_named_arrays(
            jax.tree_util.tree_map(np.asarray, new_ts.params)
        ),
        "stats": pytree_to_named_arrays(
            jax.tree_util.tree_map(np.asarray, new_ts.state)
        ),
        "trace": pytree_to_named_arrays(
            jax.tree_util.tree_map(np.asarray, trace)
        ),
    }


def _port_state(run):
    params, stats = _split(run["variables"])
    return convert.to_train_state(
        params, tzoo.optimizer(LR, MOMENTUM), device="cpu",
        batch_stats=stats,
    )


def _port_step(run):
    """One float64 port train step from the run's init -> (loss, the
    step's gradients by reference path, the new train state)."""
    ts = _port_state(run)
    model = tmodel.ResNet50(num_classes=10, dtype="float64")
    ts, loss = tstep.make_train_step(model, tzoo.loss)(
        ts, {"image": run["images"]}, run["labels"]
    )
    # the step leaves each parameter's gradient in .grad
    grads = {n: p.grad for n, p in ts.params.items()}
    return float(loss), convert.to_named(grads), ts


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resnet50_eval_forward_matches_flax(resnet_run, dtype):
    params, stats = _port_vars(resnet_run["variables"])
    out, _ = apply_model(
        tmodel.ResNet50(num_classes=10, dtype=dtype), params, stats,
        {"image": resnet_run["images"]},
    )
    assert out.dtype == torch.float32
    want, tol = (
        (resnet_run["eval_out_f32"], F32["out"]) if dtype == "float32"
        else (resnet_run["eval_out"], F64["out"])
    )
    np.testing.assert_allclose(out.numpy(), want, *tol)


def test_resnet50_train_step_matches_flax(resnet_run):
    loss, grads, ts = _port_step(resnet_run)
    np.testing.assert_allclose(loss, resnet_run["loss"], *F64["out"])
    back = convert.from_train_state(ts)
    # optax's first trace is the gradient itself
    _close_scaled(grads, resnet_run["trace"], F64["scaled"], "grad")
    _close_scaled(back["trace"], resnet_run["trace"], F64["scaled"], "trace")
    _close(back["batch_stats"], resnet_run["stats"], F64["stats"], "stats")
    _close_scaled(back["params"], resnet_run["params"], F64["scaled"],
                  "params")
    assert back["version"] == 1


def _symmetric_pool(x, kernel=3, stride=2):
    return F.max_pool2d(x, kernel, stride, padding=1)


def _torch_batchnorm2d_forward(self, x):
    """torch.nn.BatchNorm2d's running update: the unbiased variance."""
    x = x.to(self.dtype)
    stat = torch.promote_types(self.dtype, torch.float32)
    running_mean = self.running_mean.to(stat, copy=True)
    running_var = self.running_var.to(stat, copy=True)
    y = F.batch_norm(
        x, running_mean, running_var, self.weight.to(stat),
        self.bias.to(stat), self.training, 1 - self.momentum, self.eps,
    )
    if self.training and self._state_collector is not None:
        prefix, updates = self._state_collector
        updates[prefix + "running_mean"] = running_mean
        updates[prefix + "running_var"] = running_var
    return y


def test_planted_symmetric_maxpool_padding_fails(resnet_run, monkeypatch):
    monkeypatch.setattr(tmodel, "max_pool_same", _symmetric_pool)
    params, stats = _port_vars(resnet_run["variables"])
    out, _ = apply_model(
        tmodel.ResNet50(num_classes=10, dtype="float64"), params, stats,
        {"image": resnet_run["images"]},
    )
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            out.numpy(), resnet_run["eval_out"], *F64["out"]
        )


def test_planted_unbiased_running_variance_fails(resnet_run, monkeypatch):
    monkeypatch.setattr(
        tlayers.BatchNorm, "forward", _torch_batchnorm2d_forward
    )
    params, stats = _port_vars(resnet_run["variables"])
    _, new_state = apply_model(
        tmodel.ResNet50(num_classes=10, dtype="float64"), params, stats,
        {"image": resnet_run["images"]}, training=True,
    )
    got = convert.to_named(new_state)
    # the means still agree; the variances do not (the last stage
    # normalizes over n = 2 values, where n / (n - 1) doubles them)
    means = {k: v for k, v in resnet_run["stats"].items()
             if k.endswith("mean")}
    _close({k: got[k] for k in means}, means, F64["stats"], "means")
    last = "batch_stats/BottleneckBlock_15/BatchNorm_0/var"
    with pytest.raises(AssertionError):
        _close({last: got[last]}, {last: resnet_run["stats"][last]},
               F64["stats"], "var")


def test_converter_round_trip_is_exact(resnet_run):
    params, stats = _split(resnet_run["variables"])
    trace = resnet_run["trace"]
    ts = convert.to_train_state(
        params, tzoo.optimizer(), device="cpu", batch_stats=stats,
        trace=trace, version=7,
    )
    back = convert.from_train_state(ts)
    for got, want in ((back["params"], params), (back["batch_stats"], stats),
                      (back["trace"], trace)):
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            assert np.array_equal(got[name].numpy(), np.asarray(value)), name
    assert back["version"] == 7


def test_remat_moves_batch_statistics_once(resnet_run):
    """A rematerialized step runs the forward again in the backward; the
    statistics must still move once: bitwise as without remat, from a
    state that the step leaves untouched."""
    model = tmodel.ResNet50(num_classes=10)
    feats = {"image": resnet_run["images"]}
    new_states = {}
    for remat in (False, True):
        ts = _port_state(resnet_run)
        handed = dict(ts.state)
        before = {k: v.clone() for k, v in handed.items()}
        ts, _ = tstep.make_train_step(model, tzoo.loss, remat=remat)(
            ts, feats, resnet_run["labels"]
        )
        for k, v in handed.items():
            assert torch.equal(v, before[k]), "the step wrote its input"
            assert not torch.equal(ts.state[k], before[k]), k
        new_states[remat] = ts.state
    for k in new_states[False]:
        assert torch.equal(new_states[True][k], new_states[False][k]), k
