"""The port's training path against the JAX package's, from one set of
weights (the flax init, converted by ``common/convert``) and the same
numpy-seeded batches, on one JAX CPU device: ``make_grad_fn``,
``make_train_step`` (1 and 3 steps, accumulation, a precision policy,
remat), ``make_local_update_fn`` and ``AllReduceTrainer.train_step``, on
both attention branches — plain at L = 64, the flash kernels at L = 1024
(Pallas in interpret mode on the JAX side, the kernels' plain versions
through the port's autograd Function on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu.parallel.trainer import AllReduceTrainer as JTrainer
from elasticdl_tpu.training import step as jstep
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    transformer_lm as tzoo,
)
from elasticdl_tpu_torch.nn import model_api
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
from elasticdl_tpu_torch.training import precision as tprecision
from elasticdl_tpu_torch.training import step as tstep
from model_zoo.transformer_lm import transformer_lm as jzoo

CFG = dict(
    vocab_size=128, num_layers=2, num_heads=4, head_dim=16, embed_dim=64,
    mlp_dim=256,
)
TOL = {  # (rtol, atol): outputs/params, gradients and moments
    "float32": dict(out=(2e-4, 2e-5), grad=(3e-4, 3e-4)),
    "bfloat16": dict(out=(0.1, 0.1), grad=(0.1, 0.1)),
}
# the two attention branches: (sequence length, batch)
BRANCHES = {"plain": (64, 2), "flash": (1024, 1)}


def _tokens(length, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], size=(batch, length)).astype(
        np.int32
    )


def _named(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            pytree_to_named_arrays(tree).items()}


def _init(dtype, seed=0):
    """(flax model, its params (host copies), the port's model)."""
    jm = jzoo.custom_model(dtype=dtype, **CFG)
    params = init_variables(
        jm, jax.random.PRNGKey(seed), {"tokens": _tokens(8, 1)}
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, tzoo.custom_model(dtype=dtype, **CFG)


def _close(got, want, tol, what=""):
    """{reference path: array} of the port (torch or numpy) vs JAX."""
    assert sorted(got) == sorted(want), what
    rtol, atol = tol
    for name, value in want.items():
        g = got[name]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, np.asarray(value, np.float32), rtol=rtol, atol=atol,
            err_msg="%s %s" % (what, name),
        )


def _port_grads_named(grads):
    return convert.to_named(grads, CFG["num_heads"], CFG["head_dim"])


@pytest.mark.parametrize(
    "dtype,branch",
    [("float32", "plain"), ("bfloat16", "plain"), ("float32", "flash")],
)
def test_grad_fn_matches_jax(dtype, branch):
    length, batch = BRANCHES[branch]
    jm, params, tm = _init(dtype)
    tokens = _tokens(length, batch)
    j_loss, j_grads, _, j_out = jstep.make_grad_fn(jm, jzoo.loss)(
        params, {}, {"tokens": tokens}, tokens, jax.random.PRNGKey(1)
    )
    t_params = convert.to_state_dict(pytree_to_named_arrays(params))
    t_loss, t_grads, _, t_out = tstep.make_grad_fn(tm, tzoo.loss)(
        t_params, {}, {"tokens": tokens}, tokens
    )
    tol = TOL[dtype]
    # the reference's loss is float32: its aux-loss term promotes it
    assert t_loss.dtype == torch.float32
    np.testing.assert_allclose(float(t_loss), float(j_loss), *tol["out"])
    assert str(t_out.dtype) == "torch." + str(j_out.dtype)
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), *tol["out"]
    )
    _close(_port_grads_named(t_grads), _named(j_grads), tol["grad"], "grad")


def _run_both(dtype, branch, steps, **step_kwargs):
    """``steps`` train steps through both packages from one init ->
    (JAX losses, JAX state, port losses, port state as reference names)."""
    length, batch = BRANCHES[branch]
    jm, params, tm = _init(dtype)
    named0 = pytree_to_named_arrays(params)
    opt = jzoo.optimizer()
    j_ts = jstep.TrainState.create(params, {}, opt)
    j_step = jstep.make_train_step(jm, jzoo.loss, opt, **step_kwargs)
    t_ts = convert.to_train_state(named0, tzoo.optimizer(), device="cpu")
    t_step = tstep.make_train_step(tm, tzoo.loss, **step_kwargs)
    j_losses, t_losses = [], []
    for i in range(steps):
        tokens = _tokens(length, batch, seed=i + 1)
        j_ts, j_loss = j_step(
            j_ts, {"tokens": tokens}, tokens, jax.random.PRNGKey(i)
        )
        t_ts, t_loss = t_step(t_ts, {"tokens": tokens}, tokens)
        j_losses.append(float(j_loss))
        t_losses.append(float(t_loss))
    back = convert.from_train_state(t_ts, CFG["num_heads"], CFG["head_dim"])
    return j_losses, j_ts, t_losses, back


def _assert_states_close(j_ts, back, dtype):
    tol = TOL[dtype]
    adam = j_ts.opt_state[0]
    assert back["count"] == int(adam.count)
    assert back["version"] == int(j_ts.version)
    _close(back["params"], _named(j_ts.params), tol["grad"], "params")
    _close(back["mu"], _named(adam.mu), tol["grad"], "mu")
    _close(back["nu"], _named(adam.nu), tol["grad"], "nu")


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize(
    "dtype,branch",
    [("float32", "plain"), ("bfloat16", "plain"), ("float32", "flash")],
)
def test_train_step_matches_jax(dtype, branch, steps):
    j_losses, j_ts, t_losses, back = _run_both(dtype, branch, steps)
    np.testing.assert_allclose(t_losses, j_losses, *TOL[dtype]["out"])
    _assert_states_close(j_ts, back, dtype)


@pytest.mark.parametrize(
    "kwargs",
    [dict(accum_steps=2), dict(precision="mixed_bfloat16")],
    ids=["accum2", "mixed_bfloat16"],
)
def test_train_step_options_match_jax(kwargs):
    dtype = "bfloat16" if "precision" in kwargs else "float32"
    j_losses, j_ts, t_losses, back = _run_both(
        "float32", "plain", 2, **kwargs
    )
    np.testing.assert_allclose(t_losses, j_losses, *TOL[dtype]["out"])
    _assert_states_close(j_ts, back, dtype)


@pytest.mark.parametrize("branch", ["plain", "flash"])
def test_remat_equals_no_remat(branch):
    length, batch = BRANCHES[branch]
    _, params, tm = _init("float32")
    named0 = pytree_to_named_arrays(params)
    tokens = _tokens(length, batch)
    states = []
    for remat in (False, True):
        ts = convert.to_train_state(named0, tzoo.optimizer(), device="cpu")
        step = tstep.make_train_step(tm, tzoo.loss, remat=remat)
        ts, loss = step(ts, {"tokens": tokens}, tokens)
        states.append((float(loss), ts))
    (loss_a, ts_a), (loss_b, ts_b) = states
    assert loss_a == loss_b
    for name, p in ts_a.params.items():
        torch.testing.assert_close(
            ts_b.params[name], p, rtol=1e-6, atol=1e-7, msg=name
        )


def test_every_parameter_gets_a_gradient_through_the_flash_branch():
    """The regression test for detached attention: through the autograd
    Function at L = 1024 every parameter's gradient is finite and
    nonzero (``make_grad_fn`` gives zeros to a parameter the loss does
    not reach, so a detached attention shows as zero q/k/v gradients)."""
    tm = tzoo.custom_model(**CFG)
    model_api.init_variables(tm, 3)
    tokens = _tokens(1024, 1)
    params = dict(tm.named_parameters())
    loss, grads, _, _ = tstep.make_grad_fn(tm, tzoo.loss)(
        params, {}, {"tokens": tokens}, tokens
    )
    assert torch.isfinite(loss)
    assert sorted(grads) == sorted(params)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        assert float(g.abs().max()) > 0, name
    # and the flash branch was the one taken: its output carries the
    # Function's backward node
    q = torch.randn(1, 1024, 2, 8, requires_grad=True)
    out = tfa.pick_causal_attention(1024)(q, q, q)
    assert type(out.grad_fn).__name__.startswith("_FlashWithLse")


def test_local_update_fn_matches_jax():
    _, params, _ = _init("float32")
    named0 = pytree_to_named_arrays(params)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params
    )
    opt = jzoo.optimizer()
    j_params, j_opt = params, opt.init(params)
    update = jstep.make_local_update_fn(opt)
    t_ts = convert.to_train_state(named0, tzoo.optimizer(), device="cpu")
    t_update = tstep.make_local_update_fn()
    t_grads = convert.to_state_dict(pytree_to_named_arrays(grads))
    for _ in range(2):
        j_params, j_opt = update(grads, j_opt, j_params)
        t_update(t_grads, t_ts.opt_state, t_ts.params)
    back = convert.from_train_state(t_ts, CFG["num_heads"], CFG["head_dim"])
    _close(back["params"], _named(j_params), TOL["float32"]["grad"])
    _close(back["mu"], _named(j_opt[0].mu), TOL["float32"]["grad"])
    assert back["count"] == int(j_opt[0].count) == 2


@pytest.mark.parametrize("branch", ["plain", "flash"])
def test_allreduce_trainer_matches_jax(branch):
    length, batch = BRANCHES[branch]
    jm, params, tm = _init("float32")
    named0 = pytree_to_named_arrays(params)
    opt = jzoo.optimizer()
    j_trainer = JTrainer(jm, jzoo.loss, opt, devices=jax.devices()[:1])
    j_trainer.load_state(jstep.TrainState.create(params, {}, opt))
    t_trainer = AllReduceTrainer(
        tm, tzoo.loss, tzoo.optimizer(), device="cpu"
    )
    t_trainer.load_state(
        convert.to_train_state(named0, tzoo.optimizer(), device="cpu")
    )
    for i in range(2):
        tokens = _tokens(length, batch, seed=10 + i)
        j_loss = j_trainer.train_step({"tokens": tokens}, tokens)
        t_loss = t_trainer.train_step({"tokens": tokens}, tokens)
        np.testing.assert_allclose(
            float(t_loss), float(j_loss), *TOL["float32"]["out"]
        )
    assert t_trainer.version == j_trainer.version == 2
    host = t_trainer.get_host_state()
    assert all(p.device.type == "cpu" for p in host.params.values())
    assert host.opt_state["state"]
    back = convert.from_train_state(
        t_trainer.train_state, CFG["num_heads"], CFG["head_dim"]
    )
    j_host = j_trainer.get_host_state()
    _close(back["params"], _named(j_host.params), TOL["float32"]["grad"])


def test_allreduce_trainer_inits_from_its_seed():
    a = AllReduceTrainer(
        tzoo.custom_model(**CFG), tzoo.loss, tzoo.optimizer(), seed=4,
        device="cpu",
    )
    b = AllReduceTrainer(
        tzoo.custom_model(**CFG), tzoo.loss, tzoo.optimizer(), seed=4,
        device="cpu",
    )
    tokens = _tokens(64, 2)
    losses = [
        float(t.train_step({"tokens": tokens}, tokens)) for t in (a, b)
    ]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert a.version == 1 and a.num_devices == 1


def _trainer(**kwargs):
    return AllReduceTrainer(
        tzoo.custom_model(**CFG), tzoo.loss, tzoo.optimizer(), device="cpu",
        **kwargs
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda: _trainer().resize([0, 1]),
        lambda: _trainer(mesh=object()),
        lambda: _trainer(devices=[0, 1]),
    ],
    ids=["resize", "mesh", "devices"],
)
def test_unported_trainer_surfaces_raise(call):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        call()


def test_sharded_checkpoint_round_trip_is_bitwise(tmp_path):
    """save_sharded then restore_sharded into a fresh trainer: params,
    the AdamW state and the version come back bitwise, and the next step
    of both trainers gives the same loss."""
    a = _trainer(seed=1)
    for i in range(2):
        tokens = _tokens(64, 2, seed=i)
        a.train_step({"tokens": tokens}, tokens)
    a.save_sharded(str(tmp_path / "ckpt_v2"))
    b = _trainer(seed=9)
    b.init_from_batch(None)
    assert b.restore_sharded(str(tmp_path / "ckpt_v2")) == 2 == b.version
    for name, p in a.train_state.params.items():
        assert torch.equal(b.train_state.params[name], p.detach()), name
    sa = a.train_state.opt_state.state_dict()["state"]
    sb = b.train_state.opt_state.state_dict()["state"]
    for i, slots in sa.items():
        for slot, value in slots.items():
            assert torch.equal(sb[i][slot], value), (i, slot)
    tokens = _tokens(64, 2, seed=5)
    assert float(a.train_step({"tokens": tokens}, tokens)) == float(
        b.train_step({"tokens": tokens}, tokens)
    )


def test_remat_policies_validate_like_the_reference():
    assert tstep.parse_remat("") is False
    assert tstep.parse_remat("full") is True
    assert jstep.parse_remat("dots_saveable") == tstep.parse_remat(
        "dots_saveable"
    )
    for value in ("dots_savable", "nope"):
        with pytest.raises(ValueError):
            jstep.parse_remat(value)
        with pytest.raises(ValueError):
            tstep.parse_remat(value)
    assert sorted(tstep.REMAT_POLICIES) == sorted(
        n for n in dir(jax.checkpoint_policies) if not n.startswith("_")
    )
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tstep.make_remat_forward(tzoo.custom_model(**CFG), "dots_saveable")


def test_precision_policies_match_the_reference():
    from elasticdl_tpu.training import precision as jprecision

    for name in ("float32", "mixed_bfloat16", "bfloat16"):
        j, t = jprecision.get_policy(name), tprecision.get_policy(name)
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(t, field)) == "torch." + np.dtype(
                getattr(j, field)
            ).name
    with pytest.raises(ValueError):
        tprecision.get_policy("fp8")
    cast = tprecision.get_policy("mixed_bfloat16").cast_to_compute(
        {"x": torch.zeros(2), "i": torch.zeros(2, dtype=torch.int32)}
    )
    assert cast["x"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32


def test_init_variables_is_seeded_and_needs_the_hook():
    a = model_api.init_variables(tzoo.custom_model(**CFG), 7)
    b = model_api.init_variables(
        tzoo.custom_model(**CFG), torch.Generator().manual_seed(7)
    )
    params, state = model_api.split_variables(a)
    assert state == {} and sorted(params) == sorted(b["params"])
    for name, value in params.items():
        torch.testing.assert_close(value, b["params"][name], rtol=0, atol=0)
    with pytest.raises(TypeError, match="init_parameters"):
        model_api.init_variables(torch.nn.Linear(2, 2), 0)


def test_to_train_state_defaults_to_the_card(monkeypatch):
    """No device argument means the card; where torch sees none it
    raises rather than building the state on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, params, _ = _init("float32")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert.to_train_state(
            pytree_to_named_arrays(params), tzoo.optimizer()
        )
