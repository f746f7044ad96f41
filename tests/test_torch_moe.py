"""The port's mixture of experts (``parallel/expert.py``, the LM's
``MoEMlp``) against the JAX package's, from the same numpy-seeded inputs
and one set of weights (the flax init, carried across by
``common/convert.py``):

- ``topk_gate`` (top-1 and the renormalised top-2), ``load_balancing_loss``
  (1.0 at perfect balance) and ``reference_moe`` (output and gradients);
- the routed ``moe_apply`` over four gloo CPU ranks (``make_moe_fn`` on an
  ``expert`` axis of 4 and on ``data`` x ``expert`` = 2 x 2) against the
  JAX ``make_moe_fn`` on four of conftest's host devices: output, the
  expert stacks', tokens' and gate logits' gradients, top-2, and the
  overflow case (capacity 1: the same one token served, every other row
  bitwise zero);
- the MoE ``TransformerLM`` (dense fallback) against the flax model: the
  loss with its ``aux_loss`` term and every gradient, through
  ``make_grad_fn`` and ``make_train_step``; the routed LM on the four
  ranks (``data`` x ``expert``) against the flax model on the whole
  batch;
- ``cli train`` with ``num_experts`` on the zoo's 64-token records, and
  an exported MoE member against the module it was traced from.

Tolerances (float32): outputs 1e-5 relative L2, gradients 1e-4 relative
L2; the member against its module exact.
"""

import glob
import os
import socket

import numpy as np
import pytest
import torch

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
D = 16
HIDDEN = 32
N_RANKS = 4
ROUTED_CASES = {
    # name: (mesh shape, experts, tokens, capacity factor, top-k)
    "expert4_top1": ({"expert": 4}, 4, 32, 8.0, 1),
    "data2_expert2_top1": ({"data": 2, "expert": 2}, 2, 32, 8.0, 1),
    "expert4_top2": ({"expert": 4}, 4, 32, 8.0, 2),
    "expert4_overflow": ({"expert": 4}, 4, 8, 1e-9, 1),
}
LM_CFG = dict(
    vocab_size=64, num_layers=2, num_heads=4, head_dim=16, embed_dim=64,
    mlp_dim=128, use_flash=False,
)
LM_ROUTED = dict(LM_CFG, num_experts=2, moe_capacity_factor=8.0,
                 moe_aux_loss_coef=0.1)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _expert_inputs(name):
    """(per-expert params, x, logits, output cotangent) of a routed case,
    from numpy."""
    _, n_exp, tokens, _, _ = ROUTED_CASES[name]
    rng = np.random.default_rng(sorted(ROUTED_CASES).index(name))
    experts = [
        {
            "w": rng.standard_normal((D, HIDDEN)).astype(np.float32) * 0.2,
            "wo": rng.standard_normal((HIDDEN, D)).astype(np.float32) * 0.2,
        }
        for _ in range(n_exp)
    ]
    x = rng.standard_normal((tokens, D)).astype(np.float32)
    logits = rng.standard_normal((tokens, n_exp)).astype(np.float32)
    if name == "expert4_overflow":
        x = np.ones((tokens, D), np.float32)
        logits = np.zeros((tokens, n_exp), np.float32)
        logits[:, 2] = 5.0  # everyone wants expert 2
    cot = rng.standard_normal((tokens, D)).astype(np.float32)
    return experts, x, logits, cot


def _torch_expert_fn(params, x):
    return torch.relu(x @ params["w"]) @ params["wo"]


def _lm_tokens(batch=4, length=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, LM_CFG["vocab_size"], (batch, length)).astype(np.int32)


# -- the ranks ---------------------------------------------------------------


def _routed_case(name, rank, out_dir):
    from elasticdl_tpu_torch.parallel.expert import make_moe_fn
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    shape, _, _, factor, k = ROUTED_CASES[name]
    mesh = create_mesh(shape, devices=["cpu"])
    experts, x, logits, cot = _expert_inputs(name)
    stacked = {
        key: torch.tensor(np.stack([e[key] for e in experts]),
                          requires_grad=True)
        for key in ("w", "wo")
    }
    rows = slice(None)
    if "data" in shape:
        part = x.shape[0] // shape["data"]
        i = mesh.axis("data").index
        rows = slice(i * part, (i + 1) * part)
    xt = torch.tensor(x[rows], requires_grad=True)
    lt = torch.tensor(logits[rows], requires_grad=True)
    moe = make_moe_fn(mesh, _torch_expert_fn,
                      batch_axis="data" if "data" in shape else None,
                      capacity_factor=factor, num_selected=k)
    y = moe(stacked, xt, lt)
    (y * torch.tensor(cot[rows])).sum().backward()
    # the stacks' gradient: each rank's own expert's slice, summed over
    # the expert axis, then over data (a sum loss)
    grads = {}
    for key, p in stacked.items():
        g = p.grad.clone()
        torch.distributed.all_reduce(g)
        grads[key] = g
    np.savez(
        os.path.join(out_dir, "%s-%d.npz" % (name, rank)),
        y=y.detach().numpy(), x=xt.grad.numpy(), logits=lt.grad.numpy(),
        rows=np.arange(x.shape[0])[rows],
        **{"g_" + k_: v.numpy() for k_, v in grads.items()},
    )


def _routed_lm(rank, out_dir):
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import make_grad_fn

    mesh = create_mesh({"data": 2, "expert": 2}, devices=["cpu"])
    model = tzoo.custom_model(mesh=mesh, **LM_ROUTED)
    named = dict(np.load(os.path.join(out_dir, "lm_init.npz")))
    model.load_state_dict(convert.to_state_dict(named))
    tokens = _lm_tokens()
    grad_fn = make_grad_fn(model, tzoo.loss, mesh=mesh)
    loss, grads, _, _ = grad_fn(
        dict(model.named_parameters()), dict(model.named_buffers()),
        {"tokens": tokens}, tokens,
    )
    np.savez(
        os.path.join(out_dir, "lm-%d.npz" % rank), loss=loss.numpy(),
        **{"g/" + n: g.numpy() for n, g in grads.items()},
    )


def _rank_main(rank, port, out_dir):
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank,
        world_size=N_RANKS,
    )
    try:
        for name in sorted(ROUTED_CASES):
            _routed_case(name, rank, out_dir)
        _routed_lm(rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def _jax_lm(cfg, seed=0):
    import jax

    from elasticdl_tpu.nn.model_api import init_variables
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm = jzoo.custom_model(**cfg)
    variables = init_variables(jm, jax.random.PRNGKey(seed),
                               {"tokens": _lm_tokens()})
    return jm, variables


def _jax_lm_loss_grads(jm, variables, tokens):
    """(loss with the aux term, aux term, {state_dict key: grad})."""
    import jax

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu_torch.common import convert
    from model_zoo.transformer_lm import transformer_lm as jzoo

    def loss_fn(params):
        out, st = jm.apply(
            {"params": params, "aux_loss": variables["aux_loss"]},
            {"tokens": tokens}, mutable=["aux_loss"],
        )
        aux = sum(jax.tree_util.tree_leaves(st["aux_loss"]))
        return jzoo.loss(out, tokens) + aux, aux

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    named = convert.to_state_dict(pytree_to_named_arrays(grads))
    return float(loss), float(aux), {k: v.numpy() for k, v in named.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every routed case and the routed LM on four gloo ranks; the
    directory of their results."""
    import torch.multiprocessing as mp

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays

    out = tmp_path_factory.mktemp("moe_ranks")
    _, variables = _jax_lm(dict(LM_ROUTED))
    named = pytree_to_named_arrays(variables["params"])
    np.savez(out / "lm_init.npz", **{k: np.asarray(v)
                                     for k, v in named.items()})
    mp.spawn(_rank_main, args=(_free_port(), str(out)), nprocs=N_RANKS,
             join=True)
    return out


# -- the plain functions -----------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_topk_gate_matches_jax(k):
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.expert import topk_gate as jtopk
    from elasticdl_tpu_torch.parallel.expert import topk_gate

    logits = np.random.default_rng(k).standard_normal((64, 8)).astype(
        np.float32)
    idx, gate = topk_gate(torch.tensor(logits), k)
    jidx, jgate = jtopk(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _rel(gate.numpy(), jgate) < OUT_TOL
    if k > 1:
        np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_top2_renormalises_and_keeps_the_odds():
    from elasticdl_tpu_torch.parallel.expert import top1_gate, topk_gate

    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    idx, gate = topk_gate(logits, 2)
    assert idx.tolist() == [[0, 1]]
    np.testing.assert_allclose(float(gate.sum()), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(gate[0, 0] / gate[0, 1]), np.e,
                               rtol=1e-4)
    i1, g1 = top1_gate(logits)
    assert i1.tolist() == [0] and g1.shape == (1,)


def test_load_balancing_loss_is_one_at_balance_and_matches_jax():
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.expert import load_balancing_loss as jlb
    from elasticdl_tpu_torch.parallel.expert import load_balancing_loss

    e = 8
    balanced = np.tile(np.eye(e, dtype=np.float32) * 20.0, (4, 1))
    np.testing.assert_allclose(
        float(load_balancing_loss(torch.tensor(balanced))), 1.0, rtol=1e-4)
    collapsed = np.zeros((32, e), np.float32)
    collapsed[:, 0] = 20.0
    assert float(load_balancing_loss(torch.tensor(collapsed))) > e - 1e-3
    logits = np.random.default_rng(0).standard_normal((40, e)).astype(
        np.float32)
    t = torch.tensor(logits, requires_grad=True)
    got = load_balancing_loss(t)
    got.backward()
    import jax

    want, jgrad = jax.value_and_grad(lambda x: jlb(x))(jnp.asarray(logits))
    assert abs(float(got.detach()) - float(want)) < 1e-6
    assert _rel(t.grad.numpy(), jgrad) < GRAD_TOL


@pytest.mark.parametrize("k", [1, 2])
def test_reference_moe_matches_jax(k):
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.expert import reference_moe as jref
    from elasticdl_tpu_torch.parallel.expert import reference_moe

    experts, x, logits, cot = _expert_inputs("expert4_top1")

    def jexpert(p, xx):
        return jax.nn.relu(xx @ p["w"]) @ p["wo"]

    def jloss(ps, xx, lg):
        return (jref(jexpert, ps, xx, lg, num_selected=k) * cot).sum()

    jexperts = [{kk: jnp.asarray(v) for kk, v in e.items()}
                for e in experts]
    want = jref(jexpert, jexperts, jnp.asarray(x), jnp.asarray(logits),
                num_selected=k)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jexperts, jnp.asarray(x),
                                            jnp.asarray(logits))
    texperts = [{kk: torch.tensor(v, requires_grad=True)
                 for kk, v in e.items()} for e in experts]
    xt = torch.tensor(x, requires_grad=True)
    lt = torch.tensor(logits, requires_grad=True)
    got = reference_moe(_torch_expert_fn, texperts, xt, lt, num_selected=k)
    (got * torch.tensor(cot)).sum().backward()
    assert _rel(got.detach().numpy(), want) < OUT_TOL
    for e, (te, je) in enumerate(zip(texperts, jg[0])):
        for key in ("w", "wo"):
            assert _rel(te[key].grad.numpy(), je[key]) < GRAD_TOL, (e, key)
    assert _rel(xt.grad.numpy(), jg[1]) < GRAD_TOL
    assert _rel(lt.grad.numpy(), jg[2]) < GRAD_TOL


# -- the routed form over four gloo ranks ------------------------------------


def _jax_routed(name):
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.expert import make_moe_fn as jmake
    from elasticdl_tpu.parallel.mesh import create_mesh as jmesh

    shape, _, _, factor, k = ROUTED_CASES[name]
    experts, x, logits, cot = _expert_inputs(name)
    mesh = jmesh(shape, axis_names=tuple(shape),
                 devices=jax.devices()[:N_RANKS])

    def jexpert(p, xx):
        return jax.nn.relu(xx @ p["w"]) @ p["wo"]

    moe = jmake(mesh, jexpert, batch_axis="data" if "data" in shape else None,
                capacity_factor=factor, num_selected=k)
    stacked = {key: jnp.asarray(np.stack([e[key] for e in experts]))
               for key in ("w", "wo")}

    def loss(st, xx, lg):
        return (moe(st, xx, lg) * cot).sum()

    with mesh:
        y = np.asarray(jax.jit(moe)(stacked, x, logits))
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(stacked, x, logits)
    return y, g


@pytest.mark.parametrize("name", sorted(ROUTED_CASES))
def test_moe_apply_over_gloo_ranks_matches_jax_make_moe_fn(name, ranks):
    y, (g_stack, g_x, g_logits) = _jax_routed(name)
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("%s-%d.npz" % (name, rank))))
        rows = got["rows"]
        if name == "expert4_overflow":
            # one token served, the same one; every other row bitwise 0
            served = np.abs(got["y"]).sum(axis=1) > 0
            assert served.sum() == 1
            np.testing.assert_array_equal(served,
                                          np.abs(y).sum(axis=1) > 0)
            np.testing.assert_array_equal(got["y"][~served], 0.0)
        assert _rel(got["y"], y[rows]) < OUT_TOL, rank
        assert _rel(got["x"], np.asarray(g_x)[rows]) < GRAD_TOL, rank
        assert _rel(got["logits"], np.asarray(g_logits)[rows]) < GRAD_TOL
        for key in ("w", "wo"):
            assert _rel(got["g_" + key], g_stack[key]) < GRAD_TOL, (
                rank, key)


def test_routed_moe_refuses_an_axis_that_is_not_one_expert_per_rank():
    from elasticdl_tpu_torch.parallel.expert import make_moe_fn
    from elasticdl_tpu_torch.parallel.mesh import Axis

    class _Mesh:
        axis_names = ("expert",)

        def axis(self, name):
            return Axis("expert", 2, 0, (0, 1), None)

    moe = make_moe_fn(_Mesh(), _torch_expert_fn)
    stacked = {"w": torch.zeros(4, D, HIDDEN), "wo": torch.zeros(4, HIDDEN, D)}
    with pytest.raises(ValueError, match="one expert per rank"):
        moe(stacked, torch.zeros(8, D), torch.zeros(8, 4))


def test_routed_lm_on_data_by_expert_ranks_matches_the_flax_model(ranks):
    """The routed MoE LM, each of four ranks on its data shard and its
    expert, the gradients reduced by the step's mesh path, against the
    flax model's loss (with its aux term) and gradients on the whole
    batch; capacity 8 (no overflow)."""
    jm, variables = _jax_lm(dict(LM_ROUTED))
    loss, _, grads = _jax_lm_loss_grads(jm, variables, _lm_tokens())
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("lm-%d.npz" % rank)))
        assert abs(float(got["loss"]) - loss) < 1e-5 * abs(loss), rank
        for name, want in grads.items():
            assert _rel(got["g/" + name], want) < GRAD_TOL, (rank, name)


# -- the MoE LM on one device ------------------------------------------------


def _port_lm(cfg, variables):
    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    model = tzoo.custom_model(**cfg)
    model.load_state_dict(convert.to_state_dict(
        pytree_to_named_arrays(variables["params"])))
    return model


@pytest.mark.parametrize("k", [1, 2])
def test_moe_lm_loss_aux_and_every_gradient_match_the_flax_model(k):
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.training.step import (
        aux_loss_total,
        make_grad_fn,
    )

    cfg = dict(LM_CFG, num_experts=4, moe_num_selected=k,
               moe_aux_loss_coef=0.1)
    jm, variables = _jax_lm(cfg)
    tokens = _lm_tokens()
    loss, aux, grads = _jax_lm_loss_grads(jm, variables, tokens)
    model = _port_lm(cfg, variables)
    got_loss, got_grads, new_state, _ = make_grad_fn(model, tzoo.loss)(
        dict(model.named_parameters()), dict(model.named_buffers()),
        {"tokens": tokens}, tokens,
    )
    assert aux > 0.1 * 0.99  # coef 0.1 x a balance loss >= 1
    assert abs(float(aux_loss_total(new_state)) - aux) < 1e-6
    assert abs(float(got_loss) - loss) < 1e-5 * loss
    assert sorted(got_grads) == sorted(grads)
    for name, want in grads.items():
        assert _rel(got_grads[name], want) < GRAD_TOL, name
    for e in range(4):  # every expert gets a gradient
        g = got_grads["blocks.0.moe_mlp.experts_up"][e]
        assert float(g.abs().max()) > 0, e


def test_aux_loss_enters_make_train_step_as_in_the_reference():
    """Two SGD steps of both packages' ``make_train_step``: the step's
    loss is the task loss plus the aux term, and the parameters after
    each step agree."""
    import jax
    import optax

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu.training.step import TrainState as JState
    from elasticdl_tpu.training.step import make_train_step as jmake
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.training.step import TrainState, make_train_step
    from model_zoo.transformer_lm import transformer_lm as jzoo

    cfg = dict(LM_CFG, num_experts=4, moe_num_selected=2,
               moe_aux_loss_coef=0.1)
    jm, variables = _jax_lm(cfg)
    model = _port_lm(cfg, variables)
    opt = optax.sgd(0.05)
    jts = JState.create(variables["params"],
                        {"aux_loss": variables["aux_loss"]}, opt)
    jstep = jmake(jm, jzoo.loss, opt)
    ts = TrainState.create(
        dict(model.named_parameters()), dict(model.named_buffers()),
        lambda ps: torch.optim.SGD(ps, lr=0.05),
    )
    step = make_train_step(model, tzoo.loss)
    for i in range(2):
        tokens = _lm_tokens(seed=i)
        jts, jloss = jstep(jts, {"tokens": tokens}, tokens,
                           jax.random.PRNGKey(i))
        ts, loss = step(ts, {"tokens": tokens}, tokens)
        assert abs(float(loss) - float(jloss)) < 1e-5 * float(jloss), i
        want = convert.to_state_dict(pytree_to_named_arrays(jts.params))
        for name, p in ts.params.items():
            assert _rel(p.detach().numpy(), want[name].numpy()) < OUT_TOL
    assert any("aux_loss" in n for n in ts.state)


def test_an_eval_forward_writes_no_aux_loss():
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.nn.model_api import apply_model

    model = tzoo.custom_model(num_experts=2, **LM_CFG)
    tzoo.init_parameters(model, torch.Generator().manual_seed(0))
    state = dict(model.named_buffers())
    _, new_state = apply_model(model, dict(model.named_parameters()), state,
                               {"tokens": _lm_tokens()}, training=False)
    assert new_state is state
    assert "blocks.0.moe_mlp.aux_loss.moe_balance" not in model.state_dict()


def test_moe_state_dict_round_trips_to_the_reference_names():
    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu_torch.common import convert

    cfg = dict(LM_CFG, num_experts=4)
    _, variables = _jax_lm(cfg)
    model = _port_lm(cfg, variables)
    named = pytree_to_named_arrays(variables["params"])
    back = convert.to_named(model.state_dict(), 4, 16)
    assert sorted(back) == sorted(named)
    for name, value in named.items():
        np.testing.assert_array_equal(back[name].numpy(), np.asarray(value))
    aux = pytree_to_named_arrays({"aux_loss": variables["aux_loss"]})
    state = convert.to_state_dict(aux)
    assert sorted(state) == sorted(n for n, _ in model.named_buffers())


def test_adam_state_of_the_moe_lm_crosses_both_ways():
    """A port AdamW state after one step, as optax's (mu, nu, count), and
    back into a fresh optimizer: bitwise."""
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.training.step import TrainState, make_train_step

    cfg = dict(LM_CFG, num_experts=4)
    _, variables = _jax_lm(cfg)
    model = _port_lm(cfg, variables)
    ts = TrainState.create(dict(model.named_parameters()),
                           dict(model.named_buffers()), tzoo.optimizer())
    tokens = _lm_tokens()
    make_train_step(model, tzoo.loss)(ts, {"tokens": tokens}, tokens)
    out = convert.from_train_state(ts, 4, 16)
    assert "block_0/moe_mlp/experts_up" in out["mu"]
    assert "aux_loss/block_0/moe_mlp/moe_balance" in out["batch_stats"]
    back = convert.to_train_state(
        out["params"], tzoo.optimizer(), adam=(out["mu"], out["nu"],
                                               out["count"]),
        device="cpu", batch_stats=out["batch_stats"],
    )
    for name, p in ts.params.items():
        assert torch.equal(back.params[name], p.detach()), name
        a, b = ts.opt_state.state[p], back.opt_state.state[
            back.params[name]]
        assert torch.equal(a["exp_avg"], b["exp_avg"]), name
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]), name


# -- the job and the member --------------------------------------------------


LM_DEF = "transformer_lm.transformer_lm.custom_model"
JOB_PARAMS = ("vocab_size=64,num_layers=1,num_heads=2,head_dim=16,"
              "embed_dim=32,mlp_dim=64,num_experts=4,moe_num_selected=2")


def _lm_records(directory, n=64, vocab=64):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(directory, "lm.rio")) as w:
        for _ in range(n):
            w.write(encode_example(
                {"tokens": rng.integers(0, vocab, 64).astype(np.int64)}))
    return directory


def test_cli_trains_and_exports_an_moe_lm_on_64_token_records(tmp_path):
    """``cli train`` with ``num_experts`` on the zoo's 64-token records:
    the job finishes, its artifact carries the MoE weights under the
    reference's names and the serving member, and the port's scorer
    serves the member equal to the module rebuilt from the manifest."""
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.common import export as texport
    from elasticdl_tpu_torch.serving.scorer import ScorerModel

    data = _lm_records(str(tmp_path / "data"))
    out = str(tmp_path / "out")
    assert cli.main([
        "train", "--job_name", "moe", "--model_zoo", "", "--model_def",
        LM_DEF, "--model_params", JOB_PARAMS, "--training_data", data,
        "--minibatch_size", "16", "--num_epochs", "1", "--output", out,
        "--distribution_strategy", "AllreduceStrategy", "--device", "cpu",
    ]) == 0
    (manifest,) = glob.glob(os.path.join(out, "*", "MANIFEST.json"))
    artifact = os.path.dirname(manifest)
    import json

    with open(manifest) as f:
        spec = json.load(f)
    assert spec["leaves"]["block_0/moe_mlp/experts_up"]["shape"] == [4, 32,
                                                                      64]
    assert spec["artifacts"]["torch_serving_fn"] == "serving_fn.pt2"
    model = ScorerModel(artifact, device="cpu")
    assert model.serves_member
    tokens = _lm_tokens(3, 64, seed=2)
    got = model.predict({"tokens": tokens})
    with torch.no_grad():
        want = model.rebuild()({"tokens": tokens})
    assert got.shape == (3, 64, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows", [1, 5])
def test_an_exported_moe_member_equals_its_module(tmp_path, rows):
    """The top-2 MoE LM exported with a dynamic batch: the graph traces
    ``topk`` and the gathers, and the member's replies equal the module's
    at batch sizes the trace never saw."""
    from elasticdl_tpu_torch.common import export as texport
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    model = tzoo.custom_model(num_experts=4, moe_num_selected=2, **LM_CFG)
    tzoo.init_parameters(model, torch.Generator().manual_seed(1))
    manifest = texport.export_model(
        str(tmp_path), {}, 1,
        serving_module=texport.make_serving_module(
            model, dict(model.named_parameters()),
            dict(model.named_buffers())),
        example_features={"tokens": _lm_tokens(2)},
    )
    assert manifest["artifacts"]["torch_serving_fn"] == "serving_fn.pt2"
    program = torch.export.load(str(tmp_path / "serving_fn.pt2"))
    assert not [n for n in program.graph_signature.buffers
                if "aux_loss" in n]
    tokens = _lm_tokens(rows, seed=rows)
    got = texport.load_export(str(tmp_path)).serve({"tokens": tokens},
                                                    "cpu")
    with torch.no_grad():
        want = model.eval()({"tokens": tokens})
    assert torch.equal(got, want)
