"""The port's tensor parallelism (the ``model`` axis) against the JAX
package, from one set of flax weights loaded into every rank's parts
through ``common/convert.shard_state_dict``:

- the TP rule table (``parallel/sharding.py``) against the reference's
  on the flax layouts, ``mesh_axes``/``param_shardings`` answers and
  errors, and ``tp_degree_candidates`` over an (n, T) grid;
- the tiny LM over four gloo CPU ranks on ``model`` 2 x ``data`` 2,
  ``model`` 4 and ``seq`` 2 x ``model`` 2 (the ring with heads over
  ``model``) through ``make_grad_fn``'s mesh path, against the
  one-device flax model: the gathered logits, the loss, every gathered
  gradient; each replicated parameter's gradient bitwise the same on
  every ``model`` rank;
- three AdamW steps of ``AllReduceTrainer`` on ``data`` 2 x ``model`` 2
  against the JAX ``make_train_step`` on one device;
- the ring on ``seq`` 2 x ``model`` 2 against the JAX
  ``make_ring_attention`` on four of conftest's host devices;
- a TP checkpoint: ``load_sharded_to_host`` bitwise the gathered state,
  restored bitwise into a T = 1 trainer, a T = 1 checkpoint restored
  bitwise into the ranks' parts, and ``cli evaluate`` of the TP
  checkpoint on one CPU device against the flax model's scores of the
  same weights;
- the LM's ``cli train`` jobs (dense and MoE) run as they did before
  the zoo defined its distributed hooks.

The ranks are one spawn of four processes for the module (a function of
this module, which imports no JAX at its top). Tolerances (float32):
logits 1e-5 relative L2, the loss 1e-5 relative, gradients 1e-4, the
trained parameters 1e-5; the ring's output 1e-5, its gradients 1e-4.
"""

import functools
import os
import socket

import numpy as np
import pytest
import torch

N_RANKS = 4
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
           embed_dim=32, mlp_dim=64)
MESHES = {
    "model2_data2": {"data": 2, "model": 2},
    "model4": {"model": 4},
    "seq2_model2": {"seq": 2, "model": 2},
}
TOKENS = (4, 32)  # global batch, global length
TRAIN_MESH = {"data": 2, "model": 2}
TRAIN_STEPS = 3
OUT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
RING_SHAPE = {"seq": 2, "model": 2}
RING = (2, 8, 4, 16)  # B, L per seq rank, H (whole), D
LM_DEF = "transformer_lm.transformer_lm.custom_model"
TP_PARAMS = ",".join("%s=%d" % kv for kv in CFG.items()) + ",tensor_parallel=2"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _tokens(seed=0, shape=TOKENS):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], shape).astype(np.int32)


def _ring_inputs():
    rng = np.random.default_rng(7)
    b, l, h, d = RING
    full = (b, l * RING_SHAPE["seq"], h, d)
    return [rng.standard_normal(full).astype(np.float32) for _ in range(4)]


def _ring_part(x, seq_index, model_index):
    l, h = RING[1], RING[2] // RING_SHAPE["model"]
    return x[:, seq_index * l:(seq_index + 1) * l,
             model_index * h:(model_index + 1) * h]


# -- the ranks ---------------------------------------------------------------


def _np(t):
    return t.detach().float().numpy()


def _lm_case(name, rank, out_dir, named):
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel import collectives
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import make_grad_fn

    shape = MESHES[name]
    mesh = create_mesh(shape, devices=["cpu"])
    seq = "seq" if "seq" in shape else None
    model = tzoo.build_distributed_model(
        mesh, seq_axis=seq, tensor_parallel=shape["model"], **CFG)
    specs = tzoo.param_shardings(mesh, tensor_parallel=shape["model"])
    model.load_state_dict(convert.shard_state_dict(
        convert.to_state_dict(named), specs, mesh))
    tokens = _tokens()
    loss, grads, _, output = make_grad_fn(
        model, tzoo.loss, mesh=mesh, seq_axis=seq)(
        dict(model.named_parameters()), {}, {"tokens": tokens}, tokens)
    logits = collectives.all_gather(output, mesh.axis("model"), dim=-1)
    whole = convert.gather_state_dict(grads, specs, mesh)
    split = set(model.param_layout())
    np.savez(
        os.path.join(out_dir, "lm_%s-%d.npz" % (name, rank)),
        loss=_np(loss), logits=_np(logits),
        **{"g/" + n: _np(g) for n, g in whole.items()},
        **{"r/" + n: _np(g) for n, g in grads.items() if n not in split},
    )


def _train_case(rank, out_dir, named):
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh, shard_slices
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
    from elasticdl_tpu_torch.training.step import TrainState

    axes = tzoo.mesh_axes(N_RANKS, tensor_parallel=2)
    assert axes == TRAIN_MESH
    mesh = create_mesh(axes, devices=["cpu"])

    def trainer():
        return AllReduceTrainer(
            tzoo.build_distributed_model(mesh, tensor_parallel=2, **CFG),
            tzoo.loss, tzoo.optimizer(), mesh=mesh,
            param_specs=tzoo.param_shardings(mesh, tensor_parallel=2),
            device="cpu")

    tr = trainer()
    local = convert.shard_state_dict(
        convert.to_state_dict(named), tzoo.param_shardings(
            mesh, tensor_parallel=2), mesh)
    tr.load_state(TrainState.create(local, {}, tzoo.optimizer()))
    losses = [float(tr.train_step({"tokens": t}, t))
              for t in (_tokens(seed=i + 1) for i in range(TRAIN_STEPS))]
    host = tr.get_host_state()
    tp_dir = os.path.join(out_dir, "tp_ckpt", "ckpt_v%d" % tr.version)
    tr.save_sharded(tp_dir)
    if rank == 0:
        names = list(host.params)
        np.savez(
            os.path.join(out_dir, "train.npz"), losses=np.array(losses),
            **{"p/" + n: p.numpy() for n, p in host.params.items()},
            **{"o/%s/%s" % (names[i], slot): np.asarray(v)
               for i, slots in host.opt_state["state"].items()
               for slot, v in slots.items()},
        )
    # a T = 1 checkpoint (written by the fixture) onto this rank's parts
    t1 = os.path.join(out_dir, "t1_ckpt")
    tr1 = trainer()
    tr1.init_from_batch(None)
    version = tr1.restore_sharded(t1)
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )

    _, whole = load_sharded_to_host(t1)
    exact = True
    for n, p in tr1.train_state.params.items():
        want = whole["params/" + n]
        spec = tr1.param_specs.get(n)
        if spec is not None:
            want = want[shard_slices(spec, tuple(want.shape), mesh)]
        exact &= torch.equal(p, want)
    for i, slots in tr1.train_state.opt_state.state_dict()["state"].items():
        n = list(tr1.train_state.params)[i]
        want = whole["opt_state/%s/exp_avg_sq" % n]
        spec = tr1.param_specs.get(n)
        if spec is not None:
            want = want[shard_slices(spec, tuple(want.shape), mesh)]
        exact &= torch.equal(slots["exp_avg_sq"], want)
    np.savez(os.path.join(out_dir, "t1_onto_tp-%d.npz" % rank),
             exact=exact, version=version)


def _ring_case(rank, out_dir):
    from elasticdl_tpu_torch.parallel import ring_attention as ra
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(RING_SHAPE, devices=["cpu"])
    s, m = mesh.axis("seq").index, mesh.axis("model").index
    q, k, v, cot = (_ring_part(x, s, m) for x in _ring_inputs())
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ra.make_ring_attention(mesh, "seq", causal=True)(qt, kt, vt)
    (out * torch.tensor(cot)).sum().backward()
    np.savez(os.path.join(out_dir, "ring-%d.npz" % rank),
             out=_np(out), dq=_np(qt.grad), dk=_np(kt.grad),
             dv=_np(vt.grad), seq=s, model=m)


def _rank_main(rank, port, out_dir):
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank,
        world_size=N_RANKS,
    )
    try:
        named = dict(np.load(os.path.join(out_dir, "lm_init.npz")))
        for name in sorted(MESHES):
            _lm_case(name, rank, out_dir, named)
        _train_case(rank, out_dir, named)
        _ring_case(rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


# -- the reference -----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_lm():
    """(the flax model, its init as host arrays), made once."""
    import jax

    from elasticdl_tpu.nn.model_api import init_variables
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm = jzoo.custom_model(**CFG)
    params = init_variables(jm, jax.random.PRNGKey(0),
                            {"tokens": _tokens()})["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _named(tree):
    from elasticdl_tpu.common.tensor import pytree_to_named_arrays

    return {k: np.asarray(v, np.float32)
            for k, v in pytree_to_named_arrays(tree).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    out = tmp_path_factory.mktemp("tp_ranks")
    _, params = _jax_lm()
    named = _named(params)
    np.savez(out / "lm_init.npz", **named)
    # a T = 1 checkpoint of one AdamW step, for the ranks to restore
    t1 = AllReduceTrainer(tzoo.custom_model(**CFG), tzoo.loss,
                          tzoo.optimizer(), device="cpu")
    t1.load_state(convert.to_train_state(named, tzoo.optimizer(),
                                         device="cpu"))
    t1.train_step({"tokens": _tokens(seed=9)}, _tokens(seed=9))
    t1.save_sharded(str(out / "t1_ckpt"))
    mp.spawn(_rank_main, args=(_free_port(), str(out)), nprocs=N_RANKS,
             join=True)
    return out


def _coords(shape, rank):
    return dict(zip(shape, np.unravel_index(rank, tuple(shape.values()))))


# -- the rules and the hooks -------------------------------------------------


def test_the_tp_rules_cut_the_flax_kernels_as_the_reference_does():
    """Every parameter of the LM: the port's part of its ``state_dict``
    tensor (``shard_state_dict``, rank r of a ``model`` axis of 2) is
    the converted part of the flax kernel that the reference's spec
    (``parallel/sharding.param_spec``) gives rank r."""
    from elasticdl_tpu.parallel.sharding import param_spec as jspec
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.parallel.mesh import Axis, WorldMesh
    from elasticdl_tpu_torch.parallel.sharding import param_spec

    _, params = _jax_lm()
    named = _named(params)

    class _JMesh:
        axis_names = ("data", "model")

    class _Mesh(WorldMesh):
        def __init__(self, index):
            self.axis_names = ("data", "model")
            self._axes = {"data": Axis("data", 1, 0, (0,), None),
                          "model": Axis("model", 2, index, (0, 1), None)}

    split = set()
    for r in range(2):
        mine = convert.shard_state_dict(
            convert.to_state_dict(named), None, _Mesh(r))
        for path, value in named.items():
            spec = tuple(jspec(path, _JMesh()))
            index = tuple(
                slice(r * d // 2, (r + 1) * d // 2) if a == "model"
                else slice(None)
                for a, d in zip(spec + (None,) * value.ndim, value.shape))
            (key, want), = convert.to_state_dict(
                {path: value[index]}).items()
            assert torch.equal(mine[key], want), path
            assert any(param_spec(key, _Mesh(r))) == ("model" in spec), key
            if "model" in spec:
                split.add(key)
    assert {".".join(k.split(".")[-2:]) for k in split} == {
        "query.weight", "key.weight", "value.weight", "out.weight",
        "mlp_up.weight", "mlp_up.bias", "mlp_down.weight", "embed.weight"}


def test_mesh_axes_and_param_shardings_answer_as_the_reference():
    from model_zoo.transformer_lm import transformer_lm as jzoo

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    cases = [
        (4, {}), (4, dict(tensor_parallel=2)), (8, dict(tensor_parallel=4)),
        (4, dict(min_tensor_parallel=2)), (4, dict(pipeline_stages=2)),
        (1, dict(tensor_parallel=1)),
    ]
    for n, kw in cases:
        assert tzoo.mesh_axes(n, **kw) == jzoo.mesh_axes(n, **kw), (n, kw)
    for n, kw in [(1, dict(tensor_parallel=2)), (6, dict(tensor_parallel=4)),
                  (4, dict(tensor_parallel=2, pipeline_stages=2)),
                  (3, dict(pipeline_stages=2))]:
        with pytest.raises(ValueError) as jerr:
            jzoo.mesh_axes(n, **kw)
        with pytest.raises(ValueError) as terr:
            tzoo.mesh_axes(n, **kw)
        assert str(terr.value) == str(jerr.value)
    for kw in [dict(tensor_parallel=2, pipeline_stages=2),
               dict(tensor_parallel=2, shard_vocab=True)]:
        with pytest.raises(ValueError) as jerr:
            jzoo.param_shardings(None, **kw)
        with pytest.raises(ValueError) as terr:
            tzoo.param_shardings(None, **kw)
        assert str(terr.value) == str(jerr.value)
    # the probe: what splits, and over which axes
    assert tzoo.param_shardings(None) is jzoo.param_shardings(None) is None
    tp = tzoo.param_shardings(None, tensor_parallel=2)
    assert sorted(tp) == sorted(jzoo.param_shardings(None,
                                                     tensor_parallel=2))
    with pytest.raises(NotImplementedError, match="pipeline.*ROADMAP A9"):
        tzoo.build_distributed_model(None, pipeline_stages=2, **CFG)


def test_tp_degree_candidates_match_the_reference():
    from elasticdl_tpu.parallel.sharding import tp_degree_candidates as jtp

    from elasticdl_tpu_torch.parallel.sharding import tp_degree_candidates

    for dims in [(12, 3072, 32768), (4, 64, 64), (6, 10), (), (0, 8), (7,)]:
        for max_degree in (None, 1, 2, 4, 8):
            assert tp_degree_candidates(dims, max_degree) == jtp(
                dims, max_degree), (dims, max_degree)


def test_a_model_axis_that_does_not_divide_raises():
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.mesh import Axis, WorldMesh

    class _Mesh(WorldMesh):
        def __init__(self):
            self.axis_names = ("model",)
            self._axes = {"model": Axis("model", 3, 0, (0, 1, 2), None)}

    with pytest.raises(ValueError, match="num_heads=4 does not split"):
        tzoo.custom_model(mesh=_Mesh(), **CFG)


# -- the ranks against the reference -----------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_grads():
    """The flax model's loss, logits and gradients ({state_dict key:
    tensor}) on the whole batch, made once."""
    import jax

    from elasticdl_tpu_torch.common import convert
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm, params = _jax_lm()
    tokens = _tokens()

    def loss_fn(p):
        out = jm.apply({"params": p}, {"tokens": tokens})
        return jzoo.loss(out, tokens), out

    (loss, logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (float(loss), np.asarray(logits),
            convert.to_state_dict(_named(grads)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_the_tp_lm_matches_the_one_device_flax_model(name, ranks):
    """Each rank runs its parts (H/T heads, F/T hidden units, V/T
    vocabulary rows) on its shard of the batch; the gathered logits, the
    vocabulary-parallel loss and every gathered gradient against the
    flax model on the whole batch."""
    loss, logits, grads = _jax_grads()
    shape = MESHES[name]
    got = {r: dict(np.load(ranks / ("lm_%s-%d.npz" % (name, r))))
           for r in range(N_RANKS)}
    for rank in range(N_RANKS):
        c = _coords(shape, rank)
        want = np.split(logits, shape.get("data", 1), 0)[c.get("data", 0)]
        want = np.split(want, shape.get("seq", 1), 1)[c.get("seq", 0)]
        assert _rel(got[rank]["logits"], want) < OUT_TOL, rank
        assert abs(float(got[rank]["loss"]) - float(loss)) < (
            LOSS_TOL * float(loss)), rank
        for key, g in grads.items():
            assert _rel(got[rank]["g/" + key], g.numpy()) < GRAD_TOL, (
                rank, key)
    # the replicated parameters' gradients: the same on every model rank
    replicated = [k[2:] for k in got[0] if k.startswith("r/")]
    assert "norm.weight" in replicated and any(
        k.endswith("mlp_down.bias") for k in replicated)
    for rank in range(N_RANKS):
        for key in replicated:
            assert np.array_equal(got[rank]["r/" + key],
                                  got[0]["r/" + key]), (rank, key)


def test_allreduce_trainer_on_data_by_model_matches_the_jax_step(ranks):
    """Three AdamW steps of ``AllReduceTrainer`` over ``data`` 2 x
    ``model`` 2 from the flax init against the JAX ``make_train_step``
    on one device: every gathered parameter and Adam moment."""
    import jax

    from elasticdl_tpu.training import step as jstep
    from elasticdl_tpu_torch.common import convert
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm, params = _jax_lm()
    opt = jzoo.optimizer()
    ts = jstep.TrainState.create(params, {}, opt)
    step = jstep.make_train_step(jm, jzoo.loss, opt)
    losses = []
    for i in range(TRAIN_STEPS):
        t = _tokens(seed=i + 1)
        ts, loss = step(ts, {"tokens": t}, t, jax.random.PRNGKey(i))
        losses.append(float(loss))
    got = dict(np.load(ranks / "train.npz"))
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    want = convert.to_state_dict(_named(ts.params))
    mu = convert.to_state_dict(_named(ts.opt_state[0].mu))
    for key, w in want.items():
        assert _rel(got["p/" + key], w.numpy()) < PARAM_TOL, key
        assert _rel(got["o/%s/exp_avg" % key], mu[key].numpy()) < GRAD_TOL, (
            key)


def test_the_ring_on_seq_by_model_matches_the_jax_ring(ranks):
    import jax

    from elasticdl_tpu.parallel.mesh import create_mesh as jmesh
    from elasticdl_tpu.parallel.ring_attention import make_ring_attention

    q, k, v, cot = _ring_inputs()
    mesh = jmesh(RING_SHAPE, axis_names=tuple(RING_SHAPE),
                 devices=jax.devices()[:N_RANKS])
    ring = make_ring_attention(mesh, "seq", causal=True)

    def loss(q, k, v):
        return (ring(q, k, v) * cot).sum()

    with mesh:
        out = np.asarray(jax.jit(ring)(q, k, v))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    seen = set()
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("ring-%d.npz" % rank)))
        s, m = int(got["seq"]), int(got["model"])
        seen.add((s, m))
        assert _rel(got["out"], _ring_part(out, s, m)) < OUT_TOL, rank
        for key, want in zip(("dq", "dk", "dv"), grads):
            assert _rel(got[key], _ring_part(np.asarray(want), s, m)) < (
                GRAD_TOL), (rank, key)
    assert len(seen) == N_RANKS


# -- checkpoints and scoring -------------------------------------------------


def test_a_tp_checkpoint_restores_bitwise_onto_t1_and_back(ranks):
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    directory = ranks / "tp_ckpt" / ("ckpt_v%d" % TRAIN_STEPS)
    # a manifest a rank: the first data slice's ranks hold every leaf's
    # first replica, the other ranks' manifests list none
    manifests = sorted(os.listdir(directory))
    assert [m for m in manifests if m.startswith("manifest-")] == [
        "manifest-%d.json" % r for r in range(N_RANKS)]
    version, leaves = load_sharded_to_host(str(directory))
    assert version == TRAIN_STEPS
    got = dict(np.load(ranks / "train.npz"))
    del got["losses"]
    for key, value in got.items():
        head, _, name = key.partition("/")
        path = ("params/" if head == "p" else "opt_state/") + name
        assert np.array_equal(leaves[path].numpy(), value), path
    t1 = AllReduceTrainer(tzoo.custom_model(**CFG), tzoo.loss,
                          tzoo.optimizer(), device="cpu")
    t1.init_from_batch(None)
    assert t1.restore_sharded(str(directory)) == TRAIN_STEPS
    host = t1.get_host_state()
    for name, p in host.params.items():
        assert np.array_equal(p.numpy(), got["p/" + name]), name
    for r in range(N_RANKS):
        onto = dict(np.load(ranks / ("t1_onto_tp-%d.npz" % r)))
        assert bool(onto["exact"]) and int(onto["version"]) == 1, r


def _lm_records(directory, n=32):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG["vocab_size"], (n, 64)).astype(np.int64)
    with RecordIOWriter(os.path.join(directory, "lm.rio")) as w:
        for row in tokens:
            w.write(encode_example({"tokens": row}))
    return directory, tokens


def test_cli_evaluate_scores_a_tp_checkpoint_on_one_device(ranks, tmp_path):
    """``evaluate`` with the training job's ``--model_params``
    (``tensor_parallel=2``) scores the TP checkpoint whole on one CPU
    device: the published token accuracy is the flax model's on the
    same weights."""
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from model_zoo.transformer_lm import transformer_lm as jzoo

    val, tokens = _lm_records(str(tmp_path / "val"))
    jobs = []
    assert cli.main([
        "evaluate", "--job_name", "tp", "--model_zoo", "", "--model_def",
        LM_DEF, "--model_params", TP_PARAMS, "--minibatch_size", "8",
        "--num_minibatches_per_task", "2", "--validation_data", val,
        "--checkpoint_dir", str(ranks / "tp_ckpt"),
        "--distribution_strategy", "AllreduceStrategy", "--device", "cpu",
    ], jobs=jobs) == 0
    published = jobs[0].master.evaluation_service.published
    assert len(published) == 1 and published[0]["scored_versions"] == [
        TRAIN_STEPS]
    _, leaves = load_sharded_to_host(
        str(ranks / "tp_ckpt" / ("ckpt_v%d" % TRAIN_STEPS)))
    named = convert.to_named(
        {k[len("params/"):]: v for k, v in leaves.items()
         if k.startswith("params/")}, CFG["num_heads"], CFG["head_dim"])
    import flax

    params = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): v.numpy() for k, v in named.items()})
    logits = np.asarray(jzoo.custom_model(**CFG).apply(
        {"params": params}, {"tokens": tokens.astype(np.int32)}))
    want = jzoo.eval_metrics_fn()["token_accuracy"](tokens, logits).mean()
    np.testing.assert_allclose(
        published[0]["metrics"]["token_accuracy"], want, rtol=1e-6)


# -- the LM's jobs with the hooks defined -------------------------------------


@pytest.mark.parametrize("params", [
    "vocab_size=64,num_layers=1,num_heads=2,head_dim=16,embed_dim=32,"
    "mlp_dim=64",
    "vocab_size=64,num_layers=1,num_heads=2,head_dim=16,embed_dim=32,"
    "mlp_dim=64,num_experts=4,moe_num_selected=2",
])
def test_lm_train_jobs_run_as_before_the_hooks(params, tmp_path,
                                               monkeypatch):
    """``cli train`` of the LM (dense, and MoE) with the zoo's
    ``mesh_axes``/``param_shardings``/``build_distributed_model``
    defined ends in the bits of the same job with the hooks hidden (the
    plain ``custom_model`` on one card, as before they existed)."""
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.data import dataset as tdataset
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    data, _ = _lm_records(str(tmp_path / "data"), n=48)
    monkeypatch.setattr(tdataset.Dataset, "shuffle",
                        lambda self, *a, **k: self)
    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "5")

    def job():
        jobs = []
        assert cli.main([
            "train", "--job_name", "lm", "--model_zoo", "", "--model_def",
            LM_DEF, "--model_params", params, "--training_data", data,
            "--minibatch_size", "8", "--num_epochs", "1",
            "--distribution_strategy", "AllreduceStrategy", "--device",
            "cpu",
        ], jobs=jobs) == 0
        return jobs[0].worker.trainer.get_host_state()

    hooked = job()
    for hook in ("mesh_axes", "param_shardings", "build_distributed_model"):
        monkeypatch.delattr(tzoo, hook)
    plain = job()
    assert hooked.version == plain.version == 6
    for name, p in plain.params.items():
        assert torch.equal(hooked.params[name], p), name
