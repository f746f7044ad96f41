"""The pjit dense plane in the elastic world (tensor parallelism over a
``model`` axis in a membership-driven world) against the JAX package:

- the layout solver (``parallel/layout_solver.py``, the port's copy):
  ``solve``, ``best``, ``device_bytes``, ``predict_examples_per_sec``,
  ``memory_budget_from_env`` and ``LayoutPlanner.axes_for``/``candidates``
  equal the reference's exactly over a grid of profiles, world sizes 1-8,
  budgets and telemetry;
- the model profile of the LM (``derive_model_profile`` of the port's
  whole model on the meta device) equals the reference's of its abstract
  train state, and the master's world-size multiple and its error equal
  the reference's;
- the establish refusals raise the reference's errors, naming the same
  leaves by the reference's flax paths: the replica plane on a leaf split
  past dim 0, ``accum_steps > 1``, heads and vocabulary that do not
  divide the world, and a cross-leaf optimizer (with and without
  ``EDL_ALLOW_CROSS_LEAF_OPT``);
- four gloo CPU ranks (one module fixture): the weighted step on
  ``data`` 2 x ``model`` 2 from the flax init with data-group weights
  (1, 1) then (1, 0) against ``make_pjit_train_step`` on a 2 x 2 mesh of
  conftest's host devices (the losses and every gathered parameter
  after the two AdamW steps), weights (0, 0) leaving the state and the
  version bitwise; establish at ``data`` 2 x ``model`` 2, its per-rank
  checkpoint re-established at ``data`` 1 x ``model`` 2 and back, each
  move bitwise; a torn newest checkpoint falling back to the older one;
- the job: ``cli train --num_workers 3`` with ``tensor_parallel=2`` on
  CPU ranks, worker 1 SIGKILLed once both ranks' version-4 manifests are
  on disk: the spare parks and is promoted, the state restores bitwise
  from the checkpoint, every task runs once, each evaluation round's
  metric and outputs equal a whole-model forward of that version's
  checkpoint, and the SAVE_MODEL artifact holds the final checkpoint's
  parameters, on which the JAX package's forward (through
  ``common/convert.py``) matches the port's.

The rank processes run a function of this module, which imports no JAX
at its top. Tolerances (float32): 1e-5 absolute and 1e-4 relative;
bitwise wherever state is only moved.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
           embed_dim=32, mlp_dim=64)
CFG_PARAMS = ",".join("%s=%d" % kv for kv in CFG.items())
N_RANKS = 4
ROWS, LENGTH = 2, 16  # each rank's batch
ATOL, RTOL = 1e-5, 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _tokens(seed, shape=(ROWS, LENGTH)):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], shape).astype(np.int32)


def _hooks(params=CFG_PARAMS + ",tensor_parallel=2"):
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    return ElasticAllReduceWorker._pjit_dense_hooks(tzoo, params)


def _trainer(cfg=CFG, params=None, **kw):
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer

    params = params or ",".join(
        "%s=%d" % kv for kv in cfg.items()) + ",tensor_parallel=2"
    return ElasticDPTrainer(
        tzoo.custom_model(**cfg), tzoo.loss, kw.pop("optimizer",
                                                    tzoo.optimizer()),
        device="cpu", **_hooks(params), **kw)


def _budget_mb(profile):
    """A per-device budget the whole model's state does not fit and its
    two-way split does: the layout solver must split over ``model``."""
    return (profile.replicated_bytes + 0.75 * profile.tp_bytes) / 2 ** 20


# -- the layout solver ---------------------------------------------------------


def _profiles():
    from elasticdl_tpu_torch.parallel import layout_solver as tls

    return [
        tls.ModelProfile(1.0e6, 8.0e6, 4.0e3, 2.0e8, (1, 2, 4)),
        tls.ModelProfile(2696.0, 321024.0, 5760.0, 161856.0, (1, 2, 4)),
        tls.ModelProfile(0.0, 0.0, 0.0, 1.0e9, (1, 2, 4)),
        tls.ModelProfile(5.0e7, 9.0e8, 1.2e5, 7.0e9, (1, 2, 3, 6)),
        tls.ModelProfile(1.0e3, 1.0e3, 1.0, 1.0e3, (1,)),
    ]


def _scored(ranked):
    return [(s.layout.dp, s.layout.tp, s.layout.microbatch, s.feasible,
             s.device_bytes, s.examples_per_sec) for s in ranked]


def test_the_layout_solver_answers_as_the_reference_does():
    from elasticdl_tpu.parallel import layout_solver as jls
    from elasticdl_tpu_torch.parallel import layout_solver as tls

    telemetry = [None]
    for layout in ((4, 2, 8), (2, 1, 4)):
        for parts in ((0.0, 0.0, 0.0), (0.02, 0.01, 0.03)):
            telemetry.append((layout, 0.125, parts))
    cases = 0
    for profile in _profiles():
        jprofile = jls.ModelProfile(**profile.__dict__)
        for n in range(1, 9):
            for budget in (None, 2.5e6, 4.0e5, 1.0e9, 10.0):
                for tel in telemetry:
                    jtel = ttel = None
                    if tel is not None:
                        (dp, tp, mb), step_s, (c, d, t) = tel
                        jtel = jls.StepTelemetry(jls.Layout(dp, tp, mb),
                                                 step_s, c, d, t)
                        ttel = tls.StepTelemetry(tls.Layout(dp, tp, mb),
                                                 step_s, c, d, t)
                    want = jls.solve(n, jprofile, budget, telemetry=jtel)
                    got = tls.solve(n, profile, budget, telemetry=ttel)
                    assert _scored(got) == _scored(want), (profile, n)
                    jb = jls.best(n, jprofile, budget, telemetry=jtel)
                    tb = tls.best(n, profile, budget, telemetry=ttel)
                    assert (_scored([tb]) if tb else None) == (
                        _scored([jb]) if jb else None)
                    for scored in got:
                        lay = scored.layout
                        jlay = jls.Layout(lay.dp, lay.tp, lay.microbatch)
                        assert tls.device_bytes(lay, profile) == (
                            jls.device_bytes(jlay, jprofile))
                        assert tls.predict_examples_per_sec(
                            lay, profile, ttel) == (
                            jls.predict_examples_per_sec(
                                jlay, jprofile, jtel))
                    cases += 1
                jplan = jls.LayoutPlanner(memory_budget=budget)
                tplan = tls.LayoutPlanner(memory_budget=budget)
                assert tplan.axes_for(n) == jplan.axes_for(n) is None
                jplan.set_profile(jprofile)
                tplan.set_profile(profile)
                jplan.set_telemetry(jtel)
                tplan.set_telemetry(ttel)
                assert tplan.axes_for(n) == jplan.axes_for(n), (profile, n)
                assert tplan.candidates(n, top=3) == [
                    tls.Layout(lay.dp, lay.tp, lay.microbatch)
                    for lay in jplan.candidates(n, top=3)]
    assert cases == len(_profiles()) * 8 * 5 * len(telemetry)
    fallback = (lambda n: {"data": n // 2, "model": 2})
    assert tls.LayoutPlanner(fallback_axes_fn=fallback).axes_for(6) == (
        jls.LayoutPlanner(fallback_axes_fn=fallback).axes_for(6))
    for raw in ("", "64", "junk", "-3", "0.5"):
        env = {"EDL_LAYOUT_MEM_BUDGET_MB": raw}
        assert tls.memory_budget_from_env(env) == (
            jls.memory_budget_from_env(env))


# -- the profile and the master's multiple -------------------------------------


@pytest.mark.parametrize("extra", [
    dict(tensor_parallel=2),
    dict(min_tensor_parallel=2),
    dict(tensor_parallel=2, vocab_size=96, num_heads=6, head_dim=8,
         mlp_dim=96, num_layers=3),
], ids=["tp2", "min_tp2", "heads6_vocab96"])
def test_the_model_profile_equals_the_reference(extra):
    import jax

    from elasticdl_tpu.common.pytree import key_path_names
    from elasticdl_tpu.parallel import elastic as je
    from elasticdl_tpu_torch.parallel.elastic import (
        derive_model_profile,
        reference_state_leaves,
    )
    from model_zoo.transformer_lm import transformer_lm as jzoo

    cfg = dict(CFG, **{k: v for k, v in extra.items() if k in CFG})
    placement = {k: v for k, v in extra.items() if k not in CFG}
    params = ",".join("%s=%d" % kv for kv in dict(cfg, **placement).items())
    jm = jzoo.custom_model(**cfg)
    jt = je.ElasticDPTrainer(jm, jzoo.loss, jzoo.optimizer())
    example = ({"tokens": _tokens(0)}, _tokens(0))
    abstract = jt._abstract_ts(example)
    specs = je.build_state_specs(abstract, je.collect_sharded_paths(
        jzoo.param_shardings(None, **placement)))
    want = je.derive_model_profile(abstract, specs)
    t = _trainer(cfg, params)
    whole, probe = t._whole_model()
    assert all(p.is_meta for p in whole.parameters())
    leaves = reference_state_leaves(whole, probe, t._optimizer)
    assert derive_model_profile(leaves).__dict__ == want.__dict__
    # the leaves are the reference's, by path and shape
    flat = {"/".join(key_path_names(path)): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                abstract)[0]}
    got = {p: s for p, s, _, _ in leaves}
    for path, shape in got.items():
        ref = path.replace("opt_state/mu/", "opt_state/0/mu/").replace(
            "opt_state/nu/", "opt_state/0/nu/").replace(
            "opt_state/count", "opt_state/0/count")
        assert flat[ref] == shape, path
    assert len(got) == len(flat)
    # every process solves the same layout from it
    assert t._planner.profile is None
    t._maybe_derive_profile()
    assert t._planner.profile.__dict__ == want.__dict__


def _lm_records(directory, n=32):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            w.write(encode_example({"tokens": rng.integers(
                0, CFG["vocab_size"], 64).astype(np.int64)}))
    return directory


def test_the_world_size_multiple_equals_the_reference(tmp_path,
                                                      monkeypatch):
    from elasticdl_tpu.common.args import parse_master_args as jparse
    from elasticdl_tpu.master.master import Master as JMaster
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.master import Master

    data = _lm_records(str(tmp_path / "data"))

    def argv(zoo, workers, model_params):
        return ["--job_name", "j", "--model_zoo", zoo, "--model_def",
                "transformer_lm.transformer_lm.custom_model",
                "--model_params", model_params, "--training_data", data,
                "--minibatch_size", "8", "--distribution_strategy",
                "AllreduceStrategy", "--num_workers", str(workers)]

    def multiple(workers, model_params):
        jm = JMaster(jparse(argv(os.path.join(REPO, "model_zoo"), workers,
                                 model_params)))
        tm = Master(parse_master_args(
            argv("", workers, model_params) + ["--device", "cpu"]))
        return (tm.membership._world_multiple,
                jm.membership._world_multiple)

    cases = [(3, "tensor_parallel=2", 2), (1, "tensor_parallel=2", 1),
             (3, "min_tensor_parallel=2", 2), (2, "pipeline_stages=2", 2),
             (4, "tensor_parallel=2,min_tensor_parallel=4", 4),
             (3, "num_layers=2", 1)]
    for workers, model_params, want in cases:
        assert multiple(workers, model_params) == (want, want), model_params
    monkeypatch.setenv("EDL_WORLD_SIZE_MULTIPLE", "3")
    assert multiple(4, "num_layers=2") == (3, 3)
    monkeypatch.delenv("EDL_WORLD_SIZE_MULTIPLE")
    with pytest.raises(ValueError) as jerr:
        JMaster(jparse(argv(os.path.join(REPO, "model_zoo"), 3,
                            "tensor_parallel=4")))
    with pytest.raises(ValueError) as terr:
        Master(parse_master_args(argv("", 3, "tensor_parallel=4")
                                 + ["--device", "cpu"]))
    assert str(terr.value) == str(jerr.value)


# -- the establish refusals ----------------------------------------------------


def _jax_trainer(cfg=CFG, optimizer=None, accum_steps=1, tp=2):
    from elasticdl_tpu.parallel import elastic as je
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm = jzoo.custom_model(**cfg)
    return je.ElasticDPTrainer(
        jm, jzoo.loss, optimizer or jzoo.optimizer(),
        accum_steps=accum_steps,
        distributed_builder=lambda mesh: (
            jm, jzoo.param_shardings(mesh, tensor_parallel=tp)),
        mesh_axes_fn=lambda n: jzoo.mesh_axes(n, tensor_parallel=tp),
    )


def _jax_divisibility_error(cfg, model, mirror_steps):
    import jax
    from jax.sharding import Mesh

    from elasticdl_tpu.parallel import elastic as je
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jt = _jax_trainer(cfg)
    mesh = Mesh(np.array(jax.devices()[:model]).reshape(1, model),
                ("data", "model"))
    abstract = jt._abstract_ts(({"tokens": _tokens(0)}, _tokens(0)))
    jt._mesh = mesh
    jt._sharded_paths = je.collect_sharded_paths(
        jzoo.param_shardings(mesh, tensor_parallel=2))
    jt._state_specs = je.build_state_specs(abstract, jt._sharded_paths)
    jt.mirror_steps = mirror_steps
    with pytest.raises(ValueError) as err:
        jt._check_shard_divisibility(abstract)
    return str(err.value)


def _port_divisibility_error(cfg, model, mirror_steps):
    t = _trainer(cfg)
    t.mirror_steps = mirror_steps
    t._mesh_shape = {"data": 1, "model": model}
    with pytest.raises(ValueError) as err:
        t._check_shard_divisibility(t._reference_leaves(t._whole_model()[1]))
    return str(err.value)


@pytest.mark.parametrize("cfg,model,mirror_steps", [
    (CFG, 2, 8),
    (CFG, 3, 0),
    (dict(CFG, num_heads=6, head_dim=8, vocab_size=66, mlp_dim=96), 4, 8),
], ids=["mirror_on_tp", "heads_vocab_mlp_over_3", "heads_vocab_over_4"])
def test_the_divisibility_refusals_name_the_reference_leaves(cfg, model,
                                                             mirror_steps):
    want = _jax_divisibility_error(cfg, model, mirror_steps)
    got = _port_divisibility_error(cfg, model, mirror_steps)
    assert got == want
    assert "block_0/query/kernel" in got


def test_accum_steps_are_refused_on_the_pjit_plane(monkeypatch):
    from elasticdl_tpu.parallel import distributed as jdist
    from elasticdl_tpu.parallel.distributed import WorldSpec as JSpec
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    monkeypatch.setattr(jdist, "ensure_world", lambda spec: None)
    jt = _jax_trainer(accum_steps=2)
    with pytest.raises(ValueError) as jerr:
        jt.establish(JSpec("localhost:1", 1, 0, 1),
                     example_batch=({"tokens": _tokens(0)}, _tokens(0)))
    t = _trainer(accum_steps=2)
    t._mesh_shape = {"data": 4, "model": 2}
    with pytest.raises(ValueError) as terr:
        t._check_sharded_layout(tzoo.param_shardings(None,
                                                     tensor_parallel=2))
    assert str(terr.value) == str(jerr.value)
    assert "accum_steps > 1" in str(terr.value)


class _ClippedSGD(torch.optim.SGD):
    """SGD after a global-norm clip of every gradient it steps: the
    cross-leaf coupling of ``optax.chain(clip_by_global_norm, sgd)``."""

    def step(self, closure=None):
        torch.nn.utils.clip_grad_norm_(
            [p for g in self.param_groups for p in g["params"]], 1.0)
        return super().step(closure)


def test_a_cross_leaf_optimizer_is_refused_as_the_reference(monkeypatch):
    import optax

    from elasticdl_tpu.parallel.elastic import (
        optimizer_couples_leaves as jcouples,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import optimizer_couples_leaves

    coupled = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.1))

    def clipped(params):
        return _ClippedSGD(params, lr=0.1)

    assert jcouples(coupled) and optimizer_couples_leaves(clipped)
    for jopt, topt in ((optax.sgd(0.1), lambda p: torch.optim.SGD(p, 0.1)),
                       (optax.adam(1e-3), lambda p: torch.optim.Adam(p)),
                       (optax.adamw(3e-3), tzoo.optimizer())):
        assert not jcouples(jopt) and not optimizer_couples_leaves(topt)
    messages = {}
    for allowed in (False, True):
        if allowed:
            monkeypatch.setenv("EDL_ALLOW_CROSS_LEAF_OPT", "1")
        jt = _jax_trainer(optimizer=coupled)
        jt._sharded_paths = {("query", "kernel"): None}
        t = _trainer(optimizer=clipped)
        t._sharded_paths = {("query", "weight"): None}
        if allowed:
            jt._check_optimizer_coupling()
            t._check_optimizer_coupling()
            continue
        for name, tr in (("jax", jt), ("port", t)):
            with pytest.raises(ValueError) as err:
                tr._check_optimizer_coupling()
            messages[name] = str(err.value)
    assert messages["port"] == messages["jax"]
    assert "EDL_ALLOW_CROSS_LEAF_OPT" in messages["port"]


def _left_cases():
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel import mesh as tmesh
    from elasticdl_tpu_torch.parallel.mesh import PadDim0
    from elasticdl_tpu_torch.parallel.mesh import PartitionSpec as P
    from elasticdl_tpu_torch.training.step import make_train_step

    def layout(specs, mirror_steps=0):
        t = _trainer()
        t.mirror_steps = mirror_steps
        t._mesh_shape = {"data": 1, "model": 2}
        t._check_sharded_layout(specs)

    def pipe_layout():
        t = _trainer()
        t._mesh_shape = {"data": 2, "pipe": 2}
        t._check_sharded_layout({"pipe": {"stages": {"**": P("pipe")}}})

    def unpadded_layout():
        t = _trainer()
        t._mesh_shape = {"data": 3, "model": 1}
        t._check_sharded_layout({"embed": {"weight": P("data", None)}})

    tp = tzoo.param_shardings(None, tensor_parallel=2)
    return {
        "pmean_axis": (lambda: make_train_step(
            tzoo.custom_model(**CFG), tzoo.loss, pmean_axis="seq",
            mesh=tmesh.create_mesh({"data": 1}, devices=["cpu"])),
            ValueError, "has no axis 'seq'"),
        "resize": (lambda: _trainer().resize(["cpu", "cpu"]),
                   NotImplementedError, "resize.*A9.2.3"),
        "pad_dim0": (unpadded_layout, ValueError,
                     "embed/embedding: dim 0 .*3 devices.*mark the spec "
                     "PadDim0"),
        "collective_plane": (pipe_layout, NotImplementedError,
                             "pipe.*stage stacks.*A9.3"),
        "mirrors": (lambda: layout(dict(tp, embed={
            "weight": PadDim0(P("model", None))}), mirror_steps=8),
            ValueError, "replica plane.*leading-dim"),
    }


@pytest.mark.parametrize("case", ["pmean_axis", "resize", "pad_dim0",
                                  "collective_plane", "mirrors"])
def test_what_is_left_of_the_sharded_planes_raises_by_name(case):
    """What the sharded planes still refuse, now that ``pmean_axis``,
    ``PadDim0`` and the collective plane's step are ported
    (tests/test_torch_elastic_collective.py): a pmean over an axis the
    mesh lacks; ``resize`` (ROADMAP A9.2.3); an unmarked split leaf that
    does not divide the world (the reference's ValueError, which names
    PadDim0); a split leaf that must also be reduced over another axis,
    the pipeline's stage stacks (A9.3); and the mirrors over a leaf split
    past dim 0 (the reference's ValueError), a PadDim0 marker
    notwithstanding."""
    call, exc, match = _left_cases()[case]
    with pytest.raises(exc, match=match):
        call()


def test_the_replica_plane_raises_by_name_on_the_collective_plane():
    """With no split leaf past dim 0 the mirrors are what is missing:
    NotImplementedError naming ROADMAP A2 and the checkpoint fallback."""
    from elasticdl_tpu_torch.parallel.mesh import PartitionSpec as P

    t = _trainer()
    t.mirror_steps = 8
    t._mesh_shape = {"data": 2, "model": 1}
    with pytest.raises(NotImplementedError,
                       match="ShardMirror.*A2.*replica_refresh_steps 0"):
        t._check_sharded_layout({"embed": {"weight": P("data", None)}})


# -- four gloo ranks -----------------------------------------------------------


def _gathered(trainer):
    """The whole state of a sharded trainer (every rank calls it): its
    parameters and AdamW moments by name, and the version."""
    host = trainer.get_host_state()
    names = list(host.params)
    out = {"p/" + n: p.numpy() for n, p in host.params.items()}
    for i, slots in host.opt_state["state"].items():
        for slot, v in slots.items():
            out["o/%s/%s" % (names[i], slot)] = np.asarray(v)
    out["version"] = np.array(host.version)
    return out


def _rank_main(rank, ports, out_dir, budget_mb):
    os.environ["EDL_LAYOUT_MEM_BUDGET_MB"] = str(budget_mb)
    os.environ["EDL_WORLD_INIT_TIMEOUT"] = "60"
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        ShardedCheckpointManager,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.distributed import WorldSpec
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.training.step import TrainState

    def save(name, **arrays):
        np.savez(os.path.join(out_dir, "%s-%d.npz" % (name, rank)),
                 **arrays)

    named = dict(np.load(os.path.join(out_dir, "lm_init.npz")))
    t = _trainer()
    example = ({"tokens": _tokens(rank)}, _tokens(rank))
    t.establish(WorldSpec("127.0.0.1:%d" % ports[0], N_RANKS, rank, 1),
                example_batch=example)
    with pytest.raises(ValueError, match="restores its state"):
        t.load_host_state(TrainState.create(convert.to_state_dict(named),
                                            {}, tzoo.optimizer()))
    # the flax init, cut to this rank's parts
    t.load_state(TrainState.create(convert.shard_state_dict(
        convert.to_state_dict(named),
        tzoo.param_shardings(t._mesh, tensor_parallel=2), t._mesh), {},
        tzoo.optimizer()))
    mesh1 = t.mesh_shape
    # the weighted step: data-group weights (1, 1), then (1, 0)
    losses, lives = [], []
    for step in range(2):
        feed = _tokens(100 * step + rank)
        if step == 1 and rank >= 2:
            loss, live, _ = t.train_step(None, None, ROWS)
        else:
            loss, live, _ = t.train_step({"tokens": feed}, feed, ROWS)
        losses.append(loss)
        lives.append(live)
    trained = _gathered(t)
    # (0, 0): no live process, nothing moves
    before = (state_digest(t.train_state), t.version)
    _, live0, _ = t.train_step(None, None, ROWS)
    after = (state_digest(t.train_state), t.version)
    save("step", losses=np.array(losses), lives=np.array(lives),
         live0=live0, unchanged=before == after, mesh=json.dumps(mesh1),
         **trained)
    # establish moves: data 2 x model 2 -> data 1 x model 2 -> back
    ckpt_a = ShardedCheckpointManager(os.path.join(out_dir, "a"), 1)
    ckpt_a.set_expected_writers(N_RANKS)
    ckpt_a.save(t.train_state, t.version, parts=t.checkpoint_parts())
    t.leave()
    ckpt_b = ShardedCheckpointManager(os.path.join(out_dir, "b"), 1)
    if rank < 2:
        t.restore_provider = ckpt_a.dirs_newest_first
        t.establish(WorldSpec("127.0.0.1:%d" % ports[1], 2, rank, 2))
        save("moved_to_2", mesh=json.dumps(t.mesh_shape),
             restored=str(t.establish_times["restored_from"]),
             **_gathered(t))
        ckpt_b.save(t.train_state, t.version, parts=t.checkpoint_parts())
        t.leave()
    t.restore_provider = ckpt_b.dirs_newest_first
    t.establish(WorldSpec("127.0.0.1:%d" % ports[2], N_RANKS, rank, 3))
    save("moved_to_4", mesh=json.dumps(t.mesh_shape), **_gathered(t))
    if rank == 0:
        # a torn newer version: only this rank's manifest lands
        ckpt_b.save(t.train_state, 5, parts=t.checkpoint_parts())
    t.eval_have_consensus(False)  # the torn write has landed everywhere
    t.leave()
    t.establish(WorldSpec("127.0.0.1:%d" % ports[3], N_RANKS, rank, 4))
    save("torn", restored=str(t.establish_times["restored_from"]),
         **_gathered(t))
    t.leave()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' records, from one spawn: the flax init goes in,
    the budget makes the solver lay out ``data`` 2 x ``model`` 2 at
    four ranks and ``data`` 1 x ``model`` 2 at two."""
    import torch.multiprocessing as mp

    from elasticdl_tpu_torch.parallel.elastic import derive_model_profile

    out = tmp_path_factory.mktemp("elastic_tp_ranks")
    _, params = _jax_lm()
    np.savez(out / "lm_init.npz", **_named(params))
    t = _trainer()
    profile = derive_model_profile(t._reference_leaves(t._whole_model()[1]))
    ports = [_free_port() for _ in range(4)]
    mp.spawn(_rank_main, args=(ports, str(out), _budget_mb(profile)),
             nprocs=N_RANKS, join=True)
    return out


def _rank_records(root, name, ranks=range(N_RANKS)):
    return [dict(np.load(root / ("%s-%d.npz" % (name, r)))) for r in ranks]


def _jax_lm(cfg=CFG):
    import jax

    from elasticdl_tpu.nn.model_api import init_variables
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm = jzoo.custom_model(**cfg)
    params = init_variables(jm, jax.random.PRNGKey(0),
                            {"tokens": _tokens(0)})["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _named(tree):
    from elasticdl_tpu.common.tensor import pytree_to_named_arrays

    return {k: np.asarray(v, np.float32)
            for k, v in pytree_to_named_arrays(tree).items()}


def test_the_weighted_step_matches_make_pjit_train_step(ranks):
    """Data-group weights (1, 1) then (1, 0) on ``data`` 2 x ``model``
    2, from the flax init: each step's loss and, after both AdamW steps,
    every gathered parameter and Adam moment against the reference's
    GSPMD step on a 2 x 2 mesh of host devices, whose global batch is the
    ranks' rows in rank order and whose per-device weights are each
    rank's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from elasticdl_tpu.parallel import elastic as je
    from elasticdl_tpu.training import step as jstep
    from elasticdl_tpu_torch.common import convert
    from model_zoo.transformer_lm import transformer_lm as jzoo

    got = _rank_records(ranks, "step")
    assert {json.dumps(json.loads(str(g["mesh"])), sort_keys=True)
            for g in got} == {'{"data": 2, "model": 2}'}
    jm, params = _jax_lm()
    opt = jzoo.optimizer()
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]).reshape(2, 2),
                ("data", "model"))
    ts = jstep.TrainState.create(params, {}, opt)
    specs = je.build_state_specs(ts, je.collect_sharded_paths(
        jzoo.param_shardings(mesh, tensor_parallel=2)))
    step = je.make_pjit_train_step(jm, jzoo.loss, opt, mesh, specs)
    losses, last = [], {}
    for i, weights in enumerate(((1, 1, 1, 1), (1, 1, 0, 0))):
        rows = []
        for r, w in enumerate(weights):
            if w:
                last[r] = _tokens(100 * i + r)
            rows.append(last[r])
        batch = np.concatenate(rows)
        with mesh:
            ts, loss, n, _ = step(
                ts, {"tokens": batch}, batch,
                np.array(weights, np.float32),
                np.zeros(N_RANKS, np.int32), jax.random.PRNGKey(i))
        losses.append(float(loss))
        assert int(n) == sum(weights)
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        assert list(g["lives"]) == [4, 2]
    want = convert.to_state_dict(_named(ts.params))
    mu = convert.to_state_dict(_named(ts.opt_state[0].mu))
    nu = convert.to_state_dict(_named(ts.opt_state[0].nu))
    assert int(jnp.asarray(ts.version)) == 2
    for g in got:
        assert int(g["version"]) == 2
        for key, w in want.items():
            np.testing.assert_allclose(g["p/" + key], w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
            np.testing.assert_allclose(g["o/%s/exp_avg" % key],
                                       mu[key].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
            np.testing.assert_allclose(g["o/%s/exp_avg_sq" % key],
                                       nu[key].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_no_live_data_group_leaves_the_state_and_version_bitwise(ranks):
    for g in _rank_records(ranks, "step"):
        assert int(g["live0"]) == 0
        assert bool(g["unchanged"])


def test_establish_moves_between_layouts_bitwise(ranks):
    """data 2 x model 2 -> its per-rank checkpoint restored at data 1 x
    model 2 -> that world's checkpoint restored at data 2 x model 2:
    every gathered parameter and optimizer slot bitwise the trained
    state's, each rank reading its own parts."""
    trained = _rank_records(ranks, "step")[0]
    keys = [k for k in trained if k.startswith(("p/", "o/"))]
    for name, ranks_in, mesh in (("moved_to_2", range(2),
                                  {"data": 1, "model": 2}),
                                 ("moved_to_4", range(N_RANKS),
                                  {"data": 2, "model": 2})):
        for g in _rank_records(ranks, name, ranks_in):
            assert json.loads(str(g["mesh"])) == mesh
            assert int(g["version"]) == 2
            for k in keys:
                assert np.array_equal(g[k], trained[k]), (name, k)
    for g in _rank_records(ranks, "moved_to_2", range(2)):
        assert str(g["restored"]).endswith(os.path.join("a", "ckpt_v2"))


def test_a_torn_newest_checkpoint_falls_back_to_the_older_one(ranks):
    """ckpt_v5 holds rank 0's manifest alone: every rank restores ckpt_v2
    instead, bitwise, and the version is set past the torn one (later
    saves must not reuse its directory)."""
    trained = _rank_records(ranks, "step")[0]
    for g in _rank_records(ranks, "torn"):
        assert str(g["restored"]).endswith(os.path.join("b", "ckpt_v2"))
        assert int(g["version"]) == 5
        for k in trained:
            if k.startswith(("p/", "o/")):
                assert np.array_equal(g[k], trained[k]), k


# -- the job -------------------------------------------------------------------

# the port's LM, its records parsed as the zoo parses them, without the
# training shuffle: a 1,024-record buffer would let the first worker
# fetch every task of this small job before its peers prime
ZOO_MODULE = textwrap.dedent(
    """
    from elasticdl_tpu_torch.model_zoo.transformer_lm.transformer_lm import *  # noqa
    from elasticdl_tpu_torch.model_zoo.transformer_lm.transformer_lm import (
        FixedLenFeature, Mode, np, parse_example)


    def dataset_fn(dataset, mode, _):
        def _parse_data(record):
            r = parse_example(
                record, {"tokens": FixedLenFeature([64], np.int64)})
            tokens = r["tokens"].astype(np.int32)
            if mode == Mode.PREDICTION:
                return {"tokens": tokens}
            return {"tokens": tokens}, tokens

        return dataset.map(_parse_data)
    """
)
JOB_RECORDS, JOB_BATCH, VAL_RECORDS = 256, 8, 8
JOB_LIMIT_S = 150

LAUNCHER = textwrap.dedent(
    """
    import glob, json, os, sys, threading, time
    import numpy as np
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, cfg["repo"])
    os.environ["EDL_WORKER_TIMELINE_DIR"] = cfg["timeline"]
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    reports = []
    orig = MasterServicer.report_evaluation_metrics

    def spy(servicer, version, outputs, labels, scored_version=None):
        np.savez(os.path.join(cfg["out"], "report-%d.npz" % len(reports)),
                 output=outputs["output"], labels=labels)
        reports.append([version, scored_version])
        return orig(servicer, version, outputs, labels,
                    scored_version=scored_version)

    MasterServicer.report_evaluation_metrics = spy
    jobs, rc = [], []
    runner = threading.Thread(
        target=lambda: rc.append(cli.main(cfg["argv"], jobs=jobs)),
        daemon=True)
    runner.start()
    while not jobs and runner.is_alive():
        time.sleep(0.01)
    master = jobs[0].master
    done = []
    report = master.task_d.report

    def counting(task_id, success, exec_counters=None):
        if success:
            done.append(task_id)
        return report(task_id, success, exec_counters)

    master.task_d.report = counting
    first = os.path.join(cfg["ckpt"], "ckpt_v4", "manifest-*.json")
    while len(glob.glob(first)) < 2 and runner.is_alive():
        time.sleep(0.01)
    killed = {"version": master.master_servicer.get_model_version(),
              "t": time.time()}
    master.instance_manager.kill_worker(1)
    runner.join()
    print(json.dumps({
        "rc": rc[0] if rc else None, "done": done,
        "finished": master.task_d.finished(),
        "exit_codes": {str(k): v for k, v in
                       master.instance_manager.exit_codes.items()},
        "published": master.evaluation_service.published,
        "reports": reports, "killed": killed,
    }, default=float))
    """
)


def _timeline(root):
    events = {}
    for path in glob.glob(os.path.join(root, "worker-*.jsonl")):
        wid = int(os.path.basename(path)[len("worker-"):-len(".jsonl")])
        with open(path) as f:
            events[wid] = [json.loads(line) for line in f]
    return events


def _of(events, kind):
    return [e for e in events if e["event"] == kind]


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    """``cli train`` of the LM with ``tensor_parallel=2`` and three
    workers on CPU ranks, worker 1 SIGKILLed once both ranks' ckpt_v4
    manifests are on disk."""
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter
    from elasticdl_tpu_torch.parallel.elastic import derive_model_profile

    root = tmp_path_factory.mktemp("elastic_tp_job")
    zoo = root / "zoo" / "lm_tp"
    zoo.mkdir(parents=True)
    (zoo / "lm_tp.py").write_text(ZOO_MODULE)
    rng = np.random.default_rng(0)
    for name, n in (("data", JOB_RECORDS), ("val", VAL_RECORDS)):
        (root / name).mkdir()
        with RecordIOWriter(str(root / name / "f0")) as w:
            for _ in range(n):
                w.write(encode_example({"tokens": rng.integers(
                    0, CFG["vocab_size"], 64).astype(np.int64)}))
    t = _trainer()
    profile = derive_model_profile(t._reference_leaves(t._whole_model()[1]))
    argv = [
        "train", "--job_name", "tp", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "3", "--model_zoo",
        str(root / "zoo"), "--model_def", "lm_tp.lm_tp.custom_model",
        "--model_params", CFG_PARAMS + ",tensor_parallel=2",
        "--training_data", str(root / "data"), "--validation_data",
        str(root / "val"), "--evaluation_steps", "4", "--minibatch_size",
        str(JOB_BATCH), "--num_minibatches_per_task", "1", "--num_epochs",
        "1", "--checkpoint_dir", str(root / "ckpt"), "--checkpoint_steps",
        "1", "--keep_checkpoint_max", "0", "--replica_refresh_steps", "0",
        "--output", str(root / "export"), "--restart_policy", "Never",
        "--device", "cpu", "--log_level", "WARNING",
    ]
    cfg = dict(repo=REPO, argv=argv, timeline=str(root / "timeline"),
               ckpt=str(root / "ckpt"), out=str(root))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               EDL_LAYOUT_MEM_BUDGET_MB=str(_budget_mb(profile)))
    proc = subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=env)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, stderr = proc.communicate()
        pytest.fail("the job did not finish within %d s: %s"
                    % (JOB_LIMIT_S, stderr[-3000:]))
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, stderr[-4000:]
    result = json.loads(stdout.strip().splitlines()[-1])
    result["events"] = _timeline(cfg["timeline"])
    result["root"] = root
    return result


def _parts_digest(directory, rank, mesh_shape):
    """The state digest of ``rank``'s parts of a checkpoint's
    parameters on a ``mesh_shape`` world, read from the files."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.parallel.mesh import Axis, WorldMesh, shard_slices
    from elasticdl_tpu_torch.parallel.sharding import param_spec
    from elasticdl_tpu_torch.training.step import TrainState

    class _Mesh(WorldMesh):
        def __init__(self):
            names = tuple(mesh_shape)
            sizes = tuple(mesh_shape[a] for a in names)
            coords = np.unravel_index(rank, sizes)
            self.axis_names = names
            self._axes = {a: Axis(a, n, c, (), None)
                          for a, n, c in zip(names, sizes, coords)}

    mesh = _Mesh()
    _, leaves = load_sharded_to_host(directory)
    params = {}
    for path, t in leaves.items():
        if path.startswith("params/"):
            name = path[len("params/"):]
            params[name] = t[shard_slices(param_spec(name, mesh),
                                          tuple(t.shape), mesh)]
    return state_digest(TrainState(params, {}, None))


def test_the_tp_job_parks_a_spare_and_promotes_it(tp_job):
    r = tp_job
    assert r["rc"] == 0 and r["finished"]
    assert r["exit_codes"] == {"0": 0, "1": -signal.SIGKILL, "2": 0}
    ev = r["events"]
    # the first world is workers 0 and 1; worker 2 parks, hands its
    # fetched tasks back, and joins the world the death re-forms
    first = [e for w in (0, 1) for e in _of(ev[w], "established")
             if e["version"] == 0]
    assert sorted(e["rank"] for e in first) == [0, 1]
    assert all(e["mesh"] == {"data": 1, "model": 2} for e in first)
    kinds = [e["event"] for e in ev[2]]
    assert kinds.index("spare") < kinds.index("established")
    (promoted,) = _of(ev[2], "established")
    assert promoted["t"] >= r["killed"]["t"]
    assert promoted["size"] == 2 and promoted["mesh"] == {
        "data": 1, "model": 2}


def test_the_tp_job_restores_the_checkpoint_bitwise(tp_job):
    """Both ranks of the re-formed world restore the newest checkpoint
    every rank can read, each rank's parts bitwise the files', and the
    version continues from it (or past a torn newer directory)."""
    r = tp_job
    ev = r["events"]
    reformed = [e for w in (0, 2) for e in _of(ev[w], "established")
                if e["t"] >= r["killed"]["t"]]
    assert sorted(e["rank"] for e in reformed) == [0, 1]
    restored = {e["restored_from"] for e in reformed}
    assert len(restored) == 1
    directory = restored.pop()
    version = int(os.path.basename(directory)[len("ckpt_v"):])
    assert version >= 4
    for e in reformed:
        assert e["restored_version"] == version
        assert e["version"] >= version
        assert e["digest"] == _parts_digest(directory, e["rank"],
                                            e["mesh"])


def test_the_tp_job_runs_every_task_once(tp_job):
    r = tp_job
    training = JOB_RECORDS // JOB_BATCH
    rounds = len(r["published"])
    assert rounds >= 3
    # training tasks, SAVE_MODEL, and one evaluation task a round
    assert len(r["done"]) == len(set(r["done"])) == training + 1 + rounds


def _whole_forward(directory, tokens):
    """The whole LM's logits on ``tokens`` from a checkpoint's
    parameters, on the CPU."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.training.step import make_forward_fn

    _, leaves = load_sharded_to_host(directory)
    params = {k[len("params/"):]: v for k, v in leaves.items()
              if k.startswith("params/")}
    model = tzoo.custom_model(**CFG)
    return make_forward_fn(model)(params, {}, {"tokens": tokens}).numpy()


def test_the_collective_evaluation_equals_the_whole_model(tp_job):
    """Each round's outputs and token accuracy against the whole model's
    forward of the checkpoint at the version the round scored."""
    r = tp_job
    root = r["root"]
    # a round scores the version its task is taken at: the one it pinned
    # or, when the task lands just after the ranks looked, the next
    for p in r["published"]:
        (scored,) = p["scored_versions"]
        assert p["version"] <= scored <= p["version"] + 1
    for i, (version, scored) in enumerate(r["reports"]):
        got = dict(np.load(root / ("report-%d.npz" % i)))
        labels = got["labels"]
        want = _whole_forward(str(root / "ckpt" / ("ckpt_v%d" % scored)),
                              labels)
        np.testing.assert_allclose(got["output"], want, rtol=RTOL,
                                   atol=ATOL)
        acc = float(np.mean(np.argmax(want[:, :-1], -1) == labels[:, 1:]))
        (round_,) = [p for p in r["published"] if p["version"] == version]
        assert round_["metrics"]["token_accuracy"] == pytest.approx(acc)
    assert len(r["reports"]) == len(r["published"])


def test_the_tp_job_exports_the_final_state(tp_job):
    """The SAVE_MODEL artifact holds the newest checkpoint's parameters
    (the final state every rank wrote), its serving member answers as
    the whole model does, and the JAX package's forward on the same
    parameters (through ``common/convert.py``) matches the port's."""
    import jax

    from elasticdl_tpu.common.tensor import named_arrays_to_pytree
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.export import load_export
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from model_zoo.transformer_lm import transformer_lm as jzoo

    r = tp_job
    root = r["root"]
    (manifest,) = glob.glob(str(root / "export" / "*" / "MANIFEST.json"))
    artifact = load_export(os.path.dirname(manifest))
    with open(manifest) as f:
        assert json.load(f)["artifacts"]["torch_serving_fn"]
    newest = max(glob.glob(str(root / "ckpt" / "ckpt_v*")),
                 key=lambda d: int(os.path.basename(d)[len("ckpt_v"):]))
    version, leaves = load_sharded_to_host(newest)
    finals = [_of(r["events"][w], "final")[0] for w in (0, 2)]
    assert {f["version"] for f in finals} == {version}
    params = {k[len("params/"):]: v for k, v in leaves.items()
              if k.startswith("params/")}
    exported = convert.to_state_dict(artifact.named)
    assert sorted(exported) == sorted(params)
    for k, v in params.items():
        assert torch.equal(exported[k], v), k
    # each rank's final parts are the final checkpoint's, bitwise
    for w, final in zip((0, 2), finals):
        (e,) = [x for x in _of(r["events"][w], "established")
                if x["t"] >= r["killed"]["t"]]
        assert final["digest"] == _parts_digest(newest, e["rank"],
                                                e["mesh"])
    tokens = _tokens(7, (4, 64))
    whole = _whole_forward(newest, tokens)
    served = artifact.serve({"tokens": tokens}, "cpu")
    np.testing.assert_allclose(np.asarray(served), whole, rtol=RTOL,
                               atol=ATOL)
    jm = jzoo.custom_model(**CFG)
    template = jm.init(jax.random.PRNGKey(0), {"tokens": tokens})["params"]
    jparams = named_arrays_to_pytree(
        {k: v.numpy() for k, v in convert.to_named(
            exported, CFG["num_heads"], CFG["head_dim"]).items()},
        template)
    jout = np.asarray(jm.apply({"params": jparams}, {"tokens": tokens}))
    np.testing.assert_allclose(whole, jout, rtol=RTOL, atol=ATOL)
