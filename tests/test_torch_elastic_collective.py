"""The collective plane of deepfm_edl's vocabulary-split HBM tables in the
elastic world against the JAX package:

- ``padded_unique`` equals the reference's, the empty input included;
- the routing bodies (``a2a_lookup_collective`` and
  ``a2a_dedup_lookup_collective``) on 4 and on 3 gloo CPU ranks against
  the reference's on 4 and 3 of conftest's host devices under
  ``shard_map``: each rank's rows, each table shard's gradient, and the
  overflow counts with a small ``capacity`` (above 0) and with None (0);
  ``HbmEmbedding(collective=True, method="psum")`` raises the
  reference's ``ValueError``;
- the weighted collective step on 3 ranks with ``PadDim0`` tables (97
  rows padded to 99) against ``make_elastic_train_step`` on a 3-device
  mesh with padded tables, from one flax init: weights (1, 1, 1) then
  (1, 0, 1), two SGD steps and two Adam steps (the slots co-shard): the
  loss and every gathered parameter and slot; (0, 0, 0) leaves the state
  and the version bitwise; the SGD steps also equal dense one-device
  training of the host twin on the live ranks' rows;
- ``make_train_step(pmean_axis="data")`` on 2 ranks against the
  reference's inside ``shard_map``;
- checkpoints across paddings: written at 3 ranks (99 rows), restored at
  2 (98) and at 4 (100), each move bitwise in the logical rows with the
  padding rows zero; ``load_sharded_to_host`` clips the padding; a torn
  newest checkpoint falls back to the older one;
- the job: ``cli train --num_workers 3`` of deepfm_edl (vocabulary
  1,000, padded to 1,002 at 3 ranks) on CPU ranks with
  ``--replica_refresh_steps 0``, worker 1 SIGKILLed once all three
  ranks' ``ckpt_v4`` manifests are on disk: the tables pad at 3 ranks,
  the world re-forms at 2 and restores bitwise, every task runs once,
  each round equals a whole-model evaluation of its checkpoint, and the
  export holds the final checkpoint's clipped tables, on which the JAX
  package's forward (through ``common/convert.py``) matches the port's;
  ``cli evaluate`` of the padded checkpoint scores through the host twin;
- the refusals, by the reference's messages: a PS-plane table in the
  collective form, a zoo with sharded specs and no
  ``build_collective_model``, an ``embedding_plane`` that puts a table
  on the PS plane.

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
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, DIM, FC, LENGTH = 97, 8, 8, 10
MODEL = dict(vocab_size=VOCAB, embedding_dim=DIM, fc_unit=FC)
ROWS = 4  # each rank's records a step
CAP = 3  # the small capacity of the overflow cases
ATOL, RTOL = 1e-5, 1e-4
LR_SGD, LR_ADAM = 0.1, 1e-2


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _batch(seed, rows=ROWS):
    """({"feature": (rows, 10) ids, 0 among them}, (rows, 1) labels)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (rows, LENGTH)).astype(np.int64)
    return {"feature": ids}, rng.integers(0, 2, (rows, 1)).astype(np.int32)


def _route_ids(rank):
    """A rank's flat ids for the routing bodies: duplicates, skip slots
    (-1) and ids of every owner."""
    rng = np.random.default_rng(50 + rank)
    ids = rng.integers(0, VOCAB, 24)
    ids[::7] = -1
    ids[1:4] = ids[5]
    return ids.astype(np.int64)


def _cotangent(rank, n):
    return np.random.default_rng(80 + rank).standard_normal(
        (n, DIM)).astype(np.float32)


def _table():
    return np.random.default_rng(7).standard_normal(
        (VOCAB, DIM)).astype(np.float32)


def _padded(table, n):
    rows = -(-table.shape[0] // n) * n
    out = np.zeros((rows,) + table.shape[1:], table.dtype)
    out[:table.shape[0]] = table
    return out


def _sgd(params):
    return torch.optim.SGD(params, lr=LR_SGD)


def _adam(params):
    return torch.optim.Adam(params, lr=LR_ADAM)


def _collective_trainer(optimizer, **kw):
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    params = ",".join("%s=%d" % kv for kv in MODEL.items())
    hooks = ElasticAllReduceWorker._collective_hooks(tzoo, params)
    return ElasticDPTrainer(tzoo.build_host_model(**MODEL), tzoo.loss,
                            optimizer, device="cpu", **hooks, **kw)


def _gathered(trainer):
    """The whole (padded) state of a collective trainer (every rank
    calls it): parameters and optimizer slots by name, and the
    version."""
    host = trainer.get_host_state()
    names = list(host.params)
    out = {"p/" + n: p.numpy() for n, p in host.params.items()}
    for i, slots in host.opt_state["state"].items():
        for slot, v in slots.items():
            out["o/%s/%s" % (names[i], slot)] = np.asarray(v)
    out["version"] = np.array(host.version)
    return out


# -- the rank processes --------------------------------------------------------


def _rank_main(rank, out_dir):
    os.environ["EDL_WORLD_INIT_TIMEOUT"] = "60"
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        ShardedCheckpointManager,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )
    from elasticdl_tpu_torch.nn import hbm_embedding as th
    from elasticdl_tpu_torch.parallel import distributed
    from elasticdl_tpu_torch.parallel.distributed import WorldSpec
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import TrainState, make_train_step

    cpu = torch.device("cpu")

    def save(name, **arrays):
        np.savez(os.path.join(out_dir, "%s-%d.npz" % (name, rank)),
                 **arrays)

    def spec(n, epoch):
        """World ``epoch``'s spec: rank 0 takes a free port just before
        its store binds it and hands it on through a file (a port picked
        ahead could be taken meanwhile)."""
        path = os.path.join(out_dir, "port-%d" % epoch)
        if rank == 0:
            with open(path + ".tmp", "w") as f:
                f.write(str(_free_port()))
            os.replace(path + ".tmp", path)
        deadline = time.monotonic() + 60.0
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.01)
        with open(path) as f:
            return WorldSpec("127.0.0.1:%s" % f.read(), n, rank, epoch)

    def routing(n, epoch):
        distributed.ensure_world(spec(n, epoch), cpu)
        axis = create_mesh({"data": n}, devices=["cpu"]).axis("data")
        padded = _padded(_table(), n)
        per = padded.shape[0] // n
        ids = torch.from_numpy(_route_ids(rank))
        cot = torch.from_numpy(_cotangent(rank, len(ids)))
        got = {}
        for dedup in (False, True):
            body = (th.a2a_dedup_lookup_collective if dedup
                    else th.a2a_lookup_collective)
            for cap in (None, CAP):
                local = torch.from_numpy(
                    padded[rank * per:(rank + 1) * per].copy()
                ).requires_grad_(True)
                rows, n_over = body(local, ids, axis, capacity=cap,
                                    return_overflow=True)
                (rows * cot).sum().backward()
                key = "%d_%s" % (dedup, cap)
                got["rows_" + key] = rows.detach().numpy()
                got["grad_" + key] = local.grad.numpy()
                got["over_" + key] = np.array(int(n_over))
        save("route%d" % n, **got)
        distributed.leave_world()

    def load_init(t, optimizer):
        """The flax init (padded and cut to this rank's rows) onto ``t``."""
        named = dict(np.load(os.path.join(out_dir, "init.npz")))
        t.load_state(TrainState.create(convert.shard_state_dict(
            convert.to_state_dict(named), tzoo.param_shardings(t._mesh),
            t._mesh), {}, optimizer))

    def weighted_steps(t, name):
        losses, lives = [], []
        for step in range(2):
            if step == 1 and rank == 1:
                loss, live, _ = t.train_step(None, None, ROWS)
            else:
                loss, live, _ = t.train_step(*_batch(100 * step + rank),
                                             ROWS)
            losses.append(loss)
            lives.append(live)
        got = _gathered(t)
        before = (state_digest(t.train_state), t.version)
        _, live0, _ = t.train_step(None, None, ROWS)
        unchanged = before == (state_digest(t.train_state), t.version)
        save(name, losses=np.array(losses), lives=np.array(lives),
             live0=live0, unchanged=unchanged,
             mesh=json.dumps(t.mesh_shape),
             table_rows=t.train_state.params["embedding.table"].shape[0],
             overflow=th.a2a_overflow_total(t._module), **got)

    routing(4, 1)
    if rank < 3:
        routing(3, 2)
        # the weighted step at 3 ranks, SGD then Adam
        t = _collective_trainer(_sgd)
        t.establish(spec(3, 3), example_batch=_batch(rank))
        load_init(t, _sgd)
        weighted_steps(t, "sgd")
        ck3 = ShardedCheckpointManager(os.path.join(out_dir, "ck3"), 1)
        ck3.set_expected_writers(3)
        ck3.set_logical_dim0(t.logical_dim0_by_path())
        ck3.save(t.train_state, t.version, parts=t.checkpoint_parts())
        save("logical3", **{k: np.array(v) for k, v in
                            t.logical_dim0_by_path().items()})
        t.leave()
        adam = _collective_trainer(_adam)
        adam.establish(spec(3, 4), example_batch=_batch(rank))
        load_init(adam, _adam)
        weighted_steps(adam, "adam")
        adam.leave()
        ck2 = ShardedCheckpointManager(os.path.join(out_dir, "ck2"), 1)
        if rank < 2:
            # ck3 restored at 2 ranks (98 rows), then make_train_step's
            # pmean over the same world
            t.restore_provider = ck3.dirs_newest_first
            t.establish(spec(2, 5))
            save("at2", mesh=json.dumps(t.mesh_shape),
                 restored=str(t.establish_times["restored_from"]),
                 part=t.train_state.params["embedding.table"].detach().numpy(),
                 **_gathered(t))
            ck2.set_expected_writers(2)
            ck2.set_logical_dim0(t.logical_dim0_by_path())
            ck2.save(t.train_state, t.version, parts=t.checkpoint_parts())
            mesh = create_mesh({"data": 2}, devices=["cpu"])
            model = tzoo.build_host_model(**MODEL)
            named = dict(np.load(os.path.join(out_dir, "init.npz")))
            ts = TrainState.create(convert.to_state_dict(named), {}, _sgd)
            step = make_train_step(model, tzoo.loss, pmean_axis="data",
                                   mesh=mesh)
            ts, loss = step(ts, *_batch(300 + rank))
            save("pmean", loss=float(loss),
                 **{"p/" + k: v.detach().numpy()
                    for k, v in ts.params.items()})
            t.leave()
    if rank == 3:
        t = _collective_trainer(_sgd)
    ck2 = ShardedCheckpointManager(os.path.join(out_dir, "ck2"), 1)
    t.restore_provider = ck2.dirs_newest_first
    t.establish(spec(4, 6), example_batch=_batch(rank))
    save("at4", mesh=json.dumps(t.mesh_shape),
         restored=str(t.establish_times["restored_from"]),
         part=t.train_state.params["embedding.table"].detach().numpy(),
         **_gathered(t))
    if rank == 0:
        # a torn newer version: only this rank's manifest lands
        ck2.save(t.train_state, 9, parts=t.checkpoint_parts())
    t.eval_have_consensus(False)  # the torn write has landed everywhere
    t.leave()
    t.establish(spec(4, 7), example_batch=_batch(rank))
    save("torn", restored=str(t.establish_times["restored_from"]),
         **_gathered(t))
    t.leave()


def _jax_model(**kw):
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

    return jzoo.DeepFMEdl(embedding_dim=DIM, fc_unit=FC, vocab_size=VOCAB,
                          **kw)


def _jax_init():
    """The flax init of the collective model: (module, params, state)."""
    import jax

    from elasticdl_tpu.nn.model_api import init_variables, split_variables

    jm = _jax_model(collective=True)
    params, state = split_variables(init_variables(
        jm, jax.random.PRNGKey(0), _batch(0)[0]))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jm, to_np(params), to_np(state)


def _named(tree):
    from elasticdl_tpu.common.tensor import pytree_to_named_arrays

    return {k: np.asarray(v) for k, v in pytree_to_named_arrays(tree).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' records, from one spawn: the flax init goes in."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("elastic_collective_ranks")
    _, params, _ = _jax_init()
    np.savez(out / "init.npz", **{k: v.astype(np.float32)
                                  for k, v in _named(params).items()})
    mp.spawn(_rank_main, args=(str(out),), nprocs=4, join=True)
    return out


def _records(root, name, ranks):
    return [dict(np.load(root / ("%s-%d.npz" % (name, r)),
                         allow_pickle=False)) for r in ranks]


# -- padded_unique and the routing bodies --------------------------------------


@pytest.mark.parametrize("ids", [
    [5, 3, 5, 1, 3, 3, 7], [2, 2, 2], [], [9, -1, 4, -1, 9, 0],
    list(np.random.default_rng(3).integers(0, 40, 64)),
], ids=["dups", "one_value", "empty", "skips", "random"])
def test_padded_unique_equals_the_reference(ids):
    import jax.numpy as jnp

    from elasticdl_tpu.nn.sparse_comms import padded_unique as jpadded
    from elasticdl_tpu_torch.nn.sparse_comms import padded_unique

    ids = np.asarray(ids, np.int64)
    got = padded_unique(torch.from_numpy(ids))
    want = jpadded(jnp.asarray(ids, jnp.int32))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == ids.shape and got[1].dtype == torch.int32


def _jax_routing(n):
    """{key: per-device arrays} of the reference's bodies on ``n`` host
    devices: rows, the padded table's gradient cut per device, and the
    local overflow counts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.nn import hbm_embedding as jh
    from elasticdl_tpu.parallel.ring_attention import shard_map

    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    table = jnp.asarray(_padded(_table(), n))
    ids = jnp.asarray(np.concatenate([_route_ids(r) for r in range(n)]),
                      jnp.int32)
    cot = jnp.asarray(np.concatenate([_cotangent(r, 24) for r in range(n)]))
    out = {}
    for dedup in (False, True):
        body = (jh.a2a_dedup_lookup_collective if dedup
                else jh.a2a_lookup_collective)
        for cap in (None, CAP):
            def lookup(t, i, body=body, cap=cap):
                rows, n_over = body(t, i, "data", capacity=cap,
                                    return_overflow=True)
                return rows, n_over.reshape(1)

            fn = shard_map(lookup, mesh=mesh,
                           in_specs=(P("data", None), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_rep=False)

            @jax.jit
            def rows_and_grad(t, fn=fn):
                (rows, n_over), vjp = jax.vjp(lambda t: fn(t, ids), t)
                (grad,) = vjp((cot, jnp.zeros_like(n_over)))
                return rows, n_over, grad

            rows, n_over, grad = rows_and_grad(table)
            key = "%d_%s" % (dedup, cap)
            per = table.shape[0] // n
            out[key] = [
                (np.asarray(rows)[r * 24:(r + 1) * 24],
                 np.asarray(grad)[r * per:(r + 1) * per],
                 int(np.asarray(n_over)[r]))
                for r in range(n)
            ]
    return out


@pytest.mark.parametrize("n", [4, 3])
def test_the_routing_bodies_match_the_reference(ranks, n):
    """Rows and each shard's gradient within the f32 tolerance, the
    overflow counts equal: above 0 at capacity 3, 0 with None."""
    want = _jax_routing(n)
    got = _records(ranks, "route%d" % n, range(n))
    for key, per_rank in want.items():
        for r, (rows, grad, over) in enumerate(per_rank):
            np.testing.assert_allclose(got[r]["rows_" + key], rows,
                                       rtol=RTOL, atol=ATOL, err_msg=key)
            np.testing.assert_allclose(got[r]["grad_" + key], grad,
                                       rtol=RTOL, atol=ATOL, err_msg=key)
            assert int(got[r]["over_" + key]) == over, (key, r)
    assert sum(int(g["over_0_%d" % CAP]) for g in got) > 0
    assert sum(int(g["over_1_%d" % CAP]) for g in got) > 0
    assert all(int(g["over_%d_None" % d]) == 0 for g in got for d in (0, 1))


def test_a_psum_collective_lookup_raises_the_reference_error():
    import jax

    from elasticdl_tpu.nn.hbm_embedding import HbmEmbedding as JHbm
    from elasticdl_tpu_torch.nn.hbm_embedding import HbmEmbedding

    ids = np.ones((2, 3), np.int64)
    layer = HbmEmbedding(8, 4, collective=True, method="psum")
    with pytest.raises(ValueError) as port:
        layer(torch.from_numpy(ids))
    jl = JHbm(8, 4, collective=True, method="psum")
    variables = jl.init(jax.random.PRNGKey(0), ids)
    with pytest.raises(ValueError) as ref:
        jl.apply(variables, ids, mutable=["metrics"])
    assert str(port.value) == str(ref.value)


# -- the weighted step ---------------------------------------------------------


def _jax_weighted_steps(optimizer):
    """The reference's ``make_elastic_train_step`` on 3 host devices from
    the flax init with tables padded to 99 rows: weights (1, 1, 1) then
    (1, 0, 1), the weight-0 device feeding its previous rows. Returns
    (losses, lives, final train state)."""
    import jax
    from jax.sharding import Mesh

    from elasticdl_tpu.parallel import elastic as je
    from elasticdl_tpu.training import step as jstep
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

    jm, params, state = _jax_init()
    for table in ("embedding", "id_bias"):
        params[table]["table"] = _padded(params[table]["table"], 3)
    mesh = Mesh(np.array(jax.devices()[:3]), ("data",))
    ts = jstep.TrainState.create(params, state, optimizer)
    specs = je.build_state_specs(
        ts, je.collect_sharded_paths(jzoo.param_shardings(mesh)))
    ts = je.place_from_host_specs(mesh, ts, specs)
    step = je.make_elastic_train_step(jm, jzoo.loss, optimizer, mesh,
                                      state_specs=specs)
    losses, lives, last = [], [], {}
    for i, weights in enumerate(((1, 1, 1), (1, 0, 1))):
        for r, w in enumerate(weights):
            if w:
                last[r] = _batch(100 * i + r)
        feats = np.concatenate([last[r][0]["feature"] for r in range(3)])
        labels = np.concatenate([last[r][1] for r in range(3)])
        ts, loss, n, _ = step(ts, {"feature": feats}, labels,
                              np.array(weights, np.float32),
                              np.zeros(3, np.int32), jax.random.PRNGKey(i))
        losses.append(float(loss))
        lives.append(int(n))
    return losses, lives, jax.device_get(ts)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_the_weighted_step_matches_make_elastic_train_step(ranks, name):
    import optax

    from elasticdl_tpu_torch.common import convert

    opt = optax.sgd(LR_SGD) if name == "sgd" else optax.adam(LR_ADAM)
    losses, lives, ts = _jax_weighted_steps(opt)
    want = convert.to_state_dict(_named(ts.params))
    slots = {}
    if name == "adam":
        slots = {"exp_avg": convert.to_state_dict(_named(ts.opt_state[0].mu)),
                 "exp_avg_sq": convert.to_state_dict(
                     _named(ts.opt_state[0].nu))}
    for g in _records(ranks, name, range(3)):
        assert json.loads(str(g["mesh"])) == {"data": 3}
        assert int(g["table_rows"]) == 33  # 97 padded to 99, a third
        np.testing.assert_allclose(g["losses"], losses, rtol=RTOL, atol=ATOL)
        assert list(g["lives"]) == lives == [3, 2]
        assert int(g["version"]) == int(np.asarray(ts.version)) == 2
        assert int(g["overflow"]) == 0
        for key, w in want.items():
            np.testing.assert_allclose(g["p/" + key], w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
            for slot, by_key in slots.items():
                np.testing.assert_allclose(
                    g["o/%s/%s" % (key, slot)], by_key[key].numpy(),
                    rtol=RTOL, atol=ATOL, err_msg=key)
        for table in ("embedding.table", "id_bias.table"):
            assert not g["p/" + table][VOCAB:].any()  # the padding


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_no_live_rank_leaves_the_state_and_version_bitwise(ranks, name):
    for g in _records(ranks, name, range(3)):
        assert int(g["live0"]) == 0 and bool(g["unchanged"])


def test_the_padded_step_matches_dense_training(ranks):
    """The SGD steps against the host twin (whole tables, plain gathers)
    trained on one device on the live ranks' rows: the pad rows are
    never addressed, so the logical rows match and the padding stays
    zero."""
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )
    from elasticdl_tpu_torch.training.step import TrainState, make_train_step

    named = dict(np.load(ranks / "init.npz"))
    ts = TrainState.create(convert.to_state_dict(named), {}, _sgd)
    step = make_train_step(tzoo.build_host_model(**MODEL), tzoo.loss)
    losses = []
    for i, live in enumerate(((0, 1, 2), (0, 2))):
        batches = [_batch(100 * i + r) for r in live]
        ts, loss = step(ts, {"feature": np.concatenate(
            [b[0]["feature"] for b in batches])},
            np.concatenate([b[1] for b in batches]))
        losses.append(float(loss))
    for g in _records(ranks, "sgd", range(3)):
        np.testing.assert_allclose(g["losses"], losses, rtol=RTOL, atol=ATOL)
        for key, p in ts.params.items():
            np.testing.assert_allclose(g["p/" + key][:p.shape[0]],
                                       p.detach().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_pmean_axis_matches_the_reference(ranks):
    """One SGD step of the host twin with ``pmean_axis="data"`` on 2
    ranks, each feeding its own rows, against the reference's step in a
    ``shard_map`` over 2 host devices."""
    import jax
    import optax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.parallel.ring_attention import shard_map
    from elasticdl_tpu.training import step as jstep
    from elasticdl_tpu_torch.common import convert
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

    _, params, _ = _jax_init()
    jm = _jax_model(force_hbm=True)
    opt = optax.sgd(LR_SGD)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = jstep.make_train_step(jm, jzoo.loss, opt, pmean_axis="data")
    fn = shard_map(step, mesh=mesh, in_specs=(P(), P("data"), P("data"),
                                               P()),
                   out_specs=(P(), P()), check_rep=False)
    batches = [_batch(300 + r) for r in range(2)]
    ts, loss = fn(jstep.TrainState.create(params, {}, opt),
                  {"feature": np.concatenate(
                      [b[0]["feature"] for b in batches])},
                  np.concatenate([b[1] for b in batches]),
                  jax.random.PRNGKey(0))
    want = convert.to_state_dict(_named(jax.device_get(ts.params)))
    for g in _records(ranks, "pmean", range(2)):
        np.testing.assert_allclose(float(g["loss"]), float(loss),
                                   rtol=RTOL, atol=ATOL)
        for key, w in want.items():
            np.testing.assert_allclose(g["p/" + key], w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


# -- checkpoints across paddings -----------------------------------------------


def _logical(g):
    """Every parameter and slot of a gathered state, clipped to the
    logical rows, and whether the padding rows are all zero."""
    out, zero = {}, True
    for k, v in g.items():
        if k.startswith(("p/", "o/")):
            if k.split("/")[1].endswith(".table") and v.ndim:
                zero = zero and not v[VOCAB:].any()
                v = v[:VOCAB]
            out[k] = v
    return out, zero


def test_checkpoints_move_across_paddings_bitwise(ranks):
    """Written at 3 ranks (99 rows, logical 97), restored at 2 (98 rows,
    49 a rank) and that world's checkpoint at 4 (100 rows, 25 a rank):
    the logical rows of every parameter and SGD slot bitwise the
    trained state's, the padding rows zero, and each rank's part its
    own rows."""
    trained, zero = _logical(_records(ranks, "sgd", [0])[0])
    assert zero
    for name, n, per in (("at2", 2, 49), ("at4", 4, 25)):
        recs = _records(ranks, name, range(n))
        for r, g in enumerate(recs):
            assert json.loads(str(g["mesh"])) == {"data": n}
            moved, zero = _logical(g)
            assert zero, name
            assert sorted(moved) == sorted(trained)
            for k, v in trained.items():
                assert np.array_equal(moved[k], v), (name, k)
            whole = g["p/embedding.table"]
            assert g["part"].shape == (per, DIM)
            assert np.array_equal(g["part"], whole[r * per:(r + 1) * per])
    for g in _records(ranks, "at2", range(2)):
        assert str(g["restored"]).endswith(os.path.join("ck3", "ckpt_v2"))
    for g in _records(ranks, "at4", range(4)):
        assert str(g["restored"]).endswith(os.path.join("ck2", "ckpt_v2"))


def test_the_manifest_records_the_logical_rows_and_host_loads_clip(ranks):
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        leaf_shapes,
        load_sharded_to_host,
    )

    directory = str(ranks / "ck3" / "ckpt_v2")
    (logical,) = _records(ranks, "logical3", [0])
    assert {k: int(v) for k, v in logical.items()} == {
        "params/embedding.table": VOCAB, "params/id_bias.table": VOCAB}
    assert leaf_shapes(directory)["params/embedding.table"] == (99, DIM)
    version, leaves = load_sharded_to_host(directory)
    assert version == 2
    assert tuple(leaves["params/embedding.table"].shape) == (VOCAB, DIM)
    assert tuple(leaves["params/id_bias.table"].shape) == (VOCAB, 1)
    trained, _ = _logical(_records(ranks, "sgd", [0])[0])
    assert np.array_equal(leaves["params/embedding.table"].numpy(),
                          trained["p/embedding.table"])


def test_a_torn_newest_checkpoint_falls_back_to_the_older_one(ranks):
    """ck2's v9 holds rank 0's manifest alone: every rank restores v2
    instead, bitwise, and the version is set past the torn one."""
    trained, _ = _logical(_records(ranks, "sgd", [0])[0])
    for g in _records(ranks, "torn", range(4)):
        assert str(g["restored"]).endswith(os.path.join("ck2", "ckpt_v2"))
        assert int(g["version"]) == 9
        moved, zero = _logical(g)
        assert zero
        for k, v in trained.items():
            assert np.array_equal(moved[k], v), k


# -- the refusals --------------------------------------------------------------


def test_a_ps_plane_table_in_the_collective_form_is_refused():
    import jax

    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )

    with pytest.raises(ValueError) as port:
        tzoo.build_collective_model(embedding_plane="hybrid", **MODEL)
    with pytest.raises(ValueError) as ref:
        _jax_model(collective=True, embedding_plane="hybrid").init(
            jax.random.PRNGKey(0), _batch(0)[0])
    assert str(port.value).replace("--", "—") == str(ref.value)


def _worker_error(zoo_dir, model_def, model_params, cls):
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    with pytest.raises(cls) as err:
        ElasticAllReduceWorker(0, JobType.TRAINING_ONLY, 4, zoo_dir,
                               model_def, model_params=model_params,
                               checkpoint_dir="c", device="cpu")
    return str(err.value)


def _reference_worker_error(zoo_dir, model_def, model_params, cls):
    from elasticdl_tpu.common.constants import JobType
    from elasticdl_tpu.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    with pytest.raises(cls) as err:
        ElasticAllReduceWorker(0, JobType.TRAINING_ONLY, 4, zoo_dir,
                               model_def, model_params=model_params,
                               checkpoint_dir="c")
    return str(err.value)


def test_a_zoo_with_sharded_specs_and_no_collective_hook_is_refused(
        tmp_path):
    """deepfm_edl without ``build_collective_model``, in each package's
    zoo: the reference's message."""
    messages = {}
    for pkg, zoo_from, call in (
        ("port", "elasticdl_tpu_torch.model_zoo", _worker_error),
        ("jax", "model_zoo", _reference_worker_error),
    ):
        zoo = tmp_path / pkg / "nohook"
        zoo.mkdir(parents=True)
        (zoo / "nohook.py").write_text(textwrap.dedent(
            """
            from %s.deepfm_edl_embedding.deepfm_edl_embedding import *  # noqa
            from %s.deepfm_edl_embedding import deepfm_edl_embedding as _z
            del build_collective_model
            custom_model = _z.custom_model
            """ % (zoo_from, zoo_from)))
        messages[pkg] = call(str(tmp_path / pkg), "nohook.nohook."
                             "custom_model", "vocab_size=97",
                             NotImplementedError)
    assert messages["port"] == messages["jax"]
    assert "build_collective_model" in messages["port"]


def test_an_embedding_plane_with_ps_tables_is_refused():
    edl = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
    for spec in ("hybrid", "embedding:hbm", "ps"):
        params = "vocab_size=97,embedding_plane=%s" % spec
        port = _worker_error("", edl, params, NotImplementedError)
        ref = _reference_worker_error(os.path.join(REPO, "model_zoo"), edl,
                                      params, NotImplementedError)
        assert port == ref and "PS plane" in port, spec


# -- the job -------------------------------------------------------------------

# deepfm_edl, its records parsed as the zoo parses them, without the
# training shuffle: a 1,024-record buffer would let the first worker
# fetch every task of this small job before its peers prime
ZOO_MODULE = textwrap.dedent(
    """
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding.deepfm_edl_embedding import *  # noqa
    from elasticdl_tpu_torch.model_zoo.deepfm_functional_api.deepfm_functional_api import (  # noqa
        FixedLenFeature, Mode, np, parse_example)


    def dataset_fn(dataset, mode, _):
        spec = {"feature": FixedLenFeature([10], np.int64)}
        if mode != Mode.PREDICTION:
            spec["label"] = FixedLenFeature([1], np.int64)

        def _parse_data(record):
            r = parse_example(record, spec)
            features = {"feature": r["feature"].astype(np.int64)}
            if mode == Mode.PREDICTION:
                return features
            return features, r["label"].astype(np.int32)

        return dataset.map(_parse_data)
    """
)
JOB_VOCAB = 1000
JOB_PARAMS = "vocab_size=%d,embedding_dim=%d,fc_unit=%d" % (JOB_VOCAB, DIM,
                                                             FC)
JOB_RECORDS, JOB_BATCH, VAL_RECORDS = 240, 8, 8  # one task a round
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
                 labels=labels, **outputs)
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
    while len(glob.glob(first)) < 3 and runner.is_alive():
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


def _write_records(directory, n, seed):
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    rng = np.random.default_rng(seed)
    os.makedirs(directory)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            w.write(encode_example({
                "feature": rng.integers(0, JOB_VOCAB, 10).astype(np.int64),
                "label": rng.integers(0, 2, 1).astype(np.int64),
            }))


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
def collective_job(tmp_path_factory):
    """``cli train`` of deepfm_edl with three workers on CPU ranks,
    worker 1 SIGKILLed once all three ranks' ckpt_v4 manifests are on
    disk."""
    root = tmp_path_factory.mktemp("elastic_collective_job")
    zoo = root / "zoo" / "edl"
    zoo.mkdir(parents=True)
    (zoo / "edl.py").write_text(ZOO_MODULE)
    _write_records(str(root / "data"), JOB_RECORDS, 0)
    _write_records(str(root / "val"), VAL_RECORDS, 1)
    argv = [
        "train", "--job_name", "edl", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "3", "--model_zoo",
        str(root / "zoo"), "--model_def", "edl.edl.custom_model",
        "--model_params", JOB_PARAMS, "--training_data", str(root / "data"),
        "--validation_data", str(root / "val"), "--evaluation_steps", "4",
        "--minibatch_size", str(JOB_BATCH), "--num_minibatches_per_task",
        "1", "--num_epochs", "1", "--checkpoint_dir", str(root / "ckpt"),
        "--checkpoint_steps", "1", "--keep_checkpoint_max", "0",
        "--replica_refresh_steps", "0", "--output", str(root / "export"),
        "--restart_policy", "Never", "--device", "cpu", "--log_level",
        "WARNING",
    ]
    cfg = dict(repo=REPO, argv=argv, timeline=str(root / "timeline"),
               ckpt=str(root / "ckpt"), out=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
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


def _parts_digest(directory, rank, n):
    """The state digest of ``rank``'s parameter parts of a checkpoint in
    a world of ``n`` (the tables' rows padded to that world), read from
    the files."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.training.step import TrainState

    _, leaves = load_sharded_to_host(directory)
    params = {}
    for path, t in leaves.items():
        if path.startswith("params/"):
            name = path[len("params/"):]
            if name.endswith(".table"):
                padded = torch.from_numpy(_padded(t.numpy(), n))
                per = padded.shape[0] // n
                t = padded[rank * per:(rank + 1) * per]
            params[name] = t
    return state_digest(TrainState(params, {}, None))


def test_the_collective_job_pads_its_tables_at_three_ranks(collective_job):
    from elasticdl_tpu_torch.common.sharded_checkpoint import leaf_shapes

    r = collective_job
    assert r["rc"] == 0 and r["finished"]
    assert r["exit_codes"] == {"0": 0, "1": -signal.SIGKILL, "2": 0}
    first = [e for w in (0, 1, 2) for e in _of(r["events"][w],
                                               "established")
             if e["t"] < r["killed"]["t"]]
    assert sorted(e["rank"] for e in first) == [0, 1, 2]
    assert all(e["mesh"] == {"data": 3} for e in first)
    directory = str(r["root"] / "ckpt" / "ckpt_v4")
    assert leaf_shapes(directory)["params/embedding.table"] == (1002, DIM)
    with open(os.path.join(directory, "manifest-1.json")) as f:
        entry = json.load(f)["leaves"]["params/embedding.table"]
    assert entry["logical_dim0"] == JOB_VOCAB
    assert [s["slices"][0] for s in entry["shards"]] == [[334, 668]]


def test_the_collective_job_reforms_at_two_and_restores_bitwise(
        collective_job):
    """Both ranks of the re-formed world (500 rows a rank, no padding)
    restore the newest checkpoint every rank can read, each rank's parts
    bitwise the files' logical rows, and the version goes on from it (or
    from past a newer directory the kill left torn)."""
    r = collective_job
    reformed = [e for w in (0, 2) for e in _of(r["events"][w],
                                               "established")
                if e["t"] >= r["killed"]["t"]]
    assert sorted(e["rank"] for e in reformed) == [0, 1]
    assert all(e["mesh"] == {"data": 2} for e in reformed)
    (directory,) = {e["restored_from"] for e in reformed}
    version = int(os.path.basename(directory)[len("ckpt_v"):])
    assert version >= 4
    for e in reformed:
        assert e["restored_version"] == version
        # past a newer directory the kill left torn, never below it
        assert e["version"] >= version
        assert e["digest"] == _parts_digest(directory, e["rank"], 2)
    steps = [e for w in (0, 2) for e in _of(r["events"][w], "step")
             if e["t"] > r["killed"]["t"] and e["live"]]
    assert min(e["version"] for e in steps) == reformed[0]["version"] + 1
    assert all(e["routing"]["routed"] <= e["routing"]["occurrences"]
               for e in steps)


def test_the_collective_job_runs_every_task_once(collective_job):
    r = collective_job
    rounds = len(r["published"])
    assert rounds >= 2
    # training tasks, SAVE_MODEL, and one evaluation task a round
    assert len(r["done"]) == len(set(r["done"])) == (
        JOB_RECORDS // JOB_BATCH + 1 + rounds)


def _whole_forward(directory, features):
    """The host twin's outputs on ``features`` from a checkpoint's
    clipped parameters, on the CPU."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as tzoo,
    )
    from elasticdl_tpu_torch.training.step import make_forward_fn

    _, leaves = load_sharded_to_host(directory)
    params = {k[len("params/"):]: v for k, v in leaves.items()
              if k.startswith("params/")}
    model = tzoo.build_host_model(vocab_size=JOB_VOCAB, embedding_dim=DIM,
                                  fc_unit=FC)
    out = make_forward_fn(model)(params, {}, features)
    return {k: v.numpy() for k, v in out.items()}


def _val_features(root):
    from elasticdl_tpu_torch.data.example import parse_example
    from elasticdl_tpu_torch.data.example import FixedLenFeature
    from elasticdl_tpu_torch.data.recordio import RecordIOReader

    spec = {"feature": FixedLenFeature([10], np.int64),
            "label": FixedLenFeature([1], np.int64)}
    with RecordIOReader(str(root / "val" / "f0")) as reader:
        rows = [parse_example(rec, spec) for rec in reader]
    return (np.stack([r["feature"] for r in rows]),
            np.stack([r["label"] for r in rows]))


def test_the_rounds_equal_a_whole_model_evaluation(collective_job):
    """Each round's logits against the host twin's forward of the
    checkpoint at the version the round scored (1e-5 relative L2), and
    its accuracy and AUC equal that forward's."""
    from elasticdl_tpu_torch.metrics import AUC

    r = collective_job
    root = r["root"]
    feats, labels = _val_features(root)
    for i, (version, scored) in enumerate(r["reports"]):
        got = dict(np.load(root / ("report-%d.npz" % i)))
        # one task a round: the validation records in file order
        assert np.array_equal(got["labels"].reshape(-1), labels.reshape(-1))
        want = _whole_forward(str(root / "ckpt" / ("ckpt_v%d" % scored)),
                              {"feature": feats})
        err = (np.linalg.norm(got["logits"] - want["logits"])
               / np.linalg.norm(want["logits"]))
        assert err <= 1e-5, (version, scored, err)
        (round_,) = [p for p in r["published"] if p["version"] == version]
        acc = float(np.mean((want["logits"] > 0).astype(np.int32)
                            == labels.reshape(-1)))
        assert round_["metrics"]["logits"]["accuracy"] == pytest.approx(acc)
        auc = AUC()
        auc.update_state(labels, want["probs"])
        assert round_["metrics"]["probs"]["auc"] == pytest.approx(
            float(auc.result()))
    assert len(r["reports"]) == len(r["published"]) >= 2


def test_the_collective_job_exports_the_final_state(collective_job):
    """The SAVE_MODEL artifact holds the newest checkpoint's clipped
    tables (the final state every rank wrote), its serving member answers
    as the host twin does, and the JAX package's forward on the same
    parameters (through ``common/convert.py``) matches the port's."""
    import jax

    from elasticdl_tpu.common.tensor import named_arrays_to_pytree
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.export import load_export
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

    r = collective_job
    root = r["root"]
    (manifest,) = glob.glob(str(root / "export" / "*" / "MANIFEST.json"))
    with open(manifest) as f:
        assert json.load(f)["artifacts"]["torch_serving_fn"]
    artifact = load_export(os.path.dirname(manifest))
    newest = max(glob.glob(str(root / "ckpt" / "ckpt_v*")),
                 key=lambda d: int(os.path.basename(d)[len("ckpt_v"):]))
    version, leaves = load_sharded_to_host(newest)
    finals = [_of(r["events"][w], "final")[0] for w in (0, 2)]
    assert {f["version"] for f in finals} == {version}
    params = {k[len("params/"):]: v for k, v in leaves.items()
              if k.startswith("params/")}
    assert artifact.version == version
    exported = convert.to_state_dict(artifact.named)
    assert sorted(exported) == sorted(params)
    for k, v in params.items():
        assert np.array_equal(exported[k].numpy(), v.numpy()), k
    assert tuple(exported["embedding.table"].shape) == (JOB_VOCAB, DIM)
    feats, _ = _val_features(root)
    want = _whole_forward(newest, {"feature": feats})
    served = artifact.serve({"feature": feats}, "cpu")
    np.testing.assert_allclose(np.asarray(served["logits"]), want["logits"],
                               rtol=RTOL, atol=ATOL)
    # each rank's final parts are the final checkpoint's, bitwise
    for w, final in zip((0, 2), finals):
        (e,) = [x for x in _of(r["events"][w], "established")
                if x["t"] >= r["killed"]["t"]]
        assert final["digest"] == _parts_digest(newest, e["rank"], 2)
    jm = jzoo.DeepFMEdl(embedding_dim=DIM, fc_unit=FC, vocab_size=JOB_VOCAB,
                        force_hbm=True)
    template = jm.init(jax.random.PRNGKey(0), {"feature": feats})["params"]
    jparams = named_arrays_to_pytree(
        {k: v.numpy() for k, v in convert.to_named(params).items()},
        template)
    jout = jm.apply({"params": jparams}, {"feature": feats})
    np.testing.assert_allclose(np.asarray(jout["logits"]), want["logits"],
                               rtol=RTOL, atol=ATOL)


def test_evaluate_scores_the_padded_checkpoint_through_the_host_twin(
        collective_job):
    """``cli evaluate`` of the job's padded checkpoints: the newest
    restorable one, clipped to the logical rows, scored by the host
    twin, as a whole-model forward of it scores."""
    from elasticdl_tpu_torch import cli

    root = collective_job["root"]
    jobs = []
    assert cli.main([
        "evaluate", "--job_name", "edl", "--model_zoo", str(root / "zoo"),
        "--model_def", "edl.edl.custom_model", "--model_params", JOB_PARAMS,
        "--minibatch_size", str(JOB_BATCH), "--num_minibatches_per_task",
        "2", "--validation_data", str(root / "val"), "--checkpoint_dir",
        str(root / "ckpt"), "--distribution_strategy", "AllreduceStrategy",
        "--device", "cpu",
    ], jobs=jobs) == 0
    (published,) = jobs[0].master.evaluation_service.published
    newest = max(glob.glob(str(root / "ckpt" / "ckpt_v*")),
                 key=lambda d: int(os.path.basename(d)[len("ckpt_v"):]))
    assert published["scored_versions"] == [
        int(os.path.basename(newest)[len("ckpt_v"):])]
    feats, labels = _val_features(root)
    want = _whole_forward(newest, {"feature": feats})
    acc = float(np.mean((want["logits"] > 0).astype(np.int32)
                        == labels.reshape(-1)))
    assert published["metrics"]["logits"]["accuracy"] == pytest.approx(acc)
