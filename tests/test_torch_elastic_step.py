"""The port's weighted lockstep step (``parallel/elastic.py``
``ElasticDPTrainer``) on a world of two gloo CPU ranks, against the JAX
``make_elastic_train_step`` on two of conftest's eight CPU devices, run
as ``tests/test_elastic_allreduce.py`` runs it (the state placed
replicated on the two devices).

The model is the MNIST CNN in float32 with its dropout patched to the
identity in both packages (their random draws differ), trained by SGD at
0.01 with momentum 0.9, from one set of weights (the flax init,
converted). Each rank holds half of a 16-row batch. Three steps with the
weights (1, 1), (1, 0) and (0, 0): a rank at weight 0 feeds its previous
batch, as the worker's data-less rank does. After each step every
parameter and momentum buffer is within 1e-5 relative L2 of the
reference's, the losses agree to 1e-5, the live counts and versions are
equal, and the two ranks hold the same bits; the (0, 0) step changes
nothing and does not advance the version.

Before the steps, rank 1 holds garbage (random parameters and momentum)
and ``establish`` replaces it with rank 0's state, bitwise.

A second model, conv -> BatchNorm -> dense beside its flax twin, holds
what the MNIST CNN (GroupNorm, no model state) cannot: fractional weights
(partial batches padded by their last row) and the weight-averaged
batch statistics, Σ(x·w)/Σw, at the same 1e-5.
"""

import os
import socket

import numpy as np
import torch

SEED = 0
LR, MOMENTUM = 0.01, 0.9
WEIGHTS = [(1, 1), (1, 0), (0, 0)]
ROWS = 8  # per rank
REL_L2 = 1e-5


def _no_dropout(x, *args, **kwargs):
    return x


def _sgd(params):
    return torch.optim.SGD(params, lr=LR, momentum=MOMENTUM)


def _batches():
    rng = np.random.default_rng(SEED)
    images = rng.random((2 * ROWS, 28, 28), dtype=np.float32)
    labels = rng.integers(0, 10, (2 * ROWS, 1)).astype(np.int32)
    return images, labels


def _save(path, tensors):
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in tensors.items()})


def _rank_main(rank, port, out_dir):
    """One gloo rank: adopt the initial state (rank 0) or garbage (rank
    1), establish, then step through WEIGHTS, saving the state after
    each step."""
    torch.nn.functional.dropout = _no_dropout
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.mnist_subclass import (
        mnist_subclass as zoo,
    )
    from elasticdl_tpu_torch.parallel.distributed import WorldSpec
    from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer

    trainer = ElasticDPTrainer(zoo.CustomModel(), zoo.loss, _sgd,
                               seed=SEED, device="cpu")
    named = dict(np.load(os.path.join(out_dir, "init.npz")))
    ts = convert.to_train_state(named, _sgd, device="cpu")
    if rank == 1:  # garbage: random parameters and momentum
        g = torch.Generator().manual_seed(99)
        for p in ts.params.values():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=g))
            ts.opt_state.state[p] = {
                "momentum_buffer": torch.randn(p.shape, generator=g)
            }
        ts.version = 7
    trainer.load_host_state(ts)
    trainer.establish(WorldSpec("localhost:%d" % port, 2, rank, 1))
    _save(os.path.join(out_dir, "est-%d.npz" % rank), _leaves(trainer))
    images, labels = _batches()
    mine = slice(rank * ROWS, (rank + 1) * ROWS)
    for k, weights in enumerate(WEIGHTS):
        if weights[rank]:
            got = trainer.train_step(
                {"image": images[mine]}, labels[mine], ROWS
            )
        else:
            got = trainer.train_step(None, None, ROWS)
        loss, live, _ = got
        leaves = _leaves(trainer)
        leaves["_loss"] = torch.tensor(loss, dtype=torch.float64)
        leaves["_live"] = torch.tensor(live)
        leaves["_version"] = torch.tensor(trainer.version)
        split = trainer.step_times
        leaves["_timed"] = torch.tensor(split.get("host_step", 0))
        leaves["_split_ok"] = torch.tensor(all(
            split.get(key, 0) >= 0
            for key in ("compute_s", "allreduce_s", "rest_s", "step_s")
        ))
        _save(os.path.join(out_dir, "step%d-%d.npz" % (k, rank)), leaves)
    trainer.leave()


def _leaves(trainer):
    ts = trainer.train_state
    out = {"p/" + n: p for n, p in trainer.host_params().items()}
    for n, p in ts.params.items():
        buf = (ts.opt_state.state.get(p) or {}).get("momentum_buffer")
        out["m/" + n] = torch.zeros_like(p) if buf is None else buf
    out["_version"] = torch.tensor(ts.version)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _reference_steps(monkeypatch):
    """The JAX weighted step on two CPU devices: the initial named
    params, then per step (params, momentum trace, loss, live, version)
    in the port's names and layouts."""
    import flax.linen as flax_nn
    import jax
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu.nn.model_api import init_variables, split_variables
    from elasticdl_tpu.parallel.elastic import (
        host_copy,
        make_elastic_train_step,
    )
    from elasticdl_tpu.training.step import TrainState
    from elasticdl_tpu_torch.common import convert
    from model_zoo.mnist_subclass import mnist_subclass as jzoo

    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    model = jzoo.CustomModel()
    images, labels = _batches()
    variables = init_variables(
        model, jax.random.PRNGKey(SEED), {"image": images[:1]}
    )
    params, state = split_variables(variables)
    opt = optax.sgd(LR, momentum=MOMENTUM)
    ts0 = TrainState.create(params, state, opt)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    # replicated on the two devices (broadcast_from_device0 tiles over
    # every local device, eight here)
    ts = jax.device_put(host_copy(ts0), NamedSharding(mesh, P()))
    step = make_elastic_train_step(model, jzoo.loss, opt, mesh)

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P("data")))

    def port_names(tree):
        return {
            k: v.numpy()
            for k, v in convert.to_state_dict(
                pytree_to_named_arrays(host_copy(tree))
            ).items()
        }

    out = []
    with mesh:
        for weights in WEIGHTS:
            ts, loss, n, _ = step(
                ts, put({"image": images}), put(labels),
                put(np.asarray(weights, np.float32)),
                put(np.zeros(2, np.int32)), jax.random.PRNGKey(7),
            )
            out.append({
                "p": port_names(ts.params),
                "m": port_names(ts.opt_state[0].trace),
                "loss": float(loss),
                "live": int(n),
                "version": int(host_copy(ts.version)),
            })
    return pytree_to_named_arrays(params), out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def test_weighted_step_matches_jax_on_two_gloo_ranks(monkeypatch, tmp_path):
    import torch.multiprocessing as mp

    named0, reference = _reference_steps(monkeypatch)
    np.savez(tmp_path / "init.npz",
             **{k: np.asarray(v) for k, v in named0.items()})
    mp.spawn(_rank_main, args=(_free_port(), str(tmp_path)), nprocs=2,
             join=True)

    # establish: rank 1's garbage gave way to rank 0's state, bitwise
    est = [dict(np.load(tmp_path / ("est-%d.npz" % r))) for r in (0, 1)]
    assert sorted(est[0]) == sorted(est[1])
    for k in est[0]:
        assert np.array_equal(est[0][k], est[1][k]), k
    assert int(est[1]["_version"]) == 0

    for k, want in enumerate(reference):
        ranks = [dict(np.load(tmp_path / ("step%d-%d.npz" % (k, r))))
                 for r in (0, 1)]
        for key in ranks[0]:
            if key != "_split_ok":
                assert np.array_equal(ranks[0][key], ranks[1][key]), (k, key)
        got = ranks[0]
        assert int(got["_live"]) == want["live"] == sum(
            w > 0 for w in WEIGHTS[k]
        )
        assert int(got["_version"]) == want["version"] == min(k + 1, 2)
        # the split read after step k + 1 is that of the step before it
        assert int(got["_timed"]) == k and bool(got["_split_ok"])
        if want["live"]:
            assert abs(float(got["_loss"]) - want["loss"]) <= 1e-5 * abs(
                want["loss"]
            )
        for kind in ("p", "m"):
            for name, ref in want[kind].items():
                err = _rel_l2(got["%s/%s" % (kind, name)], ref)
                assert err <= REL_L2, (k, kind, name, err)
    # the (0, 0) step changed nothing
    last = dict(np.load(tmp_path / "step2-0.npz"))
    before = dict(np.load(tmp_path / "step1-0.npz"))
    for key in last:
        if not key.startswith("_"):
            assert np.array_equal(last[key], before[key]), key


BN_ROWS = 8
# per step, each rank's true rows of BN_ROWS: weights (1, 0.5), (0.5, 1),
# then (1, 0) with rank 1 feeding its previous batch at weight 0
BN_STEPS = [(8, 4), (4, 8), (8, 0)]


class _ConvBN(torch.nn.Module):
    """conv -> BatchNorm -> relu -> mean -> dense: float model state that
    a training forward moves, in the names ``convert`` maps to flax's
    ``Conv_0``/``BatchNorm_0``/``Dense_0``."""

    def __init__(self):
        super().__init__()
        from elasticdl_tpu_torch.nn.layers import BatchNorm

        self.conv0 = torch.nn.Conv2d(3, 8, 3, bias=False)
        self.norm0 = BatchNorm(8)
        self.head = torch.nn.Linear(8, 3)

    def forward(self, inputs):
        x = inputs["image"].permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = torch.relu(self.norm0(self.conv0(x)))
        return self.head(x.mean(dim=(2, 3)))


def _ce(output, labels):
    return torch.nn.functional.cross_entropy(
        output, labels.reshape(-1).long()
    )


def _bn_data():
    """Per step and rank, the true rows: (images NHWC, labels)."""
    rng = np.random.default_rng(SEED + 1)
    return [
        [(rng.standard_normal((n, 6, 6, 3)).astype(np.float32),
          rng.integers(0, 3, (n, 1)).astype(np.int32)) for n in rows]
        for rows in BN_STEPS
    ]


def _bn_rank_main(rank, port, out_dir):
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.parallel.distributed import WorldSpec
    from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer

    trainer = ElasticDPTrainer(_ConvBN(), _ce, _sgd, seed=SEED,
                               device="cpu")
    init = dict(np.load(os.path.join(out_dir, "bn-init.npz")))
    trainer.load_host_state(convert.to_train_state(
        {k: v for k, v in init.items() if not k.startswith("batch_stats")},
        _sgd, device="cpu",
        batch_stats={k: v for k, v in init.items()
                     if k.startswith("batch_stats")},
    ))
    trainer.establish(WorldSpec("localhost:%d" % port, 2, rank, 1))
    for k, step in enumerate(_bn_data()):
        x, y = step[rank]
        if len(x):
            got = trainer.train_step({"image": x}, y, BN_ROWS)
        else:
            got = trainer.train_step(None, None, BN_ROWS)
        loss, live, _ = got
        leaves = _leaves(trainer)
        leaves.update(
            {"s/" + n: v for n, v in trainer.train_state.state.items()}
        )
        leaves["_loss"] = torch.tensor(loss, dtype=torch.float64)
        leaves["_live"] = torch.tensor(live)
        _save(os.path.join(out_dir, "bn%d-%d.npz" % (k, rank)), leaves)
    trainer.leave()


def _bn_reference_steps():
    """The JAX weighted step of the flax twin of ``_ConvBN`` on two CPU
    devices, each rank's rows padded by its last row as both packages'
    workers pad them: the initial named variables, then per step
    (params, momentum trace, batch statistics, loss, live, version) in
    the port's names and layouts."""
    import flax.linen as flax_nn
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu.nn.model_api import init_variables, split_variables
    from elasticdl_tpu.parallel.elastic import (
        host_copy,
        make_elastic_train_step,
    )
    from elasticdl_tpu.training.step import TrainState
    from elasticdl_tpu_torch.common import convert

    class ConvBN(flax_nn.Module):
        @flax_nn.compact
        def __call__(self, inputs, training=False):
            x = flax_nn.Conv(8, (3, 3), padding="VALID", use_bias=False)(
                inputs["image"]
            )
            x = flax_nn.BatchNorm(use_running_average=not training,
                                  momentum=0.9, epsilon=1e-5)(x)
            x = jnp.mean(flax_nn.relu(x), axis=(1, 2))
            return flax_nn.Dense(3)(x)

    def loss(output, labels):
        return optax.softmax_cross_entropy_with_integer_labels(
            output, labels.reshape(-1)
        ).mean()

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], BN_ROWS - len(x), 0)])

    model = ConvBN()
    data = _bn_data()
    variables = init_variables(
        model, jax.random.PRNGKey(SEED), {"image": data[0][0][0][:1]}
    )
    params, state = split_variables(variables)
    opt = optax.sgd(LR, momentum=MOMENTUM)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    ts = jax.device_put(host_copy(TrainState.create(params, state, opt)),
                        NamedSharding(mesh, P()))
    step = make_elastic_train_step(model, loss, opt, mesh)

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P("data")))

    def port_names(tree):
        return {
            k: v.numpy()
            for k, v in convert.to_state_dict(
                pytree_to_named_arrays(host_copy(tree))
            ).items()
        }

    out, previous = [], None
    with mesh:
        for rows, ranks in zip(BN_STEPS, data):
            # a rank without data feeds its previous batch at weight 0
            batch = [(pad(x), pad(y)) if len(x) else previous[r]
                     for r, (x, y) in enumerate(ranks)]
            previous = batch
            ts, loss_v, n, _ = step(
                ts,
                put({"image": np.concatenate([b[0] for b in batch])}),
                put(np.concatenate([b[1] for b in batch])),
                put(np.asarray([r / BN_ROWS for r in rows], np.float32)),
                put(np.zeros(2, np.int32)), jax.random.PRNGKey(7),
            )
            out.append({
                "p": port_names(ts.params),
                "m": port_names(ts.opt_state[0].trace),
                "s": port_names(ts.state),
                "loss": float(loss_v),
                "live": int(n),
                "version": int(host_copy(ts.version)),
            })
    named = dict(pytree_to_named_arrays(params))
    named.update(pytree_to_named_arrays(state))
    return named, out


def test_weighted_step_averages_batchnorm_state_by_weight(tmp_path):
    """Fractional weights and BatchNorm statistics against JAX: a conv
    -> BatchNorm model on two gloo ranks, from the flax twin's init
    (crossing through ``convert``), for the weights (1, 0.5), (0.5, 1)
    and (1, 0) (partial batches padded by their last row). After each
    step the parameters, momentum and batch statistics (Σ(x·w)/Σw) are
    within 1e-5 relative L2 of ``make_elastic_train_step``'s, the losses
    agree to 1e-5, the live counts and versions are equal, and the two
    ranks hold the same bits."""
    import torch.multiprocessing as mp

    named0, reference = _bn_reference_steps()
    np.savez(tmp_path / "bn-init.npz",
             **{k: np.asarray(v) for k, v in named0.items()})
    mp.spawn(_bn_rank_main, args=(_free_port(), str(tmp_path)), nprocs=2,
             join=True)
    for k, want in enumerate(reference):
        ranks = [dict(np.load(tmp_path / ("bn%d-%d.npz" % (k, r))))
                 for r in (0, 1)]
        for key in ranks[0]:
            assert np.array_equal(ranks[0][key], ranks[1][key]), (k, key)
        got = ranks[0]
        assert int(got["_live"]) == want["live"] == sum(
            n > 0 for n in BN_STEPS[k]
        )
        assert int(got["_version"]) == want["version"] == k + 1
        assert abs(float(got["_loss"]) - want["loss"]) <= 1e-5 * abs(
            want["loss"]
        )
        assert sorted(want["s"]) == ["norm0.running_mean",
                                     "norm0.running_var"]
        for kind in ("p", "m", "s"):
            for name, ref in want[kind].items():
                err = _rel_l2(got["%s/%s" % (kind, name)], ref)
                assert err <= REL_L2, (k, kind, name, err)
