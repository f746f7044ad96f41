"""The port's parameter-server store against the JAX package's, on the
same numpy-seeded inputs: lazily minted rows (bitwise), the host
``Parameters`` store, the sparse optimizer apply (rows and slot rows,
``optax`` SGD / momentum / Adam / Adagrad against their torch
counterparts), the duplicate-id combine and the staleness modulation of
the learning rate."""

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.tensor import (
    Tensor as JTensor,
    combine_indexed_slices as jcombine,
)
from elasticdl_tpu.ps import embedding_table as jtable
from elasticdl_tpu.ps.optimizer_wrapper import OptimizerWrapper as JWrapper
from elasticdl_tpu.ps.parameters import (
    EmbeddingTableInfo as JInfo,
    Parameters as JParameters,
)
from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    combine_indexed_slices,
)
from elasticdl_tpu_torch.master.learning_rate_modulator import (
    add_lr_modulation_to_optimizer,
)
from elasticdl_tpu_torch.ps import embedding_table as ttable
from elasticdl_tpu_torch.ps.optimizer_wrapper import (
    OptimizerWrapper,
    probe_row_state,
)
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters


@pytest.mark.parametrize(
    "initializer", ["uniform", "normal", "random_normal", "zeros", "ones",
                    "0.25", None]
)
@pytest.mark.parametrize("seed", [0, 7])
def test_lazy_rows_are_bitwise_the_references(initializer, seed):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([
        rng.integers(0, 1 << 20, 64), [0, -3, (1 << 40) + 5],
    ]).astype(np.int64)
    want = jtable._make_initializer(initializer, seed)(ids, 16)
    got = ttable._make_initializer(initializer, seed)(ids, 16)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_lazy_rows_are_order_independent_and_match_the_table():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5000, 200)
    a = ttable.EmbeddingTable("t", 8, "uniform")
    b = ttable.EmbeddingTable("t", 8, "uniform")
    ref = jtable.EmbeddingTable("t", 8, "uniform")
    forward = a.get(ids)
    b.get(ids[::-1])
    assert np.array_equal(b.get(ids), forward)
    assert np.array_equal(forward, ref.get(ids))
    snap_ids, snap_rows = b.snapshot()
    assert sorted(snap_ids) == sorted(set(ids.tolist())) == sorted(
        b.embedding_vectors)
    assert np.array_equal(snap_rows, b.get(snap_ids))
    assert len(a) == len(b) == len(set(ids.tolist()))
    assert ttable.get_slot_table_name("emb", "exp_avg") == "emb-exp_avg"
    with pytest.raises(ValueError, match="Unknown embedding initializer"):
        ttable.EmbeddingTable("t", 8, "glorot")


def test_parameters_store_matches_the_reference():
    infos = [("emb", 4, "uniform"), ("bias", 1, "zeros")]
    store, ref = Parameters(), JParameters()
    store.init_embedding_params([EmbeddingTableInfo(*i) for i in infos])
    ref.init_embedding_params([JInfo(*i) for i in infos])
    # first write wins: a second registration changes nothing
    store.init_embedding_params([EmbeddingTableInfo("emb", 9, "ones")])
    assert store.embedding_params["emb"].dim == 4
    ids = np.array([5, 2, 5])
    assert np.array_equal(store.get_embedding_param("emb", ids),
                          ref.get_embedding_param("emb", ids))
    store.set_embedding_param("bias", [2], np.ones((1, 1), np.float32))
    assert store.get_embedding_param("bias", [2])[0, 0] == 1.0
    store.create_slot_params(["m"], {"m": 0.5})
    ref.create_slot_params(["m"], {"m": 0.5})
    assert sorted(store.embedding_params) == sorted(ref.embedding_params)
    assert np.array_equal(store.get_embedding_param("emb-m", [4]),
                          np.full((1, 4), 0.5, np.float32))
    assert store.embedding_params["emb-m"].is_slot


@pytest.mark.parametrize("kwargs", [dict(device=True),
                                    dict(tier_config={"warm_rows": 4})])
def test_unported_stores_raise_by_name(kwargs, monkeypatch):
    """The device and tiered stores are ported; a store that cannot be
    built as asked raises, naming what is missing: the arena on a host
    without a card (no fallback to the host store), a tier without its
    spill directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, ValueError),
                       match="CUDA" if "device" in kwargs else "spill_dir"):
        Parameters(**kwargs)


OPTIMIZERS = {
    # name: (torch factory, optax transformation, {torch slot: optax slot},
    #        atol, rtol)
    "sgd": (lambda p: torch.optim.SGD(p, lr=0.1), optax.sgd(0.1), {},
            1e-6, 0.0),
    "momentum": (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
                 optax.sgd(0.1, momentum=0.9),
                 {"momentum_buffer": "0/trace"}, 1e-6, 0.0),
    # optax computes Adam's bias correction 1 - b2**t in float32, torch in
    # double: at the default b2 = 0.999, 1 - 0.999f is 1.3e-5 off, which
    # parts the two by ~3e-7 after four steps at lr 0.01. b2 = 0.9375 is
    # exact in float32, so the rows are held at the stated tolerance;
    # "adam_default" holds the default betas to that measured gap.
    "adam": (lambda p: torch.optim.Adam(p, lr=0.01, betas=(0.9, 0.9375)),
             optax.adam(0.01, b2=0.9375),
             {"exp_avg": "0/mu", "exp_avg_sq": "0/nu"}, 1e-7, 1e-5),
    "adam_default": (lambda p: torch.optim.Adam(p, lr=0.01),
                     optax.adam(0.01),
                     {"exp_avg": "0/mu", "exp_avg_sq": "0/nu"}, 1e-6, 1e-5),
    "adagrad": (lambda p: torch.optim.Adagrad(
        p, lr=0.1, initial_accumulator_value=0.1, eps=1e-10),
        optax.adagrad(0.1, initial_accumulator_value=0.1, eps=1e-10),
        {"sum": "0/sum_of_squares"}, 1e-7, 1e-5),
}


def test_probed_slot_layout_is_optaxs():
    for name, (factory, opt, slots, _, _) in OPTIMIZERS.items():
        fresh, per_layer = probe_row_state(factory, 4, "cpu")
        assert sorted(fresh) == sorted(slots), name
        template = JWrapper(opt, JParameters())._row_state_template(4)[2]
        for key, ref_key in slots.items():
            assert np.array_equal(fresh[key], template[ref_key]), name
        if name.startswith("adam"):
            assert float(per_layer["step"]) == 0.0
        else:
            assert not {k for k in per_layer if k != "step"}, name


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sparse_apply_matches_the_references(name):
    factory, opt, slots, atol, rtol = OPTIMIZERS[name]
    store, ref = Parameters(), JParameters()
    store.init_embedding_params([EmbeddingTableInfo("emb", 8, "uniform")])
    ref.init_embedding_params([JInfo("emb", 8, "uniform")])
    wrapper = OptimizerWrapper(factory, store, "cpu")
    ref_wrapper = JWrapper(opt, ref)
    rng = np.random.default_rng(11)
    seen = set()
    for step in range(4):
        # duplicates in even steps, new ids joining in every step
        ids = rng.integers(0, 40 + 10 * step, 24)
        if step % 2:
            ids = np.unique(ids)
        values = rng.normal(size=(len(ids), 8)).astype(np.float32)
        wrapper.apply_gradients(
            embedding_grads={"emb": Tensor("emb", values, ids)})
        ref_wrapper.apply_gradients(
            embedding_grads={"emb": JTensor("emb", values, ids)}
        )
        seen.update(int(i) for i in ids)
    ids = np.array(sorted(seen))
    np.testing.assert_allclose(
        store.get_embedding_param("emb", ids),
        ref.get_embedding_param("emb", ids), atol=atol, rtol=rtol,
    )
    for key, ref_key in slots.items():
        np.testing.assert_allclose(
            store.get_embedding_param("emb-" + key, ids),
            ref.get_embedding_param("emb-" + ref_key, ids),
            atol=atol, rtol=rtol,
        )
    if name.startswith("adam"):
        assert float(wrapper._non_row_state["emb"]["step"]) == 4.0


@pytest.mark.parametrize("dup", [False, True])
def test_combine_indexed_slices_matches_the_reference(dup):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 8 if dup else 1000, 12)
    if not dup:
        ids = rng.permutation(np.unique(ids))
    values = rng.normal(size=(len(ids), 3)).astype(np.float32)
    got, want = combine_indexed_slices(ids, values), jcombine(ids, values)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    t = Tensor("e", values, ids) + Tensor("e", values[:2], ids[:2])
    ref = JTensor("e", values, ids) + JTensor("e", values[:2], ids[:2])
    assert np.array_equal(t.indices, ref.indices)
    assert np.array_equal(t.values, ref.values)
    got, want = (combine_indexed_slices(t.indices, t.values),
                 jcombine(ref.indices, ref.values))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    dense = sum([Tensor("d", values), Tensor("d", values)])
    assert np.array_equal(dense.values, 2 * values)
    with pytest.raises(ValueError, match="sparse and dense"):
        Tensor("e", values, ids) + Tensor("e", values)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_lr_modulation_scales_one_step_as_the_reference(name):
    """One step at multiplier 1/3 equals the unmodulated step's update
    times 1/3 (the reference scales optax's updates), and the next step
    runs at the full rate again."""
    factories = {
        "sgd": lambda p: torch.optim.SGD(p, lr=0.1),
        "momentum": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
        "adam": lambda p: torch.optim.Adam(p, lr=0.01),
        "adamw": lambda p: torch.optim.AdamW(p, lr=0.01, weight_decay=0.1),
    }
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2)]

    def run(multipliers):
        factory, modulation = add_lr_modulation_to_optimizer(factories[name])
        p = torch.tensor(w0, dtype=torch.float64).requires_grad_(True)
        opt = factory([p])
        out = []
        for g, m in zip(grads, multipliers):
            before = p.detach().clone()
            modulation.set_multiplier(m)
            p.grad = torch.tensor(g, dtype=torch.float64)
            opt.step()
            modulation.set_multiplier(1.0)
            out.append((p.detach() - before).numpy())
        assert [g["lr"] for g in opt.param_groups] == [
            factories[name]([torch.zeros(1)]).param_groups[0]["lr"]
        ]
        return out

    full, scaled = run([1.0, 1.0]), run([1.0 / 3, 1.0])
    np.testing.assert_allclose(scaled[0], full[0] / 3, rtol=1e-12)


@pytest.mark.parametrize(
    "name, shape, indices",
    [("emb", (2, 4), None), ("emb", (2, 3), [1, 2]),
     ("nope", (2, 4), [1, 2]), ("emb", (2, 4), [1, 9])],
    ids=["unindexed", "wrong_width", "unknown_table", "accepted"],
)
def test_embedding_grad_checks_match_the_reference(name, shape, indices):
    """The store's checks of an embedding gradient, message for message
    the reference's (the dense gradients' checks are the servicer's,
    tests/test_torch_ps_servicer.py)."""
    store, ref = Parameters(), JParameters()
    store.init_embedding_params([EmbeddingTableInfo("emb", 4, "uniform")])
    ref.init_embedding_params([JInfo("emb", 4, "uniform")])
    values = np.ones(shape, np.float32)
    try:
        want = ref.check_grad(JTensor(name, values, indices))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            store.check_grad(Tensor(name, values, indices))
        assert str(got.value) == str(e)
    else:
        assert want is True
        assert store.check_grad(Tensor(name, values, indices)) is True
