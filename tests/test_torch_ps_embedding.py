"""The port's elastic embedding layer against the JAX package's: the
capture pass, the batch-wide unique plan, and the outputs and gradients
(the dense parameters' and the rows buffer's) of one step, through
``make_embedding_grad_fn`` in both packages, with ``mask_zero``, the
three combiners and a layer called twice."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from elasticdl_tpu.nn import comm_plane as jplane
from elasticdl_tpu.nn import embedding as jemb
from elasticdl_tpu.training.step import (
    make_embedding_forward_fn as jforward_fn,
    make_embedding_grad_fn as jgrad_fn,
)
from elasticdl_tpu_torch.nn import comm_plane as tplane
from elasticdl_tpu_torch.nn import embedding as temb
from elasticdl_tpu_torch.training.step import (
    make_embedding_forward_fn,
    make_embedding_grad_fn,
)

B, L, DIM = 6, 5, 4


class JModel(fnn.Module):
    mask_zero: bool = False
    combiner: str = None
    twice: bool = False

    @fnn.compact
    def __call__(self, features, training=False):
        emb = jemb.Embedding(4, mask_zero=self.mask_zero,
                             combiner=self.combiner, name="emb")
        x = emb(features["ids"])
        if self.twice:
            x = x + emb(features["ids2"])
        return fnn.Dense(1)(x.reshape((x.shape[0], -1))).reshape(-1)


class TModel(tnn.Module):
    def __init__(self, mask_zero=False, combiner=None, twice=False):
        super().__init__()
        self.twice = twice
        self.emb = temb.Embedding(DIM, mask_zero=mask_zero, combiner=combiner)
        self.out = tnn.Linear(DIM * (1 if combiner else L), 1)

    def forward(self, features):
        x = self.emb(torch.as_tensor(features["ids"]))
        if self.twice:
            x = x + self.emb(torch.as_tensor(features["ids2"]))
        return self.out(x.reshape(x.shape[0], -1)).reshape(-1)


def _jloss(output, labels):
    return jnp.mean((output - labels) ** 2)


def _tloss(output, labels):
    return torch.mean((output - torch.as_tensor(labels)) ** 2)


CASES = [
    dict(),
    dict(mask_zero=True),
    dict(combiner="sum"),
    dict(mask_zero=True, combiner="mean"),
    dict(mask_zero=True, combiner="sqrtn"),
    dict(combiner="mean"),
    dict(mask_zero=True, twice=True),
]


@pytest.mark.parametrize(
    "case", CASES,
    ids=["plain", "mask_zero", "sum", "mask_mean", "mask_sqrtn", "mean",
         "twice"],
)
def test_step_matches_make_embedding_grad_fn(case):
    rng = np.random.default_rng(5)
    features = {"ids": rng.integers(0, 9, (B, L)).astype(np.int64),
                "ids2": rng.integers(0, 12, (B, L)).astype(np.int64)}
    features["ids"][0] = 0  # an all-padding row
    labels = rng.normal(size=B).astype(np.float32)
    jmodel, tmodel = JModel(**case), TModel(**case)
    variables = jmodel.init(jax.random.PRNGKey(0), features)
    params = variables["params"]
    with torch.no_grad():
        tmodel.out.weight.copy_(torch.from_numpy(
            np.asarray(params["Dense_0"]["kernel"]).T.copy()))
        tmodel.out.bias.copy_(torch.from_numpy(
            np.array(params["Dense_0"]["bias"])))
    tparams = {k: v.detach() for k, v in tmodel.named_parameters()}

    # the capture pass: each call's ids and the declared initializer
    n_calls = 2 if case.get("twice") else 1
    info = {}
    jcap = jemb.capture_embedding_ids(jmodel, {"params": params}, features,
                                      expected_count=n_calls)
    tcap = temb.capture_embedding_ids(tmodel, tparams, {}, features,
                                      layer_info=info)
    assert info == {"emb": (DIM, "uniform")}
    assert len(tcap["emb"]) == len(jcap[("emb",)]) == n_calls
    for got, want in zip(tcap["emb"], jcap[("emb",)]):
        assert np.array_equal(got, want)

    # one plan over all the calls, the same in both packages; the port
    # gathers from the unique rows unpadded, the reference from the same
    # rows padded to its bucket
    unique, idxs = tplane.plan_lookup_multi(tcap["emb"])
    junique, jidxs, jbucket = jplane.plan_lookup_multi(jcap[("emb",)])
    assert np.array_equal(unique, junique)
    assert all(np.array_equal(a, b) for a, b in zip(idxs, jidxs))
    rows = rng.normal(size=(len(unique), DIM)).astype(np.float32)
    jrows = jplane.pad_rows_to_bucket(rows, jbucket)

    rows_tree = jemb.build_collection({("emb",): jrows}, "rows")
    idx_tree = jemb.build_collection(
        {("emb", jemb.call_slot_name(i)): idx for i, idx in enumerate(jidxs)},
        "idx")
    jl, jg, jrows_g, _, jout = jgrad_fn(jmodel, _jloss)(
        params, rows_tree, {}, idx_tree, features, labels,
        jax.random.PRNGKey(1))
    tl, tg, trows_g, _, tout = make_embedding_grad_fn(tmodel, _tloss)(
        tparams, {"emb": torch.from_numpy(rows)}, {},
        {"emb": [torch.from_numpy(i.astype(np.int64)) for i in idxs]},
        features, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(
        tg["out.weight"].numpy().T, np.asarray(jg["Dense_0"]["kernel"]),
        atol=1e-5)
    assert trows_g["emb"].dtype == torch.float32
    assert trows_g["emb"].shape == (len(unique), DIM)
    jrows_g = np.asarray(jemb.flatten_collection(jrows_g, "rows")[("emb",)])
    np.testing.assert_allclose(trows_g["emb"].numpy(),
                               jrows_g[:len(unique)], atol=1e-5)
    # the reference's padded lanes get no gradient: the pushed rows agree
    assert not jrows_g[len(unique):].any()

    # the inference forward
    jf = jforward_fn(jmodel)(params, rows_tree, {}, idx_tree, features)
    tf = make_embedding_forward_fn(tmodel)(
        tparams, {"emb": torch.from_numpy(rows)}, {},
        {"emb": [torch.from_numpy(i.astype(np.int64)) for i in idxs]},
        features)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)


def test_a_layer_without_rows_raises_and_a_capture_stops_early():
    model = TModel(twice=True)
    with pytest.raises(RuntimeError, match="no rows bound"):
        model({"ids": np.ones((2, L), np.int64)})
    features = {"ids": np.ones((2, L), np.int64),
                "ids2": np.full((2, L), 3, np.int64)}
    params = dict(model.named_parameters())
    assert len(temb.capture_embedding_ids(
        model, params, {}, features, expected_count=1)["emb"]) == 1
    with pytest.raises(ValueError, match="called 2 times, planned for 1"):
        unique, idxs = tplane.plan_lookup_multi([features["ids"]])
        with temb.bind_rows(model, {"emb": torch.zeros(len(unique), DIM)},
                            {"emb": [torch.from_numpy(i.astype(np.int64))
                                     for i in idxs]}):
            model(features)
    with pytest.raises(ValueError, match="Unknown combiner"):
        temb.Embedding(4, combiner="max")


@pytest.mark.parametrize("shapes", [[(4, 3), (5,)], [(4, 3)]],
                         ids=["two_calls", "one_call"])
def test_plans_match_the_reference(shapes):
    """The deduplicated plan: the reference's unique ids and per-call
    positions (its bucket is padding the port does not keep)."""
    rng = np.random.default_rng(2)
    calls = [rng.integers(0, 30, shape) for shape in shapes]
    unique, idxs = tplane.plan_lookup_multi(calls)
    want_unique, want_idxs, _ = jplane.plan_lookup_multi(calls)
    assert np.array_equal(unique, want_unique)
    assert len(idxs) == len(want_idxs) == len(calls)
    for got, want, call in zip(idxs, want_idxs, calls):
        assert got.dtype == np.int32 and got.shape == call.shape
        assert np.array_equal(got, want)
        assert np.array_equal(unique[got], call)
