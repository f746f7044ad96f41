"""The evaluation forward of the port's elastic worker in a training job
(``ElasticAllReduceWorker._local_forward``), against the JAX worker's
(``elasticdl_tpu/worker/elastic_allreduce_worker.py:1550``): the
counterpart of ``tests/test_elastic_allreduce.py:338``.

- The version pin: a round pinned at version V scores the snapshot taken
  at V even after training moves on, a new round refreshes it, and a
  late grab scores the current state and reports the version it scored.
- Parity: one seeded set of weights, crossing through
  ``common/convert.py``, scored by both workers' ``_local_forward`` over
  their trainers' host snapshots: the MNIST CNN (GroupNorm, dropout off
  in the inference forward) and a conv -> BatchNorm -> dense model with
  planted running statistics (the snapshot must carry them, and the
  forward must use them), in float32 within 1e-5.
"""

import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.constants import JobType as JJobType
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables, split_variables
from elasticdl_tpu.worker.elastic_allreduce_worker import (
    ElasticAllReduceWorker as JaxWorker,
)
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
    ElasticAllReduceWorker,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = "mnist_subclass.mnist_subclass.CustomModel"
TOL = 1e-5


class _FakeTS:
    def __init__(self, params, state):
        self.params = params
        self.state = state


class _FakeTrainer:
    """What ``_local_forward`` reads of a trainer: its version, whether it
    is sharded, and its host snapshot."""

    is_sharded = False
    has_state = True

    def __init__(self, params, state, version=5):
        self.params, self.state, self.version = params, state, version
        self.snapshots = 0

    def snapshot(self):
        self.snapshots += 1
        return _FakeTS(self.params, self.state)


def _port_worker():
    return ElasticAllReduceWorker(
        0, JobType.TRAINING_WITH_EVALUATION, 4, "", MNIST, device="cpu"
    )


def test_local_forward_pins_the_version_snapshot():
    worker = _port_worker()

    class Versioned(_FakeTrainer):
        def snapshot(self):
            return _FakeTS({"w": torch.tensor(float(self.version))}, {})

    worker.trainer = Versioned(None, None, version=5)
    worker._forward_fn = lambda params, state, x: float(params["w"])
    # a round pinned at the current version: exact
    assert worker._local_forward("x", pinned_version=5) == 5
    assert worker._eval_scored_version == 5
    # training moves on; the round's other tasks keep the v5 snapshot
    worker.trainer.version = 7
    assert worker._local_forward("x", pinned_version=5) == 5
    assert worker._eval_scored_version == 5
    # a round at v7 refreshes
    assert worker._local_forward("x", pinned_version=7) == 7
    assert worker._eval_scored_version == 7
    # a late grab (v6 was never snapshotted): the current state, and
    # the version it really scored
    worker.trainer.version = 9
    assert worker._local_forward("x", pinned_version=6) == 9
    assert worker._eval_scored_version == 9


class _FlaxConvBN(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, inputs, training=False):
        x = flax_nn.Conv(8, (3, 3), padding="VALID", use_bias=False)(
            inputs["image"]
        )
        x = flax_nn.BatchNorm(use_running_average=not training,
                              momentum=0.9, epsilon=1e-5)(x)
        x = jnp.mean(flax_nn.relu(x), axis=(1, 2))
        return flax_nn.Dense(3)(x)


class _TorchConvBN(torch.nn.Module):
    """The port's twin, in the names ``convert`` maps to flax's."""

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


def _models(name):
    """(flax model, torch model or None for the zoo's, features)."""
    rng = np.random.default_rng(3)
    if name == "mnist":
        from model_zoo.mnist_subclass.mnist_subclass import CustomModel

        return CustomModel(), None, {
            "image": rng.random((6, 28, 28), dtype=np.float32)
        }
    return _FlaxConvBN(), _TorchConvBN(), {
        "image": rng.standard_normal((6, 9, 9, 3)).astype(np.float32)
    }


def _seeded(tree, rng):
    """Replace every leaf with seeded values of its shape; variances stay
    positive."""
    def leaf(path, x):
        value = rng.standard_normal(x.shape).astype(np.float32) * 0.3
        if "var" in jax.tree_util.keystr(path):
            value = np.abs(value) + 0.5
        elif "mean" in jax.tree_util.keystr(path):
            value = value + 0.7
        return value

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("name", ["mnist", "conv_bn"])
def test_local_forward_matches_the_jax_workers(name):
    flax_model, torch_model, features = _models(name)
    variables = init_variables(flax_model, jax.random.PRNGKey(0),
                               {"image": features["image"][:1]})
    params, state = split_variables(variables)
    rng = np.random.default_rng(11)
    params, state = _seeded(params, rng), _seeded(state, rng)

    jworker = JaxWorker(worker_id=0, job_type=JJobType.TRAINING_ONLY,
                        minibatch_size=4, model_zoo=os.path.join(
                            REPO, "model_zoo"),
                        model_def=MNIST, stub=None)
    jworker._model = flax_model
    jworker.trainer = _FakeTrainer(params, state)
    want = np.asarray(jworker._local_forward(features, pinned_version=5))

    worker = _port_worker()
    if torch_model is not None:
        worker._model = torch_model
    named = dict(pytree_to_named_arrays(params))
    named.update(pytree_to_named_arrays(state))
    host = convert.to_state_dict(named)
    names = dict(worker._model.named_parameters())
    worker.trainer = _FakeTrainer(
        {k: v for k, v in host.items() if k in names},
        {k: v for k, v in host.items() if k not in names},
    )
    if name == "conv_bn":  # the planted statistics cross over
        assert sorted(worker.trainer.state) == ["norm0.running_mean",
                                                "norm0.running_var"]
    got = worker._local_forward(
        {"image": torch.from_numpy(features["image"])}, pinned_version=5
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert worker._eval_scored_version == jworker._eval_scored_version == 5
    # the second task of the round reuses the snapshot
    worker._local_forward({"image": torch.from_numpy(features["image"])},
                          pinned_version=5)
    assert worker.trainer.snapshots == 1
