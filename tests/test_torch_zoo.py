"""The port's zoo models that need no PS fleet against the JAX package's.

The same records, encoded once from a numpy seed, go through each
package's own ``dataset_fn`` (evaluation mode: no shuffle) and its model,
from one set of weights carried across by ``common/convert.py``: the flax
init converted to the port's ``state_dict`` (ResNet-50 the other way, the
port's seeded init converted to flax's names: a flax init of ResNet-50
takes ~20 s on the CPU). Dropout is the identity on both sides, as in
tests/test_torch_evaluation.py. Each model is held on

- the inference forward (every output of a dict);
- one SGD step at the zoo's own rate: the loss, and every updated
  parameter mapped back by ``convert.to_named``.

Tolerances, float32, (rtol, atol): the CNNs (mnist_functional_api,
cifar10 x2) (1e-4, 1e-5) on the outputs and the loss, (1e-4, 2e-5) on
the stepped parameters. GroupNorm's variance is Welford's in torch and
E[x^2] - E[x]^2 in flax, and oneDNN and XLA sum the convolutions in
different orders; both differ at rounding, well inside these bounds (the
outputs read 2.4e-6 apart at most, the stepped parameters 1.5e-7, the
loss 4.8e-7). DeepFM (both forms) (1e-5, 1e-6): gathers and small
products (outputs 9.5e-7 apart, parameters 1.2e-7). ResNet-50
(resnet50_subclass, 32x32, batch 8) the outputs (1e-4, 1e-5), the loss
(1e-4, 1e-6) and the stepped parameters (1e-4, 1e-5) (they read 4.5e-8,
1.9e-6 and 3.9e-6): the port scales uint8 images on the device (x *
(1/255)) where the reference divides on the host, an ulp apart.

Then every new zoo entry through the port's command line on the CPU:
``train`` with ``--validation_data`` (rounds published at the
evaluation steps, checkpoints written), ``evaluate --checkpoint_dir``
and ``predict --checkpoint_dir`` with a capturing processor (every
record once, its outputs equal to a direct forward of the checkpoint).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.constants import Mode as JMode
from elasticdl_tpu.common.tensor import (
    named_arrays_to_nested,
    pytree_to_named_arrays,
)
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.nn.model_api import init_variables as jinit
from elasticdl_tpu_torch import cli
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.nn.model_api import init_variables, split_variables
from elasticdl_tpu_torch.training import step as tstep
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)

BATCH = 8


def _flax_no_dropout(self, x, *args, **kwargs):
    return x


def _torch_no_dropout(x, *args, **kwargs):
    return x


@pytest.fixture
def no_dropout(monkeypatch):
    import flax.linen as flax_nn

    monkeypatch.setattr(flax_nn.Dropout, "__call__", _flax_no_dropout)
    monkeypatch.setattr(torch.nn.functional, "dropout", _torch_no_dropout)


def _images(shape, dtype=np.float32):
    def make(rng, n):
        if dtype == np.uint8:
            return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        return (rng.random((n,) + shape, dtype=np.float32) * 255).astype(
            np.float32)
    return make


def _ids(vocab, zero_share=0.1):
    def make(rng, n):
        ids = rng.integers(1, vocab, (n, 10), dtype=np.int64)
        ids[rng.random((n, 10)) < zero_share] = 0  # mask_zero does work
        return ids
    return make


# name -> (model_def symbol, model params, the feature key and maker,
# classes (labels in [0, classes), 1-based for resnet50), tolerances)
CASES = {
    "mnist_functional_api": dict(
        symbol="custom_model", params={}, key="image",
        make=_images((28, 28)), classes=10,
        tol=dict(out=(1e-4, 1e-5), step=(1e-4, 2e-5)),
    ),
    "cifar10_subclass": dict(
        symbol="CustomModel", params={}, key="image",
        make=_images((32, 32, 3)), classes=10,
        tol=dict(out=(1e-4, 1e-5), step=(1e-4, 2e-5)),
    ),
    "cifar10_functional_api": dict(
        symbol="custom_model", params={}, key="image",
        make=_images((32, 32, 3)), classes=10,
        tol=dict(out=(1e-4, 1e-5), step=(1e-4, 2e-5)),
    ),
    "deepfm_functional_api": dict(
        symbol="custom_model",
        params=dict(input_dim=64, embedding_dim=8, fc_unit=8),
        key="feature", make=_ids(64), classes=2,
        tol=dict(out=(1e-5, 1e-6), step=(1e-5, 1e-6)),
    ),
    "deepfm_edl_embedding": dict(
        symbol="build_host_model",
        params=dict(vocab_size=64, embedding_dim=8, fc_unit=8),
        key="feature", make=_ids(64), classes=2,
        tol=dict(out=(1e-5, 1e-6), step=(1e-5, 1e-6)),
    ),
    "resnet50_subclass": dict(
        symbol="CustomModel", params=dict(num_classes=10, dtype="float32"),
        key="image", make=_images((32, 32, 3), np.uint8), classes=10,
        one_based=True, port_init=True,
        tol=dict(out=(1e-4, 1e-5), loss=(1e-4, 1e-6), step=(1e-4, 1e-5)),
    ),
}


def _zoos(name):
    import importlib

    jzoo = importlib.import_module("model_zoo.%s.%s" % (name, name))
    tzoo = importlib.import_module(
        "elasticdl_tpu_torch.model_zoo.%s.%s" % (name, name))
    return jzoo, tzoo


def _records(case, n, seed):
    rng = np.random.default_rng(seed)
    features = case["make"](rng, n)
    labels = rng.integers(0, case["classes"], n) + case.get("one_based", 0)
    return [
        encode_example({
            case["key"]: f.reshape(-1) if case["key"] == "image"
            and f.dtype != np.uint8 else f,
            "label": np.array([y], np.int64),
        })
        for f, y in zip(features, labels)
    ]


def _batch(dataset_cls, zoo, records, mode):
    ds = zoo.dataset_fn(dataset_cls.from_tensors(records), mode, None)
    return next(iter(ds.batch(len(records))))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _weights(name, case, jmodel, tmodel, features):
    """(flax variables, port params, port state) of one set of
    weights."""
    if case.get("port_init"):
        params, state = split_variables(init_variables(tmodel, 3))
        named = {"params/" + k: v
                 for k, v in convert.to_named(params).items()}
        named.update(convert.to_named(state))
        variables = named_arrays_to_nested(
            {k: jnp.asarray(v.numpy()) for k, v in named.items()})
        return variables, params, state
    variables = jax.jit(functools.partial(jinit, jmodel))(
        jax.random.PRNGKey(1), features)
    named = pytree_to_named_arrays(variables["params"])
    params = convert.to_state_dict(named)
    state = convert.to_state_dict(pytree_to_named_arrays(
        {k: v for k, v in variables.items() if k != "params"}))
    return variables, params, state


def _jax_forward_and_step(jmodel, jzoo, variables, features, labels, lr):
    """The inference forward and one SGD step, in one jit (one compile
    per architecture): (outputs, loss, stepped params)."""
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(p):
        out, _ = jmodel.apply({"params": p, **rest}, features, training=True,
                              mutable=list(rest))
        return jzoo.loss(out, jnp.asarray(labels))

    @jax.jit
    def run(params):
        out = jmodel.apply({"params": params, **rest}, features,
                           training=False)
        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, _ = optax.sgd(lr).update(grads, optax.sgd(lr).init(params))
        return out, loss, optax.apply_updates(params, updates)

    out, loss, params = run(variables["params"])
    return _numpy_tree(out), float(loss), params


def _build(zoo, case):
    return getattr(zoo, case["symbol"])(**case["params"])


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_model_forward_and_step_match_jax(name, no_dropout):
    case = CASES[name]
    jzoo, tzoo = _zoos(name)
    records = _records(case, BATCH, seed=4)
    jfeatures, jlabels = _batch(JDataset, jzoo, records, JMode.EVALUATION)
    tfeatures, tlabels = _batch(Dataset, tzoo, records, Mode.EVALUATION)
    jmodel, tmodel = _build(jzoo, case), _build(tzoo, case)
    variables, params, state = _weights(name, case, jmodel, tmodel,
                                        jfeatures)
    # every parameter of the port's model, and nothing else, was carried
    want = dict(tmodel.named_parameters())
    assert sorted(params) == sorted(want)
    for k, v in params.items():
        assert tuple(v.shape) == tuple(want[k].shape), k

    lr = tzoo.optimizer().keywords["lr"]
    assert lr == jzoo.optimizer.__defaults__[0]
    jout, jloss, jparams = _jax_forward_and_step(
        jmodel, jzoo, variables, jfeatures, jlabels, lr)

    # the inference forward
    tout = _numpy_tree(tstep.make_forward_fn(tmodel)(params, state,
                                                     tfeatures))
    rtol, atol = case["tol"]["out"]
    if isinstance(jout, dict):
        assert sorted(jout) == sorted(tout) == ["logits", "probs"]
        for k in jout:
            np.testing.assert_allclose(tout[k], jout[k], rtol, atol,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(tout, jout, rtol, atol)

    # one SGD step at the zoo's rate
    ts = tstep.TrainState.create(params, state, tzoo.optimizer())
    ts, tloss = tstep.make_train_step(tmodel, tzoo.loss)(
        ts, tfeatures, tlabels)
    np.testing.assert_allclose(float(tloss), jloss,
                               *case["tol"].get("loss", case["tol"]["out"]))
    got = convert.to_named(ts.params)
    want = pytree_to_named_arrays(jparams)
    assert sorted(got) == sorted(want)
    rtol, atol = case["tol"]["step"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol, atol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_weight_map_round_trips(name):
    """The port's keys -> flax names -> the port's keys, exactly, through
    the map that each side's full name set selects."""
    case = CASES[name]
    _, tzoo = _zoos(name)
    params, _ = split_variables(init_variables(_build(tzoo, case), 0))
    back = convert.to_state_dict(convert.to_named(params))
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert torch.equal(back[k], v.detach()), k


def test_the_maps_of_cnns_do_not_collide():
    """flax's creation-order names mean different layers per
    architecture: the MNIST CNN's only GroupNorm and the CIFAR-10 CNN's
    first, a CNN's Dense_0 head and DeepFM's Dense_0 output layer. Each
    model's full name set selects its own map."""
    def keys(prefixes):
        return sorted(convert.to_state_dict(
            {p: np.ones(4, np.float32) for p in prefixes}))

    cnn = ["Conv_%d/bias" % j for j in range(2)] + ["Dense_0/bias"]
    assert keys(cnn + ["GroupNorm_0/scale"]) == [
        "conv0.bias", "conv1.bias", "group_norm.weight", "head.bias"]
    assert keys(cnn + ["GroupNorm_%d/scale" % j for j in range(6)]) == [
        "conv0.bias", "conv1.bias"] + [
        "group_norm%d.weight" % j for j in range(6)] + ["head.bias"]
    assert keys(["Embed_0/embedding", "Dense_0/bias", "Dense_1/bias"]) == [
        "embedding.weight", "out.bias", "tower.bias"]
    assert keys(["embedding/table", "Dense_0/bias"]) == [
        "embedding.table", "out.bias"]
    with pytest.raises(KeyError, match="no parameter mapping"):
        convert.to_state_dict({"GroupNorm_1/scale": np.ones(4),
                               "BatchNorm_0/scale": np.ones(4)})


def test_hbm_counter_is_dropped_from_the_reference_state():
    """The reference's HBM state carries metrics/<table>/a2a_overflow; on
    one device it cannot move, and the port keeps no counter."""
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

    jmodel = jzoo.build_host_model(vocab_size=16, embedding_dim=4,
                                   fc_unit=4)
    variables = jinit(jmodel, jax.random.PRNGKey(0),
                      {"feature": np.ones((2, 10), np.int64)})
    state = pytree_to_named_arrays(
        {k: v for k, v in variables.items() if k != "params"})
    assert sorted(state) == ["metrics/embedding/a2a_overflow",
                             "metrics/id_bias/a2a_overflow"]
    assert convert.to_state_dict(state) == {}


def test_cifar10_functional_processor_logs_and_refuses_odps(monkeypatch):
    from elasticdl_tpu_torch.model_zoo.cifar10_functional_api import (
        cifar10_functional_api as tzoo,
    )

    tzoo.PredictionOutputsProcessor().process(np.zeros((2, 10)), 0)
    for var in ("ODPS_PROJECT_NAME", "ODPS_ACCESS_ID", "ODPS_ACCESS_KEY"):
        monkeypatch.setenv(var, "x")
    with pytest.raises(NotImplementedError, match="ODPS"):
        tzoo.PredictionOutputsProcessor()


# ---------------------------------------------------------------------------
# every new zoo entry through the port's command line, on the CPU
# ---------------------------------------------------------------------------

JOB_BATCH = 4
TRAIN_RECORDS, VAL_RECORDS = 16, 8  # 4 steps, a round at 2 and 4

JOBS = {  # model_def -> (case, --model_params)
    "mnist_functional_api.mnist_functional_api.custom_model": (
        "mnist_functional_api", ""),
    "cifar10_subclass.cifar10_subclass.CustomModel": (
        "cifar10_subclass", ""),
    "cifar10_functional_api.cifar10_functional_api.custom_model": (
        "cifar10_functional_api", ""),
    "resnet50_subclass.resnet50_subclass.CustomModel": (
        "resnet50_subclass", "num_classes=10,dtype='float32'"),
    "deepfm_functional_api.deepfm_functional_api.custom_model": (
        "deepfm_functional_api", "input_dim=64,embedding_dim=8,fc_unit=8"),
    "deepfm_edl_embedding.deepfm_edl_embedding.custom_model": (
        "deepfm_edl_embedding", "vocab_size=64,embedding_dim=8,fc_unit=8"),
}


def _write(directory, records):
    os.makedirs(directory)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for r in records:
            w.write(r)
    return directory


def _argv(verb, model_def, params, *extra):
    argv = [
        verb, "--job_name", "zoo", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "0", "--model_zoo", "",
        "--model_def", model_def, "--minibatch_size", str(JOB_BATCH),
        "--num_minibatches_per_task", "2", "--device", "cpu",
        "--log_level", "WARNING",
    ] + list(extra)
    if params:
        argv += ["--model_params", params]
    return argv


class _Capture(BasePredictionOutputsProcessor):
    def __init__(self):
        self.chunks = []

    def process(self, predictions, worker_id):
        self.chunks.append(predictions)


def _checkpoint(directory):
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )

    _, leaves = load_sharded_to_host(directory)
    split = {"params": {}, "state": {}}
    for path, value in leaves.items():
        head, _, name = path.partition("/")
        if head in split:
            split[head][name] = value
    return split["params"], split["state"]


@pytest.mark.parametrize("model_def", list(JOBS))
def test_zoo_entry_trains_evaluates_and_predicts(model_def, tmp_path,
                                                 monkeypatch):
    name, params = JOBS[model_def]
    case = CASES[name]
    _, tzoo = _zoos(name)
    train = _write(str(tmp_path / "train"),
                   _records(case, TRAIN_RECORDS, seed=1))
    val = _write(str(tmp_path / "val"), _records(case, VAL_RECORDS, seed=2))
    ckpt = str(tmp_path / "ckpt")
    jobs = []
    rc = cli.main(_argv(
        "train", model_def, params, "--training_data", train,
        "--validation_data", val, "--evaluation_steps", "2",
        "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
        "--output", str(tmp_path / "export"),
    ), jobs=jobs)
    job = jobs[0]
    assert rc == 0 and job.worker.trainer.version == 4
    assert all(np.isfinite(job.losses))
    rounds = job.master.evaluation_service.published
    assert [r["version"] for r in rounds] == [2, 4]
    for r in rounds:
        metrics = r["metrics"]
        if name.startswith("deepfm"):
            assert sorted(metrics) == ["logits", "probs"]
            assert 0.0 <= metrics["probs"]["auc"] <= 1.0
        else:
            assert 0.0 <= metrics["accuracy"] <= 1.0
    assert sorted(os.listdir(ckpt)) == ["ckpt_v2", "ckpt_v4"]
    assert os.listdir(str(tmp_path / "export"))
    if name == "deepfm_edl_embedding":
        # the HBM table is a parameter, checkpointed under its own name
        ts = job.worker.trainer.train_state
        assert tuple(ts.params["embedding.table"].shape) == (64, 8)
        assert "params/embedding.table" in _leaf_names(ckpt + "/ckpt_v4")
        # and the SAVE_MODEL export under the reference's name
        from elasticdl_tpu_torch.common.model_utils import (
            load_from_checkpoint_file,
        )

        export = str(tmp_path / "export")
        _, named = load_from_checkpoint_file(
            os.path.join(export, os.listdir(export)[0]))
        assert named["embedding/table"].shape == (64, 8)
        assert "metrics/embedding/a2a_overflow" not in named

    # evaluate the checkpoints
    rc = cli.main(_argv("evaluate", model_def, params, "--validation_data",
                        val, "--checkpoint_dir", ckpt), jobs=jobs)
    scored = jobs[1].master.evaluation_service.published
    assert rc == 0 and scored[0]["scored_versions"] == [4]
    assert scored[0]["metrics"] == rounds[-1]["metrics"]

    # predict with a capturing processor: every record once, equal to a
    # direct forward of the newest checkpoint
    capture = _Capture()
    monkeypatch.setattr(tzoo, "PredictionOutputsProcessor", capture,
                        raising=False)
    rc = cli.main(_argv("predict", model_def, params, "--prediction_data",
                        val, "--checkpoint_dir", ckpt), jobs=jobs)
    assert rc == 0 and jobs[2].master.task_d.finished()
    got = capture.chunks
    model = (tzoo.build_host_model(**_kwargs(params))
             if hasattr(tzoo, "build_host_model") else _build(tzoo, case))
    want = tstep.make_forward_fn(model)(
        *_checkpoint(ckpt + "/ckpt_v4"),
        _batch(Dataset, tzoo, _records(case, VAL_RECORDS, seed=2),
               Mode.PREDICTION),
    )
    if isinstance(want, dict):
        assert all(isinstance(c, dict) for c in got)
        for k in want:
            np.testing.assert_allclose(
                np.concatenate([c[k] for c in got]), want[k].numpy(),
                rtol=1e-5, atol=1e-6, err_msg=k)
    else:
        np.testing.assert_allclose(np.concatenate(got), want.numpy(),
                                   rtol=1e-5, atol=1e-6)


def _kwargs(params):
    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )

    return get_dict_from_params_str(params) or {}


def _leaf_names(directory):
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )

    return set(load_sharded_to_host(directory)[1])


def test_resnet50_subclass_contract_matches_jax():
    """The zoo's loss (NLL of probabilities clipped to [1e-7, 1]), its
    plain SGD at 0.02 and its 1-based labels, against the JAX zoo's."""
    from model_zoo.resnet50_subclass import resnet50_subclass as jzoo
    from elasticdl_tpu_torch.model_zoo.resnet50_subclass import (
        resnet50_subclass as tzoo,
    )

    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    probs[0, 3] = 0.0  # clipped to 1e-7
    labels = np.array([3, 1, 2, 9, 0, 5], np.int32)
    np.testing.assert_allclose(
        float(tzoo.loss(torch.from_numpy(probs), labels)),
        float(jzoo.loss(jnp.asarray(probs), jnp.asarray(labels))),
        rtol=1e-6)
    opt = tzoo.optimizer()(
        [torch.nn.Parameter(torch.zeros(1))])
    assert opt.defaults["lr"] == 0.02 and opt.defaults["momentum"] == 0
    records = _records(CASES["resnet50_subclass"], 2, seed=9)
    _, jl = _batch(JDataset, jzoo, records, JMode.EVALUATION)
    _, tl = _batch(Dataset, tzoo, records, Mode.EVALUATION)
    np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))

