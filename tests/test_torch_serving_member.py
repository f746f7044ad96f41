"""The serving member of the port's export artifact (``serving_fn.pt2``,
``common/export.py``), on the CPU, against the JAX package's
``serving_fn.jaxexport``:

- a BatchNorm module whose running statistics a training step moved
  serves them through the member at batch sizes 1 and 7, equal to its
  eval forward;
- the small LM with the flash branch forced (``pick_causal_attention``
  from length 64): the graph holds the ``edl_tpu_torch::flash_fwd`` node,
  and the member's logits equal the module's and the JAX LM's; a fresh
  process that imports only ``torch`` and the ops module serves it;
- a forward that cannot be traced leaves a params-only artifact;
- ResNet-50 (10 classes, 32x32 images) exported by the JAX package with
  its serving function closing over perturbed statistics, against the
  port's member from the same weights and statistics (f32, 1e-5);
- crossing: the reference reads a port artifact with a member as a
  params-only one and scores it by rebuild; the port scores a reference
  MNIST artifact with a JAX member by rebuild, equal to the JAX member;
  it refuses a reference BatchNorm artifact with a JAX member by name;
- the export sites: the ALLREDUCE job's and the PS job's SAVE_MODEL
  artifacts carry the member and the port's scorer serves through it;
  ``deepfm_edl_embedding`` carries one on the HBM plane and none on the
  PS plane, as the reference's do; a streaming export carries none.

Tolerances: the member against the module it was traced from is exact
(the same kernels in the same order); against the JAX package, float32
1e-5 absolute (softmax probabilities; oneDNN and XLA sum convolutions in
different orders) and the serving tests' 2e-4 for the LM's logits.
"""

import functools
import glob
import json
import logging
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import export as jexport
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn.model_api import init_variables as jinit
from elasticdl_tpu.serving.scorer import ScorerModel as JaxScorerModel
from elasticdl_tpu_torch import cli
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common import export as texport
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.model_zoo.resnet50_subclass import (
    resnet50_model as tmodel,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    transformer_lm as tlm,
)
from elasticdl_tpu_torch.nn import layers as tlayers
from elasticdl_tpu_torch.nn.model_api import apply_model
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.serving.scorer import ScorerModel
from model_zoo.mnist_subclass import mnist_subclass as jmnist
from model_zoo.resnet50_subclass import resnet50_model as jmodel
from model_zoo.transformer_lm import transformer_lm as jlm
from tests.test_torch_resnet import _images, _perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
LM_DEF = "transformer_lm.transformer_lm.custom_model"
LM_PARAMS = (
    "vocab_size=128,num_layers=2,num_heads=4,head_dim=16,embed_dim=64,"
    "mlp_dim=256"
)
LM_LEN = 64
MNIST = "mnist_subclass.mnist_subclass.CustomModel"
RESNET = "resnet50_subclass.resnet50_subclass.CustomModel"
DEEPFM_EDL = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
F32_ATOL = 1e-5
LM_TOL = dict(rtol=2e-4, atol=2e-4)


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def _tokens(rows, seed=0):
    return np.random.default_rng(seed).integers(
        0, 128, (rows, LM_LEN)).astype(np.int32)


# -- a BatchNorm module ------------------------------------------------------


class _Norm(torch.nn.Module):
    """A dense layer, the port's BatchNorm over its 8 channels, a head."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(5, 8)
        self.norm = tlayers.BatchNorm(8)
        self.head = torch.nn.Linear(8, 3)

    def forward(self, features):
        x = features["x"]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        return self.head(torch.relu(self.norm(self.dense(x.float()))))


@pytest.mark.parametrize("rows", [1, 7])
def test_a_batchnorm_member_serves_the_statistics_a_step_moved(rows,
                                                               tmp_path):
    torch.manual_seed(0)
    model = _Norm()
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((16, 5))).astype(np.float32)
    _, moved = apply_model(model, params, state, {"x": x}, training=True)
    assert not torch.equal(moved["norm.running_mean"],
                           state["norm.running_mean"])
    manifest = texport.export_model(
        str(tmp_path), {k: v.detach() for k, v in params.items()}, 5,
        serving_module=texport.make_serving_module(model, params, moved),
        example_features={"x": x[:4]},
    )
    assert manifest["artifacts"]["torch_serving_fn"] == "serving_fn.pt2"
    assert manifest["artifacts"]["serving_fn"] is None
    assert manifest["format_version"] == 1
    assert manifest["torch_serving"] == {
        "features": {"x": {"dtype": "float32", "shape": [None, 5]}},
        "device": "cpu",
    }
    # the module the member was traced from is left as it was
    assert torch.equal(model.norm.running_mean, state["norm.running_mean"])
    x2 = rng.standard_normal((rows, 5)).astype(np.float32)
    got = texport.load_export(str(tmp_path)).serve({"x": x2}, "cpu")
    want, _ = apply_model(model, params, moved, {"x": x2})
    fresh, _ = apply_model(model, params, state, {"x": x2})
    assert got.shape == (rows, 3)
    assert torch.equal(got, want.detach())
    assert not torch.allclose(got, fresh.detach())


def test_an_untraceable_forward_leaves_a_params_only_artifact(tmp_path,
                                                              caplog):
    class Branchy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, x):
            if bool((x * self.w).sum() > 0):  # a branch on the data
                return x * self.w
            return -x

    model = Branchy()
    default_logger.addHandler(caplog.handler)
    caplog.set_level(logging.WARNING)
    try:
        manifest = texport.export_model(
            str(tmp_path), {"w": np.ones(4, np.float32)}, 1,
            serving_module=texport.make_serving_module(
                model, dict(model.named_parameters()), {}),
            example_features=np.ones((2, 4), np.float32),
        )
    finally:
        default_logger.removeHandler(caplog.handler)
    assert "serving-fn export skipped (params-only artifact)" in caplog.text
    assert manifest["artifacts"]["torch_serving_fn"] is None
    assert "torch_serving" not in manifest
    assert not os.path.exists(os.path.join(str(tmp_path), "serving_fn.pt2"))
    loaded = texport.load_export(str(tmp_path))
    assert not loaded.has_torch_serving_fn()
    with pytest.raises(RuntimeError, match="carries no serving member"):
        loaded.serve(np.ones((1, 4), np.float32), "cpu")


# -- the LM through the flash op ---------------------------------------------


@pytest.fixture(scope="module")
def lm_member(tmp_path_factory):
    """The small LM from the JAX package's init, exported by the port
    with the flash branch forced: (artifact, the rebuilt module, the
    JAX model and params)."""
    root = tmp_path_factory.mktemp("lm")
    jm = jlm.custom_model(**get_dict_from_params_str(LM_PARAMS))
    jparams = jinit(jm, jax.random.PRNGKey(0), {"tokens": _tokens(1)})[
        "params"]
    jexport.export_model(
        str(root / "jax"), jparams, 3,
        metadata=jexport.export_provenance(JAX_ZOO, LM_DEF, LM_PARAMS),
    )
    module = ScorerModel(str(root / "jax"), device="cpu").rebuild()
    forced = functools.partial(fa.pick_causal_attention, min_flash_len=64)
    mp = pytest.MonkeyPatch()
    mp.setattr(tlm, "pick_causal_attention", forced)
    try:
        texport.export_model(
            str(root / "port"),
            convert.to_named(module.state_dict(), 4, 16), 3,
            metadata=texport.export_provenance("", LM_DEF, LM_PARAMS),
            serving_module=texport.make_serving_module(
                module, dict(module.named_parameters()), {}),
            example_features={"tokens": _tokens(2)},
        )
        with torch.no_grad():
            want = {n: module({"tokens": _tokens(n, seed=n)})
                    for n in (1, 3)}
    finally:
        mp.undo()
    return str(root / "port"), want, jm, jparams


@pytest.mark.parametrize("rows", [1, 3])
def test_the_lm_member_holds_the_flash_op_and_matches_module_and_jax(
        rows, lm_member):
    path, want, jm, jparams = lm_member
    program = torch.export.load(os.path.join(path, "serving_fn.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("edl_tpu_torch.flash_fwd.default") == 2
    fa.launches.reset()
    tokens = _tokens(rows, seed=rows)
    got = texport.load_export(path).serve({"tokens": tokens}, "cpu")
    assert fa.launches.count == 0  # the CPU runs the plain version
    assert got.shape == (rows, LM_LEN, 128)
    assert torch.equal(got, want[rows])
    jout = np.asarray(jm.apply({"params": jparams}, {"tokens": tokens}))
    np.testing.assert_allclose(got.numpy(), jout, **LM_TOL)


def test_a_fresh_process_serves_the_member_without_the_zoo(lm_member,
                                                           tmp_path):
    path, want, _, _ = lm_member
    np.save(tmp_path / "tokens.npy", _tokens(3, seed=3))
    code = textwrap.dedent("""
        import json, os, sys
        import numpy as np
        import torch
        import elasticdl_tpu_torch.ops.flash_attention  # registers the op
        d = sys.argv[1]
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        program = torch.export.load(
            os.path.join(d, manifest["artifacts"]["torch_serving_fn"]))
        tokens = torch.from_numpy(np.load(sys.argv[2]))
        with torch.no_grad():
            out = program.module()({"tokens": tokens})
        np.save(sys.argv[3], out.numpy())
        zoo = [m for m in sys.modules if "model_zoo" in m]
        print("SERVED", tuple(out.shape), zoo)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code, path, str(tmp_path / "tokens.npy"),
         str(tmp_path / "out.npy")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVED (3, 64, 128) []" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  want[3].numpy())


# -- BatchNorm against the JAX package ---------------------------------------


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """ResNet-50 (10 classes) on 32x32 images: the JAX package's artifact
    with its serving function over perturbed statistics, and the port's
    artifact with its member from the same weights and statistics."""
    root = tmp_path_factory.mktemp("resnet")
    images = _images((2, 32, 32, 3), seed=3)
    jm = jmodel.ResNet50(num_classes=10)
    variables = jax.tree_util.tree_map(np.asarray, dict(_perturbed(
        jinit(jm, jax.random.PRNGKey(0), images[:1]), seed=4)))
    jexport.export_model(
        str(root / "jax"), variables["params"], 2,
        metadata=jexport.export_provenance(JAX_ZOO, RESNET,
                                           "num_classes=10"),
        serving_fn=jexport.make_serving_fn(
            jm, {"batch_stats": variables["batch_stats"]}),
        example_features={"image": images},
    )
    named = pytree_to_named_arrays(variables["params"])
    stats = pytree_to_named_arrays(
        {"batch_stats": variables["batch_stats"]})
    module = tmodel.ResNet50(num_classes=10)
    texport.export_model(
        str(root / "port"), named, 2,
        metadata=texport.export_provenance("", RESNET, "num_classes=10"),
        serving_module=texport.make_serving_module(
            module, convert.to_state_dict(named),
            convert.to_state_dict(stats)),
        example_features={"image": images},
    )
    return str(root / "jax"), str(root / "port")


def test_the_jax_batchnorm_member_and_the_ports_agree(resnet):
    jpath, tpath = resnet
    x2 = _images((3, 32, 32, 3), seed=9)
    jloaded = jexport.load_export(jpath)
    assert jloaded.has_serving_fn()
    want = np.asarray(jloaded.serve({"image": x2}))
    got = texport.load_export(tpath).serve({"image": x2}, "cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


def test_the_port_scorer_refuses_a_jax_batchnorm_artifact_by_name(resnet):
    jpath, tpath = resnet
    model = ScorerModel(jpath, device="cpu")
    assert not model.serves_member
    with pytest.raises(NotImplementedError,
                       match="running statistics live only in its "
                             "serving_fn.jaxexport member"):
        model.prepare()
    # the port's own artifact of the same model serves through its member
    served = ScorerModel(tpath, device="cpu")
    assert served.serves_member
    out = served.predict({"image": _images((1, 32, 32, 3), seed=5)})
    assert out.shape == (1, 10)


# -- crossing between the packages -------------------------------------------


def _mnist_images(rows, seed=0):
    return np.random.default_rng(seed).random((rows, 28, 28),
                                              dtype=np.float32)


def test_the_reference_scores_a_port_artifact_with_a_member_by_rebuild(
        tmp_path):
    from elasticdl_tpu_torch.model_zoo.mnist_subclass import (
        mnist_subclass as tmnist,
    )

    torch.manual_seed(2)
    module = tmnist.CustomModel()
    params = dict(module.named_parameters())
    texport.export_model(
        str(tmp_path), convert.to_named(params), 4,
        metadata=texport.export_provenance("", MNIST, ""),
        serving_module=texport.make_serving_module(module, params, {}),
        example_features={"image": _mnist_images(2)},
    )
    assert _manifest(str(tmp_path))["artifacts"]["torch_serving_fn"]
    reference = JaxScorerModel(str(tmp_path), model_zoo=JAX_ZOO)
    assert not reference.exported.has_serving_fn()
    x = {"image": _mnist_images(3, seed=1)}
    want = texport.load_export(str(tmp_path)).serve(x, "cpu")
    got = np.asarray(reference.predict(x))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=F32_ATOL)


def test_the_port_scorer_serves_a_jax_mnist_artifact_by_rebuild(tmp_path):
    jm = jmnist.CustomModel()
    params = jinit(jm, jax.random.PRNGKey(1),
                   {"image": _mnist_images(1)})["params"]
    jexport.export_model(
        str(tmp_path), params, 6,
        metadata=jexport.export_provenance(JAX_ZOO, MNIST, ""),
        serving_fn=jexport.make_serving_fn(jm, {}),
        example_features={"image": _mnist_images(2)},
    )
    jloaded = jexport.load_export(str(tmp_path))
    assert jloaded.has_serving_fn()
    model = ScorerModel(str(tmp_path), device="cpu")
    assert not model.serves_member
    x = {"image": _mnist_images(5, seed=2)}
    got = model.predict(x)
    want = np.asarray(jloaded.serve(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


# -- the export sites --------------------------------------------------------


def _mnist_records(directory, n=96):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            w.write(encode_example({
                "image": rng.random(784, dtype=np.float32) * 255,
                "label": np.array([rng.integers(0, 10)], np.int64),
            }))
    return directory


def _frappe(directory, n=64, vocab=300):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            w.write(encode_example({
                "feature": rng.integers(1, vocab, 10).astype(np.int64),
                "label": np.array([rng.integers(0, 2)], np.int64),
            }))
    return directory


def _train(tmp_path, model_def, data, *extra, params=""):
    out = str(tmp_path / "out")
    assert cli.main([
        "train", "--job_name", "j", "--model_zoo", "", "--model_def",
        model_def, "--model_params", params, "--training_data", data,
        "--minibatch_size", "16", "--num_epochs", "1", "--output", out,
        "--device", "cpu", *extra]) == 0
    (artifact,) = glob.glob(os.path.join(out, "*", "MANIFEST.json"))
    return os.path.dirname(artifact)


def _served_through_the_member(artifact):
    """The port's scorer serves the artifact through its member, equal to
    the model rebuilt from its model.chkpt."""
    model = ScorerModel(artifact, device="cpu")
    assert model.serves_member
    x = {"image": _mnist_images(3, seed=4)}
    got = model.predict(x)
    with torch.no_grad():
        want = model.rebuild()(x)
    assert got.shape == (3, 10)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_the_allreduce_jobs_artifact_carries_the_member(tmp_path):
    artifact = _train(tmp_path, MNIST, _mnist_records(str(tmp_path / "d")),
                      "--distribution_strategy", "AllreduceStrategy")
    manifest = _manifest(artifact)
    assert manifest["artifacts"]["torch_serving_fn"] == "serving_fn.pt2"
    assert manifest["torch_serving"]["features"] == {
        "image": {"dtype": "float32", "shape": [None, 28, 28]}}
    _served_through_the_member(artifact)


@pytest.fixture(scope="module")
def ps_job(tmp_path_factory):
    """The held-model MNIST job with a SAVE_MODEL export and streaming
    exports every 2 versions."""
    tmp = tmp_path_factory.mktemp("ps-job")
    stream = str(tmp / "stream")
    artifact = _train(tmp, MNIST, _mnist_records(str(tmp / "d")),
                      "--export_dir", stream, "--export_every_versions", "2")
    return artifact, stream


def test_the_ps_jobs_artifact_carries_the_member(ps_job):
    artifact, _ = ps_job
    assert _manifest(artifact)["artifacts"]["torch_serving_fn"]
    _served_through_the_member(artifact)


def test_a_streaming_export_carries_no_member(ps_job):
    _, stream = ps_job
    manifests = glob.glob(os.path.join(stream, "v*", "MANIFEST.json"))
    assert manifests
    for path in manifests:
        assert _manifest(os.path.dirname(path))["artifacts"][
            "torch_serving_fn"] is None


@pytest.mark.parametrize("strategy,member", [
    ("AllreduceStrategy", True), ("ParameterServerStrategy", False)],
    ids=["hbm_plane", "ps_plane"])
def test_deepfm_edl_ships_a_member_only_where_its_rows_are_in_the_graph(
        strategy, member, tmp_path):
    artifact = _train(
        tmp_path, DEEPFM_EDL, _frappe(str(tmp_path / "d")),
        "--distribution_strategy", strategy,
        params="embedding_dim=8,fc_unit=8",
    )
    manifest = _manifest(artifact)
    assert bool(manifest["artifacts"]["torch_serving_fn"]) is member
    if member:
        ids = np.random.default_rng(3).integers(1, 300, (2, 10))
        out = ScorerModel(artifact, device="cpu").predict({"feature": ids})
        assert bool(torch.isfinite(out["logits"]
                                   if isinstance(out, dict) else out).all())
