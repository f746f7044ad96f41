"""The port's in-graph (HBM) embedding plane on one device against the JAX
package's, with everything the port leaves out refusing by name.

- ``HbmEmbedding`` against the JAX layer with ``mesh=None`` (its
  ``jnp.take``) and on a one-device CPU mesh (its vocab-sharded ``psum``
  lookup over one shard): the lookup, with and without ``mask_zero``, and
  the table's gradient, a dense ``(vocab, features)`` tensor that is zero
  on the rows the ids do not touch; ids outside the table read as the
  reference's forms read them. float32, (rtol, atol) (1e-6, 1e-7): a
  gather is exact, the gradient a sum of a few products.
- ``resolve_table_planes`` on every spec form, and ``make_embedding``:
  the same planes and the same errors as the reference; the PS plane
  builds the elastic ``Embedding`` layer, and a PS-plane table on a mesh
  raises ``NotImplementedError``, naming the hybrid trainer on the
  parameter-server worker as such a table's home.
- deepfm_edl's ``build_distributed_model`` on a one-device mesh, placed by
  its ``param_shardings``, trained ten SGD steps through the port's
  ``AllReduceTrainer`` against the JAX model on a one-device mesh
  (tests/test_hbm_deepfm.py is the model) from one converted init, within
  that test's bound (rtol 2e-4, atol 2e-5).
- The worker hooks: ``AllReduceWorker`` builds the distributed model on
  the one-card mesh with whole specs; the elastic worker scores the host
  twin from ``--checkpoint_dir`` and refuses without it, and trains the
  hooked zoo on the collective plane, refusing a PS-plane table; a
  PS-plane table in the collective form, meshes of two devices in one
  process and the psum form inside the collective step raise by name;
  ``method="a2a"`` on a mesh of one device equals the reference's
  ``all_to_all_lookup``, overflow count included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn import comm_plane as jplane
from elasticdl_tpu.nn.hbm_embedding import HbmEmbedding as JHbm
from elasticdl_tpu.nn.model_api import init_variables as jinit
from elasticdl_tpu.nn.model_api import split_variables as jsplit
from elasticdl_tpu.parallel.mesh import create_mesh as jcreate_mesh
from elasticdl_tpu.training.step import TrainState as JTrainState
from elasticdl_tpu.training.step import make_train_step as jmake_step
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
    deepfm_edl_embedding as tzoo,
)
from elasticdl_tpu_torch.nn import comm_plane as tplane
from elasticdl_tpu_torch.nn.hbm_embedding import HbmEmbedding
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo

VOCAB, DIM = 96, 8
EDL = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
EDL_PARAMS = "vocab_size=96,embedding_dim=8,fc_unit=8"


def _ids(shape, seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB // 2, shape)
    ids[0, :3] = 0  # some padding ids for mask_zero
    # ids outside the table: NaN rows (negatives counted from the end)
    # without a mesh, zero rows on the mesh, as in the reference
    ids[1, :4] = [VOCAB, VOCAB + 7, -1, -VOCAB - 1]
    return ids.astype(np.int64)


def _cpu_mesh():
    return tmesh.create_mesh(devices=["cpu"])


@pytest.mark.parametrize("mask_zero", [False, True])
@pytest.mark.parametrize("form", ["mesh=None", "one-device mesh"])
def test_hbm_embedding_matches_jax(form, mask_zero):
    ids = _ids((4, 10))
    weight = np.random.default_rng(1).standard_normal(
        (4, 10, DIM)).astype(np.float32)
    jmesh = (jcreate_mesh({"data": 1}, devices=jax.devices()[:1])
             if form != "mesh=None" else None)
    jlayer = JHbm(VOCAB, DIM, mesh=jmesh, mask_zero=mask_zero)
    table = np.asarray(
        jlayer.init(jax.random.PRNGKey(0), ids)["params"]["table"])

    def jloss(t):
        emb = jlayer.apply({"params": {"table": t}}, ids)
        return (emb * weight).sum(), emb

    if jmesh is not None:
        with jmesh:
            (_, jemb), jgrad = jax.value_and_grad(jloss, has_aux=True)(
                jnp.asarray(table))
    else:
        (_, jemb), jgrad = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(table))

    layer = HbmEmbedding(VOCAB, DIM, mesh=(
        _cpu_mesh() if jmesh is not None else None), mask_zero=mask_zero)
    with torch.no_grad():
        layer.table.copy_(torch.from_numpy(np.array(table)))
    emb = layer(torch.from_numpy(ids))
    (emb * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jemb),
                               rtol=1e-6, atol=1e-7)
    grad = layer.table.grad
    assert grad.layout == torch.strided and tuple(grad.shape) == (VOCAB, DIM)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)
    untouched = np.setdiff1d(np.arange(VOCAB), np.where(
        ids < 0, ids + VOCAB, ids) if jmesh is None else ids)
    assert not grad[torch.from_numpy(untouched)].any()
    if mask_zero:
        assert not grad[0].any()


def test_hbm_init_is_the_reference_variance_scaling():
    """variance_scaling(1.0, "fan_in", "normal", out_axis=0): a plain
    normal of variance 1 / features, from an explicit generator."""
    layer = HbmEmbedding(4096, 16)
    layer.init_parameters(torch.Generator().manual_seed(0))
    t = layer.table.detach()
    assert abs(float(t.mean())) < 5e-3
    assert abs(float(t.std()) - 0.25) < 5e-3
    again = HbmEmbedding(4096, 16).init_parameters(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.table, layer.table)
    jt = np.asarray(JHbm(4096, 16).init(
        jax.random.PRNGKey(0), np.ones((1, 1), np.int64))["params"]["table"])
    assert abs(float(jt.std()) - 0.25) < 5e-3


SPECS = [
    "ps", "hbm", "hybrid", "embedding:hbm", "id_bias:hbm",
    "embedding:hbm/id_bias:ps", " embedding:hbm / id_bias:hbm / ",
    "embedding:gpu", "embedding", "user:hbm",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("split", [jzoo.HYBRID_SPLIT, None,
                                   {"embedding": "ps"}])
def test_resolve_table_planes_matches_the_reference(spec, split):
    def resolve(module):
        try:
            return module.resolve_table_planes(spec, jzoo.TABLES,
                                               hybrid_default=split)
        except ValueError as e:
            return ("ValueError", str(e))

    assert resolve(tplane) == resolve(jplane)
    assert tplane.PLANES == jplane.PLANES


def test_make_embedding_planes():
    from elasticdl_tpu_torch.nn.embedding import Embedding

    elastic = tplane.make_embedding("ps", output_dim=4, name="embedding",
                                    vocab_size=8, mask_zero=True,
                                    combiner="mean")
    ref = jplane.make_embedding("ps", output_dim=4, name="embedding",
                                vocab_size=8, mask_zero=True, combiner="mean")
    assert isinstance(elastic, Embedding) and not list(elastic.parameters())
    for field in ("output_dim", "embedding_initializer", "mask_zero",
                  "combiner"):
        assert getattr(elastic, field) == getattr(ref, field), field
    for kwargs in (dict(plane="nvme", output_dim=4, name="t",
                        vocab_size=8),
                   dict(plane="hbm", output_dim=4, name="t")):
        with pytest.raises(ValueError) as want:
            jplane.make_embedding(**kwargs)
        with pytest.raises(ValueError) as got:
            tplane.make_embedding(**kwargs)
        assert str(got.value) == str(want.value)
    layer = tplane.make_embedding("hbm", output_dim=4, name="t",
                                  vocab_size=8, mask_zero=True)
    assert isinstance(layer, HbmEmbedding)
    assert tuple(layer.table.shape) == (8, 4) and layer.mask_zero


def _batches(n_steps, batch=16, length=10, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        ids = rng.integers(0, VOCAB, size=(batch, length))
        labels = rng.integers(0, 2, size=(batch, 1)).astype(np.int64)
        out.append(({"feature": ids.astype(np.int64)}, labels))
    return out


def test_deepfm_edl_trains_ten_steps_as_jax_on_one_device():
    batches = _batches(10)
    jmesh = jcreate_mesh({"data": 1}, devices=jax.devices()[:1])
    jmodel = jzoo.build_distributed_model(jmesh, embedding_dim=8, fc_unit=8,
                                          vocab_size=VOCAB)
    params, state = jsplit(jinit(jmodel, jax.random.PRNGKey(0),
                                 batches[0][0]))
    named = {k: np.asarray(v)
             for k, v in pytree_to_named_arrays(params).items()}
    opt = optax.sgd(0.05)
    ts = JTrainState.create(params, state, opt)
    step = jmake_step(jmodel, jzoo.loss, opt)
    with jmesh:
        for features, labels in batches:
            ts, _ = step(ts, features, labels, jax.random.PRNGKey(0))
    want = pytree_to_named_arrays(jax.tree_util.tree_map(np.asarray,
                                                         ts.params))

    mesh = _cpu_mesh()
    model = tzoo.build_distributed_model(mesh, embedding_dim=8, fc_unit=8,
                                         vocab_size=VOCAB)
    trainer = AllReduceTrainer(
        model, tzoo.loss, tzoo.optimizer(0.05), mesh=mesh,
        param_specs=tzoo.param_shardings(mesh), device="cpu",
    )
    trainer.load_state(convert.to_train_state(
        named, tzoo.optimizer(0.05), device="cpu"))
    for features, labels in batches:
        trainer.train_step(features, labels)
    got = convert.to_named(trainer.train_state.params)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    table = trainer.train_state.params["embedding.table"]
    assert tuple(table.shape) == (VOCAB, 8)


def test_allreduce_worker_builds_the_distributed_model_on_one_card():
    from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker

    worker = AllReduceWorker(0, JobType.TRAINING_ONLY, 4, "", EDL,
                             model_params=EDL_PARAMS, device="cpu")
    model = worker.trainer._module
    assert isinstance(model, tzoo.DeepFMEdl)
    assert model.mesh.shape == {"data": 1}
    assert isinstance(model.embedding, HbmEmbedding)
    # the zoo's specs, which the trainer took, name the tables whole
    specs = tmesh.flatten_specs(tzoo.param_shardings(model.mesh))
    assert sorted(specs) == ["embedding.table", "id_bias.table"]
    assert all(tmesh.spec_is_whole(s, model.mesh) for s in specs.values())


def test_param_specs_must_name_parameters_and_be_whole():
    mesh = _cpu_mesh()
    model = tzoo.build_distributed_model(mesh, vocab_size=8, embedding_dim=4,
                                         fc_unit=4)

    def trainer(specs, **kwargs):
        return AllReduceTrainer(model, tzoo.loss, tzoo.optimizer(),
                                mesh=mesh, param_specs=specs,
                                device="cpu", **kwargs)

    with pytest.raises(ValueError, match="not a parameter"):
        trainer({"embedding": {"weight": tmesh.PartitionSpec("data")}})
    with pytest.raises(ValueError, match="lacks"):
        trainer({"embedding": {"table": tmesh.PartitionSpec("model")}})
    with pytest.raises(NotImplementedError, match="without a mesh"):
        AllReduceTrainer(model, tzoo.loss, tzoo.optimizer(),
                         param_specs=tzoo.param_shardings(mesh),
                         device="cpu")
    assert tmesh.spec_is_whole(tzoo.param_shardings(mesh)["embedding"][
        "table"], mesh)


def _two_rank_mesh():
    """A ``WorldMesh`` of two ranks, seen from rank 0, without a world:
    only its shape is read."""
    return tmesh.WorldMesh({"data": 2}, torch.device("cpu"), 0, {})


@pytest.mark.parametrize(
    "call,exc,match",
    [
        (lambda: tzoo.build_collective_model(embedding_plane="hybrid"),
         ValueError, "PS plane.*collective"),
        (lambda: tmesh.create_mesh({"data": 2}, devices=["cpu", "cpu"]),
         NotImplementedError, "mesh of 2 devices.*A9"),
        (lambda: tmesh.create_mesh(devices=["cpu", "cpu"]),
         NotImplementedError, "mesh of 2 devices.*A9"),
        (lambda: HbmEmbedding(8, 4, mesh=_two_rank_mesh()),
         NotImplementedError, "2 devices outside the collective.*A9.2.3"),
        (lambda: HbmEmbedding(8, 4, mesh=_cpu_mesh(), collective=True,
                              method="psum")(torch.ones(2, 3)),
         ValueError, "only supports a2a"),
        (lambda: tzoo.DeepFMEdl(mesh=_cpu_mesh(), embedding_plane="ps"),
         NotImplementedError, "PS plane.*hybrid mode"),
        (lambda: tzoo.build_distributed_model(_cpu_mesh(),
                                              embedding_plane="hybrid"),
         NotImplementedError, "PS plane.*hybrid mode"),
    ],
    ids=["build_collective_model", "mesh_shape_2", "devices_2",
         "collective_layer", "a2a", "custom_model_ps", "hybrid_ps"],
)
def test_unported_forms_raise_by_name(call, exc, match):
    """What the HBM plane still refuses: a PS-plane table in the
    collective form (the reference's ValueError), meshes of two devices
    in one process and the vocab-sharded lookups over them (ROADMAP
    A9.2.3), and the psum form inside the collective step (the
    reference's ValueError). ``build_collective_model``, the collective
    layer and the a2a routing themselves are ported
    (tests/test_torch_elastic_collective.py)."""
    with pytest.raises(exc, match=match):
        call()


def test_the_a2a_lookup_on_a_one_device_mesh_equals_the_reference():
    """``method="a2a"`` on a mesh of one device: the routing body over
    an axis of one rank, its rows and overflow count as the reference's
    ``all_to_all_lookup`` gives them (a capacity of 5 drops ids)."""
    from elasticdl_tpu.nn.hbm_embedding import all_to_all_lookup

    ids = _ids((3, 4), seed=4)
    table = np.random.default_rng(5).standard_normal(
        (VOCAB, DIM)).astype(np.float32)
    for capacity in (None, 5):
        layer = HbmEmbedding(VOCAB, DIM, mesh=_cpu_mesh(), method="a2a")
        layer.capacity = capacity
        with torch.no_grad():
            layer.table.copy_(torch.from_numpy(table))
        got = layer.train()(torch.from_numpy(ids)).detach().numpy()
        want, n_over = all_to_all_lookup(
            jnp.asarray(table), jnp.asarray(ids), jcreate_mesh(
                {"data": 1}, devices=jax.devices()[:1]), "data",
            capacity=capacity, return_overflow=True, dedup=True)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert layer.a2a_overflow == int(n_over)
    assert layer.a2a_overflow > 0


def test_the_host_twin_of_a_ps_table_refuses_as_the_reference():
    with pytest.raises(ValueError, match="PS plane"):
        tzoo.build_host_model(embedding_plane="hybrid")
    with pytest.raises(ValueError, match="PS plane"):
        jzoo.DeepFMEdl(force_hbm=True, embedding_plane="hybrid").init(
            jax.random.PRNGKey(0), {"feature": np.ones((1, 10), np.int64)})


def test_allreduce_worker_refuses_mesh_axes_by_name(tmp_path):
    """A zoo's ``mesh_axes`` gives the worker's mesh, as in the
    reference: ``{'data': n}`` on the one device is a mesh of one, and
    the HBM tables train on it; a layout one device cannot hold is
    refused by the zoo's own ValueError (the LM's tensor_parallel=2)."""
    from elasticdl_tpu_torch.parallel.mesh import Mesh
    from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker

    zoo = tmp_path / "zoo" / "meshed"
    zoo.mkdir(parents=True)
    (zoo / "meshed.py").write_text(
        "from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding."
        "deepfm_edl_embedding import *  # noqa\n\n\n"
        "def mesh_axes(n, **_params):\n    return {'data': n}\n"
    )
    worker = AllReduceWorker(0, JobType.TRAINING_ONLY, 4,
                             str(tmp_path / "zoo"),
                             "meshed.meshed.custom_model",
                             model_params=EDL_PARAMS, device="cpu")
    assert isinstance(worker._model.embedding.mesh, Mesh)
    ids = np.random.default_rng(0).integers(0, 32, (4, 10))
    labels = np.array([[0], [1], [1], [0]])
    losses = [float(worker.trainer.train_step({"feature": ids}, labels))
              for _ in range(2)]
    assert all(np.isfinite(losses)) and worker.trainer.version == 2
    with pytest.raises(ValueError,
                       match="1 devices do not divide into tensor_parallel=2"):
        AllReduceWorker(0, JobType.TRAINING_ONLY, 4, "",
                        "transformer_lm.transformer_lm.custom_model",
                        model_params="tensor_parallel=2", device="cpu")


@pytest.mark.parametrize(
    "job_type", [JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION])
def test_elastic_worker_refuses_to_train_the_hooked_zoo(job_type):
    """The hooked zoo trains on the collective plane (its tables split
    over ``data``, the host twin the export's model); what the worker
    still refuses is a table on the PS plane, by the reference's
    message."""
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    worker = ElasticAllReduceWorker(0, job_type, 4, "", EDL,
                                    model_params=EDL_PARAMS, device="cpu")
    assert worker.trainer.is_sharded
    assert worker._host_model_factory().force_hbm
    with pytest.raises(NotImplementedError, match="PS plane.*hybrid"):
        ElasticAllReduceWorker(0, job_type, 4, "", EDL,
                               model_params=EDL_PARAMS
                               + ",embedding_plane=hybrid", device="cpu")


@pytest.mark.parametrize(
    "job_type", [JobType.EVALUATION_ONLY, JobType.PREDICTION_ONLY])
def test_elastic_worker_scores_the_host_twin_from_checkpoints(job_type):
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    worker = ElasticAllReduceWorker(0, job_type, 4, "", EDL,
                                    model_params=EDL_PARAMS,
                                    checkpoint_dir="c", device="cpu")
    assert worker._model.force_hbm and worker.trainer is None
    assert tuple(worker._model.embedding.table.shape) == (VOCAB, 8)
    with pytest.raises(ValueError, match="needs --checkpoint_dir"):
        ElasticAllReduceWorker(0, job_type, 4, "", EDL,
                               model_params=EDL_PARAMS,
                               checkpoint_filename_for_init="model.chkpt",
                               device="cpu")
