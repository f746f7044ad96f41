"""The port's master-held model against ``elasticdl_tpu.master.servicer.
MasterServicer``, fed the same numpy-seeded reports: sync averaging over
``grads_to_wait``, async applies with staleness modulation, the stale
rejection and the checks on bad gradients, ``get_model`` FIXED from a
checkpoint, and checkpoints that cross between the packages with their
``edl_embedding:`` tables."""

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.model_utils import (
    load_from_checkpoint_file as jload,
)
from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.master.checkpoint_service import (
    CheckpointService as JCheckpointService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JTaskDispatcher,
)
from elasticdl_tpu.ps.optimizer_wrapper import OptimizerWrapper as JWrapper
from elasticdl_tpu.ps.parameters import EmbeddingTableInfo as JInfo
from elasticdl_tpu_torch.common.constants import GetModelMethod
from elasticdl_tpu_torch.common.model_utils import load_from_checkpoint_file
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.master.checkpoint_service import CheckpointService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo

MODEL = {"w": (4, 3), "b": (3,), "table": (6, 3)}


def _model(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in MODEL.items()}


def _pair(tmp_path=None, momentum=0.0, **kwargs):
    """(port servicer, reference servicer), same optimizer and model."""
    ckpts = {}
    if tmp_path is not None:
        ckpts = dict(
            port=CheckpointService(str(tmp_path / "t"), 1, 0, False),
            ref=JCheckpointService(str(tmp_path / "j"), 1, 0, False),
        )
    port = MasterServicer(
        kwargs.pop("grads_to_wait", 1), 8,
        lambda p: torch.optim.SGD(p, lr=0.1, momentum=momentum),
        TaskDispatcher({"s": (0, 8)}, {}, {}, 8, 1),
        checkpoint_service=ckpts.get("port"), device="cpu", **kwargs,
    )
    kwargs.pop("device", None)
    ref = JServicer(
        port._grad_to_wait, 8, optax.sgd(0.1, momentum=momentum or None),
        JTaskDispatcher({"s": (0, 8)}, {}, {}, 8, 1),
        checkpoint_service=ckpts.get("ref"), **kwargs,
    )
    model = _model(np.random.default_rng(0))
    port.report_variable(model)
    ref.report_variable(model)
    # first write wins
    port.report_variable({k: np.zeros(s, np.float32) for k, s in MODEL.items()})
    for s, info in ((port, EmbeddingTableInfo), (ref, JInfo)):
        s.push_embedding_info([info("emb", 3, "uniform"),
                               info("bias", 1, "zeros")])
    return port, ref


def _report(rng):
    """One worker's report: dense grads, an indexed slice of the dense
    ``table`` (duplicate rows), and row gradients of two elastic tables."""
    ids = rng.integers(0, 50, 7)
    return {
        "w": (rng.normal(size=(4, 3)).astype(np.float32), None),
        "b": (rng.normal(size=(3,)).astype(np.float32), None),
        "table": (rng.normal(size=(3, 3)).astype(np.float32), [1, 4, 1]),
        "emb": (rng.normal(size=(7, 3)).astype(np.float32), ids),
        "bias": (rng.normal(size=(2, 1)).astype(np.float32), ids[:2]),
    }


def _send(servicer, cls, report, version):
    return servicer.report_gradient(
        [cls(k, v, i) for k, (v, i) in report.items()], version
    )


def _assert_same(port, ref, ids, atol=1e-6):
    pv, pm = port.get_model(port.get_model_version())
    rv, rm = ref.get_model(ref.get_model_version())
    assert pv == rv and sorted(pm) == sorted(rm)
    for k in pm:
        np.testing.assert_allclose(pm[k], rm[k], atol=atol, rtol=0)
    for table in ("emb", "bias"):
        np.testing.assert_allclose(
            port.pull_embedding_vectors(table, ids),
            ref.pull_embedding_vectors(table, ids), atol=atol, rtol=0,
        )


def test_sync_averages_grads_to_wait_reports():
    port, ref = _pair(grads_to_wait=2, momentum=0.9)
    rng = np.random.default_rng(1)
    seen = []
    for version in (0, 0, 1, 1, 2, 2):
        report = _report(rng)
        seen.extend(report["emb"][1])
        got = _send(port, Tensor, report, version)
        want = _send(ref, JTensor, report, version)
        assert got == want
    assert port.get_model_version() == 3
    # a stale report is rejected, one from the future raises
    report = _report(rng)
    assert _send(port, Tensor, report, 1) == (False, 3)
    assert _send(ref, JTensor, report, 1) == (False, 3)
    with pytest.raises(ValueError, match="not available yet"):
        _send(port, Tensor, report, 9)
    _assert_same(port, ref, np.unique(seen))


def test_async_applies_at_once_with_staleness_modulation():
    """The reference modulates the dense update correctly, but its sparse
    apply runs a jitted optax step that bakes the multiplier in when it
    is traced, so later applies keep a stale one. The expected rows are
    the reference's wrapper stepping at ``lr * multiplier`` per apply:
    the semantics the port implements for both."""
    port, ref = _pair(momentum=0.9, use_async=True,
                      lr_staleness_modulation=True)

    def modulated_rows(grads):
        multiplier = ref._lr_modulation.get_multiplier()
        JWrapper(optax.sgd(0.1 * multiplier, momentum=0.9),
                 ref._embedding_store).apply_gradients(embedding_grads=grads)

    ref._embedding_gradient_applier = modulated_rows
    rng = np.random.default_rng(2)
    seen = []
    # request versions 0, 0, 0, 1, 4: staleness 1, 1, 2, 2, 1
    for version in (0, 0, 0, 1, 4):
        report = _report(rng)
        seen.extend(report["emb"][1])
        assert _send(port, Tensor, report, version) == _send(
            ref, JTensor, report, version)
    assert port.get_model_version() == 5
    assert port._lr_modulation.get_multiplier() == 1.0
    _assert_same(port, ref, np.unique(seen))


@pytest.mark.parametrize(
    "tensor",
    [
        ("nope", np.ones((2, 3), np.float32), None),
        ("w", np.ones((4, 4), np.float32), None),
        ("table", np.ones((2, 2), np.float32), [0, 1]),
        ("table", np.ones((2, 3), np.float32), [0, 6]),
        ("unregistered", np.ones((2, 3), np.float32), [0, 6]),
        ("emb", np.ones((2, 5), np.float32), [0, 6]),
        ("emb", np.ones((2, 3), np.float32), None),
    ],
    ids=["unknown", "dense_shape", "slice_width", "slice_range",
         "unregistered_table", "row_width", "dense_to_table"],
)
def test_bad_gradients_raise_as_the_reference(tensor):
    port, ref = _pair()
    name, values, indices = tensor
    with pytest.raises(ValueError) as want:
        ref.report_gradient([JTensor(name, values, indices)], 0)
    with pytest.raises(ValueError) as got:
        port.report_gradient([Tensor(name, values, indices)], 0)
    assert str(got.value) == str(want.value)
    assert port.get_model_version() == 0


def test_a_gradient_against_an_uninitialized_model_is_rejected():
    port = MasterServicer(1, 8, lambda p: torch.optim.SGD(p, lr=0.1),
                          TaskDispatcher({}, {}, {}, 8, 1), device="cpu")
    assert port.report_gradient(
        [Tensor("w", np.ones((4, 3), np.float32))], 0) == (False, 0)
    assert port.get_model(0) == (0, {})
    with pytest.raises(TypeError):
        port.report_gradient([np.ones(3)], 0)


def test_get_model_fixed_serves_the_checkpoint_without_tables(tmp_path):
    port, ref = _pair(tmp_path)
    rng = np.random.default_rng(3)
    for version in (0, 1):
        report = _report(rng)
        _send(port, Tensor, report, version)
        _send(ref, JTensor, report, version)
    for method in (GetModelMethod.FIXED, GetModelMethod.MINIMUM):
        pv, pm = port.get_model(1, method)
        rv, rm = ref.get_model(1, method)
        assert pv == rv and sorted(pm) == sorted(rm) == sorted(MODEL)
        for k in pm:
            np.testing.assert_allclose(pm[k], rm[k], atol=1e-6)
    # the checkpoint itself carries the tables
    _, named = load_from_checkpoint_file(
        port._checkpoint_service.get_checkpoint_path(1))
    assert {"edl_embedding:emb:ids", "edl_embedding:emb:rows",
            "edl_embedding:bias:ids"} <= set(named)
    with pytest.raises(ValueError, match="not available yet"):
        port.get_model(7, GetModelMethod.FIXED)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_checkpoints_cross_with_their_tables(tmp_path, direction):
    port, ref = _pair(tmp_path)
    rng = np.random.default_rng(4)
    report = _report(rng)
    _send(port, Tensor, report, 0)
    _send(ref, JTensor, report, 0)
    # the touched rows: a restored table mints new rows "uniform" in both
    # packages (a checkpoint does not carry the initializer)
    touched = {"emb": np.unique(report["emb"][1]),
               "bias": np.unique(report["bias"][1])}
    src = port if direction == "port_to_ref" else ref
    path = src._checkpoint_service.get_checkpoint_path(1)
    version, named = (jload if direction == "port_to_ref"
                      else load_from_checkpoint_file)(path)
    assert version == 1 and "edl_embedding:emb:rows" in named
    if direction == "port_to_ref":
        restored = JServicer(1, 8, optax.sgd(0.1),
                             JTaskDispatcher({}, {}, {}, 8, 1),
                             checkpoint_filename_for_init=path)
    else:
        restored = MasterServicer(1, 8, lambda p: torch.optim.SGD(p, lr=0.1),
                                  TaskDispatcher({}, {}, {}, 8, 1),
                                  checkpoint_filename_for_init=path,
                                  device="cpu")
    assert restored.get_model_version() == 1
    _, got = restored.get_model(1)
    _, want = src.get_model(1)
    for k in want:
        assert np.array_equal(got[k], want[k])
    for table, ids in touched.items():
        assert np.array_equal(restored.pull_embedding_vectors(table, ids),
                              src.pull_embedding_vectors(table, ids))
