"""The port's data modules and the zoo's data contract against the JAX
package's: RecordIO files and examples cross both ways byte for byte, a
seeded Dataset pipeline yields the same batches, and the transformer
zoo's ``dataset_fn``, ``loss`` and ``eval_metrics_fn`` agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.constants import MetricsDictKey as JKey
from elasticdl_tpu.common.constants import Mode as JMode
from elasticdl_tpu.data import dataset as jdataset
from elasticdl_tpu.data import example as jexample
from elasticdl_tpu.data import recordio as jrecordio
from elasticdl_tpu_torch.common import model_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data import dataset as tdataset
from elasticdl_tpu_torch.data import example as texample
from elasticdl_tpu_torch.data import recordio as trecordio
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    transformer_lm as tzoo,
)
from model_zoo.transformer_lm import transformer_lm as jzoo


def _examples(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "tokens": rng.integers(0, 1000, 64).astype(np.int64),
            "x": rng.standard_normal(3).astype(np.float32),
        }
        for _ in range(n)
    ]


def _write(module, path, payloads):
    with module.RecordIOWriter(str(path)) as w:
        for p in payloads:
            w.write(p)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recordio_crosses_both_ways(tmp_path, writer):
    payloads = [jexample.encode_example(e) for e in _examples()]
    w, r = (jrecordio, trecordio) if writer == "jax" else (
        trecordio, jrecordio
    )
    path = tmp_path / "a.edlr"
    _write(w, path, payloads)
    other = tmp_path / "b.edlr"
    _write(r, other, payloads)
    assert path.read_bytes() == other.read_bytes()
    with r.RecordIOReader(str(path)) as reader:
        assert len(reader) == len(payloads)
        assert [bytes(p) for p in reader] == [bytes(p) for p in payloads]
        assert [bytes(p) for p in reader.read_range(3, 7)] == [
            bytes(p) for p in payloads[3:7]
        ]
        assert bytes(reader.read(5, validate=True)) == bytes(payloads[5])


def test_truncated_recordio_is_refused_by_both(tmp_path):
    path = tmp_path / "t.edlr"
    with pytest.raises(RuntimeError):
        with trecordio.RecordIOWriter(str(path)) as w:
            w.write(b"abc")
            raise RuntimeError("boom")
    for module in (jrecordio, trecordio):
        with pytest.raises(ValueError):
            module.RecordIOReader(str(path))


def test_examples_encode_and_parse_alike():
    spec_j = {
        "tokens": jexample.FixedLenFeature([8, 8], np.int32),
        "x": jexample.FixedLenFeature([3], np.float64),
        "missing": jexample.FixedLenFeature([2], np.int64, default_value=7),
    }
    spec_t = {
        name: texample.FixedLenFeature(s.shape, s.dtype, s.default_value)
        for name, s in spec_j.items()
    }
    for e in _examples(4):
        data = jexample.encode_example(e)
        assert bytes(texample.encode_example(e)) == bytes(data)
        got = texample.parse_example(data, spec_t)
        want = jexample.parse_example(data, spec_j)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(KeyError):
        texample.parse_example(
            data, {"nope": texample.FixedLenFeature([1], np.int64)}
        )


def _pipeline(module, elements, **shuffle):
    ds = module.Dataset.from_tensors(elements)
    return (
        ds.map(lambda e: (e["tokens"][:4], e["x"]), num_parallel_calls=3)
        .filter(lambda e: e[0][0] % 7 != 0)
        .shuffle(8, **shuffle)
        .batch(3)
        .take(5)
        .prefetch(2)
    )


@pytest.mark.parametrize("reshuffle", [True, False])
def test_seeded_dataset_yields_the_reference_batches(reshuffle):
    elements = _examples(40)
    kwargs = dict(seed=11, reshuffle_each_iteration=reshuffle)
    j = _pipeline(jdataset, elements, **kwargs).repeat(2)
    t = _pipeline(tdataset, elements, **kwargs).repeat(2)
    got, want = list(t), list(j)
    assert len(got) == len(want) == 10
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)


def test_batch_assembly_paths_agree():
    elements = [(e["tokens"], {"x": e["x"], "s": b"ab"}) for e in _examples(7)]
    for vectorized in (True, False):
        got = list(tdataset.Dataset.from_tensors(elements).batch(
            3, drop_remainder=False, vectorized=vectorized
        ))
        want = list(jdataset.Dataset.from_tensors(elements).batch(3))
        assert [len(b[0]) for b in got] == [3, 3, 1]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1]["x"], w[1]["x"])
            np.testing.assert_array_equal(g[1]["s"], w[1]["s"])


def test_map_error_surfaces_in_order_and_prefetch_propagates():
    def fn(x):
        if x == 3:
            raise ValueError("bad element")
        return x

    for parallel in (None, 4):
        seen = []
        ds = tdataset.Dataset.from_tensors(range(6)).map(
            fn, num_parallel_calls=parallel
        ).prefetch(1)
        with pytest.raises(ValueError, match="bad element"):
            for x in ds:
                seen.append(x)
        assert seen == [0, 1, 2]


def test_create_dataset_from_tasks_reads_each_task_in_order():
    class Reader:
        def read_records(self, task):
            yield from range(task[0], task[1])

    tasks = [(0, 2), (5, 7)]
    assert list(tdataset.create_dataset_from_tasks(tasks, Reader())) == list(
        jdataset.create_dataset_from_tasks(tasks, Reader())
    ) == [0, 1, 5, 6]


def _token_file(tmp_path, n=10):
    rng = np.random.default_rng(3)
    path = tmp_path / "tokens.edlr"
    _write(
        jrecordio,
        path,
        [
            jexample.encode_example(
                {"tokens": rng.integers(0, 128, 64).astype(np.int64)}
            )
            for _ in range(n)
        ],
    )
    return path


def _records(path):
    reader = jrecordio.RecordIOReader(str(path))
    return [bytes(p) for p in reader]


@pytest.mark.parametrize(
    "mode", [Mode.TRAINING, Mode.EVALUATION, Mode.PREDICTION]
)
def test_dataset_fn_reads_a_jax_written_token_file(tmp_path, mode):
    records = _records(_token_file(tmp_path))
    got = list(
        tzoo.dataset_fn(tdataset.Dataset.from_tensors(records), mode, None)
    )
    want = list(
        jzoo.dataset_fn(jdataset.Dataset.from_tensors(records), mode, None)
    )
    assert len(got) == len(want) == len(records)

    def key(e):
        features = e if mode == Mode.PREDICTION else e[0]
        return features["tokens"].tobytes()

    if mode == Mode.TRAINING:  # both shuffle with OS entropy
        got, want = sorted(got, key=key), sorted(want, key=key)
    for g, w in zip(got, want):
        if mode == Mode.PREDICTION:
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            if isinstance(b, dict):
                a, b = a["tokens"], b["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_constants_match_the_reference():
    from elasticdl_tpu_torch.common.constants import MetricsDictKey

    for name in ("TRAINING", "EVALUATION", "PREDICTION"):
        assert getattr(Mode, name) == getattr(JMode, name)
    for name in ("MODEL_OUTPUT", "LABEL"):
        assert getattr(MetricsDictKey, name) == getattr(JKey, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_metrics_agree(dtype):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 16)).astype(np.int32)
    j_out = jnp.asarray(logits).astype(getattr(jnp, dtype))
    t_out = torch.from_numpy(logits).to(getattr(torch, dtype))
    j_loss = jzoo.loss(j_out, labels)
    t_loss = tzoo.loss(t_out, labels)
    assert str(t_loss.dtype) == "torch." + str(j_loss.dtype)
    tol = 2e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(
        float(t_loss), float(j_loss), rtol=tol, atol=tol
    )
    j_acc = jzoo.eval_metrics_fn()["token_accuracy"](labels, j_out)
    t_acc = tzoo.eval_metrics_fn()["token_accuracy"](labels, t_out)
    if dtype == "float32":  # bf16 rounding may tie different argmaxes
        np.testing.assert_array_equal(t_acc, j_acc)
    assert t_acc.shape == j_acc.shape == (2 * 15,)


def test_model_spec_resolves_the_training_contract():
    spec = model_utils.get_model_spec(
        "", "transformer_lm.transformer_lm.custom_model", "num_layers=1"
    )
    assert len(spec.model.blocks) == 1
    assert spec.loss is tzoo.loss and spec.dataset_fn is tzoo.dataset_fn
    assert spec.eval_metrics_fn is tzoo.eval_metrics_fn
    assert spec.prediction_outputs_processor is None
    opt = spec.optimizer()(list(spec.model.parameters()))
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["eps"]) == (
        3e-3, 1e-4, 1e-8
    )
    with pytest.raises(ValueError, match="Missing required spec key"):
        model_utils.get_model_spec(
            "", "transformer_lm.transformer_lm.custom_model", loss="nope"
        )
