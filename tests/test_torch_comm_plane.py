"""The port's plane interface, its overlapped row pull and the hybrid
trainer against the JAX package's (``tests/test_comm_plane.py`` case by
case).

- ``EmbeddingPullPipeline``: both packages' pipelines run each scenario
  and keep the same contract: ``consume`` returns the staged pull once,
  ``invalidate`` drops exactly once, the depth evicts the oldest, a failed
  pull surfaces at ``consume``, ``close`` stops the thread and a later
  ``submit`` raises.
- The planes: ``PsPlane`` pulls through the client's hot-row cache and
  pushes the sparse tensors alone, ``MasterStorePlane.push`` raises; a
  hybrid worker refuses evaluate- and predict-only jobs and a missing PS
  client, and warms its optimizer before the first task.
- Plane parity across the packages: one power-law batch and one set of
  weights (the JAX workers' init, carried with ``common/convert.py``, and
  the JAX store's rows seeded into the port's shards); the port's PS, HBM
  and hybrid arms against the JAX package's: logits, loss, dense
  gradients and row gradients within the PS-plane parity tolerance of
  ``tests/test_torch_ps_embedding.py`` (atol 1e-5, loss rtol 1e-5); PS
  against hybrid inside the port bitwise on the CPU, as the reference
  demands of its own arms.
- The hybrid job over two in-process shards: every task once, each
  shard's dense parameters the worker's first push, a requeued task's
  staged pull dropped exactly once, the SAVE_MODEL export carrying the
  worker's trained copy, the timeline's ``pipelined`` steps and its
  ``end`` counters, and a shard replaced by an empty one getting the
  model and infos again, from the worker thread, while the worker trains
  on.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.constants import JobType as JJobType
from elasticdl_tpu.common.tensor import pytree_to_named_arrays
from elasticdl_tpu.nn import comm_plane as jplane
from elasticdl_tpu.ps.parameters import Parameters as JParameters
from elasticdl_tpu.ps.servicer import PserverServicer as JServicer
from elasticdl_tpu.worker.ps_client import PSClient as JPSClient
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.common import convert
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.model_utils import load_from_checkpoint_file
from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
    deepfm_edl_embedding as tzoo,
)
from elasticdl_tpu_torch.nn import comm_plane as tplane
from elasticdl_tpu_torch.ps.parameters import Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.training.step import make_grad_fn
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_utils import MODEL_ZOO_PATH

VOCAB, DIM, BATCH = 96, 16, 64
MODEL_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
PACKAGES = [jplane, tplane]
PACKAGE_IDS = ["jax", "torch"]
ATOL = 1e-5


def _powerlaw_batch(seed=11):
    """The reference test's batch: ids drawn with weights 1 / rank^1.1
    from 24 of the vocabulary's ids, so a batch repeats many."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(VOCAB)[:24]
    weights = 1.0 / np.arange(1, 25) ** 1.1
    weights /= weights.sum()
    features = {
        "feature": rng.choice(pool, size=(BATCH, 10), p=weights).astype(
            np.int64
        )
    }
    labels = rng.integers(0, 2, size=(BATCH, 1)).astype(np.int32)
    return features, labels


def _params_str(plane, fc_unit=16):
    return "embedding_dim=%d,fc_unit=%d,vocab_size=%d,embedding_plane='%s'" % (
        DIM, fc_unit, VOCAB, plane)


def _shards(n=2, epoch=1):
    return [PserverServicer(Parameters(), 1, tzoo.optimizer(), "cpu",
                            use_async=True, shard_epoch=epoch)
            for _ in range(n)]


def _table_info(name, dim):
    from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo

    return EmbeddingTableInfo(name, dim, "uniform")


def _worker(client, zoo_plane, worker_plane, fc_unit=16, **kwargs):
    return Worker(
        worker_id=1, job_type=kwargs.pop("job_type", JobType.TRAINING_ONLY),
        minibatch_size=kwargs.pop("minibatch_size", BATCH), model_zoo="",
        model_def=MODEL_DEF, model_params=_params_str(zoo_plane, fc_unit),
        ps_client=client, embedding_plane=worker_plane, device="cpu",
        embedding_prefetch=kwargs.pop("embedding_prefetch", False), **kwargs,
    )


# ---------------------------------------------------------------------------
# the overlapped pull, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", PACKAGES, ids=PACKAGE_IDS)
def test_pipeline_consume_returns_staged_pull(plane):
    pipe = plane.EmbeddingPullPipeline()
    key = object()
    pipe.submit(key, "plan", lambda: {"t": np.ones(3)})
    got_plan, pulled = pipe.consume(key)
    assert got_plan == "plan" and np.array_equal(pulled["t"], np.ones(3))
    assert pipe.served == 1
    assert pipe.consume(key) is None  # one-shot
    pipe.close()


@pytest.mark.parametrize("plane", PACKAGES, ids=PACKAGE_IDS)
def test_pipeline_invalidate_drops_exactly_once(plane):
    """invalidate waits the pull in flight out, drops it once, and a
    second invalidate (or a consume after it) finds nothing."""
    pipe = plane.EmbeddingPullPipeline()
    release = threading.Event()
    pulled = []

    def slow_pull():
        release.wait(5.0)
        pulled.append(True)
        return {"t": np.zeros(1)}

    key = object()
    pipe.submit(key, "plan", slow_pull)
    dropper = {}
    t = threading.Thread(target=lambda: dropper.update(n=pipe.invalidate()))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # invalidate waits for the pull in flight
    release.set()
    t.join(5.0)
    assert dropper["n"] == 1 and pulled == [True]
    assert pipe.dropped == 1
    assert pipe.invalidate() == 0  # exactly once
    assert pipe.consume(key) is None
    pipe.close()


@pytest.mark.parametrize("plane", PACKAGES, ids=PACKAGE_IDS)
def test_pipeline_depth_evicts_oldest(plane):
    pipe = plane.EmbeddingPullPipeline(depth=2)
    keys = [object() for _ in range(3)]
    for i, key in enumerate(keys):
        pipe.submit(key, i, lambda i=i: i)
    assert pipe.consume(keys[0]) is None  # evicted, counted dropped
    assert pipe.consume(keys[1]) == (1, 1)
    assert pipe.consume(keys[2]) == (2, 2)
    assert pipe.dropped == 1 and pipe.served == 2
    pipe.close()


@pytest.mark.parametrize("plane", PACKAGES, ids=PACKAGE_IDS)
def test_pipeline_failed_pull_surfaces_at_consume(plane):
    pipe = plane.EmbeddingPullPipeline()
    key = object()

    def boom():
        raise RuntimeError("shard died")

    pipe.submit(key, "plan", boom)
    with pytest.raises(RuntimeError, match="shard died"):
        pipe.consume(key)
    assert pipe.served == 0
    # a failed pull that nobody consumes is swallowed by invalidate
    pipe.submit(key, "plan", boom)
    assert pipe.invalidate() == 1 and pipe.dropped == 1
    pipe.close()


@pytest.mark.parametrize("plane", PACKAGES, ids=PACKAGE_IDS)
def test_pipeline_close_stops_the_thread_and_refuses_submit(plane):
    pipe = plane.EmbeddingPullPipeline()
    pipe.submit(object(), "plan", lambda: 1)
    names = {t.name for t in threading.enumerate()}
    assert any(n.startswith("edl-emb-pull") for n in names)
    pipe.close()
    assert pipe.dropped == 1  # close invalidates what was staged
    assert not any(t.name.startswith("edl-emb-pull")
                   for t in threading.enumerate())
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(object(), "plan", lambda: 1)
    pipe.close()  # idempotent


def test_pipeline_times_the_background_pulls():
    pipe = tplane.EmbeddingPullPipeline()
    keys = [object(), object()]
    for key in keys:
        pipe.submit(key, None, lambda: time.sleep(0.02) or 0)
    pipe.consume(keys[0])
    first = pipe.last_pull_s
    pipe.consume(keys[1])
    assert first >= 0.02 and pipe.last_pull_s >= 0.02
    assert pipe.pull_s >= first + pipe.last_pull_s - 1e-9
    pipe.close()


# ---------------------------------------------------------------------------
# the plane objects
# ---------------------------------------------------------------------------


def test_ps_plane_shares_external_cache():
    shared = tplane.HotRowCache(64, window=2)
    shards = _shards()
    client = PSClient(shards, cache=shared)
    client.push_model({}, [_table_info("embedding", 4)])
    plane = tplane.PsPlane(client)
    rows = plane.pull({"embedding": np.array([1, 2, 3], np.int64)})
    assert rows["embedding"].shape == (3, 4)
    assert len(shared) == 3
    before = shared.hits
    again = plane.pull({"embedding": np.array([1, 2, 3], np.int64)})
    assert shared.hits == before + 3
    assert np.array_equal(again["embedding"], rows["embedding"])
    client.close()


@pytest.mark.parametrize("service_reinit", [True, False])
def test_ps_plane_pull_services_a_pending_repush_when_asked(service_reinit):
    """A shard that came back empty gets the worker's re-push before a
    pull that services it; the pipeline thread's pull leaves it pending
    (and fails on the empty shard), so the next call runs it."""
    shards = [_Remote(s) for s in _shards()]
    client = PSClient(shards)
    client.push_model({}, [_table_info("embedding", 4)])
    repushes = []

    def repush(which):
        repushes.append(which)
        client.push_model({}, [_table_info("embedding", 4)])

    client.set_on_shard_reset(repush)
    client._ps[1] = _Remote(_shards(1, epoch=2)[0])
    client._note_shard_failures({1})  # the probe sees the new, empty shard
    plane = tplane.PsPlane(client)
    ids = {"embedding": np.array([1, 2, 3], np.int64)}
    if service_reinit:
        assert plane.pull(ids)["embedding"].shape == (3, 4)
        assert repushes == [[1]]
    else:
        with pytest.raises(Exception, match="initialize embedding param"):
            plane.pull(ids, service_reinit=False)
        assert repushes == []
        assert plane.push([], 0)[0] and repushes == [[1]]
    client.close()


def test_ps_plane_push_sends_the_sparse_tensors_alone():
    from elasticdl_tpu_torch.common.tensor import Tensor

    shards = _shards()
    client = PSClient(shards)
    client.push_model({"w": np.ones(3, np.float32)},
                      [_table_info("embedding", 2)])
    plane = tplane.PsPlane(client)
    before = [s._parameters.get_non_embedding_param("w") for s in shards]
    before = [None if b is None else np.array(b) for b in before]
    ids = np.array([0, 1, 2, 3], np.int64)
    rows = client.pull_embedding_vectors("embedding", ids)
    grad = np.ones((4, 2), np.float32)
    assert plane.push([Tensor("embedding", grad, indices=ids)], 0) == (
        True, 1)
    assert plane.drain() == (True, -1)
    after = client.pull_embedding_vectors("embedding", ids)
    np.testing.assert_allclose(after, rows - 0.1 * grad, rtol=1e-6)
    for shard, b in zip(shards, before):
        got = shard._parameters.get_non_embedding_param("w")
        assert (b is None and got is None) or np.array_equal(
            np.array(got), b)
    client.close()


def test_master_store_plane_pulls_per_table_and_refuses_push():
    calls = {}

    class Stub:
        def pull_embedding_vectors(self, name, ids):
            calls[name] = calls.get(name, 0) + 1
            return np.ones((len(ids), 4), np.float32)

    plane = tplane.MasterStorePlane(lambda: Stub())
    out = plane.pull({"a": np.array([1, 2]), "b": np.array([3, 4, 5])})
    assert out["a"].shape == (2, 4) and out["b"].shape == (3, 4)
    assert calls == {"a": 1, "b": 1}
    assert plane.drain() == (True, -1)
    with pytest.raises(NotImplementedError, match="report_gradient"):
        plane.push([], 0)
    with pytest.raises(NotImplementedError):
        jplane.MasterStorePlane(lambda: Stub()).push([], 0)


@pytest.mark.parametrize(
    "job_type", [JobType.EVALUATION_ONLY, JobType.PREDICTION_ONLY])
def test_hybrid_worker_rejects_serving_only_jobs(job_type):
    """The local copy is made by training: a scoring-only hybrid worker
    would score the random init. Both packages refuse alike."""
    with pytest.raises(ValueError, match="training job"):
        _worker(PSClient(_shards()), "hybrid", "hybrid", job_type=job_type)
    with pytest.raises(ValueError, match="training job"):
        JWorker(worker_id=1, job_type=job_type, minibatch_size=4,
                model_zoo=MODEL_ZOO_PATH, model_def=MODEL_DEF,
                ps_client=JPSClient(_jservicers()),
                embedding_plane="hybrid")


@pytest.mark.parametrize(
    "plane,client,match",
    [("hybrid", False, "needs a ps_client"),
     ("allreduce", True, "must be 'ps' or 'hybrid'")],
    ids=["hybrid_without_fleet", "unknown_plane"],
)
def test_worker_refuses_what_the_reference_refuses(plane, client, match):
    with pytest.raises(ValueError, match=match):
        _worker(PSClient(_shards()) if client else None, "hybrid", plane)


def test_the_pipeline_is_built_as_the_reference_builds_it():
    """By default only under hybrid, and never without a PS client."""
    client = PSClient(_shards())
    assert _worker(client, "hybrid", "hybrid",
                   embedding_prefetch=None)._emb_pipeline is not None
    assert _worker(client, "ps", "ps",
                   embedding_prefetch=None)._emb_pipeline is None
    assert _worker(client, "ps", "ps",
                   embedding_prefetch=True)._emb_pipeline is not None
    assert _worker(None, "ps", "ps", stub=object(),
                   embedding_prefetch=True)._emb_pipeline is None
    client.close()


@pytest.mark.parametrize("n", [0, 1, 4], ids=["empty", "one", "four"])
def test_lookahead_pairs_match_the_reference(n):
    items = list(range(n))
    assert list(Worker._lookahead_pairs(items)) == list(
        JWorker._lookahead_pairs(items))


# ---------------------------------------------------------------------------
# plane parity across the packages
# ---------------------------------------------------------------------------


def _jservicers(n=2):
    return [JServicer(JParameters(), grads_to_wait=1,
                      optimizer=optax.sgd(0.1), use_async=True)
            for _ in range(n)]


def _jworker(servicers, zoo_plane, worker_plane):
    return JWorker(
        worker_id=1, job_type=JJobType.TRAINING_ONLY, minibatch_size=BATCH,
        model_zoo=MODEL_ZOO_PATH, model_def=MODEL_DEF,
        model_params=_params_str(zoo_plane),
        ps_client=JPSClient(servicers), embedding_plane=worker_plane,
        embedding_prefetch=False,
    )


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


@pytest.fixture(scope="module")
def arms():
    """Every arm's forward and one training step in both packages, from
    the JAX PS worker's dense init and the JAX store's rows."""
    from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jzoo
    from elasticdl_tpu.nn.model_api import init_variables, split_variables
    from elasticdl_tpu.training.step import make_grad_fn as jmake_grad_fn

    features, labels = _powerlaw_batch()
    all_ids = np.arange(VOCAB)
    out = {"jax": {}, "torch": {}}

    # the JAX package, as tests/test_comm_plane.py runs it
    jserv = _jservicers()
    wp, wh = _jworker(jserv, "ps", "ps"), _jworker(jserv, "hybrid", "hybrid")
    wp._run_model_call_before_training(features)
    wh._run_model_call_before_training(features)
    for key in ("Dense_0", "Dense_1"):
        wh._params[key] = wp._params[key]
    rows = {
        t: np.asarray(wp._ps_client.pull_embedding_vectors(t, all_ids),
                      np.float32)
        for t in ("embedding", "id_bias")
    }
    wh._params["id_bias"]["table"] = jnp.asarray(rows["id_bias"])
    twin = jzoo.DeepFMEdl(embedding_dim=DIM, fc_unit=16, vocab_size=VOCAB,
                          embedding_plane="hbm")
    t_params, t_state = split_variables(
        init_variables(twin, jax.random.PRNGKey(0), features))
    for key in ("Dense_0", "Dense_1"):
        t_params[key] = wp._params[key]
    for t in ("embedding", "id_bias"):
        t_params[t]["table"] = jnp.asarray(rows[t])
    dense = {k: np.asarray(v) for k, v in pytree_to_named_arrays(
        {k: wp._params[k] for k in ("Dense_0", "Dense_1")}).items()}

    for name, w in (("ps", wp), ("hybrid", wh)):
        logits = np.asarray(w.forward_process(features)["logits"])
        loss, grads, sparse = w.training_process(features, labels)
        out["jax"][name] = dict(
            logits=logits, loss=float(loss),
            grads={k: np.asarray(v)
                   for k, v in pytree_to_named_arrays(grads).items()},
            rows={t.name: (np.asarray(t.indices), np.asarray(t.values))
                  for t in sparse},
        )
        w._ps_client.close()
    rng = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    loss, grads, _, _ = jmake_grad_fn(twin, jzoo.loss)(
        t_params, t_state, features, labels, rng)
    out["jax"]["hbm"] = dict(
        logits=np.asarray(twin.apply({"params": t_params, **t_state},
                                     features)["logits"]),
        loss=float(loss),
        grads={k: np.asarray(v)
               for k, v in pytree_to_named_arrays(grads).items()},
        rows={},
    )

    # the port, from the same weights and rows
    shards = _shards()
    client = PSClient(shards)
    tp = _worker(client, "ps", "ps")
    th = _worker(client, "hybrid", "hybrid")
    tp._run_model_call_before_training(features)
    th._run_model_call_before_training(features)
    for shard, servicer in enumerate(shards):
        mine = all_ids[all_ids % 2 == shard]
        for t in ("embedding", "id_bias"):
            if t in servicer._parameters.embedding_params:
                servicer._parameters.set_embedding_param(
                    t, mine, rows[t][mine])
    state = convert.to_state_dict(dict(
        dense, **{"%s/table" % t: rows[t] for t in rows}))
    with torch.no_grad():
        for w in (tp, th):
            for k, p in w._params.items():
                p.copy_(state[k])
    hbm = tzoo.custom_model(embedding_dim=DIM, fc_unit=16,
                            vocab_size=VOCAB, embedding_plane="hbm")
    hbm_params = {k: state[k].clone() for k, _ in hbm.named_parameters()}
    for name, w in (("ps", tp), ("hybrid", th)):
        logits = _np(w.forward_process(features)["logits"])
        loss, grads, sparse = w.training_process(features, labels)
        out["torch"][name] = dict(
            logits=logits, loss=float(loss),
            grads={k: _np(v) for k, v in convert.to_named(grads).items()},
            rows={t.name: (np.asarray(t.indices), np.asarray(t.values))
                  for t in sparse},
        )
    loss, grads, _, output = make_grad_fn(hbm, tzoo.loss)(
        hbm_params, {}, features, labels, None)
    out["torch"]["hbm"] = dict(
        logits=_np(output["logits"]), loss=float(loss),
        grads={k: _np(v) for k, v in convert.to_named(grads).items()},
        rows={},
    )
    client.close()
    return out


@pytest.mark.parametrize("arm", ["ps", "hbm", "hybrid"])
def test_plane_parity_against_the_jax_package(arms, arm):
    got, want = arms["torch"][arm], arms["jax"][arm]
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   atol=ATOL, err_msg=k)
    # the PS arm pushes both tables' rows, hybrid only the PS-plane one,
    # the HBM arm none
    assert sorted(got["rows"]) == sorted(want["rows"]) == {
        "ps": ["embedding", "id_bias"], "hybrid": ["embedding"],
        "hbm": []}[arm]
    for t, (ids, values) in want["rows"].items():
        assert np.array_equal(got["rows"][t][0], ids), t
        np.testing.assert_allclose(got["rows"][t][1], values, atol=ATOL,
                                   err_msg=t)


def test_ps_and_hybrid_are_bitwise_in_the_port(arms):
    ps, hy = arms["torch"]["ps"], arms["torch"]["hybrid"]
    assert np.array_equal(ps["logits"], hy["logits"])
    assert ps["loss"] == hy["loss"]
    for k in ("Dense_0/kernel", "Dense_0/bias", "Dense_1/kernel",
              "Dense_1/bias"):
        assert np.array_equal(ps["grads"][k], hy["grads"][k]), k
    for i in (0, 1):
        assert np.array_equal(ps["rows"]["embedding"][i],
                              hy["rows"]["embedding"][i])
    # the hybrid arm's dense id_bias gradient is the PS arm's rows
    # scattered into a zero table
    ids, values = ps["rows"]["id_bias"]
    scattered = np.zeros((VOCAB, 1), np.float32)
    scattered[ids] = values
    assert np.array_equal(scattered, hy["grads"]["id_bias/table"])


# ---------------------------------------------------------------------------
# the hybrid job over two in-process shards
# ---------------------------------------------------------------------------


def _identity_shuffle(self, *args, **kwargs):
    return self


def _write_records(path, records, seed=5):
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(records):
            w.write(encode_example({
                "feature": rng.integers(0, VOCAB, size=(10,)).astype(
                    np.int64),
                "label": np.array([rng.integers(0, 2)], np.int64),
            }))


def _run_hybrid_job(tmp_path, fail_on_call=None, output=None, shards=None,
                    on_step=None, records=64, batch=16):
    """A small hybrid training job (two epochs) over in-process shards;
    optionally one failing minibatch (its task requeues)."""
    path = str(tmp_path / "hy.edlr")
    _write_records(path, records)
    shards = shards or _shards()
    task_d = TaskDispatcher({path: (0, records)}, {}, {}, batch, 2)
    if output:
        task_d.add_deferred_callback_create_save_model_task(output)
    master = MasterServicer(1, batch, None, task_d, coordinates_only=False,
                            device="cpu")
    client = PSClient(shards, push_inflight=1)
    worker = _worker(client, "hybrid", "hybrid", fc_unit=8,
                     minibatch_size=batch, stub=master,
                     embedding_prefetch=None)
    orig = worker._run_training_task
    calls = {"n": 0}

    def run_task(features, labels):
        calls["n"] += 1
        if calls["n"] == fail_on_call:
            raise RuntimeError("injected minibatch failure")
        result = orig(features, labels)
        if on_step is not None:
            on_step(calls["n"], worker)
        return result

    worker._run_training_task = run_task
    first_push = {}
    push_model = client.push_model

    def recording_push(named, infos=None, version=0):
        if not first_push:
            first_push.update({k: np.array(v) for k, v in named.items()})
        return push_model(named, infos, version)

    client.push_model = recording_push
    try:
        losses = worker.run()
    finally:
        client.close()
    return worker, task_d, shards, losses, first_push


def test_hybrid_job_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setattr(TDataset, "shuffle", _identity_shuffle)
    monkeypatch.setenv("EDL_WORKER_TIMELINE_DIR", str(tmp_path / "tl"))
    worker, task_d, shards, losses, first = _run_hybrid_job(tmp_path)
    assert task_d.finished() and len(losses) == 8  # 64 x 2 / 16
    assert np.all(np.isfinite(losses))
    assert worker._emb_pipeline.served > 0
    assert worker._emb_pipeline.dropped == 0
    assert worker.dense_tensors_pushed == 0
    # the model version advanced from the sparse pushes' replies
    assert worker._model_version >= 7
    # the shards still hold the worker's first push, bitwise: no dense
    # gradient reached them, and id_bias is a dense parameter there
    seen = {}
    for shard, s in enumerate(shards):
        params = s._parameters
        assert sorted(params.embedding_params) == ["embedding"]
        ids = params.embedding_params["embedding"].embedding_vectors
        assert ids and all(i % 2 == shard for i in ids)
        for name, value in params.non_embedding_params.items():
            seen[name] = np.array(value)
    assert sorted(seen) == sorted(first)
    for name in first:
        assert np.array_equal(seen[name], first[name]), name
    # while the worker's own copy moved away from it
    local = worker._to_wire(worker._params)
    assert not np.array_equal(local["id_bias/table"], first["id_bias/table"])
    # the timeline: each step says whether its rows were staged
    with open(tmp_path / "tl" / "worker-1.jsonl") as f:
        events = [json.loads(line) for line in f]
    steps = [e for e in events if e["event"] == "step"]
    assert len(steps) == 8
    pipelined = [e["pipelined"] for e in steps]
    assert sum(pipelined) == worker._emb_pipeline.served
    # each round's first batch pulls inline, every later one is staged
    # (the first round's second too: the variables are made before it)
    rounds = worker.rounds
    assert worker._emb_pipeline.served == 8 - rounds and not pipelined[0]
    for e in steps:
        assert "get_model" not in e["split"]
        assert {"compute", "report", "local_update"} <= set(e["split"])
        assert ("pull_bg" in e["split"]) == e["pipelined"]
    (end,) = [e for e in events if e["event"] == "end"]
    assert end["dense_tensors_pushed"] == 0
    assert end["pipeline"]["served"] == worker._emb_pipeline.served
    assert end["pipeline"]["dropped"] == 0
    assert end["pipeline"]["pull_s"] > 0


def test_hybrid_requeued_task_drops_prefetched_pull_once(tmp_path):
    """A failed minibatch requeues its task, and every pull staged at that
    moment (the failed batch's own and the lookahead batch's) is dropped
    exactly once. The job completes; the requeued records rerun with
    fresh inline pulls."""
    worker, task_d, _, _, _ = _run_hybrid_job(tmp_path, fail_on_call=3)
    assert task_d.finished()
    assert worker._emb_pipeline.dropped == 2
    assert worker._emb_pipeline.served > 0
    assert worker._emb_pipeline.invalidate() == 0


def test_hybrid_export_carries_the_local_copy(tmp_path):
    out = str(tmp_path / "out")
    worker, task_d, shards, _, first = _run_hybrid_job(tmp_path, output=out)
    assert task_d.finished()
    (stamp,) = os.listdir(out)
    version, named = load_from_checkpoint_file(os.path.join(out, stamp))
    assert version == worker._model_version
    local = worker._to_wire(worker._params)
    assert sorted(named) == sorted(local)
    for k in local:
        assert np.array_equal(np.asarray(named[k]), local[k]), k
    # not the shards' (the first push's) copy
    assert not np.array_equal(np.asarray(named["id_bias/table"]),
                              first["id_bias/table"])


class _Remote:
    """An in-process shard whose errors reach the client as a shard
    process's do (``PSRpcError``, as ``BoundPS`` raises them)."""

    def __init__(self, servicer):
        self.servicer = servicer

    def __getattr__(self, method):
        from elasticdl_tpu_torch.worker.ps_client import PSRpcError

        fn = getattr(self.servicer, method)

        def call(req):
            try:
                return fn(req)
            except Exception as err:
                raise PSRpcError("shard", method, err) from err

        return call


def test_hybrid_worker_repushes_to_an_empty_shard(tmp_path):
    """Shard 1 is replaced by an empty incarnation mid-job: the worker
    (which never pulls the model) pushes the model and the table infos
    again and trains on to the end."""
    shards = [_Remote(s) for s in _shards()]
    swapped = {}

    def swap(step, worker):
        if step == 3:
            swapped["new"] = _shards(1, epoch=2)[0]
            worker._ps_client._ps[1] = _Remote(swapped["new"])

    worker, task_d, _, losses, _ = _run_hybrid_job(
        tmp_path, shards=shards, on_step=swap)
    assert task_d.finished() and len(losses) == 8
    fresh = swapped["new"]._parameters
    assert fresh.initialized
    assert sorted(fresh.embedding_params) == ["embedding"]
    assert fresh.embedding_params["embedding"].embedding_vectors
    assert [r[:3] for r in worker._ps_client.relaunches] == [(1, 1, 2)]


def test_hybrid_repush_runs_on_the_worker_thread(tmp_path, monkeypatch):
    """The re-push reads the parameters that the worker thread updates in
    place, so it never runs on the pull pipeline's thread: here that
    thread's staged pull is the first call after the relaunch is seen."""
    threads = []
    reset = Worker._on_ps_shard_reset

    def recording_reset(self, shards):
        threads.append(threading.current_thread().name)
        return reset(self, shards)

    monkeypatch.setattr(Worker, "_on_ps_shard_reset", recording_reset)
    shards = [_Remote(s) for s in _shards()]

    def swap(step, worker):
        if step == 3:
            worker._ps_client._ps[1] = _Remote(_shards(1, epoch=2)[0])
            worker._ps_client._note_shard_failures({1})

    worker, task_d, _, losses, _ = _run_hybrid_job(
        tmp_path, shards=shards, on_step=swap)
    assert task_d.finished() and len(losses) == 8
    assert threads and set(threads) == {threading.main_thread().name}


@pytest.mark.parametrize(
    "plane,get_model_steps,warms",
    [("hybrid", 1, True), ("ps", 4, True), ("ps", 1, False)],
    ids=["hybrid", "ssp", "ps"],
)
def test_local_optimizer_warms_before_the_first_task(
        plane, get_model_steps, warms):
    """A worker that updates its own copy (every step under hybrid, the
    SSP steps) steps its optimizer once on a scratch tensor before the
    first task; the model and its optimizer are untouched."""
    worker = _worker(PSClient(_shards()), plane, plane,
                     get_model_steps=get_model_steps,
                     stub=type("NoTasks", (), {})())
    built = []
    opt_fn = worker._opt_fn

    def recording_opt_fn(params):
        built.append([tuple(p.shape) for p in params])
        return opt_fn(params)

    worker._opt_fn = recording_opt_fn
    worker._train_and_evaluate = lambda: None
    worker.run()
    assert built == ([[(1,)]] if warms else [])
    assert worker._local_opt is None and worker._params is None
    worker._ps_client.close()


def test_the_worker_entry_point_refuses_hybrid_without_a_fleet():
    """``worker.main --embedding_plane hybrid`` on the master-held model
    (no ``--ps_addrs``): the worker has no PS client and refuses, as the
    reference's does."""
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker import main as worker_main

    args = parse_worker_args([
        "--worker_id", "0", "--job_type", "training_only",
        "--master_addr", "localhost:1", "--model_zoo", "",
        "--model_def", MODEL_DEF, "--minibatch_size", "8",
        "--embedding_plane", "hybrid", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a ps_client"):
        worker_main._ps_main(args)


def test_a_hybrid_fleet_of_processes_trains(tmp_path):
    """``master.main --num_ps_pods 2 --embedding_plane hybrid``, two
    ``ps.main`` shards and ``worker.main --embedding_plane hybrid
    --ps_push_inflight 1`` under the instance manager: every task done
    once, no dense tensor pushed, the pipeline serving, and each shard
    holding only the ``embedding`` table."""
    import sys

    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )
    from tests.test_torch_ps_fleet import REPO, _free_port
    from tests.test_torch_ps_job import write_frappe

    data = tmp_path / "data"
    write_frappe(str(data), 256, 5000)
    mport, pports = _free_port(), [_free_port(), _free_port()]
    journal, timeline = str(tmp_path / "journal"), str(tmp_path / "tl")
    py = [sys.executable, "-m"]
    common = ["--model_zoo", "", "--model_def", MODEL_DEF, "--model_params",
              "embedding_dim=8,fc_unit=8,vocab_size=5000,"
              "embedding_plane='hybrid'", "--device", "cpu",
              "--log_level", "WARNING"]
    master_argv = py + [
        "elasticdl_tpu_torch.master.main", "--job_name", "j",
        "--training_data", str(data), "--minibatch_size", "32",
        "--num_minibatches_per_task", "2", "--num_ps_pods", "2",
        "--use_async", "true", "--embedding_plane", "hybrid",
        "--port", str(mport), "--master_journal_dir", journal] + common

    def ps_command(i):
        return py + ["elasticdl_tpu_torch.ps.main", "--ps_id", str(i),
                     "--port", str(pports[i]), "--use_async", "true"] + common

    def worker_command(worker_id, device):
        return py + [
            "elasticdl_tpu_torch.worker.main", "--worker_id",
            str(worker_id), "--job_type", "training_only",
            "--master_addr", "localhost:%d" % mport, "--ps_addrs",
            ",".join("localhost:%d" % p for p in pports),
            "--minibatch_size", "32", "--master_failover_s", "30",
            "--embedding_plane", "hybrid", "--ps_push_inflight", "1",
        ] + common

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_MASTER_POLL_SECS="1", EDL_WORKER_TIMELINE_DIR=timeline)
    manager = LocalInstanceManager(
        None, 1, worker_command, ["cpu"], num_ps=2, ps_command=ps_command,
        env=env, master_command=lambda: master_argv,
    )
    tables = []
    try:
        manager.start_master()
        manager.start_all_ps()
        manager.start_workers()
        assert manager.wait(timeout=240)
        deadline = time.monotonic() + 30
        while manager.live_master() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert manager.exit_codes == {0: 0}
        assert manager.master_exit_codes == [0]
        from elasticdl_tpu_torch.worker.ps_client import BoundPS

        for port in pports:
            stub = BoundPS("localhost:%d" % port, deadline_s=10)
            try:
                status = stub.ps_status({})
            finally:
                stub.close()
            tables.append(sorted(status["tables"]))
            assert status["version"] == 8 and not status["apply_ms"]["dense"]
    finally:
        manager.stop_relaunch_and_remove_all_pods()
    state = MasterJournal(journal).replay()
    assert state.counters["done"] == 256 // 64 and not state.pending
    assert tables == [["embedding"], ["embedding"]]
    with open(os.path.join(timeline, "worker-0.jsonl")) as f:
        (end,) = [e for e in map(json.loads, f) if e["event"] == "end"]
    assert end["dense_tensors_pushed"] == 0 and end["rounds"] == 1
    # every step but the round's first
    assert end["pipeline"]["served"] == 8 - 1
    assert end["pipeline"]["dropped"] == 0
