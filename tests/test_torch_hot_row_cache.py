"""The worker's hot-row cache (``nn/comm_plane.HotRowCache``) and the PS
client's hooks, against the JAX package's: one scripted sequence of
``note_version``/``put_rows``/``get_rows``/``invalidate_shard`` gives the
same rows, hits, misses and evictions; a ``PSClient`` with the cache
drives the same small sync DeepFM-shaped stream (zipf ids, two tables)
in both packages against in-process shards, with equal hit counts and
the fleet tests' tolerance on rows and dense parameters; a relaunched
shard's entries are dropped; ``worker.main`` hands the client its
flags. The ``"{layer}-{id}"`` embedding service facade is held against
the reference's here too."""

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.master.embedding_service import (
    EmbeddingService as JEmbeddingService,
)
from elasticdl_tpu.nn.comm_plane import HotRowCache as JHotRowCache
from elasticdl_tpu.ps.parameters import (
    EmbeddingTableInfo as JInfo,
    Parameters as JParameters,
)
from elasticdl_tpu.ps.servicer import PserverServicer as JServicer
from elasticdl_tpu.worker.ps_client import PSClient as JPSClient
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.master.embedding_service import EmbeddingService
from elasticdl_tpu_torch.nn.comm_plane import HotRowCache
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker.ps_client import PSClient

DIM = 4
FLEET_TOL = 1e-6  # tests/test_torch_ps_fleet.py's momentum tolerance


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _script(cache, rng):
    """A mixed sequence of the client's calls; what each probe returned."""
    out = []
    for step in range(40):
        shard = int(rng.integers(0, 2))
        op = rng.integers(0, 5)
        if op == 0:
            cache.note_version(shard, int(rng.integers(-1, 12)))
        elif op == 1:
            ids = rng.integers(0, 30, 5)
            rows = rng.normal(size=(5, DIM)).astype(np.float32)
            cache.put_rows("t%d" % (step % 2), ids, shard,
                           int(rng.integers(0, 10)), rows)
        elif op == 2 and step % 7 == 0:
            out.append(("dropped", cache.invalidate_shard(
                shard, version=int(rng.integers(0, 5)))))
        else:
            got = cache.get_rows("t%d" % (step % 2), rng.integers(0, 30, 6))
            out.append([None if r is None else np.asarray(r).tolist()
                        for r in got])
    return out


@pytest.mark.parametrize("window", [0, 1, 3])
@pytest.mark.parametrize("max_rows", [8, 64])
def test_a_scripted_sequence_matches_the_reference(window, max_rows):
    port, ref = HotRowCache(max_rows, window), JHotRowCache(max_rows, window)
    assert _script(port, np.random.default_rng(7)) == _script(
        ref, np.random.default_rng(7))
    assert (port.hits, port.misses, len(port)) == (
        ref.hits, ref.misses, len(ref))
    assert port.table_stats() == ref.table_stats()
    assert port.hits > 0 and port.misses > 0


def test_per_table_counters():
    c = HotRowCache(max_rows=2, window=1)
    c.note_version("ps0", 1)
    row = np.ones(DIM, np.float32)
    c.put("emb_a", 1, "ps0", 1, row)
    assert c.get("emb_a", 1) is not None
    assert c.get("emb_a", 2) is None
    assert c.get("emb_b", 7) is None
    c.put("emb_b", 8, "ps0", 1, row)
    c.put("emb_b", 9, "ps0", 1, row)  # evicts emb_a:1, the LRU entry
    stats = c.table_stats()
    assert stats["emb_a"] == {"hits": 1, "misses": 1, "evictions": 1}
    assert stats["emb_b"] == {"hits": 0, "misses": 1, "evictions": 0}
    assert c.hits == 1 and c.misses == 2
    c.put("emb_b", 10, "ps0", None, row)  # an unversioned reply
    assert c.get("emb_b", 10) is None


def test_an_entry_past_the_window_is_a_miss_and_dropped():
    c = HotRowCache(max_rows=8, window=2)
    c.put_rows("t", [1, 2], 0, 5, np.ones((2, DIM), np.float32))
    c.note_version(0, 7)
    assert c.get("t", 1) is not None  # two behind: still served
    c.note_version(0, 8)
    assert c.get("t", 1) is None and len(c) == 1
    # a relaunched shard restored to version 3: entries gone, clock reset
    c.put_rows("t", [4], 0, 8, np.ones((1, DIM), np.float32))
    assert c.invalidate_shard(0, version=3) == 2
    c.put_rows("t", [5], 0, 3, np.ones((1, DIM), np.float32))
    assert c.get("t", 5) is not None


# -- the client over in-process shards, both packages ----------------------


def _zipf_stream(steps, batch=24, pool=300, seed=11):
    """DeepFM-shaped batches: 10 ids a record drawn with weights
    1 / i^1.05 from a pool, and a dense gradient seed per step."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, pool + 1) ** 1.05
    ids = rng.permutation(5000)[:pool]
    return [ids[rng.choice(pool, size=(batch, 10),
                           p=weights / weights.sum())].reshape(-1)
            for _ in range(steps)]


def _shards(package, n=2):
    if package == "port":
        return [PserverServicer(
            Parameters(), 1, lambda p: torch.optim.SGD(
                p, lr=0.1, momentum=0.9), "cpu", shard_epoch=1)
            for _ in range(n)]
    return [JServicer(JParameters(), 1, optax.sgd(0.1, momentum=0.9))
            for _ in range(n)]


def _train(package, window, steps=12):
    """Sync steps through a cached client: pull both tables' rows, push
    row gradients that are a function of the rows pulled (so a stale hit
    changes the update), pull the dense model."""
    client_cls, tensor, info = (
        (PSClient, Tensor, EmbeddingTableInfo) if package == "port"
        else (JPSClient, JTensor, JInfo))
    shards = _shards(package)
    client = client_cls(shards, hot_row_cache_rows=4096,
                        staleness_window=window)
    rng = np.random.default_rng(3)
    model = {"dense": rng.normal(size=(10, 1)).astype(np.float32)}
    client.push_model(model, [info("embedding", DIM, "uniform"),
                              info("id_bias", 1, "zeros")])
    version = 0
    try:
        for ids in _zipf_stream(steps):
            rows = client.pull_embedding_vectors_multi(
                {"embedding": ids, "id_bias": ids})
            # a mean loss's scale: each occurrence carries 1 / len(ids)
            grads = [
                tensor("embedding",
                       (rows["embedding"] * 0.5 + 0.01) / len(ids), ids),
                tensor("id_bias", (rows["id_bias"] - 0.1) / len(ids), ids),
            ]
            dense = {"dense": rng.normal(size=(10, 1)).astype(np.float32)}
            accepted, version = client.push_gradient(dense, grads, version)
            assert accepted
            ready, version, named = client.pull_dense()
        cache = client.hot_row_cache
        touched = np.unique(np.concatenate(_zipf_stream(steps)))
        out_rows = {
            name: np.concatenate([np.asarray(
                shards[i].pull_embedding_vector(
                    {"name": name, "ids": touched[touched % 2 == i]}
                )["rows"]) for i in range(2)])
            for name in ("embedding", "id_bias")
        }
        return (cache.hits, cache.misses, cache.table_stats(), version,
                named, out_rows)
    finally:
        client.close()


@pytest.mark.parametrize("window", [1, 2])
def test_the_cached_client_trains_as_the_references(window):
    port = _train("port", window)
    ref = _train("reference", window)
    assert port[:4] == ref[:4]
    assert port[0] > 0 and port[3] == 12
    for name in ref[4]:
        assert _rel_l2(port[4][name], ref[4][name]) <= FLEET_TOL, name
    for name in ref[5]:
        assert _rel_l2(port[5][name], ref[5][name]) <= FLEET_TOL, name


def test_a_cache_that_hits_moves_the_model_a_cold_one_does_not():
    """Hits serve rows up to a version stale, so the cached run departs
    from the uncached one; the departure is what the chip check's Z3
    bounds."""
    cached = _train("port", 1)
    cold = _train("port", 0)  # every entry stale after one version
    assert cached[0] > 0 and cold[0] == 0
    diff = max(_rel_l2(cached[5][k], cold[5][k]) for k in cold[5])
    assert 0 < diff <= 5e-2


def test_a_relaunched_shard_loses_its_cached_rows():
    shards = _shards("port")
    client = PSClient(shards, hot_row_cache_rows=64, staleness_window=4)
    client.push_model({"w": np.ones(2, np.float32)},
                      [EmbeddingTableInfo("emb", DIM, "uniform")])
    try:
        ids = np.arange(8)
        first = client.pull_embedding_vectors("emb", ids)
        assert np.array_equal(client.pull_embedding_vectors("emb", ids),
                              first)
        assert client.hot_row_cache.hits == 8
        # shard 1 comes back as a new incarnation at version 0
        shards[1]._shard_epoch = 2
        shards[1]._parameters.embedding_params["emb"].set(
            ids[1::2], np.zeros((4, DIM), np.float32))
        client.pull_dense()
        assert len(client.hot_row_cache) == 4  # shard 0's rows stay
        again = client.pull_embedding_vectors("emb", ids)
        assert np.array_equal(again[0::2], first[0::2])
        assert not again[1::2].any()
    finally:
        client.close()


@pytest.mark.parametrize("flags,window", [
    ([], 1), (["--get_model_steps", "3", "--use_async", "true"], 3),
    (["--hot_row_staleness_window", "5"], 5),
])
def test_the_worker_hands_the_client_its_cache_flags(flags, window):
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker.main import make_ps_client
    from tests.test_torch_ps_job import DEEPFM

    args = parse_worker_args([
        "--worker_id", "0", "--job_type", "training_only",
        "--ps_addrs", "localhost:1,localhost:2", "--model_zoo", "",
        "--model_def", DEEPFM, "--minibatch_size", "8",
        "--hot_row_cache_rows", "64", "--device", "cpu"] + flags)
    client = make_ps_client(args)
    try:
        cache = client.hot_row_cache
        assert cache._max_rows == 64 and cache._window == window
    finally:
        client.close()


# -- the embedding service facade -------------------------------------------


@pytest.mark.parametrize("device", [None, "cpu"])
def test_the_embedding_service_matches_the_references(device):
    port = EmbeddingService(Parameters(device=device))
    ref = JEmbeddingService()
    port.parameters.init_embedding_params(
        [EmbeddingTableInfo("layer-a", DIM, "uniform")])
    ref.parameters.init_embedding_params([JInfo("layer-a", DIM, "uniform")])
    keys = ["layer-a-%d" % i for i in (7, 3, 7, 120)]
    got, unknown = port.lookup_embedding(keys)
    want, ref_unknown = ref.lookup_embedding(keys)
    assert unknown == ref_unknown == []
    assert np.array_equal(np.stack(got), np.stack(want))
    values = np.arange(2 * DIM, dtype=np.float32).reshape(2, DIM)
    port.update_embedding(keys[:2], values)
    ref.update_embedding(keys[:2], values)
    got, _ = port.lookup_embedding(keys)
    want, _ = ref.lookup_embedding(keys)
    assert np.array_equal(np.stack(got), np.stack(want))
    assert np.array_equal(got[1], values[1])
