"""Serving's PS plane against the JAX package's: the shard's delta log
(``ps/delta_log.py``), the shard's two scorer reads (``serving_status``,
``pull_embedding_delta``), the hot-row cache's delta-sync methods, the
delta sync (``serving/delta_sync.py``) and the scorer of an
elastic-embedding model reading its rows through the cache from the
shards; then the scorer's hot swap, the micro-batcher and
``serving.main.build_scorer`` over two shard processes with one SIGKILLed
and relaunched.

Each parity case runs one script through both packages at DeepFM's small
width (``embedding_dim=8,fc_unit=8,vocab_size=100``) and holds ids,
versions and counters equal; rows and scores are float32 on the CPU,
held bitwise where both packages run the same arithmetic (SGD row
updates) and within ``SCORE_TOL`` relative L2 where they do not (the
forward).
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.export import (
    export_model as j_export_model,
    export_provenance as j_export_provenance,
)
from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.nn.comm_plane import HotRowCache as JHotRowCache
from elasticdl_tpu.ps.delta_log import DeltaLog as JDeltaLog
from elasticdl_tpu.ps.parameters import (
    EmbeddingTableInfo as JInfo,
    Parameters as JParameters,
)
from elasticdl_tpu.ps.servicer import PserverServicer as JServicer
from elasticdl_tpu.serving.delta_sync import (
    EmbeddingDeltaSync as JEmbeddingDeltaSync,
)
from elasticdl_tpu.serving.scorer import (
    ModelDirectoryWatcher as JWatcher,
    Scorer as JScorer,
)
from elasticdl_tpu.worker.ps_client import PSClient as JPSClient
from elasticdl_tpu_torch.common.args import parse_scorer_args
from elasticdl_tpu_torch.common.tensor import Tensor
from elasticdl_tpu_torch.nn.comm_plane import HotRowCache
from elasticdl_tpu_torch.ps.delta_log import DeltaLog
from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo, Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.serving.batcher import MicroBatcher
from elasticdl_tpu_torch.serving.delta_sync import EmbeddingDeltaSync
from elasticdl_tpu_torch.serving.main import build_scorer
from elasticdl_tpu_torch.serving.scorer import ModelDirectoryWatcher, Scorer
from elasticdl_tpu_torch.worker.ps_client import PSClient
from tests.test_utils import MODEL_ZOO_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
MODEL_PARAMS = "embedding_dim=8,fc_unit=8,vocab_size=100"
DIM = 8
SCORE_TOL = 1e-5  # f32 scores on the CPU, relative L2
PROCESS_LIMIT_S = 120  # each stage of the process test


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _features(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"feature": rng.integers(1, 100, size=(n, 10)).astype(np.int64)}


# -- the delta log ----------------------------------------------------------


def _note_script(log, rng, tables=("a", "b"), steps=40):
    """Notes of random ids, versions advancing by 0-2 (a sync round's two
    notes share one), empty updates among them."""
    version = 0
    for _ in range(steps):
        version += int(rng.integers(0, 3))
        table = tables[int(rng.integers(0, len(tables)))]
        n = int(rng.integers(0, 6))
        log.note(table, rng.integers(0, 50, n), version)
    return version


@pytest.mark.parametrize("keep,max_rows", [(3, 1 << 20), (8, 20), (1024, 7)])
@pytest.mark.parametrize("base", [0, 5])
def test_the_delta_log_answers_as_the_references(keep, max_rows, base):
    port = DeltaLog(base_version=base, keep_versions=keep, max_rows=max_rows)
    ref = JDeltaLog(base_version=base, keep_versions=keep, max_rows=max_rows)
    last = _note_script(port, np.random.default_rng(3))
    assert _note_script(ref, np.random.default_rng(3)) == last
    assert port.table_versions() == ref.table_versions()
    assert port.floors() == ref.floors()
    incomplete = 0
    for table in ("a", "b", "never"):
        for since in range(-2, last + 3):
            got, want = port.since(table, since), ref.since(table, since)
            assert got[0].dtype == np.int64
            assert np.array_equal(got[0], want[0]), (table, since)
            assert got[1:] == want[1:], (table, since)
            incomplete += not got[2]
    # the small windows prune, so some since-versions lie below the floor
    assert incomplete > 0


def test_the_delta_log_floor_and_prune():
    """The reference's own floor-and-prune walk through, on the port."""
    log = DeltaLog(base_version=0, keep_versions=3)
    log.note("t", [1, 2, 3], 1)
    log.note("t", torch.tensor([2, 4]), 2)  # a tensor crosses in one copy
    ids, covered, complete = log.since("t", 1)
    assert complete and covered == 2 and list(ids) == [2, 4]
    ids, covered, complete = log.since("t", 0)
    assert complete and sorted(ids) == [1, 2, 3, 4]
    ids, covered, complete = log.since("t", 2)
    assert complete and covered == 2 and ids.size == 0
    log.note("t", [5], 3)
    log.note("t", [6], 4)  # prunes v1: the floor rises to 1
    ids, covered, complete = log.since("t", 0)
    assert not complete and covered == 4
    assert log.floors()["t"] == 1
    ids, covered, complete = log.since("t", 1)
    assert complete and sorted(ids) == [2, 4, 5, 6]
    ids, covered, complete = log.since("u", 0)
    assert complete and ids.size == 0
    assert log.table_versions() == {"t": 4}
    with pytest.raises(ValueError):
        DeltaLog(keep_versions=0)


def test_a_noted_view_is_copied():
    ids = np.array([1, 2, 3], np.int64)
    log = DeltaLog()
    log.note("t", ids, 1)
    ids[:] = 9
    assert list(log.since("t", 0)[0]) == [1, 2, 3]


# -- the shard's two reads ----------------------------------------------------


OPTS = {
    "sgd": (lambda: (lambda p: torch.optim.SGD(p, lr=0.1)),
            lambda: optax.sgd(0.1)),
    "momentum": (lambda: (lambda p: torch.optim.SGD(p, lr=0.1,
                                                    momentum=0.9)),
                 lambda: optax.sgd(0.1, momentum=0.9)),
}


def _servicer_pair(opt, use_async, grads_to_wait, restored=None):
    """A port and a reference servicer holding one dense tensor and both
    DeepFM tables; ``restored`` boots them as a shard that restored that
    version."""
    make_port, make_ref = OPTS[opt]
    model = {"dense": np.full((3, 2), 0.5, np.float32)}
    pair = []
    for params, cls, info, tensor in (
        (Parameters(), PserverServicer, EmbeddingTableInfo, Tensor),
        (JParameters(), JServicer, JInfo, JTensor),
    ):
        infos = [info("embedding", DIM, "uniform"), info("id_bias", 1,
                                                         "zeros")]
        if restored is not None:
            params.init_from_model(restored, model, infos)
        kwargs = dict(use_async=use_async, restored_version=restored)
        if cls is PserverServicer:
            s = cls(params, grads_to_wait, make_port(), "cpu", **kwargs)
        else:
            s = cls(params, grads_to_wait, make_ref(), **kwargs)
        s.push_model({"version": restored or 0, "embedding_infos": [
            {"name": i.name, "dim": i.dim, "initializer": i.initializer}
            for i in infos], "params": [tensor(k, v)
                                        for k, v in model.items()]})
        pair.append((s, tensor))
    return pair


def _push(servicer, tensor, rng, version):
    grads = [tensor("dense", rng.normal(size=(3, 2)).astype(np.float32))]
    for table, dim in (("embedding", DIM), ("id_bias", 1)):
        if rng.random() < 0.3:
            continue  # a push that leaves this table alone
        ids = rng.integers(0, 40, int(rng.integers(1, 8)))
        grads.append(tensor(table, rng.normal(size=(len(ids), dim)).astype(
            np.float32), ids))
    return servicer.push_gradient(
        {"model_version": version, "gradients": grads})


def _drive(servicer, tensor, pushes):
    rng = np.random.default_rng(5)
    version = servicer.ps_status({})["version"]
    for _ in range(pushes):
        version = _push(servicer, tensor, rng, version)["version"]
    return version


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
@pytest.mark.parametrize(
    "use_async,grads_to_wait", [(True, 1), (False, 1), (False, 2)],
    ids=["async", "sync", "sync_wait2"])
@pytest.mark.parametrize("restored", [None, 6], ids=["fresh", "restored"])
def test_the_shards_reads_answer_as_the_references(
        opt, use_async, grads_to_wait, restored):
    (port, pt), (ref, rt) = _servicer_pair(opt, use_async, grads_to_wait,
                                           restored)
    base = restored or 0
    first = port.serving_status({})
    # nothing applied yet: every table reports the base
    assert first["tables"] == {"embedding": base, "id_bias": base}
    version = _drive(port, pt, 14)
    assert _drive(ref, rt, 14) == version
    assert version == base + 14 // grads_to_wait
    got, want = port.serving_status({}), ref.serving_status({})
    assert got.pop("shard_epoch") == want.pop("shard_epoch") == 0
    assert got == want
    # the optimizer's slot tables exist and are never advertised
    slots = [n for n, t in port._parameters.embedding_params.items()
             if t.is_slot]
    assert bool(slots) == (opt == "momentum")
    assert set(got["tables"]) == {"embedding", "id_bias"}
    for table in ("embedding", "id_bias", "missing"):
        for since in range(base - 2, version + 2):
            req = {"name": table, "since_version": since}
            a, b = port.pull_embedding_delta(req), ref.pull_embedding_delta(
                req)
            assert np.array_equal(a["ids"], b["ids"]), (table, since)
            assert (a["version"], a["complete"]) == (
                b["version"], b["complete"]), (table, since)
    # the zero-initialized rows moved alike in both packages
    req = {"name": "id_bias", "ids": np.arange(40)}
    assert _rel_l2(port.pull_embedding_vector(req)["rows"],
                   ref.pull_embedding_vector(req)["rows"]) <= 1e-6


def test_the_log_never_runs_behind_the_version():
    """Each apply's ids are in the log before its version is visible: a
    reader that takes the version first finds, for every table, the
    newest write at or below that version (or a later one)."""
    (port, pt), _ = _servicer_pair("sgd", True, 1)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(port.serving_status({}))

    t = threading.Thread(target=reader)
    t.start()
    try:
        _drive(port, pt, 60)
    finally:
        stop.set()
        t.join()
    writes = {table: [v for v, _ in q]
              for table, q in port._delta._entries.items()}
    assert set(writes) == {"embedding", "id_bias"}
    for status in seen:
        for table, last in status["tables"].items():
            newest = max([v for v in writes[table] if v <= status["version"]],
                         default=0)
            assert last >= newest, (table, status)
    assert len(seen) > 1


# -- the cache's delta-sync methods -----------------------------------------


def _cache_script(cache, rng):
    """The client's and the sync's calls mixed; what each returned."""
    out = []
    for step in range(60):
        shard = int(rng.integers(0, 2))
        table = "t%d" % (step % 2)
        op = int(rng.integers(0, 8))
        if op == 0:
            cache.note_version(shard, int(rng.integers(0, 14)))
        elif op in (1, 2):
            ids = rng.integers(0, 30, 5)
            cache.put_rows(table, ids, shard, int(rng.integers(0, 12)),
                           rng.normal(size=(5, DIM)).astype(np.float32))
        elif op == 3:
            dropped, retagged = cache.refresh_table(
                table, shard, int(rng.integers(0, 14)),
                rng.integers(0, 30, int(rng.integers(0, 4))),
                since=int(rng.integers(0, 10)))
            out.append(("refresh", sorted(dropped), retagged))
        elif op == 4:
            below = None if rng.random() < 0.3 else int(rng.integers(0, 12))
            out.append(("invalidate",
                        cache.invalidate_table(table, below_version=below)))
        elif op == 5:
            out.append(("lag", cache.max_live_lag()))
        else:
            got = cache.get_rows(table, rng.integers(0, 30, 6))
            out.append([None if r is None else np.asarray(r).tolist()
                        for r in got])
    return out


def _entries(cache):
    return [(key, shard, version, np.asarray(row).tolist())
            for key, (shard, version, row) in cache._rows.items()]


@pytest.mark.parametrize("window", [0, 2, 4])
@pytest.mark.parametrize("max_rows", [12, 256])
def test_the_caches_delta_methods_match_the_references(window, max_rows):
    port, ref = HotRowCache(max_rows, window), JHotRowCache(max_rows, window)
    assert _cache_script(port, np.random.default_rng(11)) == _cache_script(
        ref, np.random.default_rng(11))
    assert _entries(port) == _entries(ref)
    assert port._latest == ref._latest
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.table_stats() == ref.table_stats()


def test_refresh_table_drops_changed_and_stale_and_retags_the_rest():
    cache = HotRowCache(64, window=2)
    for i in range(4):
        cache.put("t", i, 0, 10, np.full(2, i, np.float32))
    cache.put("t", 9, 0, 5, np.full(2, 9.0, np.float32))  # below since
    cache.put("u", 1, 0, 10, np.ones(2, np.float32))  # another table
    cache.put("t", 7, 1, 10, np.ones(2, np.float32))  # another shard
    dropped, retagged = cache.refresh_table("t", 0, 14, [1, 3], since=10)
    assert sorted(dropped) == [1, 3, 9] and retagged == 2
    assert cache.get("t", 0) is not None and cache.get("t", 2) is not None
    assert cache.get("t", 1) is None
    # the shard's clock moved to 14: "u" (tagged 10) is past the window
    assert cache.get("u", 1) is None
    assert cache.get("t", 7) is not None  # shard 1's clock did not move
    assert cache.max_live_lag() == 0
    cache.note_version(0, 16)
    assert cache.max_live_lag() == 2
    # below 12: shard 1's entry (10) drops, shard 0's re-tagged ones stay
    assert cache.invalidate_table("t", below_version=12) == 1
    assert cache.invalidate_table("t") == 2 and len(cache) == 0


# -- the delta sync ---------------------------------------------------------


def _package(name):
    if name == "port":
        return dict(
            shard=lambda: PserverServicer(
                Parameters(), 1, lambda p: torch.optim.SGD(p, lr=0.1), "cpu",
                use_async=True),
            client=PSClient, cache=HotRowCache, sync=EmbeddingDeltaSync,
            tensor=Tensor, info=EmbeddingTableInfo, log=DeltaLog)
    return dict(
        shard=lambda: JServicer(JParameters(), 1, optax.sgd(0.1),
                                use_async=True),
        client=JPSClient, cache=JHotRowCache, sync=JEmbeddingDeltaSync,
        tensor=JTensor, info=JInfo, log=JDeltaLog)


def _push_sparse(pkg, client, table, ids, dim, rng):
    grads = rng.normal(0, 0.1, size=(len(ids), dim)).astype(np.float32)
    client.push_gradient({}, [pkg["tensor"](
        table, grads, indices=np.asarray(ids, np.int64))], 0)


def _sync_setup(pkg, window=2, shards=1):
    shards = [pkg["shard"]() for _ in range(shards)]
    cache = pkg["cache"](4096, window=window)
    client = pkg["client"](shards, cache=cache)
    client.push_model({}, [pkg["info"]("embedding", DIM, "uniform"),
                           pkg["info"]("id_bias", 1, "uniform")], version=0)
    return shards, cache, client


def _counters(sync):
    return {k: getattr(sync, k) for k in (
        "rounds", "rows_dropped", "rows_retagged", "rows_refreshed",
        "tables_invalidated")}


def _staleness_bound(pkg):
    """Table A is rewritten every version: no hit may lag past the
    window, and table B's hot rows, which nothing writes, keep hitting
    across A's advances."""
    rng = np.random.default_rng(2)
    shards, cache, scorer_client = _sync_setup(pkg)
    trainer = pkg["client"](shards)
    sync = pkg["sync"](scorer_client, cache, refresh_rows=True)
    ids = np.arange(1, 9, dtype=np.int64)
    out = {"lags": [], "b_hits": []}
    try:
        scorer_client.pull_embedding_vectors("embedding", ids)
        scorer_client.pull_embedding_vectors("id_bias", ids)
        sync.sync_once()
        for round_ in range(12):
            _push_sparse(pkg, trainer, "embedding", ids[round_ % 2::2], DIM,
                         rng)
            sync.sync_once()
            out["lags"].append(cache.max_live_lag())
            out["b_hits"].append(all(
                r is not None for r in cache.get_rows("id_bias", ids)))
        fresh = trainer.pull_embedding_vectors("embedding", ids)
        cached = scorer_client.pull_embedding_vectors("embedding", ids)
        out["fresh_equals_cached"] = bool(np.array_equal(fresh, cached))
        out["rows"] = np.asarray(cached).tolist()
        out["synced"] = sync.synced_versions()
    finally:
        scorer_client.close()
        trainer.close()
    return out, _counters(sync), (cache.hits, cache.misses)


def _incomplete_fallback(pkg):
    """The shard's log cannot answer the sync point: only that table's
    stale rows drop, the other table's survive."""
    rng = np.random.default_rng(4)
    shards, cache, client = _sync_setup(pkg)
    sync = pkg["sync"](client, cache, refresh_rows=False)
    try:
        client.pull_embedding_vectors("embedding", np.arange(1, 9))
        client.pull_embedding_vectors("id_bias", np.arange(1, 9))
        sync.sync_once()
        _push_sparse(pkg, client, "embedding", [1, 2], DIM, rng)
        shards[0]._delta = pkg["log"](base_version=50, keep_versions=2)
        shards[0]._delta.note("embedding", [1, 2], 51)
        sync.sync_once()
        out = {"id_bias_kept": all(r is not None for r in cache.get_rows(
            "id_bias", np.arange(1, 9))),
            "entries": len(cache), "synced": sync.synced_versions()}
    finally:
        client.close()
    return out, _counters(sync), (cache.hits, cache.misses)


def _epoch_change(pkg):
    """A relaunched shard (a new ``shard_epoch``, its log restarted at
    its restored version): the poll alone sees it, the client drops the
    shard's entries, and the sync starts its sync points afresh."""
    rng = np.random.default_rng(6)
    shards, cache, client = _sync_setup(pkg, shards=2)
    sync = pkg["sync"](client, cache, refresh_rows=True)
    ids = np.arange(1, 13, dtype=np.int64)
    try:
        client.pull_embedding_vectors("embedding", ids)
        sync.sync_once()
        for _ in range(3):
            _push_sparse(pkg, client, "embedding", ids[:4], DIM, rng)
        sync.sync_once()
        before = sync.synced_versions()
        restored = shards[1]._parameters.version
        shards[1]._shard_epoch = 7
        shards[1]._restored_version = restored
        shards[1]._delta = pkg["log"](base_version=restored)
        left = len(cache)
        sync.sync_once()
        out = {"before": before, "after": sync.synced_versions(),
               "dropped_by_relaunch": left - len(cache),
               "epochs": client.shard_epochs}
        _push_sparse(pkg, client, "embedding", ids[4:8], DIM, rng)
        client.pull_embedding_vectors("embedding", ids)
        sync.sync_once()
        out["final"] = sync.synced_versions()
        out["lag"] = cache.max_live_lag()
    finally:
        client.close()
    return out, _counters(sync), (cache.hits, cache.misses)


@pytest.mark.parametrize("scenario", [_staleness_bound, _incomplete_fallback,
                                      _epoch_change])
def test_the_delta_sync_runs_as_the_references(scenario):
    port, ref = scenario(_package("port")), scenario(_package("ref"))
    assert port == ref
    out, counters, _ = port
    assert counters["rounds"] > 0
    if scenario is _staleness_bound:
        assert max(out["lags"]) <= 2 and all(out["b_hits"])
        assert out["fresh_equals_cached"]
        assert counters["rows_dropped"] > 0 and counters["rows_retagged"] > 0
        assert counters["rows_refreshed"] == counters["rows_dropped"]
    elif scenario is _incomplete_fallback:
        assert counters["tables_invalidated"] == 1 and out["id_bias_kept"]
    else:
        assert out["dropped_by_relaunch"] > 0
        assert out["epochs"] == {0: 0, 1: 7}
        assert out["after"][1] != out["before"][1]
        assert counters["tables_invalidated"] == 0


def test_the_loop_backs_off_while_no_shard_answers():
    class Down:
        num_ps = 2

        def serving_status(self, shard):
            raise RuntimeError("down")

    sync = EmbeddingDeltaSync(Down(), HotRowCache(4), interval_s=0.01,
                              max_interval_s=0.04)
    assert sync.sync_once() == {"shards_ok": 0, "shards_failed": 2}
    assert sync.last_error == "down"
    t0 = time.monotonic()
    sync.start()
    deadline = t0 + 10.0
    while sync.rounds < 6 and time.monotonic() < deadline:
        time.sleep(0.005)
    elapsed = time.monotonic() - t0
    sync.stop()
    # capped doubling: five rounds wait 0.01 + 0.02 + 3 x 0.04 s at least
    assert sync.rounds >= 6 and elapsed >= 0.15
    assert sync.staleness_gauge() == 0


# -- the scorer ------------------------------------------------------------


def _jax_deepfm_params(seed=0):
    import jax

    from elasticdl_tpu.common.model_utils import get_model_spec
    from elasticdl_tpu.nn.embedding import IDX_COLLECTION, ROWS_COLLECTION
    from elasticdl_tpu.nn.model_api import init_variables, split_variables

    spec = get_model_spec(model_zoo=MODEL_ZOO_PATH, model_def=MODEL_DEF,
                          model_params=MODEL_PARAMS)
    variables = init_variables(spec.model, jax.random.PRNGKey(seed),
                               _features())
    params, state = split_variables(variables)
    state.pop(ROWS_COLLECTION, None)
    state.pop(IDX_COLLECTION, None)
    return params


def _jax_export(root, version, seed=0):
    """A JAX-package export of the elastic DeepFM: its Dense layers only
    (the tables live on the shards)."""
    path = os.path.join(str(root), "v%010d" % version)
    j_export_model(path, _jax_deepfm_params(seed), version,
                   metadata=j_export_provenance(MODEL_ZOO_PATH, MODEL_DEF,
                                                MODEL_PARAMS))
    return path


def _rows(seed=9):
    rng = np.random.default_rng(seed)
    return {"embedding": rng.uniform(-0.05, 0.05, (100, DIM)).astype(
        np.float32),
        "id_bias": rng.uniform(-0.05, 0.05, (100, 1)).astype(np.float32)}


def _seed_rows(shards, rows):
    """Both packages' shards hold the same rows: each its ``id % n``."""
    ids = np.arange(100)
    for i, s in enumerate(shards):
        mine = ids[ids % len(shards) == i]
        for table, values in rows.items():
            s._parameters.embedding_params[table].set(mine, values[mine])


def _scorer_stack(pkg, root, window=2):
    shards, cache, client = _sync_setup(pkg, window=window, shards=2)
    _seed_rows(shards, _rows())
    if pkg["client"] is PSClient:
        scorer = Scorer(ps_client=client, staleness_versions=window)
        watcher = ModelDirectoryWatcher(root, scorer, device="cpu")
    else:
        scorer = JScorer(ps_client=client, staleness_versions=window)
        watcher = JWatcher(root, scorer)
    return shards, cache, client, scorer, watcher


@pytest.mark.parametrize("rows", [4, 32])
def test_the_scorer_scores_as_the_references(tmp_path, rows):
    _jax_export(tmp_path, 3)
    feats = _features(rows, seed=rows)
    outs = {}
    for name in ("port", "ref"):
        shards, cache, client, scorer, watcher = _scorer_stack(
            _package(name), tmp_path)
        try:
            assert watcher.poll_once() == 3
            out, version = scorer.score(feats)
            assert version == 3
            outs[name] = {k: np.asarray(v) for k, v in out.items()}
            if name == "port":
                hits = cache.hits
                again, _ = scorer.score(feats)
                assert cache.hits > hits  # the repeat comes from the cache
                for k in out:
                    assert torch.equal(out[k], again[k]), k
                status = scorer.status()
                assert status["model_version"] == 3
                assert status["staleness_versions"] <= status[
                    "staleness_window"] == 2
                assert status["cache_hits"] == cache.hits
                assert scorer.inflight_versions() == {}
                assert scorer.model().embedding_tables == {
                    "embedding": (DIM, "uniform"), "id_bias": (1, "uniform")}
        finally:
            scorer.close()
            client.close()
    assert outs["port"]["probs"].shape == (rows, 1)
    for k in ("logits", "probs"):
        assert _rel_l2(outs["port"][k], outs["ref"][k]) <= SCORE_TOL, k


def test_the_scorer_gauges(tmp_path):
    from elasticdl_tpu_torch.utils import profiling

    _jax_export(tmp_path, 1)
    _, cache, client, scorer, watcher = _scorer_stack(
        _package("port"), tmp_path)
    try:
        watcher.poll_once()
        scorer.score(_features())
        samples = {(n, tuple(sorted(labels.items()))): v
                   for n, labels, v in profiling.metrics.collect()}
        assert samples[("edl_scorer_row_staleness_versions", ())] == 0
        probes = cache.hits + cache.misses
        assert samples[("edl_scorer_hot_row_hit_rate", ())] == (
            cache.hits / probes)
        stats = cache.table_stats()
        for table in ("embedding", "id_bias"):
            for key in ("hits", "misses", "evictions"):
                assert samples[("edl_cache_%s_total" % key,
                                (("table", table),))] == stats[table][key]
    finally:
        scorer.close()
        client.close()


def test_an_embedding_model_needs_a_plane(tmp_path):
    from elasticdl_tpu_torch.serving.scorer import ScorerModel

    model = ScorerModel(_jax_export(tmp_path, 1), device="cpu")
    # the export carries the Dense layers alone, and the rebuild takes it
    assert sorted(model.module.state_dict()) == [
        "out.bias", "out.weight", "tower.bias", "tower.weight"]
    with pytest.raises(RuntimeError, match="comm plane over the PS fleet"):
        model.predict(_features())
    scorer = Scorer()
    try:
        scorer.install(model)
        with pytest.raises(RuntimeError, match="PS-resident"):
            scorer.score(_features())
        assert "cache_hits" not in scorer.status()
    finally:
        scorer.close()


def test_a_shard_back_empty_gets_the_table_infos(tmp_path):
    """A shard relaunched with no snapshot reports no model: the scorer
    pushes its tables' infos again, and its rows are minted anew."""
    _jax_export(tmp_path, 1)
    shards, cache, client, scorer, watcher = _scorer_stack(
        _package("port"), tmp_path)
    try:
        watcher.poll_once()
        scorer.score(_features())
        shards[0] = PserverServicer(
            Parameters(), 1, lambda p: torch.optim.SGD(p, lr=0.1), "cpu",
            use_async=True, shard_epoch=4)
        client._ps[0] = shards[0]
        client.serving_status(0)  # the poll sees the new epoch
        out, _ = scorer.score(_features())
        assert np.all(np.isfinite(out["logits"].numpy()))
        assert sorted(shards[0]._parameters.embedding_params) == [
            "embedding", "id_bias"]
    finally:
        scorer.close()
        client.close()


def test_a_hot_swap_drains_the_requests_in_flight(tmp_path):
    """A request in flight across an install finishes on the version it
    acquired; new requests score the new version; the old version leaves
    the ledger once drained."""
    _jax_export(tmp_path, 1, seed=0)
    _, _, client, scorer, watcher = _scorer_stack(_package("port"),
                                                  tmp_path)
    try:
        assert watcher.poll_once() == 1
        feats = _features()
        scorer.score(feats)
        v1 = scorer.model()
        entered, proceed = threading.Event(), threading.Event()
        real = v1.predict

        def slow_predict(*a, **kw):
            entered.set()
            assert proceed.wait(10.0)
            return real(*a, **kw)

        v1.predict = slow_predict
        result = {}

        def request():
            result["out"], result["version"] = scorer.score(feats)

        t = threading.Thread(target=request)
        t.start()
        assert entered.wait(10.0)
        _jax_export(tmp_path, 2, seed=1)
        assert watcher.poll_once() == 2
        assert scorer.model_version == 2
        assert scorer.inflight_versions().get(1) == 1
        assert scorer.wait_drained(1, timeout=0.05) is False
        out_new, v_new = scorer.score(feats)
        assert v_new == 2
        proceed.set()
        t.join(10.0)
        assert result["version"] == 1
        assert scorer.wait_drained(1, timeout=10.0)
        assert 1 not in scorer.inflight_versions()
        assert not np.allclose(result["out"]["logits"].numpy(),
                               out_new["logits"].numpy())
    finally:
        scorer.close()
        client.close()


def test_a_batched_request_scores_as_a_solo_one(tmp_path):
    """The micro-batcher's forward of one 32-row request equals
    ``Scorer.score`` of it bitwise, and coalesced requests each get
    their own rows."""
    _jax_export(tmp_path, 1)
    _, _, client, scorer, watcher = _scorer_stack(_package("port"),
                                                  tmp_path)
    batcher = MicroBatcher(scorer, max_batch=64, timeout_ms=50.0)
    batcher.start()
    try:
        watcher.poll_once()
        feats = _features(32, seed=3)
        solo, _ = scorer.score(feats)
        batched, _ = batcher.submit(feats)
        for k in solo:
            assert torch.equal(solo[k], batched[k]), k
        parts = [_features(8, seed=s) for s in range(4)]
        outs = [None] * 4

        def submit(i):
            outs[i] = batcher.submit(parts[i])[0]

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for part, out in zip(parts, outs):
            alone, _ = scorer.score(part)
            assert _rel_l2(out["logits"].numpy(),
                           alone["logits"].numpy()) <= SCORE_TOL
    finally:
        batcher.stop(drain=True)
        batcher.close()
        scorer.close()
        client.close()


# -- the process entry over shard processes ---------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _until(probe, what, limit_s=PROCESS_LIMIT_S):
    deadline = time.monotonic() + limit_s
    while True:
        try:
            result = probe()
            if result:
                return result
        except Exception:  # noqa: BLE001 - not there yet
            pass
        assert time.monotonic() < deadline, "%s: over %d s" % (what, limit_s)
        time.sleep(0.1)


def test_build_scorer_serves_through_a_shard_sigkill(tmp_path):
    """``build_scorer`` with ``--ps_addrs`` over two ``ps.main`` shard
    processes (async, a snapshot every version): it scores a JAX-exported
    DeepFM from rows a trainer pushed, its sync re-tags and refreshes
    rows, and after shard 0 is SIGKILLed and relaunched on its port the
    poll alone sees the relaunch; scoring goes on within the window. A
    ``serving.main --ps_addrs`` process over the socket transport scores
    the same batch alike before and after, and drains on SIGTERM."""
    from elasticdl_tpu_torch.rpc.socket_transport import Client
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    ports = [_free_port(), _free_port()]
    snap = str(tmp_path / "snap")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def spawn(i):
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.ps.main",
             "--ps_id", str(i), "--port", str(ports[i]), "--model_zoo", "",
             "--model_def", MODEL_DEF, "--model_params", MODEL_PARAMS,
             "--use_async", "true", "--ps_snapshot_versions", "1",
             "--ps_snapshot_dir", snap, "--device", "cpu",
             "--log_level", "WARNING"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def status(i):
        stub = BoundPS("localhost:%d" % ports[i], deadline_s=2.0)
        try:
            return stub.ps_status({})
        finally:
            stub.close()

    procs = [spawn(0), spawn(1)]
    stack = trainer = scorer_proc = wire = None
    scorer_log = open(str(tmp_path / "scorer.log"), "wb")
    try:
        for i in (0, 1):
            _until(lambda i=i: status(i), "shard %d serving" % i)
        export_root = tmp_path / "exports"
        export_root.mkdir()
        _jax_export(export_root, 1)
        args = parse_scorer_args([
            "--export_dir", str(export_root), "--device", "cpu",
            "--ps_addrs", ",".join("localhost:%d" % p for p in ports),
            "--serving_staleness_versions", "2", "--rpc_deadline_s", "5",
            "--rpc_retries", "2", "--serve_max_batch", "0"])
        stack = build_scorer(args)
        scorer, watcher, sync, bound, batcher = stack
        assert batcher is None and len(bound) == 2
        client = scorer._client
        assert client.hot_row_cache._window == 2
        trainer = PSClient([BoundPS("localhost:%d" % p, deadline_s=10.0)
                            for p in ports])
        trainer.push_model({}, [EmbeddingTableInfo("embedding", DIM,
                                                   "uniform"),
                                EmbeddingTableInfo("id_bias", 1,
                                                   "uniform")])
        assert watcher.poll_once() == 1
        feats = _features(16)
        out1, _ = scorer.score(feats)
        scorer_port = _free_port()
        scorer_proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
             "--export_dir", str(export_root), "--ps_addrs",
             ",".join("localhost:%d" % p for p in ports), "--device", "cpu",
             "--port", str(scorer_port), "--scorer_transport", "socket",
             "--serving_staleness_versions", "2", "--watch_interval_s",
             "0.2", "--serving_sync_interval_s", "0.2", "--log_level",
             "WARNING"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=scorer_log)
        wire = Client("localhost:%d" % scorer_port, deadline_s=30)
        reply = _until(lambda: (lambda r: r if "error" not in r else None)(
            wire.call("score", **feats)), "the scorer process's first score")
        assert reply["model_version"] == 1
        assert np.array_equal(np.asarray(reply["out:logits"]),
                              out1["logits"].numpy())
        rng = np.random.default_rng(0)
        touched = np.unique(feats["feature"])[:6]
        for _ in range(3):
            trainer.push_gradient({}, [Tensor(
                "embedding", rng.normal(0, 0.1, (len(touched), DIM)).astype(
                    np.float32), touched)], 0)
        assert sync.sync_once() == {"shards_ok": 2, "shards_failed": 0}
        assert sync.sync_once() == {"shards_ok": 2, "shards_failed": 0}
        assert sync.rows_dropped > 0 and sync.rows_retagged > 0
        assert sync.rows_refreshed == sync.rows_dropped
        out2, _ = scorer.score(feats)
        assert not torch.equal(out1["logits"], out2["logits"])
        _until(lambda: os.path.isdir(os.path.join(snap, "ps-0")) and any(
            d.startswith("snap_v") for d in os.listdir(
                os.path.join(snap, "ps-0"))), "shard 0's snapshot")
        epoch = client.shard_epochs[0]
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=30)
        procs[0] = spawn(0)
        _until(lambda: status(0), "shard 0 relaunched")

        def relaunch_seen():
            sync.sync_once()
            return client.shard_epochs.get(0, epoch) != epoch

        _until(relaunch_seen, "the poll seeing the relaunch")
        assert [r[0] for r in client.relaunches] == [0]
        out3, _ = scorer.score(feats)
        assert np.all(np.isfinite(out3["logits"].numpy()))
        assert client.hot_row_cache.max_live_lag() <= 2
        assert sync.tables_invalidated == 0
        reply = _until(lambda: (lambda r: r if "error" not in r else None)(
            wire.call("score", **feats)), "the scorer process after")
        assert np.all(np.isfinite(np.asarray(reply["out:logits"])))
        status = wire.call("scorer_status")
        assert status["staleness_versions"] <= status[
            "staleness_window"] == 2
        scorer_proc.send_signal(signal.SIGTERM)
        assert scorer_proc.wait(timeout=PROCESS_LIMIT_S) == 0
    finally:
        if wire is not None:
            wire.close()
        if scorer_proc is not None and scorer_proc.poll() is None:
            scorer_proc.kill()
            scorer_proc.wait(timeout=30)
        scorer_log.close()
        if trainer is not None:
            trainer.close()
        if stack is not None:
            stack[0].close()
            for channel in stack[3]:
                channel.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def test_the_scorer_answers_over_the_socket_transport(tmp_path):
    """``ScorerServer(transport="socket")``: the port's socket wire (a
    host without grpcio) carries ``score`` and ``scorer_status`` with the
    same frames, replies equal to the in-process servicer's."""
    from elasticdl_tpu_torch.rpc.socket_transport import Client
    from elasticdl_tpu_torch.serving.server import ScorerServer

    _jax_export(tmp_path, 2)
    _, _, client, scorer, watcher = _scorer_stack(_package("port"),
                                                  tmp_path)
    server = ScorerServer(scorer, port=0, transport="socket")
    wire = Client("localhost:%d" % server.port, deadline_s=30)
    try:
        watcher.poll_once()
        feats = _features(8)
        reply = wire.call("score", **feats)
        assert reply["model_version"] == 2
        direct = server.servicer.score(feats)
        for key in ("out:logits", "out:probs"):
            assert np.array_equal(np.asarray(reply[key]),
                                  direct[key].numpy()), key
        status = wire.call("scorer_status")
        assert status["model_version"] == 2
        assert status["staleness_versions"] <= status["staleness_window"]
        with pytest.raises(ValueError):
            ScorerServer(scorer, transport="http")
    finally:
        wire.close()
        server.stop()
        scorer.close()
        client.close()
