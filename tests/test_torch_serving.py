"""The port's scorer stack against the JAX package's, on artifacts the
JAX package exported: model parity through ``ScorerModel``, the
micro-batcher, hot swap, error replies, gRPC loopback, and the process
entry point."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import export as jexport
from elasticdl_tpu.nn.model_api import init_variables
from elasticdl_tpu.serving.scorer import ScorerModel as JaxScorerModel
from elasticdl_tpu_torch.common.args import parse_scorer_args
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str
from elasticdl_tpu_torch.serving.main import build_scorer
from elasticdl_tpu_torch.serving.scorer import ScorerModel
from elasticdl_tpu_torch.serving.server import ScorerServer, ScorerServicer
from elasticdl_tpu_torch.utils import profiling
from model_zoo.transformer_lm import transformer_lm as jzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
MODEL_DEF = "transformer_lm.transformer_lm.custom_model"
MODEL_PARAMS = (
    "vocab_size=128,num_layers=2,num_heads=4,head_dim=16,embed_dim=64,"
    "mlp_dim=256"
)
VOCAB = 128
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _tokens(rows, length=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, size=(rows, length)).astype(np.int32)


def _export_jax(root, version, seed=0):
    """A JAX-exported artifact of the small transformer at
    ``root/v<version>``."""
    model = jzoo.custom_model(**get_dict_from_params_str(MODEL_PARAMS))
    params = init_variables(
        model, jax.random.PRNGKey(seed), {"tokens": _tokens(1, 8)}
    )["params"]
    path = os.path.join(str(root), "v%010d" % version)
    jexport.export_model(
        path, params, version,
        metadata=jexport.export_provenance(JAX_ZOO, MODEL_DEF, MODEL_PARAMS),
    )
    return path


def _stack(root, max_batch=4, timeout_ms=200.0):
    """A dense model's stack: (scorer, watcher, batcher); with no
    ``--ps_addrs`` there is no delta sync and no PS channel."""
    scorer, watcher, sync, bound, batcher = build_scorer(
        parse_scorer_args(
            [
                "--export_dir", str(root),
                "--device", "cpu",
                "--serve_max_batch", str(max_batch),
                "--serve_batch_timeout_ms", str(timeout_ms),
            ]
        )
    )
    assert sync is None and bound == []
    return scorer, watcher, batcher


def _out(reply):
    assert "error" not in reply, reply
    out = reply["output"]
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("exports")
    return root, _export_jax(root, 1)


@pytest.mark.parametrize("length", [64, 1024])
def test_scorer_model_matches_the_jax_scorer(artifact, length):
    _, path = artifact
    features = {"tokens": _tokens(2, length, seed=length)}
    want = np.asarray(
        JaxScorerModel(path, model_zoo=JAX_ZOO).predict(features)
    )
    got = ScorerModel(path, device="cpu").predict(features)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_batcher_coalesces_and_each_reply_equals_its_solo_reply(artifact):
    root, _ = artifact
    scorer, watcher, batcher = _stack(root, max_batch=4)
    assert watcher.poll_once() == 1
    servicer = ScorerServicer(scorer, batcher=batcher)
    batcher.start()
    batches = profiling.metrics.counter("edl_scorer_batches_total")
    before = batches.value()
    rows = [1, 2, 1, 1, 3, 1]
    requests = [_tokens(n, seed=i) for i, n in enumerate(rows)]
    replies = [None] * len(rows)

    def one(i):
        replies[i] = servicer.score({"tokens": requests[i]})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.stop(drain=True)
        batcher.close()
    forwards = batches.value() - before
    assert 0 < forwards < len(rows)
    for req, reply in zip(requests, replies):
        solo, version = scorer.score({"tokens": req})
        assert reply["model_version"] == version == 1
        np.testing.assert_allclose(
            _out(reply), solo.numpy(), rtol=1e-5, atol=1e-5
        )
    scorer.close()


def test_watcher_hot_swaps_to_a_newer_version(tmp_path):
    scorer, watcher, _ = _stack(tmp_path, max_batch=0)
    _export_jax(tmp_path, 1, seed=0)
    assert watcher.poll_once() == 1
    servicer = ScorerServicer(scorer)
    req = {"tokens": _tokens(1)}
    first = servicer.score(req)
    assert first["model_version"] == 1
    _export_jax(tmp_path, 2, seed=1)
    assert watcher.poll_once() == 2
    assert watcher.poll_once() is None  # nothing newer
    second = servicer.score(req)
    assert second["model_version"] == 2
    assert not np.allclose(_out(first), _out(second))
    assert scorer.status()["swaps"] == 2
    assert ("edl_scorer_model_version", {}, 2) in profiling.metrics.collect()
    swaps = [e for e in profiling.events.tail(50)
             if e["kind"] == "scorer_model_swap"]
    assert (swaps[-1]["version"], swaps[-1]["previous"]) == (2, 1)
    scorer.close()
    assert ("edl_scorer_model_version", {}, 2) not in (
        profiling.metrics.collect()
    )


def test_model_def_resolves_against_a_zoo_directory(artifact, tmp_path):
    """``--model_zoo`` loads the module file from a directory instead of
    the port's own zoo package."""
    import shutil

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    _, path = artifact
    zoo = tmp_path / "zoo" / "transformer_lm"
    zoo.mkdir(parents=True)
    shutil.copy(tzoo.__file__, zoo / "transformer_lm.py")
    features = {"tokens": _tokens(1)}
    from_dir = ScorerModel(
        path, model_zoo=str(tmp_path / "zoo"), device="cpu"
    )
    assert type(from_dir.module).__module__ != tzoo.__name__
    np.testing.assert_array_equal(
        from_dir.predict(features).numpy(),
        ScorerModel(path, device="cpu").predict(features).numpy(),
    )


def test_error_replies(tmp_path):
    scorer, watcher, _ = _stack(tmp_path, max_batch=0)
    servicer = ScorerServicer(scorer)
    errors = profiling.metrics.counter(
        "edl_scorer_errors_total", labels=("kind",)
    )
    no_model = errors.value(kind="no_model")
    bad = errors.value(kind="bad_request")
    reply = servicer.score({"tokens": _tokens(1)})
    assert "no model" in reply["error"]
    assert errors.value(kind="no_model") == no_model + 1
    for req in ({}, {"_sctx": ["t", "s"]}):
        assert "no feature arrays" in servicer.score(req)["error"]
    assert errors.value(kind="bad_request") == bad + 2
    assert servicer.scorer_status({})["model_version"] == -1
    scorer.close()


def test_score_over_grpc_loopback(artifact):
    from elasticdl_tpu_torch.rpc.core import Client

    root, _ = artifact
    scorer, watcher, batcher = _stack(root, max_batch=4, timeout_ms=5)
    assert watcher.poll_once() == 1
    server = ScorerServer(scorer, port=0, batcher=batcher)
    client = Client("localhost:%d" % server.port, deadline_s=60)
    try:
        req = _tokens(2, seed=5)
        reply = client.call("score", tokens=req)
        assert reply["model_version"] == 1
        solo, _ = scorer.score({"tokens": req})
        np.testing.assert_allclose(
            _out(reply), solo.numpy(), rtol=1e-5, atol=1e-5
        )
        assert client.call("scorer_status")["model_version"] == 1
    finally:
        client.close()
        server.stop()
        scorer.close()


def test_bf16_reply_travels_as_bf16(tmp_path):
    from elasticdl_tpu_torch.common.convert import to_named
    from elasticdl_tpu_torch.common.export import (
        export_model,
        export_provenance,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.rpc.core import pack_message, unpack_message

    params = MODEL_PARAMS + ",dtype='bfloat16'"
    model = tzoo.init_parameters(
        tzoo.custom_model(**get_dict_from_params_str(params)),
        torch.Generator().manual_seed(0),
    )
    export_model(
        str(tmp_path / "v1"), to_named(model.state_dict(), 4, 16), 1,
        metadata=export_provenance("", MODEL_DEF, params),
    )
    scorer, watcher, _ = _stack(tmp_path, max_batch=0)
    assert watcher.poll_once() == 1
    reply = ScorerServicer(scorer).score({"tokens": _tokens(1)})
    assert reply["output"].dtype == torch.bfloat16
    wire = unpack_message(pack_message(reply))
    assert wire["output"].dtype == torch.bfloat16
    assert torch.equal(wire["output"], reply["output"])
    scorer.close()


def test_unported_planes_raise(tmp_path):
    base = ["--export_dir", str(tmp_path), "--device", "cpu"]
    # --ps_shm on builds: each PS channel negotiates at its first call
    scorer, _, sync, bound, _ = build_scorer(parse_scorer_args(
        base + ["--ps_addrs", "localhost:1", "--ps_shm", "on"]))
    assert sync is not None and len(bound) == 1
    assert bound[0].shm_channel is not None
    assert bound[0].shm_channel.state == "new"
    scorer.close()
    for channel in bound:
        channel.close()
    # the telemetry endpoint answers: loading before the first model
    scorer, _, _, _, batcher = build_scorer(
        parse_scorer_args(base + ["--scorer_telemetry_port", "0"])
    )
    server = ScorerServer(scorer, batcher=batcher, transport="socket",
                          telemetry_port=0)
    try:
        import urllib.error
        import urllib.request

        url = "http://127.0.0.1:%d" % server.telemetry_port
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/healthz", timeout=10)
        assert err.value.code == 503
        assert err.value.read().decode().strip() == "loading"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "edl_scorer_model_version" in r.read().decode()
    finally:
        server.stop()
        scorer.close()
    path = _export_jax(tmp_path, 1)
    manifest_path = os.path.join(path, "MANIFEST.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["artifacts"]["serving_fn"] = "serving_fn.jaxexport"
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    # a JAX member is not read: the model is rebuilt from model.chkpt,
    # as the reference serves an artifact without a member
    model = ScorerModel(path, device="cpu")
    assert model.exported.has_serving_fn() and not model.serves_member
    assert isinstance(model.module, torch.nn.Module)
    out = model.predict({"tokens": _tokens(2)})
    assert out.shape == (2, 64, VOCAB) and bool(torch.isfinite(out).all())


def test_scorer_args_parse_like_the_reference():
    from elasticdl_tpu.common.args import parse_scorer_args as jparse

    argv = [
        "--export_dir", "/x", "--port", "5", "--serve_max_batch", "8",
        "--serve_batch_timeout_ms", "3", "--serve_p99_slo_ms", "50",
        "--serve_queue_rows", "9", "--watch_interval_s", "0.5",
        "--hot_row_cache_rows", "7", "--serving_staleness_versions", "3",
        "--serving_sync_interval_s", "0.25", "--rpc_deadline_s", "5",
        "--rpc_retries", "1", "--ps_shm", "off", "--ps_addrs", "a:1,b:2",
    ]
    ours, ref = parse_scorer_args(argv), jparse(argv)
    for name, value in vars(ours).items():
        # the port's own: the device, and the wire for a host without grpc
        if name not in ("device", "scorer_transport"):
            assert getattr(ref, name) == value, name
    assert ours.device == "cuda" and ours.scorer_transport == "grpc"
    defaults = parse_scorer_args(["--export_dir", "/x"])
    assert vars(defaults).items() >= {
        "serving_staleness_versions": 2, "serving_sync_interval_s": 0.5,
        "hot_row_cache_rows": 65536, "rpc_deadline_s": 20.0,
        "rpc_retries": 3, "ps_shm": "auto", "ps_addrs": "",
    }.items()
    for name, value in vars(jparse(["--export_dir", "/x"])).items():
        assert getattr(defaults, name) == value, name


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_scorer_process_serves_and_drains_on_sigterm(artifact):
    from elasticdl_tpu_torch.rpc.core import Client

    root, _ = artifact
    port = _free_port()
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
            "--export_dir", str(root), "--device", "cpu",
            "--port", str(port), "--watch_interval_s", "0.2",
        ],
        cwd=REPO,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 120
        reply = {"error": "not started"}
        while "error" in reply and time.monotonic() < deadline:
            time.sleep(0.3)
            client = Client("localhost:%d" % port, deadline_s=30)
            try:
                reply = client.call("score", tokens=_tokens(1))
            except Exception as err:  # noqa: BLE001 — server still booting
                reply = {"error": str(err)}
            finally:
                client.close()
        assert reply.get("model_version") == 1, reply
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
