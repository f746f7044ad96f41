"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package (and the job path nothing of gRPC, which the card's machine
lacks), and it never drifts onto the CPU when the card is asked for."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
           "elasticdl_tpu", "model_zoo", "grpc")

# A meta-path finder that refuses the blocked top-level packages; run
# first in a fresh interpreter, before anything else is imported.
BLOCKER = textwrap.dedent(
    """
    import sys

    BLOCKED = %r

    class _Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in BLOCKED:
                raise ImportError("blocked import of %%s" %% name)
            return None

    sys.meta_path.insert(0, _Block())
    """
) % (BLOCKED,)


def _run_blocked(body, cwd=REPO, env=None):
    code = BLOCKER + textwrap.dedent(body)
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=cwd,
        capture_output=True,
        text=True,
        timeout=240,
        env=env,
    )


def test_every_port_module_imports_without_jax():
    proc = _run_blocked(
        """
        import importlib, pkgutil
        sys.path.insert(0, %r)
        import elasticdl_tpu_torch
        names = ["elasticdl_tpu_torch"]
        for info in pkgutil.walk_packages(
            elasticdl_tpu_torch.__path__, "elasticdl_tpu_torch."
        ):
            names.append(info.name)
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED
        )
        assert not leaked, leaked
        print(" ".join(names))
        print("imported", len(names))
        """
        % REPO
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    count = int(proc.stdout.split()[-1])
    # every module of the slices, packages included (master/, worker/,
    # metrics/, the zoo's ResNet-50 and MNIST modules, the elastic job's
    # socket transport, membership, instance manager, process groups,
    # elastic trainer and worker entry, and the master's journal and the
    # failover channel among them, the zoo that needs no PS fleet with the
    # one-card HBM embedding plane, the master-held model's store,
    # elastic embedding layer and parameter-server worker, and the PS
    # fleet's shard, snapshots, client, placement hashing, compressed
    # wire and master entry)
    assert count >= 109
    for name in ("master.journal", "rpc.failover", "nn.hbm_embedding",
                 "rpc.shm_transport", "rpc.socket_transport", "rpc.core",
                 "common.tensor", "master.rpc_service", "master.master",
                 "worker.main", "serving.server", "serving.main",
                 "ps.device_store",
                 "ps.servicer", "ps.parameter_server", "ps.snapshot",
                 "ps.main", "worker.ps_client", "common.hash_utils",
                 "rpc.wire_compression", "master.main",
                 "ps.embedding_table", "ps.parameters",
                 "ps.optimizer_wrapper", "master.learning_rate_modulator",
                 "nn.embedding",
                 "worker.worker", "ps.delta_log", "serving.delta_sync",
                 "nn.comm_plane", "parallel.mesh", "parallel.sharding",
                 # the pjit dense plane's solver, elastic trainer and
                 # parts of the checkpoint it restores
                 "parallel.layout_solver", "parallel.elastic",
                 "parallel.spmd", "parallel.collectives",
                 "common.sharded_checkpoint",
                 # the collective plane's dedup and its routed tables
                 "nn.sparse_comms", "worker.elastic_allreduce_worker",
                 "training.step",
                 "model_zoo.mnist_functional_api.mnist_functional_api",
                 "model_zoo.cifar10_subclass.cifar10_subclass",
                 "model_zoo.cifar10_functional_api.cifar10_functional_api",
                 "model_zoo.resnet50_subclass.resnet50_subclass",
                 "model_zoo.deepfm_functional_api.deepfm_functional_api",
                 "model_zoo.deepfm_edl_embedding.deepfm_edl_embedding",
                 # the telemetry plane
                 "utils.profiling", "common.tb_events",
                 "master.tensorboard_service", "master.telemetry",
                 "worker.telemetry", "tools.tracetool"):
        assert "elasticdl_tpu_torch." + name in proc.stdout.split(), name


def test_the_job_runs_with_jax_and_grpc_blocked(tmp_path):
    """CPU mnist jobs through the command-line entry, in a fresh
    interpreter where jax, grpc and the JAX package cannot be imported: a
    training job (its artifact's serving member served), one with
    evaluation rounds, and an evaluation-only job on the second one's
    checkpoints."""
    proc = _run_blocked(
        """
        import os
        import numpy as np
        sys.path.insert(0, %r)
        from elasticdl_tpu_torch import cli
        from elasticdl_tpu_torch.data.example import encode_example
        from elasticdl_tpu_torch.data.recordio import RecordIOWriter
        data = os.path.join(%r, "data")
        os.makedirs(data)
        rng = np.random.default_rng(0)
        with RecordIOWriter(os.path.join(data, "f0")) as w:
            for _ in range(32):
                w.write(encode_example({
                    "image": rng.random(784, dtype=np.float32) * 255,
                    "label": np.array([rng.integers(0, 10)], np.int64),
                }))
        jobs = []
        rc = cli.main([
            "train", "--job_name", "j", "--distribution_strategy",
            "AllreduceStrategy", "--num_workers", "0", "--model_zoo", "",
            "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
            "--training_data", data, "--minibatch_size", "8",
            "--checkpoint_dir", os.path.join(%r, "ckpt"),
            "--checkpoint_steps", "2", "--output", os.path.join(%r, "out"),
            "--device", "cpu",
        ], jobs=jobs)
        leaked = sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED
        )
        assert not leaked, leaked
        assert rc == 0 and jobs[0].worker.trainer.version == 4
        # its artifact's serving member, served without the zoo's source
        import glob
        from elasticdl_tpu_torch.common.export import load_export
        (manifest,) = glob.glob(os.path.join(%r, "out", "*", "MANIFEST.json"))
        exported = load_export(os.path.dirname(manifest))
        assert exported.has_torch_serving_fn()
        served = exported.serve(
            {"image": np.zeros((3, 28, 28), np.float32)}, "cpu")
        assert tuple(served.shape) == (3, 10)
        # with evaluation rounds, then evaluation-only on its checkpoints
        rc = cli.main([
            "train", "--job_name", "j", "--distribution_strategy",
            "AllreduceStrategy", "--num_workers", "0", "--model_zoo", "",
            "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
            "--training_data", data, "--validation_data", data,
            "--evaluation_steps", "2", "--minibatch_size", "8",
            "--checkpoint_dir", os.path.join(%r, "ckpt2"),
            "--checkpoint_steps", "2", "--device", "cpu",
        ], jobs=jobs)
        rounds = jobs[1].master.evaluation_service.published
        assert rc == 0 and [r["version"] for r in rounds] == [2, 4], rounds
        rc = cli.main([
            "evaluate", "--job_name", "j", "--distribution_strategy",
            "AllreduceStrategy", "--model_zoo", "",
            "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
            "--validation_data", data, "--minibatch_size", "8",
            "--checkpoint_dir", os.path.join(%r, "ckpt2"), "--device", "cpu",
        ], jobs=jobs)
        scored = jobs[2].master.evaluation_service.published
        assert rc == 0 and scored[0]["scored_versions"] == [4], scored
        leaked = sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED
        )
        assert not leaked, leaked
        print("version", jobs[0].worker.trainer.version)
        """
        % (REPO, str(tmp_path), str(tmp_path), str(tmp_path),
           str(tmp_path), str(tmp_path), str(tmp_path))
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-1] == "4"


def test_the_multi_process_job_runs_with_jax_and_grpc_blocked(tmp_path):
    """``--num_workers 2`` on the CPU: the master in a blocked
    interpreter, and each ``worker.main`` process blocked the same way
    (its command line runs the blocker first), over the socket plane;
    with the master's journal, a parked standby and evaluation rounds."""
    proc = _run_blocked(
        """
        import os, runpy
        import numpy as np
        sys.path.insert(0, %r)
        from elasticdl_tpu_torch import api, cli
        from elasticdl_tpu_torch.data.example import encode_example
        from elasticdl_tpu_torch.data.recordio import RecordIOWriter
        BLOCKER = %r

        def blocked_worker(self, worker_id, device,
                           _orig=api.LocalJob._worker_command):
            argv = _orig(self, worker_id, device)
            code = BLOCKER + (
                "import runpy; sys.argv = ['worker'] + %%r + sys.argv[1:]; "
                "runpy.run_module('elasticdl_tpu_torch.worker.main', "
                "run_name='__main__')" %% (argv[3:],)
            )
            return [sys.executable, "-c", code]

        api.LocalJob._worker_command = blocked_worker
        data = os.path.join(%r, "data")
        os.makedirs(data)
        rng = np.random.default_rng(0)
        # twice the zoo's 1024-record shuffle buffer: the first worker's
        # buffer and prefetch cannot take every task, so both get data
        with RecordIOWriter(os.path.join(data, "f0")) as w:
            for _ in range(2048):
                w.write(encode_example({
                    "image": rng.random(784, dtype=np.float32) * 255,
                    "label": np.array([rng.integers(0, 10)], np.int64),
                }))
        val = os.path.join(%r, "val")
        os.makedirs(val)
        with RecordIOWriter(os.path.join(val, "f0")) as w:
            for _ in range(64):
                w.write(encode_example({
                    "image": rng.random(784, dtype=np.float32) * 255,
                    "label": np.array([rng.integers(0, 10)], np.int64),
                }))
        jobs = []
        rc = cli.main([
            "train", "--job_name", "j", "--distribution_strategy",
            "AllreduceStrategy", "--num_workers", "2", "--model_zoo", "",
            "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
            "--training_data", data, "--minibatch_size", "16",
            "--num_minibatches_per_task", "2", "--device", "cpu",
            "--log_level", "WARNING", "--num_standby_workers", "1",
            "--master_journal_dir", os.path.join(%r, "journal"),
            "--validation_data", val, "--evaluation_steps", "32",
        ], jobs=jobs)
        master = jobs[0].master
        codes = master.instance_manager.exit_codes
        assert rc == 0 and codes == {0: 0, 1: 0}, codes
        assert master.task_d.finished()
        assert master.instance_manager.standby_exit_codes  # stopped
        assert master.evaluation_service.published
        from elasticdl_tpu_torch.master.journal import MasterJournal
        state = MasterJournal(os.path.join(%r, "journal")).replay()
        assert state.counters["done"] > 0 and not state.pending
        leaked = sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED
        )
        assert not leaked, leaked
        print("version", jobs[0].master.master_servicer.get_model_version())
        """
        % (REPO, BLOCKER, str(tmp_path), str(tmp_path), str(tmp_path),
           str(tmp_path)),
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) > 0


def test_the_parameter_server_job_runs_with_jax_and_grpc_blocked(tmp_path):
    """The ParameterServerStrategy job (no strategy flag) with two worker
    processes on the CPU, the master and each worker in a blocked
    interpreter: DeepFM's tables in the master's store."""
    proc = _run_blocked(
        """
        import os
        import numpy as np
        sys.path.insert(0, %r)
        from elasticdl_tpu_torch import api, cli
        from elasticdl_tpu_torch.data.example import encode_example
        from elasticdl_tpu_torch.data.recordio import RecordIOWriter
        BLOCKER = %r

        def blocked_worker(self, worker_id, device,
                           _orig=api.LocalJob._worker_command):
            argv = _orig(self, worker_id, device)
            code = BLOCKER + (
                "import runpy; sys.argv = ['worker'] + %%r + sys.argv[1:]; "
                "runpy.run_module('elasticdl_tpu_torch.worker.main', "
                "run_name='__main__')" %% (argv[3:],)
            )
            return [sys.executable, "-c", code]

        api.LocalJob._worker_command = blocked_worker
        data = os.path.join(%r, "data")
        os.makedirs(data)
        rng = np.random.default_rng(0)
        with RecordIOWriter(os.path.join(data, "f0")) as w:
            for _ in range(512):
                w.write(encode_example({
                    "feature": rng.integers(0, 2000, 10).astype(np.int64),
                    "label": np.array([rng.integers(0, 2)], np.int64),
                }))
        jobs = []
        rc = cli.main([
            "train", "--job_name", "j", "--model_zoo", "",
            "--model_def",
            "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
            "--model_params", "embedding_dim=8,fc_unit=8",
            "--training_data", data, "--minibatch_size", "32",
            "--num_workers", "2", "--device", "cpu",
            "--log_level", "WARNING",
        ], jobs=jobs)
        master = jobs[0].master
        codes = master.instance_manager.exit_codes
        assert rc == 0 and codes == {0: 0, 1: 0}, codes
        assert master.task_d.finished()
        store = master.master_servicer.embedding_store.embedding_params
        assert sorted(store) == ["embedding", "id_bias"]
        assert len(store["embedding"]) > 1000
        leaked = sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED
        )
        assert not leaked, leaked
        print("version", master.master_servicer.get_model_version())
        """
        % (REPO, BLOCKER, str(tmp_path)),
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # sync SGD: a stale report is run again, so every batch lands once
    assert int(proc.stdout.split()[-1]) == 512 // 32


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _build_cuda_scorer(tmp_path):
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.main import build_scorer

    return build_scorer(
        parse_scorer_args(["--export_dir", str(tmp_path), "--device", "cuda"])
    )


def _build_cuda_ps_scorer(tmp_path):
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.main import build_scorer

    return build_scorer(
        parse_scorer_args(["--export_dir", str(tmp_path), "--ps_addrs",
                           "localhost:1,localhost:2"])
    )


def _cuda_scorer_model(tmp_path):
    from elasticdl_tpu_torch.serving.scorer import ScorerModel

    return ScorerModel(str(tmp_path), device="cuda")


def _resolve_cuda(tmp_path):
    from elasticdl_tpu_torch.common.device import resolve_device

    return resolve_device("cuda")


def _cuda_trainer(tmp_path):
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    return AllReduceTrainer(zoo.custom_model(), zoo.loss, zoo.optimizer())


def _cuda_job(tmp_path):
    from elasticdl_tpu_torch import cli

    (tmp_path / "data").mkdir()
    return cli.main([
        "train", "--job_name", "j", "--distribution_strategy",
        "AllreduceStrategy", "--num_workers", "0", "--model_zoo", "",
        "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
        "--training_data", str(tmp_path / "data"), "--minibatch_size", "8",
    ])


def _cuda_eval_job(tmp_path):
    from elasticdl_tpu_torch import cli

    (tmp_path / "data").mkdir()
    return cli.main([
        "evaluate", "--job_name", "j", "--distribution_strategy",
        "AllreduceStrategy", "--model_zoo", "",
        "--model_def", "mnist_subclass.mnist_subclass.CustomModel",
        "--validation_data", str(tmp_path / "data"),
        "--checkpoint_dir", str(tmp_path), "--minibatch_size", "8",
    ])


def _cuda_ps_shard(tmp_path):
    from elasticdl_tpu_torch.ps.parameter_server import main

    return main(["--ps_id", "0", "--port", "1", "--model_zoo", "",
                 "--model_def",
                 "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"])


def _cuda_fleet_worker(tmp_path):
    from elasticdl_tpu_torch.worker.main import main

    return main(["--worker_id", "0", "--job_type", "training_only",
                 "--master_addr", "localhost:1", "--ps_addrs",
                 "localhost:2,localhost:3", "--model_zoo", "",
                 "--model_def",
                 "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
                 "--minibatch_size", "8"])


def _cuda_prefetch(tmp_path):
    from elasticdl_tpu_torch.data.dataset import Dataset

    return Dataset.from_tensors([1]).device_prefetch("cuda")


@pytest.mark.parametrize(
    "entry",
    [_resolve_cuda, _build_cuda_scorer, _build_cuda_ps_scorer,
     _cuda_scorer_model, _cuda_trainer,
     _cuda_job, _cuda_eval_job, _cuda_prefetch, _cuda_ps_shard,
     _cuda_fleet_worker],
)
def test_cuda_without_a_card_raises(no_card, tmp_path, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tmp_path)


def test_cpu_is_taken_only_when_named():
    from elasticdl_tpu_torch.common.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_chip_smoke_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_blocked(
        """
        sys.argv = ["chip_smoke.py"]
        sys.path.insert(0, %r)
        import chip_smoke
        sys.exit(chip_smoke.main([]))
        """
        % REPO,
        env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
