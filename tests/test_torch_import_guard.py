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
        print("imported", len(names))
        """
        % REPO
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    count = int(proc.stdout.split()[-1])
    # every module of the slices, packages included (master/, worker/,
    # metrics/ and the zoo's ResNet-50 and MNIST modules among them)
    assert count >= 63


def test_the_job_runs_with_jax_and_grpc_blocked(tmp_path):
    """CPU mnist jobs through the command-line entry, in a fresh
    interpreter where jax, grpc and the JAX package cannot be imported: a
    training job, one with evaluation rounds, and an evaluation-only job
    on the second one's checkpoints."""
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
           str(tmp_path), str(tmp_path))
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-1] == "4"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _build_cuda_scorer(tmp_path):
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.main import build_scorer

    return build_scorer(
        parse_scorer_args(["--export_dir", str(tmp_path), "--device", "cuda"])
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


def _cuda_prefetch(tmp_path):
    from elasticdl_tpu_torch.data.dataset import Dataset

    return Dataset.from_tensors([1]).device_prefetch("cuda")


@pytest.mark.parametrize(
    "entry",
    [_resolve_cuda, _build_cuda_scorer, _cuda_scorer_model, _cuda_trainer,
     _cuda_job, _cuda_eval_job, _cuda_prefetch],
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
