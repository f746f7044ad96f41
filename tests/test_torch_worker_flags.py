"""How the port's worker entry points treat flags that a plane ignores
or lacks, against the reference's ``worker/main.py`` and ``api.py``:

- ``--standby`` under the parameter-server strategy is logged and has no
  effect (the reference's PS branch never reads it);
- ``--grad_accum_steps`` and ``--remat`` on a PS worker draw the
  reference's ``warn_accum_unsupported`` warning, at the worker process
  and at the in-process PS worker of ``api.py``;
- ``--speculative_compile true`` raises by name (the compile plane is
  unported, ROADMAP A9.2.2).
"""

import logging

import pytest

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.worker import main as worker_main

PS_ARGV = [
    "--worker_id", "3", "--job_type", "training_only", "--master_addr",
    "localhost:1", "--model_zoo", "", "--model_def",
    "mnist_subclass.mnist_subclass.CustomModel", "--minibatch_size", "8",
    "--device", "cpu",
]


@pytest.fixture
def log(caplog):
    """The port's logger, captured (it does not propagate)."""
    default_logger.addHandler(caplog.handler)
    caplog.set_level(logging.INFO)
    try:
        yield caplog
    finally:
        default_logger.removeHandler(caplog.handler)


@pytest.fixture
def ran(monkeypatch):
    """The PS worker process's master channel, shard client and worker,
    stubbed: records the worker ids that ran."""
    ran = []

    class _Worker:
        def __init__(self, args):
            self._id = args.worker_id

        def run(self):
            ran.append(self._id)

    class _Stub:
        def close(self):
            pass

    monkeypatch.setattr(worker_main, "master_client", lambda args: _Stub())
    monkeypatch.setattr(worker_main, "make_ps_client", lambda args: None)
    monkeypatch.setattr(worker_main, "ps_worker",
                        lambda args, stub, client: _Worker(args))
    return ran


def test_a_ps_worker_runs_with_standby_set_and_logs_it(ran, log):
    assert worker_main.main(PS_ARGV + ["--standby", "true"]) == 0
    assert ran == [3]
    assert "--standby has no effect under ParameterServerStrategy" in (
        log.text)


def _frappe(directory, n=64, vocab=300):
    """``n`` DeepFM records (10 ids and a 0/1 label) in one file."""
    import os

    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    with RecordIOWriter(os.path.join(directory, "f0")) as w:
        for _ in range(n):
            w.write(encode_example({
                "feature": rng.integers(1, vocab, 10).astype(np.int64),
                "label": np.array([rng.integers(0, 2)], np.int64),
            }))


@pytest.mark.parametrize("site", ["worker_process", "in_process"])
def test_a_ps_worker_warns_that_it_ignores_accumulation_and_remat(
        site, ran, log, tmp_path):
    flags = ["--grad_accum_steps", "2", "--remat", "full"]
    if site == "worker_process":
        assert worker_main.main(PS_ARGV + flags) == 0
        assert ran == [3]
        plane = "the parameter-server worker"
    else:
        from elasticdl_tpu_torch import cli

        _frappe(str(tmp_path / "data"))
        assert cli.main([
            "train", "--job_name", "j", "--model_zoo", "", "--model_def",
            "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
            "--model_params", "embedding_dim=8,fc_unit=8",
            "--training_data", str(tmp_path / "data"),
            "--minibatch_size", "32", "--device", "cpu"] + flags) == 0
        plane = "the in-process PS worker"
    assert ("--grad_accum_steps=2 is only honored by the ALLREDUCE "
            "strategy (single- and multi-process); %s runs WITHOUT "
            "gradient accumulation" % plane) in log.text
    assert "--remat=full is only honored by the ALLREDUCE strategy; %s" % (
        plane) in log.text


@pytest.mark.parametrize("strategy", ["AllreduceStrategy",
                                      "ParameterServerStrategy"])
def test_speculative_compile_raises_by_name(strategy, tmp_path):
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.master import Master

    _frappe(str(tmp_path / "data"))
    argv = [
        "--job_name", "j", "--model_zoo", "", "--model_def",
        "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
        "--training_data", str(tmp_path / "data"), "--minibatch_size", "8",
        "--distribution_strategy", strategy, "--device", "cpu",
    ]
    with pytest.raises(NotImplementedError, match=(
            r"speculative compile plane \(ROADMAP A9\.2\.2\) is not ported yet "
            r"\(asked for by --speculative_compile\)")):
        Master(parse_master_args(argv + ["--speculative_compile", "true"]))
    # off (the default) is no request
    Master(parse_master_args(argv + ["--speculative_compile", "false"]))
