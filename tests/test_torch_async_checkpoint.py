"""Asynchronous checkpoint writes of the port
(``elasticdl_tpu_torch/common/async_checkpoint.py`` and
``ShardedCheckpointManager(async_io=True)``), against the contracts of
``tests/test_async_checkpoint.py``:

- the background writer runs jobs in submission order, relays the first
  error at the next ``submit``/``wait`` and then clears it, bounds its
  queue, and drains on ``close`` (after which ``submit`` raises);
- a checkpoint written asynchronously is byte-identical, file by file,
  to one written synchronously, restores bitwise, and keeps the ring
  retention; a parameter updated in place right after ``save`` returns
  does not reach it (the snapshot is taken before ``save`` returns);
- the single-process ``AllReduceWorker`` still writes synchronously, as
  the reference's does.

The train state is the MNIST CNN's after one SGD step with momentum, on
the CPU (the pinned copies of the card path are held by
``chip_smoke.py``'s elastic phase).
"""

import functools
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common.async_checkpoint import AsyncCheckpointer
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.sharded_checkpoint import (
    ShardedCheckpointManager,
    load_sharded_to_host,
    train_state_leaves,
)
from elasticdl_tpu_torch.model_zoo.mnist_subclass import mnist_subclass as zoo
from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")


class TestAsyncCheckpointer:
    def test_jobs_run_in_submission_order(self):
        ckpt = AsyncCheckpointer()
        seen = []
        gate = threading.Event()

        def first():
            gate.wait(5)
            seen.append(1)

        ckpt.submit(first)
        ckpt.submit(lambda: seen.append(2))
        ckpt.submit(lambda: seen.append(3))
        gate.set()
        ckpt.wait()
        assert seen == [1, 2, 3]
        ckpt.close()

    def test_worker_error_reraised_on_next_submit_then_cleared(self):
        ckpt = AsyncCheckpointer()

        def boom():
            raise IOError("disk gone")

        ckpt.submit(boom)
        ckpt._queue.join()
        with pytest.raises(IOError, match="disk gone"):
            ckpt.submit(lambda: None)
        done = []
        ckpt.submit(lambda: done.append(True))
        ckpt.wait()
        assert done == [True]
        ckpt.close()

    def test_wait_reraises_and_close_rejects_submit(self):
        ckpt = AsyncCheckpointer()

        def boom():
            raise ValueError("bad write")

        ckpt.submit(boom)
        with pytest.raises(ValueError, match="bad write"):
            ckpt.wait()
        ckpt.close()
        with pytest.raises(RuntimeError):
            ckpt.submit(lambda: None)

    def test_max_pending_bounds_queue(self):
        ckpt = AsyncCheckpointer(max_pending=1)
        release = threading.Event()
        started = threading.Event()

        def slow():
            started.set()
            release.wait(5)

        ckpt.submit(slow)
        started.wait(5)
        ckpt.submit(lambda: None)  # fills the single queue slot
        blocker = threading.Thread(target=lambda: ckpt.submit(lambda: None))
        blocker.start()
        blocker.join(0.2)
        assert blocker.is_alive(), "a third submit should block on the bound"
        release.set()
        blocker.join(5)
        assert not blocker.is_alive()
        ckpt.close()

    def test_close_drains_outstanding_jobs(self):
        ckpt = AsyncCheckpointer()
        done = []

        def slow(i):
            time.sleep(0.05)
            done.append(i)

        for i in range(3):
            ckpt.submit(functools.partial(slow, i))
        ckpt.close()
        assert done == [0, 1, 2]


def _sgd_momentum(params):
    return torch.optim.SGD(params, lr=0.01, momentum=0.9)


def _trained_trainer(seed=0):
    """The MNIST CNN after one SGD-with-momentum step: params, and a
    momentum buffer per parameter."""
    trainer = AllReduceTrainer(
        zoo.CustomModel(), zoo.loss, _sgd_momentum, seed=seed, device="cpu"
    )
    rng = np.random.default_rng(seed)
    features = {"image": rng.random((8, 28, 28), dtype=np.float32)}
    labels = rng.integers(0, 10, (8, 1)).astype(np.int32)
    trainer.train_step(features, labels)
    return trainer


def _files(directory):
    return {
        os.path.basename(p): open(p, "rb").read()
        for p in sorted(glob.glob(os.path.join(directory, "*")))
    }


def test_async_files_are_byte_identical_to_sync(tmp_path):
    ts = _trained_trainer().train_state
    sync = ShardedCheckpointManager(str(tmp_path / "sync"), 1)
    asyn = ShardedCheckpointManager(str(tmp_path / "async"), 1,
                                    async_io=True)
    d_sync = sync.save(ts, 3)
    d_async = asyn.save(ts, 3)
    asyn.wait()
    a, b = _files(d_sync), _files(d_async)
    assert sorted(a) == sorted(b)
    # params, the momentum buffers and the version, plus the manifest
    assert len(a) == len(train_state_leaves(ts)) + 1
    for name in a:
        assert a[name] == b[name], name
    assert set(asyn.write_seconds) == {3}
    asyn.close()


def test_async_checkpoint_restores_bitwise(tmp_path):
    trainer = _trained_trainer()
    mgr = ShardedCheckpointManager(str(tmp_path), 1, async_io=True)
    directory = mgr.save(trainer.train_state, trainer.version)
    mgr.close()
    fresh = AllReduceTrainer(
        zoo.CustomModel(), zoo.loss, _sgd_momentum, seed=5, device="cpu"
    )
    fresh.init_from_batch(None)
    assert fresh.restore_sharded(directory) == trainer.version == 1
    want = train_state_leaves(trainer.train_state)
    got = train_state_leaves(fresh.train_state)
    assert sorted(got) == sorted(want)
    assert any("momentum_buffer" in k for k in got)
    for k in want:
        assert torch.equal(got[k].detach(), want[k].detach()), k


def test_in_place_update_after_save_does_not_reach_the_checkpoint(tmp_path):
    ts = _trained_trainer().train_state
    before = {k: v.detach().clone() for k, v in train_state_leaves(ts).items()}
    mgr = ShardedCheckpointManager(str(tmp_path), 1, async_io=True)
    gate = threading.Event()
    # hold the writer so every file is written after the updates below
    mgr._async.submit(lambda: gate.wait(5))
    directory = mgr.save(ts, 7)
    with torch.no_grad():
        for p in ts.params.values():
            p.add_(1.0)
    for slots in ts.opt_state.state.values():
        slots["momentum_buffer"].mul_(-3.0)
    gate.set()
    mgr.close()
    version, leaves = load_sharded_to_host(directory)
    assert version == 7
    for k, want in before.items():
        if k == "version":
            continue
        assert torch.equal(leaves[k], want), k


def test_async_ring_keeps_the_newest(tmp_path):
    trainer = _trained_trainer()
    mgr = ShardedCheckpointManager(str(tmp_path), 1, keep_max=2,
                                   async_io=True)
    mgr.set_expected_writers(1)
    for version in (1, 2, 3):
        mgr.save(trainer.train_state, version)
    mgr.wait()
    assert mgr.versions() == [2, 3]
    mgr.close()


def test_a_failing_async_write_surfaces_at_wait(tmp_path):
    trainer = _trained_trainer()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = ShardedCheckpointManager(str(blocker), 1, async_io=True)
    mgr.save(trainer.train_state, 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()


def test_allreduce_worker_still_writes_synchronously(tmp_path):
    worker = AllReduceWorker(
        worker_id=0, job_type=JobType.TRAINING_ONLY, minibatch_size=8,
        model_zoo=PORT_ZOO, model_def="mnist_subclass.mnist_subclass."
        "CustomModel", checkpoint_dir=str(tmp_path), checkpoint_steps=2,
        device="cpu",
    )
    assert worker._ckpt._async is None
