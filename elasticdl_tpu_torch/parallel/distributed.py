"""Multi-process world lifecycle over ``torch.distributed``, the
counterpart of ``elasticdl_tpu/parallel/distributed.py``.

A world is one default process group. Elasticity re-forms it whenever
the membership changes, so a membership epoch is::

    leave_world()  ->  ensure_world(new_spec, device)

``leave_world`` destroys the process group; ``ensure_world`` forms the
next one against a fresh ``TCPStore`` that rank 0 hosts at the epoch's
coordinator address (the master hands out a new port each epoch, so a
store of an earlier world is never mistaken for this one). The train
state stays on its device across the re-form; ``parallel/elastic.py``
re-broadcasts it from rank 0.

The backend follows from the device each rank was placed on, so every
rank computes the same answer (:func:`choose_backend`): CPU tensors form a
gloo world (the tests; the counterpart of the reference's
``EDL_DIST_PLATFORM=cpu``), CUDA tensors an NCCL world only when each rank
has a card of its own, and otherwise a gloo world over the CUDA tensors:
NCCL refuses two ranks of one communicator on one device, so worker
processes that share one card form a gloo world. A rank owns its card
when its device names one (``cuda:<i>``); the local instance manager
places its workers so (``worker_devices``): a card each when there are
enough, else ``cuda`` for all of them. The choice is logged and
returned.

A dead peer must surface on the survivors within seconds, as the
reference's ``jax_enable_recoverability`` makes it: a killed process's
sockets close and the survivors' collective raises at once; a hung one
is bounded by the process group's timeout (the step deadline). Either
way the caller sees :class:`WorldBroken`.
"""

import datetime
import os
from dataclasses import dataclass

from elasticdl_tpu_torch.common.log_utils import default_logger as logger


@dataclass(frozen=True)
class WorldSpec:
    """One membership epoch's process world."""

    coordinator: str  # host:port of rank 0's store
    num_processes: int
    process_id: int
    epoch: int


class WorldBroken(RuntimeError):
    """A collective or formation failure that requires re-forming."""


# Must stay below the master's confirm window (MembershipService's
# confirm_timeout_secs derives from it): a member stuck forming a stale
# world has to fail fast and re-poll before the master declares it
# wedged. Healthy formations take well under a second.
DEFAULT_WORLD_INIT_TIMEOUT = 10

# How long a collective waits for its slowest peer before the world is
# declared broken: a live peer may still be inside its own step (a
# joiner's first step pays its warm-up), so this is the step's deadline,
# not the formation timeout.
STEP_DEADLINE_S = 120


def world_init_timeout():
    return int(
        os.environ.get(
            "EDL_WORLD_INIT_TIMEOUT", str(DEFAULT_WORLD_INIT_TIMEOUT)
        )
    )


_active = None  # (spec, backend, store)


def current_spec():
    return _active[0] if _active is not None else None


def choose_backend(device):
    """``"nccl"`` for a rank placed on a card of its own (a ``cuda:<i>``
    ``torch.device``), ``"gloo"`` for the CPU and for ranks that share a
    card (a bare ``cuda``). Every rank of one job is placed the same way
    (see :func:`worker_devices`), so all of them choose alike."""
    if device.type == "cuda" and device.index is not None:
        return "nccl"
    return "gloo"


def worker_devices(device, num_workers):
    """The device of each of ``num_workers`` worker slots on this host
    for a job on ``device`` (a string): a card each (``cuda:0``,
    ``cuda:1``, ...) when the host has that many, else the bare ``cuda``
    for all of them (a shared card, the current one of each process);
    other devices unchanged. A card named by index cannot hold several
    workers of one world, so it is refused for more than one."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [device] * num_workers
    if dev.index is not None:
        if num_workers > 1:
            raise ValueError(
                "--device %s names one card; a job of %d workers places "
                "them itself: pass --device cuda" % (device, num_workers)
            )
        return [device]
    if num_workers <= torch.cuda.device_count():
        return ["cuda:%d" % i for i in range(num_workers)]
    return ["cuda"] * num_workers


def ensure_world(spec, device):
    """Join (or re-join) the world of ``spec``; returns its backend.

    Rank 0 hosts the store at ``spec.coordinator``; the others connect to
    it. Formation waits at most :func:`world_init_timeout` for the peers,
    and raises :class:`WorldBroken` when they do not all arrive, so the
    caller re-polls the master for a fresher epoch."""
    global _active
    if _active is not None and _active[0] == spec:
        return _active[1]
    if _active is not None:
        leave_world()
    import torch
    import torch.distributed as dist

    backend = choose_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
    host, _, port = spec.coordinator.rpartition(":")
    init_timeout = datetime.timedelta(seconds=world_init_timeout())
    logger.info(
        "joining world epoch=%d rank=%d/%d coordinator=%s backend=%s",
        spec.epoch,
        spec.process_id,
        spec.num_processes,
        spec.coordinator,
        backend,
    )
    store = None
    try:
        store = dist.TCPStore(
            host,
            int(port),
            spec.num_processes,
            is_master=spec.process_id == 0,
            timeout=init_timeout,
            wait_for_workers=False,
        )
        dist.init_process_group(
            backend,
            store=store,
            rank=spec.process_id,
            world_size=spec.num_processes,
            timeout=datetime.timedelta(
                seconds=max(world_init_timeout(), STEP_DEADLINE_S)
            ),
        )
    except Exception as e:
        if dist.is_initialized():
            dist.destroy_process_group()
        del store
        raise WorldBroken(
            "could not form world epoch %d (%s)" % (spec.epoch, e)
        ) from e
    _active = (spec, backend, store)
    logger.info("world epoch=%d formed on %s", spec.epoch, backend)
    return backend


def leave_world():
    """Leave the current world: destroy the process group and drop the
    store (rank 0's server closes with it)."""
    global _active
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        logger.warning("destroy_process_group failed", exc_info=True)
    _active = None
