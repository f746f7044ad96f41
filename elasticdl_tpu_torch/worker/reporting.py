"""Shared worker-side report helpers, the counterpart of
``elasticdl_tpu/worker/reporting.py``."""

from elasticdl_tpu_torch.common.constants import TaskExecCounterKey


def with_model_version(trainer, exec_counters):
    """Piggyback the trainer's model version onto task-report counters so
    the coordinating (ALLREDUCE) master, which applies no gradients,
    follows it. Best-effort: a failure path must still report."""
    try:
        version = trainer.version
    except Exception:  # noqa: BLE001 - failure paths must still report
        version = -1
    if version >= 0:
        exec_counters = dict(exec_counters or {})
        exec_counters.setdefault(TaskExecCounterKey.MODEL_VERSION, version)
    return exec_counters
