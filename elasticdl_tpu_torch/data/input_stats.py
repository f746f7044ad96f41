"""Per-stage counters of the worker's input plane, the counterpart of
``elasticdl_tpu/data/input_stats.py``.

One ``InputPlaneStats`` object rides a whole dataset round: the task
data service charges task starvation, record reads and acks,
``Dataset.map`` charges parse time, ``Dataset.batch`` batch assembly,
``Dataset.prefetch`` the time its consumer waited on an empty buffer and
``Dataset.device_prefetch`` the host time of its copies to the card.
Parse time aggregates across decode threads (CPU-seconds, not a
latency).
"""

import threading
import time


class InputPlaneStats:
    """Thread-safe additive counters for the input pipeline stages."""

    TIME_FIELDS = (
        "task_starved_s",
        "read_s",
        "parse_s",
        "batch_s",
        "consumer_starved_s",
        "ack_s",
        "h2d_s",
    )
    COUNT_FIELDS = ("tasks", "records", "batches")

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self.reset()

    def reset(self):
        with self._lock:
            for f in self.TIME_FIELDS + self.COUNT_FIELDS:
                self._values[f] = 0.0 if f in self.TIME_FIELDS else 0

    def add(self, field, seconds):
        with self._lock:
            self._values[field] += seconds

    def count(self, field, n=1):
        with self._lock:
            self._values[field] += n

    def timed(self, field):
        """Context manager charging its body's wall time to ``field``."""
        return _Timed(self, field)

    def snapshot(self):
        with self._lock:
            return dict(self._values)


class _Timed:
    def __init__(self, stats, field):
        self._stats = stats
        self._field = field

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stats.add(self._field, time.perf_counter() - self._t0)
        return False
