"""Worker-side telemetry: compact snapshots piggybacked to the master;
the port of ``elasticdl_tpu/worker/telemetry.py``.

:class:`WorkerTelemetry` rides the worker's existing master channel —
the worker calls :meth:`on_batch` once per consumed minibatch (two
integer adds, no lock — the consumer loop is the only writer) and
:meth:`maybe_snapshot` behind every task report (snapshot assembly is
serialized internally: acks also fire from the input plane's
prefetcher threads). When the report
interval has elapsed, ``maybe_snapshot`` builds one JSON-safe dict:

- ``steps_per_sec`` / ``examples_per_sec`` over the interval,
- the :class:`InputPlaneStats` counters (mid-epoch — the worker's own
  boundary log only fires at stream ends, so a stalled stream is
  visible here first) plus the ``consumer_starved_ratio`` satellite,
- compile-plane counters from the Counters shim (none in this port
  yet: the compile plane is not ported),
- the hot-row cache hit rate when a PS client carries one,
- pending :data:`profiling.events` entries (resize begin/end, PS shard
  failures) drained for master-side
  aggregation.

The worker ships it via ``stub.report_telemetry`` (guarded with
hasattr, so bare test stubs and the in-process fixture keep working
unchanged). Everything here is cheap enough for the hot loop: the
interval check is one clock read and a subtraction.
"""

import threading
import time

from elasticdl_tpu_torch.utils import profiling


class WorkerTelemetry:
    def __init__(
        self,
        worker_id,
        stats=None,
        interval_s=5.0,
        ps_client=None,
        registry=None,
    ):
        self._worker_id = worker_id
        self._stats = stats
        self._ps_client = ps_client
        self._interval = float(interval_s)
        # snapshot assembly races: ship() runs behind EVERY task ack,
        # and acks also fire from TaskDataService's prefetcher threads
        # (warm-failure / hand-back paths) concurrently with the
        # consumer loop's — the interval bookkeeping must be serialized
        # or two passers of the interval check double-count the window
        self._snap_lock = threading.Lock()
        self._steps = 0
        self._examples = 0
        self._last_t = time.monotonic()
        self._last_steps = 0
        self._last_examples = 0
        self._last_input = {}
        r = registry or profiling.metrics
        self._g_starved = r.gauge(
            "edl_worker_consumer_starved_ratio",
            "Fraction of the last telemetry interval this worker's "
            "train loop spent waiting on an empty input buffer",
            labels=("worker",),
        )
        # per-table HotRowCache counters (docs/tiered_store.md): the
        # tiered store's admission signal, exported labeled so /metrics
        # shows WHICH table's working set thrashes the top tier.
        # Monotonic totals written gauge-style each interval (the
        # cache owns the counters; this plane only mirrors them)
        self._g_cache = {
            stat: r.gauge(
                "edl_cache_%s_total" % stat,
                "Per-table worker hot-row cache %s (cumulative)" % stat,
                labels=("table", "worker"),
            )
            for stat in ("hits", "misses", "evictions")
        }

    @property
    def enabled(self):
        # evaluated live so set_metrics_enabled() toggles shipping
        # mid-job like it does every other telemetry write
        return self._interval > 0 and profiling.metrics_enabled()

    def on_batch(self, examples):
        """One consumed minibatch of ``examples`` records."""
        self._steps += 1
        self._examples += examples

    def maybe_snapshot(self, force=False):
        """The snapshot dict when the interval elapsed, else None."""
        if not self.enabled:
            return None
        with self._snap_lock:
            return self._snapshot_locked(force)

    def _snapshot_locked(self, force):
        now = time.monotonic()
        dt = now - self._last_t
        if dt < self._interval and not force:
            return None
        dt = max(dt, 1e-6)
        d_steps = self._steps - self._last_steps
        d_examples = self._examples - self._last_examples
        snap = {
            "worker_id": self._worker_id,
            "interval_s": round(dt, 3),
            "steps_per_sec": round(d_steps / dt, 3),
            "examples_per_sec": round(d_examples / dt, 3),
            "steps_total": self._steps,
            "examples_total": self._examples,
        }
        if self._stats is not None:
            # mirror into the local registry (mid-epoch visibility) and
            # ship the same numbers to the master
            cur = self._stats.publish_to(
                profiling.metrics, worker=self._worker_id
            )
            snap["input"] = {k: round(v, 6) for k, v in cur.items()}
            # the stats object resets at stream boundaries, so the
            # interval delta is max(0, cur - last); after a reset the
            # current (smaller) value is itself the best lower bound
            starved = cur.get("consumer_starved_s", 0.0)
            d_starved = starved - self._last_input.get(
                "consumer_starved_s", 0.0
            )
            if d_starved < 0:
                d_starved = starved
            snap["consumer_starved_ratio"] = round(
                min(1.0, max(0.0, d_starved / dt)), 4
            )
            self._g_starved.set(
                snap["consumer_starved_ratio"],
                worker=str(self._worker_id),
            )
            self._last_input = cur
        compile_counters = profiling.counters.snapshot("compile_plane/")
        if compile_counters:
            snap["counters"] = {
                k: round(v, 6) if isinstance(v, float) else v
                for k, v in compile_counters.items()
            }
        hit_rate = self._hot_row_hit_rate()
        if hit_rate is not None:
            snap["hot_row_hit_rate"] = round(hit_rate, 4)
        cache_stats = self._hot_row_table_stats()
        if cache_stats:
            snap["cache_tables"] = cache_stats
            for table, stats in cache_stats.items():
                for stat, gauge in self._g_cache.items():
                    gauge.set(
                        stats[stat],
                        table=table,
                        worker=str(self._worker_id),
                    )
        shipped_spans = profiling.spans.drain_pending()
        if shipped_spans:
            # span records are JSON-safe by construction (SpanLog
            # coerces fields at finish), so they ride the snapshot
            # as-is; the master's JobTelemetry ingests them into its
            # own SpanLog for the /trace export
            snap["spans"] = shipped_spans
        shipped = profiling.events.drain_pending()
        if shipped:
            # the wire codec json.dumps's the header with no default=,
            # so coerce non-scalar fields the way the file sink does —
            # one bad field must not wedge shipping in a requeue loop
            snap["events"] = [
                {
                    k: (
                        v
                        if isinstance(
                            v, (str, int, float, bool, type(None))
                        )
                        else str(v)
                    )
                    for k, v in e.items()
                }
                for e in shipped
            ]
        self._last_t = now
        self._last_steps = self._steps
        self._last_examples = self._examples
        return snap

    def _hot_row_hit_rate(self):
        cache = getattr(self._ps_client, "hot_row_cache", None)
        if cache is None:
            return None
        total = cache.hits + cache.misses
        return cache.hits / total if total else 0.0

    def _hot_row_table_stats(self):
        cache = getattr(self._ps_client, "hot_row_cache", None)
        stats = getattr(cache, "table_stats", None)
        return stats() if stats is not None else None

    def ship(self, stub, force=False):
        """Build + send one snapshot over ``stub`` if due; best-effort
        (telemetry must never fail a training step)."""
        report = getattr(stub, "report_telemetry", None)
        if report is None:
            return False
        snap = self.maybe_snapshot(force=force)
        if snap is None:
            return False
        try:
            report(snap)
            return True
        except Exception:
            # the snapshot's rates are recomputed next interval, but the
            # drained events/spans exist nowhere else — put them back
            profiling.events.requeue(snap.get("events"))
            profiling.spans.requeue(snap.get("spans"))
            from elasticdl_tpu_torch.common.log_utils import (
                default_logger as logger,
            )

            logger.debug("telemetry report failed", exc_info=True)
            return False
