"""Dynamic micro-batching for the scorer: the port of
``elasticdl_tpu/serving/batcher.py``, unchanged in behaviour.

- **Coalesce**: concurrent ``score`` requests of one *shape signature*
  (feature names, dtypes, trailing dims) queue here; a dispatcher thread
  concatenates them into ONE forward.
- **Bucket**: batches pad up to a fixed ladder of row counts (powers of
  two up to ``--serve_max_batch``), and every bucket is warmed on hot
  swap (:meth:`Scorer.set_warm_batch_sizes`). Padding REPEATS real rows
  (never zeros), so each caller's rows score exactly as they would alone.
- **Cutoff**: dispatch fires at a full bucket or ``--serve_batch_timeout_ms``
  after the oldest queued request arrived.
- **Admit or shed**: past the p99 SLO (``--serve_p99_slo_ms``, predicted
  from the request-latency histogram) or the hard queue-row cap,
  ``submit`` sheds with :class:`Overloaded`, which the RPC surface turns
  into an explicit ``{"error": "overloaded"}`` reply.

The batcher lock guards only the queue: the forward and every padding
copy run off it on the dispatcher thread, and results return to callers
through per-request events. ``stop(drain=True)`` answers everything
already queued before the thread exits.
"""

import threading
import time

import numpy as np

from elasticdl_tpu_torch.utils import profiling


class Overloaded(RuntimeError):
    """Admission control shed this request (``reason``: ``slo``,
    ``queue_full``, or ``draining``); the RPC reply is the explicit
    ``{"error": "overloaded"}`` degrade, safe to retry elsewhere."""

    def __init__(self, reason):
        super().__init__("overloaded")
        self.reason = reason


def batch_buckets(max_batch):
    """The fixed bucket ladder: powers of two, with ``max_batch``
    itself always the top bucket (pow2 or not)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def request_signature(features):
    """``(rows, signature)`` for a feature dict, or ``(None, None)``
    when the request cannot join a coalesced batch (0-d features,
    ragged leading dims, or zero rows). Only same-signature requests
    share a forward: the concatenated batch must be a valid input of
    the same model forward."""
    rows = None
    sig = []
    for name in sorted(features):
        a = features[name]
        if getattr(a, "ndim", 0) < 1:
            return None, None
        n = int(a.shape[0])
        if rows is None:
            rows = n
        elif n != rows:
            return None, None
        sig.append((name, str(a.dtype), tuple(a.shape[1:])))
    if not rows:
        return None, None
    return rows, tuple(sig)


def _slice_rows(out, offset, rows):
    """De-multiplex one caller's rows out of a batched output."""
    if isinstance(out, dict):
        return {k: v[offset : offset + rows] for k, v in out.items()}
    return out[offset : offset + rows]


class _Pending:
    """One queued request: features in, (out, version) or err out."""

    __slots__ = (
        "features",
        "rows",
        "sig",
        "t_enq",
        "done",
        "out",
        "version",
        "err",
    )

    def __init__(self, features, rows, sig):
        self.features = features
        self.rows = rows
        self.sig = sig
        self.t_enq = time.monotonic()
        self.done = threading.Event()
        self.out = None
        self.version = -1
        self.err = None


class MicroBatcher:
    """Per-scorer coalescing queue + dispatcher + admission control.

    ``max_batch``: the row budget of one coalesced forward (top of the
    bucket ladder). ``timeout_ms``: latency-budget cutoff measured from
    the oldest queued request. ``p99_slo_ms``: shed when the predicted
    completion time (queue ahead + one forward, at the histogram's p99
    estimate) exceeds this; 0 disables. ``queue_rows``: hard cap on
    queued rows (0 -> ``8 * max_batch``) — the backstop that bounds
    memory and tail latency even before the SLO estimate warms up.
    """

    def __init__(
        self,
        scorer,
        max_batch=64,
        timeout_ms=2.0,
        p99_slo_ms=0.0,
        queue_rows=0,
        slo_refresh_s=0.25,
    ):
        self._scorer = scorer
        self.max_batch = int(max_batch)
        self.buckets = batch_buckets(self.max_batch)
        self._timeout_s = max(0.0, float(timeout_ms) / 1000.0)
        self._slo_s = max(0.0, float(p99_slo_ms) / 1000.0)
        self._queue_rows_cap = (
            int(queue_rows) if queue_rows else 8 * self.max_batch
        )
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queue = []  # FIFO of _Pending (per-sig order preserved)
        self._queued_rows = 0
        self._dispatching_rows = 0
        self._stopping = False
        self._thread = None
        # p99 estimate cache: the histogram read happens OFF the queue
        # lock at most once per refresh window, behind its own tiny
        # lock (the cache tuple is shared across submitters)
        self._est_mu = threading.Lock()
        self._slo_refresh_s = float(slo_refresh_s)
        self._p99_at = -1e9
        self._p99_est = None
        r = profiling.metrics
        self._h_batch = r.histogram(
            "edl_scorer_batch_size",
            "Real (pre-padding) rows per dispatched coalesced forward",
            buckets=tuple(float(b) for b in self.buckets),
        )
        self._c_batches = r.counter(
            "edl_scorer_batches_total",
            "Coalesced forwards dispatched",
        )
        self._c_shed = r.counter(
            "edl_scorer_shed_total",
            "Requests shed by admission control, by reason",
            labels=("reason",),
        )
        r.register_collector(self._collect)

    # -- telemetry -----------------------------------------------------------

    def _collect(self):
        with self._mu:
            depth = len(self._queue)
            rows = self._queued_rows + self._dispatching_rows
        return [
            ("edl_scorer_queue_depth", {}, depth),
            ("edl_scorer_queue_rows", {}, rows),
        ]

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        with self._mu:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="edl-micro-batcher"
            )
            self._thread.start()

    def stop(self, drain=True, timeout=30.0):
        """Stop taking requests; with ``drain`` (the SIGTERM path),
        everything already queued is answered before the dispatcher
        exits — otherwise queued requests shed as ``draining``."""
        deadline = time.monotonic() + timeout
        with self._mu:
            self._stopping = True
            if not drain:
                for p in self._queue:
                    p.err = Overloaded("draining")
                dropped, self._queue = self._queue, []
                self._queued_rows = 0
            else:
                dropped = []
            self._cv.notify_all()
            if drain:
                while self._queue or self._dispatching_rows:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
            thread, self._thread = self._thread, None
        for p in dropped:
            self._c_shed.inc(reason="draining")
            p.done.set()
        if thread is not None:
            thread.join(
                timeout=max(0.0, deadline - time.monotonic()) + 1.0
            )

    def close(self):
        profiling.metrics.unregister_collector(self._collect)

    # -- the request path ----------------------------------------------------

    def submit(self, features):
        """Score ``features`` through the coalescing queue ->
        ``(output, model_version)``. Raises :class:`Overloaded` when
        admission sheds; un-batchable requests (0-d features, ragged
        leading dims) and a not-started batcher score inline."""
        rows, sig = request_signature(features)
        if rows is None or self._thread is None:
            return self._scorer.score(features)
        p99 = self._forward_p99() if self._slo_s > 0 else None
        p = _Pending(features, rows, sig)
        with self._mu:
            if self._stopping:
                reason = "draining"
            elif self._queued_rows + rows > self._queue_rows_cap:
                reason = "queue_full"
            elif p99 is not None and self._past_slo_locked(rows, p99):
                reason = "slo"
            else:
                reason = None
                self._queue.append(p)
                self._queued_rows += rows
                self._cv.notify_all()
        if reason is not None:
            self._c_shed.inc(reason=reason)
            raise Overloaded(reason)
        p.done.wait()
        if p.err is not None:
            raise p.err
        return p.out, p.version

    def _past_slo_locked(self, rows, p99):
        """Would this request's predicted QUEUE WAIT bust the SLO?
        Batches ahead of it (queued + dispatching, NOT its own rows —
        an idle plane must always admit, even when the histogram's p99
        is poisoned by a cold-compile outlier a cumulative histogram
        never forgets) x the p99 forward estimate; pure arithmetic
        (the histogram read happened off-lock in :meth:`_forward_p99`),
        so it recovers the moment a burst drains instead of echoing
        the burst's tail for minutes."""
        ahead = self._queued_rows + self._dispatching_rows
        batches = (ahead + self.max_batch - 1) // self.max_batch
        return batches * p99 > self._slo_s

    def _forward_p99(self):
        now = time.monotonic()
        with self._est_mu:
            if now - self._p99_at <= self._slo_refresh_s:
                return self._p99_est
        est = self._scorer.latency_p99()
        with self._est_mu:
            self._p99_at = now
            self._p99_est = est
        return est

    # -- the dispatcher thread -----------------------------------------------

    def _run(self):
        while True:
            batch = self._gather()
            if batch is None:
                return
            self._dispatch(batch)

    def _gather(self):
        """Block until a batch is due (full bucket or cutoff expired),
        pop it from the queue, return it. None means shut down."""
        with self._mu:
            while not self._queue:
                if self._stopping:
                    return None
                self._cv.wait()
            head = self._queue[0]
            deadline = head.t_enq + self._timeout_s
            while True:
                take, rows = self._match_locked(head.sig)
                if rows >= self.max_batch or self._stopping:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            for p in take:
                self._queue.remove(p)
                self._queued_rows -= p.rows
            self._dispatching_rows = rows
            return take, rows

    def _match_locked(self, sig):
        """Oldest-first requests of ``sig`` fitting the row budget
        (the head always ships, even oversize — it pads to the next
        power of two past the ladder rather than starving)."""
        take, rows = [], 0
        for p in self._queue:
            if p.sig != sig:
                continue
            if take and rows + p.rows > self.max_batch:
                break
            take.append(p)
            rows += p.rows
        return take, rows

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        b = self.buckets[-1]
        while b < n:
            b *= 2
        return b

    def _dispatch(self, batch):
        """Assemble, score, de-multiplex — all OFF the queue lock; one
        exception fails every coalesced caller (they see the same
        degraded plane a solo request would)."""
        take, rows = batch
        try:
            feats = self._assemble(take, rows)
            out, version = self._scorer.score(feats)
            self._h_batch.observe(rows)
            self._c_batches.inc()
            offset = 0
            for p in take:
                p.out = _slice_rows(out, offset, p.rows)
                p.version = version
                offset += p.rows
        except Exception as err:  # noqa: BLE001 — reported per caller
            for p in take:
                p.err = err
        finally:
            with self._mu:
                self._dispatching_rows = 0
                self._cv.notify_all()
            for p in take:
                p.done.set()

    def _assemble(self, take, rows):
        """One concatenated feature dict, padded to the bucket by
        repeating real rows (never zeros, so the padded batch holds
        only real requests' inputs)."""
        bucket = self.bucket_for(rows)
        pad = bucket - rows
        pad_idx = np.arange(pad) % rows if pad else None
        feats = {}
        for name in take[0].features:
            parts = [np.asarray(p.features[name]) for p in take]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if pad:
                arr = np.concatenate([arr, arr[pad_idx]])
            feats[name] = arr
        return feats
