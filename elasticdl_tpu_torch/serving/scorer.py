"""The scorer: inference over exported models, with hot swap.

The port of ``elasticdl_tpu/serving/scorer.py`` for dense models.

- :class:`ScorerModel` loads one export artifact (common/export.py),
  rebuilds the module its manifest names (``metadata['model_def']``,
  resolved against the port's zoo), loads the weights through
  common/convert.py and scores on its device.
- :class:`Scorer` is the double buffer over one model slot: new
  requests route to the newest installed version, requests in flight
  finish on the version they acquired, and a superseded version leaves
  the ledger when its in-flight count drains to zero. It keeps the
  request-latency histogram the micro-batcher's SLO admission reads.
- :class:`ModelDirectoryWatcher` polls an export root, loads and warms
  the newest complete artifact off the request path, and installs it.

Not ported yet: the PS/embedding plane (read-through embeddings and the
delta sync) and the source-free ``serving_fn.jaxexport`` plane, which
cannot exist without JAX. Both raise ``NotImplementedError``.
"""

import json
import os
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling


def _resize_rows(template, rows):
    """The features template re-tiled to ``rows`` leading rows — how a
    hot swap warms every micro-batching bucket shape."""
    return {
        k: np.resize(a, (int(rows),) + a.shape[1:]) if a.ndim >= 1 else a
        for k, a in template.items()
    }


def _template_rows(template):
    for a in template.values():
        if getattr(a, "ndim", 0) >= 1:
            return int(a.shape[0])
    return None


class ScorerModel:
    """One export artifact, loaded and ready to score on ``device``."""

    def __init__(self, export_dir, model_zoo=None, device="cuda"):
        from elasticdl_tpu_torch.common.export import load_export

        self.export_dir = os.path.abspath(export_dir)
        self.device = resolve_device(device)
        self.exported = load_export(export_dir)
        if self.exported.has_serving_fn():
            raise NotImplementedError(
                "export at %s serves through serving_fn.jaxexport, a "
                "serialized JAX function; that plane is not ported yet "
                "(export params-only for the PyTorch scorer)"
                % self.export_dir
            )
        self.version = int(self.exported.version)
        self._model_zoo = model_zoo
        self._mu = threading.Lock()
        self._model = None

    def _rebuild(self):
        """The module the manifest names, holding this artifact's
        weights, on this model's device."""
        from elasticdl_tpu_torch.common.convert import to_state_dict
        from elasticdl_tpu_torch.common.model_utils import build_model

        meta = self.exported.metadata
        model_def = meta.get("model_def")
        if not model_def:
            raise ValueError(
                "export at %s carries no model_def metadata; nothing to "
                "rebuild" % self.export_dir
            )
        with torch.device("meta"):
            model = build_model(
                model_def,
                meta.get("model_params") or None,
                self._model_zoo,
            )
        model.load_state_dict(
            to_state_dict(self.exported.named), assign=True
        )
        return model.to(self.device).eval()

    def prepare(self):
        """Build the module once (thread-safe: the watcher warms on its
        own thread while a first request may race in)."""
        with self._mu:
            if self._model is None:
                self._model = self._rebuild()

    @property
    def module(self):
        """The rebuilt ``nn.Module`` holding this artifact's weights."""
        self.prepare()
        return self._model

    def predict(self, features):
        """Score one features batch; returns the output on the device,
        complete (the device work has finished)."""
        with torch.inference_mode():
            out = self.module(features)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out


class Scorer:
    """The double-buffered scoring surface over one model slot."""

    def __init__(self):
        self._mu = threading.Lock()
        self._current = None
        self._inflight = {}  # model_version -> in-flight request count
        self._draining = {}  # model_version -> ScorerModel awaiting drain
        self._features_template = None
        self._warm_batch_sizes = ()
        self._swaps = 0
        r = profiling.metrics
        self._h_latency = r.histogram(
            "edl_scorer_request_latency_seconds",
            "Scorer-observed request latency (score path, successes "
            "only)",
        )
        self._c_requests = r.counter(
            "edl_scorer_requests_total",
            "Score requests by outcome",
            labels=("outcome",),
        )
        self._c_errors = r.counter(
            "edl_scorer_errors_total",
            "Degraded-path score failures by kind",
            labels=("kind",),
        )
        r.register_collector(self._collect)

    # -- telemetry -----------------------------------------------------------

    def _collect(self):
        with self._mu:
            version = (
                self._current.version if self._current is not None else -1
            )
            draining = len(self._draining)
            swaps = self._swaps
        return [
            ("edl_scorer_model_version", {}, version),
            ("edl_scorer_draining_versions", {}, draining),
            ("edl_scorer_model_swaps_total", {}, swaps),
        ]

    def note_error(self, kind):
        """Count a degraded-path failure (``bad_request``/``no_model``/
        ``overloaded``/``predict``)."""
        self._c_errors.inc(kind=kind)

    def latency_p99(self):
        """p99 estimate (seconds) of the request latency, None before
        the first success — what SLO admission control reads."""
        return self._h_latency.quantile(0.99)

    def close(self):
        profiling.metrics.unregister_collector(self._collect)

    # -- the double buffer ---------------------------------------------------

    def model(self):
        with self._mu:
            return self._current

    @property
    def model_version(self):
        with self._mu:
            return (
                self._current.version if self._current is not None else -1
            )

    def set_warm_batch_sizes(self, sizes):
        """Row counts :meth:`install` warms besides the last request's
        own shape (the micro-batcher's bucket ladder)."""
        with self._mu:
            self._warm_batch_sizes = tuple(
                sorted({int(s) for s in sizes if int(s) > 0})
            )

    def install(self, model, warm=True):
        """Swap the serving model to ``model`` (idempotent on version).

        ``warm`` builds the new module BEFORE the flip and, once a
        request has shown the feature shapes, runs it at those shapes
        and at every registered bucket, so no request pays the build or
        the first forward of a version."""
        with self._mu:
            template = self._features_template
            warm_sizes = self._warm_batch_sizes
        if warm:
            sizes = []
            t_rows = None
            if template is not None:
                t_rows = _template_rows(template)
                sizes = [None]
                if t_rows is not None and warm_sizes:
                    sizes = sorted(set(warm_sizes) | {t_rows})
            try:
                model.prepare()
                for n in sizes:
                    shaped = (
                        template
                        if n is None or n == t_rows
                        else _resize_rows(template, n)
                    )
                    model.predict(shaped)
            except Exception:  # noqa: BLE001 — warm is best-effort
                logger.warning(
                    "warming export v%d failed; the first request pays "
                    "the build",
                    model.version,
                    exc_info=True,
                )
        with self._mu:
            old = self._current
            if old is not None and old.version == model.version:
                return False
            self._current = model
            self._swaps += 1
            old_inflight = (
                self._inflight.get(old.version, 0) if old is not None else 0
            )
            if old_inflight:
                self._draining[old.version] = old
        profiling.events.emit(
            "scorer_model_swap",
            version=model.version,
            previous=old.version if old is not None else None,
            export_dir=model.export_dir,
        )
        logger.info(
            "scorer now serving model v%d (%s)%s",
            model.version,
            model.export_dir,
            (
                "; v%d draining %d in-flight request(s)"
                % (old.version, old_inflight)
            )
            if old_inflight
            else "",
        )
        return True

    def _acquire(self):
        with self._mu:
            model = self._current
            if model is None:
                raise RuntimeError(
                    "scorer has no model yet (no export artifact "
                    "loaded); is the trainer exporting?"
                )
            self._inflight[model.version] = (
                self._inflight.get(model.version, 0) + 1
            )
            return model

    def _release(self, model):
        with self._mu:
            n = self._inflight.get(model.version, 1) - 1
            if n > 0:
                self._inflight[model.version] = n
                return
            self._inflight.pop(model.version, None)
            drained = self._draining.pop(model.version, None)
        if drained is not None:
            profiling.events.emit(
                "scorer_version_drained", version=model.version
            )

    # -- the request path ----------------------------------------------------

    def score(self, features):
        """Score one batch -> (output, model_version)."""
        try:
            model = self._acquire()
        except Exception:
            self._c_requests.inc(outcome="error")
            self.note_error("no_model")
            raise
        try:
            with self._mu:
                need_template = self._features_template is None
            if need_template:
                # shapes-only template for warming later versions
                template = {
                    k: np.zeros_like(np.asarray(a))
                    for k, a in features.items()
                }
                with self._mu:
                    if self._features_template is None:
                        self._features_template = template
            t0 = time.perf_counter()
            out = model.predict(features)
            self._h_latency.observe(time.perf_counter() - t0)
            self._c_requests.inc(outcome="ok")
            return out, model.version
        except Exception:
            self._c_requests.inc(outcome="error")
            self.note_error("predict")
            raise
        finally:
            self._release(model)

    def status(self):
        with self._mu:
            version = (
                self._current.version if self._current is not None else -1
            )
            inflight = {str(v): n for v, n in self._inflight.items()}
            swaps = self._swaps
        return {"model_version": version, "inflight": inflight, "swaps": swaps}


class ModelDirectoryWatcher:
    """Polls an export root for new versioned artifacts and hot-swaps.

    A trainer writes ``<root>/<subdir>/MANIFEST.json`` last and
    atomically, so a manifest marks a complete artifact. The newest
    unseen version is loaded and warmed on the watcher's thread, never
    on a request; a load failure keeps the old version serving, and an
    artifact that failed three times is skipped."""

    def __init__(
        self, export_root, scorer, interval_s=1.0, model_zoo=None,
        device="cuda",
    ):
        self._root = os.path.abspath(export_root)
        self._scorer = scorer
        self._interval = float(interval_s)
        self._model_zoo = model_zoo
        self._device = resolve_device(device)
        self._stop = threading.Event()
        self._mu = threading.Lock()
        self._thread = None
        self._failed = {}  # export_dir -> failure count

    def newest_manifest(self):
        """(export_dir, model_version) of the newest complete artifact
        under the root, or (None, -1)."""
        best_dir, best_version = None, -1
        try:
            entries = sorted(os.listdir(self._root))
        except OSError:
            return None, -1
        for name in entries:
            path = os.path.join(self._root, name)
            try:
                with open(os.path.join(path, "MANIFEST.json")) as f:
                    version = int(json.load(f).get("model_version", -1))
            except (OSError, ValueError):
                continue  # incomplete/foreign/vanished — not an artifact
            if version > best_version:
                best_dir, best_version = path, version
        return best_dir, best_version

    def poll_once(self):
        """Load and install the newest unseen export; returns its
        version, or None when there is nothing new."""
        path, version = self.newest_manifest()
        with self._mu:
            for stale in [p for p in self._failed if not os.path.isdir(p)]:
                del self._failed[stale]
        if path is None or version <= self._scorer.model_version:
            return None
        with self._mu:
            if self._failed.get(path, 0) >= 3:
                return None  # poisoned artifact: stop re-loading it
        try:
            model = ScorerModel(
                path, model_zoo=self._model_zoo, device=self._device
            )
            self._scorer.install(model)
        except Exception:  # noqa: BLE001 — keep serving the old version
            with self._mu:
                self._failed[path] = self._failed.get(path, 0) + 1
            logger.warning(
                "loading export at %s failed; still serving v%d",
                path,
                self._scorer.model_version,
                exc_info=True,
            )
            return None
        return version

    def start(self):
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="edl-model-watcher"
            )
            self._thread.start()

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.warning("model watcher poll failed", exc_info=True)

    def stop(self):
        self._stop.set()
        with self._mu:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
