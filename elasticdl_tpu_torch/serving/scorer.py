"""The scorer: inference over exported models, with hot swap.

The port of ``elasticdl_tpu/serving/scorer.py``.

- :class:`ScorerModel` loads one export artifact (common/export.py).
  An artifact with the port's serving member (``serving_fn.pt2``) is
  served through it: no rebuild and no zoo lookup, the member loaded
  once on the scorer's device, as the reference serves its
  ``serving_fn.jaxexport``. An artifact without it is served by the
  module its manifest names (``metadata['model_def']``, resolved against
  the port's zoo), rebuilt with the weights of ``model.chkpt`` through
  common/convert.py. That is also how a reference artifact whose member
  is JAX's is served: the port cannot read StableHLO, so it logs that
  the member is not read and rebuilds, as the reference does without a
  member. A BatchNorm model's running statistics live only in that
  member, so a rebuild would serve wrong answers: such an artifact
  raises ``NotImplementedError``. A model with elastic
  embedding layers (``nn/embedding.py``) scores as the trainer steps: a
  capture pass learns the batch's ids, ``plan_lookup_multi`` plans one
  pull of each layer's unique ids, the rows come through the scorer's
  ``PsPlane`` (the PS fleet, read through the ``HotRowCache``), and the
  forward gathers from them on the device (``bind_rows``).
- :class:`Scorer` is the double buffer over one model slot: new
  requests route to the newest installed version, requests in flight
  finish on the version they acquired, and a superseded version leaves
  the ledger when its in-flight count drains to zero. It keeps the
  request-latency histogram the micro-batcher's SLO admission reads,
  and, over a ``PSClient``, the plane, the capture lock and the cache's
  staleness and hit gauges (``serving/delta_sync.py`` keeps the cache
  fresh).
- :class:`ModelDirectoryWatcher` polls an export root, loads and warms
  the newest complete artifact off the request path, and installs it.

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
        self.version = int(self.exported.version)
        # the source-free plane: the port's own member
        self.serves_member = self.exported.has_torch_serving_fn()
        if self.exported.has_serving_fn() and not self.serves_member:
            logger.info(
                "export at %s carries a serialized JAX serving function "
                "(serving_fn.jaxexport), which the port cannot read; "
                "scoring it by the model rebuilt from its model_def and "
                "model.chkpt", self.export_dir,
            )
        self._model_zoo = model_zoo
        self._mu = threading.Lock()
        self._model = None
        self._elastic = False  # has elastic embedding layers
        # the embedding surface, learned by the first capture pass
        self._embedding_dims = {}  # {layer path: row width}
        self._embedding_initializers = {}
        self._num_calls = None

    def rebuild(self):
        """The module the manifest names, holding this artifact's
        weights, on this model's device. An elastic layer has no weights
        (its rows live on the PS fleet), so a PS-plane model's artifact
        carries only its dense layers. A reference artifact whose
        running statistics live only in its JAX member raises."""
        from elasticdl_tpu_torch.common.convert import to_state_dict
        from elasticdl_tpu_torch.common.model_utils import build_model
        from elasticdl_tpu_torch.nn.layers import BatchNorm

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
        if self.exported.has_serving_fn() and any(
            isinstance(m, BatchNorm) for m in model.modules()
        ):
            raise NotImplementedError(
                "export at %s is a BatchNorm model (%s) whose running "
                "statistics live only in its serving_fn.jaxexport member, "
                "a serialized JAX function the port cannot read; rebuilt "
                "from model.chkpt it would serve fresh statistics"
                % (self.export_dir, model_def)
            )
        model.load_state_dict(
            to_state_dict(self.exported.named), assign=True
        )
        for module in model.modules():
            # a buffer no artifact carries (non-persistent: the MoE's
            # aux_loss) starts at zero
            for name, buf in module.named_buffers(recurse=False):
                if buf.is_meta:
                    module._buffers[name] = torch.zeros(
                        buf.shape, dtype=buf.dtype
                    )
        return model.to(self.device).eval()

    def prepare(self):
        """Load the serving member, or build the module, once
        (thread-safe: the watcher warms on its own thread while a first
        request may race in)."""
        from elasticdl_tpu_torch.nn.embedding import embedding_layers

        with self._mu:
            if self._model is None:
                if self.serves_member:
                    self._model = self.exported.serving_program(self.device)
                else:
                    self._model = self.rebuild()
                    self._elastic = bool(embedding_layers(self._model))

    @property
    def module(self):
        """What scores: the serving member's module, or the rebuilt
        ``nn.Module`` holding this artifact's weights."""
        self.prepare()
        return self._model

    @property
    def embedding_tables(self):
        """{table: (dim, initializer)} once a request has been scored:
        what a shard that came back empty needs pushed again."""
        return {
            path: (dim, self._embedding_initializers.get(path, "uniform"))
            for path, dim in self._embedding_dims.items()
        }

    def _capture(self, features):
        """{layer path: [ids per call]} of ``features``; the first pass
        learns the layers' widths, initializers and number of calls."""
        from elasticdl_tpu_torch.nn.embedding import capture_embedding_ids

        # the module runs with its own weights: nothing to substitute
        model = self._model
        if self._num_calls is not None:
            return capture_embedding_ids(
                model, {}, {}, features, expected_count=self._num_calls
            )
        layer_info = {}
        captured = capture_embedding_ids(
            model, {}, {}, features, layer_info=layer_info
        )
        self._embedding_dims = {p: int(i[0]) for p, i in layer_info.items()}
        self._embedding_initializers = {
            p: i[1] for p, i in layer_info.items()
        }
        self._num_calls = sum(len(ids) for ids in captured.values())
        return captured

    def _to_device(self, lookups, pulled):
        """Each layer's pulled rows and positions on the device: one
        host-to-device copy for all the rows, one for all the
        positions."""
        paths = list(lookups)
        flat = np.concatenate(
            [np.asarray(pulled[p], np.float32).reshape(-1) for p in paths]
        )
        pos = np.concatenate(
            [i.reshape(-1) for p in paths for i in lookups[p][1]]
        ).astype(np.int64)
        flat = torch.from_numpy(flat).to(self.device)
        pos = torch.from_numpy(pos).to(self.device)
        rows, idx, off, at = {}, {}, 0, 0
        for p in paths:
            unique, idxs = lookups[p]
            n = len(unique) * self._embedding_dims[p]
            rows[p] = flat[off:off + n].view(len(unique),
                                             self._embedding_dims[p])
            off += n
            idx[p] = []
            for i in idxs:
                idx[p].append(pos[at:at + i.size].view(i.shape))
                at += i.size
        return rows, idx

    def predict(self, features, plane=None, capture_lock=None):
        """Score one features batch; returns the output on the device,
        complete (the device work has finished).

        A model with elastic layers needs ``plane``, the comm plane over
        the PS fleet. Its capture pass and plan run under
        ``capture_lock`` (one capture at a time, as the worker runs it on
        one thread), its pull and forward outside it."""
        from elasticdl_tpu_torch.nn.comm_plane import plan_lookup_multi
        from elasticdl_tpu_torch.nn.embedding import bind_rows

        model = self.module
        if self.serves_member:
            out = self.exported.serve(features, self.device)
        elif not self._elastic:
            with torch.inference_mode():
                out = model(features)
        else:
            if plane is None:
                raise RuntimeError(
                    "model %s has PS-resident embedding tables; the scorer "
                    "needs a comm plane over the PS fleet to serve them "
                    "(--ps_addrs)" % self.export_dir
                )
            with capture_lock if capture_lock is not None else self._mu:
                lookups = {
                    path: plan_lookup_multi(ids_list)
                    for path, ids_list in self._capture(features).items()
                }
            pulled = plane.pull(
                {path: unique for path, (unique, _) in lookups.items()}
            )
            rows, idx = self._to_device(lookups, pulled)
            with torch.inference_mode(), bind_rows(model, rows, idx):
                out = model(features)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out


class Scorer:
    """The double-buffered scoring surface over one model slot.

    ``ps_client``: a ``worker.ps_client.PSClient`` over the shards that
    hold an embedding model's tables; the scorer pulls through a
    ``PsPlane`` over it and, when a shard comes back with no state, pushes
    the tables' infos again so its rows are minted anew (the trainer
    pushes the model on its own schedule). ``staleness_versions``: the
    window reported beside the cache's staleness (the cache's own by
    default)."""

    def __init__(self, ps_client=None, staleness_versions=None,
                 model_zoo=None):
        from elasticdl_tpu_torch.nn.comm_plane import PsPlane

        self._client = ps_client
        self._plane = PsPlane(ps_client) if ps_client is not None else None
        self._model_zoo = model_zoo
        self._mu = threading.Lock()
        self._capture_mu = threading.Lock()
        self._current = None
        self._inflight = {}  # model_version -> in-flight request count
        self._draining = {}  # model_version -> ScorerModel awaiting drain
        self._drained = threading.Condition(self._mu)
        self._features_template = None
        self._warm_batch_sizes = ()
        self._swaps = 0
        self._cache = (
            ps_client.hot_row_cache if ps_client is not None else None
        )
        self._staleness_versions = (
            staleness_versions if staleness_versions is not None
            else (self._cache._window if self._cache is not None else 0)
        )
        if ps_client is not None:
            ps_client.set_on_shard_reset(self._on_ps_shard_reset)
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
        out = []
        cache = self._cache
        if cache is not None:
            probes = cache.hits + cache.misses
            out.append(("edl_scorer_row_staleness_versions", {},
                        cache.max_live_lag()))
            out.append(("edl_scorer_hot_row_hit_rate", {},
                        cache.hits / probes if probes else 0.0))
            for table, stats in cache.table_stats().items():
                labels = {"table": table}
                for key in ("hits", "misses", "evictions"):
                    out.append(("edl_cache_%s_total" % key, labels,
                                stats[key]))
        with self._mu:
            version = (
                self._current.version if self._current is not None else -1
            )
            draining = len(self._draining)
            swaps = self._swaps
        out.append(("edl_scorer_model_version", {}, version))
        out.append(("edl_scorer_draining_versions", {}, draining))
        out.append(("edl_scorer_model_swaps_total", {}, swaps))
        return out

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

    def _on_ps_shard_reset(self, shards):
        model = self.model()
        tables = model.embedding_tables if model is not None else {}
        if not tables:
            return
        from elasticdl_tpu_torch.ps.parameters import EmbeddingTableInfo

        logger.warning(
            "re-pushing embedding table infos after PS shard(s) %s "
            "relaunched without restorable state", shards,
        )
        self._client.push_embedding_info([
            EmbeddingTableInfo(name, dim, init)
            for name, (dim, init) in sorted(tables.items())
        ])

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
                    model.predict(
                        shaped, plane=self._plane,
                        capture_lock=self._capture_mu,
                    )
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
            self._drained.notify_all()
        if drained is not None:
            profiling.events.emit(
                "scorer_version_drained", version=model.version
            )

    def inflight_versions(self):
        """{model_version: in-flight count}, copied."""
        with self._mu:
            return dict(self._inflight)

    def wait_drained(self, version, timeout=10.0):
        """Wait until no request of ``version`` is in flight; False on
        the timeout."""
        deadline = time.monotonic() + timeout
        with self._mu:
            while self._inflight.get(version):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._drained.wait(left)
            return True

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
            out = model.predict(
                features, plane=self._plane, capture_lock=self._capture_mu
            )
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
        out = {"model_version": version, "inflight": inflight, "swaps": swaps}
        cache = self._cache
        if cache is not None:
            out["cache_hits"] = cache.hits
            out["cache_misses"] = cache.misses
            out["staleness_versions"] = cache.max_live_lag()
            out["staleness_window"] = self._staleness_versions
        return out


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
