"""Streaming evaluation metrics, the port's own copy of
``elasticdl_tpu/metrics/__init__.py``.

The master adds up each evaluation round with these host numpy
accumulators, fed the raw model outputs and labels that the workers
report. A model zoo's ``eval_metrics_fn`` may return metric objects or
plain callables ``fn(labels, predictions) -> per-example values``; a
callable is wrapped in a :class:`Mean` (:func:`as_metric`).

Inputs may arrive as torch tensors, on the card or on the host: every
``update_state`` brings them to host numpy first (:func:`to_host`). numpy
has no bfloat16, so a bf16 tensor is widened to float32 on the way; the
widening is exact, so ``argmax`` and comparisons read as they would on
the bf16 values.
"""

import numpy as np
import torch

__all__ = [
    "Metric",
    "Mean",
    "Sum",
    "Accuracy",
    "BinaryAccuracy",
    "SparseCategoricalAccuracy",
    "CategoricalAccuracy",
    "MeanSquaredError",
    "AUC",
    "as_metric",
    "to_host",
]


def to_host(x):
    """A torch tensor (any device; bf16 widened to float32) or an array
    -> a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Metric:
    """Base streaming metric: update_state / result / reset_states."""

    def __init__(self, name=None):
        self.name = name or type(self).__name__.lower()

    def update_state(self, labels, predictions):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def reset_states(self):
        raise NotImplementedError


class Mean(Metric):
    """Running mean of whatever values are fed in."""

    def __init__(self, name=None, fn=None):
        super().__init__(name)
        self._fn = fn
        self._total = 0.0
        self._count = 0

    def update_state(self, labels, predictions=None):
        if self._fn is not None:
            values = self._fn(labels, predictions)
        else:
            values = labels  # fed values directly
        values = to_host(values).astype(np.float64).reshape(-1)
        self._total += float(values.sum())
        self._count += values.size

    def result(self):
        return self._total / self._count if self._count else 0.0

    def reset_states(self):
        self._total = 0.0
        self._count = 0


class Sum(Metric):
    def __init__(self, name=None):
        super().__init__(name)
        self._total = 0.0

    def update_state(self, labels, predictions=None):
        self._total += float(to_host(labels).astype(np.float64).sum())

    def result(self):
        return self._total

    def reset_states(self):
        self._total = 0.0


class _Counted(Metric):
    """A share of matching examples: ``correct / count``."""

    def __init__(self, name):
        super().__init__(name)
        self._correct = 0
        self._count = 0

    def _add(self, labels, predictions):
        self._correct += int((labels == predictions).sum())
        self._count += labels.size

    def result(self):
        return self._correct / self._count if self._count else 0.0

    def reset_states(self):
        self._correct = 0
        self._count = 0


class Accuracy(_Counted):
    """Exact-match accuracy of predictions vs labels (keras Accuracy)."""

    def __init__(self, name="accuracy"):
        super().__init__(name)

    def update_state(self, labels, predictions):
        self._add(
            to_host(labels).reshape(-1), to_host(predictions).reshape(-1)
        )


class SparseCategoricalAccuracy(_Counted):
    """argmax(logits) == integer label."""

    def __init__(self, name="accuracy"):
        super().__init__(name)

    def update_state(self, labels, predictions):
        pred = np.argmax(to_host(predictions), axis=-1).reshape(-1)
        self._add(to_host(labels).reshape(-1), pred)


class CategoricalAccuracy(SparseCategoricalAccuracy):
    """argmax(logits) == argmax(one-hot label)."""

    def update_state(self, labels, predictions):
        labels = np.argmax(to_host(labels), axis=-1)
        super().update_state(labels, predictions)


class BinaryAccuracy(_Counted):
    def __init__(self, name="binary_accuracy", threshold=0.5):
        super().__init__(name)
        self._threshold = threshold

    def update_state(self, labels, predictions):
        labels = to_host(labels).reshape(-1)
        pred = (to_host(predictions).reshape(-1) > self._threshold).astype(
            labels.dtype
        )
        self._add(labels, pred)


class MeanSquaredError(Metric):
    def __init__(self, name="mse"):
        super().__init__(name)
        self._total = 0.0
        self._count = 0

    def update_state(self, labels, predictions):
        labels = to_host(labels).astype(np.float64).reshape(-1)
        pred = to_host(predictions).astype(np.float64).reshape(-1)
        self._total += float(((labels - pred) ** 2).sum())
        self._count += labels.size

    def result(self):
        return self._total / self._count if self._count else 0.0

    def reset_states(self):
        self._total = 0.0
        self._count = 0


class AUC(Metric):
    """Streaming ROC AUC via fixed-threshold confusion-count histograms.

    Same approximation scheme as tf.keras.metrics.AUC: bucket scores into
    ``num_thresholds`` bins, accumulate TP/FP per threshold, integrate
    TPR over FPR with the trapezoid rule.
    """

    def __init__(self, name="auc", num_thresholds=200):
        super().__init__(name)
        self._n = num_thresholds
        self._thresholds = np.linspace(0.0, 1.0, num_thresholds)
        self.reset_states()

    def update_state(self, labels, predictions):
        labels = to_host(labels).reshape(-1).astype(bool)
        scores = to_host(predictions).astype(np.float64).reshape(-1)
        # predictions >= threshold counted positive, per threshold bin
        pred_pos = scores[None, :] >= self._thresholds[:, None]
        self._tp += (pred_pos & labels[None, :]).sum(axis=1)
        self._fp += (pred_pos & ~labels[None, :]).sum(axis=1)
        self._pos += int(labels.sum())
        self._neg += int((~labels).sum())

    def result(self):
        if not self._pos or not self._neg:
            return 0.0
        tpr = self._tp / self._pos
        fpr = self._fp / self._neg
        # thresholds ascend -> fpr descends; integrate in ascending order
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr[::-1], fpr[::-1]))

    def reset_states(self):
        self._tp = np.zeros(self._n, dtype=np.int64)
        self._fp = np.zeros(self._n, dtype=np.int64)
        self._pos = 0
        self._neg = 0


def as_metric(name, value):
    """A Metric object for an ``eval_metrics_fn`` dict value: a plain
    callable ``fn(labels, predictions)`` becomes a Mean over its
    per-example outputs."""
    if isinstance(value, Metric):
        return value
    if callable(value):
        return Mean(name=name, fn=value)
    raise TypeError(
        "eval metric %r must be a Metric or callable, got %r" % (name, value)
    )
