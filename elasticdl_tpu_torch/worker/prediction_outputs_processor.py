"""The user's hook for prediction outputs, the counterpart of
``elasticdl_tpu/worker/prediction_outputs_processor.py``.

A zoo module may define ``PredictionOutputsProcessor``, a subclass (or an
instance) of :class:`BasePredictionOutputsProcessor`; a prediction-only
job hands it each batch's outputs as host numpy arrays (bf16 widened to
float32), once per batch.
"""

from abc import ABC, abstractmethod


class BasePredictionOutputsProcessor(ABC):
    """Base class for processing prediction outputs on workers."""

    @abstractmethod
    def process(self, predictions, worker_id):
        """Process one batch of predictions produced by ``worker_id``."""
