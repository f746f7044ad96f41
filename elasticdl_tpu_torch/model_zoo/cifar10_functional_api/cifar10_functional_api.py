"""CIFAR-10 CNN, the port of
``model_zoo/cifar10_functional_api/cifar10_functional_api.py``: the
network of ``cifar10_subclass`` built by ``custom_model()``, the same
loss, SGD at 0.1, ``dataset_fn`` and accuracy metric, and its
``PredictionOutputsProcessor``.

The reference's processor writes each batch's predictions to an ODPS
table when the ODPS credentials are in the environment, and logs them
otherwise. The port logs them likewise; with the credentials set it
raises ``NotImplementedError`` naming the ODPS writer, which needs a
MaxCompute service and is not queued for the port.
"""

import os

import numpy as np

from elasticdl_tpu_torch.common.constants import ODPSConfig
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.model_zoo.cifar10_subclass.cifar10_subclass import (
    CustomModel,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)

__all__ = ["custom_model", "loss", "optimizer", "dataset_fn",
           "eval_metrics_fn", "PredictionOutputsProcessor"]


def custom_model():
    return CustomModel()


class PredictionOutputsProcessor(BasePredictionOutputsProcessor):
    """Logs the predictions; the reference's ODPS table writer is not
    ported."""

    def __init__(self):
        if all(
            k in os.environ
            for k in (
                ODPSConfig.PROJECT_NAME,
                ODPSConfig.ACCESS_ID,
                ODPSConfig.ACCESS_KEY,
            )
        ):
            raise NotImplementedError(
                "the ODPS writer (ODPSWriter, the table "
                "cifar10_prediction_outputs) is not ported: it needs a "
                "MaxCompute service"
            )
        self.odps_writer = None

    def process(self, predictions, worker_id):
        logger.info("Predictions: %s", np.asarray(predictions))
