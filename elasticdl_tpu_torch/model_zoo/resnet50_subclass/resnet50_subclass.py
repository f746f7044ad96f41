"""ResNet-50, the port of
``model_zoo/resnet50_subclass/resnet50_subclass.py``: ``CustomModel
(num_classes=10, dtype)`` builds the shared ResNet-50
(``resnet50_model.py``), whose output is a softmax; the loss is the
negative log of the labels' probabilities clipped to [1e-7, 1], trained
by plain SGD at 0.02. Records hold uint8 NHWC images and 1-based labels.

The reference scales the images to [0, 1] float32 on the host; the port
keeps them uint8 through the input pipeline and the model scales them on
the device (``x * (1/255)`` in the compute dtype), so the copy to the card
carries one byte per pixel, as ``imagenet_resnet50``'s does. Images
stored as another dtype are scaled on the host, as the reference does.
"""

import functools

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.model_zoo.imagenet_resnet50.imagenet_resnet50 import (  # noqa: E501
    eval_metrics_fn,
    loss,
)
from elasticdl_tpu_torch.model_zoo.resnet50_subclass.resnet50_model import (
    ResNet50,
)

__all__ = ["CustomModel", "loss", "optimizer", "dataset_fn",
           "eval_metrics_fn"]


def CustomModel(num_classes=10, dtype="float32"):  # noqa: N802 - zoo name
    return ResNet50(num_classes=num_classes, dtype=dtype)


def _sgd(params, lr):
    return torch.optim.SGD(params, lr=lr)


def optimizer(lr=0.02):
    return functools.partial(_sgd, lr=lr)


def dataset_fn(dataset, mode, _):
    def _parse_data(record):
        r = decode_example(record)
        image = r["image"]
        if image.dtype != np.uint8:  # scaled here, as the reference does
            image = image.astype(np.float32) / 255.0
        features = {"image": image}
        if mode == Mode.PREDICTION:
            return features
        # the labels are 1-based
        return features, (r["label"].astype(np.int32) - 1).reshape(-1)

    dataset = dataset.map(_parse_data)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024)
    return dataset
