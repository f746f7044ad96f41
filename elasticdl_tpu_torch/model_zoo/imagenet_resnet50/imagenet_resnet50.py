"""ImageNet ResNet-50, the port of
``model_zoo/imagenet_resnet50/imagenet_resnet50.py``: the shared ResNet-50
(resnet50_subclass/resnet50_model.py) with 1000 classes and bfloat16
compute while the parameters stay float32, trained by SGD with momentum
0.9 (``optax.sgd(lr, momentum=0.9)``: torch's ``momentum_buffer`` is
optax's trace). Records hold uint8 NHWC images, normalized on the device.
"""

import functools

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.model_zoo.resnet50_subclass.resnet50_model import (
    ResNet50,
)


def custom_model(num_classes=1000, dtype="bfloat16"):
    return ResNet50(num_classes=num_classes, dtype=dtype)


def loss(output, labels):
    """Mean negative log of the labels' probabilities, clipped to [1e-7,
    1] first."""
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=output.device, dtype=torch.long).reshape(-1)
    probs = output.clamp(1e-7, 1.0)
    return -torch.log(probs.gather(1, labels[:, None])[:, 0]).mean()


def _sgd(params, lr, momentum):
    return torch.optim.SGD(params, lr=lr, momentum=momentum)


def optimizer(lr=0.02, momentum=0.9):
    """A factory ``params -> SGD`` with ``optax.sgd(lr, momentum)``'s
    update: trace = g + momentum * trace, param -= lr * trace."""
    return functools.partial(_sgd, lr=lr, momentum=momentum)


def dataset_fn(dataset, mode, _):
    def _parse_data(record):
        r = decode_example(record)
        # uint8 stays uint8: the model normalizes on the device, so the
        # copy to the card carries 1 byte per pixel
        features = {"image": r["image"]}
        if mode == Mode.PREDICTION:
            return features
        return features, (r["label"].astype(np.int32) - 1).reshape(-1)

    dataset = dataset.map(_parse_data, num_parallel_calls=4)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024)
    return dataset


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x)


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: np.equal(
            np.argmax(_numpy(predictions), axis=1).astype(np.int32),
            _numpy(labels).reshape(-1).astype(np.int32),
        )
    }
