"""MNIST CNN, the port of
``model_zoo/mnist_functional_api/mnist_functional_api.py``: the network of
``mnist_subclass`` (two valid 3x3 convolutions with ReLU, ``GroupNorm(8)``
at flax's epsilon 1e-6, a 2x2 max pool, dropout 0.25 in training and
``Dense(10)`` over the NHWC-flattened features), built by
``custom_model()``, and trained by SGD at 0.1.
"""

import functools

from elasticdl_tpu_torch.model_zoo.mnist_subclass.mnist_subclass import (
    CustomModel,
    _sgd,
    dataset_fn,
    eval_metrics_fn,
    loss,
)

__all__ = ["custom_model", "loss", "optimizer", "dataset_fn",
           "eval_metrics_fn"]


def custom_model():
    return CustomModel()


def optimizer(lr=0.1):
    return functools.partial(_sgd, lr=lr)
