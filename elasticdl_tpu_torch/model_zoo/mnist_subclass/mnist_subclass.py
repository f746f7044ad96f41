"""MNIST CNN, the port of ``model_zoo/mnist_subclass/mnist_subclass.py``:
two valid 3x3 convolutions with ReLU, ``GroupNorm(8)`` (flax's epsilon,
1e-6), a 2x2 max pool, dropout 0.25 in training and a dense head over the
features flattened in NHWC order, as flax flattens them (so the head's
weight is the flax kernel transposed). SGD at 0.01.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.nn.layers import Conv, lecun_normal_


class CustomModel(nn.Module):
    def __init__(self, channel_last=True):
        super().__init__()
        # a single channel: NHWC and NCHW images are the same array
        self.channel_last = channel_last
        self.conv0 = Conv(1, 32, 3, padding=(0, 0), bias=True)
        self.conv1 = Conv(32, 64, 3, padding=(0, 0), bias=True)
        self.group_norm = nn.GroupNorm(8, 64, eps=1e-6)
        self.head = nn.Linear(12 * 12 * 64, 10)

    def forward(self, inputs):
        x = inputs["image"]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        x = x.to(self.head.weight.device, torch.float32).unsqueeze(1)
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        x = self.group_norm(x)
        x = F.max_pool2d(x, 2, 2)
        if self.training:
            x = F.dropout(x, 0.25, training=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(x)

    def init_parameters(self, generator):
        """flax's init: lecun-normal kernels, zero biases, unit norm
        scales."""
        with torch.no_grad():
            for conv in (self.conv0, self.conv1):
                cout, cin, kh, kw = conv.weight.shape
                lecun_normal_(conv.weight, cin * kh * kw, generator)
                conv.bias.zero_()
            lecun_normal_(self.head.weight, self.head.weight.shape[1],
                          generator)
            self.head.bias.zero_()
            self.group_norm.weight.fill_(1.0)
            self.group_norm.bias.zero_()
        return self


def loss(output, labels):
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=output.device, dtype=torch.long).reshape(-1)
    return F.cross_entropy(output, labels)


def _sgd(params, lr):
    return torch.optim.SGD(params, lr=lr)


def optimizer(lr=0.01):
    return functools.partial(_sgd, lr=lr)


def dataset_fn(dataset, mode, _):
    feature_spec = {"image": FixedLenFeature([28, 28], np.float32)}
    if mode != Mode.PREDICTION:
        feature_spec["label"] = FixedLenFeature([1], np.int64)

    def _parse_data(record):
        r = parse_example(record, feature_spec)
        features = {"image": (r["image"] / 255.0).astype(np.float32)}
        if mode == Mode.PREDICTION:
            return features
        return features, r["label"].astype(np.int32)

    dataset = dataset.map(_parse_data)
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
