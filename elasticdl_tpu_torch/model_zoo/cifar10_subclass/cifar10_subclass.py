"""CIFAR-10 CNN, the port of
``model_zoo/cifar10_subclass/cifar10_subclass.py``: three pairs of "SAME"
3x3 convolutions with bias (32, 64 and 128 filters), each followed by
``GroupNorm(8)`` at epsilon 1e-6 and ReLU, each pair by a 2x2 max pool and
dropout 0.2 / 0.3 / 0.4 in training; then ``Dense(10)`` over the features
flattened in NHWC order, as flax flattens them. SGD at 0.1; images are
divided by 255 on the host.

Layers are named ``conv{j}``/``group_norm{j}`` (flax's ``Conv_{j}`` and
``GroupNorm_{j}``, j = 0..5) and ``head`` (``Dense_0``): the
``cifar10`` weight map of ``common/convert.py``. A 3x3 "SAME" convolution
at stride 1 pads one pixel on every side, symmetric as in XLA.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.nn.layers import Conv, lecun_normal_

STAGES = ((32, 0.2), (64, 0.3), (128, 0.4))  # (filters, dropout rate)


class CustomModel(nn.Module):
    def __init__(self):
        super().__init__()
        cin, j = 3, 0
        for filters, _ in STAGES:
            for _ in range(2):
                setattr(self, "conv%d" % j,
                        Conv(cin, filters, 3, padding="SAME", bias=True))
                setattr(self, "group_norm%d" % j,
                        nn.GroupNorm(8, filters, eps=1e-6))
                cin, j = filters, j + 1
        self.head = nn.Linear(4 * 4 * cin, 10)

    def forward(self, inputs):
        x = inputs["image"]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        x = x.to(self.head.weight.device, torch.float32).permute(0, 3, 1, 2)
        j = 0
        for _, rate in STAGES:
            for _ in range(2):
                x = getattr(self, "conv%d" % j)(x)
                x = F.relu(getattr(self, "group_norm%d" % j)(x))
                j += 1
            x = F.max_pool2d(x, 2, 2)
            if self.training:
                x = F.dropout(x, rate, training=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(x)

    def init_parameters(self, generator):
        """flax's init: lecun-normal kernels, zero biases, unit norm
        scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    cout, cin, kh, kw = m.weight.shape
                    lecun_normal_(m.weight, cin * kh * kw, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            lecun_normal_(self.head.weight, self.head.weight.shape[1],
                          generator)
            self.head.bias.zero_()
        return self


def loss(output, labels):
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=output.device, dtype=torch.long).reshape(-1)
    return F.cross_entropy(output, labels)


def _sgd(params, lr):
    return torch.optim.SGD(params, lr=lr)


def optimizer(lr=0.1):
    return functools.partial(_sgd, lr=lr)


def dataset_fn(dataset, mode, _):
    feature_spec = {"image": FixedLenFeature([32, 32, 3], np.float32)}
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
