"""ResNet-50, the port of ``model_zoo/resnet50_subclass/resnet50_model.py``.

The same function as the flax model, layer for layer:

- a stem of a 7x7/2 convolution padded (3, 3), BatchNorm, ReLU and a 3x3/2
  max pool with flax's "SAME" padding: at an even size that pads one
  -inf row and column after the input and none before, so the pool pads
  explicitly and then pools (``nn.MaxPool2d(3, 2, padding=1)`` would
  shift every window by one pixel);
- 3-4-6-3 bottleneck blocks whose stride sits on the first 1x1
  convolution (and on the projection), not on the 3x3 as in torchvision;
  the last norm of each block starts with a zero scale;
- a spatial mean, then a float32 ``Dense`` and a softmax.

uint8 images are cast to the compute dtype and scaled by 1/255 (a
constant in that dtype, as JAX rounds a weak scalar) on the device.
Images arrive NHWC; ``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
already ``torch.channels_last``, and every convolution takes its weight
in that format, so cuDNN runs its NHWC kernels without layout copies.

Parameters are float32 and are cast to the compute ``dtype`` at use, as
flax's ``promote_dtype`` does. The layers (``nn/layers.py``) are flax's:
BatchNorm keeps the biased batch variance in its running average and
returns its new statistics through ``nn/model_api.apply_model``.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    as_dtype,
    lecun_normal_,
    max_pool_same,
)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with an optional projection shortcut
    (``conv3``/``norm3``); the stride is on the first 1x1."""

    def __init__(self, cin, filters, strides=1, projection=False,
                 dtype=torch.float32):
        super().__init__()
        dtype = as_dtype(dtype)
        self.projection = projection
        self.conv0 = Conv(cin, filters, 1, strides, dtype=dtype)
        self.norm0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, 1, dtype=dtype)
        self.norm1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters * 4, 1, 1, dtype=dtype)
        self.norm2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        if projection:
            self.conv3 = Conv(cin, filters * 4, 1, strides, dtype=dtype)
            self.norm3 = BatchNorm(filters * 4, dtype)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        if self.projection:
            residual = self.norm3(self.conv3(residual))
        return F.relu(y + residual)


STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


class ResNet50(nn.Module):
    """ResNet-50 body: 3-4-6-3 bottleneck stages, softmax head."""

    def __init__(self, num_classes=10, dtype=torch.float32):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.conv0 = Conv(3, 64, 7, 2, padding=(3, 3), dtype=dtype)
        self.norm0 = BatchNorm(64, dtype)
        blocks, cin = [], 64
        for i, (filters, n) in enumerate(STAGES):
            for j in range(n):
                blocks.append(
                    BottleneckBlock(
                        cin, filters, strides=(2 if i and not j else 1),
                        projection=(j == 0), dtype=dtype,
                    )
                )
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x):
        """``x``: a ``{"image": (B, H, W, 3)}`` dict or the images, uint8
        or float, NHWC -> (B, num_classes) float32 probabilities."""
        if isinstance(x, dict):
            x = x["image"]
        device = self.conv0.weight.device
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        x = x.to(device).permute(0, 3, 1, 2)  # NHWC -> channels_last NCHW
        if x.dtype == torch.uint8:
            scale = torch.tensor(1.0 / 255.0, dtype=self.dtype)
            x = x.to(self.dtype) * scale
        else:
            x = x.to(self.dtype)
        x = F.relu(self.norm0(self.conv0(x)))
        x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        # the spatial mean in the compute dtype (accumulated in at least
        # float32), then the float32 head
        acc = torch.promote_types(self.dtype, torch.float32)
        x = x.mean(dim=(2, 3), dtype=acc).to(self.dtype).float()
        return F.softmax(F.linear(x, self.head.weight, self.head.bias), -1)

    def init_parameters(self, generator):
        return init_parameters(self, generator)


def init_parameters(model, generator):
    """Random weights from ``generator`` at flax's init: lecun-normal
    convolution and dense kernels, zero biases, BatchNorm scales one
    (zero for each block's last norm), running statistics zero mean and
    unit variance."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                cout, cin, kh, kw = m.weight.shape
                lecun_normal_(m.weight, cin * kh * kw, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.weight.shape[1], generator)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(0.0 if m.zero_scale else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
