"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for the card where there is none raises: a run never drifts onto
the CPU unannounced. The CPU is used only when the caller names it, as
the tests do.

float32 math is decided here too, once for every entry point: each
device resolution calls :func:`set_float32_math`, which turns TF32 off
for cuBLAS matrix products and cuDNN convolutions. A float32 model then
computes in full float32 on the card, as the JAX package's float32
results it is held against do; bf16 models are unaffected.
"""

import torch


def set_float32_math():
    """TF32 off for cuBLAS and cuDNN (process-wide): float32 products
    and convolutions keep their 23-bit mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``; raises when CUDA is asked for and unavailable.
    Sets the float32 math (:func:`set_float32_math`)."""
    set_float32_math()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch sees no CUDA card; pass "
                "device='cpu' to run on the CPU" % str(device)
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                "device %r requested but only %d CUDA card(s) are visible"
                % (str(device), torch.cuda.device_count())
            )
    elif dev.type != "cpu":
        raise ValueError(
            "unsupported device %r (use 'cuda' or 'cpu')" % str(device)
        )
    return dev
