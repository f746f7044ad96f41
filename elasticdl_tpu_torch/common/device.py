"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for the card where there is none raises: a run never drifts onto
the CPU unannounced. The CPU is used only when the caller names it, as
the tests do.
"""

import torch


def resolve_device(device="cuda"):
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``; raises when CUDA is asked for and unavailable."""
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
