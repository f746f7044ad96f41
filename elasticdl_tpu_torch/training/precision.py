"""Mixed-precision policy, the counterpart of
``elasticdl_tpu/training/precision.py``.

- ``param_dtype``   — what the parameters are stored in between steps.
- ``compute_dtype`` — what enters the model's forward.
- ``output_dtype``  — what the loss sees.

Casting parameters down inside the differentiated function is itself
differentiable, so gradients and optimizer state stay in
``param_dtype``. Integer and bool leaves pass through. Without a policy
(``None``) nothing is cast: a bf16 model's loss then runs on its bf16
output, as in the reference.
"""

import dataclasses

import numpy as np
import torch


def _cast_leaf(leaf, dtype):
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
        leaf = torch.from_numpy(np.array(leaf))
    if (
        isinstance(leaf, torch.Tensor)
        and leaf.is_floating_point()
        and leaf.dtype != dtype
    ):
        return leaf.to(dtype)
    return leaf


def cast_floats(tree, dtype):
    """Cast every float leaf of a dict/list/tuple tree to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return _cast_leaf(tree, dtype)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Float-leaf casting rules; integer/bool leaves pass through."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Params/features entering the model's forward pass."""
        return cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        """Back to storage dtype (e.g. restored checkpoints)."""
        return cast_floats(tree, self.param_dtype)

    def cast_output(self, tree):
        """Model output entering the loss."""
        return cast_floats(tree, self.output_dtype)


_PRESETS = {
    # f32 everywhere
    "float32": Policy(torch.float32, torch.float32, torch.float32),
    # f32 masters, bf16 matmuls, f32 loss
    "mixed_bfloat16": Policy(torch.float32, torch.bfloat16, torch.float32),
    # bf16 masters too: halves parameter memory, loses small updates
    "bfloat16": Policy(torch.bfloat16, torch.bfloat16, torch.float32),
}


def get_policy(name_or_policy):
    """Resolve a preset name (or pass a Policy through). None -> None."""
    if name_or_policy is None or isinstance(name_or_policy, Policy):
        return name_or_policy
    try:
        return _PRESETS[name_or_policy]
    except KeyError:
        raise ValueError(
            "unknown precision policy %r (have: %s)"
            % (name_or_policy, ", ".join(sorted(_PRESETS)))
        )
