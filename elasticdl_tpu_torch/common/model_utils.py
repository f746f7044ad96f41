"""Model-zoo loading and the checkpoint file codec.

The counterpart of ``elasticdl_tpu/common/model_utils.py``:
``--model_params`` parsing, resolving a dotted ``model_def`` to a model,
the zoo's training contract as a :class:`ModelSpec`, and the ``EDLC``
checkpoint codec (``model.chkpt`` in every export artifact) that both
packages read and write.

A ``model_def`` such as ``transformer_lm.transformer_lm.custom_model``
resolves against the port's own zoo (``elasticdl_tpu_torch.model_zoo``)
unless a zoo directory is given, in which case the module file is loaded
from there as the reference does.
"""

import importlib
import importlib.util
import json
import os
import struct

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    deserialize_tensors,
    serialize_tensors,
)

ZOO_PACKAGE = "elasticdl_tpu_torch.model_zoo"

def load_module(module_file):
    """Load a zoo module from a file."""
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def get_module_file_path(model_zoo, spec_key):
    """``"a.b.custom_model"`` -> ``{zoo}/a/b.py``."""
    return os.path.join(model_zoo, *spec_key.split(".")[:-1]) + ".py"


def get_dict_from_params_str(params_str):
    """Parse ``"a=1,b='x'"`` into a kwargs dict (None when empty)."""
    if not params_str:
        return None
    kv = {}
    for kv_str in params_str.split(","):
        k, _, v = kv_str.partition("=")
        try:
            kv[k.strip()] = eval(v)  # noqa: S307 - same trust model as argparse
        except Exception:
            kv[k.strip()] = v
    return kv


def load_zoo_module(model_def, model_zoo=None):
    """The module that defines ``model_def``: from the port's zoo
    package, or from the file under ``model_zoo`` when one is given."""
    if model_zoo:
        return load_module(get_module_file_path(model_zoo, model_def))
    parts = model_def.split(".")[:-1]
    if not parts:
        raise ValueError(
            "model_def %r names no module (expected module.path.symbol)"
            % model_def
        )
    return importlib.import_module(".".join([ZOO_PACKAGE] + parts))


def build_model(model_def, model_params=None, model_zoo=None):
    """Instantiate ``model_def``: call it with the parsed params if a
    function, else construct it."""
    module = load_zoo_module(model_def, model_zoo)
    name = model_def.split(".")[-1]
    fn = getattr(module, name, None)
    if fn is None:
        raise ValueError(
            "Cannot find the model definition %s in the module" % model_def
        )
    return fn(**(get_dict_from_params_str(model_params) or {}))


def _get_spec_value(spec_key, model_zoo, default_module, required=False):
    """Resolve a spec key to a symbol: a single name in the model-def
    module, a dotted key in its own module."""
    parts = spec_key.split(".")
    if len(parts) == 1:
        module = default_module
    else:
        module = load_zoo_module(spec_key, model_zoo)
    value = getattr(module, parts[-1], None)
    if required and value is None:
        raise ValueError(
            "Missing required spec key %s in the module: %s"
            % (parts[-1], spec_key)
        )
    return value


class ModelSpec:
    """The resolved user contract for one job."""

    def __init__(
        self,
        model,
        dataset_fn,
        loss,
        optimizer,
        eval_metrics_fn,
        prediction_outputs_processor,
    ):
        self.model = model
        self.dataset_fn = dataset_fn
        self.loss = loss
        self.optimizer = optimizer
        self.eval_metrics_fn = eval_metrics_fn
        self.prediction_outputs_processor = prediction_outputs_processor


def get_model_spec(
    model_zoo,
    model_def,
    model_params=None,
    dataset_fn="dataset_fn",
    loss="loss",
    optimizer="optimizer",
    eval_metrics_fn="eval_metrics_fn",
    prediction_outputs_processor="PredictionOutputsProcessor",
    build=True,
):
    """Resolve the full model spec from the port's zoo (``model_zoo``
    empty) or a zoo directory. ``optimizer`` resolves to the zoo's
    ``optimizer(lr)``, which returns a factory ``params -> Optimizer``.
    ``build=False`` leaves ``model`` None, for a caller that builds the
    model through a zoo hook (``build_distributed_model``,
    ``build_host_model``) instead of ``model_def``."""
    default_module = load_zoo_module(model_def, model_zoo)
    model = (
        build_model(model_def, model_params, model_zoo) if build else None
    )
    pop = _get_spec_value(
        prediction_outputs_processor, model_zoo, default_module
    )
    # a class or an instance in the zoo module
    pop = pop() if isinstance(pop, type) else pop
    from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
        BasePredictionOutputsProcessor,
    )

    if pop is not None and not isinstance(
        pop, BasePredictionOutputsProcessor
    ):
        logger.warning(
            "prediction_outputs_processor is not inherited from "
            "BasePredictionOutputsProcessor. Prediction outputs may not "
            "be processed correctly."
        )
    return ModelSpec(
        model=model,
        dataset_fn=_get_spec_value(
            dataset_fn, model_zoo, default_module, required=True
        ),
        loss=_get_spec_value(loss, model_zoo, default_module, required=True),
        optimizer=_get_spec_value(
            optimizer, model_zoo, default_module, required=True
        ),
        eval_metrics_fn=_get_spec_value(
            eval_metrics_fn, model_zoo, default_module, required=True
        ),
        prediction_outputs_processor=pop,
    )


# ---------------------------------------------------------------------------
# Checkpoint file codec: {version, named arrays} <-> one .chkpt file.
# ---------------------------------------------------------------------------

_CKPT_MAGIC = b"EDLC"
LEGACY_CHKPT = "model.chkpt"
MANIFEST_NAME = "MANIFEST.json"


def save_checkpoint_to_file(named_arrays, version, file_path):
    payload = serialize_tensors(
        Tensor(name, values) for name, values in sorted(named_arrays.items())
    )
    with open(file_path, "wb") as f:
        f.write(_CKPT_MAGIC)
        f.write(struct.pack("<q", int(version)))
        f.write(payload)


def load_from_checkpoint_file(file_path):
    """Returns (version, {name: array}). Also accepts an export artifact
    directory: its legacy-checkpoint member is this codec."""
    if os.path.isdir(file_path):
        member = LEGACY_CHKPT
        try:
            with open(os.path.join(file_path, MANIFEST_NAME)) as f:
                member = (
                    json.load(f)["artifacts"].get("legacy_checkpoint")
                    or member
                )
        except (OSError, ValueError, KeyError):
            pass
        candidate = os.path.join(file_path, member)
        if not os.path.exists(candidate):
            raise ValueError(
                "%s is a directory without a %s member (not an export "
                "artifact)" % (file_path, member)
            )
        file_path = candidate
    with open(file_path, "rb") as f:
        data = f.read()
    if data[:4] != _CKPT_MAGIC:
        raise ValueError("not an elasticdl checkpoint: %s" % file_path)
    (version,) = struct.unpack_from("<q", data, 4)
    tensors = deserialize_tensors(memoryview(data)[12:])
    return version, {t.name: t.values for t in tensors}
