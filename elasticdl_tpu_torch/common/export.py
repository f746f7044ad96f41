"""Export artifacts, in the format of ``elasticdl_tpu/common/export.py``.

An artifact is a directory holding ``model.chkpt`` (the EDLC tensor-frame
codec, common/model_utils.py) and ``MANIFEST.json`` (format version, model
version, leaf spec, provenance metadata, artifact listing), written last
and atomically so its presence marks a complete artifact.

The port reads and writes only the ``model.chkpt`` member. Its writer
records ``"params": null`` and ``"serving_fn": null`` (an Orbax tree and a
serialized JAX function need JAX), and the reference's ``load_export``
falls back to ``model.chkpt`` when ``params`` is null — so artifacts cross
between the packages both ways. Arrays are named by the reference's
``/``-joined parameter paths (``block_0/query/kernel``);
common/convert.py maps them to a module's ``state_dict``.

:func:`export_train_state` is the training half: the SAVE_MODEL task's
export of a train state. As in the reference, ``model.chkpt`` carries the
parameters only; the reference bakes a BatchNorm model's running
statistics into its ``serving_fn.jaxexport`` member, which has no
counterpart here, so a BatchNorm model's artifact from the port has no
running statistics.
"""

import json
import os
import time
from dataclasses import dataclass

import torch

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    LEGACY_CHKPT,
    MANIFEST_NAME,
    load_from_checkpoint_file,
    save_checkpoint_to_file,
)
from elasticdl_tpu_torch.common.tensor import host_words

EXPORT_FORMAT = "elasticdl-tpu-export"
EXPORT_FORMAT_VERSION = 1


def _leaf_spec(named):
    spec = {}
    for name, value in named.items():
        host, dtype = host_words(value)
        spec[name] = {"shape": list(host.shape), "dtype": dtype}
    return spec


def export_model(export_dir, named, version, metadata=None):
    """Write an artifact from ``named`` ({reference path name: numpy
    array or torch tensor}); returns the manifest dict."""
    export_dir = os.path.abspath(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    save_checkpoint_to_file(
        named, version, os.path.join(export_dir, LEGACY_CHKPT)
    )
    manifest = {
        "format": EXPORT_FORMAT,
        "format_version": EXPORT_FORMAT_VERSION,
        "model_version": int(version),
        "created_unix": int(time.time()),
        "torch_version": torch.__version__,
        "metadata": dict(metadata or {}),
        "extra_named": [],
        "leaves": _leaf_spec(named),
        "artifacts": {
            "params": None,
            "legacy_checkpoint": LEGACY_CHKPT,
            "serving_fn": None,
        },
    }
    tmp = os.path.join(export_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(export_dir, MANIFEST_NAME))
    logger.info("exported model v%d to %s", version, export_dir)
    return manifest


def export_train_state(export_dir, ts, model=None, metadata=None):
    """Write an artifact of train state ``ts`` (its parameters, under the
    reference's names, at its version); ``model`` supplies the head
    layout a transformer's attention weights need."""
    from elasticdl_tpu_torch.common.convert import to_named

    named = to_named(
        ts.params,
        getattr(model, "num_heads", None),
        getattr(model, "head_dim", None),
    )
    return export_model(export_dir, named, ts.version, metadata=metadata)


def export_provenance(model_zoo, model_def, model_params):
    """The manifest metadata a scorer rebuilds the model from."""
    return {
        "model_zoo": model_zoo,
        "model_def": model_def,
        "model_params": model_params or "",
    }


@dataclass
class ExportedModel:
    """A loaded artifact: its manifest and its flat named arrays."""

    export_dir: str
    manifest: dict
    named: dict

    @property
    def version(self):
        return self.manifest["model_version"]

    @property
    def metadata(self):
        return self.manifest["metadata"]

    def has_serving_fn(self):
        return bool(self.manifest["artifacts"].get("serving_fn"))


def load_export(export_dir):
    """Load an artifact through its manifest and ``model.chkpt`` member
    (an Orbax ``params/`` member, if any, is not read)."""
    export_dir = os.path.abspath(export_dir)
    with open(os.path.join(export_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format") != EXPORT_FORMAT:
        raise ValueError(
            "%s is not an %s artifact" % (export_dir, EXPORT_FORMAT)
        )
    if manifest.get("format_version", 0) > EXPORT_FORMAT_VERSION:
        raise ValueError(
            "export format v%s is newer than this loader (v%d)"
            % (manifest.get("format_version"), EXPORT_FORMAT_VERSION)
        )
    _, named = load_from_checkpoint_file(export_dir)
    return ExportedModel(
        export_dir=export_dir, manifest=manifest, named=named
    )
