"""Export artifacts, in the format of ``elasticdl_tpu/common/export.py``.

An artifact is a directory holding ``model.chkpt`` (the EDLC tensor-frame
codec, common/model_utils.py), optionally ``serving_fn.pt2`` (the serving
member) and ``MANIFEST.json`` (format version, model version, leaf spec,
provenance metadata, artifact listing), written last and atomically so
its presence marks a complete artifact.

- ``model.chkpt`` carries the parameters, named by the reference's
  ``/``-joined parameter paths (``block_0/query/kernel``);
  common/convert.py maps them to a module's ``state_dict``. The writer
  records ``"params": null`` (an Orbax tree needs JAX), and the
  reference's ``load_export`` falls back to ``model.chkpt`` when
  ``params`` is null, so artifacts cross between the packages both ways.
- ``serving_fn.pt2`` is the port's counterpart of the reference's
  ``serving_fn.jaxexport``: the model's inference forward in eval mode,
  with its parameters and buffers (a BatchNorm model's running
  statistics among them), exported with ``torch.export`` over one
  example features batch with the batch dimension dynamic, and saved
  with ``torch.export.save``. A fresh process serves it without the
  model's source (:meth:`ExportedModel.serve`). It is listed under
  ``artifacts["torch_serving_fn"]``, its input signature and the device
  it was traced on under ``torch_serving``; ``artifacts["serving_fn"]``
  stays null and ``format_version`` 1, so the reference's loader reads
  the artifact as a params-only one and never tries to deserialize the
  member as StableHLO. As in the reference the member is best-effort: a
  forward that cannot be traced logs a warning and leaves a params-only
  artifact.

:func:`export_train_state` is the training half: the SAVE_MODEL task's
export of a train state, with the member when the worker hands it the
model and one example batch (:func:`example_batch_for_export`).
"""

import copy
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from elasticdl_tpu_torch.common.dtypes import (
    dtype_name,
    dtype_name_to_torch,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.model_utils import (
    LEGACY_CHKPT,
    MANIFEST_NAME,
    load_from_checkpoint_file,
    save_checkpoint_to_file,
)

EXPORT_FORMAT = "elasticdl-tpu-export"
EXPORT_FORMAT_VERSION = 1
SERVING_FILE = "serving_fn.pt2"
SERVING_KEY = "torch_serving_fn"  # the member's key under "artifacts"
_AUX_LOSS = "aux_loss"  # training/step.py's AUX_LOSS_COLLECTION


def _leaf_spec(named):
    spec = {}
    for name, value in named.items():
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        spec[name] = {"shape": [int(d) for d in value.shape],
                      "dtype": dtype_name(value.dtype)}
    return spec


def make_serving_module(model, params, state):
    """``model`` in eval mode holding ``params`` and ``state`` ({name:
    tensor}, as ``named_parameters()`` and ``named_buffers()`` name them):
    the module the serving member is traced from. It is a copy whose
    parameters and buffers are the given tensors (no copy of the model's
    own), so the caller's module is left as it was."""
    memo = {}
    for name, p in model.named_parameters():
        memo[id(p)] = torch.nn.Parameter(
            params[name].detach(), requires_grad=False
        )
    for name, b in model.named_buffers():
        if name in (state or {}):
            memo[id(b)] = state[name].detach()
    served = copy.deepcopy(model, memo).eval()
    # the auxiliary losses a training forward writes (the MoE's balance
    # loss) are no input of a forward: they stay out of the served graph
    for module in served.modules():
        for name, _ in list(module.named_buffers(recurse=False)):
            if name not in module._non_persistent_buffers_set:
                continue
            if _AUX_LOSS in _path_of(served, module).split("."):
                del module._buffers[name]
    return served


def _path_of(root, module):
    for path, m in root.named_modules():
        if m is module:
            return path
    return ""


def _module_device(module):
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


def _leaves(fn, features):
    """``fn(name, leaf)`` over a features batch: a ``{name: leaf}`` dict,
    or one leaf (its name None)."""
    if isinstance(features, dict):
        return {k: fn(k, v) for k, v in features.items()}
    return fn(None, features)


def _feature_tensors(features, device, spec=None):
    """``features`` as tensors on ``device``, each cast to the dtype its
    ``spec`` entry names where one is given."""
    def one(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            # wire and reader arrays may be read-only views: one copy
            leaf = torch.from_numpy(np.array(leaf))
        entry = spec if name is None else (spec or {}).get(name)
        if entry is None:
            return leaf.to(device)
        return leaf.to(device, dtype_name_to_torch(entry["dtype"]))

    return _leaves(one, features)


def _export_serving_fn(path, module, example_features):
    """``torch.export`` ``module``'s forward over ``example_features``
    with a dynamic batch dimension (the other dimensions static, as the
    reference's ``symbolic_shape("batch")``), and save it at ``path``.
    Returns the manifest's ``torch_serving`` entry, or None when the
    forward cannot be traced (logged: the artifact is then params-only,
    as the reference's is)."""
    # an exported graph that takes the flash branch holds its op
    from elasticdl_tpu_torch.ops import flash_attention  # noqa: F401

    try:
        device = _module_device(module)
        features = _feature_tensors(example_features, device)
        # torch.export specializes a dimension traced at 0 or 1
        features = _leaves(
            lambda _, t: t if t.shape[0] > 1 else t.repeat_interleave(2, 0),
            features,
        )
        batch = torch.export.Dim("batch", min=1)
        with torch.no_grad():
            program = torch.export.export(
                module.eval(), (features,),
                dynamic_shapes=(_leaves(lambda *_: {0: batch}, features),),
            )
        torch.export.save(program, path)
    except Exception as e:  # noqa: BLE001 - optional member, reported
        logger.warning(
            "serving-fn export skipped (params-only artifact): %s", e
        )
        return None
    signature = _leaves(
        lambda _, t: {"dtype": dtype_name(t.dtype),
                      "shape": [None] + [int(d) for d in t.shape[1:]]},
        features,
    )
    return {"features": signature, "device": str(device)}


def export_model(export_dir, named, version, metadata=None, extra_named=None,
                 serving_module=None, example_features=None):
    """Write an artifact from ``named`` ({reference path name: numpy
    array or torch tensor}); returns the manifest dict. ``extra_named``
    ({name: array}, the master-held embedding tables' ``edl_embedding:``
    arrays) goes into ``model.chkpt`` only, not the leaf spec, as in the
    reference: ``--checkpoint_filename_for_init`` restores the tables
    from it. ``serving_module`` (:func:`make_serving_module`) with one
    ``example_features`` batch adds the serving member."""
    export_dir = os.path.abspath(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    save_checkpoint_to_file(
        {**named, **(extra_named or {})},
        version,
        os.path.join(export_dir, LEGACY_CHKPT),
    )
    serving = None
    if serving_module is not None and example_features is not None:
        serving = _export_serving_fn(
            os.path.join(export_dir, SERVING_FILE), serving_module,
            example_features,
        )
    manifest = {
        "format": EXPORT_FORMAT,
        "format_version": EXPORT_FORMAT_VERSION,
        "model_version": int(version),
        "created_unix": int(time.time()),
        "torch_version": torch.__version__,
        "metadata": dict(metadata or {}),
        "extra_named": sorted(extra_named) if extra_named else [],
        "leaves": _leaf_spec(named),
        "artifacts": {
            "params": None,
            "legacy_checkpoint": LEGACY_CHKPT,
            "serving_fn": None,
            SERVING_KEY: SERVING_FILE if serving else None,
        },
    }
    if serving:
        manifest["torch_serving"] = serving
    tmp = os.path.join(export_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(export_dir, MANIFEST_NAME))
    logger.info(
        "exported model v%d to %s (serving member: %s)", version,
        export_dir, bool(serving),
    )
    return manifest


def export_train_state(export_dir, ts, model=None, metadata=None,
                       example_features=None, serving_ts=None):
    """Write an artifact of train state ``ts`` (its parameters, under the
    reference's names, at its version); ``model`` supplies the head
    layout a transformer's attention weights need. With ``model`` and
    ``example_features`` the artifact carries the serving member, traced
    from ``serving_ts`` (by default ``ts``: the worker passes its state
    on the device, so the member is traced where the worker runs)."""
    from elasticdl_tpu_torch.common.convert import to_named

    named = to_named(
        ts.params,
        getattr(model, "num_heads", None),
        getattr(model, "head_dim", None),
    )
    serving_module = None
    if model is not None and example_features is not None:
        live = serving_ts if serving_ts is not None else ts
        serving_module = make_serving_module(model, live.params, live.state)
    return export_model(
        export_dir, named, ts.version, metadata=metadata,
        serving_module=serving_module, example_features=example_features,
    )


def export_provenance(model_zoo, model_def, model_params):
    """The manifest metadata a scorer rebuilds the model from."""
    return {
        "model_zoo": model_zoo,
        "model_def": model_def,
        "model_params": model_params or "",
    }


def example_batch_for_export(dataset, dataset_fn, metadata, minibatch_size,
                             mode):
    """One prediction-mode batch of the SAVE_MODEL task's records: what
    the serving member is traced from, as the reference's is. None (a
    params-only artifact) when the task has no records or the pipeline
    fails."""
    if not dataset:
        return None
    try:
        for features in dataset_fn(dataset, mode, metadata).batch(
            max(1, minibatch_size)
        ):
            return features
    except Exception as e:  # noqa: BLE001 - optional member
        logger.warning("no example batch for serving export: %s", e)
    return None


@dataclass
class ExportedModel:
    """A loaded artifact: its manifest and its flat named arrays; with
    the serving member, :meth:`serve` answers without the model's
    source."""

    export_dir: str
    manifest: dict
    named: dict
    _programs: dict = field(default_factory=dict, repr=False)
    _mu: object = field(default_factory=threading.Lock, repr=False)

    @property
    def version(self):
        return self.manifest["model_version"]

    @property
    def metadata(self):
        return self.manifest["metadata"]

    def has_serving_fn(self):
        """True when the artifact carries the reference's JAX member
        (``serving_fn.jaxexport``), which the port cannot read."""
        return bool(self.manifest["artifacts"].get("serving_fn"))

    def has_torch_serving_fn(self):
        """True when the artifact carries the port's member."""
        return bool(self.manifest["artifacts"].get(SERVING_KEY))

    def serving_program(self, device="cuda"):
        """The member as a callable module on ``device``, loaded once per
        device. A member traced on another device is moved there
        (parameters, buffers, constants and the devices written into its
        graph)."""
        from elasticdl_tpu_torch.common.device import resolve_device

        device = resolve_device(device)
        key = str(device)
        with self._mu:
            if key in self._programs:
                return self._programs[key]
            if not self.has_torch_serving_fn():
                raise RuntimeError(
                    "export at %s carries no serving member; rebuild the "
                    "model from metadata['model_def'] and apply params"
                    % self.export_dir
                )
            # a graph holding the flash op dispatches to this module
            from elasticdl_tpu_torch.ops import flash_attention  # noqa: F401

            path = os.path.join(
                self.export_dir, self.manifest["artifacts"][SERVING_KEY]
            )
            traced = torch.device(self.manifest["torch_serving"]["device"])
            try:
                program = torch.export.load(path)
            except Exception as e:
                raise RuntimeError(
                    "the serving member at %s (traced on %s) cannot be "
                    "loaded by torch %s on this host: %s"
                    % (path, traced, torch.__version__, e)
                ) from e
            if _same_device(traced, device):
                module = program.module()
            else:
                try:
                    from torch.export.passes import move_to_device_pass
                except ImportError as e:
                    raise NotImplementedError(
                        "the serving member at %s was traced on %s; moving "
                        "it to %s needs torch.export.passes."
                        "move_to_device_pass, which torch %s lacks"
                        % (path, traced, device, torch.__version__)
                    ) from e
                module = move_to_device_pass(program, str(device)).module()
            self._programs[key] = module
            return module

    def serve(self, features, device="cuda"):
        """The member's output for ``features`` (a ``{name: array}``
        dict or one array of any batch size, numpy or torch) on
        ``device``; each feature is cast to the dtype it was traced
        with."""
        module = self.serving_program(device)
        spec = self.manifest["torch_serving"]["features"]
        inputs = _feature_tensors(features, _module_device(module), spec)
        with torch.no_grad():
            return module(inputs)


def _same_device(a, b):
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current
    )


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
