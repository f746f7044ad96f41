"""The device mesh, the counterpart of ``elasticdl_tpu/parallel/mesh.py``,
in its one-device form.

The reference's ``create_mesh`` builds a ``jax.sharding.Mesh`` over the
devices a job uses, with named axes (``data``, ``model``, ``seq``), and
the zoo's hooks (``build_distributed_model(mesh)``, ``param_shardings(
mesh)``) receive it. The port runs on one card, so its :class:`Mesh` is
that mesh over one device: the axis names, their sizes (all 1) and the
device list. A mesh of more than one device raises
``NotImplementedError`` (ROADMAP A9).

:class:`PartitionSpec` names, per tensor dimension, the mesh axis it is
split over (or None); :class:`PadDim0` is the reference's wrapper
(``parallel/elastic.py``) that lets the elastic plane pad dim 0 to a
world size it does not divide. On a mesh of one device every spec is
whole: :func:`spec_is_whole` says so, and the trainer places every
parameter whole on the card.
"""

import numpy as np

from elasticdl_tpu_torch.common.device import resolve_device


def _not_ported(n):
    return NotImplementedError(
        "a mesh of %d devices is not ported yet (ROADMAP A9: the port "
        "runs on one card)" % n
    )


class Mesh:
    """A mesh of one device: ``axis_names``, ``shape`` ({axis: size}),
    ``devices`` (an array of ``torch.device`` of the mesh's shape)."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.size != 1:
            raise _not_ported(devices.size)
        if devices.ndim != len(axis_names):
            raise ValueError(
                "devices of rank %d for axes %s"
                % (devices.ndim, tuple(axis_names))
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """The mesh's one device."""
        return self.devices.reshape(-1)[0]

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, self.device)


def create_mesh(mesh_shape=None, devices=None):
    """Build the one-device :class:`Mesh`: ``mesh_shape`` {axis_name:
    size} (default one ``data`` axis), ``devices`` the device list
    (default: the card). A mesh of more than one device raises
    ``NotImplementedError``."""
    devices = [resolve_device(d) for d in (devices or ["cuda"])]
    mesh_shape = mesh_shape or {"data": len(devices)}
    n = int(np.prod(list(mesh_shape.values())))
    if n != 1 or len(devices) != 1:
        raise _not_ported(max(n, len(devices)))
    dev_array = np.empty((1,) * len(mesh_shape), dtype=object)
    dev_array.reshape(-1)[0] = devices[0]
    return Mesh(dev_array, tuple(mesh_shape))


class PartitionSpec(tuple):
    """Per dimension, the mesh axis (or tuple of axes) it is split over,
    or None: ``PartitionSpec("data", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class PadDim0:
    """The reference's marker for a spec whose dim 0 the elastic plane
    may zero-pad to a multiple of the world size."""

    def __init__(self, spec):
        self.spec = spec

    def __repr__(self):
        return "PadDim0(%r)" % (self.spec,)


def spec_axes(spec):
    """The mesh axes a spec names (a :class:`PadDim0` unwrapped)."""
    if isinstance(spec, PadDim0):
        spec = spec.spec
    axes = []
    for entry in spec or ():
        if entry is None:
            continue
        axes.extend(entry if isinstance(entry, (tuple, list)) else [entry])
    return axes


def spec_is_whole(spec, mesh):
    """True when ``spec`` splits nothing on ``mesh``: every axis it names
    exists and has size 1. An axis the mesh lacks raises ValueError."""
    shape = mesh.shape
    for axis in spec_axes(spec):
        if axis not in shape:
            raise ValueError(
                "spec %r names axis %r, which mesh %r lacks"
                % (spec, axis, mesh)
            )
    return all(shape[axis] == 1 for axis in spec_axes(spec))


def flatten_specs(specs, prefix=""):
    """A nested {module: {param: spec}} tree (the reference's
    ``param_shardings`` form) -> {state_dict key: spec}."""
    flat = {}
    for name, value in specs.items():
        key = prefix + name
        if isinstance(value, dict):
            flat.update(flatten_specs(value, key + "."))
        else:
            flat[key] = value
    return flat
