"""The device mesh, the counterpart of ``elasticdl_tpu/parallel/mesh.py``.

The reference's ``create_mesh`` builds a ``jax.sharding.Mesh`` over the
devices a job uses, with named axes (``data``, ``model``, ``seq``,
``expert``), and the zoo's hooks (``build_distributed_model(mesh)``,
``param_shardings(mesh)``) and the LM family's axes receive it. The port
has two forms:

- A mesh of one device (:class:`Mesh`): the axis names, their sizes (all
  1) and the device. Every spec on it is whole: :func:`spec_is_whole`
  says so, and the trainer places every parameter whole on the card.
- A mesh over the ranks of an initialised ``torch.distributed`` world
  (:class:`WorldMesh`), one process per position: the world's ranks laid
  out row-major over the axes, as the reference lays its devices out,
  and one process group for each axis slice (:meth:`WorldMesh.axis`).
  Each rank holds its own shard of what the reference's mesh holds
  globally; the expert and sequence axes (``parallel/expert.py``,
  ``parallel/ring_attention.py``) run their collectives over these
  groups. The groups take gloo when the ranks share a card or run on
  the CPU, NCCL only when each rank names a card of its own (the port's
  backend rule, ``parallel/distributed.choose_backend``).

A mesh that needs a device per position beyond the world (more than one
device and no world of that size) raises ``NotImplementedError``
(ROADMAP A9.2.3: several devices in one process).

:class:`PartitionSpec` names, per tensor dimension, the mesh axis it is
split over (or None); :class:`PadDim0` is the reference's wrapper
(``parallel/elastic.py``) that lets the elastic plane zero-pad dim 0 to
a world size it does not divide (:func:`padded_dim0`).
"""

import numpy as np

from elasticdl_tpu_torch.common.device import resolve_device


def _not_ported(n):
    return NotImplementedError(
        "a mesh of %d devices is not ported yet (ROADMAP A9.2.3: outside "
        "a torch.distributed world of that many ranks, the port runs on "
        "one card)" % n
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


class Axis:
    """One axis of a :class:`WorldMesh` as this rank sees it: ``name``,
    ``size``, ``index`` (this rank's position on it), ``ranks`` (the
    world ranks of its slice, in axis order) and ``group`` (their
    process group; None for an axis of size 1)."""

    def __init__(self, name, size, index, ranks, group):
        self.name = name
        self.size = int(size)
        self.index = int(index)
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group

    def __repr__(self):
        return "Axis(%r, size=%d, index=%d)" % (
            self.name, self.size, self.index,
        )


class WorldMesh(Mesh):
    """A mesh over the ranks of the current ``torch.distributed`` world,
    one per position: ``ranks`` is the world's ranks in the mesh's shape
    (row-major, as the reference reshapes its device list), ``device``
    this rank's device. Built by :func:`create_mesh` inside a world."""

    def __init__(self, mesh_shape, device, rank, groups):
        self.axis_names = tuple(mesh_shape)
        sizes = tuple(int(mesh_shape[a]) for a in self.axis_names)
        self.ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
        self.rank = int(rank)
        self._device = device
        coords = np.argwhere(self.ranks == self.rank)[0]
        self._axes = {}
        for i, name in enumerate(self.axis_names):
            index = list(coords)
            index[i] = slice(None)
            ranks = self.ranks[tuple(index)]
            self._axes[name] = Axis(
                name, sizes[i], coords[i], ranks, groups.get(name)
            )
        self.devices = None

    @property
    def shape(self):
        return {a: self._axes[a].size for a in self.axis_names}

    @property
    def size(self):
        return int(self.ranks.size)

    @property
    def device(self):
        """This rank's device."""
        return self._device

    def axis(self, name):
        """This rank's :class:`Axis` ``name``."""
        if name not in self._axes:
            raise ValueError("mesh %r has no axis %r" % (self, name))
        return self._axes[name]

    def __repr__(self):
        return "WorldMesh(%s, rank %d, %s)" % (
            self.shape, self.rank, self._device,
        )


def axis_of(mesh, name):
    """``mesh``'s :class:`Axis` ``name``, or None where the mesh lacks
    that axis or it has size 1 (nothing is split over it)."""
    if mesh is None or name is None or name not in mesh.axis_names:
        return None
    if not isinstance(mesh, WorldMesh):
        return None
    ax = mesh.axis(name)
    return ax if ax.size > 1 else None


def _world_mesh(mesh_shape, device):
    """The :class:`WorldMesh` of ``mesh_shape`` over the current world:
    every rank creates every axis slice's group, in one order, as
    ``new_group`` requires; each keeps its own."""
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.distributed import choose_backend

    names = tuple(mesh_shape)
    sizes = tuple(int(mesh_shape[a]) for a in names)
    layout = np.arange(int(np.prod(sizes))).reshape(sizes)
    rank = dist.get_rank()
    backend = choose_backend(device)
    groups = {}
    for i, name in enumerate(names):
        if sizes[i] == 1:
            continue
        # every slice along axis i: the other axes' coordinates fixed
        slices = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
        for ranks in slices:
            group = dist.new_group([int(r) for r in ranks], backend=backend)
            if rank in ranks:
                groups[name] = group
    return WorldMesh(mesh_shape, device, rank, groups)


def create_mesh(mesh_shape=None, devices=None):
    """Build a mesh: ``mesh_shape`` {axis_name: size} (default one
    ``data`` axis), ``devices`` the device list (default: the card).

    A mesh of one position is the one-device :class:`Mesh` over
    ``devices[0]``. A larger one is a :class:`WorldMesh` when this
    process is a rank of an initialised ``torch.distributed`` world of
    exactly that many ranks, ``devices`` naming this rank's one device;
    anything else raises ``NotImplementedError``."""
    devices = [resolve_device(d) for d in (devices or ["cuda"])]
    mesh_shape = mesh_shape or {"data": len(devices)}
    n = int(np.prod(list(mesh_shape.values())))
    if n == 1 and len(devices) == 1:
        dev_array = np.empty((1,) * len(mesh_shape), dtype=object)
        dev_array.reshape(-1)[0] = devices[0]
        return Mesh(dev_array, tuple(mesh_shape))
    if len(devices) == 1 and _world_size() == n:
        return _world_mesh(mesh_shape, devices[0])
    raise _not_ported(max(n, len(devices)))


def _world_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


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


def dim0_shard_count(spec, axes):
    """How many ways a leaf's dim 0 splits on a mesh laid out ``axes``
    ({axis: size}); a :class:`PadDim0` unwrapped."""
    if isinstance(spec, PadDim0):
        spec = spec.spec
    entry = spec[0] if spec is not None and len(spec) else None
    count = 1
    for a in _dim_axes(entry):
        count *= int(axes[a])
    return count


def padded_dim0(shape0, spec, axes):
    """dim 0 rounded up to the next multiple of its shard count."""
    count = dim0_shard_count(spec, axes)
    return -(-int(shape0) // count) * count


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


def _dim_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _parts(mesh, entry):
    """(number of parts, this rank's part) of a dim split over the axes
    of ``entry``, row-major over them as the reference's mesh splits a
    dim over several axes; (1, 0) on a mesh of one device."""
    parts, index = 1, 0
    for name in _dim_axes(entry):
        if not isinstance(mesh, WorldMesh):
            continue
        ax = mesh.axis(name)
        parts, index = parts * ax.size, index * ax.size + ax.index
    return parts, index


def _spec_entries(spec, ndim):
    if isinstance(spec, PadDim0):
        spec = spec.spec
    entries = tuple(spec or ())
    if len(entries) > ndim:
        raise ValueError("spec %r has more dims than %d" % (spec, ndim))
    return entries + (None,) * (ndim - len(entries))


def shard_slices(spec, global_shape, mesh):
    """This rank's part of an array of ``global_shape`` split by ``spec``
    on ``mesh``: one ``slice`` per dim. A split dim must divide evenly
    (the reference's NamedSharding of an unpadded spec)."""
    out = []
    entries = _spec_entries(spec, len(global_shape))
    for dim, entry in zip(global_shape, entries):
        parts, index = _parts(mesh, entry)
        if dim % parts:
            raise ValueError(
                "dim of %d does not split into %d parts over %r"
                % (dim, parts, entry)
            )
        size = dim // parts
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def global_shape(spec, local_shape, mesh):
    """The whole array's shape of this rank's ``local_shape`` part."""
    return tuple(
        int(d) * _parts(mesh, entry)[0]
        for d, entry in zip(local_shape, _spec_entries(spec, len(local_shape)))
    )


def holds_first_replica(spec, mesh):
    """True when this rank's index is 0 on every axis ``spec`` does not
    split over: the one rank that writes its part of a leaf (the
    reference's ``replica_id == 0``)."""
    if not isinstance(mesh, WorldMesh):
        return True
    split = set(spec_axes(spec))
    return all(
        mesh.axis(a).index == 0 for a in mesh.axis_names if a not in split
    )


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


def resolve_specs(names, specs):
    """{parameter name: spec} for the ``names`` that ``specs`` covers.
    ``specs`` is the nested {module: {param: spec}} form; a key is a
    whole ``state_dict`` name or a suffix of one (the reference's suffix
    specs: ``{"query": {"weight": ...}}`` covers every block's query),
    and a name takes the longest key it ends with at a ``.``. A key
    that covers no name raises ValueError."""
    flat = flatten_specs(specs or {})
    out, used = {}, set()
    for name in names:
        keys = [k for k in flat if name == k or name.endswith("." + k)]
        if keys:
            key = max(keys, key=len)
            out[name] = flat[key]
            used.add(key)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(
            "param_specs names %s, not a parameter of the model" % unused
        )
    return out
