"""Sparse-aware optimizer apply on a parameter store, the port of
``elasticdl_tpu/ps/optimizer_wrapper.py``, with its host and device
planes.

The dense step (a PS shard's subset of the model) runs the optimizer
over device copies of the store's dense parameters: the copies and the
optimizer's state persist between applies, each apply sets every
parameter's gradient (zero where none came) and steps once, and the
store gets fresh host arrays back. A store whose dense dict was replaced
from outside (an init, a restore) is copied to the device anew.

For an embedding layer's gradient the wrapper reads the touched rows
*and their optimizer-slot rows* from the store, runs the optimizer on
those rows alone, and writes rows and slots back. Duplicate ids are
combined first by ``common/tensor.combine_indexed_slices`` (on
duplicate-free input a pure reorder into unique-id order, no additions),
so a worker-side pre-combined push and an uncombined one land the same
rows.

The optimizer is a ``torch.optim`` factory (``params -> Optimizer``, as
the zoo's ``optimizer()`` returns), and its slot layout is read from
torch's own state, as the reference reads optax's: one zero-gradient
step of the optimizer on a scratch one-row parameter, with the state
dict recording the first value torch writes under each key (a key
filled at construction, as Adagrad's ``sum``, counts as written then).
A state tensor shaped like the row is a slot: a slot table
``"{layer}-{key}"`` is created lazily, its fresh rows the recorded value
(``momentum_buffer`` 0, ``exp_avg``/``exp_avg_sq`` 0, Adagrad's ``sum``
its ``initial_accumulator_value``). Anything else (Adam's ``step``) is
kept whole per layer, starting from its recorded first value, as the
reference keeps optax's ``count``. No per-optimizer registry.

Each apply builds the optimizer over the gathered ``(k, dim)`` rows on
the wrapper's device, installs their state, sets the combined gradient
and steps once; the rows cross host to device and back, as the
reference's host store crosses into its jitted step. Rows are not padded
to a power of two: nothing recompiles here. Every apply holds
``apply_lock`` (reentrant: a caller may hold it across a whole apply,
as a shard's servicer does so that a snapshot never cuts one).

**The device plane** (a store built with ``device``, the shard's
``--ps_device``) keeps everything on the card: the sparse apply takes
the rows and each slot table's rows with ``ensure_rows`` ->
``gather_slots``, runs the same torch step as the host plane, writes
them back with ``scatter_slots`` (unique ids, so ``index_copy_`` is
defined) and ends on ``sync``; the dense apply leaves device copies of
the parameters in the store, which ``Parameters.to_named_arrays`` copies
to host for a reply. Both planes run one step on the same device over
the same values, so they agree bitwise. After an apply a tiered table's
demoter is woken, outside the apply lock.

Gradients enter the device through ``common/tensor.device_from_host_view``:
a writable request view (a ``--ps_device`` shard's shared-memory slot) is
imported without a host copy, and the apply consumes it before the
handler returns and the slot carries the reply.
"""

import threading

import numpy as np
import torch

from elasticdl_tpu_torch.common.tensor import (
    combine_indexed_slices,
    device_from_host_view,
)
from elasticdl_tpu_torch.ps.embedding_table import get_slot_table_name


class _FirstWrites(dict):
    """An optimizer state dict that remembers the first value written
    under each key (cloned, so later in-place updates leave it)."""

    def __init__(self, initial):
        super().__init__(initial)
        self.first = {k: _clone(v) for k, v in initial.items()}

    def __setitem__(self, key, value):
        if key not in self.first:
            self.first[key] = _clone(value)
        super().__setitem__(key, value)


def _clone(value):
    return value.detach().clone() if isinstance(value, torch.Tensor) else value


def probe_row_state(optimizer, dim, device):
    """(slot fresh rows {key: (dim,) float32 ndarray}, per-layer initial
    state {key: value}) of torch optimizer factory ``optimizer`` for rows
    ``dim`` wide, read from one zero-gradient step on a scratch row."""
    scratch = torch.zeros(1, dim, device=device, requires_grad=True)
    opt = optimizer([scratch])
    state = _FirstWrites(opt.state.get(scratch, {}))
    opt.state[scratch] = state
    scratch.grad = torch.zeros_like(scratch)
    opt.step()
    slots, per_layer = {}, {}
    for key, value in state.first.items():
        if isinstance(value, torch.Tensor) and tuple(value.shape) == (1, dim):
            slots[key] = value[0].to("cpu", torch.float32).numpy()
        else:
            per_layer[key] = value
    return slots, per_layer


class OptimizerWrapper:
    def __init__(self, optimizer, parameters, device):
        """``optimizer``: a torch optimizer factory; ``parameters``: the
        ``ps.Parameters`` store; ``device``: where the updates run (every
        caller names it)."""
        self._opt_fn = optimizer
        self._params = parameters
        self._device = torch.device(device)
        self._lock = threading.RLock()
        self._non_row_state = {}  # layer -> {key: value}, kept whole
        self._template_cache = {}  # dim -> (slot fresh rows, per-layer)
        self._dense_src = None  # the store dict the device copies mirror
        self._dense_params = None  # {name: device tensor}
        self._dense_opt = None

    @property
    def apply_lock(self):
        return self._lock

    def apply_dense_gradients(self, grads):
        """One optimizer step over the store's dense parameters with
        ``{name: float32 array}`` gradients (a missing one is zero)."""
        store = self._params
        with self._lock:
            if store.non_embedding_params is not self._dense_src:
                self._dense_params = {
                    k: (
                        v.detach().clone() if isinstance(v, torch.Tensor)
                        else self._to_device(v)
                    ).requires_grad_(True)
                    for k, v in store.non_embedding_params.items()
                }
                self._dense_opt = self._opt_fn(
                    list(self._dense_params.values())
                )
            for k, p in self._dense_params.items():
                g = grads.get(k)
                # a decoded request view enters the device through the
                # bridge (an alias on the CPU when the view is writable):
                # the step consumes it before the handler returns
                p.grad = (
                    torch.zeros_like(p) if g is None
                    else device_from_host_view(
                        np.asarray(g, dtype=np.float32), self._device)
                )
            self._dense_opt.step()
            if store.device is not None:
                # the store keeps its own device copies: a concurrent
                # pull copies them to host while the next step runs
                named = {
                    k: p.detach().clone()
                    for k, p in self._dense_params.items()
                }
            else:
                named = {
                    k: p.detach().to("cpu", copy=True).numpy()
                    for k, p in self._dense_params.items()
                }
            store.set_non_embedding_params(named)
            self._dense_src = named

    def _row_state_template(self, dim):
        cached = self._template_cache.get(dim)
        if cached is None:
            cached = probe_row_state(self._opt_fn, dim, self._device)
            self._template_cache[dim] = cached
        return cached

    def _ensure_slot_tables(self, store, layer_name, row_slot_init):
        tables = {}
        for slot, fresh_row in row_slot_init.items():
            name = get_slot_table_name(layer_name, slot)
            if name not in store.embedding_params:
                store.create_slot_params(
                    [slot], {slot: float(fresh_row.flat[0])}
                )
            tables[slot] = store.embedding_params[name]
        return tables

    def _to_device(self, rows):
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self._device)

    def apply_sparse_gradients(self, layer_name, indices, values):
        """Apply one embedding layer's indexed-slice gradient to its rows
        and slot rows."""
        store = self._params
        table = store.embedding_params[layer_name]
        unique, grad_rows = combine_indexed_slices(
            np.asarray(indices, dtype=np.int64).reshape(-1),
            np.asarray(values, dtype=np.float32),
        )
        with self._lock:
            row_slot_init, per_layer_init = self._row_state_template(
                table.dim
            )
            slot_tables = self._ensure_slot_tables(
                store, layer_name, row_slot_init
            )
            on_device = store.device is not None
            if on_device:
                slots = table.ensure_rows(unique)
                rows = table.gather_slots(slots)
                slot_slots = {
                    key: t.ensure_rows(unique)
                    for key, t in slot_tables.items()
                }
            else:
                rows = self._to_device(table.get(unique))
            rows.requires_grad_(True)
            opt = self._opt_fn([rows])
            per_layer = self._non_row_state.get(layer_name)
            if per_layer is None:
                per_layer = {k: _clone(v) for k, v in per_layer_init.items()}
            state = dict(per_layer)
            for key, t in slot_tables.items():
                state[key] = (
                    t.gather_slots(slot_slots[key]) if on_device
                    else self._to_device(t.get(unique))
                )
            opt.state[rows] = state
            rows.grad = device_from_host_view(grad_rows, self._device)
            opt.step()
            if on_device:
                table.scatter_slots(slots, rows.detach())
                for key, t in slot_tables.items():
                    t.scatter_slots(slot_slots[key], state[key])
                # one stream carries every table's writes: the reply
                # reads none of them before they have run
                table.sync()
            else:
                table.set(unique, rows.detach().to("cpu").numpy())
                for key, t in slot_tables.items():
                    t.set(unique, state[key].to("cpu").numpy())
            self._non_row_state[layer_name] = {
                k: state[k] for k in per_layer_init
            }
        for t in (table, *slot_tables.values()):
            pressure = getattr(t, "signal_pressure", None)
            if pressure is not None:
                pressure()

    def apply_gradients(self, dense_grads=None, embedding_grads=None):
        """Apply ``{name: array}`` dense gradients, then ``{layer:
        Tensor}`` indexed-slice gradients."""
        if dense_grads:
            self.apply_dense_gradients(dense_grads)
        for layer_name, tensor in (embedding_grads or {}).items():
            self.apply_sparse_gradients(
                layer_name, tensor.indices, tensor.values
            )
