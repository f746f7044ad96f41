"""The in-graph (HBM) embedding plane, the counterpart of
``elasticdl_tpu/nn/hbm_embedding.py``.

The table is a real parameter that lives on the card and updates inside
the training step, as in the reference: ``(vocab_size, features)``, its
init the reference's ``variance_scaling(1.0, "fan_in", "normal",
out_axis=0)`` (a plain normal of variance 1 / features) drawn from an
explicit generator.

**One card.** Without a mesh the lookup is a gather (``nn/layers.
take_rows``) with the ``mask_zero`` multiply; its gradient is the dense
``(vocab, features)`` table gradient, as ``jnp.take``'s is under
``jit``, so SGD, weight decay and momentum act on the table as they do
in the reference. On a mesh of one device the reference's ``psum``
lookup is the same gather, but an id outside the table reads a zero
row (no shard owns it), and ``method="a2a"`` runs the routing body
below over an axis of one rank (its capacity and overflow count
included).

**The collective form** (``collective=True``): the lookup inside the
sharded elastic plane's step (``parallel/elastic.py``). Over a
``parallel/mesh.WorldMesh`` the layer holds this rank's rows of the
table split by vocabulary over ``axis``: ``(V_padded / n, D)``, where
``V_padded`` is the vocabulary rounded up to a multiple of the axis
size ``n`` (the elastic plane's ``PadDim0``; the padding rows are never
addressed). The init draws the whole table from the seed, pads it with
zeros and keeps this rank's rows, so every world size starts alike.
Each rank routes its own batch's ids with :func:`a2a_lookup_collective`
(:func:`a2a_dedup_lookup_collective` with ``dedup=True``, the default):
owner by range (``id // rows_per``), static ``(n, cap)`` buckets (``cap``
the local id count when ``capacity`` is None), ``-1`` skip slots that
take no capacity and read zero rows, a trash column for overflow and
skip slots, and ids past their peer's capacity reading zero rows,
counted as overflow. Both exchanges are ``parallel/collectives.
all_to_all``; the backward is the reverse exchange and a scatter-add
into the owner's shard alone, so no rank ever holds the dense ``(V, D)``
gradient. Without a world (``mesh=None``) the collective layer holds the
whole table and routes over an axis of one rank: the whole model on one
device. ``method="psum"`` raises the reference's ``ValueError``.

The overflow count (the reference's ``metrics/a2a_overflow`` state
counter) is kept outside the ``state_dict``: ``common/convert.py`` drops
the reference's counter, and the port's checkpoints do not carry it. A
training forward leaves this step's local count in
``pending_overflow``; the elastic step sums it over the world in its one
flat SUM and :meth:`HbmEmbedding.settle_overflow` adds the global count
to ``a2a_overflow``. :func:`a2a_overflow_total` reads the total of a
model's layers. A lookup also leaves ``last_routing``: the ids it
routed (the unique ones with dedup) and their occurrences, device
tensors, read without a sync only when asked.

Not ported, each raising ``NotImplementedError`` by name (ROADMAP
A9.2.3): the vocab-sharded lookups over a mesh of more than one device
outside the collective form (the reference's ``sharded_lookup`` and
``all_to_all_lookup`` over several devices of one process).
"""

import torch
import torch.nn as nn

from elasticdl_tpu_torch.nn.layers import embed_normal_, take_rows
from elasticdl_tpu_torch.nn.sparse_comms import padded_unique

METHODS = ("auto", "a2a", "psum")
OVERFLOW_METRIC = "a2a_overflow"


def a2a_overflow_total(module):
    """The overflowed-id count over every :class:`HbmEmbedding` in
    ``module`` (settled counts, a Python int), or None when it has
    none."""
    layers = [m for m in module.modules() if isinstance(m, HbmEmbedding)]
    if not layers:
        return None
    return sum(m.a2a_overflow for m in layers)


def _exchange(t, axis):
    """Row ``p`` of ``t`` to rank ``p`` of ``axis``; the identity on an
    axis of one rank (``None``)."""
    if axis is None or axis.size == 1:
        return t
    from elasticdl_tpu_torch.parallel import collectives

    return collectives.all_to_all(t.contiguous(), axis)


def a2a_lookup_collective(
    table_local, ids_flat, axis, capacity=None, return_overflow=False
):
    """The ``all_to_all`` routing body for one rank of ``axis`` (a
    ``parallel/mesh.Axis``, or None for an axis of one rank).

    ``table_local`` is this rank's ``(V/n, D)`` rows, ``ids_flat`` its
    flat ids. Negative ids are skip slots (the :func:`~elasticdl_tpu_
    torch.nn.sparse_comms.padded_unique` padding): no capacity, zero
    rows, never overflow. Returns ``(ids, D)`` rows, or with
    ``return_overflow`` ``(rows, n_overflowed)``: this rank's LOCAL count
    of live ids that did not fit their peer's bucket (an int64 0-dim
    device tensor), which the caller sums over the ranks."""
    n = 1 if axis is None else axis.size
    me = 0 if axis is None else axis.index
    device = ids_flat.device
    ids_flat = ids_flat.long()
    rows_per = table_local.shape[0]
    mm = ids_flat.shape[0]
    cap = mm if capacity is None else min(int(capacity), mm)

    live = ids_flat >= 0
    owner = torch.clamp(ids_flat // rows_per, 0, n - 1)
    # skip slots bucket past every real peer (owner n): they sort to the
    # end and cannot displace a live id from its capacity window
    owner = torch.where(live, owner, torch.full_like(owner, n))
    sorted_owner, order = torch.sort(owner, stable=True)
    sorted_ids = ids_flat[order]
    sorted_live = live[order]
    counts = torch.bincount(owner, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(mm, device=device) - starts[sorted_owner]
    ok = (pos < cap) & sorted_live
    # overflow and skip entries write to a trash column (cap), cut off
    # before the exchange
    pos = torch.where(ok, pos, torch.full_like(pos, cap))
    write_owner = torch.clamp(sorted_owner, max=n - 1)
    # (n, cap) buckets: row p holds the ids this rank asks rank p for;
    # an empty slot carries -1
    send_ids = torch.full((n, cap + 1), -1, dtype=torch.long, device=device)
    send_ids[write_owner, pos] = sorted_ids
    pos = torch.where(ok, pos, torch.zeros_like(pos))
    recv_ids = _exchange(send_ids[:, :cap], axis)  # row p: rank p asks

    local = recv_ids - me * rows_per
    valid = (local >= 0) & (local < rows_per)
    rows = nn.functional.embedding(local.clamp(0, rows_per - 1), table_local)
    rows = rows.where(valid[..., None], rows.new_zeros(()))
    back = _exchange(rows, axis)  # row p: the rows rank p sent back

    out_sorted = back[write_owner, pos]
    out_sorted = out_sorted.where(ok[..., None], out_sorted.new_zeros(()))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(mm, device=device)
    out = out_sorted[inv]
    if not return_overflow:
        return out
    return out, (sorted_live & ~ok).sum()


def a2a_dedup_lookup_collective(
    table_local, ids_flat, axis, capacity=None, return_overflow=False
):
    """:func:`a2a_lookup_collective` over the batch's unique ids alone
    (:func:`padded_unique`), the occurrences restored by a local gather
    through the inverse map; ``capacity`` bounds unique ids per peer,
    and the overflow counts unique ids dropped (each zeroes every
    occurrence that maps to it)."""
    uids, inv, _ = padded_unique(ids_flat.long())
    out = a2a_lookup_collective(
        table_local, uids, axis, capacity=capacity,
        return_overflow=return_overflow,
    )
    if not return_overflow:
        return out[inv.long()]
    rows_u, n_over = out
    return rows_u[inv.long()], n_over


class HbmEmbedding(nn.Module):
    """An embedding table resident on the card; ``table`` is the
    reference's ``table`` parameter (untransposed): ``(vocab_size,
    features)``, or this rank's ``(V_padded / n, features)`` rows in the
    collective form over a ``WorldMesh``."""

    def __init__(
        self,
        vocab_size,
        features,
        mesh=None,
        axis="data",
        mask_zero=False,
        method="auto",
        capacity=None,
        collective=False,
        dedup=True,
    ):
        super().__init__()
        from elasticdl_tpu_torch.parallel.mesh import WorldMesh

        if method not in METHODS:
            raise ValueError(
                "unknown HbmEmbedding method %r (want one of %s)"
                % (method, "/".join(METHODS))
            )
        rows = vocab_size
        self._axis = None  # the routing axis over a world
        if mesh is not None:
            if axis not in mesh.axis_names:
                raise ValueError(
                    "table axis %r is not an axis of %r" % (axis, mesh)
                )
            if collective and isinstance(mesh, WorldMesh):
                self._axis = mesh.axis(axis)
                rows = -(-vocab_size // self._axis.size)  # padded, a rank
            elif mesh.size != 1:
                raise NotImplementedError(
                    "HbmEmbedding over a mesh of %d devices outside the "
                    "collective form (the reference's sharded_lookup / "
                    "all_to_all_lookup over the devices of one process) "
                    "is not ported yet (ROADMAP A9.2.3)" % mesh.size
                )
        self.vocab_size = vocab_size
        self.features = features
        self.mesh = mesh
        self.axis = axis
        self.mask_zero = mask_zero
        self.method = method
        self.capacity = capacity
        self.collective = collective
        self.dedup = dedup
        self.table = nn.Parameter(torch.empty(rows, features))
        self.a2a_overflow = 0  # settled global count (the reference's
        # metrics/a2a_overflow)
        self.pending_overflow = None  # this step's local count, unsettled
        self.last_routing = None

    def _route(self, table, ids):
        """(rows, local overflow count) of the routed lookup of ``ids``
        over this layer's axis (None: one rank)."""
        flat = ids.reshape(-1)
        routed = flat
        if self.dedup:
            # a2a_dedup_lookup_collective, with its unique ids kept
            routed, inv, _ = padded_unique(flat)
        out, n_over = a2a_lookup_collective(
            table, routed, self._axis, capacity=self.capacity,
            return_overflow=True,
        )
        if self.dedup:
            out = out[inv.long()]
        self.last_routing = {"routed": (routed >= 0).sum(),
                             "occurrences": (flat >= 0).sum()}
        return out.reshape(ids.shape + (table.shape[1],)), n_over

    def forward(self, ids):
        ids = ids.to(self.table.device).long()
        if self.collective:
            if self.method == "psum":
                # each rank's ids differ inside the step, so a sum of
                # per-rank lookups would add misaligned rows
                raise ValueError(
                    "HbmEmbedding(collective=True) only supports a2a "
                    "routing; psum needs replicated ids, which the "
                    "elastic plane's sharded batch cannot provide"
                )
            emb, n_over = self._route(self.table, ids)
            if self.training:
                # summed over the world by the elastic step
                self.pending_overflow = n_over if (
                    self.pending_overflow is None
                ) else self.pending_overflow + n_over
        elif self.mesh is None:
            emb = take_rows(self.table, ids, "fill")
        elif self._method_on_mesh() == "a2a":
            emb, n_over = self._route(self.table, ids)
            if self.training:
                # one device: the local count is the global one
                self.a2a_overflow += int(n_over)
        else:
            emb = take_rows(self.table, ids, "zero")
        if self.mask_zero:
            emb = emb * (ids != 0).to(emb.dtype)[..., None]
        return emb

    def _method_on_mesh(self):
        """The reference's ``auto``: a2a when the mesh gives the batch an
        axis other than the table's, else psum."""
        if self.method != "auto":
            return self.method
        has_batch_axis = (
            "data" in self.mesh.axis_names and self.axis != "data"
        )
        return "a2a" if has_batch_axis else "psum"

    def settle_overflow(self, global_count):
        """Add the world's overflow count of this step (the sum of every
        rank's ``pending_overflow``) and clear the pending one."""
        self.a2a_overflow += int(global_count)
        self.pending_overflow = None

    def init_parameters(self, generator):
        """The reference's init of the whole ``(vocab_size, features)``
        table; in the collective form over a world, drawn whole, padded
        with zero rows and cut to this rank's rows."""
        with torch.no_grad():
            draw = torch.empty((self.vocab_size, self.features),
                               device=generator.device)
            embed_normal_(draw, generator)
            if self._axis is not None:
                rows = self.table.shape[0]
                padded = draw.new_zeros((rows * self._axis.size,
                                         self.features))
                padded[:self.vocab_size] = draw
                start = self._axis.index * rows
                draw = padded[start:start + rows]
            self.table.copy_(draw)
        return self
