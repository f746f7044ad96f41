"""The in-graph (HBM) embedding plane, the counterpart of
``elasticdl_tpu/nn/hbm_embedding.py`` over a world of one card.

The table is a real parameter that lives on the card and updates inside
the training step, as in the reference: ``(vocab_size, features)``, its
init the reference's ``variance_scaling(1.0, "fan_in", "normal",
out_axis=0)`` (a plain normal of variance 1 / features) drawn from an
explicit generator. The lookup is a gather (``nn/layers.take_rows``)
with the ``mask_zero`` multiply. Its gradient is the dense ``(vocab, features)``
table gradient, as ``jnp.take``'s is under ``jit``: the optimizer sees
the reference's dense gradient, zero on the rows the batch does not
touch, so SGD, weight decay and momentum act on the table as they do in
the reference (a sparse gradient would skip the untouched rows).

On a mesh of one device the reference's vocab-sharded ``psum`` lookup
(``sharded_lookup``) is exactly this gather, but for ids outside the
table: without a mesh they read as ``jnp.take`` reads them (NaN rows,
negatives counted from the end), on the mesh as rows no shard owns
(zeros). Its ``metrics/
a2a_overflow`` counter cannot move (nothing is routed). The port keeps
no counter: ``common/convert.py`` drops it from the reference's state.
Not ported, each raising ``NotImplementedError`` by name: the
``all_to_all`` routing (``method="a2a"``, ROADMAP A9), a mesh of more
than one device (A9), and the collective form that looks up inside the
sharded elastic plane's step (``collective=True``, A9).
"""

import torch
import torch.nn as nn

from elasticdl_tpu_torch.nn.layers import embed_normal_, take_rows

METHODS = ("auto", "a2a", "psum")


class HbmEmbedding(nn.Module):
    """An embedding table resident on the card; ``table`` is the
    reference's ``table`` parameter (``(vocab_size, features)``,
    untransposed)."""

    def __init__(
        self,
        vocab_size,
        features,
        mesh=None,
        axis="data",
        mask_zero=False,
        method="auto",
        collective=False,
    ):
        super().__init__()
        if collective:
            raise NotImplementedError(
                "HbmEmbedding(collective=True), the lookup inside the "
                "sharded elastic plane's step, is not ported yet "
                "(ROADMAP A9)"
            )
        if method not in METHODS:
            raise ValueError(
                "unknown HbmEmbedding method %r (want one of %s)"
                % (method, "/".join(METHODS))
            )
        if mesh is not None:
            if mesh.size != 1:
                raise NotImplementedError(
                    "HbmEmbedding over a mesh of %d devices (the "
                    "vocab-sharded psum lookup) is not ported yet "
                    "(ROADMAP A9)" % mesh.size
                )
            if axis not in mesh.axis_names:
                raise ValueError(
                    "table axis %r is not an axis of %r" % (axis, mesh)
                )
            if method == "a2a":
                raise NotImplementedError(
                    "HbmEmbedding(method='a2a'), the all_to_all row "
                    "routing, is not ported yet (ROADMAP A9)"
                )
        self.vocab_size = vocab_size
        self.features = features
        self.mesh = mesh
        self.axis = axis
        self.mask_zero = mask_zero
        self.table = nn.Parameter(torch.empty(vocab_size, features))

    def forward(self, ids):
        ids = ids.to(self.table.device).long()
        emb = take_rows(self.table, ids,
                        "fill" if self.mesh is None else "zero")
        if self.mask_zero:
            emb = emb * (ids != 0).to(emb.dtype)[..., None]
        return emb

    def init_parameters(self, generator):
        with torch.no_grad():
            embed_normal_(self.table, generator)
        return self

