"""Per-table embedding planes, the counterpart of the selection half of
``elasticdl_tpu/nn/comm_plane.py``.

A model that mixes planes names one per table: ``"ps"`` (rows on the
parameter-server fleet, pulled per batch, sparse gradients pushed) or
``"hbm"`` (the table a real parameter on the device,
``nn/hbm_embedding.py``). :func:`resolve_table_planes` parses the
zoo-facing ``embedding_plane=ps|hbm|hybrid|"table:plane/table:plane"``
spec with the reference's rules and errors, and :func:`make_embedding`
builds one table's layer from its plane.

The port has the HBM plane on one card. The PS plane (its ``Embedding``
layer, ``HotRowCache``, ``PsPlane``, ``MasterStorePlane`` and
``EmbeddingPullPipeline``) is not ported: ``make_embedding("ps", ...)``
raises ``NotImplementedError`` naming it (ROADMAP A5).
"""

PLANES = ("ps", "hbm")


def resolve_table_planes(spec, tables, hybrid_default=None):
    """Parse an ``embedding_plane`` spec into {table_name: plane}.

    Accepted forms:

    - ``"ps"`` / ``"hbm"``: every table on that plane.
    - ``"hybrid"``: per-table via ``hybrid_default`` (the zoo's
      declared split).
    - ``"table:plane/table:plane"`` explicit per-table entries
      (``/``-separated because ``,`` already delimits model_params);
      unlisted tables get ``ps``.
    """
    tables = list(tables)
    if spec in PLANES:
        return {t: spec for t in tables}
    if spec == "hybrid":
        if not hybrid_default:
            raise ValueError(
                "embedding_plane='hybrid' needs the model to declare a "
                "per-table split (hybrid_default)"
            )
        missing = [t for t in tables if t not in hybrid_default]
        if missing:
            raise ValueError(
                "hybrid plane split missing tables %r" % (missing,)
            )
        return {t: hybrid_default[t] for t in tables}
    out = {t: "ps" for t in tables}
    for entry in str(spec).split("/"):
        entry = entry.strip()
        if not entry:
            continue
        table, sep, plane = entry.partition(":")
        if not sep or plane not in PLANES:
            raise ValueError(
                "bad embedding_plane entry %r (want 'table:ps' or "
                "'table:hbm', '/'-separated; or one of %s, 'hybrid')"
                % (entry, "/".join(PLANES))
            )
        if table not in out:
            raise ValueError(
                "embedding_plane names unknown table %r (model tables: %r)"
                % (table, tables)
            )
        out[table] = plane
    return out


def make_embedding(
    plane,
    output_dim,
    name,
    vocab_size=None,
    mesh=None,
    axis="data",
    mask_zero=False,
    collective=False,
):
    """Build one table's embedding layer from its plane name: ``"hbm"``
    -> :class:`~elasticdl_tpu_torch.nn.hbm_embedding.HbmEmbedding` (the
    table a trainable parameter on the card); ``"ps"`` raises
    ``NotImplementedError`` (the PS plane is not ported). The caller
    assigns the layer to its attribute ``name``."""
    if plane == "ps":
        raise NotImplementedError(
            "table %r rides the PS plane (the elastic Embedding layer, "
            "rows pulled from the parameter-server fleet), which is not "
            "ported yet (ROADMAP A5); put it on the 'hbm' plane" % name
        )
    if plane == "hbm":
        from elasticdl_tpu_torch.nn.hbm_embedding import HbmEmbedding

        if vocab_size is None:
            raise ValueError(
                "hbm-plane table %r needs a declared vocab_size (the "
                "table is a real parameter)" % name
            )
        return HbmEmbedding(
            vocab_size=vocab_size,
            features=output_dim,
            mesh=mesh,
            axis=axis,
            mask_zero=mask_zero,
            collective=collective,
        )
    raise ValueError(
        "unknown embedding plane %r (want one of %s)"
        % (plane, "/".join(PLANES))
    )
