"""Per-table embedding planes, the counterpart of
``elasticdl_tpu/nn/comm_plane.py``.

A model that mixes planes names one per table: ``"ps"`` (the elastic
``nn/embedding.Embedding``: rows in the master's store, pulled per
batch, sparse gradients pushed) or ``"hbm"`` (the table a real parameter
on the device, ``nn/hbm_embedding.py``). :func:`resolve_table_planes`
parses the zoo-facing ``embedding_plane=ps|hbm|hybrid|"table:plane/
table:plane"`` spec with the reference's rules and errors, and
:func:`make_embedding` builds one table's layer from its plane.

The PS plane's host data path, ``plan -> pull -> push``:

- :func:`plan_lookup_multi`, the batch-wide unique plan: one pull of a
  layer's unique ids over all its calls, each call keeping its positions
  into the shared rows buffer, so the step's row gradients come back
  already combined, one row per unique id;
- :class:`MasterStorePlane` pulls the planned rows from the master's
  store, one call per table; :class:`PsPlane` pulls them from the PS
  fleet in one fan-out over every (table, shard) leg
  (``worker/ps_client.py``); the worker copies them to the card as they
  are. The reference pads them to a power-of-two bucket to bound XLA
  recompiles; eager PyTorch has none to bound, and the pushed
  ``(ids, rows)`` are the unique ids and their rows either way;
- the sparse gradients travel with the dense ones (``report_gradient``
  to the master, ``push_gradient`` to the fleet), and
  :meth:`PsPlane.drain` settles the fleet client's push window.

Not ported: the ``HotRowCache`` and the hybrid trainer's
``EmbeddingPullPipeline`` (ROADMAP A4).
"""

import numpy as np

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
    combiner=None,
    collective=False,
    embedding_initializer="uniform",
):
    """Build one table's embedding layer from its plane name: ``"ps"`` ->
    the elastic :class:`~elasticdl_tpu_torch.nn.embedding.Embedding`
    (unbounded vocabulary, rows pulled per batch); ``"hbm"`` ->
    :class:`~elasticdl_tpu_torch.nn.hbm_embedding.HbmEmbedding` (the
    table a trainable parameter on the card). The caller assigns the
    layer to its attribute ``name``, the table's name."""
    if plane == "ps":
        from elasticdl_tpu_torch.nn.embedding import Embedding

        return Embedding(
            output_dim=output_dim,
            embedding_initializer=embedding_initializer,
            mask_zero=mask_zero,
            combiner=combiner,
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


def plan_lookup_multi(ids_list):
    """One layer's plan over all its calls in one forward: (unique ids
    (k,), [positions per call, int32, shaped like the call's ids]). Each
    call gathers from the one pulled buffer, so only unique rows cross
    and the step's row gradients come back combined."""
    arrays = [np.asarray(ids) for ids in ids_list]
    flat = np.concatenate([a.reshape(-1).astype(np.int64) for a in arrays])
    unique, inverse = np.unique(flat, return_inverse=True)
    inverse = inverse.reshape(-1)
    idxs, off = [], 0
    for a in arrays:
        idxs.append(inverse[off:off + a.size].reshape(a.shape).astype(np.int32))
        off += a.size
    return unique, idxs


class MasterStorePlane:
    """The master-held store: a pull is one ``pull_embedding_vectors``
    call per table. ``stub_fn`` gives the master stub at call time."""

    def __init__(self, stub_fn):
        self._stub_fn = stub_fn

    def pull(self, ids_by_table):
        """{table: unique ids} -> {table: (k, dim) float32 rows}."""
        stub = self._stub_fn()
        return {
            name: np.asarray(
                stub.pull_embedding_vectors(name, ids), dtype=np.float32
            )
            for name, ids in ids_by_table.items()
        }


class PsPlane:
    """The PS fleet's plane over a ``worker.ps_client.PSClient``: a pull
    is one fan-out round, and :meth:`drain` settles the push window.
    After a shard relaunch the client abandons the pushes in flight: a
    drain drops their outcome and never resends them."""

    def __init__(self, ps_client):
        self._client = ps_client

    def pull(self, ids_by_table):
        return self._client.pull_embedding_vectors_multi(ids_by_table)

    def drain(self):
        return self._client.drain()
