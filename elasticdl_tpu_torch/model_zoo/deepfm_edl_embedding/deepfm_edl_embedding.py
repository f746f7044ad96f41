"""DeepFM with per-table embedding planes, the port of
``model_zoo/deepfm_edl_embedding/deepfm_edl_embedding.py``.

The network is ``deepfm_functional_api``'s (``deepfm_forward``); each of
its two tables (``TABLES``: the ``embedding`` feature table and the
one-wide ``id_bias`` table) rides the plane the ``embedding_plane`` spec
gives it (``nn/comm_plane.py``): the HBM plane, the table a parameter on
the card updated inside the step (``nn/hbm_embedding.py``), or the PS
plane, the elastic ``nn/embedding.Embedding`` whose rows live in the
master's store (the parameter-server worker, ``worker/worker.py``).

The hooks, as the reference's:

- ``custom_model()`` (no mesh, ``embedding_plane=""`` or ``"ps"``): both
  tables on the PS plane, the ParameterServerStrategy job's model; its
  parameters are the tower's alone.
- ``build_distributed_model(mesh, ...)``: the ALLREDUCE worker's model.
  With a mesh (the port's is one card) the tables resolve to the HBM
  plane. A PS-plane table on a mesh raises ``NotImplementedError``: such
  a table trains on the parameter-server worker, in hybrid mode
  (``custom_model(embedding_plane="hybrid")``: the feature table on the
  fleet, ``id_bias`` a dense parameter of the worker).
- ``build_host_model(**params)``: ``force_hbm``, a plain gather over
  whole tables; evaluation-only and prediction-only jobs score it against
  ``--checkpoint_dir``.
- ``param_shardings(mesh, ...)``: each HBM table's spec
  (``PadDim0(P(table_axis, None))``), whole on a world of one.
- ``build_collective_model(table_axis, mesh=None, **params)``: the
  multi-process elastic hook. Its tables are looked up with the
  ``all_to_all`` routing inside the collective plane's weighted step
  (``parallel/elastic.py``); over a ``WorldMesh`` (``mesh``, the port's
  explicit form of the reference's outer ``shard_map``) each table holds
  this rank's padded rows, without one the whole table. A PS-plane
  table raises the reference's ``ValueError``.

Layers: ``embedding``/``id_bias`` (their ``table``), ``tower``/``out``,
the ``deepfm`` weight map of ``common/convert.py``.
"""

import torch.nn as nn

from elasticdl_tpu_torch.model_zoo.deepfm_functional_api.deepfm_functional_api import (  # noqa: E501
    dataset_fn,
    deepfm_forward,
    eval_metrics_fn,
    init_dense,
    loss,
    optimizer,
)
from elasticdl_tpu_torch.nn.comm_plane import (
    make_embedding,
    resolve_table_planes,
)
from elasticdl_tpu_torch.parallel.mesh import PadDim0, PartitionSpec

__all__ = ["custom_model", "build_distributed_model", "build_host_model",
           "build_collective_model", "param_shardings", "loss", "optimizer",
           "dataset_fn", "eval_metrics_fn", "TABLES", "HYBRID_SPLIT",
           "VOCAB_SIZE"]

# frappe CTR vocabulary (reference data/recordio_gen/frappe_recordio_gen)
VOCAB_SIZE = 5384

TABLES = ("embedding", "id_bias")
# the reference's hybrid split: the feature table on the PS fleet, the
# small bias table in the dense world
HYBRID_SPLIT = {"embedding": "ps", "id_bias": "hbm"}


class DeepFMEdl(nn.Module):
    def __init__(
        self,
        embedding_dim=64,
        input_length=10,
        fc_unit=64,
        mesh=None,
        vocab_size=VOCAB_SIZE,
        table_axis="data",
        embedding_plane="",
        force_hbm=False,
        collective=False,
    ):
        super().__init__()
        self.mesh = mesh
        self.embedding_plane = embedding_plane
        self.force_hbm = force_hbm
        self.collective = collective
        planes = self._table_planes()
        for name, dim in zip(TABLES, (embedding_dim, 1)):
            if planes[name] == "ps" and mesh is not None and not (
                collective or force_hbm
            ):
                raise NotImplementedError(
                    "table %r rides the PS plane on a mesh, which the "
                    "ALLREDUCE plane cannot serve -- train PS-plane tables "
                    "on the parameter-server worker (hybrid mode: "
                    "--embedding_plane hybrid with --ps_addrs)" % name
                )
            if planes[name] == "ps" and (collective or force_hbm):
                raise ValueError(
                    "table %r rides the PS plane, which the collective/"
                    "host-twin elastic forms cannot serve -- train "
                    "PS-plane tables on the parameter-server worker "
                    "(hybrid mode)" % name
                )
            setattr(self, name, make_embedding(
                planes[name],
                output_dim=dim,
                name=name,
                vocab_size=vocab_size,
                mesh=mesh,
                axis=table_axis,
                mask_zero=True,
                collective=collective,
            ))
        self.tower = nn.Linear(input_length * embedding_dim, fc_unit)
        self.out = nn.Linear(fc_unit, 1)

    def _table_planes(self):
        if self.embedding_plane:
            return resolve_table_planes(
                self.embedding_plane, TABLES, hybrid_default=HYBRID_SPLIT
            )
        # the reference's mode-wide switch: PS layers without a mesh, HBM
        # layers with one (or with force_hbm/collective)
        legacy = (
            "ps"
            if self.mesh is None and not self.force_hbm
            and not self.collective
            else "hbm"
        )
        return {t: legacy for t in TABLES}

    def forward(self, features):
        return deepfm_forward(self, features)

    def init_parameters(self, generator):
        """The HBM tables by the reference's HBM init, in creation order
        (a PS-plane table has no parameters: the store mints its rows),
        then the tower."""
        self.embedding.init_parameters(generator)
        self.id_bias.init_parameters(generator)
        init_dense(self, generator)
        return self


def custom_model(
    embedding_dim=64,
    input_length=10,
    fc_unit=64,
    vocab_size=VOCAB_SIZE,
    embedding_plane="",
):
    return DeepFMEdl(
        embedding_dim=embedding_dim,
        input_length=input_length,
        fc_unit=fc_unit,
        vocab_size=vocab_size,
        embedding_plane=embedding_plane,
    )


def build_distributed_model(mesh, table_axis="data", **params):
    """ALLREDUCE-strategy hook: the tables on the mesh's HBM."""
    return DeepFMEdl(mesh=mesh, table_axis=table_axis, **params)


def build_collective_model(table_axis="data", mesh=None, **params):
    """The multi-process elastic hook: tables looked up with the routed
    collectives inside the collective plane's step; ``mesh`` the world's
    ``WorldMesh`` (this rank's rows), None for the whole tables."""
    return DeepFMEdl(collective=True, mesh=mesh, table_axis=table_axis,
                     **params)


def build_host_model(**params):
    """The host twin: the same parameters, plain gathers over whole
    tables; what evaluation-only and prediction-only jobs score."""
    params.pop("table_axis", None)
    return DeepFMEdl(force_hbm=True, **params)


def param_shardings(mesh, table_axis="data", embedding_plane="", **_params):
    """The specs of the HBM-resident tables (vocab rows split over
    ``table_axis``, zero-padded on a world size that does not divide
    them); everything else replicates. A PS-plane table is not a
    parameter, so it gets no spec. On a mesh of one card every spec is
    whole."""
    planes = (
        resolve_table_planes(
            embedding_plane, TABLES, hybrid_default=HYBRID_SPLIT
        )
        if embedding_plane
        else {t: "hbm" for t in TABLES}
    )
    spec = PadDim0(PartitionSpec(table_axis, None))
    return {
        name: {"table": spec}
        for name in TABLES
        if planes[name] == "hbm"
    }
