"""DeepFM with dense embedding tables, the port of
``model_zoo/deepfm_functional_api/deepfm_functional_api.py``.

A ``mask_zero`` embedding (``input_dim`` 5383, dim 64, ``input_length``
10 ids a row) feeds the FM first-order term (a one-wide ``id_bias``
table) and second-order term, and a ``Dense(fc_unit)`` -> ``Dense(1)``
tower over the flattened embeddings; the output is ``{"logits",
"probs"}``, the loss sigmoid binary cross-entropy, SGD at 0.1, and the
evaluation metrics nested per output: accuracy on the logits, AUC on the
probabilities.

The tables are flax ``nn.Embed`` parameters in the reference, dense
parameters here (``nn/layers.Embed``): their gradient is the dense
table gradient, as ``jnp.take``'s is. Layers: ``embedding``/``id_bias``
(``Embed_0``/``Embed_1``), ``tower``/``out`` (``Dense_1``/``Dense_0``:
flax creates the outer ``Dense(1)`` first),
the ``deepfm`` weight map of ``common/convert.py``. :func:`deepfm_forward`
is the body ``deepfm_edl_embedding`` shares.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example import FixedLenFeature, parse_example
from elasticdl_tpu_torch.metrics import AUC
from elasticdl_tpu_torch.nn.layers import Embed, lecun_normal_


def deepfm_forward(model, features):
    """DeepFM over ``model.embedding``, ``model.id_bias`` (id -> row
    lookups), ``model.tower`` and ``model.out``: ``{"logits": (B,),
    "probs": (B, 1)}``."""
    ids = features["feature"]
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.array(ids))
    ids = ids.to(model.out.weight.device).long()  # (B, L)
    mask = (ids != 0).float()[..., None]  # mask_zero

    embeddings = model.embedding(ids) * mask
    emb_sum = embeddings.sum(1)
    second_order = 0.5 * (
        emb_sum.square() - embeddings.square().sum(1)
    ).sum(1)
    first_order = (model.id_bias(ids) * mask).sum((1, 2))
    fm_output = first_order + second_order

    nn_input = embeddings.reshape(embeddings.shape[0], -1)
    deep_output = model.out(model.tower(nn_input)).reshape(-1)

    logits = fm_output + deep_output
    probs = torch.sigmoid(logits).reshape(-1, 1)
    return {"logits": logits, "probs": probs}


def init_dense(model, generator):
    """flax's Dense init of ``tower`` and ``out``: lecun-normal kernels,
    zero biases."""
    with torch.no_grad():
        for layer in (model.tower, model.out):
            lecun_normal_(layer.weight, layer.weight.shape[1], generator)
            layer.bias.zero_()


class DeepFM(nn.Module):
    def __init__(self, input_dim=5383, embedding_dim=64, input_length=10,
                 fc_unit=64):
        super().__init__()
        self.embedding = Embed(input_dim, embedding_dim)
        self.id_bias = Embed(input_dim, 1)
        self.tower = nn.Linear(input_length * embedding_dim, fc_unit)
        self.out = nn.Linear(fc_unit, 1)

    def forward(self, features):
        return deepfm_forward(self, features)

    def init_parameters(self, generator):
        """The tables by flax's embed init, in creation order, then the
        tower."""
        self.embedding.init_parameters(generator)
        self.id_bias.init_parameters(generator)
        init_dense(self, generator)
        return self


def custom_model(
    input_dim=5383, embedding_dim=64, input_length=10, fc_unit=64
):
    return DeepFM(
        input_dim=input_dim,
        embedding_dim=embedding_dim,
        input_length=input_length,
        fc_unit=fc_unit,
    )


def loss(output, labels):
    logits = output["logits"].reshape(-1)
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=logits.device, dtype=logits.dtype).reshape(-1)
    return F.binary_cross_entropy_with_logits(logits, labels)


def _sgd(params, lr):
    return torch.optim.SGD(params, lr=lr)


def optimizer(lr=0.1):
    return functools.partial(_sgd, lr=lr)


def dataset_fn(dataset, mode, _):
    feature_spec = {"feature": FixedLenFeature([10], np.int64)}
    if mode != Mode.PREDICTION:
        feature_spec["label"] = FixedLenFeature([1], np.int64)

    def _parse_data(record):
        r = parse_example(record, feature_spec)
        features = {"feature": r["feature"].astype(np.int64)}
        if mode == Mode.PREDICTION:
            return features
        return features, r["label"].astype(np.int32)

    dataset = dataset.map(_parse_data)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024)
    return dataset


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x)


def eval_metrics_fn():
    return {
        "logits": {
            "accuracy": lambda labels, predictions: np.equal(
                (_numpy(predictions).reshape(-1) > 0.0).astype(np.int32),
                _numpy(labels).reshape(-1).astype(np.int32),
            )
        },
        "probs": {"auc": AUC()},
    }
