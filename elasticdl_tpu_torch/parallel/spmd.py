"""The training step over a :class:`~elasticdl_tpu_torch.parallel.mesh.
WorldMesh`: what the reference's GSPMD inserts around a model whose
batch is split over ``data`` and ``seq``, whose experts are split over
``expert`` and whose heads, hidden units and vocabulary are split over
``model``, made explicit for ranks that each run their own shard.

The reference runs the whole model on global arrays; the port runs each
rank on its shard of the batch, (B / data, L / seq), and its part of
the split parameters. So the step builder (``training/step.py``, given
a ``mesh``) calls these:

- :func:`shard_batch`: this rank's rows (its ``data`` slice) and
  columns (its ``seq`` slice) of every feature, and of the labels; every
  ``model`` rank gets the same. On a sequence or a ``model`` axis the
  labels become next-token targets before they are cut: a shard's last
  position targets the first token of the next shard, and the
  sequence's last position is masked (``IGNORE``).
- :func:`make_loss`: on a sequence axis, the next-token cross entropy
  summed over this shard's targets and divided by the whole sequence's
  count of targets, so the shards' losses sum to the loss of the
  sequence (the LM family's ``loss``: position ``t`` predicts token ``t
  + 1``, the mean over every target). On a ``model`` axis the same, on
  the rank's vocabulary part of the logits (:func:`vocab_parallel_ce`).
  Otherwise the zoo's loss as it is.
- :func:`reduce_gradients`: the routed experts' stacks summed over
  ``expert`` (each rank holds the gradient of its own expert's slice),
  then every gradient summed over ``seq`` and averaged over ``data``.
  Nothing is reduced over ``model``: a split parameter's gradient is
  its part's, and a replicated one's is already the whole gradient on
  every ``model`` rank, the same there (the model sums its replicated
  activations' gradients over ``model`` where they enter the split
  products, ``collectives.sum_grad``).
- :func:`reduce_loss`: the loss of the whole batch, for the report.
"""

import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import axis_of

IGNORE = -100  # F.cross_entropy's ignore_index


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np

    return torch.from_numpy(np.array(x))


def _cut(t, dim, axis):
    if axis is None:
        return t
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(
            "dim %d of %d does not split over the %r axis of %d"
            % (dim, n, axis.name, axis.size)
        )
    part = n // axis.size
    return t.narrow(dim, axis.index * part, part)


def shard_batch(features, labels, mesh, seq_axis=None):
    """``(features, labels)`` of the global batch -> this rank's shard;
    on a sequence or a ``model`` axis the labels come back as
    next-token targets."""
    data = axis_of(mesh, "data")
    seq = axis_of(mesh, seq_axis)

    def cut(x):
        t = _cut(_as_tensor(x), 0, data)
        return _cut(t, 1, seq) if seq is not None else t

    features = _map(cut, features)
    if labels is None:
        return features, None
    if seq is not None or axis_of(mesh, "model") is not None:
        labels = _as_tensor(labels).long()
        targets = torch.full_like(labels, IGNORE)
        targets[:, :-1] = labels[:, 1:]
        labels = targets
    return features, cut(labels)


def vocab_parallel_ce(logits, targets, axis):
    """The cross entropy of each position, float32, from this rank's
    vocabulary part of the logits, (B, L, V / T) with the rank's part
    the ``axis.index``-th, and the targets' global ids (B, L): the max,
    the sum of exponentials and the target's logit, each taken over the
    rank's part and maxed or summed over ``axis`` in float32. The
    gradient reaches only this rank's logits (softmax minus one-hot on
    its part). An ``IGNORE`` target reads 0."""
    lf = logits.float()
    part = lf.shape[-1]
    shift = collectives.all_reduce_max(lf.detach().amax(dim=-1), axis)
    sumexp = collectives.all_reduce(
        torch.exp(lf - shift[..., None]).sum(dim=-1), axis
    )
    local = targets - axis.index * part
    mine = (local >= 0) & (local < part)
    picked = lf.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    target = collectives.all_reduce(torch.where(mine, picked, 0.0), axis)
    ce = torch.log(sumexp) + shift - target
    return torch.where(targets != IGNORE, ce, 0.0)


def make_loss(loss_fn, mesh, seq_axis=None):
    """The step's loss on this rank's shard (see the module's text)."""
    seq = axis_of(mesh, seq_axis)
    model = axis_of(mesh, "model")
    if seq is None and model is None:
        return loss_fn

    def next_token_loss(output, targets):
        targets = targets.to(device=output.device, dtype=torch.long)
        b, l = targets.shape
        # every position of the sequence but the last has a target
        count = b * (l * (seq.size if seq is not None else 1) - 1)
        if model is not None:
            return vocab_parallel_ce(output, targets, model).sum() / count
        ce = F.cross_entropy(
            output.reshape(-1, output.shape[-1]), targets.reshape(-1),
            ignore_index=IGNORE, reduction="none",
        )
        return ce.float().sum() / count

    return next_token_loss


def expert_sharded(module, mesh):
    """Names of the parameters that a routed MoE splits over ``expert``
    (empty without an expert axis)."""
    if axis_of(mesh, "expert") is None:
        return set()
    names = set()
    for prefix, m in module.named_modules():
        for pname in getattr(m, "EXPERT_SHARDED", ()):
            names.add((prefix + "." if prefix else "") + pname)
    return names


def _all_reduce_flat(grads, names, axis, scale=None):
    if not names:
        return
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    flat = collectives.all_reduce_sum(flat, axis)
    if scale is not None:
        flat.mul_(scale)
    offset = 0
    for n in names:
        size = grads[n].numel()
        grads[n] = flat[offset:offset + size].view_as(grads[n])
        offset += size


def reduce_gradients(grads, module, mesh, seq_axis=None):
    """``grads`` ({name: tensor}) of this rank's shard -> the whole
    batch's, the same on every rank (one flat all-reduce per axis)."""
    grads = dict(grads)
    expert = axis_of(mesh, "expert")
    if expert is not None:
        sharded = [n for n in grads if n in expert_sharded(module, mesh)]
        _all_reduce_flat(grads, sharded, expert)
    seq = axis_of(mesh, seq_axis)
    if seq is not None:
        _all_reduce_flat(grads, list(grads), seq)
    data = axis_of(mesh, "data")
    if data is not None:
        _all_reduce_flat(grads, list(grads), data, 1.0 / data.size)
    return grads


def reduce_loss(loss, mesh, seq_axis=None):
    """This rank's loss -> the whole batch's: summed over ``seq`` (the
    shards' partial sums), averaged over ``data``."""
    loss = loss.detach().float().reshape(1)
    seq = axis_of(mesh, seq_axis)
    if seq is not None:
        loss = collectives.all_reduce_sum(loss, seq)
    data = axis_of(mesh, "data")
    if data is not None:
        loss = collectives.all_reduce_sum(loss, data) / data.size
    return loss.reshape(())
