"""Expert parallelism, the counterpart of ``elasticdl_tpu/parallel/expert.py``:
top-k gating, the Switch load-balancing loss, the dense reference, and
the routed mixture of experts over an ``expert`` axis of a
:class:`~elasticdl_tpu_torch.parallel.mesh.WorldMesh`.

Each rank of the axis owns one expert. Tokens are gated top-k, packed
into capacity-bounded per-expert buckets, shipped to their expert with
one all-to-all, transformed, and shipped back with another
(``parallel/collectives.all_to_all``). Overflow tokens bypass the
experts: they contribute zero. The bucket sort is the reference's (a
stable argsort, ``bincount``, a trash column at ``cap``), so the port
chooses the same tokens to overflow.

The reference's ``make_moe_fn`` is a ``shard_map`` whose tokens are
replicated over the expert axis. Its transpose divides the output's
cotangent by the axis size and sums the tokens' and gate logits'
cotangents over the axis; :func:`make_moe_fn` does the same
(``scale_grad``, ``sum_grad``), so every gradient has the reference's
scale. The plain functions (:func:`topk_gate`, :func:`load_balancing_loss`,
:func:`reference_moe`) run on any device.
"""

import torch

from elasticdl_tpu_torch.parallel import collectives


def topk_gate(logits, k):
    """(T, E) gate logits -> (expert_idx (T, k), gate_probs (T, k)).

    For ``k > 1`` the selected probabilities renormalize to sum to 1
    per token (the GShard top-2 recipe)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return idx, gate


def top1_gate(logits):
    """(T, E) gate logits -> (expert_idx (T,), gate_prob (T,))."""
    idx, gate = topk_gate(logits, 1)
    return idx[:, 0], gate[:, 0]


def load_balancing_loss(gate_logits, axis=None):
    """Switch-transformer auxiliary loss: ``E * sum_e f_e * P_e``.

    ``f_e`` = fraction of tokens whose top-1 expert is ``e``; ``P_e`` =
    mean router probability for ``e``. Equals 1.0 at perfect balance,
    grows as routing collapses onto few experts. Differentiable through
    ``P_e`` (the ``f_e`` factor is piecewise-constant, as in the paper).

    ``axis``: an axis the tokens are split over (``data``). ``f`` is
    then the mean over the whole axis and ``P`` this rank's own, so the
    ranks' mean loss and mean gradient are the reference's on the whole
    batch."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    e = probs.shape[-1]
    top1 = torch.argmax(probs, dim=-1)
    f = torch.nn.functional.one_hot(top1, e).float().mean(dim=0)
    if axis is not None:
        f = collectives.all_reduce_sum(f, axis) / axis.size
    p = probs.mean(dim=0)
    return e * (f * p).sum()


def moe_apply(
    expert_fn,
    expert_params,
    x,
    gate_logits,
    axis,
    capacity,
    num_selected=1,
):
    """Route tokens to experts over ``axis`` (a mesh :class:`Axis`).

    - ``expert_fn(params, x) -> y``: one expert's computation (same
      in/out feature width).
    - ``expert_params``: this rank's expert's parameter slice (leading
      dim 1, squeezed here).
    - ``x``: (T, D) local tokens; ``gate_logits``: (T, E).
    - ``num_selected``: top-k routing. Each (token, choice) pair routes
      as a virtual token through one shared capacity budget, and a
      token's k expert outputs sum gate-weighted.

    Returns (T, D): gate-weighted expert outputs, overflow tokens zero.
    """
    n_exp = axis.size
    params = {k: v.squeeze(0) for k, v in expert_params.items()}
    t_local, d = x.shape
    k = num_selected

    idx_tk, gate_tk = topk_gate(gate_logits, k)
    # choice-major virtual tokens: v[j*T + t] = (token t, choice j)
    expert_idx = idx_tk.T.reshape(-1)  # (k*T,)
    gate = gate_tk.T.reshape(-1)
    vx = x.repeat(k, 1)  # (k*T, D)
    t_virtual = k * t_local
    cap = min(capacity, t_virtual)

    # position of each virtual token within its expert's bucket
    order = torch.argsort(expert_idx, stable=True)
    sorted_expert = expert_idx[order]
    counts = torch.bincount(expert_idx, minlength=n_exp)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t_virtual, device=x.device) - starts[sorted_expert]
    ok = pos < cap
    slot = torch.where(ok, pos, torch.full_like(pos, cap))  # trash column

    # (E, cap+1, D) send buffer; row e = tokens for expert e
    send = x.new_zeros((n_exp, cap + 1, d))
    send = send.index_put((sorted_expert, slot), vx[order])[:, :cap]
    # (E, cap, D): row p = tokens rank p sent to THIS expert
    recv = collectives.all_to_all(send.contiguous(), axis)

    y = expert_fn(params, recv.reshape(n_exp * cap, d))
    y = y.reshape(n_exp, cap, d)
    # (E, cap, D): row e = this rank's tokens back from expert e
    back = collectives.all_to_all(y.contiguous(), axis)

    # un-permute; overflow tokens contribute zero
    picked = back[sorted_expert, torch.where(ok, pos, torch.zeros_like(pos))]
    gathered = torch.where(ok[:, None], picked, torch.zeros_like(picked))
    inv = torch.argsort(order, stable=True)
    routed = gathered[inv] * gate[:, None].to(x.dtype)
    return routed.reshape(k, t_local, d).sum(dim=0)


def make_moe_fn(
    mesh,
    expert_fn,
    expert_axis="expert",
    batch_axis=None,
    capacity_factor=2.0,
    num_selected=1,
):
    """``(stacked_expert_params, x, gate_logits) -> y`` on this rank.

    ``stacked_expert_params`` leaves are the whole (E, ...) stacks; this
    rank computes with its own expert's slice (its index on
    ``expert_axis``), so the stack's gradient is nonzero in that slice
    alone and a sum over the axis assembles it. ``x`` is this rank's
    (T, D) tokens (its shard over ``batch_axis``, all of them when that
    is None), replicated over the expert axis, and ``gate_logits`` (T,
    E) likewise. Capacity per expert = ceil(T_local * num_selected / E)
    * capacity_factor. The expert axis's size must equal the number of
    experts: one expert per rank, as in the reference."""
    axis = mesh.axis(expert_axis)
    if batch_axis is not None:
        mesh.axis(batch_axis)  # the axis must exist, as in a spec

    def _capacity(t_local, n_exp):
        return max(
            1,
            int(-(-(t_local * num_selected) // n_exp) * capacity_factor),
        )

    def _moe(stacked_params, x, gate_logits):
        n_exp = next(iter(stacked_params.values())).shape[0]
        if n_exp != axis.size:
            raise ValueError(
                "%d experts over an %r axis of %d ranks: the routed MoE "
                "takes one expert per rank" % (n_exp, expert_axis, axis.size)
            )
        mine = {
            name: p[axis.index:axis.index + 1]
            for name, p in stacked_params.items()
        }
        x = collectives.sum_grad(x, axis)
        gate_logits = collectives.sum_grad(gate_logits, axis)
        y = moe_apply(
            expert_fn,
            mine,
            x,
            gate_logits,
            axis,
            _capacity(x.shape[0], axis.size),
            num_selected=num_selected,
        )
        return collectives.scale_grad(y, 1.0 / axis.size)

    return _moe


def reference_moe(expert_fn, per_expert_params, x, gate_logits,
                  num_selected=1):
    """Dense semantics the routed form must match: every expert runs
    every token, outputs combined by the top-k gate."""
    idx, gate = topk_gate(gate_logits, num_selected)
    outs = torch.stack(
        [expert_fn(p, x) for p in per_expert_params]
    )  # (E, T, D)
    t = torch.arange(x.shape[0], device=x.device)
    picked = sum(
        outs[idx[:, j], t] * gate[:, j, None].to(x.dtype)
        for j in range(num_selected)
    )
    return picked
