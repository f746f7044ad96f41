"""The sparse-comms primitive of the in-graph embedding plane, the
counterpart of ``elasticdl_tpu/nn/sparse_comms.py``.

A recommendation batch repeats the same ids many times, so the HBM
plane's routed lookup (``nn/hbm_embedding.py``) ships only a batch's
unique ids over the ``all_to_all`` and restores the per-occurrence rows
by a local gather through the inverse map. The gather's backward is a
scatter-add over that map, which is the combine of the duplicate rows'
gradients, so the backward exchange also carries one row per unique id.
The host planes dedup on the host with ``np.unique``
(``nn/comm_plane.plan_lookup_multi``).
"""

import torch


def padded_unique(ids_flat):
    """Unique-with-inverse over a flat int id vector, at the input's
    length: ``(uids, inv, n_unique)``. ``uids`` has the input's shape
    and dtype, the sorted unique values at the front and ``-1`` after;
    ``inv`` (int32) maps each input position to its slot in ``uids``
    (``uids[inv]`` is the input); ``n_unique`` is the count of live
    slots, an int32 0-dim tensor on the input's device (no host read).

    The ``-1`` padding is what the routing bodies skip: a padded slot
    takes no per-peer capacity, reads a zero row and is never counted
    as overflow."""
    ids_flat = torch.as_tensor(ids_flat)
    device = ids_flat.device
    m = ids_flat.shape[0]
    if m == 0:
        return (ids_flat, torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    s, order = torch.sort(ids_flat, stable=True)
    first = torch.ones(m, dtype=torch.bool, device=device)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1  # each sorted element's unique slot
    uids = torch.full_like(ids_flat, -1).index_put_((slot,), s)
    inv = torch.empty(m, dtype=torch.int32, device=device)
    inv[order] = slot.to(torch.int32)
    return uids, inv, (slot[-1] + 1).to(torch.int32)
