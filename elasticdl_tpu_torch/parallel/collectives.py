"""Differentiable collectives over one axis of a
:class:`~elasticdl_tpu_torch.parallel.mesh.WorldMesh`: the port's
counterparts of the ``lax`` collectives that the reference's
``shard_map`` bodies call (``all_to_all``, ``ppermute``, ``psum``).

- :func:`all_to_all`: row ``p`` of the input goes to rank ``p`` of the
  axis, row ``p`` of the output came from it (``lax.all_to_all`` with
  ``split_axis=concat_axis=0, tiled=True``). Its transpose is itself.
- :func:`ring_shift`: the tensor goes to the next rank of the axis and
  the previous rank's comes back (``ppermute`` with ``i -> i + 1``). Its
  transpose is the shift the other way.
- :func:`sum_grad` and :func:`scale_grad`: the identity forward whose
  backward sums the gradient over the axis, or scales it. Together they
  are what ``shard_map``'s transpose does to an input and an output that
  are replicated over an axis (the input's cotangent ``psum``-ed, the
  output's divided by the axis size).
- :func:`all_reduce`: the sum over the axis whose backward is the
  identity. With :func:`sum_grad` it is the pair a tensor-parallel block
  puts around its split products (Megatron-LM's ``g`` and ``f``): the
  replicated input's gradient summed, the partial outputs summed.
- :func:`all_reduce_max` and :func:`all_gather` (not differentiable): a
  vocabulary-parallel softmax's shift, and the whole tensor of the
  shards (gathered state, gathered logits).

gloo moves no CUDA tensor through ``send``/``recv``, and the port's ranks
that share one card form a gloo world. There every exchange is staged:
the tensor is copied to a host buffer, exchanged between the ranks'
host buffers, and copied back to the card. Nothing is computed on the
host: only the bytes cross it. :data:`staging` counts the bytes and the
seconds of those copies, and the seconds of the exchanges, so a run can
report what the staging costs. An NCCL group (each rank on a card of its
own) and CPU tensors exchange in place.
"""

import threading
import time

import torch
import torch.distributed as dist


class StagingStats:
    """By kind of exchange (``shift``, ``all_to_all``, ``all_reduce``,
    ``all_reduce_max``, ``all_gather``):
    how many, the bytes and seconds of their host staging (CUDA tensors
    over gloo), and the seconds of the exchanges themselves."""

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self):
        with self._mu:
            self._kinds = {}

    def add(self, kind, nbytes, copy_s, exchange_s):
        with self._mu:
            k = self._kinds.setdefault(kind, {
                "exchanges": 0, "staged_bytes": 0, "copy_s": 0.0,
                "exchange_s": 0.0})
            k["exchanges"] += 1
            k["staged_bytes"] += int(nbytes)
            k["copy_s"] += copy_s
            k["exchange_s"] += exchange_s

    def snapshot(self):
        """{kind: {"exchanges", "staged_bytes", "copy_s", "exchange_s"}}."""
        with self._mu:
            return {kind: dict(v) for kind, v in self._kinds.items()}


staging = StagingStats()


def _staged(t, axis):
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def _exchange(kind, t, axis, run):
    """``run(host_or_device_input) -> output`` around the staging: a
    CUDA tensor on a gloo group goes through a host copy and back."""
    start = time.perf_counter()
    if not _staged(t, axis):
        out = run(t.contiguous())
        staging.add(kind, 0, 0.0, time.perf_counter() - start)
        return out
    device = t.device
    host = t.detach().to("cpu", copy=True)
    # the copy back is issued on the current stream: wait for it below
    copied = time.perf_counter()
    out = run(host)
    exchanged = time.perf_counter()
    back = out.to(device)
    torch.cuda.current_stream(device).synchronize()
    done = time.perf_counter()
    staging.add(
        kind,
        host.numel() * host.element_size() + out.numel() * out.element_size(),
        (copied - start) + (done - exchanged),
        exchanged - copied,
    )
    return back


def _all_to_all(t, axis):
    def run(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=axis.group)
        return out

    return _exchange("all_to_all", t, axis, run)


def _shift(t, axis, step):
    """``t`` to the rank ``step`` places on along the axis, the one
    ``step`` places back's in return."""
    n = axis.size
    if step % n == 0:
        return t
    dst = axis.ranks[(axis.index + step) % n]
    src = axis.ranks[(axis.index - step) % n]

    def run(x):
        out = torch.empty_like(x)
        ops = [
            dist.P2POp(dist.isend, x, dst, group=axis.group),
            dist.P2POp(dist.irecv, out, src, group=axis.group),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    return _exchange("shift", t, axis, run)


def _all_reduce(t, axis, op=dist.ReduceOp.SUM, kind="all_reduce"):
    def run(x):
        out = x.clone()
        dist.all_reduce(out, op=op, group=axis.group)
        return out

    return _exchange(kind, t.detach(), axis, run)


def _all_gather(t, axis, dim):
    def run(x):
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim=dim)

    return _exchange("all_gather", t.detach(), axis, run)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_to_all(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, step):
        ctx.axis, ctx.step = axis, step
        return _shift(t, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.step), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.axis), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return _all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_to_all(t, axis):
    """Rows of ``t`` (its leading dim, the axis size) to the ranks of
    ``axis``; differentiable."""
    if t.shape[0] != axis.size:
        raise ValueError(
            "all_to_all over %r needs a leading dim of %d, got %s"
            % (axis, axis.size, tuple(t.shape))
        )
    return _AllToAll.apply(t, axis)


def ring_shift(t, axis, step=1):
    """``t`` to the rank ``step`` places on along ``axis``, the rank
    ``step`` places back's tensor returned; differentiable."""
    return _RingShift.apply(t, axis, step)


def ring_shift_raw(t, axis, step=1):
    """:func:`ring_shift` outside autograd (a custom backward's)."""
    return _shift(t, axis, step)


def all_reduce_sum(t, axis):
    """The sum of ``t`` over the ranks of ``axis`` (a new tensor; not
    differentiable)."""
    return _all_reduce(t, axis)


def all_reduce(t, axis):
    """The sum of ``t`` over ``axis``; its gradient passes unchanged (the
    sum's output is replicated, each rank's input a partial)."""
    return _AllReduce.apply(t, axis)


def all_reduce_max(t, axis):
    """The elementwise max of ``t`` over ``axis`` (not differentiable)."""
    return _all_reduce(t, axis, dist.ReduceOp.MAX, "all_reduce_max")


def all_gather(t, axis, dim=0):
    """The ranks' ``t`` of ``axis`` concatenated along ``dim``, in axis
    order (not differentiable)."""
    return _all_gather(t, axis, dim)


def sum_grad(t, axis):
    """``t`` unchanged; its gradient summed over ``axis``."""
    return _SumGrad.apply(t, axis)


def scale_grad(t, scale):
    """``t`` unchanged; its gradient multiplied by ``scale``."""
    return _ScaleGrad.apply(t, scale)
