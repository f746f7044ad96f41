"""Multi-process elastic data-parallel training, the counterpart of
``elasticdl_tpu/parallel/elastic.py`` on its replicated plane: one
worker process is one device of the reference's mesh, the parameters are
replicated in every process, and each step's gradient exchange is a
collective of the ``torch.distributed`` world that
``parallel/distributed.py`` forms per membership epoch.

The reference's three problems, and the port's answers:

- **Lockstep with independent task queues.** Each process pulls its own
  tasks, so processes run out of data at different times, yet every
  process must join every collective. The step is weighted: each rank
  carries a weight ``w`` (its true rows over the padded rows, 0 without
  data), its gradient counts ``w / max(Σw, 1e-6)``, and the step returns
  the live count ``Σ(w > 0)``. A rank without data feeds its previous
  batch at weight 0 and keeps stepping until the live count is 0.
- **State continuity across epochs.** The state stays on the device while
  the world re-forms; :meth:`ElasticDPTrainer.establish` then broadcasts
  it from the lowest rank that holds one (rank 0, the longest-lived
  survivor): parameters, model state (BatchNorm statistics), the
  optimizer's state (SGD's momentum) and the version. A joiner offers
  nothing and receives them.
- **Failure visibility.** A peer's death fails the step's collective on
  every survivor; the worker sees :class:`WorldBroken`. The state is
  updated only after the collective returns, so the pre-step state is
  intact for the re-form.

One step carries its whole exchange in **one flattened SUM all-reduce**
(each gradient times ``w``, the loss times ``w``, each float state leaf
times ``w``, then ``w`` and ``w > 0``) plus one MAX of the members'
polled membership epochs and of whether their task streams are still
open; the sums are divided by ``max(Σw, 1e-6)``
afterwards, which equals the reference's scaling of each contribution by
``w / Σw``. Integer state leaves keep the rank's own values. With no live
rank the step changes nothing: no update, no version.

The reference's sharded, pjit and pipelined planes (mirrors, the layout
solver, the compile plane) are not ported; neither are deferred loss
fetches: every step ends in a host read of its live count.
"""

import hashlib
import time

import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.sharded_checkpoint import (
    split_train_state_leaves,
    train_state_leaves,
)
from elasticdl_tpu_torch.data.dataset import tree_map
from elasticdl_tpu_torch.parallel import distributed
from elasticdl_tpu_torch.parallel.trainer import (
    AllReduceTrainer,
    place_module,
)
from elasticdl_tpu_torch.training.precision import get_policy
from elasticdl_tpu_torch.training.step import (
    TrainState,
    _apply,
    _loss_and_grads,
    accumulate_gradients,
    fold_in,
    make_remat_forward,
)
from elasticdl_tpu_torch.utils import profiling

_WAIT_POLL_S = 0.001  # collective completion poll
_ABORT_CHECK_S = 1.0  # how often a waiting collective asks abort_check

# the establish pause, scraped through /metrics: one observation per
# establish()
_RESIZE_PAUSE = profiling.metrics.histogram(
    "edl_resize_pause_seconds",
    "establish() wall seconds, world re-form through step-fn acquire",
    labels=("compile_phase",),
)


def _pad_rows(x, rows):
    """``x`` cut or padded to ``rows`` rows, the last row repeated."""
    import numpy as np

    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    short = rows - x.shape[0]
    if short <= 0:
        return x[:rows]
    return torch.cat([x, x[-1:].expand(short, *x.shape[1:])])


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_digest(ts):
    """A bitwise fingerprint of the parameters and the model state,
    computed where they live: per tensor, in name order, the int64 sums
    (wrapping, so any summation order gives the same value) of its words
    and of its words times their position mod 65521, plus one; the
    sums, names and dtypes are then hashed. Equal bits give equal
    digests on any device; one flipped word changes them."""
    h = hashlib.sha256()
    sums = []
    for part in (ts.params, ts.state):
        for name in sorted(part):
            t = part[name].detach().contiguous().reshape(-1)
            words = t.view(_WORDS[t.element_size()]).to(torch.int64)
            pos = torch.arange(
                words.numel(), device=t.device, dtype=torch.int64
            ) % 65521 + 1
            sums.append(torch.stack([words.sum(), (words * pos).sum()]))
            h.update(("%s:%s;" % (name, t.dtype)).encode("utf-8"))
    if sums:
        h.update(repr(torch.stack(sums).cpu().tolist()).encode("utf-8"))
    return h.hexdigest()


class ElasticDPTrainer(AllReduceTrainer):
    """One process's handle on the replicated elastic plane."""

    def __init__(
        self,
        module,
        loss_fn,
        optimizer,
        seed=0,
        precision=None,
        accum_steps=1,
        remat=False,
        device="cuda",
    ):
        super().__init__(
            module, loss_fn, optimizer, seed=seed, accum_steps=accum_steps,
            precision=precision, remat=remat, device=device,
        )
        self._loss_fn = loss_fn
        self._accum_steps = max(1, accum_steps)
        self._pol = get_policy(precision)
        self._forward = make_remat_forward(module, remat)
        self._spec = None
        self.backend = None
        self._last_local = None  # (features, labels) for weight-0 steps
        self.epoch_consensus = None  # newest epoch any member has seen
        # whether any member's task stream was still open at the step
        self.pending_consensus = False
        # the worker sets it to a "did one of my peers die?" probe; a
        # collective waiting on a dead peer then gives up
        self.abort_check = None
        # (host step, its timeline points) of the last step and of the
        # one before it, whose end the stream has passed
        self._marks = self._timed = None
        # the last establish's seconds: the world's formation, the
        # source rank's choice, and that with the state's broadcast
        self.establish_times = {}

    @property
    def has_state(self):
        return self._ts is not None

    # -- forming a world ----------------------------------------------------

    def _small(self, values, dtype):
        """A control tensor on the device the backend exchanges."""
        device = self._device if self.backend == "nccl" else "cpu"
        return torch.tensor(values, dtype=dtype, device=device)

    def _wait(self, works):
        """Wait for collective ``works``, asking ``abort_check`` now and
        then: a peer that died mid-collective raises WorldBroken."""
        next_check = time.monotonic() + _ABORT_CHECK_S
        try:
            while not all(w.is_completed() for w in works):
                if time.monotonic() >= next_check:
                    next_check = time.monotonic() + _ABORT_CHECK_S
                    if self.abort_check is not None and self.abort_check():
                        raise distributed.WorldBroken(
                            "a member of world epoch %d died mid-collective"
                            % self._spec.epoch
                        )
                time.sleep(_WAIT_POLL_S)
            for w in works:
                w.wait()
        except distributed.WorldBroken:
            raise
        except Exception as e:
            raise distributed.WorldBroken(
                "collective of world epoch %d failed: %s"
                % (self._spec.epoch, e)
            ) from e

    def _all_reduce(self, tensor, op):
        self._wait([dist.all_reduce(tensor, op=op, async_op=True)])

    def _replicated_source_rank(self):
        """Lowest rank holding state (the broadcast source), or -1 when
        nobody does."""
        mine = 1 if self._ts is not None else 0
        if self._spec.num_processes <= 1:
            return 0 if mine else -1
        flags = self._small([0] * self._spec.num_processes, torch.int64)
        flags[self._spec.process_id] = mine
        self._all_reduce(flags, dist.ReduceOp.SUM)
        ranks = [r for r, has in enumerate(flags.tolist()) if has]
        return min(ranks) if ranks else -1

    def _empty_state(self):
        """A train state with this model's structure and placement but no
        values worth keeping: a joiner's stand-in, overwritten by the
        broadcast."""
        place_module(self._module, self._device)
        return TrainState.create(
            dict(self._module.named_parameters()),
            dict(self._module.named_buffers()),
            self._optimizer,
        )

    def _broadcast_state(self, source):
        """Every rank adopts ``source``'s train state: the leaf list goes
        first (a joiner's optimizer has no momentum yet), then one flat
        buffer per dtype."""
        if self._spec.num_processes <= 1:
            return
        me = self._spec.process_id
        leaves = train_state_leaves(self._ts)
        manifest = [None]
        if me == source:
            manifest[0] = [
                (path, tuple(t.shape), t.dtype) for path, t in leaves.items()
            ]
        dist.broadcast_object_list(manifest, src=source)
        manifest = manifest[0]
        by_dtype = {}
        for path, shape, dtype in manifest:
            by_dtype.setdefault(dtype, []).append((path, shape))
        received = {}
        for dtype, entries in by_dtype.items():
            if me == source:
                flat = torch.cat([
                    leaves[path].detach().reshape(-1).to(self._device)
                    for path, _ in entries
                ])
            else:
                flat = torch.empty(
                    sum(int(torch.Size(s).numel()) for _, s in entries),
                    dtype=dtype, device=self._device,
                )
            self._wait([dist.broadcast(flat, src=source, async_op=True)])
            off = 0
            for path, shape in entries:
                n = int(torch.Size(shape).numel())
                received[path] = flat[off:off + n].reshape(shape).clone()
                off += n
        if me == source:
            return
        params, state, opt, version = split_train_state_leaves(
            received, list(self._ts.params)
        )
        groups = self._ts.opt_state.state_dict()["param_groups"]
        self._adopt(
            {n: params[n] for n in self._ts.params},
            state,
            {"state": opt, "param_groups": groups},
            version,
        )

    def establish(self, spec, example_batch=None):
        """Join ``spec``'s world and adopt the state of its lowest rank
        that has one. When nobody has state (the first world), every
        rank initializes from the trainer's seed, identically, and rank
        0's copy is broadcast all the same. Each establish emits the
        ``resize_begin`` and ``resize_end`` events and observes
        ``edl_resize_pause_seconds`` (its ``compile_phase`` label reads
        ``none``: nothing is compiled here)."""
        t0 = time.perf_counter()
        profiling.events.emit(
            "resize_begin",
            epoch=spec.epoch,
            rank=spec.process_id,
            world_size=spec.num_processes,
        )
        self.backend = distributed.ensure_world(spec, self._device)
        self._spec = spec
        t_world = time.perf_counter()
        source = self._replicated_source_rank()
        t_source = time.perf_counter()
        if source < 0:
            if example_batch is None:
                raise ValueError("the first establish() needs a batch")
            self.init_from_batch(example_batch)
            source = 0
        elif self._ts is None:
            self._ts = self._empty_state()
        self._broadcast_state(source)
        # source_s: the first collective of the world, so it holds the
        # wait for the slowest member to arrive
        self.establish_times = {
            "world_s": t_world - t0,
            "source_s": t_source - t_world,
            "broadcast_s": time.perf_counter() - t_world,
        }
        logger.info(
            "elastic plane established: epoch=%d rank=%d/%d backend=%s "
            "source=%d version=%d (world %.2fs, broadcast %.2fs)",
            spec.epoch,
            spec.process_id,
            spec.num_processes,
            self.backend,
            source,
            self.version,
            self.establish_times["world_s"],
            self.establish_times["broadcast_s"],
        )
        profiling.events.emit(
            "resize_end",
            epoch=spec.epoch,
            rank=spec.process_id,
            world_size=spec.num_processes,
            backend=self.backend,
            compile_phase="none",
            **{k: round(v, 3) for k, v in self.establish_times.items()},
        )
        _RESIZE_PAUSE.observe(time.perf_counter() - t0, compile_phase="none")

    # -- the weighted step --------------------------------------------------

    def local_rows(self, minibatch_size):
        """Fixed per-process rows: the minibatch padded to whole
        microbatches."""
        chunk = self._accum_steps
        return -(-minibatch_size // chunk) * chunk

    def _mark(self):
        """A point on the step's timeline that costs no host wait: an
        event on the card's stream, the host clock on the CPU (where
        every op has finished when it returns)."""
        if self._device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @property
    def host_step(self):
        """The number of steps this process has taken, all worlds."""
        return self._host_step

    @property
    def step_times(self):
        """The split of the step before the last one, in seconds:
        compute (forward, backward and the flat buffer), the flattened
        all-reduce, and the rest (state and the optimizer update), with
        its ``host_step``. That step's end is behind the last step's
        host read of the live count, so reading its events waits for
        nothing; on the card they are the stream's times."""
        if self._timed is None:
            return {}
        host_step, m = self._timed
        if self._device.type == "cuda":
            gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        else:
            gaps = [b - a for a, b in zip(m, m[1:])]
        return {
            "host_step": host_step,
            "compute_s": gaps[0],
            "allreduce_s": gaps[1],
            "rest_s": gaps[2],
            "step_s": sum(gaps),
        }

    def _grads(self, features, labels, rng):
        ts = self._ts

        def grads_of(state, f, l, r):
            loss, grads, new_state, _ = _loss_and_grads(
                self._forward, self._loss_fn, self._pol, ts.params, state,
                f, l, r,
            )
            return loss, grads, new_state

        if self._accum_steps == 1:
            return grads_of(ts.state, features, labels, rng)
        return accumulate_gradients(
            grads_of, ts.state, features, labels, rng, self._accum_steps,
            ts.params,
        )

    def train_step(self, features, labels, minibatch_size, epoch_hint=0,
                   pending=False):
        """One weighted lockstep step; ``features=None`` takes part at
        weight 0 on the previous batch. Returns (loss, live count, this
        process's true rows). ``epoch_hint`` is this process's last
        polled membership epoch and ``pending`` whether its task stream
        is still open; the step's MAX over the members lands in
        :attr:`epoch_consensus` and :attr:`pending_consensus`, the same
        values on every rank.

        Raises :class:`WorldBroken` when a collective fails; the state
        is then as it was before the step."""
        rows = self.local_rows(minibatch_size)
        if features is not None:
            count = int(_first_leaf(features).shape[0])
            pad = lambda x: _pad_rows(x, rows).to(self._device)  # noqa: E731
            local = (tree_map(pad, features), tree_map(pad, labels))
            self._last_local = local
            w = min(1.0, count / rows)
        else:
            count = 0
            if self._last_local is None:
                raise RuntimeError(
                    "cannot run a weight-0 step before the first data step"
                )
            local = self._last_local
            w = 0.0
        ts = self._ts
        self._host_step += 1
        # decorrelate stochastic layers (dropout) across the ranks
        rng = fold_in(
            fold_in(self._seed, self._host_step), self._spec.process_id
        )
        m0 = self._mark()
        loss, grads, new_state = self._grads(local[0], local[1], rng)
        # one flat f32 buffer: w*grads | w*loss | w*float state | w | w>0
        floats = [n for n, v in new_state.items() if v.is_floating_point()]
        sizes = [g.numel() for g in grads.values()]
        sizes += [1] + [new_state[n].numel() for n in floats] + [1, 1]
        flat = torch.empty(sum(sizes), dtype=torch.float32,
                           device=self._device)
        parts = list(flat.split(sizes))
        for part, g in zip(parts, grads.values()):
            torch.mul(g.reshape(-1), w, out=part)
        k = len(grads)
        torch.mul(loss.reshape(1).float(), w, out=parts[k])
        for part, n in zip(parts[k + 1:], floats):
            torch.mul(new_state[n].reshape(-1).float(), w, out=part)
        parts[-2].fill_(w)
        parts[-1].fill_(1.0 if w > 0 else 0.0)
        epoch = self._small([int(epoch_hint), int(bool(pending))],
                            torch.int64)
        m1 = self._mark()
        if self._spec.num_processes > 1:
            self._wait([
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, async_op=True),
                dist.all_reduce(epoch, op=dist.ReduceOp.MAX, async_op=True),
            ])
        m2 = self._mark()
        # the step's one host read: lockstep needs the live count
        tail = parts[-2].tolist() + parts[-1].tolist() + parts[k].tolist()
        w_sum, live, loss_sum = tail
        live = int(round(live))
        denom = max(w_sum, 1e-6)
        self.epoch_consensus, pending = epoch.tolist()
        self.pending_consensus = bool(pending)
        if live > 0:
            ts.state = dict(new_state)
            for part, n in zip(parts[k + 1:], floats):
                ts.state[n] = (part / denom).reshape(
                    new_state[n].shape
                ).to(new_state[n].dtype)
            _apply(
                ts.opt_state,
                ts.params,
                {n: part.div_(denom).reshape(p.shape)
                 for (n, p), part in zip(ts.params.items(), parts)},
            )
            ts.version += 1
        self._timed = self._marks
        self._marks = (self._host_step, (m0, m1, m2, self._mark()))
        return loss_sum / denom, live, count

    # -- state on the host, checkpoints, leaving ----------------------------

    def snapshot(self):
        """The train state as owned host copies (the export's source), or
        None before any state exists."""
        return self.get_host_state() if self._ts is not None else None

    def host_params(self):
        return self.snapshot().params

    def load_host_state(self, host_ts):
        """Adopt a host train state (``snapshot()``'s form: the optimizer
        state as its ``state_dict``, or the optimizer) before
        establish."""
        opt = host_ts.opt_state
        if not isinstance(opt, dict):
            opt = opt.state_dict()
        self._adopt(host_ts.params, host_ts.state, opt, host_ts.version)

    def digest(self):
        return state_digest(self._ts)

    def leave(self):
        """Leave the world at an epoch boundary; the state stays on the
        device for the next one."""
        distributed.leave_world()
        self._spec = None
