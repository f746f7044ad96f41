"""A streaming Dataset, the counterpart of ``elasticdl_tpu/data/dataset.py``.

The fluent surface a zoo ``dataset_fn(dataset, mode, metadata)`` uses —
``map / filter / shuffle / batch / repeat / take / prefetch`` — over
plain Python iterators of numpy-structured elements (dicts/tuples of
arrays). ``batch`` stacks leaf-wise; ``prefetch`` runs the upstream
pipeline in a daemon thread. A seeded ``shuffle`` draws the same order as
the reference's. A Dataset can carry an ``input_stats.InputPlaneStats``:
every transform passes it on and charges its own stage (``map`` parse
time, ``batch`` assembly, ``prefetch`` consumer starvation,
``device_prefetch`` the host side of its copies).

``device_prefetch(device)`` moves batches to the card ahead of their
use: each leaf is copied into pinned host memory and from there, without
blocking, on a side CUDA stream; the consuming stream waits on the
copy's event, and each batch is marked as used by that stream so the
caching allocator does not hand its memory out early. On the CPU, which
the caller must name, it is a plain conversion to tensors.
"""

import collections
import concurrent.futures
import queue
import random as _random
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device


def _tree_stack(elements):
    """Stack a list of same-structure elements leaf-wise (``np.stack``'s
    promotion semantics; the path for bytes/str/object leaves)."""
    first = elements[0]
    if isinstance(first, dict):
        return {k: _tree_stack([e[k] for e in elements]) for k in first}
    if isinstance(first, (tuple, list)):
        stacked = [
            _tree_stack([e[i] for e in elements]) for i in range(len(first))
        ]
        return tuple(stacked) if isinstance(first, tuple) else stacked
    return np.stack([np.asarray(e) for e in elements])


class _NoFastPath(Exception):
    """A leaf the preallocated batch assembly must not host."""


def _batch_buffers(first, n):
    """Same-structure tree of preallocated (n, *leaf.shape) buffers."""
    if isinstance(first, dict):
        return {k: _batch_buffers(v, n) for k, v in first.items()}
    if isinstance(first, (tuple, list)):
        bufs = [_batch_buffers(v, n) for v in first]
        return tuple(bufs) if isinstance(first, tuple) else bufs
    leaf = np.asarray(first)
    if leaf.dtype == object or leaf.dtype.kind in "USV":
        raise _NoFastPath
    return np.empty((n,) + leaf.shape, leaf.dtype)


def _batch_fill(buf, element, i):
    """Write ``element``'s leaves into row ``i`` of the buffers in place."""
    if isinstance(buf, dict):
        for k in buf:
            _batch_fill(buf[k], element[k], i)
    elif isinstance(buf, (tuple, list)):
        for b, e in zip(buf, element):
            _batch_fill(b, e, i)
    else:
        leaf = np.asarray(element)
        if leaf.dtype != buf.dtype or leaf.shape != buf.shape[1:]:
            # a leaf that differs from element 0's: only np.stack has the
            # right promotion semantics
            raise _NoFastPath
        buf[i] = leaf


def _tree_assemble(elements):
    """One preallocated buffer per leaf, filled row by row; falls back to
    :func:`_tree_stack` where fixed-width buffers cannot host a leaf."""
    try:
        buffers = _batch_buffers(elements[0], len(elements))
        for i, e in enumerate(elements):
            _batch_fill(buffers, e, i)
    except _NoFastPath:
        return _tree_stack(elements)
    return buffers


class Dataset:
    """Lazily-evaluated record stream; each transform returns a new Dataset."""

    def __init__(self, gen_factory, stats=None):
        self._gen_factory = gen_factory
        self._stats = stats

    @staticmethod
    def from_generator(gen_factory, stats=None):
        """gen_factory: zero-arg callable returning a fresh iterator."""
        return Dataset(gen_factory, stats=stats)

    @staticmethod
    def from_tensors(elements):
        elements = list(elements)
        return Dataset(lambda: iter(elements))

    def map(self, fn, num_parallel_calls=None):
        """Apply ``fn`` per element; with ``num_parallel_calls`` > 1 on a
        thread pool, merged back in input order (an exception raised on
        element i surfaces after element i-1). An abandoned consumer stops
        the pool from pulling more of the source."""
        stats = self._stats
        # parse time accumulates in locals and reaches the (locked) stats
        # once per iteration, not per record
        if not num_parallel_calls or num_parallel_calls <= 1:

            def gen():
                parse_s = 0.0
                perf = time.perf_counter
                try:
                    for x in self._gen_factory():
                        t0 = perf()
                        out = fn(x)
                        parse_s += perf() - t0
                        yield out
                finally:
                    if stats is not None:
                        stats.add("parse_s", parse_s)

            return Dataset(gen, stats=stats)

        window = 2 * num_parallel_calls

        def timed(x):
            t0 = time.perf_counter()
            out = fn(x)
            return time.perf_counter() - t0, out

        def gen():
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=num_parallel_calls,
                thread_name_prefix="edl-map",
            )
            pending = collections.deque()
            parse_s = 0.0

            def resolve(future):
                nonlocal parse_s
                dt, out = future.result()
                parse_s += dt
                return out

            try:
                for x in self._gen_factory():
                    pending.append(pool.submit(timed, x))
                    if len(pending) >= window:
                        yield resolve(pending.popleft())
                while pending:
                    yield resolve(pending.popleft())
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
                if stats is not None:
                    stats.add("parse_s", parse_s)

        return Dataset(gen, stats=stats)

    def filter(self, pred):
        def gen():
            for x in self._gen_factory():
                if pred(x):
                    yield x

        return Dataset(gen, stats=self._stats)

    def shuffle(self, buffer_size, seed=None, reshuffle_each_iteration=True):
        """Streaming buffer shuffle with tf.data semantics: a seeded
        dataset is deterministic within one iteration and, by default,
        draws a new order on each re-iteration. The seeded draws are the
        reference's, so both packages yield the same order."""
        iteration = collections.deque((0,))  # mutable epoch counter

        def gen():
            epoch = iteration[0]
            iteration[0] = epoch + 1
            if seed is None:
                rng = _random.Random()
            elif reshuffle_each_iteration:
                rng = _random.Random(seed * 0x9E3779B1 + epoch)
            else:
                rng = _random.Random(seed)
            buf = []
            for x in self._gen_factory():
                buf.append(x)
                if len(buf) >= buffer_size:
                    i = rng.randrange(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return Dataset(gen, stats=self._stats)

    def batch(self, batch_size, drop_remainder=False, vectorized=True):
        """Group ``batch_size`` elements into one stacked tree;
        ``vectorized`` fills preallocated per-leaf buffers, False stacks
        with ``np.stack`` (identical arrays for numeric trees)."""
        assemble = _tree_assemble if vectorized else _tree_stack
        stats = self._stats

        def emit(batch):
            t0 = time.perf_counter()
            out = assemble(batch)
            if stats is not None:
                stats.add("batch_s", time.perf_counter() - t0)
                stats.count("batches")
            return out

        def gen():
            batch = []
            for x in self._gen_factory():
                batch.append(x)
                if len(batch) == batch_size:
                    yield emit(batch)
                    batch = []
            if batch and not drop_remainder:
                yield emit(batch)

        return Dataset(gen, stats=stats)

    def repeat(self, count=None):
        def gen():
            n = 0
            while count is None or n < count:
                empty = True
                for x in self._gen_factory():
                    empty = False
                    yield x
                if empty:
                    return
                n += 1

        return Dataset(gen, stats=self._stats)

    def take(self, n):
        def gen():
            for i, x in enumerate(self._gen_factory()):
                if i >= n:
                    return
                yield x

        return Dataset(gen, stats=self._stats)

    def prefetch(self, buffer_size=1):
        """Run the upstream pipeline in a background thread. The producer
        is cancelled when the consumer generator is closed or collected,
        so an abandoned consumer leaks no blocked thread."""

        def gen():
            q = queue.Queue(maxsize=max(1, buffer_size))
            end = object()
            cancel = threading.Event()

            def put_or_cancel(item):
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        return True
                    except queue.Full:
                        continue
                return False

            def produce():
                try:
                    for x in self._gen_factory():
                        if not put_or_cancel(x):
                            return
                    put_or_cancel(end)
                except BaseException as e:  # handed to the consumer
                    put_or_cancel(e)

            threading.Thread(target=produce, daemon=True).start()
            stats = self._stats
            try:
                while True:
                    # a consumer blocked here is starved: the device
                    # outran the host's input pipeline
                    t0 = time.perf_counter()
                    item = q.get()
                    if stats is not None:
                        stats.add(
                            "consumer_starved_s", time.perf_counter() - t0
                        )
                    if item is end:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                cancel.set()

        return Dataset(gen, stats=self._stats)

    def device_prefetch(self, device, buffer_size=2):
        """Elements as tensors on ``device``, copied ``buffer_size`` ahead
        of their use (call it last in the pipeline). On CUDA each numpy
        leaf is staged in pinned host memory and copied without blocking
        on a side stream, so the copy of batch N+1 overlaps the compute on
        batch N; the consumer's stream waits on the copy's event before
        it sees the batch, and ``record_stream`` keeps the allocator from
        reusing the batch's memory while that stream may still read it.
        On the CPU (named by the caller) it is a plain conversion."""
        device = resolve_device(device)
        stats = self._stats

        def gen():
            if device.type != "cuda":
                for x in self._gen_factory():
                    yield tree_map(_host_tensor, x)
                return
            side = torch.cuda.Stream(device=device)
            buf = collections.deque()

            def put(x):
                t0 = time.perf_counter()
                pinned = tree_map(
                    lambda leaf: _host_tensor(leaf).pin_memory(), x
                )
                with torch.cuda.stream(side):
                    on_card = tree_map(
                        lambda t: t.to(device, non_blocking=True), pinned
                    )
                    done = torch.cuda.Event()
                    done.record(side)
                if stats is not None:
                    stats.add("h2d_s", time.perf_counter() - t0)
                return on_card, done

            def take(item):
                on_card, done = item
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                tree_map(lambda t: t.record_stream(consumer), on_card)
                return on_card

            for x in self._gen_factory():
                buf.append(put(x))
                if len(buf) > max(1, buffer_size):
                    yield take(buf.popleft())
            while buf:
                yield take(buf.popleft())

        return Dataset(gen, stats=stats)

    def __iter__(self):
        return iter(self._gen_factory())

    def as_numpy_iterator(self):
        return iter(self)


def tree_map(fn, tree):
    """``fn`` over the leaves of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(leaf):
    """A numpy leaf as an owned CPU tensor (a tensor passes through)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def create_dataset_from_tasks(tasks, data_reader):
    """Dataset over the records of a fixed task list (the reader's
    ``read_records(task)`` yields each task's records)."""

    def gen():
        for task in tasks:
            yield from data_reader.read_records(task)

    return Dataset.from_generator(gen)
