"""The worker's client of the PS fleet, the port of
``elasticdl_tpu/worker/ps_client.py``.

A dense parameter lives on shard ``string_to_id(name, n)``, an embedding
row on shard ``id % n`` (``common/hash_utils.py``, the reference's
placement). Each logical call fans its per-shard legs out over a small
thread pool, so n shards cost one round trip; the legs' results merge in
ascending shard order, and on a failure the lowest failing shard's error
is raised only after every leg has finished. ``push_inflight`` > 0 makes
``push_gradient`` return at once behind a window of that many pushes in
flight, which ``pull_dense`` and :meth:`drain` settle (the worker drains
it at every task boundary). Sparse gradients are combined to one row per
unique id before the wire.

**The reconnect protocol.** Every shard reply carries the shard's
``shard_epoch``. A higher epoch than the last seen is a relaunched
shard: the client abandons the in-flight push window (those pushes
raced the dead incarnation: their outcome is dropped, never resent),
and, where the shard reports it is
uninitialized (it came back with no snapshot), runs the worker's
``on_shard_reset`` callback before the next data-plane call, which
re-pushes the model and the table infos (first write wins, so live
shards ignore it). A failed leg makes the client probe the failing
shards' ``ps_status`` (at most once a second per shard), so a relaunch
is seen before the worker's retry runs.

:class:`BoundPS` adapts the port's socket ``Client`` (``deadline_s``,
``retries`` of ``UNAVAILABLE``; ``push_gradient`` is never resent) to
the dict-method interface, and raises :class:`PSRpcError`, a
``RuntimeError``, so the worker's minibatch machinery fails the task
rather than the process. The wire is the port's sockets, not the
reference's gRPC: the packages' workers and shards do not dial each
other.

**The hot-row cache.** ``hot_row_cache_rows`` > 0 (or a ``cache=`` the
caller owns) puts a ``nn/comm_plane.HotRowCache`` in front of the rows'
fan-out: each distinct id is probed once, only the misses cross the
wire (a shard all of whose ids hit is skipped), and the pulled rows go
in tagged with the reply's version. Pull and push replies note each
shard's newest version, which ages the entries; an entry more than
``staleness_window`` versions behind is a miss. A relaunched shard's
entries are dropped in the reconnect protocol, its clock set to the
restored version.

**The scorer's reads.** ``serving_status`` and ``pull_embedding_delta``
(the delta sync's poll, ``serving/delta_sync.py``) run their replies
through the reconnect protocol too, so a poll alone sees a relaunched
shard and drops its cache entries.

**The shared-memory wire.** ``BoundPS(shm="auto")`` (or ``"on"``, the
same) negotiates a ring of shared-memory slots with a shard on the same
host at its first call (``rpc/shm_transport.py``); payloads then travel
in the slots and the socket carries ~100 bytes a call. Cross-host, or on
any failure to attach, it keeps the socket path. A slot reply's views
turn to garbage once its message is released, so every call site here
copies what it keeps (the rows into the caller's output and the cache,
the dense pull, the delta's ids) and then releases the reply.
"""

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from elasticdl_tpu_torch.common.hash_utils import (
    scatter_embedding_vector,
    string_to_id,
)
from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    combine_indexed_slices,
    release_message,
)
from elasticdl_tpu_torch.nn.comm_plane import HotRowCache
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.rpc.wire_compression import (
    compress_tensors,
    decompress_tensors,
)


def _infos_wire(embedding_infos):
    return [
        {"name": i.name, "dim": i.dim, "initializer": i.initializer}
        for i in embedding_infos or ()
    ]


class PSClient:
    def __init__(
        self,
        ps_stubs,
        wire_dtype="",
        hot_row_cache_rows=0,
        staleness_window=1,
        fanout=True,
        push_inflight=0,
        cache=None,
        on_shard_reset=None,
    ):
        """``ps_stubs``: one object per shard with the PS dict methods
        (``BoundPS``, or an in-process ``PserverServicer``)."""
        self._cache = cache if cache is not None else (
            HotRowCache(hot_row_cache_rows, staleness_window)
            if hot_row_cache_rows > 0
            else None
        )
        self._ps = list(ps_stubs)
        self._wire_dtype = wire_dtype
        self._fanout_enabled = bool(fanout)
        self._fanout_pool = None
        self._push_inflight = max(0, int(push_inflight))
        self._push_pool = None
        self._pool_lock = threading.Lock()
        self._closed = False
        self._pending_pushes = deque()
        self._reaped_accepted = True
        self._last_push_version = -1
        # the reconnect protocol's state; replies are noted on the
        # worker, fan-out and push threads alike
        self._epoch_mu = threading.Lock()
        self._shard_epochs = {}  # shard -> last seen shard_epoch
        self._reset_gen = 0  # +1 at every relaunch seen
        self._last_probe_t = {}  # shard -> last ps_status probe
        self._needs_reinit = set()
        self._on_shard_reset = on_shard_reset
        # (shard, old epoch, new epoch, restored version, wall time) of
        # each relaunch seen
        self.relaunches = []

    @property
    def num_ps(self):
        return len(self._ps)

    @property
    def stubs(self):
        """The per-shard stubs, in shard order (their owner closes
        them)."""
        return list(self._ps)

    @property
    def hot_row_cache(self):
        """The ``HotRowCache`` (None without one): its counters."""
        return self._cache

    @property
    def shard_epochs(self):
        with self._epoch_mu:
            return dict(self._shard_epochs)

    def set_on_shard_reset(self, callback):
        """``callback(shards)`` runs before the next data-plane call
        after a relaunched shard reported no model."""
        self._on_shard_reset = callback

    # -- the reconnect protocol -------------------------------------------

    def _note_shard_reply(self, shard, resp):
        if not isinstance(resp, dict):
            return
        epoch = resp.get("shard_epoch")
        if epoch is None:
            return
        version = resp.get("version")
        with self._epoch_mu:
            prev = self._shard_epochs.get(shard)
            if prev is not None and epoch < prev:
                # a late reply of the dead incarnation
                return
            self._shard_epochs[shard] = epoch
            changed = prev is not None and epoch > prev
            if changed:
                self._reset_gen += 1
                if (
                    resp.get("initialized") is False
                    or resp.get("model_init_status") is False
                ):
                    self._needs_reinit.add(shard)
                self.relaunches.append(
                    (shard, prev, epoch, version, time.time())
                )
        if changed:
            dropped = 0
            if self._cache is not None:
                dropped = self._cache.invalidate_shard(shard, version=version)
            profiling.events.emit(
                "ps_shard_restore",
                shard=shard,
                old_epoch=prev,
                new_epoch=epoch,
                version=version,
                cache_rows_invalidated=dropped,
            )
            logger.warning(
                "PS shard %s relaunched (epoch %s -> %s) at version %s; "
                "the in-flight push window is abandoned",
                shard, prev, epoch, version,
            )

    def _note_shard_failures(self, shards):
        """Probe the failing shards' ``ps_status`` (at most once a
        second each): a shard already back as a new incarnation is seen
        here, before the worker's retry."""
        now = time.monotonic()
        with self._epoch_mu:
            shards = {
                s for s in shards
                if now - self._last_probe_t.get(s, -10.0) >= 1.0
            }
            for s in shards:
                self._last_probe_t[s] = now
        for shard in sorted(shards):
            try:
                status = self._ps[shard].ps_status({})
            except Exception:  # noqa: BLE001 - still down
                logger.debug("ps_status probe of shard %s failed", shard,
                             exc_info=True)
                continue
            self._note_shard_reply(shard, status)
            release_message(status)

    def _gen_snapshot(self):
        with self._epoch_mu:
            return self._reset_gen

    def _service_reinit(self):
        """Run the re-push callback for shards that came back empty; a
        failed re-push keeps the flag for the next call."""
        with self._epoch_mu:
            if not self._needs_reinit:
                return
            shards = sorted(self._needs_reinit)
            self._needs_reinit.clear()
        if self._on_shard_reset is None:
            return
        try:
            self._on_shard_reset(shards)
        except Exception:
            with self._epoch_mu:
                self._needs_reinit.update(shards)
            raise

    # -- the scorer's reads --------------------------------------------------

    def serving_status(self, shard):
        """Shard ``shard``'s ``{version, shard_epoch, initialized,
        tables, floors}`` (``ps/servicer.serving_status``). A new
        ``shard_epoch`` in the reply runs the reconnect protocol here, so
        a scorer's poll sees a relaunch without a failed pull."""
        resp = self._ps[shard].serving_status({})
        self._note_shard_reply(shard, resp)
        try:
            return {
                "version": int(resp.get("version", -1)),
                "shard_epoch": resp.get("shard_epoch"),
                "initialized": bool(resp.get("initialized", False)),
                "tables": dict(resp.get("tables") or {}),
                "floors": dict(resp.get("floors") or {}),
            }
        finally:
            release_message(resp)

    def pull_embedding_delta(self, shard, name, since_version):
        """The ids of ``name`` shard ``shard`` wrote after
        ``since_version``: ``(ids int64, covered version, complete)``.
        A read, so the socket channel may resend it."""
        resp = self._ps[shard].pull_embedding_delta(
            {"name": name, "since_version": int(since_version)}
        )
        self._note_shard_reply(shard, resp)
        try:
            # a copy: the decoded ids are a view of the reply's buffer
            return (
                np.array(resp["ids"], dtype=np.int64, copy=True).reshape(-1),
                int(resp.get("version", since_version)),
                bool(resp.get("complete", False)),
            )
        finally:
            release_message(resp)

    # -- the fan-out ----------------------------------------------------------

    def _ps_of_var(self, name):
        return self._ps[string_to_id(name, self.num_ps)]

    def _get_fanout_pool(self):
        with self._pool_lock:
            if self._closed:
                raise RuntimeError("PSClient is closed")
            if self._fanout_pool is None:
                self._fanout_pool = ThreadPoolExecutor(
                    max_workers=min(16, max(self.num_ps, 8)),
                    thread_name_prefix="edl-ps-fanout",
                )
            return self._fanout_pool

    def _run_sharded(self, calls):
        """``[(key, thunk)]`` -> ``{key: result}``; ``key`` is a shard or
        ``(table, shard)``. Every leg finishes before the lowest failing
        key's error is raised."""
        if not calls:
            return {}

        def shard_of(key):
            return key[1] if isinstance(key, tuple) else key

        if not self._fanout_enabled or len(calls) == 1:
            try:
                return {key: thunk() for key, thunk in calls}
            except Exception:
                self._note_shard_failures({shard_of(k) for k, _ in calls})
                raise
        pool = self._get_fanout_pool()
        futs = [(key, pool.submit(thunk)) for key, thunk in calls]
        results, errors = {}, []
        for key, fut in futs:
            try:
                results[key] = fut.result()
            except Exception as err:  # noqa: BLE001 - raised below
                errors.append((key, err))
        if errors:
            # the legs that answered go unread: release their replies, or
            # the raised error's traceback (which keeps this frame) would
            # pin their shared-memory slots
            for result in results.values():
                release_message(result)
            errors.sort(key=lambda pair: pair[0])
            self._note_shard_failures({shard_of(k) for k, _ in errors})
            raise errors[0][1]
        return results

    def close(self):
        """Drain the push window (its failure logged, not raised: this
        runs on teardown) and stop the pools."""
        try:
            self.drain()
        except Exception as err:  # noqa: BLE001 - teardown
            logger.warning("push window failed to drain at close: %s", err)
        finally:
            with self._pool_lock:
                self._closed = True
                pools = (self._push_pool, self._fanout_pool)
                self._push_pool = self._fanout_pool = None
            for pool in pools:
                if pool is not None:
                    pool.shutdown(wait=True)

    # -- the model --------------------------------------------------------------

    def push_model(self, named_params, embedding_infos=None, version=0):
        """Each shard gets its dense partition and every table info."""
        parts = [{} for _ in range(self.num_ps)]
        for name, arr in named_params.items():
            parts[string_to_id(name, self.num_ps)][name] = arr
        infos = _infos_wire(embedding_infos)
        calls = [
            (shard, lambda ps=ps, req={
                "version": version,
                "params": [Tensor(n, v) for n, v in part.items()],
                "embedding_infos": infos,
            }: ps.push_model(req))
            for shard, (ps, part) in enumerate(zip(self._ps, parts))
        ]
        for shard, resp in self._run_sharded(calls).items():
            self._note_shard_reply(shard, resp)
            release_message(resp)

    def push_embedding_info(self, embedding_infos):
        infos = _infos_wire(embedding_infos)
        resps = self._run_sharded([
            (shard, lambda ps=ps: ps.push_embedding_info(
                {"embedding_infos": infos}))
            for shard, ps in enumerate(self._ps)
        ])
        for shard, resp in resps.items():
            self._note_shard_reply(shard, resp)
            release_message(resp)

    def pull_dense(self):
        """``(all initialized, min version, {name: ndarray})`` over every
        shard; drains the push window first."""
        self._service_reinit()
        self.drain()
        resps = self._run_sharded([
            (shard, lambda ps=ps: ps.pull_variable({}))
            for shard, ps in enumerate(self._ps)
        ])
        named, versions, ready = {}, [], True
        try:
            for shard in range(self.num_ps):
                resp = resps[shard]
                self._note_shard_reply(shard, resp)
                if not resp.get("model_init_status"):
                    ready = False
                    continue
                versions.append(resp["version"])
                if self._cache is not None:
                    self._cache.note_version(shard, resp["version"])
                for t in decompress_tensors(
                    resp.get("params", []), resp.get("compressed_f32")
                ):
                    # kept across steps: owned copies, made before the
                    # reply is released (an in-process shard's own
                    # arrays are copied too)
                    named[t.name] = np.array(t.values, dtype=np.float32)
        finally:
            for resp in resps.values():
                release_message(resp)
        if not ready:
            return False, -1, {}
        return True, min(versions), named

    # -- gradients --------------------------------------------------------------

    def push_gradient(self, dense_named, sparse_tensors, version):
        """Dense gradients to their shards by name, sparse rows by id.
        ``(accepted, version)``: accepted only where every shard
        accepted, the least shard version. With a push window, the call
        returns ``(True, last reconciled version)`` at once; the true
        outcome comes at the next ``pull_dense`` / :meth:`drain`."""
        reqs = [[] for _ in range(self.num_ps)]
        for name, arr in (dense_named or {}).items():
            reqs[string_to_id(name, self.num_ps)].append(Tensor(name, arr))
        for t in sparse_tensors or ():
            ids, values = combine_indexed_slices(t.indices, t.values)
            for shard, (vals, shard_ids) in scatter_embedding_vector(
                values, ids, self.num_ps
            ).items():
                reqs[shard].append(Tensor(t.name, vals, indices=shard_ids))
        self._service_reinit()
        if self._push_inflight <= 0:
            return self._push_shards(reqs, version)
        while len(self._pending_pushes) >= self._push_inflight:
            self._reap_push(self._pending_pushes.popleft())
        with self._pool_lock:
            if self._closed:
                raise RuntimeError("PSClient is closed")
            if self._push_pool is None:
                # its own threads: a push waits on fan-out legs, which
                # must not queue behind it
                self._push_pool = ThreadPoolExecutor(
                    max_workers=self._push_inflight,
                    thread_name_prefix="edl-ps-push",
                )
            pool = self._push_pool
        self._pending_pushes.append(
            (pool.submit(self._push_shards, reqs, version),
             self._gen_snapshot())
        )
        return True, self._last_push_version

    def _push_shards(self, reqs, version):
        def push_one(shard):
            tensors, compressed = compress_tensors(
                reqs[shard], self._wire_dtype
            )
            return self._ps[shard].push_gradient({
                "model_version": version,
                "gradients": tensors,
                "compressed_f32": compressed,
            })

        resps = self._run_sharded([
            (shard, lambda shard=shard: push_one(shard))
            for shard in range(self.num_ps)
        ])
        accepted, out_version = True, None
        for shard in range(self.num_ps):
            resp = resps[shard]
            self._note_shard_reply(shard, resp)
            accepted = accepted and bool(resp["accepted"])
            out_version = (
                resp["version"] if out_version is None
                else min(out_version, resp["version"])
            )
            if self._cache is not None:
                # the apply this push made ages the cached rows it wrote
                self._cache.note_version(shard, resp["version"])
            release_message(resp)  # a scalar reply: its slot recycles
        return accepted, (-1 if out_version is None else out_version)

    def _reap_push(self, entry):
        fut, gen = entry
        try:
            accepted, version = fut.result()
        except Exception as err:  # noqa: BLE001 - raised unless abandoned
            if self._gen_snapshot() != gen:
                profiling.events.emit(
                    "ps_push_window_dropped", reason=str(err)[:200]
                )
                logger.warning(
                    "an in-flight gradient push was abandoned across a PS "
                    "shard relaunch (dropped, not resent): %s", err,
                )
                return True, -1
            raise
        if self._gen_snapshot() != gen:
            return True, -1
        self._reaped_accepted = self._reaped_accepted and accepted
        if version >= 0:
            self._last_push_version = max(self._last_push_version, version)
        return accepted, version

    def drain(self):
        """Settle every push in flight; ``(accepted, version)`` over the
        pushes reaped since the last drain. A shard's failure is raised
        here, unless its push was abandoned across a relaunch."""
        while self._pending_pushes:
            self._reap_push(self._pending_pushes.popleft())
        accepted = self._reaped_accepted
        self._reaped_accepted = True
        return accepted, self._last_push_version

    # -- embeddings -------------------------------------------------------------

    def pull_embedding_vectors(self, name, ids):
        return self.pull_embedding_vectors_multi({name: ids})[name]

    def pull_embedding_vectors_multi(self, ids_by_name, service_reinit=True):
        """``{table: ids} -> {table: rows}`` in one fan-out round over
        every (table, shard) leg, rows in the ids' order; the cache's
        hits stay off the wire. ``service_reinit=False`` leaves a pending
        re-push to the next call that services it (a caller off the
        worker's thread)."""
        if service_reinit:
            self._service_reinit()
        state, calls = {}, []
        for name, ids in ids_by_name.items():
            ids = np.asarray(ids, dtype=np.int64)
            st = {"ids": ids, "out": None, "positions": {}}
            state[name] = st
            if ids.size == 0:
                st["out"] = np.zeros((0, 0), np.float32)
                continue
            shard_ids = ids % self.num_ps
            hit = np.zeros(ids.shape, dtype=bool)
            if self._cache is not None:
                uniq, inverse = np.unique(ids, return_inverse=True)
                inverse = inverse.reshape(-1)
                uniq_rows = self._cache.get_rows(name, uniq)
                uniq_hit = np.fromiter(
                    (r is not None for r in uniq_rows), dtype=bool,
                    count=len(uniq_rows),
                )
                hit = uniq_hit[inverse]
                if uniq_hit.any():
                    hit_rows = np.stack(
                        [r for r in uniq_rows if r is not None]
                    )
                    st["out"] = np.empty(
                        (len(ids), hit_rows.shape[1]), np.float32
                    )
                    # each hitting unique id's row in hit_rows
                    to_hit = np.cumsum(uniq_hit) - 1
                    st["out"][hit] = hit_rows[to_hit[inverse[hit]]]
            for shard in np.unique(shard_ids[~hit]):
                shard = int(shard)
                positions = np.nonzero((shard_ids == shard) & ~hit)[0]
                st["positions"][shard] = positions
                req = {"name": name, "ids": ids[positions]}
                calls.append((
                    (name, shard),
                    lambda shard=shard, req=req: self._ps[
                        shard].pull_embedding_vector(req),
                ))
        resps = self._run_sharded(calls)
        try:
            for name, shard in sorted(resps):
                resp = resps[(name, shard)]
                self._note_shard_reply(shard, resp)
                st = state[name]
                positions = st["positions"][shard]
                got = np.asarray(resp["rows"], dtype=np.float32)
                if got.shape[0] != len(positions):
                    raise ValueError(
                        "PS shard %d returned %d rows for %d ids of %r"
                        % (shard, got.shape[0], len(positions), name)
                    )
                if st["out"] is None:
                    st["out"] = np.empty((len(st["ids"]), got.shape[1]),
                                         np.float32)
                # the scatter into the caller's output and the cache's
                # own row copies are this path's one decode copy: the
                # view ``got`` never outlives its message
                st["out"][positions] = got
                if self._cache is not None:
                    version = resp.get("version")
                    self._cache.note_version(shard, version)
                    self._cache.put_rows(
                        name, st["ids"][positions], shard, version, got
                    )
        finally:
            for resp in resps.values():
                release_message(resp)
        return {name: st["out"] for name, st in state.items()}


class PSRpcError(RuntimeError):
    """A PS data-plane call failed for good (an expired deadline, a dead
    shard past its retries). A RuntimeError, so the worker fails the
    task and lives. ``code`` is the transport's code."""

    def __init__(self, addr, method, cause):
        super().__init__("PS %s %s failed: %s" % (addr, method, cause))
        self.addr = addr
        self.method = method
        self.cause = cause
        self.code = getattr(cause, "code", None)


class BoundPS:
    """The PS dict-method interface over the port's socket ``Client``:
    ``deadline_s`` bounds each call, ``retries`` resends an
    ``UNAVAILABLE`` one (never ``push_gradient``, which a shard may
    have applied).

    ``shm``: ``"auto"`` (or ``"on"``) negotiates the shared-memory
    payload path with a co-located shard at the first call
    (``transport_hello``) and keeps the socket path cross-host or on any
    failure to attach; ``"off"``, the default for direct constructions,
    never negotiates. The ring is ``shm_slots`` x ``shm_slot_mb``."""

    def __init__(self, addr, deadline_s=None, retries=0, shm="off",
                 shm_slots=4, shm_slot_mb=8):
        from elasticdl_tpu_torch.rpc.socket_transport import Client

        if shm not in ("auto", "on", "off", "", None, False):
            raise ValueError("shm must be 'auto', 'on' or 'off'")
        self._addr = addr
        self._client = Client(addr, deadline_s=deadline_s, retries=retries)
        self._shm = None
        if shm in ("auto", "on"):
            from elasticdl_tpu_torch.rpc.shm_transport import ShmChannel

            self._shm = ShmChannel(
                self._client, n_slots=shm_slots, slot_mb=shm_slot_mb
            )

    @property
    def shm_channel(self):
        """The ``ShmChannel`` (None when off): its ``state`` and
        ``stats``."""
        return self._shm

    def close(self):
        """Unlink the negotiated ring, if any, and close the socket
        client; safe to call twice."""
        if self._shm is not None:
            self._shm.close()
        self._client.close()

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(req):
            from elasticdl_tpu_torch.rpc.socket_transport import RpcError

            try:
                if self._shm is not None:
                    # the channel keeps the same resend guard
                    return self._shm.call(method, **req)
                return self._client.call(
                    method, _retriable=(method != "push_gradient"), **req
                )
            except RpcError as err:
                wrapped = PSRpcError(self._addr, method, err)
                # a fleet-visible event: it rides the worker's next
                # telemetry snapshot into the master's job log, and arms
                # the flight recorder's postmortem
                profiling.events.emit(
                    "ps_shard_failure",
                    addr=self._addr,
                    method=method,
                    code=getattr(wrapped.code, "name", wrapped.code),
                )
                raise wrapped from err

        return call
