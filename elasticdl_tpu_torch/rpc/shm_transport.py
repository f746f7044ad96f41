"""The shared-memory wire between co-located peers, the port of
``elasticdl_tpu/rpc/shm_transport.py``: the same protocol, slot layout
and ``edlw-`` segment names, so a ring written by either package decodes
in the other.

On one host the socket (or gRPC) path still packs every payload into a
request, copies it through the kernel and reassembles it on the far
side. Here the PAYLOAD moves into a client-owned ring of
``multiprocessing.shared_memory`` slots, negotiated at the first call
through a ``transport_hello`` RPC; the RPC itself then carries only
``{segment name, slot, generation, length}``, about 100 bytes whatever
the tensors' sizes. The packer (``rpc/core.plan_message`` /
``pack_message_into``) writes the frames straight into the slot, one
copy per payload and direction (for a tensor on the card, the one
device-to-host copy), and the receiver decodes read-only views in place.

Protocol:

- ``transport_hello``: the client creates a ring (one per channel) and
  sends ``{name, n_slots, slot_size, host}``; the server attaches only
  when the host fingerprint (hostname and kernel boot id) is its own and
  the attach succeeds. Anything else answers ``accepted=False`` and the
  channel keeps the bytes path for good. The ring carries requests AND
  replies: the server overwrites the request slot with its reply (the
  slot stays the client's for the whole round trip).
- Each slot starts with a 16-byte header ``(u64 generation, u64
  length)``. The client stamps a fresh generation per call; the server
  checks it before dispatch and stamps ``generation | RESP_BIT`` on the
  reply, so a resent control RPC can never decode a reply as a request
  (it reads a mismatch and answers ``_shm_error`` WITHOUT dispatching;
  the client then resends inline, which is safe because nothing ran).
- Fallbacks are per call and lose nothing: a payload too big for a slot
  or an empty pool goes inline; ``_shm_error`` (a restarted server that
  does not know the ring) disables the channel and resends inline; a
  transport error mid-call QUARANTINES the slot, never used again, since
  the server may still write its late reply there.
- Lifetime: the creator unlinks on ``close()`` and at interpreter exit
  (atexit); the server's registry unlinks every ring it attached on
  ``close()``, which reclaims the segments of clients SIGKILLed mid-call
  (``/dev/shm`` keeps a name until someone unlinks it).

A slot reply decodes with a ``common/tensor.WireArena`` whose
``release()`` recycles the slot: consumers (``worker/ps_client.py``,
``master/rpc_service.py``) materialize what they keep, then release.
The caller's telemetry span context rides in the slot's payload as the
``_sctx`` field, as in the reference: the inline fallbacks reuse the
same fields, and the control message carries none.
"""

import atexit
import socket
import struct
import threading

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tensor import WireArena

_NAME_PREFIX = "edlw-"
_SLOT_HDR = 16  # u64 generation | u64 payload length
_RESP_BIT = 1 << 62  # stamped into the generation of a reply header
_MAX_SLOTS = 64
_MAX_SLOT_BYTES = 256 << 20
_MAX_RING_BYTES = 1 << 30


def host_fingerprint():
    """This kernel's and host's identity: equal fingerprints mean the
    peers can plausibly see one ``/dev/shm`` (a different mount
    namespace still fails the attach, which the hello treats alike)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return "%s|%s" % (socket.gethostname(), boot)


class ShmRing:
    """A fixed-geometry ring of payload slots in one shared segment.

    Created (and owned) by the CLIENT; the server attaches by name. All
    slot bookkeeping beyond the in-segment headers lives on the client,
    so the segment needs no cross-process synchronization: a slot is the
    client's except between sending the control RPC and its reply, when
    it is the server's."""

    def __init__(self, n_slots, slot_size, name=None):
        from multiprocessing import shared_memory

        self.n_slots = int(n_slots)
        self.slot_size = int(slot_size)
        self._stride = _SLOT_HDR + self.slot_size
        size = self._stride * self.n_slots
        self.created = name is None
        if self.created:
            import uuid

            for _attempt in range(8):
                candidate = _NAME_PREFIX + uuid.uuid4().hex[:16]
                try:
                    self._shm = shared_memory.SharedMemory(
                        name=candidate, create=True, size=size
                    )
                    break
                except FileExistsError:
                    continue
            else:
                raise OSError("could not allocate a unique shm ring name")
        else:
            if not name.startswith(_NAME_PREFIX):
                raise ValueError("not an elasticdl wire segment: %r" % name)
            self._shm = shared_memory.SharedMemory(name=name)
            if self._shm.size < size:
                self._shm.close()
                raise ValueError("segment smaller than advertised ring")
            # Python < 3.13 registers an ATTACHED segment with the
            # resource tracker too, which would unlink the creator's live
            # segment when this (server) process exits: the creator owns
            # the name (_dispose re-balances the ledger before an unlink)
            self._tracker_call("unregister")
        self.name = self._shm.name
        self._destroyed = False

    def _tracker_call(self, op):
        from multiprocessing import resource_tracker

        try:
            getattr(resource_tracker, op)(self._shm._name, "shared_memory")
            return True
        except (AttributeError, KeyError, ValueError, OSError) as err:
            logger.debug("shm resource-tracker %s skipped: %s", op, err)
            return False

    def payload_view(self, slot):
        """Writable memoryview of one slot's payload area."""
        base = slot * self._stride + _SLOT_HDR
        return self._shm.buf[base : base + self.slot_size]

    def write_header(self, slot, generation, length):
        struct.pack_into(
            "<QQ", self._shm.buf, slot * self._stride, generation, length
        )

    def read_header(self, slot):
        return struct.unpack_from("<QQ", self._shm.buf, slot * self._stride)

    def _dispose(self, unlink):
        if self._destroyed:
            return
        self._destroyed = True
        if unlink:
            # balance the tracker's ledger BEFORE the unlink: the attach's
            # unregister (and a same-process create and attach, as in the
            # tests, where the set-backed ledger holds one entry for both)
            # can leave the name untracked, and unlink()'s own unregister
            # would then fail the tracker's exit sweep. register is a
            # set-add, leaving exactly one entry for unlink to consume.
            self._tracker_call("register")
            try:
                self._shm.unlink()
            except FileNotFoundError:
                # the peer unlinked first: drop our dangling entry
                self._tracker_call("unregister")
        try:
            self._shm.close()
        except BufferError:
            # views of the segment are still alive somewhere; the mapping
            # dies with the process, and the name is gone already
            logger.debug(
                "shm ring %s close deferred: exported views still live",
                self.name,
            )

    def destroy(self):
        """Close this mapping; unlink the name if this process created
        it. The unlink removes only the NAME: the memory lives until the
        last mapping goes, so views still held stay valid."""
        self._dispose(unlink=self.created)

    def reclaim(self):
        """The server's reclamation of a (possibly dead) client's ring:
        unlink the name whoever created it, then close."""
        self._dispose(unlink=True)


class ShmChannel:
    """The client's channel: an RPC client (the socket ``Client``, the
    gRPC ``rpc.core.Client`` or the master's failover channel) plus the
    negotiated shared-memory payload path, falling back to the client's
    own path per call.

    Thread-safe for the fan-out pool and the hybrid pull thread: slot
    accounting rides one lock, and the RPCs always run outside it. The
    control RPC for ``method`` may be resent exactly when ``method`` may
    (never ``push_gradient``), and every ``_shm_error`` reply is answered
    BEFORE dispatch, so the inline resend it triggers never applies
    twice."""

    def __init__(self, client, n_slots=4, slot_mb=8):
        self._client = client
        self._n_slots = max(1, int(n_slots))
        self._slot_size = max(1, int(slot_mb)) << 20
        self._mu = threading.Lock()
        self._state = "new"  # new | negotiating | on | off
        self._ring = None
        self._free = list(range(self._n_slots))
        self._gen = 0
        # calls between _acquire and _leave: a concurrent _disable (a
        # peer's _shm_error, close()) must not destroy the ring under
        # them; it parks it in _retired instead
        self._users = 0
        self._retired = None
        self.stats = {"shm": 0, "inline": 0, "quarantined": 0}

    @property
    def ring_bytes(self):
        """The ring's size in ``/dev/shm`` when negotiated."""
        return self._n_slots * (_SLOT_HDR + self._slot_size)

    # -- negotiation ----------------------------------------------------

    def _ensure(self):
        """The current state, running the one-shot hello on first use:
        one thread negotiates (outside the lock), racers take the inline
        path until the state settles."""
        with self._mu:
            if self._state != "new":
                return self._state
            self._state = "negotiating"
        state, ring = "off", None
        try:
            ring = ShmRing(self._n_slots, self._slot_size)
            atexit.register(ring.destroy)  # the crash-safe unlink floor
            resp = self._client.call(
                "transport_hello",
                name=ring.name,
                n_slots=self._n_slots,
                slot_size=self._slot_size,
                host=host_fingerprint(),
            )
            if resp.get("accepted"):
                state = "on"
            else:
                logger.info(
                    "shm transport declined (%s); using the bytes path",
                    resp.get("reason", "unspecified"),
                )
        except Exception as err:  # noqa: BLE001 - any failure: bytes path
            logger.info(
                "shm transport negotiation failed (%s); using the bytes "
                "path", err,
            )
        if state != "on" and ring is not None:
            ring.destroy()
            ring = None
        with self._mu:
            self._ring = ring
            self._state = state
        return state

    # -- slot accounting ------------------------------------------------

    def _acquire(self):
        """``(ring, slot, generation)``, or None when the pool is empty
        or the channel is not on. A claim counts the caller as a user of
        the ring until its :meth:`_leave`."""
        with self._mu:
            if self._state != "on" or not self._free:
                return None
            slot = self._free.pop()
            self._gen += 1
            self._users += 1
            return self._ring, slot, self._gen

    def _leave(self):
        """The caller no longer touches ring memory (its reply views keep
        their own mapping); the last user out destroys a ring that a
        concurrent _disable retired."""
        with self._mu:
            self._users -= 1
            ring = None
            if self._users == 0 and self._retired is not None:
                ring, self._retired = self._retired, None
        if ring is not None:
            ring.destroy()

    def _release(self, slot):
        with self._mu:
            if self._state == "on" and slot not in self._free:
                self._free.append(slot)

    def _quarantine(self, slot):
        """Never reuse ``slot``: after a transport error mid-call the
        server may still write its late reply there. A channel that loses
        every slot degrades to the bytes path."""
        with self._mu:
            self.stats["quarantined"] += 1

    def _disable(self):
        """Stop offering shm on this channel. The ring is destroyed once
        no call is between _acquire and _leave: a fan-out sibling mid-call
        degrades to the bytes path instead of touching a closed
        mapping."""
        with self._mu:
            self._state = "off"
            ring, self._ring = self._ring, None
            if ring is not None and self._users:
                self._retired, ring = ring, None
        if ring is not None:
            ring.destroy()

    # -- the call path --------------------------------------------------

    def _inline(self, method, fields, plan=None):
        """The bytes path, with the resend guard in one place; a plan
        already made rides along, so a fallback never plans twice."""
        with self._mu:
            self.stats["inline"] += 1
        return self._client.call(
            method,
            _retriable=(method != "push_gradient"),
            _plan=plan,
            **fields
        )

    def call(self, method, /, **fields):
        # positional-only: a wire field may be named "method" (get_model's
        # method selector) and must land in ``fields``
        from elasticdl_tpu_torch.rpc.core import (
            inject_span_context,
            pack_message_into,
            plan_message,
            unpack_message,
        )

        # the span context rides the slot's payload (the control message
        # carries only the slot spec), so it goes in before planning;
        # the inline fallbacks reuse these fields
        inject_span_context(fields)
        if self._ensure() != "on":
            return self._inline(method, fields)
        plan = plan_message(fields)
        claim = self._acquire() if plan.total <= self._slot_size else None
        if claim is None:
            # bigger than a slot, or every slot in flight or quarantined:
            # the bytes path is always right
            return self._inline(method, fields, plan)
        ring, slot, gen = claim
        try:
            payload = ring.payload_view(slot)
            pack_message_into(plan, payload)
            ring.write_header(slot, gen, plan.total)
            try:
                ctrl = self._client.call(
                    method,
                    _retriable=(method != "push_gradient"),
                    _shm_req={
                        "name": ring.name,
                        "slot": slot,
                        "gen": gen,
                        "len": plan.total,
                    },
                )
            except BaseException:
                self._quarantine(slot)
                raise
            if "_shm_error" in ctrl:
                # answered BEFORE dispatch (an unknown ring or a stale
                # generation, e.g. a relaunched server): resend inline,
                # and stop offering shm on this channel
                logger.warning(
                    "shm transport rejected by the server (%s); falling "
                    "back to the bytes path", ctrl["_shm_error"],
                )
                self._release(slot)
                self._disable()
                return self._inline(method, fields, plan)
            spec = ctrl.get("_shm_resp")
            if spec is None:
                # the reply did not fit a slot and came inline
                self._release(slot)
                with self._mu:
                    self.stats["shm"] += 1
                return ctrl
            hgen, hlen = ring.read_header(slot)
            if spec.get("gen") != gen or hgen != (gen | _RESP_BIT) or (
                hlen != spec.get("len")
            ):
                self._quarantine(slot)
                self._disable()
                raise RuntimeError(
                    "shm reply generation mismatch on %s slot %d "
                    "(protocol desync; channel disabled)" % (ring.name, slot)
                )
            view = payload[: spec["len"]].toreadonly()
            arena = WireArena(view, on_release=lambda: self._release(slot))
            with self._mu:
                self.stats["shm"] += 1
            return unpack_message(view, arena=arena)
        finally:
            # reply views hold their own mapping: this only ends the
            # window in which ring headers and slots may be touched
            self._leave()

    def close(self):
        self._disable()

    @property
    def state(self):
        with self._mu:
            return self._state


# ---------------------------------------------------------------------------
# the server side
# ---------------------------------------------------------------------------


class ShmEndpointRegistry:
    """The server's table of client rings attached through
    ``transport_hello``. ``close()`` reclaims EVERY attached ring (unlink
    and close): the path that frees the segments of clients SIGKILLed
    mid-call, whose atexit never ran."""

    def __init__(self, writable_request_views=False):
        self._mu = threading.Lock()
        self._rings = {}
        self._fingerprint = host_fingerprint()
        # a --ps_device shard opts in: request payloads decode as
        # WRITABLE slot views, which enter the device without a host copy
        # (common/tensor.device_from_host_view). Safe under the slot
        # contract (the handler consumes the request before the reply
        # overwrites the slot), but it forfeits the codec's read-only
        # guard, so it is never the default.
        self._writable_request_views = bool(writable_request_views)

    def hello(self, req):
        name = req.get("name", "")
        n_slots = int(req.get("n_slots", 0))
        slot_size = int(req.get("slot_size", 0))
        if req.get("host") != self._fingerprint:
            return {"accepted": False, "reason": "cross-host"}
        if not isinstance(name, str) or not name.lstrip("/").startswith(
            _NAME_PREFIX
        ):
            return {"accepted": False, "reason": "bad segment name"}
        if not (
            0 < n_slots <= _MAX_SLOTS
            and 0 < slot_size <= _MAX_SLOT_BYTES
            and n_slots * slot_size <= _MAX_RING_BYTES
        ):
            return {"accepted": False, "reason": "ring geometry out of bounds"}
        try:
            ring = ShmRing(n_slots, slot_size, name=name)
        except (OSError, ValueError) as err:
            return {"accepted": False, "reason": "attach failed: %s" % err}
        with self._mu:
            old = self._rings.pop(name, None)
            self._rings[name] = ring
        if old is not None:
            old.reclaim()  # the same client negotiated again
        return {"accepted": True}

    def _resolve(self, name):
        with self._mu:
            return self._rings.get(name)

    @property
    def attached(self):
        """The names of the rings attached now."""
        with self._mu:
            return sorted(self._rings)

    def wrap(self, fn):
        """Route ``_shm_req`` control messages through the slot; plain
        requests go straight to ``fn``. Every ``_shm_error`` is returned
        BEFORE ``fn`` runs (the client's inline resend relies on it)."""
        from elasticdl_tpu_torch.rpc.core import (
            pack_message_into,
            plan_message,
            unpack_message,
        )

        def handler(req):
            spec = req.get("_shm_req") if isinstance(req, dict) else None
            if spec is None:
                return fn(req)
            ring = self._resolve(spec.get("name", ""))
            if ring is None:
                return {"_shm_error": "unknown ring"}
            slot, gen = int(spec.get("slot", -1)), int(spec.get("gen", -1))
            length = int(spec.get("len", -1))
            if not 0 <= slot < ring.n_slots:
                return {"_shm_error": "slot out of range"}
            hgen, hlen = ring.read_header(slot)
            if hgen != gen or hlen != length or not (
                0 <= length <= ring.slot_size
            ):
                return {"_shm_error": "stale generation"}
            payload = ring.payload_view(slot)
            if self._writable_request_views:
                request = unpack_message(payload[:length], writable=True)
            else:
                request = unpack_message(payload[:length].toreadonly())
            reply = fn(request) or {}
            # the handler is done with the request (the retention sites
            # copy what they keep), so the slot carries the reply back
            del request
            plan = plan_message(reply)
            if plan.total > ring.slot_size:
                return reply  # an oversized reply goes inline
            pack_message_into(plan, payload)
            ring.write_header(slot, gen | _RESP_BIT, plan.total)
            return {
                "_shm_resp": {"slot": slot, "gen": gen, "len": plan.total}
            }

        return handler

    def close(self):
        with self._mu:
            rings, self._rings = list(self._rings.values()), {}
        for ring in rings:
            ring.reclaim()


def install_shm_endpoint(
    methods, hello_extra=None, writable_request_views=False
):
    """Wrap a ``{name: fn}`` RPC table with the shared-memory endpoint.

    Returns ``(methods, registry)``: ``methods`` also serves
    ``transport_hello``; ``registry.close()`` at the server's stop
    reclaims every attached ring, orphans included. ``hello_extra``:
    fields merged into every hello reply (a PS shard's ``shard_epoch``,
    so a reconnecting client learns the incarnation at negotiation).
    ``writable_request_views``: ``--ps_device`` shards only (see
    :class:`ShmEndpointRegistry`)."""
    registry = ShmEndpointRegistry(
        writable_request_views=writable_request_views
    )
    wrapped = {name: registry.wrap(fn) for name, fn in methods.items()}
    if hello_extra:
        extra = dict(hello_extra)

        def hello(req):
            resp = dict(registry.hello(req) or {})
            resp.update(extra)
            return resp

        wrapped["transport_hello"] = hello
    else:
        wrapped["transport_hello"] = registry.hello
    return wrapped, registry
