"""The port's shared-memory wire against the reference's
(``elasticdl_tpu/rpc/shm_transport.py``, ``tests/test_wire.py``).

- byte identity: the port's planner and in-place packer write exactly
  the reference packer's bytes (f32, int64 indices, strided sources, bf16
  narrowed from a marked f32 inside the copy, torch tensors, bytes);
- views and lifetime: decoded views are read-only and zero-copy,
  ``materialize`` is free for owned arrays, views outlive other
  messages' arenas, an arena's callback fires once, and the host-view
  bridge aliases a writable f32 view on the CPU;
- the protocol over the port's socket transport, case for case with the
  reference's tests;
- across the packages over gRPC: each package's ``ShmChannel`` against
  the other's endpoint;
- the job: a two-shard fleet with ``--grads_to_wait 2`` is bitwise the
  same with the wire on and off, ``get_model`` rides the master's ring
  through a master relaunch, and the scorer's ring scores as its socket.

Every test ends with none of the ``edlw-`` segments it created left in
``/dev/shm``.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.common.tensor import Tensor as JTensor
from elasticdl_tpu.rpc.core import pack_message as j_pack
from elasticdl_tpu.rpc.core import unpack_message as j_unpack
from elasticdl_tpu.rpc.wire_compression import compress_tensors as j_compress
from elasticdl_tpu_torch.common.tensor import (
    Tensor,
    WireArena,
    deserialize_tensor,
    device_from_host_view,
    device_host_view,
    is_device_array,
    release_message,
    serialize_tensor,
)
from elasticdl_tpu_torch.rpc.core import (
    pack_message,
    pack_message_into,
    plan_message,
    unpack_message,
)
from elasticdl_tpu_torch.rpc.shm_transport import (
    ShmChannel,
    ShmEndpointRegistry,
    ShmRing,
    host_fingerprint,
    install_shm_endpoint,
)
from elasticdl_tpu_torch.rpc.socket_transport import Client, serve
from elasticdl_tpu_torch.rpc.wire_compression import compress_tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_LIMIT_S = 60


def _segment_exists(name):
    return os.path.exists(os.path.join("/dev/shm", name))


@pytest.fixture(autouse=True)
def no_leaked_segments(monkeypatch):
    """Record every ring this test's process creates; none may be left
    in ``/dev/shm`` once the test is done."""
    created = []
    init = ShmRing.__init__

    def recording_init(self, n_slots, slot_size, name=None):
        init(self, n_slots, slot_size, name=name)
        if name is None:
            created.append(self.name)

    monkeypatch.setattr(ShmRing, "__init__", recording_init)
    yield created
    leaked = [n for n in created if _segment_exists(n)]
    assert not leaked, leaked


# ---------------------------------------------------------------------------
# byte identity with the reference's packer
# ---------------------------------------------------------------------------


def _rng():
    return np.random.default_rng(8)


def _cases():
    rng = _rng()
    dense = rng.standard_normal((5, 3)).astype(np.float32)
    base = rng.standard_normal((8, 6)).astype(np.float32)
    rows = rng.standard_normal((3, 4)).astype(np.float32)
    ids = np.array([7, 1, 30], dtype=np.int64)
    return dense, base, rows, ids


def _pair(kind):
    """(the reference's message, the port's) for one payload kind."""
    dense, base, rows, ids = _cases()
    if kind == "f32":
        return {"t": JTensor("w", dense)}, {"t": Tensor("w", dense)}
    if kind == "int64_indices":
        return ({"g": [JTensor("emb", rows, ids)]},
                {"g": [Tensor("emb", rows, ids)]})
    if kind == "strided":
        return ({"s": JTensor("s", base[::2, ::3]), "a": base[:, 1]},
                {"s": Tensor("s", base[::2, ::3]), "a": base[:, 1]})
    if kind == "bf16_fused":
        ref, names = j_compress(
            [JTensor("w", dense), JTensor("emb", rows, ids)], "bfloat16")
        ours, ours_names = compress_tensors(
            [Tensor("w", dense), Tensor("emb", rows, ids)], "bfloat16")
        # the mark costs no pass: the payload is still the caller's
        assert ours[0].values is dense
        return ({"g": ref, "compressed_f32": names},
                {"g": ours, "compressed_f32": ours_names})
    if kind == "bf16_fused_torch":
        ref, names = j_compress([JTensor("w", base[::2])], "bfloat16")
        ours, ours_names = compress_tensors(
            [Tensor("w", torch.from_numpy(base)[::2])], "bfloat16")
        return ({"g": ref, "compressed_f32": names},
                {"g": ours, "compressed_f32": ours_names})
    if kind == "torch_cpu":
        return ({"t": JTensor("w", dense), "a": np.arange(4, dtype=np.int64)},
                {"t": Tensor("w", torch.from_numpy(dense)),
                 "a": torch.arange(4)})
    if kind == "bytes_and_json":
        return ({"blob": b"\x00raw\xff", "version": 41, "name": "shard-0",
                 "e": np.zeros((0, 4), np.float32)},
                {"blob": b"\x00raw\xff", "version": 41, "name": "shard-0",
                 "e": np.zeros((0, 4), np.float32)})
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "f32", "int64_indices", "strided", "bf16_fused", "bf16_fused_torch",
    "torch_cpu", "bytes_and_json",
])
def test_the_packer_writes_the_references_bytes(kind):
    ref, ours = _pair(kind)
    want = bytes(j_pack(ref))
    plan = plan_message(ours)
    assert plan.total == len(want)
    # into a larger buffer at an offset, as into a slot
    buf = bytearray(plan.total + 16)
    assert pack_message_into(plan, memoryview(buf), 8) == 8 + plan.total
    assert bytes(buf[8:8 + plan.total]) == want
    assert bytes(pack_message(ours)) == want
    # each package decodes the other's bytes, and packing the decode again
    # gives the same bytes
    assert bytes(pack_message(unpack_message(want))) == want
    assert bytes(j_pack(j_unpack(bytes(pack_message(ours))))) == want


def test_the_plan_reads_only_metadata():
    """A tensor's plan reads shape and dtype alone: its payload is first
    touched by the write (which a CUDA tensor pays as its one copy)."""
    dense = np.ones((4, 4), np.float32)
    plan = plan_message({"t": Tensor("w", dense),
                         "u": Tensor("u", torch.ones(3))})
    dense[0, 0] = 7.0  # after the plan, before the write
    buf = bytearray(plan.total)
    pack_message_into(plan, buf)
    msg = unpack_message(buf)
    assert msg["t"].values[0, 0] == 7.0
    assert np.array_equal(msg["u"].values, np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# views and lifetime
# ---------------------------------------------------------------------------


def _sparse():
    rng = _rng()
    return Tensor("emb", rng.standard_normal((3, 4)).astype(np.float32),
                  indices=np.array([7, 1, 30], dtype=np.int64))


def test_decoded_views_are_readonly_and_zero_copy():
    buf = bytearray(serialize_tensor(_sparse()))
    got = deserialize_tensor(buf)
    for arr in (got.values, got.indices):
        assert not arr.flags.writeable
        with pytest.raises((ValueError, RuntimeError)):
            arr[0] = 0
    before = got.indices.copy()
    buf[-1] ^= 0xFF  # the last byte of the indices: seen through the view
    assert not np.array_equal(got.indices, before)
    buf[-1] ^= 0xFF
    assert np.array_equal(got.indices, before)


def test_materialize_is_the_escape_hatch_and_free_for_owned():
    got = deserialize_tensor(bytes(serialize_tensor(_sparse())))
    owned = got.materialize()
    assert owned is not got
    assert owned.values.flags.writeable and owned.indices.flags.writeable
    assert np.array_equal(owned.values, got.values)
    owned.values[0, 0] = 7.0
    local = _sparse()
    assert local.materialize() is local
    assert owned.materialize() is owned
    t = Tensor("t", torch.ones(2))
    assert t.materialize() is t
    # a writable decode (a --ps_device shard's slot request) is no owner
    # either: what it keeps must not change with the buffer
    buf = bytearray(serialize_tensor(_sparse()))
    view = deserialize_tensor(buf, writable=True)
    assert view.values.flags.writeable
    kept = view.materialize()
    assert kept is not view
    buf[-1] ^= 0xFF
    assert not np.array_equal(view.indices, kept.indices)
    assert np.array_equal(kept.values, view.values)
    bf16 = Tensor("b", np.arange(4, dtype=np.float32))
    bf16.wire_dtype = "bfloat16"
    frame = bytearray(serialize_tensor(bf16))
    alias = deserialize_tensor(frame, writable=True)
    owned = alias.materialize()
    frame[-1] ^= 0xFF
    assert torch.equal(owned.values, torch.arange(4, dtype=torch.bfloat16))
    assert not torch.equal(alias.values, owned.values)


def test_views_survive_arena_release_of_other_messages():
    msgs = []
    for k in range(3):
        wire = bytes(pack_message(
            {"t": Tensor("w", np.full((64,), float(k), np.float32))}))
        msgs.append(unpack_message(wire, arena=WireArena(wire)))
    release_message(msgs[0])
    release_message(msgs[0])  # idempotent, a no-op without an arena
    for k in (1, 2):
        assert np.array_equal(msgs[k]["t"].values,
                              np.full((64,), float(k), np.float32))
    assert np.array_equal(msgs[0]["t"].values, np.zeros(64, np.float32))
    # a decoded message re-sent leaves its arena off the wire
    again = unpack_message(pack_message(msgs[1]))
    assert set(again) == {"t"}


def test_arena_release_callback_fires_once_even_via_del():
    fired = []
    arena = WireArena(b"x", on_release=lambda: fired.append(1))
    msg = {"_wire_arena": arena}
    release_message(msg)
    assert "_wire_arena" not in msg and arena.released
    release_message(msg)
    arena.release()
    arena.__del__()
    assert fired == [1]
    dropped = []
    WireArena(b"y", on_release=lambda: dropped.append(1))  # never released
    assert dropped == [1]


def test_the_host_view_bridge_aliases_a_writable_f32_view():
    buf = bytearray(serialize_tensor(Tensor("g", np.arange(6, dtype=np.float32))))
    writable = deserialize_tensor(buf, writable=True).values
    assert writable.flags.writeable
    t = device_from_host_view(writable, "cpu")
    assert t.data_ptr() == writable.ctypes.data  # an alias, no copy
    readonly = deserialize_tensor(buf).values
    c = device_from_host_view(readonly, "cpu")
    assert c.data_ptr() != readonly.ctypes.data  # one owned copy
    assert torch.equal(t, c)
    ints = device_from_host_view(np.arange(3), "cpu")
    assert ints.dtype == torch.int64
    # and the forward bridge: a CPU tensor's host view is zero-copy, bf16
    # comes back as its 16-bit words
    src = torch.arange(4, dtype=torch.float32)
    assert not is_device_array(src) and not is_device_array(np.ones(2))
    assert device_host_view(src).ctypes.data == src.data_ptr()
    words = device_host_view(src.to(torch.bfloat16))
    assert words.dtype == np.uint16 and np.array_equal(
        words, src.to(torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16))
    # a bf16 frame aliases a writable buffer and copies a read-only one
    bf = compress_tensors([Tensor("b", np.ones(4, np.float32))],
                          "bfloat16")[0][0]
    frame = bytearray(serialize_tensor(bf))
    alias = deserialize_tensor(frame, writable=True).values
    owned = deserialize_tensor(frame).values
    assert alias.dtype == owned.dtype == torch.bfloat16
    frame[-1] ^= 0x01
    assert not torch.equal(alias, owned)


# ---------------------------------------------------------------------------
# the protocol, over the port's socket transport
# ---------------------------------------------------------------------------


def _dense(n=2048):
    return np.arange(n, dtype=np.float32)


def _methods(calls):
    def pull_dense(req):
        calls["n"] += 1
        return {"version": calls["n"],
                "params": [Tensor("w", _dense() * req.get("scale", 1.0))]}

    def push_gradient(req):
        # a retention site: the handler materializes what outlives it
        g = req["grad"].materialize()
        return {"accepted": True, "sum": float(g.values.sum())}

    return {"pull_dense": pull_dense, "push_gradient": push_gradient}


@pytest.fixture
def shm_fleet():
    """A socket server with the endpoint and a negotiating channel."""
    calls = {"n": 0}
    methods, registry = install_shm_endpoint(_methods(calls))
    server = serve(methods, 0)
    client = Client("localhost:%d" % server.port, deadline_s=30)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        yield chan, registry, calls
    finally:
        chan.close()
        client.close()
        server.stop()
        registry.close()


def test_shm_round_trip_and_slot_recycle(shm_fleet):
    chan, registry, _ = shm_fleet
    resp = chan.call("pull_dense", scale=2.0)
    assert chan.state == "on" and registry.attached
    assert chan.stats == {"shm": 1, "inline": 0, "quarantined": 0}
    got = resp["params"][0]
    assert not got.values.flags.writeable
    assert np.array_equal(got.values, _dense() * 2.0)
    kept = got.materialize().values
    release_message(resp)
    with chan._mu:
        assert sorted(chan._free) == [0, 1]
    assert np.array_equal(kept, _dense() * 2.0)
    resp2 = chan.call("push_gradient",
                      grad=Tensor("g", np.ones((8,), np.float32)))
    assert resp2["accepted"] and resp2["sum"] == 8.0
    release_message(resp2)
    assert chan.stats["shm"] == 2
    del resp, got


def test_shm_oversized_payload_falls_back_per_call(shm_fleet):
    chan, _, _ = shm_fleet
    big = Tensor("g", np.zeros((1 << 19,), np.float32))  # 2 MiB > a slot
    resp = chan.call("push_gradient", grad=big)
    assert resp["accepted"] and chan.stats["inline"] == 1
    assert chan.state == "on"
    resp2 = chan.call("pull_dense")
    assert np.array_equal(resp2["params"][0].values, _dense())
    release_message(resp2)
    assert chan.stats["shm"] == 1
    del resp2


def test_shm_declined_cross_host_uses_bytes_path():
    registry = ShmEndpointRegistry()
    registry._fingerprint = "other-host|far-away"
    wrapped = {n: registry.wrap(f) for n, f in _methods({"n": 0}).items()}
    wrapped["transport_hello"] = registry.hello
    server = serve(wrapped, 0)
    client = Client("localhost:%d" % server.port, deadline_s=30)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        resp = chan.call("pull_dense")
        assert np.array_equal(resp["params"][0].values, _dense())
        assert chan.state == "off"
        assert chan.stats["inline"] == 1 and chan.stats["shm"] == 0
        release_message(resp)  # a no-op on the bytes path
    finally:
        chan.close()
        client.close()
        server.stop()
        registry.close()


def test_shm_hello_validates_geometry_and_name():
    registry = ShmEndpointRegistry()
    base = {"n_slots": 2, "slot_size": 1 << 20, "host": host_fingerprint()}
    assert not registry.hello(dict(base, name="not-ours"))["accepted"]
    assert not registry.hello(
        dict(base, name="edlw-x", n_slots=10_000))["accepted"]
    assert not registry.hello(
        dict(base, name="edlw-x", slot_size=1 << 30))["accepted"]
    assert not registry.hello(
        dict(base, name="edlw-x", host="elsewhere|"))["accepted"]
    resp = registry.hello(dict(base, name="edlw-nonexistent"))
    assert not resp["accepted"] and "attach" in resp["reason"]
    registry.close()


def test_shm_ring_reclaimed_after_client_sigkilled_mid_pull():
    """A client makes a ring, the server attaches, the client is SIGKILLed
    with its resource tracker detached (a killed pod loses both): the
    server registry's close() reclaims the name."""
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         "from multiprocessing import resource_tracker\n"
         "from elasticdl_tpu_torch.rpc.shm_transport import ShmRing\n"
         "ring = ShmRing(2, 1 << 16)\n"
         "resource_tracker.unregister(ring._shm._name, 'shared_memory')\n"
         "print(ring.name, flush=True)\n"
         "time.sleep(120)\n"],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    name = None
    try:
        name = child.stdout.readline().strip()
        assert name.startswith("edlw-")
        registry = ShmEndpointRegistry()
        assert registry.hello({"name": name, "n_slots": 2,
                               "slot_size": 1 << 16,
                               "host": host_fingerprint()})["accepted"]
        child.kill()
        child.wait(timeout=CHILD_LIMIT_S)
        assert _segment_exists(name)  # the name outlived its creator
        registry.close()
        assert not _segment_exists(name)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=CHILD_LIMIT_S)
        child.stdout.close()
        if name and _segment_exists(name):
            os.unlink(os.path.join("/dev/shm", name))


def test_shm_server_restart_disables_channel_and_resends_inline():
    """A restarted server lost its attachments: it answers _shm_error
    BEFORE dispatch, the client resends inline once and stops offering
    shm on the channel."""
    calls = {"n": 0}
    methods, registry = install_shm_endpoint(_methods(calls))
    server = serve(methods, 0)
    client = Client("localhost:%d" % server.port, deadline_s=30)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        release_message(chan.call("pull_dense"))
        assert chan.state == "on" and calls["n"] == 1
        registry.close()  # the "restart": the server lives, rings gone
        resp = chan.call("pull_dense")
        assert np.array_equal(resp["params"][0].values, _dense())
        assert chan.state == "off" and chan.stats["inline"] == 1
        assert calls["n"] == 2  # dispatched once, not twice
    finally:
        chan.close()
        client.close()
        server.stop()
        registry.close()


def test_shm_ring_unlink_is_idempotent_and_attach_checks_size():
    ring = ShmRing(2, 1 << 12)
    attached = ShmRing(2, 1 << 12, name=ring.name)
    with pytest.raises(ValueError):
        ShmRing(64, 1 << 20, name=ring.name)  # advertised > actual
    with pytest.raises(ValueError):
        ShmRing(2, 1 << 12, name="unprefixed-segment")
    attached.destroy()  # the attacher closes, never unlinks
    assert _segment_exists(ring.name)
    ring.destroy()
    ring.destroy()
    assert not _segment_exists(ring.name)


def test_memoryview_field_sizes_in_bytes_not_elements():
    arr = np.arange(4, dtype=np.float32)
    msg = unpack_message(bytes(pack_message({"b": memoryview(arr)})))
    assert msg["b"] == arr.tobytes()


def test_disable_defers_ring_destroy_until_inflight_drain():
    chan = ShmChannel(client=None, n_slots=2, slot_mb=1)
    ring = ShmRing(2, 1 << 12)
    with chan._mu:
        chan._state = "on"
        chan._ring = ring
    claim = chan._acquire()
    assert claim is not None and claim[0] is ring
    chan._disable()
    assert chan.state == "off" and not ring._destroyed
    ring.read_header(claim[1])  # still mapped mid-call
    assert chan._acquire() is None
    chan._leave()
    assert ring._destroyed
    chan.close()


def test_release_under_load_returns_every_slot(shm_fleet):
    """More concurrent calls than slots: the spill rides inline, every
    slot comes home and nothing fails."""
    chan, _, _ = shm_fleet
    errors = []

    def burst():
        try:
            for _ in range(6):
                resp = chan.call("pull_dense")
                assert np.array_equal(resp["params"][0].values, _dense())
                release_message(resp)
        except Exception as err:  # noqa: BLE001 - asserted below
            errors.append(err)

    threads = [threading.Thread(target=burst) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CHILD_LIMIT_S)
    assert not errors and not any(t.is_alive() for t in threads)
    with chan._mu:
        assert sorted(chan._free) == [0, 1]
    assert chan.stats["shm"] + chan.stats["inline"] == 24
    assert chan.stats["shm"] > 0 and chan.stats["quarantined"] == 0


def test_a_failed_fan_out_returns_the_answered_legs_slots():
    """One shard of a fan-out fails: the other shard's reply goes unread,
    and its slot comes home although the raised error's traceback keeps
    the fan-out's frame."""
    from elasticdl_tpu_torch.worker.ps_client import (
        BoundPS,
        PSClient,
        PSRpcError,
    )

    def pull_variable(req):
        return {"model_init_status": True, "version": 1,
                "params": [Tensor("w", _dense())]}

    def broken(req):
        raise ValueError("no model")

    servers = []
    for fn in (pull_variable, broken):
        methods, registry = install_shm_endpoint({"pull_variable": fn})
        servers.append((serve(methods, 0), registry))
    bound = [BoundPS("localhost:%d" % srv.port, deadline_s=30, shm="auto",
                     shm_slots=2, shm_slot_mb=1) for srv, _ in servers]
    client = PSClient(bound)
    try:
        with pytest.raises(PSRpcError) as excinfo:
            client.pull_dense()
        assert excinfo.value.__traceback__ is not None
        chan = bound[0].shm_channel
        assert chan.stats["shm"] == 1
        with chan._mu:
            assert sorted(chan._free) == [0, 1]
        del excinfo
    finally:
        client.close()
        for b in bound:
            b.close()
        for srv, registry in servers:
            srv.stop()
            registry.close()


def test_a_transport_error_mid_call_quarantines_the_slot():
    def slow(req):
        time.sleep(1.0)
        return {}

    methods, registry = install_shm_endpoint({"slow": slow})
    server = serve(methods, 0)
    client = Client("localhost:%d" % server.port, deadline_s=0.2)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        assert chan._ensure() == "on"
        from elasticdl_tpu_torch.rpc.socket_transport import RpcError

        with pytest.raises(RpcError, match="DEADLINE"):
            chan.call("slow")
        assert chan.stats["quarantined"] == 1
        with chan._mu:
            assert len(chan._free) == 1  # the slot is never reused
    finally:
        time.sleep(1.0)  # the late reply lands before the ring goes
        chan.close()
        client.close()
        server.stop()
        registry.close()


# ---------------------------------------------------------------------------
# across the packages, over gRPC
# ---------------------------------------------------------------------------


def _reply_values(resp):
    return [np.asarray(t.values).copy() for t in resp["params"]]


def test_the_ports_channel_against_the_references_endpoint():
    pytest.importorskip("grpc")
    from elasticdl_tpu.rpc import core as jcore
    from elasticdl_tpu.rpc import shm_transport as jshm

    def pull_dense(req):
        return {"params": [JTensor("w", _dense() * req.get("scale", 1.0))]}

    def push_gradient(req):
        g = req["grad"].materialize()
        return {"sum": float(g.values.sum()),
                "rows": g.values[:2].copy()}

    methods, registry = jshm.install_shm_endpoint(
        {"pull_dense": pull_dense, "push_gradient": push_gradient})
    server = jcore.serve(methods, 0)
    from elasticdl_tpu_torch.rpc.core import Client as GrpcClient

    client = GrpcClient("localhost:%d" % server._edl_port, deadline_s=30)
    chan = ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        inline = client.call("pull_dense", scale=3.0)
        ring = chan.call("pull_dense", scale=3.0)
        assert chan.state == "on" and chan.stats["shm"] == 1
        assert [np.array_equal(a, b) for a, b in zip(
            _reply_values(inline), _reply_values(ring))] == [True]
        release_message(ring)
        grad = Tensor("g", torch.arange(12, dtype=torch.float32).view(6, 2))
        a = client.call("push_gradient", grad=grad)
        b = chan.call("push_gradient", grad=grad)
        assert a["sum"] == b["sum"] == 66.0
        assert np.array_equal(a["rows"], b["rows"])
        release_message(b)
        assert chan.stats["shm"] == 2
        del ring, b
    finally:
        chan.close()
        client.close()
        server.stop(None)
        registry.close()


def test_the_references_channel_against_the_ports_endpoint():
    pytest.importorskip("grpc")
    from elasticdl_tpu.common.tensor import release_message as j_release
    from elasticdl_tpu.rpc import core as jcore
    from elasticdl_tpu.rpc import shm_transport as jshm
    from elasticdl_tpu_torch.rpc.core import serve as grpc_serve

    calls = {"n": 0}
    methods, registry = install_shm_endpoint(_methods(calls))
    server = grpc_serve(methods, 0)
    client = jcore.Client("localhost:%d" % server._edl_port)
    chan = jshm.ShmChannel(client, n_slots=2, slot_mb=1)
    try:
        inline = client.call("pull_dense", scale=0.5)
        ring = chan.call("pull_dense", scale=0.5)
        assert chan.state == "on" and chan.stats["shm"] == 1
        assert np.array_equal(_reply_values(inline)[0],
                              _reply_values(ring)[0])
        j_release(ring)
        b = chan.call("push_gradient",
                      grad=JTensor("g", np.full(5, 2.0, np.float32)))
        assert b["accepted"] and b["sum"] == 10.0
        j_release(b)
        assert chan.stats["shm"] == 2 and registry.attached
        names = registry.attached
        del ring, b
    finally:
        chan.close()
        client.close()
        server.stop(None)
        registry.close()
    assert not any(_segment_exists(n) for n in names)


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------


def _shard_args(i, device_store):
    from elasticdl_tpu_torch.common.args import parse_ps_args
    from tests.test_torch_ps_job import DEEPFM, _free_port

    return parse_ps_args([
        "--ps_id", str(i), "--port", str(_free_port()), "--model_zoo", "",
        "--model_def", DEEPFM, "--device", "cpu", "--grads_to_wait", "2",
        "--ps_device", "true" if device_store else "false"])


def _fleet_run(tmp_path, shm, monkeypatch):
    """DeepFM over two ``ParameterServer`` shards served on sockets (shard
    1 with ``--ps_device``), one in-process worker through ``BoundPS``
    with ``shm``, ``--grads_to_wait 2``: the shards' dense model, every
    row, and each channel's state and stats."""
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.data.dataset import Dataset as TDataset
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
    from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient
    from elasticdl_tpu_torch.worker.worker import Worker
    from tests.test_torch_ps_job import (
        DEEPFM,
        PORT_ZOO,
        SMALL,
        _identity_shuffle,
        write_frappe,
    )

    monkeypatch.setenv("EDL_TASK_SHUFFLE_SEED", "3")
    monkeypatch.setattr(TDataset, "shuffle", _identity_shuffle)
    f = write_frappe(str(tmp_path / ("data-" + shm)), 192, 300)
    shards = [ParameterServer(_shard_args(i, i == 1)) for i in range(2)]
    bound = []
    try:
        for s in shards:
            s.prepare()
        bound = [BoundPS("localhost:%d" % s.port, deadline_s=30, shm=shm,
                         shm_slots=2, shm_slot_mb=1) for s in shards]
        client = PSClient(bound)
        task_d = TaskDispatcher({f: (0, 192)}, {}, {}, 32, 1)
        master = MasterServicer(1, 32, None, task_d, coordinates_only=False,
                                device="cpu")
        worker = Worker(worker_id=0, job_type=JobType.TRAINING_ONLY,
                        minibatch_size=32, model_zoo=PORT_ZOO,
                        model_def=DEEPFM, model_params=SMALL, stub=master,
                        device="cpu", ps_client=client)
        losses = worker.run()
        assert task_d.finished() and len(losses) == 6
        ready, version, dense = client.pull_dense()
        ids = np.arange(300)
        rows = {t: client.pull_embedding_vectors(t, ids)
                for t in ("embedding", "id_bias")}
        client.close()
        channels = [(b.shm_channel.state, dict(b.shm_channel.stats))
                    if b.shm_channel is not None else None for b in bound]
        attached = [s._shm_registry.attached for s in shards]
    finally:
        for b in bound:
            b.close()
        for s in shards:
            s.stop()
    assert ready and version == 3  # six pushes, an apply every second
    return dense, rows, channels, attached


def test_the_fleet_is_bitwise_the_same_with_the_wire_on_and_off(
        tmp_path, monkeypatch):
    off = _fleet_run(tmp_path, "off", monkeypatch)
    auto = _fleet_run(tmp_path, "auto", monkeypatch)
    assert off[2] == [None, None] and off[3] == [[], []]
    for state, stats in auto[2]:
        assert state == "on" and stats["shm"] > 0, auto[2]
        assert stats["quarantined"] == 0
    assert all(len(names) == 1 for names in auto[3])
    assert sorted(off[0]) == sorted(auto[0])
    for k in off[0]:
        assert np.array_equal(off[0][k], auto[0][k]), k
    for t in off[1]:
        assert np.array_equal(off[1][t], auto[1][t]), t


def _held_master(epoch):
    from elasticdl_tpu_torch.master.rpc_service import MasterRpcService
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    task_d = TaskDispatcher({"f": (0, 16)}, {}, {}, 16, 1)
    master = MasterServicer(
        1, 16, lambda params: torch.optim.SGD(params, lr=0.1), task_d,
        use_async=True, device="cpu")
    master.report_variable(
        {"w": np.arange(12, dtype=np.float32).reshape(3, 4) * epoch})
    return MasterRpcService(master, master_epoch=epoch)


def test_get_model_rides_the_masters_ring_through_a_relaunch():
    from elasticdl_tpu_torch.master.rpc_service import MasterClient
    from tests.test_torch_ps_job import _free_port

    port = _free_port()
    methods, registry = install_shm_endpoint(_held_master(1).rpc_methods())
    server = serve(methods, port)
    client = MasterClient("localhost:%d" % port, failover_s=30, shm="auto")
    seen = []
    client.set_on_master_epoch_change(lambda old, new: seen.append(
        (old, new)))
    try:
        _, named = client.get_model(0)
        chan = client.shm_channel
        assert chan.state == "on" and chan.stats["shm"] == 1
        assert named["w"].flags.writeable  # owned, off the recycled slot
        first = named["w"].copy()
        _, named2 = client.get_model(0)
        assert np.array_equal(named["w"], first)
        assert np.array_equal(named2["w"], first)
        assert client.master_epoch == 1 and chan.stats["shm"] == 2
        client.get_task(1)  # requests stay on the socket path
        assert chan.stats["shm"] == 2
        # the relaunch: a new master (epoch 2) on the same port knows no
        # ring, answers _shm_error before dispatch, and the resend goes
        # inline and shows the new epoch
        server.stop()
        registry.close()
        methods, registry = install_shm_endpoint(
            _held_master(2).rpc_methods())
        server = serve(methods, port)
        _, named3 = client.get_model(0)
        assert np.array_equal(named3["w"], first * 2)
        assert chan.state == "off" and chan.stats["inline"] == 1
        assert client.master_epoch == 2 and seen == [(1, 2)]
    finally:
        client.close()
        server.stop()
        registry.close()


def test_the_scorers_ring_scores_as_its_socket(tmp_path):
    from elasticdl_tpu_torch.serving.server import ScorerServer
    from tests.test_torch_serving_ps import (
        _features,
        _jax_export,
        _package,
        _scorer_stack,
    )

    _jax_export(tmp_path, 2)
    _, _, ps_client, scorer, watcher = _scorer_stack(_package("port"),
                                                     tmp_path)
    server = ScorerServer(scorer, port=0, transport="socket")
    plain = Client("localhost:%d" % server.port, deadline_s=30)
    ring_client = Client("localhost:%d" % server.port, deadline_s=30)
    chan = ShmChannel(ring_client, n_slots=2, slot_mb=1)
    try:
        watcher.poll_once()
        for seed in range(3):
            feats = _features(8, seed=seed)
            a = plain.call("score", **feats)
            b = chan.call("score", **feats)
            assert a["model_version"] == b["model_version"] == 2
            for key in ("out:logits", "out:probs"):
                assert np.array_equal(np.asarray(a[key]),
                                      np.asarray(b[key])), key
            release_message(b)
            del b
        assert chan.state == "on" and chan.stats["shm"] == 3
        assert chan.stats["inline"] == 0
    finally:
        chan.close()
        plain.close()
        ring_client.close()
        server.stop()
        scorer.close()
        ps_client.close()


def test_a_sigkilled_clients_ring_is_reclaimed_by_the_shards_stop(
        tmp_path):
    """A client process negotiates with a served shard and is SIGKILLed
    with its resource tracker detached: the shard's stop unlinks the
    ring."""
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer

    shard = ParameterServer(_shard_args(0, False))
    shard.prepare()
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import time\n"
         "from multiprocessing import resource_tracker\n"
         "from elasticdl_tpu_torch.worker.ps_client import BoundPS\n"
         "b = BoundPS('localhost:%d', deadline_s=30, shm='auto')\n"
         "b.ps_status({})\n"
         "ring = b.shm_channel._ring\n"
         "resource_tracker.unregister(ring._shm._name, 'shared_memory')\n"
         "print(ring.name, b.shm_channel.state, flush=True)\n"
         "time.sleep(120)\n" % shard.port],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    name = None
    try:
        name, state = child.stdout.readline().split()
        assert state == "on" and shard._shm_registry.attached == [name]
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=CHILD_LIMIT_S)
        assert _segment_exists(name)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=CHILD_LIMIT_S)
        child.stdout.close()
        shard.stop()
    assert not _segment_exists(name)
