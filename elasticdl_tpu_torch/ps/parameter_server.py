"""A parameter-server shard process, the port of
``elasticdl_tpu/ps/parameter_server.py``: it loads the zoo's optimizer,
restores the newest snapshot of its shard directory before it serves
(``--ps_snapshot_versions`` with ``--ps_snapshot_dir``), mints its
``shard_epoch``, and serves ``PserverServicer`` on the port's socket
transport (``rpc/socket_transport.py``) at ``--port``: a relaunch with
the same id binds the same address, so the workers dial it again. The
shard's applies run on ``--device`` (``cuda`` by default; raises without
a card); once it serves, a background thread runs one scratch step of
the optimizer there, so the first apply does not pay for the device's
context and torch's lazy imports. SIGTERM drains: one final snapshot, then exit 75, which the
instance manager relaunches without spending its crash budget.

The shard always offers the shared-memory endpoint
(``rpc/shm_transport.py``), as the reference does: a client on the same
host negotiates a ring through ``transport_hello`` (whose reply carries
the ``shard_epoch``), after which payloads travel in its slots; a
``--ps_device`` shard decodes slot requests as writable views, which
enter the device in one host-to-device copy. A stop reclaims every
attached ring, those of SIGKILLed clients included. The shard has no
``--ps_shm`` flag, as the reference's has none.

``--ps_device`` keeps the store on ``--device`` (``ps/device_store.py``);
``--ps_warm_rows`` with ``--ps_spill_dir`` tiers every table
(``ps/tiered_store.py``), spilling under ``<spill_dir>/ps-{id}``. Only one
of those two runs untiered with a warning, as the reference does. A stop
closes the tiered tables' demoters.

``--ps_telemetry_port`` (0: ephemeral, exposed as ``ps_telemetry_port``;
-1: off) serves the shard's own registry (the service histograms under
``role=ps``, ``edl_ps_snapshot_age_seconds``), ``/events``, ``/trace``
(the shard's ``ps/apply`` and snapshot spans, joined to the workers'
traces by ``_sctx``) and ``/healthz`` (``restoring`` until the RPC plane
serves, then ``serving``, ``draining`` through SIGTERM). The flight
recorder is armed at ``<ps_snapshot_dir>/ps-<id>/postmortem`` (or
``EDL_FLIGHT_RECORDER_DIR``).
"""

import os
import threading
import time

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.master.local_instance_manager import (
    PREEMPTED_EXIT_CODE,
)
from elasticdl_tpu_torch.utils import profiling


def tier_config(args):
    """The tiered store's config from ``--ps_warm_rows`` and
    ``--ps_spill_dir`` (spilling under ``<dir>/ps-{id}``), or None; one
    flag without the other warns and runs untiered."""
    warm_rows = int(getattr(args, "ps_warm_rows", 0) or 0)
    spill_dir = getattr(args, "ps_spill_dir", "") or ""
    if warm_rows > 0 and spill_dir:
        return {
            "warm_rows": warm_rows,
            "spill_dir": os.path.join(spill_dir, "ps-%d" % args.ps_id),
        }
    if warm_rows > 0 or spill_dir:
        logger.warning(
            "the tiered store needs both --ps_warm_rows and --ps_spill_dir;"
            " running untiered"
        )
    return None


class ParameterServer:
    def __init__(self, args):
        from elasticdl_tpu_torch.common.device import resolve_device
        from elasticdl_tpu_torch.common.model_utils import load_zoo_module
        from elasticdl_tpu_torch.ps.parameters import Parameters
        from elasticdl_tpu_torch.ps.servicer import PserverServicer
        from elasticdl_tpu_torch.ps.snapshot import (
            ShardSnapshotter,
            mint_shard_epoch,
        )

        self._args = args
        self._server = None
        self._shm_registry = None
        self._telemetry_http = None
        self.ps_telemetry_port = None
        self._draining = threading.Event()
        # /healthz: "restoring" until the RPC plane serves, then
        # "serving", "draining" through SIGTERM
        self._health = "restoring"
        self._owns_flight_recorder = False
        self._warm_thread = None
        self.device = resolve_device(getattr(args, "device", "cuda"))
        module = load_zoo_module(args.model_def, args.model_zoo)
        optimizer = getattr(module, args.optimizer, None)
        if optimizer is None:
            raise ValueError(
                "the model module of %s defines no %s"
                % (args.model_def, args.optimizer)
            )
        self.parameters = Parameters(
            device=self.device if getattr(args, "ps_device", False) else None,
            tier_config=tier_config(args),
        )
        snap_dir = getattr(args, "ps_snapshot_dir", "") or ""
        shard_dir = (
            os.path.join(snap_dir, "ps-%d" % args.ps_id) if snap_dir else ""
        )
        self.shard_epoch = mint_shard_epoch(shard_dir or None)
        self.snapshotter = ShardSnapshotter(
            shard_dir,
            ps_id=args.ps_id,
            every_versions=getattr(args, "ps_snapshot_versions", 0),
            keep=getattr(args, "ps_snapshot_keep", 2),
        )
        self.snapshotter.set_shard_epoch(self.shard_epoch)
        # postmortems land next to the shard's snapshots (durable across
        # the relaunch); EDL_FLIGHT_RECORDER_DIR overrides for
        # snapshot-less shards
        fr_dir = os.environ.get("EDL_FLIGHT_RECORDER_DIR") or (
            os.path.join(shard_dir, "postmortem") if shard_dir else ""
        )
        if fr_dir:
            profiling.flight_recorder.arm(fr_dir)
            self._owns_flight_recorder = True
        # restored before the servicer exists: a restored shard never
        # serves one call from an empty store
        self.restored_version = self.snapshotter.restore_into(
            self.parameters
        )
        self._optimizer = optimizer()
        self.servicer = PserverServicer(
            self.parameters,
            args.grads_to_wait,
            self._optimizer,
            self.device,
            lr_staleness_modulation=args.lr_staleness_modulation,
            use_async=args.use_async,
            wire_dtype=getattr(args, "wire_dtype", ""),
            snapshotter=(
                self.snapshotter if self.snapshotter.is_enabled() else None
            ),
            shard_epoch=self.shard_epoch,
            restored_version=self.restored_version,
        )

    @property
    def port(self):
        return self._server.port if self._server else None

    def prepare(self):
        from elasticdl_tpu_torch.rpc.shm_transport import install_shm_endpoint
        from elasticdl_tpu_torch.rpc.socket_transport import serve

        # offered always: it engages only when a co-located client
        # negotiates a ring, and costs nothing otherwise
        methods, self._shm_registry = install_shm_endpoint(
            self.servicer.rpc_methods(),
            hello_extra={"shard_epoch": self.shard_epoch},
            writable_request_views=self.parameters.device is not None,
        )
        telemetry_port = getattr(self._args, "ps_telemetry_port", -1)
        if telemetry_port is not None and telemetry_port >= 0:
            from elasticdl_tpu_torch.master.telemetry import (
                ProcessTelemetry,
                TelemetryHTTPServer,
            )

            self._telemetry_http = TelemetryHTTPServer(
                ProcessTelemetry(),
                port=telemetry_port,
                health_fn=lambda: self._health,
            )
            self.ps_telemetry_port = self._telemetry_http.port
        self._server = serve(methods, self._args.port)
        self._health = "serving"
        logger.info(
            "PS %d serving on port %d (shard_epoch %d%s, device %s, %s "
            "store%s)",
            self._args.ps_id,
            self._server.port,
            self.shard_epoch,
            (
                ", restored snapshot v%d" % self.restored_version
                if self.restored_version is not None
                else ""
            ),
            self.device,
            "device" if self.parameters.device is not None else "host",
            (
                ", tiered at %d warm rows"
                % self.parameters.tier_config["warm_rows"]
                if self.parameters.tier_config
                else ""
            ),
        )
        # the first apply would pay for the device's context and torch's
        # lazy imports (seconds): they are paid here while the workers boot
        self._warm_thread = threading.Thread(
            target=self._warm, name="ps-warm", daemon=True
        )
        self._warm_thread.start()

    def _warm(self):
        """One zero-gradient step of the optimizer on a scratch row of
        the device; the store is not touched."""
        import torch

        from elasticdl_tpu_torch.ps.optimizer_wrapper import probe_row_state

        try:
            probe_row_state(self._optimizer, 1, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as err:  # noqa: BLE001 - the first apply raises it
            logger.warning("warming the shard's device failed: %s", err)

    def install_drain_handler(self):
        """SIGTERM: a final snapshot, then exit 75. Installed only by the
        process entry."""
        import signal
        import sys

        def _drain(signum, frame):
            if self._draining.is_set():
                return
            self._draining.set()
            self._health = "draining"
            logger.warning("SIGTERM: draining a final shard snapshot")
            try:
                self.servicer.drain_snapshot()
            except Exception as err:  # noqa: BLE001 - exit regardless
                logger.error("drain snapshot failed: %s", err)
            self.stop()
            sys.exit(PREEMPTED_EXIT_CODE)

        signal.signal(signal.SIGTERM, _drain)

    def run(self):
        try:
            while True:
                time.sleep(60)
        finally:
            self.stop()

    def stop(self):
        if self._server:
            self._server.stop()
            self._server = None
        if self._telemetry_http is not None:
            self._telemetry_http.close()
            self._telemetry_http = None
        if self._shm_registry is not None:
            # reclaims every attached ring, SIGKILLed clients' included
            self._shm_registry.close()
            self._shm_registry = None
        if self.snapshotter is not None:
            try:
                self.snapshotter.close()
            except Exception as err:  # noqa: BLE001 - teardown
                logger.warning("snapshotter close failed: %s", err)
            self.snapshotter = None
        self.parameters.close()
        if self._owns_flight_recorder:
            # the recorder is process-wide: an embedded shard must not
            # leave it pointed at a torn-down directory
            profiling.flight_recorder.disarm()
            self._owns_flight_recorder = False


def main(argv=None):
    from elasticdl_tpu_torch.common.args import parse_ps_args

    args = parse_ps_args(argv)
    logger.setLevel(args.log_level)
    # name this process in every span id and postmortem header (entry
    # points only: embedded shards keep the pid default)
    profiling.spans.set_process("ps-%d" % args.ps_id)
    server = ParameterServer(args)
    server.prepare()
    server.install_drain_handler()
    server.run()
