"""The worker's channel to the master through a master restart, the
counterpart of ``elasticdl_tpu/rpc/failover.py`` over the socket
transport (``rpc/socket_transport.py``).

:class:`MasterFailoverChannel` is the one place the master channel sends
a call again:

- **A busy master still blocks.** Attempts carry no deadline by default
  (``attempt_deadline_s=0``): a worker parked on a slow reply waits. An
  expired deadline (``DEADLINE_EXCEEDED``) is never retried: a
  ``get_task`` whose dispatch the live master made would leak its task.
- **``UNAVAILABLE`` rides out the outage.** A refused connection, or a
  reset or end of stream before the first reply byte, is what a killed
  and relaunching master looks like. The call is sent again, on a freshly
  dialled connection, with a doubling backoff capped at 2 s, until
  ``outage_budget_s`` is spent; then the error is raised.
- **A cut reply is resent only where a second delivery is harmless.** A
  connection cut after the first reply byte (``DATA_LOSS``) is how a
  master killed mid-reply looks over sockets; gRPC, under the reference,
  calls it ``UNAVAILABLE``. The calls in :data:`RESEND_AFTER_CUT` ride it
  out like ``UNAVAILABLE``, inside the same budget and backoff: the reads
  are pure, and ``report_task_result`` is deduped by the new master
  against its journal by the ack's trace id. Every other call raises it:
  a cut ``get_task`` whose master lived would leave its task in the doing
  set, a cut ``report_gradient`` could apply one gradient twice.
- **Epochs.** Every master reply carries the incarnation's
  ``master_epoch``; ``on_epoch_change(old, new)`` fires once per change,
  so the owner (``MasterClient``'s worker) can re-register.

``outage_budget_s=0`` sends each call once, keeping the epoch watch.
"""

import threading
import time

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils import profiling

_BACKOFF_S = 0.2
_BACKOFF_CAP_S = 2.0

# the calls a reply cut after its first byte (DATA_LOSS) is resent for
RESEND_AFTER_CUT = frozenset({
    "report_task_result",
    "get_comm_world",
    "standby_poll",
    "master_status",
    "get_model",
    "pull_embedding_vectors",
    "export_embedding_tables",
})


class MasterFailoverChannel:
    """``call``-compatible wrapper around one socket ``Client``."""

    def __init__(self, addr, outage_budget_s=0.0, attempt_deadline_s=0.0,
                 on_epoch_change=None):
        self._addr = addr
        self._attempt_deadline = (
            attempt_deadline_s if attempt_deadline_s > 0 else None
        )
        self._client = self._dial()
        self._budget_s = max(0.0, float(outage_budget_s))
        self._on_epoch_change = on_epoch_change
        self._mu = threading.Lock()
        self._epoch = None  # the last master_epoch any reply carried
        self._outage_logged = False
        self._c_retries = profiling.metrics.counter(
            "edl_master_failover_retries_total",
            "Master-channel calls resent through an outage window",
            labels=("method",),
        )

    def _dial(self):
        from elasticdl_tpu_torch.rpc.socket_transport import Client

        # the client never retries itself: this channel owns resends
        return Client(self._addr, deadline_s=self._attempt_deadline)

    @property
    def master_epoch(self):
        with self._mu:
            return self._epoch

    @property
    def outage_budget_s(self):
        return self._budget_s

    def call(self, rpc_name, _retriable=True, _budget_s=None, **fields):
        """One master call, sent again through an ``UNAVAILABLE`` window
        (or a cut reply, for :data:`RESEND_AFTER_CUT`) of at most
        ``_budget_s`` (the channel's budget by default)."""
        from elasticdl_tpu_torch.rpc.socket_transport import RpcError

        budget = self._budget_s if _budget_s is None else _budget_s
        deadline = time.monotonic() + budget if budget > 0 else None
        backoff = _BACKOFF_S
        while True:
            try:
                resp = self._client.call(rpc_name, **fields)
            except RpcError as err:
                resendable = err.code == "UNAVAILABLE" or (
                    err.code == "DATA_LOSS" and rpc_name in RESEND_AFTER_CUT
                )
                if not (
                    _retriable
                    and resendable
                    and deadline is not None
                    and time.monotonic() + backoff < deadline
                ):
                    raise
                self._note_outage(rpc_name)
                self._c_retries.inc(method=rpc_name)
                # a pooled connection to the dead master is dead too: the
                # next attempt dials afresh. The old client is dropped,
                # not closed: another thread may still be inside it.
                self._client = self._dial()
                time.sleep(backoff)
                backoff = min(backoff * 2, _BACKOFF_CAP_S)
                continue
            self.note_reply(resp)
            return resp

    def _note_outage(self, rpc_name):
        with self._mu:
            first = not self._outage_logged
            self._outage_logged = True
        if first:
            logger.warning(
                "master unreachable (%s); retrying through the outage "
                "window with capped backoff",
                rpc_name,
            )
            profiling.events.emit("master_unavailable", method=rpc_name)

    def note_reply(self, resp):
        """Watch ``master_epoch`` in a reply; fire the hook on a change."""
        epoch = resp.get("master_epoch") if isinstance(resp, dict) else None
        changed = None
        with self._mu:
            self._outage_logged = False
            if epoch is not None and epoch != self._epoch:
                changed = (self._epoch, epoch)
                self._epoch = epoch
        if changed is None or changed[0] is None:
            return
        logger.warning(
            "master epoch changed %s -> %s: a relaunched master is serving",
            changed[0],
            changed[1],
        )
        profiling.events.emit(
            "master_epoch_change", old=changed[0], new=changed[1]
        )
        if self._on_epoch_change is not None:
            try:
                self._on_epoch_change(changed[0], changed[1])
            except Exception:
                logger.warning("master epoch-change hook failed",
                               exc_info=True)

    def close(self):
        self._client.close()
