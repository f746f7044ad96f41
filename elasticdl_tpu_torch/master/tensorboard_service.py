"""Metrics export service, the port of
``elasticdl_tpu/master/tensorboard_service.py``.

It writes the evaluation service's metric dicts keyed by model version,
and spawns a ``tensorboard`` process where one is installed. It writes
both surfaces: real TensorBoard
event files (``events.out.tfevents.*`` via common/tb_events.py — same
on-disk format ``tf.summary`` produces, no TF dependency) so
``tensorboard --logdir`` renders the eval curves, plus a JSONL scalar
log (``scalars.jsonl``) any dashboard can tail without a TB parser.
"""

import json
import os
import subprocess
import time

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.common.tb_events import EventFileWriter


class TensorboardService:
    def __init__(self, tensorboard_log_dir, master_ip=None):
        self._logdir = tensorboard_log_dir
        self._master_ip = master_ip
        os.makedirs(self._logdir, exist_ok=True)
        self._scalars_path = os.path.join(self._logdir, "scalars.jsonl")
        self._f = open(self._scalars_path, "a")
        self._events = EventFileWriter(self._logdir)
        self.tb_process = None

    def write_dict_to_summary(self, dictionary, version):
        """Append flat scalar records ``{tag, value, step, ts}``.

        Nested dicts (multi-output models) flatten to ``output/metric`` tags,
        matching the reference's summary naming.
        """
        now = time.time()
        scalars = []

        def emit(tag, value):
            scalars.append((tag, float(value)))
            self._f.write(
                json.dumps(
                    {
                        "tag": tag,
                        "value": float(value),
                        "step": int(version),
                        "ts": now,
                    }
                )
                + "\n"
            )

        for key, value in dictionary.items():
            if isinstance(value, dict):
                for sub_key, sub_value in value.items():
                    emit("%s/%s" % (key, sub_key), sub_value)
            else:
                emit(key, value)
        self._f.flush()
        self._events.add_scalars(scalars, version, wall_time=now)

    def start(self):
        """Spawn the tensorboard CLI if present."""
        try:
            self.tb_process = subprocess.Popen(
                ["tensorboard", "--logdir", self._logdir, "--host", "0.0.0.0"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        except FileNotFoundError:
            logger.info(
                "tensorboard CLI not installed; scalars logged to %s",
                self._scalars_path,
            )

    def is_active(self):
        return self.tb_process is not None and self.tb_process.poll() is None

    def keep_running(self):
        while self.is_active():
            time.sleep(10)

    def close(self):
        self._f.close()
        self._events.close()
        if self.tb_process is not None:
            self.tb_process.terminate()
