"""Versioned model checkpoints with ring retention, the counterpart of
``elasticdl_tpu/master/checkpoint_service.py``: ``model_v{N}.chkpt`` files
in the EDLC codec (common/model_utils.py) every ``checkpoint_steps``
versions, the newest ``keep_checkpoint_max`` kept, evaluation snapshots
in a temporary directory of their own.

The single-process ALLREDUCE job's master holds no parameters, so it
only carries this service; the worker writes the sharded checkpoints
(common/sharded_checkpoint.py).
"""

import os
import tempfile

from elasticdl_tpu_torch.common.model_utils import (
    load_from_checkpoint_file,
    save_checkpoint_to_file,
)


class Checkpoint:
    def __init__(self, version, file):
        self.version = version
        self.file = file


class CheckpointService:
    def __init__(
        self,
        checkpoint_dir,
        checkpoint_steps,
        keep_checkpoint_max,
        include_evaluation,
    ):
        self._directory = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoint_dir"
        )
        self._steps = checkpoint_steps
        self._max_versions = keep_checkpoint_max
        self._checkpoint_list = []
        self._include_evaluation = include_evaluation
        self._eval_checkpoint_dir = (
            tempfile.mkdtemp() if include_evaluation else ""
        )

    def _get_checkpoint_file(self, version, is_eval_checkpoint=False):
        return "%s/model_v%s.chkpt" % (
            self._eval_checkpoint_dir
            if is_eval_checkpoint
            else self._directory,
            str(version),
        )

    def is_enabled(self):
        return bool(self._steps)

    def need_to_checkpoint(self, version):
        return self.is_enabled() and version % self._steps == 0

    def save(self, version, named_arrays, is_eval_checkpoint):
        """Write {name: array} at ``version``; ring-evict old ones."""
        if not is_eval_checkpoint:
            os.makedirs(self._directory, exist_ok=True)
        file = self._get_checkpoint_file(version, is_eval_checkpoint)
        save_checkpoint_to_file(named_arrays, version, file)
        if not is_eval_checkpoint:
            self._checkpoint_list.append(Checkpoint(version, file))
            if self._max_versions:
                while len(self._checkpoint_list) > self._max_versions:
                    os.remove(self._checkpoint_list.pop(0).file)

    def remove_eval_checkpoint(self, version):
        os.remove(self._get_checkpoint_file(version, is_eval_checkpoint=True))

    def get_checkpoint_path(self, version):
        for is_eval in (False, True):
            f = self._get_checkpoint_file(version, is_eval_checkpoint=is_eval)
            if os.path.isfile(f):
                return f
        return ""

    def get_checkpoint_model(self, version):
        """Returns (version, {name: array}) for a stored version."""
        file = self.get_checkpoint_path(version)
        try:
            return load_from_checkpoint_file(file)
        except Exception:
            raise RuntimeError(
                "Failed to read model checkpoint from file " + str(file)
            )

    def get_latest_checkpoint_version(self):
        if not self._checkpoint_list:
            raise RuntimeError("No model checkpoint available")
        return self._checkpoint_list[-1].version
