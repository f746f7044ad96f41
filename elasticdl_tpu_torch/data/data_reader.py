"""Data readers, the counterpart of ``elasticdl_tpu/data/data_reader.py``:
``read_records(task)`` yields the raw records ``[task.start, task.end)``
of shard ``task.shard_name`` and ``create_shards()`` returns ``{shard_name:
(start_index, num_records)}``, the dispatcher's input.

The RecordIO reader serves one shard per EDLR file of a directory
(record indices are file-local, so every shard starts at 0). The ODPS
(MaxCompute) reader is not ported yet: the factory raises where the
reference would pick it.
"""

import os
import threading

from elasticdl_tpu_torch.common.constants import ODPSConfig
from elasticdl_tpu_torch.data.recordio import RecordIOReader, open_recordio


class Metadata:
    def __init__(self, column_names=None):
        self.column_names = column_names


class RecordIODataReader:
    """Reads EDLR files from ``data_dir``; one shard per file."""

    def __init__(self, **kwargs):
        _check_required_kwargs(["data_dir"], kwargs)
        self._kwargs = kwargs
        self._readers = {}
        # read_records runs on the task prefetcher's pool and on the
        # consumer at once: one reader per file, opened once
        self._readers_lock = threading.Lock()
        self._closed = False

    def _reader(self, path):
        with self._readers_lock:
            if self._closed:
                raise RuntimeError("RecordIODataReader is closed")
            reader = self._readers.get(path)
        if reader is not None:
            return reader
        reader = open_recordio(path)
        with self._readers_lock:
            winner = None if self._closed else (
                self._readers.setdefault(path, reader)
            )
        if winner is not reader:
            reader.close()
        if winner is None:
            raise RuntimeError("RecordIODataReader is closed")
        return winner

    def read_records(self, task):
        yield from self._reader(task.shard_name).read_range(
            task.start, task.end
        )

    def create_shards(self):
        data_dir = self._kwargs["data_dir"]
        shards = {}
        for f in sorted(os.listdir(data_dir)):
            p = os.path.join(data_dir, f)
            with RecordIOReader(p) as r:
                shards[p] = (0, len(r))
        return shards

    @property
    def metadata(self):
        return Metadata()

    def close(self):
        with self._readers_lock:
            self._closed = True
            readers = list(self._readers.values())
            self._readers.clear()
        for r in readers:
            r.close()


def create_data_reader(data_origin, records_per_task=None, **kwargs):
    """RecordIO over a directory. Where the reference would read an ODPS
    table (its credentials set in the environment), this raises."""
    del records_per_task, kwargs  # the ODPS reader's, as in the reference
    if all(
        k in os.environ
        for k in (
            ODPSConfig.PROJECT_NAME,
            ODPSConfig.ACCESS_ID,
            ODPSConfig.ACCESS_KEY,
        )
    ):
        raise NotImplementedError(
            "the ODPS data reader is not ported yet (unset %s to read "
            "RecordIO)" % ODPSConfig.PROJECT_NAME
        )
    return RecordIODataReader(data_dir=data_origin)


def _check_required_kwargs(required_args, kwargs):
    missing = [k for k in required_args if k not in kwargs]
    if missing:
        raise ValueError(
            "The following required arguments are missing: %s"
            % ", ".join(missing)
        )
