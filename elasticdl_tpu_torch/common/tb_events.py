"""Dependency-free TensorBoard event-file writer and reader, the port of
``elasticdl_tpu/common/tb_events.py`` (the same bytes for the same calls).

TensorBoard renders TFRecord-framed files written by
``tf.summary.create_file_writer``. This module writes the same
on-disk format — ``events.out.tfevents.*`` files of length-prefixed,
CRC32C-masked records carrying hand-serialized ``Event`` protos — with
no TensorFlow (or protoc) dependency, the same stance as rpc/core.py's
self-describing frames.

Format (tensorflow/core/lib/io/record_writer.cc):

    uint64  length          (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data            (serialized Event proto)
    uint32  masked_crc32c(data)

where ``masked_crc = ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32``
over the Castagnoli CRC-32. The first record of every file is an Event
with ``file_version = "brain.Event:2"``; scalars are Summary.Value
entries with ``simple_value`` set, which every TensorBoard release
renders in the scalar dashboard.
"""

import os
import socket
import struct
import threading
import time

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data):
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n):
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field, wire_type):
    return _varint(field << 3 | wire_type)


def _bytes_field(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _summary_value(tag, value):
    # Summary.Value{ tag=1 (string), simple_value=2 (float) }
    payload = _bytes_field(1, tag.encode("utf-8"))
    payload += _key(2, 5) + struct.pack("<f", float(value))
    return payload


def encode_scalar_event(wall_time, step, scalars):
    """Event{wall_time=1 (double), step=2 (int64), summary=5} with one
    Summary.Value per (tag, value) pair."""
    event = _key(1, 1) + struct.pack("<d", wall_time)
    event += _key(2, 0) + _varint(int(step) & 0xFFFFFFFFFFFFFFFF)
    summary = b"".join(
        _bytes_field(1, _summary_value(tag, value))
        for tag, value in scalars
    )
    event += _bytes_field(5, summary)
    return event


def encode_file_version_event(wall_time):
    event = _key(1, 1) + struct.pack("<d", wall_time)
    return event + _bytes_field(3, b"brain.Event:2")


def frame_record(data):
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


class EventFileWriter:
    """Appends scalar events to one ``events.out.tfevents.*`` file.

    Thread-safe; writes are flushed per call (evaluation and scrape
    cadence, never the step loop)."""

    def __init__(self, logdir, filename_suffix=""):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir,
            "events.out.tfevents.%d.%s%s"
            % (int(time.time()), socket.gethostname(), filename_suffix),
        )
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write(encode_file_version_event(time.time()))

    def _write(self, event_bytes):
        self._f.write(frame_record(event_bytes))
        self._f.flush()

    def add_scalars(self, scalars, step, wall_time=None):
        """``scalars``: iterable of (tag, value); one Event per call."""
        scalars = list(scalars)
        if not scalars:
            return
        with self._lock:
            self._write(
                encode_scalar_event(
                    wall_time if wall_time is not None else time.time(),
                    step,
                    scalars,
                )
            )

    def add_scalar(self, tag, value, step, wall_time=None):
        self.add_scalars([(tag, value)], step, wall_time)

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_events(path):
    """Parse an event file back into [(wall_time, step, [(tag, value)])].

    The verification half of the round trip (tests, debugging); tolerates
    a torn final record the way TensorBoard's loader does — stop at the
    first incomplete frame."""
    events = []
    with open(path, "rb") as f:
        blob = f.read()
    off = 0
    while off + 12 <= len(blob):
        (length,) = struct.unpack_from("<Q", blob, off)
        if off + 12 + length + 4 > len(blob):
            break
        header = blob[off : off + 8]
        (len_crc,) = struct.unpack_from("<I", blob, off + 8)
        data = blob[off + 12 : off + 12 + length]
        (data_crc,) = struct.unpack_from("<I", blob, off + 12 + length)
        if (
            masked_crc32c(header) != len_crc
            or masked_crc32c(data) != data_crc
        ):
            raise ValueError("corrupt event record at offset %d" % off)
        events.append(_decode_event(data))
        off += 12 + length + 4
    return events


def _read_varint(buf, off):
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _decode_event(data):
    wall_time, step, scalars = 0.0, 0, []
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        field, wire = key >> 3, key & 7
        if wire == 1:  # 64-bit
            if field == 1:
                (wall_time,) = struct.unpack_from("<d", data, off)
            off += 8
        elif wire == 0:  # varint
            value, off = _read_varint(data, off)
            if field == 2:
                step = value
        elif wire == 5:  # 32-bit
            off += 4
        elif wire == 2:  # length-delimited
            length, off = _read_varint(data, off)
            if field == 5:
                scalars = _decode_summary(data[off : off + length])
            off += length
        else:
            raise ValueError("unsupported wire type %d" % wire)
    return wall_time, step, scalars


def _decode_summary(data):
    scalars = []
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        if key >> 3 == 1 and key & 7 == 2:
            length, off = _read_varint(data, off)
            scalars.append(_decode_value(data[off : off + length]))
            off += length
        else:
            raise ValueError("unexpected Summary field")
    return scalars


def _decode_value(data):
    tag, value = "", 0.0
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            length, off = _read_varint(data, off)
            tag = data[off : off + length].decode("utf-8")
            off += length
        elif field == 2 and wire == 5:
            (value,) = struct.unpack_from("<f", data, off)
            off += 4
        elif wire == 0:
            _, off = _read_varint(data, off)
        elif wire == 2:
            length, off = _read_varint(data, off)
            off += length
        elif wire == 5:
            off += 4
        elif wire == 1:
            off += 8
        else:
            raise ValueError("unsupported wire type %d" % wire)
    return tag, value
