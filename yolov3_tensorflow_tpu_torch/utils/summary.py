"""Scalar metric logging: JSONL always, TensorBoard event files natively,
copied from the JAX package's `utils/summary.py` (a test holds the bytes it
writes equal to the original's).

A minimal writer emitting the TFRecord-framed Event protobuf stream that
TensorBoard reads (varint-encoded protos + masked CRC32C framing), with no
TensorFlow dependency, plus a JSONL mirror that is trivially
machine-readable.
"""

from __future__ import annotations

import json
import os
import struct
import time
# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for tensorboard Event/Summary messages.
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    sv = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    # Summary{ value=1 repeated }
    summary = _pb_bytes(1, sv)
    # Event{ wall_time=1 (double), step=2 (int64), summary=5 }
    return (_pb_double(1, wall_time) + _pb_int(2, int(step))
            + _pb_bytes(5, summary))


def _file_version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3 (string) }
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


class NullSummaryWriter:
    """No-op writer (for a process that must not write logs)."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class SummaryWriter:
    """Write scalars to a TensorBoard event file and a JSONL mirror."""

    def __init__(self, log_dir: str, jsonl: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        stamp = int(time.time())
        self._event_path = os.path.join(
            log_dir, f"events.out.tfevents.{stamp}.yolov3tpu")
        self._events = open(self._event_path, "ab")
        self._write_record(_file_version_event(time.time()))
        self._jsonl = (open(os.path.join(log_dir, "metrics.jsonl"), "a")
                       if jsonl else None)

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._events.write(header)
        self._events.write(struct.pack("<I", _masked_crc(header)))
        self._events.write(payload)
        self._events.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        now = time.time()
        self._write_record(_scalar_event(tag, value, step, now))
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": now}) + "\n")

    def flush(self) -> None:
        self._events.flush()
        if self._jsonl:
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._events.close()
        if self._jsonl:
            self._jsonl.close()
