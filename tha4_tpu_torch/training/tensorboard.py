"""TensorBoard-compatible scalar logging (no TensorFlow dependency; a copy
of ``tha4_tpu/training/tensorboard.py``, which the port does not import).

The reference logs per-loss-term curves through a TensorBoard SummaryWriter
on rank 0 (reference:
src/tha4/shion/core/training/distrib/distributed_trainer.py:171-182 and
sum_loss.py:22-27).  This module writes the same artifact — a
``events.out.tfevents.*`` file TensorBoard can open directly — by encoding
the Event/Summary protobuf wire format and the TFRecord framing (length +
masked CRC32C) by hand; scalars only, which is all the reference ever wrote.

Also provides ``jsonl_to_tensorboard`` to convert this framework's JSONL
scalar logs (training/trainer.py) after the fact, and ``read_events`` (used
by tests) to parse the files back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        table = []
        for n in range(256):
            crc = n
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire encoding for Event { wall_time, step, file_version | summary }
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


def _field_double(num: int, value: float) -> bytes:
    return bytes([(num << 3) | 1]) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return bytes([(num << 3) | 5]) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return bytes([(num << 3) | 0]) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([(num << 3) | 2]) + _varint(len(payload)) + payload


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    return _field_bytes(1, tag.encode()) + _field_float(2, value)


def encode_scalar_event(wall_time: float, step: int, scalars: Dict[str, float]) -> bytes:
    # Summary { repeated Value value = 1; }
    summary = b"".join(_field_bytes(1, _summary_value(t, v)) for t, v in scalars.items())
    # Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
    return _field_double(1, wall_time) + _field_varint(2, step) + _field_bytes(5, summary)


def encode_file_version_event(wall_time: float) -> bytes:
    # Event { file_version = 3 }  — "brain.Event:2" is what TF writes.
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Scalar-only events.out.tfevents writer (reference SummaryWriter use)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(_record(encode_file_version_event(time.time())))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: Dict[str, float], step: int, wall_time: Optional[float] = None) -> None:
        wt = time.time() if wall_time is None else wall_time
        self._f.write(_record(encode_scalar_event(wt, step, scalars)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# Reader (tests / debugging) and the JSONL converter
# ---------------------------------------------------------------------------


def _decode_fields(data: bytes) -> Iterator[Tuple[int, int, bytes]]:
    i = 0
    while i < len(data):
        key = data[i]
        num, wire = key >> 3, key & 7
        i += 1
        if wire == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield num, wire, v.to_bytes(8, "little")
        elif wire == 1:
            yield num, wire, data[i : i + 8]
            i += 8
        elif wire == 5:
            yield num, wire, data[i : i + 4]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield num, wire, data[i : i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def read_events(path: str, validate_crc: bool = True) -> List[Dict]:
    """Parse an events file back into [{wall_time, step, scalars{}}...]."""
    out: List[Dict] = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        (len_crc,) = struct.unpack_from("<I", data, i + 8)
        payload = data[i + 12 : i + 12 + length]
        (payload_crc,) = struct.unpack_from("<I", data, i + 12 + length)
        if validate_crc:
            assert len_crc == _masked_crc(data[i : i + 8]), "length CRC mismatch"
            assert payload_crc == _masked_crc(payload), "payload CRC mismatch"
        i += 12 + length + 4

        event = {"wall_time": None, "step": 0, "scalars": {}, "file_version": None}
        for num, wire, val in _decode_fields(payload):
            if num == 1 and wire == 1:
                event["wall_time"] = struct.unpack("<d", val)[0]
            elif num == 2 and wire == 0:
                event["step"] = int.from_bytes(val, "little")
            elif num == 3 and wire == 2:
                event["file_version"] = val.decode()
            elif num == 5 and wire == 2:
                for vn, vw, vv in _decode_fields(val):
                    if vn == 1 and vw == 2:
                        tag = None
                        simple = None
                        for sn, sw, sv in _decode_fields(vv):
                            if sn == 1 and sw == 2:
                                tag = sv.decode()
                            elif sn == 2 and sw == 5:
                                simple = struct.unpack("<f", sv)[0]
                        if tag is not None and simple is not None:
                            event["scalars"][tag] = simple
        out.append(event)
    return out


def jsonl_to_tensorboard(jsonl_path: str, log_dir: Optional[str] = None) -> str:
    """Convert a trainer scalars.jsonl into a TensorBoard events file.

    Rows are {'loss': ..., 'examples_seen': N, ...}; examples_seen becomes
    the TB step (the reference's global progress unit)."""
    import json

    if log_dir is None:
        log_dir = os.path.dirname(jsonl_path)
    writer = SummaryWriter(log_dir)
    try:
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                step = int(row.pop("examples_seen", 0))
                wall = row.pop("wall_time", None)
                scalars = {k: float(v) for k, v in row.items() if isinstance(v, (int, float))}
                writer.add_scalars(scalars, step, wall)
    finally:
        writer.close()
    return writer.path
