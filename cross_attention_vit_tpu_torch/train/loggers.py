"""Experiment loggers: CSV and TensorBoard, the reference's dual
CSVLogger/TensorBoardLogger setup (main_mist.py:183-184).

Port of ``cross_attention_vit_tpu/train/loggers.py``.  The JAX package writes
TensorBoard files through tensorboardX and does nothing without it; the card's
host has neither tensorboardX nor tensorboard, so this module writes the
scalar event files itself: TFRecord framing (length, masked CRC-32C, payload,
masked CRC-32C) around hand-encoded ``Event`` protobufs, the format
TensorBoard reads.

Under a process group only rank 0 writes: on every other rank both loggers
are made inert and create no file or directory.
"""

from __future__ import annotations

import csv
import os
import socket
import struct
import tempfile
import time
from pathlib import Path

from ..parallel.mesh import rank


class CSVLogger:
    """One metrics.csv per run: columns grow as new metric names appear.

    resume=True loads a pre-existing metrics.csv so a resumed run keeps its
    earlier rows (a replayed epoch replaces its row); the default starts
    fresh.  Every rewrite goes through a temp file and an atomic rename, so a
    kill mid-write never tears the file.  Inert on ranks other than 0."""

    def __init__(self, save_dir: str | Path, name: str, resume: bool = False):
        self.dir = Path(save_dir) / name
        self.path = self.dir / "metrics.csv"
        self._rows: list[dict] = []
        self._fields: list[str] = ["epoch"]
        self.active = rank() == 0
        if not self.active:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        if resume and self.path.exists():
            with open(self.path, newline="") as f:
                for row in csv.DictReader(f):
                    parsed = {k: (int(v) if k == "epoch" else float(v))
                              for k, v in row.items() if v not in ("", None)}
                    self._rows.append(parsed)
                    for k in parsed:
                        if k not in self._fields:
                            self._fields.append(k)

    def log_metrics(self, metrics: dict, epoch: int) -> None:
        if not self.active:
            return
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
        self._rows = [r for r in self._rows if r.get("epoch") != epoch]
        self._rows.append(row)
        self._rows.sort(key=lambda r: r.get("epoch", 0))
        fd, tmp = tempfile.mkstemp(suffix=".tmp.csv", dir=self.dir)
        with os.fdopen(fd, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)
        os.replace(tmp, self.path)

    def finalize(self) -> None:
        pass


# --- TensorBoard event files ---------------------------------------------------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _masked_crc(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    key = _varint(number << 3 | wire)
    if wire == 2:                                   # length-delimited
        return key + _varint(len(payload)) + payload
    return key + payload


def _event(step: int, wall_time: float, *, file_version: str | None = None,
           scalar: tuple[str, float] | None = None) -> bytes:
    """An ``Event`` protobuf: wall_time (1, double), step (2, int64), and
    file_version (3, string) or summary (5) holding one Summary.Value with a
    tag (1) and a simple_value (2, float)."""
    msg = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(step))
    if file_version is not None:
        msg += _field(3, 2, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        val = _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", value))
        msg += _field(5, 2, _field(1, 2, val))
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class TensorBoardLogger:
    """Scalars per epoch into ``<save_dir>/<name>/events.out.tfevents.*``;
    inert on ranks other than 0."""

    def __init__(self, save_dir: str | Path, name: str):
        self.dir = Path(save_dir) / name
        self._f = None
        if rank() != 0:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = self.dir / f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(0, now, file_version="brain.Event:2")))
        self._f.flush()

    def log_metrics(self, metrics: dict, epoch: int) -> None:
        if self._f is None:
            return
        now = time.time()
        for k, v in metrics.items():
            self._f.write(_record(_event(epoch, now, scalar=(k, float(v)))))
        self._f.flush()

    def finalize(self) -> None:
        if self._f is not None:
            self._f.close()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = loggers

    def log_metrics(self, metrics: dict, epoch: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, epoch)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()
