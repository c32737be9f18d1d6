"""HTK feature-file and label I/O.

The reference reads HTK-format features/labels through QuickNet stream
classes (``QN_InFtrStream_HTK`` etc. — SURVEY.md §2.1 L0/L1).  The HTK
parameter-file format is public and simple: a 12-byte big-endian header
(nSamples u32, sampPeriod u32, sampSize u16, parmKind u16) followed by
``nSamples * sampSize`` bytes of big-endian float32 frames.

Label files are HTK text ``.lab`` (``start end name`` per line, 100ns units);
master label files (MLF) live in :mod:`asr_craft.data.mlf`.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

# parmKind base codes (HTK book) — stored for round-trip fidelity only.
PARM_KINDS = {
    "WAVEFORM": 0, "LPC": 1, "LPREFC": 2, "LPCEPSTRA": 3, "LPDELCEP": 4,
    "IREFC": 5, "MFCC": 6, "FBANK": 7, "MELSPEC": 8, "USER": 9,
    "DISCRETE": 10, "PLP": 11,
}
_E = 0o100  # has energy
_D = 0o400  # has deltas
_A = 0o1000  # has accelerations


def write_htk(path, feats: np.ndarray, samp_period: int = 100000,
              parm_kind: int = PARM_KINDS["USER"]) -> None:
    """Write (T, D) float32 features as a big-endian HTK parameter file."""
    feats = np.ascontiguousarray(feats, dtype=">f4")
    T, D = feats.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIHH", T, samp_period, D * 4, parm_kind))
        f.write(feats.tobytes())


def read_htk(path) -> Tuple[np.ndarray, int, int]:
    """Read an HTK parameter file. Returns (feats (T, D) float32,
    samp_period, parm_kind)."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        n, period, ssize, kind = struct.unpack(">IIHH", hdr)
        if ssize % 4:
            raise ValueError(f"sampSize {ssize} not float32-aligned")
        D = ssize // 4
        data = np.frombuffer(f.read(n * ssize), dtype=">f4")
    if data.size != n * D:
        raise ValueError(f"truncated HTK file: expected {n * D} values, "
                         f"got {data.size}")
    return data.reshape(n, D).astype(np.float32), period, kind


def read_htk_labels(path, frame_period: int = 100000) -> list:
    """Read an HTK ``.lab`` transcription: [(start_frame, end_frame, name)].

    Times are converted from 100ns units to frames of ``frame_period``.
    Lines may omit times entirely (name-only transcription) in which case
    frames are (-1, -1).
    """
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 3 and parts[0].lstrip("-").isdigit():
                s, e = int(parts[0]), int(parts[1])
                out.append((s // frame_period, e // frame_period, parts[2]))
            else:
                out.append((-1, -1, parts[0]))
    return out


def write_htk_labels(path, segments, frame_period: int = 100000) -> None:
    """Write [(start_frame, end_frame, name)] as an HTK ``.lab`` file."""
    with open(path, "w") as f:
        for s, e, name in segments:
            f.write(f"{s * frame_period} {e * frame_period} {name}\n")
