"""Sparse feature streams: (index, value) frames end-to-end.

The reference's ``CRF_StdSparseFeatureMap`` consumes QuickNet *sparse*
feature streams where each frame is a list of (dimension index, value)
pairs (SURVEY.md §2.1 "Sparse feature map").  This module provides the
batched data side of that capability:

- ``sparsify_frames``: top-K magnitude sparsification of dense frames into
  fixed-width ``(T, K)`` index/value tensors (lossless when K covers every
  non-zero — the dense<->sparse equivalence surface used by the tests).
- a simple binary container (``write_sparse_file`` / ``read_sparse_file``)
  for genuinely sparse corpora, standing in for QuickNet sparse streams
  (whose exact on-disk format is unrecoverable — reference mount empty,
  SURVEY.md §0): per utterance, fixed-width index/value matrices plus
  optional frame labels.

Fixed-width K (padding slots carry value 0.0) keeps shapes static for XLA;
the feature map treats zero-valued pairs as absent, so padding is inert.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"ACSP"
_VERSION = 1


def sparsify_frames(frames: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ``(T, D)`` frames -> (``indices (T, K) int32``,
    ``values (T, K) float32``) keeping the K largest-magnitude dims per
    frame.  Exact (densify round-trips) when every frame has <= K
    non-zeros, e.g. ``k >= D``."""
    frames = np.asarray(frames, np.float32)
    T, D = frames.shape
    k = min(k, D)
    # argpartition: top-k by |value| per row
    if k < D:
        part = np.argpartition(-np.abs(frames), k - 1, axis=1)[:, :k]
    else:
        part = np.broadcast_to(np.arange(D), (T, D)).copy()
    idx = np.sort(part, axis=1).astype(np.int32)
    val = np.take_along_axis(frames, idx, axis=1).astype(np.float32)
    # zero-valued slots are semantically absent; normalize their index to 0
    idx = np.where(val != 0.0, idx, 0).astype(np.int32)
    return idx, val


def densify(indices: np.ndarray, values: np.ndarray, feat_dim: int) -> np.ndarray:
    """Inverse of ``sparsify_frames`` (for tests): (T, K) pairs -> (T, D)."""
    T, K = indices.shape
    out = np.zeros((T, feat_dim), np.float32)
    rows = np.repeat(np.arange(T), K)
    np.add.at(out, (rows, indices.ravel()), values.ravel())
    return out


def write_sparse_file(path: str, utterances: Sequence[Tuple[np.ndarray, np.ndarray]],
                      feat_dim: int,
                      labels: Optional[Sequence[np.ndarray]] = None) -> None:
    """Write a sparse feature corpus.

    Layout (little-endian): magic 'ACSP', u32 version, u32 n_utts,
    u32 feat_dim, u32 has_labels; then per utterance u32 T, u32 K,
    indices (T*K) i32, values (T*K) f32, [labels (T) i32].
    """
    has_labels = labels is not None
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<IIII", _VERSION, len(utterances), feat_dim,
                            int(has_labels)))
        for u, (idx, val) in enumerate(utterances):
            idx = np.asarray(idx, np.int32)
            val = np.asarray(val, np.float32)
            T, K = idx.shape
            f.write(struct.pack("<II", T, K))
            f.write(idx.tobytes())
            f.write(val.tobytes())
            if has_labels:
                f.write(np.asarray(labels[u], np.int32).tobytes())


class SparseFeatureList(list):
    """List of (indices, values) utterance pairs carrying the dense
    dimensionality — drop-in for the dense feature list in the CLIs."""

    def __init__(self, items, feat_dim: int):
        super().__init__(items)
        self.feat_dim = feat_dim


class SparseCorpus:
    """``features``: SparseFeatureList of (indices, values) pairs;
    ``labels``: list of (T,) int32 arrays or None; ``feat_dim``: dense
    dimensionality."""

    def __init__(self, features, labels, feat_dim):
        self.features = SparseFeatureList(features, feat_dim)
        self.labels = labels
        self.feat_dim = feat_dim


def is_sparse_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def read_sparse_file(path: str) -> SparseCorpus:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a sparse feature file")
        version, n, feat_dim, has_labels = struct.unpack("<IIII", f.read(16))
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        feats, labels = [], ([] if has_labels else None)
        for _ in range(n):
            T, K = struct.unpack("<II", f.read(8))
            idx = np.frombuffer(f.read(4 * T * K), np.int32).reshape(T, K)
            val = np.frombuffer(f.read(4 * T * K), np.float32).reshape(T, K)
            feats.append((idx.copy(), val.copy()))
            if has_labels:
                labels.append(np.frombuffer(f.read(4 * T), np.int32).copy())
    return SparseCorpus(feats, labels, feat_dim)
