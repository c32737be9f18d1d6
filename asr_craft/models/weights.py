"""Flat lambda-vector weight files.

The reference stores the model as a single flat ``double*`` lambda vector
written/read as a raw binary file per epoch (``CRF_Model`` read/write —
SURVEY.md §2.1, §3.5).  For parity and interchange, this module defines the
canonical flat ordering of the parameter pytree (names sorted, row-major
within each array) and raw-float64 + ``.npz`` formats.
"""
from __future__ import annotations

import numpy as np

from asr_craft.models.feature_map import FeatureMapConfig


def flatten_params(cfg: FeatureMapConfig, params: dict) -> np.ndarray:
    """Canonical flat float64 lambda vector (names sorted alphabetically)."""
    shapes = cfg.param_shapes()
    missing = set(shapes) - set(params)
    if missing:
        raise ValueError(f"params missing {sorted(missing)}")
    return np.concatenate([
        np.asarray(params[name], dtype=np.float64).reshape(-1)
        for name in sorted(shapes)
    ])


def unflatten_params(cfg: FeatureMapConfig, flat: np.ndarray,
                     dtype=np.float32) -> dict:
    shapes = cfg.param_shapes()
    if flat.size != cfg.num_params():
        raise ValueError(
            f"weight vector has {flat.size} entries, config needs "
            f"{cfg.num_params()}")
    out, off = {}, 0
    for name in sorted(shapes):
        n = int(np.prod(shapes[name]))
        out[name] = flat[off:off + n].reshape(shapes[name]).astype(dtype)
        off += n
    return out


def save_raw(path, cfg: FeatureMapConfig, params: dict) -> None:
    """Raw little-endian float64 flat file — the reference's on-disk format."""
    flatten_params(cfg, params).astype("<f8").tofile(path)


def load_raw(path, cfg: FeatureMapConfig) -> dict:
    flat = np.fromfile(path, dtype="<f8")
    return unflatten_params(cfg, flat)


def save_npz(path, params: dict) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
