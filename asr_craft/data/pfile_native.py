"""ctypes bridge to the native pfile reader (native/pfile_io.cpp).

``read_pfile_fast`` mirrors :func:`asr_craft.data.pfile.read_pfile`
(the pure-Python fallback and correctness oracle) with an mmap'd C++ parse —
the QuickNet-stream-equivalent fast path for production corpora.
"""
from __future__ import annotations

import ctypes

import numpy as np

from asr_craft.data.pfile import PFile
from asr_craft.utils import native_build

_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(native_build.build("craftio", "pfile_io.cpp"))
    except Exception:
        _build_failed = True
        return None
    I, V = ctypes.c_int32, ctypes.c_void_p
    fp = np.ctypeslib.ndpointer(np.float32, flags="C")
    up = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.craft_pfile_open.restype = V
    lib.craft_pfile_open.argtypes = [ctypes.c_char_p]
    lib.craft_pfile_close.argtypes = [V]
    for name in ("num_sents", "num_features", "num_label_cols"):
        fn = getattr(lib, f"craft_pfile_{name}")
        fn.restype = I
        fn.argtypes = [V]
    lib.craft_pfile_sent_frames.restype = I
    lib.craft_pfile_sent_frames.argtypes = [V, I]
    lib.craft_pfile_read_sent.restype = I
    lib.craft_pfile_read_sent.argtypes = [V, I, fp, up]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_pfile_fast(path) -> PFile:
    lib = _load()
    if lib is None:
        raise RuntimeError("native pfile reader not built")
    h = lib.craft_pfile_open(str(path).encode())
    if not h:
        raise ValueError(f"cannot open pfile {path!r}")
    try:
        ns = lib.craft_pfile_num_sents(h)
        D = lib.craft_pfile_num_features(h)
        K = lib.craft_pfile_num_label_cols(h)
        features, labels = [], ([] if K else None)
        for s in range(ns):
            T = lib.craft_pfile_sent_frames(h, s)
            feats = np.empty((T, D), np.float32)
            labs = np.empty((T,), np.uint32)
            got = lib.craft_pfile_read_sent(h, s, feats, labs)
            if got != T:
                raise IOError(f"pfile sentence {s}: read {got} != {T}")
            features.append(feats)
            if K:
                labels.append(labs)
        return PFile(features, labels)
    finally:
        lib.craft_pfile_close(h)
