"""Build the host-side C++ libraries (``native/*.cpp``) on first use.

A library is named after a hash of its source, the compiler flags and the
host it is built on (``native/lib<name>-<key>.so``), so a changed source
or flag, or a checkout copied to another machine, builds afresh instead of
loading a stale library.  Because the host is in the key, ``-march=native``
is safe: the machine that builds a library is the one that loads it.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
CXX = os.environ.get("CXX", "g++")
# -march=native: the decoders are host-side latency paths (about 10% on
# the 5k-word dynamic word decode)
CXXFLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17", "-fPIC",
            "-Wall", "-shared")


def _host_id() -> str:
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = "".join(ln for ln in f
                          if ln.startswith(("model name", "flags")))
    except OSError:
        pass
    return "|".join((platform.node(), platform.machine(), cpu))


def library_path(name: str, source: str) -> str:
    """Where the library for ``source`` (a file in native/) lives."""
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((CXX,) + CXXFLAGS).encode())
    h.update(_host_id().encode())
    return os.path.join(NATIVE_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, source: str, timeout: float = 300.0) -> str:
    """Compile ``native/<source>`` unless its keyed library exists; returns
    the library path.  Concurrent builders each write a private file and
    rename it into place."""
    out = library_path(name, source)
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([CXX, *CXXFLAGS, os.path.join(NATIVE_DIR, source),
                        "-o", tmp], check=True, capture_output=True,
                       timeout=timeout)
        os.replace(tmp, out)
    return out
