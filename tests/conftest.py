"""Test configuration.

A plain ``pytest`` run forces an 8-device CPU platform before JAX starts a
backend: the forced host-platform device count lets ``tests/dist``
exercise real multi-device sharding without accelerators, and Pallas
kernels run with ``interpret=True``.

Tests marked ``gpu`` need an NVIDIA GPU and skip without one (the ``gpu``
fixture decides, at run time).  ``chip_smoke.py`` runs them in its own
process on the card: there JAX has already started the GPU backend when
this file is imported, and the platform is left as it is.
"""
import os

from jax._src import xla_bridge

FORCE_CPU = not xla_bridge.backends_are_initialized()
if FORCE_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if FORCE_CPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    if not FORCE_CPU:
        return
    devs = jax.devices()
    assert devs[0].platform == "cpu", f"tests must run on CPU, got {devs}"
    assert len(devs) == 8, f"expected 8 forced CPU devices, got {len(devs)}"


@pytest.fixture
def gpu():
    """Skip unless the default JAX device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_problem(rng, T, L, frame_dep_trans=False, scale=1.0, dtype=np.float32):
    """A random (state, trans, length) CRF problem with length <= T."""
    state = rng.normal(size=(T, L), scale=scale).astype(dtype)
    tshape = (T, L, L) if frame_dep_trans else (L, L)
    trans = rng.normal(size=tshape, scale=scale).astype(dtype)
    length = int(rng.integers(1, T + 1))
    return state, trans, length
