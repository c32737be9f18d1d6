"""Observability utilities: replication assertions, debug toggles,
profiler session smoke test."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.parallel import make_mesh, replicate_tree
from asr_craft.utils import diagnostics


def test_assert_replicated_passes_for_replicated():
    mesh = make_mesh(8)
    tree = replicate_tree(mesh, {"w": jnp.ones((4, 4))})
    diagnostics.assert_replicated(tree)  # no raise


def test_assert_replicated_detects_divergence():
    mesh = make_mesh(8)
    from jax.sharding import NamedSharding, PartitionSpec as P
    # a sharded (non-replicated) array whose shards differ — stands in for
    # diverged replicas
    x = jnp.arange(8.0)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    with pytest.raises(AssertionError):
        diagnostics.assert_replicated({"w": xs})


def test_grad_sync_hook_cadence():
    calls = []
    orig = diagnostics.assert_replicated
    diagnostics.assert_replicated = lambda t, **k: calls.append(1)
    try:
        hook = diagnostics.grad_sync_check_hook(every=3)
        for step in range(1, 10):
            hook(step, {})
    finally:
        diagnostics.assert_replicated = orig
    assert len(calls) == 3  # steps 3, 6, 9


def test_profiler_session_writes_trace(tmp_path):
    d = str(tmp_path / "trace")
    with diagnostics.profiler_session(d):
        with diagnostics.step_annotation("train", 0):
            jnp.sum(jnp.ones((8, 8))).block_until_ready()
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found, "no trace files written"


def test_profiler_session_noop():
    with diagnostics.profiler_session(None):
        pass


def test_debug_nans_toggle():
    diagnostics.enable_debug_nans(True)
    with pytest.raises(FloatingPointError):
        jnp.log(jnp.zeros(())) / jnp.zeros(())
    diagnostics.enable_debug_nans(False)


def test_deterministic_key():
    k1 = diagnostics.deterministic(7)
    k2 = diagnostics.deterministic(7)
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
