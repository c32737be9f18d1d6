"""Hypothesis property tests for the DP core (SURVEY.md §4.2 item 4)."""
import jax.numpy as jnp
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from asr_craft import ops

_settings = settings(max_examples=25, deadline=None)


def _problem(seed, T, L, scale):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(T, L), scale=scale).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=scale).astype(np.float32)
    return jnp.asarray(state), jnp.asarray(trans)


@_settings
@given(st.integers(0, 2**31 - 1), st.integers(1, 12), st.integers(1, 6),
       st.floats(0.1, 4.0))
def test_logZ_at_least_viterbi(seed, T, L, scale):
    state, trans = _problem(seed, T, L, scale)
    logZ = float(ops.log_partition(state, trans, T))
    _, best = ops.viterbi(state, trans, T)
    assert logZ >= float(best) - 1e-4


@_settings
@given(st.integers(0, 2**31 - 1), st.integers(1, 10), st.integers(1, 5),
       st.floats(-5.0, 5.0))
def test_shift_invariance_of_posteriors(seed, T, L, c):
    """Adding a constant to every state potential shifts logZ by T*c and
    leaves posteriors unchanged."""
    state, trans = _problem(seed, T, L, 1.0)
    z0 = float(ops.log_partition(state, trans, T))
    z1 = float(ops.log_partition(state + c, trans, T))
    np.testing.assert_allclose(z1, z0 + T * c, rtol=1e-4, atol=1e-3)
    g0 = np.asarray(ops.posteriors(state, trans, T))
    g1 = np.asarray(ops.posteriors(state + c, trans, T))
    np.testing.assert_allclose(g0, g1, rtol=2e-3, atol=1e-4)


@_settings
@given(st.integers(0, 2**31 - 1), st.integers(2, 10), st.integers(1, 5),
       st.integers(1, 6))
def test_padding_invariance_property(seed, T, L, pad):
    state, trans = _problem(seed, T + pad, L, 1.0)
    z_full = float(ops.log_partition(state[:T], trans, T))
    z_padded = float(ops.log_partition(state, trans, T))
    np.testing.assert_allclose(z_padded, z_full, rtol=1e-5, atol=1e-4)


@_settings
@given(st.integers(0, 2**31 - 1), st.integers(1, 8), st.integers(1, 4))
def test_viterbi_path_score_consistency(seed, T, L):
    """The returned score equals the explicit score of the returned path."""
    state, trans = _problem(seed, T, L, 1.0)
    path, score = ops.viterbi(state, trans, T)
    ref = float(ops.path_score(state, trans, path, T))
    np.testing.assert_allclose(float(score), ref, rtol=1e-5, atol=1e-4)


@_settings
@given(st.integers(0, 2**31 - 1), st.integers(2, 8), st.integers(2, 4),
       st.integers(1, 3))
def test_segmental_reduces_to_chain_at_dmax1(seed, T, L, _):
    """With Dmax=1 (all segments one frame) the SCRF logZ equals the
    linear-chain logZ over the same frame scores."""
    rng = np.random.default_rng(seed)
    frame = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    seg = frame[:, None, :]                        # (T, 1, L)
    _, z_seg = ops.segmental_forward(jnp.asarray(seg), jnp.asarray(trans), T)
    z_chain = ops.log_partition(jnp.asarray(frame), jnp.asarray(trans), T)
    np.testing.assert_allclose(float(z_seg), float(z_chain), rtol=1e-5,
                               atol=1e-4)
