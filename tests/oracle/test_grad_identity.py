"""Gradient checks (SURVEY.md §4.2 item 3): jax.grad of logZ equals the
forward-backward expected counts (the quantity the reference accumulates in
``computeExpF``), and matches finite differences."""
import jax
import jax.numpy as jnp
import numpy as np

from asr_craft import ops
from asr_craft.ops import oracle
from tests.conftest import random_problem


def test_grad_logZ_equals_expected_counts(rng):
    T, L = 7, 4
    state, trans, length = random_problem(rng, T, L)
    gamma_ref, xi_ref = oracle.expected_counts_np(state, trans, length)

    gs, gt = jax.grad(
        lambda s, t: ops.log_partition(s, t, length), argnums=(0, 1)
    )(jnp.asarray(state), jnp.asarray(trans))
    np.testing.assert_allclose(np.asarray(gs)[:length], gamma_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(gs)[length:], 0.0)
    np.testing.assert_allclose(np.asarray(gt), xi_ref, rtol=2e-4, atol=2e-5)


def test_grad_matches_finite_differences(rng):
    T, L = 5, 3
    state, trans, length = random_problem(rng, T, L)
    s64 = state.astype(np.float64)

    def f(s):
        return float(oracle.forward_np(s, trans, length)[1])

    gs = jax.grad(lambda s: ops.log_partition(s, jnp.asarray(trans), length))(
        jnp.asarray(state))
    eps = 1e-5
    for (t, l) in [(0, 0), (2, 1), (length - 1, L - 1)]:
        sp = s64.copy(); sp[t, l] += eps
        sm = s64.copy(); sm[t, l] -= eps
        fd = (f(sp) - f(sm)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(gs)[t, l], fd, rtol=1e-3, atol=1e-4)


def test_loss_grad_is_expected_minus_observed(rng):
    """d(logZ - score(y))/d theta = E[f] - f_obs: the reference's gradient
    (``CRF_NewGradBuilder::buildGradient``) with sign flipped."""
    T, L = 6, 4
    state, trans, length = random_problem(rng, T, L)
    labels = rng.integers(0, L, size=T)

    def loss(s, t):
        return (ops.log_partition(s, t, length)
                - ops.path_score(s, t, jnp.asarray(labels), length))

    gs, gt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(state), jnp.asarray(trans))
    gamma, xi = oracle.expected_counts_np(state, trans, length)
    f_obs_state = np.zeros((T, L)); f_obs_trans = np.zeros((L, L))
    for t in range(length):
        f_obs_state[t, labels[t]] = 1.0
        if t > 0:
            f_obs_trans[labels[t - 1], labels[t]] += 1.0
    np.testing.assert_allclose(
        np.asarray(gs)[:length], gamma - f_obs_state[:length], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gt), xi - f_obs_trans, rtol=2e-4, atol=2e-5)


def test_segmental_grad_finite(rng):
    T, L, Dmax = 6, 3, 3
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)

    g = jax.grad(lambda s: ops.segmental_forward(s, jnp.asarray(trans), T)[1])(
        jnp.asarray(seg))
    assert not np.any(np.isnan(np.asarray(g)))
    # d logZ / d seg_score sums to expected number of segments — between 1
    # and T — and each (t,*) plane's mass equals P(some segment ends at t) <= 1.
    total = float(np.asarray(g).sum())
    assert 1.0 - 1e-4 <= total <= T + 1e-4
