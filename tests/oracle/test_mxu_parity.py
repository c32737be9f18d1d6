"""Matmul-formulation forward-backward vs the generic scan and the oracle:
values, posteriors, and custom-VJP gradients (fp32 parity bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft import ops
from asr_craft.ops import mxu, oracle

TOL = dict(rtol=5e-4, atol=5e-5)


def _batch(rng, B, T, L, scale=1.0):
    state = rng.normal(size=(B, T, L), scale=scale).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=scale).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return state, trans, lengths


@pytest.mark.parametrize("B,T,L", [(1, 1, 3), (3, 9, 5), (4, 17, 48), (2, 33, 7)])
def test_forward_mxu_matches_oracle(rng, B, T, L):
    state, trans, lengths = _batch(rng, B, T, L)
    alphas, logZ = mxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                                   jnp.asarray(lengths))
    for b in range(B):
        ref_a, ref_z = oracle.forward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(alphas)[b, :lengths[b]], ref_a, **TOL)
        np.testing.assert_allclose(np.asarray(logZ)[b], ref_z, **TOL)


def test_forward_mxu_large_potentials(rng):
    """Rescaling must keep things finite for large potential magnitudes."""
    state, trans, lengths = _batch(rng, 2, 50, 10, scale=20.0)
    _, logZ = mxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                              jnp.asarray(lengths))
    for b in range(2):
        _, ref = oracle.forward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(logZ)[b], ref, rtol=2e-3)


def test_forward_mxu_masked_trans(rng):
    """Topology NEG_INF masks flow through the exp formulation."""
    from asr_craft.models.topology import Topology
    topo = Topology(num_labels=3, num_states=2)
    state = rng.normal(size=(2, 12, 6)).astype(np.float32)
    trans = (rng.normal(size=(6, 6)).astype(np.float32)
             + topo.transition_penalty())
    lengths = np.asarray([12, 7], np.int32)
    _, logZ = mxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                              jnp.asarray(lengths))
    for b in range(2):
        _, ref = oracle.forward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(logZ)[b], ref, **TOL)


def test_posteriors_mxu_matches_oracle(rng):
    B, T, L = 3, 11, 6
    state, trans, lengths = _batch(rng, B, T, L)
    gamma = mxu.posteriors_mxu(jnp.asarray(state), jnp.asarray(trans),
                               jnp.asarray(lengths))
    for b in range(B):
        ref = oracle.posteriors_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(gamma)[b, :lengths[b]], ref, **TOL)
        np.testing.assert_array_equal(np.asarray(gamma)[b, lengths[b]:], 0.0)


def test_custom_vjp_matches_expected_counts(rng):
    B, T, L = 3, 8, 5
    state, trans, lengths = _batch(rng, B, T, L)

    def f(s, t):
        return jnp.sum(mxu.log_partition_mxu(s, t, jnp.asarray(lengths)))

    gs, gt = jax.grad(f, argnums=(0, 1))(jnp.asarray(state), jnp.asarray(trans))
    xi_total = np.zeros((L, L))
    for b in range(B):
        gamma_ref, xi_ref = oracle.expected_counts_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(gs)[b, :lengths[b]], gamma_ref,
                                   rtol=2e-3, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(gs)[b, lengths[b]:], 0.0)
        xi_total += xi_ref
    np.testing.assert_allclose(np.asarray(gt), xi_total, rtol=2e-3, atol=1e-5)


def test_custom_vjp_matches_generic_grad(rng):
    """Matmul custom VJP vs autodiff-through-scan on the same loss."""
    B, T, L = 2, 10, 4
    state, trans, lengths = _batch(rng, B, T, L)
    s, t, n = jnp.asarray(state), jnp.asarray(trans), jnp.asarray(lengths)

    def loss_mxu(s, t):
        return jnp.mean(mxu.log_partition_mxu(s, t, n))

    def loss_gen(s, t):
        return jnp.mean(ops.log_partition_batch(s, t, n))

    v1, g1 = jax.value_and_grad(loss_mxu, argnums=(0, 1))(s, t)
    v2, g2 = jax.value_and_grad(loss_gen, argnums=(0, 1))(s, t)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-5)


def test_vjp_weighted_cotangent(rng):
    """Non-uniform per-sequence cotangents (the loss weights sequences)."""
    B, T, L = 3, 7, 4
    state, trans, lengths = _batch(rng, B, T, L)
    s, t, n = jnp.asarray(state), jnp.asarray(trans), jnp.asarray(lengths)
    w = jnp.asarray([1.0, -2.0, 0.5])

    def f_mxu(s, t):
        return jnp.sum(w * mxu.log_partition_mxu(s, t, n))

    def f_gen(s, t):
        return jnp.sum(w * ops.log_partition_batch(s, t, n))

    g1 = jax.grad(f_mxu, argnums=(0, 1))(s, t)
    g2 = jax.grad(f_gen, argnums=(0, 1))(s, t)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-5)
