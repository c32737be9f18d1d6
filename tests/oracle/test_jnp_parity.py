"""jnp scan implementations vs the float64 NumPy oracle (fp32 tolerance —
the BASELINE.json parity bar), including padding-invariance and batching
properties (SURVEY.md §4.2 items 1, 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft import ops
from asr_craft.ops import oracle
from tests.conftest import random_problem

# fp32 scan vs fp64 loop accumulate in different orders; ~1e-4 relative is
# the realistic fp32 agreement level (BASELINE "allclose at fp32").
TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("T,L", [(1, 1), (1, 5), (7, 4), (20, 48), (64, 12)])
@pytest.mark.parametrize("frame_dep", [False, True])
def test_forward_matches_oracle(rng, T, L, frame_dep):
    state, trans, length = random_problem(rng, T, L, frame_dep)
    alphas, logZ = ops.forward(jnp.asarray(state), jnp.asarray(trans), length)
    ref_alphas, ref_logZ = oracle.forward_np(state, trans, length)
    np.testing.assert_allclose(np.asarray(alphas)[:length], ref_alphas, **TOL)
    np.testing.assert_allclose(np.asarray(logZ), ref_logZ, **TOL)


@pytest.mark.parametrize("T,L", [(1, 3), (9, 5), (16, 48)])
@pytest.mark.parametrize("frame_dep", [False, True])
def test_backward_and_posteriors_match_oracle(rng, T, L, frame_dep):
    state, trans, length = random_problem(rng, T, L, frame_dep)
    betas = ops.backward(jnp.asarray(state), jnp.asarray(trans), length)
    gamma = ops.posteriors(jnp.asarray(state), jnp.asarray(trans), length)
    np.testing.assert_allclose(
        np.asarray(betas)[:length], oracle.backward_np(state, trans, length), **TOL)
    np.testing.assert_allclose(
        np.asarray(gamma)[:length], oracle.posteriors_np(state, trans, length), **TOL)
    # padded rows are exactly zero
    np.testing.assert_array_equal(np.asarray(gamma)[length:], 0.0)


@pytest.mark.parametrize("T,L", [(1, 2), (8, 4), (15, 48)])
@pytest.mark.parametrize("frame_dep", [False, True])
def test_viterbi_matches_oracle(rng, T, L, frame_dep):
    state, trans, length = random_problem(rng, T, L, frame_dep)
    path, score = ops.viterbi(jnp.asarray(state), jnp.asarray(trans), length)
    ref_path, ref_score = oracle.viterbi_np(state, trans, length)
    np.testing.assert_allclose(np.asarray(score), ref_score, **TOL)
    np.testing.assert_array_equal(np.asarray(path)[:length], ref_path)


def test_path_score_matches_oracle(rng):
    T, L = 10, 6
    state, trans, length = random_problem(rng, T, L)
    labels = rng.integers(0, L, size=T)
    got = ops.path_score(jnp.asarray(state), jnp.asarray(trans),
                         jnp.asarray(labels), length)
    ref = oracle.path_score_np(state, trans, labels, length)
    np.testing.assert_allclose(np.asarray(got), ref, **TOL)


def test_padding_invariance(rng):
    """Adding padded frames must not change logZ, posteriors, or Viterbi."""
    T, L, pad = 9, 5, 7
    state, trans, _ = random_problem(rng, T, L)
    state_p = np.concatenate([state, rng.normal(size=(pad, L)).astype(np.float32)])
    s, sp = jnp.asarray(state), jnp.asarray(state_p)
    tr = jnp.asarray(trans)
    np.testing.assert_allclose(
        ops.log_partition(s, tr, T), ops.log_partition(sp, tr, T), rtol=1e-6)
    g1, g2 = ops.posteriors(s, tr, T), ops.posteriors(sp, tr, T)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2)[:T], rtol=1e-6, atol=1e-6)
    p1, _ = ops.viterbi(s, tr, T)
    p2, _ = ops.viterbi(sp, tr, T)
    np.testing.assert_array_equal(np.asarray(p1)[:T], np.asarray(p2)[:T])


def test_batch_of_one_equals_unbatched(rng):
    state, trans, length = random_problem(rng, 12, 7)
    s, tr = jnp.asarray(state), jnp.asarray(trans)
    logZ_b = ops.log_partition_batch(s[None], tr, jnp.asarray([length]))
    logZ = ops.log_partition(s, tr, length)
    np.testing.assert_allclose(np.asarray(logZ_b)[0], np.asarray(logZ), rtol=1e-6)


def test_batched_variable_lengths(rng):
    B, T, L = 4, 11, 6
    states = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lengths = np.array([1, 4, 11, 7])
    logZs = ops.log_partition_batch(
        jnp.asarray(states), jnp.asarray(trans), jnp.asarray(lengths))
    for b in range(B):
        _, ref = oracle.forward_np(states[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(logZs)[b], ref, **TOL)


def test_per_sequence_transitions(rng):
    B, T, L = 3, 6, 4
    states = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(B, T, L, L)).astype(np.float32)
    lengths = np.array([6, 3, 5])
    logZs = ops.log_partition_batch(
        jnp.asarray(states), jnp.asarray(trans), jnp.asarray(lengths))
    for b in range(B):
        _, ref = oracle.forward_np(states[b], trans[b], lengths[b])
        np.testing.assert_allclose(np.asarray(logZs)[b], ref, **TOL)


def test_long_sequence_no_underflow(rng):
    """T=2000 with large-ish potentials: logZ stays finite (max-subtracted
    logsumexp — SURVEY.md §7.3 item 1)."""
    T, L = 2000, 10
    state = rng.normal(size=(T, L), scale=5.0).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=5.0).astype(np.float32)
    logZ = ops.log_partition(jnp.asarray(state), jnp.asarray(trans), T)
    assert np.isfinite(np.asarray(logZ))


def test_masked_labels_all_neginf_row_safe():
    """An all-NEG_INF state row (fully masked frame) must not produce NaN."""
    T, L = 4, 3
    state = np.zeros((T, L), np.float32)
    state[2, :] = ops.NEG_INF
    trans = np.zeros((L, L), np.float32)
    logZ = ops.log_partition(jnp.asarray(state), jnp.asarray(trans), T)
    g = jax.grad(lambda s: ops.log_partition(s, jnp.asarray(trans), T))(
        jnp.asarray(state))
    assert np.isfinite(np.asarray(logZ)) or np.asarray(logZ) <= ops.NEG_INF / 2
    assert not np.any(np.isnan(np.asarray(g)))
