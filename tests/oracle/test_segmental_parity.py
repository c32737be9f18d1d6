"""Segmental (SCRF) jnp scans vs the NumPy oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft import ops
from asr_craft.ops import oracle

TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("T,L,Dmax,length", [
    (1, 2, 1, 1), (4, 3, 2, 4), (6, 2, 3, 5), (8, 4, 4, 8), (5, 3, 8, 5),
])
def test_segmental_forward_matches_oracle(rng, T, L, Dmax, length):
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    alphas, logZ = ops.segmental_forward(jnp.asarray(seg), jnp.asarray(trans), length)
    ref_alphas, ref_logZ = oracle.segmental_forward_np(seg, trans, length, Dmax)
    np.testing.assert_allclose(np.asarray(alphas)[:length], ref_alphas, **TOL)
    np.testing.assert_allclose(np.asarray(logZ), ref_logZ, **TOL)


@pytest.mark.parametrize("T,L,Dmax,length", [(4, 2, 2, 4), (7, 3, 3, 6), (6, 4, 6, 6)])
def test_segmental_viterbi_matches_oracle(rng, T, L, Dmax, length):
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    starts, labels, n, score = ops.segmental_viterbi(
        jnp.asarray(seg), jnp.asarray(trans), length)
    ref_segs, ref_score = oracle.segmental_viterbi_np(seg, trans, length, Dmax)
    np.testing.assert_allclose(np.asarray(score), ref_score, **TOL)
    n = int(n)
    got = [(int(starts[i]), int(labels[i])) for i in range(n)]
    ref = [(a, l) for (a, b, l) in ref_segs]
    assert got == ref


def test_segmental_frame_dep_trans(rng):
    T, L, Dmax = 5, 3, 2
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(T, L, L)).astype(np.float32)
    _, logZ = ops.segmental_forward(jnp.asarray(seg), jnp.asarray(trans), T)
    _, ref = oracle.segmental_forward_np(seg, trans, T, Dmax)
    np.testing.assert_allclose(np.asarray(logZ), ref, **TOL)


def test_segmental_padding_invariance(rng):
    T, L, Dmax, pad = 6, 3, 3, 5
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    seg_p = np.concatenate(
        [seg, rng.normal(size=(pad, Dmax, L)).astype(np.float32)])
    trans = rng.normal(size=(L, L)).astype(np.float32)
    _, z1 = ops.segmental_forward(jnp.asarray(seg), jnp.asarray(trans), T)
    _, z2 = ops.segmental_forward(jnp.asarray(seg_p), jnp.asarray(trans), T)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z2), rtol=1e-6)


def test_segments_to_frames():
    starts = jnp.asarray([0, 3, 5, 0, 0])
    labels = jnp.asarray([7, 2, 9, 0, 0])
    frames = ops.segments_to_frames(starts, labels, 3, 8, 8)
    np.testing.assert_array_equal(
        np.asarray(frames), [7, 7, 7, 2, 2, 9, 9, 9])


def test_segmental_batch(rng):
    B, T, L, Dmax = 3, 6, 3, 2
    seg = rng.normal(size=(B, T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lengths = np.array([6, 2, 4])
    _, logZs = ops.segmental_forward_batch(
        jnp.asarray(seg), jnp.asarray(trans), jnp.asarray(lengths))
    for b in range(B):
        _, ref = oracle.segmental_forward_np(seg[b], trans, lengths[b], Dmax)
        np.testing.assert_allclose(np.asarray(logZs)[b], ref, **TOL)
