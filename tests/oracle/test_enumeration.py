"""Brute-force enumeration tests: the NumPy oracle itself is verified by
summing/maxing over all L**T paths on tiny problems (SURVEY.md §4.2 item 2).
Everything else in the framework is then held to the oracle."""
import numpy as np
import pytest

from asr_craft.ops import oracle
from tests.conftest import random_problem


@pytest.mark.parametrize("T,L", [(1, 1), (1, 3), (2, 2), (4, 3), (6, 2), (5, 4)])
@pytest.mark.parametrize("frame_dep", [False, True])
def test_logZ_matches_enumeration(rng, T, L, frame_dep):
    state, trans, _ = random_problem(rng, T, L, frame_dep)
    _, logZ = oracle.forward_np(state, trans, T)
    ref = oracle.enumerate_logZ_np(state, trans, T)
    np.testing.assert_allclose(logZ, ref, rtol=1e-10)


@pytest.mark.parametrize("T,L", [(1, 2), (3, 3), (5, 3), (6, 2)])
def test_viterbi_matches_enumeration(rng, T, L):
    state, trans, _ = random_problem(rng, T, L)
    path, score = oracle.viterbi_np(state, trans, T)
    ref_path, ref_score = oracle.enumerate_viterbi_np(state, trans, T)
    np.testing.assert_allclose(score, ref_score, rtol=1e-10)
    assert path == ref_path


def test_posteriors_sum_to_one(rng):
    state, trans, _ = random_problem(rng, 7, 5)
    gamma = oracle.posteriors_np(state, trans, 7)
    np.testing.assert_allclose(gamma.sum(axis=1), 1.0, rtol=1e-10)


def test_expected_state_counts_match_posteriors(rng):
    state, trans, _ = random_problem(rng, 6, 4)
    gamma, _ = oracle.expected_counts_np(state, trans, 6)
    ref = oracle.posteriors_np(state, trans, 6)
    np.testing.assert_allclose(gamma, ref, rtol=1e-10)


def test_logZ_at_least_best_path(rng):
    state, trans, _ = random_problem(rng, 8, 4)
    _, logZ = oracle.forward_np(state, trans, 8)
    _, best = oracle.viterbi_np(state, trans, 8)
    assert logZ >= best


@pytest.mark.parametrize("T,L,Dmax", [(1, 2, 1), (3, 2, 2), (4, 2, 3), (5, 3, 2), (4, 3, 4)])
def test_segmental_logZ_matches_enumeration(rng, T, L, Dmax):
    seg = rng.normal(size=(T, Dmax, L))
    trans = rng.normal(size=(L, L))
    _, logZ = oracle.segmental_forward_np(seg, trans, T, Dmax)
    ref = oracle.enumerate_segmental_logZ_np(seg, trans, T, Dmax)
    np.testing.assert_allclose(logZ, ref, rtol=1e-10)


def test_segmental_viterbi_covers_and_scores(rng):
    T, L, Dmax = 6, 3, 3
    seg = rng.normal(size=(T, Dmax, L))
    trans = rng.normal(size=(L, L))
    segs, score = oracle.segmental_viterbi_np(seg, trans, T, Dmax)
    # Segments must tile [0, T-1] contiguously.
    assert segs[0][0] == 0 and segs[-1][1] == T - 1
    for (a, b, _), (a2, b2, _) in zip(segs, segs[1:]):
        assert a2 == b + 1
    # Recomputed score matches.
    s = 0.0
    for i, (a, b, l) in enumerate(segs):
        s += seg[b, b - a, l]
        if i > 0:
            s += trans[segs[i - 1][2], l]
    np.testing.assert_allclose(s, score, rtol=1e-10)
    # Viterbi score <= logZ
    _, logZ = oracle.segmental_forward_np(seg, trans, T, Dmax)
    assert score <= logZ
