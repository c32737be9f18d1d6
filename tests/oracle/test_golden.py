"""Golden-fixture parity (SURVEY.md §4.2 item 8): every compute path is held
to checked-in oracle tensors, catching silent numeric regressions."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft import ops
from asr_craft.ops import mxu

FIX = os.path.join(os.path.dirname(__file__), "..", "fixtures",
                   "golden_v1.npz")
TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIX) as z:
        return {k: z[k] for k in z.files}


def _mask(arr, lengths):
    out = np.array(arr)
    for b, n in enumerate(lengths):
        out[b, n:] = 0
    return out


def test_scan_path_matches_golden(golden):
    g = golden
    s, t, n = map(jnp.asarray, (g["state"], g["trans"], g["lengths"]))
    alphas, logZ = ops.forward_batch(s, t, n)
    np.testing.assert_allclose(np.asarray(logZ), g["logZ"], **TOL)
    np.testing.assert_allclose(
        _mask(np.asarray(alphas), g["lengths"]), _mask(g["alphas"],
                                                       g["lengths"]), **TOL)
    gam = ops.posteriors_batch(s, t, n)
    np.testing.assert_allclose(np.asarray(gam),
                               _mask(g["gammas"], g["lengths"]), **TOL)


def test_mxu_path_matches_golden(golden):
    g = golden
    s, t, n = map(jnp.asarray, (g["state"], g["trans"], g["lengths"]))
    alphas, logZ = mxu.forward_mxu(s, t, n)
    np.testing.assert_allclose(np.asarray(logZ), g["logZ"], **TOL)
    gam = mxu.posteriors_mxu(s, t, n)
    np.testing.assert_allclose(np.asarray(gam),
                               _mask(g["gammas"], g["lengths"]), **TOL)


def test_mxu_betas_match_golden(golden):
    g = golden
    s, t, n = map(jnp.asarray, (g["state"], g["trans"], g["lengths"]))
    betas = mxu._backward_any(s, t, n)
    b = np.asarray(jnp.moveaxis(betas, 0, 1))
    # golden betas are zero past each row's end and at its last frame —
    # mask both the same way
    np.testing.assert_allclose(_mask(b, g["lengths"]),
                               _mask(g["betas"], g["lengths"]), **TOL)


def test_viterbi_paths_match_golden(golden):
    g = golden
    s, t, n = map(jnp.asarray, (g["state"], g["trans"], g["lengths"]))
    paths, scores = ops.viterbi_batch(s, t, n)
    np.testing.assert_allclose(np.asarray(scores), g["vit_scores"], **TOL)
    for b, nn in enumerate(g["lengths"]):
        np.testing.assert_array_equal(np.asarray(paths)[b, :nn],
                                      g["vit_paths"][b, :nn])


def test_segmental_matches_golden(golden):
    g = golden
    seg, t, n = map(jnp.asarray, (g["seg"], g["trans"], g["lengths"]))
    _, logZ = ops.segmental_forward_batch(seg, t, n)
    np.testing.assert_allclose(np.asarray(logZ), g["seg_logZ"], **TOL)
