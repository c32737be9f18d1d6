"""Dense and sparse feature maps vs direct NumPy computation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.models.feature_map import (FeatureMapConfig,
                                          dense_potentials,
                                          sparse_potentials)


def test_param_shapes_and_count():
    cfg = FeatureMapConfig(feat_dim=10, num_expanded=4,
                           state_range=(0, 6), trans_range=(6, 10))
    shapes = cfg.param_shapes()
    assert shapes == {"w_state": (6, 4), "b_state": (4,),
                      "w_trans": (4, 4, 4), "b_trans": (4, 4)}
    assert cfg.num_params() == 24 + 4 + 64 + 16


def test_bias_only_transitions():
    cfg = FeatureMapConfig(feat_dim=5, num_expanded=3)
    assert not cfg.frame_dependent_trans
    assert set(cfg.param_shapes()) == {"w_state", "b_state", "b_trans"}


def test_dense_matches_manual(rng):
    B, T, D, L = 2, 7, 10, 4
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=L,
                           state_range=(0, 6), trans_range=(6, 10))
    params = cfg.init_params(jax.random.PRNGKey(1), scale=0.5)
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    state, trans = dense_potentials(cfg, params, jnp.asarray(feats))
    assert state.shape == (B, T, L) and trans.shape == (B, T, L, L)
    ref_state = feats[..., :6] @ np.asarray(params["w_state"]) + np.asarray(params["b_state"])
    ref_trans = (np.einsum("btd,dpl->btpl", feats[..., 6:], np.asarray(params["w_trans"]))
                 + np.asarray(params["b_trans"]))
    np.testing.assert_allclose(np.asarray(state), ref_state, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(trans), ref_trans, rtol=1e-5, atol=1e-5)


def test_no_biases():
    cfg = FeatureMapConfig(feat_dim=4, num_expanded=3, trans_range=(0, 4),
                           use_state_bias=False, use_trans_bias=False)
    assert set(cfg.param_shapes()) == {"w_state", "w_trans"}


def test_sparse_matches_dense_one_hot(rng):
    """A sparse frame with explicit (index, value) pairs must score the same
    as the equivalent dense frame."""
    B, T, D, L, K = 2, 5, 8, 3, 4
    cfg_d = FeatureMapConfig(feat_dim=D, num_expanded=L,
                             state_range=(0, 5), trans_range=(5, 8))
    cfg_s = FeatureMapConfig(feat_dim=D, num_expanded=L, kind="sparse",
                             state_range=(0, 5), trans_range=(5, 8))
    params = cfg_d.init_params(jax.random.PRNGKey(2), scale=0.3)
    # random sparse frames: K distinct dims active per frame
    idx = np.stack([np.stack([
        np.sort(rng.choice(D, size=K, replace=False)) for _ in range(T)])
        for _ in range(B)]).astype(np.int32)
    val = rng.normal(size=(B, T, K)).astype(np.float32)
    dense = np.zeros((B, T, D), np.float32)
    for b in range(B):
        for t in range(T):
            dense[b, t, idx[b, t]] = val[b, t]
    s_d, t_d = dense_potentials(cfg_d, params, jnp.asarray(dense))
    s_s, t_s = sparse_potentials(cfg_s, params, jnp.asarray(idx), jnp.asarray(val))
    np.testing.assert_allclose(np.asarray(s_s), np.asarray(s_d), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_d), rtol=1e-5, atol=1e-5)


def test_bad_ranges_raise():
    with pytest.raises(ValueError):
        FeatureMapConfig(feat_dim=4, num_expanded=2, state_range=(2, 6))
