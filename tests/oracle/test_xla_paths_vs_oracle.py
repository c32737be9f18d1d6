"""The XLA recursions of configs 1/3/4/5 held to the float64 NumPy oracle
(ops/oracle.py) and to the dense materialized paths: shared-transition
alpha/beta passes (ops/mxu.py), Viterbi with both beam modes
(ops/viterbi.py), the dual-lattice objective, and the streaming segmental
lattice (ops/segmental_stream.py) — ragged lengths, n-state topologies,
label widths up to 144, Dmax windows, and dead or empty rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.models.topology import Topology
from asr_craft.ops import mxu, oracle
from asr_craft.ops.mxu import _clamp_penalty
from asr_craft.ops.semiring import NEG_INF
from asr_craft.ops.viterbi import viterbi_batch

TOL = dict(rtol=5e-4, atol=5e-5)


def _problem(rng, B, T, L):
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return state, trans, lengths


@pytest.mark.parametrize("B,T,L", [(2, 5, 4), (3, 12, 48), (8, 7, 128),
                                   (5, 9, 144)])
def test_mxu_forward_matches_oracle(rng, B, T, L):
    state, trans, lengths = _problem(rng, B, T, L)
    alphas, logZ = mxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                                   jnp.asarray(lengths))
    for b in range(B):
        ref_a, ref_z = oracle.forward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(alphas)[b, :lengths[b]],
                                   ref_a, **TOL)
        np.testing.assert_allclose(np.asarray(logZ)[b], ref_z, **TOL)


@pytest.mark.parametrize("B,T,L", [(2, 6, 4), (3, 10, 48), (4, 8, 144)])
def test_mxu_backward_matches_oracle(rng, B, T, L):
    state, trans, lengths = _problem(rng, B, T, L)
    betas = mxu._backward_any(jnp.asarray(state), jnp.asarray(trans),
                              jnp.asarray(lengths))
    for b in range(B):
        ref_b = oracle.backward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(betas)[:lengths[b], b],
                                   ref_b, **TOL)
        # past the row's end beta holds the semiring one (zero)
        np.testing.assert_array_equal(np.asarray(betas)[lengths[b]:, b], 0.0)


def test_mxu_forward_with_topology_mask(rng):
    topo = Topology(num_labels=4, num_states=3)
    L = topo.num_expanded
    state = rng.normal(size=(2, 9, L)).astype(np.float32)
    trans = (rng.normal(size=(L, L)).astype(np.float32)
             + topo.transition_penalty())
    lengths = np.asarray([9, 6], np.int32)
    _, logZ = mxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                              jnp.asarray(lengths))
    for b in range(2):
        _, ref = oracle.forward_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(logZ)[b], ref, **TOL)


@pytest.mark.parametrize("B,T,L", [(2, 6, 4), (3, 11, 48), (4, 9, 144)])
def test_viterbi_matches_oracle(rng, B, T, L):
    state, trans, lengths = _problem(rng, B, T, L)
    path, score = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                                jnp.asarray(lengths))
    assert path.shape == (B, T)
    for b in range(B):
        ref_path, ref_score = oracle.viterbi_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(score)[b], ref_score, **TOL)
        np.testing.assert_array_equal(np.asarray(path)[b, :lengths[b]],
                                      ref_path)


def test_viterbi_beam_threshold_bounds(rng):
    """A huge threshold equals exact search; a tiny one returns a valid,
    no-better path."""
    B, T, L = 2, 8, 6
    s, t, n = map(jnp.asarray, _problem(rng, B, T, L))
    p_exact, s_exact = viterbi_batch(s, t, n)
    p_wide, s_wide = viterbi_batch(s, t, n, beam_threshold=1e9)
    np.testing.assert_array_equal(np.asarray(p_exact), np.asarray(p_wide))
    np.testing.assert_allclose(np.asarray(s_exact), np.asarray(s_wide))
    p_nar, s_nar = viterbi_batch(s, t, n, beam_threshold=0.5)
    assert (np.asarray(s_nar) <= np.asarray(s_exact) + 1e-5).all()
    assert 0 <= np.asarray(p_nar).min() and np.asarray(p_nar).max() < L


def test_viterbi_topology_paths_are_legal(rng):
    topo = Topology(num_labels=3, num_states=2)
    L = topo.num_expanded
    state = rng.normal(size=(2, 10, L)).astype(np.float32)
    trans = (rng.normal(size=(L, L)).astype(np.float32)
             + topo.transition_penalty())
    lengths = np.asarray([10, 7], np.int32)
    path, _ = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                            jnp.asarray(lengths))
    mask = topo.transition_mask()
    p = np.asarray(path)
    for b in range(2):
        for t in range(1, int(lengths[b])):
            assert mask[p[b, t - 1], p[b, t]]


@pytest.mark.parametrize("P,NS,B,T", [(3, 2, 2, 10), (48, 3, 3, 17),
                                      (5, 4, 2, 9)])
def test_viterbi_nstate_matches_oracle(rng, P, NS, B, T):
    topo = Topology(num_labels=P, num_states=NS)
    L = topo.num_expanded
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    state[:, 0] += topo.start_penalty()
    trans = (rng.normal(size=(L, L)).astype(np.float32)
             + topo.transition_penalty())
    lengths = rng.integers(NS, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    path, score = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                                jnp.asarray(lengths))
    for b in range(B):
        ref_path, ref_score = oracle.viterbi_np(state[b], trans, lengths[b])
        np.testing.assert_allclose(np.asarray(score)[b], ref_score, **TOL)
        np.testing.assert_array_equal(np.asarray(path)[b, :lengths[b]],
                                      ref_path)


def _beam_viterbi_np(state, trans, n, k):
    """Top-k (max-active) beam Viterbi in float64: every frame, the first
    one included, keeps the labels scoring at least the k-th best."""
    def prune(d):
        kth = np.sort(d)[::-1][k - 1]
        return np.where(d >= kth, d, NEG_INF)

    state, trans = state.astype(np.float64), trans.astype(np.float64)
    delta = prune(state[0])
    for t in range(1, n):
        delta = prune(np.max(delta[:, None] + trans, axis=0) + state[t])
    return float(np.max(delta))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_viterbi_beam_width_matches_reference(rng, k):
    B, T, L = 3, 9, 12
    state, trans, lengths = _problem(rng, B, T, L)
    _, score = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                             jnp.asarray(lengths), beam_width=k)
    for b in range(B):
        np.testing.assert_allclose(
            np.asarray(score)[b],
            _beam_viterbi_np(state[b], trans, lengths[b], k), **TOL)


def _dual_problem(rng, B, T, L, ns):
    state, trans, lengths = _problem(rng, B, T, L)
    run = ns + 1
    labels = np.repeat(rng.integers(0, L // ns, size=(B, T // run + 1)),
                       run, axis=1)[:, :T].astype(np.int32)
    return (jnp.asarray(state), jnp.asarray(trans), jnp.asarray(labels),
            jnp.asarray(lengths))


@pytest.mark.parametrize("ns", [1, 2])
def test_nll_dual_value_and_grad_match_two_pass(rng, ns):
    B, T, L = 3, 11, 6
    state, trans, labels, lengths = _dual_problem(rng, B, T, L, ns)

    def loss_dual(s, t):
        return jnp.sum(mxu.nll_dual(s, t, labels, lengths, ns)[0])

    def loss_ref(s, t):
        zf = mxu.log_partition_mxu(s, t, lengths)
        zc = mxu.log_partition_mxu(s + _clamp_penalty(labels, L, ns), t,
                                   lengths)
        return jnp.sum(zf - zc)

    v1, g1 = jax.value_and_grad(loss_dual, argnums=(0, 1))(state, trans)
    v2, g2 = jax.value_and_grad(loss_ref, argnums=(0, 1))(state, trans)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-3, atol=2e-5)


def test_nll_dual_weighted_outputs_grad(rng):
    """Cotangents flowing through all three outputs (nll, logZ, num)."""
    B, T, L = 2, 8, 4
    state, trans, labels, lengths = _dual_problem(rng, B, T, L, 1)

    def f_dual(s):
        nll, zf, zc = mxu.nll_dual(s, trans, labels, lengths, 1)
        return jnp.sum(nll * 2.0 + zf * 0.5 - zc * 0.25)

    def f_ref(s):
        zf = mxu.log_partition_mxu(s, trans, lengths)
        zc = mxu.log_partition_mxu(s + _clamp_penalty(labels, L, 1), trans,
                                   lengths)
        return jnp.sum((zf - zc) * 2.0 + zf * 0.5 - zc * 0.25)

    np.testing.assert_allclose(np.asarray(jax.grad(f_dual)(state)),
                               np.asarray(jax.grad(f_ref)(state)),
                               rtol=3e-3, atol=2e-5)


def _seg_setup(rng, B, T, D, L, Dmax, **kw):
    from asr_craft.models.segmental import SegCrfConfig
    cfg = SegCrfConfig(num_labels=L, feat_dim=D, max_dur=Dmax, **kw)
    params = cfg.init_params(jax.random.PRNGKey(0), scale=0.4)
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return cfg, params, feats, jnp.asarray(lengths)


def _seg_stream_logZ(cfg, params, feats, lengths):
    from asr_craft.models.segmental import _frame_scores_and_bias
    from asr_craft.ops.segmental_stream import seg_log_partition_stream
    frame, bias = _frame_scores_and_bias(cfg, params, feats)
    return seg_log_partition_stream(jnp.moveaxis(frame, 1, 0), bias,
                                    params["b_trans"], lengths, cfg.max_dur,
                                    cfg.pooling == "mean")


@pytest.mark.parametrize("B,T,D,L,Dmax", [
    (2, 6, 4, 3, 2), (3, 12, 5, 4, 4), (2, 10, 6, 48, 8), (4, 9, 4, 144, 3),
])
def test_seg_stream_matches_dense(rng, B, T, D, L, Dmax):
    from asr_craft.models.segmental import seg_potentials
    from asr_craft.ops import segmental as seg_ops
    cfg, params, feats, lengths = _seg_setup(rng, B, T, D, L, Dmax)
    seg, trans = seg_potentials(cfg, params, feats)
    _, logZ_ref = seg_ops.segmental_forward_batch(seg, trans, lengths)
    np.testing.assert_allclose(
        np.asarray(_seg_stream_logZ(cfg, params, feats, lengths)),
        np.asarray(logZ_ref), **TOL)


def test_seg_stream_sum_pooling(rng):
    from asr_craft.models.segmental import seg_potentials
    from asr_craft.ops import segmental as seg_ops
    cfg, params, feats, _ = _seg_setup(rng, 2, 8, 4, 5, 3, pooling="sum",
                                       use_dur_feature=False,
                                       use_seg_bias=False)
    lengths = jnp.asarray([8, 5], jnp.int32)
    seg, trans = seg_potentials(cfg, params, feats)
    _, logZ_ref = seg_ops.segmental_forward_batch(seg, trans, lengths)
    np.testing.assert_allclose(
        np.asarray(_seg_stream_logZ(cfg, params, feats, lengths)),
        np.asarray(logZ_ref), **TOL)


def test_seg_viterbi_stream_zero_length_rows(rng):
    """Length-0 rows return a NEG_INF score and no segments; the other
    rows match the dense materialized decode."""
    from asr_craft.models.segmental import (SegCrfConfig,
                                            _frame_scores_and_bias,
                                            scrf_decode_dense)
    from asr_craft.ops.segmental_stream import seg_viterbi_stream
    cfg = SegCrfConfig(num_labels=5, feat_dim=6, max_dur=4)
    params = cfg.init_params(jax.random.PRNGKey(12), scale=0.4)
    feats = jnp.asarray(rng.normal(size=(3, 11, 6)), jnp.float32)
    lengths = jnp.asarray([11, 0, 4], jnp.int32)
    frame, bias = _frame_scores_and_bias(cfg, params, feats)
    starts, labels, n, scores = seg_viterbi_stream(
        jnp.moveaxis(frame, 1, 0), bias, params["b_trans"], lengths,
        cfg.max_dur)
    assert float(scores[1]) <= NEG_INF * 0.5 and int(n[1]) == 0
    keep = jnp.asarray([0, 2])
    s2, l2, n2, sc2 = scrf_decode_dense(cfg, params, feats[keep],
                                        lengths[keep])
    np.testing.assert_allclose(np.asarray(scores)[[0, 2]], np.asarray(sc2),
                               rtol=1e-5, atol=1e-5)
    for i, b in enumerate((0, 2)):
        k = int(n2[i])
        assert int(n[b]) == k
        np.testing.assert_array_equal(np.asarray(starts)[b, :k],
                                      np.asarray(s2)[i, :k])
        np.testing.assert_array_equal(np.asarray(labels)[b, :k],
                                      np.asarray(l2)[i, :k])
