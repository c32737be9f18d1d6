"""Factored frame-dependent-transition path (ops/fdt.py) vs the generic
materialized-(B,T,L',L') scan: values, gradients, and Viterbi decode.

The factored lattice scores only topology-legal transitions; the generic
path scores all pairs with the topology NEG_INF penalty folded in — the two
must agree exactly (legal paths see identical scores)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.models.feature_map import FeatureMapConfig, dense_potentials
from asr_craft.models.topology import Topology
from asr_craft.ops import fdt, fwdbwd
from asr_craft.ops.semiring import NEG_INF
from asr_craft.ops.viterbi import viterbi_batch

TOL = dict(rtol=5e-4, atol=5e-5)


def _problem(rng, B, T, P, ns, D=12, scale=0.3):
    Lp = P * ns
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=Lp,
                           trans_range=(2, D), state_range=(0, D - 1))
    params = cfg.init_params(jax.random.PRNGKey(0), scale=scale)
    # break symmetry with real randomness (init_params is deterministic)
    params = {k: jnp.asarray(rng.normal(size=v.shape, scale=scale),
                             jnp.float32) for k, v in params.items()}
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    labels = jnp.asarray(
        np.repeat(rng.integers(0, P, size=(B, T // (ns + 1) + 1)),
                  ns + 1, axis=1)[:, :T], jnp.int32)
    lengths = rng.integers(max(ns, 1), T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return cfg, params, feats, labels, jnp.asarray(lengths)


def _generic_pair(cfg, params, feats, labels, lengths, ns, boundaries=True):
    """Reference: dense potentials + topology penalty + generic scan."""
    topo = Topology(cfg.num_expanded // ns, ns)
    state, trans = dense_potentials(cfg, params, feats)
    trans = trans + jnp.asarray(topo.transition_penalty())
    if ns > 1 and boundaries:
        T = state.shape[1]
        state = state.at[:, 0, :].add(jnp.asarray(topo.start_penalty()))
        at_end = (jnp.arange(T)[None, :] == (lengths - 1)[:, None])
        state = state + jnp.where(at_end[..., None],
                                  jnp.asarray(topo.end_penalty())[None, None],
                                  0.0)
    zf = fwdbwd.log_partition_batch(state, trans, lengths)
    clamp = topo.clamp_mask(labels)
    zc = fwdbwd.log_partition_batch(state + clamp, trans, lengths)
    return state, trans, zf, zc


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (3, 11, 5, 2),
                                      (2, 13, 4, 3)])
def test_logZ_pair_matches_generic(rng, B, T, P, ns):
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    state, selfp, advp, crossp = fdt.factored_planes(
        params, feats, cfg.num_expanded, ns, cfg.state_range,
        cfg.trans_range)
    zf, zc = fdt.fdt_logZ_pair(state, selfp, advp, crossp, labels, lengths,
                               ns, ns, True)
    _, _, zf_ref, zc_ref = _generic_pair(cfg, params, feats, labels,
                                         lengths, ns)
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zf_ref), **TOL)
    np.testing.assert_allclose(np.asarray(zc), np.asarray(zc_ref), **TOL)


@pytest.mark.parametrize("ns", [1, 3])
def test_nll_dual_grads_match_generic(rng, ns):
    B, T, P = 2, 8, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)

    def loss_fdt(p):
        nll, zf, zc = fdt.fdt_nll_dual(cfg, ns, p, feats, labels, lengths)
        return jnp.sum(nll * 2.0 + 0.25 * zf)

    def loss_gen(p):
        _, _, zf, zc = _generic_pair(cfg, p, feats, labels, lengths, ns)
        return jnp.sum((zf - zc) * 2.0 + 0.25 * zf)

    v1, g1 = jax.value_and_grad(loss_fdt)(params)
    v2, g2 = jax.value_and_grad(loss_gen)(params)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4, atol=1e-4)
    for k in params:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=3e-3, atol=3e-5, err_msg=k)


def test_illegal_pairs_get_zero_grad(rng):
    """The factored path's implicit topology = zero gradient exactly where
    the generic path's NEG_INF mask puts it."""
    ns, P = 2, 3
    cfg, params, feats, labels, lengths = _problem(rng, 2, 7, P, ns)

    def loss(p):
        nll, _, _ = fdt.fdt_nll_dual(cfg, ns, p, feats, labels, lengths)
        return jnp.sum(nll)

    g = jax.grad(loss)(params)["w_trans"]
    mask = Topology(P, ns).transition_mask()
    np.testing.assert_array_equal(np.asarray(g)[:, ~mask], 0.0)
    assert float(jnp.sum(jnp.abs(jnp.asarray(np.asarray(g)[:, mask])))) > 0


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (2, 12, 4, 3)])
def test_fdt_viterbi_matches_generic(rng, B, T, P, ns):
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    state, selfp, advp, crossp = fdt.factored_planes(
        params, feats, cfg.num_expanded, ns, cfg.state_range,
        cfg.trans_range)
    paths, scores = fdt.fdt_viterbi(state, selfp, advp, crossp, lengths, ns)
    state_b, trans, _, _ = _generic_pair(cfg, params, feats, labels, lengths,
                                         ns)
    ref_paths, ref_scores = viterbi_batch(state_b, trans, lengths)
    np.testing.assert_allclose(np.asarray(scores), np.asarray(ref_scores),
                               **TOL)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(paths)[b, :n],
                                      np.asarray(ref_paths)[b, :n])


def test_fdt_viterbi_beam_exact_when_wide(rng):
    B, T, P, ns = 2, 10, 4, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    state, selfp, advp, crossp = fdt.factored_planes(
        params, feats, cfg.num_expanded, ns, cfg.state_range,
        cfg.trans_range)
    exact, sc = fdt.fdt_viterbi(state, selfp, advp, crossp, lengths, ns)
    wide, sc_w = fdt.fdt_viterbi(state, selfp, advp, crossp, lengths, ns,
                                 beam_width=P * ns, beam_threshold=1e9)
    np.testing.assert_allclose(np.asarray(sc), np.asarray(sc_w), **TOL)
    np.testing.assert_array_equal(np.asarray(exact), np.asarray(wide))


def test_padding_inert(rng):
    """Extra padded frames change nothing (property bar, SURVEY §4.2)."""
    ns, P = 3, 3
    cfg, params, feats, labels, lengths = _problem(rng, 2, 8, P, ns)
    state, selfp, advp, crossp = fdt.factored_planes(
        params, feats, cfg.num_expanded, ns, cfg.state_range,
        cfg.trans_range)
    zf, zc = fdt.fdt_logZ_pair(state, selfp, advp, crossp, labels, lengths,
                               ns, ns, True)
    pad = lambda x: jnp.pad(x, [(0, 0), (0, 5)] +
                            [(0, 0)] * (x.ndim - 2))
    zf2, zc2 = fdt.fdt_logZ_pair(pad(state), pad(selfp), pad(advp),
                                 pad(crossp), pad(labels), lengths, ns, ns,
                                 True)
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zf2), **TOL)
    np.testing.assert_allclose(np.asarray(zc), np.asarray(zc2), **TOL)


@pytest.mark.parametrize("ns", [1, 2, 3])
def test_fdt_posteriors_match_materialized(rng, ns):
    """fdt_posteriors (factored scans, no (B,T,L',L') tensor) == the
    materialized fwdbwd.posteriors_batch on small shapes."""
    from asr_craft.models.crf import (CrfConfig, apply_boundaries,
                                      frame_posteriors, potentials)
    from asr_craft.ops import fwdbwd

    P, D = 4, 7
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                    state_range=(0, D), trans_range=(1, D))
    params = cfg.init_params(jax.random.PRNGKey(3), scale=0.3)
    B, T = 3, 9
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lengths = jnp.asarray([T, T - 2, 4], jnp.int32)
    post = frame_posteriors(cfg, params, feats, lengths)
    state, trans = potentials(cfg, params, feats)
    state = apply_boundaries(cfg, state, lengths)
    ref = fwdbwd.posteriors_batch(state, trans, lengths)
    ref = jnp.where(jnp.arange(T)[None, :, None] < lengths[:, None, None],
                    ref, 0.0)
    np.testing.assert_allclose(np.asarray(post), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
