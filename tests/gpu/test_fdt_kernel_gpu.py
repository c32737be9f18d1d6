"""The fdt kernels compiled for the card (Triton route, not interpret mode)
against the lax.scan recursion.  Marked ``gpu``: they skip without a card
and run on it through ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.models.feature_map import FeatureMapConfig
from asr_craft.ops import fdt

pytestmark = pytest.mark.gpu


def _problem(B, T, P, ns, D=20, seed=0):
    rng = np.random.default_rng(seed)
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=P * ns,
                           trans_range=(0, D))
    params = {k: jnp.asarray(rng.normal(size=v, scale=0.2), jnp.float32)
              for k, v in cfg.param_shapes().items()}
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    run = ns + 1
    labels = jnp.asarray(np.repeat(rng.integers(0, P, size=(B, T // run + 1)),
                                   run, axis=1)[:, :T], jnp.int32)
    lengths = run * rng.integers(1, T // run + 1, size=B)
    lengths[0] = T - T % run
    planes = fdt.factored_planes(params, feats, P * ns, ns, cfg.state_range,
                                 cfg.trans_range)
    return planes, labels, jnp.asarray(lengths, jnp.int32)


def test_kernel_is_chosen(gpu):
    assert fdt.recursion_impl(48) == "kernel"
    assert fdt.recursion_impl(129) == "scan"


@pytest.mark.parametrize("B,T,P,ns", [(5, 37, 48, 3), (3, 20, 7, 2),
                                      (4, 16, 12, 1), (2, 12, 128, 3)])
def test_logZ_and_grads_match_scan(gpu, B, T, P, ns):
    planes, labels, lengths = _problem(B, T, P, ns)

    def loss(pl, impl):
        z = fdt._logZ_dual(*pl, labels, lengths, ns, ns, True, impl)
        return jnp.sum(z[0] - z[1]), z

    (vk, zk), gk = jax.value_and_grad(loss, has_aux=True)(planes, "kernel")
    (vs, zs), gs = jax.value_and_grad(loss, has_aux=True)(planes, "scan")
    np.testing.assert_allclose(np.asarray(zk), np.asarray(zs), rtol=1e-5,
                               atol=1e-4)
    for a, b in zip(jax.tree.leaves(gk), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("beam", [{}, {"beam_threshold": 3.0},
                                  {"beam_width": 10},
                                  {"beam_width": 5, "beam_threshold": 2.0}])
def test_viterbi_matches_scan(gpu, beam):
    planes, _, lengths = _problem(6, 41, 48, 3, seed=1)
    bw, thr = beam.get("beam_width"), beam.get("beam_threshold")
    pk, sk = fdt._viterbi(*planes, lengths, 3, True, bw, thr, "kernel")
    ps, ss = fdt._viterbi(*planes, lengths, 3, True, bw, thr, "scan")
    np.testing.assert_allclose(np.asarray(sk), np.asarray(ss), rtol=1e-6)
    valid = np.arange(41)[None, :] < np.asarray(lengths)[:, None]
    assert not np.any((np.asarray(pk) != np.asarray(ps)) & valid)
