"""ops.fdt's classical forward-backward VJP (the custom VJP of
``fdt_nll_dual``) against autodiff through the lax.scan recursion, for each
(ns, clamp_ns, boundaries), plus ragged and dead lattices.  Runs the scan
recursion, as on every platform but the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.ops import fdt


def _planes(rng, B, T, P, ns, scale=0.5):
    Lp = P * ns
    st = jnp.asarray(rng.normal(size=(B, T, Lp), scale=scale), jnp.float32)
    cp = jnp.asarray(rng.normal(size=(B, T, P, P), scale=scale), jnp.float32)
    if ns == 1:
        return st, None, None, cp
    sp = jnp.asarray(rng.normal(size=(B, T, Lp), scale=scale), jnp.float32)
    adv_ok = (np.arange(Lp) % ns) < ns - 1
    ap = jnp.where(adv_ok, jnp.asarray(rng.normal(size=(B, T, Lp),
                                                  scale=scale)), fdt.NEG_INF)
    return st, sp, ap.astype(jnp.float32), cp


def _labels(rng, B, T, P, ns, clamp_ns):
    """Topology-legal targets: phone runs of ns + 1 frames; state-level
    labels walk [0, 0, 1, .., ns-1] inside each run."""
    run = ns + 1
    phones = np.repeat(rng.integers(0, P, size=(B, T // run + 1)), run,
                       axis=1)[:, :T]
    if clamp_ns == ns:
        return jnp.asarray(phones, jnp.int32)
    steps = np.tile(np.asarray([0] + list(range(ns))), T // run + 1)[:T]
    return jnp.asarray(phones * ns + steps[None], jnp.int32)


def _grads(planes, labels, lengths, ns, clamp_ns, boundaries, w):
    def custom(pl):
        z = fdt._logZ_dual(*pl, labels, lengths, ns, clamp_ns, boundaries,
                           "scan")
        return jnp.sum(w[0] * z[0] + w[1] * z[1])

    def autodiff(pl):
        zf, zc = fdt.fdt_logZ_pair(*pl, labels, lengths, ns, clamp_ns,
                                   boundaries)
        return jnp.sum(w[0] * zf + w[1] * zc)

    return (jax.value_and_grad(custom)(planes),
            jax.value_and_grad(autodiff)(planes))


@pytest.mark.parametrize("ns,clamp_ns,boundaries", [
    (1, 1, True), (1, 1, False), (2, 2, True), (2, 2, False), (2, 1, False),
    (3, 3, True), (3, 3, False), (3, 1, False)])
def test_vjp_matches_autodiff(rng, ns, clamp_ns, boundaries):
    B, T, P = 3, 11, 4
    planes = _planes(rng, B, T, P, ns)
    labels = _labels(rng, B, T, P, ns, clamp_ns)
    run = ns + 1
    lengths = jnp.asarray([T - T % run, run, 2 * run], jnp.int32)
    w = (jnp.asarray([1.0, 0.5, -2.0]), jnp.asarray([-1.0, 0.25, 3.0]))
    (v1, g1), (v2, g2) = _grads(planes, labels, lengths, ns, clamp_ns,
                                boundaries, w)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    for a, b in zip(g1, g2):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_vjp_ragged_lengths_and_length_one(rng):
    """Rows of length 1 and mid-utterance ends: frames past a row's end
    get exactly zero gradient."""
    B, T, P, ns = 4, 9, 3, 3
    planes = _planes(rng, B, T, P, ns)
    labels = _labels(rng, B, T, P, ns, 1)
    lengths = jnp.asarray([9, 1, 4, 6], jnp.int32)
    w = (jnp.ones(B), -jnp.ones(B))
    (v1, g1), (v2, g2) = _grads(planes, labels, lengths, ns, 1, False, w)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    g_state = np.asarray(g1[0])
    for b, n in enumerate(np.asarray(lengths)):
        assert np.all(g_state[b, n:] == 0.0)


def test_vjp_dead_lattice_has_zero_gradient(rng):
    """A clamp that no legal path satisfies (z = NEG_INF): that row's
    gradient is exactly zero and every other row's is finite."""
    B, T, P, ns = 2, 6, 3, 3
    planes = _planes(rng, B, T, P, ns)
    labels = jnp.asarray(np.tile(np.arange(T) % P, (B, 1)), jnp.int32)
    lengths = jnp.asarray([T, T], jnp.int32)   # a new phone every frame

    def loss(pl):
        z = fdt._logZ_dual(*pl, labels, lengths, ns, ns, True, "scan")
        return jnp.sum(z[1])

    z = fdt._logZ_dual(*planes, labels, lengths, ns, ns, True, "scan")
    assert np.all(np.asarray(z[1]) <= fdt.NEG_INF * 0.5)
    for g in jax.grad(loss)(planes):
        assert np.all(np.asarray(g) == 0.0)


@pytest.mark.parametrize("backend,P,impl", [
    ("cpu", 48, "scan"), ("gpu", 48, "kernel"), ("gpu", 128, "kernel"),
    ("gpu", 129, "scan"), ("gpu", 512, "scan")])
def test_kernel_chosen_only_on_gpu_under_cap(monkeypatch, backend, P, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert fdt.recursion_impl(P) == impl


def test_nll_dual_follows_recursion_impl(rng, monkeypatch):
    """fdt_nll_dual asks recursion_impl with the phone count P."""
    from asr_craft.models.feature_map import FeatureMapConfig
    seen = []
    monkeypatch.setattr(fdt, "recursion_impl",
                        lambda P: seen.append(P) or "scan")
    cfg = FeatureMapConfig(feat_dim=6, num_expanded=12, trans_range=(0, 6))
    params = cfg.init_params(jax.random.PRNGKey(0), scale=0.1)
    feats = jnp.asarray(rng.normal(size=(2, 5, 6)), jnp.float32)
    labels = jnp.zeros((2, 5), jnp.int32)
    fdt.fdt_nll_dual(cfg, 3, params, feats, labels,
                     jnp.asarray([5, 4], jnp.int32))
    assert seen == [4]
