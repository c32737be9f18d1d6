"""Factored frame-dependent-transition kernels (kernels/fdt_triton.py, the
Pallas Triton route) in interpret mode vs the lax.scan path of ops/fdt.py:
values, full parameter gradients through the classical-gradient VJP, and
Viterbi decode with both beam modes (SURVEY §4.2 item 6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.kernels import fdt_triton as kern
from asr_craft.models.feature_map import FeatureMapConfig
from asr_craft.ops import fdt

TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture
def interpret(monkeypatch):
    """Route ops.fdt's recursions through the kernels in interpret mode."""
    monkeypatch.setattr(fdt, "recursion_impl", lambda P: "interpret")


def _problem(rng, B, T, P, ns, D=10, state_range=None, trans_range=None):
    Lp = P * ns
    cfg = FeatureMapConfig(
        feat_dim=D, num_expanded=Lp,
        state_range=state_range or (0, D),
        trans_range=trans_range or (1, D))
    shapes = cfg.param_shapes()
    params = {k: jnp.asarray(rng.normal(size=v, scale=0.3), jnp.float32)
              for k, v in shapes.items()}
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    labels = jnp.asarray(
        np.repeat(rng.integers(0, P, size=(B, T // (ns + 1) + 1)),
                  ns + 1, axis=1)[:, :T], jnp.int32)
    lengths = rng.integers(max(ns, 1), T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return cfg, params, feats, labels, jnp.asarray(lengths)


def _planes(cfg, params, feats, ns):
    return fdt.factored_planes(params, feats, cfg.num_expanded, ns,
                               cfg.state_range, cfg.trans_range)


def _nll_kernel(cfg, ns, p, feats, labels, lengths, clamp_ns=None,
                boundaries=True, grad_feats=False):
    return fdt.fdt_nll_dual(cfg, ns, p, feats, labels, lengths, clamp_ns,
                            boundaries, grad_feats=grad_feats)


def _vit(planes, lengths, ns, impl, **beam):
    return fdt._viterbi(*planes, lengths, ns, True, beam.get("beam_width"),
                        beam.get("beam_threshold"), impl)


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (3, 11, 5, 2),
                                      (2, 13, 4, 3), (2, 8, 5, 3)])
def test_values_match_xla(rng, interpret, B, T, P, ns):
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    nll, zf, zc = _nll_kernel(cfg, ns, params, feats, labels, lengths)
    zf_ref, zc_ref = fdt.fdt_logZ_pair(*_planes(cfg, params, feats, ns),
                                       labels, lengths, ns, ns, True)
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zf_ref), **TOL)
    np.testing.assert_allclose(np.asarray(zc), np.asarray(zc_ref), **TOL)


@pytest.mark.parametrize("ns,clamp_ns", [(1, 1), (3, 3), (3, 1)])
def test_grads_match_xla(rng, interpret, ns, clamp_ns):
    B, T, P = 2, 9, 4
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    boundaries = True
    if clamp_ns == 1:
        # state-granular targets must be a topology-legal path (else the
        # clamped lattice is empty and zc = -inf): within each phone run of
        # ns+1 frames walk states [0, 0, 1, .., ns-1]; skip the end-state
        # boundary since lengths may cut mid-run.
        steps = np.asarray([0] + list(range(ns)), np.int32)
        labels = jnp.asarray(
            np.asarray(labels) * ns + np.tile(steps, T // (ns + 1) + 1)
            [None, :T], jnp.int32)
        boundaries = False

    def loss_kernel(p):
        nll, zf, zc = _nll_kernel(cfg, ns, p, feats, labels, lengths,
                                  clamp_ns, boundaries)
        return jnp.sum(nll * 2.0 + 0.25 * zf - 0.5 * zc)

    def loss_xla(p):
        zf, zc = fdt.fdt_logZ_pair(*_planes(cfg, p, feats, ns), labels,
                                   lengths, ns, clamp_ns, boundaries)
        return jnp.sum((zf - zc) * 2.0 + 0.25 * zf - 0.5 * zc)

    v1, g1 = jax.value_and_grad(loss_kernel)(params)
    v2, g2 = jax.value_and_grad(loss_xla)(params)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4, atol=1e-4)
    for k in params:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=3e-3, atol=3e-5, err_msg=k)


def _value_and_grad_pair(cfg, ns, params, feats, labels, lengths):
    def loss_kernel(p):
        return jnp.sum(_nll_kernel(cfg, ns, p, feats, labels, lengths)[0])

    def loss_xla(p):
        zf, zc = fdt.fdt_logZ_pair(*_planes(cfg, p, feats, ns), labels,
                                   lengths, ns, ns, True)
        return jnp.sum(zf - zc)

    return (jax.value_and_grad(loss_kernel)(params),
            jax.value_and_grad(loss_xla)(params))


def test_disjoint_ranges_and_no_biases(rng, interpret):
    """state/trans dim ranges disagree; biases disabled."""
    B, T, P, ns, D = 2, 10, 4, 2, 12
    Lp = P * ns
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=Lp, state_range=(0, 7),
                           trans_range=(5, 12), use_state_bias=False,
                           use_trans_bias=False)
    params = {k: jnp.asarray(rng.normal(size=v, scale=0.3), jnp.float32)
              for k, v in cfg.param_shapes().items()}
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, P, size=(B, T)), jnp.int32)
    lengths = jnp.asarray([T, T - 3], jnp.int32)
    (v1, g1), (v2, g2) = _value_and_grad_pair(cfg, ns, params, feats,
                                              labels, lengths)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4, atol=1e-4)
    for k in params:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=3e-3, atol=3e-5, err_msg=k)


def test_long_T_crosses_blocks(rng, interpret):
    """A longer odd-length utterance with P = 3 padded to 4 lanes."""
    B, T, P, ns = 2, 27, 3, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    (v1, g1), (v2, g2) = _value_and_grad_pair(cfg, ns, params, feats,
                                              labels, lengths)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4, atol=1e-4)
    for k in params:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=3e-3, atol=3e-5, err_msg=k)


def test_slot_layout_shapes(rng):
    """to_slots / cross_slots pad P to a power of two with the semiring
    zero, and from_slots inverts to_slots."""
    B, T, P, ns = 3, 5, 5, 3
    Bp, Pp = kern.slot_dims(B, P)
    assert Pp == 8 and Bp >= B
    x = jnp.asarray(rng.normal(size=(2, B, T, P * ns)), jnp.float32)
    s = kern.to_slots(x, ns, Pp, Bp)
    assert s.shape == (2, T, ns, Bp, Pp)
    assert float(jnp.max(s[..., P:])) == np.float32(fdt.NEG_INF)
    np.testing.assert_array_equal(np.asarray(kern.from_slots(s, B, P)),
                                  np.asarray(x))
    c = kern.cross_slots(jnp.zeros((B, T, P, P)), Pp, Bp)
    assert c.shape == (T, Bp, Pp, Pp)
    assert float(jnp.max(c[:, :, P:, :])) == np.float32(fdt.NEG_INF)


def test_bf16x3_precision_close_to_highest(rng, interpret):
    """The three-pass bf16 plane formation: logZ and gradients through the
    kernel path stay within the recorded bound of the fp32 (HIGHEST)
    result."""
    B, T, P, ns = 2, 12, 4, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    cfg_b = FeatureMapConfig(feat_dim=cfg.feat_dim,
                             num_expanded=cfg.num_expanded,
                             state_range=cfg.state_range,
                             trans_range=cfg.trans_range,
                             precision="bf16x3")
    nll_h, zf_h, _ = _nll_kernel(cfg, ns, params, feats, labels, lengths)
    nll_b, zf_b, _ = _nll_kernel(cfg_b, ns, params, feats, labels, lengths)
    np.testing.assert_allclose(np.asarray(zf_b), np.asarray(zf_h),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(nll_b), np.asarray(nll_h),
                               rtol=2e-3, atol=2e-3)

    def loss(p, c):
        return jnp.sum(_nll_kernel(c, ns, p, feats, labels, lengths)[0])

    g_h = jax.grad(loss)(params, cfg)
    g_b = jax.grad(loss)(params, cfg_b)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_b[k]), np.asarray(g_h[k]),
                                   rtol=0.02, atol=2e-3, err_msg=k)


def _assert_same_decode(out_k, out_x, lengths, msg=""):
    (pk, sk), (px, sx) = out_k, out_x
    np.testing.assert_allclose(np.asarray(sk), np.asarray(sx),
                               rtol=1e-5, atol=1e-5, err_msg=msg)
    for b in range(len(lengths)):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(pk)[b, :n],
                                      np.asarray(px)[b, :n],
                                      err_msg=f"{msg} b={b}")


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (2, 13, 4, 3),
                                      (3, 27, 5, 3)])
def test_fdt_viterbi_kernel_matches_xla(rng, B, T, P, ns):
    """Max-plus kernel + traceback kernel == the XLA factored Viterbi:
    paths and scores."""
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    planes = _planes(cfg, params, feats, ns)
    _assert_same_decode(_vit(planes, lengths, ns, "interpret"),
                        _vit(planes, lengths, ns, "scan"), lengths)


def test_fdt_viterbi_kernel_beam_threshold(rng):
    """Wide threshold == exact; tight threshold == XLA path with the same
    threshold (search-error parity)."""
    B, T, P, ns = 2, 14, 4, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    planes = _planes(cfg, params, feats, ns)
    for thr in (1e9, 2.0):
        _assert_same_decode(
            _vit(planes, lengths, ns, "interpret", beam_threshold=thr),
            _vit(planes, lengths, ns, "scan", beam_threshold=thr),
            lengths, str(thr))


def test_fdt_viterbi_tight_threshold_prunes_init_symmetrically(rng):
    """Both paths prune the INIT frame identically — a sub-typical-margin
    threshold makes frame-0 pruning decisive."""
    B, T, P, ns = 3, 10, 4, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    planes = _planes(cfg, params, feats, ns)
    for thr in (0.25, 0.75):
        _assert_same_decode(
            _vit(planes, lengths, ns, "interpret", beam_threshold=thr),
            _vit(planes, lengths, ns, "scan", beam_threshold=thr),
            lengths, str(thr))


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (3, 11, 5, 2),
                                      (2, 13, 4, 3)])
def test_grad_feats_matches_xla(rng, interpret, B, T, P, ns):
    """grad_feats=True: the feature cotangent through the kernel VJP ==
    the XLA factored path's autodiff dfeats."""
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)

    def loss_kernel(f):
        nll, zf, zc = _nll_kernel(cfg, ns, params, f, labels, lengths,
                                  grad_feats=True)
        return jnp.sum(nll * 2.0 + 0.25 * zf - 0.5 * zc)

    def loss_xla(f):
        zf, zc = fdt.fdt_logZ_pair(*_planes(cfg, params, f, ns), labels,
                                   lengths, ns, ns, True)
        return jnp.sum((zf - zc) * 2.0 + 0.25 * zf - 0.5 * zc)

    v1, g1 = jax.value_and_grad(loss_kernel)(feats)
    v2, g2 = jax.value_and_grad(loss_xla)(feats)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=5e-4, atol=5e-4)


def test_grad_feats_default_is_stop_gradient(rng, interpret):
    """Default grad_feats=False: dfeats is exactly zero by declared
    stop_gradient contract (not silently-wrong numbers)."""
    cfg, params, feats, labels, lengths = _problem(rng, 2, 9, 4, 3)

    def loss(f):
        return jnp.sum(_nll_kernel(cfg, 3, params, f, labels, lengths)[0])

    g = jax.grad(loss)(feats)
    assert float(jnp.max(jnp.abs(g))) == 0.0


def test_fdt_large_P_128(rng, interpret):
    """P=128, the kernel's cap: values + grads + decode parity vs XLA."""
    B, T, P, ns, D = 2, 8, 128, 1, 6
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns, D=D)
    (v1, g1), (v2, g2) = _value_and_grad_pair(cfg, ns, params, feats,
                                              labels, lengths)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    planes = _planes(cfg, params, feats, ns)
    _assert_same_decode(_vit(planes, lengths, ns, "interpret"),
                        _vit(planes, lengths, ns, "scan"), lengths)


def test_fdt_viterbi_kernel_beam_width(rng):
    """In-kernel top-k (max-active) pruning == the XLA lax.top_k path,
    including ties at the k-th and combination with a threshold."""
    B, T, P, ns = 3, 12, 4, 3
    cfg, params, feats, labels, lengths = _problem(rng, B, T, P, ns)
    planes = _planes(cfg, params, feats, ns)
    for bw, thr in ((3, None), (6, None), (4, 2.0), (100, None)):
        _assert_same_decode(
            _vit(planes, lengths, ns, "interpret", beam_width=bw,
                 beam_threshold=thr),
            _vit(planes, lengths, ns, "scan", beam_width=bw,
                 beam_threshold=thr), lengths, f"bw={bw} thr={thr}")


def test_kth_largest_key_exact_adversarial(rng):
    """_kth_largest_key == the k-th output of lax.top_k BIT-FOR-BIT on
    adversarial rows a float bisection gets wrong: 1-ULP near-ties, values
    > 1e5 below the row max, ties at the k-th, and NEG_INF fill."""
    n = 64
    base = rng.normal(size=(n,)).astype(np.float32)
    tied = base.copy()
    tied[1] = np.nextafter(tied[0], np.float32(np.inf))      # 1 ULP apart
    tied[2] = tied[0]                                        # exact tie
    spread = base.copy()
    spread[10:30] = -2.0e5                                   # > span below max
    spread[30:40] = fdt.NEG_INF
    rows = np.stack([base, tied, spread, np.full(n, 3.25, np.float32),
                     np.linspace(-1e6, 1e6, n, dtype=np.float32)])
    halves = [jnp.asarray(rows[:, :32]), jnp.asarray(rows[:, 32:])]
    for K in (1, 2, 5, n // 2, n):
        key = kern._kth_largest_key([kern._order_key(h) for h in halves], K)
        ref = jax.lax.top_k(jnp.asarray(rows), K)[0][:, -1]
        np.testing.assert_array_equal(np.asarray(key),
                                      np.asarray(kern._order_key(ref)),
                                      err_msg=f"K={K}")
