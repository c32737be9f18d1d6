"""Matmul forward-backward: log-semiring recursions as real matmuls.

The generic scan (:mod:`asr_craft.ops.fwdbwd`) evaluates the semiring
matvec ``logsumexp_p(alpha[p] + trans[p, l])`` with a broadcasted
(B, L, L) elementwise add + reduction.  This module reformulates it for
the dominant shared-transition case so the inner step is a matrix product:

    m       = max_p alpha[p]                     (per row / batch element)
    tmax[l] = max_p trans[p, l]                  (per column, precomputed)
    alpha'  = m + tmax + log(exp(alpha - m) @ exp(trans - tmax)) + state

Both factors lie in (0, 1], so products cannot overflow and the result
matches max-subtracted logsumexp to fp32 accuracy; underflow below
exp(-88) is exactly the semiring-zero behaviour of NEG_INF masking.  Every
product here runs at ``precision="highest"``: TF32 keeps about three
decimal digits, too few for the parity bar.

The gradient does not use autodiff-through-scan (which must either save
O(T L^2) residuals or rematerialize): a custom VJP implements the classical
forward-backward identities,

    d logZ / d state[b,t,l]  = gamma[b,t,l] = exp(alpha+beta-logZ)
    d logZ / d trans[p,l]    = sum_{b,t} xi[b,t,p,l]
                             = exp(trans) . ( U^T V )   (one big matmul)
      with U[b,t-1,p] = exp(alpha[b,t-1,p] - logZ_b),
           V[b,t,l]   = exp(state[b,t,l] + beta[b,t,l])

so the backward pass is a beta scan (the same step, transposed) plus a
single (B*T, L)^T @ (B*T, L) contraction: the batched re-design of the
reference's per-frame expected-count accumulation
(``CRF_StateNode::computeExpF`` — SURVEY.md §3.1).

Scope: shared transitions (L, L) — the flagship configuration where
``trans`` is frame-independent (BASELINE: "transition matrices ... replicate
per chip").  Frame-dependent (B, T, L, L) transitions use the generic scan
path.  Parity: held allclose to the NumPy oracle in tests/oracle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asr_craft.ops.semiring import NEG_INF

__all__ = ["forward_mxu", "log_partition_mxu", "posteriors_mxu"]


def _safe_log(x):
    return jnp.log(jnp.maximum(x, 1e-38))


def _row_max(x):
    return jnp.maximum(jnp.max(x, axis=-1, keepdims=True), NEG_INF)


def _forward_scan(state, P, tmax, lengths):
    """state: (B, T, L); P = exp(trans - tmax): (L, L). Returns alphas
    (T, B, L) (time-major for cheap scan stacking) and logZ (B,)."""
    B, T, L = state.shape
    state_tm = jnp.moveaxis(state, 1, 0)          # (T, B, L)

    def step(alpha, inp):
        t, state_t = inp
        m = _row_max(alpha)                        # (B, 1)
        prod = jnp.dot(jnp.exp(alpha - m), P,
                       precision="highest",
                       preferred_element_type=jnp.float32)  # (B, L)
        new = m + tmax[None, :] + _safe_log(prod) + state_t
        new = jnp.where((t < lengths)[:, None], new, alpha)
        return new, new

    alpha0 = state_tm[0]
    ts = jnp.arange(1, T)
    last, rest = jax.lax.scan(step, alpha0, (ts, state_tm[1:]))
    alphas = jnp.concatenate([alpha0[None], rest], axis=0)  # (T, B, L)
    m = _row_max(last)
    logZ = (m + _safe_log(jnp.sum(jnp.exp(last - m), axis=-1,
                                  keepdims=True)))[:, 0]
    return alphas, logZ


def _backward_scan(state, Pt, tmax_r, lengths):
    """Beta pass with the same matmul trick on trans^T.
    Pt = exp(trans.T - tmax_r): (L, L) with tmax_r[p] = max_l trans[p, l].
    Returns betas (T, B, L)."""
    B, T, L = state.shape
    state_tm = jnp.moveaxis(state, 1, 0)

    def step(beta, inp):
        t, state_next = inp
        x = beta + state_next                       # (B, L)
        m = _row_max(x)
        prod = jnp.dot(jnp.exp(x - m), Pt,
                       precision="highest",
                       preferred_element_type=jnp.float32)
        new = m + tmax_r[None, :] + _safe_log(prod)
        new = jnp.where((t + 1 < lengths)[:, None], new,
                        jnp.zeros_like(new))
        return new, new

    init = jnp.zeros((B, L), state.dtype)
    ts = jnp.arange(T - 1)
    _, rest = jax.lax.scan(step, init, (ts, state_tm[1:]), reverse=True)
    return jnp.concatenate([rest, init[None]], axis=0)   # (T, B, L)


def _forward_any(state, trans, lengths):
    """Alpha pass.  Returns time-major (alphas (T, B, L), logZ (B,))."""
    tmax = jnp.maximum(jnp.max(trans, axis=0), NEG_INF)
    P = jnp.exp(trans - tmax[None, :])
    return _forward_scan(state, P, tmax, lengths)


def _backward_any(state, trans, lengths):
    """Beta pass.  Returns betas (T, B, L)."""
    tmax_r = jnp.maximum(jnp.max(trans, axis=1), NEG_INF)
    Pt = jnp.exp(trans.T - tmax_r[None, :])
    return _backward_scan(state, Pt, tmax_r, lengths)


def forward_mxu(state, trans, lengths):
    """Batched alpha pass. ``state``: (B, T, L); ``trans``: (L, L).
    Returns (alphas (B, T, L), logZ (B,))."""
    alphas, logZ = _forward_any(state, trans, lengths)
    return jnp.moveaxis(alphas, 0, 1), logZ


@jax.custom_vjp
def log_partition_mxu(state, trans, lengths):
    """(B,) logZ with the classical forward-backward gradient."""
    _, logZ = forward_mxu(state, trans, lengths)
    return logZ


def _lp_fwd(state, trans, lengths):
    alphas, logZ = _forward_any(state, trans, lengths)
    return logZ, (state, trans, alphas, logZ, lengths)


def _lp_bwd(res, g):
    state, trans, alphas, logZ, lengths = res
    B, T, L = state.shape
    betas = _backward_any(state, trans, lengths)            # (T, B, L)

    ts = jnp.arange(T)
    valid = (ts[:, None] < lengths[None, :])                # (T, B)

    # gamma: d logZ / d state
    gamma = jnp.exp(alphas + betas - logZ[None, :, None])
    gamma = jnp.where(valid[..., None], gamma, 0.0)
    g_state = jnp.moveaxis(gamma * g[None, :, None], 0, 1)  # (B, T, L)

    # xi sum: d logZ / d trans = exp(trans) . (U^T V)
    # U rows: frames 0..T-2 (alpha side), V rows: frames 1..T-1 (beta side).
    # Split the exp(trans) factor's scale between the two sides via the
    # per-sequence alpha max to keep products in range.
    state_tm = jnp.moveaxis(state, 1, 0)
    mU = _row_max(alphas[:-1])                              # (T-1, B, 1)
    x = betas[1:] + state_tm[1:]
    mV = _row_max(x)
    # per-(t,b) scale: exp(alpha - mU) @ exp(trans) @ exp(x - mV)^T would
    # need a per-pair log correction; fold it into U instead:
    # xi[t] = exp(alpha[t-1] + trans + state[t] + beta[t] - logZ)
    #       = (e^{alpha[t-1] - mU} )^T (e^{x - mV}) * e^{trans}
    #         * e^{mU + mV - logZ}
    w = jnp.exp(mU + mV - logZ[None, :, None])              # (T-1, B, 1)
    w = jnp.where(valid[1:][..., None], w, 0.0)
    U = jnp.exp(alphas[:-1] - mU) * (w * g[None, :, None])  # fold weight+cotangent
    V = jnp.exp(x - mV)
    UV = jnp.einsum("tbp,tbl->pl", U, V,
                    precision="highest",
                    preferred_element_type=jnp.float32)     # (L, L)
    # exp(trans + log|UV|) * sign(UV) rather than exp(trans) * UV: immune to
    # exp overflow for large positive learned transition weights.
    g_trans = jnp.sign(UV) * jnp.exp(trans + _safe_log(jnp.abs(UV)))
    return g_state, g_trans, None


log_partition_mxu.defvjp(_lp_fwd, _lp_bwd)


def _clamp_penalty(labels, L, num_states):
    """(B, T) labels -> (B, T, L) additive clamp penalty."""
    lane = jnp.arange(L)
    return jnp.where(lane[None, None, :] // num_states == labels[..., None],
                     0.0, NEG_INF)


def _xi_uv(alphas, betas, state_eff, logZ, lengths, w):
    """Cotangent-weighted U, V factors of the xi contraction (time-major
    alphas/betas (T, B, L); state_eff includes any clamp).  Returns
    (U, V): (T-1, B, L) each, ready for a single einsum."""
    T = alphas.shape[0]
    valid = (jnp.arange(T)[:, None] < lengths[None, :])          # (T, B)
    state_tm = jnp.moveaxis(state_eff, 1, 0)
    mU = _row_max(alphas[:-1])
    x = betas[1:] + state_tm[1:]
    mV = _row_max(x)
    scale = jnp.exp(mU + mV - logZ[None, :, None])
    scale = jnp.where(valid[1:][..., None], scale, 0.0)
    U = jnp.exp(alphas[:-1] - mU) * (scale * w[None, :, None])
    V = jnp.exp(x - mV)
    return U, V


@functools.lru_cache(maxsize=None)
def _make_nll_dual(num_states: int):
    """Fused training objective: per-sequence (nll, logZ, numerator) with a
    classical-forward-backward VJP over BOTH lattices (free + clamped).

    ``num_states``: clamp granularity — frame label ``y`` admits expanded
    states ``[y*ns, (y+1)*ns)``; 1 = direct state equality.
    """

    def _fwd_both(state, trans, labels, lengths):
        af, zf = _forward_any(state, trans, lengths)
        clamp = _clamp_penalty(labels, state.shape[-1], num_states)
        ac, zc = _forward_any(state + clamp, trans, lengths)
        return af, ac, zf, zc

    def _bwd_both(state, trans, labels, lengths):
        bf = _backward_any(state, trans, lengths)
        clamp = _clamp_penalty(labels, state.shape[-1], num_states)
        bc = _backward_any(state + clamp, trans, lengths)
        return bf, bc

    @jax.custom_vjp
    def nll_dual(state, trans, labels, lengths):
        _, _, zf, zc = _fwd_both(state, trans, labels, lengths)
        return zf - zc, zf, zc

    def fwd(state, trans, labels, lengths):
        af, ac, zf, zc = _fwd_both(state, trans, labels, lengths)
        return (zf - zc, zf, zc), (state, trans, labels, lengths,
                                   af, ac, zf, zc)

    def bwd(res, gs):
        g_nll, g_zf, g_zc = gs
        state, trans, labels, lengths, af, ac, zf, zc = res
        wf = g_nll + g_zf
        wc = g_zc - g_nll
        bf, bc = _bwd_both(state, trans, labels, lengths)

        T = af.shape[0]
        valid = (jnp.arange(T)[:, None] < lengths[None, :])
        gamma_f = jnp.exp(af + bf - zf[None, :, None])
        gamma_c = jnp.exp(ac + bc - zc[None, :, None])
        g_state_tm = jnp.where(
            valid[..., None],
            gamma_f * wf[None, :, None] + gamma_c * wc[None, :, None], 0.0)
        g_state = jnp.moveaxis(g_state_tm, 0, 1)

        clamp = _clamp_penalty(labels, state.shape[-1], num_states)
        Uf, Vf = _xi_uv(af, bf, state, zf, lengths, wf)
        Uc, Vc = _xi_uv(ac, bc, state + clamp, zc, lengths, wc)
        U = jnp.concatenate([Uf, Uc], axis=0)
        V = jnp.concatenate([Vf, Vc], axis=0)
        UV = jnp.einsum("tbp,tbl->pl", U, V,
                        precision="highest",
                        preferred_element_type=jnp.float32)
        g_trans = jnp.sign(UV) * jnp.exp(trans + _safe_log(jnp.abs(UV)))
        return g_state, g_trans, None, None

    nll_dual.defvjp(fwd, bwd)
    return nll_dual


def nll_dual(state, trans, labels, lengths, num_states: int = 1):
    """Per-sequence (nll, logZ, numerator) — see _make_nll_dual."""
    return _make_nll_dual(int(num_states))(state, trans, labels, lengths)


def posteriors_mxu(state, trans, lengths):
    """(B, T, L) gamma — parity surface for tests/benchmarks."""
    alphas, logZ = _forward_any(state, trans, lengths)
    betas = _backward_any(state, trans, lengths)
    gamma = jnp.exp(alphas + betas - logZ[None, :, None])
    T = state.shape[1]
    valid = (jnp.arange(T)[:, None] < lengths[None, :])
    gamma = jnp.where(valid[..., None], gamma, 0.0)
    return jnp.moveaxis(gamma, 0, 1)
