"""Streaming SCRF log-partition with a classical segmental fwd-bwd gradient.

Training a segmental CRF at production shapes (B=64, T=512, Dmax=16, L=48)
cannot materialize the ``(B, T, Dmax, L)`` segment-potential tensor that the
dense path (:mod:`asr_craft.ops.segmental` over
``models.segmental.seg_potentials``) differentiates through — SURVEY.md
§7.3 item 4's memory blow-up, and round-1 VERDICT missing #2.  This module
computes logZ *and its gradient* from the O(B·T·L) frame-score stream
alone: segment potentials are reconstructed on the fly from cumulative
frame scores inside rolling ``(Dmax, B, L)`` windows,

    seg[t, d, l] = invd[d] * (CS[t+1, l] - CS[t-d, l]) + bias[d, l],

where ``CS[k] = sum_{u<k} frame[u]`` and ``invd[d] = 1/(d+1)`` for mean
pooling (1 otherwise).

The gradient is not autodiff-through-scan (which stores the rolling carries
for every step) but the classical segmental forward-backward identities via
``jax.custom_vjp`` — the segmental analogue of the linear-chain design in
:mod:`asr_craft.ops.mxu` (reference ``CRF_NewGradBuilder`` expected
counts, SURVEY.md §3.1, generalized to segments §3.4):

    beta[t, l]    = logsumexp_{d, l'} trans[l, l'] + seg[t+d+1, d, l']
                                      + beta[t+d+1, l']        (beta[len-1]=0)
    xi[t, d, l]   = exp(pred[t, d, l] + seg[t, d, l] + beta[t, l] - logZ)
      with pred   = logsumexp_p alpha[t-d-1, p] + trans[p, l]  (0 if d == t)

    dlogZ/dbias[d, l]  = sum_{t} xi[t, d, l]
    dlogZ/dtrans[p, l] = sum_{t, d < t} exp(alpha[t-d-1, p] + trans[p, l]
                                            + seg[t, d, l] + beta[t, l] - logZ)
    dlogZ/dCS[k, l]    = A[k-1, l] - S[k, l]
      A[t] = sum_d invd[d]*xi[t, d]          (segments *ending* at t)
      S[k] = sum_d invd[d]*xi[k+d, d]        (segments *starting* at k)
    dlogZ/dframe[u]    = sum_{k > u} dlogZ/dCS[k]   (reverse cumulative sum)

All recursions are matrix products via the rescaled-exp log-matmul trick
(``ops.mxu`` module docstring), at ``precision="highest"`` (fp32: the
products of values in (0, 1] carry the log-partition).  Parity: held to
the dense materialized path (itself
enumeration-verified in tests/oracle/test_segmental_parity.py) in
tests/oracle/test_segmental_stream.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asr_craft.ops.semiring import NEG_INF

__all__ = ["seg_log_partition_stream", "seg_forward_stream",
           "seg_backward_stream", "seg_log_partition_stream_ns",
           "nstate_cuts", "nstate_pool_matrices"]


def _safe_log(x):
    return jnp.log(jnp.maximum(x, 1e-38))


def _row_max(x):
    return jnp.maximum(jnp.max(x, axis=-1, keepdims=True), NEG_INF)


def _invd(max_dur: int, mean_pool: bool):
    d = jnp.arange(max_dur, dtype=jnp.float32)
    return 1.0 / (d + 1.0) if mean_pool else jnp.ones_like(d)


def _seg_window(cum_now, cs_buf, bias, invd):
    """Segment potentials for the Dmax segments ending at the current frame,
    from the cumulative-score window: (Dmax, B, L)."""
    return (cum_now[None] - cs_buf) * invd[:, None, None] + bias[:, None, :]


def seg_forward_stream(cum, bias, trans, lengths, invd):
    """Alpha pass over the (t, d) lattice from cumulative frame scores.

    ``cum``: (T, B, L) with ``cum[t] = CS[t+1]`` (inclusive cumsum of frame
    scores); ``bias``: (Dmax, L) additive segment bias (duration + label);
    ``trans``: (L, L).  Returns (alphas (T, B, L), logZ (B,)).
    """
    T, B, L = cum.shape
    Dmax = bias.shape[0]
    tmax = jnp.maximum(jnp.max(trans, axis=0), NEG_INF)         # (L,)
    P = jnp.exp(trans - tmax[None, :])
    ds = jnp.arange(Dmax)[:, None, None]

    def step(carry, inp):
        alpha_buf, cs_buf = carry          # alpha_buf[i]=alpha[t-1-i]; cs_buf[i]=CS[t-i]
        t, cum_now = inp                   # cum_now = CS[t+1]
        m = _row_max(alpha_buf)                                  # (Dmax,B,1)
        prod = jnp.dot(jnp.exp(alpha_buf - m).reshape(Dmax * B, L), P,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        msg = m + tmax[None, None, :] + _safe_log(prod)
        msg = jnp.where(ds == t, 0.0, msg)      # segment starts at frame 0
        msg = jnp.where(ds > t, NEG_INF, msg)   # invalid duration
        cand = msg + _seg_window(cum_now, cs_buf, bias, invd)
        cm = jnp.maximum(jnp.max(cand, axis=0), NEG_INF)         # (B, L)
        alpha_t = cm + _safe_log(jnp.sum(jnp.exp(cand - cm[None]), axis=0))
        alpha_t = jnp.where((t < lengths)[:, None], alpha_t, NEG_INF)
        return (jnp.concatenate([alpha_t[None], alpha_buf[:-1]]),
                jnp.concatenate([cum_now[None], cs_buf[:-1]])), alpha_t

    init = (jnp.full((Dmax, B, L), NEG_INF, cum.dtype),
            jnp.zeros((Dmax, B, L), cum.dtype))
    _, alphas = jax.lax.scan(step, init, (jnp.arange(T), cum))

    last = jnp.take_along_axis(
        alphas, jnp.clip(lengths - 1, 0)[None, :, None]
        .astype(jnp.int32).repeat(L, axis=2), axis=0)[0]         # (B, L)
    m = _row_max(last)
    logZ = (m + _safe_log(jnp.sum(jnp.exp(last - m), axis=-1,
                                  keepdims=True)))[:, 0]
    return alphas, logZ


def seg_backward_stream(cum, bias, trans, lengths, invd):
    """Beta pass (descending t).  Returns betas (T, B, L) with
    ``beta[length-1] = 0`` and NEG_INF past the sequence end."""
    T, B, L = cum.shape
    Dmax = bias.shape[0]
    tmax_row = jnp.maximum(jnp.max(trans, axis=1), NEG_INF)      # (L,)
    # M[l', l] = exp(trans[l, l'] - tmax_row[l]): logsumexp over next label
    M = jnp.exp(trans - tmax_row[:, None]).T

    def step(carry, inp):
        beta_buf, cs_buf = carry      # beta_buf[i]=beta[t+1+i]; cs_buf[i]=CS[t+2+i]
        t, cs_next = inp              # cs_next = CS[t+1]
        # segment (end=t+d+1, dur=d+1) starting at t+1:
        seg_next = (cs_buf - cs_next[None]) * invd[:, None, None] \
            + bias[:, None, :]                                   # (Dmax,B,L)
        w = seg_next + beta_buf
        mw = _row_max(w)
        prod = jnp.dot(jnp.exp(w - mw).reshape(Dmax * B, L), M,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        msg = mw + tmax_row[None, None, :] + _safe_log(prod)
        cm = jnp.maximum(jnp.max(msg, axis=0), NEG_INF)
        beta_t = cm + _safe_log(jnp.sum(jnp.exp(msg - cm[None]), axis=0))
        beta_t = jnp.where((t == lengths - 1)[:, None],
                           jnp.zeros_like(beta_t), beta_t)
        beta_t = jnp.where((t >= lengths)[:, None], NEG_INF, beta_t)
        return (jnp.concatenate([beta_t[None], beta_buf[:-1]]),
                jnp.concatenate([cs_next[None], cs_buf[:-1]])), beta_t

    init = (jnp.full((Dmax, B, L), NEG_INF, cum.dtype),
            jnp.zeros((Dmax, B, L), cum.dtype))
    _, betas = jax.lax.scan(step, init, (jnp.arange(T), cum), reverse=True)
    return betas


def _grad_scan(cum, bias, trans, lengths, invd, alphas, betas, logZ, g):
    """Ascending xi pass: accumulates all gradient pieces in one scan.

    Returns raw pieces ``(A (T,B,L), S_emit (T,B,L), acc_fin (Dmax,B,L),
    gd (Dmax,L), gt (L,L))`` for :func:`_assemble_frame_grad` / the
    exp(trans) contraction finish.  ``g``: (B,) cotangent of logZ, folded
    into every xi.
    """
    T, B, L = cum.shape
    Dmax = bias.shape[0]
    tmax = jnp.maximum(jnp.max(trans, axis=0), NEG_INF)
    P = jnp.exp(trans - tmax[None, :])
    ds = jnp.arange(Dmax)[:, None, None]
    gB = g[None, :, None]                                        # (1,B,1)

    def step(carry, inp):
        alpha_buf, cs_buf, acc, gt, gd = carry
        t, cum_now, alpha_t, beta_t = inp
        m = _row_max(alpha_buf)                                  # (Dmax,B,1)
        prod = jnp.dot(jnp.exp(alpha_buf - m).reshape(Dmax * B, L), P,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        pred = m + tmax[None, None, :] + _safe_log(prod)
        pred = jnp.where(ds == t, 0.0, pred)
        pred = jnp.where(ds > t, NEG_INF, pred)
        seg = _seg_window(cum_now, cs_buf, bias, invd)
        x_v = seg + (beta_t - logZ[:, None])[None]               # (Dmax,B,L)
        valid = (t < lengths)[None, :, None]
        xi_g = jnp.where(valid, jnp.exp(pred + x_v) * gB, 0.0)

        acc = acc + invd[:, None, None] * xi_g
        s_emit = acc[Dmax - 1]
        acc = jnp.concatenate([jnp.zeros((1, B, L), acc.dtype), acc[:-1]])
        a_t = jnp.sum(invd[:, None, None] * xi_g, axis=0)        # (B, L)
        gd = gd + jnp.sum(xi_g, axis=1)                          # (Dmax, L)

        # trans contraction: xi over (p, l) factored as U^T V * exp(trans)
        mV = _row_max(x_v)
        w_sc = jnp.exp(m + mV) * gB
        w_sc = jnp.where(valid & (ds < t), w_sc, 0.0)
        U = jnp.exp(alpha_buf - m) * w_sc                        # (Dmax,B,P)
        V = jnp.exp(x_v - mV)                                    # (Dmax,B,L)
        gt = gt + jnp.einsum("dbp,dbl->pl", U, V,
                             precision="highest",
                             preferred_element_type=jnp.float32)

        return (jnp.concatenate([alpha_t[None], alpha_buf[:-1]]),
                jnp.concatenate([cum_now[None], cs_buf[:-1]]),
                acc, gt, gd), (a_t, s_emit)

    init = (jnp.full((Dmax, B, L), NEG_INF, cum.dtype),
            jnp.zeros((Dmax, B, L), cum.dtype),
            jnp.zeros((Dmax, B, L), jnp.float32),
            jnp.zeros((L, L), jnp.float32),
            jnp.zeros((Dmax, L), jnp.float32))
    (_, _, acc_fin, gt, gd), (A, S_emit) = jax.lax.scan(
        step, init, (jnp.arange(T), cum, alphas, betas))
    return A, S_emit, acc_fin, gd, gt


def _assemble_frame_grad(A, S_emit, acc_fin):
    """Frame-score gradient from the xi-pass pieces.

    ``A[t]``: end-contributions of frame t; ``S_emit[t]``: completed
    start-contributions of frame t - (Dmax-1); ``acc_fin[j]``: leftover
    start-contributions of frame T - j (post-shift of the last step).
    """
    import numpy as np
    T, B, L = A.shape
    Dmax = acc_fin.shape[0]
    S = jnp.zeros((T, B, L), jnp.float32)
    if T >= Dmax:
        S = S.at[:T - Dmax + 1].set(S_emit[Dmax - 1:])
    js = np.arange(1, Dmax)
    frames = T - js
    keep = frames >= 0
    if keep.any():
        S = S.at[frames[keep]].set(acc_fin[js[keep]])

    # g_frame[u] = sum_{t >= u} A[t] - sum_{k >= u+1} S[k]
    ra = jnp.flip(jnp.cumsum(jnp.flip(A, 0), axis=0), 0)
    rs = jnp.flip(jnp.cumsum(jnp.flip(S, 0), axis=0), 0)
    rs_next = jnp.concatenate([rs[1:], jnp.zeros((1, B, L), rs.dtype)])
    return ra - rs_next


# ---------------------------------------------------------------------------
# n-state segmental streams (CRF_StdSegNStateNode analogue at production
# shapes — VERDICT r2 missing #4 / next #6).  A duration-(d+1) segment is
# split into ``ns`` proportional sub-state spans (models.segmental docs);
# each span is a cumulative-sum difference of its own frame-score stream.
# With the window W[j] = CS[t+1-j] (j = 0..Dmax) that the rolling buffers
# already hold, every span endpoint is a STATIC window offset per (d, s),
# so pooling becomes one small static einsum with a +/- "pooling matrix"
# E[s, d, j] — the ns == 1 path is the special case E[0, d, :] =
# invd[d] * (onehot(0) - onehot(d+1)).
# ---------------------------------------------------------------------------

def nstate_cuts(max_dur: int, num_states: int):
    """(Dmax, ns+1) proportional span boundaries of a duration-(d+1)
    segment (canonical left-to-right alignment; static)."""
    import numpy as np
    d = np.arange(max_dur) + 1
    s = np.arange(num_states + 1)
    return np.floor(s[None, :] * d[:, None] / num_states + 0.5).astype(
        np.int32)


def nstate_pool_matrices(max_dur: int, ns: int, mean_pool: bool):
    """Static pooling matrices (E_fwd, E_bwd): (ns, Dmax, Dmax+1) each.

    Forward window W[j] = CS[t+1-j] (segments ENDING at t):
        seg[d] = sum_s einsum(E_fwd[s, d, :], W_s) ;
        span s of segment [t-d, t] is W[d+1-cut[d,s+1]] - W[d+1-cut[d,s]].
    Backward window V[j] = CS[t+1+j] (segments STARTING at t+1):
        span s is V[cut[d,s+1]] - V[cut[d,s]].
    """
    import numpy as np
    cuts = nstate_cuts(max_dur, ns)
    Ef = np.zeros((ns, max_dur, max_dur + 1), np.float32)
    Eb = np.zeros((ns, max_dur, max_dur + 1), np.float32)
    for s in range(ns):
        for d in range(max_dur):
            lo, hi = int(cuts[d, s]), int(cuts[d, s + 1])
            if hi <= lo:
                continue                      # empty span (short segment)
            w = 1.0 / (hi - lo) if mean_pool else 1.0
            Ef[s, d, d + 1 - hi] += w
            Ef[s, d, d + 1 - lo] -= w
            Eb[s, d, hi] += w
            Eb[s, d, lo] -= w
    return Ef, Eb


def _seg_window_ns(cum_now, cs_buf, bias, E):
    """Window einsum: (Dmax, B, ns, L) buffers -> (Dmax, B, L) potentials.

    ``cum_now`` (B, ns, L) is W[0]; ``cs_buf[i]`` (Dmax, B, ns, L) is
    W[i+1]; ``E`` (ns, Dmax, Dmax+1)."""
    W = jnp.concatenate([cum_now[None], cs_buf], axis=0)   # (Dmax+1,B,ns,L)
    return jnp.einsum("sdj,jbsl->dbl", E, W,
                      precision="highest",
                      preferred_element_type=jnp.float32) + bias[:, None, :]


def seg_forward_stream_ns(cums, bias, trans, lengths, E):
    """Alpha pass with n-state sub-segment pooling.  ``cums``: (T, B, ns, L)
    inclusive cumsums per sub-state stream.  Returns (alphas, logZ)."""
    T, B, ns, L = cums.shape
    Dmax = bias.shape[0]
    tmax = jnp.maximum(jnp.max(trans, axis=0), NEG_INF)
    P = jnp.exp(trans - tmax[None, :])
    ds = jnp.arange(Dmax)[:, None, None]

    def step(carry, inp):
        alpha_buf, cs_buf = carry
        t, cum_now = inp
        m = _row_max(alpha_buf)
        prod = jnp.dot(jnp.exp(alpha_buf - m).reshape(Dmax * B, L), P,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        msg = m + tmax[None, None, :] + _safe_log(prod)
        msg = jnp.where(ds == t, 0.0, msg)
        msg = jnp.where(ds > t, NEG_INF, msg)
        cand = msg + _seg_window_ns(cum_now, cs_buf, bias, E)
        cm = jnp.maximum(jnp.max(cand, axis=0), NEG_INF)
        alpha_t = cm + _safe_log(jnp.sum(jnp.exp(cand - cm[None]), axis=0))
        alpha_t = jnp.where((t < lengths)[:, None], alpha_t, NEG_INF)
        return (jnp.concatenate([alpha_t[None], alpha_buf[:-1]]),
                jnp.concatenate([cum_now[None], cs_buf[:-1]])), alpha_t

    init = (jnp.full((Dmax, B, L), NEG_INF, cums.dtype),
            jnp.zeros((Dmax, B, ns, L), cums.dtype))
    _, alphas = jax.lax.scan(step, init, (jnp.arange(T), cums))
    last = jnp.take_along_axis(
        alphas, jnp.clip(lengths - 1, 0)[None, :, None]
        .astype(jnp.int32).repeat(L, axis=2), axis=0)[0]
    m = _row_max(last)
    logZ = (m + _safe_log(jnp.sum(jnp.exp(last - m), axis=-1,
                                  keepdims=True)))[:, 0]
    return alphas, logZ


def seg_backward_stream_ns(cums, bias, trans, lengths, Eb):
    """Beta pass with n-state pooling (V-window orientation)."""
    T, B, ns, L = cums.shape
    Dmax = bias.shape[0]
    tmax_row = jnp.maximum(jnp.max(trans, axis=1), NEG_INF)
    M = jnp.exp(trans - tmax_row[:, None]).T

    def step(carry, inp):
        beta_buf, cs_buf = carry          # cs_buf[i] = CS[t+2+i]
        t, cs_next = inp                  # cs_next = CS[t+1]
        seg_next = _seg_window_ns(cs_next, cs_buf, bias, Eb)
        w = seg_next + beta_buf
        mw = _row_max(w)
        prod = jnp.dot(jnp.exp(w - mw).reshape(Dmax * B, L), M,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        msg = mw + tmax_row[None, None, :] + _safe_log(prod)
        cm = jnp.maximum(jnp.max(msg, axis=0), NEG_INF)
        beta_t = cm + _safe_log(jnp.sum(jnp.exp(msg - cm[None]), axis=0))
        beta_t = jnp.where((t == lengths - 1)[:, None],
                           jnp.zeros_like(beta_t), beta_t)
        beta_t = jnp.where((t >= lengths)[:, None], NEG_INF, beta_t)
        return (jnp.concatenate([beta_t[None], beta_buf[:-1]]),
                jnp.concatenate([cs_next[None], cs_buf[:-1]])), beta_t

    init = (jnp.full((Dmax, B, L), NEG_INF, cums.dtype),
            jnp.zeros((Dmax, B, ns, L), cums.dtype))
    _, betas = jax.lax.scan(step, init, (jnp.arange(T), cums), reverse=True)
    return betas


def _grad_scan_ns(cums, bias, trans, lengths, E, alphas, betas, logZ, g):
    """Ascending xi pass, n-state: per step scatter the xi mass onto the
    rolling dCS window with the SAME static pooling matrix E (transposed
    einsum), then emit completed positions.  Returns
    (dcs_emit (T, B, ns, L) where row t holds dCS[t+1-Dmax] — valid from
    t >= Dmax — acc_fin (Dmax+1, B, ns, L) leftovers for the tail
    positions, gd (Dmax, L), gt (L, L))."""
    T, B, ns, L = cums.shape
    Dmax = bias.shape[0]
    tmax = jnp.maximum(jnp.max(trans, axis=0), NEG_INF)
    P = jnp.exp(trans - tmax[None, :])
    ds = jnp.arange(Dmax)[:, None, None]
    gB = g[None, :, None]

    def step(carry, inp):
        alpha_buf, cs_buf, acc, gt, gd = carry
        t, cum_now, alpha_t, beta_t = inp
        m = _row_max(alpha_buf)
        prod = jnp.dot(jnp.exp(alpha_buf - m).reshape(Dmax * B, L), P,
                       precision="highest",
                       preferred_element_type=jnp.float32).reshape(Dmax, B, L)
        pred = m + tmax[None, None, :] + _safe_log(prod)
        pred = jnp.where(ds == t, 0.0, pred)
        pred = jnp.where(ds > t, NEG_INF, pred)
        seg = _seg_window_ns(cum_now, cs_buf, bias, E)
        x_v = seg + (beta_t - logZ[:, None])[None]
        valid = (t < lengths)[None, :, None]
        xi_g = jnp.where(valid, jnp.exp(pred + x_v) * gB, 0.0)

        # dCS[t+1-j] += sum_{s,d} E[s,d,j] * xi[d]  (per sub-state stream)
        acc = acc + jnp.einsum("sdj,dbl->jbsl", E, xi_g,
                               precision="highest",
                               preferred_element_type=jnp.float32)
        emit = acc[Dmax]                                  # dCS[t+1-Dmax]
        acc = jnp.concatenate([jnp.zeros((1, B, ns, L), acc.dtype),
                               acc[:-1]])
        gd = gd + jnp.sum(xi_g, axis=1)

        mV = _row_max(x_v)
        w_sc = jnp.exp(m + mV) * gB
        w_sc = jnp.where(valid & (ds < t), w_sc, 0.0)
        U = jnp.exp(alpha_buf - m) * w_sc
        V = jnp.exp(x_v - mV)
        gt = gt + jnp.einsum("dbp,dbl->pl", U, V,
                             precision="highest",
                             preferred_element_type=jnp.float32)

        return (jnp.concatenate([alpha_t[None], alpha_buf[:-1]]),
                jnp.concatenate([cum_now[None], cs_buf[:-1]]),
                acc, gt, gd), emit

    init = (jnp.full((Dmax, B, L), NEG_INF, cums.dtype),
            jnp.zeros((Dmax, B, ns, L), cums.dtype),
            jnp.zeros((Dmax + 1, B, ns, L), jnp.float32),
            jnp.zeros((L, L), jnp.float32),
            jnp.zeros((Dmax, L), jnp.float32))
    (_, _, acc_fin, gt, gd), dcs_emit = jax.lax.scan(
        step, init, (jnp.arange(T), cums, alphas, betas))
    return dcs_emit, acc_fin, gd, gt


def _assemble_frame_grad_ns(dcs_emit, acc_fin):
    """dCS pieces -> frame-score gradient (T, B, ns, L).

    ``dcs_emit[t]`` = dCS[t+1-Dmax] (complete once t >= Dmax-1);
    ``acc_fin[j]`` = dCS[T+1-j] leftovers (j = 1..Dmax, after the final
    shift).  dframe[u] = sum_{k > u} dCS[k] (CS is an inclusive cumsum)."""
    import numpy as np
    T, B, ns, L = dcs_emit.shape
    Dmax = acc_fin.shape[0] - 1
    dcs = jnp.zeros((T + 1, B, ns, L), jnp.float32)   # dCS[k], k = 0..T
    if T >= Dmax:
        # emits at t = Dmax-1 .. T-1 cover k = 0 .. T-Dmax
        dcs = dcs.at[0:T - Dmax + 1].set(dcs_emit[Dmax - 1:])
    js = np.arange(1, Dmax + 1)
    ks = T + 1 - js
    keep = (ks >= 0) & (ks <= T)
    if keep.any():
        dcs = dcs.at[ks[keep]].set(acc_fin[js[keep]])
    # dframe[u] = sum_{k >= u+1} dCS[k]
    ra = jnp.flip(jnp.cumsum(jnp.flip(dcs[1:], 0), axis=0), 0)
    return ra


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _log_partition_stream_ns(frame_tm, bias, trans, lengths, max_dur, ns,
                             mean_pool):
    cums = jnp.cumsum(frame_tm, axis=0)
    Ef, _ = nstate_pool_matrices(max_dur, ns, mean_pool)
    _, logZ = seg_forward_stream_ns(cums, bias, trans, lengths,
                                    jnp.asarray(Ef))
    return logZ


def _lps_ns_fwd(frame_tm, bias, trans, lengths, max_dur, ns, mean_pool):
    cums = jnp.cumsum(frame_tm, axis=0)
    Ef, _ = nstate_pool_matrices(max_dur, ns, mean_pool)
    alphas, logZ = seg_forward_stream_ns(cums, bias, trans, lengths,
                                         jnp.asarray(Ef))
    return logZ, (cums, bias, trans, lengths, alphas, logZ)


def _lps_ns_bwd(max_dur, ns, mean_pool, res, g):
    cums, bias, trans, lengths, alphas, logZ = res
    Ef, Eb = nstate_pool_matrices(max_dur, ns, mean_pool)
    betas = seg_backward_stream_ns(cums, bias, trans, lengths,
                                   jnp.asarray(Eb))
    dcs_emit, acc_fin, gd, gt = _grad_scan_ns(
        cums, bias, trans, lengths, jnp.asarray(Ef), alphas, betas, logZ, g)
    g_frame = _assemble_frame_grad_ns(dcs_emit, acc_fin)
    g_trans = jnp.sign(gt) * jnp.exp(trans + _safe_log(jnp.abs(gt)))
    return g_frame, gd, g_trans, None


_log_partition_stream_ns.defvjp(_lps_ns_fwd, _lps_ns_bwd)


def seg_log_partition_stream_ns(frame_tm, bias, trans, lengths,
                                max_dur: int, ns: int,
                                mean_pool: bool = True):
    """n-state SCRF logZ (B,) from per-sub-state frame scores — O(B T ns L)
    memory, classical segmental fwd-bwd gradient.  ``frame_tm``:
    (T, B, ns, L) time-major sub-state frame scores."""
    return _log_partition_stream_ns(frame_tm, bias, trans, lengths,
                                    int(max_dur), int(ns), bool(mean_pool))


def _dispatch_forward(frame_tm, bias, trans, lengths, max_dur, mean_pool):
    cum = jnp.cumsum(frame_tm, axis=0)
    return seg_forward_stream(cum, bias, trans, lengths,
                              _invd(max_dur, mean_pool))


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _log_partition_stream(frame_tm, bias, trans, lengths,
                          max_dur, mean_pool):
    _, logZ = _dispatch_forward(frame_tm, bias, trans, lengths,
                                max_dur, mean_pool)
    return logZ


def _lps_fwd(frame_tm, bias, trans, lengths, max_dur, mean_pool):
    alphas, logZ = _dispatch_forward(frame_tm, bias, trans, lengths,
                                     max_dur, mean_pool)
    return logZ, (frame_tm, bias, trans, lengths, alphas, logZ)


def _lps_bwd(max_dur, mean_pool, res, g):
    frame_tm, bias, trans, lengths, alphas, logZ = res
    invd = _invd(max_dur, mean_pool)
    cum = jnp.cumsum(frame_tm, axis=0)
    betas = seg_backward_stream(cum, bias, trans, lengths, invd)
    A, S_emit, acc_fin, gd, gt = _grad_scan(
        cum, bias, trans, lengths, invd, alphas, betas, logZ, g)
    g_frame = _assemble_frame_grad(A, S_emit, acc_fin)
    # finish trans grad outside the scan: exp(trans) * sum(U^T V), in
    # log space for immunity to large learned transition weights (ops.mxu)
    g_trans = jnp.sign(gt) * jnp.exp(trans + _safe_log(jnp.abs(gt)))
    return g_frame, gd, g_trans, None


_log_partition_stream.defvjp(_lps_fwd, _lps_bwd)


def seg_log_partition_stream(frame_tm, bias, trans, lengths,
                             max_dur: int, mean_pool: bool = True):
    """SCRF logZ (B,) from frame scores, differentiable at production
    shapes: never materializes (B, T, Dmax, L), with the classical
    segmental forward-backward gradient (module docstring).

    ``frame_tm``: (T, B, L) per-frame label scores (time-major);
    ``bias``: (Dmax, L) combined duration/label segment bias;
    ``trans``: (L, L) segment-level transitions.
    """
    return _log_partition_stream(frame_tm, bias, trans, lengths,
                                 int(max_dur), bool(mean_pool))


# ---------------------------------------------------------------------------
# streaming segmental Viterbi (+beam) — the production-shape decode
# (VERDICT r2 missing #2/#3: scrf_decode could only run where the dense
# (B, T, Dmax, L) tensor fit).  Same rolling windows as the forward stream,
# tropical semiring, with (duration, predecessor) argmax emission and a
# batched traceback; n-state sub-segment pooling via the static window
# matrices (works for ns == 1 with E_fwd[0, d] = invd[d]*(e0 - e_{d+1})).
# ---------------------------------------------------------------------------

def seg_viterbi_stream(frame_tm, bias, trans, lengths, max_dur: int,
                       ns: int = 1, mean_pool: bool = True,
                       beam_threshold: float | None = None,
                       beam_width: int | None = None):
    """Best segmentations from frame scores, O(B T ns L) memory.

    ``frame_tm``: (T, B, L) for ns == 1, else (T, B, ns, L).  Returns
    ``(starts, labels, n_segs, scores)`` in the fixed-size (B, T) layout of
    ops.segmental.segmental_viterbi_batch.  Beam pruning masks the per-frame
    delta rows (threshold margin and/or top-k max-active); both None =
    exact.
    """
    if frame_tm.ndim == 3:
        frame_tm = frame_tm[:, :, None, :]
    T, B, ns_, L = frame_tm.shape
    assert ns_ == ns
    Dmax = bias.shape[0]
    Ef, _ = nstate_pool_matrices(max_dur, ns, mean_pool)
    E = jnp.asarray(Ef)
    cums = jnp.cumsum(frame_tm, axis=0)
    ds = jnp.arange(Dmax)[:, None, None]

    def prune(delta):
        if beam_threshold is not None:
            m = jnp.max(delta, axis=-1, keepdims=True)
            delta = jnp.where(delta >= m - beam_threshold, delta, NEG_INF)
        if beam_width is not None and beam_width < L:
            kth = jax.lax.top_k(delta, beam_width)[0][..., -1:]
            delta = jnp.where(delta >= kth, delta, NEG_INF)
        return delta

    def step(carry, inp):
        delta_buf, cs_buf = carry
        t, cum_now = inp
        # msg[d, b, l] = max_p delta[t-d-1, b, p] + trans[p, l]
        cand_p = delta_buf[:, :, :, None] + trans[None, None]  # (D,B,P,L)
        msg = jnp.max(cand_p, axis=2)
        argp = jnp.argmax(cand_p, axis=2).astype(jnp.int32)
        msg = jnp.where(ds == t, 0.0, msg)
        argp = jnp.where(ds == t, 0, argp)
        msg = jnp.where(ds > t, NEG_INF, msg)
        cand = msg + _seg_window_ns(cum_now, cs_buf, bias, E)
        delta_t = jnp.max(cand, axis=0)                        # (B, L)
        argd = jnp.argmax(cand, axis=0).astype(jnp.int32)
        argp_t = jnp.take_along_axis(argp, argd[None], axis=0)[0]
        delta_t = prune(delta_t)
        live = (t < lengths)[:, None]
        delta_t = jnp.where(live, delta_t, NEG_INF)
        return ((jnp.concatenate([delta_t[None], delta_buf[:-1]]),
                 jnp.concatenate([cum_now[None], cs_buf[:-1]])),
                (delta_t, argd, argp_t))

    init = (jnp.full((Dmax, B, L), NEG_INF, jnp.float32),
            jnp.zeros((Dmax, B, ns, L), jnp.float32))
    _, (deltas, arg_d, arg_p) = jax.lax.scan(
        step, init, (jnp.arange(T), cums))

    last = jnp.take_along_axis(
        deltas, jnp.clip(lengths - 1, 0)[None, :, None].astype(jnp.int32)
        .repeat(L, axis=2), axis=0)[0]                         # (B, L)
    scores = jnp.max(last, axis=-1)
    lab0 = jnp.argmax(last, axis=-1).astype(jnp.int32)

    def traceback(arg_d_b, arg_p_b, lab0_b, length):
        def body(state):
            t, lab, i, starts, labels = state
            d = arg_d_b[t, lab]
            start = t - d
            starts = starts.at[i].set(start)
            labels = labels.at[i].set(lab)
            return start - 1, arg_p_b[t, lab], i + 1, starts, labels

        init = (length - 1, lab0_b, jnp.int32(0),
                jnp.zeros((T,), jnp.int32), jnp.zeros((T,), jnp.int32))
        _, _, n, st_rev, lb_rev = jax.lax.while_loop(
            lambda s: s[0] >= 0, body, init)
        idx = jnp.arange(T)
        src = jnp.clip(n - 1 - idx, 0, T - 1)
        return (jnp.where(idx < n, st_rev[src], 0),
                jnp.where(idx < n, lb_rev[src], 0), n)

    starts, labels, n = jax.vmap(traceback, in_axes=(1, 1, 0, 0))(
        arg_d, arg_p, lab0, lengths)
    return starts, labels, n, scores
