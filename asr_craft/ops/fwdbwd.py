"""Forward-backward recursions as masked ``lax.scan`` tensor programs.

Replaces the reference's per-frame lattice node DP (``CRF_StateNode::
computeAlpha / computeBeta / computeAlphaBeta / computeExpF`` and the
per-utterance driver ``CRF_NewGradBuilder::buildGradient`` — SURVEY.md §2.1,
§3.1).  Where the reference walks heap-allocated node objects one frame at a
time, here an utterance is a dense padded ``(T, L)`` potential tensor and the
alpha/beta passes are single ``lax.scan``s; batching is ``jax.vmap``; the
gradient is ``jax.grad`` of :func:`log_partition` (no hand-written
expected-count accumulation — but see tests/oracle for the identity check
E[f] - f_obs == -grad of log-likelihood).

Conventions (SURVEY.md §7.0):
- ``log_phi_state``: ``(T, L)`` log state potentials (feature-map output).
- ``log_phi_trans``: ``(L, L)`` shared, or ``(T, L, L)`` frame-dependent
  transition potentials; ``trans[t, p, l]`` scores the edge from label ``p``
  at frame ``t-1`` to label ``l`` at frame ``t``.  Row ``t=0`` is unused.
- ``length``: scalar int32 count of valid frames; frames ``t >= length`` are
  padding and are provably inert (property-tested).
- All recursions are semiring-parametric (log = training, tropical = Viterbi
  score), see :mod:`asr_craft.ops.semiring`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asr_craft.ops.semiring import LOG, Semiring, get_semiring, matvec

__all__ = [
    "broadcast_trans",
    "forward",
    "backward",
    "log_partition",
    "posteriors",
    "path_score",
    "forward_batch",
    "log_partition_batch",
    "posteriors_batch",
    "path_score_batch",
]


def broadcast_trans(log_phi_trans, T: int):
    """Return ``(T, L, L)`` transitions from either ``(L, L)`` or ``(T, L, L)``.

    The ``(L, L)`` case is not materialized — a broadcasted view is returned
    so XLA keeps it as a loop-invariant operand of the scan.
    """
    if log_phi_trans.ndim == 2:
        return jnp.broadcast_to(log_phi_trans, (T, *log_phi_trans.shape))
    if log_phi_trans.shape[0] != T:
        raise ValueError(
            f"frame-dependent transitions have T={log_phi_trans.shape[0]}, "
            f"but state potentials have T={T}"
        )
    return log_phi_trans


@functools.partial(jax.jit, static_argnames=("semiring",))
def forward(log_phi_state, log_phi_trans, length, semiring: Semiring | str = LOG):
    """Alpha pass. Returns ``(alphas, logZ)`` with ``alphas: (T, L)``.

    ``alpha[0] = state[0]``;
    ``alpha[t, l] = sr.sum_p(alpha[t-1, p] + trans[t, p, l]) + state[t, l]``.
    Padded frames carry ``alpha`` through unchanged, so the final carry is
    ``alpha[length-1]`` and ``logZ = sr.sum(final_carry)``.
    """
    sr = get_semiring(semiring)
    T, L = log_phi_state.shape
    trans = broadcast_trans(log_phi_trans, T)

    # remat: without it autodiff saves the per-step (L, L) candidate tensor,
    # an O(T*L^2) residual that OOMs HBM at production shapes; recomputing
    # the elementwise semiring ops in the backward pass is far cheaper than
    # storing them (SURVEY.md §5 long-context notes).
    @jax.checkpoint
    def step(carry, inp):
        t, state_t, trans_t = inp
        new = matvec(sr, trans_t, carry) + state_t
        new = jnp.where(t < length, new, carry)
        return new, new

    alpha0 = log_phi_state[0]
    ts = jnp.arange(1, T)
    carry, rest = jax.lax.scan(step, alpha0, (ts, log_phi_state[1:], trans[1:]))
    alphas = jnp.concatenate([alpha0[None], rest], axis=0)
    return alphas, sr.sum(carry, axis=-1)


@functools.partial(jax.jit, static_argnames=("semiring",))
def backward(log_phi_state, log_phi_trans, length, semiring: Semiring | str = LOG):
    """Beta pass. Returns ``betas: (T, L)``.

    ``beta[length-1] = 0``;
    ``beta[t, l] = sr.sum_l'(trans[t+1, l, l'] + state[t+1, l'] + beta[t+1, l'])``.
    Padded positions (``t >= length - 1``) hold the semiring one (0.0).
    """
    sr = get_semiring(semiring)
    T, L = log_phi_state.shape
    trans = broadcast_trans(log_phi_trans, T)

    @jax.checkpoint
    def step(carry, inp):
        t, state_next, trans_next = inp  # potentials of frame t+1
        # out[l] = sum_l' trans[t+1][l, l'] + (state[t+1] + beta[t+1])[l']
        new = matvec(sr, trans_next.T, carry + state_next)
        new = jnp.where(t + 1 < length, new, jnp.zeros_like(new))
        return new, new

    init = jnp.zeros((L,), log_phi_state.dtype)
    ts = jnp.arange(T - 1)
    _, rest = jax.lax.scan(
        step, init, (ts, log_phi_state[1:], trans[1:]), reverse=True
    )
    return jnp.concatenate([rest, init[None]], axis=0)


def log_partition(log_phi_state, log_phi_trans, length, semiring: Semiring | str = LOG):
    """``logZ`` (log semiring) or best-path score (tropical)."""
    _, logZ = forward(log_phi_state, log_phi_trans, length, semiring)
    return logZ


@jax.jit
def posteriors(log_phi_state, log_phi_trans, length):
    """Frame-level label posteriors gamma: ``(T, L)``, rows sum to 1.

    ``gamma[t] = softmax(alpha[t] + beta[t])``; padded rows are all zero.
    This is the parity surface BASELINE.json holds allclose at fp32
    ("posterior/alpha/beta tensors allclose").
    """
    alphas, logZ = forward(log_phi_state, log_phi_trans, length, LOG)
    betas = backward(log_phi_state, log_phi_trans, length, LOG)
    gamma = jnp.exp(alphas + betas - logZ)
    mask = (jnp.arange(alphas.shape[0]) < length)[:, None]
    return jnp.where(mask, gamma, 0.0)


@jax.jit
def path_score(log_phi_state, log_phi_trans, labels, length):
    """Log score of a single label path (the CRF numerator for 1-state).

    ``sum_t state[t, y_t] + sum_{t>=1} trans[t, y_{t-1}, y_t]`` over valid
    frames only.
    """
    T, L = log_phi_state.shape
    trans = broadcast_trans(log_phi_trans, T)
    ts = jnp.arange(T)
    valid = ts < length
    state_sc = jnp.where(valid, jnp.take_along_axis(
        log_phi_state, labels[:, None], axis=1)[:, 0], 0.0)
    prev = labels[:-1]
    nxt = labels[1:]
    tr_sc = trans[jnp.arange(1, T), prev, nxt]
    tr_sc = jnp.where(ts[1:] < length, tr_sc, 0.0)
    return jnp.sum(state_sc) + jnp.sum(tr_sc)


# ---------------------------------------------------------------------------
# Batched variants.  Transitions may be shared across the batch ((L,L) or
# (T,L,L)) or per-sequence ((B,T,L,L)); vmap axes are chosen accordingly.
# ---------------------------------------------------------------------------

def _trans_axis(log_phi_trans, batched_time: bool):
    # (L,L) / (T,L,L): broadcast; (B,T,L,L): map over batch.
    return 0 if log_phi_trans.ndim == 4 else None


def forward_batch(log_phi_state, log_phi_trans, lengths, semiring=LOG):
    ax = _trans_axis(log_phi_trans, True)
    return jax.vmap(lambda s, t, n: forward(s, t, n, semiring),
                    in_axes=(0, ax, 0))(log_phi_state, log_phi_trans, lengths)


def log_partition_batch(log_phi_state, log_phi_trans, lengths, semiring=LOG):
    ax = _trans_axis(log_phi_trans, True)
    return jax.vmap(lambda s, t, n: log_partition(s, t, n, semiring),
                    in_axes=(0, ax, 0))(log_phi_state, log_phi_trans, lengths)


def posteriors_batch(log_phi_state, log_phi_trans, lengths):
    ax = _trans_axis(log_phi_trans, True)
    return jax.vmap(posteriors, in_axes=(0, ax, 0))(
        log_phi_state, log_phi_trans, lengths)


def path_score_batch(log_phi_state, log_phi_trans, labels, lengths):
    ax = _trans_axis(log_phi_trans, True)
    return jax.vmap(path_score, in_axes=(0, ax, 0, 0))(
        log_phi_state, log_phi_trans, labels, lengths)
