"""Batched Viterbi: tropical-semiring scan with backpointer traceback.

Replaces the reference's time-synchronous decoder core
(``CRF_ViterbiDecoder`` — SURVEY.md §2.1, §3.3) with a dense max-plus scan:
the forward pass records per-frame argmax backpointers ``(T-1, L)``; a
reverse scan does the traceback.  Beam pruning (the analogue of the
reference's threshold/max-active pruning) is a top-k mask applied to the
carry; ``beam_width=None`` is the exact-search parity fallback
(SURVEY.md §7.3 item 6).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asr_craft.ops.fwdbwd import broadcast_trans
from asr_craft.ops.semiring import NEG_INF

__all__ = ["viterbi", "viterbi_batch"]


@functools.partial(jax.jit, static_argnames=("beam_width", "beam_threshold"))
def viterbi(log_phi_state, log_phi_trans, length, beam_width: int | None = None,
            beam_threshold: float | None = None):
    """Best label path. Returns ``(path, score)`` with ``path: (T,) int32``.

    Padded positions of ``path`` repeat the label at ``length - 1`` (inert —
    downstream scoring masks by length).

    Beam pruning (the reference decoder's max-active / score-margin modes,
    both supported symmetrically here and in the Pallas kernels):
    - ``beam_width``: after each frame only the top-k labels survive (ties
      at the k-th score are all kept).
    - ``beam_threshold``: labels more than this margin below the frame-best
      score are pruned.
    Both None = exact Viterbi; both set = intersection of the two beams.
    """
    T, L = log_phi_state.shape
    trans = broadcast_trans(log_phi_trans, T)

    def prune(delta):
        if beam_threshold is not None:
            delta = jnp.where(delta >= jnp.max(delta) - beam_threshold,
                              delta, NEG_INF)
        if beam_width is not None and beam_width < L:
            kth = jax.lax.top_k(delta, beam_width)[0][..., -1]
            delta = jnp.where(delta >= kth, delta, NEG_INF)
        return delta

    def step(carry, inp):
        t, state_t, trans_t = inp
        cand = carry[:, None] + trans_t                    # (L_prev, L)
        bp = jnp.argmax(cand, axis=0).astype(jnp.int32)    # (L,)
        new = prune(jnp.max(cand, axis=0) + state_t)
        new = jnp.where(t < length, new, carry)
        # Padded frames get identity backpointers so traceback through
        # padding propagates the last valid label unchanged.
        bp = jnp.where(t < length, bp, jnp.arange(L, dtype=jnp.int32))
        return new, bp

    delta0 = prune(log_phi_state[0])
    ts = jnp.arange(1, T)
    carry, bps = jax.lax.scan(step, delta0, (ts, log_phi_state[1:], trans[1:]))
    score = jnp.max(carry)
    last = jnp.argmax(carry).astype(jnp.int32)

    # bps[i] holds backpointers for frame i+1.  Reverse scan: carry is the
    # chosen label at frame i+1, emitted as path[i+1]; final carry is path[0].
    def back(lab, bp_t):
        return bp_t[lab], lab

    first, labs = jax.lax.scan(back, last, bps, reverse=True)
    path = jnp.concatenate([first[None], labs], axis=0)
    return path, score


def viterbi_batch(log_phi_state, log_phi_trans, lengths, beam_width=None,
                  beam_threshold=None):
    """Batch over utterances. ``log_phi_state: (B, T, L)``; trans shared
    ((L,L)/(T,L,L)) or per-sequence ((B,T,L,L))."""
    ax = 0 if log_phi_trans.ndim == 4 else None
    return jax.vmap(lambda s, t, n: viterbi(s, t, n, beam_width,
                                            beam_threshold),
                    in_axes=(0, ax, 0))(log_phi_state, log_phi_trans, lengths)
