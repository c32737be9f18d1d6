"""Segmental CRF (SCRF) recursions over a (time x duration x label) lattice.

Replaces the reference's segmental node classes and segmental Viterbi
decoder (``CRF_StdSegStateNode*``, ``CRF_ViterbiDecoder_StdSeg*`` —
SURVEY.md §2.1, §3.4) with dense scans over a ``(T, Dmax, L)`` segment
potential tensor.

Conventions:
- ``seg_score[t, d, l]``: log potential of a segment labelled ``l`` covering
  frames ``[t - d, t]`` inclusive (``d`` = duration - 1).  Entries with
  ``d > t`` are structurally invalid and masked inside the recursion — the
  caller may leave arbitrary finite values there.
- ``trans``: ``(L, L)`` segment-level label transition potentials, or
  ``(T, L, L)`` where row ``s`` is used for a segment starting at frame ``s``
  (frame-dependent segment transitions).
- The recursion carries a rolling ``(Dmax, L)`` window of the last ``Dmax``
  alphas — the blockwise construction SURVEY.md §7.3 item 4 calls for, so the
  full ``(T, Dmax, L)`` tensor is the only O(T*Dmax) object.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asr_craft.ops.semiring import LOG, NEG_INF, get_semiring

__all__ = ["segmental_forward", "segmental_viterbi",
           "segmental_forward_batch", "segmental_viterbi_batch",
           "segments_to_frames"]


def _trans_for_starts(trans, starts):
    """Gather per-duration transition matrices: (Dmax, L, L)."""
    if trans.ndim == 2:
        return jnp.broadcast_to(trans, (starts.shape[0], *trans.shape))
    return trans[jnp.clip(starts, 0, trans.shape[0] - 1)]


def _alpha_scan(seg_score, trans, length, sr, with_argmax: bool):
    T, Dmax, L = seg_score.shape
    ds = jnp.arange(Dmax)

    @jax.checkpoint
    def step(buf, inp):
        # buf[i] = alpha[t - 1 - i]; rows past the start of time are -inf.
        t, seg_t = inp
        starts = t - ds                                   # (Dmax,)
        tr = _trans_for_starts(trans, starts)             # (Dmax, L, L)
        # msg[d, l] = sr.sum_p buf[d, p] + tr[d, p, l]
        msg = sr.sum(buf[:, :, None] + tr, axis=1)        # (Dmax, L)
        if with_argmax:
            arg_p = jnp.argmax(buf[:, :, None] + tr, axis=1).astype(jnp.int32)
        # Segment starting at 0 has no predecessor: message is semiring one.
        msg = jnp.where((starts == 0)[:, None], 0.0, msg)
        # Invalid durations (segment would start before frame 0): zero.
        msg = jnp.where((starts < 0)[:, None], NEG_INF, msg)
        cand = msg + seg_t                                # (Dmax, L)
        alpha_t = sr.sum(cand, axis=0)                    # (L,)
        new_buf = jnp.concatenate([alpha_t[None], buf[:-1]], axis=0)
        if with_argmax:
            arg_d = jnp.argmax(cand, axis=0).astype(jnp.int32)   # (L,)
            arg_p = jnp.take_along_axis(
                arg_p, arg_d[None, :], axis=0)[0]                # (L,)
            return new_buf, (alpha_t, arg_d, arg_p)
        return new_buf, alpha_t

    buf0 = jnp.full((Dmax, L), NEG_INF, seg_score.dtype)
    ts = jnp.arange(T)
    _, out = jax.lax.scan(step, buf0, (ts, seg_score))
    return out


@functools.partial(jax.jit, static_argnames=("semiring",))
def segmental_forward(seg_score, trans, length, semiring=LOG):
    """Returns ``(alphas (T, L), logZ)`` over all segmentations+labelings of
    the first ``length`` frames (log semiring) or the best-path score
    (tropical)."""
    sr = get_semiring(semiring)
    alphas = _alpha_scan(seg_score, trans, length, sr, with_argmax=False)
    logZ = sr.sum(alphas[length - 1], axis=-1)
    return alphas, logZ


@jax.jit
def segmental_viterbi(seg_score, trans, length):
    """Best segmentation. Returns ``(starts, labels, n_segs, score)``:
    fixed-size ``(T,)`` arrays where entries ``[0, n_segs)`` hold the segment
    start frames (ascending) and labels; the segment ``i`` spans
    ``[starts[i], starts[i+1] - 1]`` (last segment ends at ``length - 1``).
    """
    from asr_craft.ops.semiring import TROPICAL
    T, Dmax, L = seg_score.shape
    alphas, arg_d, arg_p = _alpha_scan(
        seg_score, trans, length, TROPICAL, with_argmax=True)
    score = jnp.max(alphas[length - 1])
    lab0 = jnp.argmax(alphas[length - 1]).astype(jnp.int32)

    # Traceback: at (t, l) the best last segment spans [t - arg_d[t,l], t] and
    # its predecessor label is arg_p[t, l].  At most T segments.
    def body(state):
        t, lab, i, starts, labels = state
        d = arg_d[t, lab]
        start = t - d
        starts = starts.at[i].set(start)
        labels = labels.at[i].set(lab)
        prev_lab = arg_p[t, lab]
        return start - 1, prev_lab, i + 1, starts, labels

    def cond(state):
        t = state[0]
        return t >= 0

    init = (length - 1, lab0, jnp.int32(0),
            jnp.zeros((T,), jnp.int32), jnp.zeros((T,), jnp.int32))
    _, _, n, starts_rev, labels_rev = jax.lax.while_loop(cond, body, init)

    # Entries were written backwards (last segment first); reverse the valid
    # prefix into ascending order.
    idx = jnp.arange(T)
    src = jnp.clip(n - 1 - idx, 0, T - 1)
    starts = jnp.where(idx < n, starts_rev[src], 0)
    labels = jnp.where(idx < n, labels_rev[src], 0)
    return starts, labels, n, score


def segments_to_frames(starts, labels, n_segs, length, T):
    """Expand a segment list to per-frame labels ``(T,)`` (padded with the
    last segment's label)."""
    ts = jnp.arange(T)
    # frame t belongs to segment i where starts[i] <= t < starts[i+1]
    seg_idx = jnp.sum(
        (ts[:, None] >= starts[None, :]) & (jnp.arange(starts.shape[0])[None, :] < n_segs),
        axis=1) - 1
    seg_idx = jnp.clip(seg_idx, 0, starts.shape[0] - 1)
    return labels[seg_idx]


def segmental_forward_batch(seg_score, trans, lengths, semiring=LOG):
    ax = 0 if trans.ndim == 4 else None
    return jax.vmap(lambda s, t, n: segmental_forward(s, t, n, semiring),
                    in_axes=(0, ax, 0))(seg_score, trans, lengths)


def segmental_viterbi_batch(seg_score, trans, lengths):
    ax = 0 if trans.ndim == 4 else None
    return jax.vmap(segmental_viterbi, in_axes=(0, ax, 0))(
        seg_score, trans, lengths)
