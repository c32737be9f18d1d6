"""Time-axis sharding of the DP recursions (lattice-sharded decode).

BASELINE requires decode sharded along time with "beam/lattice pruning state
exchanged via collectives"; the reference has no analogue (single process).
The algorithmic basis is the associativity of the semiring matrix product
(Hassan et al., "Temporal Parallelization of Inference in HMMs" — PAPERS.md):
with per-frame transfer matrices

    M_0[p, l] = state[0][l] if p == 0 else -inf        (virtual start)
    M_t[p, l] = trans[p, l] + state[t][l]              (1 <= t < length)
    M_t       = semiring identity                      (t >= length: padding)

the alpha recursion is the prefix product ``e_0 (x) M_0 (x) ... (x) M_t``.
Each time-shard:

1. reduces its local chunk to one (B, L, L) transfer-matrix product
   (sequential local scan of semiring matmuls),
2. ``all_gather``s the per-shard products over the "time" mesh axis and
   (redundantly, they are small) prefix-multiplies them into its chunk's
   boundary alpha — this is the collective boundary exchange,
3. re-runs the cheap local *vector* recursion from the boundary alpha to
   materialize its shard of alphas / Viterbi deltas.

logZ falls out of step 2 alone (the full product), replicated on all shards.
Viterbi traceback is inherently sequential right-to-left; labels cross shard
boundaries through a ``ppermute`` chain of (B,) messages (cheap).

Honest scaling note: step 1 costs O(T/N * L^3) per shard versus the
unsharded O(T * L^2) vector scan, so EXACT time-sharding wins on
wall-clock only for N comparable to L or very long T (memory).  The r4
``beam_labels`` path makes it win in practice: per-chunk top-K label
survivor sets shrink the reduction to O(T/N * K^3) — measured 3.1x FASTER
than the unsharded full-L scan at B=4 T=16384 L=48 K=12 on the 8-device
CPU mesh (runs/baseline_table.json timeshard_decode_r4), while remaining
exactly equal to the unsharded decode on the survivor-masked lattice.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from asr_craft.ops.semiring import (LOG, NEG_INF, TROPICAL, get_semiring,
                                    matvec)

__all__ = ["time_mesh", "sharded_log_partition", "sharded_viterbi",
           "survivor_mask", "sharded_decode"]


def time_mesh(n_devices: Optional[int] = None) -> Mesh:
    import numpy as np
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("time",))


def sharded_decode(cfg, params, feats, lengths, n_shards: int,
                   beam_labels: Optional[int] = None, sparse=None):
    """Config 5's lattice-sharded decode as a product surface
    (``cli.decode --time_shard N [--shard_beam_labels K]``): potentials ->
    boundary-masked state -> :func:`sharded_viterbi` over an ``n_shards``-
    device "time" mesh -> per-frame phones.

    Returns ``(phone_frames (B, T), state_paths (B, T), scores (B,))`` —
    the models.crf.decode contract.  Exact vs the unsharded decode (or,
    with ``beam_labels``, vs the survivor-masked unsharded decode — the
    regime where sharding WINS wall-clock: 3.1x at B=4 T=16384 L=48 K=12,
    runs/baseline_table.json timeshard_decode_r4).

    Frame-dependent-transition configs are rejected: the factored planes
    carry no (L', L') transfer matrix to chunk-reduce.  T is padded up to
    a multiple of ``n_shards`` (padding frames are inert — every
    recursion gates on ``lengths``)."""
    from asr_craft.models.crf import (apply_boundaries, densify_sparse,
                                      potentials)
    if cfg.fmap.frame_dependent_trans:
        raise ValueError(
            "time-sharded decode needs a frame-independent (L', L') "
            "transition matrix; frame-dependent-transition configs "
            "(trans_range non-empty) decode on the factored fdt path")
    if sparse is not None:
        feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
    state, trans = potentials(cfg, params, feats)
    state = apply_boundaries(cfg, state, lengths)
    B, T, L = state.shape
    Tp = -(-T // n_shards) * n_shards
    if Tp != T:
        state = jnp.pad(state, ((0, 0), (0, Tp - T), (0, 0)))
    mesh = time_mesh(n_shards)
    path, score = sharded_viterbi(state, trans, lengths, mesh,
                                  beam_labels=beam_labels)
    path = path[:, :T]
    return cfg.topology.path_to_phones(path), path, score


def _local_chunk_product(state_loc, trans, lengths, offset, sr):
    """Reduce a local chunk to one (B, L, L) semiring transfer matrix."""
    B, Tl, L = state_loc.shape
    eye = jnp.where(jnp.eye(L, dtype=bool), 0.0, NEG_INF).astype(state_loc.dtype)
    e0_mat = jnp.full((L, L), NEG_INF, state_loc.dtype)

    def step(prod, inp):
        g, state_t = inp                       # global frame index, (B, L)
        # M_t rows: (B, L, L)
        M = trans[None, :, :] + state_t[:, None, :]
        M0 = jnp.where(
            (jnp.arange(L) == 0)[:, None], state_t[:, None, :], NEG_INF)
        M = jnp.where(g == 0, M0, M)
        # prod (x) M : out[b, i, l] = sr.sum_k prod[b, i, k] + M[b, k, l]
        new = sr.sum(prod[:, :, :, None] + M[:, None, :, :], axis=2)
        new = jnp.where((g < lengths)[:, None, None], new, prod)
        return new, None

    init = jnp.broadcast_to(eye, (B, L, L))
    gs = offset + jnp.arange(Tl)
    prod, _ = jax.lax.scan(step, init, (gs, jnp.moveaxis(state_loc, 1, 0)))
    return prod


def _local_vector_scan(state_loc, trans, lengths, offset, alpha_in, sr):
    """Vector recursion over the local chunk from boundary alpha_in (B, L).
    Returns (alphas_loc (B, Tl, L), alpha_out (B, L))."""
    def step(alpha, inp):
        g, state_t = inp
        new = matvec_b(sr, trans, alpha) + state_t
        new = jnp.where(g == 0, state_t, new)
        new = jnp.where((g < lengths)[:, None], new, alpha)
        return new, new

    def matvec_b(sr, trans, vec):              # batched matvec
        return sr.sum(vec[:, :, None] + trans[None, :, :], axis=1)

    Tl = state_loc.shape[1]
    gs = offset + jnp.arange(Tl)
    alpha_out, alphas = jax.lax.scan(
        step, alpha_in, (gs, jnp.moveaxis(state_loc, 1, 0)))
    return jnp.moveaxis(alphas, 0, 1), alpha_out


def _boundary_alphas(prods, my_idx, B, L, sr):
    """prods: (N, B, L, L) per-shard products.  Returns (alpha_in (B, L) for
    this shard, alpha_final (B, L) after all chunks)."""
    N = prods.shape[0]
    e0 = jnp.where(jnp.arange(L) == 0, 0.0, NEG_INF).astype(prods.dtype)
    a = jnp.broadcast_to(e0, (B, L))

    def body(j, carry):
        a, mine = carry
        mine = jnp.where(j == my_idx, a, mine)
        a = sr.sum(a[:, :, None] + prods[j], axis=1)
        return a, mine

    a_final, a_mine = jax.lax.fori_loop(0, N, body, (a, a))
    return a_mine, a_final


def sharded_log_partition(state, trans, lengths, mesh: Mesh,
                          semiring=LOG):
    """logZ (log semiring) / best score (tropical) with the time axis of
    ``state`` (B, T, L) sharded over mesh axis "time"."""
    sr = get_semiring(semiring)
    N = mesh.shape["time"]
    B, T, L = state.shape

    def fn(state_loc, trans, lengths):
        idx = jax.lax.axis_index("time")
        Tl = state_loc.shape[1]
        offset = idx * Tl
        prod = _local_chunk_product(state_loc, trans, lengths, offset, sr)
        prods = jax.lax.all_gather(prod, "time")            # (N, B, L, L)
        _, a_final = _boundary_alphas(prods, idx, state_loc.shape[0], L, sr)
        return sr.sum(a_final, axis=-1)                     # (B,) replicated

    return shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, "time", None), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(state, trans, lengths)


def _chunk_survivors(state_loc, lengths, offset, K: int):
    """Per-(batch, chunk) top-K surviving labels by peak state evidence
    over the chunk's valid frames.  Returns (B, K) int32 label ids.

    This is the sharded analogue of beam label pruning: the survivor set
    is a pure function of the chunk's own potentials (no sequential
    dependence), so the pruned lattice is IDENTICAL between the sharded
    and unsharded evaluations — pruned-sharded == pruned-unsharded holds
    exactly (tests/dist/test_timeshard.py), while the chunk reduction
    drops from O(Tl L^3) to O(Tl K^3)."""
    B, Tl, L = state_loc.shape
    gs = offset + jnp.arange(Tl)
    valid = (gs[None, :] < lengths[:, None])[..., None]
    peak = jnp.max(jnp.where(valid, state_loc, NEG_INF), axis=1)  # (B, L)
    _, surv = jax.lax.top_k(peak, K)
    return jnp.sort(surv.astype(jnp.int32), axis=-1)


def survivor_mask(state, lengths, n_chunks: int, K: int):
    """(B, T, L) bool: the label-survivor sets the pruned sharded decode
    uses, materialized for the unsharded reference path (test utility —
    the sharded path never builds this)."""
    B, T, L = state.shape
    Tl = T // n_chunks
    masks = []
    for c in range(n_chunks):
        surv = _chunk_survivors(state[:, c * Tl:(c + 1) * Tl], lengths,
                                c * Tl, K)
        m = jnp.zeros((B, L), bool)
        m = m.at[jnp.arange(B)[:, None], surv].set(True)
        masks.append(jnp.broadcast_to(m[:, None], (B, Tl, L)))
    return jnp.concatenate(masks, axis=1)


def _pruned_chunk_product(state_loc, trans, lengths, offset, sr, surv):
    """Chunk transfer product restricted to the survivor labels, expanded
    back to (B, L, L) for the boundary combine (non-survivor rows/columns
    are semiring zeros).  The all_gather payload in sharded_viterbi is the
    EXPANDED matrix for code simplicity on CPU meshes; the information
    content is the (B, K, K) pruned product + (B, K) survivor ids — the
    collective-exchanged pruning state of the BASELINE bar."""
    B, Tl, L = state_loc.shape
    K = surv.shape[1]
    state_k = jnp.take_along_axis(state_loc, surv[:, None, :], axis=2)
    trans_kk = trans[surv[:, :, None], surv[:, None, :]]      # (B, K, K)
    eyeK = jnp.where(jnp.eye(K, dtype=bool), 0.0, NEG_INF)

    # inner frames (t0+1 ..): K-space product — the O(Tl K^3) core
    def step(prod, inp):
        g, state_t = inp                                      # (B, K)
        M = trans_kk + state_t[:, None, :]
        new = sr.sum(prod[:, :, :, None] + M[:, None, :, :], axis=2)
        new = jnp.where((g < lengths)[:, None, None], new, prod)
        return new, None

    gs = offset + 1 + jnp.arange(Tl - 1)
    inner, _ = jax.lax.scan(
        step, jnp.broadcast_to(eyeK, (B, K, K)),
        (gs, jnp.moveaxis(state_k[:, 1:], 1, 0)))

    # first factor: ROWS stay in the FULL label space — the product's row
    # index is the label BEFORE the chunk (the previous chunk's survivor
    # domain), only its columns are this chunk's survivors.
    Mf = jnp.moveaxis(trans[:, surv], 1, 0)                   # (B, L, K)
    Mf = Mf + state_k[:, 0][:, None, :]
    Mf = jnp.where(offset == 0,
                   jnp.broadcast_to(state_k[:, 0][:, None, :], (B, L, K)),
                   Mf)                                        # virtual start
    comp = sr.sum(Mf[:, :, :, None] + inner[:, None, :, :], axis=2)

    full = jnp.full((B, L, L), NEG_INF, comp.dtype)
    full = full.at[jnp.arange(B)[:, None, None],
                   jnp.arange(L)[None, :, None],
                   surv[:, None, :]].set(comp)
    eyeL = jnp.where(jnp.eye(L, dtype=bool), 0.0, NEG_INF)
    return jnp.where((offset < lengths)[:, None, None], full, eyeL)


def sharded_viterbi(state, trans, lengths, mesh: Mesh,
                    beam_labels: Optional[int] = None):
    """Exact Viterbi with time sharding.  Returns (path (B, T), score (B,)).

    Local deltas come from the tropical vector recursion off the boundary
    alphas; the traceback chains labels right-to-left across shards via
    ppermute (the "pruning state exchanged via collectives" of BASELINE).

    ``beam_labels``: per-chunk top-K label pruning (None/K>=L = exact).
    The chunk reduction — the O(Tl L^3) term that makes exact time
    sharding lose at moderate L — runs in the K-dim survivor space; what
    crosses the collective is the pruned product (see
    :func:`_pruned_chunk_product`).  Equals the unsharded decode on the
    survivor-masked lattice exactly (:func:`survivor_mask`)."""
    sr = TROPICAL
    N = mesh.shape["time"]
    B, T, L = state.shape

    def fn(state_loc, trans, lengths):
        idx = jax.lax.axis_index("time")
        Tl = state_loc.shape[1]
        offset = idx * Tl
        if beam_labels is not None and beam_labels < L:
            surv = _chunk_survivors(state_loc, lengths, offset,
                                    beam_labels)
            prod = _pruned_chunk_product(state_loc, trans, lengths,
                                         offset, sr, surv)
            smask = jnp.zeros((B, L), bool).at[
                jnp.arange(B)[:, None], surv].set(True)
            state_loc = jnp.where(smask[:, None, :], state_loc, NEG_INF)
        else:
            prod = _local_chunk_product(state_loc, trans, lengths, offset,
                                        sr)
        prods = jax.lax.all_gather(prod, "time")
        a_in, a_final = _boundary_alphas(prods, idx, B, L, sr)
        deltas, _ = _local_vector_scan(state_loc, trans, lengths, offset,
                                       a_in, sr)            # (B, Tl, L)
        score = jnp.max(a_final, axis=-1)                   # replicated
        last = jnp.argmax(a_final, axis=-1).astype(jnp.int32)

        # Right-to-left traceback.  Label recursion:
        #   lab[g] = last                                   for g >= length-1
        #   lab[g] = argmax_p(delta[g][p] + trans[p, lab[g+1]])  otherwise
        # The `last` clause resolves every frame at/after the end of the
        # sequence, so a shard only needs one incoming value: the label at
        # its right neighbour's first frame (lab_in).
        def local_traceback(lab_in):
            """Returns (path_loc (B, Tl), label at my first frame)."""
            def step(lab_next, inp):
                g, delta_t = inp
                x = delta_t + trans[:, lab_next].T          # (B, L)
                lab = jnp.where(g >= lengths - 1, last,
                                jnp.argmax(x, axis=-1).astype(jnp.int32))
                return lab, lab

            gs = offset + jnp.arange(Tl)
            deltas_tm = jnp.moveaxis(deltas, 1, 0)
            lab_first, path_rev = jax.lax.scan(
                step, lab_in, (gs, deltas_tm), reverse=True)
            return jnp.moveaxis(path_rev, 0, 1), lab_first

        # Sequential chain over shards, rightmost first; each active shard
        # tracebacks its chunk and ppermutes its first-frame label left.
        def chain(k, carry):
            lab_in, path_loc = carry
            shard = N - 1 - k
            am_i = idx == shard
            p_loc, lab_first = local_traceback(lab_in)
            path_loc = jnp.where(am_i, p_loc, path_loc)
            send = jnp.where(am_i, lab_first, lab_in)
            lab_next = jax.lax.ppermute(
                send, "time", [(j, (j - 1) % N) for j in range(N)])
            return lab_next, path_loc

        init = (jnp.zeros((B,), jnp.int32), jnp.zeros((B, Tl), jnp.int32))
        _, path_loc = jax.lax.fori_loop(0, N, chain, init)
        return path_loc, score, last

    path, score, last = shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, "time", None), P(), P()),
        out_specs=(P(None, "time"), P(), P()),
        check_vma=False,
    )(state, trans, lengths)
    # padding region: repeat final label (contract of ops.viterbi)
    Tidx = jnp.arange(T)[None, :]
    path = jnp.where(Tidx < lengths[:, None], path, last[:, None])
    return path, score
