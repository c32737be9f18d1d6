"""Factored-lattice recursions of :mod:`asr_craft.ops.fdt` as Pallas
kernels on the Triton route.

One program per batch tile walks the whole utterance: the time loop runs
inside the kernel and the carry stays in registers, so a pass over T
frames is one launch instead of one XLA loop iteration per frame.  Plane
formation (the GEMMs of ``ops.fdt.factored_planes``) and gradient assembly
stay in XLA.

Layout.  Expanded labels are state-major (``l = p * ns + s``).  The kernels
see them split into ``ns`` slots of P phones each, with P padded to a power
of two (``Pp``) and the batch padded to a multiple of the batch tile:
emission and self/advance planes are time-major ``(T, ns, Bp, Pp)``, the
cross-phone plane is ``(T, Bp, Pp, Pp)``, and padding holds NEG_INF, the
semiring zero.  In slot form the three legal transition classes of the
n-state topology need no gathers:

    self     slot s        -> slot s           elementwise
    advance  slot s        -> slot s + 1       elementwise
    cross    slot ns-1, p  -> slot 0, q        (Pp, Pp) reduction over p

For ``ns == 1`` every pair is legal and the cross plane is the full
transition matrix (self/advance unused), exactly as in ``ops.fdt``.

Kernels: the log-semiring alpha pass, the beta pass (time reversed), and
the max-plus pass with backpointers (exact, score-margin and top-k beam),
followed by a traceback kernel.  Several lattices that share transition
planes (the free and label-clamped lattices of training) run as a second
grid axis over stacked emissions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from asr_craft.ops.semiring import NEG_INF

__all__ = ["P_MAX", "lse_forward", "lse_backward", "viterbi", "slot_dims",
           "to_slots", "cross_slots", "from_slots"]

# Cap on the phone inventory P.  Each program holds a (BB, Pp, Pp) fp32
# cross-phone block in registers every frame; at Pp = 128 and BB = 1 that is
# 16k values, 64 per thread at 8 warps, beside the carries.  Pp = 256 would
# need 256 registers per thread (the hardware limit is 255), so the block
# would spill to local memory every frame.  Above the cap ops.fdt runs the
# lax.scan recursion.
P_MAX = 128

# A score below every reachable lattice value, for masking padded lanes
# out of max and top-k reductions in the max-plus pass.
_FLOOR = float("-inf")


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _block_b(Pp: int) -> int:
    """Batch rows per program: one row per program keeps the cross block at
    Pp^2 values and puts the most programs on the card's 132 SMs (each
    program is a serial chain of T dependent frames, so more programs, not
    wider ones, is what fills the card).  Measured on an H100 at B=128,
    T=512, Pp=64: 2 or 4 rows per program were never faster."""
    del Pp
    return 1


def _num_warps(Pp: int) -> int:
    """Warps per program.  At Pp=64 two warps were fastest over {1, 2, 4,
    8} on an H100 (beta pass 2.5 ms against 3.8 ms at four warps; alpha
    and max-plus within 5%); Pp=128 takes eight so that the 16k-value
    cross block stays at 64 registers per thread."""
    return 2 if Pp <= 64 else 8


def _compiler_params(Pp: int):
    return plt.CompilerParams(num_warps=_num_warps(Pp), num_stages=1)


# ---------------------------------------------------------------------------
# layout conversion (XLA)
# ---------------------------------------------------------------------------

def to_slots(x, ns: int, Pp: int, Bp: int):
    """(..., B, T, L') state-major planes -> (..., T, ns, Bp, Pp)."""
    *lead, B, T, Lp = x.shape
    P = Lp // ns
    y = x.reshape(*lead, B, T, P, ns)
    nl = len(lead)
    y = jnp.transpose(y, tuple(range(nl)) + (nl + 1, nl + 3, nl, nl + 2))
    pad = [(0, 0)] * (nl + 2) + [(0, Bp - B), (0, Pp - P)]
    return jnp.pad(y, pad, constant_values=NEG_INF)


def from_slots(y, B: int, P: int):
    """(..., T, ns, Bp, Pp) -> (..., B, T, P * ns) state-major."""
    *lead, T, ns, _, _ = y.shape
    nl = len(lead)
    y = y[..., :B, :P]
    y = jnp.transpose(y, tuple(range(nl)) + (nl + 2, nl, nl + 3, nl + 1))
    return y.reshape(*lead, B, T, P * ns)


def cross_slots(c, Pp: int, Bp: int):
    """(B, T, P, P) cross-phone plane -> (T, Bp, Pp, Pp)."""
    B, T, P, _ = c.shape
    c = jnp.moveaxis(c, 1, 0)
    return jnp.pad(c, ((0, 0), (0, Bp - B), (0, Pp - P), (0, Pp - P)),
                   constant_values=NEG_INF)


# ---------------------------------------------------------------------------
# in-kernel helpers
# ---------------------------------------------------------------------------

def _lse2(x, y):
    m = jnp.maximum(x, y)
    return m + jnp.log(jnp.exp(x - m) + jnp.exp(y - m))


def _lse_axis(x, axis: int):
    m = jnp.maximum(jnp.max(x, axis=axis), NEG_INF)
    s = jnp.sum(jnp.exp(x - jnp.expand_dims(m, axis)), axis=axis)
    return m + jnp.log(jnp.maximum(s, 1e-35))


def _lse_rows(vals):
    """logsumexp over the slot list and the lane axis -> (BB,)."""
    m = functools.reduce(jnp.maximum, [jnp.max(v, axis=1) for v in vals])
    m = jnp.maximum(m, NEG_INF)
    s = functools.reduce(jnp.add, [jnp.sum(jnp.exp(v - m[:, None]), axis=1)
                                   for v in vals])
    return m + jnp.log(jnp.maximum(s, 1e-35))


def _first_index(hit, idx, axis: int, big: int):
    """Smallest ``idx`` where ``hit`` (argmax-first semantics)."""
    return jnp.min(jnp.where(hit, idx, big), axis=axis)


def _kth_largest_key(keys, k: int):
    """Exact k-th largest of each row over a list of (BB, Pp) int32
    order-preserving float keys: greedy bit construction, one counting
    pass per bit (no float bisection, so 1-ULP ties resolve exactly)."""
    def count_ge(v):
        return functools.reduce(jnp.add, [
            jnp.sum((kk >= v[:, None]).astype(jnp.int32), axis=1)
            for kk in keys])

    BB = keys[0].shape[0]
    zero = jnp.zeros((BB,), jnp.int32)
    base = jnp.where(count_ge(zero) >= k, zero,
                     jnp.full((BB,), -2 ** 31, jnp.int32))
    for bit in range(30, -1, -1):
        cand = base | (1 << bit)
        base = jnp.where(count_ge(cand) >= k, cand, base)
    return base


def _order_key(x):
    """float32 -> int32 with the same order (-0.0 folded onto +0.0)."""
    bits = lax.bitcast_convert_type(x + 0.0, jnp.int32)
    return jnp.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _split_refs(refs, ns: int, n_out: int):
    """Kernel refs -> (len, emission, self, adv, cross, outputs)."""
    if ns > 1:
        len_ref, st_ref, f_ref, a_ref, c_ref = refs[:5]
        rest = refs[5:]
    else:
        len_ref, st_ref, c_ref = refs[:3]
        f_ref = a_ref = None
        rest = refs[3:]
    assert len(rest) == n_out
    return len_ref, st_ref, f_ref, a_ref, c_ref, rest


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _forward_kernel(*refs, ns: int, T: int, BB: int):
    len_ref, st_ref, f_ref, a_ref, c_ref, (alpha_ref, z_ref) = \
        _split_refs(refs, ns, 2)
    k = pl.program_id(1)
    bs = pl.ds(pl.program_id(0) * BB, BB)
    n = len_ref[bs]

    carry0 = tuple(st_ref[k, 0, s, bs, :] for s in range(ns))
    for s in range(ns):
        alpha_ref[k, 0, s, bs, :] = carry0[s]

    def body(t, carry):
        valid = (t < n)[:, None]
        cross = _lse_axis(carry[ns - 1][:, :, None] + c_ref[t, bs, :, :],
                          axis=1)
        out = []
        for s in range(ns):
            if ns == 1:
                cand = cross
            else:
                cand = carry[s] + f_ref[t, s, bs, :]
                other = (cross if s == 0
                         else carry[s - 1] + a_ref[t, s - 1, bs, :])
                cand = _lse2(cand, other)
            new = jnp.where(valid, cand + st_ref[k, t, s, bs, :], carry[s])
            alpha_ref[k, t, s, bs, :] = new
            out.append(new)
        return tuple(out)

    last = lax.fori_loop(1, T, body, carry0)
    z_ref[k, bs] = _lse_rows(last)


def _backward_kernel(*refs, ns: int, T: int, BB: int):
    len_ref, st_ref, f_ref, a_ref, c_ref, (beta_ref,) = \
        _split_refs(refs, ns, 1)
    k = pl.program_id(1)
    bs = pl.ds(pl.program_id(0) * BB, BB)
    n = len_ref[bs]
    Pp = st_ref.shape[-1]
    zero = jnp.zeros((BB, Pp), jnp.float32)
    for s in range(ns):
        beta_ref[k, T - 1, s, bs, :] = zero

    def body(i, carry):
        t = T - 2 - i                      # beta[t] from frame t + 1
        valid = (t + 1 < n)[:, None]
        x = [st_ref[k, t + 1, s, bs, :] + carry[s] for s in range(ns)]
        cross = _lse_axis(c_ref[t + 1, bs, :, :] + x[0][:, None, :], axis=2)
        out = []
        for s in range(ns):
            if ns == 1:
                cand = cross
            else:
                cand = x[s] + f_ref[t + 1, s, bs, :]
                other = (x[s + 1] + a_ref[t + 1, s, bs, :] if s < ns - 1
                         else cross)
                cand = _lse2(cand, other)
            new = jnp.where(valid, cand, carry[s])
            beta_ref[k, t, s, bs, :] = new
            out.append(new)
        return tuple(out)

    lax.fori_loop(0, T - 1, body, (zero,) * ns)


def _viterbi_kernel(*refs, ns: int, T: int, BB: int, P: int,
                    beam_width, beam_threshold):
    len_ref, st_ref, f_ref, a_ref, c_ref, (bp_ref, score_ref, last_ref) = \
        _split_refs(refs, ns, 3)
    bs = pl.ds(pl.program_id(0) * BB, BB)
    n = len_ref[bs]
    Pp = st_ref.shape[-1]
    Lp = P * ns
    lane = lax.broadcasted_iota(jnp.int32, (BB, Pp), 1)
    real = lane < P
    labs = [lane * ns + s for s in range(ns)]          # expanded labels
    prow = lax.broadcasted_iota(jnp.int32, (BB, Pp, Pp), 1)
    big = Pp * ns

    def masked(d):
        return [jnp.where(real, v, _FLOOR) for v in d]

    def prune(d):
        if beam_threshold is not None:
            m = functools.reduce(jnp.maximum,
                                 [jnp.max(v, axis=1) for v in masked(d)])
            d = [jnp.where(v >= m[:, None] - beam_threshold, v, NEG_INF)
                 for v in d]
        if beam_width is not None and beam_width < Lp:
            keys = [_order_key(v) for v in masked(d)]
            kth = _kth_largest_key(keys, beam_width)
            d = [jnp.where(kk >= kth[:, None], v, NEG_INF)
                 for kk, v in zip(keys, d)]
        return tuple(d)

    def best_prev(carry_last, c):
        camd = carry_last[:, :, None] + c               # (BB, p, q)
        best = jnp.max(camd, axis=1)
        arg = _first_index(camd == best[:, None, :], prow, 1, Pp)
        return best, arg

    carry0 = prune([st_ref[0, 0, s, bs, :] for s in range(ns)])

    def body(t, carry):
        valid = (t < n)[:, None]
        cbest, carg = best_prev(carry[ns - 1], c_ref[t, bs, :, :])
        new = []
        for s in range(ns):
            if ns == 1:
                best, bp = cbest, carg
            else:
                cross_bp = carg * ns + (ns - 1)
                self_c = carry[s] + f_ref[t, s, bs, :]
                if s == 0:
                    adv_c = jnp.full_like(self_c, NEG_INF)
                    cross_c = cbest
                else:
                    adv_c = carry[s - 1] + a_ref[t, s - 1, bs, :]
                    cross_c = jnp.full_like(self_c, NEG_INF)
                # first of (self, advance, cross) on ties, as ops.fdt
                best = jnp.maximum(jnp.maximum(self_c, adv_c), cross_c)
                bp = jnp.where(self_c == best, labs[s],
                               jnp.where(adv_c == best, labs[s] - 1,
                                         cross_bp))
            bp_ref[t, s, bs, :] = jnp.where(valid, bp, labs[s])
            new.append(best + st_ref[0, t, s, bs, :])
        new = prune(new)
        return tuple(jnp.where(valid, v, c) for v, c in zip(new, carry))

    final = masked(lax.fori_loop(1, T, body, carry0))
    score = functools.reduce(jnp.maximum, [jnp.max(v, axis=1) for v in final])
    last = functools.reduce(jnp.minimum, [
        _first_index(v == score[:, None], lab, 1, big)
        for v, lab in zip(final, labs)])
    score_ref[bs] = score
    last_ref[bs] = last


def _traceback_kernel(last_ref, bp_ref, path_ref, *, ns: int, T: int,
                      Bp: int, Pp: int, BB: int):
    b0 = pl.program_id(0) * BB
    rows = b0 + lax.broadcasted_iota(jnp.int32, (BB,), 0)
    bs = pl.ds(b0, BB)

    def body(i, lab):
        t = T - 1 - i
        path_ref[t, bs] = lab
        idx = ((t * ns + lab % ns) * Bp + rows) * Pp + lab // ns
        return plt.load(bp_ref.at[idx])

    first = lax.fori_loop(0, T - 1, body, last_ref[bs])
    path_ref[0, bs] = first


# ---------------------------------------------------------------------------
# wrappers (slot layout in, slot layout out)
# ---------------------------------------------------------------------------

def _operands(st, f, a, c, lengths, ns):
    Bp = st.shape[-2]
    lens = jnp.zeros((Bp,), jnp.int32).at[:lengths.shape[0]].set(
        lengths.astype(jnp.int32))
    return (lens, st, f, a, c) if ns > 1 else (lens, st, c)


def lse_forward(st, f, a, c, lengths, ns: int, interpret: bool = False):
    """Alpha pass.  ``st``: (K, T, ns, Bp, Pp) stacked emissions of K
    lattices that share the transition planes ``f``, ``a`` (T, ns, Bp, Pp;
    None for ns == 1) and ``c`` (T, Bp, Pp, Pp).  Returns alphas
    (K, T, ns, Bp, Pp) and logZ (K, Bp)."""
    K, T, _, Bp, Pp = st.shape
    BB = _block_b(Pp)
    kern = functools.partial(_forward_kernel, ns=ns, T=T, BB=BB)
    return pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct(st.shape, jnp.float32),
                   jax.ShapeDtypeStruct((K, Bp), jnp.float32)),
        grid=(Bp // BB, K),
        backend="triton",
        compiler_params=_compiler_params(Pp),
        interpret=interpret,
        name="fdt_alpha",
    )(*_operands(st, f, a, c, lengths, ns))


def lse_backward(st, f, a, c, lengths, ns: int, interpret: bool = False):
    """Beta pass over the same operands; returns betas (K, T, ns, Bp, Pp)
    with beta = 0 from each row's last frame on."""
    K, T, _, Bp, Pp = st.shape
    BB = _block_b(Pp)
    kern = functools.partial(_backward_kernel, ns=ns, T=T, BB=BB)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(st.shape, jnp.float32),
        grid=(Bp // BB, K),
        backend="triton",
        compiler_params=_compiler_params(Pp),
        interpret=interpret,
        name="fdt_beta",
    )(*_operands(st, f, a, c, lengths, ns))


def viterbi(st, f, a, c, lengths, ns: int, P: int, beam_width=None,
            beam_threshold=None, interpret: bool = False):
    """Max-plus pass and traceback.  ``st``: (1, T, ns, Bp, Pp).  Returns
    state-major expanded-label paths (Bp, T) int32 and scores (Bp,);
    pruning follows ``ops.fdt.fdt_viterbi`` (the first frame is pruned
    too)."""
    _, T, _, Bp, Pp = st.shape
    BB = _block_b(Pp)
    kern = functools.partial(
        _viterbi_kernel, ns=ns, T=T, BB=BB, P=P, beam_width=beam_width,
        beam_threshold=(None if beam_threshold is None
                        else float(beam_threshold)))
    bp, score, last = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((T, ns, Bp, Pp), jnp.int32),
                   jax.ShapeDtypeStruct((Bp,), jnp.float32),
                   jax.ShapeDtypeStruct((Bp,), jnp.int32)),
        grid=(Bp // BB,),
        backend="triton",
        compiler_params=_compiler_params(Pp),
        interpret=interpret,
        name="fdt_viterbi",
    )(*_operands(st, f, a, c, lengths, ns))
    TB = min(Bp & -Bp, 32)
    path = pl.pallas_call(
        functools.partial(_traceback_kernel, ns=ns, T=T, Bp=Bp, Pp=Pp,
                          BB=TB),
        out_shape=jax.ShapeDtypeStruct((T, Bp), jnp.int32),
        grid=(Bp // TB,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="fdt_traceback",
    )(last, bp.reshape(-1))
    return path.T, score


def slot_dims(B: int, P: int):
    """(Bp, Pp) for a batch of B rows over P phones."""
    Pp = _pow2(P)
    BB = _block_b(Pp)
    return -(-B // BB) * BB, Pp
