"""Frame-dependent transition features, topology-factored (the real config 2).

The reference's ``CRF_StdFeatureMap`` ties a weight to every (input dim,
prev-label, label) triple (SURVEY.md §2.1 "Std feature map"), so with
``crf_transftr_end > 0`` the transition potentials depend on the frame:
``trans[b, t, p, l] = x[b, t] . w_trans[:, p, l] + b_trans[p, l]``.  The
generic path materializes that as a ``(B, T, L', L')`` tensor (2.7 GB at
flagship shapes) and runs the generic scan (``ops/fwdbwd.py``).

Under the n-state left-to-right topology (``models/topology.py``) only three
classes of transitions are legal —

    self     (s, s)            L'  entries per frame
    advance  (s, s+1)          L' - P entries (within-phone)
    cross    (last_i, first_j) P^2 entries (phone bigram)

i.e. ``2 L' + P^2`` ≈ 1/8 of the ``L'^2`` plane at ns=3.  Illegal pairs are
semiring zeros: they contribute nothing to logZ or to the gradient of any
legal-path objective, so scoring only the legal classes is EXACT, not an
approximation.  This module computes per-frame *factored potential planes*

    selfp (B, T, L')   advp (B, T, L')   crossp (B, T, P, P)

by three (gathered-weight) matmuls and runs the dual-lattice recursion on
them directly; for ``ns == 1`` every pair is legal and ``crossp`` IS the
full frame-dependent matrix (self/adv unused — no double count).

The recursions (alpha, beta, max-plus) run as Pallas kernels on the GPU
(``kernels/fdt_triton.py``: one program per batch tile, the time loop inside
the kernel) when the phone inventory is under the kernel's cap, and as
``lax.scan`` elsewhere; :func:`recursion_impl` makes that choice from the
platform and P alone.  The training objective :func:`fdt_nll_dual` has one
custom VJP built on the classical forward-backward identities (the ones
``ops/mxu.py`` uses for shared transitions); the gradient assembly from
gamma and xi is XLA on every platform.  :func:`fdt_logZ_pair` keeps the
autodiff-through-the-scan form as the reference for that VJP.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from asr_craft.kernels import fdt_triton as kern
from asr_craft.ops.semiring import NEG_INF

__all__ = ["factored_trans_weights", "factored_planes", "fdt_logZ_pair",
           "fdt_nll_dual", "fdt_viterbi", "fdt_posteriors",
           "recursion_impl"]


def _adv_valid(Lp: int, ns: int) -> np.ndarray:
    """(L',) 1.0 where state-major label l has an advance edge (st < ns-1)."""
    st = np.arange(Lp) % ns
    return (st < ns - 1).astype(np.float32)


def factored_trans_weights(params: dict, Lp: int, ns: int):
    """Gather the legal-transition columns of the canonical parameters.

    ``params`` follow models.feature_map (``w_trans (Dt, L', L')``,
    ``b_trans (L', L')``); returns
    ``(w_self (Dt, L'), b_self (L',), w_adv, b_adv, w_cross (Dt, P, P),
    b_cross (P, P))`` — all plain gathers, so autodiff scatters gradients
    back into the canonical tensors (illegal pairs get zero gradient,
    matching the generic path's NEG_INF-masked lattice).

    For ``ns == 1`` only the cross pair is meaningful (it is the full
    matrix); self/adv are returned as zeros and must not be used.
    """
    w = params["w_trans"]
    b = params.get("b_trans")
    Dt = w.shape[0]
    P = Lp // ns
    if b is None:
        b = jnp.zeros((Lp, Lp), w.dtype)
    if ns == 1:
        z = jnp.zeros((Dt, Lp), w.dtype)
        zb = jnp.zeros((Lp,), w.dtype)
        return z, zb, z, zb, w, b
    lab = np.arange(Lp)
    adv_mask = jnp.asarray(_adv_valid(Lp, ns))
    w_self = jnp.diagonal(w, axis1=1, axis2=2)            # (Dt, L')
    b_self = jnp.diagonal(b)
    nxt = np.minimum(lab + 1, Lp - 1)                     # dummy at last col
    w_adv = w[:, lab, nxt] * adv_mask[None, :]
    b_adv = b[lab, nxt] * adv_mask
    last = np.arange(P) * ns + (ns - 1)
    first = np.arange(P) * ns
    w_cross = w[:, last][:, :, first]                     # (Dt, P, P)
    b_cross = b[last][:, first]
    return w_self, b_self, w_adv, b_adv, w_cross, b_cross


def matmul_precision(precision: str):
    """The ``precision`` option as XLA's matmul precision.

    "highest" is full fp32.  "bf16x3" maps to XLA's HIGH: on the GPU, XLA
    runs an fp32 dot at HIGH as three bf16 passes (bf16_bf16_f32_x3), so
    the name keeps its meaning there.  "default" is XLA's DEFAULT, which on
    the GPU lets an fp32 dot run in TF32.
    """
    return {"default": None, "bf16x3": "high"}.get(precision, precision)


def factored_planes(params: dict, feats, Lp: int, ns: int,
                    state_range, trans_range, use_state_bias=True,
                    precision="highest"):
    """feats (B, T, D) -> (state (B,T,L'), selfp, advp, crossp (B,T,P,P)).

    The state plane is the standard dense map (models.feature_map
    semantics); the transition planes contract the gathered legal-pair
    weights with the ``trans_range`` feature slice.
    """
    prec = matmul_precision(precision)
    xs = feats[..., state_range[0]:state_range[1]]
    xt = feats[..., trans_range[0]:trans_range[1]]
    state = jnp.einsum("...td,dl->...tl", xs, params["w_state"],
                       precision=prec, preferred_element_type=jnp.float32)
    if use_state_bias and "b_state" in params:
        state = state + params["b_state"]
    w_self, b_self, w_adv, b_adv, w_cross, b_cross = \
        factored_trans_weights(params, Lp, ns)
    crossp = jnp.einsum("...td,dpq->...tpq", xt, w_cross, precision=prec,
                        preferred_element_type=jnp.float32) + b_cross
    if ns == 1:
        return state, None, None, crossp
    selfp = jnp.einsum("...td,dl->...tl", xt, w_self, precision=prec,
                       preferred_element_type=jnp.float32) + b_self
    advp = (jnp.einsum("...td,dl->...tl", xt, w_adv, precision=prec,
                       preferred_element_type=jnp.float32) + b_adv)
    # keep illegal advance slots at the semiring zero regardless of bias
    advp = jnp.where(jnp.asarray(_adv_valid(Lp, ns))[None, None, :] > 0,
                     advp, NEG_INF)
    return state, selfp, advp, crossp


def _boundary_state(state, lengths, ns: int, boundaries: bool):
    """Fold start/end n-state masking into the state plane (state-major)."""
    if ns == 1 or not boundaries:
        return state
    Lp = state.shape[-1]
    T = state.shape[-2]
    st = jnp.arange(Lp) % ns
    start = jnp.where(st == 0, 0.0, NEG_INF)
    end = jnp.where(st == ns - 1, 0.0, NEG_INF)
    state = state.at[..., 0, :].add(start)
    at_end = (jnp.arange(T)[None, :] == (lengths - 1)[:, None])
    return state + jnp.where(at_end[..., None], end[None, None, :], 0.0)


def _clamp_plane(labels, Lp: int, clamp_ns: int):
    """(B, T) labels -> (B, T, L') additive clamp penalty (state-major)."""
    lane = jnp.arange(Lp)
    return jnp.where(lane // clamp_ns == labels[..., None], 0.0, NEG_INF)


def _dual_emissions(state, labels, lengths, ns, clamp_ns, boundaries):
    """(2, B, T, L'): the free and the label-clamped lattices' emissions."""
    state = _boundary_state(state, lengths, ns, boundaries)
    return jnp.stack([state, state + _clamp_plane(labels, state.shape[-1],
                                                  clamp_ns)])


def _lse(x, axis):
    m = jnp.maximum(jnp.max(x, axis=axis, keepdims=True), NEG_INF)
    out = m + jnp.log(jnp.maximum(
        jnp.sum(jnp.exp(x - m), axis=axis, keepdims=True), 1e-35))
    return jnp.squeeze(out, axis)


def _factored_update(alpha, f_t, a_t, c_t, ns: int):
    """One factored semiring matvec: alpha (..., B, L') -> (..., B, L')
    candidates (before adding the state plane)."""
    if ns == 1:
        return _lse(alpha[..., :, None] + c_t, axis=-2)
    Lp = alpha.shape[-1]
    st = jnp.arange(Lp) % ns
    self_c = alpha + f_t
    adv_c = jnp.roll(alpha + a_t, 1, axis=-1)
    adv_c = jnp.where(st > 0, adv_c, NEG_INF)
    alpha_last = alpha[..., ns - 1::ns]                     # (..., B, P)
    crossed = _lse(alpha_last[..., :, None] + c_t, axis=-2)
    cross_c = jnp.where(st == 0, jnp.repeat(crossed, ns, axis=-1), NEG_INF)
    return jnp.logaddexp(self_c, jnp.logaddexp(adv_c, cross_c))


def _factored_update_rev(x, f_n, a_n, c_n, ns: int):
    """Transposed matvec of the beta pass: x = beta[t+1] + state[t+1]."""
    if ns == 1:
        return _lse(x[..., None, :] + c_n, axis=-1)
    Lp = x.shape[-1]
    st = jnp.arange(Lp) % ns
    self_c = x + f_n
    adv_c = jnp.where(st < ns - 1, jnp.roll(x, -1, axis=-1) + a_n, NEG_INF)
    x_first = x[..., 0::ns]                                 # (..., B, P)
    crossed = _lse(x_first[..., None, :] + c_n, axis=-1)
    cross_c = jnp.where(st == ns - 1, jnp.repeat(crossed, ns, axis=-1),
                        NEG_INF)
    return jnp.logaddexp(self_c, jnp.logaddexp(adv_c, cross_c))


def _time_major(selfp, advp, crossp, ns, T, B):
    cross_tm = jnp.moveaxis(crossp, 1, 0)
    if ns > 1:
        return jnp.moveaxis(selfp, 1, 0), jnp.moveaxis(advp, 1, 0), cross_tm
    z = jnp.zeros((T, B, 1), crossp.dtype)   # unused; uniform scan inputs
    return z, z, cross_tm


def _alpha_scan(emis, selfp, advp, crossp, lengths, ns: int):
    """lax.scan alpha pass.  ``emis``: (K, B, T, L') emissions of K lattices
    sharing the planes.  Returns alphas (K, B, T, L') and logZ (K, B)."""
    K, B, T, Lp = emis.shape
    em_tm = jnp.moveaxis(emis, 2, 0)                        # (T, K, B, L')
    f_tm, a_tm, c_tm = _time_major(selfp, advp, crossp, ns, T, B)

    @jax.checkpoint
    def step(alpha, inp):
        t, e_t, f_t, a_t, c_t = inp
        cand = _factored_update(alpha, f_t, a_t, c_t, ns) + e_t
        new = jnp.where((t < lengths)[:, None], cand, alpha)
        return new, new

    last, rest = jax.lax.scan(
        step, em_tm[0],
        (jnp.arange(1, T), em_tm[1:], f_tm[1:], a_tm[1:], c_tm[1:]))
    alphas = jnp.concatenate([em_tm[0][None], rest], axis=0)
    return jnp.moveaxis(alphas, 0, 2), _lse(last, -1)


def _beta_scan(emis, selfp, advp, crossp, lengths, ns: int):
    """lax.scan beta pass; betas (K, B, T, L'), zero from length-1 on."""
    K, B, T, Lp = emis.shape
    em_tm = jnp.moveaxis(emis, 2, 0)
    f_tm, a_tm, c_tm = _time_major(selfp, advp, crossp, ns, T, B)

    @jax.checkpoint
    def step(bt, inp):
        t, e_n, f_n, a_n, c_n = inp                         # frame t + 1
        nb = _factored_update_rev(bt + e_n, f_n, a_n, c_n, ns)
        nb = jnp.where((t + 1 < lengths)[:, None], nb, bt)
        return nb, nb

    init = jnp.zeros((K, B, Lp), emis.dtype)
    _, rest = jax.lax.scan(
        step, init,
        (jnp.arange(T - 1), em_tm[1:], f_tm[1:], a_tm[1:], c_tm[1:]),
        reverse=True)
    betas = jnp.concatenate([rest, init[None]], axis=0)
    return jnp.moveaxis(betas, 0, 2)


def recursion_impl(P: int) -> str:
    """Which recursion runs: "kernel" (Pallas, Triton route) on the GPU for
    P up to the kernel's register cap, "scan" (lax.scan) otherwise."""
    if jax.default_backend() == "gpu" and P <= kern.P_MAX:
        return "kernel"
    return "scan"


def _kernel_operands(emis, selfp, advp, crossp, ns):
    """Slot-layout kernel operands (kernels/fdt_triton.py docstring)."""
    B, P = emis.shape[1], crossp.shape[-1]
    Bp, Pp = kern.slot_dims(B, P)
    f = a = None
    if ns > 1:
        f = kern.to_slots(selfp, ns, Pp, Bp)
        a = kern.to_slots(advp, ns, Pp, Bp)
    return (kern.to_slots(emis, ns, Pp, Bp), f, a,
            kern.cross_slots(crossp, Pp, Bp))


def _forward(emis, selfp, advp, crossp, lengths, ns, impl):
    """Alpha pass on the chosen implementation; also returns the kernel
    operands (None on the scan) for reuse by :func:`_backward`."""
    if impl == "scan":
        return _alpha_scan(emis, selfp, advp, crossp, lengths, ns), None
    ops = _kernel_operands(emis, selfp, advp, crossp, ns)
    alphas, z = kern.lse_forward(*ops, lengths, ns,
                                 interpret=impl == "interpret")
    B, P = emis.shape[1], crossp.shape[-1]
    return (kern.from_slots(alphas, B, P), z[:, :B]), ops


def _backward(emis, selfp, advp, crossp, lengths, ns, impl, ops):
    if impl == "scan":
        return _beta_scan(emis, selfp, advp, crossp, lengths, ns)
    betas = kern.lse_backward(*ops, lengths, ns,
                              interpret=impl == "interpret")
    return kern.from_slots(betas, emis.shape[1], crossp.shape[-1])


@functools.partial(jax.jit, static_argnames=("ns", "clamp_ns", "boundaries"))
def fdt_logZ_pair(state, selfp, advp, crossp, labels, lengths,
                  ns: int, clamp_ns: int, boundaries: bool = True):
    """Free + clamped log-partitions by autodiff through the ``lax.scan``
    recursion — the reference for :func:`fdt_nll_dual`'s custom VJP.

    All planes batched (B, T, ...), state-major expanded labels; ``labels``
    (B, T) int32 at ``clamp_ns`` granularity (ns = phone labels, 1 = state
    labels).  Returns (zf, zc): (B,) each.
    """
    emis = _dual_emissions(state, labels, lengths, ns, clamp_ns, boundaries)
    _, z = _alpha_scan(emis, selfp, advp, crossp, lengths, ns)
    return _dead_guard(z[0]), _dead_guard(z[1])


def _dead_guard(z):
    """Zero the gradient of sequences whose lattice has no legal path
    (z == NEG_INF, e.g. a clamp made inconsistent by a mid-phone length
    cut): the 'gradient' there is a softmax over garbage."""
    return jnp.where(z > NEG_INF * 0.5, z, jax.lax.stop_gradient(z))


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9))
def _logZ_dual(state, selfp, advp, crossp, labels, lengths, ns, clamp_ns,
               boundaries, impl):
    return _logZ_dual_fwd(state, selfp, advp, crossp, labels, lengths, ns,
                          clamp_ns, boundaries, impl)[0]


def _logZ_dual_fwd(state, selfp, advp, crossp, labels, lengths, ns,
                   clamp_ns, boundaries, impl):
    emis = _dual_emissions(state, labels, lengths, ns, clamp_ns, boundaries)
    (alphas, z), ops = _forward(emis, selfp, advp, crossp, lengths, ns,
                                impl)
    return z, (emis, selfp, advp, crossp, lengths, alphas, z, ops)


def _logZ_dual_bwd(ns, clamp_ns, boundaries, impl, res, g):
    """Classical forward-backward gradient of (zf, zc) w.r.t. the planes:

        d z / d state[t, l]   = gamma[t, l] = exp(alpha + beta - z)
        d z / d selfp[t, l]   = exp(alpha[t-1, l] + f[t, l]
                                    + state[t, l] + beta[t, l] - z)
        d z / d advp[t, l]    = exp(alpha[t-1, l] + a[t, l]
                                    + state[t, l+1] + beta[t, l+1] - z)
        d z / d crossp[t,p,q] = exp(alpha[t-1, last(p)] + c[t, p, q]
                                    + state[t, first(q)] + beta[t, first(q)]
                                    - z)

    for 1 <= t < length (state includes the boundary and clamp masks), each
    lattice's terms weighted by its cotangent.  A lattice with no legal
    path (z == NEG_INF) gets zero gradient, as in :func:`_dead_guard`.
    """
    emis, selfp, advp, crossp, lengths, alphas, z, ops = res
    betas = _backward(emis, selfp, advp, crossp, lengths, ns, impl, ops)
    K, B, T, Lp = emis.shape
    live = z > NEG_INF * 0.5
    w = jnp.where(live, g, 0.0)[:, :, None, None]              # (K,B,1,1)
    z_eff = jnp.where(live, z, -NEG_INF)[:, :, None, None]
    valid = (jnp.arange(T)[None, :] < lengths[:, None])[None, :, :, None]

    gamma = jnp.where(valid, jnp.exp(alphas + betas - z_eff), 0.0)
    g_state = jnp.sum(w * gamma, axis=0)

    prv = alphas[:, :, :-1]                        # alpha[t-1], t = 1..T-1
    nxt = emis[:, :, 1:] + betas[:, :, 1:] - z_eff  # state[t] + beta[t] - z
    wv = w * valid[:, :, 1:]

    def pad0(x):            # frame 0 carries no transition
        return jnp.pad(x, ((0, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))

    if ns == 1:
        g_self = g_adv = None
        xi_c = jnp.exp(prv[..., :, None] + crossp[None, :, 1:]
                       + nxt[..., None, :])
    else:
        st = jnp.arange(Lp) % ns
        g_self = pad0(jnp.sum(wv * jnp.exp(prv + selfp[None, :, 1:] + nxt),
                              axis=0))
        xi_a = jnp.exp(prv + advp[None, :, 1:] + jnp.roll(nxt, -1, axis=-1))
        g_adv = pad0(jnp.sum(wv * jnp.where(st < ns - 1, xi_a, 0.0),
                             axis=0))
        xi_c = jnp.exp(prv[..., ns - 1::ns, None] + crossp[None, :, 1:]
                       + nxt[..., None, 0::ns])
    g_cross = pad0(jnp.sum(wv[..., None] * xi_c, axis=0))
    return g_state, g_self, g_adv, g_cross, None, None


_logZ_dual.defvjp(_logZ_dual_fwd, _logZ_dual_bwd)


def fdt_nll_dual(fmap_cfg, ns: int, params, feats, labels, lengths,
                 clamp_ns: int | None = None, boundaries: bool = True,
                 grad_feats: bool = False):
    """Fused dual-lattice objective for frame-dependent transitions.

    Mirrors ops.mxu.nll_dual's contract: returns per-sequence
    ``(nll, logZ, numerator)``.  Plane formation is XLA (three GEMMs); the
    recursions follow :func:`recursion_impl`; the gradient is the
    classical forward-backward VJP of :func:`_logZ_dual_bwd`.

    ``grad_feats``: when False, feats is stop_gradient'ed, so ``dfeats`` is
    exactly zero.
    """
    if not grad_feats:
        feats = jax.lax.stop_gradient(feats)
    Lp = fmap_cfg.num_expanded
    clamp_ns = ns if clamp_ns is None else clamp_ns
    state, selfp, advp, crossp = factored_planes(
        params, feats, Lp, ns, fmap_cfg.state_range, fmap_cfg.trans_range,
        fmap_cfg.use_state_bias, fmap_cfg.precision)
    zf, zc = _logZ_dual(state, selfp, advp, crossp, labels, lengths, ns,
                        clamp_ns, boundaries, recursion_impl(Lp // ns))
    return zf - zc, zf, zc


@functools.partial(jax.jit, static_argnames=("ns", "boundaries"))
def fdt_posteriors(state, selfp, advp, crossp, lengths, ns: int,
                   boundaries: bool = True):
    """(B, T, L') frame posteriors over the factored frame-dependent
    lattice — the parity tensor surface at shapes where the materialized
    ``(B, T, L', L')`` path (ops.fwdbwd.posteriors_batch) cannot exist.
    gamma = alpha + beta - logZ.  Held to the materialized path at small
    shapes (tests/oracle/test_fdt).
    """
    impl = recursion_impl(crossp.shape[-1])
    emis = _boundary_state(state, lengths, ns, boundaries)[None]
    (alphas, z), ops = _forward(emis, selfp, advp, crossp, lengths, ns,
                                impl)
    betas = _backward(emis, selfp, advp, crossp, lengths, ns, impl, ops)
    post = jnp.exp(jnp.minimum(alphas + betas - z[..., None, None], 0.0))[0]
    T = state.shape[1]
    return jnp.where((jnp.arange(T)[None, :] < lengths[:, None])[..., None],
                     post, 0.0)


@functools.partial(jax.jit, static_argnames=("ns", "boundaries",
                                             "beam_width", "beam_threshold"))
def fdt_viterbi(state, selfp, advp, crossp, lengths, ns: int,
                boundaries: bool = True, beam_width: int | None = None,
                beam_threshold: float | None = None):
    """Max-plus decode over the factored lattice with traceback.

    Returns (paths (B, T) int32 state-major expanded labels, scores (B,)).
    Beam options mirror ops.viterbi (None = exact).  Backpointers name the
    predecessor expanded label directly (self: l, advance: l-1, cross: the
    argmax phone's last state), so the traceback is the standard gather.
    """
    return _viterbi(state, selfp, advp, crossp, lengths, ns, boundaries,
                    beam_width, beam_threshold,
                    recursion_impl(crossp.shape[-1]))


def _viterbi(state, selfp, advp, crossp, lengths, ns, boundaries,
             beam_width, beam_threshold, impl):
    B, T, Lp = state.shape
    state = _boundary_state(state, lengths, ns, boundaries)
    if impl != "scan":
        st, f, a, c = _kernel_operands(state[None], selfp, advp, crossp, ns)
        paths, scores = kern.viterbi(
            st, f, a, c, lengths, ns, Lp // ns, beam_width, beam_threshold,
            interpret=impl == "interpret")
        return paths[:B], scores[:B]
    state_tm = jnp.moveaxis(state, 1, 0)
    self_tm, adv_tm, cross_tm = _time_major(selfp, advp, crossp, ns, T, B)
    lab = jnp.arange(Lp, dtype=jnp.int32)
    st = lab % ns

    def prune(delta):
        if beam_threshold is not None:
            delta = jnp.where(
                delta >= jnp.max(delta, axis=-1, keepdims=True)
                - beam_threshold, delta, NEG_INF)
        if beam_width is not None and beam_width < Lp:
            kth = jax.lax.top_k(delta, beam_width)[0][..., -1:]
            delta = jnp.where(delta >= kth, delta, NEG_INF)
        return delta

    def step(carry, inp):
        t, s_t, f_t, a_t, c_t = inp
        if ns == 1:
            cand = carry[:, :, None] + c_t                  # (B, P_prev, P)
            best = jnp.max(cand, axis=1)
            bp = jnp.argmax(cand, axis=1).astype(jnp.int32)
        else:
            self_c = carry + f_t
            adv_c = jnp.roll(carry + a_t, 1, axis=-1)
            adv_c = jnp.where(st[None, :] > 0, adv_c, NEG_INF)
            alpha_last = carry[:, ns - 1::ns]
            camd = alpha_last[:, :, None] + c_t             # (B, P, P)
            cross_best = jnp.max(camd, axis=1)
            cross_arg = jnp.argmax(camd, axis=1).astype(jnp.int32)
            cross_c = jnp.where(st[None, :] == 0,
                                jnp.repeat(cross_best, ns, axis=-1), NEG_INF)
            cross_bp = jnp.repeat(cross_arg * ns + (ns - 1), ns, axis=-1)
            stacked = jnp.stack([self_c, adv_c, cross_c], axis=0)
            which = jnp.argmax(stacked, axis=0)
            best = jnp.max(stacked, axis=0)
            bp = jnp.where(which == 0, lab[None, :],
                           jnp.where(which == 1, lab[None, :] - 1, cross_bp))
        new = prune(best + s_t)
        valid = (t < lengths)[:, None]
        new = jnp.where(valid, new, carry)
        bp = jnp.where(valid, bp, lab[None, :])
        return new, bp

    ts = jnp.arange(1, T)
    # the first frame is pruned too (symmetric-beam contract of
    # models.crf.decode)
    final, bps = jax.lax.scan(
        step, prune(state_tm[0]),
        (ts, state_tm[1:], self_tm[1:], adv_tm[1:], cross_tm[1:]))
    scores = jnp.max(final, axis=-1)
    last_lab = jnp.argmax(final, axis=-1).astype(jnp.int32)

    def back(labels_b, bp_t):
        prev = jnp.take_along_axis(bp_t, labels_b[:, None], axis=-1)[:, 0]
        return prev, labels_b

    first_lab, rest = jax.lax.scan(back, last_lab, bps, reverse=True)
    paths = jnp.concatenate([first_lab[None], rest], axis=0)
    return jnp.moveaxis(paths, 0, 1), scores
