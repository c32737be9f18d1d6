"""Semiring abstraction for CRF dynamic programs.

The reference toolkit hand-codes two flavours of every DP recursion: a
log-space sum-product pass for training (``CRF_StateNode::computeAlpha`` with
a ``logAdd`` helper in ``CRF/CRF.h`` — SURVEY.md §2.1) and a max-product
Viterbi pass for decoding.  Here the two differ only in the semiring: one scan
implementation is parameterized by (sum, prod, zero, one), which keeps the
kernel count low (SURVEY.md §7.0).

``LOG``       : (logsumexp, +, -inf, 0)  — sum-product in log space (training)
``TROPICAL``  : (max,       +, -inf, 0)  — max-product in log space (Viterbi)

All potentials everywhere in the framework are natural-log scores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

# Large-negative stand-in for -inf where true -inf would poison gradients
# (e.g. masked transition entries still flow through jax.grad).  exp(NEG_INF)
# underflows to 0 in fp32, so it is an exact semiring zero in practice.
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring over log-domain scores."""

    name: str
    sum: Callable[..., jax.Array]     # reduction: sum(x, axis=)
    zero: float                        # identity of `sum`
    # `prod` is ordinary + and `one` is 0.0 for both semirings used here;
    # they are fixed rather than parameterized so kernels can rely on it.

    def prod(self, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    @property
    def one(self) -> float:
        return 0.0


def _logsumexp(x, axis=None, keepdims=False):
    """Max-subtracted logsumexp that tolerates all-NEG_INF slices.

    jax.nn.logsumexp returns -inf for all -inf rows but produces NaN grads;
    this variant clamps the max so masked rows stay at NEG_INF with zero
    gradient, which the padding-invariance property tests rely on.
    """
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.maximum(m, NEG_INF)  # avoid -inf - -inf = NaN
    s = jnp.sum(jnp.exp(x - m_safe), axis=axis, keepdims=True)
    out = m_safe + jnp.log(s)
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


LOG = Semiring(name="log", sum=_logsumexp, zero=NEG_INF)
TROPICAL = Semiring(
    name="tropical",
    sum=lambda x, axis=None, keepdims=False: jnp.max(x, axis=axis, keepdims=keepdims),
    zero=NEG_INF,
)

SEMIRINGS = {"log": LOG, "tropical": TROPICAL}


def get_semiring(name_or_sr) -> Semiring:
    if isinstance(name_or_sr, Semiring):
        return name_or_sr
    return SEMIRINGS[name_or_sr]


def matvec(sr: Semiring, trans, vec):
    """Semiring ``vec @ trans``: out[l] = sum_p(vec[p] + trans[p, l]).

    The inner step of every forward recursion.  ``trans``: (L, L),
    ``vec``: (L,).  Returns (L,).
    """
    return sr.sum(vec[:, None] + trans, axis=0)


def matmul(sr: Semiring, a, b):
    """Semiring matrix product: out[i,j] = sum_k(a[i,k] + b[k,j]).

    (L, L) x (L, L) -> (L, L).  Associative — the building block of the
    time-parallel (associative-scan / time-sharded) formulations in
    :mod:`asr_craft.parallel` (cf. Hassan et al., "Temporal
    Parallelization of Inference in Hidden Markov Models", PAPERS.md).
    """
    return sr.sum(a[:, :, None] + b[None, :, :], axis=1)
