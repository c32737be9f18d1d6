"""Feature maps: (acoustic frame, label) -> log potential, as batched matmuls.

Capability-parity with the reference's feature-map hierarchy
(``CRF_FeatureMap`` / ``CRF_StdFeatureMap`` / ``CRF_StdSparseFeatureMap`` —
SURVEY.md §2.1): a state feature function ties a weight to every (input dim,
label) pair plus an optional per-label bias, and a transition feature
function ties a weight to every (input dim, prev label, label) triple plus an
optional per-pair bias; sub-ranges of the input dims can be routed to state
vs transition functions (the reference's ``crf_stateftr_start/end`` /
``crf_transftr_start/end`` flags).

Where the reference evaluates these as per-frame scalar dot-product loops
(``computeStateArrayValue`` / ``computeTransMatrixValue``), here the whole
utterance batch is two matmuls:

    state  scores: (B, T, Ds) @ (Ds, L')        -> (B, T, L')
    trans  scores: (B, T, Dt) @ (Dt, L'*L')     -> (B, T, L', L')

The sparse map consumes (indices, values) frames — QuickNet sparse streams —
via gather + weighted sum.

Parameters are a flat pytree (dict of arrays); ``num_params`` and
``flatten_params`` define the canonical flat "lambda" vector ordering used by
the weight-file format (models.weights), mirroring the reference's single
``double*`` lambda vector in ``CRF_Model``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from asr_craft.ops.fdt import matmul_precision


@dataclasses.dataclass(frozen=True)
class FeatureMapConfig:
    """Mirrors ``CRF_FeatureMap_config`` (SURVEY.md §2.1).

    ``state_range`` / ``trans_range``: half-open [start, end) slices of the
    input feature dims feeding state / transition functions.  ``trans_range``
    of zero width means transitions get bias weights only (the common
    reference configuration), producing a shared ``(L', L')`` matrix instead
    of frame-dependent ``(B, T, L', L')`` potentials.
    """

    feat_dim: int
    num_expanded: int                      # L' = num_labels * num_states
    state_range: Tuple[int, int] = None    # default: all dims
    trans_range: Tuple[int, int] = (0, 0)  # default: bias-only transitions
    use_state_bias: bool = True
    use_trans_bias: bool = True
    kind: str = "dense"                    # "dense" | "sparse"
    # matmul precision of the potential matmuls (ops.fdt.matmul_precision):
    # "highest" keeps fp32 (the BASELINE fp32-allclose parity bar);
    # "bf16x3" is three bf16 passes; "default" lets the GPU use TF32.
    precision: str = "highest"

    def __post_init__(self):
        if self.state_range is None:
            object.__setattr__(self, "state_range", (0, self.feat_dim))
        for name in ("state_range", "trans_range"):
            s, e = getattr(self, name)
            if not (0 <= s <= e <= self.feat_dim):
                raise ValueError(f"{name}={(s, e)} out of [0, {self.feat_dim}]")
        if self.kind not in ("dense", "sparse"):
            raise ValueError(f"unknown feature map kind {self.kind!r}")

    @property
    def state_dim(self) -> int:
        return self.state_range[1] - self.state_range[0]

    @property
    def trans_dim(self) -> int:
        return self.trans_range[1] - self.trans_range[0]

    @property
    def frame_dependent_trans(self) -> bool:
        return self.trans_dim > 0

    # --- parameter pytree ---------------------------------------------------

    def param_shapes(self) -> dict:
        L = self.num_expanded
        shapes = {"w_state": (self.state_dim, L)}
        if self.use_state_bias:
            shapes["b_state"] = (L,)
        if self.frame_dependent_trans:
            shapes["w_trans"] = (self.trans_dim, L, L)
        if self.use_trans_bias or not self.frame_dependent_trans:
            # bias-only transitions always need the bias matrix
            shapes["b_trans"] = (L, L)
        return shapes

    def num_params(self) -> int:
        return sum(int(np.prod(s)) for s in self.param_shapes().values())

    def init_params(self, key, scale: float = 0.0, dtype=jnp.float32) -> dict:
        """Reference CRFs start from zero lambdas (conf:M); ``scale > 0``
        gives small-random init for the tests that need symmetry breaking."""
        shapes = self.param_shapes()
        keys = jax.random.split(key, len(shapes))
        return {
            name: (scale * jax.random.normal(k, shape, dtype) if scale
                   else jnp.zeros(shape, dtype))
            for k, (name, shape) in zip(keys, sorted(shapes.items()))
        }


def _slice_feats(feats, rng: Tuple[int, int]):
    return feats[..., rng[0]:rng[1]]


def dense_potentials(cfg: FeatureMapConfig, params: dict, feats):
    """feats (..., T, D) -> (state (..., T, L'), trans (L',L') or (..., T, L', L'))."""
    L = cfg.num_expanded
    prec = matmul_precision(cfg.precision)
    x = _slice_feats(feats, cfg.state_range)
    state = jnp.einsum("...td,dl->...tl", x, params["w_state"],
                       precision=prec, preferred_element_type=jnp.float32)
    if cfg.use_state_bias:
        state = state + params["b_state"]
    if cfg.frame_dependent_trans:
        xt = _slice_feats(feats, cfg.trans_range)
        w = params["w_trans"].reshape(cfg.trans_dim, L * L)
        trans = jnp.einsum("...td,dm->...tm", xt, w,
                           precision=prec, preferred_element_type=jnp.float32)
        trans = trans.reshape(*trans.shape[:-1], L, L)
        if cfg.use_trans_bias:
            trans = trans + params["b_trans"]
    else:
        trans = params["b_trans"]
    return state, trans


def densify_sparse(indices, values, D: int):
    """(B, T, K) sparse (index, value) pairs -> dense (B, T, D) frames.

    Exact bridge onto the dense fast paths: ``sum_k val_k * w[idx_k, l]``
    equals ``densify(pairs) @ w`` term-for-term, so the topology-factored
    frame-dependent-transition path (ops.fdt) can
    serve sparse inputs without materializing the (B, T, L', L')
    transition tensor (VERDICT r3 missing #3).  Padding slots follow the
    loader contract (index 0, value 0) and land harmlessly on dim 0.  The
    scatter-add is O(B T K); duplicate indices accumulate, matching
    sparse_potentials' sum semantics."""
    B, T, K = indices.shape
    out = jnp.zeros((B, T, D), values.dtype)
    return out.at[jnp.arange(B)[:, None, None],
                  jnp.arange(T)[None, :, None],
                  indices].add(values)


def sparse_potentials(cfg: FeatureMapConfig, params: dict, indices, values):
    """Sparse frames: ``indices (..., T, K) int32``, ``values (..., T, K)``.

    Score contribution of pair k: values[k] * w[indices[k], label]; padding
    slots use index 0 with value 0.  Range routing selects which *indices*
    fall in the state vs transition range (matching the reference's
    dim-range semantics); out-of-range pairs contribute nothing.
    """
    L = cfg.num_expanded
    s0, s1 = cfg.state_range

    k_axis = indices.ndim - 1

    def seg(w, lo, hi, n_out_dims):
        in_rng = (indices >= lo) & (indices < hi)
        idx = jnp.clip(indices - lo, 0, w.shape[0] - 1)
        gathered = w[idx]                       # indices.shape + out dims
        val = jnp.where(in_rng, values, 0.0)
        val = val.reshape(val.shape + (1,) * n_out_dims)
        return jnp.sum(val * gathered, axis=k_axis)

    state = seg(params["w_state"], s0, s1, 1)
    if cfg.use_state_bias:
        state = state + params["b_state"]
    if cfg.frame_dependent_trans:
        t0, t1 = cfg.trans_range
        trans = seg(params["w_trans"], t0, t1, 2)
        if cfg.use_trans_bias:
            trans = trans + params["b_trans"]
    else:
        trans = params["b_trans"]
    return state, trans
