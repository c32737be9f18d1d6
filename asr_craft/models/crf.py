"""The CRF model: config + parameters + potentials + training criterion.

Capability-parity with ``CRF_Model`` (owns the lambda vector, label alphabet,
states-per-label, feature-map handle — SURVEY.md §2.1) and with the training
criterion computed by ``CRF_NewGradBuilder::buildGradient`` (§3.1): the
conditional log-likelihood  log p(y|x) = score(y) - logZ(x).

Differences from the reference:
- The numerator is a *clamped forward pass* (states inconsistent with the
  frame's phone label are masked to the semiring zero), which handles both
  monophone (single consistent path -> exact path score) and n-state
  topologies (marginalizes over within-phone state alignments) with the same
  scan as the denominator — no separate "alignment lattice" machinery.
- The gradient is ``jax.grad`` of the loss; the expected-count accumulation
  the reference hand-codes (``computeExpF``) is exactly what autodiff of the
  scan produces (verified in tests/oracle/test_grad_identity.py).
- Everything is batched over utterances and jit-compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from asr_craft.models.feature_map import (FeatureMapConfig,
                                          dense_potentials,
                                          densify_sparse,
                                          sparse_potentials)
from asr_craft.models.topology import Topology
from asr_craft.ops import fdt, fwdbwd, mxu
from asr_craft.ops.viterbi import viterbi_batch


def _log_partition(state, trans, lengths):
    """Dispatch: matmul formulation for shared (L, L) transitions
    (with its classical-forward-backward custom VJP); generic scan for
    frame-dependent transitions."""
    if trans.ndim == 2:
        return mxu.log_partition_mxu(state, trans, lengths)
    return fwdbwd.log_partition_batch(state, trans, lengths)
from asr_craft.ops.semiring import NEG_INF


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Model hyperparameters (the reference's ``crf_*`` flags)."""

    num_labels: int                       # phone alphabet (crf_label_size)
    feat_dim: int                         # input feature dim after windowing
    num_states: int = 1                   # states per label (crf_states)
    state_range: Optional[Tuple[int, int]] = None
    trans_range: Tuple[int, int] = (0, 0)
    use_state_bias: bool = True
    use_trans_bias: bool = True
    featuremap: str = "dense"             # "dense" | "sparse" (crf_featuremap)
    # matmul precision of the feature map (ops.fdt.matmul_precision):
    # "highest" (fp32, the parity bar) | "bf16x3" (three bf16 passes) |
    # "default" (TF32 on the GPU)
    precision: str = "highest"
    # n-state start/end state masking (paths enter a phone at its first state
    # and the utterance must end in a phone's last state) — the reference
    # n-state node's boundary masking.  No-op for num_states == 1.
    enforce_boundaries: bool = True

    @property
    def topology(self) -> Topology:
        return Topology(self.num_labels, self.num_states)

    @property
    def fmap(self) -> FeatureMapConfig:
        return FeatureMapConfig(
            feat_dim=self.feat_dim,
            num_expanded=self.topology.num_expanded,
            state_range=self.state_range,
            trans_range=self.trans_range,
            use_state_bias=self.use_state_bias,
            use_trans_bias=self.use_trans_bias,
            kind=self.featuremap,
            precision=self.precision,
        )

    def init_params(self, key=None, scale: float = 0.0):
        key = key if key is not None else jax.random.PRNGKey(0)
        return self.fmap.init_params(key, scale)


def potentials(cfg: CrfConfig, params, feats, sparse=None):
    """Feature frames -> (log_phi_state, log_phi_trans) with topology applied.

    ``feats``: (B, T, D) dense frames, or for the sparse map pass
    ``sparse=(indices, values)`` with (B, T, K) each (``feats`` ignored).
    Returns state (B, T, L') and trans (L', L') or (B, T, L', L'), with the
    n-state structural mask folded in as an additive NEG_INF penalty.
    """
    if cfg.featuremap == "sparse":
        if sparse is None:
            raise ValueError("sparse feature map needs sparse=(indices, values)")
        state, trans = sparse_potentials(cfg.fmap, params, *sparse)
    else:
        state, trans = dense_potentials(cfg.fmap, params, feats)
    if cfg.num_states > 1:
        trans = trans + jnp.asarray(cfg.topology.transition_penalty())
    return state, trans


def apply_boundaries(cfg: CrfConfig, state, lengths):
    """Fold start/end state masking into the state potentials.

    ``state``: (B, T, L'); frame 0 is restricted to phone entry states and
    frame ``length-1`` to phone exit states.  Identity for monophone or
    ``enforce_boundaries=False``.
    """
    if cfg.num_states == 1 or not cfg.enforce_boundaries:
        return state
    topo = cfg.topology
    T = state.shape[-2]
    start = jnp.asarray(topo.start_penalty())
    end = jnp.asarray(topo.end_penalty())
    state = state.at[..., 0, :].add(start)
    at_end = (jnp.arange(T)[None, :] == (lengths - 1)[:, None])
    return state + jnp.where(at_end[..., None], end[None, None, :], 0.0)


def crf_loss(cfg: CrfConfig, params, feats, labels, lengths, sparse=None,
             label_kind: str = "phone", grad_feats: bool = False):
    """Mean negative conditional log-likelihood per frame.

    ``labels``: (B, T) int32 frame labels — phone labels by default, or
    expanded-state labels with ``label_kind='state'`` (the reference's
    hardtarget streams can carry either; SURVEY.md §2.1 "hardtarget_*").
    Returns (loss, aux dict) where aux carries per-utterance logZ and
    numerator scores (the reference logs logZx per utterance).

    ``grad_feats``: set True when differentiating through ``feats`` (an
    upstream encoder / input saliency).  When False (the default), feats
    is stop_gradient'ed, so the feature cotangent is exactly zero —
    silently, not loudly: an encoder trained without setting this flag
    receives zero gradient.
    """
    if cfg.fmap.frame_dependent_trans:
        # topology-factored fast path (ops.fdt): never materializes the
        # (B, T, L', L') transition tensor.  Boundaries/clamp handled
        # inside.
        # Sparse inputs ride the same path through an exact on-device
        # densify (O(B T K) scatter — see feature_map.densify_sparse);
        # r3's sparse x frame-dependent cliff (materialized tensor +
        # generic scan) is gone.
        if cfg.featuremap == "sparse":
            if sparse is None:
                raise ValueError(
                    "sparse feature map needs sparse=(indices, values)")
            feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
        clamp_ns = 1 if label_kind == "state" else cfg.num_states
        raw_nll, logZ, num = fdt.fdt_nll_dual(
            cfg.fmap, cfg.num_states, params, feats, labels, lengths,
            clamp_ns, cfg.enforce_boundaries, grad_feats=grad_feats)
        nll = jnp.where(lengths > 0, raw_nll, 0.0)
        total_frames = jnp.maximum(jnp.sum(lengths), 1)
        return jnp.sum(nll) / total_frames, {
            "logZ": logZ, "numerator": num, "nll": nll,
            "frames": total_frames}
    state, trans = potentials(cfg, params, feats, sparse)
    state = apply_boundaries(cfg, state, lengths)
    if trans.ndim == 2:
        # fused dual-lattice objective: one kernel pass computes both the
        # free denominator and the label-clamped numerator (ops.mxu)
        ns = 1 if label_kind == "state" else cfg.num_states
        raw_nll, logZ, num = mxu.nll_dual(state, trans, labels, lengths, ns)
    else:
        logZ = _log_partition(state, trans, lengths)
        if label_kind == "state":
            states = jnp.arange(cfg.topology.num_expanded)
            clamp = jnp.where(labels[..., None] == states, 0.0, NEG_INF)
        else:
            clamp = cfg.topology.clamp_mask(labels)
        num = _log_partition(state + clamp, trans, lengths)
        raw_nll = logZ - num

    # empty rows (length 0: loader batch padding) are inert
    nll = jnp.where(lengths > 0, raw_nll, 0.0)     # (B,)
    total_frames = jnp.maximum(jnp.sum(lengths), 1)
    loss = jnp.sum(nll) / total_frames
    return loss, {"logZ": logZ, "numerator": num, "nll": nll,
                  "frames": total_frames}


def decode(cfg: CrfConfig, params, feats, lengths, sparse=None,
           beam_width: Optional[int] = None,
           beam_threshold: Optional[float] = None):
    """Batched Viterbi over expanded states, collapsed to per-frame phones.

    Beam options (both None = exact search; the reference
    ``CRF_ViterbiDecoder``'s threshold / max-active pruning modes):
    - ``beam_width``: top-k max-active pruning.
    - ``beam_threshold``: score-margin pruning.

    Returns (phone_frames (B, T), state_paths (B, T), scores (B,)).
    """
    if cfg.fmap.frame_dependent_trans:
        # factored max-plus decode: no (B, T, L', L') materialization;
        # sparse inputs densified exactly (see crf_loss)
        if cfg.featuremap == "sparse":
            if sparse is None:
                raise ValueError(
                    "sparse feature map needs sparse=(indices, values)")
            feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
        state, selfp, advp, crossp = fdt.factored_planes(
            params, feats, cfg.fmap.num_expanded, cfg.num_states,
            cfg.fmap.state_range, cfg.fmap.trans_range,
            cfg.fmap.use_state_bias, cfg.fmap.precision)
        paths, scores = fdt.fdt_viterbi(
            state, selfp, advp, crossp, lengths, cfg.num_states,
            cfg.enforce_boundaries, beam_width, beam_threshold)
        return cfg.topology.path_to_phones(paths), paths, scores
    state, trans = potentials(cfg, params, feats, sparse)
    state = apply_boundaries(cfg, state, lengths)
    paths, scores = viterbi_batch(state, trans, lengths, beam_width,
                                  beam_threshold)
    return cfg.topology.path_to_phones(paths), paths, scores


def frame_posteriors(cfg: CrfConfig, params, feats, lengths, sparse=None):
    """(B, T, L') label posteriors — the parity tensor surface.

    Frame-dependent-transition configs ride the factored scan
    (ops.fdt.fdt_posteriors) so the surface exists at shapes where the
    (B, T, L', L') tensor does not; sparse inputs densify exactly."""
    if cfg.fmap.frame_dependent_trans:
        if cfg.featuremap == "sparse":
            if sparse is None:
                raise ValueError(
                    "sparse feature map needs sparse=(indices, values)")
            feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
        state, selfp, advp, crossp = fdt.factored_planes(
            params, feats, cfg.fmap.num_expanded, cfg.num_states,
            cfg.fmap.state_range, cfg.fmap.trans_range,
            cfg.fmap.use_state_bias, cfg.fmap.precision)
        return fdt.fdt_posteriors(state, selfp, advp, crossp, lengths,
                                  cfg.num_states, cfg.enforce_boundaries)
    state, trans = potentials(cfg, params, feats, sparse)
    state = apply_boundaries(cfg, state, lengths)
    if trans.ndim == 2:
        return mxu.posteriors_mxu(state, trans, lengths)
    return fwdbwd.posteriors_batch(state, trans, lengths)


def frame_accuracy(phone_frames, labels, lengths):
    """Fraction of valid frames with correct phone label (the reference's
    per-epoch CV metric)."""
    T = labels.shape[-1]
    valid = jnp.arange(T)[None, :] < lengths[:, None]
    correct = (phone_frames == labels) & valid
    return jnp.sum(correct) / jnp.maximum(jnp.sum(valid), 1)
