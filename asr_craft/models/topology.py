"""Label topologies: monophone and left-to-right n-state-per-phone.

The reference encodes topology in node classes (``CRF_StdStateNode`` for
1-state, ``CRF_StdNStateNode`` for the left-to-right n-state/"triphone-state"
case — SURVEY.md §2.1): the n-state node hard-codes that a state may only
self-loop or advance, with cross-phone transitions entering at a phone's
first state and leaving from its last.

Here topology is not a class hierarchy but a static boolean mask on the
expanded ``(L', L')`` transition matrix (``L' = num_labels * num_states``) —
SURVEY.md §7.0.  The mask is baked into potentials as an additive ``NEG_INF``
penalty, so every DP recursion stays a dense semiring scan; XLA folds the
constant mask into the fused transition add.

Expanded-state index convention: state ``s`` of phone ``p`` is
``p * num_states + s``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from asr_craft.ops.semiring import NEG_INF


@dataclasses.dataclass(frozen=True)
class Topology:
    """num_labels phones x num_states left-to-right states each."""

    num_labels: int
    num_states: int = 1

    @property
    def num_expanded(self) -> int:
        return self.num_labels * self.num_states

    def expand(self, phone):
        """First expanded state of each phone label (entry state)."""
        return phone * self.num_states

    def phone_of(self, state):
        """Map expanded-state index -> phone label. Works on arrays."""
        return state // self.num_states

    def transition_mask(self) -> np.ndarray:
        """(L', L') bool: True where a transition is allowed.

        Allowed: self-loop (s -> s); advance within a phone (s -> s+1);
        cross-phone from the last state of any phone to the first state of
        any phone.  With num_states == 1 every transition is allowed and the
        mask is all-True (monophone linear chain).
        """
        n, k = self.num_labels, self.num_states
        Lp = n * k
        idx = np.arange(Lp)
        phone, st = idx // k, idx % k
        mask = np.zeros((Lp, Lp), dtype=bool)
        # self loops
        mask[idx, idx] = True
        # advance within phone
        adv = st < k - 1
        mask[idx[adv], idx[adv] + 1] = True
        # last state -> first state of any phone
        last = idx[st == k - 1]
        first = idx[st == 0]
        mask[np.ix_(last, first)] = True
        return mask

    def transition_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L', L') additive penalty: 0 where allowed, NEG_INF otherwise."""
        return np.where(self.transition_mask(), 0.0, NEG_INF).astype(dtype)

    def start_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L',) additive penalty: paths must begin in a phone's first state
        (the n-state node's start-state masking — SURVEY.md §2.1).  All-zero
        for monophone."""
        st = np.arange(self.num_expanded) % self.num_states
        return np.where(st == 0, 0.0, NEG_INF).astype(dtype)

    def end_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L',) additive penalty: paths must end in a phone's last state."""
        st = np.arange(self.num_expanded) % self.num_states
        return np.where(st == self.num_states - 1, 0.0, NEG_INF).astype(dtype)

    def clamp_mask(self, phone_labels: np.ndarray) -> np.ndarray:
        """(T, L') additive penalty clamping frame t to states of phone
        ``phone_labels[t]`` — the numerator ("clamped") lattice used for the
        training criterion (see models.crf.CrfModel.loss). Works batched on
        a leading axis."""
        import jax.numpy as jnp
        states = jnp.arange(self.num_expanded)
        ok = self.phone_of(states)[None, :] == phone_labels[..., None]
        return jnp.where(ok, 0.0, NEG_INF).astype(jnp.float32)

    def path_to_phones(self, state_path):
        """Collapse an expanded-state Viterbi path to per-frame phone labels."""
        return self.phone_of(state_path)
