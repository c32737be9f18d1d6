"""Core DP operations: semirings, forward-backward, Viterbi, segmental.

This is the layer everything else in the framework is held to (SURVEY.md
§7.1 step 1): pure-jnp ``lax.scan`` implementations plus float64 NumPy
oracles (:mod:`asr_craft.ops.oracle`), themselves verified against
brute-force path enumeration in ``tests/oracle/``.
"""
from asr_craft.ops.semiring import (LOG, NEG_INF, TROPICAL, Semiring,
                                    get_semiring, matmul, matvec)
from asr_craft.ops.fwdbwd import (backward, broadcast_trans, forward,
                                  forward_batch, log_partition,
                                  log_partition_batch, path_score,
                                  path_score_batch, posteriors,
                                  posteriors_batch)
from asr_craft.ops.viterbi import viterbi, viterbi_batch
from asr_craft.ops.segmental import (segmental_forward,
                                     segmental_forward_batch,
                                     segmental_viterbi,
                                     segmental_viterbi_batch,
                                     segments_to_frames)
