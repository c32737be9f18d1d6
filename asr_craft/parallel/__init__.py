"""Parallelism layer: meshes, data-parallel placement, time-sharded decode.

The reference has no distributed execution at all (SURVEY.md §2.2); this
package provides the scaling story: DP over a ``("data",)`` mesh
with XLA-inserted gradient psum, and time-axis sharding of the DP recursions
via the associative (semiring matrix product) formulation with ppermute
boundary exchange.
"""
from asr_craft.parallel.mesh import (batch_shardings, data_shard_info,
                                     initialize_distributed,
                                     make_batch_put, make_mesh,
                                     replicate_tree, replicated)
