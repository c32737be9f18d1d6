"""Device meshes and sharding placement for data-parallel training.

The reference is single-process (SURVEY.md §2.2); this layer is new and
required by BASELINE: training runs data-parallel over utterance batches
with a gradient all-reduce; transition matrices and feature weights
replicate per device.

Design: a 1-D ``("data",)`` mesh (a "time" axis is added only by the
time-sharded decode in :mod:`asr_craft.parallel.timeshard`).  Batches
are sharded on the leading utterance axis; parameters are replicated.  The
gradient all-reduce is *not* written by hand: with batch inputs sharded over
"data" and replicated-out params, XLA inserts the psum over ICI during jit
compilation (the modern ``NamedSharding`` equivalent of the snippets'
legacy pjit patterns — SNIPPETS.md).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local/global devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_2d(data: int, time: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "time") mesh (SURVEY.md §5): DP training shards batches
    over "data" with "time" = 1 in normal training; long-form decode flips
    to time > 1 for the lattice-sharded path (parallel.timeshard works over
    the "time" axis of any mesh containing it)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[:data * time]).reshape(data, time)
    return Mesh(devices, ("data", "time"))


def batch_shardings(mesh: Mesh, axis: str = "data") -> Dict[str, NamedSharding]:
    """Shardings for a batch dict: leading (utterance) axis sharded."""
    return {
        "feats": NamedSharding(mesh, P(axis, None, None)),
        "sparse_idx": NamedSharding(mesh, P(axis, None, None)),
        "sparse_val": NamedSharding(mesh, P(axis, None, None)),
        "labels": NamedSharding(mesh, P(axis, None)),
        "lengths": NamedSharding(mesh, P(axis)),
    }


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def make_batch_put(mesh: Mesh, axis: str = "data") -> Callable:
    """Returns ``put(batch_dict) -> batch_dict`` placing each array with its
    data-parallel sharding.  Batch size must divide the mesh size."""
    sh = batch_shardings(mesh, axis)

    def put(batch: Dict) -> Dict:
        return {k: jax.device_put(v, sh[k]) if k in sh else v
                for k, v in batch.items()}

    return put


def replicate_tree(mesh: Mesh, tree):
    """Replicate a parameter pytree across the mesh (weights replicate per
    chip — BASELINE)."""
    rep = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, rep), tree)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (``jax.distributed.initialize``).

    No-op when single-process (the common case in tests and on one host);
    on a pod slice each host calls this before building the global mesh.
    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS
    etc.) so launchers only set the environment.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num_processes,
        process_id=(process_id if process_id is not None
                    else int(os.environ.get("JAX_PROCESS_ID", "0"))),
    )


def data_shard_info() -> Dict[str, int]:
    """(shard_id, num_shards) for the host-sharded data loader."""
    return {"shard_id": jax.process_index(),
            "num_shards": jax.process_count()}
