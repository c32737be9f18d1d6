"""Observability & correctness-paranoia utilities (SURVEY.md §5).

The reference has no tracing/profiling/sanitizers (printf-only, single
thread).  Equivalents here:

- ``profiler_session`` / ``step_annotation``: jax.profiler traces (Perfetto/
  TensorBoard-compatible) around steps; driven by ``--profile_dir``.
- ``enable_debug_nans``: jax debug_nans/debug_infs toggles — the "sanitizer"
  of the XLA world.
- ``deterministic``: fixed-seed, no-host-time configuration for
  reproducible runs (the determinism flag SURVEY.md §5 calls for).
- ``assert_replicated``: the cross-device grad-sync assertion mode — pulls
  every addressable shard of nominally-replicated arrays and compares them,
  catching divergent data-parallel replicas (e.g. a missed psum).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax
import numpy as np


@contextlib.contextmanager
def profiler_session(profile_dir: Optional[str]) -> Iterator[None]:
    """Trace everything inside the context to ``profile_dir`` (no-op when
    None)."""
    if not profile_dir:
        yield
        return
    jax.profiler.start_trace(profile_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def step_annotation(name: str, step: int):
    """Named step marker visible in the trace viewer."""
    return jax.profiler.StepTraceAnnotation(name, step_num=step)


def enable_debug_nans(on: bool = True) -> None:
    jax.config.update("jax_debug_nans", on)
    jax.config.update("jax_debug_infs", on)


def deterministic(seed: int = 0) -> jax.Array:
    """Configure for reproducibility and return the root PRNG key.

    XLA executions are deterministic given deterministic inputs; the
    sources of nondeterminism to pin down are the PRNG seed and host-time-
    dependent code (which this framework avoids: presentation order derives
    from (seed, epoch), see data.loader).
    """
    jax.config.update("jax_threefry_partitionable", True)
    return jax.random.PRNGKey(seed)


def assert_replicated(tree, atol: float = 0.0, what: str = "params") -> None:
    """Assert every addressable shard of each (replicated) array is equal.

    Run every N steps under data parallelism to catch replica divergence —
    the analogue of a race detector for the DP training loop.
    """
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not hasattr(leaf, "addressable_shards"):
            continue
        shards = leaf.addressable_shards
        if len(shards) <= 1:
            continue
        ref = np.asarray(shards[0].data)
        for s in shards[1:]:
            got = np.asarray(s.data)
            if not np.allclose(ref, got, atol=atol, rtol=0):
                diff = float(np.max(np.abs(ref - got)))
                raise AssertionError(
                    f"{what}{jax.tree_util.keystr(path)} diverges across "
                    f"devices {shards[0].device} vs {s.device}: "
                    f"max abs diff {diff}")


def grad_sync_check_hook(every: int = 100):
    """Returns ``hook(step, params)`` to call from the training loop."""
    def hook(step: int, params) -> None:
        if every and step % every == 0:
            assert_replicated(params)
    return hook
