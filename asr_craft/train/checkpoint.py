"""Checkpoint/resume: full training state as one ``.npz`` per directory.

The reference checkpoints only flat per-epoch weight files and restarts
from them (SURVEY.md §5 "failure detection").  Here a checkpoint carries
``{params, optimizer state, averaged params, step, epoch, loader state}``
so ``--resume`` restores mid-training exactly (loss-curve continuity is
asserted in tests/e2e/test_toy_timit.py), plus the reference-style raw flat
weight export lives in models.weights.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import jax
import numpy as np


def _to_numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def save_checkpoint(path: str, trainer,
                    loader_state: Optional[Dict] = None) -> None:
    """Write a checkpoint directory at ``path``."""
    state = {
        "params": _to_numpy_tree(trainer.params),
        "opt_state": _to_numpy_tree(trainer.opt_state),
        "avg_params": _to_numpy_tree(trainer.avg_params),
    }
    meta = {"step": trainer.step, "epoch": trainer.epoch,
            "loader_state": loader_state or {}}
    os.makedirs(path, exist_ok=True)
    flat, _ = jax.tree.flatten(state)
    np.savez(os.path.join(path, "state.npz"),
             **{str(i): a for i, a in enumerate(flat)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, trainer) -> Dict:
    """Restore trainer state in place; returns loader state dict."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    template = {
        "params": _to_numpy_tree(trainer.params),
        "opt_state": _to_numpy_tree(trainer.opt_state),
        "avg_params": _to_numpy_tree(trainer.avg_params),
    }
    z = np.load(os.path.join(path, "state.npz"))
    flat, treedef = jax.tree.flatten(template)
    state = jax.tree.unflatten(treedef, [z[str(i)] for i in range(len(flat))])
    import jax.numpy as jnp
    trainer.params = jax.tree.map(jnp.asarray, state["params"])
    trainer.opt_state = jax.tree.map(jnp.asarray, state["opt_state"])
    trainer.avg_params = jax.tree.map(jnp.asarray, state["avg_params"])
    trainer.step = int(meta["step"])
    trainer.epoch = int(meta["epoch"])
    return meta.get("loader_state", {})
