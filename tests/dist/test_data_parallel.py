"""Data-parallel equivalence on a forced 8-device CPU mesh (SURVEY.md §4.2
item 5): sharded loss/grads/updates must equal single-device values, and the
full train step must keep params replicated."""
import jax
import jax.numpy as jnp
import numpy as np

from asr_craft.models.crf import CrfConfig, crf_loss
from asr_craft.parallel import (batch_shardings, make_batch_put,
                                make_mesh, replicate_tree)
from asr_craft.train import TrainConfig, make_train_step


def _batch(rng, cfg, B, T):
    feats = jnp.asarray(rng.normal(size=(B, T, cfg.feat_dim)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, cfg.num_labels, size=(B, T)),
                         jnp.int32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=(B,)), jnp.int32)
    return {"feats": feats, "labels": labels, "lengths": lengths}


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_loss_equals_single_device(rng):
    cfg = CrfConfig(num_labels=6, feat_dim=8)
    params = cfg.init_params(jax.random.PRNGKey(0), scale=0.3)
    batch = _batch(rng, cfg, B=16, T=12)

    loss_single, _ = jax.jit(
        lambda p, b: crf_loss(cfg, p, b["feats"], b["labels"], b["lengths"])
    )(params, batch)

    mesh = make_mesh(8)
    put = make_batch_put(mesh)
    sharded = put(batch)
    p_rep = replicate_tree(mesh, params)
    loss_sharded, _ = jax.jit(
        lambda p, b: crf_loss(cfg, p, b["feats"], b["labels"], b["lengths"])
    )(p_rep, sharded)
    np.testing.assert_allclose(float(loss_sharded), float(loss_single),
                               rtol=1e-6)


def test_sharded_grads_equal_single_device(rng):
    cfg = CrfConfig(num_labels=5, feat_dim=7, num_states=1)
    params = cfg.init_params(jax.random.PRNGKey(1), scale=0.3)
    batch = _batch(rng, cfg, B=8, T=10)

    def loss_fn(p, b):
        return crf_loss(cfg, p, b["feats"], b["labels"], b["lengths"])[0]

    g_single = jax.jit(jax.grad(loss_fn))(params, batch)

    mesh = make_mesh(8)
    put = make_batch_put(mesh)
    g_sharded = jax.jit(jax.grad(loss_fn))(replicate_tree(mesh, params),
                                           put(batch))
    for k in g_single:
        np.testing.assert_allclose(np.asarray(g_sharded[k]),
                                   np.asarray(g_single[k]),
                                   rtol=2e-5, atol=1e-6)


def test_full_train_step_sharded_matches_single(rng):
    cfg = CrfConfig(num_labels=4, feat_dim=6)
    tc = TrainConfig(lr=0.2, momentum=0.9)
    params = cfg.init_params()
    step_fn, opt = make_train_step(cfg, tc)
    batch = _batch(rng, cfg, B=16, T=9)
    lr = jnp.float32(0.2)

    p1, o1, a1, m1 = step_fn(params, opt.init(params), params, batch, lr)

    mesh = make_mesh(8)
    put = make_batch_put(mesh)
    p_rep = replicate_tree(mesh, params)
    p2, o2, a2, m2 = step_fn(p_rep, opt.init(p_rep), p_rep, put(batch), lr)

    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p2[k]), np.asarray(p1[k]),
                                   rtol=2e-5, atol=1e-6)
        # updated params stay replicated across the mesh
        assert p2[k].sharding.is_fully_replicated


def test_uneven_last_batch_via_padding(rng):
    """Loader pad rows (length 0) are inert under sharding: removing them
    changes nothing."""
    cfg = CrfConfig(num_labels=4, feat_dim=5)
    params = cfg.init_params(jax.random.PRNGKey(2), scale=0.2)
    batch = _batch(rng, cfg, B=8, T=8)
    # zero out rows 6,7 as loader padding
    batch["lengths"] = batch["lengths"].at[6:].set(0)

    def loss_sum(p, b):
        # sum-form loss (normalizer excluded) to compare subset vs padded
        _, aux = crf_loss(cfg, p, b["feats"], b["labels"], b["lengths"])
        return jnp.sum(aux["nll"])

    full = float(jax.jit(loss_sum)(params, batch))
    sub = {k: v[:6] for k, v in batch.items()}
    subset = float(jax.jit(loss_sum)(params, sub))
    np.testing.assert_allclose(full, subset, rtol=1e-6)

def test_scaling_check_mesh():
    """bench.py --scaling --check self-validates on the forced 8-device
    CPU mesh: per device count, DP-sharded loss/grads == single-device
    values on the same global batch (VERDICT r4 next #8)."""
    import bench
    rows = bench.bench_scaling(per_device_batch=1, T=32, steps=2,
                               check=True)
    assert rows["check_ok"], rows
    for n in (1, 2, 4, 8):
        assert rows[n]["check"]["ok"], rows[n]
