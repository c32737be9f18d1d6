"""Streaming SCRF log-partition (ops.segmental_stream) vs the dense
materialized path: values AND gradients (the classical segmental fwd-bwd
custom VJP vs jax.grad through the dense scan) — VERDICT r1 missing #2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft.ops.segmental import segmental_forward_batch
from asr_craft.ops.segmental_stream import (seg_backward_stream,
                                            seg_forward_stream,
                                            seg_log_partition_stream,
                                            _invd)


def _dense_logZ(frame, bias, trans, lengths, mean_pool):
    """Materialized (B, T, Dmax, L) path — the models.segmental.seg_potentials
    construction + the enumeration-verified dense scan."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    cs = jnp.cumsum(frame, axis=1)
    cs = jnp.concatenate([jnp.zeros((B, 1, L), frame.dtype), cs], axis=1)
    ds = jnp.arange(Dmax)
    start = jnp.arange(T)[:, None] - ds[None, :]
    seg = cs[:, 1:][:, :, None, :] - cs[:, jnp.clip(start, 0, T)]
    if mean_pool:
        seg = seg / (ds + 1.0)[None, None, :, None]
    seg = seg + bias[None, None]
    _, logZ = segmental_forward_batch(seg, trans, lengths)
    return logZ


def _problem(rng, B, T, L, Dmax, scale=0.7):
    frame = jnp.asarray(rng.normal(size=(B, T, L)) * scale, jnp.float32)
    bias = jnp.asarray(rng.normal(size=(Dmax, L)) * scale, jnp.float32)
    trans = jnp.asarray(rng.normal(size=(L, L)) * scale, jnp.float32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=(B,)), jnp.int32)
    return frame, bias, trans, lengths


@pytest.mark.parametrize("shape,mean_pool", [
    ((3, 9, 4, 3), True), ((3, 9, 4, 3), False),
    ((2, 5, 8, 3), True),          # Dmax > T
    ((2, 6, 6, 2), True),          # Dmax == T
    ((4, 1, 2, 3), True),          # single frame
])
def test_stream_logZ_matches_dense(rng, shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(rng, B, T, L, Dmax)
    z_dense = _dense_logZ(frame, bias, trans, lengths, mean_pool)
    z_stream = seg_log_partition_stream(
        jnp.moveaxis(frame, 1, 0), bias, trans, lengths, Dmax, mean_pool)
    np.testing.assert_allclose(np.asarray(z_stream), np.asarray(z_dense),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,mean_pool", [
    ((3, 9, 4, 3), True), ((3, 9, 4, 3), False),
    ((2, 5, 8, 3), True), ((2, 6, 6, 2), True), ((4, 1, 2, 3), True),
])
def test_stream_grad_matches_dense(rng, shape, mean_pool):
    """Classical segmental fwd-bwd gradient == autodiff through the dense
    path, with a random per-sequence cotangent."""
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(rng, B, T, L, Dmax)
    w = jnp.asarray(rng.normal(size=(B,)), jnp.float32)   # mixed-sign cotangent

    def dense_obj(frame, bias, trans):
        return jnp.sum(w * _dense_logZ(frame, bias, trans, lengths,
                                       mean_pool))

    def stream_obj(frame, bias, trans):
        return jnp.sum(w * seg_log_partition_stream(
            jnp.moveaxis(frame, 1, 0), bias, trans, lengths, Dmax,
            mean_pool))

    gd = jax.grad(dense_obj, argnums=(0, 1, 2))(frame, bias, trans)
    gs = jax.grad(stream_obj, argnums=(0, 1, 2))(frame, bias, trans)
    for a, b, name in zip(gd, gs, ("frame", "bias", "trans")):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=3e-4, atol=3e-5, err_msg=name)


def test_beta_identity(rng):
    """alpha[t] + beta[t] marginalizes to logZ at every segment boundary:
    logsumexp_l(alpha[t, l] + beta[t, l]) is the log-mass of paths with a
    boundary after frame t, always <= logZ, == logZ at t = length-1."""
    B, T, Dmax, L = 3, 8, 3, 4
    frame, bias, trans, lengths = _problem(rng, B, T, L, Dmax)
    cum = jnp.cumsum(jnp.moveaxis(frame, 1, 0), axis=0)
    invd = _invd(Dmax, True)
    alphas, logZ = seg_forward_stream(cum, bias, trans, lengths, invd)
    betas = seg_backward_stream(cum, bias, trans, lengths, invd)
    ab = np.asarray(jax.nn.logsumexp(alphas + betas, axis=-1))  # (T, B)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_allclose(ab[n - 1, b], float(logZ[b]), rtol=1e-5)
        assert (ab[:n, b] <= float(logZ[b]) + 1e-4).all()


def test_zero_length_rows_inert(rng):
    """length-0 padding rows (loader batch padding) get zero gradient."""
    B, T, Dmax, L = 3, 6, 3, 3
    frame, bias, trans, _ = _problem(rng, B, T, L, Dmax)
    lengths = jnp.asarray([6, 0, 4], jnp.int32)
    w = jnp.asarray([1.0, 0.0, 1.0], jnp.float32)  # mask like the model does

    def obj(frame):
        return jnp.sum(w * seg_log_partition_stream(
            jnp.moveaxis(frame, 1, 0), bias, trans, lengths, Dmax, True))

    g = np.asarray(jax.grad(obj)(frame))
    assert np.abs(g[1]).max() == 0.0
    assert np.isfinite(g).all()
