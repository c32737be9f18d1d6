"""Time-sharded (lattice-sharded) DP vs the unsharded path on the 8-device
CPU mesh: logZ, Viterbi score and path must match exactly (SURVEY.md §7.3
item 5 — shard-boundary correctness)."""
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft import ops
from asr_craft.parallel.timeshard import (sharded_log_partition,
                                          sharded_viterbi, time_mesh)


def _problem(rng, B, T, L):
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return (jnp.asarray(state), jnp.asarray(trans), jnp.asarray(lengths))


@pytest.mark.parametrize("T", [16, 40])
def test_sharded_logZ_matches_unsharded(rng, T):
    B, L = 3, 5
    state, trans, lengths = _problem(rng, B, T, L)
    mesh = time_mesh(8)
    logZ_sh = sharded_log_partition(state, trans, lengths, mesh)
    logZ_ref = ops.log_partition_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(logZ_sh), np.asarray(logZ_ref),
                               rtol=1e-5, atol=1e-6)


def test_sharded_tropical_score(rng):
    B, T, L = 2, 24, 4
    state, trans, lengths = _problem(rng, B, T, L)
    mesh = time_mesh(8)
    sc_sh = sharded_log_partition(state, trans, lengths, mesh,
                                  semiring="tropical")
    _, sc_ref = ops.viterbi_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(sc_sh), np.asarray(sc_ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T,n_dev", [(16, 8), (24, 4), (12, 2)])
def test_sharded_viterbi_matches_unsharded(rng, T, n_dev):
    B, L = 3, 5
    state, trans, lengths = _problem(rng, B, T, L)
    mesh = time_mesh(n_dev)
    path_sh, score_sh = sharded_viterbi(state, trans, lengths, mesh)
    path_ref, score_ref = ops.viterbi_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(score_sh), np.asarray(score_ref),
                               rtol=1e-5, atol=1e-6)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(path_sh)[b, :n],
                                      np.asarray(path_ref)[b, :n])


def test_sharded_viterbi_short_lengths(rng):
    """Sequences that end inside the first shard."""
    B, T, L = 2, 16, 4
    state = jnp.asarray(rng.normal(size=(B, T, L)), jnp.float32)
    trans = jnp.asarray(rng.normal(size=(L, L)), jnp.float32)
    lengths = jnp.asarray([1, 2], jnp.int32)
    mesh = time_mesh(8)
    path_sh, score_sh = sharded_viterbi(state, trans, lengths, mesh)
    path_ref, score_ref = ops.viterbi_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(score_sh), np.asarray(score_ref),
                               rtol=1e-5)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(path_sh)[b, :n],
                                      np.asarray(path_ref)[b, :n])


def test_2d_mesh_dp_plus_timeshard(rng):
    """A ("data", "time") mesh: DP loss on the data axis and time-sharded
    logZ on the time axis coexist (SURVEY.md §5 mesh design)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from asr_craft.models.crf import CrfConfig, crf_loss
    from asr_craft.parallel import replicate_tree
    from asr_craft.parallel.mesh import make_mesh_2d

    mesh = make_mesh_2d(4, 2)
    cfg = CrfConfig(num_labels=4, feat_dim=5)
    params = cfg.init_params(jax.random.PRNGKey(0), scale=0.3)
    B, T = 8, 16
    feats = jnp.asarray(rng.normal(size=(B, T, 5)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 4, size=(B, T)), jnp.int32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=(B,)), jnp.int32)

    ref_loss, ref_aux = jax.jit(
        lambda p, f, l, n: crf_loss(cfg, p, f, l, n))(
        params, feats, labels, lengths)

    fs = jax.device_put(feats, NamedSharding(mesh, P("data", None, None)))
    ls = jax.device_put(labels, NamedSharding(mesh, P("data", None)))
    ns = jax.device_put(lengths, NamedSharding(mesh, P("data")))
    p_rep = replicate_tree(mesh, params)
    got_loss, _ = jax.jit(lambda p, f, l, n: crf_loss(cfg, p, f, l, n))(
        p_rep, fs, ls, ns)
    np.testing.assert_allclose(float(got_loss), float(ref_loss), rtol=1e-6)

    # time-sharded logZ over the same mesh's "time" axis
    from asr_craft.parallel.timeshard import sharded_log_partition
    from asr_craft.models.crf import potentials
    state, trans = potentials(cfg, params, feats)
    logZ_sh = sharded_log_partition(state, trans, lengths, mesh)
    logZ_ref = ops.log_partition_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(logZ_sh), np.asarray(logZ_ref),
                               rtol=1e-5, atol=1e-6)


def test_pruned_sharded_equals_masked_unsharded(rng):
    """beam_labels=K: the pruned sharded decode == the unsharded decode on
    the survivor-masked lattice (identical label sets by construction),
    and K=L == exact (VERDICT r3 next #4a/d)."""
    import jax
    from asr_craft.ops.semiring import NEG_INF
    from asr_craft.parallel.timeshard import (sharded_viterbi,
                                              survivor_mask, time_mesh)

    B, T, L, K = 3, 64, 12, 5
    mesh = time_mesh()
    N = mesh.shape["time"]
    state = jnp.asarray(rng.normal(size=(B, T, L)) * 2.0, jnp.float32)
    trans = jnp.asarray(rng.normal(size=(L, L)) * 0.4, jnp.float32)
    lengths = jnp.asarray([T, T - 9, 2 * T // N + 3], jnp.int32)

    path_p, score_p = sharded_viterbi(state, trans, lengths, mesh,
                                      beam_labels=K)
    mask = survivor_mask(state, lengths, N, K)
    state_masked = jnp.where(mask, state, NEG_INF)
    path_ref, score_ref = ops.viterbi_batch(state_masked, trans, lengths)
    np.testing.assert_allclose(np.asarray(score_p), np.asarray(score_ref),
                               rtol=1e-5, atol=1e-5)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(path_p)[b, :n],
                                      np.asarray(path_ref)[b, :n])

    # K = L: pruning inert, equals exact
    path_x, score_x = sharded_viterbi(state, trans, lengths, mesh,
                                      beam_labels=L)
    path_e, score_e = ops.viterbi_batch(state, trans, lengths)
    np.testing.assert_allclose(np.asarray(score_x), np.asarray(score_e),
                               rtol=1e-5, atol=1e-5)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(np.asarray(path_x)[b, :n],
                                      np.asarray(path_e)[b, :n])
