"""Sparse feature path: sparsify/densify, file round-trip, loader batches,
dense<->sparse potential and loss equivalence (SURVEY.md §2.1 "Sparse
feature map": QuickNet sparse (index, value) streams)."""
import numpy as np
import pytest

import jax.numpy as jnp

from asr_craft import data
from asr_craft.data.sparse import (densify, read_sparse_file,
                                   sparsify_frames, write_sparse_file)
from asr_craft.models.crf import CrfConfig, crf_loss, decode
from asr_craft.models.feature_map import (FeatureMapConfig,
                                          dense_potentials,
                                          sparse_potentials)


def test_sparsify_roundtrip_exact(rng):
    x = rng.normal(size=(11, 7)).astype(np.float32)
    idx, val = sparsify_frames(x, 7)
    np.testing.assert_allclose(densify(idx, val, 7), x)


def test_sparsify_topk_keeps_largest(rng):
    x = np.zeros((5, 10), np.float32)
    x[:, 2] = 3.0
    x[:, 7] = -5.0
    x[:, 4] = 0.1
    idx, val = sparsify_frames(x, 2)
    d = densify(idx, val, 10)
    assert (d[:, 2] == 3.0).all() and (d[:, 7] == -5.0).all()
    assert (d[:, 4] == 0.0).all()


def test_sparse_file_roundtrip(tmp_path, rng):
    utts = []
    labels = []
    for T in (5, 9):
        x = (rng.random((T, 6)) < 0.3) * rng.normal(size=(T, 6))
        utts.append(sparsify_frames(x.astype(np.float32), 4))
        labels.append(rng.integers(0, 3, size=T).astype(np.int32))
    path = str(tmp_path / "c.spf")
    write_sparse_file(path, utts, feat_dim=6, labels=labels)
    corpus = read_sparse_file(path)
    assert corpus.feat_dim == 6
    assert len(corpus.features) == 2
    for (i1, v1), (i2, v2), l1, l2 in zip(
            utts, corpus.features, labels, corpus.labels):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("trans_range", [(0, 0), (3, 6)])
def test_dense_sparse_potentials_equal(rng, trans_range):
    """Top-K = D sparsification: identical potentials, incl. range routing
    and frame-dependent transitions."""
    D, L = 6, 4
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=L, state_range=(0, 4),
                           trans_range=trans_range)
    params = cfg.init_params(__import__("jax").random.PRNGKey(0), scale=0.3)
    x = rng.normal(size=(2, 9, D)).astype(np.float32)
    idxs, vals = zip(*(sparsify_frames(f, D) for f in x))
    sp = (jnp.asarray(np.stack(idxs)), jnp.asarray(np.stack(vals)))
    s_d, t_d = dense_potentials(cfg, params, jnp.asarray(x))
    s_s, t_s = sparse_potentials(cfg, params, *sp)
    np.testing.assert_allclose(np.asarray(s_d), np.asarray(s_s), atol=1e-5)
    np.testing.assert_allclose(np.asarray(t_d), np.asarray(t_s), atol=1e-5)


def test_one_hot_sparse_potentials(rng):
    """One-hot frames: K=1 sparse pairs reproduce the dense potentials —
    the reference's canonical sparse-stream use case."""
    D, L, T = 8, 3, 6
    cfg = FeatureMapConfig(feat_dim=D, num_expanded=L)
    params = cfg.init_params(__import__("jax").random.PRNGKey(1), scale=0.5)
    hot = rng.integers(0, D, size=(T,))
    x = np.eye(D, dtype=np.float32)[hot]
    idx = hot[:, None].astype(np.int32)
    val = np.ones((T, 1), np.float32)
    s_d, _ = dense_potentials(cfg, params, jnp.asarray(x[None]))
    s_s, _ = sparse_potentials(cfg, params, jnp.asarray(idx[None]),
                               jnp.asarray(val[None]))
    np.testing.assert_allclose(np.asarray(s_d), np.asarray(s_s), atol=1e-6)


def test_loader_sparse_batches(rng):
    scfg = data.SyntheticConfig(num_labels=3, feat_dim=3, seed=0,
                                min_len=8, max_len=16)
    feats, labels, _ = data.generate_corpus(scfg, 6)
    loader = data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=3, buckets=(32,),
                                         shuffle=False, sparse_k=3))
    batches = list(loader.epoch_batches(0))
    assert batches and "sparse_idx" in batches[0]
    b = batches[0]
    assert b["sparse_idx"].shape == b["sparse_val"].shape
    assert b["sparse_idx"].shape[:2] == b["labels"].shape
    # densified batch equals the dense loader's batch
    dense = list(data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=3, buckets=(32,),
                                         shuffle=False)).epoch_batches(0))[0]
    for r in range(3):
        np.testing.assert_allclose(
            densify(b["sparse_idx"][r], b["sparse_val"][r], 3),
            dense["feats"][r], atol=1e-6)


def test_loader_sparse_tuple_input(rng):
    utts = [sparsify_frames(rng.normal(size=(10, 5)).astype(np.float32), 3)
            for _ in range(4)]
    labels = [rng.integers(0, 2, size=10).astype(np.int32) for _ in range(4)]
    loader = data.UtteranceLoader(
        utts, labels, data.LoaderConfig(batch_size=2, buckets=(16,),
                                        shuffle=False), feat_dim=5)
    assert loader.is_sparse and loader.feat_dim == 5
    b = next(iter(loader.epoch_batches(0)))
    assert b["sparse_idx"].shape == (2, 16, 3)


def test_crf_loss_dense_sparse_equal(rng):
    D, L = 5, 4
    cfg_d = CrfConfig(num_labels=L, feat_dim=D)
    cfg_s = CrfConfig(num_labels=L, feat_dim=D, featuremap="sparse")
    params = cfg_d.init_params(scale=0.2)
    x = rng.normal(size=(3, 12, D)).astype(np.float32)
    labels = jnp.asarray(rng.integers(0, L, size=(3, 12)), jnp.int32)
    lengths = jnp.asarray([12, 7, 10], jnp.int32)
    idxs, vals = zip(*(sparsify_frames(f, D) for f in x))
    sp = (jnp.asarray(np.stack(idxs)), jnp.asarray(np.stack(vals)))
    loss_d, _ = crf_loss(cfg_d, params, jnp.asarray(x), labels, lengths)
    loss_s, _ = crf_loss(cfg_s, params, None, labels, lengths, sparse=sp)
    np.testing.assert_allclose(float(loss_d), float(loss_s), rtol=1e-5)
    ph_d, _, _ = decode(cfg_d, params, jnp.asarray(x), lengths)
    ph_s, _, _ = decode(cfg_s, params, None, lengths, sparse=sp)
    np.testing.assert_array_equal(np.asarray(ph_d), np.asarray(ph_s))
