"""End-to-end recipe smoke tests (SURVEY.md §4.2 item 7, §7.2): a synthetic
separable "toy TIMIT" must train to near-zero PER in a few epochs."""
import numpy as np
import pytest

from asr_craft import data
from asr_craft.decode.scorer import ErrorRateScorer, score_batch
from asr_craft.models.crf import CrfConfig
from asr_craft.train import TrainConfig, Trainer
from asr_craft.utils.logging import MetricsLogger


def _toy_corpus(L=6, n=40, noise=0.3, seed=0):
    cfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=noise,
                               min_len=20, max_len=60, seed=seed)
    return data.generate_corpus(cfg, n)


def test_monophone_toy_trains_to_low_per():
    L = 6
    feats, labels, phones = _toy_corpus(L=L)
    tr_idx, cv_idx = data.train_cv_split(len(feats), 0.2, seed=1)
    lcfg = data.LoaderConfig(batch_size=8, buckets=(64,), seed=0)
    train_loader = data.UtteranceLoader(
        [feats[i] for i in tr_idx], [labels[i] for i in tr_idx], lcfg)
    cv_loader = data.UtteranceLoader(
        [feats[i] for i in cv_idx], [labels[i] for i in cv_idx],
        data.LoaderConfig(batch_size=8, buckets=(64,), shuffle=False))

    cfg = CrfConfig(num_labels=L, feat_dim=L)
    tc = TrainConfig(lr=1.0, epochs=4, log_every=1000)
    trainer = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))

    first = trainer.train_epoch(train_loader)
    # uid mapping: cv loader indexes into the cv subset
    refs = {i: phones[cv_idx[i]] for i in range(len(cv_idx))}
    for _ in range(tc.epochs - 1):
        trainer.train_epoch(train_loader)
    res = trainer.evaluate(cv_loader, ref_phone_seqs=refs)
    assert res["frame_accuracy"] > 0.9, res
    assert res["per"] < 0.1, res
    # loss decreased vs the first epoch
    assert res["cv_loss"] < first["mean_loss"]


def test_nstate_toy_trains():
    """Triphone-state-style config (BASELINE config 2): 2-state topology,
    state-granular targets from the synthetic aligner."""
    L = 5
    cfg_syn = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=0.3,
                                   min_len=16, max_len=50, seed=2,
                                   min_dur=3)
    feats, labels, phones = data.generate_corpus(cfg_syn, 24)
    state_labels = [data.nstate_frame_labels(l, 2) for l in labels]
    lcfg = data.LoaderConfig(batch_size=6, buckets=(64,), seed=0)
    loader = data.UtteranceLoader(feats, state_labels, lcfg)

    cfg = CrfConfig(num_labels=L, feat_dim=L, num_states=2)
    tc = TrainConfig(lr=0.5, epochs=3, log_every=1000)
    trainer = Trainer(cfg, tc, label_kind="state",
                      logger=MetricsLogger(quiet=True))
    first = trainer.train_epoch(loader)
    for _ in range(2):
        last = trainer.train_epoch(loader)
    assert last["mean_loss"] < first["mean_loss"]
    res = trainer.evaluate(loader)
    assert res["frame_accuracy"] > 0.8, res


def test_frame_dep_transitions_toy():
    """Transition feature functions driven by the acoustics (BASELINE
    config 2's 'transition feature functions')."""
    L = 4
    feats, labels, phones = _toy_corpus(L=L, n=20, seed=3)
    lcfg = data.LoaderConfig(batch_size=5, buckets=(64,), seed=0)
    loader = data.UtteranceLoader(feats, labels, lcfg)
    cfg = CrfConfig(num_labels=L, feat_dim=L, trans_range=(0, L))
    tc = TrainConfig(lr=0.5, epochs=3, log_every=1000)
    trainer = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    first = trainer.train_epoch(loader)
    for _ in range(2):
        last = trainer.train_epoch(loader)
    assert last["mean_loss"] < first["mean_loss"]


def test_checkpoint_resume(tmp_path):
    """Kill-and-resume continuity (SURVEY.md §5 failure detection): restored
    trainer continues from identical state."""
    from asr_craft.train import load_checkpoint, save_checkpoint
    L = 4
    feats, labels, _ = _toy_corpus(L=L, n=12, seed=4)
    lcfg = data.LoaderConfig(batch_size=4, buckets=(64,), seed=0)
    loader = data.UtteranceLoader(feats, labels, lcfg)
    cfg = CrfConfig(num_labels=L, feat_dim=L)
    tc = TrainConfig(lr=0.3, epochs=1, log_every=1000, momentum=0.9)
    t1 = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    t1.train_epoch(loader)
    save_checkpoint(str(tmp_path / "ckpt"), t1, loader.state())

    t2 = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    lstate = load_checkpoint(str(tmp_path / "ckpt"), t2)
    assert t2.step == t1.step and t2.epoch == t1.epoch
    loader2 = data.UtteranceLoader(feats, labels, lcfg)
    loader2.restore(lstate)

    # Continue both for one epoch: identical losses (exact resume).
    r1 = t1.train_epoch(loader)
    r2 = t2.train_epoch(loader2)
    np.testing.assert_allclose(r1["mean_loss"], r2["mean_loss"], rtol=1e-6)


def test_sparse_featuremap_e2e():
    """Sparse feature map end-to-end on one batch (capability parity with
    CRF_StdSparseFeatureMap)."""
    import jax
    import jax.numpy as jnp
    from asr_craft.models.crf import crf_loss
    rng = np.random.default_rng(0)
    L, D, K, B, T = 4, 12, 3, 3, 10
    cfg = CrfConfig(num_labels=L, feat_dim=D, featuremap="sparse")
    params = cfg.init_params()
    idx = jnp.asarray(rng.integers(0, D, size=(B, T, K)), jnp.int32)
    val = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, L, size=(B, T)), jnp.int32)
    lengths = jnp.asarray([10, 6, 8], jnp.int32)

    def loss_fn(p):
        return crf_loss(cfg, p, None, labels, lengths, sparse=(idx, val))[0]

    l0 = float(loss_fn(params))
    g = jax.grad(loss_fn)(params)
    p2 = jax.tree.map(lambda p, gg: p - 0.5 * gg, params, g)
    assert float(loss_fn(p2)) < l0
