"""Gradient accumulation and optimizer variants."""
import jax
import jax.numpy as jnp
import numpy as np

from asr_craft import data
from asr_craft.models.crf import CrfConfig
from asr_craft.train import TrainConfig, Trainer
from asr_craft.utils.logging import MetricsLogger


def _setup(seed=0, n=16):
    cfg_syn = data.SyntheticConfig(num_labels=4, feat_dim=4, noise=0.3,
                                   min_len=10, max_len=20, seed=seed)
    feats, labels, _ = data.generate_corpus(cfg_syn, n)
    loader = data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=4, buckets=(32,),
                                         shuffle=False))
    return loader


def test_accumulation_trains():
    """Training with accum_steps=2 converges and stays finite (the exact
    grad-sum property is asserted by test_accumulation_exact_grad_sum)."""
    cfg = CrfConfig(num_labels=4, feat_dim=4)
    tc = TrainConfig(lr=0.5, epochs=2, accum_steps=2, log_every=1000)
    tr = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    loader = _setup()
    first = tr.train_epoch(loader)
    last = tr.train_epoch(loader)
    assert last["mean_loss"] < first["mean_loss"]
    for leaf in jax.tree.leaves(tr.params):
        assert np.isfinite(np.asarray(leaf)).all()


def test_accumulation_exact_grad_sum():
    """grad_step really accumulates: two micro-batches == sum of grads."""
    from asr_craft.train.trainer import make_train_step
    cfg = CrfConfig(num_labels=3, feat_dim=3)
    tc = TrainConfig(lr=1.0)
    step, opt = make_train_step(cfg, tc)
    params = cfg.init_params(jax.random.PRNGKey(0), scale=0.2)
    rng = np.random.default_rng(0)

    def mk_batch(seed):
        r = np.random.default_rng(seed)
        return {"feats": jnp.asarray(r.normal(size=(2, 6, 3)), jnp.float32),
                "labels": jnp.asarray(r.integers(0, 3, size=(2, 6)),
                                      jnp.int32),
                "lengths": jnp.asarray([6, 4], jnp.int32)}

    b1, b2 = mk_batch(1), mk_batch(2)
    zero = jax.tree.map(jnp.zeros_like, params)
    acc, _ = step.grad_step(params, zero, b1)
    acc, _ = step.grad_step(params, acc, b2)

    from asr_craft.models.crf import crf_loss
    g1 = jax.grad(lambda p: crf_loss(cfg, p, b1["feats"], b1["labels"],
                                     b1["lengths"])[0])(params)
    g2 = jax.grad(lambda p: crf_loss(cfg, p, b2["feats"], b2["labels"],
                                     b2["lengths"])[0])(params)
    for k in params:
        np.testing.assert_allclose(np.asarray(acc[k]),
                                   np.asarray(g1[k]) + np.asarray(g2[k]),
                                   rtol=1e-5, atol=1e-6)


def test_lbfgs_optimizer_trains():
    """The quasi-Newton trainer variant (SURVEY.md §2.1 non-SG trainer slot)
    reduces the loss on separable synthetic data and keeps params finite."""
    cfg = CrfConfig(num_labels=4, feat_dim=4)
    tc = TrainConfig(lr=0.5, optimizer="lbfgs", epochs=3, log_every=1000)
    tr = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    loader = _setup()
    first = tr.train_epoch(loader)
    tr.train_epoch(loader)
    last = tr.train_epoch(loader)
    assert last["mean_loss"] < first["mean_loss"]
    for leaf in jax.tree.leaves(tr.params):
        assert np.isfinite(np.asarray(leaf)).all()


def test_steps_per_call_matches_sequential():
    """Fused multi-step (lax.scan over K batches) must produce the exact
    same params and per-step losses as K sequential single steps."""
    cfg = CrfConfig(num_labels=4, feat_dim=4)
    loader = _setup()
    tc_seq = TrainConfig(lr=0.3, epochs=1, log_every=1000)
    tc_fused = TrainConfig(lr=0.3, epochs=1, steps_per_call=3,
                           log_every=1000)
    tr_seq = Trainer(cfg, tc_seq, logger=MetricsLogger(quiet=True))
    tr_fused = Trainer(cfg, tc_fused, params=jax.tree.map(
        jnp.copy, tr_seq.params), logger=MetricsLogger(quiet=True))
    out_seq = tr_seq.train_epoch(loader)
    out_fused = tr_fused.train_epoch(loader)
    assert tr_seq.step == tr_fused.step
    np.testing.assert_allclose(out_seq["mean_loss"], out_fused["mean_loss"],
                               rtol=1e-6)
    for a, b in zip(jax.tree.leaves(tr_seq.params),
                    jax.tree.leaves(tr_fused.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_steps_per_call_bucket_boundary_flush():
    """Mixed bucket shapes force partial fused windows; step count and
    trailing flush must still cover every batch."""
    cfg_syn = data.SyntheticConfig(num_labels=4, feat_dim=4, noise=0.3,
                                   min_len=10, max_len=60, seed=1)
    feats, labels, _ = data.generate_corpus(cfg_syn, 20)
    loader = data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=4, buckets=(32, 64),
                                         shuffle=False))
    n_batches = sum(1 for _ in loader.epoch_batches(0))
    cfg = CrfConfig(num_labels=4, feat_dim=4)
    tc = TrainConfig(lr=0.3, epochs=1, steps_per_call=4, log_every=1000)
    tr = Trainer(cfg, tc, logger=MetricsLogger(quiet=True))
    tr.train_epoch(loader)
    assert tr.step == n_batches
