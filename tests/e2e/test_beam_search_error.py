"""Beam search-error curve: beam strength vs exact-decode PER on the toy
corpus (SURVEY.md §7.3 item 6 / VERDICT r1 weak #5).

Path-score monotonicity in beam strength is exact (a stronger beam's
survivor set contains a weaker one's, so carried deltas dominate
elementwise); PER must coincide with exact search once the beam is
generous.
"""
import jax.numpy as jnp
import numpy as np

from asr_craft import data
from asr_craft.decode.scorer import ErrorRateScorer, score_batch
from asr_craft.models.crf import CrfConfig, decode
from asr_craft.train import TrainConfig, Trainer
from asr_craft.utils.logging import MetricsLogger


def _trained_setup(L=6, n=40):
    scfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=0.5,
                                min_len=20, max_len=40, seed=1)
    feats, labels, phones = data.generate_corpus(scfg, n)
    loader = data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=8, buckets=(64,),
                                         shuffle=False))
    cfg = CrfConfig(num_labels=L, feat_dim=L)
    tr = Trainer(cfg, TrainConfig(lr=1.0, epochs=2, log_every=1000),
                 logger=MetricsLogger(quiet=True))
    for _ in range(2):
        tr.train_epoch(loader)
    batch = next(iter(loader.epoch_batches(0)))
    refs = [phones[int(u)] if u >= 0 else None for u in batch["uids"]]
    return cfg, tr.params, batch, refs


def _per(phones, batch, refs):
    scorer = ErrorRateScorer()
    score_batch(scorer, refs, np.asarray(phones), batch["lengths"])
    return scorer.error_rate


def test_beam_width_search_error_curve():
    cfg, params, batch, refs = _trained_setup()
    feats = jnp.asarray(batch["feats"])
    lengths = jnp.asarray(batch["lengths"])
    ph_exact, _, sc_exact = decode(cfg, params, feats, lengths)
    per_exact = _per(ph_exact, batch, refs)

    prev_scores = None
    curve = {}
    for k in (1, 2, 4, 6):
        ph, _, sc = decode(cfg, params, feats, lengths, beam_width=k)
        sc = np.asarray(sc)
        # beam scores never exceed exact, and grow with beam width
        assert (sc <= np.asarray(sc_exact) + 1e-4).all(), k
        if prev_scores is not None:
            assert (sc >= prev_scores - 1e-4).all(), k
        prev_scores = sc
        curve[k] = _per(ph, batch, refs)
    print("search-error curve (beam_width -> PER):", curve,
          "exact:", per_exact)
    # full-width beam == exact search
    ph_full, _, sc_full = decode(cfg, params, feats, lengths, beam_width=6)
    np.testing.assert_array_equal(np.asarray(ph_full), np.asarray(ph_exact))
    assert curve[6] == per_exact
    # greedy beam cannot beat exact search error
    assert curve[1] >= per_exact


def test_beam_threshold_search_error_curve():
    cfg, params, batch, refs = _trained_setup()
    feats = jnp.asarray(batch["feats"])
    lengths = jnp.asarray(batch["lengths"])
    ph_exact, _, sc_exact = decode(cfg, params, feats, lengths)
    per_exact = _per(ph_exact, batch, refs)

    prev_scores = None
    curve = {}
    for thr in (0.1, 1.0, 5.0, 1e9):
        ph, _, sc = decode(cfg, params, feats, lengths, beam_threshold=thr)
        sc = np.asarray(sc)
        assert (sc <= np.asarray(sc_exact) + 1e-4).all(), thr
        if prev_scores is not None:
            assert (sc >= prev_scores - 1e-4).all(), thr
        prev_scores = sc
        curve[thr] = _per(ph, batch, refs)
    print("search-error curve (beam_threshold -> PER):", curve,
          "exact:", per_exact)
    assert curve[1e9] == per_exact
