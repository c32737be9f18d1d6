"""Recipe 4 (BASELINE config 4): segmental CRF (SCRF).

Variable-duration segment lattice scoring: pooled frame features +
duration/label biases, segment-level transitions; trained on the segmental
log-likelihood with the gold segmentation as numerator; decoded with the
segmental Viterbi (ops.segmental).

Self-contained driver (the linear-chain CLI covers recipes 1-3; the SCRF
training criterion/decoder differ enough to warrant a dedicated loop).

Run:  python recipes/scrf.py [--utts 100] [--epochs 30] [--platform cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--utts", type=int, default=100)
    p.add_argument("--eval_utts", type=int, default=0,
                   help="held-out utterances for PER (decode_only and the "
                        "final eval); 0 = score the training corpus (the "
                        "r4 behavior).  VERDICT r4 next #6: the parity "
                        "cells need >=5k eval tokens so a single fp32 "
                        "near-tie flip is <1%% relative")
    p.add_argument("--labels", type=int, default=12)
    p.add_argument("--max_dur", type=int, default=16)
    p.add_argument("--seg_states", type=int, default=1,
                   help="sub-states per segment (n-state segmental, "
                        "CRF_StdSegNStateNode capability)")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--out_dir", default="./runs/scrf")
    p.add_argument("--dense_loss", action="store_true",
                   help="train with the materialized (B,T,Dmax,L) oracle "
                        "loss instead of the streaming fused loss")
    p.add_argument("--platform", default=None)
    p.add_argument("--decode_only", default=None,
                   help="skip training: load this scrf_weights.npz, decode "
                        "the (seeded, deterministic) corpus, report PER — "
                        "the same-weights parity probe")
    args = p.parse_args(argv)

    import os
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from asr_craft import data
    from asr_craft.decode.scorer import ErrorRateScorer, score_batch
    from asr_craft.models import weights as weights_mod
    from asr_craft.models.segmental import (SegCrfConfig,
                                            scrf_frame_labels, scrf_loss,
                                            scrf_loss_fused)
    from asr_craft.utils.logging import MetricsLogger

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))

    L = args.labels
    scfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=args.noise,
                                min_len=20, max_len=64, mean_dur=4.0,
                                min_dur=2, seed=0)
    n_total = args.utts + args.eval_utts
    feats_l, labels_l, phones = data.generate_corpus(scfg, n_total)
    T = 64
    B = len(feats_l)
    feats = np.zeros((B, T, L), np.float32)
    labels = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, (f, l) in enumerate(zip(feats_l, labels_l)):
        n = min(len(f), T)
        feats[i, :n], labels[i, :n], lengths[i] = f[:n], l[:n], n

    cfg = SegCrfConfig(num_labels=L, feat_dim=L, max_dur=args.max_dur,
                       num_states=args.seg_states)
    params = cfg.init_params()
    feats, labels, lengths = map(jnp.asarray, (feats, labels, lengths))
    # held-out eval slice (deterministic — same seeded corpus on every
    # invocation, so same-weights cross-backend decodes see one set)
    if args.eval_utts:
        ev = slice(args.utts, n_total)
    else:
        ev = slice(0, args.utts)
    feats_ev, labels_ev, lengths_ev = feats[ev], labels[ev], lengths[ev]
    phones_ev = phones[ev]
    feats, labels, lengths = (feats[:args.utts], labels[:args.utts],
                              lengths[:args.utts])

    def evaluate(params):
        frames, _ = scrf_frame_labels(cfg, params, feats_ev, lengths_ev)
        scorer = ErrorRateScorer()
        score_batch(scorer, phones_ev, np.asarray(frames),
                    np.asarray(lengths_ev))
        logger.log("eval", per=scorer.error_rate,
                   eval_utts=int(lengths_ev.shape[0]), **scorer.summary())

    if args.decode_only:
        params = weights_mod.load_npz(args.decode_only)
        params = {k: jnp.asarray(v) for k, v in params.items()}
        evaluate(params)
        return 0

    import optax
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)
    loss = scrf_loss if args.dense_loss else scrf_loss_fused
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p: loss(cfg, p, feats, labels, lengths)[0]))

    @jax.jit
    def step(params, opt_state):
        loss, g = loss_grad(params)
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for epoch in range(args.epochs):
        params, opt_state, loss = step(params, opt_state)
        if epoch % 25 == 0 or epoch == args.epochs - 1:
            logger.log("train_epoch", epoch=epoch, loss=float(loss))

    evaluate(params)
    weights_mod.save_npz(os.path.join(args.out_dir, "scrf_weights.npz"),
                         params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
