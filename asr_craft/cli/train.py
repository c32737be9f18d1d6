"""``crf-train``: the reference ``CRFTrain`` CLI.

Flow (SURVEY.md §3.1): flags/recipe -> corpus + transforms -> loaders ->
model init (fresh or from weight file) -> batched jit-compiled SGD epochs
with per-epoch weight files, CV evaluation (frame accuracy + PER), and
optional full-state checkpoint/resume; data-parallel over all visible
devices when more than one is present.

Run ``python -m asr_craft.cli.train --help``; e.g. a synthetic smoke
run: ``python -m asr_craft.cli.train --synthetic_utts 50
--crf_label_size 8 --crf_epochs 2 --out_dir /tmp/run``.
"""
from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from asr_craft.cli.common import build_corpus, make_transform
from asr_craft.data import LoaderConfig, UtteranceLoader, train_cv_split
from asr_craft.models import weights as weights_mod
from asr_craft.models.crf import CrfConfig
from asr_craft.parallel import (data_shard_info, initialize_distributed,
                                make_batch_put, make_mesh, replicate_tree)
from asr_craft.train import (TrainConfig, Trainer, load_checkpoint,
                             save_checkpoint)
from asr_craft.utils.compile_cache import enable_compile_cache
from asr_craft.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a (linear-chain) CRF acoustic model")
    # data (QuickNet-style flags)
    p.add_argument("--ftr1_file", help="pfile with features (+labels)")
    p.add_argument("--ftr2_file", help="2nd feature pfile to concatenate")
    p.add_argument("--ftr3_file", help="3rd feature pfile to concatenate")
    p.add_argument("--hardtarget_file", help="label pfile (else ftr1 labels)")
    p.add_argument("--htk_scp", help="list of HTK feature files "
                   "(one per line, optionally key=path)")
    p.add_argument("--label_mlf", help="MLF with frame-time labels "
                   "for --htk_scp utterances")
    p.add_argument("--phone_names", help="one phone name per line "
                   "(maps MLF labels to indices)")
    p.add_argument("--window_extent", type=int, default=0,
                   help="+/- context frames")
    p.add_argument("--deltas_order", type=int, default=0)
    p.add_argument("--normalize", choices=["none", "global", "utt"],
                   default="none")
    p.add_argument("--synthetic_utts", type=int, default=0,
                   help="use a synthetic corpus of N utterances")
    p.add_argument("--synthetic_noise", type=float, default=0.4)
    p.add_argument("--cv_fraction", type=float, default=0.1)
    # model
    p.add_argument("--crf_label_size", type=int, required=True)
    p.add_argument("--crf_states", type=int, default=1)
    p.add_argument("--crf_featuremap", choices=["dense", "sparse"],
                   default="dense")
    p.add_argument("--sparse_topk", type=int, default=0,
                   help="with --crf_featuremap sparse on a dense source: "
                        "keep the K largest-magnitude dims per frame "
                        "(0 = all dims, i.e. exact)")
    p.add_argument("--crf_stateftr_start", type=int, default=None)
    p.add_argument("--crf_stateftr_end", type=int, default=None)
    p.add_argument("--crf_transftr_start", type=int, default=0)
    p.add_argument("--crf_transftr_end", type=int, default=0)
    p.add_argument("--crf_use_state_bias", type=int, default=1)
    p.add_argument("--crf_use_trans_bias", type=int, default=1)
    p.add_argument("--precision", choices=["highest", "bf16x3", "default"],
                   default="highest",
                   help="feature-map matmul precision: highest = fp32 "
                        "(parity bar), bf16x3 = three bf16 passes, "
                        "default = XLA's default (TF32 on the GPU -- "
                        "validate PER before trusting)")
    p.add_argument("--label_kind", choices=["phone", "state"],
                   default="phone")
    p.add_argument("--init_weight_file", help="warm-start flat weight file")
    # training
    p.add_argument("--crf_lr", type=float, default=0.05)
    p.add_argument("--crf_lr_decay", type=float, default=1.0)
    p.add_argument("--crf_epochs", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adagrad", "lbfgs"])
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--weight_avg", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation micro-batches per update "
                        "(the reference's bunch-SGD analogue)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="fuse K optimizer steps into one jit dispatch "
                        "(lax.scan over K stacked batches)")
    p.add_argument("--bucket_sizes", default="128,256,512,1024,2048")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", default="./crf_out")
    p.add_argument("--resume", action="store_true",
                   help="resume from out_dir/ckpt")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu/gpu)")
    # observability / sanitizers (SURVEY.md §5)
    p.add_argument("--profile_dir", default=None,
                   help="dump a jax.profiler trace of training here")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--check_sync_every", type=int, default=0,
                   help="assert DP replicas identical every N steps")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    if args.debug_nans:
        from asr_craft.utils.diagnostics import enable_debug_nans
        enable_debug_nans()
    initialize_distributed()
    shard = data_shard_info()

    feats, labels, _ = build_corpus(args)
    transform, feat_dim = make_transform(args, feats)
    sparse_input = feats and isinstance(feats[0], tuple)
    if sparse_input and args.crf_featuremap != "sparse":
        raise SystemExit("sparse feature input requires "
                         "--crf_featuremap sparse")
    sparse_k = None
    if args.crf_featuremap == "sparse" and not sparse_input:
        sparse_k = args.sparse_topk or feat_dim
    tr_idx, cv_idx = train_cv_split(len(feats), args.cv_fraction, args.seed)
    buckets = tuple(int(x) for x in args.bucket_sizes.split(","))
    train_loader = UtteranceLoader(
        [feats[i] for i in tr_idx], [labels[i] for i in tr_idx],
        LoaderConfig(batch_size=args.batch_size, buckets=buckets,
                     seed=args.seed, sparse_k=sparse_k, **shard),
        transform=transform, feat_dim=feat_dim)
    cv_loader = UtteranceLoader(
        [feats[i] for i in cv_idx], [labels[i] for i in cv_idx],
        LoaderConfig(batch_size=args.batch_size, buckets=buckets,
                     shuffle=False, sparse_k=sparse_k, **shard),
        transform=transform, feat_dim=feat_dim)

    state_rng = ((args.crf_stateftr_start, args.crf_stateftr_end)
                 if args.crf_stateftr_start is not None else None)
    cfg = CrfConfig(
        num_labels=args.crf_label_size, feat_dim=feat_dim,
        num_states=args.crf_states, featuremap=args.crf_featuremap,
        state_range=state_rng,
        trans_range=(args.crf_transftr_start, args.crf_transftr_end),
        use_state_bias=bool(args.crf_use_state_bias),
        use_trans_bias=bool(args.crf_use_trans_bias),
        precision=args.precision)
    params = None
    if args.init_weight_file:
        params = {k: jnp.asarray(v) for k, v in weights_mod.load_raw(
            args.init_weight_file, cfg.fmap).items()}

    tc = TrainConfig(
        lr=args.crf_lr, lr_decay=args.crf_lr_decay, epochs=args.crf_epochs,
        momentum=args.momentum, optimizer=args.optimizer, l2=args.l2,
        weight_avg=bool(args.weight_avg), log_every=args.log_every,
        accum_steps=args.accum_steps, steps_per_call=args.steps_per_call,
        out_dir=args.out_dir, profile_dir=args.profile_dir,
        check_sync_every=args.check_sync_every)
    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))
    trainer = Trainer(cfg, tc, params=params, label_kind=args.label_kind,
                     logger=logger)

    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    if args.resume and os.path.exists(os.path.join(ckpt_dir, "meta.json")):
        lstate = load_checkpoint(ckpt_dir, trainer)
        train_loader.restore(lstate)
        logger.log("resume", step=trainer.step, epoch=trainer.epoch)

    put = None
    if len(jax.devices()) > 1:
        mesh = make_mesh()
        put = make_batch_put(mesh)
        trainer.params = replicate_tree(mesh, trainer.params)
        trainer.opt_state = trainer.opt.init(trainer.params)
        trainer.avg_params = trainer.params

    # reference phone sequences for CV PER (collapsed frame labels)
    from asr_craft.decode.scorer import collapse_frames
    cv_refs = None
    if args.label_kind == "phone":
        cv_refs = {i: collapse_frames(labels[cv_idx[i]], len(labels[cv_idx[i]]))
                   for i in range(len(cv_idx))}

    for _ in range(trainer.epoch, tc.epochs):
        trainer.train_epoch(train_loader, put=put)
        if len(cv_loader):
            trainer.evaluate(cv_loader, ref_phone_seqs=cv_refs)
        save_checkpoint(ckpt_dir, trainer, train_loader.state())

    weights_mod.save_raw(os.path.join(args.out_dir, "weights.final.dat"),
                         cfg.fmap, trainer.inference_params)
    logger.log("done", step=trainer.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
