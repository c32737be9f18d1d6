"""Shared CLI plumbing: corpus assembly and feature transforms.

Replaces the reference's QuickNet ``QN_ArgEntry`` flag tables (SURVEY.md §5
config system): flags keep QN-ish names (``--ftr1_file``, ``--crf_lr``,
``--window_extent``...) for familiarity.  Recipes (``recipes/*.py``) are
arg-list drivers on top of these flags — extra CLI args appended to a
recipe's invocation override its defaults, which is the override mechanism.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from asr_craft import data as data_mod
from asr_craft.data import (LoaderConfig, Normalizer, UtteranceLoader,
                            add_deltas, concat_streams, context_window,
                            read_pfile, train_cv_split)


def build_corpus(args) -> Tuple[list, list, Optional[list]]:
    """Features + frame labels from pfiles (ftr1/ftr2/ftr3 concatenated),
    an HTK scp + MLF pair, or a synthetic corpus.
    Returns (features, labels, phone_seqs|None)."""
    if getattr(args, "htk_scp", None):
        return _build_htk_corpus(args)
    if getattr(args, "synthetic_utts", 0):
        scfg = data_mod.SyntheticConfig(
            num_labels=args.crf_label_size,
            feat_dim=args.crf_label_size,
            noise=getattr(args, "synthetic_noise", 0.4),
            seed=getattr(args, "seed", 0),
            min_dur=max(2, getattr(args, "crf_states", 1)),
        )
        feats, labels, phones = data_mod.generate_corpus(
            scfg, args.synthetic_utts)
        return feats, labels, phones

    # sparse feature corpus (QuickNet-sparse-stream analogue, data.sparse)
    from asr_craft.data import sparse as sparse_mod
    if args.ftr1_file and sparse_mod.is_sparse_file(args.ftr1_file):
        corpus = sparse_mod.read_sparse_file(args.ftr1_file)
        labels = corpus.labels
        if getattr(args, "hardtarget_file", None):
            from asr_craft.data import pfile_native as pn
            reader = (pn.read_pfile_fast if pn.available() else read_pfile)
            labels = reader(args.hardtarget_file).labels
        if labels is not None:
            labels = [l.astype(np.int32) for l in labels]
        return corpus.features, labels, None

    # native mmap'd reader when built; pure-Python fallback
    from asr_craft.data import pfile_native
    reader = (pfile_native.read_pfile_fast if pfile_native.available()
              else read_pfile)
    pf = reader(args.ftr1_file)
    feats, labels = list(pf.features), pf.labels
    for extra in (getattr(args, "ftr2_file", None),
                  getattr(args, "ftr3_file", None)):
        if extra:
            pf2 = reader(extra)
            feats = [concat_streams(a, b) for a, b in zip(feats, pf2.features)]
    if getattr(args, "hardtarget_file", None):
        labels = reader(args.hardtarget_file).labels
    if labels is not None:
        labels = [l.astype(np.int32) for l in labels]
    return feats, labels, None


def _build_htk_corpus(args):
    """HTK path: ``--htk_scp`` lists one feature file per line (optionally
    ``key=path``); frame labels come from ``--label_mlf`` +
    ``--phone_names`` (label segments expanded to frames)."""
    from asr_craft.data import read_htk, read_mlf

    names = None
    if getattr(args, "phone_names", None):
        with open(args.phone_names) as f:
            names = {ln.strip(): i for i, ln in enumerate(f) if ln.strip()}
    mlf = (read_mlf(args.label_mlf)
           if getattr(args, "label_mlf", None) else None)

    feats, labels = [], ([] if mlf else None)
    with open(args.htk_scp) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, path = line.rpartition("=")
            if not key:
                path = line
                key = os.path.splitext(os.path.basename(path))[0]
            x, _, _ = read_htk(path)
            feats.append(x)
            if mlf is not None:
                segs = mlf.get(key)
                if segs is None:
                    raise ValueError(f"utterance {key!r} missing from MLF")
                lab = np.zeros(len(x), np.int32)
                for s, e, name in segs:
                    li = names[name] if names else int(name)
                    lab[max(s, 0):min(e, len(x))] = li
                labels.append(lab)
    return feats, labels, None


def make_transform(args, feats: list):
    """Windowing / deltas / normalization pipeline (CRF_FeatureStream
    duties), returns (transform fn, output feat dim)."""
    from asr_craft.data.sparse import SparseFeatureList
    if isinstance(feats, SparseFeatureList):
        if (getattr(args, "deltas_order", 0) or getattr(args, "window_extent", 0)
                or getattr(args, "normalize", "none") != "none"):
            raise ValueError("feature transforms (deltas/window/normalize) "
                             "are not supported on sparse feature inputs")
        return None, feats.feat_dim
    steps = []
    if getattr(args, "deltas_order", 0):
        order = args.deltas_order
        steps.append(lambda f: add_deltas(f, order=order))
    if getattr(args, "window_extent", 0):
        w = args.window_extent
        steps.append(lambda f: context_window(f, w))
    norm = None
    if getattr(args, "normalize", "none") == "global":
        probe = []
        for f in feats[:200]:
            x = f
            for s in steps:
                x = s(x)
            probe.append(x)
        norm = Normalizer.fit(probe)
        steps.append(norm)
    elif getattr(args, "normalize", "none") == "utt":
        steps.append(Normalizer.per_utterance)

    def transform(f):
        for s in steps:
            f = s(f)
        return f

    dim = transform(feats[0][:2]).shape[1]
    return transform, dim
