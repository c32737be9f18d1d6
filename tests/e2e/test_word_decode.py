"""End-to-end FST word decode through the real CLIs: train a CRF on a
synthetic word corpus, decode through lattice o collapser o lexicon [o LM],
score WER (the reference CRFFstDecode pipeline — SURVEY.md §3.2)."""
import json
import os
import subprocess
import sys

import numpy as np

from asr_craft.data import PFile, WordCorpusConfig, write_pfile
from asr_craft.data.synthetic import generate_word_corpus

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(mod, *args):
    out = subprocess.run(
        [sys.executable, "-m", mod, *args, "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _setup_corpus(tmp_path):
    cfg = WordCorpusConfig(num_words=6, noise=0.2, seed=7)
    feats, labels, word_seqs, lexicon, words = generate_word_corpus(cfg, 80)
    num_phones = 1 + max(p for ps in lexicon.values() for p in ps)

    write_pfile(tmp_path / "train.pf", PFile(feats[:70], labels[:70]))
    write_pfile(tmp_path / "test.pf", PFile(feats[70:], labels[70:]))
    with open(tmp_path / "lex.txt", "w") as f:
        for w in words:
            f.write(f"{w} {' '.join(map(str, lexicon[w]))}\n")
    with open(tmp_path / "refs.txt", "w") as f:
        for i, ws in enumerate(word_seqs[70:]):
            f.write(f"utt{i:06d} {' '.join(ws)}\n")
    return num_phones


def _wer(stdout):
    done = [json.loads(l) for l in stdout.splitlines()
            if '"kind": "decode_done"' in l]
    assert done, stdout
    return done[-1]["wer"]


def test_cli_word_decode(tmp_path):
    num_phones = _setup_corpus(tmp_path)
    out_dir = str(tmp_path / "run")
    _run("asr_craft.cli.train",
         "--ftr1_file", str(tmp_path / "train.pf"),
         "--crf_label_size", str(num_phones),
         "--crf_epochs", "6", "--crf_lr", "1.0",
         "--batch_size", "8", "--bucket_sizes", "256",
         "--out_dir", out_dir)
    weight = os.path.join(out_dir, "weights.final.dat")

    common = ["asr_craft.cli.decode",
              "--ftr1_file", str(tmp_path / "test.pf"),
              "--crf_label_size", str(num_phones),
              "--weight_file", weight,
              "--batch_size", "8", "--bucket_sizes", "256",
              "--lexicon", str(tmp_path / "lex.txt"),
              "--ref_words", str(tmp_path / "refs.txt")]

    stdout = _run(*common, "--out_words", str(tmp_path / "hyp.txt"))
    wer = _wer(stdout)
    assert wer < 0.1, f"exact-lattice WER too high: {wer}"
    with open(tmp_path / "hyp.txt") as f:
        lines = [l.split() for l in f if l.strip()]
    assert len(lines) == 10 and all(l[0].startswith("utt") for l in lines)

    # a generous lattice beam must not change the result (pruned == exact)
    stdout_pruned = _run(*common, "--prune_margin", "15.0")
    assert _wer(stdout_pruned) == wer

    # n-best: best hypothesis of the n-best list == 1-best; weights sorted
    stdout_nb = _run(*common, "--nbest", "3",
                     "--out_nbest", str(tmp_path / "nbest.txt"))
    assert _wer(stdout_nb) == wer
    by_utt = {}
    with open(tmp_path / "nbest.txt") as f:
        for line in f:
            parts = line.split()
            by_utt.setdefault(parts[0], []).append(
                (float(parts[1]), parts[2:]))
    assert len(by_utt) == 10
    for key, entries in by_utt.items():
        ws = [w for w, _ in entries]
        assert ws == sorted(ws), (key, ws)

    # on-the-fly composed beam Viterbi (no lattice): exact beam == offline
    stdout_otf = _run(*common, "--otf")
    assert _wer(stdout_otf) == wer
    # beam-pruned on-the-fly decode stays accurate on separable data
    stdout_otf_beam = _run(*common, "--otf", "--beam_threshold", "30.0",
                           "--max_active", "64")
    assert _wer(stdout_otf_beam) <= wer + 0.02


def test_cli_word_decode_with_lm(tmp_path):
    """An LM FST biased toward the reference transcripts must not hurt WER;
    --lm_weight 0 must reproduce the no-LM result."""
    from asr_craft.decode import fst as F

    num_phones = _setup_corpus(tmp_path)
    out_dir = str(tmp_path / "run")
    _run("asr_craft.cli.train",
         "--ftr1_file", str(tmp_path / "train.pf"),
         "--crf_label_size", str(num_phones),
         "--crf_epochs", "6", "--crf_lr", "1.0",
         "--batch_size", "8", "--bucket_sizes", "256",
         "--out_dir", out_dir)
    weight = os.path.join(out_dir, "weights.final.dat")

    # uniform bigram LM over the 6 words
    W = 6
    logp = np.log(np.full((W, W), 1.0 / W))
    lm = F.bigram_lm_fst(W, logp, np.log(np.full(W, 1.0 / W)),
                         np.log(np.full(W, 0.5)))
    F.write_fst_text(lm, tmp_path / "lm.fst.txt")

    common = ["asr_craft.cli.decode",
              "--ftr1_file", str(tmp_path / "test.pf"),
              "--crf_label_size", str(num_phones),
              "--weight_file", weight,
              "--batch_size", "8", "--bucket_sizes", "256",
              "--lexicon", str(tmp_path / "lex.txt"),
              "--ref_words", str(tmp_path / "refs.txt")]
    wer_nolm = _wer(_run(*common))
    wer_lm = _wer(_run(*common, "--lm", str(tmp_path / "lm.fst.txt")))
    # uniform LM shifts every path by the same per-word constant; with the
    # acoustic model this strong it must not degrade the transcripts much
    assert wer_lm <= wer_nolm + 0.02, (wer_lm, wer_nolm)


def test_cli_word_decode_dynamic(tmp_path):
    """--otf_dynamic through the real CLI: the fully dynamic
    lexicon/LM-composition decoder (r4 WSJ-scale path) with a pruned
    BACKOFF bigram LM estimated from the training transcripts must match
    the offline composed path's transcripts on this easy corpus."""
    from asr_craft.data.synthetic import WordCorpusConfig as WCC
    from asr_craft.decode import fst as F

    cfg = WCC(num_words=6, noise=0.2, seed=7)
    feats, labels, word_seqs, lexicon, words = generate_word_corpus(cfg, 80)
    num_phones = _setup_corpus(tmp_path)
    out_dir = str(tmp_path / "run")
    _run("asr_craft.cli.train",
         "--ftr1_file", str(tmp_path / "train.pf"),
         "--crf_label_size", str(num_phones),
         "--crf_epochs", "6", "--crf_lr", "1.0",
         "--batch_size", "8", "--bucket_sizes", "256",
         "--out_dir", out_dir)
    weight = os.path.join(out_dir, "weights.final.dat")
    lm = F.estimate_backoff_bigram(word_seqs[:70], words)
    F.write_fst_text(lm, tmp_path / "lm.fst.txt")

    common = ["asr_craft.cli.decode",
              "--ftr1_file", str(tmp_path / "test.pf"),
              "--crf_label_size", str(num_phones),
              "--weight_file", weight,
              "--batch_size", "8", "--bucket_sizes", "256",
              "--lexicon", str(tmp_path / "lex.txt"),
              "--ref_words", str(tmp_path / "refs.txt")]
    wer_offline = _wer(_run(*common))
    wer_dyn = _wer(_run(*common, "--otf_dynamic", "--fst_backend", "py",
                        "--beam_threshold", "12.0", "--max_active", "64"))
    wer_dyn_lm = _wer(_run(*common, "--otf_dynamic",
                           "--lm", str(tmp_path / "lm.fst.txt"),
                           "--lm_weight", "0.5",
                           "--beam_threshold", "12.0",
                           "--max_active", "64"))
    assert wer_dyn <= wer_offline + 0.02, (wer_dyn, wer_offline)
    # a transcript-matched LM must not hurt on this separable corpus
    assert wer_dyn_lm <= wer_dyn + 0.02, (wer_dyn_lm, wer_dyn)
