"""Recipe 3 (BASELINE config 3): WSJ Crandem-style CRF.

CRF over MLP phone posteriors concatenated with spectral features
(ftr1 (+) ftr2 — the "Crandem" tandem setup), beam-pruned Viterbi decode
(threshold beam on the Pallas path; --beam_width top-k on the XLA path),
per-utterance normalization.

Run:  python recipes/wsj_crandem.py [--ftr1_file post.pfile --ftr2_file mfcc.pfile ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_ARGS = [
    "--crf_label_size", "42",          # WSJ phone set size (CMUdict-style)
    "--crf_states", "1",
    "--window_extent", "2",
    "--normalize", "utt",
    "--crf_lr", "0.05", "--crf_lr_decay", "0.85",
    "--crf_epochs", "15",
    "--batch_size", "48",
    "--out_dir", "./runs/wsj_crandem",
    "--synthetic_utts", "300",
]

DECODE_ARGS = [
    "--crf_label_size", "42",
    "--window_extent", "2",
    "--normalize", "utt",
    "--weight_file", "./runs/wsj_crandem/weights.final.dat",
    "--beam_threshold", "8.0",         # beam-pruned Viterbi
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft.cli.train import main as train_main
    from asr_craft.cli.decode import main as decode_main
    train_main(TRAIN_ARGS + list(extra))
    decode_main(DECODE_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
