"""Recipe 2 (BASELINE config 2): TIMIT triphone-state CRF.

48 phones x 3 left-to-right states with acoustically-driven transition
feature functions, batched utterances.  Frame labels at state granularity
(from a forced alignment; the synthetic stand-in uses the proportional
aligner in data.synthetic.nstate_frame_labels via --label_kind phone on
phone targets, which marginalizes state alignments in the numerator).

Run:  python recipes/timit_triphone.py [--ftr1_file posteriors.pfile ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "3",
    "--window_extent", "1",
    # route all windowed dims to state fns AND transition fns (Crandem-style
    # transition feature functions — SURVEY.md §2.1 Std feature map)
    "--crf_transftr_start", "0", "--crf_transftr_end", "144",
    "--crf_lr", "0.05", "--crf_lr_decay", "0.9",
    "--crf_epochs", "12",
    "--batch_size", "32",
    "--out_dir", "./runs/timit_tri",
    "--synthetic_utts", "200",
]

DECODE_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "3",
    "--window_extent", "1",
    "--crf_transftr_start", "0", "--crf_transftr_end", "144",
    "--weight_file", "./runs/timit_tri/weights.final.dat",
    "--timit_fold",
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft.cli.train import main as train_main
    from asr_craft.cli.decode import main as decode_main
    train_main(TRAIN_ARGS + list(extra))
    decode_main(DECODE_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
