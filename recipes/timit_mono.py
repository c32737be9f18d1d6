"""Recipe 1 (BASELINE config 1): TIMIT monophone linear-chain CRF.

48 labels, MLP phone-posterior features, bias-only transitions, exact
Viterbi decode scored with the standard 48->39 folding.

With real TIMIT posteriors, point ``--ftr1_file`` at a pfile of per-frame
MLP posteriors with frame labels (QuickNet format); without data access this
recipe runs on the built-in synthetic posterior corpus so the full pipeline
is exercised end-to-end.

Run:  python recipes/timit_mono.py [--ftr1_file posteriors.pfile] [extra flags]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "1",
    "--window_extent", "1",
    "--crf_lr", "0.5", "--crf_lr_decay", "0.9",
    "--crf_epochs", "20",
    "--batch_size", "32",
    "--out_dir", "./runs/timit_mono",
    # synthetic stand-in corpus (drop when --ftr1_file is given)
    "--synthetic_utts", "400",
]

DECODE_ARGS = [
    "--crf_label_size", "48",
    "--weight_file", "./runs/timit_mono/weights.final.dat",
    "--window_extent", "1",
    "--timit_fold",
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft.cli.train import main as train_main
    from asr_craft.cli.decode import main as decode_main
    extra = list(extra)
    args = [a for a in TRAIN_ARGS]
    if any(x.startswith("--ftr1_file") for x in extra):
        args = [a for i, a in enumerate(args)
                if a != "--synthetic_utts" and (i == 0 or args[i - 1] != "--synthetic_utts")]
    train_main(args + extra)
    decode_main(DECODE_ARGS + extra)


if __name__ == "__main__":
    main(sys.argv[1:])
