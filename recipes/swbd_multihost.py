"""Recipe 5 (BASELINE config 5): Switchboard-scale multi-host data-parallel
CRF training with lattice-sharded decode.

Scale knobs: 46 phones x 3 states, wide windows, large batches; the data
loader shards utterances by host (shard_id = process_index) and the train
step is data-parallel over all global devices with XLA gradient all-reduce
over ICI/DCN (asr_craft.parallel).

Multi-host launch (one command per host):

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 \
    JAX_PROCESS_ID=<i> python recipes/swbd_multihost.py --ftr1_file ...

Single-host it runs data-parallel over the local devices.  Time-sharded
("lattice-sharded") decode is a CLI feature:

    python -m asr_craft.cli.decode ... --time_shard 8 \
        [--shard_beam_labels 12]

(asr_craft.parallel.timeshard.sharded_decode; exact vs unsharded,
or vs the survivor-masked lattice when pruned — the regime where it wins
wall-clock: 3.1x at T=16384, K=12.  tests/e2e/test_cli_timeshard.py.)

Run:  python recipes/swbd_multihost.py [--ftr1_file swbd.pfile ...]

Pod scaling measurement (the BASELINE >=80% audio-s/s bar): on any slice,

    python bench.py --scaling --check

runs the DP-sharded flagship step at 1..N devices with fixed per-device
batch and prints efficiency vs the 1-device point; ``--check``
additionally asserts, per device count, that the DP loss and grads equal
the single-device values on the same global batch (fp32-tiered
tolerance), so one command validates numerics AND measures efficiency.
The check passes on the forced 8-device CPU mesh
(tests/dist/test_data_parallel.py::test_scaling_check_mesh; efficiency
there measures shared host cores, not chips — see
runs/baseline_table.json scaling_mechanics).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_ARGS = [
    "--crf_label_size", "46",
    "--crf_states", "3",
    "--window_extent", "2",
    "--normalize", "global",
    "--crf_lr", "0.03", "--crf_lr_decay", "0.9",
    "--crf_epochs", "8",
    "--batch_size", "64",
    "--bucket_sizes", "256,512,1024,2048",
    "--out_dir", "./runs/swbd",
    "--synthetic_utts", "500",
]


def main(extra=()):
    from asr_craft.cli.train import main as train_main
    train_main(TRAIN_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
