"""CLI surface for config 5's lattice-sharded decode (VERDICT r4 next #4):
``crf-decode --time_shard N [--shard_beam_labels K]`` on a forced 8-device
CPU mesh must reproduce the unsharded decode (exact mode) and score
comparably in the pruned mode, through the real subprocess entry point.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(*args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    out = subprocess.run(
        [sys.executable, "-m", "asr_craft.cli.decode", *args,
         "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _train_weights(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out_dir = str(tmp_path / "run")
    out = subprocess.run(
        [sys.executable, "-m", "asr_craft.cli.train",
         "--synthetic_utts", "24", "--synthetic_noise", "0.3",
         "--crf_label_size", "6", "--crf_epochs", "2", "--crf_lr", "1.0",
         "--batch_size", "8", "--bucket_sizes", "256",
         "--out_dir", out_dir, "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return os.path.join(out_dir, "weights.final.dat")


def test_cli_time_shard_matches_unsharded(tmp_path):
    wf = _train_weights(tmp_path)
    common = ["--synthetic_utts", "10", "--synthetic_noise", "0.3",
              "--crf_label_size", "6", "--weight_file", wf,
              "--batch_size", "8", "--bucket_sizes", "256"]
    ref = _run(*common, "--out_mlf", str(tmp_path / "ref.mlf"))
    sh = _run(*common, "--time_shard", "8",
              "--out_mlf", str(tmp_path / "sh.mlf"))
    with open(tmp_path / "ref.mlf") as f1, open(tmp_path / "sh.mlf") as f2:
        assert f1.read() == f2.read()
    per_ref = [json.loads(l) for l in ref.splitlines()
               if '"kind": "decode_done"' in l][-1]["per"]
    per_sh = [json.loads(l) for l in sh.splitlines()
              if '"kind": "decode_done"' in l][-1]["per"]
    assert per_sh == per_ref


def test_cli_time_shard_pruned(tmp_path):
    """--shard_beam_labels K: pruned sharded decode runs end-to-end and
    stays accurate on separable data (K=4 of L=6)."""
    wf = _train_weights(tmp_path)
    sh = _run("--synthetic_utts", "10", "--synthetic_noise", "0.3",
              "--crf_label_size", "6", "--weight_file", wf,
              "--batch_size", "8", "--bucket_sizes", "256",
              "--time_shard", "8", "--shard_beam_labels", "4")
    done = [json.loads(l) for l in sh.splitlines()
            if '"kind": "decode_done"' in l]
    assert done and done[-1]["per"] < 0.25, done
