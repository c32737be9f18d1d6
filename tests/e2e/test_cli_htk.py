"""CLI end-to-end with the HTK scp + MLF input path."""
import json
import os
import subprocess
import sys

import numpy as np

from asr_craft import data

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_cli_train_htk_corpus(tmp_path):
    rng = np.random.default_rng(0)
    L = 4
    scfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=0.3,
                                min_len=15, max_len=40, seed=2)
    feats, labels, _ = data.generate_corpus(scfg, 20)

    scp_lines, mlf = [], {}
    names = [f"ph{i}" for i in range(L)]
    for i, (f, l) in enumerate(zip(feats, labels)):
        key = f"utt{i:03d}"
        path = tmp_path / f"{key}.htk"
        data.write_htk(path, f)
        scp_lines.append(f"{key}={path}")
        segs = []
        t = 0
        while t < len(l):
            e = t
            while e < len(l) and l[e] == l[t]:
                e += 1
            segs.append((t, e, names[int(l[t])]))
            t = e
        mlf[key] = segs
    scp = tmp_path / "train.scp"
    scp.write_text("\n".join(scp_lines))
    mlf_path = tmp_path / "train.mlf"
    data.write_mlf(mlf_path, mlf, frame_period=100000)
    phn = tmp_path / "phones.txt"
    phn.write_text("\n".join(names))

    out = subprocess.run(
        [sys.executable, "-m", "asr_craft.cli.train",
         "--htk_scp", str(scp), "--label_mlf", str(mlf_path),
         "--phone_names", str(phn),
         "--crf_label_size", str(L), "--crf_epochs", "3", "--crf_lr", "1.0",
         "--batch_size", "8", "--bucket_sizes", "64",
         "--out_dir", str(tmp_path / "run"), "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    evals = [json.loads(l) for l in out.stdout.splitlines()
             if '"kind": "eval"' in l]
    assert evals and evals[-1]["frame_accuracy"] > 0.8, evals
