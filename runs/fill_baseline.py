"""Fill the BASELINE.md accuracy table.

For each of the five BASELINE configs, runs the real CLIs/recipes on the
default device (``--platform gpu``) or the CPU and records the PER of the
trained model.  The time-sharded decode row runs on the forced 8-device CPU
mesh.  Speed is measured by ``bench.py`` and recorded in PERF.md, not here.

Every job runs in a subprocess, so this parent process never opens the
device (a second JAX process on a card fails for want of memory).  Results
land in runs/baseline_table.json.

Usage:  python runs/fill_baseline.py [--fast]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the script lives in runs/; jobs import the pkg


def run_jsonl(args, env_extra=None, timeout=900):
    """Run a subprocess, return parsed JSONL records from stdout."""
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", REPO)
    if env_extra:
        env.update(env_extra)
    proc = subprocess.run(args, cwd=REPO, env=env, timeout=timeout,
                          capture_output=True, text=True)
    recs = []
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:] + "\n")
        raise RuntimeError(f"{args} -> rc={proc.returncode}")
    return recs


def last(recs, kind):
    out = [r for r in recs if r.get("kind") == kind]
    return out[-1] if out else {}


def train_and_decode(name, train_args, decode_args, fast, platform="gpu"):
    """Train once, then decode the final weights on the same platform."""
    out_dir = f"/tmp/baseline_{platform}_{name}"
    epochs = "4" if fast else "10"
    plat = ["--platform", platform]
    recs = run_jsonl([sys.executable, "-m", "asr_craft.cli.train",
                      "--out_dir", out_dir, "--crf_epochs", epochs,
                      "--bucket_sizes", "256"] + train_args + plat)
    ev = last(recs, "eval")
    row = {"cv_per": ev.get("per"), "cv_frame_acc": ev.get("frame_accuracy")}
    d = last(run_jsonl([sys.executable, "-m", "asr_craft.cli.decode",
                        "--weight_file",
                        os.path.join(out_dir, "weights.final.dat")]
                       + decode_args + plat), "decode_done")
    row[f"per_{platform}"] = d.get("per")
    return row


def scrf_rows(fast, platform="gpu"):
    ep = "120" if fast else "300"
    out = f"/tmp/baseline_scrf_{platform}"
    corpus = ["--utts", "60", "--eval_utts", "600"]
    r = run_jsonl([sys.executable, "recipes/scrf.py", "--epochs", ep,
                   "--out_dir", out, "--platform", platform] + corpus,
                  timeout=1800)
    row = {f"per_{platform}": last(r, "eval").get("per")}
    # the same weights decoded on the CPU
    r = run_jsonl([sys.executable, "recipes/scrf.py", "--decode_only",
                   f"{out}/scrf_weights.npz", "--platform", "cpu",
                   "--out_dir", f"{out}_cpu"] + corpus)
    row["per_decode_cpu_same_weights"] = last(r, "eval").get("per")
    # dense materialized oracle loss on CPU (the parity reference)
    r = run_jsonl([sys.executable, "recipes/scrf.py", "--epochs", ep,
                   "--dense_loss", "--platform", "cpu",
                   "--out_dir", f"{out}_dense"] + corpus, timeout=1800)
    row["per_oracle_cpu"] = last(r, "eval").get("per")
    return row


def word_decode_rows(fast):
    """Accuracy AND throughput for the flagship word-decode mode (VERDICT
    r2 missing #5): lattice -> lexicon [o LM] -> shortest path on the py
    and native FST backends, plus on-the-fly composed beam search.  Runs
    on CPU (the FST search is host-side by design; the posterior lattice
    is a trivial fraction at these shapes); utts/s is end-to-end CLI wall
    clock over the test set (conservative: includes process startup)."""
    import tempfile
    import time

    import numpy as np

    from asr_craft.data import PFile, WordCorpusConfig, write_pfile
    from asr_craft.data.synthetic import generate_word_corpus
    from asr_craft.decode import fst as F

    tmp = tempfile.mkdtemp(prefix="word_decode_bench_")
    n_train, n_test = 600, 60
    cfg = WordCorpusConfig(num_words=60, noise=0.25, seed=11)
    feats, labels, word_seqs, lexicon, words = generate_word_corpus(
        cfg, n_train + n_test)
    num_phones = 1 + max(p for ps in lexicon.values() for p in ps)
    write_pfile(f"{tmp}/train.pf", PFile(feats[:n_train], labels[:n_train]))
    write_pfile(f"{tmp}/test.pf", PFile(feats[n_train:], labels[n_train:]))
    with open(f"{tmp}/lex.txt", "w") as f:
        for w in words:
            f.write(f"{w} {' '.join(map(str, lexicon[w]))}\n")
    with open(f"{tmp}/refs.txt", "w") as f:
        for i, ws in enumerate(word_seqs[n_train:]):
            f.write(f"utt{i:06d} {' '.join(ws)}\n")
    # bigram LM from the training transcripts (add-1 smoothed)
    W = len(words)
    widx = {w: i for i, w in enumerate(words)}
    counts = np.ones((W, W))
    uni = np.ones(W)
    for ws in word_seqs[:n_train]:
        for a, b in zip(ws[:-1], ws[1:]):
            counts[widx[a], widx[b]] += 1
        for a in ws:
            uni[widx[a]] += 1
    logp = np.log(counts / counts.sum(1, keepdims=True))
    lm = F.bigram_lm_fst(W, logp, np.log(uni / uni.sum()),
                         np.log(np.full(W, 0.1)))
    F.write_fst_text(lm, f"{tmp}/lm.fst.txt")

    run_jsonl([sys.executable, "-m", "asr_craft.cli.train",
               "--ftr1_file", f"{tmp}/train.pf",
               "--crf_label_size", str(num_phones),
               "--crf_epochs", "10" if fast else "40", "--crf_lr", "1.0",
               "--batch_size", "16", "--bucket_sizes", "256",
               "--out_dir", f"{tmp}/run", "--platform", "cpu"],
              timeout=1800)
    common = [sys.executable, "-m", "asr_craft.cli.decode",
              "--ftr1_file", f"{tmp}/test.pf",
              "--crf_label_size", str(num_phones),
              "--weight_file", f"{tmp}/run/weights.final.dat",
              "--batch_size", "16", "--bucket_sizes", "256",
              "--lexicon", f"{tmp}/lex.txt",
              "--ref_words", f"{tmp}/refs.txt", "--platform", "cpu"]
    row = {"lexicon_words": W, "num_phones": int(num_phones),
           "test_utts": n_test}
    variants = {
        "fst_py": ["--fst_backend", "py"],
        "fst_native": ["--fst_backend", "native"],
        "fst_native_lm": ["--fst_backend", "native",
                          "--lm", f"{tmp}/lm.fst.txt",
                          "--lm_weight", "0.5"],
        "otf_beam": ["--otf", "--beam_threshold", "10.0",
                     "--max_active", "64"],
        "otf_beam_lm": ["--otf", "--beam_threshold", "10.0",
                        "--max_active", "64", "--lm", f"{tmp}/lm.fst.txt",
                        "--lm_weight", "0.5"],
    }
    for name, extra in variants.items():
        t0 = time.perf_counter()
        recs = run_jsonl(common + extra)
        wall = time.perf_counter() - t0
        d = last(recs, "decode_done")
        row[name] = {"wer": d.get("wer"),
                     "utts_per_s": round(n_test / wall, 2),
                     "wall_s": round(wall, 2)}
    return row


def word_decode_scale_rows(fast):
    """WSJ-scale word decode (VERDICT r3 next #2): 5000-word shared-phone
    lexicon + pruned backoff bigram LM, decoded by the fully-dynamic OTF
    path (decode.otf.otf_decode_words_dynamic / craft_otf_decode_dynamic)
    — the trie x history composed graph (~1e8 states) is never built.
    Records WER and utts/s for the native and python dynamic decoders,
    plus a pruned-vs-wide-beam search-error spot check on a subset (the
    dynamic decoder's exactness itself is unit-proven at small scale,
    tests/unit/test_otf.py)."""
    import tempfile
    import time

    import numpy as np

    from asr_craft.data import PFile, WordCorpusConfig, write_pfile
    from asr_craft.data.synthetic import generate_word_corpus
    from asr_craft.decode import fst as F

    tmp = tempfile.mkdtemp(prefix="word_decode_scale_")
    W = 1000 if fast else 5000
    n_train, n_test = 400, 50
    cfg = WordCorpusConfig(num_words=W, shared_phones=42, min_pron=3,
                           max_pron=7, min_words=6, max_words=12,
                           mean_dur=5.0, noise=0.2, zipf_a=1.05, seed=7)
    feats, labels, word_seqs, lexicon, words = generate_word_corpus(
        cfg, n_train + n_test)
    write_pfile(f"{tmp}/train.pf", PFile(feats[:n_train], labels[:n_train]))
    write_pfile(f"{tmp}/test.pf", PFile(feats[n_train:], labels[n_train:]))
    with open(f"{tmp}/lex.txt", "w") as f:
        for w in words:
            f.write(f"{w} {' '.join(map(str, lexicon[w]))}\n")
    with open(f"{tmp}/refs.txt", "w") as f:
        for i, ws in enumerate(word_seqs[n_train:]):
            f.write(f"utt{i:06d} {' '.join(ws)}\n")
    lm = F.estimate_backoff_bigram(word_seqs[:n_train], words)
    F.write_fst_text(lm, f"{tmp}/lm.fst.txt")

    run_jsonl([sys.executable, "-m", "asr_craft.cli.train",
               "--ftr1_file", f"{tmp}/train.pf",
               "--crf_label_size", "42",
               "--crf_epochs", "6" if fast else "15", "--crf_lr", "1.0",
               "--batch_size", "16", "--bucket_sizes", "512",
               "--out_dir", f"{tmp}/run", "--platform", "cpu"],
              timeout=2400)
    common = [sys.executable, "-m", "asr_craft.cli.decode",
              "--ftr1_file", f"{tmp}/test.pf",
              "--crf_label_size", "42",
              "--weight_file", f"{tmp}/run/weights.final.dat",
              "--batch_size", "16", "--bucket_sizes", "512",
              "--lexicon", f"{tmp}/lex.txt",
              "--ref_words", f"{tmp}/refs.txt", "--platform", "cpu",
              "--otf_dynamic", "--lm", f"{tmp}/lm.fst.txt",
              "--lm_weight", "0.7"]
    row = {"lexicon_words": W, "num_phones": 42, "test_utts": n_test,
           "lm_arcs": int(lm.num_arcs)}
    # production beam (20, 512) chosen by the r4 sweep; r5 adds LM
    # lookahead (on by default): per-trie-state best-continuation
    # potentials in the pruning key, charging a word's LM cost before
    # its boundary — the r4 sweep's 23%-relative search-error penalty at
    # the production point was exactly this missing (VERDICT r4 next #2).
    # nola = the r4 behavior; tight = the lookahead-enabled fast point.
    variants = {
        "dyn_native": ["--fst_backend", "native", "--beam_threshold",
                       "20.0", "--max_active", "512"],
        "dyn_native_nola": ["--fst_backend", "native", "--beam_threshold",
                            "20.0", "--max_active", "512",
                            "--no_lm_lookahead"],
        "dyn_native_tight": ["--fst_backend", "native",
                             "--beam_threshold", "12.0",
                             "--max_active", "192"],
        "dyn_native_wide": ["--fst_backend", "native", "--beam_threshold",
                            "40.0", "--max_active", "1500"],
        "dyn_py": ["--fst_backend", "py", "--beam_threshold", "20.0",
                   "--max_active", "512"],
    }
    for name, extra in variants.items():
        t0 = time.perf_counter()
        recs = run_jsonl(common + extra
                         + ["--out_words", f"{tmp}/hyp_{name}.txt"],
                         timeout=3600)
        wall = time.perf_counter() - t0
        d = last(recs, "decode_done")
        row[name] = {"wer": d.get("wer", d.get("error_rate")),
                     "utts_per_s": round(n_test / wall, 2),
                     "wall_s": round(wall, 2)}
    # search-error spot check: production beam vs wide beam, same hyps?
    h1 = open(f"{tmp}/hyp_dyn_native.txt").read().splitlines()
    h2 = open(f"{tmp}/hyp_dyn_native_wide.txt").read().splitlines()
    row["beam_vs_wide_differing_utts"] = sum(
        1 for a, b in zip(sorted(h1), sorted(h2)) if a != b)
    # lookahead-enabled beam sweep (r5): with the RMQ exact lookahead
    # near-free, the production point is chosen from WER/speed pairs
    # with the lookahead ON (the r4 sweep was lookahead-less)
    sweep = {}
    for thr, ma in ((12, 192), (16, 384), (20, 512), (22, 512),
                    (25, 512), (25, 800), (30, 1000), (40, 1500)):
        t0 = time.perf_counter()
        recs = run_jsonl(common + ["--fst_backend", "native",
                                   "--beam_threshold", str(float(thr)),
                                   "--max_active", str(ma)],
                         timeout=3600)
        wall = time.perf_counter() - t0
        d = last(recs, "decode_done")
        sweep[f"{thr}/{ma}"] = {
            "wer": round(d.get("wer", d.get("error_rate")), 5),
            "utts_per_s": round(n_test / wall, 2)}
    row["beam_sweep_native_la"] = sweep
    return row


def bf16_convergence_row(platform="gpu"):
    """VERDICT r4 next #5: validate (or demote) the 1-pass bf16 speed
    mode.  Trains the config-2-shaped triphone CRF to convergence twice
    from the same corpus/seed — precision bf16x3 (the flagship mode) vs
    'default' (1-pass bf16) — and decodes both held weight files at
    fp32, recording PER.  Replaces the r4 'loss after 8 steps matched'
    evidence with the convergence cell the accuracy bar asks for."""
    tr = ["--crf_label_size", "48", "--crf_states", "3",
          "--window_extent", "1", "--crf_transftr_start", "0",
          "--crf_transftr_end", "144", "--crf_lr", "0.05",
          "--batch_size", "32", "--synthetic_utts", "200",
          "--crf_epochs", "10", "--bucket_sizes", "256",
          "--steps_per_call", "4", "--platform", platform]
    dec = ["--crf_label_size", "48", "--crf_states", "3",
           "--window_extent", "1", "--crf_transftr_start", "0",
           "--crf_transftr_end", "144", "--timit_fold",
           "--synthetic_utts", "48", "--bucket_sizes", "256",
           "--platform", platform]
    row = {}
    for prec in ("bf16x3", "default"):
        out = f"/tmp/baseline_bf16conv_{prec}"
        recs = run_jsonl([sys.executable, "-m", "asr_craft.cli.train",
                          "--out_dir", out, "--precision", prec] + tr,
                         timeout=2400)
        ev = last(recs, "eval")
        d = last(run_jsonl(
            [sys.executable, "-m", "asr_craft.cli.decode",
             "--weight_file", os.path.join(out, "weights.final.dat")]
            + dec, timeout=1200), "decode_done")
        row[prec] = {"cv_per": ev.get("per"),
                     "cv_frame_acc": ev.get("frame_accuracy"),
                     "test_per": d.get("per")}
    row["per_delta_abs"] = round(
        (row["default"].get("test_per") or 0)
        - (row["bf16x3"].get("test_per") or 0), 5)
    return row


def scaling_mechanics_row():
    """Weak-scaling harness mechanics on the 8-device forced CPU mesh
    (VERDICT r3 next #6): bench.py --scaling runs the DP-sharded flagship
    step at 1..8 devices.  CPU devices share host cores, so the recorded
    efficiencies assert the harness works, not chip scaling; on a pod the
    same command is the >=80% scaling measurement."""
    r = run_jsonl([sys.executable, "bench.py", "--scaling"],
                  env_extra={"JAX_PLATFORMS": "cpu",
                             "XLA_FLAGS":
                             "--xla_force_host_platform_device_count=8"},
                  timeout=2400)
    for rec in r:
        if "scaling" in rec:
            return {"cpu_mesh_mechanics": rec["scaling"],
                    "note": "shared-core virtual devices: asserts "
                            "plumbing; pod command: python bench.py "
                            "--scaling"}
    return {"error": "no scaling record"}


def timeshard_row():
    """Sharded-vs-unsharded decode wall clock on the 8-device CPU mesh
    (VERDICT Weak #6: measure the honest O(L'^3) cost)."""
    code = r"""
import json, time
import jax, jax.numpy as jnp, numpy as np
from asr_craft.parallel.timeshard import time_mesh, sharded_viterbi
from asr_craft.ops.viterbi import viterbi_batch
B, T, L = 8, 512, 48
rng = np.random.default_rng(0)
state = jnp.asarray(rng.normal(size=(B, T, L)), jnp.float32)
trans = jnp.asarray(rng.normal(size=(L, L)), jnp.float32)
lengths = jnp.full((B,), T, jnp.int32)
mesh = time_mesh(8)
sh = jax.jit(lambda s: sharded_viterbi(s, trans, lengths, mesh))
un = jax.jit(lambda s: viterbi_batch(s, trans, lengths))
for f, name in ((sh, "sharded_8dev"), (un, "unsharded_1dev")):
    out = f(state); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(5):
        out = f(state)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 5
    print(json.dumps({"kind": name, "ms": dt * 1e3,
                      "audio_s_per_s": B * T * 0.01 / dt}))
# the r4 pruned win shape: long T, top-K survivor pruning (VERDICT r3 #4b)
B, T, L, K = 4, 16384, 48, 12
rng = np.random.default_rng(1)
state = jnp.asarray(rng.normal(size=(B, T, L)) * 2.0, jnp.float32)
trans = jnp.asarray(rng.normal(size=(L, L)) * 0.3, jnp.float32)
lengths = jnp.full((B,), T, jnp.int32)
shp = jax.jit(lambda s: sharded_viterbi(s, trans, lengths, mesh,
                                        beam_labels=K))
unx = jax.jit(lambda s: viterbi_batch(s, trans, lengths))
for f, name in ((shp, "pruned_sharded_T16k"), (unx, "unsharded_T16k")):
    out = f(state); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = f(state)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({"kind": name, "ms": dt * 1e3}))
"""
    r = run_jsonl([sys.executable, "-c", code],
                  env_extra={"JAX_PLATFORMS": "cpu",
                             "XLA_FLAGS":
                             "--xla_force_host_platform_device_count=8"})
    return {"sharded_8dev_cpu": last(r, "sharded_8dev"),
            "unsharded_1dev_cpu": last(r, "unsharded_1dev"),
            "pruned_sharded_T16k_L48_K12": last(r, "pruned_sharded_T16k"),
            "unsharded_T16k": last(r, "unsharded_T16k")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fast", action="store_true")
    p.add_argument("--only", help="comma-list of rows to run")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--merge", action="store_true",
                   help="merge into an existing baseline_table.json")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    plat = args.platform

    out = os.path.join(REPO, "runs", "baseline_table.json")
    # ALWAYS merge into an existing table when running a row subset —
    # a bare --only run once replaced the whole file (r4); --merge is
    # kept as an explicit no-op for compatibility
    table = {}
    if (args.merge or only) and os.path.exists(out):
        with open(out) as f:
            table = json.load(f)

    jobs = {
        "timit_mono": lambda: train_and_decode(
            "mono",
            ["--crf_label_size", "48", "--window_extent", "1",
             "--crf_lr", "0.5", "--batch_size", "32",
             "--synthetic_utts", "200"],
            ["--crf_label_size", "48", "--window_extent", "1",
             "--timit_fold", "--synthetic_utts", "48"], args.fast, plat),
        "timit_triphone": lambda: train_and_decode(
            "tri",
            ["--crf_label_size", "48", "--crf_states", "3",
             "--window_extent", "1", "--crf_transftr_start", "0",
             "--crf_transftr_end", "144", "--crf_lr", "0.05",
             "--batch_size", "32", "--synthetic_utts", "200"],
            ["--crf_label_size", "48", "--crf_states", "3",
             "--window_extent", "1", "--crf_transftr_start", "0",
             "--crf_transftr_end", "144", "--timit_fold",
             "--synthetic_utts", "48"], args.fast, plat),
        # corpus noise 0.25: with utt-norm the default-noise corpus trains
        # to PER ~0.5 where backend/beam deltas hide inside variance; at
        # 0.25 it reaches PER ~0.12 — a real parity anchor (VERDICT r2
        # weak #5 / next #9)
        "wsj_crandem_beam": lambda: train_and_decode(
            "wsj",
            ["--crf_label_size", "42", "--window_extent", "2",
             "--normalize", "utt", "--crf_lr", "0.3",
             "--synthetic_noise", "0.25",
             "--batch_size", "48", "--synthetic_utts", "200"],
            ["--crf_label_size", "42", "--window_extent", "2",
             "--normalize", "utt", "--beam_threshold", "8.0",
             "--synthetic_noise", "0.25",
             "--synthetic_utts", "48"], args.fast, plat),
        "scrf": lambda: scrf_rows(args.fast, plat),
        "swbd_scale": lambda: train_and_decode(
            "swbd",
            ["--crf_label_size", "46", "--crf_states", "3",
             "--window_extent", "2", "--normalize", "global",
             "--crf_lr", "0.03", "--batch_size", "64",
             "--synthetic_utts", "300"],
            ["--crf_label_size", "46", "--crf_states", "3",
             "--window_extent", "2", "--normalize", "global",
             "--synthetic_utts", "48"], args.fast, plat),
        "timeshard_decode": timeshard_row,
        "word_decode": lambda: word_decode_rows(args.fast),
        "word_decode_scale": lambda: word_decode_scale_rows(args.fast),
        "scaling_mechanics": scaling_mechanics_row,
        "bf16_convergence": lambda: bf16_convergence_row(plat),
    }
    for name, job in jobs.items():
        if only and name not in only:
            continue
        print(f"=== {name}", file=sys.stderr)
        try:
            row = job()
        except Exception as e:  # record the failure, keep measuring
            row = {"error": str(e)[:500]}
        table.setdefault(name, {}).update(row)
        if "error" in table[name] and "error" not in row:
            del table[name]["error"]     # stale failure, job now succeeded
        print(json.dumps({name: table[name]}), file=sys.stderr)

        # merge against the freshest on-disk table at every write so two
        # concurrent --only runs can't clobber each other's rows
        if args.merge and os.path.exists(out):
            with open(out) as f:
                disk = json.load(f)
            for k, v in table.items():
                disk.setdefault(k, {}).update(v)
            table = disk
        with open(out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps(table, indent=1))


if __name__ == "__main__":
    main()
