"""Smoke run of the system on one NVIDIA GPU (or four, with ``--four``).

One process drives the card through the entry points a user calls, at the
full width of BASELINE config 2 (TIMIT triphone-state CRF: 48 phones x 3
states, 144-dim windowed features, frame-dependent transitions over all
144 dims).  Phases:

  a. device: the default JAX device must be a GPU; no CPU fallback.
  b. training through ``cli.train.main`` with the recipe's flags at batch
     128 on a synthetic corpus: a finite loss that falls, weights on disk.
  c. decoding through ``cli.decode.main`` on those weights, exact and with
     ``--beam_threshold``: a ``decode_done`` line with a finite PER.
  d. parity at real widths (B=128, T=512; decode at B=64): the Pallas
     kernels of ``kernels/fdt_triton.py`` against the ``lax.scan``
     recursion (logZ, parameter gradients, Viterbi paths and scores), and
     against the float64 NumPy oracle (``ops/oracle.py``) at a small shape.
  e. timing, kernel against the XLA scan: the recursions alone, the train
     step (loss, gradient and update) and exact decode; medians of 5 calls
     after warm-up, each ended by ``block_until_ready``.
  f. the card-marked tests (``pytest -m gpu tests/gpu``), in this process.

``--four`` runs only the paths that need four cards: one data-parallel
train step on a 4-card ("data",) mesh against the same global batch on
one card, and ``--time_shard 4`` decode at T=16k against the unsharded
decode.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed; any failure exits non-zero.

Usage: ``python chip_smoke.py [--four]`` from the root of a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "runs", "chip_smoke")
REPS = 5

# Parity tolerances (kernel against the lax.scan reference, both fp32):
# - logZ, relative: the two sum each frame's 48-term cross-phone
#   logsumexp in a different order, a rounding of order 1e-7 relative per
#   frame, so at most ~511 * 1e-7 = 5e-5 over an utterance.
LOGZ_RTOL = 1e-4
# - gradients, max |difference| over max |reference| per parameter: every
#   entry is a sum of exp(alpha + beta - logZ) terms, and with alpha, beta
#   and logZ of order 1e3..1e4 an fp32 rounding of 1e-7 relative moves the
#   exponent by up to 1e-3.
GRAD_RTOL = 1e-3
# - Viterbi scores, relative: the max-plus pass adds the same terms in the
#   same order on both paths; only the plane layout differs.
SCORE_RTOL = 1e-5
# - against the float64 oracle (small shape, |logZ| ~ 10): fp32 rounding.
ORACLE_RTOL = 1e-5
# - time-sharded decode scores, relative: the sharded path sums the 16k
#   frames as four chunk products and a prefix combine, another
#   association than the sequential scan; fp32 rounding of 6e-8 per
#   addition grows to ~sqrt(16384) * 6e-8 ~ 1e-5 typical and 1e-3 at worst.
TIMESHARD_RTOL = 1e-4

_CARD = None


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    global _CARD
    if _CARD is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        _CARD = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "nvidia-smi failed"
    return _CARD


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_phase(count: int):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"the default JAX device is {devs[0].platform}, not a GPU")
    check(len(devs) >= count, f"{count} GPUs needed, JAX found {len(devs)}")
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    print(f"card: {card()}")
    print(f"jax: {jax.__version__}", flush=True)
    from asr_craft.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": count}


def _records(text: str, kind: str):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{") and json.loads(ln).get("kind") == kind]


def train_phase():
    sys.path.insert(0, os.path.join(ROOT, "recipes"))
    import timit_triphone
    from asr_craft.cli import train
    shutil.rmtree(WORK, ignore_errors=True)
    args = list(timit_triphone.TRAIN_ARGS)
    for flag, val in (("--batch_size", "128"), ("--synthetic_utts", "320"),
                      ("--crf_epochs", "3"), ("--out_dir", WORK)):
        args[args.index(flag) + 1] = val
    check(train.main(args) == 0, "cli.train returned non-zero")
    with open(os.path.join(WORK, "metrics.jsonl")) as f:
        losses = [r["mean_loss"] for r in _records(f.read(), "train_epoch")]
    print(f"train mean_loss per epoch: {losses}")
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"finite loss per epoch: {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    weights = os.path.join(WORK, "weights.final.dat")
    check(os.path.getsize(weights) > 0, "weights.final.dat written")
    return weights


def decode_phase(weights: str):
    sys.path.insert(0, os.path.join(ROOT, "recipes"))
    import timit_triphone
    from asr_craft.cli import decode
    args = list(timit_triphone.DECODE_ARGS)
    args[args.index("--weight_file") + 1] = weights
    for extra in ([], ["--beam_threshold", "10.0"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = decode.main(args + extra)
        done = _records(buf.getvalue(), "decode_done")
        check(rc == 0 and len(done) == 1, f"decode {extra}: decode_done")
        per = done[0]["per"]
        print(f"decode {' '.join(extra) or 'exact'}: PER {per}")
        check(np.isfinite(per), f"finite PER: {per}")


@contextlib.contextmanager
def forced_impl(impl: str):
    """Run ops.fdt's recursions on ``impl`` ("kernel" or "scan")."""
    import jax
    from asr_craft.ops import fdt
    orig = fdt.recursion_impl
    fdt.recursion_impl = lambda P: impl
    jax.clear_caches()
    try:
        yield
    finally:
        fdt.recursion_impl = orig
        jax.clear_caches()


def _problem(B, T, P, ns, D, seed=0):
    """Config-2-shaped problem with topology-legal labels: phone runs of 4
    frames and lengths that end a run."""
    import jax.numpy as jnp
    from asr_craft.models.crf import CrfConfig
    rng = np.random.default_rng(seed)
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                    trans_range=(0, D))
    params = {k: jnp.asarray(rng.normal(size=v.shape, scale=0.05),
                             jnp.float32)
              for k, v in cfg.init_params().items()}
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    labels = jnp.asarray(np.repeat(rng.integers(0, P, size=(B, -(-T // 4))),
                                   4, axis=1)[:, :T], jnp.int32)
    lengths = 4 * rng.integers(T // 8, T // 4 + 1, size=B)
    lengths[0] = T
    return cfg, params, feats, labels, jnp.asarray(lengths, jnp.int32)


def _loss_and_grad(cfg, params, feats, labels, lengths):
    import jax
    from asr_craft.models.crf import crf_loss
    return jax.jit(jax.value_and_grad(
        lambda p, *batch: crf_loss(cfg, p, *batch)[0]))(
            params, feats, labels, lengths)


def _decode(cfg, params, feats, lengths, **beam):
    import jax
    from asr_craft.models.crf import decode
    return jax.jit(lambda p, f, n: decode(cfg, p, f, n, **beam)[1:])(
        params, feats, lengths)


def _path_scores(cfg, params, feats, lengths, paths):
    """Score state-major paths under the factored lattice (float64)."""
    from asr_craft.ops import fdt
    ns, Lp = cfg.num_states, cfg.fmap.num_expanded
    st, sp, ap, cp = fdt.factored_planes(
        params, feats, Lp, ns, cfg.fmap.state_range, cfg.fmap.trans_range)
    st = fdt._boundary_state(st, lengths, ns, True)
    st, sp, ap, cp = (None if x is None else np.asarray(x, np.float64)
                      for x in (st, sp, ap, cp))
    out = []
    for b, path in enumerate(np.asarray(paths)):
        n = int(lengths[b])
        s = st[b, 0, path[0]]
        for t in range(1, n):
            i, j = path[t - 1], path[t]
            if i == j and ns > 1:
                tr = sp[b, t, i]
            elif j == i + 1 and j % ns and ns > 1:
                tr = ap[b, t, i]
            else:
                tr = cp[b, t, i // ns, j // ns]
            s += tr + st[b, t, j]
        out.append(s)
    return np.asarray(out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def parity_phase():
    from asr_craft.ops import fdt
    B, T, P, ns, D = 128, 512, 48, 3, 144
    cfg, params, feats, labels, lengths = _problem(B, T, P, ns, D)
    check(fdt.recursion_impl(P) == "kernel", "the kernel is chosen on gpu")
    res = {}
    for impl in ("kernel", "scan"):
        with forced_impl(impl):
            res[impl] = _loss_and_grad(cfg, params, feats, labels, lengths)
    (lk, gk), (ls, gs) = res["kernel"], res["scan"]
    rel = abs(float(lk) - float(ls)) / abs(float(ls))
    print(f"train B={B} T={T}: loss kernel {float(lk)!r} scan {float(ls)!r}"
          f" rel {rel:.3g} (tol {LOGZ_RTOL})")
    check(np.isfinite(float(lk)) and rel <= LOGZ_RTOL, "loss parity")
    for k in gs:
        r = _rel(gk[k], gs[k])
        print(f"  grad {k}: max rel {r:.3g} (tol {GRAD_RTOL})")
        check(r <= GRAD_RTOL, f"gradient parity {k}")

    Bd = 64
    fd, nd = feats[:Bd], lengths[:Bd]
    valid = np.arange(T)[None, :] < np.asarray(nd)[:, None]
    for beam in ({}, {"beam_threshold": 10.0}, {"beam_width": 24}):
        out = {}
        for impl in ("kernel", "scan"):
            with forced_impl(impl):
                out[impl] = _decode(cfg, params, fd, nd, **beam)
        (pk, sk), (px, sx) = out["kernel"], out["scan"]
        srel = _rel(sk, sx)
        diff = np.any((np.asarray(pk) != np.asarray(px)) & valid, axis=1)
        print(f"decode B={Bd} {beam or 'exact'}: score max rel {srel:.3g} "
              f"(tol {SCORE_RTOL}); rows whose paths differ: "
              f"{int(diff.sum())}")
        check(srel <= SCORE_RTOL, f"Viterbi score parity {beam}")
        if diff.any():                       # ties: equal-scoring paths
            rows = np.nonzero(diff)[0]
            a = _path_scores(cfg, params, fd[rows], nd[rows],
                             np.asarray(pk)[rows])
            b = _path_scores(cfg, params, fd[rows], nd[rows],
                             np.asarray(px)[rows])
            check(_rel(a, b) <= SCORE_RTOL, "differing paths are ties")
    oracle_check()


def oracle_check():
    """Kernel logZ and Viterbi against the float64 NumPy oracle on the
    materialized (T, L', L') lattice, small shape."""
    from asr_craft.models import crf
    from asr_craft.ops import fdt, oracle
    cfg, params, feats, labels, lengths = _problem(3, 16, 5, 3, 12, seed=1)
    state, trans = crf.potentials(cfg, params, feats)
    state = np.asarray(crf.apply_boundaries(cfg, state, lengths))
    trans = np.asarray(trans)
    pl = fdt.factored_planes(params, feats, cfg.fmap.num_expanded, 3,
                             cfg.fmap.state_range, cfg.fmap.trans_range)
    z = fdt._logZ_dual(*pl, labels, lengths, 3, 3, True, "kernel")[0]
    paths, scores = fdt._viterbi(*pl, lengths, 3, True, None, None, "kernel")
    for b in range(3):
        n = int(lengths[b])
        _, zo = oracle.forward_np(state[b], trans[b], n)
        po, so = oracle.viterbi_np(state[b], trans[b], n)
        print(f"oracle b={b}: logZ {float(z[b])!r} vs {zo!r}; "
              f"score {float(scores[b])!r} vs {so!r}")
        check(abs(float(z[b]) - zo) <= ORACLE_RTOL * abs(zo), "oracle logZ")
        check(abs(float(scores[b]) - so) <= ORACLE_RTOL * abs(so),
              "oracle Viterbi score")
        check(list(np.asarray(paths[b, :n])) == po, "oracle Viterbi path")


def _median_ms(fn, state):
    import jax
    state = jax.block_until_ready(fn(state))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        state = jax.block_until_ready(fn(state))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def timing_phase():
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship, _tiny_batch
    from asr_craft.models.crf import decode
    from asr_craft.ops import fdt
    from asr_craft.train import TrainConfig, make_train_step

    cfg = _flagship()
    params = cfg.init_params(scale=0.01)
    batch = _tiny_batch(cfg, B=128, T=512)
    dbatch = _tiny_batch(cfg, B=64, T=512)
    planes = jax.jit(lambda p, f: fdt.factored_planes(
        p, f, 144, 3, cfg.fmap.state_range, cfg.fmap.trans_range))
    st, sp, ap, cp = planes(params, batch["feats"])
    n = batch["lengths"]
    emis = jnp.stack([st, st])
    lr = jnp.float32(0.05)
    rows = {}
    dplanes = planes(params, dbatch["feats"])
    dn = dbatch["lengths"]
    for impl in ("kernel", "scan"):
        with forced_impl(impl):
            @jax.jit
            def passes(e, s, a, c, n):
                (al, _z), ops = fdt._forward(e, s, a, c, n, 3, impl)
                return al, fdt._backward(e, s, a, c, n, 3, impl, ops)

            vit = jax.jit(lambda s, a, c, d, n: fdt._viterbi(
                s, a, c, d, n, 3, True, None, None, impl))
            step, opt = make_train_step(cfg, TrainConfig(lr=0.05))
            dec = jax.jit(lambda p, f, n: decode(cfg, p, f, n))
            rec = _median_ms(lambda _: passes(emis, sp, ap, cp, n), None)
            vi = _median_ms(lambda _: vit(*dplanes, dn), None)
            tr = _median_ms(lambda st: step(*st, batch, lr)[:3],
                            (params, opt.init(params), params))
            de = _median_ms(lambda _: dec(params, dbatch["feats"], dn), None)
        rows[impl] = (rec, vi, tr, de)
    names = ("dual alpha+beta passes B=128", "Viterbi pass+traceback B=64",
             "train step B=128", "exact decode B=64")
    for i, name in enumerate(names):
        k, s = rows["kernel"][i], rows["scan"][i]
        print(f"time {name} T=512 [{card()}]: kernel {k:.3f} ms, "
              f"XLA scan {s:.3f} ms, ratio {s / k:.2f}x")
    return rows


class _Counts:
    def __init__(self):
        self.passed = self.skipped = self.failed = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.failed:
            self.failed += 1


def tests_phase():
    import pytest
    counts = _Counts()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "--rootdir", ROOT,
                      os.path.join(ROOT, "tests", "gpu")],
                     plugins=[counts])
    print(f"gpu tests: {counts.passed} passed, {counts.skipped} skipped, "
          f"{counts.failed} failed")
    check(rc == 0 and counts.passed > 0 and counts.skipped == 0
          and counts.failed == 0, "card-marked tests")


def four_phase():
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship, _tiny_batch
    from asr_craft.models.crf import CrfConfig, crf_loss, decode
    from asr_craft.parallel.mesh import (make_batch_put, make_mesh,
                                         replicate_tree)
    from asr_craft.parallel.timeshard import sharded_decode
    from asr_craft.train import TrainConfig, make_train_step

    cfg = _flagship()
    params = cfg.init_params(scale=0.01)
    hb = _tiny_batch(cfg, B=128, T=512)
    lg = jax.jit(jax.value_and_grad(lambda p, b: crf_loss(
        cfg, p, b["feats"], b["labels"], b["lengths"])[0]))
    one = jax.device_put(hb, jax.devices()[0])
    l1, g1 = lg(params, one)
    mesh = make_mesh(4)
    ln, gn = lg(replicate_tree(mesh, params), make_batch_put(mesh)(hb))
    rel = abs(float(ln) - float(l1)) / abs(float(l1))
    print(f"data-parallel step, 4 cards vs 1 [{card()}]: loss rel {rel:.3g}"
          f" (tol {LOGZ_RTOL})")
    check(np.isfinite(float(ln)) and rel <= LOGZ_RTOL, "DP loss")
    for k in g1:
        r = _rel(gn[k], g1[k])
        print(f"  grad {k}: max rel {r:.3g} (tol {GRAD_RTOL})")
        check(r <= GRAD_RTOL, f"DP gradient {k}")
    step, opt = make_train_step(cfg, TrainConfig(lr=0.05))
    rep = replicate_tree(mesh, params)
    new, _, _, m = step(rep, opt.init(rep), rep, make_batch_put(mesh)(hb),
                        jnp.float32(0.05))
    check(all(leaf.sharding.is_fully_replicated and
              bool(np.all(np.isfinite(np.asarray(leaf))))
              for leaf in jax.tree.leaves(new)), "DP update replicated")
    print(f"data-parallel train step (update) loss {float(m['loss'])!r}")

    tcfg = CrfConfig(num_labels=48, feat_dim=144, num_states=3)
    tp = tcfg.init_params(scale=0.05)
    rng = np.random.default_rng(2)
    Tl = 16384
    feats = jnp.asarray(rng.normal(size=(4, Tl, 144)), jnp.float32)
    lengths = jnp.asarray([Tl, Tl - 1000, Tl - 4097, 9000], jnp.int32)
    _, pu, su = decode(tcfg, tp, feats, lengths)
    _, ps, ss = sharded_decode(tcfg, tp, feats, lengths, 4)
    valid = np.arange(Tl)[None, :] < np.asarray(lengths)[:, None]
    ndiff = int(((np.asarray(pu) != np.asarray(ps)) & valid).sum())
    srel = _rel(ss, su)
    print(f"time-sharded decode T={Tl}, 4 cards vs unsharded: frames that "
          f"differ {ndiff}, score max rel {srel:.3g} (tol {TIMESHARD_RTOL})")
    check(ndiff == 0 and srel <= TIMESHARD_RTOL, "time-sharded decode parity")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    with phase("a: device"):
        dev = device_phase(4 if args.four else 1)
    if args.four:
        with phase("four cards: data parallel and time-sharded decode"):
            four_phase()
    else:
        with phase("b: train CLI"):
            weights = train_phase()
        with phase("c: decode CLI"):
            decode_phase(weights)
        with phase("d: parity"):
            parity_phase()
        with phase("e: timing"):
            timing_phase()
        with phase("f: card-marked tests"):
            tests_phase()
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
