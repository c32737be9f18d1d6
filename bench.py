"""Benchmark: audio-seconds of speech processed per second on one device.

Metrics (BASELINE.json): audio-seconds/s for training (loss + gradient +
update) on the flagship triphone-state CRF (config 2, B=128 T=512 48x3
D=144), exact Viterbi decode at B=64, the loader-fed training epoch, and
the streaming segmental CRF (B=128 T=512 L=48 Dmax=16) train and decode.

Every time is the median of several calls after warm-up, each ended by
``jax.block_until_ready``.  Roofline shares come from
``utils/roofline.py`` and only for a device kind in its peaks table.  The
script refuses to run on the CPU: its numbers are device numbers.

Usage: ``python bench.py`` (one JSON line per cell, the headline last), or
``python bench.py --scaling [--check]`` for data-parallel weak scaling.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

B, T = 128, 512      # train batch
DECODE_B = 64
FRAME_S = 0.01       # 10 ms frames
REPS = 5             # timed calls per cell (median reported)
TRAIN_PRECISION = "bf16x3"


def _device():
    import jax
    d = jax.devices()[0]
    if d.platform == "cpu":
        raise SystemExit("bench.py measures a GPU; JAX found only the CPU")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _median_s(fn, state, reps=REPS):
    """Median seconds of ``state = fn(state)`` over ``reps`` calls, each
    ended by block_until_ready; one untimed warm-up call first."""
    import jax
    state = jax.block_until_ready(fn(state))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(fn(state))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), state


def bench_train_step(B=B, precision=None, spc=4):
    """Flagship train step: ``spc`` optimizer steps fused per dispatch
    (TrainConfig.steps_per_call), time per step."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship, _tiny_batch
    from asr_craft.train import TrainConfig, make_train_step

    cfg = _flagship()
    if precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    tc = TrainConfig(lr=0.1, steps_per_call=spc)
    params = cfg.init_params(scale=0.01)
    step_fn, opt = make_train_step(cfg, tc)
    batch = _tiny_batch(cfg, B=B, T=T)
    stacked = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (spc,) + x.shape), batch)
    lr = jnp.float32(tc.lr)

    def call(state):
        p, s, a, _ = state
        return step_fn.multi_step(p, s, a, stacked, lr)

    dt, (_, _, _, ms) = _median_s(
        call, (params, opt.init(params), params, None))
    dt /= spc
    return B * T * FRAME_S / dt, dt, float(ms["loss"][-1])


def bench_train_epoch_loader(n_utts=512, precision=TRAIN_PRECISION):
    """Training fed by the bucketing UtteranceLoader; audio-s/s over the
    second epoch (the first pays compiles)."""
    import dataclasses
    import jax
    from __graft_entry__ import _flagship
    from asr_craft import data
    from asr_craft.train import TrainConfig, Trainer
    from asr_craft.utils.logging import MetricsLogger

    cfg = dataclasses.replace(_flagship(), precision=precision)
    scfg = data.SyntheticConfig(num_labels=48, feat_dim=cfg.feat_dim,
                                noise=0.3, min_len=300, max_len=512, seed=3)
    feats, labels, _ = data.generate_corpus(scfg, n_utts)
    loader = data.UtteranceLoader(
        feats, labels, data.LoaderConfig(batch_size=B, buckets=(512,),
                                         shuffle=True))
    tr = Trainer(cfg, TrainConfig(lr=0.1, steps_per_call=8,
                                  log_every=10_000),
                 logger=MetricsLogger(quiet=True))
    tr.train_epoch(loader)
    jax.block_until_ready(tr.params)
    t0 = time.perf_counter()
    tr.train_epoch(loader)
    jax.block_until_ready(tr.params)
    dt = time.perf_counter() - t0
    return sum(len(l) for l in labels) * FRAME_S / dt


def bench_decode():
    import jax
    from __graft_entry__ import _flagship, _tiny_batch
    from asr_craft.models.crf import decode

    cfg = _flagship()
    params = cfg.init_params(scale=0.01)
    batch = _tiny_batch(cfg, B=DECODE_B, T=T)
    step = jax.jit(lambda p, f, n: decode(cfg, p, f, n))
    dt, _ = _median_s(
        lambda _: step(params, batch["feats"], batch["lengths"]), None)
    return DECODE_B * T * FRAME_S / dt, dt


def bench_scrf():
    """Segmental-CRF production shape (the (B, T, Dmax, L) tensor would be
    17 GB): streaming train step and streaming decode."""
    import jax
    import jax.numpy as jnp
    import optax
    from asr_craft.models.segmental import (SegCrfConfig, scrf_decode,
                                            scrf_loss_fused)

    Bs, Ts, L, D, Dmax = 128, 512, 48, 144, 16
    cfg = SegCrfConfig(num_labels=L, feat_dim=D, max_dur=Dmax)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(Bs, Ts, D)), jnp.float32)
    runs = np.repeat(rng.integers(0, L, size=(Bs, Ts // 4)), 4, axis=1)
    labels = jnp.asarray(runs[:, :Ts], jnp.int32)
    lengths = jnp.full((Bs,), Ts, jnp.int32)
    opt = optax.sgd(0.05)

    @jax.jit
    def train(state, feats, labels, lengths):
        p, s = state
        g = jax.grad(lambda q: scrf_loss_fused(cfg, q, feats, labels,
                                               lengths)[0])(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s

    params = cfg.init_params()
    train_dt, (params, _) = _median_s(
        lambda st: train(st, feats, labels, lengths),
        (params, opt.init(params)))
    dec = jax.jit(lambda p, f, n: scrf_decode(cfg, p, f, n))
    dec_dt, _ = _median_s(lambda _: dec(params, feats, lengths), None)
    return {"B": Bs, "T": Ts, "L": L, "Dmax": Dmax,
            "train_ms": train_dt * 1e3,
            "train_audio_s_per_s": Bs * Ts * FRAME_S / train_dt,
            "decode_ms": dec_dt * 1e3,
            "decode_audio_s_per_s": Bs * Ts * FRAME_S / dec_dt}, \
        train_dt, dec_dt


def bench_scaling(per_device_batch=16, check=False):
    """Weak scaling of the data-parallel flagship train step at 1..N
    devices with the per-device batch fixed: efficiency =
    aps(n) / (n * aps(1)).  ``check``: per device count, the sharded
    loss and gradients must equal the single-device ones on the same
    global batch (the psum reorders the batch reduction, hence the
    tolerance)."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship, _tiny_batch
    from asr_craft.models.crf import crf_loss
    from asr_craft.parallel.mesh import (make_batch_put, make_mesh,
                                         replicate_tree)
    from asr_craft.train import TrainConfig, make_train_step

    ndev = len(jax.devices())
    ns = [n for n in (1, 2, 4, 8) if n <= ndev]
    cfg = _flagship()
    tc = TrainConfig(lr=0.1)
    rows, base = {}, None
    for n in ns:
        mesh = make_mesh(n)
        put = make_batch_put(mesh)
        params = replicate_tree(mesh, cfg.init_params(scale=0.01))
        step_fn, opt = make_train_step(cfg, tc)
        hb = _tiny_batch(cfg, B=per_device_batch * n, T=T)
        batch = put(hb)
        lr = jnp.float32(tc.lr)

        def call(state):
            p, s, a = state
            return step_fn(p, s, a, batch, lr)[:3]

        dt, _ = _median_s(call, (params, opt.init(params), params))
        aps = per_device_batch * n * T * FRAME_S / dt
        base = base or aps
        rows[n] = {"audio_s_per_s": aps, "ms_per_step": dt * 1e3,
                   "efficiency": aps / (n * base)}
        if check:
            p0 = cfg.init_params(scale=0.01)
            lg = jax.jit(jax.value_and_grad(lambda p, b: crf_loss(
                cfg, p, b["feats"], b["labels"], b["lengths"])[0]))
            l1, g1 = lg(p0, jax.device_put(
                {k: jnp.asarray(v) for k, v in hb.items()},
                jax.devices()[0]))
            ln, gn = lg(replicate_tree(mesh, p0), batch)
            loss_rel = abs(float(ln) - float(l1)) / max(abs(float(l1)),
                                                        1e-30)
            grad_rel = max(
                float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                      / max(float(np.max(np.abs(np.asarray(a)))), 1e-30))
                for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(gn)))
            rows[n]["check"] = {"loss_rel": loss_rel, "grad_max_rel": grad_rel,
                                "ok": loss_rel < 1e-5 and grad_rel < 1e-4}
    return rows


def main():
    from asr_craft.utils import roofline as rl
    from asr_craft.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = _device()
    if "--scaling" in sys.argv:
        print(json.dumps({"device": dev, "scaling": bench_scaling(
            check="--check" in sys.argv)}))
        return
    train_aps, train_dt, loss = bench_train_step(precision=TRAIN_PRECISION)
    f32_aps, f32_dt, f32_loss = bench_train_step(precision="highest")
    loader_aps = bench_train_epoch_loader()
    decode_aps, decode_dt = bench_decode()
    scrf, scrf_tr, scrf_dec = bench_scrf()
    kind = dev["kind"]
    shares = {
        "train_fp32": rl.share(rl.fdt_train_work(B, T, 48, 3, 144),
                               f32_dt, kind),
        "decode": rl.share(rl.fdt_decode_work(DECODE_B, T, 48, 3, 144),
                           decode_dt, kind),
        "scrf_train": rl.share(rl.scrf_train_work(128, 512, 48, 144, 16),
                               scrf_tr, kind),
        "scrf_decode": rl.share(rl.scrf_decode_work(128, 512, 48, 144, 16),
                                scrf_dec, kind),
    }
    print(json.dumps({"device": dev, "roofline": shares}))
    print(json.dumps({"device": dev, "scrf": scrf}))
    print(json.dumps({"device": dev, "aux": {
        "decode_audio_s_per_s": decode_aps, "decode_ms": decode_dt * 1e3,
        "B": B, "T": T, "decode_B": DECODE_B,
        "train_precision": TRAIN_PRECISION, "train_ms": train_dt * 1e3,
        "loader_epoch_audio_s_per_s": loader_aps,
        "train_fp32_audio_s_per_s": f32_aps, "train_fp32_ms": f32_dt * 1e3,
        "train_loss_delta_vs_fp32": abs(loss - f32_loss)}}))
    print(json.dumps({"device": dev,
                      "metric": "train_audio_s_per_s",
                      "value": train_aps,
                      "unit": "audio-seconds/s"}))


if __name__ == "__main__":
    main()
