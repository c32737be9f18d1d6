"""Roofline shares for bench.py: published peaks by device kind, and the
FLOPs and bytes of each timed step counted from its shapes.

A share is the least time the device could take — the larger of FLOPs over
peak FLOP/s and bytes over peak bandwidth — divided by the measured time.
It is given only for a device kind listed in :data:`PEAKS`; for any other
kind :func:`share` returns None rather than a guess.

The counts follow the XLA code path of ``ops.fdt`` (plane formation GEMMs,
the recursions' plane reads, the gradient assembly).  They count tensor
traffic at the shapes the code uses (P padded to a power of two inside the
kernels), not an idealized algorithm, so a count that shrinks is a real
saving.  The recursions' exps and reductions are not FLOPs of the tensor
cores and are not counted; the recursions are latency-bound chains of T
dependent frames, which no roofline term captures.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Peaks", "PEAKS", "peaks_for", "Work", "fdt_train_work",
           "fdt_decode_work", "scrf_train_work", "scrf_decode_work", "share"]

_F32 = 4


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Dense peak rates of one device (no sparsity)."""
    hbm_gbps: float
    fp32_tflops: float       # without the tensor cores
    tf32_tflops: float
    bf16_tflops: float
    source: str


# Keyed by ``jax.devices()[0].device_kind``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        hbm_gbps=3350.0, fp32_tflops=67.0, tf32_tflops=495.0,
        bf16_tflops=989.0,
        source="NVIDIA H100 SXM data sheet, dense, at the 700 W limit"),
}


def peaks_for(kind: str) -> Peaks | None:
    """The peaks of ``kind``, or None for a kind not in the table."""
    return PEAKS.get(kind)


@dataclasses.dataclass(frozen=True)
class Work:
    """FLOPs (matrix products) and device-memory bytes of one step."""
    flops: float
    bytes: float


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _formation(B, T, P, ns, D):
    """GEMM FLOPs and output bytes of ``ops.fdt.factored_planes``."""
    Lp = P * ns
    cols = Lp + P * P + (2 * Lp if ns > 1 else 0)
    return 2.0 * B * T * D * cols, B * T * cols * _F32


def fdt_train_work(B: int, T: int, P: int, ns: int, D: int) -> Work:
    """One config-2 train step: plane formation, the dual alpha and beta
    passes (each reads every plane once), the gradient assembly (reads the
    planes, alphas and betas, writes plane cotangents) and the weight
    GEMMs, plus the optimizer's read-modify-write of the parameters."""
    Lp = P * ns
    flops, planes = _formation(B, T, P, ns, D)
    Pp = _pow2(P)
    padded = B * T * (Pp * Pp + 3 * ns * Pp) * _F32     # kernel operands
    lattice = 2 * B * T * Lp * _F32                     # alphas or betas
    feats = B * T * D * _F32
    n_param = D * Lp + D * Lp * Lp + Lp + Lp * Lp
    byt = (feats + planes                 # formation
           + planes + padded              # slot layout
           + 2 * padded + 2 * lattice     # alpha + beta passes
           + planes + 2 * lattice + planes   # gradient assembly
           + feats + planes               # weight GEMMs
           + 3 * n_param * _F32)          # optimizer
    return Work(flops=2.0 * flops, bytes=float(byt))


def fdt_decode_work(B: int, T: int, P: int, ns: int, D: int) -> Work:
    """One config-2 decode: plane formation, the max-plus pass (reads the
    planes, writes int32 backpointers) and the traceback."""
    Lp = P * ns
    flops, planes = _formation(B, T, P, ns, D)
    Pp = _pow2(P)
    padded = B * T * (Pp * Pp + 3 * ns * Pp) * _F32
    bp = B * T * ns * Pp * 4
    byt = (B * T * D * _F32 + planes + planes + padded + padded + bp
           + B * T * Lp * 4)
    return Work(flops=flops, bytes=float(byt))


def scrf_train_work(B: int, T: int, L: int, D: int, Dmax: int) -> Work:
    """One streaming SCRF train step (``ops.segmental_stream``): frame
    scores, the alpha, beta and xi scans with one (Dmax*B, L) @ (L, L)
    message product per frame each (two in the xi scan), and the weight
    GEMM."""
    msg = 2.0 * Dmax * B * L * L * T
    frame = 2.0 * B * T * D * L
    row = B * T * L * _F32
    byt = B * T * D * _F32 * 2 + row * 12
    return Work(flops=4 * msg + 2 * frame, bytes=float(byt))


def scrf_decode_work(B: int, T: int, L: int, D: int, Dmax: int) -> Work:
    """One streaming SCRF decode: frame scores and the max-plus scan."""
    row = B * T * L * _F32
    return Work(flops=2.0 * B * T * D * L,
                bytes=float(B * T * D * _F32 + row * 6))


def share(work: Work, seconds: float, kind: str,
          precision: str = "fp32") -> dict | None:
    """Roofline record for ``work`` done in ``seconds`` on ``kind``.

    ``precision`` names the FLOP peak: "fp32" (the parity bar's products,
    outside the tensor cores), "tf32" or "bf16".  None for an unknown
    kind."""
    pk = peaks_for(kind)
    if pk is None:
        return None
    peak = {"fp32": pk.fp32_tflops, "tf32": pk.tf32_tflops,
            "bf16": pk.bf16_tflops}[precision] * 1e12
    t_flop = work.flops / peak
    t_mem = work.bytes / (pk.hbm_gbps * 1e9)
    floor = max(t_flop, t_mem)
    return {"floor_ms": floor * 1e3,
            "share": floor / seconds,
            "bound": "compute" if t_flop >= t_mem else "memory",
            "gflop": work.flops / 1e9, "gbytes": work.bytes / 1e9,
            "peaks": pk.source}
