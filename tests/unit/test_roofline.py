"""Roofline shares (utils/roofline.py): the peaks table keyed by device
kind refuses kinds it does not list, and the shape-derived work counts
behave like counts."""
import math

import pytest

from asr_craft.utils import roofline as rl

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "",
                                  "NVIDIA H100 PCIe"])
def test_unknown_kind_gives_no_share(kind):
    assert rl.peaks_for(kind) is None
    assert rl.share(rl.Work(1e9, 1e9), 1e-3, kind) is None


def test_h100_peaks_are_the_data_sheet():
    pk = rl.peaks_for(H100)
    assert (pk.hbm_gbps, pk.fp32_tflops, pk.tf32_tflops, pk.bf16_tflops) \
        == (3350.0, 67.0, 495.0, 989.0)
    assert "data sheet" in pk.source


@pytest.mark.parametrize("flops,byts,bound", [(1e12, 1e6, "compute"),
                                              (1e6, 1e10, "memory")])
def test_share_picks_the_binding_bound(flops, byts, bound):
    s = rl.share(rl.Work(flops, byts), 0.5, H100)
    assert s["bound"] == bound
    floor = max(flops / 67e12, byts / 3350e9)
    assert math.isclose(s["floor_ms"], floor * 1e3)
    assert math.isclose(s["share"], floor / 0.5)


def test_share_precision_selects_the_peak():
    w = rl.Work(1e13, 1.0)
    f32 = rl.share(w, 1.0, H100, "fp32")["floor_ms"]
    bf16 = rl.share(w, 1.0, H100, "bf16")["floor_ms"]
    assert math.isclose(f32 / bf16, 989.0 / 67.0)


@pytest.mark.parametrize("fn,args", [
    (rl.fdt_train_work, (512, 48, 3, 144)),
    (rl.fdt_decode_work, (512, 48, 3, 144)),
    (rl.scrf_train_work, (512, 48, 144, 16)),
    (rl.scrf_decode_work, (512, 48, 144, 16))])
def test_work_positive_and_linear_in_batch(fn, args):
    lo, hi = fn(32, *args), fn(64, *args)
    assert lo.flops > 0 and lo.bytes > 0
    assert math.isclose(hi.flops / lo.flops, 2.0, rel_tol=1e-9)
    assert math.isclose(hi.bytes / lo.bytes, 2.0, rel_tol=0.01)
