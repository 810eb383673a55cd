"""The metric arithmetic against hand counts at small shapes: busy time,
range attribution, idle gaps, the two kernels' roofline counts and the
FLOP count."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench.harness import flops, metrics, trace
from h100bench.drivers.sampler import percentile
from h100bench.reference.unet import GEGLU, Norm, TemporalBlock
from h100bench.reference import ops
from h100bench.tests.tiny import I2V, TRAIN, tiny_cell


def test_busy_time_is_the_union():
    iv = [(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (21, 22, "d")]
    assert trace.busy_us(iv) == 12 + 5
    events = [{"cat": "kernel", "ts": 3, "dur": 4, "name": "k"},
              {"cat": "cpu_op", "ts": 0, "dur": 9, "name": "op"},
              {"cat": "gpu_memcpy", "ts": 8, "dur": 1, "name": "m"}]
    assert trace.device_intervals(events) == [(3, 7, "k"), (8, 9, "m")]


def _launch(tid, ts, corr):
    return {"cat": "cuda_runtime", "name": "launch", "tid": tid, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _range(name, tid, ts, dur):
    return {"cat": "user_annotation", "name": trace.RANGE_PREFIX + name,
            "tid": tid, "ts": ts, "dur": dur}


def test_range_attribution_takes_the_innermost_range_of_the_thread():
    events = [
        _range("unet", 1, 0, 100), _range("block:4x2", 1, 10, 20),
        _range("block:4x2", 1, 40, 10), _range("other", 2, 0, 100),
        _launch(1, 15, 1), _launch(1, 35, 2), _launch(1, 45, 3),
        _launch(2, 60, 4), _launch(1, 150, 5),
        _kernel(200, 7, 1), _kernel(210, 11, 2), _kernel(230, 13, 3),
        _kernel(250, 17, 4), _kernel(270, 19, 5)]
    rec = trace.Records(events, trace.device_intervals(events), 1.0, 0.5,
                        [], 0, None)
    us, calls = rec.ranges()
    p = trace.RANGE_PREFIX
    assert us == {p + "block:4x2": 7 + 13, p + "unet": 11, p + "other": 17}
    assert calls == {p + "unet": 1, p + "block:4x2": 2, p + "other": 1}


def test_idle_gaps_go_to_what_the_host_was_doing():
    events = [{"cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
              {"cat": "cpu_op", "name": "inner", "ts": 20, "dur": 10},
              {"cat": "cpu_op", "name": "late", "ts": 60, "dur": 30}]
    iv = [(0, 25, "a"), (28, 40, "b"), (70, 80, "c"), (79, 81, "d")]
    gaps = trace.idle_gaps(events, iv)
    assert gaps == {"inner": pytest.approx(3e-6),
                    "outer": pytest.approx(30e-6)}
    gaps = trace.idle_gaps(events, iv, labelled=1)
    assert gaps == {"outer": pytest.approx(30e-6),
                    "(shorter gaps)": pytest.approx(3e-6)}


def _matmul_flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("p,f,c,heads", [(2, 3, 8, 2), (5, 16, 16, 4)])
def test_motion_block_roofline_counts(p, f, c, heads):
    mod = metrics.load("motion_block_roofline.sample")
    ops_, nbytes = mod.ops_bytes(p, f, c)
    assert ops_ == p * (40 * f * c * c + 8 * f * f * c)
    block = TemporalBlock(c, heads)
    assert ops_ == _matmul_flops(lambda: block(torch.randn(p, f, c)))
    weights = sum(t.numel() for t in block.parameters())
    assert weights == 20 * c * c + 17 * c
    assert nbytes == 2 * (2 * p * f * c + weights + f * c)
    assert mod.bound_s(p, f, c) == max(ops_ / 989e12, nbytes / 3.35e12)


@pytest.mark.parametrize("r,c", [(7, 8), (64, 32)])
def test_ln_geglu_roofline_counts(r, c):
    mod = metrics.load("ln_geglu_roofline.sample")
    ops_, nbytes = mod.ops_bytes(r, c)
    ff, norm = GEGLU(c), Norm(c)
    assert ops_ == _matmul_flops(
        lambda: ff(ops.layer_norm(torch.randn(r, c), norm)))
    weights = sum(t.numel() for t in ff.parameters()) + 2 * c
    assert nbytes == 2 * (2 * r * c + weights)


def test_roofline_reads_sum_bound_over_device_time():
    mod = metrics.load("ln_geglu_roofline.sample")
    events = [_range("fused_ln_geglu:100x8", 1, 0, 10), _launch(1, 5, 1),
              _kernel(20, 4, 1), _range("fused_ln_geglu:50x16", 1, 30, 10),
              _launch(1, 35, 2), _kernel(40, 6, 2)]
    rec = trace.Records(events, trace.device_intervals(events), 1.0, 0.5,
                        [], 0, None)
    want = 100 * (mod.bound_s(100, 8) + mod.bound_s(50, 16)) / 10e-6
    assert mod.read(rec) == pytest.approx(want)
    empty = trace.Records([], [], 1.0, 0.5, [], 0, None)
    assert mod.read(empty) is None


def test_flop_count_by_hand():
    lin = torch.nn.Linear(4, 8)
    assert flops._count(lambda: lin(torch.randn(3, 4))) == 2 * 3 * 4 * 8
    conv = torch.nn.Conv2d(2, 5, 3, padding=1)
    assert flops._count(lambda: conv(torch.randn(1, 2, 6, 6))) \
        == 2 * 36 * 5 * 2 * 9


def test_request_flops_grow_with_the_steps():
    cell = tiny_cell(I2V, steps=1)
    one = flops.request_flops(cell.config, cell.traffic)
    three = flops.request_flops(cell.config, dict(cell.traffic, steps=3))
    five = flops.request_flops(cell.config, dict(cell.traffic, steps=5))
    assert three - one == five - three > 0


def test_step_flops_count_forward_and_backward():
    cell = tiny_cell(TRAIN)
    small = flops.step_flops(cell.config, cell.traffic, 2)
    large = flops.step_flops(cell.config, cell.traffic, 8)
    assert 0 < small < large


def test_percentile_stays_within_the_samples():
    assert percentile([1.0, 2.0, 3.0], 0.9) == pytest.approx(2.8)
    assert percentile([4.0], 0.9) == 4.0


def test_mfu_and_idle_readers():
    cell = tiny_cell(I2V)
    work = [{"kind": "request", "frames": 4, "clips": 1}] * 2
    rec = trace.Records([], [(0, 1, "k")], 2.0, 1.5, work, 3 * 2 ** 30,
                        cell)
    per = flops.request_flops(cell.config, cell.traffic)
    assert metrics.load("mfu.sample").read(rec) == pytest.approx(
        100 * 2 * per / (2.0 * 989e12))
    assert metrics.load("idle_share.sample").read(rec) == pytest.approx(25)
    assert metrics.load("peak_gib.sample").read(rec) == pytest.approx(3)
    assert metrics.load("idle_share.train").read(rec) == pytest.approx(25)
    assert metrics.load("peak_gib.train").read(rec) == pytest.approx(3)
    empty = trace.Records([], [(0, 1, "k")], 2.0, 1.5, [], 0, cell)
    for name in ("idle_share.sample", "peak_gib.train"):
        assert metrics.load(name).read(empty) is None


def test_a_layer_range_counts_the_kernels_of_ranges_nested_in_it():
    events = [
        _range("unet", 1, 0, 100), _range("fused_motion_block:4x2x8x2", 1,
                                           10, 20),
        _range("unet", 1, 200, 50),
        _launch(1, 15, 1), _launch(1, 40, 2), _launch(1, 210, 3),
        _launch(1, 150, 4),
        _kernel(300, 7, 1), _kernel(310, 11, 2), _kernel(330, 13, 3),
        _kernel(350, 17, 4)]
    rec = trace.Records(events, trace.device_intervals(events), 1.0, 0.5,
                        [], 0, None)
    assert rec.inclusive("unet") == (7 + 11 + 13, 2)
    assert metrics.load("unet_eval_ms.sample").read(rec) == pytest.approx(
        31 / 1e3 / 2)
    us, _ = rec.ranges()
    assert us[trace.RANGE_PREFIX + "unet"] == 11 + 13
