"""The reader of the GroupNorm kernel's spans on hand-built events: the
kernel's roofline (its byte bound worked out by hand at two shapes and
both element sizes), which reads nothing where the program has no such
span."""

from __future__ import annotations

import pytest

from h100bench.harness import metrics, trace
from h100bench.harness.cell import load_cell
from h100bench.harness.device import HBM_BYTES_PER_S
from h100bench.tests.test_bench_metrics import _kernel, _launch
from h100bench.tests.tiny import I2V

ROOFLINE = "group_norm_span_roofline.sample"
KERNEL = "fyc.kernel.fused_group_norm:"


def _span(name, tid, ts, dur):
    return {"cat": "user_annotation", "name": name, "tid": tid, "ts": ts,
            "dur": dur}


def _records(events):
    return trace.Records(events, trace.device_intervals(events), 1.0, 0.5,
                         [], 0, None, [])


@pytest.mark.parametrize("b,n,c,esize,nbytes", [
    # x in and y out, 2·B·N·C elements, and the scale and the bias, 2·C
    (2, 65536, 320, 2, 2 * (2 * 2 * 65536 * 320 + 2 * 320)),
    (16, 262144, 128, 4, 4 * (2 * 16 * 262144 * 128 + 2 * 128))])
def test_the_roofline_bound_is_one_read_and_one_write(b, n, c, esize,
                                                      nbytes):
    bound_s = metrics.load(ROOFLINE).bound_s
    assert bound_s(b, n, c, esize) == pytest.approx(nbytes / 3.35e12)
    assert HBM_BYTES_PER_S == 3.35e12


def test_the_roofline_sums_bound_over_device_time():
    """Each span's launches (one cluster launch, or the two-pass
    path's two) count in it; kernels outside the spans count nowhere."""
    mod = metrics.load(ROOFLINE)
    events = [_span(KERNEL + "2x4096x320x2", 1, 0, 10),
              _launch(1, 5, 1), _kernel(100, 4, 1),
              _span(KERNEL + "16x262144x128x4", 1, 20, 10),
              _launch(1, 22, 2), _launch(1, 25, 3),
              _kernel(110, 30, 2), _kernel(150, 50, 3),
              _span("fyc.unet.full", 1, 40, 10),
              _launch(1, 45, 4), _kernel(300, 90, 4)]
    want = 100 * (mod.bound_s(2, 4096, 320, 2)
                  + mod.bound_s(16, 262144, 128, 4)) / 84e-6
    assert mod.read(_records(events)) == pytest.approx(want)


def test_a_program_without_the_route_reads_nothing():
    """The parent of the route has the tracer but not the span."""
    events = [_span("fyc.unet.full", 1, 0, 10), _launch(1, 5, 1),
              _kernel(20, 4, 1)]
    assert metrics.load(ROOFLINE).read(_records(events)) is None


def test_the_sampler_cell_lists_the_reader():
    """The reader shares the cell's one tracer block."""
    assert ROOFLINE in [m["name"] for m in load_cell(I2V).per_layer]
    assert list(metrics.load(ROOFLINE).ranges({})) == ["program_tracing"]
