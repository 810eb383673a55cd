"""The metrics that read the program's own spans and counters
(``harness/spans.py``), against hand counts on hand-built events and a
hand-built record; the one tracer block every such metric shares; and the
benchmark's ``trace.idle_gaps`` naming the program's spans on a real CPU
profiler trace with hand-placed device intervals."""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time
import types

import pytest
import torch

from h100bench.harness import metrics, spans, trace
from h100bench.harness.cell import load_cell
from h100bench.tests.test_bench_metrics import _kernel, _launch
from h100bench.tests.tiny import I2V, TRAIN


def _span(name, tid, ts, dur):
    return {"cat": "user_annotation", "name": name, "tid": tid, "ts": ts,
            "dur": dur}


def _records(events, detail_work=()):
    return trace.Records(events, trace.device_intervals(events), 1.0, 0.5,
                         [], 0, None, list(detail_work))


REQUEST = {"kind": "request", "frames": 16, "clips": 2}
STEP = {"kind": "step", "frames": 72, "clip_frames": 24}


def test_request_spans_read_device_ms_per_unit():
    events = [
        _span("fyc.request", 1, 0, 1000),
        _span("fyc.encode_prompt", 1, 10, 20), _launch(1, 15, 1),
        _span("fyc.unet.full", 1, 40, 100), _launch(1, 50, 2),
        _span("fyc.kernel.fused_motion_block:4x2x8x2", 1, 60, 20),
        _launch(1, 65, 3),
        _span("fyc.unet.half", 1, 200, 100), _launch(1, 250, 4),
        _span("fyc.decode", 1, 400, 100), _launch(1, 450, 5),
        _launch(1, 600, 6),  # in the request, in no layer's span
        _span("fyc.encode_image", 1, 2000, 50), _launch(1, 2010, 7),
        _kernel(3000, 2000, 1), _kernel(5000, 3000, 2),
        _kernel(8000, 5000, 3), _kernel(13000, 7000, 4),
        _kernel(20000, 11000, 5), _kernel(31000, 13000, 6),
        _kernel(44000, 17000, 7)]
    rec = _records(events, [REQUEST, REQUEST])
    read = {name: metrics.load(name).read(rec) for name in (
        "text_encode_ms.sample", "vae_encode_ms.sample",
        "unet_span_ms.sample", "decode_span_ms.sample")}
    assert read == {
        "text_encode_ms.sample": pytest.approx(2.0 / 2),
        "vae_encode_ms.sample": pytest.approx(17.0 / 2),
        "unet_span_ms.sample": pytest.approx((3 + 5 + 7) / 2),
        "decode_span_ms.sample": pytest.approx(11.0 / 4)}


def test_a_kernel_in_a_span_and_a_range_counts_in_both():
    """A kernel nested in ``fyc.unet.full`` and ``h100bench.unet`` (and in
    the kernel's span and range inside them) counts in both
    ``unet_span_ms`` and ``unet_eval_ms``, and in both rooflines."""
    shape = "4x2x8x2"
    events = [
        _span(trace.RANGE_PREFIX + "unet", 1, 0, 100),
        _span("fyc.unet.full", 1, 5, 90),
        _span(trace.RANGE_PREFIX + "fused_motion_block:" + shape, 1, 10, 30),
        _span("fyc.kernel.fused_motion_block:" + shape, 1, 12, 26),
        _launch(1, 20, 1), _launch(1, 60, 2),
        _kernel(200, 7, 1), _kernel(210, 11, 2)]
    rec = _records(events, [REQUEST])
    span_ms = metrics.load("unet_span_ms.sample").read(rec)
    eval_ms = metrics.load("unet_eval_ms.sample").read(rec)
    assert span_ms == eval_ms == pytest.approx(18 / 1e3)
    outside = metrics.load("motion_block_roofline.sample")
    inside = metrics.load("motion_block_span_roofline.sample")
    want = 100 * outside.bound_s(4, 2, 8) / 7e-6
    assert inside.read(rec) == outside.read(rec) == pytest.approx(want)


def test_ln_geglu_span_roofline_sums_bound_over_device_time():
    mod = metrics.load("ln_geglu_span_roofline.sample")
    bound_s = metrics.load("ln_geglu_roofline.sample").bound_s
    events = [_span("fyc.kernel.fused_ln_geglu:100x8", 1, 0, 10),
              _launch(1, 5, 1), _kernel(20, 4, 1),
              _span("fyc.kernel.fused_ln_geglu:50x16", 1, 30, 10),
              _launch(1, 35, 2), _kernel(40, 6, 2),
              _span("fyc.kernel.fused_ln_geglu:50x16", 1, 50, 10),
              _launch(1, 55, 3), _kernel(60, 6, 3)]
    want = 100 * (bound_s(100, 8) + 2 * bound_s(50, 16)) / 16e-6
    assert mod.read(_records(events)) == pytest.approx(want)


def test_training_phases_take_what_every_thread_launched_in_them():
    """The backward's kernels are launched by the autograd engine's thread
    (tid 2) while ``fyc.train.backward`` is open on the calling thread."""
    events = [
        _span("fyc.train.step", 1, 0, 1000),
        _span("fyc.train.encode", 1, 10, 90), _launch(1, 20, 1),
        _span("fyc.train.forward", 1, 100, 100), _launch(1, 150, 2),
        _span("fyc.train.backward", 1, 200, 500), _launch(2, 300, 3),
        _launch(2, 400, 4),
        _span("fyc.train.optimizer", 1, 700, 200), _launch(1, 800, 5),
        _launch(1, 950, 6),  # in the step, in no phase
        _launch(2, 1100, 7),  # after the step
        _kernel(2000, 3000, 1), _kernel(5000, 5000, 2),
        _kernel(10000, 7000, 3), _kernel(17000, 11000, 4),
        _kernel(28000, 13000, 5), _kernel(41000, 17000, 6),
        _kernel(58000, 19000, 7)]
    rec = _records(events, [STEP])
    got = {n: metrics.load(n + ".train").read(rec)
           for n in ("encode_ms", "forward_ms", "backward_ms",
                     "optimizer_ms")}
    assert got == {"encode_ms": pytest.approx(3.0),
                   "forward_ms": pytest.approx(5.0),
                   "backward_ms": pytest.approx(18.0),
                   "optimizer_ms": pytest.approx(13.0)}


def _trace_record(counters, gc_ms):
    from followyourclick_tpu_torch.utils import profiling

    record = profiling.Trace(counters=counters)
    start = 0
    for ms in gc_ms:
        record.spans.append(profiling.Span(
            "fyc.gc", start, start + int(ms * 1e6), None, 0,
            {"generation": 0}))
        start += 10 ** 9
    record.spans.append(profiling.Span("fyc.gc", start, None, None, 0,
                                       {"generation": 2}))  # still open
    return record


def test_collections_inside_a_span_left_open_are_left_out(monkeypatch):
    """The detail part ends inside the next step's span, which the record
    leaves open, while the profiler writes its trace: its collections are
    the benchmark's."""
    from followyourclick_tpu_torch.utils import profiling

    record = profiling.Trace()
    S = profiling.Span
    record.spans += [
        S("fyc.train.encode", 0, 10, None, 0),
        S("fyc.gc", 2, 2_000_002, 0, 0, {"generation": 0}),
        S("fyc.train.step", 20, 90, None, 2),
        S("fyc.gc", 30, 3_000_030, 2, 2, {"generation": 1}),
        S("fyc.train.step", 100, None, None, 4),
        S("fyc.train.optimizer", 110, None, 4, 4),
        S("fyc.gc", 120, 400_000_120, 5, 4, {"generation": 0})]
    monkeypatch.setattr(spans, "LAST", record)
    rec = _records([], [STEP] * 2)
    assert metrics.load("gc_ms.train").read(rec) == pytest.approx(2.5)


def test_the_shared_block_holds_the_tracer_alone(monkeypatch):
    """It turns the program's tracer on and keeps its record; it forces no
    collection, with or without a tracer in the program."""
    from followyourclick_tpu_torch.utils import profiling

    seen = []
    monkeypatch.setattr(gc, "collect", lambda *a: seen.append(a))
    with spans.traced():
        assert profiling._SESSION is not None
    assert profiling._SESSION is None
    assert isinstance(spans.LAST, profiling.Trace)
    monkeypatch.delattr(profiling, "tracing")
    with spans.traced():
        pass
    assert seen == [] and spans.LAST is None


def test_collector_and_allocator_readers(monkeypatch):
    counters = {"gc_collections_gen0": 40, "num_device_alloc": 9,
                "num_device_free": 3, "num_alloc_retries": 3}
    monkeypatch.setattr(spans, "LAST", _trace_record(counters, [1.5, 4.5]))
    rec = _records([], [STEP] * 3)
    assert metrics.load("gc_ms.train").read(rec) == pytest.approx(2.0)
    assert metrics.load("device_allocs.train").read(rec) == 3.0
    assert metrics.load("alloc_retries.train").read(rec) == 1.0
    monkeypatch.setattr(spans, "LAST", _trace_record(
        {"gc_collections_gen0": 1}, []))
    assert metrics.load("gc_ms.train").read(rec) == 0.0
    assert metrics.load("alloc_retries.train").read(rec) is None  # no card


NEW = ("text_encode_ms.sample", "vae_encode_ms.sample",
       "unet_span_ms.sample", "decode_span_ms.sample",
       "motion_block_span_roofline.sample", "ln_geglu_span_roofline.sample",
       "encode_ms.train", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train", "gc_ms.train", "device_allocs.train",
       "alloc_retries.train")


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """The parent of this change has neither the tracer nor its spans: the
    shared block does nothing and every new metric reads None."""
    from followyourclick_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    monkeypatch.setattr(spans, "LAST", "stale")
    with spans.traced():
        pass
    assert spans.LAST is None
    events = [_span("h100bench.unet", 1, 0, 10), _launch(1, 5, 1),
              _kernel(20, 4, 1)]
    rec = _records(events, [REQUEST, STEP])
    for name in NEW:
        assert metrics.load(name).read(rec) is None, name


@pytest.mark.parametrize("name", [I2V, TRAIN])
def test_the_cells_metrics_share_one_tracer_block(name):
    from followyourclick_tpu_torch.utils import profiling

    cell = load_cell(name)
    keys = set()
    for m in cell.per_layer:
        mod = metrics.load(m["name"])
        if m["name"] in NEW:
            assert list(mod.ranges({})) == [spans.KEY], m["name"]
        if hasattr(mod, "ranges"):
            keys |= set(mod.ranges({}))
    assert spans.KEY in keys
    pipe = types.SimpleNamespace(unet=torch.nn.Identity(),
                                 vae=types.SimpleNamespace(decode=None))
    program = {"pipe": pipe} if name == I2V else {"state": None}
    with metrics.instrumented(cell, **program):
        assert profiling._SESSION is not None
        with profiling.span("fyc.probe"):
            pass
    assert profiling._SESSION is None
    assert [s.name for s in spans.LAST.spans
            if s.name != "fyc.gc"] == ["fyc.probe"]


def _cpu_trace(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def test_idle_gaps_name_the_program_spans():
    """On the host events of a CPU profiler trace: a device gap that begins
    inside a forced collection is named ``fyc.gc``, one that begins in the
    optimizer span's own host code, no operator open, is named by that
    span."""
    from followyourclick_tpu_torch.utils import profiling

    def step():
        with profiling.span("fyc.train.step"):
            with profiling.span("fyc.train.optimizer"):
                torch.ones(8) + 1
                end = time.perf_counter() + 0.004
                while time.perf_counter() < end:
                    pass
                torch.ones(8) * 2
            junk = [[] for _ in range(200_000)]
            for j in junk:
                j.append(j)
            del junk
            gc.collect()

    was = gc.isenabled()
    gc.disable()
    try:
        with profiling.tracing():
            events = _cpu_trace(step)
    finally:
        if was:
            gc.enable()
    by = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    opt, collect = by["fyc.train.optimizer"], by["fyc.gc"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and opt["ts"] <= e["ts"] <= opt["ts"] + opt["dur"]]
    free = max(o["ts"] + o["dur"] for o in ops
               if o["ts"] < opt["ts"] + opt["dur"] / 2)
    in_opt = free + 100  # in the busy wait, after the first operator
    in_gc = collect["ts"] + collect["dur"] / 2
    assert in_opt + 1000 < opt["ts"] + opt["dur"]
    iv = [(0, in_opt, "a"), (in_opt + 700, in_gc, "b"),
          (in_gc + 300, in_gc + 400, "c")]
    gaps = trace.idle_gaps(events, iv)
    assert gaps == {"fyc.train.optimizer": pytest.approx(700e-6),
                    "fyc.gc": pytest.approx(300e-6)}
