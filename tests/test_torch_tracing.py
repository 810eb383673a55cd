"""The port's tracer (``utils/profiling.py``: ``span``, ``tracing``) and
the spans the program opens.

- Off (the default) every span site gets one shared no-op context and
  nothing is recorded.
- On, spans record their nesting (the index of the span that holds each,
  and of the outermost), a span on another thread is held by the span open
  on the thread that turned tracing on, a span opened while off is left
  out and one still open at the end keeps no end.
- Under ``torch.profiler`` each span is a ``user_annotation`` event of its
  name, nested as the spans are, each duration within 50 µs of the span's.
- A collection inside the block is a span ``fyc.gc`` and is counted; the
  ``gc.callbacks`` hook goes with the block. With the collector running at
  every chance while threads open and close spans, the block ends and every
  index, parent and root agrees.
- A tiny ``AnimationPipeline.sample`` yields ``fyc.request`` holding
  ``fyc.encode_prompt``, a ``fyc.unet.full`` or ``fyc.unet.half`` for each
  UNet call of its plan and ``fyc.decode``; the two kernel wrappers name
  their span with the call's shape; a tiny ``train_loop`` over
  ``train_step_partitioned`` yields ``fyc.train.step`` holding
  ``fyc.train.encode``, ``forward``, ``backward`` and ``optimizer``.
- An exception inside a span or inside the block leaves the tracer
  balanced.
"""

import gc
import itertools
import json
import os
import sys
import tempfile
import threading
import time

import pytest
import torch

from followyourclick_tpu_torch.config import (
    CLIPTextConfig,
    InferenceConfig,
    MotionModuleConfig,
    NoiseScheduleConfig,
    UNet3DConfig,
    VAEConfig,
)
from followyourclick_tpu_torch.utils import profiling as prof
from followyourclick_tpu_torch.utils.profiling import span, tracing
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TEXT = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2)
VAE = VAEConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                norm_num_groups=8, sample_size=64)


@pytest.fixture(autouse=True)
def no_automatic_gc():
    """Collections only where a test forces one, so span indices hold."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def _own(trace):
    return [s for s in trace.spans if s.name != "fyc.gc"]


def _named(trace, name):
    return [s for s in trace.spans if s.name == name]


def test_off_by_default_records_nothing():
    from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu

    assert prof._SESSION is None
    null = span("fyc.a")
    assert null is span("fyc.b", 3, 4) is prof._NULL
    with null:
        fused_ln_geglu(*_ln_geglu_args(4, 8))
    with tracing() as trace:
        pass
    assert _own(trace) == [] and prof._SESSION is None
    assert span("fyc.a") is prof._NULL
    assert not any(k in trace.counters for k in prof.ALLOCATOR)  # no card


def test_spans_nest_with_parents_and_roots():
    with tracing() as trace:
        with span("fyc.a"):
            with span("fyc.b"):
                with span("fyc.c", 2, 3):
                    pass
            with span("fyc.d"):
                pass
        with span("fyc.e"):
            pass
    got = [(s.name, s.parent, s.root) for s in trace.spans]
    assert got == [("fyc.a", None, 0), ("fyc.b", 0, 0),
                   ("fyc.c:2x3", 1, 0), ("fyc.d", 0, 0),
                   ("fyc.e", None, 4)]
    assert all(s.attrs is None for s in trace.spans)
    for s in trace.spans:
        assert s.end_ns >= s.start_ns and s.ms >= 0
    a, b, c = trace.spans[:3]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= a.end_ns


def test_a_span_on_another_thread_is_held_by_the_owners_span():
    idents = []

    def worker():
        idents.append(threading.get_ident())
        with span("fyc.worker"):
            with span("fyc.worker.inner"):
                pass

    with tracing() as trace:
        with span("fyc.outer"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    outer, w, inner = trace.spans
    assert (w.name, w.parent, w.root) == ("fyc.worker", 0, 0)
    assert (inner.parent, inner.root) == (1, 0)
    assert outer.parent is None and idents != [threading.get_ident()]


def test_threads_opening_spans_at_once_lose_none():
    """More threads than cores open nested spans while the owner holds
    one, with the interpreter switching threads as often as it can: every
    span is recorded once, closed, and held by its own thread's outer span
    or by the owner's."""
    threads, rounds = 16, 200

    def worker():
        for _ in range(rounds):
            with span("fyc.outer"):
                with span("fyc.inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing() as trace:
            with span("fyc.owner"):
                pool = [threading.Thread(target=worker)
                        for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    spans = trace.spans
    assert len(spans) == 1 + 2 * threads * rounds
    assert all(s.end_ns is not None and s.root == 0 for s in spans)
    for s in spans[1:]:
        p = spans[s.parent]
        if s.name == "fyc.outer":
            assert s.parent == 0
        else:
            assert p.name == "fyc.outer"
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    inner = [s.parent for s in spans if s.name == "fyc.inner"]
    assert sorted(inner) == [i for i, s in enumerate(spans)
                             if s.name == "fyc.outer"]  # one each
    assert len({id(s) for s in spans}) == len(spans)


def _profiled_events(fn):
    """The Chrome-trace events of a CPU profiler session around ``fn``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _busy(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_spans_are_profiler_annotations_on_its_clock():
    def work():
        with span("fyc.first"):  # the process's first annotation is slow
            pass
        with span("fyc.a"):
            _busy(0.002)
            with span("fyc.b"):
                _busy(0.003)
            with span("fyc.kernel.k", 5, 7):
                _busy(0.001)

    with tracing() as trace:
        events = _profiled_events(work)
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"}
    assert set(ann) == {"fyc.first", "fyc.a", "fyc.b", "fyc.kernel.k:5x7"}
    a, b, k = (ann[n] for n in ("fyc.a", "fyc.b", "fyc.kernel.k:5x7"))
    for inner in (b, k):
        assert a["ts"] <= inner["ts"] and \
            inner["ts"] + inner["dur"] <= a["ts"] + a["dur"]
    assert b["ts"] + b["dur"] <= k["ts"]
    for s in trace.spans[1:]:
        assert abs(s.ms * 1e3 - ann[s.name]["dur"]) < 50, s.name


@pytest.mark.parametrize("profiled", [False, True])
def test_a_collection_is_a_span_and_counted(profiled):
    hooks = list(gc.callbacks)

    def work():
        with span("fyc.outer"):
            cycle = [[]]
            cycle[0].append(cycle)
            del cycle
            gc.collect()

    with tracing() as trace:
        assert len(gc.callbacks) == len(hooks) + 1
        events = _profiled_events(work) if profiled else work()
    assert gc.callbacks == hooks
    (g,) = _named(trace, "fyc.gc")
    assert g.attrs["generation"] == 2 and g.attrs["collected"] >= 2
    assert g.parent == 0 and g.end_ns is not None
    assert trace.counters["gc_collections_gen2"] == 1
    if profiled:
        assert [e["name"] for e in events
                if e.get("cat") == "user_annotation"].count("fyc.gc") == 1


def _consistent(spans):
    """Each span's parent came before it and holds it in time; its root is
    its own index or its parent's root."""
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns, (i, s)
        if s.parent is None:
            assert s.root == i, (i, s)
        else:
            p = spans[s.parent]
            assert s.parent < i and s.root == p.root, (i, s)
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (i, s)


@pytest.mark.parametrize("profiled", [False, True])
def test_spans_under_constant_collections_stay_consistent(profiled):
    """The collector starts at every chance (threshold 1), so its hook
    opens ``fyc.gc`` between any two steps of the other spans' recording,
    on the owner's thread and on two others: the block ends, and the record
    is one consistent tree."""
    rounds, done = 150, []

    def worker():
        junk = []
        for i in range(rounds):
            with span("fyc.a"):
                junk.append([junk])  # a cycle for the collector
                with span("fyc.b", i, 2):
                    junk.append({})
        done.append(len(junk))

    def work():
        with span("fyc.owner"):
            pool = [threading.Thread(target=worker) for _ in range(2)]
            for t in pool:
                t.start()
            worker()
            for t in pool:
                t.join()

    def run():  # the owner, on a thread the test can give up on
        with tracing() as trace:
            _profiled_events(work) if profiled else work()
        traces.append(trace)

    traces, threshold = [], gc.get_threshold()
    gc.set_threshold(1, 50, 1000)
    gc.enable()
    try:
        runner = threading.Thread(target=run, daemon=True)
        runner.start()
        runner.join(timeout=120)
        assert not runner.is_alive(), "the tracer hung"
    finally:
        gc.disable()
        gc.set_threshold(*threshold)
    assert done == [2 * rounds] * 3
    (trace,) = traces
    spans = trace.spans
    owner = spans.index(_named(trace, "fyc.owner")[0])
    assert all(s.root == owner for s in _own(trace))
    assert [s.name for s in spans].count("fyc.a") == 3 * rounds
    collections = _named(trace, "fyc.gc")
    assert len(collections) >= rounds
    assert sum(trace.counters[f"gc_collections_gen{g}"]
               for g in range(3)) >= len(collections)
    _consistent(spans)


def _pipeline():
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    torch.manual_seed(0)
    unet = UNet3DConfig(
        sample_size=8, cross_attention_dim=TEXT.hidden_size,
        attention_head_dim=8, block_out_channels=(32, 64, 64, 64),
        layers_per_block=1, norm_num_groups=8,
        motion_module=MotionModuleConfig(num_attention_heads=4),
        use_fps_condition=True, use_first_frame_mask_condition_concat=True)
    return AnimationPipeline(InferenceConfig(unet=unet, vae=VAE,
                                             clip_text=TEXT), device="cpu")


@pytest.mark.parametrize("interval", [1, 2])
def test_a_sample_yields_its_spans(interval):
    from followyourclick_tpu_torch.pipelines.animation import (
        SampleSpec,
        request_plan,
    )

    pipe = _pipeline()
    spec = SampleSpec(video_length=2, height=64, width=64,
                      num_inference_steps=4, guidance_scale=2.0,
                      cfg_cache_interval=interval, cfg_final_exact_steps=1)
    ids = torch.zeros(1, 77, dtype=torch.long)
    with tracing() as trace:
        latent = pipe.encode_image(torch.zeros(1, 64, 64, 3))
        pipe.sample(ids, ids, latent, torch.zeros(1, 8, 8, 1),
                    torch.full((1,), 8.0), torch.full((1,), 10.0), spec)
    enc, req = _named(trace, "fyc.encode_image"), _named(trace,
                                                         "fyc.request")
    assert len(enc) == len(req) == 1 and enc[0].root != req[0].root
    r = trace.spans.index(req[0])
    kids = [s.name for s in trace.spans if s.parent == r]
    full = sum(step.full for step in request_plan(spec, 4))
    assert kids == (["fyc.encode_prompt"]
                    + [s.name for s in _own(trace) if s.name.startswith(
                        "fyc.unet.")] + ["fyc.decode"])
    assert kids.count("fyc.unet.full") == full
    assert kids.count("fyc.unet.half") == 4 - full
    assert (4 - full > 0) == (interval > 1)
    assert all(s.root == r for s in _own(trace)[1:])


def _ln_geglu_args(r, c):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(r, c, generator=g), torch.ones(c), torch.zeros(c),
            torch.randn(8 * c, c, generator=g) / c,
            torch.zeros(8 * c), torch.randn(c, 4 * c, generator=g) / c,
            torch.zeros(c))


def _motion_block_args(p, f, c):
    g = torch.Generator().manual_seed(0)
    lin = [lambda: torch.ones(c), lambda: torch.zeros(c)] + [
        lambda: torch.randn(c, c, generator=g) / c] * 4 + [
        lambda: torch.zeros(c)]
    params = [make() for make in lin * 2]
    params += [torch.ones(c), torch.zeros(c),
               torch.randn(8 * c, c, generator=g) / c, torch.zeros(8 * c),
               torch.randn(c, 4 * c, generator=g) / c, torch.zeros(c)]
    return (torch.randn(p, f, c, generator=g), torch.zeros(f, c), params,
            c ** -0.5, 2)


@pytest.mark.parametrize("kernel,name", [
    ("ln_geglu", "fyc.kernel.fused_ln_geglu:6x16"),
    ("motion_block", "fyc.kernel.fused_motion_block:3x4x16x2")])
def test_kernel_wrappers_name_their_span_by_shape(kernel, name):
    from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu
    from followyourclick_tpu_torch.ops.motion_block import fused_motion_block

    fn, args = {"ln_geglu": (fused_ln_geglu, _ln_geglu_args(6, 16)),
                "motion_block": (fused_motion_block,
                                 _motion_block_args(3, 4, 16))}[kernel]
    with tracing() as trace:
        out = fn(*args)
    assert out.shape == args[0].shape
    assert [s.name for s in _own(trace)] == [name]


def test_a_training_loop_yields_its_phases(tmp_path):
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.schedulers import ddim
    from followyourclick_tpu_torch.training import loop as tl
    from followyourclick_tpu_torch.training import step as ts

    torch.manual_seed(0)
    unet = UNet3DConditionModel(UNet3DConfig(
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
        cross_attention_dim=TEXT.hidden_size,
        motion_module=MotionModuleConfig(num_attention_heads=4)))
    vae, text = AutoencoderKL(VAE).eval(), CLIPTextModel(TEXT).eval()
    cfg = ts.TrainConfig(learning_rate=1e-3)
    state = ts.create_partitioned_train_state(unet, cfg,
                                              frozen_dtype=torch.float32)
    sched = ddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)

    def batches():
        for n in itertools.count():
            g = torch.Generator().manual_seed(n)
            video = torch.rand(1, 2, 64, 64, 3, generator=g) * 2 - 1
            yield ts.TrainBatch(
                ts.encode_batch(vae, video, g),
                torch.randint(0, TEXT.vocab_size, (1, 77), generator=g),
                torch.ones(1, 8, 8, 1), torch.full((1,), 8.0),
                torch.full((1,), 20.0))

    def step_fn(state, batch, generator):
        return ts.train_step_partitioned(state, batch, generator, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=cfg)

    loop = tl.LoopConfig(output_dir=str(tmp_path), max_train_steps=2,
                         checkpointing_steps=100, log_every=100,
                         temporal_multi_scale=False)
    with tracing() as trace:
        tl.train_loop(state, batches(), step_fn, loop)
    steps = _named(trace, "fyc.train.step")
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for step in steps:
        i = trace.spans.index(step)
        assert [s.name for s in trace.spans if s.parent == i] == [
            "fyc.train.encode", "fyc.train.forward", "fyc.train.backward",
            "fyc.train.optimizer"]
        assert all(s.end_ns <= step.end_ns for s in trace.spans
                   if s.root == i)


@pytest.mark.parametrize("where", ["span", "block"])
def test_an_exception_leaves_the_tracer_balanced(where):
    hooks = list(gc.callbacks)
    with pytest.raises(RuntimeError, match="inside"):
        with tracing() as trace:
            with span("fyc.a"):
                try:
                    with span("fyc.b"):
                        raise RuntimeError("inside")
                except RuntimeError:
                    if where == "block":
                        raise
                with span("fyc.c"):
                    pass
            raise RuntimeError("inside the block")
    assert prof._SESSION is None and gc.callbacks == hooks
    names = [(s.name, s.parent, s.end_ns is not None) for s in trace.spans]
    if where == "span":
        assert names == [("fyc.a", None, True), ("fyc.b", 0, True),
                         ("fyc.c", 0, True)]
    else:
        assert names == [("fyc.a", None, True), ("fyc.b", 0, True)]
    with tracing() as again:
        with span("fyc.d"):
            pass
    assert [(s.name, s.parent) for s in again.spans] == [("fyc.d", None)]


def test_spans_across_the_blocks_edges():
    before = span("fyc.before")
    before.__enter__()
    with tracing() as first:
        with span("fyc.inside"):
            pass
        before.__exit__(None, None, None)  # opened while off: left out
        late = span("fyc.open_at_the_end")
        late.__enter__()
        with pytest.raises(RuntimeError, match="already on"):
            with tracing():
                pass
    with tracing() as second:
        late.__exit__(None, None, None)  # the first block's: left as it was
        with span("fyc.next"):
            pass
    assert [(s.name, s.end_ns is None) for s in first.spans] == [
        ("fyc.inside", False), ("fyc.open_at_the_end", True)]
    assert [(s.name, s.parent) for s in second.spans] == [("fyc.next", None)]
