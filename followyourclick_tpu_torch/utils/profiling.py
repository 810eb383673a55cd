"""The port's tracer, and mmflow's throughput harness.

The tracer marks the program's layers with spans and counts what the host
spends around them. Off, which is the default, :func:`span` returns one
shared no-op context: it records nothing, reads no clock and touches no
CUDA. :func:`tracing` turns it on for a block and yields a :class:`Trace`:

- every span opened and closed inside the block: its name, start and end on
  ``time.perf_counter_ns()``, the index of the span that holds it and that
  of the outermost recorded span that holds it (one request, one training
  step). A span opened while tracing was off is not recorded, and one still
  open when the block ends keeps no end;
- while a ``torch.profiler`` session runs, each span also opens a
  ``torch.profiler.record_function`` of its name, so that a session that
  records host activity puts the program's spans in its trace as
  ``user_annotation`` events, on the kernels' time axis;
- Python's garbage collector: every collection inside the block as a span
  ``fyc.gc`` (attributes ``generation`` and ``collected``), through a
  ``gc.callbacks`` hook that lives only as long as the block, and the
  collections by generation counted over the block;
- on a card, the caching allocator's ``num_device_alloc``,
  ``num_device_free`` and ``num_alloc_retries`` over the block, read from
  ``torch.cuda.memory_stats()`` (host-side counters: no sync).

A span opened on another thread with none of that thread's own open is
held by the innermost span open on the thread that turned tracing on: the
autograd engine runs a backward on a device thread of its own. Recording
takes no lock: the collector's hook may open its span on any thread between
any two steps of another span's opening or closing, so each span's record
is built first and found again after the append (a list's append is atomic
under the GIL), and each span joins its thread's open spans only after its
start is read and leaves them before its end is read.

The program's spans: ``fyc.request`` (``AnimationPipeline.sample``),
``fyc.encode_prompt``, ``fyc.encode_image``, ``fyc.unet.full`` /
``fyc.unet.half`` / ``fyc.unet.frame`` (each UNet call of the denoise:
the full batch, the cond half under the CFG cache, the per-frame
``video_scale`` pass), ``fyc.decode`` (``decode_latents``),
``fyc.kernel.fused_motion_block:<P>x<F>x<C>x<heads>``,
``fyc.kernel.fused_ln_geglu:<R>x<C>`` and
``fyc.kernel.fused_group_norm:<B>x<N>x<C>x<element bytes>`` (the kernel
wrappers; GroupNorm's on the card only),
``fyc.train.step`` (one iteration of ``train_loop``), ``fyc.train.encode``
(``encode_batch``), ``fyc.train.forward``, ``fyc.train.backward`` and
``fyc.train.optimizer`` (the phases of a training step).

:func:`fps_benchmark` is mmflow's ``tools/benchmark.py``: warm-up
iterations, then timed ones, each waiting for its result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch

ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries")

_NULL = contextlib.nullcontext()
_SESSION = None  # the _Session recording, while tracing is on


@dataclasses.dataclass
class Span:
    """One recorded span; ``end_ns`` is None for one still open when
    tracing ended."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]   # index in Trace.spans of the span holding it
    root: int               # index of the outermost recorded span holding it
    attrs: Optional[dict] = None  # fyc.gc's generation and collected

    @property
    def ms(self) -> Optional[float]:
        return None if self.end_ns is None \
            else (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Trace:
    """What a :func:`tracing` block recorded: the spans in the order they
    opened, and the counters' change over the block (the collector's
    ``gc_collections_gen<i>``, and on a card the allocator's
    :data:`ALLOCATOR` counts)."""

    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


class _Session:
    """The state of one :func:`tracing` block."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.local = threading.local()
        self.owner = self.stack()
        self.gc_open = None

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc_open = _Open(self, "fyc.gc",
                                 {"generation": info["generation"]})
            self.gc_open.__enter__()
        elif self.gc_open is not None:
            opened, self.gc_open = self.gc_open, None
            opened.attrs["collected"] = info["collected"]
            opened.__exit__(None, None, None)


class _Open:
    """A span being recorded."""

    __slots__ = ("session", "name", "attrs", "index", "stack", "annotation")

    def __init__(self, session: _Session, name: str,
                 attrs: Optional[dict] = None):
        self.session, self.name, self.attrs = session, name, attrs
        self.annotation = None

    def __enter__(self):
        s = self.session
        self.stack = stack = s.stack()
        held = (stack or s.owner)[-1:]  # a slice: the owner may pop meanwhile
        parent = held[0] if held else None
        record = Span(self.name, 0, None, parent, -1, self.attrs)
        spans = s.trace.spans
        spans.append(record)
        # other threads' spans and the collector's may have followed it
        index = len(spans) - 1
        while spans[index] is not record:
            index -= 1
        self.index = index
        record.root = index if parent is None else spans[parent].root
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        # each clock read follows the annotation's: the profiler takes its
        # start early in the enter and its end late in the exit
        record.start_ns = time.perf_counter_ns()
        stack.append(index)
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        stack = self.stack
        if stack and stack[-1] == self.index:
            stack.pop()
        elif self.index in stack:
            stack.remove(self.index)
        end = time.perf_counter_ns()
        s = self.session
        if s is _SESSION:
            s.trace.spans[self.index].end_ns = end
        return False


def span(name: str, *shape: int):
    """A context that records a span ``name`` while tracing is on; the
    ``shape``, where given, is appended to the name as ``:<d0>x<d1>…``.
    Off, one shared no-op context."""
    session = _SESSION
    if session is None:
        return _NULL
    if shape:
        name = name + ":" + "x".join(str(int(d)) for d in shape)
    return _Open(session, name)


def spanned(name: str):
    """A decorator: each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def _counters() -> dict:
    out = {f"gc_collections_gen{i}": s["collections"]
           for i, s in enumerate(gc.get_stats())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out.update((k, stats[k]) for k in ALLOCATOR if k in stats)
    return out


@contextlib.contextmanager
def tracing():
    """Tracing on for the block; yields the :class:`Trace` it fills (its
    counters are set as the block ends). Blocks do not nest."""
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("tracing is already on")
    trace = Trace()
    session = _Session(trace)
    before = _counters()
    gc.callbacks.append(session.on_gc)
    _SESSION = session
    try:
        yield trace
    finally:
        gc.callbacks.remove(session.on_gc)
        _SESSION = None
        after = _counters()
        trace.counters = {k: after[k] - before[k] for k in before
                          if k in after}


def block_until_ready(out: Any) -> Any:
    """Wait for the device work behind every CUDA tensor in ``out`` (a
    tensor, or lists, tuples and dicts of them); returns ``out``."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            block_until_ready(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            block_until_ready(v)
    return out


def fps_benchmark(fn: Callable[[Any], Any], inputs: Iterable[Any],
                  warmup: int = 5, max_iter: int = 50,
                  log_interval: int = 10,
                  log: Optional[Callable[[str], None]] = print) -> float:
    """Skip ``warmup`` calls, time the next ``max_iter``, each waiting for
    its result; returns calls per second."""
    num = 0
    pure_time = 0.0
    fps = 0.0
    for i, batch in enumerate(inputs):
        start = time.perf_counter()
        block_until_ready(fn(batch))
        elapsed = time.perf_counter() - start
        if i >= warmup:
            pure_time += elapsed
            num += 1
            if num % log_interval == 0 and log is not None:
                log(f"Done item [{num:3}/{max_iter}], "
                    f"fps: {num / pure_time:.1f} items/s")
        if num >= max_iter:
            break
    if num:
        fps = num / pure_time
        if log is not None:
            log(f"Overall fps: {fps:.1f} items/s")
    return fps
