"""The program's own spans and counters (``followyourclick_tpu_torch/
utils/profiling.py``) for the per-layer metrics that read them.

Every such metric's ``ranges`` gives the one key ``program_tracing``, so
the program's ``tracing()`` is held on once over the traced detail part;
its record is kept here for the readers. The block does nothing else: the
timeline part's trace events, about 0.9 M dicts loaded just before, still
sit in the collector's young generation, and the detail part's next gen-1
or gen-2 collection walks them all, a stall of 0.5–1.5 s on the H100's
host that is the benchmark's, which ``gc_ms.train`` and the idle gaps read
as ``fyc.gc``.

Device time goes to a span as the benchmark's own ranges get theirs
(``trace.range_device_us``), with one difference: a span holds what every
thread launches while it is open, as the autograd engine launches a
backward from a device thread of its own while the span that called it
waits on the calling thread. A program without the tracer leaves no record
and no span, and the readers read nothing.
"""

from __future__ import annotations

import collections
import contextlib

from h100bench.harness import trace as tr

KEY = "program_tracing"
LAST = None  # the record of the last traced part, or None


@contextlib.contextmanager
def traced():
    """The program's tracer on over the block, its record kept in
    ``LAST``; with a program that has no tracer, nothing."""
    global LAST
    LAST = None
    from followyourclick_tpu_torch.utils import profiling

    tracing = getattr(profiling, "tracing", None)
    if tracing is None:
        yield
        return
    with tracing() as record:
        yield
    LAST = record


def ranges(program):
    return {KEY: traced}


def device_us(events, prefix: str):
    """(device µs, calls) by the name of the program's spans whose names
    begin with ``prefix``: each kernel, memcpy or memset goes to the
    innermost such span (the last begun) open when it was launched, on
    whichever thread."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(prefix) and "dur" in e]
    if not spans:
        return collections.Counter(), collections.Counter()
    threads = {e["tid"] for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    copies = [dict(e, tid=t) for e in spans for t in threads
              if t != e["tid"]]

    def label(e):
        return e["name"] if e.get("cat") == "user_annotation" \
            and e["name"].startswith(prefix) else None
    us, _ = tr.range_device_us(events + copies, label)
    return us, collections.Counter(e["name"] for e in spans)


def units(rec, kind: str, key: str | None = None) -> int:
    """The detail part's units of ``kind`` (``request`` or ``step``), or
    the sum of their ``key`` (``clips``)."""
    work = [w for w in rec.detail_work if w["kind"] == kind]
    return sum(w.get(key, 0) for w in work) if key else len(work)


def ms_per(rec, prefix: str, kind: str, key: str | None = None):
    """Device ms in the spans ``prefix…`` a unit of the detail part."""
    us, calls = device_us(rec.events, prefix)
    n = units(rec, kind, key)
    if not calls or not n:
        return None
    return sum(us.values()) / 1e3 / n


def ms_per_call(rec, prefix: str):
    """Device ms in the spans ``prefix…``, over their calls."""
    us, calls = device_us(rec.events, prefix)
    if not calls:
        return None
    return sum(us.values()) / 1e3 / sum(calls.values())


def roofline(rec, prefix: str, bound_s):
    """Σ bound / Σ device time over the spans ``prefix<d0>x<d1>…``, in
    percent; ``bound_s`` takes the call's shape."""
    us, calls = device_us(rec.events, prefix)
    bound = device = 0.0
    for name, n in calls.items():
        dims = [int(v) for v in name[len(prefix):].split("x")]
        bound += n * bound_s(*dims)
        device += us[name] / 1e6
    if device <= 0:
        return None
    return 100.0 * bound / device


def counter_per_step(rec, name: str):
    """The change of the record's counter ``name`` a step of the detail
    part."""
    steps = units(rec, "step")
    if LAST is None or name not in LAST.counters or not steps:
        return None
    return LAST.counters[name] / steps


def host_ms_per_step(rec, prefix: str):
    """Host ms a step of the detail part in the record's closed spans
    ``prefix…``, but for those inside a span the record leaves open: the
    part ends inside the next step's span, while the profiler stops and
    writes its trace."""
    steps = units(rec, "step")
    if LAST is None or not steps:
        return None
    spans = LAST.spans

    def in_open(s):
        while s.parent is not None:
            s = spans[s.parent]
            if s.end_ns is None:
                return True
        return False
    return sum(s.ms for s in spans if s.end_ns is not None
               and s.name.startswith(prefix) and not in_open(s)) / steps
