"""The traced window: ``torch.profiler`` over a few requests or steps, the
benchmark's own ranges around calls into the program's layers, and the
arithmetic that turns the trace into busy time, device time by range and
the breakdown.

Busy time is the union of the kernel, memcpy and memset intervals; device
time is put on a range through the launch's correlation id, so kernels that
several wrappers share go to the range that launched them (the innermost
one of the launching thread). Copied from the repository's chip tools
(``chip_smoke.busy_us`` / ``device_intervals``, ``chip_profile.
range_device_us``) and frozen here.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "h100bench."
TOP = 10


def device_intervals(events):
    """(start µs, end µs, name) of every device activity in the trace."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_us(intervals):
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def range_device_us(events, label):
    """Device µs and launches of the kernels launched inside host ranges:
    ``label(event)`` names a range event (or None); a kernel joins the
    runtime call that launched it (same correlation id) and that call the
    innermost labelled range of its thread that holds it."""
    ranges = collections.defaultdict(list)
    launch = {}
    for e in events:
        args = e.get("args", {})
        name = label(e) if "dur" in e else None
        if name is not None:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
    starts, reach = {}, {}
    for tid, rs in ranges.items():
        rs.sort()
        starts[tid] = [r[0] for r in rs]
        reach[tid] = list(itertools.accumulate((r[1] for r in rs), max))
    us, n = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        rs = ranges.get(tid)
        if not rs:
            continue
        # the innermost holding range is the last-begun one that holds ts;
        # none before i holds it once the ranges up to i all end before it
        i = bisect.bisect_right(starts[tid], ts) - 1
        while i >= 0 and reach[tid][i] >= ts:
            if rs[i][1] >= ts:
                us[rs[i][2]] += e["dur"]
                n[rs[i][2]] += 1
                break
            i -= 1
    return us, n


def idle_gaps(events, intervals, labelled=2000):
    """Seconds the device sat idle between its first and last activity,
    summed by what the host was doing when each gap began: the host range
    or operator that began last among those that held that moment (the
    innermost of nested ones). The ``labelled`` longest gaps are named;
    the rest are summed as "(shorter gaps)"."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation",
                                      "python_function") and "dur" in e)
    starts = [h[0] for h in host]
    gaps, end = [], None
    for s, e, _ in sorted(intervals):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    by = collections.Counter()
    for length, g0 in gaps[labelled:]:
        by["(shorter gaps)"] += length / 1e6
    for length, g0 in gaps[:labelled]:
        i = bisect.bisect_right(starts, g0)
        name = "(no host activity)"
        for h in reversed(host[max(0, i - 2000):i]):
            if h[1] >= g0:
                name = h[2]
                break
        by[name] += length / 1e6
    return by


@dataclasses.dataclass
class Records:
    """What the per-layer readers read: the timeline part of the traced
    run (device intervals, its window, busy time, the units of work done
    in it and the window's memory peak) and the detail part (the trace's
    events with the benchmark's ranges, and the units done in it)."""

    events: list          # detail part: host and device events
    intervals: list       # timeline part: device intervals
    window_s: float       # timeline part's length, host clock
    busy_s: float         # union of the timeline's device intervals
    work: list            # units (requests / steps) of the timeline part
    peak_bytes: int
    cell: object
    detail_work: list = dataclasses.field(default_factory=list)
    _ranges: tuple = None

    def ranges(self):
        """(device µs, calls) by the name of the benchmark's ranges, each
        kernel put on the innermost range that launched it."""
        if self._ranges is None:
            def label(e):
                return e["name"] if (e.get("cat") == "user_annotation"
                                     and e["name"].startswith(RANGE_PREFIX)) \
                    else None
            calls = collections.Counter(
                label(e) for e in self.events if label(e))
            us, _ = range_device_us(self.events, label)
            self._ranges = (us, calls)
        return self._ranges

    def inclusive(self, name: str):
        """(device µs, calls) of the range ``h100bench.<name>``, every
        kernel launched inside it counted, those of ranges nested in it
        too."""
        label = RANGE_PREFIX + name

        def only(e):
            return label if (e.get("cat") == "user_annotation"
                             and e["name"] == label) else None
        us, _ = range_device_us(self.events, only)
        return us[label], sum(1 for e in self.events if only(e))

    def breakdown(self) -> dict:
        """The timeline's device operations that took most time, and the
        detail part's longest idle gaps by what the host was doing (that
        part's host runs under the profiler's own cost)."""
        ops = collections.Counter()
        for s, e, name in self.intervals:
            ops[name] += (e - s) / 1e6
        gaps = idle_gaps(self.events, device_intervals(self.events))
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


def ranged(name: str, fn):
    """``fn`` inside a profiler range ``h100bench.<name>``."""
    label = RANGE_PREFIX + name

    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def patched(obj, attr: str, make):
    """Within the block the instance attribute ``attr`` of ``obj`` is
    ``make(current)``; whatever the instance held before is put back."""
    had = attr in vars(obj)
    before = vars(obj).get(attr)
    setattr(obj, attr, make(getattr(obj, attr)))
    try:
        yield
    finally:
        if had:
            setattr(obj, attr, before)
        else:
            delattr(obj, attr)


def method_ranged(obj, attr: str, name: str):
    """Within the block the instance's ``attr`` runs inside a range; the
    module tree and its qualified names stay as they are."""
    return patched(obj, attr, lambda fn: ranged(name, fn))


@contextlib.contextmanager
def call_sites_ranged(fn_name: str, make, package: str):
    """Within the block every name ``fn_name`` in the modules of
    ``package`` (the program's model modules, where the call sites are) is
    ``make(original)``; the wrapper's own module keeps its own."""
    undo = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith(package):
            continue
        fn = vars(mod).get(fn_name)
        if fn is not None and callable(fn):
            undo.append((mod, fn))
            setattr(mod, fn_name, make(fn))
    try:
        yield
    finally:
        for mod, fn in undo:
            setattr(mod, fn_name, fn)


class Profiler:
    """``torch.profiler`` over part of the window; ``host``: the host's
    operators and ranges too (which slows the host), else the device's
    activity alone. The events are read out as soon as it stops."""

    def __init__(self, host: bool):
        self.host = host
        self.events = []

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self):
        self.prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        self.prof = None


class TracePlan:
    """The traced run's two parts, in units of work (requests or steps)
    counted from the window's start: first ``timeline`` units traced on
    the device alone, whose busy time, length and work give the idle share
    and the utilisation without the host-side profiler's cost; then
    ``detail`` units traced with the host's operators and the metrics'
    ranges (``ranges()``, a context manager), for the device time of each
    layer and what the host did while the device waited."""

    def __init__(self, detail: int, timeline: int, ranges):
        self.n_detail, self.n_timeline = detail, timeline
        self.ranges = ranges
        self.detail = Profiler(host=True)
        self.timeline = Profiler(host=False)
        self.layers = None
        self.running = None
        self.detail_work, self.timeline_work = [], []
        self.t0 = self.t1 = None

    def warm(self, device) -> None:
        """One throwaway device-only session in set-up, so that the
        profiler's first start (CUPTI's set-up) falls outside the window."""
        p = Profiler(host=False)
        p.start()
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        p.stop()

    def before(self, i: int) -> None:
        """Unit ``i`` is about to start."""
        if i == 0 and self.n_timeline:
            self.timeline.start()
            self.running = self.timeline
            self.t0 = time.perf_counter()
        if i == self.n_timeline and self.n_detail:
            self.layers = self.ranges()
            self.layers.__enter__()
            self.detail.start()
            self.running = self.detail

    def after(self, i: int, t_end: float, work: dict) -> None:
        """Unit ``i`` has ended on the device at host time ``t_end``."""
        if i < self.n_timeline:
            self.timeline_work.append(work)
            self.t1 = t_end
            if i == self.n_timeline - 1:
                self._stop()
        elif i < self.n_timeline + self.n_detail:
            self.detail_work.append(work)
            if i == self.n_timeline + self.n_detail - 1:
                self._stop()

    def _stop(self):
        self.running.stop()
        if self.running is self.detail:
            self.layers.__exit__(None, None, None)
        self.running = None

    def close(self) -> None:
        """The window has ended: stop a part still running, and let go of
        the program (the ranges' closure holds it)."""
        if self.running is not None:
            self._stop()
        self.ranges = None

    def records(self, cell, peak_bytes: int):
        if not self.timeline_work:
            raise SystemExit("h100bench: the window ended before the "
                             "traced timeline did; give it more seconds")
        iv = device_intervals(self.timeline.events)
        if not iv:
            raise SystemExit("h100bench: the trace holds no device activity")
        return Records(self.detail.events, iv, self.t1 - self.t0,
                       busy_us(iv) / 1e6, self.timeline_work, peak_bytes,
                       cell, self.detail_work)
