"""Profiling and throughput harnesses.

Port of ``followyourclick_tpu/utils/profiling.py``: a ``torch.profiler``
trace around a block (:func:`device_trace`, a Chrome trace in its
directory), a stage timer that waits for the device, and mmflow's FPS
benchmark (``tools/benchmark.py``: warm-up iterations, then timed ones,
each waiting for its result).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and the card when there is
    one), written to ``log_dir/trace.json`` for a Chrome-trace viewer, also
    when the block raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Host seconds per named stage; a stage given ``sync`` waits for the
    device work behind it before its clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name] / self.counts[name],
                                       4)}
                for name in self.totals}


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
