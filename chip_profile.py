#!/usr/bin/env python3
"""Profile one warm full-width request per path on one NVIDIA card.

    python3 chip_profile.py

Builds the kernels and the default ``InferenceConfig`` pipeline as
``chip_smoke.py`` does (bf16, seeded random weights, 16 frames, 512², CFG 8)
and, for ``pab488_deep4_cfg4_ex`` at 10 steps and the exact sampler at 4
steps, runs one request to warm up and then one under ``torch.profiler``
(CPU and CUDA activities, no schedule). For each path it prints the wall
time (host clock, ending in ``torch.cuda.synchronize()``), the device's busy
time (the union of the kernel, memcpy and memset intervals of the trace),
the device span, the idle share of the wall time, and the 30 kernels that
take the most device time; the whole table goes to
``chiprun_out/profile_<path>.txt``. Needs torch with CUDA and the CUDA
toolkit; imports no JAX.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke

EXACT_STEPS = 4
TOP = 30
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(prof):
    """(start µs, end µs, name) of every device activity in the trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
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


def request(pipe, spec, seed):
    with torch.inference_mode():
        req = chip_smoke.make_request(pipe, spec, seed,
                                      pipe.config.clip_text.vocab_size)
        video = pipe.sample(spec=spec, **req)
    torch.cuda.synchronize()
    return video


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )

    chip_smoke.phase_build()
    pipe = chip_smoke.full_pipeline(0)
    paths = {
        "serving": apply_schedule(
            SampleSpec(num_inference_steps=chip_smoke.SERVING_STEPS),
            chip_smoke.SERVING_SCHEDULE),
        "exact": SampleSpec(num_inference_steps=EXACT_STEPS),
    }
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for label, spec in paths.items():
        request(pipe, spec, 100)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            request(pipe, spec, 101)
            wall = time.perf_counter() - t0
        iv = device_intervals(prof)
        if not iv:
            raise SystemExit(f"{label}: the trace holds no device activity")
        busy = busy_us(iv) / 1e6
        span = (max(e for _, e, _ in iv) - min(s for s, _, _ in iv)) / 1e6
        by_name = collections.Counter()
        calls = collections.Counter()
        for s, e, name in iv:
            by_name[name] += e - s
            calls[name] += 1
        chip_smoke.log(f"[{label}] wall {wall:.3f} s, device busy {busy:.3f} "
                       f"s over a device span of {span:.3f} s; idle share of "
                       f"wall {1 - busy / wall:.3f}")
        rows = [f"{us / 1e3:12.2f} ms {calls[name]:6d}  {name}"
                for name, us in by_name.most_common()]
        (out_dir / f"profile_{label}.txt").write_text("\n".join(rows) + "\n")
        for row in rows[:TOP]:
            chip_smoke.log(f"[{label}] {row[:150]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
