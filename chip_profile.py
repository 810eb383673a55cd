#!/usr/bin/env python3
"""Profile one warm full-width request per path on one NVIDIA card.

    python3 chip_profile.py

Builds the kernels and the default ``InferenceConfig`` pipeline as
``chip_smoke.py`` does (bf16, seeded random weights, 16 frames, 512², CFG 8)
and, for ``pab488_deep4_cfg4_ex`` at 10 steps, the exact sampler at 4 steps
and the exact sampler at 4 steps with two clips per request (batched
serving, whose level-0 self-attention takes the flash-attention kernel),
then, with that pipeline freed, for the IP-Adapter Plus configuration
(``chip_smoke.full_pipeline(ip_plus=True)``: ViT-H/14 tower, Resampler, 16
ip tokens) on the exact sampler at 4 steps, runs one request to warm up and
then one under ``torch.profiler`` (CPU and CUDA activities, no schedule). For each path it prints the wall time (host
clock, ending in ``torch.cuda.synchronize()``), the peak device memory of
the profiled request, the device's busy time (the union of the kernel,
memcpy and memset intervals of the trace), the device span, the idle share
of the wall time, each hand-written kernel's device time, launches and
share of the wall (an LN-GEGLU call's three device kernels counted
under ``fused_ln_geglu``), and the 30 kernels that
take the most device time; the whole table goes to
``chiprun_out/profile_<path>.txt``. Needs torch with CUDA and the CUDA
toolkit; imports no JAX.
"""

from __future__ import annotations

import collections
import gc
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


# device-kernel names of the hand-written kernels (csrc/*.cu), by wrapper:
# one bf16 LN-GEGLU call is three device kernels (the LN pass and the two
# wgmma products of the GEMM core, which only LN-GEGLU runs so far)
KERNEL_NAMES = {"fused_motion_block": ("motion_block_kernel",),
                "fused_ln_geglu": ("ln_bf16_kernel", "wgmma_gemm_kernel",
                                   "ln_geglu_kernel"),
                "fused_temporal_block": ("temporal_block_kernel",),
                "temporal_attention": ("temporal_attention_kernel",),
                "flash_attention": ("flash_wgmma_kernel",
                                    "flash_fp32_kernel")}


def request(pipe, spec, seed, batch=1):
    with torch.inference_mode():
        req = chip_smoke.make_request(pipe, spec, seed,
                                      pipe.config.clip_text.vocab_size, batch)
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
    exact = SampleSpec(num_inference_steps=EXACT_STEPS)
    paths = {
        "serving": (apply_schedule(
            SampleSpec(num_inference_steps=chip_smoke.SERVING_STEPS),
            chip_smoke.SERVING_SCHEDULE), 1, False),
        "exact": (exact, 1, False),
        f"exact_{chip_smoke.BATCH}clips": (exact, chip_smoke.BATCH, False),
        "exact_ip_plus": (exact, 1, True),
    }
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pipe = None
    for label, (spec, batch, ip_plus) in paths.items():
        if pipe is None or (pipe.ip_adapter is not None) != ip_plus:
            pipe = None  # one full-width pipeline at a time
            gc.collect()
            torch.cuda.empty_cache()
            pipe = chip_smoke.full_pipeline(0, ip_plus=ip_plus)
        request(pipe, spec, 100, batch)
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            request(pipe, spec, 101, batch)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
        chip_smoke.log(f"[{label}] {batch} clip(s): wall {wall:.3f} s, peak "
                       f"device memory {peak:.2f} GiB, device busy "
                       f"{busy:.3f} s over a device span of {span:.3f} s; "
                       f"idle share of wall {1 - busy / wall:.3f}")
        for wrapper, knames in KERNEL_NAMES.items():
            mine = [n for n in by_name if any(k in n for k in knames)]
            us = sum(by_name[n] for n in mine)
            n = sum(calls[n] for n in mine)
            chip_smoke.log(f"[{label}] {wrapper}: {us / 1e3:.2f} ms over "
                           f"{n} device launches, {us / 1e6 / wall:.3f} of "
                           "the wall")
        rows = [f"{us / 1e3:12.2f} ms {calls[name]:6d}  {name}"
                for name, us in by_name.most_common()]
        (out_dir / f"profile_{label}.txt").write_text("\n".join(rows) + "\n")
        for row in rows[:TOP]:
            chip_smoke.log(f"[{label}] {row[:150]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
