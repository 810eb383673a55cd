#!/usr/bin/env python3
"""Profile one warm full-width request per path on one NVIDIA card.

    python3 chip_profile.py [path ...]

(all paths by default; e.g. ``python3 chip_profile.py cli``)

Builds the kernels and the default ``InferenceConfig`` pipeline as
``chip_smoke.py`` does (bf16, seeded random weights, 16 frames, 512², CFG 8)
and, for ``pab488_deep4_cfg4_ex`` at 10 steps, the exact sampler at 4 steps,
the exact sampler at 4 steps with ``video_scale = 1.5`` (its per-frame
pass), and the exact sampler at 4 steps with two clips per request (batched
serving, whose level-0 self-attention takes the flash-attention kernel),
then, with that pipeline freed, for the IP-Adapter Plus configuration
(``chip_smoke.full_pipeline(ip_plus=True)``: ViT-H/14 tower, Resampler, 16
ip tokens) on the exact sampler at 4 steps, runs one request to warm up and
then one under ``torch.profiler`` (CPU and CUDA activities, no schedule);
last, the click-to-video CLI (``cli``): ``cli.inference.run`` on a
one-row manifest without an image over the synthetic SD-1.5 directory of
``chip_smoke.write_sd_directory`` (exact sampler, 4 steps), one run to warm
up and one under the profiler, with the load, the T2I first frame and the
request each timed and given its own device busy time and idle share (the
device intervals inside that part's host range). For each path it prints
the wall time (host clock, ending in ``torch.cuda.synchronize()``), the
peak device memory of the profiled request, the device's busy time (the union of the kernel,
memcpy and memset intervals of the trace), the device span, the idle share
of the wall time, each kernel wrapper's device time, calls, device launches
and share of the wall, and the 30 kernels that take the most device time;
the whole table goes to
``chiprun_out/profile_<path>.txt``. Needs torch with CUDA and the CUDA
toolkit; imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses
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


def trace_events(prof):
    """The events of the profiler's Chrome trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_intervals(events):
    """(start µs, end µs, name) of every device activity in the trace."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def annotated(name, fn):
    """``fn`` inside a profiler range named ``name``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def by_wrapper(events):
    """Per kernel wrapper: its calls, and the device µs and device launches
    of the kernels launched inside its calls. A kernel joins the runtime
    call that launched it (same correlation id), and that call the wrapper
    range of its thread that holds it. Several wrappers share device
    kernels (the bf16 motion block runs LN-GEGLU's, fused_ln_geglu's and
    the frame attention's), so names alone cannot tell them apart."""
    names = set(chip_smoke.KERNELS)
    ranges = collections.defaultdict(list)
    launch = {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "user_annotation" and e["name"] in names:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
    calls = collections.Counter(r[2] for rs in ranges.values() for r in rs)
    us, n = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        for start, end, name in ranges.get(tid, ()):
            if start <= ts <= end:
                us[name] += e["dur"]
                n[name] += 1
                break
    return calls, us, n


def busy_us(intervals):
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def request(pipe, spec, seed, batch=1):
    with torch.inference_mode():
        req = chip_smoke.make_request(pipe, spec, seed,
                                      pipe.config.clip_text.vocab_size, batch)
        video = pipe.sample(spec=spec, **req)
    torch.cuda.synchronize()
    return video


def host_ranges(events, names):
    """(start µs, end µs) of each host range named in ``names``, by name."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return out


def clipped_busy_us(intervals, window):
    """Device busy µs of ``intervals`` inside ``window`` (start, end)."""
    lo, hi = window
    return busy_us([(max(s, lo), min(e, hi), n) for s, e, n in intervals
                    if e > lo and s < hi])


def profile_cli(acts, cfg=None, device="cuda", clip=(16, 512, 512)):
    """The CLI path: one warm-up ``cli.inference.run`` and one under the
    profiler, with the load, each T2I request and each video request in
    their own profiler ranges, and the GIF writer patched out
    (``chip_smoke.captured_videos(write=False)``); prints each part's wall,
    device busy time and idle share, and the run's. ``cfg``, ``device``
    and ``clip`` (frames, height, width) default to the full-width run on
    the card."""
    from followyourclick_tpu_torch.cli import inference as cli
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )
    from followyourclick_tpu_torch.pipelines.text_to_image import (
        TextToImagePipeline,
    )
    from followyourclick_tpu_torch.utils import loaders

    cfg = cfg or InferenceConfig()
    frames, height, width = clip
    parts = {"load": (loaders, "assemble_pipeline_from_pretrained"),
             "t2i": (TextToImagePipeline, "__call__"),
             "request": (AnimationPipeline, "__call__")}
    with tempfile.TemporaryDirectory() as root:
        sd = os.path.join(root, "sd15")
        _, mm = chip_smoke.write_sd_directory(sd, cfg, 0, device)
        manifest = os.path.join(root, "prompts.txt")
        with open(manifest, "w") as f:
            f.write(chip_smoke.CLI_PROMPTS[0] + "\n")
        args = cli.build_arg_parser().parse_args([
            "--pretrained_model_path", sd, "--config", "smoke.yaml",
            "--file", manifest, "--output_path", root, "--device", device,
            "--L", str(frames), "--H", str(height), "--W", str(width)])
        config = {"smoke": {"motion_module": [mm], "steps": EXACT_STEPS,
                            "seed": [0]}}
        with chip_smoke.captured_videos(write=False):
            cli.run(args, cfg, config, cli.load_prompt_manifest(manifest))
        saved = {}
        for name, (owner, attr) in parts.items():
            saved[name] = getattr(owner, attr)
            setattr(owner, attr, annotated(f"cli_{name}", saved[name]))
        torch.cuda.reset_peak_memory_stats()
        try:
            with torch.profiler.profile(activities=acts) as prof, \
                    chip_smoke.captured_videos(write=False):
                t0 = time.perf_counter()
                cli.run(args, cfg, config, cli.load_prompt_manifest(manifest))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for name, (owner, attr) in parts.items():
                setattr(owner, attr, saved[name])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = trace_events(prof)
    iv = device_intervals(events)
    busy = busy_us(iv) / 1e6
    chip_smoke.log(f"[cli] one row, exact {EXACT_STEPS} steps: wall "
                   f"{wall:.3f} s, peak device memory {peak:.2f} GiB, device "
                   f"busy {busy:.3f} s; idle share of wall "
                   f"{1 - busy / wall:.3f}")
    ranges = host_ranges(events, {f"cli_{n}" for n in parts})
    for name in parts:
        for window in ranges[f"cli_{name}"]:
            w = (window[1] - window[0]) / 1e6
            b = clipped_busy_us(iv, window) / 1e6
            chip_smoke.log(f"[cli] {name}: wall {w:.3f} s, device busy "
                           f"{b:.3f} s, idle share {1 - b / w:.3f}")
    by_name = collections.Counter()
    for s, e, name in iv:
        by_name[name] += e - s
    rows = [f"{us / 1e3:12.2f} ms  {name}" for name, us in
            by_name.most_common()]
    (Path("chiprun_out") / "profile_cli.txt").write_text("\n".join(rows)
                                                         + "\n")


def main(argv=None) -> int:
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
        "exact_video_scale": (dataclasses.replace(exact, video_scale=1.5), 1,
                              False),
        f"exact_{chip_smoke.BATCH}clips": (exact, chip_smoke.BATCH, False),
        "exact_ip_plus": (exact, 1, True),
    }
    chosen = list(sys.argv[1:] if argv is None else argv) \
        or [*paths, "cli"]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pipe = None
    for label, (spec, batch, ip_plus) in paths.items():
        if label not in chosen:
            continue
        if pipe is None or (pipe.ip_adapter is not None) != ip_plus:
            pipe = None  # one full-width pipeline at a time
            gc.collect()
            torch.cuda.empty_cache()
            pipe = chip_smoke.full_pipeline(0, ip_plus=ip_plus)
        request(pipe, spec, 100, batch)
        torch.cuda.reset_peak_memory_stats()
        with chip_smoke.wrappers_replaced(annotated), \
                torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            request(pipe, spec, 101, batch)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        events = trace_events(prof)
        iv = device_intervals(events)
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
        w_calls, w_us, w_n = by_wrapper(events)
        for wrapper in chip_smoke.KERNELS:
            us = w_us[wrapper]
            chip_smoke.log(f"[{label}] {wrapper}: {us / 1e3:.2f} ms over "
                           f"{w_calls[wrapper]} calls, {w_n[wrapper]} device "
                           f"launches, {us / 1e6 / wall:.3f} of the wall")
        rows = [f"{us / 1e3:12.2f} ms {calls[name]:6d}  {name}"
                for name, us in by_name.most_common()]
        (out_dir / f"profile_{label}.txt").write_text("\n".join(rows) + "\n")
        for row in rows[:TOP]:
            chip_smoke.log(f"[{label}] {row[:150]}")
    if "cli" in chosen:
        pipe = None
        gc.collect()
        torch.cuda.empty_cache()
        profile_cli(acts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
