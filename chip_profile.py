#!/usr/bin/env python3
"""Profile one warm full-width request per path on one NVIDIA card.

    python3 chip_profile.py [path ...]
    python3 chip_profile.py train [--remat-blocks] [--frames 24 --batch 3]

(all paths by default; e.g. ``python3 chip_profile.py cli``; ``train``: the
training step, :func:`profile_train`, with ``tools/train_bench.py``'s
flags)

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

import numpy as np
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
    of the kernels launched inside its calls (:func:`range_device_us`).
    Several wrappers share device kernels (the bf16 motion block runs
    LN-GEGLU's, fused_ln_geglu's and the frame attention's), so names alone
    cannot tell them apart."""
    names = set(chip_smoke.KERNELS)
    calls = collections.Counter(
        e["name"] for e in events
        if e.get("cat") == "user_annotation" and e["name"] in names)
    us, n = range_device_us(
        events, lambda e: e["name"] if e.get("cat") == "user_annotation"
        and e["name"] in names else None)
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
    us, n = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        inside = [r for r in ranges.get(tid, ()) if r[0] <= ts <= r[1]]
        if inside:
            name = min(inside, key=lambda r: r[1] - r[0])[2]
            us[name] += e["dur"]
            n[name] += 1
    return us, n


# the backward nodes of the kernels' autograd Functions
GRAD_NODES = ("MotionBlockGradBackward", "LnGegluGradBackward",
              "GegluGradBackward", "TemporalAttentionGradBackward",
              "TemporalBlockGradBackward", "FlashAttentionGradBackward")


def profile_train(argv, out_dir: Path) -> int:
    """``chip_profile.py train``: the port's counterpart of
    ``tools/train_bench.py`` (same flags). One warm step, ``--iters`` steps
    timed by CUDA events (median), then one step under ``torch.profiler``:
    the device's busy time and idle share, the two kernels' forward device
    time (inside their wrappers' ranges) and the fp32 recompute backward's
    (inside the autograd Functions' backward nodes). One JSON line; a
    configuration that does not fit the card's memory prints ``"fits":
    false`` and exits 0. The whole kernel table goes to ``out_dir``."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_profile.py train")
    ap.add_argument("--height", type=int, default=448)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--full-tree", action="store_true",
                    help="the fp32 full-tree state (every gradient)")
    ap.add_argument("--mu-bf16", action="store_true",
                    help="AdamW's first moment in bf16")
    ap.add_argument("--fp32-compute", action="store_true",
                    help="frozen leaves in fp32, so the forward runs in "
                         "fp32 (default: bf16 frozen leaves, fp32 masters)")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="FYC_ATTN_BATCH_CHUNK for large self-attention")
    ap.add_argument("--remat-blocks", action="store_true",
                    help="per-block checkpoints instead of one around the "
                         "whole UNet call")
    args = ap.parse_args(argv)
    if args.attn_chunk:
        os.environ["FYC_ATTN_BATCH_CHUNK"] = str(args.attn_chunk)

    from followyourclick_tpu_torch.config import NoiseScheduleConfig
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
    from followyourclick_tpu_torch.training import step as ts

    workload = (f"{args.height}x{args.width}_{args.frames}f_b{args.batch}"
                + ("_fulltree" if args.full_tree else "_partitioned")
                + ("_mubf16" if args.mu_bf16 else "")
                + ("_fp32" if args.fp32_compute else "")
                + ("_rematblocks" if args.remat_blocks else "")
                + (f"_attnchunk{args.attn_chunk}" if args.attn_chunk
                   else ""))
    result = {"metric": "train_step_ms", "workload": workload,
              "kind": torch.cuda.get_device_name(0)}
    torch.cuda.reset_peak_memory_stats()
    try:
        cfg, unet, vae, text = chip_smoke.train_models(
            0, remat_blocks=args.remat_blocks)
        tcfg = ts.TrainConfig(
            adam_mu_dtype="bfloat16" if args.mu_bf16 else None,
            gradient_checkpointing=not args.remat_blocks)
        if args.full_tree:
            state, step = ts.create_train_state(unet, tcfg), ts.train_step
        else:
            state = ts.create_partitioned_train_state(
                unet, tcfg, frozen_dtype=torch.float32 if args.fp32_compute
                else torch.bfloat16)
            step = ts.train_step_partitioned
            result["trainable_m"] = sum(
                t.numel() for t in state.trainable.values()) / 1e6
            result["frozen_m"] = sum(
                t.numel() for t in state.frozen.values()) / 1e6
        unet.to("meta")  # the state holds every tensor the step reads
        batch = chip_smoke.train_batch(
            vae, cfg, 0, (args.frames, args.height, args.width), args.batch)
        sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)

        def run(i):
            gen = torch.Generator(device="cuda").manual_seed(i)
            return step(state, batch, gen, unet=unet, text_encoder=text,
                        sched=sched, cfg=tcfg)[1]

        loss = float(run(0)["loss"])
        if not np.isfinite(loss):
            raise SystemExit(f"train: loss {loss} at the first step")
        times = []
        for i in range(args.iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(i + 1)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with chip_smoke.wrappers_replaced(annotated), \
                torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(args.iters + 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as err:
        result.update(fits=False, peak_gib=torch.cuda.max_memory_allocated()
                      / 2 ** 30, error=str(err).splitlines()[0][:200])
        print(json.dumps(result), flush=True)
        return 0
    events = trace_events(prof)
    iv = device_intervals(events)
    if not iv:
        raise SystemExit("train: the trace holds no device activity")
    busy = busy_us(iv) / 1e6
    names = set(chip_smoke.KERNELS)

    def label(e):
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name in names:
            return name
        for node in GRAD_NODES:
            if name.endswith(node):
                return node
        return None

    us, n = range_device_us(events, label)
    frames = args.frames * args.batch
    result.update(
        fits=True, value=round(ms, 2), times_ms=[round(t, 2) for t in times],
        steps_per_s=1e3 / ms, frames_per_s=frames * 1e3 / ms,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        profiled_wall_ms=wall * 1e3, busy_ms=busy * 1e3,
        idle_share=1 - busy / wall,
        device_ms_by_range={k: v / 1e3 for k, v in us.items()},
        device_launches_by_range=dict(n), loss=loss)
    by_name = collections.Counter()
    for s_, e_, name in iv:
        by_name[name] += e_ - s_
    (out_dir / f"profile_train_{workload}.txt").write_text("\n".join(
        f"{v / 1e3:12.2f} ms  {k}" for k, v in by_name.most_common()) + "\n")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    argv = list(sys.argv[1:] if argv is None else argv)

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
    chosen = argv or [*paths, "cli"]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    if chosen[:1] == ["train"]:
        return profile_train(chosen[1:], out_dir)
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
