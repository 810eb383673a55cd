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
device intervals inside that part's host range); the click front-end
(``click``: SAM ``vit_h`` ``set_image`` and one click, then a
``predict_batch`` of 64 points, with the encoder, the decoder and the
postprocessing in ranges) and the SD fill (``fill``: the inpaint pipeline
on the synthetic SD-1.5 directory, one 512² crop, 25 steps, with the text
encoder, the VAE encode, each UNet step and the VAE decode in ranges),
each part's device time by the correlation ids of its launches; the
motion score (``flow``: :func:`profile_flow`, the device time by aten op
and input shapes); the other flow estimators (``estimators``:
:func:`profile_estimators`, each forward with and without cuDNN, a
profiled forward each and the card's rounding on both routes). For each path it prints
the wall time (host clock, ending in ``torch.cuda.synchronize()``), the
peak device memory of the profiled request, the device's busy time (the union of the kernel,
memcpy and memset intervals of the trace), the device span, the idle share
of the wall time, each kernel wrapper's device time, calls, device launches
and share of the wall, and the 30 kernels that take the most device time;
the whole table goes to
``chiprun_out/profile_<path>.txt``. The process keeps PyTorch's precision
flags; every path goes through entry points that run under
``utils/backend_flags.checked_precision``, but the training step's
functions, which run under it here. Needs torch with CUDA and the CUDA
toolkit; imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
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
from chip_smoke import busy_us, device_intervals, profiled, trace_events

EXACT_STEPS = 4
TOP = 30


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


def report_parts(label, acts, fn, parts, out_dir):
    """Profile ``fn`` with each ``(owner, attr)`` of ``parts`` (name →) in a
    profiler range: the wall, peak memory, busy time and idle share, and
    each part's calls and device ms (its launches' kernels by correlation
    id); the kernel table to ``chiprun_out/profile_<label>.txt``."""
    saved = {}
    for name, (owner, attr) in parts.items():
        saved[name] = getattr(owner, attr)
        setattr(owner, attr, annotated(f"{label}_{name}", saved[name]))
    try:
        wall, peak, events, iv, busy = profiled(acts, fn)
    finally:
        for name, (owner, attr) in parts.items():
            setattr(owner, attr, saved[name])
    names = {f"{label}_{n}" for n in parts}
    calls = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation"
                                and e.get("name") in names)
    us, n = range_device_us(events, lambda e: e["name"] if e.get("cat") ==
                            "user_annotation" and e["name"] in names
                            else None)
    chip_smoke.log(f"[{label}] wall {wall:.3f} s, peak device memory "
                   f"{peak:.2f} GiB, device busy {busy:.3f} s; idle share of "
                   f"wall {1 - busy / wall:.3f} ({chip_smoke.CARD})")
    for name in parts:
        key = f"{label}_{name}"
        chip_smoke.log(f"[{label}] {name}: {calls[key]} calls, "
                       f"{us[key] / 1e3:.2f} ms on the device "
                       f"({n[key]} launches), {us[key] / 1e6 / wall:.3f} of "
                       f"the wall")
    by_name = collections.Counter()
    for s, e, name in iv:
        by_name[name] += e - s
    rows = [f"{t / 1e3:12.2f} ms  {name}" for name, t in
            by_name.most_common()]
    (out_dir / f"profile_{label}.txt").write_text("\n".join(rows) + "\n")
    for row in rows[:10]:
        chip_smoke.log(f"[{label}] {row[:150]}")


def profile_click(acts, out_dir, sam_type="vit_h", device="cuda"):
    """The click path: ``set_image`` and one click's ``predict`` on the
    image of ``chip_smoke.phase_click`` (vit_h, fp32), then a
    ``predict_batch`` of ``chip_smoke.CLICK_BATCH`` points, warm, with the
    encoder, the decoder (prompt encode + mask decode) and the
    postprocessing in ranges."""
    import numpy as np

    from followyourclick_tpu_torch.sam import (
        Sam,
        SamPredictor,
        build_sam,
        sam_model_registry,
    )
    from followyourclick_tpu_torch.sam import predictor as predictor_mod

    h, w = chip_smoke.CLICK_IMAGE
    predictor = SamPredictor(build_sam(
        sam_model_registry[sam_type], device,
        torch.Generator(device=device).manual_seed(0)), device)
    img = chip_smoke.click_image(0, h, w)
    rs = np.random.RandomState(0)
    pts = rs.uniform(0, 1, (chip_smoke.CLICK_BATCH, 1, 2)) * [w, h]

    def click():
        predictor.set_image(img)
        predictor.predict(np.array([chip_smoke.CLICK_POINT]), np.array([1]))

    def batch():
        predictor.predict_batch(pts, np.ones((len(pts), 1), np.int32))

    parts = {"encoder": (Sam, "encode_image"),
             "decoder": (Sam, "predict_from_embedding"),
             "postprocess": (predictor_mod, "postprocess_masks")}
    for label, fn in (("click", click), ("click_batch", batch)):
        fn()
        report_parts(label, acts, fn, parts, out_dir)


def profile_fill(acts, out_dir, cfg=None, device="cuda"):
    """The fill path: the SD inpaint pipeline of ``cli.inpaint`` on the
    synthetic SD-1.5 directory (bf16), one warm call on a 512² crop of the
    click image with a seeded mask, ``chip_smoke.FILL_STEPS`` steps, CFG
    7.5, with the text encoder, the VAE encode, each UNet step (the CFG
    batch) and the VAE decode in ranges."""
    import numpy as np

    from followyourclick_tpu_torch.cli import inpaint as cli_inpaint
    from followyourclick_tpu_torch.config import InferenceConfig

    cfg = cfg or InferenceConfig()
    with tempfile.TemporaryDirectory() as root:
        sd = os.path.join(root, "sd15")
        chip_smoke.write_sd_directory(sd, cfg, 0, device)
        args = cli_inpaint.build_parser().parse_args(
            ["fill", "--input_img", "unused.png", "--point_coords", "0", "0",
             "--output_dir", root, "--text_prompt", chip_smoke.FILL_PROMPT,
             "--sd_model_path", sd, "--device", device])
        pipe = cli_inpaint.build_sd_pipeline(args, cfg)
    img = chip_smoke.click_image(0, 512, 512)
    mask = np.zeros((512, 512), np.uint8)
    mask[128:384, 160:352] = 255

    def fill():
        pipe(img, mask, chip_smoke.FILL_PROMPT,
             steps=chip_smoke.FILL_STEPS,
             guidance_scale=chip_smoke.FILL_GUIDANCE, seed=0)

    parts = {"text": (pipe.text_encoder, "forward"),
             "vae_encode": (pipe.vae, "encode"),
             "unet_step": (pipe.unet, "forward"),
             "vae_decode": (pipe.vae, "decode")}
    fill()
    report_parts("fill", acts, fill, parts, out_dir)


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


def profile_flow(acts, out_dir, seed=0, device="cuda"):
    """The motion score of ``chip_smoke.phase_motion_score`` (seeded RAFT
    with calibrated BN, a 16-frame 512² clip, 12 iterations): one warm call
    under the profiler with the shapes recorded, the device time by aten
    op and input shapes (which convolution takes the time, and by which
    cuDNN algorithm's kernels); then, as a diagnostic of cuDNN's choice
    alone, the same call with ``torch.backends.cudnn.benchmark`` on (not a
    setting of the port), warm, median of 3, set back after."""
    from followyourclick_tpu_torch.flow.api import compute_motion_score

    frames = chip_smoke.flow_clip(seed, *chip_smoke.FLOW_CLIP)
    model = chip_smoke.flow_model(seed, frames, device)

    def call():
        return compute_motion_score(model, frames, chip_smoke.FLOW_ITERS)

    call()
    ms, _ = chip_smoke.event_ms(call, reps=3)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        call()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted(prof.key_averages(group_by_input_shape=True),
                  key=device_us, reverse=True)
    lines = [f"{device_us(e) / 1e3:10.2f} ms {e.count:6d}  {e.key}  "
             f"{e.input_shapes}" for e in rows if device_us(e) > 0]
    (out_dir / "profile_flow.txt").write_text("\n".join(lines) + "\n")
    chip_smoke.log(f"[flow] motion score, warm: "
                   f"{' / '.join(f'{t:.1f}' for t in ms)} ms "
                   f"({chip_smoke.CARD}); device time by op and shapes:")
    for line in lines[:12]:
        chip_smoke.log(f"[flow]   {line[:220]}")
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        call()
        bench, _ = chip_smoke.event_ms(call, reps=3)
    finally:
        torch.backends.cudnn.benchmark = saved
    chip_smoke.log(f"[flow] the same call with cudnn.benchmark on "
                   f"(diagnostic): {' / '.join(f'{t:.1f}' for t in bench)} "
                   f"ms")
    conv_diagnostic(model, device)


def conv_diagnostic(model, device):
    """The motion encoder's 3x3 convs at the motion score's shapes (15
    pairs at 512²: (15, 256, 64, 64) in), fp32, each way median of 5 by
    CUDA events, beside the bound of their operations at the fp32 peak:
    cuDNN as called, with ``cudnn.benchmark`` over every algorithm
    (``benchmark_limit`` 0), in channels-last memory, as unfold + one
    cuBLAS product (plain ops), and with TF32 on (outside the port's
    contract) — which of them the card runs at a sane rate."""
    import torch.nn.functional as F

    from followyourclick_tpu_torch.utils.backend_flags import (
        checked_precision,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(15, 256, 64, 64, generator=gen, device=device)
    for name, conv in (("corr_net.1", model.decoder.encoder.corr_net[1]),
                       ("out_net.0", model.decoder.encoder.out_net[0])):
        w, b = conv.conv.weight, conv.conv.bias
        ops = 2 * x.shape[0] * 64 * 64 * w.numel()
        with checked_precision(), torch.no_grad():
            want = F.conv2d(x, w, b, padding=1)

        def unfold():
            cols = F.unfold(x, 3, padding=1)              # (B, 2304, HW)
            out = w.reshape(w.shape[0], -1) @ cols + b[:, None]
            return out.reshape(x.shape[0], -1, 64, 64)

        ways = {"cuDNN as called": lambda: F.conv2d(x, w, b, padding=1),
                "unfold + cuBLAS": unfold}
        xl = x.contiguous(memory_format=torch.channels_last)
        wl = w.contiguous(memory_format=torch.channels_last)
        ways["channels-last"] = lambda: F.conv2d(xl, wl, b, padding=1)
        rows = []
        with checked_precision(), torch.no_grad():
            for label, fn in ways.items():
                fn()
                ms, out = chip_smoke.event_ms(fn, reps=5)
                err = float((out - want).abs().max())
                rows.append((label, float(np.median(ms)), err))
            saved = (torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.benchmark_limit)
            torch.backends.cudnn.benchmark = True
            torch.backends.cudnn.benchmark_limit = 0
            try:
                fn = ways["cuDNN as called"]
                fn()
                ms, out = chip_smoke.event_ms(fn, reps=5)
                rows.append(("cuDNN, benchmark over every algorithm",
                             float(np.median(ms)),
                             float((out - want).abs().max())))
            finally:
                (torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.benchmark_limit) = saved
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                fn = ways["cuDNN as called"]
                fn()
                ms, out = chip_smoke.event_ms(fn, reps=5)
                rows.append(("cuDNN, TF32 on (outside the contract)",
                             float(np.median(ms)),
                             float((out - want).abs().max())))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        for label, ms, err in rows:
            chip_smoke.log(f"[flow conv] {name} {tuple(x.shape)} x "
                           f"{tuple(w.shape)}: {label} {ms:.3f} ms (bound "
                           f"{ops / chip_smoke.PEAK_FP32_OPS * 1e3:.3f} ms "
                           f"at the fp32 peak), max |Δ| from cuDNN's fp32 "
                           f"{err:.2e} ({chip_smoke.CARD})")


@contextlib.contextmanager
def cudnn_estimators():
    """The flow estimators' forwards without their
    ``native_convolutions`` wrapper inside the block, so their convolutions
    take cuDNN as the process has it: a diagnostic of the route the port
    does not take."""
    from followyourclick_tpu_torch.flow import (
        flownet,
        flownet2,
        irrpwc,
        liteflownet,
        maskflownet,
        pwcnet,
    )

    classes = {c for m in (pwcnet, flownet, flownet2, maskflownet, irrpwc,
                           liteflownet) for c in vars(m).values()
               if isinstance(c, type) and "__wrapped__" in dir(
                   c.__dict__.get("forward"))}
    saved = {c: c.forward for c in classes}
    for c in classes:
        c.forward = c.forward.__wrapped__
    try:
        yield
    finally:
        for c, forward in saved.items():
            c.forward = forward


def profile_estimators(acts, out_dir, seed=0, device="cuda"):
    """The other flow estimators (``chip_smoke.FLOW_ESTIMATOR_CONFIGS``,
    seeded, fp32 under the contract), each on a 448x1024 pair: the
    training-mode forward as the port runs it (cuDNN off,
    ``flow/pwcnet.native_convolutions``) and with cuDNN (its wrapper
    lifted, :func:`cudnn_estimators`), median of 5 warm calls by CUDA
    events each, in turns in this call; one warm forward of the port's
    route under the profiler (wall, busy, idle share, device launches,
    the kernels that take the most device time; all of them to
    ``chiprun_out/profile_estimators.txt``); and each route's worst
    distance of a 256x384 output from the CPU's fp64 over the CPU fp32's
    (phase 22's gate: 2), with one 3x3 conv at the model's widest layer
    (card with and without cuDNN, and the CPU, from fp64)."""
    import copy

    import torch.nn.functional as F
    import yaml

    from followyourclick_tpu_torch.flow.api import init_model
    from followyourclick_tpu_torch.flow.registry import flow_estimator
    from followyourclick_tpu_torch.utils.backend_flags import (
        checked_precision,
    )

    here = Path(__file__).resolve().parent
    table = []
    for i, name in enumerate(chip_smoke.FLOW_ESTIMATOR_CONFIGS):
        with open(here / "configs" / "flow" / f"{name}.yaml") as f:
            spec = flow_estimator(yaml.safe_load(f)["model"])
        model = init_model(spec, seed=seed + i, device=device)
        img1, img2 = chip_smoke.flow_pair(seed + i, 448, 1024, device)

        def call():
            with torch.no_grad():
                return model(img1, img2)

        ms = {}
        with checked_precision():
            for label in ("port", "cuDNN", "port ", "cuDNN "):
                route = (cudnn_estimators() if label.startswith("cuDNN")
                         else contextlib.nullcontext())
                with route:
                    call()
                    ms[label] = chip_smoke.event_ms(call, reps=5)[0]
            wall, _, _, spans, busy = profiled(acts, call)
        by_name = collections.Counter()
        for start, end, kernel in spans:
            by_name[kernel] += (end - start) / 1e3
        med = {k: float(np.median(ms[k] + ms[k + " "]))
               for k in ("port", "cuDNN")}
        chip_smoke.log(
            f"[estimators] {spec.cls.__name__} ({name}) 448x1024: "
            f"{med['port']:.3f} ms as the port runs it (cuDNN off), "
            f"{med['cuDNN']:.3f} ms with cuDNN (median of 2 x 5 in turns); "
            f"the port's route profiled: wall {wall * 1e3:.2f} ms, busy "
            f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}, "
            f"{len(spans)} device intervals ({chip_smoke.CARD})")
        table.append(f"== {name}: port {med['port']:.3f} ms, cuDNN "
                     f"{med['cuDNN']:.3f} ms; profiled wall "
                     f"{wall * 1e3:.2f} ms, busy {busy * 1e3:.2f} ms, "
                     f"{len(spans)} intervals")
        for kernel, t in by_name.most_common():
            table.append(f"{t:10.3f} ms  {kernel}")
        for kernel, t in by_name.most_common(4):
            chip_smoke.log(f"[estimators]   {t:9.3f} ms  {kernel[:110]}")

        small = chip_smoke.flow_pair(seed + i, 256, 384, device)
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        cpu = init_model(spec, checkpoint=state, device="cpu")
        cpu_in = [t.cpu() for t in small]
        want = chip_smoke.named_outputs(cpu, *cpu_in)
        exact = chip_smoke.named_outputs(copy.deepcopy(cpu).double(),
                                         *[t.double() for t in cpu_in])

        def worst(outs):
            return max(chip_smoke.rel_l2_64(outs[k], exact[k]) / max(
                chip_smoke.rel_l2_64(want[k], exact[k]), 1e-30)
                for k in exact)

        with checked_precision():
            ratio = worst(chip_smoke.named_outputs(model, *small))
            with cudnn_estimators():
                ratio_cudnn = worst(chip_smoke.named_outputs(model, *small))
        convs = [m for m in model.modules()
                 if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)]
        conv = max(convs, key=lambda m: m.weight.numel())
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(1, conv.in_channels, 28, 64, generator=gen,
                        device=device)
        args = (None, conv.stride, conv.padding)
        with checked_precision(), torch.no_grad():
            ref = F.conv2d(x.cpu().double(), conv.weight.cpu().double(),
                           *args)
            one = {"cuDNN": F.conv2d(x, conv.weight, *args),
                   "CPU": F.conv2d(x.cpu(), conv.weight.cpu(), *args)}
            saved = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = False
            try:
                one["card, cuDNN off"] = F.conv2d(x, conv.weight, *args)
            finally:
                torch.backends.cudnn.enabled = saved
        chip_smoke.log(
            f"[estimators]   256x384 outputs, worst distance from the CPU's "
            f"fp64 over the CPU fp32's: {ratio:.3f} as the port runs it, "
            f"{ratio_cudnn:.3f} with cuDNN; one 3x3 conv "
            f"{tuple(conv.weight.shape)} on {tuple(x.shape)} from fp64: "
            + ", ".join(f"{k} {chip_smoke.rel_l2_64(v, ref):.2e}"
                        for k, v in one.items()))
        del model, cpu
        gc.collect()
        torch.cuda.empty_cache()
    (out_dir / "profile_estimators.txt").write_text("\n".join(table) + "\n")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    argv = list(sys.argv[1:] if argv is None else argv)

    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )
    from followyourclick_tpu_torch.utils.backend_flags import precision_flags

    # the process keeps PyTorch's flags: the requests, the CLI, the click
    # and the fill go through entry points that set the port's contract;
    # the training step's functions run under it here
    defaults = precision_flags()

    def check_flags(label):
        if precision_flags() != defaults:
            raise SystemExit(f"{label}: the precision flags are "
                             f"{precision_flags()} after it, not {defaults}")

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
    chosen = argv or [*paths, "cli", "click", "fill", "flow", "estimators"]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    if chosen[:1] == ["train"]:
        with chip_smoke.checked_precision():
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
        check_flags(label)
    for name, fn in (("cli", profile_cli), ("click", profile_click),
                     ("fill", profile_fill), ("flow", profile_flow),
                     ("estimators", profile_estimators)):
        if name in chosen:
            pipe = None
            gc.collect()
            torch.cuda.empty_cache()
            fn(acts) if name == "cli" else fn(acts, out_dir)
            check_flags(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
