#!/usr/bin/env python3
"""Drive the PyTorch port's exact click-to-video sampler on one NVIDIA card.

    python3 chip_smoke.py [--steps 4] [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the card's name and power limit (``nvidia-smi``), then the build of the
   hand-written kernels from ``followyourclick_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at every shape the
   16-frame 512² CFG step gives it, in bf16 and in both GEGLU gate forms,
   with the error against a stated tolerance and both times;
3. a tiny-config request on the card (kernels, fp32) against the same
   request through the port on the CPU (plain versions);
4. two requests at full width (the default ``InferenceConfig``, 1.28 B
   UNet parameters) in bf16 at 16 frames, 512², CFG 8, with seeded random
   weights: time, video statistics, and the kernels' launch counts, which
   must be exactly 20 (motion block) and 16 (LN-GEGLU) per step.

The second-to-last line is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. The script needs torch with CUDA, numpy
and the CUDA toolkit; it imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 kernel vs plain: max |kernel - plain| / max |plain| <= 1.6e-2, two
# bf16 ulps of the largest output (the plain version rounds each product to
# bf16 before its fp32 bias, and sums run in another order), as
# tests/test_torch_cuda.py
BF16_REL = 1.6e-2
# tiny fp32 request, card vs CPU, on a video in [0, 1]: the two sides differ
# only in summation order (TF32 off) through 2 steps of ~60 layers and the VAE
TINY_VIDEO_ATOL = 2e-3

# (rows, C) per LN-GEGLU call and its count per UNet evaluation, and
# (positions, F, C) per motion block and its count, at 16 f / 512² with CFG
GEGLU_SHAPES = [((131072, 320), 5), ((32768, 640), 5), ((8192, 1280), 5),
                ((2048, 1280), 1)]
MOTION_SHAPES = [((8192, 16, 320), 5), ((2048, 16, 640), 5),
                 ((512, 16, 1280), 5), ((128, 16, 1280), 5)]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=5):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def randn(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        dtype)


def phase_build():
    from followyourclick_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log").read_text().splitlines()
    for line in report:
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())


def compare(name, got, ref, failures):
    """Log the error of ``got`` against ``ref``; note a failure."""
    diff = (got.float() - ref.float()).abs()
    max_abs, scale = float(diff.max()), float(ref.float().abs().max())
    ok = max_abs <= BF16_REL * scale
    log(f"  {name}: max_abs_err {max_abs:.3e}, max |plain| {scale:.3e}, "
        f"normalised {max_abs / scale:.3e} (tol {BF16_REL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return max_abs


def phase_kernels(seed):
    from followyourclick_tpu_torch.ops.geglu import (
        fused_ln_geglu,
        ln_geglu_ref,
    )
    from followyourclick_tpu_torch.ops.motion_block import (
        fused_motion_block,
        motion_block_ref,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stats = {"fused_ln_geglu": dict(err=0.0, ms=0.0, plain_ms=0.0),
             "fused_motion_block": dict(err=0.0, ms=0.0, plain_ms=0.0)}
    failures = []

    def vec(c, s=0.05, base=0.0):
        return base + randn(gen, (c,), s, bf)

    for (rows, c), count in GEGLU_SHAPES:
        inner = 4 * c
        args = (randn(gen, (rows, c), 1.0, bf), vec(c, base=1.0), vec(c),
                randn(gen, (2 * inner, c), c ** -0.5, bf), vec(2 * inner),
                randn(gen, (c, inner), inner ** -0.5, bf), vec(c))
        default = c <= 640
        for fast in (default, not default):
            name = (f"fused_ln_geglu R={rows} C={c} "
                    f"{'tanh' if fast else 'erf'}")
            got = fused_ln_geglu(*args, fast_gating=fast)
            ref = ln_geglu_ref(*args, fast_gating=fast)
            st = stats["fused_ln_geglu"]
            st["err"] = max(st["err"], compare(name, got, ref, failures))
            ms = time_ms(lambda: fused_ln_geglu(*args, fast_gating=fast))
            plain = time_ms(lambda: ln_geglu_ref(*args, fast_gating=fast))
            log(f"    kernel {ms:.3f} ms, plain {plain:.3f} ms")
            if fast == default:
                st["ms"] += count * ms
                st["plain_ms"] += count * plain

    for (p, f, c), count in MOTION_SHAPES:
        heads = 8
        params = []
        for _ in range(2):
            params += [vec(c, base=1.0), vec(c)] + [
                randn(gen, (c, c), c ** -0.5, bf) for _ in range(4)] + [
                vec(c, 0.02)]
        params += [vec(c, base=1.0), vec(c),
                   randn(gen, (8 * c, c), c ** -0.5, bf), vec(8 * c, 0.02),
                   randn(gen, (c, 4 * c), (4 * c) ** -0.5, bf), vec(c, 0.02)]
        x = randn(gen, (p, f, c), 1.0, bf)
        pe = randn(gen, (f, c), 0.5, bf)
        scale = (c // heads) ** -0.5
        default = c <= 640
        for fast in (default, not default):
            name = (f"fused_motion_block P={p} F={f} C={c} "
                    f"{'tanh' if fast else 'erf'}")

            def run_kernel():
                return fused_motion_block(x, pe, params, scale, heads,
                                          fast_gating=fast)

            def run_plain():
                return motion_block_ref(x, pe, params, scale, heads,
                                        fast_gating=fast)

            st = stats["fused_motion_block"]
            st["err"] = max(st["err"], compare(name, run_kernel(),
                                               run_plain(), failures))
            ms, plain = time_ms(run_kernel), time_ms(run_plain)
            log(f"    kernel {ms:.3f} ms, plain {plain:.3f} ms")
            if fast == default:
                st["ms"] += count * ms
                st["plain_ms"] += count * plain
    for name, st in stats.items():
        log(f"[kernels] {name}: one UNet evaluation's calls take "
            f"{st['ms']:.1f} ms in the kernel, {st['plain_ms']:.1f} ms plain")
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failures}")
    return stats


def unzero_(module, gen, std=0.02):
    """Give the layers that start at zero (motion-module proj_out, fps and
    motion-score embedding outputs) small random weights, so the motion
    blocks and the embeddings reach the video."""
    from followyourclick_tpu_torch.models.layers import TimestepEmbedding
    from followyourclick_tpu_torch.models.motion_module import MotionModule

    with torch.no_grad():
        for m in module.modules():
            layer = (m.proj_out if isinstance(m, MotionModule) else
                     m.linear_2 if isinstance(m, TimestepEmbedding) else None)
            if layer is not None and not layer.weight.any():
                w = torch.randn(layer.weight.shape, generator=gen,
                                device=gen.device) * std
                layer.weight.copy_(w)


def tiny_config():
    """The CPU tests' tiny config at 384² instead of 64²: at 64² the spatial
    self-attention of the inner levels has ≤ 32 tokens, which is the JAX
    package's tiny-sequence Pallas route, not ported yet (it raises on the
    card). At 384² the smallest level has 6² = 36 tokens."""
    from followyourclick_tpu_torch.config import (
        CLIPTextConfig,
        InferenceConfig,
        MotionModuleConfig,
        UNet3DConfig,
        VAEConfig,
    )

    return InferenceConfig(
        unet=UNet3DConfig(
            block_out_channels=(32, 64, 64, 64), layers_per_block=1,
            norm_num_groups=8,
            motion_module=MotionModuleConfig(num_attention_heads=4)),
        vae=VAEConfig(block_out_channels=(32, 64, 64, 64),
                      layers_per_block=1, norm_num_groups=8),
        clip_text=CLIPTextConfig(vocab_size=1000, intermediate_size=512,
                                 num_hidden_layers=2, num_attention_heads=4))


def make_request(pipe, spec, seed, vocab):
    """Token ids, click mask, fps / motion score and a first-frame image
    (encoded by the pipeline's VAE), all from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = 1, spec.height // 8, spec.width // 8
    image = torch.rand(b, spec.height, spec.width, 3, generator=g) * 2 - 1
    cy, cx = torch.randint(0, h, (2,), generator=g).tolist()
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    mask = (((yy - cy) ** 2 + (xx - cx) ** 2) <= (h // 4) ** 2).float()
    return dict(
        input_ids=torch.randint(0, vocab, (b, 77), generator=g),
        neg_input_ids=torch.randint(0, vocab, (b, 77), generator=g),
        first_image_latents=pipe.encode_image(image),
        mask=mask[None, :, :, None],
        fps=torch.tensor([8.0]),
        motion_score=torch.tensor([float(10 + seed % 20)]),
        noise=torch.randn(b, spec.video_length, h, w, 4, generator=g))


def phase_tiny(seed):
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
        SampleSpec,
    )

    torch.manual_seed(seed)
    cfg = tiny_config()
    cpu = AnimationPipeline(cfg)
    unzero_(cpu.unet, torch.Generator().manual_seed(seed))
    card = AnimationPipeline(cfg, copy.deepcopy(cpu.unet),
                             copy.deepcopy(cpu.vae),
                             copy.deepcopy(cpu.text_encoder), device="cuda")
    spec = SampleSpec(video_length=4, height=384, width=384,
                      num_inference_steps=2)
    with torch.inference_mode():
        req = make_request(cpu, spec, seed + 1, 1000)
    t0 = time.perf_counter()
    want = cpu.sample(spec=spec, **req)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = card.sample(spec=spec, **req)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    err = float((got.cpu() - want).abs().max())
    ok = err <= TINY_VIDEO_ATOL and bool(torch.isfinite(got).all()) \
        and float(want.std()) > 1e-3
    log(f"[tiny] video {tuple(got.shape)} card (kernels) vs CPU (plain): "
        f"max_abs_err {err:.3e} (tol {TINY_VIDEO_ATOL}); card {t_card:.2f} s, "
        f"CPU {t_cpu:.2f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tiny request: the card disagrees with the CPU")


def phase_full(seed, steps):
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu
    from followyourclick_tpu_torch.ops.motion_block import fused_motion_block
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
        SampleSpec,
    )

    cfg = InferenceConfig()
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    with torch.device("cuda"):
        from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
        from followyourclick_tpu_torch.models.unet3d import (
            UNet3DConditionModel,
        )
        from followyourclick_tpu_torch.models.vae import AutoencoderKL

        unet = UNet3DConditionModel(cfg.unet)
        vae = AutoencoderKL(cfg.vae)
        text = CLIPTextModel(cfg.clip_text)
    unzero_(unet, torch.Generator(device="cuda").manual_seed(seed))
    pipe = AnimationPipeline(cfg, unet, vae, text, device="cuda",
                             dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    log(f"[full] built in {time.perf_counter() - t0:.1f} s; UNet "
        f"{n_params / 1e9:.3f} B parameters, bf16")
    spec = SampleSpec(num_inference_steps=steps)

    counters = (fused_motion_block, fused_ln_geglu)
    for fn in counters:
        fn.launches = 0
    videos, seconds = [], []
    for r in range(2):
        before = [fn.launches for fn in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            req = make_request(pipe, spec, seed + 100 + r,
                               cfg.clip_text.vocab_size)
            video = pipe.sample(spec=spec, **req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [fn.launches - b for fn, b in zip(counters, before)]
        v = video.float()
        log(f"[full] request {r}: {dt:.2f} s, video {tuple(v.shape)} min "
            f"{float(v.min()):.4f} max {float(v.max()):.4f} mean "
            f"{float(v.mean()):.4f} std {float(v.std()):.4f}; launches "
            f"fused_motion_block {got[0]} (want {20 * steps}), "
            f"fused_ln_geglu {got[1]} (want {16 * steps})")
        if got != [20 * steps, 16 * steps]:
            raise SystemExit("the main path did not launch every kernel "
                             "the expected number of times")
        if v.shape != (1, 16, 512, 512, 3) or not bool(
                torch.isfinite(v).all()) or float(v.std()) <= 0.0:
            raise SystemExit("the video is not finite and non-constant")
        videos.append(v)
        seconds.append(dt)
    diff = float((videos[0] - videos[1]).abs().mean())
    log(f"[full] mean |video 0 - video 1| = {diff:.4f}")
    if diff <= 0.0:
        raise SystemExit("two different requests gave the same video")
    log(f"[full] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {fn.__name__: fn.launches for fn in counters}, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="DDIM steps per full-width request (default 4)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    phase_build()
    stats = phase_kernels(args.seed)
    phase_tiny(args.seed)
    launches, _ = phase_full(args.seed, args.steps)

    sources = {
        "fused_motion_block": ("followyourclick_tpu_torch/csrc/motion_block.cu",
                               "followyourclick_tpu/ops/motion_block.py:179"),
        "fused_ln_geglu": ("followyourclick_tpu_torch/csrc/geglu.cu",
                           "followyourclick_tpu/ops/geglu.py:224"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": stats[name]["err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
                "ms_covers": "one UNet evaluation's calls at 16 f / 512^2 "
                             "CFG, bf16, default gating"}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
