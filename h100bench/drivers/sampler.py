"""The click-to-video cells: requests to the port's ``AnimationPipeline``,
each its ``encode_image`` of the first frame, then ``sample``, then the
video copied to the host.

The traffic file (``traffic/<mix>.json``, ``"driver": "sampler"``) gives:

- the request: ``clips``, ``frames``, ``height``, ``width``, ``steps``,
  ``guidance_scale``, ``schedule`` (``"exact"`` or a name of the port's
  ``serving_schedules``) and ``spec``, any further ``SampleSpec`` fields,
  passed through as they are;
- the ranges the seeded inputs are drawn from: ``image_cells``,
  ``mask_area``, ``prompt_tokens``, ``fps``, ``motion_score``;
- the arrivals: one client in a closed loop, or, with
  ``arrivals_per_s``, requests arriving evenly at that rate, served in
  order, each latency counted from its arrival.

``correct``: one finished request, drawn from the seed by reservoir
sampling while the window runs, is followed stage by stage by the plain
reference (``h100bench/reference``) in float32 once the window has closed
and the program is freed. The reference works out its own text context,
first-frame latent, initial latents, DDIM tables, conditioning channels and
video, and is handed the program's latents at each step only to judge the
step that follows them (the diffusion trajectory is chaotic, so the
reference follows it from the program's own state, as a served model's
reference is fed the served tokens):

- ``text``: the [uncond; cond] CLIP context;
- ``encode``: the first frame's latent;
- ``start``: the initial latents (the first frame's noise on every frame);
- ``unet``: the UNet's [uncond; cond] output at each step, from the
  program's latents at that step, worst step;
- ``step``: the latents after each guided DDIM step, from the program's
  UNet output and latents, worst step;
- ``video``: the video on the host against the reference's decode of the
  program's final latents.

Each is a relative L2 distance ``‖program − reference‖ / ‖reference‖``.
The judge follows the exact DDIM sampler with guidance: a mix whose
request leaves it (a serving schedule, ``video_scale``) is refused before
set-up, and names a driver of its own (``drivers/<name>.py``) whose judge
follows it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import numpy as np
import torch

from h100bench.harness import draws
from h100bench.harness import trace as tr
from h100bench.harness.metrics import instrumented
from h100bench.harness.weights import DTYPES, port_models, reference_models
from h100bench.reference import ops
from h100bench.reference.sampler import (
    DDIM,
    condition_channels,
    decode,
    guided,
    initial_latents,
)
from h100bench.reference.vae import VAE_SCALE

# the SampleSpec fields the judge follows at any value; every other field
# has to keep the port's default
JUDGED = ("video_length", "height", "width", "num_inference_steps",
          "guidance_scale")
READINGS = ("program", "control")


def seed_of(seed: int, k: int) -> int:
    return (int(seed) * 1_000_033 + 7 * k + 1) % (1 << 62)


def make_request(traffic: dict, seed: int, k: int, device) -> dict:
    """Request ``k`` of a run seeded ``seed``, drawn on the device: the
    first frame (a smooth random image in [-1, 1]), the click mask, the
    prompt (the negative prompt empty), fps, the motion score and the
    initial noise."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, k))
    b, f = traffic["clips"], traffic["frames"]
    hh, ww = traffic["height"], traffic["width"]
    h, w = hh // 8, ww // 8
    cells = traffic["image_cells"]
    low = torch.randn(b, 3, cells, cells, generator=g, device=device)
    image = torch.tanh(torch.nn.functional.interpolate(
        low, size=(hh, ww), mode="bicubic", align_corners=False))
    return dict(
        image=image.permute(0, 2, 3, 1).contiguous(),
        mask=draws.click_masks(g, b, h, w, traffic["mask_area"], device),
        ids=draws.prompt_ids(g, b, traffic["prompt_tokens"], device),
        neg_ids=draws.empty_prompt(b, device),
        fps=torch.full((b,), float(traffic["fps"]), device=device),
        motion=draws.uniform(g, b, traffic["motion_score"], device),
        noise=torch.randn(b, f, h, w, 4, generator=g, device=device))


def sample_spec(traffic: dict, steps: int | None = None):
    """The request's ``SampleSpec``: the traffic's sizes, steps and
    guidance, its ``spec`` fields, then its serving schedule."""
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )

    spec = SampleSpec(video_length=traffic["frames"],
                      height=traffic["height"], width=traffic["width"],
                      num_inference_steps=steps or traffic["steps"],
                      guidance_scale=traffic["guidance_scale"],
                      **traffic.get("spec", {}))
    if traffic["schedule"] != "exact":
        spec = apply_schedule(spec, traffic["schedule"])
    return spec


def judged(spec):
    """``spec``, if the judge follows it: exact DDIM with guidance."""
    default = type(spec)()
    left = [f.name for f in dataclasses.fields(spec)
            if f.name not in JUDGED
            and getattr(spec, f.name) != getattr(default, f.name)]
    if left or spec.guidance_scale <= 1:
        raise ValueError(
            "the sampler driver judges exact DDIM with guidance; this "
            f"request also sets {left or 'guidance_scale <= 1'}: give its "
            "mix a driver whose judge follows that")
    return spec


def build_pipeline(config: dict, seed: int, device):
    """The port's pipeline at ``config``, its weights seeded on the
    device in the served dtype."""
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    m = port_models(config, seed, device)
    return AnimationPipeline(InferenceConfig.from_dict(config), m["unet"],
                             m["vae"], m["text"], device=device,
                             dtype=DTYPES[config["dtype"]])


def serve(pipe, spec, req):
    """One request as a client makes it: the first frame's latent, the
    sample, the video on the host."""
    with torch.inference_mode():
        latent = pipe.encode_image(req["image"])
        video = pipe.sample(req["ids"], req["neg_ids"], latent, req["mask"],
                            req["fps"], req["motion"], spec,
                            noise=req["noise"])
        return latent, video.cpu().numpy()


@dataclasses.dataclass
class Record:
    """What the judged request produced, stage by stage."""

    context: torch.Tensor = None   # [uncond; cond] text context
    first_latent: torch.Tensor = None
    steps: list = dataclasses.field(default_factory=list)  # (x, t, out)
    final: torch.Tensor = None     # latents handed to the decoder
    video: torch.Tensor = None     # the video on the host


@contextlib.contextmanager
def captured(pipe, record: Record):
    """Within the block the pipeline's text encode, UNet calls and decode
    leave copies of what they return (and the UNet of its latents) in
    ``record``."""
    def on_prompt(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            record.context = out.clone()
            return out
        return run

    def on_unet(fn):
        def run(sample, timesteps, *a, **k):
            out = fn(sample, timesteps, *a, **k)
            record.steps.append((sample[..., :4].clone(), timesteps.clone(),
                                 out.clone()))
            return out
        return run

    def on_decode(fn):
        def run(latents, *a, **k):
            record.final = latents.clone()
            return fn(latents, *a, **k)
        return run

    with tr.patched(pipe, "encode_prompt", on_prompt), \
            tr.patched(pipe.unet, "forward", on_unet), \
            tr.patched(pipe, "decode_latents", on_decode):
        yield


# ---------------------------------------------------------------- reference


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def _twice(x):
    return torch.cat([x, x], dim=0)


def judge(models: dict, config: dict, traffic: dict, req: dict,
          record: Record) -> dict:
    """The six numbers of ``record`` against the float32 reference."""
    unet, vae, text = models["unet"], models["vae"], models["text"]
    for m in models.values():
        ops.set_precision(m, ops.FP32)
    ddim = DDIM(config["noise_scheduler"], traffic["steps"])
    with torch.inference_mode():
        ctx = text(torch.cat([req["neg_ids"], req["ids"]]))
        latent = vae.encode(req["image"])[0] * VAE_SCALE
        out = {"text": rel_l2(record.context, ctx),
               "encode": rel_l2(record.first_latent, latent),
               "start": rel_l2(record.steps[0][0],
                               initial_latents(req["noise"]))}
        cond = condition_channels(latent, req["mask"], traffic["frames"])
        unet_gap = step_gap = 0.0
        scale = traffic["guidance_scale"]
        for i, (x, t, got) in enumerate(record.steps):
            t_i = torch.full((2,), ddim.timesteps[i], device=x.device)
            want = unet(_twice(torch.cat([x.float(), cond], dim=-1)), t_i,
                        ctx, _twice(req["fps"]), _twice(req["motion"]))
            unet_gap = max(unet_gap, rel_l2(got, want))
            nxt = record.steps[i + 1][0] if i + 1 < len(record.steps) \
                else record.final
            step_gap = max(step_gap, rel_l2(
                nxt, ddim.step(guided(got, scale), i, x.float())))
        out["unet"], out["step"] = unet_gap, step_gap
        out["video"] = rel_l2(record.video, decode(vae, record.final))
    return out


def control_record(models: dict, config: dict, traffic: dict, req: dict,
                   prec: ops.Precision) -> Record:
    """The reference put in the program's place at ``prec`` (the control:
    float8), each state it hands on rounded at that precision."""
    unet, vae, text = models["unet"], models["vae"], models["text"]
    for m in models.values():
        ops.set_precision(m, prec)
    q = prec.q
    ddim = DDIM(config["noise_scheduler"], traffic["steps"])
    rec = Record()
    with torch.inference_mode():
        rec.context = q(text(torch.cat([req["neg_ids"], req["ids"]])))
        rec.first_latent = q(vae.encode(req["image"])[0] * VAE_SCALE)
        cond = condition_channels(rec.first_latent, req["mask"],
                                  traffic["frames"])
        x = q(initial_latents(req["noise"]))
        for i in range(traffic["steps"]):
            t_i = torch.full((2,), ddim.timesteps[i], device=x.device)
            out = q(unet(_twice(torch.cat([x, cond], dim=-1)), t_i,
                         rec.context, _twice(req["fps"]),
                         _twice(req["motion"])))
            rec.steps.append((x, t_i, out))
            x = q(ddim.step(guided(out, traffic["guidance_scale"]), i, x))
        rec.final = x
        rec.video = decode(vae, x).cpu()
    return rec


# ---------------------------------------------------------------- the run


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda") -> dict:
    """Set up, warm up, measure for ``seconds``, judge; the result's
    pieces (metrics, checked numbers, trace records)."""
    traffic = cell.traffic
    spec = judged(sample_spec(traffic))
    pipe = build_pipeline(cell.config, seed, device)
    # warm-up: one short request of the cell's shapes
    serve(pipe, sample_spec(traffic, cell.own["warmup_steps"]),
          make_request(traffic, seed, -1, device))
    torch.cuda.synchronize(device)

    pick = random.Random(seed)
    plan = tr.TracePlan(cell.own["trace_detail"], cell.own["trace_timeline"],
                        lambda: instrumented(cell, pipe=pipe)) if traced \
        else None
    if plan:
        plan.warm(device)
    frames = traffic["clips"] * traffic["frames"]
    latencies, kept = [], None
    setup_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    rate = traffic.get("arrivals_per_s")
    k = 0
    while True:
        req = make_request(traffic, seed, k, device)
        chosen = pick.random() * (k + 1) < 1.0  # reservoir of one
        record = Record() if chosen else None
        if rate:  # open loop: request k arrives at k / rate
            t0 = t_open + k / rate
            time.sleep(max(0.0, t0 - time.perf_counter()))
        if plan:
            plan.before(k)
        if not rate:
            t0 = time.perf_counter()
        with captured(pipe, record) if chosen else contextlib.nullcontext():
            latent, video = serve(pipe, spec, req)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if plan:
            plan.after(k, t1, {"kind": "request", "frames": frames,
                               "clips": traffic["clips"]})
        if chosen:
            record.first_latent = latent
            record.video = torch.from_numpy(video)
            kept = (req, record)
        k += 1
        if t1 - t_open >= seconds:
            break
    if plan:
        plan.close()
    window_s = t1 - t_open
    peak_window = torch.cuda.max_memory_allocated(device)
    metrics = {"frames_per_s": frames * len(latencies) / window_s,
               "request_p90_s": percentile(latencies, 0.9),
               "setup_s": setup_s}
    out = dict(metrics=metrics, attempted=len(latencies), failed=0,
               peak=max(peak_window, setup_peak), window_peak=peak_window,
               window_s=window_s, trace=plan, latencies=latencies)
    # the program is freed before the reference runs
    req, record = kept
    del pipe
    torch.cuda.empty_cache()
    with ops.ieee_fp32():
        models = reference_models(cell.config, seed, device)
        out["numbers"] = judge(models, cell.config, traffic, req, record)
    return out


def readings(cell, seed: int, what: str, device="cuda") -> dict:
    """The checked numbers of ``what`` on ``seed``: ``program``, a run of
    one request judged as the cell's runs judge theirs; ``control``, the
    reference in float8 in the program's place."""
    if what == "program":
        return run(cell, seed, 0.0, False, time.perf_counter(),
                   device)["numbers"]
    with ops.ieee_fp32():
        req = make_request(cell.traffic, seed, 0, device)
        models = reference_models(cell.config, seed, device)
        record = control_record(models, cell.config, cell.traffic, req,
                                ops.Precision("fp8"))
        return judge(models, cell.config, cell.traffic, req, record)


def percentile(values, q: float) -> float:
    """The ``q`` quantile, linear between order statistics (numpy's
    default), never beyond the largest value."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))

