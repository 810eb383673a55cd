"""The motion-module training cells: back-to-back steps of the port's
``training/loop.train_loop`` with ``training/step.train_step_partitioned``.

The data iterator draws each step's clips from the seed and encodes them
with ``training/step.encode_batch`` inside the window; the loop crops the
frames (temporal multi-scale) and takes the step. Set-up builds the one
training state and drives it through the loop's first ``warmup_steps``
steps, which cover every crop size; the same state and the same loop call
go on into the window. The host syncs with the card only where the window
opens and closes and where a traced part starts or ends, as the port's own
loop does between its log lines. The traffic file (``"driver":
"trainer"``) gives the batch, the clip shape and the ranges of the seeded
inputs.

``correct``: the plain reference (``h100bench/reference``) follows the
loop's first steps and the window's first three in float32 from the same
seeded weights and inputs, working out the crops, the step draws, the
latents and AdamW again:

- ``loss``: the first step's loss relative to the reference's (the later
  steps' losses also swing with which weights round to another bf16
  value after two slightly different updates);
- ``grad``: the first gradient as the optimizer gets it (clipped), worked
  out from AdamW's first moment after one step, leaf by leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference leaf's norm and the median leaf's, worst leaf;
- ``change``: the same for each leaf's change over the first three steps,
  read when the fourth step begins, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (Adam
  moves those by round-off alone);
- ``window_change``: ``change`` over the window's first three steps, the
  masters at the window's start held on the host meanwhile. The window
  does not close before these three steps have run.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from h100bench.harness import draws
from h100bench.harness import trace as tr
from h100bench.harness.metrics import instrumented
from h100bench.harness.weights import DTYPES, port_models, reference_models
from h100bench.reference import ops
from h100bench.reference.sampler import DDIM
from h100bench.reference.train import (
    AdamW,
    clip_loss,
    frame_crops,
    step_draws,
    trainable,
)
from h100bench.reference.vae import VAE_SCALE

CHECKED_STEPS = 3
SMALL_GRAD = 1e-3  # of the median leaf's reference gradient
READINGS = ("program", "control", "half_batch")


class WindowClosed(Exception):
    """Raised by the data iterator when the window has run its length."""


def step_inputs(traffic: dict, seed: int, n: int, device) -> dict:
    """The clips of step ``n``: videos in [-1, 1] (a smooth random field,
    ``video_cells`` across and ``keyframes`` in time, interpolated and
    squashed by tanh), the encoder's posterior noise, prompts, click masks,
    fps and motion scores, drawn on the device from the seed and the
    step."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_037 + 11 * n + 5) % (1 << 62))
    b, f = traffic["batch"], traffic["frames"]
    hh, ww = traffic["height"], traffic["width"]
    h, w = hh // 8, ww // 8
    kw = dict(generator=g, device=device)
    ch, cw = traffic["video_cells"]
    low = torch.randn((b, 3, traffic["keyframes"], ch, cw), **kw)
    video = torch.tanh(torch.nn.functional.interpolate(
        low, size=(f, hh, ww), mode="trilinear", align_corners=True))
    fps = torch.tensor(traffic["fps"], dtype=torch.float32, device=device)
    return dict(
        video=video.permute(0, 2, 3, 4, 1).contiguous(),
        noise=torch.randn((b * f, h, w, 4), **kw),
        ids=draws.prompt_ids(g, b, traffic["prompt_tokens"], device),
        mask=draws.click_masks(g, b, h, w, traffic["mask_area"], device),
        fps=fps[torch.randint(0, len(fps), (b,), **kw)],
        motion=draws.uniform(g, b, traffic["motion_score"], device))


def train_config(config: dict):
    from followyourclick_tpu_torch.training.step import TrainConfig

    t = config["train"]
    return TrainConfig(
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        adam_beta1=t["adam_beta1"], adam_beta2=t["adam_beta2"],
        adam_eps=t["adam_eps"], max_grad_norm=t["max_grad_norm"],
        trainable_modules=tuple(t["trainable_modules"]),
        mask_corruption_rates=tuple(t["mask_corruption_rates"]),
        gradient_checkpointing=t["gradient_checkpointing"])


@dataclasses.dataclass
class Program:
    """The port's training objects: the one state the run trains."""

    state: object
    unet: object
    vae: object
    text: object
    tcfg: object
    sched: object


def build_program(config: dict, seed: int, device) -> Program:
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
    from followyourclick_tpu_torch.training.step import (
        create_partitioned_train_state,
    )

    tcfg = train_config(config)
    models = port_models(config, seed, device)
    for m in models.values():
        m.requires_grad_(False)
    unet = models["unet"]
    state = create_partitioned_train_state(
        unet, tcfg, frozen_dtype=DTYPES[config["dtype"]])
    unet.to("meta")  # the state holds every tensor the step reads
    cfg = InferenceConfig.from_dict(config)
    return Program(state, unet, models["vae"].eval(), models["text"].eval(),
                   tcfg, DDIMSchedule.create(cfg.noise_scheduler, 25))


def make_batch(prog: Program, traffic: dict, seed: int, n: int, device):
    from followyourclick_tpu_torch.training.step import (
        TrainBatch,
        encode_batch,
    )

    x = step_inputs(traffic, seed, n, device)
    dtype = next(prog.vae.parameters()).dtype
    latents = encode_batch(prog.vae, x["video"].to(dtype),
                           noise=x["noise"]).float()
    return TrainBatch(latents, x["ids"], x["mask"], x["fps"], x["motion"])


class Feed:
    """The loop's data iterator, and the run's clock: it opens the window
    after the set-up steps, starts and stops the profiler for the traced
    steps, reads what the check needs between steps, and closes the window
    at the first step boundary after ``seconds`` (and after the checked
    steps of the window)."""

    def __init__(self, prog, cell, seed, seconds, traced, t_start, device):
        self.prog, self.cell, self.seed = prog, cell, seed
        self.seconds, self.traced, self.t_start = seconds, traced, t_start
        self.device = device
        self.n = 0
        self.warmup = cell.own["warmup_steps"]
        if self.warmup < CHECKED_STEPS:
            raise ValueError(f"warmup_steps has to be {CHECKED_STEPS} or "
                             "more: the first checked steps are set-up's")
        self.plan = tr.TracePlan(
            cell.own["trace_detail"], cell.own["trace_timeline"],
            self._ranges) if traced else None
        self.t_open = self.t_close = None
        self.window_steps = 0
        self.step_frames = []       # frames trained by each step
        self.losses = []            # the first step's loss
        self.norms = {}             # number → (leaf names, norms on device)
        self.held = None            # masters the next change is taken from
        self.setup_peak = 0

    def step_fn(self, state, batch, generator):
        from followyourclick_tpu_torch.training.step import (
            train_step_partitioned,
        )

        p = self.prog
        state, metrics = train_step_partitioned(
            state, batch, generator, unet=p.unet, text_encoder=p.text,
            sched=p.sched, cfg=p.tcfg)
        self.step_frames.append(batch.latents.shape[0]
                                * batch.latents.shape[1])
        if not self.losses:
            self.losses.append(metrics["loss"].detach())
        return state, metrics

    def _ranges(self):
        return instrumented(self.cell, state=self.prog.state)

    def _sync(self):
        torch.cuda.synchronize(self.device)

    def _read_checks(self, n: int, state) -> None:
        """What the check reads as step ``n`` begins, left on the device:
        the masters the changes start from (the first step's in the type
        the weights were made in, so the copy is exact; the window's on
        the host), the first gradient, and each change."""
        masters = state.trainable
        if n == 0:
            dtype = DTYPES[self.cell.config["dtype"]]
            self.held = {k: v.to(dtype, copy=True)
                         for k, v in masters.items()}
        if n == 1:
            b1 = self.prog.tcfg.adam_beta1
            self.norms["grad"] = leaf_norms(
                state.opt_state["mu"], lambda k, m: m.float() / (1 - b1))
        if n in (CHECKED_STEPS, self.warmup + CHECKED_STEPS):
            key = "change" if n == CHECKED_STEPS else "window_change"
            held = self.held
            self.norms[key] = leaf_norms(masters, lambda k, v: v - held[k].to(
                self.device, non_blocking=True).float())
            self.held = None
        if n == self.warmup:
            pin = torch.device(self.device).type == "cuda"
            self.held = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=pin).copy_(v)
                         for k, v in masters.items()}

    def __iter__(self):
        return self

    def __next__(self):
        n = self.n
        self._read_checks(n, self.prog.state)
        i = n - self.warmup  # the window's step that begins now
        if i == 0:
            if self.plan:
                self.plan.warm(self.device)
            self._sync()
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.t_open = time.perf_counter()
        elif i > 0:
            if self.plan and i in (self.plan.n_timeline,
                                   self.plan.n_timeline
                                   + self.plan.n_detail):
                self._sync()  # a traced part ends with this step
            now = time.perf_counter()
            if self.plan:
                frames = self.step_frames[n - 1]
                self.plan.after(i - 1, now, {
                    "kind": "step", "frames": frames,
                    "clip_frames": frames // self.cell.traffic["batch"]})
            if now - self.t_open >= self.seconds and i >= CHECKED_STEPS:
                self._sync()
                self.t_close = time.perf_counter()
                self.window_steps = i
                raise WindowClosed
        if i >= 0 and self.plan:
            self.plan.before(i)
        self.n += 1
        return make_batch(self.prog, self.cell.traffic, self.seed, n,
                          self.device)

    def checked(self) -> dict:
        """What the program's checked steps gave, on the host."""
        out = {k: dict(zip(names, norms.double().cpu().tolist()))
               for k, (names, norms) in self.norms.items()}
        out["losses"] = [float(x) for x in self.losses]
        return out


def leaf_norms(tensors: dict, of=lambda k, v: v):
    """``(names, norms)``: the norm of ``of(name, leaf)`` for each leaf,
    one leaf at a time, left on the device."""
    names = sorted(tensors)
    return names, torch.stack([
        torch.linalg.vector_norm(of(k, tensors[k]).float()) for k in names])


def host_norms(tensors: dict, of=lambda k, v: v) -> dict:
    names, norms = leaf_norms(tensors, of)
    return dict(zip(names, norms.double().cpu().tolist()))


# ---------------------------------------------------------------- reference


def reference_steps(config: dict, traffic: dict, seed: int, warmup: int,
                    device, prec: ops.Precision = ops.FP32,
                    fault: str = "") -> dict:
    """The loop's first ``warmup`` steps and the window's first three in
    plain PyTorch: per-step losses, the first (clipped) gradient's leaf
    norms, and the change of each leaf over the first three steps and
    over the window's first three. The arithmetic is float32; the forward
    reads the weights the configuration's mixed precision gives it, the
    trainable leaves' float32 masters rounded to the served dtype at each
    step (an update under half of that dtype's step does not reach the
    forward), and AdamW updates the masters. ``prec`` float8 is the
    control; ``fault`` plants a fault in the reference put in the
    program's place ("half_batch": the loss is the mean over the first
    half of the batch)."""
    t = config["train"]
    models = reference_models(config, seed, device)
    unet, vae, text = models["unet"], models["vae"], models["text"]
    unet.checkpoint_blocks = True
    for m in models.values():
        ops.set_precision(m, prec)
    names = [n for n, _ in unet.named_parameters()
             if trainable(n, t["trainable_modules"])]
    params = dict(unet.named_parameters())
    for n, p in params.items():
        p.requires_grad_(n in names)
    masters = {n: params[n].detach().clone() for n in names}
    held = {n: m.clone() for n, m in masters.items()}
    served = DTYPES[config["dtype"]]
    ddim = DDIM(config["noise_scheduler"], 25)
    opt = AdamW(t["learning_rate"], t["adam_beta1"], t["adam_beta2"],
                t["adam_eps"], t["weight_decay"], t["max_grad_norm"])
    crops = frame_crops(warmup + CHECKED_STEPS, traffic["frames"],
                        t["min_frames"])
    out = dict(losses=[])
    for n, (c0, nf) in enumerate(crops):
        if n == CHECKED_STEPS:
            out["change"] = host_norms(masters, lambda k, v: v - held[k])
        if n == warmup:
            held = {k: m.clone() for k, m in masters.items()}
        x = step_inputs(traffic, seed, n, device)
        b = traffic["batch"]
        with torch.no_grad():
            for k in names:
                params[k].copy_(masters[k].to(served).float())
            frames = x["video"].to(served).float()
            lat = []
            for i in range(b):
                mean, logvar = vae.encode(frames[i])
                eps = x["noise"][i * traffic["frames"]:
                                 (i + 1) * traffic["frames"]]
                lat.append((mean + torch.exp(0.5 * logvar) * eps)
                           * VAE_SCALE)
            latents = torch.stack(lat)[:, c0:c0 + nf]
            context = text(x["ids"])
        drawn = step_draws(seed, n, tuple(latents.shape),
                           len(t["mask_corruption_rates"]),
                           config["noise_scheduler"]["num_train_timesteps"],
                           device)
        rows = range(b // 2) if fault == "half_batch" else range(b)
        grads = {k: torch.zeros_like(params[k]) for k in names}
        total = 0.0
        for i in rows:
            one = tuple(d[i:i + 1] for d in drawn)
            loss = clip_loss(unet, ddim, latents[i:i + 1], context[i:i + 1],
                             x["mask"][i:i + 1], x["fps"][i:i + 1],
                             x["motion"][i:i + 1], one,
                             t["mask_corruption_rates"]) / len(rows)
            got = torch.autograd.grad(loss, [params[k] for k in names])
            for k, g in zip(names, got):
                grads[k] += g
            total += float(loss.detach())
        out["losses"].append(total)
        norm = opt.update(masters, grads)
        if n == 0:
            scale = min(1.0, t["max_grad_norm"] / norm)
            out["grad"] = host_norms(grads, lambda k, g: g * scale)
    out["window_change"] = host_norms(masters, lambda k, v: v - held[k])
    return out


def compare(program: dict, reference: dict) -> dict:
    """The numbers of the program's checked steps against the
    reference's."""
    g_ref = reference["grad"]
    g_med = float(torch.tensor(list(g_ref.values())).median())

    def worst(key, keep):
        prog, ref = program[key], reference[key]
        med = float(torch.tensor([ref[k] for k in keep]).median())
        return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)

    leaves = sorted(g_ref)
    moving = [k for k in leaves if g_ref[k] >= SMALL_GRAD * g_med]
    p, r = program["losses"][0], reference["losses"][0]
    return {"loss": abs(p - r) / abs(r), "grad": worst("grad", leaves),
            "change": worst("change", moving),
            "window_change": worst("window_change", moving)}


# ---------------------------------------------------------------- the run


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda") -> dict:
    from followyourclick_tpu_torch.training.loop import (
        LoopConfig,
        train_loop,
    )

    t = cell.config["train"]
    prog = build_program(cell.config, seed, device)
    feed = Feed(prog, cell, seed, seconds, traced, t_start, device)
    with tempfile.TemporaryDirectory() as out_dir:
        loop = LoopConfig(output_dir=os.path.join(out_dir, "train"),
                          max_train_steps=1 << 40,
                          checkpointing_steps=1 << 40, log_every=1 << 40,
                          need_resume=False,
                          temporal_multi_scale=t["temporal_multi_scale"],
                          min_frames=t["min_frames"])
        try:
            train_loop(prog.state, feed, feed.step_fn, loop, seed=seed)
        except WindowClosed:
            pass
    window_s = feed.t_close - feed.t_open
    w = feed.warmup
    frames = feed.step_frames[w:w + feed.window_steps]
    peak_window = torch.cuda.max_memory_allocated(device)
    if feed.plan:
        feed.plan.close()
    metrics = {"train_frames_per_s": sum(frames) / window_s,
               "setup_s": feed.t_open - t_start}
    out = dict(metrics=metrics, attempted=feed.window_steps, failed=0,
               peak=max(peak_window, feed.setup_peak),
               window_peak=peak_window, window_s=window_s, trace=feed.plan)
    program = feed.checked()
    del feed, prog
    torch.cuda.empty_cache()
    with ops.ieee_fp32():
        reference = reference_steps(cell.config, cell.traffic, seed, w,
                                    device)
    out["numbers"] = compare(program, reference)
    return out


def readings(cell, seed: int, what: str, device="cuda") -> dict:
    """The checked numbers of ``what`` on ``seed``: ``program``, a run
    whose window holds just the checked steps, judged as the cell's runs
    judge theirs; ``control``, the reference in float8 in the program's
    place; ``half_batch``, the float32 reference with half of the batch
    left out, the mean taken over the rest, in the program's place."""
    if what == "program":
        return run(cell, seed, 0.0, False, time.perf_counter(),
                   device)["numbers"]
    w = cell.own["warmup_steps"]
    with ops.ieee_fp32():
        key = (cell.name, seed)
        if key not in _REFERENCE:
            _REFERENCE.clear()
            _REFERENCE[key] = reference_steps(cell.config, cell.traffic,
                                              seed, w, device)
        got = reference_steps(
            cell.config, cell.traffic, seed, w, device,
            prec=ops.Precision("fp8") if what == "control" else ops.FP32,
            fault="" if what == "control" else what)
    return compare(got, _REFERENCE[key])


_REFERENCE = {}  # the last seed's float32 reference, for its readings
