"""One CFG UNet3D step of the flagship configuration, as a callable.

The port's counterpart of ``__graft_entry__.entry``: the full SD-1.5 widths
with the motion modules and the 9-channel mask-conditioned ``conv_in``
(``UNet3DConfig()``), one clip of 8 frames at 32² latents (256²), the
context at the CFG-doubled batch (prefix sharing: the stem runs once and the
UNet duplicates at the first cross-attention). The weights are PyTorch's
default init; the inputs are zeros.

    from followyourclick_tpu_torch.entry import entry
    fn, args = entry()
    out = fn(*args)            # (2, 8, 32, 32, 4)

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: one data-parallel training step and
one serving request over ``n`` processes.
"""

from __future__ import annotations

import torch

from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)


def entry(device: torch.device | str = "cuda"):
    """``(fn, example_args)``: ``fn(sample, timesteps, cond)`` is one
    forward of the UNet on ``device`` (the card unless the caller asks for
    the CPU), in bf16 on the card and fp32 elsewhere."""
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = UNet3DConfig()
    with torch.device(device):
        unet = UNet3DConditionModel(cfg)
    unet = unet.to(dtype).eval()
    b, f, h, w = 1, 8, 32, 32
    sample = torch.zeros(b, f, h, w, UNet3DConditionModel.conv_in_channels(
        cfg), device=device, dtype=dtype)
    timesteps = torch.zeros(b, dtype=torch.int64, device=device)
    cond = UNetConditioning(
        context=torch.zeros(2 * b, 77, cfg.cross_attention_dim,
                            device=device, dtype=dtype),
        fps=torch.full((b,), 8.0, device=device),
        motion_score=torch.full((b,), 20.0, device=device))

    @torch.inference_mode()
    def fn(sample, timesteps, cond):
        return unet(sample, timesteps, cond)

    return fn, (sample, timesteps, cond)


# the JAX dryrun's tiny-but-real topology (__graft_entry__.py:181-190): one
# cross-attention level and one plain level, with the motion modules
DRYRUN_CLIP = (4, 16, 16)  # frames, latent height, latent width
DRYRUN_STEPS = 2


def dryrun_configs():
    """``(CLIPTextConfig, UNet3DConfig, VAEConfig)`` of the dry run."""
    from followyourclick_tpu_torch.config import (
        CLIPTextConfig,
        MotionModuleConfig,
        VAEConfig,
    )

    text = CLIPTextConfig(vocab_size=1000, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4)
    unet = UNet3DConfig(
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
        cross_attention_dim=text.hidden_size,
        motion_module=MotionModuleConfig(num_attention_heads=4))
    vae = VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                    norm_num_groups=8, sample_size=64)
    return text, unet, vae


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> dict:
    """Start ``n_devices`` processes that form one group (NCCL, one card a
    process, on the card; gloo when the caller asks for the CPU), and in
    each take one data-parallel ``train_step_partitioned`` of the tiny
    two-level UNet over a global batch of one clip a rank, then sample a
    2-step request for the rank's own clips (``process_shard``). Rank 0
    prints the JAX dry run's two lines; returns its numbers. The children
    import the port only."""
    from followyourclick_tpu_torch.parallel.data_parallel import launch

    device = torch.device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need {n_devices} cards; "
                         f"this machine has {torch.cuda.device_count()}")
    return launch(_dryrun_rank, n_devices, (n_devices, device.type),
                  backend="nccl" if device.type == "cuda" else "gloo",
                  timeout=600.0)[0]


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from followyourclick_tpu_torch.config import (
        InferenceConfig,
        NoiseScheduleConfig,
    )
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.parallel.data_parallel import shard_rows
    from followyourclick_tpu_torch.parallel.mesh import (
        process_shard,
        rank_world,
    )
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
        SampleSpec,
    )
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
    from followyourclick_tpu_torch.training.step import (
        TrainBatch,
        TrainConfig,
        create_partitioned_train_state,
        train_step_partitioned,
    )

    group = dist.group.WORLD
    rank, world = rank_world()
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    tcfg, ucfg, vcfg = dryrun_configs()
    torch.manual_seed(0)
    with torch.device(device):
        unet = UNet3DConditionModel(ucfg)
        text = CLIPTextModel(tcfg)
    text = text.to(torch.bfloat16 if device.type == "cuda"
                   else torch.float32).eval()
    f, h, w = DRYRUN_CLIP
    b = world  # one clip a rank
    gen = torch.Generator().manual_seed(0)
    latents = torch.randn(b, f, h, w, 4, generator=gen)
    batch = shard_rows(TrainBatch(
        latents=latents, input_ids=torch.zeros(b, 77, dtype=torch.long),
        mask=torch.ones(b, h, w, 1), fps=torch.full((b,), 8.0),
        motion_score=torch.full((b,), 20.0)), rank, world)
    batch = TrainBatch(*(t.to(device) for t in (
        batch.latents, batch.input_ids, batch.mask, batch.fps,
        batch.motion_score)))
    cfg = TrainConfig(gradient_checkpointing=True)
    state = create_partitioned_train_state(unet, cfg, group=group)
    state, metrics = train_step_partitioned(
        state, batch, torch.Generator(device=device).manual_seed(1),
        unet=unet, text_encoder=text,
        sched=DDIMSchedule.create(NoiseScheduleConfig(), 25), cfg=cfg,
        group=group)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (state.step == 1 and torch.isfinite(torch.tensor(loss))):
        raise RuntimeError(f"rank {rank}: step {state.step}, loss {loss}")
    lines = [f"dryrun_multichip({n_devices}): ranks={world} "
             f"backend={backend} loss={loss:.4f} grad_norm={grad_norm:.4f}"]

    # the serving microstep: the trained UNet in the sampler, this rank's
    # clips of the global request (the noise drawn for all of them)
    with torch.no_grad():
        params = dict(unet.named_parameters())
        for n, t in state.trainable.items():
            params[n].copy_(t)
    pipe = AnimationPipeline(InferenceConfig(unet=ucfg, vae=vcfg,
                                             clip_text=tcfg),
                             unet=unet, text_encoder=text, device=device)
    spec = SampleSpec(video_length=f, height=8 * 8, width=8 * 8,
                      num_inference_steps=DRYRUN_STEPS, guidance_scale=7.5)
    clips = list(process_shard(b))
    noise = torch.randn(b, f, 8, 8, 4, generator=gen)[clips]
    n = len(clips)
    ids = torch.zeros(n, 77, dtype=torch.long)
    video = pipe.sample(ids, ids, torch.zeros(n, 8, 8, 4),
                        torch.ones(n, 8, 8, 1), torch.full((n,), 8.0),
                        torch.full((n,), 20.0), spec, noise=noise)
    if tuple(video.shape) != (n, f, 64, 64, 3):
        raise RuntimeError(f"rank {rank}: video {tuple(video.shape)}")
    total = torch.tensor([float(video.double().sum()), float(n)],
                         dtype=torch.float64, device=device)
    dist.all_reduce(total, group=group)
    checksum = float(total[0])
    if not torch.isfinite(total).all():
        raise RuntimeError(f"checksum {checksum}")
    shape = (int(total[1]), f, 64, 64, 3)
    lines.append(f"dryrun_multichip({n_devices}): sharded-serving "
                 f"checksum={checksum:.4f} video={shape}")
    if rank == 0:
        for line in lines:
            print(line, flush=True)
    return {"loss": loss, "grad_norm": grad_norm, "checksum": checksum,
            "lines": lines, "backend": backend}
