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
``__graft_entry__.dryrun_multichip``: over ``n`` processes on JAX's
``(data, model)`` grid, one training step and one serving request with the
UNet and the VAE tensor-parallel over ``model`` and the clips over
``data``.
"""

from __future__ import annotations

import math

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


def dryrun_grid(n_devices: int) -> tuple:
    """``(data, model)`` of the JAX dry run's mesh over ``n_devices``
    (``__graft_entry__.py:172``): two model ranks when ``n_devices`` is
    even, the rest on ``data``."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model, model


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> dict:
    """Start ``n_devices`` processes that form one group (NCCL, one card a
    process, on the card; gloo when the caller asks for the CPU) on JAX's
    ``(data, model)`` grid (:func:`dryrun_grid`), and in each run
    :func:`dryrun_run`: one ``train_step_partitioned`` of the tiny
    two-level UNet, tensor-parallel over ``model``, over a global batch of
    one clip a data rank, then a 2-step request of those clips through
    ``AnimationPipeline(mesh=)``. Rank 0 prints the JAX dry run's two
    lines (``mesh=``, with ``backend=`` added); returns its numbers. The
    children import the port only."""
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

    from followyourclick_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(*dryrun_grid(n_devices), group=dist.group.WORLD)
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    return dryrun_run(mesh, device)


def dryrun_run(mesh, device: torch.device, batch: int | None = None
               ) -> dict:
    """The dry run on ``mesh`` (``parallel/mesh.create_mesh``; a one-process
    mesh runs it alone): the tiny models seeded alike on every rank, the
    UNet sharded over ``model``, one partitioned train step over a global
    batch of ``batch`` clips (``mesh.shape['data']`` by default, one a data
    rank) with the step's draws made at its shape, then the trained UNet in
    a 2-step request of ``batch`` clips. Rank 0 prints the two lines."""
    import torch.distributed as dist

    from followyourclick_tpu_torch.config import (
        InferenceConfig,
        NoiseScheduleConfig,
    )
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.parallel.sharding import (
        shard_batch,
        shard_params,
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

    grouped = mesh.group is not None
    rank = dist.get_rank(mesh.group) if grouped else 0
    backend = dist.get_backend(mesh.group) if grouped else "none"
    n_ranks = mesh.data_size * mesh.model_size
    tcfg, ucfg, vcfg = dryrun_configs()
    torch.manual_seed(0)
    with torch.device(device):
        unet = UNet3DConditionModel(ucfg)
        text = CLIPTextModel(tcfg)
    text = text.to(torch.bfloat16 if device.type == "cuda"
                   else torch.float32).eval()
    shard_params(unet, mesh)
    f, h, w = DRYRUN_CLIP
    b = mesh.data_size if batch is None else batch
    gen = torch.Generator().manual_seed(0)
    latents = torch.randn(b, f, h, w, 4, generator=gen)
    batch_rows = shard_batch(TrainBatch(
        latents=latents, input_ids=torch.zeros(b, 77, dtype=torch.long),
        mask=torch.ones(b, h, w, 1), fps=torch.full((b,), 8.0),
        motion_score=torch.full((b,), 20.0)), mesh)
    batch_rows = TrainBatch(*(t.to(device) for t in (
        batch_rows.latents, batch_rows.input_ids, batch_rows.mask,
        batch_rows.fps, batch_rows.motion_score)))
    cfg = TrainConfig(gradient_checkpointing=True)
    state = create_partitioned_train_state(unet, cfg, mesh=mesh)
    state, metrics = train_step_partitioned(
        state, batch_rows, torch.Generator(device=device).manual_seed(1),
        unet=unet, text_encoder=text,
        sched=DDIMSchedule.create(NoiseScheduleConfig(), 25), cfg=cfg,
        mesh=mesh)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (state.step == 1 and torch.isfinite(torch.tensor(loss))):
        raise RuntimeError(f"rank {rank}: step {state.step}, loss {loss}")
    grid = dict(mesh.shape)
    lines = [f"dryrun_multichip({n_ranks}): mesh={grid} loss={loss:.4f} "
             f"grad_norm={grad_norm:.4f} backend={backend}"]

    # the serving microstep: the trained UNet and a TP-sharded VAE in the
    # sampler over the mesh, the request's clips dealt over 'data'
    with torch.no_grad():
        params = dict(unet.named_parameters())
        for n, t in state.trainable.items():
            params[n].copy_(t)
    torch.manual_seed(1)
    with torch.device(device):
        vae = AutoencoderKL(vcfg)
    pipe = AnimationPipeline(InferenceConfig(unet=ucfg, vae=vcfg,
                                             clip_text=tcfg),
                             unet=unet, vae=vae, text_encoder=text,
                             device=device, mesh=mesh)
    spec = SampleSpec(video_length=f, height=8 * 8, width=8 * 8,
                      num_inference_steps=DRYRUN_STEPS, guidance_scale=7.5)
    noise = torch.randn(b, f, 8, 8, 4, generator=gen)
    ids = torch.zeros(b, 77, dtype=torch.long)
    video = pipe.sample(ids, ids, torch.zeros(b, 8, 8, 4),
                        torch.ones(b, 8, 8, 1), torch.full((b,), 8.0),
                        torch.full((b,), 20.0), spec, noise=noise)
    shape = (b, f, 64, 64, 3)
    if tuple(video.shape) != shape:
        raise RuntimeError(f"rank {rank}: video {tuple(video.shape)}")
    checksum = float(video.double().sum())
    if not math.isfinite(checksum):
        raise RuntimeError(f"checksum {checksum}")
    lines.append(f"dryrun_multichip({n_ranks}): sharded-serving "
                 f"checksum={checksum:.4f} video={shape} backend={backend}")
    if rank == 0:
        for line in lines:
            print(line, flush=True)
    return {"loss": loss, "grad_norm": grad_norm, "checksum": checksum,
            "lines": lines, "backend": backend, "mesh": grid,
            "video": video.cpu()}
