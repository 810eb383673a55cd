"""Seeded weights, made on the device in the type they are served in.

One normal draw fills a flat buffer for every leaf of a model; each leaf is
a view of it, scaled in place:

- a matrix or kernel (2-D and up): standard deviation 1/√(3·fan_in), the
  variance of PyTorch's default ``Linear`` / ``Conv`` init;
- a bias: the same scale as its weight;
- a norm's weight: 1 + 0.02·n, its bias 0.02·n;
- a token or position embedding table: 0.02·n;
- a layer the model starts at zero (motion-module ``proj_out``, the fps and
  motion-score embeddings' ``linear_2``): weight 0.02·n and bias 0, so
  that the motion modules and the embeddings reach the output, as a
  trained model's do.

The same seed gives the same tensors on the same device, so the program and
the reference each take them from here.
"""

from __future__ import annotations

import math

import torch

# the embeddings whose output layer a fresh model holds at zero (the
# motion modules' proj_out is the third such layer)
ZERO_INIT_EMBEDDINGS = ("fps_embedding.linear_2", "motion_embedding.linear_2")
ALIGN = 64  # elements between the starts of two leaves
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the stream each model draws its seeded weights from
STREAMS = {"unet": 0, "vae": 1, "text": 2}


def _zero_init(name: str) -> bool:
    owner = name.rsplit(".", 1)[0]
    if owner.endswith("proj_out"):
        return "motion_modules" in owner.split(".")
    return owner.endswith(ZERO_INIT_EMBEDDINGS)


def seeded_state(shapes: dict, seed: int, device, dtype=torch.bfloat16,
                 stream: int = 0) -> dict:
    """Name → tensor for every ``name: shape`` of ``shapes``, from
    ``seed`` (and ``stream``, one per model)."""
    names = sorted(shapes)  # the same tensors whatever order a model lists
    offsets, total = [], 0
    for n in names:  # each leaf 128-byte aligned, as kernels want it
        offsets.append(total)
        total += -(-math.prod(shapes[n]) // ALIGN) * ALIGN
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + stream) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    fan_in = {n.rsplit(".", 1)[0]: math.prod(s[1:])
              for n, s in shapes.items()
              if n.endswith(".weight") and len(s) >= 2}
    out = {}
    with torch.no_grad():
        for name, at in zip(names, offsets):
            shape = shapes[name]
            t = flat[at:at + math.prod(shape)].view(shape)
            owner, leaf = name.rsplit(".", 1)
            if _zero_init(name):
                t.mul_(0.02 if leaf == "weight" else 0.0)
            elif owner.endswith(("token_embedding", "position_embedding")):
                t.mul_(0.02)
            elif len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(3 * fan_in[owner]))
            elif leaf == "bias" and owner in fan_in:
                t.mul_(1.0 / math.sqrt(3 * fan_in[owner]))
            elif leaf == "weight":  # a norm's scale
                t.mul_(0.02).add_(1.0)
            else:                   # a norm's shift
                t.mul_(0.02)
            out[name] = t
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def _seeded(models: dict, seed: int, device, dtype, widen: bool) -> dict:
    for name, m in models.items():
        state = seeded_state(shapes_of(m), seed, device, dtype,
                             STREAMS[name])
        if widen:
            state = {k: v.float() for k, v in state.items()}
        m.load_state_dict(state, assign=True)
        del state
    return models


def port_models(config: dict, seed: int, device) -> dict:
    """The port's UNet, VAE and CLIP text encoder at ``config``, built on
    the meta device and given the seeded tensors in the served dtype."""
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL

    cfg = InferenceConfig.from_dict(config)
    with torch.device("meta"):
        models = {"unet": UNet3DConditionModel(cfg.unet),
                  "vae": AutoencoderKL(cfg.vae),
                  "text": CLIPTextModel(cfg.clip_text)}
    return _seeded(models, seed, device, DTYPES[config["dtype"]], False)


def reference_models(config: dict, seed: int, device) -> dict:
    """The reference's UNet, VAE and CLIP in float32, holding the seeded
    weights the program was given (drawn again from the seed, in the
    served dtype, then widened)."""
    from h100bench.reference.unet import UNet3D
    from h100bench.reference.vae import VAE, CLIPText

    with torch.device("meta"):
        models = {"unet": UNet3D(config), "vae": VAE(config),
                  "text": CLIPText(config)}
    return _seeded(models, seed, device, DTYPES[config["dtype"]], True)
