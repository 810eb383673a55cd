"""Serving-schedule drift harness: how far an opt-in serving approximation
(PAB attention reuse, DeepCache trunk reuse, CFG-uncond caching) moves the
video from the exact sampler's.

Port of ``followyourclick_tpu/utils/quality.py:22-145``: the tiny and
flagship random-init pipelines, one request with fixed random conditioning,
and the relative-L2 / PSNR drift. The JAX module's v5e step-cost model is
fitted to TPU timings and is not ported. The conditioning and the initial
noise are drawn on the CPU from fixed keys (:class:`TorchDraws`), so a
request is the same on every device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def tiny_unet_cfg():
    from followyourclick_tpu_torch.config import (
        MotionModuleConfig,
        UNet3DConfig,
    )

    return UNet3DConfig(
        sample_size=32, cross_attention_dim=768, attention_head_dim=8,
        block_out_channels=(32, 64, 64, 64), layers_per_block=1,
        norm_num_groups=8,
        motion_module=MotionModuleConfig(num_attention_heads=4),
        use_fps_condition=True,
        use_first_frame_mask_condition_concat=True)


def build_quality_pipeline(size: str = "tiny",
                           dtype: torch.dtype = torch.float32,
                           seed: int = 0, device: str = "cuda"):
    """A random-init pipeline for drift measurement (the port's own
    initialisation from ``torch.manual_seed(seed)``; not zeros, which
    would make every schedule give the same video). ``size="flagship"`` is
    the default ``InferenceConfig`` (1.28 B UNet parameters), built on
    ``device``."""
    from followyourclick_tpu_torch.config import (
        CLIPTextConfig,
        InferenceConfig,
        VAEConfig,
    )
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    if size == "tiny":
        cfg = InferenceConfig(
            unet=tiny_unet_cfg(),
            vae=VAEConfig(block_out_channels=(32, 64, 64, 64),
                          layers_per_block=1, norm_num_groups=8,
                          sample_size=64),
            clip_text=CLIPTextConfig(vocab_size=1000, hidden_size=768,
                                     intermediate_size=512,
                                     num_hidden_layers=2,
                                     num_attention_heads=4))
    elif size == "flagship":
        cfg = InferenceConfig()
    else:
        raise ValueError(size)
    torch.manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(cfg.unet)
        vae = AutoencoderKL(cfg.vae)
        text = CLIPTextModel(cfg.clip_text)
    return AnimationPipeline(cfg, unet, vae, text, device=device,
                             dtype=dtype)


class TorchDraws:
    """The harness's random draws, each from a CPU ``torch.Generator``
    seeded with its key, so a request is the same on every device. Another
    source (the JAX package's ``jax.random`` draws, to hold the harness to
    the JAX one) gives the same three functions."""

    @staticmethod
    def normal(key: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=torch.Generator().manual_seed(key))

    @staticmethod
    def uniform(key: int, shape) -> torch.Tensor:
        return torch.rand(shape, generator=torch.Generator().manual_seed(key))

    @staticmethod
    def randint(key: int, shape, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, shape,
                             generator=torch.Generator().manual_seed(key))


def run_schedule(pipe, spec, frames: int, latent_hw: Tuple[int, int],
                 seed: int = 3, draws=TorchDraws) -> np.ndarray:
    """One ``sample`` request with random but fixed conditioning (first-
    frame latent, click mask, prompt ids from keys 7, 8, 9 of ``draws``;
    the initial noise from key ``seed``) → the video as fp32 numpy."""
    h, w = latent_hw
    first = torch.as_tensor(draws.normal(7, (1, h, w, 4))) * 0.2
    mask = (torch.as_tensor(draws.uniform(8, (1, h, w, 1))) > 0.5).float()
    prompt_ids = torch.as_tensor(draws.randint(9, (1, 77), 0, 1000)).long()
    noise = torch.as_tensor(draws.normal(seed, (1, frames, h, w, 4)))
    out = pipe.sample(prompt_ids, torch.zeros_like(prompt_ids),
                      first.to(pipe.dtype), mask.to(pipe.dtype),
                      torch.full((1,), 8.0), torch.full((1,), 20.0),
                      spec=spec, noise=noise)
    return out.float().cpu().numpy()


def drift_metrics(approx: np.ndarray, exact: np.ndarray) -> Dict[str, float]:
    """Relative L2 and PSNR (dB, peak 1) of ``approx`` against ``exact``."""
    diff = approx - exact
    rel_l2 = float(np.linalg.norm(diff) / (np.linalg.norm(exact) + 1e-12))
    psnr = 10 * math.log10(1.0 / max(float(np.mean(diff ** 2)), 1e-20))
    return {"rel_l2": round(rel_l2, 4), "psnr_db": round(psnr, 2)}
