"""DDIM scheduler over precomputed fp32 tables.

Port of ``followyourclick_tpu/schedulers/ddim.py`` (itself the reference's
diffusers 0.11.1 ``scheduling_ddim.py`` with the zero-terminal-SNR patch).
The tables are fp32. ``torch.linspace`` may differ from ``jnp.linspace`` in
the last bit of a float entry; the integer timestep grid is exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig


def make_beta_schedule(cfg: NoiseScheduleConfig) -> torch.Tensor:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return torch.linspace(cfg.beta_start, cfg.beta_end, t,
                              dtype=torch.float32)
    if cfg.beta_schedule == "scaled_linear":
        return torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, t,
                              dtype=torch.float32) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        steps = torch.arange(t + 1, dtype=torch.float32) / t

        def alpha_bar(x):
            return torch.cos((x + 0.008) / 1.008 * math.pi / 2) ** 2

        return torch.clamp(1 - alpha_bar(steps[1:]) / alpha_bar(steps[:-1]),
                           max=0.999)
    raise NotImplementedError(cfg.beta_schedule)


def rescale_zero_terminal_snr(betas: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 of arXiv 2305.08891."""
    alphas_bar_sqrt = torch.sqrt(torch.cumprod(1.0 - betas, dim=0))
    a0, at = alphas_bar_sqrt[0].clone(), alphas_bar_sqrt[-1].clone()
    alphas_bar_sqrt = (alphas_bar_sqrt - at) * (a0 / (a0 - at))
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = torch.cat([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


@dataclass(frozen=True)
class DDIMSchedule:
    """fp32 tables (on the CPU) and the descending int64 timestep grid."""

    alphas_cumprod: torch.Tensor      # (T,)
    final_alpha_cumprod: float
    timesteps: torch.Tensor           # (S,)
    cfg: NoiseScheduleConfig
    num_inference_steps: int

    @classmethod
    def create(cls, cfg: NoiseScheduleConfig,
               num_inference_steps: int) -> "DDIMSchedule":
        if cfg.timestep_spacing != "leading":
            raise NotImplementedError(cfg.timestep_spacing)
        betas = make_beta_schedule(cfg)
        if cfg.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        final = 1.0 if cfg.set_alpha_to_one else float(alphas_cumprod[0])
        step_ratio = cfg.num_train_timesteps // num_inference_steps
        timesteps = (torch.arange(num_inference_steps) * step_ratio).flip(0) \
            + cfg.steps_offset
        return cls(alphas_cumprod, final, timesteps, cfg, num_inference_steps)


def ddim_step(sched: DDIMSchedule, model_output: torch.Tensor,
              step_index: int, sample: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One reverse step at loop position ``step_index`` (0 = most noisy);
    returns ``(prev_sample, pred_original_sample)`` in the sample's dtype."""
    cfg = sched.cfg
    t = int(sched.timesteps[step_index])
    prev_t = t - cfg.num_train_timesteps // sched.num_inference_steps
    orig_dtype = sample.dtype
    sample = sample.float()
    model_output = model_output.float()

    ac = sched.alphas_cumprod
    alpha_prod_t = ac[t]
    alpha_prod_t_prev = (ac[prev_t] if prev_t >= 0 else
                         torch.tensor(sched.final_alpha_cumprod,
                                      dtype=torch.float32))
    beta_prod_t = 1.0 - alpha_prod_t
    sqrt_a, sqrt_b = torch.sqrt(alpha_prod_t), torch.sqrt(beta_prod_t)
    sqrt_a, sqrt_b = sqrt_a.to(sample.device), sqrt_b.to(sample.device)

    if cfg.prediction_type == "epsilon":
        pred_original = (sample - sqrt_b * model_output) / sqrt_a
        pred_epsilon = model_output
    elif cfg.prediction_type == "sample":
        # upstream 0.11.1 quirk (reference scheduling_ddim.py:345)
        pred_original = model_output
        pred_epsilon = model_output
    elif cfg.prediction_type == "v_prediction":
        pred_original = sqrt_a * sample - sqrt_b * model_output
        pred_epsilon = sqrt_a * model_output + sqrt_b * sample
    else:
        raise ValueError(cfg.prediction_type)
    if cfg.clip_sample:
        pred_original = pred_original.clamp(-1.0, 1.0)

    beta_prod_t_prev = 1.0 - alpha_prod_t_prev
    variance = (beta_prod_t_prev / beta_prod_t) * (
        1.0 - alpha_prod_t / alpha_prod_t_prev)
    std_dev_t = eta * torch.sqrt(torch.clamp(variance, min=0.0))
    direction = torch.sqrt(torch.clamp(
        1.0 - alpha_prod_t_prev - std_dev_t ** 2, min=0.0))
    prev = (torch.sqrt(alpha_prod_t_prev).to(sample.device) * pred_original
            + direction.to(sample.device) * pred_epsilon)
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        prev = prev + std_dev_t.to(sample.device) * noise.float()
    return prev.to(orig_dtype), pred_original.to(orig_dtype)


def _extract(sched: DDIMSchedule, timesteps: torch.Tensor,
             ndim: int) -> torch.Tensor:
    vals = sched.alphas_cumprod[timesteps.cpu().long()]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))


def add_noise(sched: DDIMSchedule, original_samples: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(ᾱ_t)·x_0 + sqrt(1-ᾱ_t)·ε."""
    a = _extract(sched, timesteps, original_samples.ndim).to(
        original_samples.device)
    return (torch.sqrt(a) * original_samples.float()
            + torch.sqrt(1.0 - a) * noise.float()).to(original_samples.dtype)


def get_velocity(sched: DDIMSchedule, sample: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """v = sqrt(ᾱ_t)·ε − sqrt(1−ᾱ_t)·x_0."""
    a = _extract(sched, timesteps, sample.ndim).to(sample.device)
    return (torch.sqrt(a) * noise.float()
            - torch.sqrt(1.0 - a) * sample.float()).to(sample.dtype)
