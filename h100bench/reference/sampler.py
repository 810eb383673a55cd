"""DDIM with v-prediction, zero terminal SNR and classifier-free guidance,
and the click conditioning, in plain PyTorch.

From diffusers 0.11's ``DDIMScheduler`` (``leading`` spacing, ``steps_offset``
1, ``set_alpha_to_one``), the zero-terminal-SNR rescale of arXiv 2305.08891
(Algorithm 1) and Follow-Your-Click's sampler: the first frame's noise on
every frame, the click mask and the first-frame latent beside the latents
on the channel axis. The tables are worked out in float64.
"""

from __future__ import annotations

import math

import torch

from h100bench.reference.vae import VAE_SCALE


class DDIM:
    def __init__(self, nsc: dict, steps: int):
        if nsc["beta_schedule"] != "linear" or \
                nsc["prediction_type"] != "v_prediction":
            raise ValueError("the reference knows linear betas and "
                             "v-prediction only")
        t = nsc["num_train_timesteps"]
        betas = torch.linspace(nsc["beta_start"], nsc["beta_end"], t,
                               dtype=torch.float64)
        abar = torch.cumprod(1.0 - betas, dim=0)
        if nsc["rescale_betas_zero_snr"]:
            s = abar.sqrt()
            s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
            abar = s ** 2
        self.alphas_cumprod = abar
        self.ratio = t // steps
        self.timesteps = [i * self.ratio + nsc["steps_offset"]
                          for i in reversed(range(steps))]

    def alpha(self, t: int) -> float:
        return 1.0 if t < 0 else float(self.alphas_cumprod[t])

    def step(self, v: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
        """x_{t_prev} from x_t and the v-prediction (η = 0)."""
        t = self.timesteps[i]
        a, a_prev = self.alpha(t), self.alpha(t - self.ratio)
        x, v = x.double(), v.double()
        x0 = math.sqrt(a) * x - math.sqrt(1 - a) * v
        eps = math.sqrt(a) * v + math.sqrt(1 - a) * x
        return (math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps).float()


def initial_latents(noise: torch.Tensor) -> torch.Tensor:
    """``noise`` (B, F, h, w, 4) → the first frame's noise on every frame."""
    return noise[:, :1].expand(noise.shape).float()


def condition_channels(first_latent: torch.Tensor, mask: torch.Tensor,
                       frames: int) -> torch.Tensor:
    """(B, F, h, w, 5): the click mask on every frame, then the first-frame
    latent on frame 0 and zeros after it."""
    b, h, w, c = first_latent.shape
    first = torch.zeros(b, frames, h, w, c, device=first_latent.device)
    first[:, 0] = first_latent.float()
    m = mask.float().clamp(0.0, 1.0)[:, None].expand(b, frames, h, w, 1)
    return torch.cat([m, first], dim=-1)


def guided(out: torch.Tensor, scale: float) -> torch.Tensor:
    """[uncond; cond] → uncond + scale · (cond − uncond)."""
    u, c = out.float().chunk(2, dim=0)
    return u + scale * (c - u)


def to_video(image: torch.Tensor) -> torch.Tensor:
    """Decoder output in [-1, 1] → the video's [0, 1]."""
    return (image.float() / 2 + 0.5).clamp(0.0, 1.0)


def decode(vae, latents: torch.Tensor, frames_per_call: int = 4
           ) -> torch.Tensor:
    """(B, F, h, w, 4) scaled latents → video (B, F, H, W, 3) in [0, 1],
    a few frames a call."""
    b, f = latents.shape[:2]
    z = (latents.float() / VAE_SCALE).reshape(b * f, *latents.shape[2:])
    out = torch.cat([vae.decode(z[s:s + frames_per_call])
                     for s in range(0, b * f, frames_per_call)])
    return to_video(out).reshape(b, f, *out.shape[1:])
