"""The motion-module training step in plain PyTorch: v-prediction MSE on
the zero-SNR DDIM schedule with the first-frame masked-latent conditioning
and its random corruption, then ``optax.chain(clip_by_global_norm,
adamw)`` over the trainable leaves.

From AnimateDiff's ``train.py`` with Follow-Your-Click's conditioning (the
reference repository's ``train.py``): noisy latents ``sqrt(ā)·x0 +
sqrt(1−ā)·ε``, target ``v = sqrt(ā)·ε − sqrt(1−ā)·x0``, the click mask on
every frame and the first frame's latent on frame 0, zeroed pixel-wise where
a uniform draw falls under the clip's corruption rate. The loss is the mean
over every element of the batch; a batch is run one clip at a time with
the gradients summed, which gives the same gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference.sampler import DDIM


def trainable(name: str, prefixes) -> bool:
    """A leaf trains when a segment of its name starts with a prefix."""
    return any(seg.startswith(p) for seg in name.split(".") for p in prefixes)


def frame_crops(steps: int, frames: int, min_frames: int, seed: int = 1234):
    """The temporal multi-scale crop ``(start, count)`` of each step: a
    count among (min, (min + F) / 2, F) from ``RandomState(seed)``, then a
    start when the count is not the whole clip."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        nf = int(rng.choice([min_frames, (min_frames + frames) // 2, frames]))
        out.append((0, frames) if nf == frames
                   else (int(rng.randint(0, frames - nf + 1)), nf))
    return out


def step_draws(seed: int, step: int, shape, rates: int, train_t: int,
               device):
    """The draws of step ``step``: a generator on ``device`` seeded with
    ``seed·1000003 + step``; timesteps, noise, corruption-rate index and
    the uniform field, in that order."""
    b, f, h, w, c = shape
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    kw = dict(generator=g, device=device)
    return (torch.randint(0, train_t, (b,), **kw),
            torch.randn((b, f, h, w, c), dtype=torch.float32, **kw),
            torch.randint(0, rates, (b,), **kw),
            torch.rand((b, h, w, 1), **kw))


def clip_loss(unet, ddim: DDIM, latents, context, mask, fps, motion, draws,
              rates):
    """The MSE of one clip (every argument at batch 1), in float32."""
    t, noise, rate_i, uniform = draws
    a = ddim.alphas_cumprod.to(latents.device)[t].float()[:, None, None,
                                                           None, None]
    x0 = latents.float()
    noisy = a.sqrt() * x0 + (1 - a).sqrt() * noise
    target = a.sqrt() * noise - (1 - a).sqrt() * x0
    rate = torch.tensor(rates, device=latents.device)[rate_i]
    keep = (uniform >= rate[:, None, None, None]).float()
    b, f, h, w, _ = x0.shape
    first = torch.zeros_like(x0)
    first[:, 0] = x0[:, 0] * keep
    m = mask.float().clamp(0, 1)[:, None].expand(b, f, h, w, 1)
    pred = unet(torch.cat([noisy, m, first], dim=-1), t, context, fps,
                motion)
    return torch.mean((pred - target) ** 2)


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay))`` over named float32 leaves, in float64 arithmetic."""

    def __init__(self, lr, b1, b2, eps, weight_decay, max_norm):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd, self.max_norm = eps, weight_decay, max_norm
        self.count = 0
        self.mu, self.nu = {}, {}

    def update(self, params: dict, grads: dict) -> float:
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = 1.0 if norm < self.max_norm else self.max_norm / norm
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for n, g in grads.items():
            g = g.double() * scale
            mu = self.mu.get(n, torch.zeros_like(g))
            nu = self.nu.get(n, torch.zeros_like(g))
            mu = self.b1 * mu + (1 - self.b1) * g
            nu = self.b2 * nu + (1 - self.b2) * g * g
            self.mu[n], self.nu[n] = mu, nu
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            p = params[n]
            u = u + self.wd * p.double()
            p.copy_((p.double() - self.lr * u).float())
        return norm
