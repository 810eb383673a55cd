"""DDIM inversion and latent interpolation utilities.

Port of ``followyourclick_tpu/utils/diffusion_utils.py`` (the reference's
``animatediff/utils/util.py`` DDIM inversion ``next_step`` and ``slerp``).
``slerp`` here is the torch tensor function ``slerp(v0, v1, t,
dot_threshold)``; ``utils/video_io.slerp(t, v0, v1)`` is the numpy one of
the JAX ``utils/video_io.py``, with the other argument order.
"""

from __future__ import annotations

import torch

from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule


def ddim_inversion_step(sched: DDIMSchedule, model_output: torch.Tensor,
                        step_index: int, sample: torch.Tensor
                        ) -> torch.Tensor:
    """One inversion step x_t → x_{t + ratio}. Loop position ``i`` walks
    the grid ascending (``timesteps[S - 1 - i]``); the state is at
    ``t - ratio`` (``final_alpha_cumprod`` below 0) and moves to ``t``.
    A v-prediction is turned into ε and x0 at the current timestep."""
    cfg = sched.cfg
    S = sched.num_inference_steps
    next_t = int(sched.timesteps[S - 1 - int(step_index)])
    t = min(next_t - cfg.num_train_timesteps // S,
            cfg.num_train_timesteps - 1)
    ac = sched.alphas_cumprod
    alpha_t = (ac[t] if t >= 0 else torch.tensor(sched.final_alpha_cumprod,
                                                 dtype=torch.float32))
    alpha_t = alpha_t.to(sample.device)
    alpha_next = ac[next_t].to(sample.device)
    if cfg.prediction_type == "v_prediction":
        eps = alpha_t ** 0.5 * model_output + (1 - alpha_t) ** 0.5 * sample
        x0 = alpha_t ** 0.5 * sample - (1 - alpha_t) ** 0.5 * model_output
    else:
        eps = model_output
        x0 = (sample - (1 - alpha_t) ** 0.5 * eps) / alpha_t ** 0.5
    return alpha_next ** 0.5 * x0 + (1 - alpha_next) ** 0.5 * eps


def slerp(v0: torch.Tensor, v1: torch.Tensor, t: float,
          dot_threshold: float = 0.9995) -> torch.Tensor:
    """Spherical linear interpolation between two (noise) tensors; a plain
    lerp when their directions' |cos| exceeds ``dot_threshold``."""
    u0 = v0 / torch.linalg.vector_norm(v0)
    u1 = v1 / torch.linalg.vector_norm(v1)
    dot = torch.sum(u0 * u1)
    if torch.abs(dot) > dot_threshold:
        return (1 - t) * v0 + t * v1
    omega = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    so = torch.sin(omega)
    return (torch.sin((1.0 - t) * omega) / so * v0
            + torch.sin(t * omega) / so * v1)
