"""One protocol over every sampler the sampler accepts.

Port of ``followyourclick_tpu/schedulers/dispatch.py``. :func:`make_solver`
wraps each schedule (``schedulers/ddim.py``, ``schedulers/solvers.py``)
behind :class:`Solver`:

- ``n_calls``: UNet evaluations per request (PNDM: S+1 on the PLMS grid,
  S+9 with the PRK warm-up; the others S);
- ``timestep(i)``: the value the UNet's time embedding takes (float
  sigma-grid timesteps for Euler and LMS);
- ``scale_model_input``: the k-diffusion family's sigma pre-scaling;
- ``init_noise_sigma``: the initial latents' scale (sigma_max for Euler and
  LMS, else 1);
- ``init_state(shape, device)``: the multistep state (None for the
  stateless DDIM and Euler steps);
- ``step(out, i, x, state, eta=, noise=)`` → ``(x', state')``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_step
from followyourclick_tpu_torch.schedulers.solvers import (
    DPMSolverSchedule,
    EulerSchedule,
    LMSSchedule,
    PNDMSchedule,
    dpm_solver_step,
    euler_ancestral_step,
    euler_step,
    lms_step,
    pndm_step,
)

SCHEDULERS = (
    "ddim", "pndm", "pndm_prk", "euler", "euler_a", "lms",
    "dpm++", "dpm++3", "dpm",
)


@dataclass(frozen=True)
class Solver:
    """A schedule and the uniform step protocol over it."""

    name: str
    sched: Any
    needs_step_noise: bool = False   # the ancestral sampler's fresh noise

    @property
    def n_calls(self) -> int:
        return int(self.sched.timesteps.shape[0])

    @property
    def init_noise_sigma(self) -> float:
        return getattr(self.sched, "init_noise_sigma", 1.0)

    def timestep(self, i: int) -> torch.Tensor:
        return self.sched.timesteps[i]

    def scale_model_input(self, sample: torch.Tensor,
                          i: int) -> torch.Tensor:
        if hasattr(self.sched, "scale_model_input"):
            return self.sched.scale_model_input(sample, i)
        return sample

    def init_state(self, sample_shape, device=None):
        if hasattr(self.sched, "init_state"):
            return self.sched.init_state(sample_shape, device)
        return None

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             state, *, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None):
        if self.name == "ddim":
            new, _ = ddim_step(self.sched, model_output, i, sample, eta=eta,
                               noise=noise)
            return new, state
        if self.name in ("pndm", "pndm_prk"):
            return pndm_step(self.sched, state, model_output, i, sample)
        if self.name == "euler":
            return euler_step(self.sched, model_output, i, sample), state
        if self.name == "euler_a":
            if noise is None:
                raise ValueError("euler_a draws fresh noise every step")
            return euler_ancestral_step(self.sched, model_output, i, sample,
                                        noise), state
        if self.name == "lms":
            return lms_step(self.sched, state, model_output, i, sample)
        return dpm_solver_step(self.sched, state, model_output, i, sample)


def make_solver(name: str, cfg: NoiseScheduleConfig,
                num_inference_steps: int) -> Solver:
    """The named solver over ``cfg``'s noise schedule; an unknown name
    raises ``ValueError``."""
    if name == "ddim":
        return Solver("ddim", DDIMSchedule.create(cfg, num_inference_steps))
    if name == "pndm":
        return Solver("pndm", PNDMSchedule.create(cfg, num_inference_steps))
    if name == "pndm_prk":
        return Solver("pndm_prk", PNDMSchedule.create(
            cfg, num_inference_steps, skip_prk_steps=False))
    if name == "euler":
        return Solver("euler", EulerSchedule.create(cfg, num_inference_steps))
    if name == "euler_a":
        return Solver("euler_a", EulerSchedule.create(
            cfg, num_inference_steps), needs_step_noise=True)
    if name == "lms":
        return Solver("lms", LMSSchedule.create(cfg, num_inference_steps))
    if name in ("dpm++", "dpm++3", "dpm"):
        return Solver(name, DPMSolverSchedule.create(
            cfg, num_inference_steps,
            algorithm_type="dpmsolver" if name == "dpm" else "dpmsolver++",
            solver_order=3 if name == "dpm++3" else 2))
    raise ValueError(
        f"unknown scheduler {name!r}; expected one of {SCHEDULERS}")
