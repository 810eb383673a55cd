"""The other samplers: Euler, Euler-Ancestral, PNDM (PLMS, with the PRK
warm-up grid), DPM-Solver / DPM-Solver++ at orders 1-3, and LMS.

Port of ``followyourclick_tpu/schedulers/solvers.py`` (the diffusers 0.11.1
schedulers the reference pipeline accepts). Each schedule is a frozen
dataclass of fp32 tables built on the host; each step is a pure function of
(schedule, state, model output, loop position, sample) that returns the new
sample and the new state. The JAX package selects between branches with
``jnp.where`` inside one scan; PyTorch runs the loop eagerly, so the loop
position and the multistep counters are Python integers and only the chosen
branch is computed, with the same arithmetic.

As in the JAX package, these schedules take ``alphas_cumprod`` from the beta
schedule alone (no zero-terminal-SNR rescale; that patch is DDIM's), and the
sigma grids and LMS coefficients are computed in float64 numpy and stored in
fp32. The step arithmetic runs in fp32 whatever the sample's dtype, and the
new sample comes back in that dtype; the states hold fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.schedulers.ddim import make_beta_schedule


def _alphas_cumprod(cfg: NoiseScheduleConfig) -> torch.Tensor:
    return torch.cumprod(1.0 - make_beta_schedule(cfg), dim=0)


def _sigma_grid(cfg: NoiseScheduleConfig, num_inference_steps: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The k-diffusion grid: float timesteps ``linspace(0, T-1, S)``
    descending, and their sigmas (interpolated over the training sigmas)
    with a final 0, in fp32."""
    ac = _alphas_cumprod(cfg).numpy()
    timesteps = np.linspace(0, cfg.num_train_timesteps - 1,
                            num_inference_steps, dtype=float)[::-1].copy()
    sigmas = ((1 - ac) / ac) ** 0.5
    sigmas = np.interp(timesteps, np.arange(len(sigmas)), sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps.astype(np.float32), sigmas


def _pred_x0_from_sigma(model_output: torch.Tensor, sample: torch.Tensor,
                        sigma: torch.Tensor, prediction_type: str
                        ) -> torch.Tensor:
    if prediction_type == "epsilon":
        return sample - sigma * model_output
    if prediction_type == "v_prediction":
        return model_output * (-sigma / (sigma ** 2 + 1) ** 0.5) + (
            sample / (sigma ** 2 + 1))
    raise ValueError(prediction_type)


def _fp32(*tensors: torch.Tensor):
    return tuple(t.float() for t in tensors)


# ---------------------------------------------------------------- Euler ----


@dataclass(frozen=True)
class EulerSchedule:
    sigmas: torch.Tensor      # (S+1,) fp32, last entry 0
    timesteps: torch.Tensor   # (S,) fp32, descending
    init_noise_sigma: float
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, cfg: NoiseScheduleConfig,
               num_inference_steps: int) -> "EulerSchedule":
        timesteps, sigmas = _sigma_grid(cfg, num_inference_steps)
        return cls(torch.from_numpy(sigmas), torch.from_numpy(timesteps),
                   float(sigmas.max()), cfg.prediction_type)

    def scale_model_input(self, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        sigma = self.sigmas[step_index]
        return (sample.float() / ((sigma ** 2 + 1) ** 0.5)).to(sample.dtype)


def euler_step(sched: EulerSchedule, model_output: torch.Tensor,
               step_index: int, sample: torch.Tensor) -> torch.Tensor:
    """Deterministic Euler ODE step (the ``s_churn = 0`` path)."""
    dtype = sample.dtype
    sample, model_output = _fp32(sample, model_output)
    sigma = sched.sigmas[step_index]
    pred_x0 = _pred_x0_from_sigma(model_output, sample, sigma,
                                  sched.prediction_type)
    derivative = (sample - pred_x0) / sigma
    dt = sched.sigmas[step_index + 1] - sigma
    return (sample + derivative * dt).to(dtype)


# ------------------------------------------------------ Euler ancestral ----


def euler_ancestral_step(sched: EulerSchedule,
                         model_output: torch.Tensor, step_index: int,
                         sample: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
    """Ancestral step: the sigma transition split into a deterministic part
    (sigma_down) and fresh standard-normal ``noise`` (sigma_up)."""
    dtype = sample.dtype
    sample, model_output, noise = _fp32(sample, model_output, noise)
    sigma_from = sched.sigmas[step_index]
    sigma_to = sched.sigmas[step_index + 1]
    pred_x0 = _pred_x0_from_sigma(model_output, sample, sigma_from,
                                  sched.prediction_type)
    sigma_up = (sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2)
                / sigma_from ** 2) ** 0.5
    sigma_down = (sigma_to ** 2 - sigma_up ** 2) ** 0.5
    derivative = (sample - pred_x0) / sigma_from
    dt = sigma_down - sigma_from
    return (sample + derivative * dt + noise * sigma_up).to(dtype)


# ----------------------------------------------------------------- PNDM ----


@dataclass(frozen=True)
class PNDMState:
    ets: tuple                     # 4 fp32 tensors, newest last
    num_ets: int = 0
    cur_sample: Optional[torch.Tensor] = None
    counter: int = 0
    cur_model_output: Optional[torch.Tensor] = None  # PRK accumulator


@dataclass(frozen=True)
class PNDMSchedule:
    alphas_cumprod: torch.Tensor   # (T,) fp32
    final_alpha_cumprod: torch.Tensor  # 0-d fp32
    timesteps: torch.Tensor        # int64 grid: S+1 calls, S+9 with PRK
    step_ratio: int = 1
    prediction_type: str = "epsilon"
    # leading Runge-Kutta warm-up calls (12 on the skip_prk_steps=False
    # grid: 3 RK4 groups of 4; 0 on the PLMS grid)
    num_prk_steps: int = 0

    @classmethod
    def create(cls, cfg: NoiseScheduleConfig, num_inference_steps: int,
               skip_prk_steps: bool = True) -> "PNDMSchedule":
        """``skip_prk_steps=True``: the PLMS grid, whose warm-up repeats the
        second timestep (S+1 calls). ``False``: the last 4 timesteps refined
        on a half-ratio sub-grid into 12 PRK entries, then PLMS from
        ``timesteps[:-3]`` (S+9 calls; needs S >= 4)."""
        ac = _alphas_cumprod(cfg)
        ratio = cfg.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round() \
            + cfg.steps_offset
        if skip_prk_steps:
            grid = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1].copy()
            n_prk = 0
        else:
            prk = np.asarray(ts[-4:]).repeat(2) + np.tile(
                np.array([0, ratio // 2]), 4)
            prk = (prk[:-1].repeat(2)[1:-1])[::-1].copy()
            grid = np.concatenate([prk, ts[:-3][::-1]])
            n_prk = len(prk)
        final = torch.tensor(1.0) if cfg.set_alpha_to_one else ac[0].clone()
        return cls(ac, final, torch.from_numpy(grid.astype(np.int64)), ratio,
                   cfg.prediction_type, n_prk)

    def init_state(self, sample_shape, device=None) -> PNDMState:
        def zeros():
            return torch.zeros(sample_shape, dtype=torch.float32,
                               device=device)

        return PNDMState(ets=tuple(zeros() for _ in range(4)),
                         cur_sample=zeros(), cur_model_output=zeros())


def _pndm_prev_sample(sched: PNDMSchedule, sample: torch.Tensor, t: int,
                      prev_t: int, model_output: torch.Tensor
                      ) -> torch.Tensor:
    """Formula (9) of the PNDM paper."""
    ac = sched.alphas_cumprod
    alpha_prod_t = ac[t]
    alpha_prod_prev = ac[prev_t] if prev_t >= 0 else \
        sched.final_alpha_cumprod
    beta_prod_t = 1 - alpha_prod_t
    beta_prod_prev = 1 - alpha_prod_prev
    if sched.prediction_type == "v_prediction":
        model_output = (alpha_prod_t ** 0.5 * model_output
                        + beta_prod_t ** 0.5 * sample)
    sample_coeff = (alpha_prod_prev / alpha_prod_t) ** 0.5
    denom = alpha_prod_t * beta_prod_prev ** 0.5 + (
        alpha_prod_t * beta_prod_t * alpha_prod_prev) ** 0.5
    return (sample_coeff * sample
            - (alpha_prod_prev - alpha_prod_t) * model_output / denom)


def _pndm_step_prk(sched: PNDMSchedule, state: PNDMState,
                   model_output: torch.Tensor, step_index: int,
                   sample: torch.Tensor) -> Tuple[torch.Tensor, PNDMState]:
    """Runge-Kutta warm-up: groups of 4 calls integrate each of the last 3
    coarse intervals on the half-step sub-grid; phase 0 stashes the group's
    sample and records the call's output for the PLMS continuation."""
    t = int(sched.timesteps[step_index])
    counter = state.counter
    phase = counter % 4
    prev_t = t - (sched.step_ratio // 2 if counter % 2 == 0 else 0)
    t_group = int(sched.timesteps[(counter // 4) * 4])
    ets, num_ets, cur_sample = state.ets, state.num_ets, state.cur_sample
    if phase == 0:
        ets = ets[1:] + (model_output,)
        num_ets = min(num_ets + 1, 4)
        cur_sample = sample
    acc = state.cur_model_output
    out = acc + model_output / 6 if phase == 3 else model_output
    if phase == 0:
        acc = acc + model_output / 6
    elif phase == 3:
        acc = torch.zeros_like(model_output)
    else:
        acc = acc + model_output / 3
    prev = _pndm_prev_sample(sched, cur_sample, t_group, prev_t, out)
    return prev, PNDMState(ets, num_ets, cur_sample, counter + 1, acc)


def _pndm_step_plms(sched: PNDMSchedule, state: PNDMState,
                    model_output: torch.Tensor, step_index: int,
                    sample: torch.Tensor) -> Tuple[torch.Tensor, PNDMState]:
    """PLMS multistep: the Adams-Bashforth blend of up to 4 outputs; the
    second call re-integrates from the stashed first sample."""
    t = int(sched.timesteps[step_index])
    counter = state.counter
    prev_t = t - sched.step_ratio
    if counter == 1:
        t, prev_t = t + sched.step_ratio, t
    ets, num_ets = state.ets, state.num_ets
    if counter != 1:
        ets = ets[1:] + (model_output,)
        num_ets = min(num_ets + 1, 4)
    e4, e3, e2, e1 = ets
    case = 0 if counter == 0 else 1 if counter == 1 else min(num_ets, 4)
    if case == 0:
        blended = model_output
    elif case == 1:
        blended = (model_output + e1) / 2
    elif case == 2:
        blended = (3 * e1 - e2) / 2
    elif case == 3:
        blended = (23 * e1 - 16 * e2 + 5 * e3) / 12
    else:
        blended = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24
    eff_sample = state.cur_sample if counter == 1 else sample
    prev = _pndm_prev_sample(sched, eff_sample, t, prev_t, blended)
    cur_sample = sample if counter == 0 else state.cur_sample
    return prev, replace(state, ets=ets, num_ets=num_ets,
                         cur_sample=cur_sample, counter=counter + 1)


def pndm_step(sched: PNDMSchedule, state: PNDMState,
              model_output: torch.Tensor, step_index: int,
              sample: torch.Tensor) -> Tuple[torch.Tensor, PNDMState]:
    """PRK warm-up for the first ``num_prk_steps`` calls, PLMS after."""
    dtype = sample.dtype
    sample, model_output = _fp32(sample, model_output)
    step = (_pndm_step_prk if state.counter < sched.num_prk_steps
            else _pndm_step_plms)
    prev, state = step(sched, state, model_output, step_index, sample)
    return prev.to(dtype), state


# ----------------------------------------------------------- DPM-Solver ----


@dataclass(frozen=True)
class DPMSolverState:
    prev_output: Optional[torch.Tensor] = None    # m1, the last output
    prev_timestep: int = 0
    lower_order_nums: int = 0
    prev_output_2: Optional[torch.Tensor] = None  # m2 (third order)
    prev_timestep_2: int = 0


@dataclass(frozen=True)
class DPMSolverSchedule:
    alpha_t: torch.Tensor     # (T,) fp32
    sigma_t: torch.Tensor
    lambda_t: torch.Tensor
    timesteps: torch.Tensor   # (S,) int64, descending
    algorithm_type: str = "dpmsolver++"
    solver_type: str = "midpoint"
    lower_order_final: bool = True
    prediction_type: str = "epsilon"
    solver_order: int = 2

    @classmethod
    def create(cls, cfg: NoiseScheduleConfig, num_inference_steps: int,
               algorithm_type: str = "dpmsolver++",
               solver_type: str = "midpoint",
               solver_order: int = 2) -> "DPMSolverSchedule":
        ac = _alphas_cumprod(cfg)
        alpha_t, sigma_t = torch.sqrt(ac), torch.sqrt(1 - ac)
        lambda_t = torch.log(alpha_t) - torch.log(sigma_t)
        timesteps = (np.linspace(0, cfg.num_train_timesteps - 1,
                                 num_inference_steps + 1)
                     .round()[::-1][:-1].astype(np.int64))
        return cls(alpha_t, sigma_t, lambda_t,
                   torch.from_numpy(timesteps.copy()), algorithm_type,
                   solver_type, prediction_type=cfg.prediction_type,
                   solver_order=solver_order)

    def init_state(self, sample_shape, device=None) -> DPMSolverState:
        def zeros():
            return torch.zeros(sample_shape, dtype=torch.float32,
                               device=device)

        return DPMSolverState(prev_output=zeros(), prev_output_2=zeros())


def _dpm_convert(sched: DPMSolverSchedule, model_output: torch.Tensor,
                 t: int, sample: torch.Tensor) -> torch.Tensor:
    """The model output as the solver's data (++) or noise prediction."""
    a, s = sched.alpha_t[t], sched.sigma_t[t]
    pt = sched.prediction_type
    if sched.algorithm_type == "dpmsolver++":
        if pt == "epsilon":
            return (sample - s * model_output) / a
        if pt == "sample":
            return model_output
        if pt == "v_prediction":
            return a * sample - s * model_output
    else:
        if pt == "epsilon":
            return model_output
        if pt == "sample":
            return (sample - a * model_output) / s
        if pt == "v_prediction":
            return a * model_output + s * sample
    raise ValueError(pt)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.tensor(1e-12), x)


def dpm_solver_step(sched: DPMSolverSchedule, state: DPMSolverState,
                    model_output: torch.Tensor, step_index: int,
                    sample: torch.Tensor
                    ) -> Tuple[torch.Tensor, DPMSolverState]:
    """Multistep DPM-Solver(++) of ``sched.solver_order``: first order on
    the first step and, with ``lower_order_final`` and S < 15, on the last;
    third order warms up through second and drops to second on the
    penultimate step."""
    dtype = sample.dtype
    sample, model_output = _fp32(sample, model_output)
    n = sched.timesteps.shape[0]
    t = int(sched.timesteps[step_index])
    prev_t = 0 if step_index == n - 1 else int(
        sched.timesteps[min(step_index + 1, n - 1)])
    m0 = _dpm_convert(sched, model_output, t, sample)
    lam_t, lam_s0 = sched.lambda_t[prev_t], sched.lambda_t[t]
    a_t, a_s0 = sched.alpha_t[prev_t], sched.alpha_t[t]
    s_t, s_s0 = sched.sigma_t[prev_t], sched.sigma_t[t]
    h = lam_t - lam_s0
    pp = sched.algorithm_type == "dpmsolver++"
    # the first-order (DDIM) part every order shares
    if pp:
        base = (s_t / s_s0) * sample - (a_t * (torch.exp(-h) - 1.0)) * m0
    else:
        base = (a_t / a_s0) * sample - (s_t * (torch.exp(h) - 1.0)) * m0

    short = sched.lower_order_final and n < 15
    use_first = (sched.solver_order == 1 or state.lower_order_nums < 1
                 or (short and step_index == n - 1))
    use_second = (sched.solver_order == 2 or state.lower_order_nums < 2
                  or (short and step_index == n - 2))
    if use_first:
        prev = base
    else:
        s1, m1 = state.prev_timestep, state.prev_output
        lam_s1 = sched.lambda_t[s1]
        r0 = (lam_s0 - lam_s1) / _nonzero(h)
        d1 = (m0 - m1) / _nonzero(r0)
        if use_second:
            if pp and sched.solver_type == "midpoint":
                prev = base - 0.5 * (a_t * (torch.exp(-h) - 1.0)) * d1
            elif pp:
                prev = base + (a_t * ((torch.exp(-h) - 1.0) / h + 1.0)) * d1
            elif sched.solver_type == "midpoint":
                prev = base - 0.5 * (s_t * (torch.exp(h) - 1.0)) * d1
            else:
                prev = base - (s_t * ((torch.exp(h) - 1.0) / h - 1.0)) * d1
        else:
            m2 = state.prev_output_2
            lam_s2 = sched.lambda_t[state.prev_timestep_2]
            r1 = (lam_s1 - lam_s2) / _nonzero(h)
            d1_1 = (m1 - m2) / _nonzero(r1)
            rsum = _nonzero(r0 + r1)
            d1_3 = d1 + (r0 / rsum) * (d1 - d1_1)
            d2 = (d1 - d1_1) / rsum
            hh = _nonzero(h)
            if pp:
                prev = (base
                        + (a_t * ((torch.exp(-h) - 1.0) / hh + 1.0)) * d1_3
                        - (a_t * ((torch.exp(-h) - 1.0 + h) / hh ** 2 - 0.5))
                        * d2)
            else:
                prev = (base
                        - (s_t * ((torch.exp(h) - 1.0) / hh - 1.0)) * d1_3
                        - (s_t * ((torch.exp(h) - 1.0 - h) / hh ** 2 - 0.5))
                        * d2)
    new_state = DPMSolverState(
        prev_output=m0, prev_timestep=t,
        lower_order_nums=min(state.lower_order_nums + 1, sched.solver_order),
        prev_output_2=state.prev_output,
        prev_timestep_2=state.prev_timestep)
    return prev.to(dtype), new_state


# ------------------------------------------------------------------ LMS ----


@dataclass(frozen=True)
class LMSSchedule:
    sigmas: torch.Tensor      # (S+1,) fp32
    timesteps: torch.Tensor   # (S,) fp32, descending
    coeffs: torch.Tensor      # (S, order) fp32, newest first, zero-padded
    init_noise_sigma: float
    order: int = 4
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, cfg: NoiseScheduleConfig, num_inference_steps: int,
               order: int = 4) -> "LMSSchedule":
        """Integrated Adams-Bashforth coefficients over the sigma grid, by
        ``scipy.integrate.quad`` on the host."""
        from scipy import integrate

        timesteps, sigmas = _sigma_grid(cfg, num_inference_steps)
        n = num_inference_steps
        coeffs = np.zeros((n, order), np.float32)
        for t in range(n):
            cur_order = min(t + 1, order)
            for j in range(cur_order):
                def fn(tau, t=t, j=j, cur_order=cur_order):
                    prod = 1.0
                    for k in range(cur_order):
                        if j == k:
                            continue
                        prod *= (tau - sigmas[t - k]) / (
                            sigmas[t - j] - sigmas[t - k])
                    return prod

                coeffs[t, j] = integrate.quad(
                    fn, sigmas[t], sigmas[t + 1], epsrel=1e-4)[0]
        return cls(torch.from_numpy(sigmas), torch.from_numpy(timesteps),
                   torch.from_numpy(coeffs), float(sigmas.max()), order,
                   cfg.prediction_type)

    def scale_model_input(self, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        sigma = self.sigmas[step_index]
        return (sample.float() / ((sigma ** 2 + 1) ** 0.5)).to(sample.dtype)

    def init_state(self, sample_shape, device=None) -> tuple:
        """The derivative history, newest first, ``order`` slots."""
        return tuple(torch.zeros(sample_shape, dtype=torch.float32,
                                 device=device) for _ in range(self.order))


def lms_step(sched: LMSSchedule, derivatives: tuple,
             model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    """Push the new derivative and add the coefficient-weighted history."""
    dtype = sample.dtype
    sample, model_output = _fp32(sample, model_output)
    sigma = sched.sigmas[step_index]
    pred_x0 = _pred_x0_from_sigma(model_output, sample, sigma,
                                  sched.prediction_type)
    derivatives = ((sample - pred_x0) / sigma,) + derivatives[:-1]
    coeffs = sched.coeffs[step_index]
    update = sum(c * d for c, d in zip(coeffs, derivatives))
    return (sample + update).to(dtype), derivatives
