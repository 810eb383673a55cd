"""Every sampler of the port's ``schedulers/dispatch.py`` against the JAX
package's ``make_solver``, on the schedules and step by step over a whole
trajectory.

No UNet: the model output of step ``i`` is ``0.3·x + z_i`` with ``z_i``
drawn from a numpy seed, the same on both sides, so each step reads the
sample it is given. fp32 on the CPU. The schedules (timesteps, sigmas,
``init_noise_sigma``, the LMS coefficients) and ``n_calls`` must agree, and
every sample of the trajectory holds 1e-5 relative to the trajectory's
largest value (the schedule tables are built from fp32 betas on both sides;
the step arithmetic is the same, term for term). ``euler_a`` and DDIM at
``eta = 1`` take the same injected standard-normal noise on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import NoiseScheduleConfig as JNoise
from followyourclick_tpu.schedulers.dispatch import make_solver as jax_solver
from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.schedulers.dispatch import (
    SCHEDULERS,
    make_solver,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

SHAPE = (1, 2, 4, 4, 4)
RTOL = 1e-5


def _configs(prediction_type):
    kw = dict(prediction_type=prediction_type)
    return NoiseScheduleConfig(**kw), JNoise(**kw)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("steps", [4, 6, 16])
@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_schedule_matches_jax(name, prediction_type, steps):
    cfg, jcfg = _configs(prediction_type)
    got, want = make_solver(name, cfg, steps), jax_solver(name, jcfg, steps)
    assert got.n_calls == want.n_calls
    assert got.needs_step_noise == want.needs_step_noise
    _close(got.init_noise_sigma, float(want.init_noise_sigma),
           "init_noise_sigma")
    _close(torch.stack([got.timestep(i) for i in range(got.n_calls)]),
           np.asarray(want.sched.timesteps), "timesteps")
    for table in ("sigmas", "coeffs", "alphas_cumprod", "alpha_t",
                  "sigma_t", "lambda_t"):
        if hasattr(want.sched, table):
            _close(getattr(got.sched, table),
                   np.asarray(getattr(want.sched, table)), table)


@pytest.mark.parametrize("steps", [4, 6, 16])
@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("name", [*SCHEDULERS, "ddim_eta"])
def test_trajectory_matches_jax(name, prediction_type, steps):
    """The whole trajectory: initial scaling, the model-input scaling of
    every call and every step with its carried state."""
    eta = 1.0 if name == "ddim_eta" else 0.0
    name = "ddim" if name == "ddim_eta" else name
    cfg, jcfg = _configs(prediction_type)
    solver, jsolver = make_solver(name, cfg, steps), jax_solver(name, jcfg,
                                                                steps)
    rs = np.random.RandomState(steps)
    x0 = rs.randn(*SHAPE).astype(np.float32)
    x = torch.from_numpy(x0) * solver.init_noise_sigma
    jx = jnp.asarray(x0) * jnp.asarray(jsolver.init_noise_sigma, jnp.float32)
    state, jstate = solver.init_state(SHAPE), jsolver.init_state(SHAPE)
    for i in range(solver.n_calls):
        _close(solver.scale_model_input(x, i),
               jsolver.scale_model_input(jx, i), f"model input {i}")
        z = rs.randn(*SHAPE).astype(np.float32)
        noise = rs.randn(*SHAPE).astype(np.float32)
        stochastic = eta > 0 or solver.needs_step_noise
        out = 0.3 * solver.scale_model_input(x, i) + torch.from_numpy(z)
        jout = 0.3 * jsolver.scale_model_input(jx, i) + jnp.asarray(z)
        x, state = solver.step(
            out, i, x, state, eta=eta,
            noise=torch.from_numpy(noise) if stochastic else None)
        jx, jstate = jsolver.step(
            jout, i, jx, jstate, eta=eta,
            noise=jnp.asarray(noise) if stochastic else None)
        _close(x, jx, f"{name} step {i}")
    assert np.isfinite(x.numpy()).all()


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_solver("heun", NoiseScheduleConfig(), 4)

