"""Port parity, first modules: the DDIM scheduler, the shared layers, the
phase-decomposed upsample conv, the resnet blocks and the parameter bridge.

Each test sends the same numpy inputs (from a seed) through the JAX
function and its ``followyourclick_tpu_torch`` counterpart; parameters cross
by ``load_jax_params``. All fp32 on the CPU. Tolerances: 1e-5 where the two
compute the same elementwise formula, 1e-4 for short conv / matmul chains
(summation order differs), stated per test otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import NoiseScheduleConfig
from followyourclick_tpu.models import layers as jl
from followyourclick_tpu.models import resnet as jr
from followyourclick_tpu.ops import upsample as jup
from followyourclick_tpu.schedulers import ddim as jddim
from followyourclick_tpu_torch.models import layers as tl
from followyourclick_tpu_torch.models import resnet as tr
from followyourclick_tpu_torch.ops import upsample as tup
from followyourclick_tpu_torch.schedulers import ddim as tddim
from followyourclick_tpu_torch.utils.convert import load_jax_params


def np_tree(variables):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  variables["params"])


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- DDIM

SCHEDULES = [
    NoiseScheduleConfig(),
    NoiseScheduleConfig(beta_schedule="scaled_linear",
                        rescale_betas_zero_snr=False,
                        prediction_type="epsilon"),
    NoiseScheduleConfig(beta_schedule="squaredcos_cap_v2",
                        prediction_type="sample", set_alpha_to_one=False),
]


@pytest.mark.parametrize("cfg", SCHEDULES)
@pytest.mark.parametrize("steps", [4, 25])
def test_ddim_tables(cfg, steps):
    """The timestep grid is exact. The fp32 tables agree to 2e-5 relative
    (1e-7 absolute near the zero-SNR tail): torch.linspace and jnp.linspace
    may differ in the last bit, and the cumulative product over 1000 steps
    carries those bits (2.8e-6 relative measured)."""
    js = jddim.DDIMSchedule.create(cfg, steps)
    ts = tddim.DDIMSchedule.create(cfg, steps)
    np.testing.assert_array_equal(ts.timesteps.numpy(),
                                  np.asarray(js.timesteps))
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), rtol=2e-5,
                               atol=1e-7)
    assert ts.final_alpha_cumprod == pytest.approx(
        float(js.final_alpha_cumprod), rel=1e-6)


@pytest.mark.parametrize("cfg", SCHEDULES)
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step(cfg, eta):
    rs = np.random.RandomState(0)
    sample, out, noise = (rs.randn(2, 3, 4, 4, 4).astype(np.float32)
                          for _ in range(3))
    js = jddim.DDIMSchedule.create(cfg, 10)
    ts = tddim.DDIMSchedule.create(cfg, 10)
    for i in (0, 4, 9):  # the last step uses final_alpha_cumprod
        jp, jx0 = jddim.ddim_step(js, jnp.asarray(out), i, jnp.asarray(sample),
                                  eta=eta, noise=jnp.asarray(noise))
        tp, tx0 = tddim.ddim_step(ts, t(out), i, t(sample), eta=eta,
                                  noise=t(noise))
        close(tp, jp, 1e-5)
        close(tx0, jx0, 1e-5)


def test_ddim_add_noise_and_velocity():
    rs = np.random.RandomState(1)
    x0, eps = (rs.randn(3, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    steps = np.array([1, 500, 999])
    js = jddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    ts = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    close(tddim.add_noise(ts, t(x0), t(eps), torch.from_numpy(steps)),
          jddim.add_noise(js, jnp.asarray(x0), jnp.asarray(eps),
                          jnp.asarray(steps)), 1e-5)
    close(tddim.get_velocity(ts, t(x0), t(eps), torch.from_numpy(steps)),
          jddim.get_velocity(js, jnp.asarray(x0), jnp.asarray(eps),
                             jnp.asarray(steps)), 1e-5)


# -------------------------------------------------------------- layers

def test_sinusoidal_embeddings():
    """2e-4 absolute: at t = 999 the arguments reach 999 rad, where one fp32
    ulp is 6e-5 and the two libraries reduce the range differently."""
    steps = np.array([0.0, 1.0, 250.0, 999.0, 8.0], np.float32)
    for dim in (320, 33):
        close(tl.sinusoidal_timestep_embedding(t(steps), dim),
              jl.sinusoidal_timestep_embedding(jnp.asarray(steps), dim),
              2e-4)
    close(tl.temporal_positional_encoding(24, 320),
          jl.temporal_positional_encoding(24, 320), 1e-5)


@pytest.mark.parametrize("zero_init", [False, True])
def test_timestep_embedding(zero_init):
    x = np.random.RandomState(2).randn(3, 32).astype(np.float32)
    jm = jl.TimestepEmbedding(128, zero_init_output=zero_init)
    tree = np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tree["linear_2"]["kernel"] = np.random.RandomState(3).randn(
        128, 128).astype(np.float32) * 0.05
    tm = tl.TimestepEmbedding(32, 128, zero_init_output=zero_init)
    if zero_init:
        assert float(tm.linear_2.weight.detach().abs().sum()) == 0.0
    load_jax_params(tm, tree)
    close(tm(t(x)), jm.apply({"params": tree}, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 6, 32), (2, 3, 4, 5, 32)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm(shape, act):
    """4-D tensors take per-image statistics, the 5-D clip takes them over
    (F, H, W, C/g). The input has |mean| ≫ std to exercise the pilot shift."""
    rs = np.random.RandomState(4)
    x = (50.0 + rs.randn(*shape)).astype(np.float32)
    jm = jl.GroupNorm(num_groups=8, epsilon=1e-6, act=act)
    tree = np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tree["scale"] = (1 + 0.1 * rs.randn(32)).astype(np.float32)
    tree["bias"] = (0.1 * rs.randn(32)).astype(np.float32)
    tm = load_jax_params(tl.GroupNorm(32, 8, 1e-6, act=act), tree)
    close(tm(t(x)), jm.apply({"params": tree}, jnp.asarray(x)), 1e-4)
    if len(shape) == 5:  # F.group_norm on frames folded into the batch
        per_frame = torch.nn.functional.group_norm(
            t(x).flatten(0, 1).permute(0, 3, 1, 2), 8, tm.weight, tm.bias,
            eps=1e-6).permute(0, 2, 3, 1).reshape(shape)
        if act == "silu":
            per_frame = torch.nn.functional.silu(per_frame)
        assert not torch.allclose(per_frame, tm(t(x)), atol=1e-3)


# ------------------------------------------------------------ upsample

def test_conv3x3_nearest_up2():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 7, 6).astype(np.float32)
    k = (0.2 * rs.randn(3, 3, 6, 4)).astype(np.float32)      # HWIO
    b = (0.1 * rs.randn(4)).astype(np.float32)
    w = t(k.transpose(3, 2, 0, 1))                           # OIHW
    got = tup.conv3x3_nearest_up2(t(x), w, t(b))
    close(got, jup.conv3x3_nearest_up2(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(b)), 1e-5)
    close(got, jup.reference_up2_conv(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(b)), 1e-5)
    close(tup.reference_up2_conv(t(x), w, t(b)),
          jup.reference_up2_conv(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b)), 1e-5)


# -------------------------------------------------------------- resnet

def test_tile_to_batch_is_whole_copies():
    a = torch.arange(3.0)[:, None]
    np.testing.assert_array_equal(tr.tile_to_batch(a, 6)[:, 0].numpy(),
                                  [0, 1, 2, 0, 1, 2])
    assert tr.tile_to_batch(a, 3) is a and tr.tile_to_batch(None, 4) is None


@pytest.mark.parametrize("in_ch,out_ch,inflated", [(32, 64, False),
                                                   (64, 64, False),
                                                   (32, 32, True)])
def test_resnet_block(in_ch, out_ch, inflated):
    """Includes CFG prefix sharing: x at batch 4 with temb at batch 2."""
    rs = np.random.RandomState(6)
    x = rs.randn(4, 3, 6, 6, in_ch).astype(np.float32)
    temb = rs.randn(2, 128).astype(np.float32)
    jm = jr.ResnetBlock3D(out_channels=out_ch, in_channels=in_ch, groups=8,
                          use_inflated_groupnorm=inflated)
    tree = np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(temb)))
    tm = load_jax_params(tr.ResnetBlock3D(in_ch, out_ch, 128, groups=8,
                                          use_inflated_groupnorm=inflated),
                         tree)
    close(tm(t(x), t(temb)),
          jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(temb)),
          1e-4)


def test_down_and_upsample():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 8, 8, 16).astype(np.float32)
    jd = jr.Downsample3D(24)
    tree = np_tree(jd.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    td = load_jax_params(tr.Downsample3D(16, 24), tree)
    close(td(t(x)), jd.apply({"params": tree}, jnp.asarray(x)), 1e-4)
    ju = jr.Upsample3D(24)
    tree = np_tree(ju.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    tree["conv"]["bias"] = (0.1 * rs.randn(24)).astype(np.float32)
    tu = load_jax_params(tr.Upsample3D(16, 24), tree)
    close(tu(t(x)), ju.apply({"params": tree}, jnp.asarray(x)), 1e-4)
    close(tu(t(x), output_size=(24, 24)),
          ju.apply({"params": tree}, jnp.asarray(x), output_size=(24, 24)),
          1e-4)


# -------------------------------------------------------------- bridge

def test_load_jax_params_raises_on_leftovers():
    tm = tl.TimestepEmbedding(8, 16)
    tree = {"linear_1": {"kernel": np.zeros((8, 16)), "bias": np.zeros(16)},
            "linear_2": {"kernel": np.zeros((16, 16)), "bias": np.zeros(16)}}
    load_jax_params(tm, tree)
    with pytest.raises(ValueError, match="unused"):
        load_jax_params(tm, dict(tree, extra={"kernel": np.zeros(3)}))
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_params(tm, {"linear_1": tree["linear_1"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, dict(tree, linear_2={
            "kernel": np.zeros((16, 8)), "bias": np.zeros(16)}))
