"""The port's PAB sites (models/pab.py) against the JAX package's.

The tiny UNet of tests/test_torch_unet.py (the same random parameters, by
``load_jax_params``) runs a CFG-like batch of two (2 frames, 8² latents,
two different samples and contexts) in fp32 on the CPU under each
``PabMode`` of the serving schedules: the port with its cache dict, the JAX
UNet with its ``"pab"`` collection (``apply(..., mutable=["pab"])``, jitted).
A JAX cache crosses to the port by ``pab_cache_from_jax``. Outputs and cache
entries hold 5e-4 (rtol and atol), the UNet parity tolerance of
tests/test_torch_unet.py; within the port, reuse from a cache recorded on
the same input reproduces the output exactly. Reuse is checked against a
doctored cache (the recorded one scaled by 0.5), so it shows the cache is
read.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import MotionModuleConfig
from followyourclick_tpu.models import motion_module as jmm
from followyourclick_tpu.models import pab as jpab
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu_torch.models import motion_module as tmm
from followyourclick_tpu_torch.models.pab import PabMode, name_sites
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.utils.convert import (
    load_jax_params,
    pab_cache_from_jax,
)
from tests.test_torch_unet import TINY_UNET, tiny_unet_tree
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TOL = 5e-4
RECORD_ALL = PabMode(record_spatial=True, record_cross=True,
                     record_temporal=True)
REUSE_ALL = dataclasses.replace(RECORD_ALL, reuse_spatial=True,
                                reuse_cross=True, reuse_temporal=True)


def _jmode(mode):
    return jpab.PabMode(**dataclasses.asdict(mode)) if mode else None


@pytest.fixture(scope="module")
def setup():
    tree = tiny_unet_tree()
    rs = np.random.RandomState(3)
    inputs = dict(x=rs.randn(2, 2, 8, 8, 9).astype(np.float32),
                  ctx=(0.5 * rs.randn(2, 77, 768)).astype(np.float32),
                  t=np.array([801, 801]),
                  fps=np.full((1,), 8.0, np.float32),
                  ms=np.full((1,), 20.0, np.float32))
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), tree)
    return tree, inputs, unet


def _rows(inputs, half):
    """The inputs, or their cond half (the second batch row)."""
    if not half:
        return inputs
    return {**inputs, "x": inputs["x"][1:], "ctx": inputs["ctx"][1:],
            "t": inputs["t"][1:]}


def jax_apply(tree, inputs, mode, cache=None):
    """The JAX UNet under ``mode``: (output, its "pab" collection)."""
    inp = _rows(inputs, mode is not None and mode.half)
    variables = {"params": tree}
    if cache is not None:
        variables["pab"] = cache
    unet = JUNet(TINY_UNET, pab=_jmode(mode))
    out, mut = jax.jit(lambda v, x, t, c: unet.apply(
        v, x, t, c, mutable=["pab"]))(
            variables, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
            JCond(context=jnp.asarray(inp["ctx"]),
                  fps=jnp.asarray(inp["fps"]),
                  motion_score=jnp.asarray(inp["ms"])))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                   dict(mut["pab"]))


def port_apply(unet, inputs, mode, cache):
    inp = _rows(inputs, mode is not None and mode.half)
    with torch.no_grad():
        return unet(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                    UNetConditioning(torch.from_numpy(inp["ctx"]),
                                     torch.from_numpy(inp["fps"]),
                                     torch.from_numpy(inp["ms"])),
                    mode, cache).numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def assert_caches_close(port_cache, jax_tree):
    want = pab_cache_from_jax(jax_tree)
    assert sorted(port_cache) == sorted(want)
    for key, value in want.items():
        close(port_cache[key].numpy(), value.numpy())


def doctored(tree):
    return jax.tree_util.tree_map(lambda a: 0.5 * a, tree)


@pytest.fixture(scope="module")
def recorded(setup):
    """Record-all on both sides: (JAX out, JAX cache, port out, port
    cache)."""
    tree, inputs, unet = setup
    jout, jcache = jax_apply(tree, inputs, RECORD_ALL)
    cache = {}
    out = port_apply(unet, inputs, RECORD_ALL, cache)
    return jout, jcache, out, cache


def test_pab_mode_has_the_jax_fields_and_defaults():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(PabMode) == fields(jpab.PabMode)
    mode = PabMode(reuse_deep=True, record_temporal=True)
    assert mode.reuse("deep") and mode.record("temporal")
    assert not mode.reuse("spatial")


def test_record_all_matches_jax(setup, recorded):
    _, inputs, unet = setup
    jout, jcache, out, cache = recorded
    close(out, jout)
    assert_caches_close(cache, jcache)
    # every spatial transformer has two sites, every motion module two
    assert any(k.endswith("attn_1_out") for k in cache)
    assert any(k.endswith("attn2_out") for k in cache)
    # recording leaves the output exact
    np.testing.assert_array_equal(out, port_apply(unet, inputs, None, None))


def test_reuse_all_is_exact_and_matches_jax(setup, recorded):
    tree, inputs, unet = setup
    _, jcache, out, cache = recorded
    np.testing.assert_array_equal(
        port_apply(unet, inputs, REUSE_ALL, dict(cache)), out)
    bad = doctored(jcache)
    jout, _ = jax_apply(tree, inputs, REUSE_ALL, bad)
    got = port_apply(unet, inputs, REUSE_ALL, pab_cache_from_jax(bad))
    close(got, jout)
    assert np.abs(got - out).max() > 1e-2  # the cache was read


def test_half_mode_matches_the_cond_half(setup, recorded):
    """A cond-half step reusing a full-batch cache gives the cond half of
    the full output (rows are independent), on both sides."""
    tree, inputs, unet = setup
    jout, jcache, out, cache = recorded
    half = dataclasses.replace(REUSE_ALL, half=True)
    got = port_apply(unet, inputs, half, dict(cache))
    close(got, out[1:], 1e-5)
    jhalf, _ = jax_apply(tree, inputs, half, jcache)
    close(got, jhalf)


def test_half_mode_records_into_the_cond_half(setup, recorded):
    _, inputs, unet = setup
    _, _, _, cache = recorded
    half_rec = dataclasses.replace(RECORD_ALL, half=True)
    new = {k: v.clone() for k, v in cache.items()}
    port_apply(unet, {**inputs, "ctx": inputs["ctx"] * 0.9}, half_rec, new)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2_out"
    n2 = cache[key].shape[0] // 2
    torch.testing.assert_close(new[key][:n2], cache[key][:n2], rtol=0,
                               atol=0)
    assert not torch.allclose(new[key][n2:], cache[key][n2:])


DEEP_RECORD = PabMode(record_deep=True)
DEEP_REUSE = PabMode(record_deep=True, reuse_deep=True)


def test_trunk_record_and_reuse_match_jax(setup):
    tree, inputs, unet = setup
    jout, jcache = jax_apply(tree, inputs, DEEP_RECORD)
    cache = {}
    close(port_apply(unet, inputs, DEEP_RECORD, cache), jout)
    assert sorted(cache) == ["deep_trunk"]
    assert_caches_close(cache, jcache)
    bad = doctored(jcache)
    jreuse, _ = jax_apply(tree, inputs, DEEP_REUSE, bad)
    got = port_apply(unet, inputs, DEEP_REUSE, pab_cache_from_jax(bad))
    close(got, jreuse)
    assert np.abs(got - jout).max() > 1e-2


def test_trunk_forecast_matches_jax(setup):
    """Two records (at two timesteps) shift cur into prev; a reuse step
    returns cur + 0.5·(cur − prev) through the trunk."""
    tree, inputs, unet = setup
    rec = PabMode(record_deep=True, deep_extrapolate=True)
    reuse = dataclasses.replace(rec, reuse_deep=True, deep_ex_coeff=0.5)
    later = {**inputs, "t": np.array([601, 601])}
    _, jc1 = jax_apply(tree, inputs, rec)
    _, jc2 = jax_apply(tree, later, rec, jc1)
    jout, _ = jax_apply(tree, later, reuse, jc2)
    cache = {}
    port_apply(unet, inputs, rec, cache)
    assert bool(cache["deep_trunk_valid"] == 1)
    torch.testing.assert_close(cache["deep_trunk_prev"],
                               cache["deep_trunk"], rtol=0, atol=0)
    port_apply(unet, later, rec, cache)
    assert_caches_close(cache, jc2)
    close(port_apply(unet, later, reuse, cache), jout)


@pytest.mark.parametrize("mode", [PabMode(record_temporal=True),
                                  PabMode(record_temporal=True,
                                          reuse_temporal=True)])
def test_motion_module_temporal_sites_match_jax(mode):
    """The modular motion module with its temporal sites on; reuse runs
    from a doctored record of the same input."""
    cfg = MotionModuleConfig(num_attention_heads=4, zero_initialize=False)
    x = np.random.RandomState(9).randn(2, 4, 3, 4, 32).astype(np.float32)
    rec = jmm.MotionModule(in_channels=32, config=cfg,
                           pab=_jmode(PabMode(record_temporal=True)))
    variables = jax.tree_util.tree_map(
        np.array, rec.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tree = variables["params"]
    _, mut = rec.apply({"params": tree}, jnp.asarray(x), mutable=["pab"])
    jcache = doctored(mut["pab"]) if mode.reuse_temporal else None
    jmod = jmm.MotionModule(in_channels=32, config=cfg, pab=_jmode(mode))
    want, jmut = jmod.apply({"params": tree} | (
        {"pab": jcache} if jcache else {}), jnp.asarray(x), mutable=["pab"])
    tmod = name_sites(load_jax_params(tmm.MotionModule(32, cfg), tree))
    cache = pab_cache_from_jax(jcache) if jcache else {}
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), mode, cache)
    close(got.numpy(), want)
    assert_caches_close(cache, jmut["pab"])
