"""Port parity: the UNet3D attention options (cross-frame self-attention,
the in-block temporal attention, the T5 cross-attention,
``use_linear_projection``, ``upcast_attention``), their PAB sites, the
mixed-dtype attention of ``upcast_attention``, and the routes.

The harness, sizes and the 5e-4 tolerance are those of
``tests/test_torch_unet_options.py``: each option through the jitted JAX
UNet and the port in fp32 on the CPU, two clips a call, the context (and
the T5 states) plain and CFG-doubled, every parameter random (the
zero-initialised T5 projection included). The mixed-dtype attention holds
the JAX plain path to 1e-5 relative to its largest output. The routes run
on the stand-in card of ``tests/test_torch_motion_options.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.models import pab as jpab
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.ops import attention as jops
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.ops import attention as tops
from followyourclick_tpu_torch.utils.convert import (
    load_jax_params,
    pab_cache_from_jax,
)
from tests.test_torch_motion_options import CudaLike, stand_in_card
from tests.test_torch_unet_options import (
    BASE,
    TOL,
    check_option,
    inputs,
    tree_for,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

OPTIONS = {
    "cross_frame_attention": dict(unet_use_cross_frame_attention=True),
    "temporal_attention": dict(unet_use_temporal_attention=True),
    "text_encoder_2": dict(use_text_encoder_2=True),
    "linear_projection": dict(use_linear_projection=True),
    "upcast_attention": dict(upcast_attention=True,
                             unet_use_cross_frame_attention=True),
}


@pytest.mark.parametrize("cfg_batch", [1, 2])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option, cfg_batch):
    check_option(OPTIONS[option], cfg_batch)


def test_t5_attention_is_skipped_without_t5_states():
    """A call without ``context_t5`` (the video_scale per-frame pass) skips
    every ``attn_t5``: the prediction equals the JAX UNet's on the same
    call and differs from one with T5 states."""
    cfg = dataclasses.replace(BASE, **OPTIONS["text_encoder_2"])
    tree = tree_for(cfg)
    x, ts, cond, _ = inputs(cfg, 2, seed=3)
    t5 = cond.pop("context_t5")
    want = jax.jit(JUNet(cfg).apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(ts),
        JCond(**{k: jnp.asarray(v) for k, v in cond.items()}))
    unet = load_jax_params(UNet3DConditionModel(cfg), tree)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(ts),
                   UNetConditioning(**tcond))
        with_t5 = unet(torch.from_numpy(x), torch.from_numpy(ts),
                       UNetConditioning(**tcond,
                                        context_t5=torch.from_numpy(t5)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert float((got - with_t5).abs().max()) > 1e-3


@pytest.mark.parametrize("shapes", [
    ((2, 16, 4, 8), (2, 32, 4, 8)),     # cross-frame: twice the keys
    ((6, 8, 4, 8), (6, 8, 4, 8))],      # the tiny-sequence shape
    ids=["cross_frame", "tiny"])
def test_mixed_dtype_attention_matches_jax(shapes):
    """``upcast_attention``: q and k in fp32, v in bf16. The port casts v up
    and computes what the JAX plain path does (fp32 weights times v,
    promoted)."""
    q_shape, k_shape = shapes
    rs = np.random.RandomState(0)
    q = rs.randn(*q_shape).astype(np.float32)
    k = rs.randn(*k_shape).astype(np.float32)
    v = torch.from_numpy(rs.randn(*k_shape).astype(np.float32)).to(
        torch.bfloat16)
    got = tops.dot_product_attention(torch.from_numpy(q),
                                     torch.from_numpy(k), v)
    want = np.asarray(jops.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v.float().numpy(),
                                                    jnp.bfloat16)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_cross_frame_attention_routes_as_jax():
    """Cross-frame self-attention has twice the keys: at 1 clip, 512², the
    level-0 blocks after the CFG duplication (32 rows of 4096 queries over
    8192 keys, 16 GiB of bf16 scores) cross the flash line; the stem's, at
    16 rows (8 GiB), stays plain. The rule ignores the dtype, so upcast
    attention keeps the route."""
    assert tops.route((32, 4096, 8, 40), (32, 8192, 8, 40), False) == \
        "flash"
    assert tops.route((16, 4096, 8, 40), (16, 8192, 8, 40), False) == \
        "plain"
    # the in-block temporal attention at level 0: the tiny-sequence kernel
    assert tops.route((8192, 16, 8, 40), (8192, 16, 8, 40), False) == "tiny"


@pytest.mark.parametrize("upcast", [False, True])
def test_cross_frame_attention_launches_flash_on_the_card(monkeypatch,
                                                          upcast):
    """On the stand-in card, with the flash line lowered to this tiny
    UNet's level-0 scores, every cross-frame self-attention of level 0
    launches flash attention: in bf16, or with ``upcast_attention`` in fp32
    on v cast up; the in-block temporal attentions launch the
    tiny-sequence kernel."""
    cfg = dataclasses.replace(BASE, unet_use_cross_frame_attention=True,
                              unet_use_temporal_attention=True,
                              upcast_attention=upcast)
    tree = tree_for(cfg)
    unet = load_jax_params(UNet3DConditionModel(cfg), tree).to(
        torch.bfloat16)
    # the line at the stem's level-0 scores: 8 rows, 4 heads, 64 queries
    # over 128 keys of bf16
    monkeypatch.setattr(tops, "FLASH_SCORE_BYTES", 8 * 4 * 64 * 128 * 2)
    monkeypatch.setattr(tops, "route", _route_from_1024(tops.route))
    x, ts, cond, _ = inputs(cfg, 2)
    with torch.no_grad(), stand_in_card() as counts:
        unet(torch.from_numpy(x).to(torch.bfloat16).as_subclass(CudaLike),
             torch.from_numpy(ts), UNetConditioning(
                 **{k: torch.from_numpy(v).to(torch.bfloat16)
                    if v.dtype == np.float32 else torch.from_numpy(v)
                    for k, v in cond.items()}))
    dtype = torch.float32 if upcast else torch.bfloat16
    # level 0 has the down block's transformer block (the stem: 2 clips x
    # 4 frames, 512 KiB of scores, not above the line) and the last up
    # block's two (16 rows after the CFG duplication)
    flash = [args for name, args in counts.calls if name == "flash_attention"]
    assert flash == [[(dtype, (16, 64, 4, 8)), (dtype, (16, 128, 4, 8)),
                      (dtype, (16, 128, 4, 8))]] * 2
    # the in-block temporal attention of every spatial transformer block
    assert counts["temporal_attention"] == 4


def _route_from_1024(route):
    """``route`` with the flash line's 1024-key floor lowered to 128 keys,
    so a tiny UNet's level-0 cross-frame attention can cross it."""
    def lowered(q_shape, k_shape, has_bias, impl="auto"):
        kind = route(q_shape, k_shape, has_bias, impl)
        b, sq, h, _ = q_shape
        sk = k_shape[1]
        if kind == "plain" and impl == "auto" and not has_bias \
                and sk >= 128 and b * h * sq * sk * 2 > tops.FLASH_SCORE_BYTES:
            return "flash"
        return kind
    return lowered


RECORD = PabMode(record_spatial=True, record_cross=True,
                 record_temporal=True)
REUSE = dataclasses.replace(RECORD, reuse_spatial=True, reuse_cross=True,
                            reuse_temporal=True)


def test_t5_and_temporal_pab_sites_match_jax():
    """The sites ``attn_t5_out`` (cross) and ``attn_temp_out`` (temporal):
    a recording step gives the JAX cache, and a reusing step reads it (a
    doctored JAX cache gives the JAX output, away from the recorded
    one)."""
    cfg = dataclasses.replace(BASE, use_text_encoder_2=True,
                              unet_use_temporal_attention=True)
    tree = tree_for(cfg)
    x, ts, cond, _ = inputs(cfg, 2, seed=5)
    x = np.concatenate([x, x])  # a serving step's pre-duplicated input
    ts = np.concatenate([ts, ts])
    jcond = JCond(**{k: jnp.asarray(v) for k, v in cond.items()})
    tcond = UNetConditioning(**{k: torch.from_numpy(v)
                                for k, v in cond.items()})
    unet = load_jax_params(UNet3DConditionModel(cfg), tree)

    def jax_apply(mode, cache=None):
        variables = {"params": tree, **({} if cache is None
                                        else {"pab": cache})}
        jmode = jpab.PabMode(**dataclasses.asdict(mode))
        out, mut = jax.jit(lambda v: JUNet(cfg, pab=jmode).apply(
            v, jnp.asarray(x), jnp.asarray(ts), jcond, mutable=["pab"]))(
                variables)
        return np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                       dict(mut["pab"]))

    jout, jcache = jax_apply(RECORD)
    cache = {}
    with torch.no_grad():
        out = unet(torch.from_numpy(x), torch.from_numpy(ts), tcond, RECORD,
                   cache).numpy()
    np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)
    want = pab_cache_from_jax(jcache)
    assert sorted(cache) == sorted(want)
    for site in ("attn_t5_out", "attn_temp_out"):
        keys = [k for k in cache if k.endswith(site)]
        assert len(keys) == 4, (site, keys)
        for key in keys:
            np.testing.assert_allclose(cache[key].numpy(),
                                       want[key].numpy(), rtol=TOL, atol=TOL)
    bad = jax.tree_util.tree_map(lambda a: 0.5 * a, jcache)
    jreuse, _ = jax_apply(REUSE, bad)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(ts), tcond, REUSE,
                   pab_cache_from_jax(bad)).numpy()
    np.testing.assert_allclose(got, jreuse, rtol=TOL, atol=TOL)
    assert np.abs(got - out).max() > 1e-2
