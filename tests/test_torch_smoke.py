"""The launch counts that ``chip_smoke.py`` holds its main paths to.

``chip_smoke.expected_launches`` works each kernel's launches out from a
request's ``step_plan``, its clip shape and batch, and the UNet's module
tree alone, with the whole-block motion kernel's fit rule and the flash
route's line written out. Here it runs on the default ``InferenceConfig``
UNet built on the meta device (no weights are allocated) and must give the
counts worked out by hand: on the serving path the smoke's own
``SERVING_LAUNCHES``, on the exact path 20 whole-block motion kernels and
16 LN-GEGLU feed-forwards per step, in fp32 the modular route for the
blocks at C ≥ 640, and at two clips per request 4 flash launches per exact
step and 20 per 10-step ``pab488_deep4_cfg4_ex`` request; the
``video_scale`` per-frame pass (20 motion blocks at F = 1 a step), every
solver's UNet calls, no CFG and the unshared prefix. The IP-Adapter
Plus UNet (16 ip tokens) launches as the exact path does. The smoke's
GroupNorm sites, read by hooks from a meta-device run, are the module
tree's; every evaluation launches the GroupNorm kernel once at each of its
81 norms (a trunk-reuse step at level 0's 20 and ``conv_norm_out``), each
VAE encoder call 22 times and each decoder call 30 times.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.layers import GroupNorm
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.ops.attention import route
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

SERVING = apply_schedule(
    SampleSpec(num_inference_steps=chip_smoke.SERVING_STEPS),
    chip_smoke.SERVING_SCHEDULE)


@pytest.fixture(scope="module")
def meta_unet():
    with torch.device("meta"):
        return UNet3DConditionModel(InferenceConfig().unet)


def _counts(motion, geglu, block, attn, flash=0, *, norms):
    return {"fused_motion_block": motion, "fused_ln_geglu": geglu,
            "fused_temporal_block": block, "temporal_attention": attn,
            "flash_attention": flash, "fused_group_norm": norms}


@pytest.mark.parametrize("spec, dtype, batch, want", [
    (SERVING, torch.bfloat16, 1, chip_smoke.SERVING_LAUNCHES),
    # every step runs the 81 GroupNorms
    (SampleSpec(num_inference_steps=4), torch.bfloat16, 1,
     _counts(80, 64, 0, 0, norms=324)),
    # fp32: the 5 blocks at C = 320 fit the whole-block kernel; the 15 at
    # 640 and 1280 take the modular path (their FFs join the 16 spatial)
    (SampleSpec(num_inference_steps=1), torch.float32, 1,
     _counts(5, 31, 10, 20, norms=81)),
    (SERVING, torch.bfloat16, chip_smoke.BATCH,
     chip_smoke.BATCHED_SERVING_LAUNCHES),
    (SampleSpec(num_inference_steps=4), torch.bfloat16, chip_smoke.BATCH,
     _counts(80, 64, 0, 0, 4 * chip_smoke.BATCHED_FLASH_PER_EXACT_STEP,
             norms=324)),
    # cfg_cache3 at 6 steps: full steps 0, 3 and the 2 final exact ones run
    # 4 flash attentions each at two clips; the 2 cond-only steps none
    (apply_schedule(SampleSpec(num_inference_steps=6), "cfg_cache3"),
     torch.bfloat16, 2, _counts(120, 96, 0, 0, 16, norms=486)),
    # three clips: the first level-0 attention (48 rows, exactly 12 GiB)
    # still stays below the line
    (SampleSpec(num_inference_steps=1), torch.bfloat16, 3,
     _counts(20, 16, 0, 0, 4, norms=81)),
    # video_scale: each step adds the per-frame pass (F = 1), 20 more
    # whole-block motion calls and 16 more LN-GEGLU; its 32 rows at 2 clips
    # (8 GiB of scores) stay below the flash line
    (SampleSpec(num_inference_steps=4, video_scale=1.5), torch.bfloat16, 1,
     _counts(160, 128, 0, 0, norms=648)),
    (SampleSpec(num_inference_steps=1, video_scale=1.5), torch.bfloat16, 2,
     _counts(40, 32, 0, 0, 4, norms=162)),
    # the solvers' calls: PNDM's PLMS grid S+1, its PRK grid S+9, the
    # others S
    (SampleSpec(num_inference_steps=4, scheduler="pndm"), torch.bfloat16, 1,
     _counts(100, 80, 0, 0, norms=405)),
    (SampleSpec(num_inference_steps=4, scheduler="pndm_prk"),
     torch.bfloat16, 1, _counts(260, 208, 0, 0, norms=1053)),
    (SampleSpec(num_inference_steps=4, scheduler="euler_a"),
     torch.bfloat16, 1, _counts(80, 64, 0, 0, norms=324)),
    # no CFG: the 32 rows of 2 clips are never doubled, no flash; the
    # unshared prefix doubles before the first block: 5 flash a step
    (SampleSpec(num_inference_steps=1, guidance_scale=1.0), torch.bfloat16,
     2, _counts(20, 16, 0, 0, 0, norms=81)),
    (SampleSpec(num_inference_steps=1, share_cfg_prefix=False),
     torch.bfloat16, 2, _counts(20, 16, 0, 0, 5, norms=81)),
    # the CFG cache is off under video_scale and without CFG, as in JAX
    (apply_schedule(SampleSpec(num_inference_steps=6, video_scale=1.5),
                    "cfg_cache3"), torch.bfloat16, 1,
     _counts(240, 192, 0, 0, norms=972)),
], ids=["serving", "exact-bf16", "exact-fp32", "serving-2clips",
        "exact-2clips", "cfg_cache3-2clips", "exact-3clips", "video_scale",
        "video_scale-2clips", "pndm", "pndm_prk", "euler_a", "no_cfg-2clips",
        "unshared-2clips", "cfg_cache3-video_scale"])
def test_expected_launches_match_the_hand_count(meta_unet, spec, dtype,
                                                batch, want):
    assert chip_smoke.expected_launches(meta_unet, spec, dtype,
                                        batch) == want


def test_batched_hand_counts():
    assert chip_smoke.BATCHED_FLASH_PER_EXACT_STEP == 4
    assert chip_smoke.BATCHED_SERVING_LAUNCHES == {
        **chip_smoke.SERVING_LAUNCHES, "flash_attention": 20}


@pytest.mark.parametrize("rows", [16, 32, 48, 49, 64, 96])
@pytest.mark.parametrize("tokens", [1024, 4096])
def test_flash_line_is_the_ports_route(rows, tokens):
    """The smoke's written-out flash rule agrees with the port's route for
    level-0 self-attention shapes (8 heads of 40)."""
    shape = (rows, tokens, 8, 40)
    assert chip_smoke.flash_line(rows, tokens, 8) == (
        route(shape, shape, False) == "flash")


def test_ip_plus_unet_launches_as_the_exact_path(meta_unet):
    cfg = InferenceConfig().unet
    with torch.device("meta"):
        ip_unet = UNet3DConditionModel(dataclasses.replace(
            cfg, use_ip_cross_attention=True,
            ip_num_tokens=chip_smoke.IP_TOKENS))
    spec = SampleSpec(num_inference_steps=4)
    assert chip_smoke.expected_launches(ip_unet, spec, torch.bfloat16) == \
        chip_smoke.expected_launches(meta_unet, spec, torch.bfloat16) == \
        _counts(80, 64, 0, 0, norms=324)


def test_group_norm_sites_are_the_module_tree(meta_unet):
    """One call per GroupNorm module and evaluation, at 16 f / 512²: every
    resnet and conv_norm_out norm (SiLU, statistics over the clip) and
    every spatial-transformer and motion-module norm (no act, per frame,
    16 frames × the CFG batch)."""
    sites = chip_smoke.group_norm_sites(InferenceConfig().unet,
                                        SampleSpec())
    norms = [m for m in meta_unet.modules() if isinstance(m, GroupNorm)]
    assert sum(sites.values()) == len(norms) == 81
    assert sum(n for k, n in sites.items() if k[5] is None) == sum(
        m.act is None for m in norms) == 36
    assert sites[(2, 65536, 320, 32, 1e-5, "silu")] == 6
    assert sites[(32, 4096, 320, 32, 1e-6, None)] == 9
    assert all(c <= 2560 and c % 8 == 0 for _, _, c, *_ in sites)


def test_wrappers_replaced_reaches_every_call_site():
    """The smoke's full-width evaluation phase runs the UNet once with every
    routed wrapper replaced by its plain version: inside
    ``wrappers_replaced`` each name the model modules call refers to the
    replacement, the wrappers' own modules keep theirs, and all is restored
    on exit."""
    import followyourclick_tpu_torch.models.attention as attention
    import followyourclick_tpu_torch.models.motion_module as motion_module
    import followyourclick_tpu_torch.ops.attention as ops_attention
    import followyourclick_tpu_torch.ops.motion_block as motion_block

    sites = [(motion_module, "fused_motion_block"),
             (motion_module, "fused_temporal_block"),
             (attention, "fused_ln_geglu"),
             (ops_attention, "flash_attention"),
             (ops_attention, "temporal_attention")]
    before = [getattr(mod, name) for mod, name in sites]
    plain = chip_smoke.plain_versions()
    assert sorted(plain) == sorted(chip_smoke.KERNELS)
    with chip_smoke.wrappers_replaced(lambda name, _: plain[name]):
        assert [getattr(mod, name) for mod, name in sites] == [
            plain[name] for _, name in sites]
        assert motion_block.fused_motion_block is before[0]
    assert [getattr(mod, name) for mod, name in sites] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_are_the_cpu_wrappers(dtype):
    """Called as the model calls the wrappers, the smoke's plain stand-ins
    give what the wrappers give on a CPU tensor (their plain versions),
    the default gate form included."""
    rs = np.random.RandomState(0)

    def mk(*shape, s=1.0, base=0.0):
        return torch.from_numpy((base + s * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    c = 64
    params = []
    for _ in range(2):
        params += [mk(c, s=0.05, base=1.0), mk(c, s=0.05)] + [
            mk(c, c, s=c ** -0.5) for _ in range(4)] + [mk(c, s=0.02)]
    params += [mk(c, s=0.05, base=1.0), mk(c, s=0.05),
               mk(8 * c, c, s=c ** -0.5), mk(8 * c, s=0.02),
               mk(c, 4 * c, s=0.25 / c ** 0.5), mk(c, s=0.02)]
    x, pe = mk(3, 8, c), mk(8, c, s=0.5)
    plain = chip_smoke.plain_versions()
    wrappers = chip_smoke.kernel_wrappers()
    args = (x, pe, params, 0.25, 4)
    assert torch.equal(plain["fused_motion_block"](*args, qkv=None),
                       wrappers["fused_motion_block"](*args))
    rows = x.reshape(-1, c)
    assert torch.equal(plain["fused_ln_geglu"](rows, *params[14:], eps=1e-5,
                                               residual=True),
                       wrappers["fused_ln_geglu"](rows, *params[14:],
                                                  eps=1e-5, residual=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_block_stand_in_takes_the_concatenated_weight(dtype):
    """The modular path calls ``fused_temporal_block`` with ``qkv=``; the
    smoke's plain stand-in takes it and gives the CPU wrapper's result."""
    rs = np.random.RandomState(1)

    def mk(*shape, s=1.0):
        return torch.from_numpy((s * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    c = 64
    x, ws, bo = mk(3, 8, c), [mk(c, c, s=c ** -0.5) for _ in range(4)], \
        mk(c, s=0.02)
    qkv = torch.cat(ws[:3])
    plain = chip_smoke.plain_versions()["fused_temporal_block"]
    wrapper = chip_smoke.kernel_wrappers()["fused_temporal_block"]
    assert torch.equal(plain(x, *ws, bo, scale=0.25, heads=4, qkv=qkv),
                       wrapper(x, *ws, bo, scale=0.25, heads=4, qkv=qkv))


def test_modular_evaluation_launches(meta_unet):
    """Phase 4's second evaluation: one full step under
    ``PabMode(record_temporal=True)`` takes every motion block off the
    whole-block kernel: 2 ``fused_temporal_block`` calls in each of the 10
    blocks at C < 1280, 2 ``temporal_attention`` calls in each of the 10 at
    1280, and one LN-GEGLU per block beside the 16 spatial ones."""
    from followyourclick_tpu_torch.models.pab import PabMode
    from followyourclick_tpu_torch.pipelines.animation import PlanStep

    plan = [PlanStep(0, 0, True, PabMode(record_temporal=True))]
    assert chip_smoke.expected_launches(
        meta_unet, SampleSpec(num_inference_steps=1), torch.bfloat16,
        plan=plan) == _counts(0, 36, 20, 20, norms=81)


@pytest.mark.parametrize("encodes,decodes,norms", [(1, 1, 22 + 30),
                                                   (0, 1, 30), (2, 3, 134)])
def test_a_request_adds_its_vae_calls(meta_unet, encodes, decodes, norms):
    """Each VAE encoder call launches its 22 GroupNorms, each decoder call
    its 30; no other kernel moves."""
    from followyourclick_tpu_torch.models.vae import AutoencoderKL

    with torch.device("meta"):
        vae = AutoencoderKL(InferenceConfig().vae)
    spec = SampleSpec(num_inference_steps=2)
    base = chip_smoke.expected_launches(meta_unet, spec, torch.bfloat16)
    got = chip_smoke.expected_launches(meta_unet, spec, torch.bfloat16,
                                       vae=vae, encodes=encodes,
                                       decodes=decodes)
    assert got == {**base, "fused_group_norm": 162 + norms}


@pytest.mark.parametrize("part,norms", [("encoder", 22), ("decoder", 30)])
def test_each_vae_part_launches_its_group_norms(part, norms):
    """One launch a GroupNorm module of the part, and its smoke sites (one
    call at the smoke's VAE shapes) count the same norms."""
    from followyourclick_tpu_torch.models.vae import AutoencoderKL

    cfg = InferenceConfig()
    with torch.device("meta"):
        vae = AutoencoderKL(cfg.vae)
    assert chip_smoke.group_norm_launches(getattr(vae, part)) == norms
    (_, frames, h, w, decode), = [
        call for call in chip_smoke.VAE_GROUP_NORM_CALLS
        if call[4] == (part == "decoder")]
    assert sum(chip_smoke.vae_group_norm_sites(
        cfg.vae, frames, h, w, decode).values()) == norms
