"""Port parity: the UNet3D options on the conv and input side
(``use_pseudo_conv3d``, ``use_temporal_conv``,
``use_first_frame_condition_concat``, ``center_input_sample``).

A two-level tiny UNet (widths 32 and 64, one layer per block, a
cross-attention level and a plain one, motion modules on both) runs each
option in fp32 on the CPU through the jitted JAX UNet and the port, two
clips a call, with the context plain (at the clips' batch) and CFG-doubled
(prefix sharing: the stem runs once and the UNet duplicates at the first
cross-attention, tiling what was computed at the clips' batch). Every
parameter is random (``tests/test_torch_unet.random_tree``): the dirac
temporal convs, the zero-initialised last temporal conv, motion-module
``proj_out``, T5 projection and embedding outputs all move the output. The
noise prediction holds 5e-4 (rtol and atol), the UNet tolerance of
``tests/test_torch_unet.py``. The other options are in
``tests/test_torch_unet_options_embeddings.py`` and
``tests/test_torch_unet_options_attention.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import MotionModuleConfig, UNet3DConfig
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import random_tree
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TOL = 5e-4
B, F, HW = 2, 4, 8
T5_DIM, T5_TOKENS, CTX_DIM = 40, 7, 48
# the two-level tiny UNet every option is added to
BASE = UNet3DConfig(
    down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
    up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
    block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
    cross_attention_dim=CTX_DIM, attention_head_dim=4,
    motion_module=MotionModuleConfig(num_attention_heads=4),
    text_encoder_2_dim=T5_DIM)


def sample_channels(cfg):
    """Channels of the sample the caller passes: ``conv_in``'s less the
    first-frame latent the UNet concatenates itself."""
    c = UNet3DConditionModel.conv_in_channels(cfg)
    return c - cfg.in_channels * cfg.use_first_frame_condition_concat


def inputs(cfg, cfg_batch, seed=0, zero_timestep=False):
    """numpy inputs of one call: sample, timesteps, and the conditioning
    fields (context and T5 states at ``cfg_batch`` × the clips' batch)."""
    rs = np.random.RandomState(seed)
    cond = dict(
        context=rs.randn(cfg_batch * B, 77, CTX_DIM).astype(np.float32),
        fps=np.array([8.0, 12.0], np.float32),
        motion_score=np.array([20.0, 35.0], np.float32))
    if cfg.num_class_embeds is not None:
        cond["class_labels"] = np.array([1, cfg.num_class_embeds - 1])
    if cfg.use_text_encoder_2:
        cond["context_t5"] = rs.randn(cfg_batch * B, T5_TOKENS,
                                      T5_DIM).astype(np.float32)
    if cfg.use_first_frame_condition_concat:
        cond["reference_images_latent"] = rs.randn(
            B, HW, HW, cfg.in_channels).astype(np.float32)
    x = rs.randn(B, F, HW, HW, sample_channels(cfg)).astype(np.float32)
    return x, np.array([501, 501]), cond, zero_timestep


@functools.lru_cache(maxsize=None)
def tree_for(cfg, seed=0):
    """Random parameters in the JAX UNet's tree, every optional subtree
    present (T5 states, class labels and the reference latent given)."""
    x, ts, cond, _ = inputs(cfg, 2, seed)
    jcond = JCond(**{k: jnp.asarray(v) for k, v in cond.items()})
    return random_tree(JUNet(cfg).init, jnp.asarray(x), jnp.asarray(ts),
                       jcond, seed=seed)


def run_both(cfg, cfg_batch, tree=None, zero_timestep=False, seed=1):
    """The option's noise prediction through the jitted JAX UNet and the
    port (parameters by ``load_jax_params``, which leaves no leaf unused),
    as numpy."""
    tree = tree_for(cfg) if tree is None else tree
    x, ts, cond, zt = inputs(cfg, cfg_batch, seed, zero_timestep)
    want = jax.jit(JUNet(cfg).apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(ts),
        JCond(**{k: jnp.asarray(v) for k, v in cond.items()},
              first_frame_zero_timestep=zt))
    unet = load_jax_params(UNet3DConditionModel(cfg), tree)
    assert len(jax.tree_util.tree_leaves(tree)) == len(list(
        unet.parameters()))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(ts),
                   UNetConditioning(**{k: torch.from_numpy(v)
                                       for k, v in cond.items()},
                                    first_frame_zero_timestep=zt))
    assert got.shape == (cfg_batch * B, F, HW, HW, 4)
    return got.numpy(), np.asarray(want)


def check_option(overrides, cfg_batch, **kw):
    cfg = dataclasses.replace(BASE, **overrides)
    got, want = run_both(cfg, cfg_batch, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return got


OPTIONS = {
    "pseudo_conv3d": dict(use_pseudo_conv3d=True),
    "temporal_conv": dict(use_temporal_conv=True),
    "first_frame_condition_concat": dict(
        use_first_frame_condition_concat=True,
        use_first_frame_mask_condition_concat=False),
    "center_input_sample": dict(center_input_sample=True),
}


@pytest.mark.parametrize("cfg_batch", [1, 2])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option, cfg_batch):
    check_option(OPTIONS[option], cfg_batch)


def test_pseudo_conv3d_layers_and_inits():
    """``conv_in``, every resnet conv and shortcut become PseudoConv3d; a
    fresh temporal conv is the identity (dirac), so a fresh PseudoConv3d is
    its spatial conv; at one frame the temporal conv is skipped."""
    from followyourclick_tpu_torch.models.resnet import (
        InflatedConv,
        PseudoConv3d,
        TemporalConvBlock,
    )

    unet = UNet3DConditionModel(dataclasses.replace(
        BASE, use_pseudo_conv3d=True, use_temporal_conv=True))
    kinds = {type(m) for name, m in unet.named_modules()
             if name.endswith(("conv1", "conv2", "conv_shortcut", "conv_in"))
             and ".temporal_conv." not in name}
    assert kinds == {PseudoConv3d}
    assert isinstance(unet.conv_out, InflatedConv)
    # every resnet: down 1 + 1, mid 2, up 2 + 2
    assert sum(isinstance(m, TemporalConvBlock)
               for m in unet.modules()) == 8
    conv = PseudoConv3d(8, 16)
    x = torch.randn(2, 5, 6, 6, 8)
    with torch.no_grad():
        spatial = InflatedConv(8, 16)
        spatial.conv.load_state_dict(conv.spatial_conv.state_dict())
        torch.testing.assert_close(conv(x), spatial(x))
        conv.temporal_conv.weight.normal_()
        torch.testing.assert_close(conv(x[:, :1]), spatial(x[:, :1]))
    block = TemporalConvBlock(32)
    assert not block.conv4.weight.any() and block.conv1.weight.any()


def test_fresh_temporal_conv_block_is_the_identity():
    """The last conv of a fresh TemporalConvBlock is zero, bias included,
    as in JAX, so the block returns its input."""
    from followyourclick_tpu_torch.models.resnet import TemporalConvBlock

    torch.manual_seed(0)
    block = TemporalConvBlock(32)
    x = torch.randn(2, 4, 3, 3, 32)
    with torch.no_grad():
        torch.testing.assert_close(block(x), x, rtol=0, atol=0)


def test_conv_in_takes_the_concatenated_channels():
    """``conv_in`` sees the caller's channels plus the first-frame latent
    the UNet concatenates: 4 + 4, 9 + 4 with the click-mask concat too."""
    for overrides, want in ((dict(use_first_frame_condition_concat=True,
                                  use_first_frame_mask_condition_concat=False),
                             8),
                            (dict(use_first_frame_condition_concat=True), 13),
                            ({}, 9)):
        cfg = dataclasses.replace(BASE, **overrides)
        assert UNet3DConditionModel(cfg).conv_in.conv.in_channels == want


def test_entry_gives_one_cfg_step_of_the_flagship_config():
    """``followyourclick_tpu_torch.entry.entry``: the full-width UNet (built
    and run on the meta device here: no weights, no arithmetic) takes the
    one-clip sample with the CFG-doubled context and returns the doubled
    noise prediction."""
    from followyourclick_tpu_torch.entry import entry

    fn, (sample, timesteps, cond) = entry(device="meta")
    assert sample.shape == (1, 8, 32, 32, 9)
    assert cond.context.shape == (2, 77, 768)
    assert fn(sample, timesteps, cond).shape == (2, 8, 32, 32, 4)
