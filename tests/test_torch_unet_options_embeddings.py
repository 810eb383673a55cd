"""Port parity: the UNet3D options on the embedding and motion side
(``num_class_embeds``, the first-frame zero-timestep embedding,
``motion_module_decoder_only``, the motion-module options inside the UNet)
and the two options the port still refuses.

The harness, sizes and the 5e-4 tolerance are those of
``tests/test_torch_unet_options.py``: each option through the jitted JAX
UNet and the port in fp32 on the CPU, two clips a call, the context plain
and CFG-doubled, every parameter random.
"""

import dataclasses

import numpy as np
import pytest
import torch

from followyourclick_tpu.config import MotionModuleConfig
from followyourclick_tpu_torch.models.motion_module import MotionModule
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from tests.test_torch_unet_options import BASE, check_option
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

OPTIONS = {
    "num_class_embeds": dict(num_class_embeds=5),
    "motion_module_decoder_only": dict(motion_module_decoder_only=True),
    # RoPE, temporal LoRA, a _Cross block and dim_div 2 in every module
    "motion_options": dict(motion_module=MotionModuleConfig(
        num_attention_heads=4, use_rope_position_encoding=True,
        add_temporal_lora=True, temporal_attention_dim_div=2,
        attention_block_types=("Temporal_Self", "Temporal_Cross"),
        train_video_length=2)),
}


@pytest.mark.parametrize("cfg_batch", [1, 2])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option, cfg_batch):
    check_option(OPTIONS[option], cfg_batch)


@pytest.mark.parametrize("cfg_batch", [1, 2])
def test_first_frame_zero_timestep_matches_jax(cfg_batch):
    """``UNetConditioning.first_frame_zero_timestep``: frame 0 of every
    resnet takes the t = 0 projection (at the clips' batch, tiled where
    the batch doubles), and the prediction differs from the flag off."""
    got = check_option({}, cfg_batch, zero_timestep=True)
    off = check_option({}, cfg_batch)
    assert np.abs(got[:, 0] - off[:, 0]).max() > 1e-3


def test_class_labels_move_the_prediction():
    """Two class labels give two predictions; a UNet with class
    embeddings needs the labels."""
    cfg = dataclasses.replace(BASE, **OPTIONS["num_class_embeds"])
    unet = UNet3DConditionModel(cfg)
    assert unet.class_embedding.weight.shape == (5, cfg.time_embed_dim)
    with torch.no_grad():
        x = torch.randn(1, 2, 8, 8, 9)
        cond = dict(context=torch.randn(1, 77, 48), fps=torch.tensor([8.0]),
                    motion_score=torch.tensor([20.0]))
        a = unet(x, torch.tensor([501]), UNetConditioning(
            **cond, class_labels=torch.tensor([0])))
        b = unet(x, torch.tensor([501]), UNetConditioning(
            **cond, class_labels=torch.tensor([3])))
        assert float((a - b).abs().max()) > 1e-4
        with pytest.raises(ValueError, match="class_labels"):
            unet(x, torch.tensor([501]), UNetConditioning(**cond))


def test_decoder_only_drops_the_down_motion_modules():
    unet = UNet3DConditionModel(dataclasses.replace(
        BASE, **OPTIONS["motion_module_decoder_only"]))
    names = [n for n, m in unet.named_modules()
             if isinstance(m, MotionModule)]
    assert names and not any(n.startswith("down_blocks") for n in names)
