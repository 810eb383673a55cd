"""The port's own configuration dataclasses against the JAX package's.

``followyourclick_tpu_torch/config.py`` keeps a copy of the six dataclasses
(the port imports nothing of the JAX package). Here the copy is pinned to
the original field for field (names, types, defaults, nested defaults) and
the reference YAML loads to equal trees through both.
"""

import dataclasses

import pytest

from followyourclick_tpu import config as jcfg
from followyourclick_tpu_torch import config as tcfg

NAMES = ("NoiseScheduleConfig", "MotionModuleConfig", "UNet3DConfig",
         "VAEConfig", "CLIPTextConfig", "InferenceConfig")


def _fields(cls):
    return [(f.name, str(f.type), f.default,
             f.default_factory if f.default_factory is dataclasses.MISSING
             else dataclasses.asdict(f.default_factory()))
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", NAMES)
def test_dataclass_matches_the_jax_one(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    assert ours is not theirs
    assert ours.__module__ == "followyourclick_tpu_torch.config"
    assert _fields(ours) == _fields(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_unet_properties_match():
    for kw in ({}, dict(use_first_frame_condition_concat=True),
               dict(use_first_frame_mask_condition_concat=False)):
        ours, theirs = tcfg.UNet3DConfig(**kw), jcfg.UNet3DConfig(**kw)
        assert ours.conv_in_channels == theirs.conv_in_channels
        assert ours.time_embed_dim == theirs.time_embed_dim


def test_from_yaml_matches():
    path = "configs/inference/inference.yaml"
    ours = tcfg.InferenceConfig.from_yaml(path)
    theirs = jcfg.InferenceConfig.from_yaml(path)
    assert isinstance(ours, tcfg.InferenceConfig)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_from_dict_reads_the_reference_keys():
    d = {"unet_additional_kwargs": {
             "motion_module_kwargs": {"use_rope_postion_encoding": True,
                                      "rank": 8},
             "block_out_channels": [32, 64], "unknown_key": 1},
         "noise_scheduler_kwargs": {"beta_end": 0.02}}
    ours = tcfg.InferenceConfig.from_dict(d)
    theirs = jcfg.InferenceConfig.from_dict(d)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.unet.motion_module.lora_rank == 8
    assert ours.unet.block_out_channels == (32, 64)
