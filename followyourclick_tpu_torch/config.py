"""The port's configuration tree: its own copy of the JAX package's dataclasses.

The six dataclasses of ``followyourclick_tpu/config.py`` with the same field
names, types and defaults, ``_filter_kwargs`` and the YAML loader
(``InferenceConfig.from_yaml``), so that the reference's YAML files load
unchanged. The port keeps a copy rather than importing the JAX package: that
package's ``__init__`` is part of it, and the port imports none of it.
``tests/test_torch_config.py`` pins the copy to the original field for field.
Port modules read a config by attribute, so a JAX config object works in its
place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


def _filter_kwargs(cls, kwargs: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


@dataclass(frozen=True)
class NoiseScheduleConfig:
    """Mirrors the reference ``noise_scheduler_kwargs``
    (``configs/inference/inference_img_embed_mask_condition_zero_snr_.yaml``)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = True
    prediction_type: str = "v_prediction"  # "epsilon" | "sample" | "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "leading"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NoiseScheduleConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class MotionModuleConfig:
    """Mirrors the reference ``motion_module_kwargs``
    (``animatediff/models/motion_module.py:51-95``)."""

    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: Sequence[str] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 24
    temporal_attention_dim_div: int = 1
    zero_initialize: bool = True
    # RoPE variant (reference animatediff/models/rope.py) for inference beyond
    # the trained frame count; sinusoidal PE is the released-checkpoint default.
    use_rope_position_encoding: bool = False
    train_video_length: int = 16
    # Per-projection temporal LoRA (reference motion_module.py:306-326).
    add_temporal_lora: bool = False
    lora_rank: int = 4

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MotionModuleConfig":
        d = dict(d)
        # accept the reference's misspelled key
        if "use_rope_postion_encoding" in d:
            d["use_rope_position_encoding"] = d.pop("use_rope_postion_encoding")
        if "rank" in d:
            d["lora_rank"] = d.pop("rank")
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class UNet3DConfig:
    """Architecture config for the 3D UNet.

    Covers the SD-1.5 base surface (reference ``animatediff/models/unet.py:39-105``)
    plus all Follow-Your-Click additions (``unet_additional_kwargs``).
    """

    sample_size: int | None = None
    in_channels: int = 4
    out_channels: int = 4
    center_input_sample: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    mid_block_type: str = "UNetMidBlock3DCrossAttn"
    up_block_types: Sequence[str] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    act_fn: str = "silu"
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    # diffusers-SD1.5 convention: this is the NUMBER OF HEADS (8), not head dim.
    attention_head_dim: int = 8
    use_linear_projection: bool = False
    upcast_attention: bool = False
    resnet_time_scale_shift: str = "default"
    class_embed_type: str | None = None
    num_class_embeds: int | None = None

    # --- Follow-Your-Click additions (unet_additional_kwargs) ---
    use_motion_module: bool = True
    motion_module_resolutions: Sequence[int] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_module_decoder_only: bool = False
    motion_module: MotionModuleConfig = field(default_factory=MotionModuleConfig)
    unet_use_cross_frame_attention: bool = False
    unet_use_temporal_attention: bool = False
    use_inflated_groupnorm: bool = False
    use_pseudo_conv3d: bool = False
    use_temporal_conv: bool = False
    # first-frame latent (4ch) duplicated onto every frame, conv_in widened 4->8
    use_first_frame_condition_concat: bool = False
    # click-mask conditioning: latents(4) + mask(1) + first-frame latent(4) = 9ch
    use_first_frame_mask_condition_concat: bool = True
    use_fps_condition: bool = True
    use_camera_motion_condition: bool = False
    # IP-Adapter image-prompt tokens appended to the text sequence
    use_ip_cross_attention: bool = False
    ip_scale: float = 1.0
    ip_num_tokens: int = 4
    image_condition_dim: int = 1024
    # second (T5) text encoder projected into cross-attn
    use_text_encoder_2: bool = False
    text_encoder_2_dim: int = 4096

    @property
    def conv_in_channels(self) -> int:
        if self.use_first_frame_condition_concat:
            return self.in_channels * 2
        if self.use_first_frame_mask_condition_concat:
            return self.in_channels * 2 + 1
        return self.in_channels

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "UNet3DConfig":
        d = dict(d)
        mm_kwargs = d.pop("motion_module_kwargs", None)
        d.pop("motion_module_type", None)  # only "Vanilla" exists
        kwargs = _filter_kwargs(cls, d)
        for key in ("down_block_types", "up_block_types", "block_out_channels",
                    "motion_module_resolutions"):
            if key in kwargs and kwargs[key] is not None:
                kwargs[key] = tuple(kwargs[key])
        if mm_kwargs is not None:
            kwargs["motion_module"] = MotionModuleConfig.from_dict(mm_kwargs)
        return cls(**kwargs)


@dataclass(frozen=True)
class VAEConfig:
    """SD-1.5 AutoencoderKL architecture (reference ``diffusers/models/vae.py:501``)."""

    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Sequence[str] = (
        "DownEncoderBlock2D",
        "DownEncoderBlock2D",
        "DownEncoderBlock2D",
        "DownEncoderBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpDecoderBlock2D",
        "UpDecoderBlock2D",
        "UpDecoderBlock2D",
        "UpDecoderBlock2D",
    )
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    act_fn: str = "silu"
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VAEConfig":
        kwargs = _filter_kwargs(cls, d)
        for key in ("down_block_types", "up_block_types", "block_out_channels"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (SD-1.5's text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CLIPTextConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class InferenceConfig:
    """One file = the reference's ``--inference_config`` YAML surface."""

    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    noise_scheduler: NoiseScheduleConfig = field(default_factory=NoiseScheduleConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip_text: CLIPTextConfig = field(default_factory=CLIPTextConfig)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "InferenceConfig":
        kwargs = {}
        if "unet_additional_kwargs" in d or "unet" in d:
            kwargs["unet"] = UNet3DConfig.from_dict(
                d.get("unet", d.get("unet_additional_kwargs", {})))
        if "noise_scheduler_kwargs" in d or "noise_scheduler" in d:
            kwargs["noise_scheduler"] = NoiseScheduleConfig.from_dict(
                d.get("noise_scheduler", d.get("noise_scheduler_kwargs", {})))
        if "vae" in d:
            kwargs["vae"] = VAEConfig.from_dict(d["vae"])
        if "clip_text" in d:
            kwargs["clip_text"] = CLIPTextConfig.from_dict(d["clip_text"])
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "InferenceConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))
