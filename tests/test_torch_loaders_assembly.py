"""The port's pipeline assembly from checkpoint files against the JAX
package's (``utils/loaders.assemble_pipeline_from_pretrained``).

One tiny synthetic SD directory (``chip_smoke.write_sd_directory``: UNet,
VAE and CLIP text ``.safetensors`` in the reference's names, fp32, and a
DDP-prefixed motion-module ``.ckpt``; UNet widths 32-64 with two layers a
block, as the LDM layout of ``tests/test_convert_fullshape._hf_to_ldm_unet``
needs) goes through both assemblies, fp32 on the CPU:

- ``base``: the directory and the motion module;
- ``full``: plus a personalized LDM ``.safetensors`` (another UNet and CLIP
  under ``model.diffusion_model.`` / ``cond_stage_model.transformer.``), a
  kohya SD LoRA (UNet and text encoder), a camera-motion LoRA and a tiny T5
  encoder directory (``config.json`` + ``model.safetensors``);
- ``ip_vanilla``: IP-Adapter vanilla with a CLIP vision directory and a
  released ip checkpoint (``{"image_proj", "ip_adapter"}``, the k/v
  weights grafted by position);
- ``ip_plus``: IP-Adapter Plus, the Resampler and the ip k/v weights riding
  in the motion-module checkpoint.

Every parameter of the port's pipeline must equal ``load_jax_params`` of
the JAX tree exactly, and the ``[load_unet3d]`` audit lines (missing,
unexpected, mismatched) must be the same. The JAX IP path builds a ViT-H
tower config by default; both packages' ``CLIPVisionConfig`` are replaced
by a tiny one for the test. The JAX loader lays the checkpoint over its
UNet's initialised tree; every case here covers every parameter, so the
initial values never reach the result, and the test gives the JAX UNet's
``init`` zeros in the shapes ``jax.eval_shape`` traces (5 s instead of the
eager init's ~47 s on one CPU worker).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
import followyourclick_tpu.models.ip_adapter as jip
import followyourclick_tpu_torch.models.ip_adapter as tip
from followyourclick_tpu.config import InferenceConfig as JInference
from followyourclick_tpu.utils.loaders import (
    assemble_pipeline_from_pretrained as jax_assemble,
)
from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.t5_text import (
    T5EncoderModel,
    t5_config_from_hf,
)
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.utils.convert import load_jax_params, module_tree
from followyourclick_tpu_torch.utils.loaders import (
    assemble_pipeline_from_pretrained,
)
from tests.test_convert_fullshape import _hf_to_ldm_unet
from tests.test_torch_lora import _kohya, motion_lora
from tests.test_torch_loaders import _t5_state
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CFG_DICT = {
    "unet": dict(sample_size=8, cross_attention_dim=768,
                 attention_head_dim=8, block_out_channels=[32, 64, 64, 64],
                 layers_per_block=2, norm_num_groups=8,
                 motion_module_kwargs={"num_attention_heads": 4},
                 use_fps_condition=True,
                 use_first_frame_mask_condition_concat=True),
    "vae": dict(block_out_channels=[32, 64, 64, 64], layers_per_block=1,
                norm_num_groups=8, sample_size=64),
    "clip_text": dict(vocab_size=1000, hidden_size=768,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4),
}
CFG = InferenceConfig.from_dict(CFG_DICT)
JCFG = JInference.from_dict(CFG_DICT)
T5_HF = {"vocab_size": 50, "d_model": 16, "d_kv": 4, "d_ff": 24,
         "num_layers": 2, "num_heads": 2, "feed_forward_proj": "gated-gelu"}


@dataclasses.dataclass(frozen=True)
class TinyVision(tip.CLIPVisionConfig):
    hidden_size: int = 32
    intermediate_size: int = 64
    num_hidden_layers: int = 2
    num_attention_heads: int = 2
    image_size: int = 28
    patch_size: int = 14
    projection_dim: int = 24


@dataclasses.dataclass(frozen=True)
class JTinyVision(jip.CLIPVisionConfig):
    hidden_size: int = 32
    intermediate_size: int = 64
    num_hidden_layers: int = 2
    num_attention_heads: int = 2
    image_size: int = 28
    patch_size: int = 14
    projection_dim: int = 24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("assembly")
    sd = str(root / "sd15")
    _, mm = chip_smoke.write_sd_directory(sd, CFG, 0, "cpu", torch.float32)
    return root, sd, mm


def _ip_unet_weights(cfg, rs):
    """Random (out, in) weights for every to_k_ip / to_v_ip of ``cfg``'s UNet
    with the ip path on, in sorted flax-path order, with their reference
    names."""
    with torch.device("meta"):
        unet = UNet3DConditionModel(cfg)
    out = []
    for path, slot in sorted(chip_smoke._flat(module_tree(unet)).items()):
        if path[-2] in ("to_k_ip", "to_v_ip"):
            tree = np.broadcast_to(np.float32(0), slot.shape)
            for p in reversed(path):
                tree = {p: tree}
            (name,) = chip_smoke.unet_state_from_tree(tree)
            out.append((name, rs.randn(*slot.shape[::-1]).astype(np.float32)
                        / 30))
    return out


def _vision_state(rs):
    """A tiny CLIP vision tower in the transformers names."""
    from tests.test_torch_loaders import _clip_vision_state
    from tests.test_torch_unet import random_tree

    import jax.numpy as jnp

    tree = random_tree(jip.CLIPVisionModel(JTinyVision()).init,
                       jnp.zeros((1, 28, 28, 3)), seed=int(rs.randint(99)))
    return {k: _t(v) for k, v in _clip_vision_state(tree).items()}


def _extras(kind, root, mm_path):
    """The files of one case and the keyword arguments of both
    assemblies."""
    rs = np.random.RandomState({"base": 0, "full": 1, "ip_vanilla": 2,
                                "ip_plus": 3}[kind])
    kw = dict(motion_module_path=mm_path)
    if kind == "full":
        other = str(root / "other")
        trees, _ = chip_smoke.write_sd_directory(other, CFG, 5, "cpu",
                                                 torch.float32)
        # an SD checkpoint holds no motion module
        ldm = _hf_to_ldm_unet({
            k: v for k, v in chip_smoke.unet_state_from_tree(
                trees["unet"]).items() if ".motion_modules." not in k})
        ldm.update({"cond_stage_model.transformer." + k: v for k, v in
                    chip_smoke.clip_state_from_tree(
                        trees["text_encoder"]).items()})
        kw["personalized_ckpt_path"] = str(root / "personal.safetensors")
        chip_smoke.write_safetensors(kw["personalized_ckpt_path"],
                                     {k: v.contiguous()
                                      for k, v in ldm.items()})
        blk = "lora_unet_down_blocks_1_attentions_1_transformer_blocks_0"
        lora = {}
        for name, o, i, conv in (
                (f"{blk}_attn1_to_q", 64, 64, None),
                (f"{blk}_attn2_to_out_0", 64, 64, None),
                (f"{blk}_ff_net_0_proj", 512, 64, None),
                ("lora_unet_down_blocks_1_attentions_0_proj_in", 64, 64,
                 (1, 1)),
                ("lora_unet_up_blocks_1_upsamplers_0_conv", 64, 64, (3, 3)),
                ("lora_te_text_model_encoder_layers_1_self_attn_q_proj",
                 768, 768, None)):
            lora.update(_kohya(rs, name, o, i, conv=conv))
        kw["lora_path"] = str(root / "sd_lora.safetensors")
        chip_smoke.write_safetensors(kw["lora_path"],
                                     {k: _t(v) for k, v in lora.items()})
        kw["lora_alpha"] = 0.7
        kw["motion_lora_path"] = str(root / "camera_lora.ckpt")
        torch.save({k: _t(v) for k, v in motion_lora(CFG.unet).items()},
                   kw["motion_lora_path"])
        kw["motion_lora_alpha"] = 0.9
        t5_dir = root / "t5"
        t5_dir.mkdir()
        (t5_dir / "config.json").write_text(json.dumps(T5_HF))
        chip_smoke.write_safetensors(str(t5_dir / "model.safetensors"),
                                     _t5_state())
        kw["t5_path"] = str(t5_dir)
    elif kind.startswith("ip_"):
        plus = kind == "ip_plus"
        vision = root / f"vision_{kind}"
        vision.mkdir()
        chip_smoke.write_safetensors(str(vision / "model.safetensors"),
                                     _vision_state(rs))
        kw.update(ip_mode="plus" if plus else "raw",
                  image_encoder_path=str(vision))
        ip_cfg = dataclasses.replace(CFG.unet, use_ip_cross_attention=True,
                                     ip_num_tokens=16 if plus else 4)
        ip_weights = _ip_unet_weights(ip_cfg, rs)
        from tests.test_torch_loaders import (
            _image_proj_state,
            _ip_trees,
            _resampler_state,
        )

        trees = _ip_trees()
        if plus:
            # the Resampler and the ip k/v weights inside the motion ckpt
            import jax.numpy as jnp

            from tests.test_torch_unet import random_tree

            resampler = random_tree(
                jip.IPAdapter(vision_config=JTinyVision(),
                              cross_attention_dim=768, num_tokens=16,
                              plus=True).init,
                jnp.zeros((1, 28, 28, 3)), seed=8)["image_proj_model"]
            mm = torch.load(mm_path, weights_only=True)["state_dict"]
            mm.update({"module.image_proj_model." + k: _t(v) for k, v in
                       _resampler_state(resampler).items()})
            mm.update({"module." + k: _t(v) for k, v in ip_weights})
            kw["motion_module_path"] = str(root / "mm_ip_plus.ckpt")
            torch.save({"state_dict": mm}, kw["motion_module_path"])
        else:
            import jax.numpy as jnp

            from tests.test_torch_unet import random_tree

            proj = random_tree(
                jip.IPAdapter(vision_config=JTinyVision(),
                              cross_attention_dim=768, num_tokens=4,
                              plus=False).init,
                jnp.zeros((1, 28, 28, 3)), seed=9)["image_proj_model"]
            state = {"image_proj": {k: _t(v) for k, v in
                                    _image_proj_state(proj).items()},
                     "ip_adapter": {f"{i}.{name.split('.')[-2]}.weight":
                                    _t(w) for i, (name, w)
                                    in enumerate(ip_weights)}}
            kw["ip_ckpt_path"] = str(root / "ip_adapter.bin")
            torch.save(state, kw["ip_ckpt_path"])
        del trees
    return kw


def _assert_module_equals_tree(module, fresh, tree, label):
    want = load_jax_params(fresh, tree)
    got = dict(module.named_parameters())
    for name, ref in want.named_parameters():
        assert got[name].dtype == torch.float32, (label, name)
        torch.testing.assert_close(got[name], ref, rtol=0, atol=0,
                                   msg=f"{label}.{name}")
    assert sorted(got) == sorted(dict(want.named_parameters())), label


_INIT_SHAPES = {}


def _shaped_zeros_init(self, rng, *args, **kwargs):
    """``Module.init`` as zeros in the shapes it would give (traced once a
    module and input shapes)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    key = repr((self, jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), (args, kwargs))))
    if key not in _INIT_SHAPES:
        _INIT_SHAPES[key] = jax.eval_shape(
            lambda r: nn.Module.init(self, r, *args, **kwargs), rng)
    return jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                  _INIT_SHAPES[key])


@pytest.mark.parametrize("kind", ["base", "full", "ip_vanilla", "ip_plus"])
def test_assembly_matches_jax(sd_dir, kind, monkeypatch, capsys):
    from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JU

    root, sd, mm = sd_dir
    monkeypatch.setattr(JU, "init", _shaped_zeros_init)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(jip, "CLIPVisionConfig", JTinyVision)
    monkeypatch.setattr(tip, "CLIPVisionConfig", TinyVision)
    kw = _extras(kind, root, mm)
    capsys.readouterr()
    jpipe = jax_assemble(sd, JCFG, **kw)
    jaudit = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[load_unet3d]")]
    pipe = assemble_pipeline_from_pretrained(sd, CFG, device="cpu", **kw)
    taudit = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[load_unet3d]")]
    assert jaudit == taudit and len(taudit) == 1, (jaudit, taudit)
    assert pipe.dtype == torch.float32 and pipe.device.type == "cpu"
    ucfg = pipe.config.unet
    if kind.startswith("ip_"):
        assert ucfg.use_ip_cross_attention
        assert ucfg.ip_num_tokens == (16 if kind == "ip_plus" else 4)
    params = jpipe.params
    _assert_module_equals_tree(pipe.unet, UNet3DConditionModel(ucfg),
                               params["unet"], "unet")
    _assert_module_equals_tree(pipe.vae, AutoencoderKL(CFG.vae),
                               params["vae"], "vae")
    _assert_module_equals_tree(pipe.text_encoder,
                               CLIPTextModel(CFG.clip_text),
                               params["text_encoder"], "text_encoder")
    if kind.startswith("ip_"):
        _assert_module_equals_tree(
            pipe.ip_adapter, tip.IPAdapter(TinyVision(), 768,
                                           ucfg.ip_num_tokens,
                                           plus=kind == "ip_plus"),
            params["ip_adapter"], "ip_adapter")
    else:
        assert pipe.ip_adapter is None and "ip_adapter" not in params
    if kind == "full":
        _assert_module_equals_tree(
            pipe.t5, T5EncoderModel(t5_config_from_hf(T5_HF)),
            params["t5"], "t5")
    else:
        assert pipe.t5 is None
    # the SD directory has a merges.txt: the port's tokenizer is built
    ids = pipe.tokenizer(["the cat"]).input_ids
    assert ids.shape == (1, 77) and ids.dtype == np.int64
    assert pipe.tokenizer_2 is None


def test_default_dtype_is_bf16_on_the_card_only():
    from followyourclick_tpu_torch.utils.loaders import default_dtype

    assert default_dtype("cuda") == torch.bfloat16
    assert default_dtype("cuda:1") == torch.bfloat16
    assert default_dtype("cpu") == torch.float32


def test_motion_modules_stay_zero_without_a_motion_checkpoint(sd_dir):
    """A UNet filled from the 2D SD weights alone keeps the port's own
    initialisation where the checkpoint has nothing: the motion modules'
    zero-initialised outputs stay zero, and conv_in's channels past the
    first 4 are zero (the 2D → 3D inflation)."""
    _, sd, _ = sd_dir
    cfg = dataclasses.replace(CFG, unet=dataclasses.replace(
        CFG.unet, motion_module=dataclasses.replace(
            CFG.unet.motion_module, zero_initialize=True)))
    pipe = assemble_pipeline_from_pretrained(sd, cfg, device="cpu")
    outs = [m.proj_out.weight for name, m in pipe.unet.named_modules()
            if name.endswith("motion_modules.0")]
    assert outs and all(not w.any() for w in outs)
    w = pipe.unet.conv_in.conv.weight
    assert w.shape[1] == 9 and not w[:, 4:].any() and w[:, :4].any()
