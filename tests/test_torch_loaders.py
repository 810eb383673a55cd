"""The port's checkpoint readers and converters against the JAX package's.

- ``read_safetensors`` (the port's own reader; the card's machine has no
  ``safetensors`` package) against files written by ``safetensors.numpy``
  and ``safetensors.torch``: bit for bit, in each dtype it takes; a dtype
  it does not take raises; ``chip_smoke.write_safetensors`` (the smoke's
  writer) reads back by the ``safetensors`` package.
- ``load_torch_file`` against the JAX ``load_torch_file`` on the pickle
  dialects (DDP ``module.`` prefixes, a ``state_dict`` wrapper, ``.bin``)
  and on a safetensors file: the same keys, dtypes and values.
- The inverse mapping of ``chip_smoke`` (a flax tree → reference names and
  layouts) held to the JAX converters: their output reproduces the tree
  exactly and the JAX ``audit_params`` reports nothing missing, unexpected
  or mismatched, at the tiny configs and (shapes only, zero-stride arrays)
  at the default UNet's full width.
- Each port converter against its JAX counterpart on the same state dict:
  the same tree, exactly (UNet, VAE, CLIP text, T5, the IP projection
  models, the CLIP vision tower, the LDM remapping, the ip graft).
"""


import jax
import numpy as np
import pytest
import torch

import chip_smoke
from followyourclick_tpu.utils import convert as jconvert
from followyourclick_tpu.utils import ldm as jldm
from followyourclick_tpu.utils import loaders as jloaders
from followyourclick_tpu_torch.utils import convert as tconvert
from followyourclick_tpu_torch.utils import ldm as tldm
from followyourclick_tpu_torch.utils import loaders as tloaders
from tests.test_convert_fullshape import _hf_to_ldm_unet
from tests.test_torch_unet import (
    TINY_UNET,
    random_tree,
    tiny_clip_tree,
    tiny_unet_tree,
    tiny_vae_tree,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def assert_trees_equal(got, want, path=()):
    """The same nested keys, and at each leaf the same shape, dtype and
    values."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if not isinstance(want, dict):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g, w, err_msg=str(path))
        return
    assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        assert_trees_equal(got[k], want[k], path + (k,))


def _fp32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


_TREES = {}


def unet_tree(cfg=TINY_UNET):
    """``tiny_unet_tree(cfg)`` in fp32, traced once a config."""
    if cfg not in _TREES:
        _TREES[cfg] = _fp32(tiny_unet_tree(cfg))
    return _TREES[cfg]


# --- the safetensors reader ------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64,
                                   np.int32, np.uint8],
                         ids=["F32", "F16", "I64", "I32", "U8"])
def test_read_safetensors_matches_the_package(tmp_path, dtype):
    from safetensors.numpy import save_file

    rs = np.random.RandomState(0)
    arrays = {"a.weight": (rs.randn(3, 5, 7) * 100).astype(dtype),
              "b": (rs.randn(11) * 100).astype(dtype),
              "scalar": np.asarray(rs.randn() * 100).astype(dtype),
              "empty": np.zeros((0, 4), dtype)}
    path = str(tmp_path / "t.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    got = tloaders.read_safetensors(path)
    assert sorted(got) == sorted(arrays)
    for k, want in arrays.items():
        g = got[k].numpy()
        assert g.dtype == want.dtype and g.shape == want.shape, k
        assert g.tobytes() == want.tobytes(), k


def test_read_safetensors_bf16_and_unknown_dtype(tmp_path):
    """bf16 (written by ``safetensors.torch``) reads back bit for bit; F64,
    which the reader does not take, raises."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    t = torch.randn(4, 9, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    save_torch({"w": t}, path)
    got = tloaders.read_safetensors(path)["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    bad = str(tmp_path / "f64.safetensors")
    save_file({"w": np.ones(3, np.float64)}, bad)
    with pytest.raises(ValueError, match="F64"):
        tloaders.read_safetensors(bad)


def test_smoke_writer_reads_back_by_the_package(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(2)
    tensors = {"x": torch.randn(5, 3, generator=g).half(),
               "y": torch.randn(2, 2, generator=g).to(torch.bfloat16),
               "z": torch.arange(7, dtype=torch.int64),
               "u": torch.arange(5, dtype=torch.uint8)}
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    got = load_file(path)
    for k, want in tensors.items():
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


# --- load_torch_file: the pickle and safetensors dialects -----------------

@pytest.mark.parametrize("dialect", ["ddp_state_dict", "plain_bin",
                                     "safetensors"])
def test_load_torch_file_matches_jax(tmp_path, dialect):
    g = torch.Generator().manual_seed(3)
    sd = {"down_blocks.0.motion_modules.0.temporal_transformer.norm.weight":
          torch.randn(8, generator=g),
          "conv_in.weight": torch.randn(4, 9, 3, 3, generator=g).half(),
          "steps": torch.tensor(5)}
    if dialect == "ddp_state_dict":
        path = str(tmp_path / "mm.ckpt")
        torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                    "epoch": 3}, path)
    elif dialect == "plain_bin":
        path = str(tmp_path / "pytorch_model.bin")
        torch.save(sd, path)
    else:
        path = str(tmp_path / "model.safetensors")
        chip_smoke.write_safetensors(path, sd)
    got = tloaders.load_torch_file(path)
    want = jloaders.load_torch_file(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the smoke's inverse mapping held to the JAX converters ---------------

@pytest.mark.parametrize("part", ["unet", "vae", "clip"])
def test_inverse_mapping_round_trips_through_jax_converters(part):
    tree = {"unet": unet_tree, "vae": lambda: _fp32(tiny_vae_tree()),
            "clip": lambda: _fp32(tiny_clip_tree())}[part]()
    inverse, convert = {
        "unet": (chip_smoke.unet_state_from_tree,
                 jconvert.convert_unet3d_state_dict),
        "vae": (chip_smoke.vae_state_from_tree,
                jconvert.convert_vae_state_dict),
        "clip": (chip_smoke.clip_state_from_tree,
                 jconvert.convert_clip_text_state_dict)}[part]
    state = inverse(tree)
    assert len(state) == len(jax.tree_util.tree_leaves(tree))
    back = convert(state)
    assert_trees_equal(back, tree)
    assert jconvert.audit_params(back, tree) == ([], [], [])


def test_inverse_mapping_at_full_width_audits_clean():
    """The default (SD-1.5 width) UNet: the port's module tree (shapes
    only), given the JAX ``Conv1x1`` kernels of the spatial transformers'
    ``proj_in`` / ``proj_out`` as ``random_flax_tree`` writes them, through
    the inverse and the JAX converter, against the JAX model's own tree
    (``jax.eval_shape`` of its init)."""
    import jax.numpy as jnp

    from followyourclick_tpu.config import InferenceConfig as JInference
    from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JU
    from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel

    with torch.device("meta"):
        unet = UNet3DConditionModel(InferenceConfig().unet)
    tree = {}
    for path, slot in chip_smoke._flat(tconvert.module_tree(unet)).items():
        shape = slot.shape
        if (path[-2] in ("proj_in", "proj_out") and len(shape) == 2
                and path[-3].startswith("attentions_")):
            shape = (1, 1) + shape
        tconvert._set(tree, path, np.broadcast_to(np.float32(0), shape))
    back = jconvert.convert_unet3d_state_dict(
        chip_smoke.unet_state_from_tree(tree))
    ucfg = JInference().unet
    b, f, hw = 1, 2, 8
    want = jax.eval_shape(JU(ucfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((b, f, hw, hw, ucfg.conv_in_channels)),
                          jnp.zeros((b,), jnp.int32),
                          JCond(context=jnp.zeros((2 * b, 77, 768)),
                                fps=jnp.zeros((b,)),
                                motion_score=jnp.zeros((b,))))["params"]
    want = jax.tree_util.tree_map(lambda s: np.broadcast_to(
        np.float32(0), s.shape), want)
    assert jconvert.audit_params(back, want) == ([], [], [])


# --- each port converter against the JAX one ------------------------------

def _ip_trees():
    """Random vanilla ImageProjModel, Plus Resampler and CLIP vision
    trees from the JAX modules."""
    import jax.numpy as jnp

    from followyourclick_tpu.models.ip_adapter import (
        CLIPVisionConfig,
        IPAdapter,
    )

    vcfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=28, patch_size=14, projection_dim=24)
    out = {}
    for plus in (False, True):
        out[plus] = _fp32(random_tree(
            IPAdapter(vision_config=vcfg, cross_attention_dim=128,
                      num_tokens=4, plus=plus).init,
            jnp.zeros((1, 28, 28, 3)), seed=5 + plus))
    return out


def _image_proj_state(tree):
    return {"proj.weight": tree["proj"]["kernel"].T,
            "proj.bias": tree["proj"]["bias"],
            "norm.weight": tree["norm"]["scale"],
            "norm.bias": tree["norm"]["bias"]}


def _resampler_state(tree):
    sd = {"latents": tree["latents"]}
    for mod in ("proj_in", "proj_out"):
        sd[f"{mod}.weight"] = tree[mod]["kernel"].T
        sd[f"{mod}.bias"] = tree[mod]["bias"]
    sd["norm_out.weight"] = tree["norm_out"]["scale"]
    sd["norm_out.bias"] = tree["norm_out"]["bias"]
    depth = 0
    while f"layers_{depth}_attn" in tree:
        a, p = tree[f"layers_{depth}_attn"], f"layers.{depth}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.0.{n}.weight"] = a[n]["scale"]
            sd[f"{p}.0.{n}.bias"] = a[n]["bias"]
        for n in ("to_q", "to_kv", "to_out"):
            sd[f"{p}.0.{n}.weight"] = a[n]["kernel"].T
        sd[f"{p}.1.0.weight"] = tree[f"layers_{depth}_ff_norm"]["scale"]
        sd[f"{p}.1.0.bias"] = tree[f"layers_{depth}_ff_norm"]["bias"]
        sd[f"{p}.1.1.weight"] = tree[f"layers_{depth}_ff_in"]["kernel"].T
        sd[f"{p}.1.3.weight"] = tree[f"layers_{depth}_ff_out"]["kernel"].T
        depth += 1
    return sd


def _clip_vision_state(tree):
    sd = {"vision_model.embeddings.class_embedding": tree["class_embedding"],
          "vision_model.embeddings.patch_embedding.weight":
              tree["patch_embedding"]["kernel"].transpose(3, 2, 0, 1),
          "vision_model.embeddings.position_embedding.weight":
              tree["position_embedding"]["embedding"],
          "visual_projection.weight": tree["visual_projection"]["kernel"].T}
    for mod in ("pre_layrnorm", "post_layernorm"):
        sd[f"vision_model.{mod}.weight"] = tree[mod]["scale"]
        sd[f"vision_model.{mod}.bias"] = tree[mod]["bias"]
    i = 0
    while f"layers_{i}" in tree:
        layer, p = tree[f"layers_{i}"], f"vision_model.encoder.layers.{i}"
        for mod, v in layer.items():
            name = {"mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}.get(
                mod, mod if mod.startswith("layer_norm")
                else f"self_attn.{mod}")
            for leaf, arr in v.items():
                sd[f"{p}.{name}."
                   + ("bias" if leaf == "bias" else "weight")] = (
                    arr.T if leaf == "kernel" else arr)
        i += 1
    return sd


def _t5_state(seed=4):
    rs = np.random.RandomState(seed)
    d, kv, ff, heads = 16, 4, 24, 2
    sd = {"shared.weight": rs.randn(50, d),
          "encoder.embed_tokens.weight": rs.randn(50, d),
          "encoder.final_layer_norm.weight": rs.randn(d)}
    for i in range(2):
        p = f"encoder.block.{i}.layer"
        for n in "qkvo":
            sd[f"{p}.0.SelfAttention.{n}.weight"] = rs.randn(
                d if n == "o" else heads * kv, heads * kv if n == "o" else d)
        sd[f"{p}.0.layer_norm.weight"] = rs.randn(d)
        sd[f"{p}.1.DenseReluDense.wi_0.weight"] = rs.randn(ff, d)
        sd[f"{p}.1.DenseReluDense.wi_1.weight"] = rs.randn(ff, d)
        sd[f"{p}.1.DenseReluDense.wo.weight"] = rs.randn(d, ff)
        sd[f"{p}.1.layer_norm.weight"] = rs.randn(d)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
       "weight"] = rs.randn(32, heads)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("kind", [
    "unet", "unet_ddp", "vae", "clip", "t5", "image_proj", "resampler",
    "clip_vision", "ldm_unet", "ldm_vae_clip"])
def test_port_converter_matches_jax(kind):
    """The port's numpy converter and the JAX one give the same tree from
    the same state dict."""
    from followyourclick_tpu.models.t5_text import (
        convert_t5_state_dict as jax_t5,
    )
    from followyourclick_tpu_torch.models.t5_text import (
        convert_t5_state_dict as port_t5,
    )

    if kind in ("unet", "unet_ddp"):
        sd = chip_smoke.unet_state_from_tree(unet_tree())
        if kind == "unet_ddp":
            sd = {"module." + k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in sd.items()}
        pair = (tconvert.convert_unet3d_state_dict,
                jconvert.convert_unet3d_state_dict)
    elif kind == "vae":
        sd = chip_smoke.vae_state_from_tree(_fp32(tiny_vae_tree()))
        pair = (tconvert.convert_vae_state_dict,
                jconvert.convert_vae_state_dict)
    elif kind == "clip":
        sd = chip_smoke.clip_state_from_tree(_fp32(tiny_clip_tree()))
        sd["text_model.embeddings.position_ids"] = np.arange(77)[None]
        pair = (tconvert.convert_clip_text_state_dict,
                jconvert.convert_clip_text_state_dict)
    elif kind == "t5":
        sd, pair = _t5_state(), (port_t5, jax_t5)
    elif kind in ("image_proj", "resampler", "clip_vision"):
        trees = _ip_trees()
        sd, pair = {
            "image_proj": (_image_proj_state(trees[False]["image_proj_model"]),
                           (tconvert.convert_image_proj_state_dict,
                            jconvert.convert_image_proj_state_dict)),
            "resampler": (_resampler_state(trees[True]["image_proj_model"]),
                          (tconvert.convert_resampler_state_dict,
                           jconvert.convert_resampler_state_dict)),
            "clip_vision": (_clip_vision_state(trees[False]["image_encoder"]),
                            (tconvert.convert_clip_vision_state_dict,
                             jconvert.convert_clip_vision_state_dict)),
        }[kind]
        want_tree = (trees[kind == "resampler"]["image_proj_model"]
                     if kind != "clip_vision"
                     else trees[False]["image_encoder"])
        assert_trees_equal(pair[1](sd), want_tree)
    elif kind == "ldm_unet":
        cfg = TINY_UNET.__class__(**{**TINY_UNET.__dict__,
                                     "layers_per_block": 2})
        hf = chip_smoke.unet_state_from_tree(unet_tree(cfg))
        sd = _hf_to_ldm_unet(hf)
        assert tldm.convert_ldm_unet(sd) == jldm.convert_ldm_unet(sd)
        pair = (lambda s: tconvert.convert_unet3d_state_dict(
                    tldm.convert_ldm_unet(s)),
                lambda s: jconvert.convert_unet3d_state_dict(
                    jldm.convert_ldm_unet(s)))
    else:  # an LDM file's VAE (under first_stage_model.) and CLIP parts
        rs = np.random.RandomState(6)
        sd = {"first_stage_model.encoder.down.0.block.1.nin_shortcut.weight":
              rs.randn(4, 4, 1, 1),
              "first_stage_model.decoder.up.3.upsample.conv.bias":
              rs.randn(4),
              "first_stage_model.decoder.mid.attn_1.proj_out.weight":
              rs.randn(4, 4, 1, 1),
              "first_stage_model.encoder.mid.block_2.norm1.weight":
              rs.randn(4),
              "first_stage_model.quant_conv.weight": rs.randn(8, 8, 1, 1),
              "cond_stage_model.transformer.text_model.final_layer_norm."
              "weight": rs.randn(4)}
        assert tldm.convert_ldm_vae(sd) == jldm.convert_ldm_vae(sd)
        assert tldm.convert_ldm_clip(sd) == jldm.convert_ldm_clip(sd)
        pair = (lambda s: tconvert.convert_vae_state_dict(
                    tldm.convert_ldm_vae(s)),
                lambda s: jconvert.convert_vae_state_dict(
                    jldm.convert_ldm_vae(s)))
    assert_trees_equal(pair[0](sd), pair[1](sd))


def test_graft_and_audit_match_jax():
    """``graft_ip_cross_attention`` by position over the sorted ip
    projections, and ``audit_params`` / ``merge_params`` on a partial tree
    with an unexpected leaf and a mismatched one: the port's give the
    JAX package's results."""
    import dataclasses

    cfg = dataclasses.replace(TINY_UNET, use_ip_cross_attention=True,
                              ip_num_tokens=4)
    tree = unet_tree(cfg)
    rs = np.random.RandomState(7)
    ip_sd, n = {}, 0
    for path in sorted(chip_smoke._flat(tree)):
        if path[-2] in ("to_k_ip", "to_v_ip"):
            k = tree
            for p in path:
                k = k[p]
            ip_sd[f"{n}.{path[-2]}.weight"] = rs.randn(
                *k.shape[::-1]).astype(np.float32)
            n += 1
    assert n > 0
    assert_trees_equal(tconvert.graft_ip_cross_attention(tree, ip_sd),
                       jconvert.graft_ip_cross_attention(tree, ip_sd))
    part = {"conv_in": {"conv": {"kernel": np.zeros((3, 3, 9, 7))}},
            "no_such": {"kernel": np.zeros(3)},
            "conv_out": tree["conv_out"]}
    assert tconvert.audit_params(part, tree) == jconvert.audit_params(
        part, tree)
    merged_t = tconvert.merge_params(tree, part)
    merged_j = jconvert.merge_params(tree, part)
    assert_trees_equal(merged_t, merged_j)
    assert (tconvert.audit_params(merged_t, tree)
            == jconvert.audit_params(merged_j, tree))


@pytest.mark.parametrize("plus", [False, True], ids=["vanilla", "plus"])
def test_load_ip_adapter_matches_jax(plus):
    """A released ip checkpoint (a dict of torch tensors): the projection's
    tree as the JAX ``load_ip_adapter`` gives it, and the port's UNet with
    the k/v weights grafted equal to the JAX UNet tree it returns."""
    import dataclasses

    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel

    cfg = dataclasses.replace(TINY_UNET, use_ip_cross_attention=True,
                              ip_num_tokens=16 if plus else 4)
    tree = unet_tree(cfg)
    rs = np.random.RandomState(8)
    ip_sd = {}
    for i, path in enumerate(p for p in sorted(chip_smoke._flat(tree))
                             if p[-2] in ("to_k_ip", "to_v_ip")):
        node = tree
        for p in path:
            node = node[p]
        ip_sd[f"{i}.{path[-2]}.weight"] = torch.from_numpy(
            rs.randn(*node.shape[::-1]).astype(np.float32))
    proj_tree = _ip_trees()[plus]["image_proj_model"]
    proj_sd = (_resampler_state if plus else _image_proj_state)(proj_tree)
    state = {"image_proj": {k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in proj_sd.items()},
             "ip_adapter": ip_sd}
    want_proj, want_unet = jloaders.load_ip_adapter(state, tree, plus=plus)
    unet = tconvert.load_jax_params(UNet3DConditionModel(cfg), tree)
    got_proj = tloaders.load_ip_adapter(state, unet, plus=plus)
    assert_trees_equal(got_proj, want_proj)
    want = tconvert.load_jax_params(UNet3DConditionModel(cfg), want_unet)
    for (name, got), (_, ref) in zip(unet.named_parameters(),
                                     want.named_parameters()):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)
