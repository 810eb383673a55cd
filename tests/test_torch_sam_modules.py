"""The port's SAM modules (``followyourclick_tpu_torch/sam/``) against the
JAX package's, module by module, fp32 on the CPU.

One tiny ``vit_t`` SAM (64 wide, 2 blocks, 128² input: the 8x8 grid pads to
one 14x14 window in block 0, block 1 is global) with seeded weights from
the port (``build_sam``'s seeded values: every parameter nonzero, the
rel-pos tables and positions too); its official-named state dict goes through the JAX
``convert_sam_state_dict``, so both packages hold the same weights. A
ViTBlock whose 12x12 grid pads to 15 in windows of 5 is checked on its own.
Tolerance: 1e-5 of the output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.sam import Sam as JSam
from followyourclick_tpu.sam import sam_model_registry as jax_registry
from followyourclick_tpu.sam.convert import convert_sam_state_dict
from followyourclick_tpu.sam.image_encoder import ViTBlock as JViTBlock
from followyourclick_tpu_torch.sam import build_sam, sam_model_registry
from followyourclick_tpu_torch.sam.image_encoder import (
    ViTBlock,
    window_partition,
    window_unpartition,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_unet import random_tree

TOL = 1e-5


def tiny_sam(seed=0):
    """(port ``Sam`` on the CPU, JAX ``Sam``, its variables) for ``vit_t``,
    on the same seeded weights."""
    model = build_sam(sam_model_registry["vit_t"], "cpu",
                      torch.Generator().manual_seed(seed))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_sam_state_dict(
        state, depth=sam_model_registry["vit_t"].depth)
    return model, JSam(jax_registry["vit_t"]), variables


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{err:.3e} of max {scale:.3e}"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def sam():
    return tiny_sam()


def test_image_encoder(sam):
    model, jmodel, variables = sam
    x = np.random.RandomState(0).randn(1, 128, 128, 3).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x),
                        method=lambda m, v: m.encode_image(v))
    with torch.no_grad():
        got = model.encode_image(nchw(x))
    assert tuple(got.shape) == (1, 256, 8, 8)
    assert_close(nhwc(got), want)


def _block_params_to_torch(tree):
    """A flax ViTBlock's params → the port's ViTBlock state dict."""
    def lin(t):
        return {"weight": torch.from_numpy(np.asarray(t["kernel"]).T.copy()),
                "bias": torch.from_numpy(np.asarray(t["bias"]))}

    def ln(t):
        return {"weight": torch.from_numpy(np.asarray(t["scale"])),
                "bias": torch.from_numpy(np.asarray(t["bias"]))}

    parts = {"norm1": ln(tree["norm1"]), "norm2": ln(tree["norm2"]),
             "attn.qkv": lin(tree["attn"]["qkv"]),
             "attn.proj": lin(tree["attn"]["proj"]),
             "mlp.lin1": lin(tree["mlp_lin1"]),
             "mlp.lin2": lin(tree["mlp_lin2"])}
    out = {f"{k}.{n}": v for k, d in parts.items() for n, v in d.items()}
    for n in ("rel_pos_h", "rel_pos_w"):
        out[f"attn.{n}"] = torch.from_numpy(np.asarray(tree["attn"][n]))
    return out


@pytest.mark.parametrize("window", [5, 0])
def test_vit_block_with_window_padding(window):
    """A 12x12 grid in windows of 5 (padded to 15, the zero tokens keys of
    their windows), and the same block global."""
    dim, heads = 32, 2
    jblock = JViTBlock(dim, heads, window_size=window, input_size=(12, 12))
    x = np.random.RandomState(1).randn(2, 12, 12, dim).astype(np.float32)
    params = random_tree(jblock.init, jnp.asarray(x), seed=3)
    want = jblock.apply({"params": params}, jnp.asarray(x))
    block = ViTBlock(dim, heads, window_size=window, input_size=(12, 12))
    block.load_state_dict(_block_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert_close(got.numpy(), want)


def test_window_partition_round_trip():
    x = torch.randn(2, 12, 9, 4)
    parts, padded = window_partition(x, 5)
    assert tuple(parts.shape) == (2 * 3 * 2, 5, 5, 4) and padded == (15, 10)
    assert float(parts[-1, -1, -1].abs().sum()) == 0.0  # the padded zeros
    assert torch.equal(window_unpartition(parts, 5, padded, (12, 9)), x)


PROMPTS = {
    "points": dict(points=True),
    "points+boxes": dict(points=True, boxes=True),
    "boxes": dict(boxes=True),
    "masks": dict(masks=True),
    "points+masks": dict(points=True, masks=True),
    "none": dict(),
}


@pytest.mark.parametrize("case", list(PROMPTS))
def test_prompt_encoder(sam, case):
    model, jmodel, variables = sam
    opts = PROMPTS[case]
    rs = np.random.RandomState(2)
    coords = rs.uniform(0, 128, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, 1], [0, 1, -1]], np.int32)
    boxes = np.sort(rs.uniform(0, 128, (2, 2, 2)), axis=1).reshape(
        2, 4).astype(np.float32)
    masks = rs.randn(2, 32, 32, 1).astype(np.float32)
    jpoints = (jnp.asarray(coords), jnp.asarray(labels)) \
        if opts.get("points") else None
    jboxes = jnp.asarray(boxes) if opts.get("boxes") else None
    jmasks = jnp.asarray(masks) if opts.get("masks") else None
    sparse_w, dense_w = jmodel.apply(
        variables, method=lambda m: m.prompt_encoder(
            points=jpoints, boxes=jboxes, masks=jmasks))
    points = (torch.from_numpy(coords), torch.from_numpy(labels)) \
        if opts.get("points") else None
    with torch.no_grad():
        sparse, dense = model.prompt_encoder(
            points, torch.from_numpy(boxes) if opts.get("boxes") else None,
            nchw(masks) if opts.get("masks") else None)
    assert tuple(sparse.shape) == sparse_w.shape
    if sparse_w.shape[1]:
        assert_close(sparse.numpy(), sparse_w)
    assert_close(nhwc(dense), dense_w)


def test_dense_positional_encoding(sam):
    model, jmodel, variables = sam
    want = jmodel.apply(variables,
                        method=lambda m: m.prompt_encoder.get_dense_pe())
    with torch.no_grad():
        got = model.prompt_encoder.get_dense_pe()
    assert_close(nhwc(got), want)


@pytest.mark.parametrize("mode", ["multimask", "single", "all_tokens"])
def test_mask_decoder(sam, mode):
    model, jmodel, variables = sam
    rs = np.random.RandomState(4)
    emb = rs.randn(1, 8, 8, 256).astype(np.float32)
    sparse = rs.randn(2, 3, 256).astype(np.float32)
    dense = rs.randn(2, 8, 8, 256).astype(np.float32)
    kw = dict(multimask_output=mode == "multimask",
              return_all_tokens=mode == "all_tokens")
    masks_w, iou_w = jmodel.apply(
        variables, method=lambda m: m.mask_decoder(
            jnp.asarray(emb), m.prompt_encoder.get_dense_pe(),
            jnp.asarray(sparse), jnp.asarray(dense), **kw))
    with torch.no_grad():
        masks, iou = model.mask_decoder(
            nchw(emb), model.prompt_encoder.get_dense_pe(),
            torch.from_numpy(sparse), nchw(dense), **kw)
    k = {"multimask": 3, "single": 1, "all_tokens": 4}[mode]
    assert tuple(masks.shape) == (2, k, 32, 32) == masks_w.shape
    assert_close(masks.numpy(), masks_w)
    assert_close(iou.numpy(), iou_w)


def test_registry_matches_jax():
    for name, cfg in jax_registry.items():
        port = sam_model_registry[name]
        for field in ("embed_dim", "depth", "num_heads",
                      "global_attn_indexes", "img_size", "prompt_embed_dim",
                      "vit_patch_size", "mask_in_chans"):
            assert getattr(port, field) == getattr(cfg, field), (name, field)
