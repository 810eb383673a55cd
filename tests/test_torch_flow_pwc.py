"""The port's PWC-family estimators against the JAX package's, at the
published widths of ``configs/flow/``: PWC-Net, MaskFlowNetS (with its
occlusion mask) and MaskFlowNet, and the pieces they add.

Seeded port weights cross to the JAX module (the tree must fill
``jax.eval_shape`` of its ``init`` leaf for leaf) and back through
``flow.convert.flow_state_from_jax`` (``tests/_torch_flow_parity.py``);
on a pair of 64x64 images (batch 2) every training-mode level, the mask
and the ``inference=True`` flow agree within 1e-4 relative L2 (fp32 on
both sides; measured 6e-7 to 9e-7).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from followyourclick_tpu.flow import maskflownet as jmask
from followyourclick_tpu.flow import registry as jreg
from followyourclick_tpu_torch.flow import maskflownet
from followyourclick_tpu_torch.flow.convert import flow_state_from_jax
from followyourclick_tpu_torch.flow.pwcnet import up_conv
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_
from tests._torch_flow_parity import REL_L2, Pair, images, jax_tree, nchw, \
    nhwc, rel_l2
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CONFIGS = {"PWCNet": "configs/flow/pwcnet_slong_flyingchairs.yaml",
           "MaskFlowNetS": "configs/flow/maskflownets_slong_flyingchairs.yaml",
           "MaskFlowNet": "configs/flow/maskflownet_flyingthings3d.yaml"}


@functools.lru_cache(maxsize=None)
def run(kind: str):
    """(pair, port (levels, inference), JAX (levels, inference)) on the
    seeded images; MaskFlowNetS with ``return_mask``."""
    with open(CONFIGS[kind]) as f:
        cfg = yaml.safe_load(f)["model"]
    pair = Pair(jreg.build_flow_estimator(cfg), cfg)
    kw = {"return_mask": True} if kind == "MaskFlowNetS" else {}
    a, b = images(0)
    return pair, pair.port_run(a, b, **kw), pair.jax_run(a, b, **kw)


def assert_levels(got, want):
    # the module's order, coarse to fine (a jitted JAX dict comes sorted)
    assert list(got) == sorted(want, reverse=True)
    for k in want:
        assert got[k].shape[-2:] == want[k].shape[1:3], k
        assert rel_l2(nhwc(got[k]), want[k]) < REL_L2, k


@pytest.mark.parametrize("kind", ["PWCNet", "MaskFlowNet"])
def test_levels_and_inference_match_jax(kind):
    pair, (got, got_inf), (want, want_inf) = run(kind)
    assert list(got) == ["level6", "level5", "level4", "level3", "level2"]
    assert_levels(got, want)
    assert got_inf.shape == (2, 2, 64, 64)
    assert np.abs(want_inf).max() > 0.1
    assert rel_l2(nhwc(got_inf), want_inf) < REL_L2


def test_maskflownets_levels_mask_and_inference_match_jax():
    pair, ((got, mask), (got_inf, mask_inf)), \
        ((want, jmask_), (want_inf, jmask_inf)) = run("MaskFlowNetS")
    assert_levels(got, want)
    assert mask.shape == (2, 1, 64, 64)
    assert rel_l2(nhwc(mask), jmask_) < REL_L2
    assert rel_l2(nhwc(mask_inf), jmask_inf) < REL_L2
    assert rel_l2(nhwc(got_inf), want_inf) < REL_L2


def test_the_seeded_model_is_the_converted_one():
    """The model seeded by ``init_model`` and the one rebuilt from the JAX
    tree give the same flows (the conversion loses nothing)."""
    pair, (got, _), _ = run("PWCNet")
    a, b = images(0)
    direct, _ = pair.port_run(a, b, model=pair.port)
    for k in got:
        assert torch.equal(direct[k], got[k])


def test_upsample2_align_corners_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jmask.upsample2_align_corners(jnp.asarray(x)))
    got = nhwc(maskflownet.upsample2_align_corners(nchw(x)))
    assert got.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tradeoff", [True, False])
def test_deform_warp_block_matches_jax(tradeoff):
    """The uniform-offset deformable conv: a 3x3 conv of the warped
    feature and a separate bias, with and without the trade-off gate."""
    rs = np.random.RandomState(4)
    feat = rs.randn(1, 12, 10, 8).astype(np.float32)
    flow = 2 * rs.randn(1, 12, 10, 2).astype(np.float32)
    mask = rs.randn(1, 12, 10, 1).astype(np.float32)
    up = rs.randn(1, 12, 10, 16).astype(np.float32)
    args = (feat, flow, mask, up) if tradeoff else (feat, flow)
    variables = jax_tree(seeded_init_(
        maskflownet.DeformWarpBlock(8, with_tradeoff=tradeoff),
        torch.Generator().manual_seed(0)))
    jm = jmask.DeformWarpBlock(8, with_tradeoff=tradeoff)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    block = maskflownet.DeformWarpBlock(8, with_tradeoff=tradeoff)
    block.load_state_dict(flow_state_from_jax(variables, block))
    got = block(*[nchw(a) for a in args]).detach()
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5)


def test_transposed_conv_reads_the_flax_kernel_unflipped():
    """flax ``ConvTranspose(4, 2, "VALID", transpose_kernel=True)`` cropped
    by one pixel a side is ``nn.ConvTranspose2d(4, 2, padding=1)`` with
    the ``(kh, kw, out, in)`` kernel transposed to ``(in, out, kh, kw)``;
    a flipped kernel does not match (the kernel is not symmetric)."""
    rs = np.random.RandomState(5)
    x = rs.randn(1, 5, 6, 3).astype(np.float32)
    kernel = rs.randn(4, 4, 2, 3).astype(np.float32)
    bias = rs.randn(2).astype(np.float32)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    jm = fnn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="VALID",
                           transpose_kernel=True)
    want = np.asarray(jm.apply({"params": {"kernel": kernel, "bias": bias}},
                               x))[:, 1:-1, 1:-1]
    conv = up_conv(3, 2)
    conv.load_state_dict(flow_state_from_jax(
        {"params": {"kernel": kernel, "bias": bias}}, conv))
    got = nhwc(conv(nchw(x)).detach())
    assert got.shape == want.shape == (1, 10, 12, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        conv.weight.copy_(conv.weight.flip(2, 3))
    assert np.abs(nhwc(conv(nchw(x)).detach()) - want).max() > 0.1
