"""The route of ``models/layers.GroupNorm`` to the hand-written kernel.

On a card the module hands every input to ``ops/groupnorm.fused_group_norm``
as ``(B, N, C)`` rows, made contiguous; what the kernel does not take
raises; off the card the module keeps its plain path. Here, without a card:

- the kernel takes every GroupNorm site of one exact CFG UNet evaluation at
  16 f / 512², of the 16-frame 512² VAE decode and of the training cell's
  72-frame 256×448 encode, in bf16, as the smoke lists them by forward
  hooks on the meta device; a real tiny forward on the CPU hands every
  site a contiguous x on 16 bytes, as a card's channels-last convs do, so
  the route copies nothing;
- on the stand-in card (a CPU tensor whose ``device`` says cuda) an
  input goes to the wrapper once, folded and contiguous, and never to the
  plain path; what the kernel does not take (fp16, C off 8, a misaligned
  x, a weight in another dtype) raises with no launch; a CPU tensor takes
  the plain path;
- the kernel's plain version over the module's folding equals the module's
  plain path in fp32, 4-D and 5-D, with and without SiLU, at |mean| ≫ std;
- ``GroupNormGrad``'s gradients (the wrapper under autograd on the CPU)
  equal autograd through the module.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models import layers
from followyourclick_tpu_torch.models.layers import GroupNorm
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.ops import groupnorm
from followyourclick_tpu_torch.ops.groupnorm import (
    fused_group_norm,
    group_norm_ref,
)
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from tests.test_torch_cuda import GROUP_NORM_SITES
from tests.test_torch_motion_options import CudaLike
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _hooked(model, seen):
    """Forward hooks on every GroupNorm of ``model`` that append (module,
    input) to ``seen``."""
    def hook(module, inputs, _):
        seen.append((module, inputs[0]))
    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(hook)
    return model


def _unet_sites(cfg, frames, h, w, dtype, contexts=2):
    """One evaluation of one clip on the CPU; ``contexts`` 2 duplicates it
    for CFG inside the UNet, 1 keeps every site at batch 1 (no CFG, or a
    CFG cache's cond-only step)."""
    seen = []
    unet = _hooked(UNet3DConditionModel(cfg).to(dtype), seen)
    with torch.no_grad():
        unet(torch.zeros(1, frames, h, w, cfg.conv_in_channels, dtype=dtype),
             torch.zeros(1), UNetConditioning(
                 torch.zeros(contexts, 77, cfg.cross_attention_dim,
                             dtype=dtype), torch.ones(1), torch.ones(1)))
    return seen


def _vae_sites(cfg, frames, h, w, dtype, decode):
    seen = []
    vae = _hooked(AutoencoderKL(cfg).to(dtype), seen)
    with torch.no_grad():
        if decode:
            vae.decode(torch.zeros(frames, h // 8, w // 8, cfg.latent_channels,
                                   dtype=dtype))
        else:
            vae.encode(torch.zeros(frames, h, w, cfg.in_channels,
                                   dtype=dtype))
    return seen


# the GroupNorm calls of one exact CFG UNet evaluation at 16 f / 512², of
# the 16-frame 512² decode and of the 72-frame 256×448 encode
FULL_SITES = {"unet": 81, "decode": 30, "encode": 22}


def _full_sites(kind):
    cfg = InferenceConfig()
    if kind == "unet":
        return chip_smoke.group_norm_sites(cfg.unet, SampleSpec())
    (what, frames, h, w, decode), = [
        call for call in chip_smoke.VAE_GROUP_NORM_CALLS
        if call[0] == f"vae_{kind}"]
    return chip_smoke.vae_group_norm_sites(cfg.vae, frames, h, w, decode)


@pytest.mark.parametrize("kind", list(FULL_SITES))
def test_the_kernel_fits_every_full_width_site(kind):
    """bf16 at the benchmark's shapes, as the smoke lists them: the kernel
    takes a contiguous x of every site's shape with the module's weights
    (on the meta device), and the sites are those the card tests run the
    routed module at."""
    sites = _full_sites(kind)
    assert sum(sites.values()) == FULL_SITES[kind]
    assert set(sites) == set(GROUP_NORM_SITES[kind])
    with torch.device("meta"):
        for b, n, c, groups, _, _ in sites:
            groupnorm._check(torch.empty(b, n, c, dtype=BF16),
                             torch.empty(c, dtype=BF16),
                             torch.empty(c, dtype=BF16), groups)


@pytest.mark.parametrize("contexts", [2, 1], ids=["cfg", "batch1"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_every_site_hands_the_kernel_a_contiguous_aligned_x(dtype, contexts):
    """A real forward at tiny widths on the CPU: the UNet evaluation (with
    CFG, and at batch 1, where a motion module's output would otherwise be
    a strided view), the VAE encode and the decode hand every GroupNorm a
    contiguous x on 16 bytes (the convs keep the channels-last layout) that
    the kernel takes, so the route copies nothing."""
    cfg = chip_smoke.tiny_config()
    torch.manual_seed(0)
    seen = (_unet_sites(cfg.unet, 4, 8, 8, dtype, contexts)
            + _vae_sites(cfg.vae, 2, 64, 64, dtype, False)
            + _vae_sites(cfg.vae, 2, 64, 64, dtype, True))
    kinds = collections.Counter(x.ndim for _, x in seen)
    assert kinds[5] > 0 and kinds[4] > 0
    bad = [(tuple(x.shape), x.stride()) for m, x in seen
           if not (x.is_contiguous() and x.data_ptr() % 16 == 0)]
    assert not bad
    for m, x in seen:
        groupnorm._check(x.view(x.shape[0], -1, x.shape[-1]), m.weight,
                         m.bias, m.num_groups)


def _module(c, groups, act, dtype, seed=0):
    torch.manual_seed(seed)
    m = GroupNorm(c, groups, 1e-6, act)
    with torch.no_grad():
        m.weight.normal_(1.0, 0.1)
        m.bias.normal_(0.0, 0.1)
    return m.to(dtype)


def _on_stand_in_card(m):
    """``m`` with its weight and bias as stand-in card tensors."""
    w, b = m.weight.detach(), m.bias.detach()
    del m.weight, m.bias
    m.weight, m.bias = w.as_subclass(CudaLike), b.as_subclass(CudaLike)
    return m


def _misaligned(x):
    """``x``'s values in a contiguous tensor one element off 16 bytes."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    return flat.copy_(x.reshape(-1)).view(x.shape)


def _strided(x):
    """``x``'s values in a tensor whose frames are not contiguous."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


# (case, C, dtype, how x is laid out, what the route does): x and the
# module's weights sit on the stand-in card but where the case says not
ROUTE_CASES = [
    ("eligible", 32, BF16, None, "kernel"),
    ("eligible_fp32", 32, torch.float32, None, "kernel"),
    ("non_contiguous", 32, BF16, _strided, "kernel"),
    ("cpu_tensor", 32, BF16, None, "plain"),
    ("fp16", 32, torch.float16, None, TypeError),
    ("c_off_8", 36, BF16, None, ValueError),
    ("misaligned", 32, BF16, _misaligned, ValueError),
    ("weight_dtype", 32, BF16, None, ValueError),
]


@pytest.mark.parametrize("case,c,dtype,layout,route", ROUTE_CASES,
                         ids=[r[0] for r in ROUTE_CASES])
def test_the_route_on_the_stand_in_card(monkeypatch, case, c, dtype, layout,
                                        route):
    """The kernel path takes every card input, made contiguous, and never
    falls back to the plain path: the kernel's refusals raise from the
    wrapper before any launch."""
    groups = 4
    plain = _module(c, groups, "silu", dtype)
    rs = np.random.RandomState(c)
    x = torch.from_numpy(rs.randn(2, 3, 5, 4, c).astype(np.float32)).to(
        dtype)
    want = plain(x)
    xin = x if layout is None else layout(x)
    assert torch.equal(xin, x)
    assert (xin.data_ptr() % 16 != 0) == (case == "misaligned")
    assert xin.is_contiguous() == (case != "non_contiguous")
    if case != "cpu_tensor":
        xin = xin.as_subclass(CudaLike)
    card = _module(c, groups, "silu", dtype)
    if case == "weight_dtype":
        card = card.float()
    card = _on_stand_in_card(card)
    if route != "plain":
        monkeypatch.setattr(GroupNorm, "plain", None)
    if isinstance(route, type):
        before = fused_group_norm.launches
        with pytest.raises(route, match="fused_group_norm"):
            card(xin)
        assert fused_group_norm.launches == before
        return
    got = []

    def stand_in(rows, scale, bias, g, eps, act):
        assert rows.is_contiguous()
        got.append((tuple(rows.shape), g, eps, act))
        return group_norm_ref(rows.as_subclass(torch.Tensor),
                              scale.as_subclass(torch.Tensor),
                              bias.as_subclass(torch.Tensor), g, eps, act)

    monkeypatch.setattr(layers, "fused_group_norm", stand_in)
    out = card(xin).as_subclass(torch.Tensor)
    assert out.shape == x.shape and out.dtype == dtype
    if route == "kernel":
        assert got == [((2, 3 * 5 * 4, c), groups, 1e-6, "silu")]
        torch.testing.assert_close(
            out, group_norm_ref(x.reshape(2, -1, c), plain.weight,
                                plain.bias, groups, 1e-6,
                                "silu").reshape(x.shape), rtol=0, atol=0)
    else:
        assert not got
        assert torch.equal(out, want)


@pytest.mark.parametrize("shape", [(2, 6, 7, 64), (2, 3, 4, 5, 64)],
                         ids=["4d", "5d"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("offset,spread", [(0.0, 1.0), (500.0, 0.05)],
                         ids=["centred", "mean_over_std_1e4"])
def test_kernel_plain_version_over_the_folding_is_the_module(shape, act,
                                                             offset, spread):
    """The two pilots (the group's mean at row 0, the group's first
    element) shift the statistics exactly, so the two differ only in the
    order of rounding, at |mean| ≫ std too."""
    m = _module(shape[-1], 8, act, torch.float32, seed=len(shape))
    rs = np.random.RandomState(len(shape))
    x = torch.from_numpy((offset + spread * rs.randn(*shape)).astype(
        np.float32))
    with torch.no_grad():
        want = m(x)
        got = group_norm_ref(x.reshape(shape[0], -1, shape[-1]), m.weight,
                             m.bias, 8, m.eps, act).reshape(shape)
    # both fold the affine into x·a + b, which rounds at the size of x·a:
    # about (mean / std) float32 steps of the output
    atol = 1e-4 + 8 * torch.finfo(torch.float32).eps * offset / spread
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("shape", [(2, 6, 7, 64), (2, 3, 4, 5, 64)],
                         ids=["4d", "5d"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_grad_is_the_modules_autograd(shape, act):
    """The wrapper under autograd on the CPU (``GroupNormGrad``: the plain
    forward, the gradients of ``group_norm_fp32``) against autograd
    through the module's plain path: x, weight and bias."""
    m = _module(shape[-1], 8, act, torch.float32, seed=3)
    rs = np.random.RandomState(7)
    x = torch.from_numpy((1.0 + rs.randn(*shape)).astype(np.float32))
    cot = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    xm = x.clone().requires_grad_()
    want = torch.autograd.grad(m(xm), (xm, m.weight, m.bias), cot)
    xk = x.clone().requires_grad_()
    w, b = (p.detach().clone().requires_grad_() for p in (m.weight, m.bias))
    out = fused_group_norm(xk.reshape(shape[0], -1, shape[-1]), w, b, 8,
                           m.eps, act)
    assert out.grad_fn.name() == "GroupNormGradBackward"
    got = torch.autograd.grad(out.reshape(shape), (xk, w, b), cot)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-4)
