"""The port's flow ops, losses and metrics against the JAX package's.

Every op of ``flow/ops.py`` on the same seeded inputs, the JAX side NHWC,
the port NCHW (transposed here), fp32 on the CPU, within 1e-5 absolute:
the bilinear sampler on both ``align_corners`` branches, with and without
scaling, on a 1x1 map (where ``grid_sample`` alone would divide by zero)
and with taps outside the map; the warp with zero and border padding; the
correlation pyramid down to a 1x1 level and its lookup; both resizes, up
and down (the JAX ``align_corners=False`` resize antialiases a shrink);
``upflow8``, ``convex_upsample``, ``resize_flow`` and the local
correlation. The losses and metrics within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.flow import losses as jlosses
from followyourclick_tpu.flow import metrics as jmetrics
from followyourclick_tpu.flow import ops as jops
from followyourclick_tpu_torch.flow import losses as tlosses
from followyourclick_tpu_torch.flow import metrics as tmetrics
from followyourclick_tpu_torch.flow import ops as tops
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

ATOL = 1e-5


def nchw(a):
    """NHWC numpy → NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_coords_grid():
    close(nhwc(tops.coords_grid(2, 3, 5)), jops.coords_grid(2, 3, 5), 0)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("hw", [(7, 9), (1, 1), (1, 5)])
def test_bilinear_sample(align, scale, hw):
    rs = np.random.RandomState(0)
    h, w = hw
    feat = rs.randn(2, h, w, 3).astype(np.float32)
    if scale:   # pixel coordinates, some outside the map
        grid = rs.uniform(-2, max(h, w) + 1, (2, 4, 6, 2))
    else:       # normalised coordinates, some outside [-1, 1]
        grid = rs.uniform(-1.3, 1.3, (2, 4, 6, 2))
    grid = grid.astype(np.float32)
    want = jops.bilinear_sample(jnp.asarray(feat), jnp.asarray(grid),
                                align_corners=align, scale=scale)
    got = tops.bilinear_sample(nchw(feat), torch.from_numpy(grid),
                               align_corners=align, scale=scale)
    close(nhwc(got), want)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp(align, padding):
    rs = np.random.RandomState(1)
    feat = rs.randn(2, 6, 8, 4).astype(np.float32)
    flow = (3 * rs.randn(2, 6, 8, 2)).astype(np.float32)
    want = jops.flow_warp(jnp.asarray(feat), jnp.asarray(flow),
                          align_corners=align, padding_mode=padding)
    got = tops.flow_warp(nchw(feat), nchw(flow), align_corners=align,
                         padding_mode=padding)
    close(nhwc(got), want)
    if align:   # zero flow is the identity (mmflow tests/test_op/test_warp)
        zero = tops.flow_warp(nchw(feat), torch.zeros(2, 2, 6, 8),
                              padding_mode=padding)
        close(nhwc(zero), feat, 1e-6)


def _pyramids(rs, h=8, w=12, c=16):
    f1 = rs.randn(2, h, w, c).astype(np.float32)
    f2 = rs.randn(2, h, w, c).astype(np.float32)
    want = jops.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = tops.correlation_pyramid(nchw(f1), nchw(f2), 4)
    return want, got


def test_correlation_pyramid_down_to_1x1():
    want, got = _pyramids(np.random.RandomState(2))
    assert [tuple(p.shape[3:]) for p in want] == [(8, 12), (4, 6), (2, 3),
                                                   (1, 1)]
    for w_l, g_l in zip(want, got):
        close(g_l.reshape(w_l.shape).numpy(), w_l)


@pytest.mark.parametrize("radius", [4, 2])
def test_corr_lookup(radius):
    rs = np.random.RandomState(3)
    want_pyr, got_pyr = _pyramids(rs)
    flow = (4 * rs.randn(2, 8, 12, 2)).astype(np.float32)
    want = jops.corr_lookup(want_pyr, jnp.asarray(flow), radius)
    got = tops.corr_lookup(got_pyr, nchw(flow), radius)
    assert got.shape == (2, 4 * (2 * radius + 1) ** 2, 8, 12)
    close(nhwc(got), want)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("size", [(13, 21), (5, 3), (1, 1), (7, 10)])
def test_bilinear_resize(align, size):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 7, 10, 3).astype(np.float32)
    want = jops.bilinear_resize(jnp.asarray(x), *size, align_corners=align)
    got = tops.bilinear_resize(nchw(x), *size, align_corners=align)
    close(nhwc(got), want)


def test_upflow8_and_resize_flow():
    rs = np.random.RandomState(5)
    flow = rs.randn(2, 5, 6, 2).astype(np.float32)
    close(nhwc(tops.upflow8(nchw(flow))), jops.upflow8(jnp.asarray(flow)))
    for align in (False, True):
        for shape in ((11, 9), (3, 4)):
            want = jops.resize_flow(jnp.asarray(flow), shape, align)
            got = tops.resize_flow(nchw(flow), shape, align)
            close(nhwc(got), want)


def test_convex_upsample():
    rs = np.random.RandomState(6)
    flow = rs.randn(2, 3, 5, 2).astype(np.float32)
    mask = (2 * rs.randn(2, 3, 5, 9 * 64)).astype(np.float32)
    want = jops.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    got = tops.convex_upsample(nchw(flow), nchw(mask))
    assert got.shape == (2, 2, 24, 40)
    close(nhwc(got), want)


@pytest.mark.parametrize("kw", [dict(max_displacement=4),
                                dict(max_displacement=3, scaled=True),
                                dict(max_displacement=2, dilation_patch=2,
                                     stride=2)])
def test_local_correlation(kw):
    rs = np.random.RandomState(7)
    f1 = rs.randn(2, 9, 10, 5).astype(np.float32)
    f2 = rs.randn(2, 9, 10, 5).astype(np.float32)
    want = jops.local_correlation(jnp.asarray(f1), jnp.asarray(f2), **kw)
    got = tops.local_correlation(nchw(f1), nchw(f2), **kw)
    close(nhwc(got), want)


def _loss_inputs(rs, valid):
    gt = (30 * rs.randn(2, 16, 24, 2)).astype(np.float32)
    gt[0, 0, :4] = 500.0    # above max_flow
    v = (rs.rand(2, 16, 24) > 0.3).astype(np.float32) if valid else None
    return gt, v


@pytest.mark.parametrize("valid", [False, True])
def test_sequence_loss(valid):
    rs = np.random.RandomState(8)
    gt, v = _loss_inputs(rs, valid)
    preds = (30 * rs.randn(5, 2, 16, 24, 2)).astype(np.float32)
    want = jlosses.sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                 gamma=0.8, valid=None if v is None
                                 else jnp.asarray(v))
    got = tlosses.sequence_loss(
        torch.from_numpy(np.moveaxis(preds, -1, 2).copy()), nchw(gt),
        gamma=0.8, valid=None if v is None else torch.from_numpy(v))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind,kw", [
    ("epe", {}), ("epe", dict(q=0.4, p=1.0, eps=0.01)),
    ("epe", dict(scale_as_level=True, max_flow=400.0)),
    ("charbonnier", {}), ("charbonnier", dict(scale_as_level=True))])
@pytest.mark.parametrize("valid", [False, True])
def test_multi_level_losses(kind, kw, valid):
    rs = np.random.RandomState(9)
    gt, v = _loss_inputs(rs, valid)
    shapes = {"level6": (1, 1), "level5": (2, 3), "level4": (4, 6),
              "level3": (8, 12), "level2": (16, 24)}
    preds = {k: rs.randn(2, h, w, 2).astype(np.float32)
             for k, (h, w) in shapes.items()}
    jfn = {"epe": jlosses.multi_level_epe_loss,
           "charbonnier": jlosses.multi_level_charbonnier_loss}[kind]
    tfn = {"epe": tlosses.multi_level_epe_loss,
           "charbonnier": tlosses.multi_level_charbonnier_loss}[kind]
    want = jfn({k: jnp.asarray(p) for k, p in preds.items()},
               jnp.asarray(gt), valid=None if v is None else jnp.asarray(v),
               **kw)
    got = tfn({k: nchw(p) for k, p in preds.items()}, nchw(gt),
              valid=None if v is None else torch.from_numpy(v), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_metrics():
    rs = np.random.RandomState(10)
    preds = [rs.randn(6, 7, 2).astype(np.float32) * 5 for _ in range(3)]
    gts = [rs.randn(6, 7, 2).astype(np.float32) * 5 for _ in range(3)]
    valids = [(rs.rand(6, 7) > 0.2).astype(np.float32) for _ in range(3)]
    close(tmetrics.end_point_error_map(preds[0], gts[0]),
          jmetrics.end_point_error_map(preds[0], gts[0]), 1e-6)
    for names in ("EPE", ["EPE", "Fl"], ["Fl"]):
        want = jmetrics.eval_metrics(preds, gts, valids, names)
        got = tmetrics.eval_metrics(preds, gts, valids, names)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    with pytest.raises(KeyError):
        tmetrics.eval_metrics(preds, gts, valids, ["AUC"])
