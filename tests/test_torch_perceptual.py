"""LaMa's perceptual towers: the port against the JAX package, fp32 on the
CPU.

Each tower is built in the port with seeded weights (BN running statistics
included) under the released names, and its state dict goes through the
JAX converter (``convert_ade20k_resnet_state_dict``,
``convert_vgg_features_state_dict``, ``convert_lpips_state_dict``) into the
JAX tower; the same numpy images go to both. Checked: the dilated
ResNet-50's four stages (first blocks undilated in layer3 / layer4, later
ones at 2 and 4) and ``resnet_pl_loss``; the VGG19 perceptual partial
losses and their sum, with and without a mask; both tap modes of
``VGGFeatures``; LPIPS; the strict loaders on official-name dicts with
their prefixes and extra keys; the frozen BN in train mode.

Tolerance: 1e-4 of each output's largest magnitude (deep fp32 conv stacks
summed in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.inpaint import perceptual as jperc
from followyourclick_tpu_torch.inpaint import perceptual as perc
from tests.test_torch_lama import nhwc, numpy_state, seeded
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

REL = 1e-4


def rel_close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def ade20k_params(encoder):
    """JAX params of a port encoder, by the JAX converter on its state dict
    in the segmentation checkpoint's ``encoder.`` names."""
    return jperc.convert_ade20k_resnet_state_dict(
        {"encoder." + k: v for k, v in numpy_state(encoder).items()})


def images(seed, b=2, size=32):
    rs = np.random.RandomState(seed)
    return [rs.rand(b, 3, size, size).astype(np.float32) for _ in range(2)]


LAYERS = (1, 1, 2, 2)


@pytest.fixture(scope="module")
def encoder():
    return seeded(perc.DilatedResNet50Encoder(LAYERS), 1)


def test_dilated_resnet_stages(encoder):
    x, _ = images(0)
    want = jperc.DilatedResNet50Encoder(LAYERS).apply(
        {"params": ade20k_params(encoder)},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = encoder(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        rel_close(g.permute(0, 2, 3, 1), w)
    assert got[1].shape[-2:] == got[2].shape[-2:] == got[3].shape[-2:]
    assert encoder.layer4[1].conv2.dilation == (4, 4)
    assert encoder.layer4[0].conv2.dilation == (2, 2)
    assert encoder.layer3[0].conv2.dilation == (1, 1)


def test_resnet_pl_loss(encoder):
    a, b = images(1)
    want = jperc.resnet_pl_loss(ade20k_params(encoder), nhwc(a), nhwc(b),
                                layers=LAYERS)
    with torch.no_grad():
        got = perc.resnet_pl_loss(encoder, torch.from_numpy(a),
                                  torch.from_numpy(b))
        same = perc.resnet_pl_loss(encoder, torch.from_numpy(a),
                                   torch.from_numpy(a))
    rel_close(got, want)
    assert float(same) == 0.0 and float(got) > 0.0


def test_frozen_batch_norm_ignores_train_mode(encoder):
    x = torch.from_numpy(images(2)[0])
    with torch.no_grad():
        want = encoder(x)
        encoder.train()
        got = encoder(x)
        encoder.eval()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(encoder.bn1.num_batches_tracked) == 0


def test_load_ade20k_checkpoint(encoder):
    sd = {"encoder." + k: v for k, v in encoder.state_dict().items()}
    sd["encoder.fc.weight"] = torch.zeros(10, 2048)
    sd["decoder.conv_last.weight"] = torch.zeros(150, 512, 1, 1)
    fresh = perc.DilatedResNet50Encoder(LAYERS)
    perc.load_ade20k_resnet(fresh, sd)
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in encoder.state_dict().items())
    # num_batches_tracked is optional, any other missing key is not
    perc.load_ade20k_resnet(fresh, {k: v for k, v in sd.items()
                                    if "num_batches" not in k})
    with pytest.raises(RuntimeError, match="Missing"):
        perc.load_ade20k_resnet(fresh, {k: v for k, v in sd.items()
                                        if "layer4" not in k})


@pytest.fixture(scope="module")
def vgg19():
    return seeded(perc.perceptual_vgg(), 2)


@pytest.mark.parametrize("masked", [False, True])
def test_vgg_perceptual_losses(vgg19, masked):
    a, b = images(3)
    mask = (np.random.RandomState(4).rand(2, 1, 32, 32) > 0.5).astype(
        np.float32)
    params = jperc.convert_vgg_features_state_dict(numpy_state(vgg19))
    jm = nhwc(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jperc.vgg_perceptual_partial_losses(params, nhwc(a), nhwc(b), jm)
    with torch.no_grad():
        got = perc.vgg_perceptual_partial_losses(
            vgg19, torch.from_numpy(a), torch.from_numpy(b), tm)
        total = perc.vgg_perceptual_loss(vgg19, torch.from_numpy(a),
                                         torch.from_numpy(b), tm)
    assert len(got) == len(want) == 13  # the ReLUs of vgg19[:30]
    for g, w in zip(got, want):
        rel_close(g, w)
    rel_close(total, jperc.vgg_perceptual_loss(params, nhwc(a), nhwc(b), jm))


@pytest.mark.parametrize("cfg,max_layers,tap", [
    ((8, 8, "M", 16, "M", 16), None, "pre_pool"),
    ((8, "M", 16, 16, "M"), None, "pre_pool"),
    ((8, 8, "M", 16, 16, "M", 16), 8, "relu"),
    ((8, 8, "M", 16, 16, "M", 16), 7, "pre_pool")])
def test_vgg_tap_modes(cfg, max_layers, tap):
    vgg = seeded(perc.VGGFeatures(cfg, max_layers, True, tap), 5)
    x, _ = images(5, size=16)
    want = jperc.VGGFeatures(cfg=cfg, max_layers=max_layers,
                             use_avg_pool=True, tap=tap).apply(
        {"params": jperc.convert_vgg_features_state_dict(numpy_state(vgg))},
        nhwc(x))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        rel_close(g.permute(0, 2, 3, 1), w)


def test_load_vgg_features(vgg19):
    sd = {"features." + k: v for k, v in vgg19.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    fresh = perc.perceptual_vgg()
    perc.load_vgg_features(fresh, sd)
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in vgg19.state_dict().items())
    assert sorted(fresh.state_dict())[:2] == ["0.bias", "0.weight"]


def test_lpips():
    model = seeded(perc.LPIPS(), 6)
    a, b = images(7, size=64)
    sd = numpy_state(model)
    vgg_sd = {k.removeprefix("net."): v for k, v in sd.items()
              if k.startswith("net.")}
    lins = {f"lin{k.split('.')[1]}.model.1.weight": v
            for k, v in sd.items() if k.startswith("lins.")}
    want = jperc.LPIPS().apply(
        {"params": jperc.convert_lpips_state_dict(vgg_sd, lins)},
        nhwc(a), nhwc(b))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b))
        same = model(torch.from_numpy(a), torch.from_numpy(a))
    rel_close(got, want)
    assert got.shape == (2,) and float(same.abs().max()) == 0.0
    # the lpips package's heads in either of its names, loaded strictly
    fresh = perc.LPIPS()
    heads = {k: torch.from_numpy(v) for k, v in lins.items()}
    heads.update({k.replace("lin", "lins.", 1): v for k, v in heads.items()})
    perc.load_lpips(fresh, {k: torch.from_numpy(v)
                            for k, v in vgg_sd.items()}, heads)
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in model.state_dict().items())
