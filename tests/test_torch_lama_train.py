"""LaMa's GAN training: losses, the discriminator, the metrics and one
generator / discriminator alternation, the port against the JAX package,
fp32 on the CPU.

Weights are the port's seeded ones (the generator's and the
discriminator's BN running statistics included), carried to flax by the
JAX converter (the generator) and by :func:`disc_tree` (the
discriminator, which has no converter in the JAX package). Checked:

- the masked L1 / L2, feature matching (with a mask resized bilinear to
  each tap), the NSGAN terms and the discriminator's logits and taps;
- the mask resizing of both kinds at 256 → 35, the discriminator's logit
  size at 256²: ``nearest-exact`` is ``jax.image.resize``'s nearest, and
  plain ``nearest`` is not;
- the R1 loss: value, metrics and the gradients of the discriminator's
  parameters against ``jax.value_and_grad`` (the penalty's second-order
  term included);
- one ``generator_step`` then one ``discriminator_step`` (tiny config,
  batch 2 at 32², with and without ResNet-PL on a tiny dilated encoder)
  against the JAX steps: every metric, every parameter after the update,
  the generator's BN running statistics (flax's biased-variance update),
  and the discriminator's left as they were. Both sides run Adam at eps
  1e-5: at optax's 1e-8 the first update divides a gradient by its own
  magnitude, so a 1e-9 difference in a near-zero gradient becomes a
  difference of a good part of ``lr``;
- ``ssim``, ``psnr`` and ``frechet_distance``.

Tolerances: losses and activations 1e-5 of their scale (2e-5 for the
steps' losses); gradients 1e-4 of each one's largest magnitude; parameters
after a step within 1 % of the step's ``lr`` (1e-5 for the generator,
1e-6 for the discriminator; an update is at most about ``lr``).
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from followyourclick_tpu.inpaint import convert as jconvert
from followyourclick_tpu.inpaint import lama as jlama
from followyourclick_tpu.inpaint import losses as jlosses
from followyourclick_tpu.inpaint import train as jtrain
from followyourclick_tpu_torch.inpaint import losses, train
from followyourclick_tpu_torch.inpaint.perceptual import (
    DilatedResNet50Encoder,
)
from tests.test_torch_lama import TINY, nhwc, numpy_state, seeded, tiny
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

REL = 1e-5
GRAD_REL = 1e-4
PARAM_REL = 1e-2  # of lr
STEP_EPS = 1e-5


def rel_close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def disc_tree(named, n_layers, stats=False):
    """Port discriminator entries by name (parameters, gradients or
    running statistics) → the JAX ``NLayerDiscriminator`` tree."""
    def conv(i):
        return {"kernel": named[f"model{i}.0.weight"].transpose(2, 3, 1, 0),
                "bias": named[f"model{i}.0.bias"]}

    if stats:
        return {f"bn{n}": {"mean": named[f"model{n}.1.running_mean"],
                           "var": named[f"model{n}.1.running_var"]}
                for n in range(1, n_layers + 1)}
    tree = {"conv0": conv(0), "pred": conv(n_layers + 1)}
    for n in range(1, n_layers + 1):
        tree[f"conv{n}"] = conv(n)
        tree[f"bn{n}"] = {"scale": named[f"model{n}.1.weight"],
                          "bias": named[f"model{n}.1.bias"]}
    return tree


def disc_vars(d):
    sd = numpy_state(d)
    return {"params": disc_tree(sd, d.n_layers),
            "batch_stats": disc_tree(sd, d.n_layers, stats=True)}


def discriminator(ndf=8, n_layers=2, seed=0):
    return train.build_discriminator(ndf, n_layers, "cpu",
                                     torch.Generator().manual_seed(seed))


def data(seed, b=2, size=32):
    rs = np.random.RandomState(seed)
    image = rs.rand(b, 3, size, size).astype(np.float32)
    mask = (rs.rand(b, 1, size, size) > 0.6).astype(np.float32)
    return image, mask


def test_masked_pixel_losses():
    rs = np.random.RandomState(0)
    pred, target = (rs.rand(2, 3, 16, 16).astype(np.float32)
                    for _ in range(2))
    mask = (rs.rand(2, 1, 16, 16) > 0.5).astype(np.float32)
    t = [torch.from_numpy(a) for a in (pred, target, mask)]
    j = [nhwc(a) for a in (pred, target, mask)]
    for port, jax_fn in ((losses.masked_l1_loss, jlosses.masked_l1_loss),
                         (losses.masked_l2_loss, jlosses.masked_l2_loss)):
        for known, missing in ((10.0, 0.0), (1.0, 3.0)):
            rel_close(port(*t, known, missing), jax_fn(*j, known, missing))


@pytest.mark.parametrize("masked", [False, True])
def test_feature_matching(masked):
    rs = np.random.RandomState(1)
    shapes = [(2, 8, 17, 17), (2, 16, 9, 9), (2, 16, 35, 35)]
    fake = [rs.randn(*s).astype(np.float32) for s in shapes]
    real = [rs.randn(*s).astype(np.float32) for s in shapes]
    mask = (rs.rand(2, 1, 64, 64) > 0.5).astype(np.float32)
    got = losses.feature_matching_loss(
        [torch.from_numpy(a) for a in fake],
        [torch.from_numpy(a) for a in real],
        torch.from_numpy(mask) if masked else None)
    want = jlosses.feature_matching_loss(
        [nhwc(a) for a in fake], [nhwc(a) for a in real],
        nhwc(mask) if masked else None)
    rel_close(got, want)


def test_nsgan_generator_loss():
    x = np.random.RandomState(2).randn(2, 1, 5, 5).astype(np.float32)
    rel_close(losses.generator_nsgan_loss(torch.from_numpy(x)),
              jlosses.generator_nsgan_loss(nhwc(x)))


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_mask_resize_at_the_logit_size(method):
    """256 → 35: the discriminator's logits at 256² (ndf 64, 3 layers)."""
    mask = (np.random.RandomState(3).rand(2, 1, 256, 256) > 0.5).astype(
        np.float32)
    got = losses.resize_mask(torch.from_numpy(mask), (35, 35), method)
    want = jax.image.resize(nhwc(mask), (2, 35, 35, 1), method)
    rel_close(got.permute(0, 2, 3, 1), want)
    if method == "nearest":
        # JAX samples rows 3, 10, 18, ...; torch's "nearest" 0, 7, 14, ...
        plain = F.interpolate(torch.from_numpy(mask), size=(35, 35),
                              mode="nearest")
        assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    with torch.no_grad():
        d = losses.NLayerDiscriminator()
        shape = d(torch.zeros(1, 3, 256, 256))[0].shape
    assert tuple(shape[-2:]) == (35, 35)


def test_discriminator_matches_jax():
    d = discriminator(ndf=8, n_layers=3, seed=1)
    x = np.random.RandomState(4).rand(2, 3, 40, 40).astype(np.float32)
    logits, feats = jlosses.NLayerDiscriminator(ndf=8, n_layers=3).apply(
        disc_vars(d), nhwc(x))
    with torch.no_grad():
        got, got_feats = d(torch.from_numpy(x))
    rel_close(got.permute(0, 2, 3, 1), logits)
    assert len(got_feats) == len(feats) == 4
    for g, w in zip(got_feats, feats):
        rel_close(g.permute(0, 2, 3, 1), w)
    assert sorted(d.state_dict())[:3] == ["model0.0.bias", "model0.0.weight",
                                          "model1.0.bias"]


def test_r1_discriminator_loss_and_grads():
    d = discriminator(seed=2)
    jd = jlosses.NLayerDiscriminator(ndf=8, n_layers=2)
    variables = disc_vars(d)
    real, mask = data(5)
    fake = np.random.RandomState(6).rand(*real.shape).astype(np.float32)

    def loss_fn(params):
        def discr_fn(p, x):
            return jd.apply({"params": p,
                             "batch_stats": variables["batch_stats"]}, x)
        return jlosses.discriminator_nsgan_r1_loss(
            discr_fn, params, nhwc(real), nhwc(fake), nhwc(mask),
            gp_coef=0.5)

    (want, wmetrics), wgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    loss, metrics = losses.discriminator_nsgan_r1_loss(
        d, torch.from_numpy(real), torch.from_numpy(fake),
        torch.from_numpy(mask), gp_coef=0.5)
    loss.backward()
    rel_close(loss, want)
    for k in ("discr_real_out", "discr_fake_out", "r1"):
        rel_close(metrics[k], wmetrics[k])
    assert float(metrics["r1"].detach()) > 0
    grads = disc_tree({k: p.grad.numpy() for k, p in d.named_parameters()},
                      d.n_layers)
    flat = jax.tree_util.tree_leaves_with_path(wgrads)
    assert len(flat) == len(list(d.parameters()))
    for path, w in flat:
        g = grads
        for key in path:
            g = g[key.key]
        rel_close(g, w, GRAD_REL)


def test_r1_reaches_the_parameters():
    """The penalty's gradient reaches D's parameters (create_graph): the
    parameters' gradients move with ``gp_coef``."""
    real, mask = data(7)
    fake = np.zeros_like(real)
    got = []
    for coef in (0.0, 10.0):
        d = discriminator(seed=3)
        loss, _ = losses.discriminator_nsgan_r1_loss(
            d, torch.from_numpy(real), torch.from_numpy(fake),
            torch.from_numpy(mask), gp_coef=coef)
        loss.backward()
        got.append(d.model0[0].weight.grad.clone())
    assert not torch.allclose(got[0], got[1])


def patched_adam(monkeypatch):
    monkeypatch.setattr(jtrain, "make_optimizers", lambda cfg: (
        optax.adam(cfg.gen_lr, eps=STEP_EPS),
        optax.adam(cfg.discr_lr, eps=STEP_EPS)))
    monkeypatch.setattr(train, "ADAM_EPS", STEP_EPS)


@pytest.fixture(scope="module")
def pl_encoder():
    enc = seeded(DilatedResNet50Encoder((1, 1, 1, 1)), 11)
    for p in enc.parameters():
        p.requires_grad_(False)
    from tests.test_torch_perceptual import ade20k_params

    return enc, ade20k_params(enc)


@pytest.mark.parametrize("with_pl", [False, True])
def test_one_alternation_matches_jax(monkeypatch, pl_encoder, with_pl):
    patched_adam(monkeypatch)
    cfg = train.LamaTrainConfig()
    jcfg = jtrain.LamaTrainConfig(resnet_pl_layers=(1, 1, 1, 1))
    gen_cfg, jgen_cfg = tiny()
    gen, disc, gen_opt, discr_opt = train.init_training(
        cfg, gen_cfg, ndf=8, n_layers=2, device="cpu",
        generator=torch.Generator().manual_seed(9))
    jgen = jlama.FFCResNetGenerator(jgen_cfg)
    jdisc = jlosses.NLayerDiscriminator(ndf=8, n_layers=2)
    gen_vars = jconvert.convert_lama_state_dict(numpy_state(gen), jgen_cfg)
    d_vars = disc_vars(disc)
    d_start = {k: v.clone() for k, v in disc.state_dict().items()}
    gen_opt_j, discr_opt_j = jtrain.make_optimizers(jcfg)
    gen_state, discr_state = (gen_opt_j.init(gen_vars["params"]),
                              discr_opt_j.init(d_vars["params"]))
    image, mask = data(10)
    batch = {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask)}
    jbatch = {"image": nhwc(image), "mask": nhwc(mask)}
    enc, enc_params = pl_encoder
    gen_vars, _, jmetrics, jinpainted = jtrain.generator_step(
        jgen, jdisc, jcfg, gen_vars, d_vars, gen_state, jbatch,
        enc_params if with_pl else None)
    metrics, inpainted = train.generator_step(
        gen, disc, cfg, gen_opt, batch, enc if with_pl else None)
    assert set(metrics) == set(jmetrics)
    assert ("resnet_pl" in metrics) == with_pl
    for k in jmetrics:
        rel_close(metrics[k], jmetrics[k], 2 * REL)
    rel_close(inpainted.permute(0, 2, 3, 1), jinpainted)
    # D takes no gradient and keeps its state in the generator's step
    assert all(p.grad is None for p in disc.parameters())
    assert all(torch.equal(v, d_start[k])
               for k, v in disc.state_dict().items())
    if with_pl:
        assert all(p.grad is None for p in enc.parameters())
    got = jconvert.convert_lama_state_dict(numpy_state(gen), jgen_cfg)
    for coll in ("params", "batch_stats"):
        for (path, w), (_, g) in zip(
                jax.tree_util.tree_leaves_with_path(gen_vars[coll]),
                jax.tree_util.tree_leaves_with_path(got[coll])):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=PARAM_REL * cfg.gen_lr,
                                       err_msg=str(path))
    d_vars_after, _, jdm = jtrain.discriminator_step(
        jdisc, jcfg, d_vars, discr_state, jbatch, jinpainted)
    dm = train.discriminator_step(disc, cfg, discr_opt, batch, inpainted)
    assert set(dm) == set(jdm)
    for k in jdm:
        rel_close(dm[k], jdm[k], 2 * REL)
    tree = disc_tree(numpy_state(disc), disc.n_layers)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_leaves_with_path(d_vars_after["params"]),
            jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=PARAM_REL * cfg.discr_lr,
                                   err_msg=str(path))
    # D's running statistics: unchanged, bit for bit, on both sides
    for k in ("running_mean", "running_var"):
        assert torch.equal(disc.model1[1]._buffers[k],
                           d_start[f"model1.1.{k}"])
    assert all(p.grad is not None for p in disc.parameters())


def test_alternations_move_every_parameter():
    cfg = train.LamaTrainConfig()
    gen, disc, gen_opt, discr_opt = train.init_training(
        cfg, train.LamaConfig(**TINY), ndf=8, n_layers=2, device="cpu",
        generator=torch.Generator().manual_seed(12))
    start_g = {k: v.clone() for k, v in gen.state_dict().items()}
    start_d = {k: v.clone() for k, v in disc.state_dict().items()}
    image, mask = data(13)
    batch = {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask)}
    for _ in range(2):
        gm, inpainted = train.generator_step(gen, disc, cfg, gen_opt, batch)
        dm = train.discriminator_step(disc, cfg, discr_opt, batch, inpainted)
        assert all(bool(torch.isfinite(v)) for v in {**gm, **dm}.values())
    for name, p in gen.named_parameters():
        assert not torch.equal(p, start_g[name]), name
    for name, p in disc.named_parameters():
        assert not torch.equal(p, start_d[name]), name
    stats = [k for k in start_g if k.endswith("running_var")]
    assert all(not torch.equal(gen.state_dict()[k], start_g[k])
               for k in stats)
    assert all(torch.equal(disc.state_dict()[k], start_d[k])
               for k in start_d if "running" in k)


def test_ssim_and_psnr():
    rs = np.random.RandomState(14)
    a = rs.rand(2, 3, 32, 32).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(*a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    rel_close(losses.ssim(ta, tb), jlosses.ssim(nhwc(a), nhwc(b)))
    rel_close(losses.ssim(ta, ta), jlosses.ssim(nhwc(a), nhwc(a)))
    rel_close(losses.psnr(ta, tb), jlosses.psnr(nhwc(a), nhwc(b)))


def test_frechet_distance():
    rs = np.random.RandomState(15)
    a, b = rs.randn(200, 6), rs.randn(200, 6) * 1.5 + 0.5
    for x, y in ((a, b), (a, a)):
        assert losses.frechet_distance(x, y) == pytest.approx(
            jlosses.frechet_distance(x, y), rel=1e-9, abs=1e-9)
