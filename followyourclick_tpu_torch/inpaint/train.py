"""LaMa inpainting GAN training steps.

Port of ``followyourclick_tpu/inpaint/train.py`` (the reference's
``saicinpainting/training/trainers/default.py``): the generator's loss is
the masked L1, the non-saturating adversarial term and the discriminator
feature matching (plus ResNet-PL when an encoder is given); the
discriminator's is NSGAN with the R1 penalty; two Adam optimizers (the
published big-LaMa weights: generator lr 1e-3, discriminator 1e-4, L1 known
10, adversarial 10, feature matching 100, ResNet-PL 30).

Plain functions on modules, updated in place. As in the JAX package:

- the generator runs in train-mode BN, its running statistics moved as
  flax moves them (:class:`inpaint.lama.BatchNorm2d`: momentum 0.1 on the
  biased batch variance);
- the discriminator runs on its running statistics in both steps (eval
  mode) and never changes them (the JAX steps apply it without ``train``);
- the generator step differentiates the generator's parameters only (the
  discriminator's accumulate nothing), feature matching takes no mask; the
  discriminator step sees the generator's output detached;
- ``torch.optim.Adam`` at optax's defaults (betas 0.9 / 0.999, eps 1e-8)
  is optax's Adam update.

Weights come from explicit ``torch.Generator`` s (:func:`init_training`);
the steps draw nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from followyourclick_tpu_torch.inpaint.lama import (
    BN_STATS,
    FFCResNetGenerator,
    LamaConfig,
    build_generator,
)
from followyourclick_tpu_torch.inpaint.losses import (
    NLayerDiscriminator,
    discriminator_nsgan_r1_loss,
    feature_matching_loss,
    generator_nsgan_loss,
    masked_l1_loss,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

ADAM_EPS = 1e-8  # optax.adam's default


@dataclasses.dataclass(frozen=True)
class LamaTrainConfig:
    gen_lr: float = 1e-3
    discr_lr: float = 1e-4
    l1_weight_known: float = 10.0
    l1_weight_missing: float = 0.0
    adv_weight: float = 10.0
    fm_weight: float = 100.0
    r1_gp_coef: float = 0.001
    # the ResNet-PL term, active when generator_step is given an encoder
    # (whose stages stand in for the JAX config's resnet_pl_layers)
    resnet_pl_weight: float = 30.0


def make_optimizers(cfg: LamaTrainConfig, generator: nn.Module,
                    discriminator: nn.Module
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    return (torch.optim.Adam(generator.parameters(), cfg.gen_lr,
                             eps=ADAM_EPS),
            torch.optim.Adam(discriminator.parameters(), cfg.discr_lr,
                             eps=ADAM_EPS))


@contextlib.contextmanager
def frozen(*modules: Optional[nn.Module]):
    """The parameters of ``modules`` (None skipped) take no gradient inside
    the block."""
    params = [p for m in modules if m is not None for p in m.parameters()
              if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@checked_precision()
def generator_step(generator: FFCResNetGenerator,
                   discriminator: NLayerDiscriminator, cfg: LamaTrainConfig,
                   gen_opt: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor],
                   resnet_pl: Optional[nn.Module] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One generator update on ``batch`` (``image`` ``(B, 3, H, W)`` in [0,
    1], ``mask`` ``(B, 1, H, W)``, 1 in the hole). ``resnet_pl``: a frozen
    ``DilatedResNet50Encoder``, whose ResNet-PL term then joins the loss.
    Returns the metrics (detached) and the inpainted batch (detached)."""
    from followyourclick_tpu_torch.inpaint.perceptual import resnet_pl_loss

    image, mask = batch["image"], batch["mask"]
    generator.train()
    discriminator.eval()
    with frozen(discriminator, resnet_pl):
        pred = generator(torch.cat([image * (1.0 - mask), mask], dim=1))
        inpainted = mask * pred + (1.0 - mask) * image
        l1 = masked_l1_loss(pred, image, mask, cfg.l1_weight_known,
                            cfg.l1_weight_missing)
        fake_pred, fake_feats = discriminator(inpainted)
        with torch.no_grad():
            _, real_feats = discriminator(image)
        adv = generator_nsgan_loss(fake_pred)
        fm = feature_matching_loss(fake_feats, real_feats)
        loss = l1 + cfg.adv_weight * adv + cfg.fm_weight * fm
        metrics = {"l1": l1, "adv": adv, "fm": fm}
        if resnet_pl is not None:
            pl = resnet_pl_loss(resnet_pl, inpainted, image,
                                weight=cfg.resnet_pl_weight)
            loss = loss + pl
            metrics["resnet_pl"] = pl
        gen_opt.zero_grad(set_to_none=True)
        loss.backward()
    gen_opt.step()
    metrics["gen_total"] = loss
    return {k: v.detach() for k, v in metrics.items()}, inpainted.detach()


@checked_precision()
def discriminator_step(discriminator: NLayerDiscriminator,
                       cfg: LamaTrainConfig,
                       discr_opt: torch.optim.Optimizer,
                       batch: Dict[str, torch.Tensor],
                       inpainted: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One discriminator update (NSGAN + R1) against the generator's
    ``inpainted`` output, detached. Returns the metrics (detached)."""
    discriminator.eval()
    loss, metrics = discriminator_nsgan_r1_loss(
        discriminator, batch["image"], inpainted.detach(),
        batch["mask"][:, :1], gp_coef=cfg.r1_gp_coef)
    discr_opt.zero_grad(set_to_none=True)
    loss.backward()
    discr_opt.step()
    metrics["discr_total"] = loss
    return {k: v.detach() for k, v in metrics.items()}


def build_discriminator(ndf: int = 64, n_layers: int = 3, device="cuda",
                        generator: Optional[torch.Generator] = None
                        ) -> NLayerDiscriminator:
    """An ``NLayerDiscriminator`` on ``device`` (eval mode) with seeded
    weights and BN running statistics from ``generator``."""
    with torch.device("meta"):
        model = NLayerDiscriminator(ndf=ndf, n_layers=n_layers)
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.num_batches_tracked.zero_()
    seeded_init_(model, generator or torch.Generator().manual_seed(0),
                 buffers=BN_STATS)
    return model.eval()


def init_training(cfg: LamaTrainConfig,
                  gen_config: LamaConfig = LamaConfig(), ndf: int = 64,
                  n_layers: int = 3, device="cuda",
                  generator: Optional[torch.Generator] = None):
    """The generator (train mode) and discriminator (eval mode) with seeded
    weights drawn from ``generator`` (generator first), and their
    optimizers: ``(generator, discriminator, gen_opt, discr_opt)``."""
    generator = generator or torch.Generator(device=device).manual_seed(0)
    gen = build_generator(gen_config, device, generator).train()
    disc = build_discriminator(ndf, n_layers, device, generator)
    return (gen, disc, *make_optimizers(cfg, gen, disc))
