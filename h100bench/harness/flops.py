"""Matmul and convolution FLOPs of the cells' work, counted once from the
plain reference at the cell's shapes on the meta device
(``torch.utils.flop_counter.FlopCounterMode``), so the count is the same
whatever implements the work."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench.reference.train import trainable
from h100bench.reference.unet import UNet3D
from h100bench.reference.vae import VAE, CLIPText


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def _models(config):
    with torch.device("meta"):
        return UNet3D(config), VAE(config), CLIPText(config)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, device="meta", dtype=dtype)


@functools.lru_cache(maxsize=8)
def _request_flops(config_json: str, traffic_json: str) -> int:
    config, tr = json.loads(config_json), json.loads(traffic_json)
    unet, vae, text = _models(config)
    b, f = tr["clips"], tr["frames"]
    h, w = tr["height"] // 8, tr["width"] // 8
    rows = 2 * b  # classifier-free guidance: [uncond; cond]
    d = config["clip_text"]["hidden_size"]
    with torch.no_grad():
        prompts = _count(lambda: text(_meta(rows, 77, dtype=torch.long)))
        encode = _count(lambda: vae.encode(_meta(b, 8 * h, 8 * w, 3)))
        step = _count(lambda: unet(_meta(rows, f, h, w, 9), _meta(rows),
                                   _meta(rows, 77, d), _meta(rows),
                                   _meta(rows)))
        decode = _count(lambda: vae.decode(_meta(b * f, h, w, 4)))
    return prompts + encode + tr["steps"] * step + decode


def request_flops(config: dict, traffic: dict) -> int:
    """One exact-schedule request with guidance: the two prompts, the
    first frame's encode, every step's UNet on both halves, the decode."""
    return _request_flops(json.dumps(config, sort_keys=True),
                          json.dumps(traffic, sort_keys=True))


@functools.lru_cache(maxsize=16)
def _step_flops(config_json: str, traffic_json: str, frames: int) -> int:
    config, tr = json.loads(config_json), json.loads(traffic_json)
    unet, vae, text = _models(config)
    b, f = tr["batch"], tr["frames"]
    h, w = tr["height"] // 8, tr["width"] // 8
    d = config["clip_text"]["hidden_size"]
    for n, p in unet.named_parameters():
        p.requires_grad_(trainable(n, config["train"]["trainable_modules"]))
    with torch.no_grad():
        encode = _count(lambda: vae.encode(_meta(b * f, 8 * h, 8 * w, 3)))
        prompts = _count(lambda: text(_meta(b, 77, dtype=torch.long)))

    def fwd_bwd():
        out = unet(_meta(b, frames, h, w, 9), _meta(b), _meta(b, 77, d),
                   _meta(b), _meta(b))
        out.float().square().mean().backward()

    return encode + prompts + _count(fwd_bwd)


def step_flops(config: dict, traffic: dict, frames: int) -> int:
    """One training step at a crop of ``frames``: the encode of every
    frame of the batch's clips, the prompts, the UNet's forward and
    backward (the gradients of the trainable leaves and of the
    activations; no recompute)."""
    return _step_flops(json.dumps(config, sort_keys=True),
                       json.dumps(traffic, sort_keys=True), frames)
