"""Tiny configurations and CPU stand-ins for the benchmark's CPU tests."""

from __future__ import annotations

import contextlib
import copy
import json

import torch

from h100bench.harness.cell import BENCH, Cell, load_cell

I2V = "i2v-exact-1clip"
TRAIN = "train-ms-256x448-b3"


def tiny_config(name: str = "fyc-i2v-sd15") -> dict:
    """The configuration file at widths a CPU test can hold."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["unet"].update(block_out_channels=[32, 64, 64, 64],
                       layers_per_block=1, norm_num_groups=8,
                       cross_attention_dim=32)
    cfg["unet"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["vae"].update(block_out_channels=[32, 64, 64, 64],
                      layers_per_block=1, norm_num_groups=8)
    cfg["clip_text"].update(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4)
    cfg["dtype"] = "float32"
    return cfg


def tiny_cell(name: str, steps: int = 3) -> Cell:
    """The cell with its own limits and a tiny configuration and clip."""
    cell = load_cell(name)
    if cell.traffic["driver"] == "sampler":
        cell.config = tiny_config("fyc-i2v-sd15")
        cell.traffic = dict(cell.traffic, frames=4, height=64, width=64,
                            steps=steps)
    else:
        cell.config = tiny_config("fyc-train-sd15-motion")
        # 128² keeps every level at 2 × 2 or more, where the gradients of
        # float32 runs agree (at 1 × 1 they are ill-conditioned)
        cell.traffic = dict(cell.traffic, batch=2, frames=8, height=128,
                            width=128)
        cell.config["train"]["min_frames"] = 2
    return cell


@contextlib.contextmanager
def no_card(monkeypatch):
    """``torch.cuda``'s clock and memory calls as no-ops, for a run on the
    CPU."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    yield
