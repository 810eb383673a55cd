"""The card: its presence, name, power limit and memory peak."""

from __future__ import annotations

import subprocess
import sys

import torch

BF16_PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def require_cards(count: int) -> None:
    """Exit with code 3, printing no result, unless ``count`` cards are
    there: a run never falls back to the CPU."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: the cell needs {count} CUDA card(s), found "
              f"{found}", file=sys.stderr)
        sys.exit(3)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" where
    it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
        return out[0].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_record(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}
