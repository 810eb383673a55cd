"""The whole training step's share of the card's bf16 peak: the matmul and
conv FLOPs of the traced steps (the encode of the batch's clips, the
prompts, the UNet's forward and backward at each step's frame crop, no
recompute; counted from the plain reference, ``harness/flops.py``) over
the traced window × 989 TFLOP/s (H100 SXM dense bf16, at 700 W)."""

from h100bench.harness import flops
from h100bench.harness.device import BF16_PEAK_FLOPS


def read(rec):
    steps = [w for w in rec.work if w["kind"] == "step"]
    if not steps:
        return None
    total = sum(flops.step_flops(rec.cell.config, rec.cell.traffic,
                                 w["clip_frames"]) for w in steps)
    return 100.0 * total / (rec.window_s * BF16_PEAK_FLOPS)
