"""The whole request's share of the card's bf16 peak: the matmul and conv
FLOPs of the traced requests (counted from the plain reference at the
cell's shapes, ``harness/flops.py``) over the traced window × 989 TFLOP/s
(H100 SXM dense bf16, at 700 W; the run prints the card's power limit).
Counts an exact-schedule request only; another schedule reads nothing."""

from h100bench.harness import flops
from h100bench.harness.device import BF16_PEAK_FLOPS


def read(rec):
    traffic = rec.cell.traffic
    requests = [w for w in rec.work if w["kind"] == "request"]
    if traffic.get("schedule") != "exact" or not requests:
        return None
    total = len(requests) * flops.request_flops(rec.cell.config, traffic)
    return 100.0 * total / (rec.window_s * BF16_PEAK_FLOPS)
