"""Device ms per training step in the kernels' fp32 recompute backward:
the kernels launched inside the autograd engine's nodes of the port's
kernel Functions (``ops/autograd.Recompute`` subclasses and
``FlashAttentionGrad``, nodes named ``<Function>Backward``), as
``chip_profile.py train`` reads them."""

from h100bench.harness.trace import range_device_us

NODES = ("MotionBlockGradBackward", "LnGegluGradBackward",
         "GegluGradBackward", "TemporalAttentionGradBackward",
         "TemporalBlockGradBackward", "FlashAttentionGradBackward",
         "GroupNormGradBackward", "LnCrossAttentionGradBackward")


def _label(e):
    name = e.get("name", "")
    if e.get("cat") == "cpu_op" and name.endswith(NODES):
        return "recompute"
    return None


def read(rec):
    steps = [w for w in rec.detail_work if w["kind"] == "step"]
    if not steps:
        return None
    us, _ = range_device_us(rec.events, _label)
    return us["recompute"] / 1e3 / len(steps)
