"""The LN → GEGLU → residual kernel's share of its roofline
(``ops/geglu.py``, ``csrc/geglu.cu``): Σ bound / Σ device time over the
traced calls, in percent. Each call runs in the benchmark's range, named
with its (rows R, channels C); the bound is the larger of its operations
at 989 TFLOP/s and its bytes at 3.35 TB/s:

- operations: the two products, 2·R·C·8C + 2·R·4C·C = 24·R·C²;
- bytes (bf16): the input and the output once (2·R·C each) and every
  weight once (LayerNorm 2C, W₁ 8C² and its bias 8C, W₂ 4C² and its bias
  C)."""

from h100bench.harness import trace as tr
from h100bench.harness.device import BF16_PEAK_FLOPS, HBM_BYTES_PER_S

NAME = "fused_ln_geglu"
PACKAGE = "followyourclick_tpu_torch.models"


def ops_bytes(r, c):
    ops = 24 * r * c * c
    nbytes = 2 * (2 * r * c + 12 * c * c + 11 * c)
    return ops, nbytes


def bound_s(r, c):
    ops, nbytes = ops_bytes(r, c)
    return max(ops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def _shaped(fn):
    def run(x, *a, **k):
        r, c = x.shape
        return tr.ranged(f"{NAME}:{r}x{c}", fn)(x, *a, **k)
    return run


def ranges(program):
    return {NAME: lambda: tr.call_sites_ranged(NAME, _shaped, PACKAGE)}


def read(rec):
    us, calls = rec.ranges()
    prefix = tr.RANGE_PREFIX + NAME + ":"
    bound = device = 0.0
    for name, n in calls.items():
        if name.startswith(prefix):
            r, c = (int(v) for v in name[len(prefix):].split("x"))
            bound += n * bound_s(r, c)
            device += us[name] / 1e6
    if device <= 0:
        return None
    return 100.0 * bound / device
