"""The whole-block motion kernel's share of its roofline
(``ops/motion_block.py``, ``csrc/motion_block.cu``): Σ bound / Σ device
time over the traced calls, in percent. Each call runs in the benchmark's
range, named with its (positions P, frames F, channels C, heads); the
bound is the larger of its operations at 989 TFLOP/s and its bytes at
3.35 TB/s for a whole temporal transformer block:

- operations: per position two attention sublayers (q, k, v and out
  projections 2·F·4C² each, q·kᵀ and p·v 2·F²·C each) and the GEGLU
  feed-forward (2·F·C·8C + 2·F·4C·C): 40·F·C² + 8·F²·C;
- bytes (bf16): the input and the output once (2·P·F·C each), every
  weight once (two attentions' LayerNorm, Wq, Wk, Wv, Wo and bias: 4C² +
  3C each; the feed-forward's LayerNorm, W₁ and bias, W₂ and bias: 12C² +
  11C) and the positional table (F·C)."""

from h100bench.harness import trace as tr
from h100bench.harness.device import BF16_PEAK_FLOPS, HBM_BYTES_PER_S

NAME = "fused_motion_block"
PACKAGE = "followyourclick_tpu_torch.models"


def ops_bytes(p, f, c):
    ops = p * (40 * f * c * c + 8 * f * f * c)
    nbytes = 2 * (2 * p * f * c + 2 * (4 * c * c + 3 * c)
                  + 12 * c * c + 11 * c + f * c)
    return ops, nbytes


def bound_s(p, f, c):
    ops, nbytes = ops_bytes(p, f, c)
    return max(ops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def _shaped(fn):
    def run(x, pe, params, scale, heads, *a, **k):
        p, f, c = x.shape
        label = f"{NAME}:{p}x{f}x{c}x{heads}"
        return tr.ranged(label, fn)(x, pe, params, scale, heads, *a, **k)
    return run


def ranges(program):
    return {NAME: lambda: tr.call_sites_ranged(NAME, _shaped, PACKAGE)}


def read(rec):
    us, calls = rec.ranges()
    prefix = tr.RANGE_PREFIX + NAME + ":"
    bound = device = 0.0
    for name, n in calls.items():
        if name.startswith(prefix):
            p, f, c, _ = (int(v) for v in name[len(prefix):].split("x"))
            bound += n * bound_s(p, f, c)
            device += us[name] / 1e6
    if device <= 0:
        return None
    return 100.0 * bound / device
