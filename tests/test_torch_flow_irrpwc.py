"""The port's IRR-PWC against the JAX package's, at the published widths
of ``configs/flow/irrpwc_sshort_flyingchairsocc.yaml``.

Weights as in ``tests/_torch_flow_parity.py``; on a pair of 64x64 images
(batch 2) every entry of the bidirectional output (forward and backward
flows, raw and refined, levels 6 → 0; the occlusions alike) and the
``inference=True`` flow agree within 1e-4 relative L2 (fp32 on both
sides; measured 9e-7). The structure is the JAX one
(``tests/test_flow.py::TestIRRPWC``); one flow decoder serves every level
and direction; the local-conv refinement and the occlusion BCE over the
output follow JAX too. (IRR-PWC has a file of its own: with the other
PWC-family models its JAX compiles take a file past a minute.)
"""

import functools

import jax
import numpy as np
import torch
import yaml

from followyourclick_tpu.flow import irrpwc as jirr
from followyourclick_tpu.flow import registry as jreg
from followyourclick_tpu.flow.unsup_losses import multi_level_bce as jbce
from followyourclick_tpu_torch.flow import irrpwc
from followyourclick_tpu_torch.flow.convert import flow_state_from_jax
from followyourclick_tpu_torch.flow.unsup_losses import multi_level_bce
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_
from tests._torch_flow_parity import REL_L2, Pair, images, jax_tree, nchw, \
    nhwc, rel_l2
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CONFIG = "configs/flow/irrpwc_sshort_flyingchairsocc.yaml"
LEVELS = [f"level{i}" for i in range(6, -1, -1)]


@functools.lru_cache(maxsize=None)
def run():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)["model"]
    pair = Pair(jreg.build_flow_estimator(cfg), cfg)
    a, b = images(1)
    return pair, pair.port_run(a, b), pair.jax_run(a, b)


def test_bidirectional_flows_and_occlusions_match_jax():
    _, ((flows, occs), _), ((jflows, joccs), _) = run()
    for got, want, names in ((flows, jflows, ("flow_fw", "flow_bw")),
                             (occs, joccs, ("occ_fw", "occ_bw"))):
        assert list(got) == list(names)
        for d in names:
            assert list(got[d]) == LEVELS
            for level in LEVELS:
                n = 1 if level in ("level1", "level0") else 2
                assert len(got[d][level]) == len(want[d][level]) == n
                for g, w in zip(got[d][level], want[d][level]):
                    assert g.shape[-2:] == w.shape[1:3]
                    assert rel_l2(nhwc(g), w) < REL_L2, (d, level)
    assert flows["flow_fw"]["level0"][0].shape == (2, 2, 64, 64)
    assert occs["occ_bw"]["level0"][0].shape == (2, 1, 64, 64)


def test_inference_matches_jax():
    _, (_, got), (_, want) = run()
    assert got.shape == (2, 2, 64, 64) and np.abs(want).max() > 0.1
    assert rel_l2(nhwc(got), want) < REL_L2


def test_one_flow_decoder_serves_every_level_and_direction():
    pair, _, _ = run()
    calls = []
    hook = pair.rebuilt.flow_decoders.register_forward_hook(
        lambda mod, inp, out: calls.append(inp[0].shape[-1]))
    try:
        a, b = images(1)
        with torch.no_grad():
            pair.rebuilt(nchw(a), nchw(b))
    finally:
        hook.remove()
    assert calls == [1, 1, 2, 2, 4, 4, 8, 8, 16, 16]
    assert not any("level" in n for n, _ in
                   pair.rebuilt.flow_decoders.named_parameters())


def test_occlusion_bce_over_the_output_matches_jax():
    """``multi_level_bce`` over the forward occlusions ([raw, refined]
    lists at levels 6 → 2), balanced, against a seeded target."""
    _, ((_, occs), _), ((_, joccs), _) = run()
    target = (np.random.RandomState(2).rand(2, 64, 64, 1) > 0.7).astype(
        np.float32)
    want = float(jax.jit(functools.partial(jbce, balance=True))(
        joccs["occ_fw"], target))
    got = float(multi_level_bce(occs["occ_fw"], nchw(target), balance=True))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_local_conv_refine_matches_jax():
    rs = np.random.RandomState(6)
    feat = rs.randn(1, 9, 11, 5).astype(np.float32)
    target = 5 * rs.randn(1, 9, 11, 2).astype(np.float32)
    seeded = seeded_init_(irrpwc.LocalConvRefine(5, (8, 8)),
                          torch.Generator().manual_seed(0))
    variables = jax_tree(seeded)
    jm = jirr.LocalConvRefine(feat_channels=(8, 8))
    want = np.asarray(jax.jit(jm.apply)(variables, feat, target))
    block = irrpwc.LocalConvRefine(5, (8, 8))
    block.load_state_dict(flow_state_from_jax(variables, block))
    got = nhwc(block(nchw(feat), nchw(target)).detach())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a softmax-weighted average stays inside the neighbourhood's range
    assert np.abs(got).max() <= np.abs(target).max() + 1e-5
