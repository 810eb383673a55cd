"""The port's FlowNet family against the JAX package's, at the published
widths: FlowNetS, FlowNetC, FlowNetCSS (both FlowNetS stages), the
FlowNetSD branch and FlowNet2, with the pieces they add.

Weights as in ``tests/_torch_flow_parity.py``; on a pair of 64x64 images
(batch 2) every training-mode level and the ``inference=True`` flow agree
within 1e-4 relative L2 (fp32 on both sides; measured 1e-6 for S and C,
1.6e-5 to 1.7e-5 for CSS and FlowNet2, whose warp of the image by the
upsampled flow passes on the first stage's rounding).
"""

import functools

import jax
import numpy as np
import pytest
import torch
import yaml

from followyourclick_tpu.flow import flownet as jflownet
from followyourclick_tpu.flow import flownet2 as jflownet2
from followyourclick_tpu.flow import registry as jreg
from followyourclick_tpu_torch.flow import flownet, flownet2
from followyourclick_tpu_torch.flow.api import init_model
from followyourclick_tpu_torch.flow.registry import FlowEstimator, \
    flow_estimator
from tests._torch_flow_parity import REL_L2, Pair, images, jax_tree, nchw, \
    nhwc, rel_l2
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CONFIGS = {
    "FlowNetS": "configs/flow/flownets_slong_flyingchairs.yaml",
    "FlowNetC": "configs/flow/flownetc_slong_flyingchairs.yaml",
    "FlowNetCSS": "configs/flow/flownet_css_sfine_flyingthings3d.yaml",
    "FlowNet2": "configs/flow/flownet2_sfine_flyingthings3d.yaml",
}
LEVELS = {"FlowNet2": ["level3", "level2", "level1"]}


@functools.lru_cache(maxsize=None)
def run(kind: str):
    """(pair, port (levels, inference), JAX (levels, inference)); FlowNet2's
    JAX run also captures its FlowNetSD branch's levels."""
    with open(CONFIGS[kind]) as f:
        cfg = yaml.safe_load(f)["model"]
    pair = Pair(jreg.build_flow_estimator(cfg), cfg)
    a, b = images(2)
    want = pair.jax_run(a, b, capture=("flownetSD",) if kind == "FlowNet2"
                        else ())
    return pair, pair.port_run(a, b), want


def without_capture(want):
    (levels, _), inference = want
    return levels, inference


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_levels_and_inference_match_jax(kind):
    pair, (got, got_inf), want = run(kind)
    if kind == "FlowNet2":
        want = without_capture(want)
    want, want_inf = want
    assert list(got) == LEVELS.get(
        kind, ["level6", "level5", "level4", "level3", "level2"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape[-2:] == want[k].shape[1:3], k
        assert rel_l2(nhwc(got[k]), want[k]) < REL_L2, k
    assert got_inf.shape == (2, 2, 64, 64)
    assert np.abs(want_inf).max() > 0.1
    assert rel_l2(nhwc(got_inf), want_inf) < REL_L2


def test_flownet_sd_branch_matches_jax():
    """FlowNetSD alone (the JAX module has no config of its own) in the
    port, against the levels the JAX FlowNet2 run captures from its
    branch."""
    pair, _, ((_, captured), _) = run("FlowNet2")
    want = captured["flownetSD"]
    a, b = images(2)
    with torch.no_grad():
        got = pair.rebuilt.flownetSD(nchw(a), nchw(b))
    assert list(got) == ["level6", "level5", "level4", "level3", "level2"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert rel_l2(nhwc(got[k]), want[k]) < REL_L2, k


def test_css_with_one_refinement_stage():
    """``flownetS2: null`` in the model section drops the second FlowNetS
    stage, as in the JAX registry."""
    spec = flow_estimator({"type": "FlowNetCSS", "flownetS2": None})
    assert dict(spec.kwargs) == {"two_s_stages": False}
    with torch.device("meta"):
        model = spec.build()
    assert not hasattr(model, "flownetS2")
    jmodel = jreg.build_flow_estimator({"type": "FlowNetCSS",
                                        "flownetS2": None})
    assert jmodel.two_s_stages is False


def test_links_match_jax():
    """FlowNet2's two estimator links: the upsampled flow, the image warped
    by it with border padding, its norm and brightness error."""
    rs = np.random.RandomState(7)
    img1 = rs.randn(1, 24, 32, 3).astype(np.float32)
    img2 = rs.randn(1, 24, 32, 3).astype(np.float32)
    flow = rs.randn(1, 6, 8, 2).astype(np.float32)
    want = jflownet.basic_link(img1, img2, flow, 20.0)
    got = flownet.basic_link(nchw(img1), nchw(img2), nchw(flow), 20.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=2e-4)
    want = jflownet2._link(img1, img2, flow, 20.0)
    got = flownet2.fusion_link(nchw(img1), nchw(img2), nchw(flow), 20.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=2e-4)


def test_checkpoint_round_trip(tmp_path):
    """A port state dict saved as ``{"state_dict": ...}`` loads strictly
    through ``init_model``; the JAX tree of the loaded model is the
    original's."""
    spec = FlowEstimator(flownet.FlowNetS, flownet.FlowNetConfig())
    model = init_model(spec, seed=4, device="cpu")
    path = tmp_path / "flownets.pth"
    torch.save({"state_dict": model.state_dict()}, path)
    again = init_model(spec, checkpoint=str(path), device="cpu")
    a, b = jax_tree(model)["params"], jax_tree(again)["params"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, a, b))
    state = model.state_dict()
    state.pop("decoder.level2.predict.bias")
    torch.save({"state_dict": state}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        init_model(spec, checkpoint=str(path), device="cpu")
