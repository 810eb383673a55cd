"""The port's LiteFlowNet against the JAX package's, at the published
widths of both ``configs/flow/liteflownet*_pre_flyingchairs.yaml``, and
the progressive stage load.

Weights as in ``tests/_torch_flow_parity.py``; on a pair of 64x64 images
(batch 2) every level (6 → 2) and the ``inference=True`` flow agree
within 1e-4 relative L2 (fp32 on both sides; measured 4e-7). The two
configs build the same model (the same decoder keys and values), so they
share one JAX compile.
"""

import functools

import numpy as np
import pytest
import torch
import yaml

from followyourclick_tpu.flow import liteflownet as jlite
from followyourclick_tpu.flow import registry as jreg
from followyourclick_tpu_torch.flow import liteflownet
from followyourclick_tpu_torch.flow.api import init_model
from followyourclick_tpu_torch.flow.convert import flow_state_from_jax
from followyourclick_tpu_torch.flow.registry import flow_estimator
from tests._torch_flow_parity import REL_L2, Pair, images, nchw, nhwc, \
    rel_l2
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CONFIGS = ["configs/flow/liteflownet_pre_flyingchairs.yaml",
           "configs/flow/liteflownet2_pre_flyingchairs.yaml"]


def model_section(path):
    with open(path) as f:
        return yaml.safe_load(f)["model"]


@functools.lru_cache(maxsize=None)
def run(spec):
    cfg = {"type": "LiteFlowNet",
           "decoder": {"flow_div": spec.config.flow_div,
                       "regularized_flow": spec.config.regularized_flow}}
    pair = Pair(jreg.build_flow_estimator(cfg), cfg)
    a, b = images(4)
    return pair, pair.port_run(a, b), pair.jax_run(a, b)


@pytest.mark.parametrize("path", CONFIGS)
def test_levels_and_inference_match_jax(path):
    spec = flow_estimator(model_section(path))
    jmodel = jreg.build_flow_estimator(model_section(path))
    assert spec.config.regularized_flow == jmodel.config.regularized_flow
    assert spec.config.flow_div == jmodel.config.flow_div
    pair, (got, got_inf), (want, want_inf) = run(spec)
    assert list(got) == ["level6", "level5", "level4", "level3", "level2"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape[-2:] == want[k].shape[1:3], k
        assert rel_l2(nhwc(got[k]), want[k]) < REL_L2, k
    assert got_inf.shape == (2, 2, 64, 64)
    assert np.abs(want_inf).max() > 0.1
    assert rel_l2(nhwc(got_inf), want_inf) < REL_L2


def test_stage_load_matches_jax():
    """Copying level 3's trained blocks onto level 2 (the first level of a
    new stage): where shapes match every tensor is copied (the NetS
    convs), where they do not (NetM / NetR ``pred_flow``, ``dist*``:
    patch 5 vs 7) it keeps its value, as in the JAX function."""
    spec = flow_estimator(model_section(CONFIGS[0]))
    pair, _, _ = run(spec)
    state = pair.port.state_dict()
    got = liteflownet.liteflownet_stage_load(state, 3, 2)
    want = jlite.liteflownet_stage_load(pair.variables["params"], 3, 2)
    want = flow_state_from_jax({"params": want}, pair.port)
    assert list(got) == list(state)
    copied = kept = 0
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
        top, _, rest = name.partition(".")
        if not top.endswith("level2"):
            assert torch.equal(t, state[name]), name
            continue
        src = state.get(top[:-1] + "3." + rest)
        if src is not None and src.shape == t.shape:
            assert torch.equal(t, src), name
            copied += 1
        else:
            assert torch.equal(t, state[name]), name
            kept += 1
    assert copied > 20 and kept > 5
    # the input is left as it was
    assert not torch.equal(state["NetS_level2.conv1.weight"],
                           state["NetS_level3.conv1.weight"])


def test_unregularised_finest_level():
    """``regularized_flow: false`` builds no level-2 NetR, as in JAX."""
    spec = flow_estimator({"type": "LiteFlowNet",
                           "decoder": {"regularized_flow": False}})
    model = init_model(spec, seed=1, device="cpu")
    assert not hasattr(model, "NetR_level2")
    assert hasattr(model, "NetR_level3")
    a, b = images(5, batch=1)
    with torch.no_grad():
        out = model(nchw(a), nchw(b))
    assert out["level2"].shape == (1, 2, 32, 32)
