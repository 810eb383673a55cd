"""The port's occlusion BCE and unsupervised flow losses against the JAX
package's; the registry over every ``configs/flow/*.yaml``; ``flow_tools
flops`` for every config on the meta device; ``train`` and ``test``
refusing the estimators that are not RAFT / GMA.

The losses agree within 1e-5 relative (fp32 on both sides). Each config's
registry entry has the JAX build function's module class and config, field for
field (JAX's ``dtype`` aside).
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from followyourclick_tpu.flow import registry as jreg
from followyourclick_tpu.flow import unsup_losses as jloss
from followyourclick_tpu_torch.cli import flow_tools
from followyourclick_tpu_torch.flow import unsup_losses as loss
from followyourclick_tpu_torch.flow.registry import FLOW_ESTIMATORS, \
    build_flow_estimator, flow_estimator
from tests._torch_flow_parity import nchw
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "flow", "*.yaml")))
LOSS_REL = 1e-5


def close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_binary_cross_entropy_matches_jax(balance, reduction):
    pred = 2 * rand(0, 2, 8, 12, 1)
    target = (np.random.RandomState(1).rand(2, 8, 12, 1) > 0.7).astype(
        np.float32)
    want = np.asarray(jloss.binary_cross_entropy(
        pred, target, balance=balance, reduction=reduction))
    got = loss.binary_cross_entropy(nchw(pred), nchw(target),
                                    balance=balance, reduction=reduction)
    if reduction == "none":
        assert got.shape == (2, 8, 12)
        np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_REL,
                                   atol=1e-7)
    else:
        close(got, want)


@pytest.mark.parametrize("balance", [False, True])
def test_multi_level_bce_with_irr_lists_matches_jax(balance):
    target = (np.random.RandomState(2).rand(2, 32, 32, 1) > 0.5).astype(
        np.float32)
    sizes = {"level6": 4, "level5": 8, "level4": 16, "level3": 32,
             "level2": 32}
    preds = {k: rand(i, 2, s, s, 1) for i, (k, s) in enumerate(
        sizes.items())}
    preds["level4"] = [preds["level4"], rand(9, 2, 16, 16, 1)]
    want = jloss.multi_level_bce(preds, target, balance=balance)
    port = {k: [nchw(a) for a in v] if isinstance(v, list) else nchw(v)
            for k, v in preds.items()}
    close(loss.multi_level_bce(port, nchw(target), balance=balance), want)


@pytest.mark.parametrize("patch", [3, 5])
def test_census_loss_matches_jax(patch):
    rs = np.random.RandomState(3)
    a = rs.rand(2, 16, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(*a.shape), 0, 1).astype(np.float32)
    close(loss.census_loss(nchw(a), nchw(b), patch),
          jloss.census_loss(a, b, patch))
    assert float(loss.census_loss(nchw(a), nchw(a), patch)) == 0.0


@pytest.mark.parametrize("weighting", ["exponential", "gaussian"])
@pytest.mark.parametrize("order", [1, 2])
def test_smoothness_matches_jax(order, weighting):
    flow = 3 * rand(4, 2, 12, 16, 2)
    image = np.random.RandomState(5).rand(2, 12, 16, 3).astype(np.float32)
    jfn = {1: jloss.smooth_1st_loss, 2: jloss.smooth_2nd_loss}[order]
    fn = {1: loss.smooth_1st_loss, 2: loss.smooth_2nd_loss}[order]
    for alpha in (0.0, 10.0):
        close(fn(nchw(flow), nchw(image), alpha, weighting),
              jfn(flow, image, alpha, weighting))


def test_registry_names():
    assert sorted(FLOW_ESTIMATORS) == sorted(jreg.FLOW_ESTIMATORS)
    kinds = set()
    for path in CONFIGS:
        with open(path) as f:
            kinds.add(yaml.safe_load(f)["model"]["type"])
    assert kinds == set(FLOW_ESTIMATORS)  # each name has a config
    with pytest.raises(KeyError, match="registered: \\['FlowNet2'"):
        build_flow_estimator({"type": "SpyNet"}, device="cpu")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_registry_reads_every_config_as_jax(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)["model"]
    spec = flow_estimator(cfg)
    jmodel = jreg.build_flow_estimator(cfg)
    assert spec.cls.__name__ == type(jmodel).__name__
    want = {k: v for k, v in dataclasses.asdict(jmodel.config).items()
            if k != "dtype"}
    assert dataclasses.asdict(spec.config) == want
    if cfg["type"] == "FlowNetCSS":
        assert dict(spec.kwargs) == {"two_s_stages": jmodel.two_s_stages}


def test_quirks_of_the_build_functions():
    """FlowNetCSS and FlowNet2 read ``flow_div`` at the top level (a
    decoder's is ignored); the others under ``decoder``."""
    for kind in ("FlowNetCSS", "FlowNet2"):
        assert flow_estimator({"type": kind, "flow_div": 5.0}
                              ).config.flow_div == 5.0
        assert flow_estimator({"type": kind, "decoder": {"flow_div": 5.0}}
                              ).config.flow_div == 20.0
    assert flow_estimator({"type": "PWCNet", "flow_div": 5.0}
                          ).config.flow_div == 20.0
    spec = flow_estimator({"type": "PWCNet", "decoder": {
        "flow_div": 5.0, "corr_cfg": {"max_displacement": 3}}})
    assert (spec.config.flow_div, spec.config.max_displacement) == (5.0, 3)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_flops_counts_every_config(path, capsys):
    flow_tools.main(["flops", "--config", path])
    out = json.loads(capsys.readouterr().out)
    with open(path) as f:
        cfg = yaml.safe_load(f)["model"]
    with torch.device("meta"):
        model = flow_estimator(cfg).build()
    n = sum(p.numel() for p in model.parameters())
    assert out["model"] == cfg["type"]
    assert out["params_m"] == round(n / 1e6, 2)
    assert out["input"] == "1x3x448x1024 pair"
    assert out["gflops"] > 50


@pytest.mark.parametrize("cmd", ["train", "test"])
def test_train_and_test_take_raft_only(cmd, tmp_path):
    argv = ["--device", "cpu", cmd, "--config",
            os.path.join(REPO, "configs/flow/pwcnet_slong_flyingchairs.yaml"),
            "--data-root", str(tmp_path)]
    if cmd == "test":
        argv += ["--checkpoint", str(tmp_path / "x.pth")]
    with pytest.raises(ValueError, match="RAFT or GMA"):
        flow_tools.main(argv)
