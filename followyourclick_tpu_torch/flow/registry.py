"""Config-driven estimator construction (mmflow's registry / builder):
``build_flow_estimator({"type": "PWCNet", ...})`` as the ``model:`` section
of ``configs/flow/*.yaml`` reads.

Port of ``followyourclick_tpu/flow/registry.py``: the same eleven names, each
build function reading exactly the keys the JAX one reads (FlowNetCSS and
FlowNet2 read ``flow_div`` at the top level, FlowNetCSS keeps its second
FlowNetS stage unless ``flownetS2`` is given as None). Each gives a
:class:`FlowEstimator`, the module class and its config, so
``flow.api.init_model`` builds any of them; any other name raises the JAX
``KeyError`` listing what is registered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from torch import nn

from followyourclick_tpu_torch.flow.flownet import FlowNetC, FlowNetConfig, \
    FlowNetCSS, FlowNetS
from followyourclick_tpu_torch.flow.flownet2 import FlowNet2, FlowNet2Config
from followyourclick_tpu_torch.flow.irrpwc import IRRPWC, IRRPWCConfig
from followyourclick_tpu_torch.flow.liteflownet import LiteFlowNet, \
    LiteFlowNetConfig
from followyourclick_tpu_torch.flow.maskflownet import MaskFlowNet, \
    MaskFlowNetS, MaskFlowNetSConfig
from followyourclick_tpu_torch.flow.pwcnet import PWCNet, PWCNetConfig
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig


@dataclasses.dataclass(frozen=True)
class FlowEstimator:
    """A registered estimator: its module class, its config and any other
    constructor arguments (FlowNetCSS's ``two_s_stages``)."""

    cls: type
    config: Any
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def build(self) -> nn.Module:
        return self.cls(self.config, **dict(self.kwargs))


FLOW_ESTIMATORS: Dict[str, Callable[[Dict[str, Any]], FlowEstimator]] = {}


def register_flow_estimator(name: str):
    def deco(fn):
        FLOW_ESTIMATORS[name] = fn
        return fn

    return deco


def _raft_config(cfg: Dict[str, Any], **extra) -> FlowEstimator:
    decoder = cfg.get("decoder", {})
    return FlowEstimator(RAFT, RAFTConfig(
        num_levels=cfg.get("num_levels", 4), radius=cfg.get("radius", 4),
        h_channels=cfg.get("h_channels", 128),
        cxt_channels=cfg.get("cxt_channels", 128),
        iters=decoder.get("iters", 12), **extra))


@register_flow_estimator("RAFT")
def _build_raft(cfg: Dict[str, Any]) -> FlowEstimator:
    return _raft_config(cfg)


@register_flow_estimator("GMA")
def _build_gma(cfg: Dict[str, Any]) -> FlowEstimator:
    """GMA: RAFT with the global-motion-aggregation decoder."""
    return _raft_config(cfg, use_gma=True,
                        gma_heads=cfg.get("decoder", {}).get("heads", 1))


PYRAMID = (16, 32, 64, 96, 128, 196)


@register_flow_estimator("PWCNet")
def _build_pwcnet(cfg: Dict[str, Any]) -> FlowEstimator:
    dec = cfg.get("decoder", {})
    return FlowEstimator(PWCNet, PWCNetConfig(
        pyramid_channels=tuple(cfg.get("encoder", {}).get("out_channels",
                                                          PYRAMID)),
        max_displacement=dec.get("corr_cfg", {}).get("max_displacement", 4),
        flow_div=dec.get("flow_div", 20.0)))


@register_flow_estimator("FlowNetS")
def _build_flownets(cfg: Dict[str, Any]) -> FlowEstimator:
    return FlowEstimator(FlowNetS, FlowNetConfig(
        flow_div=cfg.get("decoder", {}).get("flow_div", 20.0)))


@register_flow_estimator("FlowNetC")
def _build_flownetc(cfg: Dict[str, Any]) -> FlowEstimator:
    return FlowEstimator(FlowNetC, FlowNetConfig(
        flow_div=cfg.get("decoder", {}).get("flow_div", 20.0)))


@register_flow_estimator("FlowNetCSS")
def _build_flownetcss(cfg: Dict[str, Any]) -> FlowEstimator:
    return FlowEstimator(
        FlowNetCSS, FlowNetConfig(flow_div=cfg.get("flow_div", 20.0)),
        (("two_s_stages", cfg.get("flownetS2", True) is not None),))


@register_flow_estimator("MaskFlowNetS")
def _build_maskflownets(cfg: Dict[str, Any]) -> FlowEstimator:
    dec = cfg.get("decoder", {})
    return FlowEstimator(MaskFlowNetS, MaskFlowNetSConfig(
        pyramid_channels=tuple(cfg.get("encoder", {}).get("out_channels",
                                                          PYRAMID)),
        max_displacement=dec.get("corr_cfg", {}).get("max_displacement", 4),
        flow_div=dec.get("flow_div", 20.0)))


@register_flow_estimator("IRRPWC")
def _build_irrpwc(cfg: Dict[str, Any]) -> FlowEstimator:
    dec = cfg.get("decoder", {})
    return FlowEstimator(IRRPWC, IRRPWCConfig(
        corr_feat_channels=dec.get("corr_feat_channels", 32),
        flow_div=dec.get("flow_div", 20.0)))


@register_flow_estimator("LiteFlowNet")
def _build_liteflownet(cfg: Dict[str, Any]) -> FlowEstimator:
    dec = cfg.get("decoder", {})
    return FlowEstimator(LiteFlowNet, LiteFlowNetConfig(
        flow_div=dec.get("flow_div", 20.0),
        regularized_flow=dec.get("regularized_flow", True)))


@register_flow_estimator("FlowNet2")
def _build_flownet2(cfg: Dict[str, Any]) -> FlowEstimator:
    return FlowEstimator(FlowNet2,
                         FlowNet2Config(flow_div=cfg.get("flow_div", 20.0)))


@register_flow_estimator("MaskFlowNet")
def _build_maskflownet(cfg: Dict[str, Any]) -> FlowEstimator:
    return FlowEstimator(MaskFlowNet, MaskFlowNetSConfig(
        flow_div=cfg.get("decoder", {}).get("flow_div", 20.0)))


def flow_estimator(cfg: Dict[str, Any]) -> FlowEstimator:
    """The registered entry for ``cfg["type"]``."""
    kind = cfg.get("type")
    if kind not in FLOW_ESTIMATORS:
        raise KeyError(
            f"unknown flow estimator {kind!r}; registered: "
            f"{sorted(FLOW_ESTIMATORS)}")
    return FLOW_ESTIMATORS[kind](cfg)


def build_flow_estimator(cfg: Dict[str, Any], checkpoint=None,
                         seed: int = 0, device="cuda") -> nn.Module:
    """mmflow ``build_flow_estimator``: the module for ``cfg["type"]``,
    weights as ``flow.api.init_model`` gives them."""
    from followyourclick_tpu_torch.flow.api import init_model

    return init_model(flow_estimator(cfg), checkpoint, seed, device)
