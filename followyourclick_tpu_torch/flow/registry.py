"""Config-driven estimator construction (mmflow's registry / builder):
``build_flow_estimator({"type": "RAFT", ...})`` as the ``model:`` section of
``configs/flow/*.yaml`` reads.

Port of ``followyourclick_tpu/flow/registry.py`` with the estimators the
port has: RAFT and GMA. Any other name raises the JAX ``KeyError`` listing
what is registered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from followyourclick_tpu_torch.flow.raft import RAFTConfig

FLOW_ESTIMATORS: Dict[str, Callable[..., Any]] = {}


def register_flow_estimator(name: str):
    def deco(fn):
        FLOW_ESTIMATORS[name] = fn
        return fn

    return deco


def _raft_config(cfg: Dict[str, Any], **extra) -> RAFTConfig:
    decoder = cfg.get("decoder", {})
    return RAFTConfig(num_levels=cfg.get("num_levels", 4),
                      radius=cfg.get("radius", 4),
                      h_channels=cfg.get("h_channels", 128),
                      cxt_channels=cfg.get("cxt_channels", 128),
                      iters=decoder.get("iters", 12), **extra)


@register_flow_estimator("RAFT")
def _build_raft(cfg: Dict[str, Any]) -> RAFTConfig:
    return _raft_config(cfg)


@register_flow_estimator("GMA")
def _build_gma(cfg: Dict[str, Any]) -> RAFTConfig:
    """GMA: RAFT with the global-motion-aggregation decoder."""
    return _raft_config(cfg, use_gma=True,
                        gma_heads=cfg.get("decoder", {}).get("heads", 1))


def build_flow_estimator(cfg: Dict[str, Any], checkpoint=None,
                         seed: int = 0, device="cuda"):
    """mmflow ``build_flow_estimator``: the module for ``cfg["type"]``,
    weights as ``flow.api.init_model`` gives them."""
    from followyourclick_tpu_torch.flow.api import init_model

    kind = cfg.get("type")
    if kind not in FLOW_ESTIMATORS:
        raise KeyError(
            f"unknown flow estimator {kind!r}; registered: "
            f"{sorted(FLOW_ESTIMATORS)}")
    return init_model(FLOW_ESTIMATORS[kind](cfg), checkpoint, seed, device)
