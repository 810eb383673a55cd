"""The optical-flow stack of the port: RAFT and GMA, the motion score the
UNet's motion embedding takes (``motion_score`` / ``flow_control``), the
other estimators of the registry (PWC-Net, FlowNetS / C / CSS, FlowNet2,
MaskFlowNet(S), IRR-PWC, LiteFlowNet), the ops, the supervised and
unsupervised losses, metrics, dataset readers and the trainer.

Port of ``followyourclick_tpu/flow`` (the reference's vendored mmflow),
NCHW as mmflow. As in the JAX package no kernel is written here: the
correlation volumes are one batched product (RAFT) or shifted products
(``ops.local_correlation``), the lookups and warps gathers, the rest
stock convolutions.
"""

from followyourclick_tpu_torch.flow.api import (
    compute_motion_score,
    inference_model,
    init_model,
)
from followyourclick_tpu_torch.flow.losses import (
    multi_level_charbonnier_loss,
    multi_level_epe_loss,
    sequence_loss,
)
from followyourclick_tpu_torch.flow.metrics import (
    end_point_error,
    end_point_error_map,
    eval_metrics,
    optical_flow_outliers,
)
from followyourclick_tpu_torch.flow.ops import (
    bilinear_sample,
    coords_grid,
    corr_lookup,
    correlation_pyramid,
    flow_warp,
)
from followyourclick_tpu_torch.flow.flownet import (
    FlowNetC,
    FlowNetConfig,
    FlowNetCSS,
    FlowNetS,
)
from followyourclick_tpu_torch.flow.flownet2 import (
    FlowNet2,
    FlowNet2Config,
    FlowNetSD,
)
from followyourclick_tpu_torch.flow.irrpwc import IRRPWC, IRRPWCConfig
from followyourclick_tpu_torch.flow.liteflownet import (
    LiteFlowNet,
    LiteFlowNetConfig,
    liteflownet_stage_load,
)
from followyourclick_tpu_torch.flow.maskflownet import (
    MaskFlowNet,
    MaskFlowNetS,
    MaskFlowNetSConfig,
)
from followyourclick_tpu_torch.flow.pwcnet import PWCNet, PWCNetConfig
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig
from followyourclick_tpu_torch.flow.registry import (
    FlowEstimator,
    build_flow_estimator,
)
from followyourclick_tpu_torch.flow.unsup_losses import (
    binary_cross_entropy,
    census_loss,
    multi_level_bce,
    smooth_1st_loss,
    smooth_2nd_loss,
)

__all__ = [
    "FlowEstimator",
    "FlowNet2",
    "FlowNet2Config",
    "FlowNetC",
    "FlowNetCSS",
    "FlowNetConfig",
    "FlowNetS",
    "FlowNetSD",
    "IRRPWC",
    "IRRPWCConfig",
    "LiteFlowNet",
    "LiteFlowNetConfig",
    "MaskFlowNet",
    "MaskFlowNetS",
    "MaskFlowNetSConfig",
    "PWCNet",
    "PWCNetConfig",
    "RAFT",
    "RAFTConfig",
    "binary_cross_entropy",
    "build_flow_estimator",
    "census_loss",
    "bilinear_sample",
    "compute_motion_score",
    "coords_grid",
    "corr_lookup",
    "correlation_pyramid",
    "end_point_error",
    "end_point_error_map",
    "eval_metrics",
    "flow_warp",
    "inference_model",
    "init_model",
    "liteflownet_stage_load",
    "multi_level_bce",
    "multi_level_charbonnier_loss",
    "multi_level_epe_loss",
    "optical_flow_outliers",
    "sequence_loss",
    "smooth_1st_loss",
    "smooth_2nd_loss",
]
