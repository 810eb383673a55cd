"""The optical-flow stack of the port: RAFT and GMA, the motion score the
UNet's motion embedding takes (``motion_score`` / ``flow_control``), the
ops, losses, metrics, dataset readers and the trainer.

Port of ``followyourclick_tpu/flow`` (the reference's vendored mmflow),
NCHW as mmflow. As in the JAX package no kernel is written here: the
correlation volume is one batched product and its lookup a gather.
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
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig

__all__ = [
    "RAFT",
    "RAFTConfig",
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
    "multi_level_charbonnier_loss",
    "multi_level_epe_loss",
    "optical_flow_outliers",
    "sequence_loss",
]
