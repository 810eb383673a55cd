"""Flow evaluation metrics, on the host in numpy as mmflow's.

A copy of ``followyourclick_tpu/flow/metrics.py`` (the port imports nothing
of the JAX package): EPE map and mean EPE over the valid pixels of a list
of results, KITTI's Fl-all (an outlier is EPE > 3 px and EPE / |gt| > 5 %),
and ``eval_metrics`` by name.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np


def end_point_error_map(
    flow_pred: np.ndarray, flow_gt: np.ndarray
) -> np.ndarray:
    """Per-pixel EPE map for ``(H, W, 2)`` flows."""
    return np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=-1))


def end_point_error(
    flow_pred: Sequence[np.ndarray],
    flow_gt: Sequence[np.ndarray],
    valid_gt: Sequence[np.ndarray],
) -> float:
    """Mean EPE over all valid pixels of all samples."""
    assert len(flow_pred) == len(flow_gt)
    epe_list = []
    for pred, gt, valid in zip(flow_pred, flow_gt, valid_gt):
        epe_map = end_point_error_map(pred, gt)
        val = valid.reshape(-1) >= 0.5
        epe_list.append(epe_map.reshape(-1)[val])
    return float(np.mean(np.concatenate(epe_list)))


def optical_flow_outliers(
    flow_pred: Sequence[np.ndarray],
    flow_gt: Sequence[np.ndarray],
    valid_gt: Sequence[np.ndarray],
) -> float:
    """KITTI Fl-all (%): outlier = EPE > 3.0 px AND EPE/|gt| > 0.05
    (thresholds from the KITTI devkit, metrics.py:80-82)."""
    assert len(flow_pred) == len(flow_gt) == len(valid_gt)
    out_list = []
    for pred, gt, valid in zip(flow_pred, flow_gt, valid_gt):
        epe = end_point_error_map(pred, gt).reshape(-1)
        mag = np.sqrt(np.sum(gt**2, axis=-1)).reshape(-1) + 1e-6
        val = valid.reshape(-1) >= 0.5
        out = ((epe > 3.0) & ((epe / mag) > 0.05)).astype(float)
        out_list.append(out[val])
    return float(100 * np.mean(np.concatenate(out_list)))


def eval_metrics(
    results: Sequence[np.ndarray],
    flow_gt: Sequence[np.ndarray],
    valid_gt: Sequence[np.ndarray],
    metrics: Union[Sequence[str], str] = ("EPE",),
) -> Dict[str, float]:
    """Dispatch over metric names ('EPE', 'Fl') like the reference
    eval_metrics (metrics.py:87-130)."""
    if isinstance(metrics, str):
        metrics = [metrics]
    allowed = {"EPE", "Fl"}
    if not set(metrics).issubset(allowed):
        raise KeyError(f"metrics {set(metrics) - allowed} are not supported")
    out: Dict[str, float] = {}
    if "EPE" in metrics:
        out["EPE"] = end_point_error(results, flow_gt, valid_gt)
    if "Fl" in metrics:
        out["Fl"] = optical_flow_outliers(results, flow_gt, valid_gt)
    return out
