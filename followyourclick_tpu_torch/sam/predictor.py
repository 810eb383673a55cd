"""SamPredictor: click → mask against a cached image embedding.

Port of ``followyourclick_tpu/sam/predictor.py``. ``set_image`` resizes the
image so its longest side is ``img_size`` (``ResizeLongestSide``: OpenCV's
uint8 bilinear bit for bit, ``utils/image_ops.resize_linear``), runs the
ViT once and keeps the embedding on the device; every ``predict`` runs only
the prompt encoder and the mask decoder on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from followyourclick_tpu_torch.sam.sam import (
    MASK_THRESHOLD,
    Sam,
    postprocess_masks,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.image_ops import resize_linear


class ResizeLongestSide:
    """Resize so the longest side equals ``target_length``."""

    def __init__(self, target_length: int):
        self.target_length = target_length

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int,
                             long_side_length: int) -> Tuple[int, int]:
        scale = long_side_length * 1.0 / max(oldh, oldw)
        newh, neww = oldh * scale, oldw * scale
        return (int(newh + 0.5), int(neww + 0.5))

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """``cv2.resize(image, (w, h), INTER_LINEAR)`` bit for bit."""
        target = self.get_preprocess_shape(image.shape[0], image.shape[1],
                                           self.target_length)
        return resize_linear(image, (target[1], target[0]))

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, int]) -> np.ndarray:
        old_h, old_w = original_size
        new_h, new_w = self.get_preprocess_shape(old_h, old_w,
                                                 self.target_length)
        coords = np.asarray(coords, dtype=np.float32).copy()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords

    def apply_boxes(self, boxes: np.ndarray,
                    original_size: Tuple[int, int]) -> np.ndarray:
        return self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2),
                                 original_size).reshape(-1, 4)


class SamPredictor:
    """``model`` moves to ``device`` (the card unless the caller says
    otherwise)."""

    def __init__(self, model: Sam, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.transform = ResizeLongestSide(model.config.img_size)
        self.reset_image()

    def reset_image(self) -> None:
        self.is_image_set = False
        self.features = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    @torch.inference_mode()
    @checked_precision()
    def set_image(self, image: np.ndarray) -> None:
        """image: (H, W, 3) RGB uint8. Runs the ViT once and keeps the
        embedding (1, 256, 64, 64) on the device."""
        assert image.ndim == 3 and image.shape[2] == 3
        self.original_size = tuple(image.shape[:2])
        resized = self.transform.apply_image(image)
        self.input_size = tuple(resized.shape[:2])
        x = torch.from_numpy(np.ascontiguousarray(resized)).to(self.device)
        x = x.permute(2, 0, 1)[None].to(self.dtype)
        self.features = self.model.encode_image(self.model.preprocess(x))
        self.is_image_set = True

    @torch.inference_mode()
    @checked_precision()
    def predict_torch(self, coords: Optional[np.ndarray],
                      labels: Optional[np.ndarray],
                      boxes: Optional[np.ndarray] = None,
                      mask_input: Optional[np.ndarray] = None,
                      multimask_output: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched prompts in original-image pixels (coords (B, N, 2),
        labels (B, N), boxes (B, 4), mask_input (B, 256, 256)) → on the
        device: (logits (B, K, H, W), IoU (B, K), low-res logits)."""
        assert self.is_image_set, "set_image must be called first"
        dev, dt = self.device, self.dtype
        c = lb = b = m = None
        if coords is not None:
            c = torch.from_numpy(self.transform.apply_coords(
                coords, self.original_size)).to(dev, dt)
            lb = torch.from_numpy(np.asarray(labels, np.int32)).to(dev)
        if boxes is not None:
            b = torch.from_numpy(self.transform.apply_boxes(
                boxes, self.original_size)).to(dev, dt)
        if mask_input is not None:
            m = torch.from_numpy(np.asarray(mask_input, np.float32)
                                 )[:, None].to(dev, dt)
        low_res, iou = self.model.predict_from_embedding(
            self.features, c, lb, b, m, multimask_output)
        masks = postprocess_masks(low_res, self.input_size,
                                  self.original_size,
                                  self.model.config.img_size)
        return masks, iou, low_res

    @checked_precision()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One prompt → (masks (K, H, W) bool, IoU (K,), low-res logits
        (K, 256, 256)), as numpy."""
        coords = labels = None
        if point_coords is not None:
            assert point_labels is not None
            coords = np.asarray(point_coords, np.float32)[None]
            labels = np.asarray(point_labels)[None]
        boxes = None if box is None else np.asarray(box).reshape(1, 4)
        mi = None if mask_input is None else np.asarray(mask_input)[None]
        masks, iou, low_res = self.predict_torch(coords, labels, boxes, mi,
                                                 multimask_output)
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        return (masks[0].cpu().numpy(), iou[0].float().cpu().numpy(),
                low_res[0].float().cpu().numpy())

    @checked_precision()
    def predict_batch(self, point_coords: np.ndarray,
                      point_labels: np.ndarray, multimask_output: bool = True,
                      return_logits: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Many independent point prompts ((B, N, 2), (B, N)) in one decoder
        call → (masks (B, K, H, W), IoU (B, K)), as numpy."""
        masks, iou, _ = self.predict_torch(point_coords, point_labels,
                                           multimask_output=multimask_output)
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        return masks.cpu().numpy(), iou.float().cpu().numpy()

    def get_image_embedding(self) -> torch.Tensor:
        assert self.is_image_set
        return self.features
