"""Click → mask CLI: point at an image, get the candidate masks.

Port of ``followyourclick_tpu/cli/click_mask.py`` (the reference's
``sam_segment.py`` flags: ``--input_img --point_coords --point_labels
--dilate_kernel_size --output_dir --sam_model_type --sam_ckpt``), plus
``--device`` (the card unless told otherwise). An official SAM ``.pth``
loads as it is; without ``--sam_ckpt`` the model takes seeded random
weights (``--seed``, drawn on the device). The image is read and the masks
(``<output_dir>/<image stem>/mask_<i>.png``, 8-bit {0, 255}) written by
PIL.

    python -m followyourclick_tpu_torch.cli.click_mask --input_img in.png \
        --point_coords 200 300 --output_dir out --sam_ckpt sam_vit_h.pth
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from followyourclick_tpu_torch.utils.backend_flags import checked_precision


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("followyourclick-click-mask")
    p.add_argument("--input_img", type=str, required=True)
    p.add_argument("--point_coords", type=float, nargs="+", required=True,
                   help="x y of the click (w h order, like the reference)")
    p.add_argument("--point_labels", type=int, nargs="+", default=[1])
    p.add_argument("--dilate_kernel_size", type=int, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--sam_model_type", type=str, default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b", "vit_t"])
    p.add_argument("--sam_ckpt", type=str, default=None,
                   help="official SAM .pth checkpoint (loaded as it is)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def write_gray(path, array: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(array, np.uint8)).save(str(path))


def build_predictor(args):
    """The SAM predictor the flags ask for, on ``args.device``."""
    import torch

    from followyourclick_tpu_torch.sam import SamPredictor, sam_model_registry
    from followyourclick_tpu_torch.sam.convert import sam_from_checkpoint

    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    model = sam_from_checkpoint(sam_model_registry[args.sam_model_type],
                                args.sam_ckpt, args.device, generator)
    return SamPredictor(model, args.device)


@checked_precision()
def main(argv=None) -> dict:
    """Runs the CLI; returns the output directory, the mask file names and
    the scores."""
    args = build_parser().parse_args(argv)

    from followyourclick_tpu_torch.masking.brush import dilate_mask
    from followyourclick_tpu_torch.masking.click import predict_masks_with_sam

    predictor = build_predictor(args)
    img = read_rgb(args.input_img)
    coords = np.asarray(args.point_coords, np.float32).reshape(-1, 2)
    labels = np.asarray(args.point_labels, np.int32)
    masks, scores, _ = predict_masks_with_sam(img, coords, labels, predictor)
    masks = masks.astype(np.uint8) * 255
    if args.dilate_kernel_size is not None:
        masks = [dilate_mask(m, args.dilate_kernel_size) for m in masks]

    out_dir = Path(args.output_dir) / Path(args.input_img).stem
    out_dir.mkdir(parents=True, exist_ok=True)
    files = []
    for idx, mask in enumerate(masks):
        files.append(f"mask_{idx}.png")
        write_gray(out_dir / files[-1], mask)
        print(f"mask_{idx}.png  iou={float(scores[idx]):.4f}")
    print(f"saved {len(masks)} masks to {out_dir}")
    return {"out_dir": str(out_dir), "files": files,
            "scores": [float(s) for s in scores]}


if __name__ == "__main__":
    main()
