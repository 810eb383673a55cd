"""Interactive click → mask → remove app (optional; needs gradio).

Port of ``followyourclick_tpu/cli/app.py`` (the reference's
``Inpaint-Anything/app.py``). The three handlers live in
:class:`ClickSession`, which runs without gradio: ``upload`` encodes the
image once (``SamPredictor.set_image``), ``click`` gives the three dilated
candidate masks as red overlays, ``remove`` LaMa-fills each mask.
:func:`build_app` wires a session into gradio's widgets; gradio is imported
there, and only there. The headless equivalents are ``cli.click_mask`` and
``cli.inpaint remove``.

    python -m followyourclick_tpu_torch.cli.app --sam_ckpt sam_vit_h.pth \\
        --lama_ckpt big-lama/models/best.ckpt
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from followyourclick_tpu_torch.masking.brush import dilate_mask
from followyourclick_tpu_torch.utils.backend_flags import checked_precision


class ClickSession:
    """One image's state between the app's events."""

    def __init__(self, predictor, inpainter, dilate_kernel_size: int = 15):
        self.predictor = predictor
        self.inpainter = inpainter
        self.dilate_kernel_size = dilate_kernel_size
        self.image: Optional[np.ndarray] = None
        self.masks: List[np.ndarray] = []

    def upload(self, img: np.ndarray) -> str:
        """Keep the (H, W, 3) uint8 RGB image and encode it, once."""
        self.image = img
        self.masks = []
        self.predictor.set_image(img)
        return "features cached — click a point"

    def click(self, w: float, h: float) -> List[np.ndarray]:
        """The click's three candidate masks, dilated, on the features
        ``upload`` cached (the masks of ``masking.click.
        predict_masks_with_sam``, which would encode the image again);
        returns the image with each mask in red (``0.5·pixel + [127, 0,
        0]``, truncated)."""
        masks, _, _ = self.predictor.predict(
            point_coords=np.array([[w, h]], np.float32),
            point_labels=np.array([1], np.int32), multimask_output=True)
        self.masks = [dilate_mask(m.astype(np.uint8) * 255,
                                  self.dilate_kernel_size) for m in masks]
        overlays = []
        for m in self.masks:
            o = self.image.copy()
            o[m > 0] = (0.5 * o[m > 0] + [127, 0, 0]).astype(np.uint8)
            overlays.append(o)
        return overlays

    def remove(self) -> List[np.ndarray]:
        """The image with each candidate mask's region filled by LaMa."""
        return [self.inpainter(self.image, m) for m in self.masks]


def build_app(predictor, inpainter, dilate_kernel_size: int = 15):
    """A gradio ``Blocks`` app over one :class:`ClickSession`."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "build_app needs gradio, which is not installed; the headless "
            "path is ClickSession, cli.click_mask or cli.inpaint remove"
        ) from e

    session = ClickSession(predictor, inpainter, dilate_kernel_size)

    def on_click(evt):
        return session.click(*evt.index)

    # gradio passes the click's event to a parameter annotated so
    on_click.__annotations__["evt"] = gr.SelectData

    with gr.Blocks() as demo:
        img_in = gr.Image(label="input")
        status = gr.Textbox()
        gallery = gr.Gallery(label="candidate masks")
        removed = gr.Gallery(label="removed")
        btn = gr.Button("remove")
        img_in.upload(session.upload, img_in, status)
        img_in.select(on_click, None, gallery)
        btn.click(session.remove, None, removed)
    return demo


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("followyourclick-app")
    p.add_argument("--sam_ckpt", type=str, required=True)
    p.add_argument("--sam_model_type", type=str, default="vit_h")
    p.add_argument("--lama_ckpt", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


@checked_precision()
def main(argv=None):
    args = build_parser().parse_args(argv)

    from followyourclick_tpu_torch.cli.click_mask import build_predictor
    from followyourclick_tpu_torch.cli.inpaint import build_lama

    build_app(build_predictor(args), build_lama(args)).launch()


if __name__ == "__main__":
    main()
