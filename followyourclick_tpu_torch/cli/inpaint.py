"""Inpaint-Anything CLI: click → remove / fill / replace.

Port of ``followyourclick_tpu/cli/inpaint.py`` with the same subcommands
and flags (``--input_img --point_coords --point_labels --output_dir
--sam_model_type --sam_ckpt --seed``; ``remove`` adds
``--dilate_kernel_size --lama_ckpt``; ``fill`` and ``replace`` add
``--text_prompt --sd_model_path --steps``, ``fill``
``--dilate_kernel_size``, ``replace`` ``--target_size``), plus ``--device``
(the card unless told otherwise).

``remove`` runs big-LaMa (``inpaint/lama.py``): the generator of
``--lama_ckpt`` (a Lightning ``best.ckpt`` or a bare state dict, loaded
strictly by ``inpaint/convert.py``), or seeded random weights without it.
With ``--sd_model_path`` the SD-1.5 directory loads through
``utils/loaders`` into the motion-free UNet, the VAE and the CLIP text
tower (fp32, then bf16 on the card), with the port's CLIP tokenizer over
``tokenizer/merges.txt``. Without it a tiny SD pipeline with seeded random
weights and a hash tokenizer stand-in run (plumbing only; the outputs are
noise). Images are read and written by PIL:
``<output_dir>/<image stem>/mask_<i>.png`` and
``{inpainted,filled,replaced}_with_mask_<i>.png``.

    python -m followyourclick_tpu_torch.cli.inpaint remove --input_img in.png \
        --point_coords 200 300 --output_dir out --sam_ckpt sam_vit_h.pth \
        --lama_ckpt big-lama/models/best.ckpt
"""

from __future__ import annotations

import argparse
import types
import zlib
from pathlib import Path

import numpy as np

from followyourclick_tpu_torch.cli.click_mask import (
    build_predictor,
    read_rgb,
    write_gray,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input_img", type=str, required=True)
    p.add_argument("--point_coords", type=float, nargs="+", required=True,
                   help="x y of the click (w h order, like the reference)")
    p.add_argument("--point_labels", type=int, nargs="+", default=[1])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--sam_model_type", type=str, default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b", "vit_t"])
    p.add_argument("--sam_ckpt", type=str, default=None,
                   help="official SAM .pth checkpoint (loaded as it is)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("followyourclick-inpaint")
    sub = p.add_subparsers(dest="command", required=True)

    rm = sub.add_parser("remove", help="click → SAM mask → LaMa removal")
    _add_common(rm)
    rm.add_argument("--dilate_kernel_size", type=int, default=15)
    rm.add_argument("--lama_ckpt", type=str, default=None,
                    help="big-lama torch checkpoint")

    fl = sub.add_parser("fill", help="click → SAM mask → SD-inpaint fill")
    _add_common(fl)
    fl.add_argument("--dilate_kernel_size", type=int, default=15)
    fl.add_argument("--text_prompt", type=str, required=True)
    fl.add_argument("--sd_model_path", type=str, default=None,
                    help="HF SD directory for the inpaint pipeline")
    fl.add_argument("--steps", type=int, default=25)

    rp = sub.add_parser(
        "replace", help="click → SAM mask → SD background replacement")
    _add_common(rp)
    rp.add_argument("--text_prompt", type=str, required=True)
    rp.add_argument("--sd_model_path", type=str, default=None)
    rp.add_argument("--steps", type=int, default=25)
    rp.add_argument("--target_size", type=int, default=512,
                    help="pad-to-square size for the repaint pass "
                         "(reference resize_and_pad uses 512)")
    return p


class HashTokenizer:
    """Token ids for runs without an SD directory (plumbing only): 77 ids
    in [0, 1000) from a ``RandomState`` seeded by the text's CRC-32, the
    same in every process."""

    model_max_length = 77

    def __call__(self, texts, padding=None, max_length=None,
                 truncation=False, return_tensors="np"):
        ids = np.zeros((len(texts), 77), dtype=np.int64)
        for i, t in enumerate(texts):
            rs = np.random.RandomState(zlib.crc32(t.encode()) % (2 ** 31))
            ids[i] = rs.randint(0, 1000, size=77)
        return types.SimpleNamespace(input_ids=ids)


def tiny_inference_config():
    """The tiny SD configuration of runs without ``--sd_model_path``."""
    from followyourclick_tpu_torch.config import (
        CLIPTextConfig,
        InferenceConfig,
        MotionModuleConfig,
        UNet3DConfig,
        VAEConfig,
    )

    return InferenceConfig(
        unet=UNet3DConfig(
            cross_attention_dim=64, attention_head_dim=4,
            block_out_channels=(32, 32, 32, 32), layers_per_block=1,
            norm_num_groups=8,
            motion_module=MotionModuleConfig(num_attention_heads=4)),
        vae=VAEConfig(block_out_channels=(32, 32, 32, 32),
                      layers_per_block=1, norm_num_groups=8),
        clip_text=CLIPTextConfig(vocab_size=1000, hidden_size=64,
                                 intermediate_size=128, num_hidden_layers=2,
                                 num_attention_heads=4))


def build_sd_pipeline(args, inference_config=None):
    """The inpaint pipeline the flags ask for, on ``args.device``:
    ``inference_config`` (default: ``InferenceConfig()``) with the SD-1.5
    directory's weights, or the tiny seeded one."""
    import os

    import torch

    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.pipelines.inpaint import (
        InpaintPipeline,
        inpaint_unet_config,
    )
    from followyourclick_tpu_torch.utils import loaders
    from followyourclick_tpu_torch.utils.convert import (
        convert_clip_text_state_dict,
        convert_vae_state_dict,
        load_jax_params,
    )
    from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

    device = torch.device(args.device)
    if args.sd_model_path:
        cfg = inference_config or InferenceConfig()
    else:
        cfg = tiny_inference_config()
    with torch.device(device):
        unet = UNet3DConditionModel(inpaint_unet_config(cfg))
        vae = AutoencoderKL(cfg.vae)
        text = CLIPTextModel(cfg.clip_text)
    if args.sd_model_path:
        path = args.sd_model_path
        loaders.load_unet3d_params(unet,
                                   loaders.load_hf_subfolder(path, "unet"))
        load_jax_params(vae, convert_vae_state_dict(
            loaders.load_hf_subfolder(path, "vae")))
        load_jax_params(text, convert_clip_text_state_dict(
            loaders.load_hf_subfolder(path, "text_encoder")))
        from followyourclick_tpu_torch.utils.native_tokenizer import (
            NativeCLIPTokenizer,
        )

        tokenizer = NativeCLIPTokenizer(
            os.path.join(path, "tokenizer", "merges.txt"))
    else:
        generator = torch.Generator(device=device).manual_seed(args.seed)
        for module in (unet, vae, text):
            seeded_init_(module, generator)
        tokenizer = HashTokenizer()
    dtype = loaders.default_dtype(device)
    modules = [m.to(dtype).eval() for m in (unet, vae, text)]
    return InpaintPipeline(cfg, *modules, tokenizer=tokenizer,
                           device=device)


def build_lama(args, lama_config=None):
    """The LaMa inpainter the flags ask for, on ``args.device``:
    ``lama_config`` (default: big-LaMa, ``LamaConfig()``) with the weights
    of ``--lama_ckpt``, or seeded from ``--seed``."""
    from followyourclick_tpu_torch.inpaint.convert import load_lama_checkpoint
    from followyourclick_tpu_torch.inpaint.lama import (
        LamaConfig,
        LamaInpainter,
        build_generator,
    )

    cfg = lama_config or LamaConfig()
    if args.lama_ckpt:
        state = load_lama_checkpoint(args.lama_ckpt)
        return LamaInpainter(build_generator(cfg, args.device,
                                             state_dict=state), args.device)
    return LamaInpainter.init_random(cfg, seed=args.seed, device=args.device)


def write_rgb(path, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(str(path))


@checked_precision()
def main(argv=None, inference_config=None, lama_config=None) -> dict:
    """Runs the CLI; returns the output directory, the files written and
    the masks' scores. ``inference_config`` replaces ``InferenceConfig()``
    for an SD directory of other widths, ``lama_config`` ``LamaConfig()``
    for a LaMa checkpoint of other widths."""
    args = build_parser().parse_args(argv)

    from followyourclick_tpu_torch.inpaint.fill import (
        fill_anything,
        replace_anything,
    )
    from followyourclick_tpu_torch.inpaint.remove import remove_anything

    img = read_rgb(args.input_img)
    point_wh = (args.point_coords[0], args.point_coords[1])
    out_dir = Path(args.output_dir) / Path(args.input_img).stem
    out_dir.mkdir(parents=True, exist_ok=True)
    predictor = build_predictor(args)
    if args.command == "remove":
        results = remove_anything(
            img, point_wh, predictor, build_lama(args, lama_config),
            dilate_kernel_size=args.dilate_kernel_size)
        key, prefix = "inpainted", "inpainted_with_mask"
    elif args.command == "fill":
        results = fill_anything(
            img, point_wh, args.text_prompt, predictor,
            build_sd_pipeline(args, inference_config),
            dilate_kernel_size=args.dilate_kernel_size, seed=args.seed,
            steps=args.steps)
        key, prefix = "filled", "filled_with_mask"
    else:
        results = replace_anything(
            img, point_wh, args.text_prompt, predictor,
            build_sd_pipeline(args, inference_config),
            seed=args.seed, steps=args.steps, target_size=args.target_size)
        key, prefix = "replaced", "replaced_with_mask"
    files = []
    for i, r in enumerate(results):
        write_gray(out_dir / f"mask_{i}.png", r["mask"])
        write_rgb(out_dir / f"{prefix}_{i}.png", r[key])
        files += [f"mask_{i}.png", f"{prefix}_{i}.png"]
        print(f"mask_{i}.png  iou={r['score']:.4f}")
    print(f"saved {len(results)} results to {out_dir}")
    return {"out_dir": str(out_dir), "files": files,
            "scores": [r["score"] for r in results]}


if __name__ == "__main__":
    main()
