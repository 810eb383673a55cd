"""Click-to-video inference CLI: first image + click mask + motion prompt →
GIF, from checkpoint files.

Port of ``followyourclick_tpu/cli/inference.py`` (the reference's
``scripts/inference.py``): the same flags, txt / csv / xlsx manifests,
prompt suffixes, per-model prompt YAML, seeds, file names and
``config_snapshot.yaml``, plus ``--device`` (``cuda`` by default; ``cpu``
runs the plain versions of the kernels)::

    python -m followyourclick_tpu_torch.cli.inference \
        --pretrained_model_path stable-diffusion-v1-5 \
        --inference_config configs/inference/inference.yaml \
        --config configs/prompts/example.yaml --file prompts.txt \
        --output_path outputs

:func:`main` reads the files (the inference config and prompt YAML, which
need PyYAML, and the manifest) and hands them to :func:`run`, which does the
rest: assembly (``utils/loaders.py``), the first frame by the T2I pipeline
for a row without an image (50 steps, CFG 8), the VAE encode, the click
mask at latent size, ``AnimationPipeline.__call__`` and the GIFs. A
multi-process launch (one process a card) splits the manifest by rank
(``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import csv
import datetime
import json
import os
import time
from typing import List, Optional

from followyourclick_tpu_torch.utils.backend_flags import checked_precision

POS_PROMPT = (", ultra quality, film grain, 8K UHD, masterpiece,  high "
              "detailed, extremely detailed, photorealistic, dramatic and "
              "cinematic lighting")
NEG_PROMPT = ("low resolution, low quality, lowres, worst quality,  noisy, "
              "duplicate, repeat, double, ugly, obese, deformed, render, "
              "rendered, bad anatomy,  text, watermark, bad anatomy, bad "
              "hands, text, missing finger,extra fingers")


def _cell(v):
    """A manifest cell: None for an empty or missing value."""
    if v is None:
        return None
    if isinstance(v, float) and v != v:  # NaN
        return None
    s = str(v)
    return None if s == "" or s == "nan" else v


def load_prompt_manifest(path: str) -> List[dict]:
    """A txt manifest (one prompt a line) or a csv / xlsx one (columns
    ``prompt``, ``image`` and optionally ``mask``) → the work items. A row
    whose image file does not exist is dropped; a row without a mask looks
    for ``<image dir>_mask/<image name>``. csv is read with the standard
    library, xlsx with pandas (and openpyxl). A row with an empty image
    cell is a row without an image (the JAX package, reading csv through
    pandas, drops it: the empty cell is NaN)."""
    items = []
    if path.endswith((".xlsx", ".xls", ".csv")):
        if path.endswith(".csv"):
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
        else:
            import pandas as pd

            try:
                df = pd.read_excel(path)
            except ImportError as e:
                raise ImportError(
                    f"reading {path} needs openpyxl; convert the manifest to "
                    f".csv with the same columns (prompt,image[,mask])") from e
            rows = [dict(row) for _, row in df.iterrows()]
        for i, row in enumerate(rows):
            image = _cell(row.get("image"))
            if image and not os.path.exists(str(image)):
                continue
            mask = _cell(row.get("mask"))
            if mask is None and image:
                p = str(image)
                stem, ext = os.path.splitext(os.path.basename(p))
                cand = os.path.join(os.path.dirname(p) + "_mask", stem + ext)
                mask = cand if os.path.exists(cand) else None
            items.append({"prompt": str(row["prompt"]), "idx": i,
                          "image": image, "mask": mask})
    else:
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip("\n")
                if line:
                    items.append({"prompt": line, "idx": i,
                                  "image": None, "mask": None})
    return items


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Follow-Your-Click inference (PyTorch port)")
    p.add_argument("--output_path", type=str, default="output_path")
    p.add_argument("--pretrained_model_path", type=str,
                   default="stable-diffusion-v1-5")
    p.add_argument("--image_pretrained_model_path", type=str, default="")
    p.add_argument("--inference_config", type=str,
                   default="configs/inference/inference.yaml")
    p.add_argument("--config", type=str, required=True,
                   help="per-model prompt yaml")
    p.add_argument("--file", type=str, required=True,
                   help="txt, csv or xlsx prompt manifest")
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--video_scale", type=float, default=0.0)
    p.add_argument("--use_fps_condition", action="store_true", default=False)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--flw_ctrl", type=int, default=4,
                   help="motion score (optical-flow magnitude) conditioning")
    p.add_argument("--use_ip", type=str, default="",
                   choices=["", "raw", "vanilla", "plus"])
    p.add_argument("--ip_ckpt", type=str, default="",
                   help="released ip-adapter ckpt ({'image_proj', "
                        "'ip_adapter'}); normally the ip weights ride in "
                        "the motion module ckpt")
    p.add_argument("--manually_input_image", action="store_true",
                   default=False)
    p.add_argument("--crop_method", type=str,
                   choices=["resize_and_crop", "crop"], default="crop")
    p.add_argument("--use_first_image_as_init_latents", action="store_true",
                   default=False)
    p.add_argument("--mask_first_frame", action="store_true", default=False)
    p.add_argument("--use_interpolate_noise", action="store_true",
                   default=False)
    p.add_argument("--dtype", type=str, default="auto",
                   choices=["auto", "bfloat16", "float32"])
    p.add_argument("--camera_motion_lora", type=str, default="",
                   help="motion-module LoRA ckpt merged at load")
    p.add_argument("--camera_motion_lora_alpha", type=float, default=1.0)
    # opt-in serving approximations (not reference behaviour; 1 = exact)
    p.add_argument("--cfg_cache_interval", type=int, default=1,
                   help="recompute the CFG uncond branch every k-th step")
    p.add_argument("--pab_interval", type=int, default=1,
                   help="PAB-style attention reuse: refresh attention "
                        "outputs every k-th step (composes with "
                        "--cfg_cache_interval)")
    p.add_argument("--pab_warmup_steps", type=int, default=0,
                   help="exact full-compute steps before PAB reuse starts")
    p.add_argument("--serving_schedule", type=str, default="",
                   help="named composed schedule from pipelines/"
                        "serving_schedules.py (e.g. pab488_deep4_cfg4_ex); "
                        "applied on top of the individual interval flags")
    p.add_argument("--scheduler", type=str, default="ddim",
                   help="solver of the denoise loop (ddim | pndm | "
                        "pndm_prk | euler | euler_a | lms | dpm++ | dpm++3 "
                        "| dpm)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the models run on (cuda | cpu)")
    return p


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def write_snapshot(path: str, snapshot: dict) -> None:
    """``config_snapshot.yaml``: YAML by PyYAML where it is installed, else
    the same mapping as JSON (which YAML reads)."""
    try:
        import yaml
    except ImportError:
        with open(path, "w") as f:
            json.dump(snapshot, f, indent=2)
        return
    with open(path, "w") as f:
        yaml.safe_dump(snapshot, f)


@checked_precision()
def run(args, inference_config, model_config: dict,
        items: List[dict]) -> dict:
    """Everything of :func:`main` after the files are read: for each model
    of ``model_config`` and each of its motion modules, assemble the
    pipeline on ``args.device``, make the first frame of each row without
    an image, and sample ``args.n_samples`` clips a row, ``args.batch_size``
    clips a request; write each clip's GIF and ``config_snapshot.yaml``.
    Returns ``{"savedir", "files" (GIF names in order), "stats" (seconds:
    "load", "t2i", "request" lists)}``; no clip is kept once written."""
    import numpy as np
    import torch

    from followyourclick_tpu_torch.parallel.mesh import process_shard
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )
    from followyourclick_tpu_torch.utils.video_io import (
        clip_preprocess_image,
        downsample_mask_to_latent,
        load_image_and_mask,
        save_videos_grid,
    )

    time_str = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    stem = os.path.splitext(os.path.basename(args.config))[0]
    savedir = os.path.join(args.output_path, f"{stem}-{time_str}")
    os.makedirs(savedir, exist_ok=True)
    shard = list(process_shard(len(items)))
    dtype = {"auto": None, "bfloat16": torch.bfloat16,
             "float32": torch.float32}[args.dtype]
    ip_mode = {"vanilla": "raw"}.get(args.use_ip, args.use_ip)
    result = {"savedir": savedir, "files": [],
              "stats": {"load": [], "t2i": [], "request": []}}

    for model_name, mc in model_config.items():
        motion_modules = mc.get("motion_module") or [None]
        if isinstance(motion_modules, str):
            motion_modules = [motion_modules]
        for mm_path in motion_modules:
            t0 = time.perf_counter()
            pipe = assemble_pipeline_from_pretrained(
                args.pretrained_model_path, inference_config,
                motion_module_path=mm_path,
                personalized_ckpt_path=mc.get("path") or None,
                lora_path=mc.get("lora") or None,
                lora_alpha=mc.get("lora_alpha", 0.6),
                motion_lora_path=args.camera_motion_lora or None,
                motion_lora_alpha=args.camera_motion_lora_alpha,
                dtype=dtype, ip_mode=ip_mode,
                image_encoder_path=args.image_pretrained_model_path or None,
                ip_ckpt_path=args.ip_ckpt or None,
                t5_path=mc.get("t5_path") or None, device=args.device)
            _sync(args.device)
            result["stats"]["load"].append(time.perf_counter() - t0)

            # the first frame of a row without an image: the base T2I
            # pipeline on the same weights, motion modules off
            t2i = None
            if not args.manually_input_image or any(
                    not it.get("image") for it in items):
                from followyourclick_tpu_torch.pipelines.text_to_image import (
                    TextToImagePipeline,
                )

                t2i = TextToImagePipeline(
                    pipe.config, pipe.unet, pipe.vae, pipe.text_encoder,
                    tokenizer=pipe.tokenizer)

            steps = int(mc.get("steps", 25))
            guidance = float(mc.get("guidance_scale", 8.0))
            spec = SampleSpec(
                video_length=args.L, height=args.H, width=args.W,
                num_inference_steps=steps, guidance_scale=guidance,
                video_scale=args.video_scale,
                use_interpolate_noise=args.use_interpolate_noise,
                use_first_image_as_init_latents=(
                    args.use_first_image_as_init_latents),
                cfg_cache_interval=args.cfg_cache_interval,
                pab_spatial_interval=args.pab_interval,
                pab_cross_interval=args.pab_interval,
                pab_temporal_interval=args.pab_interval,
                pab_warmup_steps=args.pab_warmup_steps,
                scheduler=args.scheduler)
            if args.serving_schedule:
                from followyourclick_tpu_torch.pipelines import (
                    serving_schedules,
                )

                spec = serving_schedules.apply_schedule(
                    spec, args.serving_schedule)

            seeds = mc.get("seed", [args.seed])
            if not isinstance(seeds, list):
                seeds = [seeds]

            def prep_item(item, seed):
                """One row → (image in [-1, 1], mask or None); a row
                without an image gets a generated first frame (50 steps,
                CFG 8, at the clip's size and seed)."""
                if item.get("image"):
                    return load_image_and_mask(
                        item["image"], item.get("mask"), args.H, args.W,
                        crop_method=args.crop_method)
                assert t2i is not None
                t0 = time.perf_counter()
                img01 = t2i(item["prompt"] + POS_PROMPT,
                            negative_prompt=NEG_PROMPT,
                            height=args.H, width=args.W, steps=50,
                            guidance_scale=8.0, seed=seed)[0]
                result["stats"]["t2i"].append(time.perf_counter() - t0)
                return img01 * 2.0 - 1.0, None

            work = [(idx, s) for idx in shard for s in range(args.n_samples)]
            for start in range(0, len(work), args.batch_size):
                group = work[start:start + args.batch_size]
                prompts, negs, imgs, masks, grp_seeds = [], [], [], [], []
                for idx, s in group:
                    item = items[idx]
                    prompts.append(item["prompt"] + POS_PROMPT)
                    neg = mc.get("n_prompt", [NEG_PROMPT])
                    negs.append(neg[0] if isinstance(neg, list) else neg)
                    seed = seeds[s % len(seeds)] if seeds else -1
                    if seed is None or int(seed) < 0:
                        seed = np.random.randint(0, 2 ** 31 - 1)
                    seed = int(seed) + s
                    grp_seeds.append(seed)
                    img, mask = prep_item(item, seed)
                    imgs.append(img)
                    masks.append(mask)

                t0 = time.perf_counter()
                first_latents = pipe.encode_image(
                    torch.from_numpy(np.stack(imgs).astype(np.float32)))
                mask_latent = None
                if any(m is not None for m in masks):
                    mask_latent = np.stack([downsample_mask_to_latent(
                        m if m is not None
                        else np.ones((args.H, args.W, 1), np.float32),
                        args.H // 8, args.W // 8) for m in masks])

                partial_mask = None
                if args.mask_first_frame:
                    # one 0.5-threshold spatial mask for the whole batch
                    rng = np.random.RandomState(grp_seeds[0])
                    partial_mask = (rng.rand(1, args.H // 8, args.W // 8, 1)
                                    > 0.5).astype(np.float32)

                ip_image = None
                if ip_mode:
                    # the condition image is the first frame
                    ip_image = np.concatenate(
                        [clip_preprocess_image(im) for im in imgs])

                video = pipe(
                    prompts, negative_prompt=negs, spec=spec,
                    first_image_latents=first_latents, mask=mask_latent,
                    fps=float(args.fps), motion_score=float(args.flw_ctrl),
                    seed=int(grp_seeds[0]), ip_image=ip_image,
                    partial_mask=partial_mask)
                result["stats"]["request"].append(time.perf_counter() - t0)
                for bi, (idx, s) in enumerate(group):
                    prompt = prompts[bi]
                    name = (f"{items[idx]['idx']}-{s}-"
                            f"{prompt[:60].replace('/', '')}.gif")
                    save_videos_grid(video[bi:bi + 1],
                                     os.path.join(savedir, name), fps=8)
                    result["files"].append(name)
                    print(f"[{model_name}] saved {name} "
                          f"(seed {grp_seeds[bi]})")
            del pipe, t2i

    write_snapshot(os.path.join(savedir, "config_snapshot.yaml"),
                   {"args": vars(args), "models": model_config})
    return result


@checked_precision()
def main(argv: Optional[List[str]] = None) -> dict:
    """Parse the flags, read the inference config, the prompt YAML and the
    manifest, and :func:`run`."""
    import yaml

    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.parallel.mesh import initialize_distributed

    args = build_arg_parser().parse_args(argv)
    initialize_distributed()
    inference_config = InferenceConfig.from_yaml(args.inference_config)
    with open(args.config) as f:
        model_config = yaml.safe_load(f)
    return run(args, inference_config, model_config,
               load_prompt_manifest(args.file))


if __name__ == "__main__":
    main()
