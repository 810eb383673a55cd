"""Gallery sampler: prompt YAML → one GIF a prompt and a combined grid.

Port of ``followyourclick_tpu/cli/animate.py`` (the reference's
``scripts/animate.py``): each model entry of the YAML (``motion_module``,
``path``, ``lora``, ``lora_alpha``, ``seed``, ``steps``,
``guidance_scale``, ``prompt``, ``n_prompt``) is assembled from checkpoint
files and samples each of its prompts; ``--device`` (``cuda`` by default)
as in ``cli/inference.py``::

    python -m followyourclick_tpu_torch.cli.animate --config prompts.yaml
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path
from typing import List, Optional

from followyourclick_tpu_torch.utils.backend_flags import checked_precision


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("followyourclick-animate")
    p.add_argument("--pretrained_model_path", type=str,
                   default="models/StableDiffusion/stable-diffusion-v1-5")
    p.add_argument("--inference_config", type=str,
                   default="configs/inference/inference.yaml")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--savedir", type=str, default="samples")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the models run on (cuda | cpu)")
    return p


@checked_precision()
def run(args, inference_config, model_config: dict) -> dict:
    """Sample every prompt of every model entry; write ``<n>-<prompt>.gif``
    each, ``sample.gif`` (all of them, one a row) and ``config.yaml``.
    Returns ``{"savedir", "files", "videos"}``."""
    import numpy as np

    from followyourclick_tpu_torch.cli.inference import write_snapshot
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )
    from followyourclick_tpu_torch.utils.video_io import save_videos_grid

    time_str = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    savedir = os.path.join(args.savedir,
                           f"{Path(args.config).stem}-{time_str}")
    os.makedirs(savedir, exist_ok=True)
    samples, files = [], []
    for mc in model_config.values():
        motion_modules = mc.get("motion_module") or [None]
        if isinstance(motion_modules, str):
            motion_modules = [motion_modules]
        for mm in motion_modules:
            pipe = assemble_pipeline_from_pretrained(
                args.pretrained_model_path, inference_config,
                motion_module_path=mm,
                personalized_ckpt_path=mc.get("path") or None,
                lora_path=mc.get("lora") or None,
                lora_alpha=mc.get("lora_alpha", 0.8), device=args.device)
            prompts = mc.get("prompt", [])
            n_prompts = mc.get("n_prompt", [""])
            if len(n_prompts) == 1:
                n_prompts = n_prompts * len(prompts)
            seeds = mc.get("seed", [-1])
            if not isinstance(seeds, list):
                seeds = [seeds] * len(prompts)
            spec = SampleSpec(
                video_length=args.L, height=args.H, width=args.W,
                num_inference_steps=int(mc.get("steps", 25)),
                guidance_scale=float(mc.get("guidance_scale", 7.5)))
            for prompt, neg, seed in zip(prompts, n_prompts, seeds):
                if seed is None or int(seed) < 0:
                    seed = int(np.random.randint(0, 2 ** 31 - 1))
                print(f"sampling: {prompt} (seed {seed})")
                video = pipe([prompt], negative_prompt=[neg], spec=spec,
                             seed=int(seed))
                samples.append(video)
                fname = f"{len(files)}-{prompt[:60].replace('/', '')}.gif"
                save_videos_grid(video, os.path.join(savedir, fname), fps=8)
                files.append(fname)
            del pipe
    if samples:
        save_videos_grid(np.concatenate(samples, axis=0),
                         os.path.join(savedir, "sample.gif"), fps=8,
                         n_rows=len(samples))
    write_snapshot(os.path.join(savedir, "config.yaml"), model_config)
    return {"savedir": savedir, "files": files,
            "videos": dict(zip(files, samples))}


@checked_precision()
def main(argv: Optional[List[str]] = None) -> dict:
    import yaml

    from followyourclick_tpu_torch.config import InferenceConfig

    args = build_parser().parse_args(argv)
    inference_config = InferenceConfig.from_yaml(args.inference_config)
    with open(args.config) as f:
        model_config = yaml.safe_load(f)
    return run(args, inference_config, model_config)


if __name__ == "__main__":
    main()
