"""Flow tooling CLI: train / test / benchmark / flops.

Port of ``followyourclick_tpu/cli/flow_tools.py`` (mmflow's
``tools/train.py``, ``tools/test.py``, ``tools/benchmark.py`` and a FLOP
counter). Configs are the YAML files of ``configs/flow/`` with an
mmflow-style ``model: {type: ...}`` section (any registered estimator) and
a ``train:`` section of ``flow.train.FlowTrainConfig`` fields. ``flops``
and ``benchmark`` count and time the training-mode forward of any
estimator (the per-level flows); ``train`` and ``test`` take RAFT and GMA
only, as in the JAX package, whose trainer and evaluator pass RAFT's
``iters``.

    python -m followyourclick_tpu_torch.cli.flow_tools train \\
        --config configs/flow/raft_flyingchairs.yaml --data-root DIR

Models run on the card unless ``--device cpu``. A model without a
checkpoint has seeded random weights (``--seed``). ``main`` runs under
``utils.backend_flags.checked_precision``.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from followyourclick_tpu_torch.utils.backend_flags import checked_precision


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("followyourclick-flow")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights of a model without checkpoint")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--config", type=str, required=True)
    t.add_argument("--data-root", type=str, required=True)
    t.add_argument("--dataset", type=str, default="FlyingChairs",
                   choices=["FlyingChairs", "Sintel", "KITTI"])
    t.add_argument("--work-dir", type=str, default="work_dir")
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=2)
    t.add_argument("--crop", type=int, nargs=2, default=[368, 496])
    t.add_argument("--no-resume", action="store_true")

    e = sub.add_parser("test")
    e.add_argument("--config", type=str, required=True)
    e.add_argument("--checkpoint", type=str, required=True,
                   help="a train checkpoint (iter_N.pth) or an mmflow .pth")
    e.add_argument("--data-root", type=str, required=True)
    e.add_argument("--dataset", type=str, default="Sintel",
                   choices=["FlyingChairs", "Sintel", "KITTI"])
    e.add_argument("--metrics", type=str, nargs="+", default=["EPE"])
    e.add_argument("--iters", type=int, default=32)

    b = sub.add_parser("benchmark")
    b.add_argument("--config", type=str, required=True)
    b.add_argument("--size", type=int, nargs=2, default=[448, 1024])
    b.add_argument("--warmup", type=int, default=5)
    b.add_argument("--max-iter", type=int, default=50)

    fl = sub.add_parser(
        "flops", help="operations of one forward, counted by "
        "torch.utils.flop_counter.FlopCounterMode on the meta device (its "
        "formulas per aten op, not XLA's cost model, which the JAX tool "
        "reads)")
    fl.add_argument("--config", type=str, default=None,
                    help="flow estimator YAML (or --unet)")
    fl.add_argument("--unet", action="store_true",
                    help="count the flagship UNet3D forward instead")
    fl.add_argument("--size", type=int, nargs=2, default=[448, 1024],
                    help="input H W (flow: image size; unet: pixel size, "
                         "the latent grid is size / 8)")
    fl.add_argument("--frames", type=int, default=16,
                    help="video length for --unet")
    return p


def count_flops(fn, *args) -> dict:
    """Operations of ``fn(*args)`` by ``FlopCounterMode`` (2 a
    multiply-add)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return {"gflops": round(counter.get_total_flops() / 1e9, 3)}


def _raft_only(cfg: dict, cmd: str) -> None:
    kind = cfg["model"].get("type")
    if kind not in ("RAFT", "GMA"):
        raise ValueError(f"flow_tools {cmd} takes a RAFT or GMA config "
                         f"(an iterative estimator), not {kind!r}")


def _load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _load_dataset(name: str, root: str):
    from followyourclick_tpu_torch.flow import datasets

    return {"FlyingChairs": datasets.FlyingChairs,
            "Sintel": datasets.Sintel,
            "KITTI": datasets.KITTI}[name](root)


def _flops(args) -> dict:
    import torch

    if args.unet:
        from followyourclick_tpu_torch.config import InferenceConfig
        from followyourclick_tpu_torch.models.unet3d import (
            UNet3DConditionModel,
            UNetConditioning,
        )

        ucfg = InferenceConfig().unet
        h, w = args.size[0] // 8, args.size[1] // 8
        b, f = 2, args.frames  # the CFG batch
        cin = UNet3DConditionModel.conv_in_channels(ucfg)
        with torch.device("meta"):
            unet = UNet3DConditionModel(ucfg).to(torch.bfloat16)
            sample = torch.empty(b, f, h, w, cin, dtype=torch.bfloat16)
            cond = UNetConditioning(
                torch.empty(b, 77, ucfg.cross_attention_dim,
                            dtype=torch.bfloat16),
                torch.full((b,), 8.0), torch.full((b,), 20.0))
            out = count_flops(unet, sample, torch.zeros(b), cond)
        out.update(model="UNet3DConditionModel",
                   params_m=round(sum(p.numel() for p in unet.parameters())
                                  / 1e6, 2),
                   input=f"{b}x{f}x{h}x{w}x{cin} (latent, CFG batch)")
        return out
    if args.config is None:
        raise SystemExit("flops: pass --config or --unet")
    from followyourclick_tpu_torch.flow.registry import flow_estimator

    model_cfg = _load_config(args.config)["model"]
    h, w = args.size
    with torch.device("meta"):
        model = flow_estimator(model_cfg).build().eval()
        img = torch.empty(1, 3, h, w)
        out = count_flops(model, img, img)
    out.update(model=model_cfg["type"],
               params_m=round(sum(p.numel() for p in model.parameters())
                              / 1e6, 2),
               input=f"1x3x{h}x{w} pair")
    return out


@checked_precision()
def main(argv: Optional[List[str]] = None) -> None:
    import numpy as np
    import torch

    from followyourclick_tpu_torch.flow.registry import build_flow_estimator

    args = build_parser().parse_args(argv)
    if args.cmd == "flops":
        print(json.dumps(_flops(args)))
        return

    cfg = _load_config(args.config)
    if args.cmd in ("train", "test"):
        _raft_only(cfg, args.cmd)
    if args.cmd == "train":
        from followyourclick_tpu_torch.flow.datasets import training_batches
        from followyourclick_tpu_torch.flow.train import (
            FlowTrainConfig,
            train_model,
        )

        model = build_flow_estimator(cfg["model"], seed=args.seed,
                                     device=args.device)
        ds = _load_dataset(args.dataset, args.data_root)
        it = training_batches(ds, args.batch_size, crop_size=tuple(args.crop))
        train_model(model, it, FlowTrainConfig(**cfg.get("train", {})),
                    work_dir=args.work_dir, max_steps=args.max_steps,
                    resume=not args.no_resume,
                    log_fn=lambda s, m: print(f"iter {s}: {m}", flush=True))

    elif args.cmd == "test":
        from followyourclick_tpu_torch.flow.train import evaluate

        saved = torch.load(args.checkpoint, map_location="cpu",
                           weights_only=True)
        model = build_flow_estimator(cfg["model"],
                                     checkpoint=saved.get("state_dict",
                                                          saved),
                                     device=args.device)
        ds = _load_dataset(args.dataset, args.data_root)
        print(json.dumps(evaluate(model, ds, iters=args.iters,
                                  metrics=args.metrics)))

    elif args.cmd == "benchmark":
        import time

        from followyourclick_tpu_torch.utils.profiling import fps_benchmark

        h, w = args.size
        model = build_flow_estimator(cfg["model"], seed=args.seed,
                                     device=args.device)
        rs = np.random.RandomState(0)
        pair = tuple(torch.from_numpy(rs.rand(1, 3, h, w).astype(
            np.float32)).to(args.device) for _ in range(2))
        card = torch.device(args.device).type == "cuda"
        if card:
            torch.cuda.reset_peak_memory_stats(args.device)
        seconds = []

        @torch.no_grad()
        def step(p):
            t0 = time.perf_counter()
            out = model(p[0], p[1])
            if card:
                torch.cuda.synchronize(args.device)
            seconds.append(time.perf_counter() - t0)
            return out

        fps = fps_benchmark(step, iter(lambda: pair, None),
                            warmup=args.warmup, max_iter=args.max_iter)
        warm = seconds[args.warmup:]
        print(json.dumps({
            "fps": round(fps, 2), "size": [h, w],
            # the port's additions: the median warm call, the peak memory
            "median_ms": round(float(np.median(warm)) * 1e3, 3),
            "peak_gib": (round(torch.cuda.max_memory_allocated(args.device)
                               / 2 ** 30, 3) if card else None)}))


if __name__ == "__main__":
    main()
