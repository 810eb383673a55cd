"""The port's flow CLI and the smoke's flow phases on the CPU, and the flow
path, the flow CLI and a T5 text request without JAX.

- ``chip_smoke`` phases 20-22 at small sizes on the CPU (the card's
  events, memory statistics and profiler stubbed): the motion score, card
  vs CPU (here CPU vs CPU) against fp64, GMA, the mmflow checkpoint; the
  CLI's ``train`` (with the resume), ``test``, ``benchmark`` and
  ``flops``; two of phase 22's estimators and its camera clip: every
  check they make on the card passes.
- ``cli.flow_tools flops`` counts a RAFT pair and the UNet on the meta
  device.
- In a fresh interpreter with ``jax``, ``flax``, the JAX package, ``cv2``
  and ``transformers`` banned: the motion score, ``flow_tools train`` on
  tiny synthetic FlyingChairs and a T5 text request through the loader
  run, and none of them is loaded after.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import chip_smoke
from tests.test_torch_lama_remove import _Event
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_flow_phases_rehearse_on_the_cpu(monkeypatch, tmp_path):
    for name, fn in (("Event", _Event), ("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(chip_smoke, "profiled", lambda acts, fn: (
        fn(), 1.0, 0.0, [], [(0.0, 1e5, "gemm")], 0.5)[1:])
    got = chip_smoke.phase_motion_score(0, str(tmp_path), device="cpu",
                                        clip=(3, 64, 96), cpu_size=64)
    assert not any(got.values())
    got = chip_smoke.phase_flow_train(0, str(tmp_path), device="cpu",
                                      chairs=(2, 72, 100), crop=(64, 96),
                                      sintel_size=(60, 90),
                                      bench_size=(64, 64))
    assert not any(got.values())
    # phase 22 on estimators whose outputs take each of its paths (levels
    # and a mask; IRR-PWC's nested lists and the BCE)
    monkeypatch.setattr(chip_smoke, "FLOW_EST_BENCH",
                        ("--warmup", "1", "--max-iter", "1"))
    monkeypatch.setattr(chip_smoke, "CAMERA_CLIP", (2, 64))
    monkeypatch.setattr(chip_smoke, "CAMERA_IMAGE", (96, 128))
    got = chip_smoke.phase_flow_estimators(
        0, device="cpu", size=(64, 64), bench_size=(64, 64),
        configs=("maskflownets_slong_flyingchairs",
                 "irrpwc_sshort_flyingchairsocc"))
    assert not any(got.values())


def test_flops(capsys):
    from followyourclick_tpu_torch.cli import flow_tools

    flow_tools.main(["flops", "--config", os.path.join(
        REPO, "configs/flow/raft_flyingchairs.yaml"), "--size", "64", "96"])
    raft = json.loads(capsys.readouterr().out)
    assert raft["model"] == "RAFT" and raft["params_m"] == 5.26
    flow_tools.main(["flops", "--config", os.path.join(
        REPO, "configs/flow/gma_flyingchairs.yaml"), "--size", "64", "96"])
    gma = json.loads(capsys.readouterr().out)
    assert gma["params_m"] == 5.8 and gma["gflops"] > raft["gflops"] > 0
    flow_tools.main(["flops", "--unet", "--size", "64", "64", "--frames",
                     "2"])
    unet = json.loads(capsys.readouterr().out)
    assert unet["params_m"] > 1000 and unet["gflops"] > 0
    with pytest.raises(SystemExit):
        flow_tools.main(["flops"])


def test_flow_and_t5_text_run_without_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        banned = ("jax", "flax", "followyourclick_tpu", "cv2",
                  "transformers")
        for name in banned:
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)  # beside the suite's other workers
        import chip_smoke
        from followyourclick_tpu_torch.cli import flow_tools
        from followyourclick_tpu_torch.flow import api
        root = sys.argv[1]
        model = api.init_model(seed=0, device="cpu")
        frames = chip_smoke.flow_clip(0, 3, 64, 96)
        score = api.compute_motion_score(model, frames, iters=2)
        assert np.isfinite(score) and score > 0, score
        chip_smoke.write_flying_chairs(root + "/chairs", 0, (2, 72, 100))
        flow_tools.main(["--device", "cpu", "train", "--config",
                         chip_smoke.FLOW_CONFIG, "--data-root",
                         root + "/chairs", "--work-dir", root + "/work",
                         "--max-steps", "1", "--crop", "64", "96"])
        chip_smoke.phase_t5_text(0, root, device="cpu")
        loaded = [name for name in sys.modules
                  if name.split(".")[0] in banned
                  and sys.modules[name] is not None]
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), (
        run.stdout[-3000:] + run.stderr[-3000:])
    assert "iter 0:" in run.stdout
