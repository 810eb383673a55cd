"""The last slice's modules without JAX: in a fresh interpreter whose
``PYTHONPATH`` starts with stand-ins for ``jax``, ``flax`` and the JAX
package that raise on import (so the ranks ``launch`` starts, which take
the same ``PYTHONPATH``, cannot import them either),
``entry.dryrun_multichip(2, device="cpu")`` (two gloo ranks on JAX's
``{'data': 1, 'model': 2}`` grid: one tensor-parallel step and one sampler
request), the clip loader on a PNG
and an MJPG clip, and ``evaluate_sharded`` of a seeded RAFT run, and none of
the banned modules is loaded after."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "flax", "followyourclick_tpu")


def test_ranks_loader_and_sharded_eval_run_without_jax(tmp_path):
    stubs = tmp_path / "banned"
    for name in BANNED:
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is banned here')\n")
    code = textwrap.dedent("""
        import sys, types
        import numpy as np
        import torch
        torch.set_num_threads(1)  # beside the suite's other workers
        import cv2
        from followyourclick_tpu_torch import entry
        from followyourclick_tpu_torch.data.native_loader import (
            NativeClipLoader)
        from followyourclick_tpu_torch.flow.api import init_model
        from followyourclick_tpu_torch.flow.train import evaluate_sharded

        out = entry.dryrun_multichip(2, device="cpu")
        assert np.isfinite(out["loss"]) and out["backend"] == "gloo", out
        rs = np.random.RandomState(0)
        cv2.imwrite("x.png", (rs.rand(40, 50, 3) * 255).astype(np.uint8))
        writer = cv2.VideoWriter("x.avi", cv2.VideoWriter_fourcc(*"MJPG"),
                                 8, (32, 24))
        for _ in range(4):
            writer.write((rs.rand(24, 32, 3) * 255).astype(np.uint8))
        writer.release()
        loader = NativeClipLoader(2)
        loader.submit("x.png", None, (16, 16))
        loader.submit("x.avi", [1, 3], (16, 16), 1)
        shapes = sorted(loader.next()[1].shape for _ in range(2))
        loader.close()
        assert shapes == [(1, 16, 16, 3), (2, 16, 16, 3)], shapes
        sample = types.SimpleNamespace(
            img1=rs.rand(64, 64, 3) * 255, img2=rs.rand(64, 64, 3) * 255,
            flow_gt=rs.randn(64, 64, 2).astype(np.float32),
            valid=np.ones((64, 64), np.float32))
        val = evaluate_sharded(init_model(seed=1, device="cpu"), [sample],
                               iters=2, metrics=("EPE", "Fl"))
        assert np.isfinite(val["EPE"]), val
        loaded = [name for name in sys.modules
                  if name.split(".")[0] in %r]
        assert not loaded, loaded
        print("ok")
    """ % (BANNED,))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join((str(stubs), REPO))}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), (
        run.stdout[-3000:] + run.stderr[-3000:])
    assert ("dryrun_multichip(2): mesh={'data': 1, 'model': 2} loss="
            in run.stdout)
    assert "dryrun_multichip(2): sharded-serving checksum=" in run.stdout
