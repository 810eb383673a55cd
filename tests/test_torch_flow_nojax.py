"""Every flow estimator of the port without JAX: in a fresh interpreter
with jax, flax, the JAX package and cv2 banned, ``flow_tools flops`` and
``benchmark --device cpu --size 64 64`` run for every
``configs/flow/*.yaml``, and none of the banned modules is loaded after.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_estimator_runs_without_jax():
    """In a fresh interpreter with jax, flax, the JAX package and cv2
    banned, ``flow_tools flops`` and ``benchmark`` (which builds the
    estimator with seeded weights and runs it) run for every config, so
    every registered estimator builds and runs."""
    code = textwrap.dedent("""
        import glob, io, json, sys, contextlib
        banned = ("jax", "flax", "followyourclick_tpu", "cv2")
        for name in banned:
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)  # beside the suite's other workers
        from followyourclick_tpu_torch.cli import flow_tools
        for path in sorted(glob.glob("configs/flow/*.yaml")):
            for argv in (["flops", "--config", path],
                         ["--device", "cpu", "benchmark", "--config", path,
                          "--size", "64", "64", "--warmup", "1",
                          "--max-iter", "1"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    flow_tools.main(argv)
                line = json.loads(buf.getvalue().splitlines()[-1])
                assert line.get("gflops", line.get("fps", 0)) > 0, line
        loaded = [name for name in sys.modules
                  if name.split(".")[0] in banned
                  and sys.modules[name] is not None]
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), (
        run.stdout[-3000:] + run.stderr[-3000:])
