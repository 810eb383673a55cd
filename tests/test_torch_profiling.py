"""The port's ``utils/profiling.py`` against the JAX package's.

- ``StageTimer``: the same stages give the same summary (stage names, the
  keys of each entry, the counts, mean = total / count to its rounding),
  and a stage given ``sync`` waits for it before its clock stops: with the
  wait made to take 50 ms (the JAX package's ``jax.block_until_ready``, the
  port's ``block_until_ready``), that stage counts it in both and the
  others do not.
- ``block_until_ready`` walks tensors in lists, tuples and dicts and gives
  its argument back.
- ``device_trace``: both packages write a Chrome trace (JSON with
  ``traceEvents``) under ``log_dir`` around a traced block, also when the
  block raises; the port's holds the block's operator.
"""

import glob
import gzip
import json
import os
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from followyourclick_tpu.utils import profiling as jprof
from followyourclick_tpu_torch.utils import profiling as tprof

WAIT_S = 0.05


def _stages(timer, sync):
    for name, synced in (("a", False), ("a", False), ("b", True),
                         ("c", False), ("b", True)):
        with timer.stage(name, sync=sync if synced else None):
            pass
    return timer.summary()


def test_stage_timer_matches_jax(monkeypatch):
    def slow(out):
        time.sleep(WAIT_S)
        return out

    monkeypatch.setattr(jax, "block_until_ready", slow)
    monkeypatch.setattr(tprof, "block_until_ready", slow)
    want = _stages(jprof.StageTimer(), jnp.ones(4))
    got = _stages(tprof.StageTimer(), torch.ones(4))
    assert list(got) == list(want) == ["a", "b", "c"]
    for name in want:
        assert got[name].keys() == want[name].keys()
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["mean_s"] == pytest.approx(
            got[name]["total_s"] / got[name]["count"], abs=1e-4)
    for summary in (want, got):
        assert summary["b"]["total_s"] >= 2 * WAIT_S
        assert summary["a"]["total_s"] < WAIT_S
        assert summary["c"]["total_s"] < WAIT_S


def test_block_until_ready_walks_containers():
    out = {"x": torch.ones(2), "y": [torch.zeros(1), (torch.ones(3),)],
           "z": 4}
    assert tprof.block_until_ready(out) is out
    t = torch.ones(2)
    assert tprof.block_until_ready(t) is t


def _chrome_events(log_dir):
    """The ``traceEvents`` of every Chrome trace written under ``log_dir``
    (JAX's gzipped under ``plugins/profile/<run>/``, the port's at the
    top)."""
    paths = glob.glob(os.path.join(log_dir, "**", "*trace.json*"),
                      recursive=True)
    events = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events += json.load(f)["traceEvents"]
    return paths, events


@pytest.mark.parametrize("raises", [False, True])
def test_device_trace_writes_a_chrome_trace_as_jax(tmp_path, raises):
    def traced(ctx, work):
        try:
            with ctx:
                work()
                if raises:
                    raise RuntimeError("inside the trace")
        except RuntimeError:
            assert raises

    traced(jprof.device_trace(str(tmp_path / "jax")),
           lambda: (jnp.ones((32, 32)) @ jnp.ones((32, 32))
                    ).block_until_ready())
    traced(tprof.device_trace(str(tmp_path / "port")),
           lambda: torch.ones(32, 32) @ torch.ones(32, 32))
    for pkg in ("jax", "port"):
        paths, events = _chrome_events(str(tmp_path / pkg))
        assert paths and events, pkg
    _, events = _chrome_events(str(tmp_path / "port"))
    assert any(e.get("name") in ("aten::matmul", "aten::mm")
               for e in events)
