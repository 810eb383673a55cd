"""``train_loop`` on a ``(data, model) = (2, 2)`` mesh, its checkpoints and
resume (``tests/_torch_tp_ranks.loop_runs``, four ``gloo`` ranks, the
port only; the tiny UNet sharded over ``model``, the four-clip batch of
``tests/test_torch_data_parallel.py``, partitioned steps with the
whole-call checkpoint, so every step's backward recomputes the forward's
collectives):

- a 2-step run resumed from its step-1 checkpoint equals the uninterrupted
  2-step run bit for bit (masters, frozen leaves, moments, count);
- the checkpoint files hold full tensors: a one-process state restores the
  grid's step-2 checkpoint and equals the grid's gathered state bit for
  bit;
- the other way round, the grid resumes a one-process run's step-1
  checkpoint and ends within the data-parallel tests' bound (``steps ·
  1e-3 · lr``) of the one-process run continued to step 2;
- ``validation_fn`` runs on rank 0 alone and is given the full params:
  the grid's gathered state bit for bit, the one-process run's names and
  shapes, within the same bound of its values.
"""

import itertools
import os
import shutil

import pytest
import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
from followyourclick_tpu_torch.training import loop as tl
from followyourclick_tpu_torch.training import step as ts
from tests import _torch_tp_ranks
from tests.test_torch_data_parallel import (
    PARTITIONED,
    global_batch,
    rank_job,
    torch_batch,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import models

GRID = (2, 2)
STEPS = 2
KEYS = ("trainable", "frozen", "mu", "nu")


def one_process_loop(root, steps):
    """The port's loop in this process over the four clips, a checkpoint
    every step, resumed from ``root`` when it holds one."""
    _, _, _, _, unet, text = models()
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = ts.TrainBatch(**torch_batch(global_batch()))

    def step_fn(state, batch, generator):
        return ts.train_step_partitioned(state, batch, generator, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=PARTITIONED)

    state = ts.create_partitioned_train_state(unet, PARTITIONED,
                                              frozen_dtype=torch.float32)
    return tl.train_loop(state, itertools.repeat(batch), step_fn,
                         tl.LoopConfig(output_dir=root, max_train_steps=steps,
                                       checkpointing_steps=1, log_every=100,
                                       keep_checkpoints=3,
                                       temporal_multi_scale=False), seed=3)


def as_dict(state):
    return {"trainable": state.trainable, "frozen": state.frozen,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}


@pytest.fixture(scope="module")
def one_process(runs):
    """The one-process run resumed from its step-1 checkpoint to
    ``STEPS`` (after the grid's runs, which read that checkpoint)."""
    root, _ = runs
    return one_process_loop(os.path.join(root, "one"), STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_loop"))
    one_process_loop(os.path.join(root, "one"), STEPS - 1)
    shutil.copytree(os.path.join(root, "one"), os.path.join(root, "c"))
    path = os.path.join(root, "job.pt")
    torch.save(rank_job(grid=GRID, cfg=PARTITIONED, steps=STEPS, root=root,
                        batch=torch_batch(global_batch())), path)
    out = dp.launch(_torch_tp_ranks.loop_runs, GRID[0] * GRID[1], (path,),
                    timeout=240.0)
    assert not any(r["jax_loaded"] for r in out)
    return root, out


def test_resumed_grid_run_equals_the_uninterrupted_one(runs):
    _, ranks = runs
    for r in ranks:
        a, b = r["run0"], r["run2"]
        assert a["step"] == b["step"] == STEPS
        assert a["count"] == b["count"] == STEPS
        assert r["run1"]["step"] == STEPS - 1
        for key in KEYS:
            for n, t in a[key].items():
                assert torch.equal(t, b[key][n]), (r["rank"], key, n)
                assert torch.equal(t, ranks[0]["run0"][key][n]), (key, n)


def test_grid_checkpoint_loads_in_one_process(runs):
    root, ranks = runs
    manager = tl.make_checkpoint_manager(os.path.join(root, "a",
                                                      "checkpoints"))
    assert manager.all_steps() == list(range(1, STEPS + 1))
    _, _, _, _, unet, _ = models()
    state = ts.create_partitioned_train_state(unet, PARTITIONED,
                                              frozen_dtype=torch.float32)
    state, step = tl.restore_checkpoint(manager, state)
    assert step == STEPS and state.opt_state["count"] == STEPS
    want = ranks[0]["run0"]
    got = as_dict(state)
    for key in KEYS:
        assert got[key].keys() == want[key].keys()
        for n, t in want[key].items():
            assert torch.equal(got[key][n], t), (key, n)


def test_grid_resumes_a_one_process_checkpoint(runs, one_process):
    _, ranks = runs
    want = as_dict(one_process)
    bound = STEPS * 1e-3 * PARTITIONED.learning_rate
    got = ranks[0]["run3"]
    assert got["step"] == STEPS
    worst = max(float((got["trainable"][n] - t).abs().max())
                for n, t in want["trainable"].items())
    assert worst <= bound, (worst, bound)
    for n, t in want["frozen"].items():
        assert torch.equal(got["frozen"][n], t), n


def test_grid_validation_gets_the_full_params(runs, one_process):
    _, ranks = runs
    assert all(not r["validated"] for r in ranks[1:])
    [(step, params)] = ranks[0]["validated"]
    assert step == STEPS
    grid = ranks[0]["run0"]
    want = one_process.params
    assert params.keys() == want.keys()
    bound = STEPS * 1e-3 * PARTITIONED.learning_rate
    for n, t in params.items():
        assert t.shape == want[n].shape, n
        assert torch.equal(t, grid["trainable"][n] if n in grid["trainable"]
                           else grid["frozen"][n]), n
        assert float((t - want[n]).abs().max()) <= bound, n
