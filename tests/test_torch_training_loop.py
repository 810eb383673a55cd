"""The training loop: the temporal multi-scale frame crop against the JAX
``_subsample_frames`` with the same ``RandomState``, and auto-resume.

Resume: the tiny UNet of ``tests/test_torch_training_step.py`` trains three
steps in one run that saves at step 2, and again in a fresh state that
resumes from that checkpoint and takes step 3; every trainable and frozen
tensor, both moments and the step count must equal the uninterrupted
run's, bit for bit (each step draws from a generator seeded by the run's
seed and the step). Also: keep-N, the log line and the validation hook's
steps.
"""

import dataclasses
import importlib
import itertools
import os

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.schedulers import ddim as tddim
from followyourclick_tpu_torch.training import loop as tl
from followyourclick_tpu_torch.training import step as ts
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import make_batch, models

jloop = importlib.import_module("followyourclick_tpu.training.loop")


@dataclasses.dataclass
class _Batch:
    latents: np.ndarray

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytest.mark.parametrize("frames,min_frames", [(16, 8), (24, 8), (8, 8),
                                               (13, 4)])
def test_subsample_frames_matches_jax(frames, min_frames):
    lat = np.arange(2 * frames, dtype=np.float32).reshape(2, frames, 1, 1, 1)
    jrng, trng = np.random.RandomState(1234), np.random.RandomState(1234)
    for _ in range(12):
        want = jloop._subsample_frames(_Batch(lat), jrng, min_frames)
        got = tl._subsample_frames(
            ts.TrainBatch(torch.from_numpy(lat), None, None, None, None),
            trng, min_frames)
        np.testing.assert_array_equal(got.latents.numpy(), want.latents)


def _run(tmp_path, max_steps, state, capsys=None, validation=None):
    _, _, _, _, unet, text = models()
    cfg = ts.TrainConfig(learning_rate=1e-3, gradient_checkpointing=False)
    sched = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = ts.TrainBatch(**{k: torch.from_numpy(v)
                             for k, v in make_batch().items()})

    def step_fn(state, batch, generator):
        return ts.train_step_partitioned(state, batch, generator, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=cfg)

    loop_cfg = tl.LoopConfig(output_dir=str(tmp_path),
                             max_train_steps=max_steps,
                             checkpointing_steps=2, log_every=1,
                             keep_checkpoints=1, temporal_multi_scale=False,
                             validation_steps=2, validation_steps_tuple=(1,))
    return tl.train_loop(state, itertools.repeat(batch), step_fn, loop_cfg,
                         seed=5, validation_fn=validation)


def _fresh():
    unet = models()[4]
    return ts.create_partitioned_train_state(
        unet, ts.TrainConfig(learning_rate=1e-3))


def test_resume_equals_uninterrupted(tmp_path, capsys):
    seen = []
    whole = _run(tmp_path / "a", 3, _fresh(),
                 validation=lambda step, params: seen.append(
                     (step, len(params))))
    n_params = len(dict(models()[4].named_parameters()))
    assert seen == [(1, n_params), (2, n_params)]
    out = capsys.readouterr().out
    assert "step 3/3 loss=" in out and "ms/step" in out
    assert tl.make_checkpoint_manager(
        str(tmp_path / "a" / "checkpoints")).all_steps() == [2]
    # a fresh state, resumed from the uninterrupted run's step-2 checkpoint
    os.makedirs(tmp_path / "b")
    os.symlink(tmp_path / "a" / "checkpoints", tmp_path / "b" / "checkpoints")
    resumed = _run(tmp_path / "b", 3, _fresh())
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == whole.step == 3
    assert resumed.opt_state["count"] == whole.opt_state["count"] == 3
    for part in ("trainable", "frozen"):
        for n, t in getattr(whole, part).items():
            assert torch.equal(t, getattr(resumed, part)[n]), (part, n)
    for moment in ("mu", "nu"):
        for n, t in whole.opt_state[moment].items():
            assert torch.equal(t, resumed.opt_state[moment][n]), (moment, n)
    fresh = _fresh()
    assert any(not torch.equal(t, fresh.trainable[n])
               for n, t in whole.trainable.items())


def test_checkpoint_round_trip_full_tree(tmp_path):
    unet = models()[4]
    state = ts.create_train_state(unet, ts.TrainConfig())
    manager = tl.make_checkpoint_manager(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        state.step = step
        tl.save_checkpoint(manager, step, state)
    assert manager.all_steps() == [4, 6]
    other = ts.create_train_state(unet, ts.TrainConfig())
    name = next(iter(other.tx.lrs))  # a trainable leaf: the state's copy
    other.params[name].add_(1.0)
    other, step = tl.restore_checkpoint(manager, other)
    assert step == 6 and other.step == 6
    for n, t in state.params.items():
        assert torch.equal(t, other.params[n])
