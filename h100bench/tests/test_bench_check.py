"""``correct`` at a tiny size on the CPU: a run of each cell, with the
card's look skipped, judged against the reference: sound (the program in
float32 reads next to nothing), with the control in the program's place,
and with each fault the cell can have planted under the timed path. The
cells' own limits must pass the sound run and refuse the others."""

from __future__ import annotations

import time

import pytest
import torch

from h100bench.drivers import sampler, trainer
from h100bench.harness.cell import driver
from h100bench.run import checked_numbers
from h100bench.tests.tiny import I2V, TRAIN, no_card, tiny_cell

SEED = 2_718_281_828


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_cell(monkeypatch, cell, seconds=0.0):
    with no_card(monkeypatch):
        return driver(cell).run(cell, SEED, seconds, False,
                                time.perf_counter(), device="cpu")


def verdict(cell, out) -> bool:
    return checked_numbers(out["numbers"], cell.own["limits"])[0]


# ------------------------------------------------------------- the sampler


def test_sampler_run_is_correct(monkeypatch):
    cell = tiny_cell(I2V)
    out = run_cell(monkeypatch, cell)
    assert out["attempted"] == 1
    assert set(out["numbers"]) == set(cell.own["limits"])
    assert max(out["numbers"].values()) < 1e-4, out["numbers"]
    assert verdict(cell, out)
    assert set(out["metrics"]) == {"frames_per_s", "request_p90_s",
                                   "setup_s"}


def test_sampler_control_is_refused():
    """The reference in float8 in the program's place."""
    cell = tiny_cell(I2V)
    numbers = sampler.readings(cell, SEED, "control", "cpu")
    assert not checked_numbers(numbers, cell.own["limits"])[0], numbers


@pytest.mark.parametrize("change", [
    {"schedule": "pab488_deep4_cfg4_ex"},
    {"spec": {"video_scale": 1.5}},
    {"guidance_scale": 1.0},
])
def test_sampler_refuses_a_request_its_judge_does_not_follow(change):
    traffic = dict(tiny_cell(I2V).traffic, **change)
    with pytest.raises(ValueError, match="judges exact DDIM"):
        sampler.judged(sampler.sample_spec(traffic))


def test_sampler_passes_the_traffic_spec_through():
    traffic = dict(tiny_cell(I2V).traffic, clips=2,
                   spec={"share_cfg_prefix": True})
    spec = sampler.judged(sampler.sample_spec(traffic))
    assert (spec.video_length, spec.height, spec.num_inference_steps) == (
        traffic["frames"], traffic["height"], traffic["steps"])


def test_sampler_open_loop_counts_latency_from_arrival(monkeypatch):
    """Requests arriving evenly at ``arrivals_per_s``: none starts before
    it arrives, and a sound run is correct."""
    cell = tiny_cell(I2V, steps=1)
    cell.traffic = dict(cell.traffic, arrivals_per_s=0.5)
    slept = []
    monkeypatch.setattr(sampler.time, "sleep", slept.append)
    out = run_cell(monkeypatch, cell)
    assert out["attempted"] == 1 and verdict(cell, out)
    assert slept and slept[0] == 0.0


class _Still:
    """A solver whose step hands its state back unchanged."""

    def __init__(self, solver):
        self.solver = solver

    def __getattr__(self, name):
        return getattr(self.solver, name)

    def step(self, out, i, x, state, **kw):
        return x, state


def _still_solver(make):
    return lambda *a, **k: _Still(make(*a, **k))


def _altered_video(fn):
    def run(self, latents, *a, **k):
        video = fn(self, latents, *a, **k).clone()
        video[:, 0] = 1.0 - video[:, 0]
        return video
    return run


SAMPLER_FAULTS = {
    # a step that returns its state unchanged
    "still_step": ("followyourclick_tpu_torch.pipelines.animation."
                   "make_solver", _still_solver),
    # an answer altered where it is produced: a frame of the video
    "altered_video": ("followyourclick_tpu_torch.pipelines.animation."
                      "AnimationPipeline.decode_latents", _altered_video),
    # the motion modules pass their input through
    "no_motion": ("followyourclick_tpu_torch.models.motion_module."
                  "MotionModule.forward", lambda fn: lambda self, x, *a,
                  **k: x),
}


@pytest.mark.parametrize("fault", sorted(SAMPLER_FAULTS))
def test_sampler_faults_are_refused(monkeypatch, fault):
    import importlib

    path, make = SAMPLER_FAULTS[fault]
    mod_name, _, attr = path.rpartition(".")
    try:
        owner = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        mod_name, _, cls = mod_name.rpartition(".")
        owner = getattr(importlib.import_module(mod_name), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    cell = tiny_cell(I2V)
    out = run_cell(monkeypatch, cell)
    assert not verdict(cell, out), (fault, out["numbers"])


# ------------------------------------------------------------- the trainer


def test_trainer_run_is_correct(monkeypatch):
    cell = tiny_cell(TRAIN)
    out = run_cell(monkeypatch, cell)
    assert out["attempted"] >= 1
    assert set(out["numbers"]) == set(cell.own["limits"])
    assert max(out["numbers"].values()) < 1e-3, out["numbers"]
    assert verdict(cell, out)
    assert set(out["metrics"]) == {"train_frames_per_s", "setup_s"}


def test_trainer_control_is_refused():
    cell = tiny_cell(TRAIN)
    numbers = trainer.readings(cell, SEED, "control", "cpu")
    assert not checked_numbers(numbers, cell.own["limits"])[0], numbers


def _still_state(step):
    def run(state, batch, generator, **k):
        return state, {"loss": torch.zeros(()), "grad_norm": torch.zeros(())}
    return run


def _still_after_setup(step):
    """Sound through set-up, then a state left unchanged: a fault that
    shows only in the window."""
    def run(state, batch, generator, **k):
        if state.step >= 3:
            return state, {"loss": torch.zeros(()),
                           "grad_norm": torch.zeros(())}
        return step(state, batch, generator, **k)
    return run


def _half_batch(step):
    import dataclasses

    def run(state, batch, generator, **k):
        b = batch.latents.shape[0] // 2
        half = dataclasses.replace(
            batch, latents=batch.latents[:b], input_ids=batch.input_ids[:b],
            mask=batch.mask[:b], fps=batch.fps[:b],
            motion_score=batch.motion_score[:b])
        return step(state, half, generator, **k)
    return run


def _altered_grad(fn):
    def run(*a, **k):
        loss, grads = fn(*a, **k)
        name = sorted(grads)[0]
        grads[name] = grads[name] * 0.0
        return loss, grads
    return run


TRAIN_FAULTS = {
    # a step that returns its state unchanged
    "still_step": ("train_step_partitioned", _still_state),
    # the same, from the window's first step on
    "still_in_window": ("train_step_partitioned", _still_after_setup),
    # half of the batch left out, the mean taken over the rest
    "half_batch": ("train_step_partitioned", _half_batch),
    # an answer altered where it is produced: one leaf's gradient
    "altered_grad": ("partitioned_loss_and_grads", _altered_grad),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_trainer_faults_are_refused(monkeypatch, fault):
    from followyourclick_tpu_torch.training import step as step_mod

    attr, make = TRAIN_FAULTS[fault]
    monkeypatch.setattr(step_mod, attr, make(getattr(step_mod, attr)))
    cell = tiny_cell(TRAIN)
    out = run_cell(monkeypatch, cell)
    assert not verdict(cell, out), (fault, out["numbers"])


@pytest.mark.parametrize("fault", [None, "still_step"])
def test_the_result_line_says_what_the_check_found(monkeypatch, capsys,
                                                   fault):
    """``run.main`` end to end with the card's look skipped: the last line
    is the JSON result, ``checked`` its last key, and a fault under the
    timed path makes ``correct`` false."""
    import functools
    import importlib
    import json

    from h100bench import run
    from h100bench.harness import cell as cell_mod
    from h100bench.harness import device

    if fault:
        path, make = SAMPLER_FAULTS[fault]
        mod_name, _, attr = path.rpartition(".")
        owner = importlib.import_module(mod_name)
        monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    monkeypatch.setattr(cell_mod, "load_cell", lambda name: tiny_cell(name))
    monkeypatch.setattr(device, "require_cards", lambda n: None)
    monkeypatch.setattr(device, "power_limit", lambda: "n/a")
    monkeypatch.setattr(device, "device_record", lambda count, peak: {
        "platform": "cpu", "kind": "cpu", "count": count,
        "memory_peak_bytes": peak})
    monkeypatch.setattr(sampler, "run", functools.partial(sampler.run,
                                                          device="cpu"))
    with no_card(monkeypatch):
        rc = run.main(["--workload", I2V, "--seed", str(SEED),
                       "--seconds", "0", "--trace", "0"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    assert list(result)[0] == "correct" and list(result)[-1] == "checked"
    assert result["correct"] is (fault is None)
    assert set(result["metrics"]) == {"frames_per_s", "request_p90_s",
                                      "setup_s"}
