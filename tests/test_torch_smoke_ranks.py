"""``chip_smoke.py``'s phase 23 rehearsed on the CPU (``torch.cuda``'s
events and memory statistics stubbed, as
``tests/test_torch_flow_cli.test_smoke_flow_phases_rehearse_on_the_cpu``):
phase 17 at the tiny config with its data-parallel run over a one-process
gloo group (``train_ranks``, which must equal the single-process state bit
for bit), and ``phase_ranks`` with RAFT at 64x96, a 128² loader clip and
the gloo dry run over 2 ranks (4 on the card's machine). The CPU counts no launch, so the hand counts are
zeroed."""

import time

import pytest
import torch

import chip_smoke
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


class _Event:
    def __init__(self, **kw):
        self.t = None

    def record(self, *a):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def stubbed_card(monkeypatch):
    for name, fn in (("Event", _Event), ("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(chip_smoke, "TRAIN_LAUNCHES", {})


def test_train_phase_with_ranks_rehearses(stubbed_card, capsys):
    paths = chip_smoke.phase_train(0, cfg=chip_smoke.tiny_config(),
                                   device="cpu", clip=(4, 64, 64))
    assert set(paths) == {"train", "train_ranks"}
    out = capsys.readouterr().out
    assert ("[train ranks] the data-parallel state equals the "
            "single-process one bit for bit: True") in out
    assert "world 1 over gloo" in out
    assert not torch.distributed.is_initialized()


def test_ranks_phase_rehearses(stubbed_card, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "LOADER_CLIP", (16, 128, 128))
    monkeypatch.setattr(chip_smoke, "LOADER_OUT", (64, 64))
    monkeypatch.setattr(chip_smoke, "DRYRUN_RANKS", 2)
    launches, rates = chip_smoke.phase_ranks(0, str(tmp_path), device="cpu",
                                             size=(64, 96))
    assert not any(launches.values())
    assert set(rates) == set(chip_smoke.LOADER_WORKERS)
    assert not torch.distributed.is_initialized()
