"""``train_loop`` over four ``gloo`` ranks (``tests/_torch_ranks.loop_runs``):
the tiny UNet of ``tests/test_torch_training_step.py``, one clip a rank,
a checkpoint every step. An uninterrupted run of two steps, a run of one
step, and a fresh state resumed from that one's checkpoint to step two;
then four steps with the temporal crop on (4 frames, ``min_frames`` 2):

- exactly one ``state.pt`` is written a checkpoint step, by rank 0;
- the resumed run equals the uninterrupted one bit for bit, on every rank;
- every rank cropped the same frame counts, and the crops varied;
- rank 0 alone printed the log lines and ran the validation hook.

The resume runs without the crop, as ``tests/test_torch_training_loop.py``
does: the crop's ``RandomState(1234 + start_step)`` is the JAX loop's, so a
resumed run crops anew.
"""

import os

import torch

from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.training import loop as tl
from tests import _torch_ranks
from tests.test_torch_data_parallel import (
    PARTITIONED,
    WORLD,
    global_batch,
    rank_job,
    torch_batch,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

STEPS = 2


def test_loop_over_ranks_checkpoints_once_and_resumes(tmp_path):
    job = rank_job(cfg=PARTITIONED, batch=torch_batch(global_batch()),
                   steps=STEPS, crop_steps=4, min_frames=2,
                   root=str(tmp_path))
    path = str(tmp_path / "job.pt")
    torch.save(job, path)
    results = dp.launch(_torch_ranks.loop_runs, WORLD, (path,),
                        timeout=240.0)
    assert not any(r["jax_loaded"] for r in results)
    # rank 0 writes each checkpoint once: steps 1, 2 of run 0, 1 of run 1,
    # 2 of the resumed run; the other ranks write none
    assert results[0]["writes"] == [1, 2, 1, 2]
    assert all(r["writes"] == [] for r in results[1:])
    for sub in ("a", "b"):
        manager = tl.make_checkpoint_manager(
            os.path.join(tmp_path, sub, "checkpoints"))
        assert manager.all_steps() == [1, 2]
        for step in (1, 2):
            assert os.listdir(os.path.join(manager.directory,
                                           str(step))) == [tl.STATE_FILE]
    # the crop run: the same frame counts on every rank, and not one count
    frames = results[0]["frames"]
    assert len(frames) == 4 and len(set(frames)) > 1, frames
    assert all(r["frames"] == frames for r in results)
    assert all(r["run3"]["step"] == 4 for r in results)
    check_equal_leaves(results, "run3")
    whole, resumed = "run0", "run2"
    for r in results:
        a, b = r[whole], r[resumed]
        assert a["step"] == b["step"] == STEPS
        assert a["count"] == b["count"] == STEPS
        for part in ("trainable", "frozen", "mu", "nu"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (r["rank"], part, n)
    check_equal_leaves(results, whole)
    assert "resumed from step 1" in results[0][resumed]["printed"]
    assert "step 2/2 loss=" in results[0][whole]["printed"]
    assert all(r[f"run{run}"]["printed"] == "" for r in results[1:]
               for run in range(4))
    assert results[0]["validated"] == [(0, 1), (1, 1), (3, 1)]
    assert all(r["validated"] == [] for r in results[1:])


def check_equal_leaves(results, run):
    """Every rank's state after ``run`` equals rank 0's bit for bit."""
    for r in results[1:]:
        for part in ("trainable", "frozen", "mu", "nu"):
            for n, t in results[0][run][part].items():
                assert torch.equal(t, r[run][part][n]), (r["rank"], part, n)
