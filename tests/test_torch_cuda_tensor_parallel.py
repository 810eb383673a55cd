"""``chip_smoke.py``'s phase 24 over NCCL, one card a rank.

Two model ranks (``chip_smoke.tp_rank``), each on its own card: the
full-width UNet and VAE sharded over ``model``, one exact UNet evaluation
of 1 and of 2 clips at 16 f / 512², CFG, bf16, an exact 4-step request
and one partitioned train step at 448x256 x 16 f, each held by rank 0 to
the same work in one process (phase 4's gate, ``TP_SPREAD_RATIO``,
``TRAIN_LOSS_REL`` and ``TRAIN_GRAD_COS``), with the launches
``expected_launches`` gives. NCCL refuses two ranks on one card, so this
needs a machine with two cards and skips on fewer. The file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_cuda_tensor_parallel.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

RANKS = 2


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} NVIDIA cards: NCCL takes one card a "
                    "rank")


def test_full_width_tensor_parallel_over_nccl(cards):
    import chip_smoke
    from followyourclick_tpu_torch.ops import _build
    from followyourclick_tpu_torch.parallel.data_parallel import launch

    _build.load_library()  # one build before the ranks load it
    ranks = launch(chip_smoke.tp_rank, RANKS,
                   (0, 4, torch.cuda.get_device_name(0)), backend="nccl",
                   timeout=1800.0)
    paths = ranks[0]["paths"]
    assert all(r["paths"] == paths for r in ranks)
    assert paths["tensor_parallel_eval_1clip"]["fused_motion_block"] == 0
    assert paths["tensor_parallel_eval_1clip"]["temporal_attention"] == 40
    assert paths["tensor_parallel_eval_2clips"]["flash_attention"] == 4
    assert ranks[0]["train"]["cosine"] >= chip_smoke.TRAIN_GRAD_COS
