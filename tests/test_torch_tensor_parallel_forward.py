"""The UNet forward on a ``(data, model) = (2, 2)`` mesh: the port over four
``gloo`` ranks (``tests/_torch_tp_ranks.unet_forward``: the UNet sharded by
``parallel/sharding.shard_params``, each data rank on its clip) against the
JAX UNet forward jitted on ``create_mesh(data=2, model=2)`` with the
parameters placed by JAX's ``shard_params`` and the inputs on ``P("data")``
(as ``tests/test_sharding.py::test_tp_dp_forward_matches_single_device``),
and against the port's forward in one process.

The tiny two-level UNet of ``tests/test_torch_training_step.py`` (random
trees, fp32 on the CPU; 8 spatial heads and 4 motion heads, half of them
on each model rank), 2 clips of 4 frames
at 16² latents, the context at the CFG-doubled batch (the stem runs once
and the UNet duplicates at its first cross-attention). Tolerances, of the
largest output: the ranks against one process 1e-5 (fp32, each row-parallel
product summed from two partial products); against JAX's sharded forward
1e-4 (the two packages' fp32 ops differ; JAX's sharded and unsharded
forwards are held at the same order in ``tests/test_sharding.py``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.parallel.mesh import create_mesh
from followyourclick_tpu.parallel.sharding import shard_params
from followyourclick_tpu_torch.models.unet3d import UNetConditioning
from followyourclick_tpu_torch.parallel import data_parallel as dp
from tests import _torch_tp_ranks
from tests.test_torch_data_parallel import rank_job
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import B, F, HW, TEXT, models

GRID = (2, 2)
REL_PORT = 1e-5
REL_JAX = 1e-4


def inputs():
    rs = np.random.RandomState(7)
    return dict(
        sample=rs.randn(B, F, HW, HW, 9).astype(np.float32),
        t=np.array([500, 123], np.int64),
        context=rs.randn(2 * B, 77, TEXT.hidden_size).astype(np.float32),
        fps=np.array([8.0, 12.0], np.float32),
        motion_score=np.array([20.0, 35.0], np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tp_fwd"), "job.pt")
    job = rank_job(grid=GRID, cfg=True, **{
        k: torch.from_numpy(v) for k, v in inputs().items()})
    torch.save(job, path)
    out = dp.launch(_torch_tp_ranks.unet_forward, GRID[0] * GRID[1],
                    (path,), timeout=180.0)
    assert not any(r["jax_loaded"] for r in out)
    return out


def assembled(ranks):
    """The ranks' outputs as one ``[uncond; cond]`` batch of all clips."""
    halves = {}
    for r in ranks:
        u, c = r["out"].chunk(2)
        halves[r["data_rank"]] = (u, c)
    order = sorted(halves)
    return torch.cat([halves[d][0] for d in order]
                     + [halves[d][1] for d in order])


def one_process():
    unet = models()[4]
    nb = inputs()
    cond = UNetConditioning(context=torch.from_numpy(nb["context"]),
                            fps=torch.from_numpy(nb["fps"]),
                            motion_score=torch.from_numpy(nb["motion_score"]))
    with torch.no_grad():
        return unet(torch.from_numpy(nb["sample"]),
                    torch.from_numpy(nb["t"]), cond)


def jax_sharded():
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    junet, _, uparams, *_ = models()
    nb = inputs()
    mesh = create_mesh(data=GRID[0], model=GRID[1],
                       devices=jax.devices()[:GRID[0] * GRID[1]])
    data = NamedSharding(mesh, P("data"))
    with mesh:
        params = shard_params(uparams, mesh)
        put = functools.partial(jax.device_put, device=data)
        cond = JCond(context=put(jnp.asarray(nb["context"])),
                     fps=put(jnp.asarray(nb["fps"])),
                     motion_score=put(jnp.asarray(nb["motion_score"])))
        out = jax.jit(lambda p, s, t, c: junet.apply({"params": p}, s, t, c))(
            params, put(jnp.asarray(nb["sample"])),
            put(jnp.asarray(nb["t"], jnp.int32)), cond)
    return torch.from_numpy(np.array(out))


def test_ranks_sit_on_the_jax_grid(ranks):
    """Rank r at data index r // model, model index r % model."""
    for r in ranks:
        assert (r["data_rank"], r["model_rank"]) == divmod(r["rank"], GRID[1])


def test_tp_dp_forward_matches_jax_and_one_process(ranks):
    got = assembled(ranks)
    want = one_process()
    jx = jax_sharded()
    assert got.shape == want.shape == jx.shape == (2 * B, F, HW, HW, 4)
    scale = float(want.abs().max())
    port = float((got - want).abs().max())
    vs_jax = float((got - jx).abs().max())
    print(f"TP 2x2 vs one process {port:.3e}, vs JAX on the 2x2 mesh "
          f"{vs_jax:.3e} (largest output {scale:.3f})")
    assert port <= REL_PORT * scale
    assert vs_jax <= REL_JAX * scale


def test_gathered_parameters_are_the_full_ones(ranks):
    """``gather_params`` gives back every tensor as loaded, on every rank;
    a model rank holds half of each split leaf and the two halves differ."""
    unet = models()[4]
    own = {n: p.detach() for n, p in unet.named_parameters()}
    halves = 0
    for r in ranks:
        assert r["params"].keys() == own.keys()
        for n, t in own.items():
            assert torch.equal(r["params"][n], t), (r["rank"], n)
            local = r["local"][n]
            if local.shape != t.shape:
                halves += 1
                assert local.numel() * GRID[1] == t.numel(), n
    assert halves
    a, b = ranks[0]["local"], ranks[1]["local"]
    assert not torch.equal(a["down_blocks.0.attentions.0.transformer_blocks."
                             "0.attn1.to_q.weight"],
                           b["down_blocks.0.attentions.0.transformer_blocks."
                             "0.attn1.to_q.weight"])
