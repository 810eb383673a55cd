"""The partitioned train step on a ``(data, model) = (2, 2)`` mesh.

Four ``gloo`` ranks (``tests/_torch_tp_ranks.train_steps``): the tiny UNet
sharded over ``model`` by ``parallel/sharding.shard_params``, the state
(fp32 masters and moments) of each rank's slices, two clips a data rank of
the four-clip batch of ``tests/test_torch_data_parallel.py``, the draws
made from the JAX keys at the global shape and sliced by the data rank.
Against:

- JAX's ``train_step_partitioned`` jitted on ``create_mesh(data=2,
  model=2)`` with the parameters placed by JAX's ``shard_params`` (the
  state's leaves keep their specs) and the batch on ``P("data")``, as
  ``__graft_entry__.dryrun_multichip`` runs it;
- the port's step over the four clips in one process.

One step with the clip engaged and weight decay (no whole-call checkpoint:
the checkpointed steps over the mesh are held in
``tests/test_torch_tensor_parallel_loop.py``), at the data-parallel
tests' Adam eps (1e-5) and bound: loss and ``grad_norm`` within 1e-5
relative, every gathered leaf within ``steps · 1e-3 · lr``; the frozen
leaves unchanged bit for bit, and the two model ranks of a data row (and
the two data rows) gather the same state bit for bit.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from followyourclick_tpu.config import NoiseScheduleConfig
from followyourclick_tpu.parallel.mesh import create_mesh
from followyourclick_tpu.parallel.sharding import shard_params
from followyourclick_tpu.schedulers import ddim as jddim
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.training import step as ts
from tests import _torch_tp_ranks
from tests.test_torch_data_parallel import (
    PARTITIONED,
    as_state,
    check_metrics,
    global_batch,
    keys,
    one_process,
    rank_job,
    torch_batch,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import (
    check,
    jax_config,
    jax_draws,
    jts,
    models,
)

GRID = (2, 2)
STEPS = 1
# without the whole-call checkpoint, which triples JAX's compile on the
# mesh; the ranks' checkpointed steps are tests/test_torch_tensor_parallel_
# loop.py's
CFG = dataclasses.replace(PARTITIONED, gradient_checkpointing=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    nb = global_batch()
    path = os.path.join(tmp_path_factory.mktemp("tp_train"), "job.pt")
    torch.save(rank_job(grid=GRID, cfg=CFG, batch=torch_batch(nb),
                        draws=[jax_draws(k, nb["latents"].shape, CFG)
                               for k in keys(STEPS)], steps=STEPS), path)
    out = dp.launch(_torch_tp_ranks.train_steps, GRID[0] * GRID[1], (path,),
                    timeout=240.0)
    assert not any(r["jax_loaded"] for r in out)
    return out


def jax_tp(cfg, steps):
    """JAX's partitioned step on the 2 x 2 mesh, the UNet's leaves placed
    by ``shard_params``."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    junet, jtext, uparams, tparams, _, _ = models()
    mesh = create_mesh(data=GRID[0], model=GRID[1],
                       devices=jax.devices()[:GRID[0] * GRID[1]])
    data = NamedSharding(mesh, P("data"))
    batch = jts.TrainBatch(**{k: jax.device_put(jnp.asarray(v), data)
                              for k, v in global_batch().items()})
    sched = jddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    with mesh:
        state = jts.create_partitioned_train_state(
            shard_params(uparams, mesh), jax_config(cfg),
            frozen_dtype=jnp.float32)
        step = jax.jit(functools.partial(
            jts.train_step_partitioned, unet=junet, text_encoder=jtext,
            text_params=jax.device_put(tparams, NamedSharding(mesh, P())),
            sched=sched, cfg=jax_config(cfg)))
        metrics = []
        for key in keys(steps):
            state, m = step(state, batch, key)
            metrics.append({k: float(v) for k, v in m.items()})
    kernel = state.params["down_blocks_0"]["attentions_0"][
        "transformer_blocks_0"]["attn1"]["to_q"]["kernel"]
    assert kernel.sharding.spec == P(None, "model")
    return metrics, state


def test_tp_step_matches_jax_on_the_mesh_and_one_process(ranks):
    cfg = CFG
    first = ranks[0]
    for r in ranks[1:]:
        assert r["metrics"] == first["metrics"]
        for key in ("trainable", "frozen"):
            for n, t in first[key].items():
                assert torch.equal(t, r[key][n]), (r["rank"], key, n)
    unet = models()[4]
    own = {n: p.detach() for n, p in unet.named_parameters()}
    for n, t in first["frozen"].items():
        assert torch.equal(t, own[n]), ("frozen leaf moved", n)
    # the motion modules' q / k / v / out and GEGLU weights train split
    assert any("motion_modules" in n and n.endswith("to_q.weight")
               for n in first["split"] if n in first["lrs"])
    jm, jstate = jax_tp(cfg, STEPS)
    assert jm[0]["grad_norm"] > 100 * cfg.max_grad_norm   # clip engaged
    tm, tstate = one_process(cfg, STEPS, partitioned=True)
    merged = ts.merge_params(first["trainable"], first["frozen"])
    check_metrics(first["metrics"], tm, "TP ranks vs one process")
    worst_jax = check(jm, jstate, first["metrics"],
                      as_state(merged, first["lrs"]), unet, cfg, STEPS)
    bound = STEPS * 1e-3 * cfg.learning_rate
    worst = max(float((merged[n] - t).abs().max())
                for n, t in tstate.params.items())
    print(f"2x2 TP ranks vs one process: worst leaf {worst:.3g}; vs JAX on "
          f"the 2x2 mesh {worst_jax:.3g} (bound {bound:.3g})")
    assert worst <= bound
