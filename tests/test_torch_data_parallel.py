"""Data parallelism over ranks: four ``gloo`` ranks against one process and
against the JAX step on a ``data=4`` mesh.

The tiny UNet and CLIP of ``tests/test_torch_training_step.py`` (random
trees, fp32 on the CPU) take two partitioned steps (the clip engaged,
weight decay, the whole-call checkpoint) over a global batch of four clips:

- in four ``gloo`` ranks started by ``parallel.data_parallel.launch``, one
  clip each (``tests/_torch_ranks.train_steps``, no JAX in the ranks), the
  draws made from the JAX keys at the global shape and sliced by rank;
  ranks 1-3 start from other weights, which the state's broadcast replaces;
- in this process over all four clips (``group=None``);
- in the JAX ``train_step_partitioned``, jitted on ``create_mesh(data=4,
  model=1)`` of conftest's virtual devices with the batch on ``P("data")``.

Tolerances as ``tests/test_torch_training_step.py``: loss and ``grad_norm``
within 1e-5 relative, every leaf within ``steps · UPDATE_TOL · lr`` (at
``adam_eps = 1e-5``: a gloo sum of four gradients and one process's batch
mean differ by ~1e-9). The four ranks hold the same leaves bit for bit, and
the frozen leaves are unchanged bit for bit. The full-tree step is in
``tests/test_torch_data_parallel_full_tree.py``, ``train_loop`` over ranks
in ``tests/test_torch_data_parallel_loop.py``.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import NoiseScheduleConfig
from followyourclick_tpu.parallel.mesh import create_mesh
from followyourclick_tpu.schedulers import ddim as jddim
from followyourclick_tpu_torch import config as tconfig
from followyourclick_tpu_torch.config import NoiseScheduleConfig as TSched
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.schedulers import ddim as tddim
from followyourclick_tpu_torch.training import step as ts
from tests import _torch_ranks
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import (
    EPS,
    LR,
    TEXT,
    UNET,
    check,
    jax_config,
    jax_draws,
    jts,
    models,
)

WORLD = 4
F, HW = 4, 16
STEPS = 2
PARTITIONED = ts.TrainConfig(learning_rate=LR, adam_eps=EPS,
                             max_grad_norm=1e-3, weight_decay=1e-2,
                             gradient_checkpointing=True)
FULL_TREE = ts.TrainConfig(learning_rate=LR, adam_eps=EPS, max_grad_norm=1e6,
                           gradient_checkpointing=False)


def global_batch(seed=0):
    """numpy fields of a batch of ``WORLD`` clips."""
    rs = np.random.RandomState(seed)
    return dict(
        latents=rs.randn(WORLD, F, HW, HW, 4).astype(np.float32),
        input_ids=rs.randint(0, TEXT.vocab_size, (WORLD, 77)),
        mask=(rs.rand(WORLD, HW, HW, 1) > 0.5).astype(np.float32),
        fps=np.array([8.0, 12.0, 16.0, 20.0], np.float32),
        motion_score=np.array([20.0, 35.0, 10.0, 25.0], np.float32))


def keys(steps):
    return [jax.random.PRNGKey(10 + i) for i in range(steps)]


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def port_config(cfg):
    """A JAX config dataclass as the port's class of the same name (the
    ranks unpickle the job without the JAX package)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: port_config(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})


def rank_job(**kw):
    """The tiny models as the ranks rebuild them."""
    _, _, _, _, unet, text = models()
    return dict(unet_config=port_config(UNET),
                text_config=port_config(TEXT), unet_state=unet.state_dict(),
                text_state=text.state_dict(), **kw)


def run_ranks(tmp_path, partitioned_steps, full_steps):
    """The four ranks' results (``tests/_torch_ranks.train_steps``)."""
    nb = global_batch()
    job = rank_job(cfg=PARTITIONED, full_cfg=FULL_TREE, batch=torch_batch(nb),
                   draws=[jax_draws(k, nb["latents"].shape, PARTITIONED)
                          for k in keys(max(partitioned_steps, full_steps))],
                   partitioned_steps=partitioned_steps, full_steps=full_steps)
    path = os.path.join(tmp_path, "job.pt")
    torch.save(job, path)
    results = dp.launch(_torch_ranks.train_steps, WORLD, (path,),
                        timeout=240.0)
    assert [r["rank"] for r in results] == list(range(WORLD))
    assert not any(r["jax_loaded"] for r in results)
    return results


def one_process(cfg, steps, partitioned):
    """The port's step over all ``WORLD`` clips in this process."""
    _, _, _, _, unet, text = models()
    nb = global_batch()
    batch = ts.TrainBatch(**torch_batch(nb))
    sched = tddim.DDIMSchedule.create(TSched(), 25)
    if partitioned:
        state = ts.create_partitioned_train_state(unet, cfg,
                                                  frozen_dtype=torch.float32)
        fn = ts.train_step_partitioned
    else:
        state = ts.create_train_state(unet, cfg)
        fn = ts.train_step
    metrics = []
    for key in keys(steps):
        state, m = fn(state, batch, None, unet=unet, text_encoder=text,
                      sched=sched, cfg=cfg,
                      draws=jax_draws(key, nb["latents"].shape, cfg))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def jax_on_mesh(cfg, steps, partitioned):
    """The JAX step jitted on a ``data=4`` mesh, the batch on
    ``P("data")``, the state replicated."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    junet, jtext, uparams, tparams, _, _ = models()
    jcfg = jax_config(cfg)
    mesh = create_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    data, replicated = NamedSharding(mesh, P("data")), NamedSharding(mesh,
                                                                     P())
    batch = jts.TrainBatch(**{k: jax.device_put(jnp.asarray(v), data)
                              for k, v in global_batch().items()})
    if partitioned:
        state = jts.create_partitioned_train_state(uparams, jcfg,
                                                   frozen_dtype=jnp.float32)
        fn = jts.train_step_partitioned
    else:
        state = jts.create_train_state(uparams, jcfg)
        fn = jts.train_step
    sched = jddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    with mesh:
        state = jax.device_put(state, replicated)
        step = jax.jit(functools.partial(
            fn, unet=junet, text_encoder=jtext,
            text_params=jax.device_put(tparams, replicated), sched=sched,
            cfg=jcfg))
        metrics = []
        for key in keys(steps):
            state, m = step(state, batch, key)
            metrics.append({k: float(v) for k, v in m.items()})
    assert batch.latents.sharding.spec == P("data")
    return metrics, state


def as_state(params, lrs):
    """A rank's leaves in the shape ``check`` reads."""
    return types.SimpleNamespace(params=params,
                                 tx=types.SimpleNamespace(lrs=lrs))


def check_ranks_equal(results, key_sets):
    """Every rank's leaves equal rank 0's bit for bit."""
    for r in results[1:]:
        for key in key_sets:
            for n, t in results[0][key].items():
                assert torch.equal(t, r[key][n]), (r["rank"], key, n)


def check_metrics(got, want, what):
    for a, b in zip(want, got):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k]), (what, k, a, b)


@pytest.fixture(scope="module")
def partitioned_ranks(tmp_path_factory):
    return run_ranks(str(tmp_path_factory.mktemp("dp")), STEPS, 0)


def test_ranks_start_from_rank_zero(partitioned_ranks):
    """Ranks 1-3 started from perturbed weights: the state's broadcast
    gives them rank 0's leaves, which are the module's own."""
    unet = models()[4]
    own = dict(unet.named_parameters())
    for n, t in partitioned_ranks[0]["start"].items():
        assert torch.equal(t, own[n].detach()), n
    check_ranks_equal(partitioned_ranks, ["start"])


def test_partitioned_ranks_equal_one_process_and_jax(partitioned_ranks):
    cfg = PARTITIONED
    check_ranks_equal(partitioned_ranks, ["trainable", "frozen"])
    ranks = partitioned_ranks[0]
    start = ranks["start"]
    for r in partitioned_ranks:
        assert r["metrics"] == ranks["metrics"]
        for n, t in r["frozen"].items():
            assert torch.equal(t, start[n]), ("frozen leaf moved", n)
    tm, tstate = one_process(cfg, STEPS, partitioned=True)
    jm, jstate = jax_on_mesh(cfg, STEPS, partitioned=True)
    assert jm[0]["grad_norm"] > 100 * cfg.max_grad_norm   # clip engaged
    unet = models()[4]
    merged = ts.merge_params(ranks["trainable"], ranks["frozen"])
    check_metrics(ranks["metrics"], tm, "ranks vs one process")
    worst_jax = check(jm, jstate, ranks["metrics"],
                      as_state(merged, ranks["lrs"]), unet, cfg, STEPS)
    check(jm, jstate, tm, tstate, unet, cfg, STEPS)
    bound = STEPS * 1e-3 * cfg.learning_rate
    worst = max(float((merged[n] - t).abs().max())
                for n, t in tstate.params.items())
    print(f"4 ranks vs one process: worst leaf {worst:.3g}; vs JAX on a "
          f"data=4 mesh {worst_jax:.3g} (bound {bound:.3g})")
    assert worst <= bound


def test_shard_rows_needs_a_divisible_batch():
    batch = ts.TrainBatch(**torch_batch(global_batch()))
    assert dp.shard_rows(batch, 1, 2).latents.shape[0] == 2
    torch.testing.assert_close(dp.shard_rows(batch, 3, 4).fps,
                               batch.fps[3:4], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        dp.shard_rows(batch, 0, 3)
    with pytest.raises(ValueError, match="does not divide"):
        dp.shard_rows(torch.zeros(5, 2), 0, 2)


def test_draws_are_the_global_batch_rows(monkeypatch):
    """A rank's ``draw_step`` over its rows, and ``encode_batch``'s
    posterior noise, equal its rows of one process's draws over the whole
    batch (the generator seeded alike); the rank is stood in for by
    ``group_rank_world``, so no process group is needed."""
    _, _, _, _, unet, _ = models()
    lat = torch.zeros(WORLD, F, HW, HW, 4)
    sched = tddim.DDIMSchedule.create(TSched(), 25)
    whole = ts.draw_step(lat, sched, PARTITIONED,
                         torch.Generator().manual_seed(4))
    vae = types.SimpleNamespace(encode=lambda x: (
        torch.zeros(x.shape[0], 2, 2, 4), torch.zeros(x.shape[0], 2, 2, 4)))
    video = torch.zeros(WORLD, F, 16, 16, 3)
    noise = ts.encode_batch(vae, video, torch.Generator().manual_seed(5))
    for rank in range(WORLD):
        monkeypatch.setattr(ts, "group_rank_world",
                            lambda group, rank=rank: (rank, WORLD))
        part = ts.draw_step(lat[rank:rank + 1], sched, PARTITIONED,
                            torch.Generator().manual_seed(4), group="ranks")
        for f in ("timesteps", "noise", "rate_index", "uniform"):
            assert torch.equal(getattr(part, f),
                               getattr(whole, f)[rank:rank + 1]), f
        got = ts.encode_batch(vae, video[rank:rank + 1],
                              torch.Generator().manual_seed(5),
                              group="ranks")
        assert torch.equal(got, noise[rank:rank + 1])
