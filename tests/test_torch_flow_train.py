"""The port's flow trainer against the JAX package's ``flow/train.py``.

- One ``train_step`` of RAFT at published widths (2 pairs of 64x96, 12
  iterations, the published schedule, whose first step is lr / 25 = 1.6e-5,
  the gradient clip engaged, raw [0, 255] pixels as the JAX trainer and the
  CLI feed them) from the same weights and BN statistics
  (``raft_state_from_jax``): loss and EPE within 1e-5 relative, every
  parameter within 1e-5, each of the context encoder's running statistics
  within 1e-5 relative L2. Adam's eps is 1e-5, as in the UNet trainer's parity tests
  (PR 13): at 1e-8 the first update divides gradients of 1e-9 (the stem
  conv biases in front of a norm) by their own size.
- The same step in fp64 as the reference for both packages: the port's
  BN statistics lie no farther from it than twice JAX's (or 1e-5); on
  normalised pixels its gradients no farther than twice JAX's (or 1e-4).
  There the packages part by more than a step can hide (5e-3 relative in
  the context encoder): flax's norms take the variance as E[x²] − E[x]²,
  which cancels in fp32 where a channel's mean is large against its
  spread, and the port's gradients are the ones within 1.6e-5 of fp64. On
  raw pixels both packages' first feature layers are ill-conditioned, up
  to 5.6e-3 from fp64 (``RAW_GRAD_REL``).
- The schedules equal optax's (OneCycle, step, multi-stage) at 0, in the
  warm-up, at its end and past the last step; the optimizer alone equals
  optax's ``adamw`` / Adam-L2 chain with and without the clip at eps 1e-8.
- A resumed run equals the uninterrupted one bit for bit on the CPU.
"""

import dataclasses
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from followyourclick_tpu.flow import losses as jlosses
from followyourclick_tpu.flow import train as jtrain
from followyourclick_tpu_torch.flow import train as ttrain
from followyourclick_tpu_torch.flow.convert import raft_state_from_jax
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig
from followyourclick_tpu_torch.training.step import global_norm
from tests.test_torch_raft import H, W, jax_model

STEP_ATOL = 1e-5
# val/EPE after one step, 32 iterations: the parameters part by up to
# STEP_ATOL, the flows of one forward by up to 1e-4 px
VAL_EPE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=2, h=H, w=W):
    rs = np.random.RandomState(seed)
    return {"img1": (rs.rand(b, h, w, 3) * 255).astype(np.float32),
            "img2": (rs.rand(b, h, w, 3) * 255).astype(np.float32),
            "flow_gt": (5 * rs.randn(b, h, w, 2)).astype(np.float32),
            "valid": (rs.rand(b, h, w) > 0.2).astype(np.float32)}


def test_train_step_matches_jax():
    jmodel, variables = jax_model(False)
    cfg = jtrain.FlowTrainConfig(eps=1e-5, iters=12)
    tcfg = ttrain.FlowTrainConfig(**dataclasses.asdict(cfg))
    batch = _batch(0)
    params = jax.tree_util.tree_map(np.copy, variables["params"])
    opt_state = jtrain.make_optimizer(cfg).init(params)
    new_vars, _, metrics = jtrain.train_step(
        jmodel, cfg, {"params": params,
                      "batch_stats": variables["batch_stats"]},
        opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = RAFT(RAFTConfig())
    model.load_state_dict(raft_state_from_jax(variables, model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = ttrain.FlowOptimizer(tcfg)
    state = tx.init(dict(model.named_parameters()))
    got = ttrain.train_step(model, tcfg, tx, state, batch)
    assert float(got["grad_norm"]) > tcfg.grad_clip_norm   # clipped
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["epe"]), float(metrics["epe"]),
                               rtol=1e-5)
    want = raft_state_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(new_vars)), model)
    stats = 0
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == int(before[name]) + ("context" in name)
        elif name.endswith(("running_mean", "running_var")):
            # relative L2 a tensor: JAX's variance is E[x²] − E[x]², 1.4e-5
            # from the port's in one channel (against fp64 in the next test)
            assert not torch.equal(t, before[name]), name
            assert float((t - want[name]).norm() / want[name].norm()) \
                <= STEP_ATOL, name
            stats += 1
        else:
            assert not torch.equal(t, before[name]), name
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=0, atol=STEP_ATOL, err_msg=name)
    assert stats == 2 * 15   # the context encoder's 15 BNs


def test_train_model_evaluates_as_jax(tmp_path):
    """``train_model`` with ``eval_every=1`` against JAX's (its
    ``evaluate_sharded`` on one device): the step's and the ``val/``
    metrics agree, and the evaluation reads the BN running statistics
    without moving them, so the model after it is JAX's variables after
    the step; every module goes back to train mode."""
    from jax.sharding import Mesh

    jmodel, variables = jax_model(False)
    cfg = jtrain.FlowTrainConfig(eps=1e-5, iters=12)
    tcfg = ttrain.FlowTrainConfig(**dataclasses.asdict(cfg))
    batch = _batch(0)
    rs = np.random.RandomState(7)
    samples = [types.SimpleNamespace(
        img1=(rs.rand(H, W, 3) * 255).astype(np.float32),
        img2=(rs.rand(H, W, 3) * 255).astype(np.float32),
        flow_gt=(5 * rs.randn(H, W, 2)).astype(np.float32),
        valid=(rs.rand(H, W) > 0.2).astype(np.float32)) for _ in range(2)]
    jlogs, tlogs = {}, {}
    new_vars = jtrain.train_model(
        jmodel, {"params": jax.tree_util.tree_map(np.copy,
                                                  variables["params"]),
                 "batch_stats": variables["batch_stats"]}, iter([batch]),
        cfg, work_dir=str(tmp_path / "jax"), max_steps=1, resume=False,
        log_fn=lambda step, m: jlogs.update(m), eval_dataset=samples,
        eval_every=1, eval_mesh=Mesh(np.array(jax.devices()[:1])[:, None],
                                     ("data", "model")))
    model = RAFT(RAFTConfig())
    model.load_state_dict(raft_state_from_jax(variables, model))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith("num_batches_tracked")}
    ttrain.train_model(model, iter([batch]), tcfg,
                       work_dir=str(tmp_path / "port"), max_steps=1,
                       resume=False, log_fn=lambda step, m: tlogs.update(m),
                       eval_dataset=samples, eval_every=1)
    assert set(tlogs) == set(jlogs) | {"time", "grad_norm"}
    for k in ("loss", "epe"):
        np.testing.assert_allclose(tlogs[k], jlogs[k], rtol=1e-5, err_msg=k)
    print(f"val/EPE {tlogs['val/EPE']!r} against JAX's {jlogs['val/EPE']!r}")
    np.testing.assert_allclose(tlogs["val/EPE"], jlogs["val/EPE"],
                               rtol=0, atol=VAL_EPE_ATOL)
    assert all(m.training for m in model.modules())
    want = raft_state_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(new_vars)), model)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == int(before[name]) + ("context" in name), name
        elif name.endswith(("running_mean", "running_var")):
            assert float((t - want[name]).norm() / want[name].norm()) \
                <= STEP_ATOL, name


class _Capture(ttrain.FlowOptimizer):
    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return super().update(grads, state, params)


# fp32 against fp64, relative L2 a tensor: the port's gradients and BN
# statistics lie no farther from fp64 than twice JAX's do, or than these
# floors (fp32 summation noise over the step)
GRAD_FLOOR = 1e-4
STATS_FLOOR = 1e-5
# on raw [0, 255] pixels the first feature layers' gradients are
# ill-conditioned in fp32 in both packages (the instance norm cancels a
# channel mean of ~127 against its spread): at worst 5.6e-3 from fp64 in
# the port and 2.7e-3 in JAX, in different tensors; bound them loosely
RAW_GRAD_REL = 1e-2
# a conv bias in front of a norm has gradient 0; what fp32 leaves there is
# bounded against the global gradient norm
STEM_BIASES = ("encoder.conv1.bias", "context.conv1.bias")


@functools.lru_cache(maxsize=None)
def _jax_grad():
    jmodel, variables = jax_model(False)

    def loss_fn(params, batch):
        outs, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch["img1"], batch["img2"], iters=12, train=True,
            return_intermediate=True, mutable=["batch_stats"])
        return jlosses.sequence_loss(outs, batch["flow_gt"], 0.8,
                                     batch["valid"], 400.0), mutated
    return jax.jit(jax.grad(loss_fn, has_aux=True))


def _rel(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("pixels", ["raw", "normalised"])
def test_train_step_matches_fp64_as_closely_as_jax(pixels):
    _, variables = jax_model(False)
    cfg = ttrain.FlowTrainConfig(eps=1e-5, iters=12)
    batch = _batch(0)
    if pixels == "normalised":
        for k in ("img1", "img2"):
            batch[k] = (batch[k] - 127.5) / 127.5
    grads, stats = {}, {}
    for dtype in (torch.float32, torch.float64):
        model = RAFT(RAFTConfig())
        model.load_state_dict(raft_state_from_jax(variables, model))
        model.to(dtype)
        tx = _Capture(cfg)
        ttrain.train_step(model, cfg, tx,
                          tx.init(dict(model.named_parameters())), batch)
        grads[dtype] = tx.grads
        stats[dtype] = {k: v for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}
    g, mutated = _jax_grad()(variables["params"],
                             {k: jnp.asarray(v) for k, v in batch.items()})
    jax_state = raft_state_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": g,
                                            "batch_stats": mutated[
                                                "batch_stats"]}),
        RAFT(RAFTConfig()))
    ref, port = grads[torch.float64], grads[torch.float32]
    norm = float(global_norm(ref.values()))
    worst = {"port": (0.0, ""), "jax": (0.0, "")}
    for name in ref:
        if name in STEM_BIASES:
            assert float(port[name].abs().max()) <= 1e-6 * norm, name
            continue
        mine, theirs = _rel(port[name], ref[name]), _rel(jax_state[name],
                                                         ref[name])
        worst["port"] = max(worst["port"], (mine, name))
        worst["jax"] = max(worst["jax"], (theirs, name))
        bound = RAW_GRAD_REL if pixels == "raw" else max(2 * theirs,
                                                          GRAD_FLOOR)
        assert mine <= bound, (name, mine, theirs)
    for name, ref_stat in stats[torch.float64].items():
        mine = _rel(stats[torch.float32][name], ref_stat)
        theirs = _rel(jax_state[name], ref_stat)
        worst["port stats"] = max(worst.get("port stats", (0.0, "")),
                                  (mine, name))
        worst["jax stats"] = max(worst.get("jax stats", (0.0, "")),
                                 (theirs, name))
        assert mine <= max(2 * theirs, STATS_FLOOR), (name, mine, theirs)
    print(f"{pixels} pixels, fp32 against fp64, worst relative L2: " +
          "; ".join(f"{k} {v:.3g} ({n})" for k, (v, n) in worst.items()))
    if pixels == "normalised":
        # flax's E[x^2] - E[x]^2 in the context encoder's BN
        assert worst["jax"][0] > 100 * worst["port"][0]


def _schedule_counts(cfg):
    warm = int(cfg.total_steps * cfg.pct_start)
    return sorted({0, 1, warm // 2, warm - 1, warm, warm + 1,
                   cfg.total_steps // 2, cfg.total_steps - 1,
                   cfg.total_steps, cfg.total_steps + 10})


@pytest.mark.parametrize("kw", [
    {}, dict(total_steps=1000, pct_start=0.1, lr=2.5e-4),
    dict(lr_policy="step", lr_milestones=(300, 400, 500), lr_gamma=0.5,
         total_steps=600, lr=1e-4)])
def test_schedules_equal_optax(kw):
    cfg = jtrain.FlowTrainConfig(**kw)
    want = jtrain.make_schedule(cfg)
    got = ttrain.make_schedule(ttrain.FlowTrainConfig(**kw))
    for count in _schedule_counts(cfg):
        assert np.float32(got(count)) == np.float32(
            want(jnp.asarray(count, jnp.int32))), count


def test_multistage_lr_equals_jax():
    args = ([1e-4, 5e-5], [0, 300], [[100, 200], [400, 500]], [0.5, 0.5])
    want = jtrain.multistage_lr(*args)
    got = ttrain.multistage_lr(*args)
    for count in (0, 99, 100, 250, 299, 300, 450, 500, 900):
        assert np.float32(got(count)) == np.float32(
            want(jnp.asarray(count, jnp.int32))), count
    with pytest.raises(ValueError):
        ttrain.multistage_lr([1e-4], [200], [[100]], [0.5])


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_optimizer_equals_optax(optimizer, clip):
    cfg = jtrain.FlowTrainConfig(optimizer=optimizer, grad_clip_norm=clip,
                                 total_steps=40, weight_decay=1e-2)
    rs = np.random.RandomState(1)
    params = {f"p{i}": rs.randn(*s).astype(np.float32)
              for i, s in enumerate([(3, 4), (7,), (2, 2, 3)])}
    tx = jtrain.make_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    port = ttrain.FlowOptimizer(ttrain.FlowTrainConfig(
        **dataclasses.asdict(cfg)))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = port.init(tparams)
    for step in range(4):
        grads = {k: (rs.randn(*v.shape) * (0.2 + step)).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in
                                     grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.update({k: torch.from_numpy(g) for k, g in grads.items()},
                    tstate, tparams)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{step} {k}")


def _small_model():
    from followyourclick_tpu_torch.flow.api import init_model

    return init_model(seed=2, device="cpu")


def test_resume_equals_uninterrupted(tmp_path):
    cfg = ttrain.FlowTrainConfig(iters=2, checkpoint_every=1, lr=1e-3)
    batches = [_batch(10 + i, b=1) for i in range(3)]
    whole = ttrain.train_model(_small_model(), iter(batches), cfg,
                               work_dir=str(tmp_path / "a"), max_steps=3)
    ttrain.train_model(_small_model(), iter(batches), cfg,
                       work_dir=str(tmp_path / "b"), max_steps=2)
    logs = []
    resumed = ttrain.train_model(_small_model(), iter(batches), cfg,
                                 work_dir=str(tmp_path / "b"), max_steps=3,
                                 log_fn=lambda s, m: logs.append((s, m)))
    assert [s for s, _ in logs] == [2] and logs[0][1]["time"] > 0
    for (name, t), u in zip(whole.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(t, u), name
    assert ttrain.find_latest_checkpoint(str(tmp_path / "b")).endswith(
        "iter_3.pth")
    assert ttrain.find_latest_checkpoint(str(tmp_path / "none")) is None


def test_config_reads_yaml_lists():
    cfg = ttrain.FlowTrainConfig(betas=[0.9, 0.99], lr_milestones=[5, 9])
    assert cfg.betas == (0.9, 0.99) and cfg.lr_milestones == (5, 9)
    with pytest.raises(ValueError):
        ttrain.FlowOptimizer(ttrain.FlowTrainConfig(optimizer="sgd"))


def test_mixed_training_batches_equal_jax(tmp_path):
    from followyourclick_tpu.flow import datasets as jdata
    from tests.test_torch_flow_data import write_chairs

    write_chairs(tmp_path / "a", 3, seed=0)
    write_chairs(tmp_path / "b", 2, seed=1)
    sets = [jdata.FlyingChairs(str(tmp_path / "a")),
            jdata.FlyingChairs(str(tmp_path / "b"))]
    from followyourclick_tpu_torch.flow import datasets as tdata

    tsets = [tdata.FlyingChairs(str(tmp_path / "a")),
             tdata.FlyingChairs(str(tmp_path / "b"))]
    want = jtrain.mixed_training_batches(sets, [0.6, 0.4], 3, (16, 20))
    got = ttrain.mixed_training_batches(tsets, [0.6, 0.4], 3, (16, 20))
    for w, g in itertools.islice(zip(want, got), 3):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
