"""The port's RAFT and GMA against the JAX package's, at published widths.

``RAFTConfig()`` (4 levels, radius 4, h = cxt = 128, 12 iterations; 5.26 M
parameters) and the same with ``use_gma``, fp32 on the CPU, on two pairs of
64x96 (the deepest correlation level 1x1). The JAX tree comes from flax's
``init``, its BN statistics and GMA's zero-initialised gate replaced by
seeded values so that both reach the flow, and crosses to the port by
``flow.convert.raft_state_from_jax``; the flows agree within 1e-4 px
(``FLOW_ATOL``), every iteration's upsampled flow too. The motion score
and ``inference_model`` (edge padding of a 60x90 clip to 64x96, the crop)
agree with the JAX API's; an mmflow-named state dict written to a ``.pth``
loads strictly into the port and, through the JAX converter, gives the JAX
model the same flow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.flow import api as japi
from followyourclick_tpu.flow.convert import convert_mmflow_raft
from followyourclick_tpu.flow.raft import RAFT as JRAFT
from followyourclick_tpu.flow.raft import RAFTConfig as JConfig
from followyourclick_tpu_torch.flow import api
from followyourclick_tpu_torch.flow.convert import (
    load_mmflow_raft_checkpoint,
    raft_state_from_jax,
)
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig
from followyourclick_tpu_torch.flow.registry import build_flow_estimator

# two fp32 RAFT runs of 12 GRU iterations that sum in another order
FLOW_ATOL = 1e-4
H, W = 64, 96


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_model(gma: bool):
    """(flax module, variables with seeded BN statistics and gate)."""
    model = JRAFT(JConfig(use_gma=gma))
    x = jnp.zeros((1, H, W, 3))
    variables = jax.jit(lambda k: model.init(k, x, x, iters=1))(
        jax.random.PRNGKey(int(gma)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rs = np.random.RandomState(11)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        if name == "var":
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "gamma":
            return np.full(leaf.shape, 0.7, np.float32)
        return leaf
    return model, jax.tree_util.tree_map_with_path(perturb, variables)


@functools.lru_cache(maxsize=None)
def jax_apply(gma: bool, iters: int, intermediate: bool):
    model, _ = jax_model(gma)
    return jax.jit(lambda v, a, b: model.apply(
        v, a, b, iters=iters, return_intermediate=intermediate))


def port_model(gma: bool, variables) -> RAFT:
    model = RAFT(RAFTConfig(use_gma=gma)).eval()
    model.load_state_dict(raft_state_from_jax(variables, model), strict=True)
    return model


def images(seed, n=2, h=H, w=W):
    rs = np.random.RandomState(seed)
    return (rs.rand(n + 1, h, w, 3) * 255).astype(np.uint8)


def normalised(frames):
    return ((frames.astype(np.float32) - 127.5) / 127.5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("gma", [False, True], ids=["RAFT", "GMA"])
def test_flow_matches_jax(gma):
    model, variables = jax_model(gma)
    x = normalised(images(0))
    want = np.asarray(jax_apply(gma, 12, False)(variables, x[:-1], x[1:]))
    got = port_model(gma, variables)(nchw(x[:-1]), nchw(x[1:]))
    got = np.moveaxis(got.detach().numpy(), 1, -1)
    assert got.shape == (2, H, W, 2)
    assert np.abs(want).max() > 1.0   # the flow is not trivially small
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)


@pytest.mark.parametrize("gma", [False, True], ids=["RAFT", "GMA"])
def test_every_iteration_matches_jax(gma):
    model, variables = jax_model(gma)
    x = normalised(images(1))
    want = np.asarray(jax_apply(gma, 4, True)(variables, x[:-1], x[1:]))
    got = port_model(gma, variables)(nchw(x[:-1]), nchw(x[1:]), iters=4,
                                     return_intermediate=True)
    assert got.shape == (4, 2, 2, H, W)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 2, -1),
                               want, rtol=0, atol=FLOW_ATOL)


def test_parameter_count_is_jax():
    for gma in (False, True):
        _, variables = jax_model(gma)
        n = sum(leaf.size for leaf in
                jax.tree_util.tree_leaves(variables["params"]))
        assert n == sum(p.numel() for p in
                        RAFT(RAFTConfig(use_gma=gma)).parameters())
    assert round(n / 1e6, 2) == 5.8 and sum(
        p.numel() for p in RAFT().parameters()) == 5_257_664


def test_motion_score_and_inference_match_jax():
    jmodel, variables = jax_model(False)
    model = port_model(False, variables)
    frames = images(2, n=3, h=60, w=90)
    want = japi.compute_motion_score(jmodel, variables, frames, iters=12)
    got = api.compute_motion_score(model, frames, iters=12)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = japi.inference_model(jmodel, variables, frames[0], frames[1],
                                iters=6)
    got = api.inference_model(model, frames[0], frames[1], iters=6)
    assert got.shape == (60, 90, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
    with pytest.raises(ValueError):
        api.compute_motion_score(model, frames[:1])


def test_mmflow_checkpoint_loads_as_the_jax_converter_reads_it(tmp_path):
    """A synthetic mmflow state dict (the port's names, seeded values, BN
    ``num_batches_tracked`` included) in ``{"state_dict": ...}``."""
    state = api.init_model(seed=3, device="cpu").state_dict()
    path = tmp_path / "raft_8x2_100k_flyingchairs_368x496.pth"
    torch.save({"meta": {"iter": 100000}, "state_dict": state}, path)
    model = load_mmflow_raft_checkpoint(str(path), RAFT().eval())
    jvars = convert_mmflow_raft(
        torch.load(path, weights_only=True)["state_dict"])
    # the JAX converter's tree crosses back to the same state dict
    back = raft_state_from_jax(jvars, model)
    for name, t in state.items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)
    x = normalised(images(4))
    want = np.asarray(jax_apply(False, 12, False)(jvars, x[:-1], x[1:]))
    got = model(nchw(x[:-1]), nchw(x[1:])).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=0,
                               atol=FLOW_ATOL)
    # init_model and the registry load it the same way
    other = api.init_model(checkpoint=str(path), device="cpu")
    for name, t in other.state_dict().items():
        torch.testing.assert_close(t, state[name], rtol=0, atol=0)


def test_checkpoint_load_is_strict(tmp_path):
    state = RAFT().state_dict()
    state.pop("decoder.mask_pred.predict_layer.bias")
    path = tmp_path / "partial.pth"
    torch.save({"state_dict": state}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_mmflow_raft_checkpoint(str(path), RAFT())


def test_seeded_init_and_registry():
    a = api.init_model(seed=5, device="cpu")
    b = build_flow_estimator({"type": "RAFT", "decoder": {"iters": 12}},
                             seed=5, device="cpu")
    for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(t, u, rtol=0, atol=0, msg=name)
    assert not a.training
    c = api.init_model(seed=6, device="cpu")
    assert not torch.equal(a.encoder.conv1.weight, c.encoder.conv1.weight)
    gma = build_flow_estimator({"type": "GMA", "decoder": {"heads": 1}},
                               device="cpu")
    assert gma.config.use_gma and hasattr(gma.decoder, "aggregator")
    with pytest.raises(KeyError, match="registered: \\['FlowNet2', .*"
                       "'PWCNet', 'RAFT'\\]"):
        build_flow_estimator({"type": "SpyNet"}, device="cpu")


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        api.init_model()


@pytest.mark.parametrize("gma", [False, True], ids=["RAFT", "GMA"])
def test_convolutions_see_contiguous_nchw(gma):
    """Every conv of a forward (eval and train, through the API's and the
    trainer's input paths) gets an NCHW-contiguous input: a channels-last
    one sends cuDNN's fp32 3x3 convs of the motion encoder to FFT tiling,
    which took 1.4 s of a 2.1-2.5 s motion score on the H100 (PR 16)."""
    from followyourclick_tpu_torch.flow import train

    model = api.init_model(RAFTConfig(use_gma=gma), seed=1, device="cpu")
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append(inp[0].is_contiguous()))
    frames = images(5, n=2, h=60, w=90)
    api.inference_model(model, frames[0], frames[1], iters=2)
    cfg = train.FlowTrainConfig(iters=2)
    tx = train.FlowOptimizer(cfg)
    frames = images(6, n=2).astype(np.float32)
    batch = {"img1": frames[:2], "img2": frames[1:],
             "flow_gt": np.zeros((2, H, W, 2), np.float32)}
    train.train_step(model, cfg, tx, tx.init(dict(model.named_parameters())),
                     batch)
    assert len(seen) > 100 and all(seen)
