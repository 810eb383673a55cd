"""The LaMa generator and its checkpoints: the port against the JAX package,
fp32 on the CPU.

The tiny configuration mirrors ``tests/test_lama_train.py``: ngf 8, 2
downsamples, 2 FFC blocks, at the released ratio 0.75 (so the blocks have a
global branch of 24 channels, and the local Fourier unit's quarter splits
evenly). Weights are shared: the port's seeded weights (BN running
statistics included) as an official-named state dict, which the JAX
converter turns into flax variables; or a JAX ``init`` carried over by
``lama_state_from_jax``. Checked:

- ``FourierUnit``, ``SpectralTransform`` (with and without the local
  Fourier unit, stride 1 and 2) and the whole generator, in eval mode and
  in train mode (output and the new BN running statistics, flax's update on
  the biased variance);
- ``lama_state_from_jax`` of a JAX init, and the round trip port → JAX
  converter → port, bit for bit;
- ``load_lama_checkpoint`` on a Lightning-shaped file (``state_dict`` with
  ``generator.`` and discriminator keys, plain metadata beside it) and on a
  bare ``model.*`` state dict; a file that holds a pickled object is
  refused, not unpickled;
- ``LamaInpainter`` at a size that is not a multiple of 8: uint8 for uint8.

Tolerance: 1e-4 absolute on unit-scale activations and [0, 1] outputs (the
FFTs and the convolutions sum in different orders); the inpainter's uint8
images may differ by 1 where a value sits on a truncation boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.inpaint import convert as jconvert
from followyourclick_tpu.inpaint import lama as jlama
from followyourclick_tpu_torch.inpaint import convert, lama
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TOL = 1e-4
TINY = dict(ngf=8, n_downsampling=2, n_blocks=2)


def tiny(**kw):
    """The tiny configuration in both packages."""
    return lama.LamaConfig(**TINY, **kw), jlama.LamaConfig(**TINY, **kw)


def port_model(cfg, seed=0):
    return lama.build_generator(cfg, "cpu", torch.Generator().manual_seed(
        seed))


def numpy_state(module):
    """Copies: JAX on the CPU may take a numpy array without copying it,
    and the port updates its tensors in place."""
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def jax_vars(model, jcfg):
    return jconvert.convert_lama_state_dict(numpy_state(model), jcfg)


def nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def sub_tree(model, fill):
    """flax variables of a submodule: ``fill(tree, sd, "m")`` over the
    submodule's state dict with an ``m.`` prefix."""
    sd = {"m." + k: v for k, v in numpy_state(model).items()}
    tree = jconvert._Tree()
    fill(tree, sd, "m")
    return {"params": tree.params, "batch_stats": tree.stats}


def seeded(module, seed):
    from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

    seeded_init_(module, torch.Generator().manual_seed(seed),
                 buffers=lama.BN_STATS)
    return module.eval()


def test_fourier_unit():
    fu = seeded(lama.FourierUnit(6, 6), 1)
    x = np.random.RandomState(0).randn(2, 6, 8, 10).astype(np.float32)
    variables = sub_tree(fu, lambda t, sd, s: (
        t.conv(sd, s + ".conv_layer", "conv"), t.bn(sd, s + ".bn", "bn")))
    want = jlama.FourierUnit(6).apply(variables, nhwc(x))
    with torch.no_grad():
        close(fu(torch.from_numpy(x)).permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("lfu,stride", [(False, 1), (True, 1), (False, 2),
                                        (True, 2)])
def test_spectral_transform(lfu, stride):
    st = seeded(lama.SpectralTransform(8, 16, stride, lfu), 2)
    x = np.random.RandomState(1).randn(2, 8, 16, 16).astype(np.float32)
    variables = sub_tree(st, jconvert._spectral)
    assert ("lfu" in variables["params"]) == lfu
    want = jlama.SpectralTransform(16, stride, lfu).apply(variables, nhwc(x))
    with torch.no_grad():
        close(st(torch.from_numpy(x)).permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("lfu", [False, True])
def test_generator_eval(lfu):
    cfg, jcfg = tiny(enable_lfu=lfu)
    model = port_model(cfg, seed=3)
    x = np.random.RandomState(2).rand(2, 4, 32, 48).astype(np.float32)
    want = jlama.FFCResNetGenerator(jcfg).apply(jax_vars(model, jcfg),
                                                nhwc(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    close(got.permute(0, 2, 3, 1), want)
    assert 0.0 < float(got.min()) and float(got.max()) < 1.0  # sigmoid


def test_generator_train_mode_updates_stats_as_flax():
    """Train-mode BN: the batch's statistics normalise, and the running
    ones move as flax's do (momentum 0.1 on the biased variance)."""
    cfg, jcfg = tiny()
    model = port_model(cfg, seed=4)
    variables = jax_vars(model, jcfg)
    x = np.random.RandomState(3).rand(2, 4, 32, 32).astype(np.float32)
    want, mutated = jlama.FFCResNetGenerator(jcfg).apply(
        variables, nhwc(x), train=True, mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    close(got.permute(0, 2, 3, 1), want)
    back = convert.lama_state_from_jax(
        {"params": variables["params"], "batch_stats":
         mutated["batch_stats"]}, cfg)
    state = model.state_dict()
    moved = 0
    for k, v in back.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=1e-5)
            moved += not torch.equal(v, torch.from_numpy(
                numpy_state(port_model(cfg, seed=4))[k]))
    assert moved > 0


def test_biased_running_variance():
    """flax's update: 0.9·r + 0.1·var(ddof=0), where torch's own takes the
    unbiased variance."""
    bn = lama.BatchNorm2d(3).train()
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 4, 4).astype(
        np.float32))
    bn(x)
    want = 0.9 + 0.1 * x.permute(1, 0, 2, 3).reshape(3, -1).var(
        dim=1, unbiased=False)
    torch.testing.assert_close(bn.running_var, want)
    assert int(bn.num_batches_tracked) == 1


def test_state_from_jax_init():
    cfg, jcfg = tiny()
    variables = jax.jit(jlama.FFCResNetGenerator(jcfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 4)))
    state = convert.lama_state_from_jax(variables, cfg)
    model = lama.build_generator(cfg, "cpu", state_dict=state)
    x = np.random.RandomState(5).rand(1, 4, 32, 40).astype(np.float32)
    want = jlama.FFCResNetGenerator(jcfg).apply(variables, nhwc(x))
    with torch.no_grad():
        close(model(torch.from_numpy(x)).permute(0, 2, 3, 1), want)


def test_state_round_trip_through_the_jax_converter():
    cfg, jcfg = tiny(enable_lfu=True)
    model = port_model(cfg, seed=6)
    back = convert.lama_state_from_jax(jax_vars(model, jcfg), cfg)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def lightning_file(path, model, extra=None):
    state = {"generator." + k: v for k, v in model.state_dict().items()}
    state["discriminator.model0.0.weight"] = torch.zeros(8, 3, 4, 4)
    state["loss_resnet_pl.impl.conv1.weight"] = torch.zeros(64, 3, 3, 3)
    ckpt = {"epoch": 3, "global_step": 1200, "pytorch-lightning_version":
            "1.2.9", "state_dict": state, "hparams_name": "kwargs",
            "optimizer_states": [], **(extra or {})}
    torch.save(ckpt, path)


def test_load_lightning_checkpoint(tmp_path):
    cfg, jcfg = tiny()
    model = port_model(cfg, seed=7)
    lightning_file(tmp_path / "best.ckpt", model)
    state = convert.load_lama_checkpoint(str(tmp_path / "best.ckpt"))
    assert sorted(state) == sorted(model.state_dict())
    loaded = lama.build_generator(cfg, "cpu", state_dict=state)
    # the JAX converter on the same file's tensors
    sd = torch.load(tmp_path / "best.ckpt", weights_only=True)["state_dict"]
    variables = jconvert.convert_lama_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    x = np.random.RandomState(7).rand(1, 4, 40, 32).astype(np.float32)
    want = jlama.FFCResNetGenerator(jcfg).apply(variables, nhwc(x))
    with torch.no_grad():
        close(loaded(torch.from_numpy(x)).permute(0, 2, 3, 1), want)
    # a bare state dict in ``model.*`` names
    torch.save(model.state_dict(), tmp_path / "bare.pth")
    bare = convert.load_lama_checkpoint(str(tmp_path / "bare.pth"))
    assert all(torch.equal(bare[k], v) for k, v in state.items())


class Hyper:
    """A class a pickle would have to run to load."""


def test_load_refuses_pickled_objects(tmp_path):
    cfg, _ = tiny()
    lightning_file(tmp_path / "best.ckpt", port_model(cfg),
                   {"hyper_parameters": Hyper()})
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert.load_lama_checkpoint(str(tmp_path / "best.ckpt"))


def test_strict_load_rejects_other_widths(tmp_path):
    cfg, _ = tiny()
    torch.save(port_model(cfg).state_dict(), tmp_path / "g.pth")
    with pytest.raises(RuntimeError):
        lama.build_generator(lama.LamaConfig(**{**TINY, "ngf": 16}), "cpu",
                             state_dict=convert.load_lama_checkpoint(
                                 str(tmp_path / "g.pth")))


def test_inpainter_matches_jax():
    cfg, jcfg = tiny()
    model = port_model(cfg, seed=8)
    rs = np.random.RandomState(8)
    img = (rs.rand(37, 53, 3) * 255).astype(np.uint8)
    mask = np.zeros((37, 53), np.uint8)
    mask[10:25, 12:40] = 255
    got = lama.LamaInpainter(model, "cpu")(img, mask)
    want = jlama.LamaInpainter(jlama.FFCResNetGenerator(jcfg),
                               jax_vars(model, jcfg))(img, mask)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == img.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    assert np.array_equal(got[mask == 0], img[mask == 0])
    assert not np.array_equal(got[mask > 0], img[mask > 0])


def test_inpainter_init_random():
    cfg, _ = tiny()
    a = lama.LamaInpainter.init_random(cfg, seed=1, device="cpu")
    b = lama.LamaInpainter.init_random(cfg, seed=1, device="cpu")
    c = lama.LamaInpainter.init_random(cfg, seed=2, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.1.ffc.convl2l.weight"],
                           sc["model.1.ffc.convl2l.weight"])
    assert not a.model.training
