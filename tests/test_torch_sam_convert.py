"""SAM checkpoints and the single-call decoder: the port against the JAX
package, fp32 on the CPU.

- An official-named ``vit_t`` state dict (the port's seeded weights) saved
  as a ``.pth``: the JAX package converts it (``convert_sam_state_dict``),
  the port loads it as it is (``torch.load(weights_only=True)`` +
  ``load_state_dict(strict=True)``); both predict the same masks.
- The carry-over from JAX variables (``sam_state_from_jax``): a full tree
  maps back to the state dict it came from, bit for bit; a tree shaped by
  ``Sam.init`` (flax makes no mask-downscaling convs without a mask
  prompt) lacks exactly those, and predicts as JAX does on point prompts.
- The ``torch.export`` decoder saved to bytes and reloaded against the
  eager one (equal) and against the JAX ``build_decoder_fn``.

Tolerances: logits 1e-4 of their largest magnitude, IoU 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.sam import Sam as JSam
from followyourclick_tpu.sam import SamPredictor as JPredictor
from followyourclick_tpu.sam import sam_model_registry as jax_registry
from followyourclick_tpu.sam.convert import convert_sam_state_dict
from followyourclick_tpu.sam.export import build_decoder_fn as jbuild_decoder
from followyourclick_tpu_torch.sam import SamPredictor, sam_model_registry
from followyourclick_tpu_torch.sam.convert import (
    load_sam_checkpoint,
    sam_from_checkpoint,
    sam_state_from_jax,
)
from followyourclick_tpu_torch.sam.export import (
    build_decoder_fn,
    export_decoder,
    load_decoder,
)
from tests.test_torch_sam_modules import tiny_sam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_unet import random_tree

LOGIT_TOL = 1e-4
IOU_TOL = 1e-5


def close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model, jmodel, variables = tiny_sam(seed=3)
    path = tmp_path_factory.mktemp("sam") / "sam_vit_t.pth"
    torch.save(model.state_dict(), path)
    return path, model, jmodel, variables


def image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_official_pth_loads_as_it_is(checkpoint):
    path, model, jmodel, _ = checkpoint
    state = load_sam_checkpoint(str(path))
    assert set(state) == set(model.state_dict())
    assert "image_encoder.blocks.0.attn.qkv.weight" in state
    assert "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix" \
        in state
    loaded = sam_from_checkpoint(sam_model_registry["vit_t"], str(path),
                                 "cpu")
    for name, tensor in loaded.state_dict().items():
        assert torch.equal(tensor, model.state_dict()[name]), name
    # the JAX package converts the same file and predicts the same masks
    jvars = convert_sam_state_dict(
        {k: v.numpy() for k, v in state.items()}, depth=2)
    port, jpred = SamPredictor(loaded, "cpu"), JPredictor(jmodel, jvars)
    img = image(1, 72, 100)
    port.set_image(img)
    jpred.set_image(img)
    kw = dict(point_coords=np.array([[30.0, 40.0]]),
              point_labels=np.array([1]), return_logits=True)
    got, want = port.predict(**kw), jpred.predict(**kw)
    close(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=IOU_TOL)


def test_state_from_full_jax_tree_round_trips(checkpoint):
    _, model, _, variables = checkpoint
    state = sam_state_from_jax(variables["params"])
    want = model.state_dict()
    assert set(state) == set(want)
    for name, tensor in state.items():
        assert torch.equal(tensor, want[name]), name


def test_carry_over_from_jax_init_variables():
    """``Sam.init``'s tree (shapes by ``jax.eval_shape``, seeded values)."""
    cfg = jax_registry["vit_t"]
    jmodel = JSam(cfg)
    params = random_tree(jmodel.init,
                         jnp.zeros((1, cfg.img_size, cfg.img_size, 3)),
                         jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32),
                         seed=4)
    state = sam_state_from_jax(params)
    model = sam_from_checkpoint(sam_model_registry["vit_t"], None, "cpu")
    result = model.load_state_dict(state, strict=False)
    assert not result.unexpected_keys
    assert sorted(result.missing_keys) == sorted(
        k for k in model.state_dict()
        if k.startswith("prompt_encoder.mask_downscaling."))
    port = SamPredictor(model, "cpu")
    jpred = JPredictor(jmodel, {"params": params})
    img = image(2, 64, 96)
    port.set_image(img)
    jpred.set_image(img)
    for kw in (dict(point_coords=np.array([[10.0, 20.0], [60.0, 30.0]]),
                    point_labels=np.array([1, 0])),
               dict(box=np.array([4.0, 6.0, 50.0, 60.0]),
                    multimask_output=False)):
        got = port.predict(**kw, return_logits=True)
        want = jpred.predict(**kw, return_logits=True)
        close(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=IOU_TOL)


DECODER_CASES = {
    "one click": dict(points=1, mask=0.0, stability=False),
    "two clicks, mask input": dict(points=2, mask=1.0, stability=False),
    "one click, stability score": dict(points=1, mask=0.0, stability=True),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_matches_jax(checkpoint, case):
    _, model, jmodel, variables = checkpoint
    opts = DECODER_CASES[case]
    orig = (72, 100)
    rs = np.random.RandomState(5)
    emb = rs.randn(1, 8, 8, 256).astype(np.float32)
    coords = np.concatenate([rs.uniform(0, 90, (1, opts["points"], 2)),
                             np.zeros((1, 1, 2))], axis=1).astype(np.float32)
    labels = np.array([[1] * opts["points"] + [-1]], np.float32)
    mask_in = rs.randn(1, 32, 32, 1).astype(np.float32)
    has = np.full((1, 1, 1, 1), opts["mask"], np.float32)
    jfn = jbuild_decoder(jmodel, variables, orig,
                         use_stability_score=opts["stability"])
    want = jfn(jnp.asarray(emb), jnp.asarray(coords), jnp.asarray(labels),
               jnp.asarray(mask_in), jnp.asarray(has))
    fn = build_decoder_fn(model, orig, use_stability_score=opts["stability"])
    args = (torch.from_numpy(emb.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(coords), torch.from_numpy(labels),
            torch.from_numpy(mask_in.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(has))
    with torch.no_grad():
        got = fn(*args)
    assert tuple(got[0].shape) == (1, 1) + orig
    close(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=IOU_TOL)
    close(got[2].numpy(), want[2])


def test_exported_decoder_reloads_equal_to_eager(checkpoint):
    _, model, _, _ = checkpoint
    orig = (72, 100)
    blob = export_decoder(model, orig, num_points=2)
    assert isinstance(blob, bytes) and len(blob) > 0
    exported = load_decoder(blob)
    rs = np.random.RandomState(6)
    args = (torch.from_numpy(rs.randn(1, 256, 8, 8).astype(np.float32)),
            torch.tensor([[[30.0, 20.0], [0.0, 0.0]]]),
            torch.tensor([[1.0, -1.0]]),
            torch.from_numpy(rs.randn(1, 1, 32, 32).astype(np.float32)),
            torch.ones(1, 1, 1, 1))
    with torch.no_grad():
        want = build_decoder_fn(model, orig)(*args)
        got = exported(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
