"""The click front-end's compositions and CLIs against the JAX package's,
fp32 on the CPU.

Weights are shared: a tiny ``vit_t`` SAM (seeded, saved as an official-
named ``.pth``, which the JAX CLIs convert and the port's load as it is)
and the tiny SD inpaint pipeline of ``tests/test_torch_inpaint.py`` (one
JAX pipeline, 512² crops); the port's pipeline is handed JAX's initial
noise for each call's seed; the VAE is 8 wide here, and the replacement
runs at 128². Checked:

- ``fill_anything`` / ``replace_anything``: the same masks and scores
  (IoU 1e-5), outputs within 1 of uint8 (the pipeline's 1e-3 on [0, 1]
  truncated) and, for a fill, equal outside the mask;
- ``cli.click_mask`` and ``cli.inpaint fill``: the same file names and
  pixel-equal masks as the JAX CLIs (OpenCV writes the JAX files, PIL the
  port's; pixels are compared), fills within 1;
- the port's ``cli.inpaint fill`` files equal its own ``fill_anything``;
- ``cli.inpaint remove`` from a tiny LaMa checkpoint file (Lightning-shaped,
  ``tests/test_torch_lama.py``): the same file names, pixel-equal masks and
  removals within 1 of the JAX CLI's (whose LaMa is the JAX converter's of
  the same weights), each removal equal to the input outside its mask.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from followyourclick_tpu import config as jconfig
from followyourclick_tpu.cli import click_mask as jclick_cli
from followyourclick_tpu.cli import inpaint as jinpaint_cli
from followyourclick_tpu.inpaint import fill as jfill
from followyourclick_tpu.pipelines.inpaint import InpaintPipeline as JInpaint
from followyourclick_tpu.sam import SamPredictor as JPredictor
from followyourclick_tpu.sam.convert import convert_sam_state_dict
from followyourclick_tpu_torch import config as pconfig
from followyourclick_tpu_torch.cli import click_mask as click_cli
from followyourclick_tpu_torch.cli import inpaint as inpaint_cli
from followyourclick_tpu_torch.cli.inpaint import HashTokenizer
from followyourclick_tpu_torch.inpaint import fill
from followyourclick_tpu_torch.pipelines.inpaint import InpaintPipeline
from followyourclick_tpu_torch.sam import SamPredictor, sam_model_registry
from followyourclick_tpu_torch.sam.convert import sam_from_checkpoint
from tests.test_torch_inpaint import (
    jax_noise,
    port_inpaint,
    tiny_configs,
    tiny_trees,
)
from tests.test_torch_sam_modules import tiny_sam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

STEPS = 1
VAE_WIDTH = 8  # the 512² crops' VAE passes dominate the file's time
REPLACE_SIZE = 128
POINT = (60, 40)
PROMPT = "a teddy bear"


class JaxNoiseInpaint(InpaintPipeline):
    """The port's pipeline with the initial noise JAX draws for the seed."""

    def __call__(self, image, mask, prompt, negative_prompt="", steps=25,
                 guidance_scale=7.5, seed=0, noise=None):
        h, w = image.shape[:2]
        return super().__call__(image, mask, prompt, negative_prompt, steps,
                                guidance_scale, seed,
                                noise=jax_noise(seed, (1, h // 8, w // 8, 4)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("inpaint_cli")
    model, jmodel, _ = tiny_sam(seed=5)
    ckpt = root / "sam_vit_t.pth"
    torch.save(model.state_dict(), ckpt)
    jvars = convert_sam_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, depth=2)
    trees = tiny_trees(tiny_configs(jconfig, VAE_WIDTH), seed=7)
    tok = HashTokenizer()
    jpipe = JInpaint(tiny_configs(jconfig, VAE_WIDTH), trees["unet"],
                     trees["vae"], trees["text_encoder"], tokenizer=tok)
    pipe = port_inpaint(tiny_configs(pconfig, VAE_WIDTH), trees, tok)
    pipe.__class__ = JaxNoiseInpaint
    img = (np.random.RandomState(8).rand(72, 96, 3) * 255).astype(np.uint8)
    png = root / "scene.png"
    Image.fromarray(img).save(png)
    port_sam = sam_from_checkpoint(sam_model_registry["vit_t"], str(ckpt),
                                   "cpu")
    return dict(root=root, ckpt=ckpt, img=img, png=png, jpipe=jpipe,
                pipe=pipe, predictor=SamPredictor(port_sam, "cpu"),
                jpredictor=JPredictor(jmodel, jvars))


def close_images(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.fixture(scope="module")
def filled(setup):
    s = setup
    got = fill.fill_anything(s["img"], POINT, PROMPT, s["predictor"],
                             s["pipe"], seed=3, steps=STEPS)
    want = jfill.fill_anything(s["img"], POINT, PROMPT, s["jpredictor"],
                               s["jpipe"], seed=3, steps=STEPS)
    return got, want


def test_fill_anything(setup, filled):
    got, want = filled
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g["mask"], w["mask"])
        assert abs(g["score"] - w["score"]) <= 1e-5
        close_images(g["filled"], w["filled"])
        keep = g["mask"] == 0
        assert np.array_equal(g["filled"][keep], setup["img"][keep])


def test_replace_anything(setup):
    s = setup
    got = fill.replace_anything(s["img"], POINT, PROMPT, s["predictor"],
                                s["pipe"], seed=4, steps=STEPS,
                                target_size=REPLACE_SIZE)
    want = jfill.replace_anything(s["img"], POINT, PROMPT, s["jpredictor"],
                                  s["jpipe"], seed=4, steps=STEPS,
                                  target_size=REPLACE_SIZE)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g["mask"], w["mask"])
        close_images(g["replaced"], w["replaced"])


def read(path):
    return np.asarray(Image.open(path))


def test_click_mask_cli(setup):
    s = setup
    argv = ["--input_img", str(s["png"]), "--point_coords", *map(
        str, POINT), "--sam_model_type", "vit_t", "--sam_ckpt",
        str(s["ckpt"]), "--dilate_kernel_size", "9"]
    jclick_cli.main(argv + ["--output_dir", str(s["root"] / "jax_masks")])
    out = click_cli.main(argv + ["--output_dir", str(s["root"] / "masks"),
                                 "--device", "cpu"])
    jdir = s["root"] / "jax_masks" / "scene"
    assert sorted(os.listdir(out["out_dir"])) == sorted(os.listdir(jdir)) \
        == out["files"] == ["mask_0.png", "mask_1.png", "mask_2.png"]
    for name in out["files"]:
        got = read(os.path.join(out["out_dir"], name))
        assert got.dtype == np.uint8 and got.shape == s["img"].shape[:2]
        assert np.array_equal(got, read(jdir / name))


def test_inpaint_cli_fill(setup, filled, monkeypatch):
    s = setup
    monkeypatch.setattr(jinpaint_cli, "_build_sd_pipeline",
                        lambda args: s["jpipe"])
    monkeypatch.setattr(inpaint_cli, "build_sd_pipeline",
                        lambda args, cfg=None: s["pipe"])
    argv = ["fill", "--input_img", str(s["png"]), "--point_coords",
            *map(str, POINT), "--sam_model_type", "vit_t", "--sam_ckpt",
            str(s["ckpt"]), "--text_prompt", PROMPT, "--steps", str(STEPS),
            "--seed", "3"]
    jinpaint_cli.main(argv + ["--output_dir", str(s["root"] / "jax_fill")])
    out = inpaint_cli.main(argv + ["--output_dir", str(s["root"] / "fill"),
                                   "--device", "cpu"])
    jdir = s["root"] / "jax_fill" / "scene"
    assert sorted(os.listdir(out["out_dir"])) == sorted(os.listdir(jdir)) \
        == sorted(out["files"])
    own, _ = filled  # fill_anything on the same inputs
    for i, r in enumerate(own):
        mask = read(os.path.join(out["out_dir"], f"mask_{i}.png"))
        assert np.array_equal(mask, read(jdir / f"mask_{i}.png"))
        assert np.array_equal(mask, r["mask"])
        got = read(os.path.join(out["out_dir"], f"filled_with_mask_{i}.png"))
        close_images(got, read(jdir / f"filled_with_mask_{i}.png"))
        assert np.array_equal(got, r["filled"])
        assert out["scores"][i] == r["score"]


def test_inpaint_cli_remove(setup, monkeypatch):
    from followyourclick_tpu.inpaint import lama as jlama
    from tests.test_torch_lama import (
        jax_vars,
        lightning_file,
        port_model,
        tiny,
    )

    s = setup
    cfg, jcfg = tiny()
    gen = port_model(cfg, seed=5)
    ckpt = s["root"] / "best.ckpt"
    lightning_file(ckpt, gen)
    monkeypatch.setattr(jinpaint_cli, "_build_lama", lambda args: (
        jlama.LamaInpainter(jlama.FFCResNetGenerator(jcfg),
                            jax_vars(gen, jcfg))))
    argv = ["remove", "--input_img", str(s["png"]), "--point_coords",
            *map(str, POINT), "--sam_model_type", "vit_t", "--sam_ckpt",
            str(s["ckpt"]), "--lama_ckpt", str(ckpt)]
    jinpaint_cli.main(argv + ["--output_dir", str(s["root"] / "jax_remove")])
    out = inpaint_cli.main(argv + ["--output_dir", str(s["root"] / "remove"),
                                   "--device", "cpu"], lama_config=cfg)
    jdir = s["root"] / "jax_remove" / "scene"
    want = [f"{p}_{i}.png" for i in range(3)
            for p in ("mask", "inpainted_with_mask")]
    assert out["files"] == want
    assert sorted(os.listdir(out["out_dir"])) == sorted(os.listdir(jdir)) \
        == sorted(want)
    for i in range(3):
        mask = read(os.path.join(out["out_dir"], f"mask_{i}.png"))
        assert np.array_equal(mask, read(jdir / f"mask_{i}.png"))
        got = read(os.path.join(out["out_dir"], f"inpainted_with_mask_{i}.png"))
        close_images(got, read(jdir / f"inpainted_with_mask_{i}.png"))
        assert np.array_equal(got[mask == 0], s["img"][mask == 0])


def test_hash_tokenizer_is_stable_across_processes():
    """The stand-in's ids depend on the text alone (CRC-32), not on the
    interpreter's salted ``hash``."""
    import subprocess
    import sys

    code = ("from followyourclick_tpu_torch.cli.inpaint import "
            "HashTokenizer; print(HashTokenizer()(['a cat']).input_ids"
            "[0, :5].tolist())")
    runs = {subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, check=True,
                           env={**os.environ, "PYTHONHASHSEED": seed}
                           ).stdout for seed in ("1", "2")}
    assert len(runs) == 1
    assert runs.pop().strip() == str(
        HashTokenizer()(["a cat"]).input_ids[0, :5].tolist())
