"""The port's click-to-video CLI (``cli/inference.py``) and gallery CLI
(``cli/animate.py``) against the JAX package's, on one tiny directory.

A tiny SD directory (``chip_smoke.write_sd_directory``: UNet widths 32-64,
the tiny VAE and 2-layer CLIP, fp16 ``.safetensors``, a DDP-prefixed
motion-module ``.ckpt``, a synthetic ``merges.txt`` and the ``vocab.json``
derived from it, which the JAX CLI's ``transformers.CLIPTokenizer`` reads),
an inference-config YAML with those widths and a prompt YAML (2 steps,
seed 3). Both CLIs run on the CPU at 2 frames, 64²:

- a txt manifest of two rows without images (``test_torch_cli.py``: each
  first frame from the T2I pipeline, 50 steps, CFG 8);
- a csv manifest whose rows carry images, one with a mask in the
  ``<dir>_mask`` folder, one whose file does not exist (dropped)
  (``test_torch_cli_csv.py``).

Both CLIs must write the same GIF names, each of ``--L`` frames, and a
``config_snapshot.yaml`` with the same keys (the port's ``args`` add
``device``). The two PRNGs differ, so the port's videos are held to its
own ``__call__``: the videos the CLI hands to its GIF writer (captured by
``chip_smoke.captured_videos``; the CLI keeps none) equal, bit for bit,
the port's pipeline called by hand with the same seed (T2I first frame,
VAE encode, click mask, ``__call__``), and its GIFs read back equal the
same videos written by ``save_videos_grid``.
``tests/test_torch_cli_animate.py`` holds ``cli/animate.py`` the same
way. The JAX UNet's ``init`` runs as zeros in
its traced shapes (:func:`jax_quick_init`), since the eager init would take
most of the file's time and no JAX value is compared here.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_tokenizer import (  # noqa: F401 (fixture)
    _vocab,
    one_torch_thread,
)

UNET = dict(sample_size=8, cross_attention_dim=768, attention_head_dim=8,
            block_out_channels=[32, 64, 64, 64], layers_per_block=1,
            norm_num_groups=8,
            motion_module_kwargs={"num_attention_heads": 4},
            use_fps_condition=True,
            use_first_frame_mask_condition_concat=True)
VAE = dict(block_out_channels=[32, 64, 64, 64], layers_per_block=1,
           norm_num_groups=8, sample_size=64)
CLIP = dict(vocab_size=1000, hidden_size=768, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4)
L, H, W, STEPS, SEED = 2, 64, 64, 2, 3
PROMPTS = ["the cat on the road", "a car in the sun garden"]


def write_tiny_directory(root):
    """The tiny SD directory, motion module, inference config and prompt
    YAML under ``root``; returns their paths."""
    import yaml

    from followyourclick_tpu_torch.config import InferenceConfig

    cfg = InferenceConfig.from_dict({"unet": UNET, "vae": VAE,
                                     "clip_text": CLIP})
    sd = os.path.join(root, "sd15")
    _, mm = chip_smoke.write_sd_directory(sd, cfg, 0, "cpu")
    merges = [tuple(line.split()) for line in
              chip_smoke.synthetic_merges().splitlines()[1:]]
    with open(os.path.join(sd, "tokenizer", "vocab.json"), "w") as f:
        json.dump(_vocab(merges), f)
    inference = os.path.join(root, "inference.yaml")
    with open(inference, "w") as f:
        yaml.safe_dump({"unet_additional_kwargs": UNET, "vae": VAE,
                        "clip_text": CLIP}, f)
    prompts = os.path.join(root, "tiny.yaml")
    with open(prompts, "w") as f:
        yaml.safe_dump({"Tiny": {"motion_module": [mm], "steps": STEPS,
                                 "guidance_scale": 8.0, "seed": [SEED],
                                 "n_prompt": ["ugly"],
                                 "prompt": PROMPTS}}, f)
    return cfg, sd, inference, prompts


def cli_argv(sd, inference, prompts, manifest, out, *extra):
    return ["--pretrained_model_path", sd, "--inference_config", inference,
            "--config", prompts, "--file", manifest, "--output_path", out,
            "--L", str(L), "--H", str(H), "--W", str(W), *extra]


def jax_quick_init(monkeypatch):
    """No hub access for ``transformers``; the JAX UNet's ``init`` as zeros
    in its traced shapes (``test_torch_loaders_assembly``): the checkpoint
    covers every parameter but the motion modules' (which ``animate`` runs
    without a motion checkpoint and the comparison there is the port's
    own), and the eager init would take ~47 s of the file's time."""
    from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JU
    from tests.test_torch_loaders_assembly import _shaped_zeros_init

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(JU, "init", _shaped_zeros_init)


def run_both(tmp, manifest, monkeypatch, *extra):
    """Both CLIs on ``manifest`` (and ``extra`` flags); returns (JAX save
    dir, port result, the port's videos by GIF name as handed to its
    writer)."""
    from followyourclick_tpu.cli import inference as jcli
    from followyourclick_tpu_torch.cli import inference as tcli

    jax_quick_init(monkeypatch)
    cfg, sd, inference, prompts = tmp["files"]
    jout = os.path.join(tmp["root"], "jax_" + os.path.basename(manifest))
    jcli.main(cli_argv(sd, inference, prompts, manifest, jout, *extra))
    (jdir,) = os.listdir(jout)
    with chip_smoke.captured_videos() as videos:
        result = tcli.main(cli_argv(
            sd, inference, prompts, manifest,
            os.path.join(tmp["root"], "port_" + os.path.basename(manifest)),
            *extra, "--device", "cpu"))
    return os.path.join(jout, jdir), result, videos


def read_gif(path):
    import imageio

    return [np.asarray(f)[..., :3] for f in imageio.mimread(path)]


def check_same_outputs(jdir, result, videos):
    """The same GIF names, ``L`` frames each, the snapshot keys; the port's
    GIFs hold the videos it handed to its writer."""
    import yaml

    from followyourclick_tpu_torch.utils.video_io import save_videos_grid

    jfiles = sorted(f for f in os.listdir(jdir) if f.endswith(".gif"))
    tdir = result["savedir"]
    tfiles = sorted(f for f in os.listdir(tdir) if f.endswith(".gif"))
    assert jfiles == tfiles == sorted(result["files"]) == sorted(videos) \
        and jfiles
    for name in tfiles:
        assert len(read_gif(os.path.join(jdir, name))) == L
        frames = read_gif(os.path.join(tdir, name))
        assert len(frames) == L
        video = videos[name]
        assert video.shape == (1, L, H, W, 3)
        assert np.isfinite(video).all() and 0 <= video.min() <= video.max() \
            <= 1 and video.std() > 1e-3
        ref = os.path.join(tdir, "..", "ref_" + name)
        save_videos_grid(video, ref)
        for g, w in zip(frames, read_gif(ref)):
            np.testing.assert_array_equal(g, w)
    with open(os.path.join(jdir, "config_snapshot.yaml")) as f:
        jsnap = yaml.safe_load(f)
    with open(os.path.join(tdir, "config_snapshot.yaml")) as f:
        tsnap = yaml.safe_load(f)
    assert sorted(jsnap) == sorted(tsnap) == ["args", "models"]
    assert sorted(tsnap["args"]) == sorted(list(jsnap["args"]) + ["device"])
    assert tsnap["models"] == jsnap["models"]
    assert tsnap["args"]["device"] == "cpu"


def call_by_hand(tmp, item_prompts, images, masks, seeds):
    """The port's pipeline driven by hand as the CLI drives it for one
    request: assembly, the T2I first frame of each row without an image,
    the VAE encode, the click mask at latent size, ``__call__``."""
    from followyourclick_tpu_torch.cli.inference import (
        NEG_PROMPT,
        POS_PROMPT,
    )
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.text_to_image import (
        TextToImagePipeline,
    )
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )
    from followyourclick_tpu_torch.utils.video_io import (
        downsample_mask_to_latent,
        load_image_and_mask,
    )

    cfg, sd, _, prompts_yaml = tmp["files"]
    import yaml

    with open(prompts_yaml) as f:
        mc = yaml.safe_load(f)["Tiny"]
    pipe = assemble_pipeline_from_pretrained(
        sd, cfg, motion_module_path=mc["motion_module"][0], device="cpu")
    t2i = TextToImagePipeline(pipe.config, pipe.unet, pipe.vae,
                              pipe.text_encoder, tokenizer=pipe.tokenizer)
    imgs, lat_masks = [], []
    for prompt, image, mask, seed in zip(item_prompts, images, masks, seeds):
        if image:
            img, m = load_image_and_mask(image, mask, H, W)
        else:
            img = t2i(prompt + POS_PROMPT, negative_prompt=NEG_PROMPT,
                      height=H, width=W, steps=50, guidance_scale=8.0,
                      seed=seed)[0] * 2.0 - 1.0
            m = None
        imgs.append(img)
        lat_masks.append(m)
    first = pipe.encode_image(torch.from_numpy(np.stack(imgs)))
    mask = None
    if any(m is not None for m in lat_masks):
        mask = np.stack([downsample_mask_to_latent(
            m if m is not None else np.ones((H, W, 1), np.float32),
            H // 8, W // 8) for m in lat_masks])
    spec = SampleSpec(video_length=L, height=H, width=W,
                      num_inference_steps=STEPS, guidance_scale=8.0,
                      use_interpolate_noise=False)
    return pipe([p + POS_PROMPT for p in item_prompts],
                negative_prompt=["ugly"] * len(item_prompts), spec=spec,
                first_image_latents=first, mask=mask, fps=2.0,
                motion_score=4.0, seed=seeds[0])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    return {"root": root, "files": write_tiny_directory(root)}


def test_txt_manifest_without_images(tiny, monkeypatch):
    manifest = os.path.join(tiny["root"], "prompts.txt")
    with open(manifest, "w") as f:
        f.write(PROMPTS[0] + "\n\n" + PROMPTS[1] + "\n")
    jdir, result, videos = run_both(tiny, manifest, monkeypatch)
    check_same_outputs(jdir, result, videos)
    assert [n.split("-")[0] for n in result["files"]] == ["0", "2"]
    assert len(result["stats"]["t2i"]) == 2
    # the first row by hand (each row is its own request, seed 3)
    want = call_by_hand(tiny, PROMPTS[:1], [None], [None], [SEED])
    np.testing.assert_array_equal(videos[result["files"][0]], want)
