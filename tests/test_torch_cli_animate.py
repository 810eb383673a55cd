"""The port's gallery CLI (``cli/animate.py``) against the JAX package's,
on the tiny directory of ``tests/test_torch_cli.py``: the same file names
and, for each (prompt, seed) pair of the prompt YAML, the port's
``__call__`` video.
"""

import os

import numpy as np
import pytest

from tests.test_torch_cli import (
    CLIP,
    H,
    L,
    PROMPTS,
    SEED,
    STEPS,
    UNET,
    VAE,
    W,
    jax_quick_init,
    write_tiny_directory,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("animate"))
    return {"root": root, "files": write_tiny_directory(root)}


def test_animate_cli_matches_jax_names(tiny, monkeypatch):
    """``cli/animate.py`` on a UNet without the click-mask concat and
    without a motion-module checkpoint (its motion modules keep their
    zero-initialised outputs): the JAX names (one GIF a (prompt, seed)
    pair of the YAML, ``sample.gif``, ``config.yaml``), and each video
    equal to the port's ``__call__`` with the YAML's seed."""
    import yaml

    from followyourclick_tpu.cli import animate as janimate
    from followyourclick_tpu_torch.cli import animate as tanimate
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )

    jax_quick_init(monkeypatch)
    _, sd, _, _ = tiny["files"]
    root = tiny["root"]
    inference = os.path.join(root, "inference_plain.yaml")
    with open(inference, "w") as f:
        yaml.safe_dump({"unet_additional_kwargs": dict(
            UNET, use_first_frame_mask_condition_concat=False),
            "vae": VAE, "clip_text": CLIP}, f)
    prompts = os.path.join(root, "animate.yaml")
    with open(prompts, "w") as f:
        yaml.safe_dump({"Tiny": {"steps": STEPS, "guidance_scale": 8.0,
                                 "seed": [SEED, SEED + 1],
                                 "n_prompt": ["ugly"], "prompt": PROMPTS}},
                       f)
    argv = ["--pretrained_model_path", sd, "--inference_config", inference,
            "--config", prompts, "--L", str(L), "--H", str(H), "--W",
            str(W)]
    jout = os.path.join(root, "animate_jax")
    janimate.main(argv + ["--savedir", jout])
    result = tanimate.main(argv + ["--savedir", os.path.join(
        root, "animate_port"), "--device", "cpu"])
    (jdir,) = os.listdir(jout)
    names = sorted(os.listdir(result["savedir"]))
    assert sorted(os.listdir(os.path.join(jout, jdir))) == names
    assert "sample.gif" in names and "config.yaml" in names
    assert len(result["files"]) == 2
    pipe = assemble_pipeline_from_pretrained(
        sd, InferenceConfig.from_yaml(inference), device="cpu")
    spec = SampleSpec(video_length=L, height=H, width=W,
                      num_inference_steps=STEPS, guidance_scale=8.0)
    for name, prompt, seed in zip(result["files"], PROMPTS,
                                  (SEED, SEED + 1)):
        np.testing.assert_array_equal(
            result["videos"][name],
            pipe([prompt], negative_prompt=["ugly"], spec=spec, seed=seed))
