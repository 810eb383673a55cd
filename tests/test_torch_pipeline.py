"""The port's whole tiny sampler against the JAX pipeline, and the port's
independence from JAX.

The JAX ``AnimationPipeline._sample_jit`` and the port's
``AnimationPipeline.sample`` run the same request at the tiny configs
(4 frames, 64², 2 DDIM steps, CFG 8, the default exact ``SampleSpec``):
the same token ids, first-frame latent, click mask, fps and motion score,
the same random parameters (by ``load_jax_params``), and JAX's own initial
noise injected into the port, since the two PRNGs differ. fp32 on the CPU.
The video holds 1e-3 absolute: two UNet calls, the DDIM chain and a VAE
decode amplify the 5e-4 of one UNet call slightly, on outputs in [0, 1].
The same holds for a UNet without the click-mask concat
(``tests/test_torch_pipeline_without_concat.py``, a file of its own so that
the suite's workers share the time).
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import (
    SERVING_FIELDS,
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.schedulers.dispatch import SCHEDULERS
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import (
    TINY_CLIP,
    TINY_UNET,
    TINY_VAE,
    tiny_clip_tree,
    tiny_unet_tree,
    tiny_vae_tree,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CFG = InferenceConfig(unet=TINY_UNET, vae=TINY_VAE, clip_text=TINY_CLIP)
# the same UNet with a 4-channel conv_in: no mask or first-frame channels
NO_CONCAT = dataclasses.replace(CFG, unet=dataclasses.replace(
    TINY_UNET, use_first_frame_mask_condition_concat=False))
F, H, W, STEPS = 4, 64, 64, 2


def _request(seed, b=1):
    """A request of ``b`` clips, each with its own token ids, first-frame
    latent, click mask, fps and motion score."""
    rs = np.random.RandomState(seed)
    return dict(
        input_ids=rs.randint(0, 1000, size=(b, 77)),
        neg_input_ids=rs.randint(0, 1000, size=(b, 77)),
        first_image_latents=rs.randn(b, H // 8, W // 8, 4).astype(
            np.float32),
        mask=(rs.rand(b, H // 8, W // 8, 1) > 0.5).astype(np.float32),
        fps=np.array([8.0, 12.0][:b], np.float32),
        motion_score=np.array([20.0, 35.0][:b], np.float32))


def sample_both(spec_kw, b=1, seed=0, cfg=CFG):
    """One tiny request of ``b`` clips through the JAX ``_sample_jit`` and
    the port's ``sample`` (the JAX initial noise injected), as numpy. A
    UNet without the click-mask concat gets no first-frame latent and no
    mask (None on both sides)."""
    trees = dict(unet=tiny_unet_tree(cfg.unet), vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree())
    req = _request(seed, b)
    if not cfg.unet.use_first_frame_mask_condition_concat:
        req.update(first_image_latents=None, mask=None)
    key = jax.random.PRNGKey(7)

    def on(v, wrap):
        return None if v is None else wrap(np.asarray(v))

    jpipe = JPipeline(cfg, trees["unet"], trees["vae"],
                      trees["text_encoder"])
    want = np.asarray(jpipe._sample_jit(
        jpipe.params, jnp.asarray(req["input_ids"]),
        jnp.asarray(req["neg_input_ids"]), key, JSpec(**spec_kw),
        first_image_latents=on(req["first_image_latents"], jnp.asarray),
        mask=on(req["mask"], jnp.asarray), fps=jnp.asarray(req["fps"]),
        motion_score=jnp.asarray(req["motion_score"])))
    # _sample_jit draws its initial noise from the key itself (eta == 0)
    noise = np.asarray(jax.random.normal(key, (b, F, H // 8, W // 8, 4)))

    pipe = AnimationPipeline(
        cfg,
        unet=load_jax_params(UNet3DConditionModel(cfg.unet), trees["unet"]),
        vae=load_jax_params(AutoencoderKL(cfg.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(cfg.clip_text),
                                     trees["text_encoder"]), device="cpu")
    got = pipe.sample(**{k: on(v, torch.from_numpy) for k, v in req.items()},
                      spec=SampleSpec(**spec_kw),
                      noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (b, F, H, W, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    return got, want


EXACT = dict(video_length=F, height=H, width=W, num_inference_steps=STEPS,
             guidance_scale=8.0)


def test_tiny_sample_matches_jax():
    got, want = sample_both(EXACT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_tiny_two_clip_sample_matches_jax():
    """Two different clips in one request: the CFG rows [uncond clips; cond
    clips] against the frame-folded rows, the per-clip fps and motion score
    tiled to the doubled batch, and the CFG split, as the JAX sampler."""
    got, want = sample_both(EXACT, b=2)
    assert np.abs(got[0] - got[1]).mean() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_mask_concat_requires_the_first_frame_latent():
    """With the click-mask concat on, a request without a first-frame
    latent raises (the JAX sampler asserts it)."""
    pipe = AnimationPipeline(CFG, device="cpu")
    ids = torch.zeros(1, 77, dtype=torch.long)
    with pytest.raises(ValueError, match="first-frame latent"):
        pipe.sample(ids, ids, None, None, torch.tensor([8.0]),
                    torch.tensor([20.0]),
                    spec=SampleSpec(video_length=2, height=64, width=64,
                                    num_inference_steps=1))


@pytest.mark.parametrize("spec_kw,match", [
    (dict(scheduler="euler", pab_spatial_interval=2), "DDIM scan only"),
    (dict(scheduler="dpm++", cfg_cache_interval=3), "DDIM scan only"),
    (dict(pab_temporal_interval=2, video_scale=1.5), "plain CFG only"),
    (dict(scheduler="euler", eta=0.5), "eta is a DDIM knob"),
    (dict(scheduler="heun"), "unknown scheduler")],
    ids=["pab_euler", "cfg_cache_dpm++", "pab_video_scale", "eta_euler",
         "unknown_scheduler"])
def test_sample_rejects_specs_off_the_exact_path(spec_kw, match):
    """Every field is ported; what raises are the combinations the JAX
    sampler refuses (a serving approximation or eta on another solver than
    DDIM, PAB with the 3-term video_scale guidance) and an unknown
    scheduler, with the JAX messages. The same fields alone pass."""
    with pytest.raises(ValueError, match=match):
        SampleSpec(**spec_kw).check_ported()
    for field, value in spec_kw.items():
        if field != "scheduler" or value in SCHEDULERS:
            SampleSpec(**{field: value}).check_ported()


def test_sample_accepts_every_serving_field():
    off_default = dict(cfg_cache_interval=3, pab_spatial_interval=2,
                       pab_cross_interval=4, pab_temporal_interval=4,
                       deep_cache_interval=2, pab_warmup_steps=2,
                       cfg_final_exact_steps=1, cfg_cache_extrapolate=True,
                       deep_cache_extrapolate=True)
    assert sorted(off_default) == sorted(SERVING_FIELDS)
    for field, value in off_default.items():
        SampleSpec(**{field: value}).check_ported()
    SampleSpec(**off_default).check_ported()


def test_prepare_latents_interpolates_first_frame_noise():
    pipe = AnimationPipeline.__new__(AnimationPipeline)
    pipe.device, pipe.dtype = torch.device("cpu"), torch.float32
    spec = SampleSpec(video_length=3, height=16, width=16)
    g = torch.Generator().manual_seed(0)
    lat = pipe.prepare_latents(2, spec, generator=g)
    assert lat.shape == (2, 3, 2, 2, 4)
    torch.testing.assert_close(lat[:, 1], lat[:, 0])
    assert not torch.allclose(lat[0], lat[1])


def test_port_runs_without_jax():
    """In a fresh interpreter: import every module of the port, run its tiny
    sampler on the CPU, exact, under a serving schedule and on DPM-Solver++,
    and a camera-conditioned UNet with a merged motion LoRA; then the CLI
    path from checkpoint files (a tiny SD directory written by
    ``chip_smoke.write_sd_directory``, the loaders, the tokenizer, the T2I
    first frame, ``__call__``, the GIF) and the drift metrics, then two
    train steps through the training loop; then the click front-end: the
    click-mask CLI and a tiny ``inpaint fill`` (a ``vit_t`` SAM with
    seeded weights); and find no module of jax, flax, the JAX package,
    safetensors, transformers or cv2 loaded. jax, flax, the JAX package
    and cv2 are banned from the start (``sys.modules[name] = None``: an
    import of them raises)."""
    code = textwrap.dedent("""
        import importlib
        import pkgutil
        import sys
        for banned in ("jax", "flax", "followyourclick_tpu", "cv2"):
            sys.modules[banned] = None
        import torch
        import followyourclick_tpu_torch as port
        torch.set_num_threads(1)  # beside the suite's other workers
        names = [info.name for info in pkgutil.walk_packages(
            port.__path__, port.__name__ + ".")]
        assert len(names) > 20, names
        for name in names:
            importlib.import_module(name)
        from followyourclick_tpu_torch.config import (CLIPTextConfig,
            InferenceConfig, MotionModuleConfig, UNet3DConfig, VAEConfig)
        from followyourclick_tpu_torch.pipelines.animation import (
            AnimationPipeline, SampleSpec)
        from followyourclick_tpu_torch.pipelines.serving_schedules import (
            apply_schedule)
        torch.manual_seed(0)
        cfg = InferenceConfig(
            unet=UNet3DConfig(block_out_channels=(32, 64, 64, 64),
                              layers_per_block=1, norm_num_groups=8,
                              motion_module=MotionModuleConfig(
                                  num_attention_heads=4)),
            vae=VAEConfig(block_out_channels=(32, 32, 32, 32),
                          layers_per_block=1, norm_num_groups=8),
            clip_text=CLIPTextConfig(vocab_size=1000, intermediate_size=512,
                                     num_hidden_layers=1,
                                     num_attention_heads=4))
        pipe = AnimationPipeline(cfg, device="cpu")
        ids = torch.randint(0, 1000, (1, 77))
        exact = SampleSpec(video_length=2, height=64, width=64,
                           num_inference_steps=1)
        serving = apply_schedule(SampleSpec(
            video_length=2, height=64, width=64, num_inference_steps=4),
            "pab244_deep4_cfg4_ex")
        solver = SampleSpec(video_length=2, height=64, width=64,
                            num_inference_steps=3, scheduler="dpm++")
        for spec in (exact, serving, solver):
            video = pipe.sample(ids, ids, torch.randn(1, 8, 8, 4),
                                torch.ones(1, 8, 8, 1), torch.tensor([8.0]),
                                torch.tensor([20.0]), spec,
                                generator=torch.Generator().manual_seed(0))
            assert video.shape == (1, 2, 64, 64, 3), video.shape
            assert bool(torch.isfinite(video).all())
        # BASELINE config 4: the camera embedding and a merged motion LoRA
        import dataclasses
        from followyourclick_tpu_torch.models.motion_module import (
            TemporalAttention)
        from followyourclick_tpu_torch.utils.lora import merge_motion_lora
        cam = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_camera_motion_condition=True))
        pipe = AnimationPipeline(cam, device="cpu")
        lora = {}
        for name, m in pipe.unet.named_modules():
            if isinstance(m, TemporalAttention):
                base = name.replace(
                    ".transformer_blocks.",
                    ".temporal_transformer.transformer_blocks.")
                c = m.to_q.in_features
                for p in ("to_q", "to_k", "to_v", "to_out"):
                    key = base + ".processor." + p + "_lora"
                    lora[key + ".down.weight"] = torch.randn(4, c)
                    lora[key + ".up.weight"] = torch.randn(c, 4)
        merge_motion_lora(pipe.unet, lora)
        video = pipe.sample(ids, ids, torch.randn(1, 8, 8, 4),
                            torch.ones(1, 8, 8, 1), torch.tensor([8.0]),
                            torch.tensor([20.0]), exact,
                            generator=torch.Generator().manual_seed(0),
                            camera_motion_type=torch.tensor([4.0]))
        assert video.shape == (1, 2, 64, 64, 3), video.shape
        assert bool(torch.isfinite(video).all())
        # the CLI path from checkpoint files
        import os
        import tempfile
        import chip_smoke
        from followyourclick_tpu_torch.cli import inference as cli
        from followyourclick_tpu_torch.utils.quality import drift_metrics
        root = tempfile.mkdtemp()
        sd = os.path.join(root, "sd")
        _, mm = chip_smoke.write_sd_directory(sd, cfg, 0, "cpu")
        manifest = os.path.join(root, "prompts.txt")
        with open(manifest, "w") as f:
            f.write("the cat on the road\\n")
        args = cli.build_arg_parser().parse_args([
            "--pretrained_model_path", sd, "--config", "tiny.yaml",
            "--file", manifest, "--output_path", root, "--L", "2",
            "--H", "64", "--W", "64", "--device", "cpu"])
        with chip_smoke.captured_videos() as videos:
            result = cli.run(args, cfg, {"tiny": {"motion_module": [mm],
                                                  "steps": 1, "seed": [1]}},
                             cli.load_prompt_manifest(manifest))
        (name,) = result["files"]
        video = videos[name]
        assert video.shape == (1, 2, 64, 64, 3), video.shape
        assert os.path.exists(os.path.join(result["savedir"], name))
        assert drift_metrics(video, video)["rel_l2"] == 0.0
        # training: two partitioned steps through the loop, one checkpoint
        import itertools
        from followyourclick_tpu_torch.config import NoiseScheduleConfig
        from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
        from followyourclick_tpu_torch.training import loop
        from followyourclick_tpu_torch.training import step as ts
        tcfg = ts.TrainConfig()
        state = ts.create_partitioned_train_state(pipe.unet, tcfg)
        latents = ts.encode_batch(pipe.vae, torch.rand(1, 2, 64, 64, 3) * 2
                                  - 1, torch.Generator().manual_seed(0))
        batch = ts.TrainBatch(latents, ids, torch.ones(1, 8, 8, 1),
                              torch.tensor([8.0]), torch.tensor([20.0]))
        sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
        state = loop.train_loop(
            state, itertools.repeat(batch),
            lambda s, b, g: ts.train_step_partitioned(
                s, b, g, unet=pipe.unet, text_encoder=pipe.text_encoder,
                sched=sched, cfg=tcfg),
            loop.LoopConfig(output_dir=root, max_train_steps=2,
                            checkpointing_steps=2, log_every=1))
        assert state.step == 2
        # the click front-end: click -> masks, and a tiny SD fill
        import numpy as np
        from PIL import Image
        from followyourclick_tpu_torch.cli import click_mask
        from followyourclick_tpu_torch.cli import inpaint as inpaint_cli
        png = os.path.join(root, "scene.png")
        Image.fromarray((np.random.RandomState(0).rand(48, 64, 3) * 255
                         ).astype(np.uint8)).save(png)
        click = ["--input_img", png, "--point_coords", "30", "20",
                 "--output_dir", root, "--sam_model_type", "vit_t",
                 "--device", "cpu"]
        out = click_mask.main(click)
        assert out["files"] == ["mask_0.png", "mask_1.png", "mask_2.png"]
        out = inpaint_cli.main(["fill", *click, "--text_prompt", "a cat",
                                "--steps", "1"])
        assert len(out["files"]) == 6, out
        print("LOADED", sorted(m for m, mod in sys.modules.items()
                               if mod is not None and m.split(".")[0] in (
                                   "jax", "flax", "followyourclick_tpu",
                                   "safetensors", "transformers", "cv2")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
