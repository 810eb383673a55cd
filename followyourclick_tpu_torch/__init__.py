"""Follow-Your-Click in PyTorch for NVIDIA Hopper (H100).

A port of ``followyourclick_tpu`` (JAX on TPU), which stays the reference.
The layout mirrors the JAX package: ``schedulers/``, ``models/``, ``ops/``,
``pipelines/``, ``utils/``, ``parallel/``, ``training/``, ``sam/`` and
``masking/`` (the click → mask front-end), ``inpaint/`` (SD fill and
replace) and ``cli/`` (the click-to-video CLI from checkpoint files:
``python -m followyourclick_tpu_torch.cli.inference``; ``cli.click_mask``,
``cli.inpaint``). ``config.py`` holds the port's
own copy of the JAX package's configuration dataclasses, so the same YAML
files load. The hand-written CUDA kernels (and the C++ CLIP tokenizer) live
in ``csrc/`` and are built at first use (``ops/_build.py``).
``pipelines.animation.AnimationPipeline`` places its models on the card
unless the caller passes ``device="cpu"``; ``entry.py`` gives one CFG
UNet3D step of the flagship configuration as a callable.

This package imports ``torch`` and never ``jax``, ``flax`` or any module of
``followyourclick_tpu``.
"""
