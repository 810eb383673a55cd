"""Follow-Your-Click in PyTorch for NVIDIA Hopper (H100).

A port of ``followyourclick_tpu`` (JAX on TPU), which stays the reference.
The layout mirrors the JAX package: ``schedulers/``, ``models/``, ``ops/``,
``pipelines/``, ``utils/``. ``config.py`` holds the port's own copy of the
JAX package's configuration dataclasses, so the same YAML files load. The
hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/_build.py``). ``pipelines.animation.AnimationPipeline`` places its
models on the card unless the caller passes ``device="cpu"``; ``entry.py``
gives one CFG UNet3D step of the flagship configuration as a callable.

This package imports ``torch`` and never ``jax``, ``flax`` or any module of
``followyourclick_tpu``.
"""
