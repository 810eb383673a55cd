"""Follow-Your-Click in PyTorch for NVIDIA Hopper (H100).

A port of ``followyourclick_tpu`` (JAX on TPU), which stays the reference.
The layout mirrors the JAX package: ``schedulers/``, ``models/``, ``ops/``,
``pipelines/``, ``utils/``. Configuration is shared: ``config.py``
re-exports the dataclasses of ``followyourclick_tpu.config``, which import
no JAX. The hand-written CUDA kernels live in ``csrc/`` and are built at
first use (``ops/_build.py``).

This package imports ``torch`` and never ``jax`` or ``flax``.
"""
