"""The port's configuration: the JAX package's dataclass tree, shared.

``followyourclick_tpu/config.py`` is plain Python (dataclasses, no JAX), so
the port reads the same ``InferenceConfig`` and YAML files rather than keep
a copy. This module is the one place the port imports it from.
"""

from followyourclick_tpu.config import (  # noqa: F401
    CLIPTextConfig,
    InferenceConfig,
    MotionModuleConfig,
    NoiseScheduleConfig,
    UNet3DConfig,
    VAEConfig,
)
