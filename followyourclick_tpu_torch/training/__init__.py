"""Training: the v-prediction step and the loop (``step.py``,
``loop.py``). The step module is not named ``train_step``, so the
re-exported function does not shadow it."""

from followyourclick_tpu_torch.training.step import (  # noqa: F401
    TrainConfig,
    create_train_state,
    train_step,
    trainable_mask,
)
