"""See the package docstring of ``followyourclick_tpu_torch``."""
