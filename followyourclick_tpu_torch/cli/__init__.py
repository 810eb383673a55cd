"""Command-line entry points: ``inference`` (click-to-video), ``animate``
(the prompt-YAML gallery sampler), ``click_mask`` (click → SAM masks) and
``inpaint`` (click → SD fill / replace)."""
