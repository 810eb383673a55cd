"""Command-line entry points: ``inference`` (click-to-video) and
``animate`` (the prompt-YAML gallery sampler)."""
