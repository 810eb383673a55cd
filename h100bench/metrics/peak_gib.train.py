"""``peak_gib.sample``'s reading over the training window: what the state,
a step's activations and its gradients hold."""

from h100bench.harness.metrics import load

read = load("peak_gib.sample").read
