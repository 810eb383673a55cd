"""``idle_share.sample``'s reading over the traced training steps."""

from h100bench.harness.metrics import load

read = load("idle_share.sample").read
