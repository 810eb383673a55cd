"""Allocations per training step that the caching allocator could serve
only after freeing its cached blocks and trying again: the change of its
``num_alloc_retries`` (``torch.cuda.memory_stats``) over the traced detail
part, as the program's tracer counts it, over its steps."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.counter_per_step(rec, "num_alloc_retries")
