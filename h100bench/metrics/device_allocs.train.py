"""``cudaMalloc`` calls per training step: the change of the caching
allocator's ``num_device_alloc`` (``torch.cuda.memory_stats``) over the
traced detail part, as the program's tracer counts it, over its steps."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.counter_per_step(rec, "num_device_alloc")
