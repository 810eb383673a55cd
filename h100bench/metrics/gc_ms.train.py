"""Host ms per training step inside Python's garbage collector: the
program's spans ``fyc.gc`` (one a collection, through the tracer's
``gc.callbacks`` hook), over the steps of the traced detail part; those
in the last step's span, still open as the profiler writes its trace, are
left out. The part's collections also walk the trace events that the
timeline part left in the heap (``harness/spans.py``)."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.host_ms_per_step(rec, "fyc.gc")
