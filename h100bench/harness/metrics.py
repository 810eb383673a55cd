"""The per-layer metrics, each a module ``h100bench/metrics/<name>.py``
found by the metric's name in ``BENCHMARK.json``.

A metric module has ``read(records) -> float | None`` (None: nothing to
read in this cell, and the metric is left out of the line) and may have
``ranges(program) -> {key: context manager factory}``: the profiler ranges
it reads, opened around calls into the program for the traced window only.
Ranges of the same key are opened once, whichever metrics ask for them.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math

from h100bench.harness.cell import BENCH


def load(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def instrumented(cell, **program):
    """Every range the cell's per-layer metrics ask for, opened once."""
    wanted = {}
    for m in cell.per_layer:
        mod = load(m["name"])
        if hasattr(mod, "ranges"):
            for key, make in mod.ranges(program).items():
                wanted.setdefault(key, make)
    with contextlib.ExitStack() as stack:
        for make in wanted.values():
            stack.enter_context(make())
        yield


def read_all(cell, records) -> dict:
    """``{name: {"value", "unit"}}`` of every per-layer metric that found
    something to read."""
    out = {}
    for m in cell.per_layer:
        value = load(m["name"]).read(records)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"{m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
