"""Run one cell of the port's benchmark once and print its result.

    python h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Measures ``followyourclick_tpu_torch`` on the CUDA card(s) the cell asks
for, and nothing else; without them it exits with code 3 and prints no
result. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a traced part of the window. Either way the run
ends by judging what its window produced against the plain reference and
prints, last on standard error and last in the result's line, each number
compared beside its limit. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``busy_s`` and ``window_s`` with ``--trace 1``), ``breakdown`` (with
``--trace 1``) and ``checked``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# a library the port loads must not load JAX behind it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

EXIT_FORBIDDEN = 4


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def checked_numbers(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: every limited number is
    there, finite and at most its limit."""
    checked = {k: {"value": numbers.get(k, float("nan")), "limit": v}
               for k, v in limits.items()}
    ok = bool(limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values())
    return ok, checked


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)  # one client thread: steadier on a shared host

    from h100bench.harness import cell as cells
    from h100bench.harness import device as dev
    from h100bench.harness import importcheck, metrics

    cell = cells.load_cell(args.workload)
    dev.require_cards(cell.chips)
    out = cells.driver(cell).run(cell, args.seed, args.seconds,
                                 bool(args.trace), T_START)
    bad = importcheck.loaded_forbidden()
    if bad:
        print(f"h100bench: forbidden modules were loaded: {bad}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    limit = dev.power_limit()
    device = dev.device_record(cell.chips, out["peak"])
    device["power_limit"] = limit
    result = {"attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        rec = out["trace"].records(cell, out["window_peak"])
        result["metrics"] = metrics.read_all(cell, rec)
        device.update(busy_s=rec.busy_s, window_s=rec.window_s)
        result["breakdown"] = rec.breakdown()
    else:
        result["metrics"] = {m["name"]: {"value": float(out["metrics"][
            m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    result["device"] = device
    correct, checked = checked_numbers(out["numbers"],
                                       cell.own.get("limits", {}))
    print(f"h100bench: {cell.name} seed {args.seed}: {out['attempted']} "
          f"done in a {out['window_s']:.3f} s window on "
          f"{device['kind']} ({limit})", file=sys.stderr)
    if out.get("latencies"):
        print("h100bench: request seconds "
              + " ".join(f"{x:.4f}" for x in out["latencies"]),
              file=sys.stderr)
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = {"correct": correct, **result, "checked": checked}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
