"""The readings the limits of ``correct`` are set from, on the card at the
cell's own size; the benchmark's own runs never run this.

    python h100bench/control.py --workload <cell> --seeds 1,2,3 \
        --what program,control

``--what`` names readings of the cell's driver (its ``READINGS``):
``program`` is the program, sound, judged as a run of the cell judges it
(the lower readings); ``control`` the plain reference in float8 put in the
program's place (the upper readings); a training driver adds
``half_batch``, the float32 reference with half of the batch left out.

Prints one JSON line per seed and reading: ``{"seed", "what", "numbers",
"correct", "checked", "seconds"}``, where ``correct`` and ``checked`` are
the cell's own comparison of those numbers with its limits.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse

    import torch

    from h100bench.harness import cell as cells
    from h100bench.harness.device import require_cards
    from h100bench.run import checked_numbers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    drv = cells.driver(cell)
    whats = args.what.split(",")
    unknown = set(whats) - set(drv.READINGS)
    if unknown:
        raise SystemExit(f"{sorted(unknown)}: the driver reads "
                         f"{drv.READINGS}")
    require_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in whats:
            t0 = time.perf_counter()
            numbers = drv.readings(cell, seed, what, "cuda")
            torch.cuda.empty_cache()
            correct, checked = checked_numbers(numbers,
                                               cell.own["limits"])
            print(json.dumps({"seed": seed, "what": what,
                              "numbers": numbers, "correct": correct,
                              "checked": checked,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
