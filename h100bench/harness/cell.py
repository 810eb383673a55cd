"""A cell of ``BENCHMARK.json``, found by name: its configuration file, its
traffic file, its own file (limits and the traced window), the metrics it
reports, and the driver its traffic names (``drivers/<driver>.py``)."""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as it is run
    traffic: dict         # traffic/<traffic>.json
    own: dict             # workloads/<cell>.json: limits, traced window
    end_to_end: list      # the manifest's end-to-end metrics of the cell
    per_layer: list       # the manifest's per-layer metrics of the cell


def _reports(metric: dict, cell: str) -> bool:
    """A metric with ``workloads`` is reported in those cells, one without
    (an end-to-end metric such as ``setup_s``) in every cell."""
    return cell in metric.get("workloads", [cell])


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    m = manifest or load_manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    own_path = BENCH / "workloads" / f"{name}.json"
    own = json.loads(own_path.read_text()) if own_path.exists() else {}
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    per_layer = [x for x in m["per_layer"] if _reports(x, name)]
    return Cell(name, int(w["chips"]), config, traffic, own, e2e, per_layer)


def driver(cell: Cell):
    """The module ``h100bench/drivers/<driver>.py`` the cell's traffic
    names: ``run(cell, seed, seconds, traced, t_start, device)`` makes a
    run, ``readings(cell, seed, what, device)`` the readings ``READINGS``
    names, for the limits of ``correct``."""
    name = cell.traffic["driver"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise SystemExit(f"no driver {name!r}")
    return importlib.import_module(f"h100bench.drivers.{name}")
