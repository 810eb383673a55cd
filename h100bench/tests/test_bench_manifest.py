"""``BENCHMARK.json`` against the benchmark's contract, every cell's files
found by name, and no import of JAX, flax or the JAX package anywhere the
benchmark runs (nor of the port in the reference)."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from h100bench.harness import importcheck, metrics
from h100bench.harness.cell import BENCH, MANIFEST, ROOT, driver, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads(MANIFEST.read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape(manifest):
    assert set(manifest) == KEYS
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])
            assert (ROOT / word).exists()
    assert len(MANIFEST.read_bytes()) <= 64 * 1024


def test_names_units_and_lines(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e and group not in ("end_to_end", "per_layer"):
                    assert _line(e[key]), (e["name"], key)
            if "layer" in e:
                assert _line(e["layer"])
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_exactly_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_per_layer_metric_moves_one_reported_metric(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        target = e2e[m["moves"]]
        # the harness reads a per-layer metric in the cells it names
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell]), (m["name"], cell)
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def test_every_cell_resolves_and_reports_enough(manifest):
    used = set()
    for w in manifest["workloads"]:
        cell = load_cell(w["name"], manifest)
        used.add(w["config"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        drv = driver(cell)
        assert callable(drv.run) and callable(drv.readings)
        assert "program" in drv.READINGS
        assert cell.own["limits"]
        for m in cell.per_layer:
            assert hasattr(metrics.load(m["name"]), "read")
    assert used == {c["name"] for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_no_file_imports_jax_or_the_jax_package():
    assert importcheck.static_violations(BENCH) == []


def test_the_check_compares_whole_top_level_names():
    assert importcheck.loaded_forbidden(
        ["followyourclick_tpu_torch.models", "jaxtyping", "flaxen",
         "torch"]) == []
    assert importcheck.loaded_forbidden(
        ["followyourclick_tpu.models", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "followyourclick_tpu.models", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run of each cell in a fresh interpreter leaves no
    forbidden module in ``sys.modules``."""
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(1)\n"
        "from h100bench.drivers import sampler, trainer\n"
        "from h100bench.harness import importcheck\n"
        "from h100bench.tests.tiny import tiny_cell, I2V, TRAIN\n"
        "for n in ('synchronize', 'reset_peak_memory_stats', "
        "'empty_cache'):\n"
        "    setattr(torch.cuda, n, lambda *a, **k: None)\n"
        "torch.cuda.max_memory_allocated = lambda *a, **k: 0\n"
        "sampler.run(tiny_cell(I2V, steps=1), 5, 0.0, False, "
        "time.perf_counter(), device='cpu')\n"
        "trainer.run(tiny_cell(TRAIN), 5, 0.0, False, time.perf_counter(), "
        "device='cpu')\n"
        "print(importcheck.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
