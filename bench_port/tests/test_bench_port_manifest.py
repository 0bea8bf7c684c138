"""Every entry of BENCHMARK.json resolves to its files, and the file
keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from bench_port.core import checks, manifest

BENCH = manifest.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    wl = manifest.workload(BENCH, cell)
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    cfg = manifest.config(BENCH, wl["config"])
    mix = manifest.traffic(wl["traffic"])
    assert manifest.module("loops", mix["loop"])
    assert manifest.module("models", cfg["model"]).build
    assert manifest.module("reference", cfg["model"]).forward
    limits = checks.load_limits(manifest.BENCH_DIR, cell)
    assert set(limits) <= set(checks.NUMBERS) | {"window_nonfinite_steps"}
    assert limits["window_nonfinite_steps"] == 0
    e2e = {m["name"] for m in manifest.metrics_for(BENCH, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2 and mix["rate_metric"] in e2e
    assert manifest.metrics_for(BENCH, "per_layer", cell)


def test_configs_resolve():
    for c in BENCH["configs"]:
        path = os.path.join(manifest.ROOT, c["file"])
        assert c["file"].startswith("bench_port/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_reader_matches_its_entry(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = manifest.reader(name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in moves or cell in moves["workloads"]


def test_every_reader_and_limits_file_has_its_entry():
    readers = {os.path.basename(p)[:-3] for p in os.listdir(os.path.join(manifest.BENCH_DIR, "metrics"))
               if p.endswith(".py")}
    assert readers == set(PER_LAYER)
    limits = {p[:-5] for p in os.listdir(os.path.join(manifest.BENCH_DIR, "limits"))}
    assert limits == set(CELLS)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
