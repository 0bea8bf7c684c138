"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration's file is
``configs/<name>.json`` (its ``model`` key names ``models/<model>.py``,
the port's model, and ``reference/<model>.py``, the plain reference); a
mix is ``traffic/<name>.json`` (its ``loop`` key names ``loops/<loop>.py``,
the window's loop); a per-layer metric is ``metrics/<name>.py``; a cell's
limits are ``limits/<cell>.json``. A new cell, mix, configuration or
metric is new files and entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{len(found)} {what} named {name!r} in BENCHMARK.json")
    return found[0]


def workload(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workloads")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, as a dict."""
    entry = _one(bench["configs"], name, "configs")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, kind: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def module(kind: str, name: str):
    """``bench_port.<kind>.<name>``: a loop, a port model or a reference."""
    return importlib.import_module(f"bench_port.{kind}.{name}")


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py`` (a metric's
    name may hold dots, so the file is loaded by its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
