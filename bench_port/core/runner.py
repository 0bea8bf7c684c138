"""One run of one cell: set-up, the window (or the traced window), the
check against the plain reference, and the result line.

``run_cell`` is the whole run on a given device and returns the result;
``main`` is the command line, which asks for the cards first and prints
the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from bench_port.core import checks, guard, manifest


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def cache_dirs() -> Dict[str, str]:
    """The program's build and kernel caches, at fixed paths in the checkout."""
    base = os.path.join(manifest.BENCH_DIR, ".cache")
    return {
        "kernels": os.path.join(base, "kernels"),
        "TRITON_CACHE_DIR": os.path.join(base, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
    }


def _prepare_device(device: torch.device) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device.type != "cuda":
        return
    dirs = cache_dirs()
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[k] = dirs[k]
    from paddlebox_tpu_torch.ops import cuda_kernels
    from paddlebox_tpu_torch.utils import compilecache, native

    compilecache.enable(dirs["kernels"])
    cuda_kernels.build_all()
    native.load()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None, t_origin: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result (with the numbers
    compared under ``checks``, last). ``overrides`` replace keys of the
    configuration (``"config"``) and the mix (``"traffic"``), for runs at
    a small size; ``t_origin`` is the ``perf_counter`` time set-up counts
    from (the process's start by default)."""
    if t_origin is None:
        t_origin = time.perf_counter() - process_age_s()
    bench = manifest.load_benchmark()
    wl = manifest.workload(bench, name)
    cfg = {**manifest.config(bench, wl["config"]), **(overrides or {}).get("config", {})}
    mix = {**manifest.traffic(wl["traffic"]), **(overrides or {}).get("traffic", {})}
    limits = checks.load_limits(manifest.BENCH_DIR, name)
    dev = torch.device(device)
    _prepare_device(dev)
    loop = manifest.module("loops", mix["loop"])
    tmpdir = tempfile.mkdtemp(prefix="bench_port_")
    ctx = SimpleNamespace(
        name=name, cfg=cfg, mix=mix, seed=seed, device=dev, tmpdir=tmpdir, chips=wl["chips"],
        model_mod=manifest.module("models", cfg["model"]), ref_mod=manifest.module("reference", cfg["model"]),
    )
    try:
        run = loop.setup(ctx)
        setup_s = time.perf_counter() - t_origin
        try:
            if trace:
                reading = loop.traced(run)
                metrics = {}
                for m in manifest.metrics_for(bench, "per_layer", name):
                    v = manifest.reader(m["name"]).read(reading)
                    if v is not None:
                        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
                attempted, failed = reading.attempted, reading.failed
            else:
                values, attempted, failed = loop.window(run, seconds)
                values["setup_s"] = setup_s
                metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                           for m in manifest.metrics_for(bench, "end_to_end", name)}
            peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        finally:
            loop.release(run)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = loop.check(run)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    correct, shown = checks.judge(numbers, limits)
    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": wl["chips"],
        "memory_peak_bytes": peak,
    }
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = reading.trace.busy_s
        dev_info["window_s"] = reading.trace.window_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in reading.trace.device_ops()],
                               "idle_gaps": [[k, v] for k, v in reading.trace.idle_gaps]}
    result["setup_split_s"] = run.setup_split
    result["worst_leaves"] = numbers.get("worst_leaves")
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_origin = time.perf_counter() - process_age_s()
    chips = manifest.workload(manifest.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_origin=t_origin)
    bad = guard.forbidden_modules()
    if bad:
        print(f"bench_port: modules of the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    for n, v in result["checks"].items():
        print(f"check {n} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
