"""The device time of named host spans, from a ``torch.profiler`` trace.

A kernel (or copy, or fill) belongs to a span when the host call that
launched it (a ``cuda_runtime`` or ``cuda_driver`` event of the same
``correlation``) starts inside a ``user_annotation`` of the span's name:
the port's spans enter the profiler as such annotations, and a backward
run in its own autograd node (``utils/trace.span_with_backward``) launches
its kernels inside its ``.bwd`` span. Device time is clipped to the
window mark, as ``core/trace.py`` clips it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench_port.core.trace import DEVICE_CATS, WINDOW_MARK, TraceReading, reduce_events

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profile(fn: Callable[[], None]) -> Tuple[TraceReading, List[dict]]:
    """``core/trace.traced``, keeping the trace's events: run ``fn`` under
    the profiler, CPU and CUDA, inside the window mark; (the reduction,
    the chrome-trace events)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_MARK):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="bench_port_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events), events


def span_device_s(events: List[dict], names: Sequence[str]) -> Dict[str, float]:
    """Seconds of device work inside the window launched under each span
    of ``names`` (0.0 for a name with no such work)."""
    mark = next(e for e in events if e.get("name") == WINDOW_MARK and e.get("cat") == "user_annotation")
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    spans = {n: np.asarray([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                            if e.get("cat") == "user_annotation" and e.get("name") == n], np.float64).reshape(-1, 2)
             for n in names}
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    out = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t is None or b <= a:
            continue
        for n, iv in spans.items():
            if np.any((iv[:, 0] <= t) & (t < iv[:, 1])):
                out[n] += (b - a) * 1e-6
    return out
