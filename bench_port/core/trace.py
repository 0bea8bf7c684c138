"""Reduction of a ``torch.profiler`` trace of the traced window.

The window runs inside a ``record_function`` mark and ends in a
synchronize, so the mark's span is the traced window. The device's
operations (kernels, copies, fills) are clipped to it; their union is the
device's busy time, and the stretches between them are its idle gaps,
each named by the innermost host operation under way at its middle.
The trace is read from its chrome-trace export, whose event kinds
(``cat``) are the profiler's own.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

WINDOW_MARK = "bench_port.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


@dataclass
class TraceReading:
    window_s: float
    busy_s: float
    # device operation name -> (count, seconds inside the window)
    ops: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel(self, needle: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``needle``."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if needle in name:
                n, s = n + c, s + t
        return n, s

    def device_ops(self) -> List[Tuple[str, float]]:
        return sorted(((k, v[1]) for k, v in self.ops.items()), key=lambda x: -x[1])[:TOP]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals of ``iv`` [n, 2], sorted."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def reduce_events(events: List[dict]) -> TraceReading:
    marks = [e for e in events if e.get("name") == WINDOW_MARK and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"{len(marks)} window marks in the trace")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    iv, ops = [], {}
    for e in dev:
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        iv.append((a, b))
        c, s = ops.get(e["name"], (0, 0.0))
        ops[e["name"]] = (c + 1, s + (b - a) * 1e-6)
    merged = _union(np.asarray(iv, dtype=np.float64).reshape(-1, 2))
    busy = float(np.sum(merged[:, 1] - merged[:, 0])) * 1e-6
    edges = np.r_[w0, merged.reshape(-1), w1].reshape(-1, 2)  # [gap start, gap end]
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:TOP]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X" and e.get("name") != WINDOW_MARK]
    h_ts = np.asarray([float(e["ts"]) for e in host], dtype=np.float64)
    h_end = h_ts + np.asarray([float(e["dur"]) for e in host], dtype=np.float64)
    named = []
    for a, b in longest:
        mid = (a + b) / 2
        inside = np.nonzero((h_ts <= mid) & (h_end > mid))[0]
        name = "host: no traced operation"
        if len(inside):
            j = inside[np.argmin(h_end[inside] - h_ts[inside])]
            name = f"host: {host[j]['name']}"
        named.append((name, float(b - a) * 1e-6))
    return TraceReading(window_s=(w1 - w0) * 1e-6, busy_s=busy, ops=ops, idle_gaps=named)


def traced(fn: Callable[[], None]) -> TraceReading:
    """Run ``fn`` under the profiler, CPU and CUDA, inside the window
    mark, and reduce its trace."""
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
    return reduce_events(events)
