"""What a traced window hands the per-layer metrics' readers."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

from bench_port.core.peaks import BF16_FLOPS
from bench_port.core.trace import TraceReading


@dataclass
class LayerReading:
    trace: TraceReading
    steps: int  # training steps in the traced window
    chips: int
    flops_per_step: float  # the tower's forward and backward a step
    peak_flops: float
    width: int  # the table's fp32 columns
    u_distinct: List[int]  # distinct keys of each traced step, in order
    spans: List[dict]  # the port's host spans (chrome-trace events, us)
    attempted: int = 0
    failed: int = 0

    def span_s(self, name: str) -> float:
        return sum(e["dur"] for e in self.spans if e.get("name") == name and e.get("ph") == "X") * 1e-6

    def mfu_pct(self):
        """The tower's FLOPs of the traced steps over the window and the
        chips' bf16 peak."""
        if self.trace.window_s <= 0 or not self.steps:
            return None
        return self.flops_per_step * self.steps / self.trace.window_s / (self.peak_flops * self.chips) * 100.0

    def idle_pct(self):
        if self.trace.window_s <= 0:
            return None
        return (1.0 - self.trace.busy_s / self.trace.window_s) * 100.0


def export(profiler, tmpdir: str) -> List[dict]:
    """The port profiler's events, through its chrome-trace export."""
    path = os.path.join(tmpdir, "host_spans.json")
    profiler.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return events


def layer_reading(run, reading: TraceReading, spans: List[dict], steps: int, u_distinct: List[int]) -> LayerReading:
    cfg, mix = run.ctx.cfg, run.ctx.mix
    chips = run.ctx.chips
    return LayerReading(
        trace=reading, steps=steps, chips=chips,
        flops_per_step=float(run.ctx.ref_mod.tower_flops_per_sample(cfg)) * mix["batch"] * chips,
        peak_flops=BF16_FLOPS, width=cfg["embedx_dim"] + 5, u_distinct=list(u_distinct), spans=spans,
        attempted=steps, failed=run.nonfinite,
    )
