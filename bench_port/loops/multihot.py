"""Steady resident training over multi-hot slots: one pass, trained over
and over.

``loops/steady.py``'s set-up, window, warm-up and check, with the pass
made by ``core/multihot.py`` (each slot a fixed number of keys from its
own range) and checked against the reference's multi-hot step. The
traced window keeps its ``torch.profiler`` events and gives the device
time of the port's ``dlrm.cross``, ``seqpool`` spans and their backward
spans to the readers, with the program's ``pooled_keys`` counter over the
window beside the benchmark's own count of the traced steps' keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from bench_port.core import attribution, checks, multihot, program, traffic
from bench_port.loops import spans as span_io
from bench_port.loops.steady import (  # noqa: F401  (the loop's interface)
    CHECK_BATCHES,
    Split,
    _one_pass,
    _sync,
    batch,
    read_first_steps,
    release,
    window,
)

SPAN_NAMES = ("dlrm.cross", "dlrm.cross.bwd", "seqpool", "seqpool.bwd")


@dataclass
class MultiHotReading(span_io.LayerReading):
    span_device_s: Dict[str, float] = field(default_factory=dict)  # device seconds a span of SPAN_NAMES
    pooled_keys: Optional[int] = None  # the program's count over the window, None without the counter
    counted_keys: int = 0  # the traced steps' keys, counted by the benchmark
    batch: int = 0
    num_slots: int = 0
    pull_width: int = 0  # fp32 columns of a pulled record
    cross_dim: int = 0
    cross_rank: int = 0
    cross_layers: int = 0


def open_pass(ctx, split: Split):
    """``steady.open_pass`` over a multi-hot pass."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    N, B = cfg["records_per_pass"], mix["batch"]
    if N % B or N // B < max(CHECK_BATCHES) + 1:
        raise ValueError(f"a pass of {N} records is not a whole number of at least "
                         f"{max(CHECK_BATCHES) + 1} batches of {B}")
    data = multihot.make_pass(np.random.default_rng(ctx.seed), N, cfg, mix)
    split("data")
    files = multihot.write_pass(ctx.tmpdir, "pass0", data, cfg["multi_hot_sizes"], mix["files"])
    split("write")
    keys = traffic.distinct(data.keys, multihot.key_space(cfg))
    rows = program.init_rows(cfg, len(keys), ctx.seed, dev).cpu().numpy()
    table = program.host_table(cfg, ctx.seed, keys, rows)
    split("host_table")
    ds = program.dataset(cfg, mix, table, files, ctx.seed)
    ds.load_into_memory()
    if ds.store is None:
        raise RuntimeError("the pass did not load through the native parser")
    split("load")
    ds.begin_pass(round_to=512)
    split("begin_pass")
    weights = program.make_weights(ctx.ref_mod.param_shapes(cfg), cfg, ctx.seed, dev)
    tr = program.trainer(cfg, mix, ctx.model_mod, weights, dev)
    split("trainer")
    tr.prepare_pass(ds, n_batches=N // B)
    _sync(dev)
    split("prepare_pass")
    return SimpleNamespace(ctx=ctx, data=data, keys=keys, rows=rows, table=table, ds=ds, tr=tr,
                           weights=weights, steps=N // B, batch=B, nonfinite=0)


def setup(ctx):
    split = Split()
    run = open_pass(ctx, split)
    read_first_steps(run, split)
    for _ in range(ctx.mix["warm_calls"]):
        out = run.tr.train_pass(run.ds)
        _sync(ctx.device)
        if out["batches"] != run.steps:
            raise RuntimeError(f"a warm-up call ran {out['batches']} steps, not {run.steps}")
    split("warm_up")
    run.setup_split = split.s
    return run


def _pooled_keys() -> Optional[int]:
    """The program's ``pooled_keys`` counter, None where it has none."""
    from paddlebox_tpu_torch.train import resident_step

    return getattr(resident_step, "pooled_keys", None)


def traced(run):
    """``trace_calls`` whole passes under the profiler, with the port's
    host spans on."""
    from paddlebox_tpu_torch.utils.trace import PROFILER

    cfg, calls, B = run.ctx.cfg, run.ctx.mix["trace_calls"], run.batch
    keys0 = _pooled_keys()
    PROFILER.reset()
    PROFILER.enable()
    try:
        reading, events = attribution.profile(lambda: [_one_pass(run) for _ in range(calls)])
    finally:
        PROFILER.disable()
    keys1 = _pooled_keys()
    spans = span_io.export(PROFILER, run.ctx.tmpdir)
    blocks = [run.data.keys[i * B : (i + 1) * B] for i in range(run.steps)]
    base = span_io.layer_reading(run, reading, spans, steps=calls * run.steps,
                                 u_distinct=[len(np.unique(b)) for b in blocks] * calls)
    return MultiHotReading(
        **vars(base), span_device_s=attribution.span_device_s(events, SPAN_NAMES),
        pooled_keys=None if keys0 is None else keys1 - keys0,
        counted_keys=calls * sum(int(np.count_nonzero(b)) for b in blocks),
        batch=B, num_slots=cfg["num_slots"], pull_width=3 + cfg["embedx_dim"],
        cross_dim=(cfg["num_slots"] + 1) * cfg["embedx_dim"], cross_rank=cfg["cross_rank"],
        cross_layers=cfg["cross_layers"],
    )


def reference(run, **variant) -> dict:
    """The reference's multi-hot readings over the checked steps
    (``variant``: the control's ``linear`` or a planted fault's
    ``step_share`` or ``loss_share``)."""
    ctx = run.ctx
    rows0 = torch.from_numpy(run.check_rows).to(ctx.device)
    weights = {k: v.to(ctx.device) for k, v in run.weights.items()}
    return ctx.ref_mod.run_multihot_reference(ctx.ref_mod, ctx.cfg, run.check_keys, rows0, weights,
                                              [batch(run, i) for i in CHECK_BATCHES], **variant)


def check(run) -> dict:
    numbers = checks.compare(run.prog, reference(run))
    numbers["window_nonfinite_steps"] = float(run.nonfinite)
    return numbers
