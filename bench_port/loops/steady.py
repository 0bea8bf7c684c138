"""Steady resident training: one pass, trained over and over.

Set-up makes the pass from the seed (records, the host table's rows of
its keys, the dense weights), loads it through the port's native loader,
opens it (``begin_pass``, ``prepare_pass``: the resident upload), drives
the trainer through its first steps and reads them, and warms up with the
window's own call. The window repeats ``train_pass`` over the whole pass
(the resident feed, ``resident_scan_batches`` steps a dispatch) until
``--seconds`` have passed, and ends in a synchronize: its rate is every
sample of every step it ran over its seconds. No pass boundary falls in
the window.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_port.core import checks, program, traffic
from bench_port.core.trace import traced as trace_window
from bench_port.reference.common import run_reference

CHECK_BATCHES = (0, 0, 1)  # the first steps' batches: train_pass(1 batch), then train_pass(2)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Split:
    """Seconds of each set-up stage, in order."""

    def __init__(self):
        self.s, self._t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + t - self._t
        self._t = t


def open_pass(ctx, split: Split):
    """The pass of ``ctx.seed``, loaded and begun on the port, and the
    benchmark's own copy of what it made: (run namespace)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    N, B = cfg["records_per_pass"], mix["batch"]
    if N % B or N // B < max(CHECK_BATCHES) + 1:
        raise ValueError(f"a pass of {N} records is not a whole number of at least "
                         f"{max(CHECK_BATCHES) + 1} batches of {B}")
    data = traffic.make_pass(np.random.default_rng(ctx.seed), N, cfg["num_slots"], cfg["dense_dim"],
                             cfg["key_space"], mix)
    split("data")
    files = traffic.write_pass(ctx.tmpdir, "pass0", data, mix["files"])
    split("write")
    keys = traffic.distinct(data.keys, cfg["key_space"])
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


def batch(run, i: int) -> dict:
    B, d = run.batch, run.data
    sl = slice(i * B, (i + 1) * B)
    return {"keys": d.keys[sl], "labels": d.labels[sl], "dense": None if d.dense is None else d.dense[sl]}


def read_first_steps(run, split: Split) -> None:
    """The program's first steps, read for the check."""
    B = run.batch
    run.check_keys = np.unique(run.data.keys[: (max(CHECK_BATCHES) + 1) * B])
    run.check_rows = run.rows[np.searchsorted(run.keys, run.check_keys)]
    rows0 = torch.from_numpy(run.check_rows).to(run.ctx.device)
    run.prog = program.first_steps(run.tr, run.ds, run.ctx.cfg, run.check_keys, rows0, run.weights,
                                   later=len(CHECK_BATCHES) - 1)
    run.weights = {k: v.cpu() for k, v in run.weights.items()}
    split("first_steps")


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


def _one_pass(run) -> None:
    out = run.tr.train_pass(run.ds)
    if out["batches"] != run.steps:
        raise RuntimeError(f"train_pass ran {out['batches']} steps, not {run.steps}")
    if not np.isfinite(out["loss"]):
        run.nonfinite += run.steps


def window(run, seconds: float):
    """(end-to-end values, steps attempted, steps failed)."""
    dev = run.ctx.device
    _sync(dev)
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        _one_pass(run)
        calls += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = calls * run.steps
    return {run.ctx.mix["rate_metric"]: steps * run.batch / dt}, steps, run.nonfinite


def traced(run):
    """The traced window: ``trace_calls`` whole passes under the profiler,
    with the port's host spans on."""
    from paddlebox_tpu_torch.utils.trace import PROFILER

    from bench_port.loops import spans as span_io

    mix = run.ctx.mix
    calls = mix["trace_calls"]
    PROFILER.reset()
    PROFILER.enable()
    try:
        reading = trace_window(lambda: [_one_pass(run) for _ in range(calls)])
    finally:
        PROFILER.disable()
    spans = span_io.export(PROFILER, run.ctx.tmpdir)
    B = run.batch
    distinct = [len(np.unique(run.data.keys[i * B : (i + 1) * B])) for i in range(run.steps)]
    return span_io.layer_reading(run, reading, spans, steps=calls * run.steps, u_distinct=distinct * calls)


def release(run) -> None:
    """Free the program's state before the reference runs."""
    run.tr = run.ds = run.table = None


def reference(run, **variant) -> dict:
    """The reference's readings over the checked steps (``variant``: the
    control's ``linear`` or a planted fault's ``step_share`` or
    ``loss_share``)."""
    ctx = run.ctx
    rows0 = torch.from_numpy(run.check_rows).to(ctx.device)
    weights = {k: v.to(ctx.device) for k, v in run.weights.items()}
    return run_reference(ctx.ref_mod, ctx.cfg, run.check_keys, rows0, weights,
                         [batch(run, i) for i in CHECK_BATCHES], **variant)


def check(run) -> dict:
    numbers = checks.compare(run.prog, reference(run))
    numbers["window_nonfinite_steps"] = float(run.nonfinite)
    return numbers
