"""The port's spans on a ``torch.profiler`` trace's clock, the spans that
tile a ``train_pass`` call's edges, its ``sync`` spans, and the two
benchmark readers built on them (``call_edge_ms_per_step``,
``host_syncs_per_step``).

On the CPU, at a toy size: one pass of 64 records, batch 16, trained by
``train_pass`` calls on the resident feed (and the packer feed for the
sync count). A sync span is recorded on every device, so a call's count
is the one the card's traced run reads.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as data
import paddlebox_tpu_torch.table as table
import paddlebox_tpu_torch.train as train
from bench_port.core import manifest
from bench_port.core.trace import TraceReading
from bench_port.loops.spans import LayerReading
from paddlebox_tpu_torch.utils.trace import PROFILER

torch.set_num_threads(2)

S, B, RECORDS = 4, 16, 64
MAX_INFLIGHT = 4
# every span of the resident call's edges, with its count in a call of 4
# batches at 2 a superstep
TENTPOLE = {
    "train_pass.open": 1,
    "resident_prepare": 1,
    "resident.batch_indices": 1,
    "resident.ensure_pads": 1,
    "resident.index_partition": 1,
    "resident.superstep_build": 1,
    "superstep_dispatch": 2,
    "sync.superstep": 1,
    "sync.drain": 1,
    "train_pass.close": 1,
    "auc_compute": 2,
    "sync.auc_tables": 4,
    "sync.losses": 1,
}
ORDER = ("train_pass.open", "resident_prepare", "superstep_dispatch", "sync.drain", "train_pass.close")


class _Tower(torch.nn.Module):
    """A linear logit over the flattened slot features."""

    def __init__(self, d_in):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(d_in, 1, generator=g) * 0.1)

    def forward(self, slot_feats, dense=None):
        return (slot_feats.reshape(slot_feats.shape[0], -1) @ self.w)[:, 0]


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("trace_clock") / "part-0.txt"
    with open(path, "w") as f:
        for _ in range(RECORDS):
            label = rng.integers(0, 2)
            f.write(f"1 {label}.0 " + " ".join(f"1 {k}" for k in rng.integers(1, 90, S)) + "\n")
    return [str(path)]


@contextlib.contextmanager
def _flags(**values):
    prev = {k: tconfig.get_flag(k) for k in values}
    try:
        for k, v in values.items():
            tconfig.set_flag(k, v)
        yield
    finally:
        for k, v in prev.items():
            tconfig.set_flag(k, v)


def _open(files, check_nan=False):
    lay = table.ValueLayout(embedx_dim=4)
    tab = table.HostSparseTable(lay, table.SparseOptimizerConfig(), n_shards=2, seed=0)
    schema = data.SlotSchema(
        [data.SlotInfo("label", type="float", dense=True, dim=1)] + [data.SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label",
    )
    ds = data.BoxPSDataset(schema, tab, batch_size=B)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=8)
    cfg = train.TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100, check_nan=check_nan)
    tr = train.CTRTrainer(_Tower(S * lay.pull_width), cfg, dense_opt=train.Adam(1e-3), device="cpu")
    return ds, tr


def _call(files, n_batches=4, k=2, resident=1, ring=True, profiler=True, check_nan=False):
    """(ring events, the chrome trace's ``user_annotation`` events or None,
    the call's result) of one ``train_pass`` after a warm call."""
    with _flags(enable_resident_feed=resident, resident_scan_batches=k, max_inflight_steps=MAX_INFLIGHT):
        ds, tr = _open(files, check_nan)
        tr.train_pass(ds, n_batches=n_batches)
        PROFILER.reset()
        if ring:
            PROFILER.enable()
        try:
            if profiler:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                    out = tr.train_pass(ds, n_batches=n_batches)
            else:
                prof, out = None, tr.train_pass(ds, n_batches=n_batches)
        finally:
            PROFILER.disable()
        assert tr.last_feed == ("resident" if resident else "packer")
    ring_events = list(PROFILER._events)
    PROFILER.reset()
    trace = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = [
                    {"name": e["name"], "ts": float(e["ts"]), "end": float(e["ts"]) + float(e["dur"])}
                    for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"
                ]
    return ring_events, trace, out


def _want_syncs(n, k, resident, check_nan):
    """A call's sync spans: two AUC reads at each end, the loss read (and
    the NaN flags'), the drain, and every wait for a step ahead."""
    ahead = max(0, -(-n // k) - 1) if resident else max(0, n - MAX_INFLIGHT)
    return 4 + 1 + int(check_nan) + 1 + ahead


@pytest.mark.parametrize("ring", [True, False], ids=["ring_on", "ring_off"])
def test_spans_enter_the_device_trace_as_annotations(pass_files, ring):
    ring_events, trace, _ = _call(pass_files, ring=ring)
    got = collections.Counter(e["name"] for e in trace if e["name"] in TENTPOLE)
    assert dict(got) == TENTPOLE
    if ring:
        assert collections.Counter(e["name"] for e in ring_events if e["name"] in TENTPOLE) == got
    else:
        assert ring_events == []


@pytest.mark.parametrize("clock", ["device_trace", "ring"])
def test_call_edges_tile_the_call_in_order(pass_files, clock):
    ring_events, trace, _ = _call(pass_files)
    if clock == "ring":
        spans = [{"name": e["name"], "ts": e["ts"], "end": e["ts"] + e["dur"]} for e in ring_events]
    else:
        spans = trace
    first = [min((e for e in spans if e["name"] == n), key=lambda e: e["ts"]) for n in ORDER]
    for a, b in zip(first, first[1:]):
        assert a["end"] <= b["ts"], (a["name"], b["name"])
    # the children of resident_prepare and of train_pass.close lie inside them
    outer = {e["name"]: e for e in first}
    for child, parent in (("resident.batch_indices", "resident_prepare"),
                          ("resident.superstep_build", "resident_prepare"),
                          ("auc_compute", "train_pass.close"), ("sync.losses", "train_pass.close")):
        c = next(e for e in spans if e["name"] == child)
        assert outer[parent]["ts"] <= c["ts"] and c["end"] <= outer[parent]["end"]


@pytest.mark.parametrize(
    "n, k, resident, check_nan",
    [(4, 2, 1, False), (2, 8, 1, False), (3, 1, 1, False), (4, 2, 1, True), (6, 1, 0, False), (2, 1, 0, True)],
    ids=["resident_2x2", "resident_steady", "resident_k1", "resident_nan", "packer_ahead", "packer_nan"],
)
def test_sync_spans_count_a_calls_blocking_reads(pass_files, n, k, resident, check_nan):
    ring_events, trace, out = _call(pass_files, n_batches=n, k=k, resident=resident, check_nan=check_nan)
    assert out["batches"] == n
    syncs = [e for e in ring_events if e["cat"] == "sync"]
    assert len(syncs) == _want_syncs(n, k, resident, check_nan)
    assert {e["name"] for e in syncs} <= {"sync.superstep", "sync.drain", "sync.auc_tables", "sync.losses",
                                         "sync.nan_flags"}
    # the device trace holds the same sync spans
    assert sum(1 for e in trace if e["name"].startswith("sync.")) == len(syncs)
    reading = _layer_reading(ring_events, steps=n)
    assert manifest.reader("host_syncs_per_step").read(reading) == pytest.approx(len(syncs) / n)
    if (n, k, resident, check_nan) == (2, 8, 1, False):
        # the steady cells' call: two steps, one superstep, three syncs a step
        assert manifest.reader("host_syncs_per_step").read(reading) == 3.0


@pytest.mark.parametrize("ring", [True, False], ids=["ring_on", "ring_off"])
def test_no_profiler_enters_no_record_function(pass_files, monkeypatch, ring):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    ring_events, _, _ = _call(pass_files, ring=ring, profiler=False)
    assert entered == []
    assert bool(ring_events) == ring
    _call(pass_files, ring=ring, profiler=True)
    # and the shared step's seqpool spans, forward and backward, a step each
    assert collections.Counter(entered) == collections.Counter({**TENTPOLE, "seqpool": 4, "seqpool.bwd": 4})


def _layer_reading(spans, steps):
    return LayerReading(trace=TraceReading(window_s=1.0, busy_s=0.5), steps=steps, chips=1, flops_per_step=0.0,
                        peak_flops=1.0, width=15, u_distinct=[], spans=spans)


def _span(name, dur_us, cat="pass"):
    return {"name": name, "cat": cat, "ph": "X", "ts": 0.0, "dur": dur_us}


SYNTHETIC = [_span("train_pass.open", 1000.0), _span("resident_prepare", 3000.0), _span("superstep_dispatch", 9000.0),
             _span("sync.drain", 5000.0, "sync"), _span("sync.auc_tables", 10.0, "sync"),
             _span("train_pass.close", 2000.0), _span("device_superstep", 7000.0, "device")]


@pytest.mark.parametrize(
    "name, spans, steps, want",
    [
        ("call_edge_ms_per_step", SYNTHETIC, 2, 3.0),
        ("call_edge_ms_per_step", SYNTHETIC * 2, 4, 3.0),
        ("call_edge_ms_per_step", SYNTHETIC, 0, None),
        # a program without the call's edge spans (its resident_prepare alone)
        ("call_edge_ms_per_step", SYNTHETIC[1:3], 2, None),
        ("host_syncs_per_step", SYNTHETIC, 2, 1.0),
        ("host_syncs_per_step", SYNTHETIC * 3, 3, 2.0),
        ("host_syncs_per_step", SYNTHETIC, 0, None),
        ("host_syncs_per_step", SYNTHETIC[1:], 2, None),
    ],
    ids=["edge", "edge_two_calls", "edge_no_steps", "edge_no_spans", "syncs", "syncs_three_calls",
         "syncs_no_steps", "syncs_no_spans"],
)
def test_readers_on_synthetic_spans(name, spans, steps, want):
    got = manifest.reader(name).read(_layer_reading(spans, steps))
    assert got == (None if want is None else pytest.approx(want))
