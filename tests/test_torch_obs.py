"""The port's observability plane against the JAX package's: trace-context
ext bytes, the flight recorder, the metric series, the profiler's chrome
trace, and the spans a profiled pass records.

Exact throughout: the 24 ext bytes of a context built from the same ids,
the recorder's ring and bundle keys, the metric-series files (byte for
byte, with the wall clock pinned and both registries reset to the same
stat sequence), the chrome trace's structure (not its timestamps), and
the per-name span counts of one load -> begin_pass -> train_pass(profile)
-> end_pass on the CPU, on the packer feed and on the resident feed (every
JAX span's count, and apart from them the port's own call-edge and sync
spans).
"""

from __future__ import annotations

import collections
import json
import os
import time

import numpy as np
import pytest
import torch

import paddlebox_tpu.obs.flight_recorder as jfr
import paddlebox_tpu.obs.metrics_writer as jmw
import paddlebox_tpu.obs.trace_context as jtc
import paddlebox_tpu.utils.monitor as jmon
import paddlebox_tpu.utils.trace as jtrace
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.obs.flight_recorder as tfr
import paddlebox_tpu_torch.obs.metrics_writer as tmw
import paddlebox_tpu_torch.obs.trace_context as ttc
import paddlebox_tpu_torch.utils.monitor as tmon
import paddlebox_tpu_torch.utils.trace as ttrace
from paddlebox_tpu import config as jconfig

torch.set_num_threads(2)

S, B = 4, 16


def test_trace_context_ext_bytes_match_jax():
    tid, sid = bytes(range(16)), bytes(range(100, 108))
    t, j = ttc.TraceContext(tid, sid), jtc.TraceContext(tid, sid)
    assert t.encode_ext() == j.encode_ext() and len(t.encode_ext()) == ttc.EXT_LEN == jtc.EXT_LEN == 24
    assert t.as_args() == j.as_args()
    back = ttc.decode_ext(j.encode_ext())
    assert (back.trace_id, back.span_id) == (tid, sid)
    back = jtc.decode_ext(t.encode_ext())
    assert (back.trace_id, back.span_id) == (tid, sid)
    child = t.child()
    assert child.trace_id == tid and child.span_id != sid


def test_trace_span_nesting_and_span_args():
    assert ttc.current_trace() is None
    p = ttrace.Profiler(max_events=8)
    p.enable()
    with ttc.trace_span("outer"):
        outer = ttc.current_trace()
        with ttc.trace_span("inner"):
            inner = ttc.current_trace()
            assert inner.trace_id == outer.trace_id and inner.span_id != outer.span_id
            with p.record_event("inside"):
                pass
        assert ttc.current_trace() is outer
    assert ttc.current_trace() is None
    (ev,) = list(p._events)
    assert ev["args"] == inner.as_args()


@pytest.mark.parametrize("fr", [tfr, jfr], ids=["torch", "jax"])
def test_flight_recorder_ring_bound_and_dump(tmp_path, fr):
    rec = fr.FlightRecorder(capacity=4)
    for i in range(10):
        rec.note_span(f"span{i}", "test", float(i), 1.0, {})
    rec.note_incident("test_kind", {"detail": 42})
    snap = rec.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["span6", "span7", "span8", "span9"]
    assert snap["incidents"][0]["kind"] == "test_kind"
    path = rec.dump("test_reason", detail="why", dir_path=str(tmp_path))
    assert path is not None and os.path.basename(path).startswith("incident-")
    with open(path) as f:
        bundle = json.load(f)
    assert sorted(bundle) == ["detail", "histograms", "incidents", "rank", "reason", "spans", "stats", "wall_time"]
    assert bundle["reason"] == "test_reason" and bundle["detail"] == "why" and len(bundle["spans"]) == 4


def test_flight_recorder_without_dir_and_with_tracing_disabled():
    prev = tconfig.get_flag("obs_incident_dir")
    tconfig.set_flag("obs_incident_dir", "")
    try:
        assert tfr.FlightRecorder(capacity=2).dump("nowhere") is None
    finally:
        tconfig.set_flag("obs_incident_dir", prev)
    p = ttrace.Profiler(max_events=16)
    assert not p.enabled
    with p.record_event("invisible_to_trace", category="test"):
        pass
    assert any(s["name"] == "invisible_to_trace" for s in tfr.FLIGHT_RECORDER.snapshot()["spans"])
    assert len(p._events) == 0
    # the flight recorder keeps the newest obs_flight_spans spans
    assert tfr.FLIGHT_RECORDER.snapshot()["spans"][-1]["name"] == "invisible_to_trace"
    assert tfr.recent_incidents() == tfr.FLIGHT_RECORDER.snapshot()["incidents"]


@pytest.fixture
def pinned_registries(monkeypatch):
    """Both stat registries emptied, and the wall clock pinned, so the
    same stat sequence writes the same bytes in both packages."""
    tmon.STAT_RESET()
    jmon.STAT_RESET()
    monkeypatch.setattr(time, "time", lambda: 1767225600.25)
    yield
    tmon.STAT_RESET()
    jmon.STAT_RESET()


def _series(mw, mon, out, rotate_bytes):
    w = mw.MetricsWriter(out, rank=2, interval_s=0.0, rotate_bytes=rotate_bytes)
    mon.STAT_OBSERVE("obs_test.rotate_ms", 1.0)
    mon.STAT_OBSERVE("obs_test.rotate_ms", 7.5)
    recs = []
    for i in range(10):
        mon.STAT_ADD("obs_test.window_ctr", i)
        mon.STAT_SET("obs_test.gauge", 0.5 * i)
        recs.append(w.snapshot(f"pass:{i}", extra={"i": i}))
    return w, recs


def test_metrics_writer_rotation_deltas_and_bytes_match_jax(tmp_path, pinned_registries):
    got = {}
    for name, mw, mon in (("torch", tmw, tmon), ("jax", jmw, jmon)):
        out = str(tmp_path / name)
        w, recs = _series(mw, mon, out, rotate_bytes=1500)
        files = mw.series_files(out, rank=2)
        assert w.rotations >= 1 and len(files) == w.rotations + 1
        assert mw.series_ranks(out) == [2]
        back = list(mw.read_series(out, rank=2))
        assert [r["seq"] for r in back] == list(range(1, 11))
        assert [r["deltas"]["obs_test.window_ctr"] for r in back] == list(range(10))
        assert back[3]["extra"] == {"i": 3} and "obs_test.rotate_ms" in back[0]["histograms"]
        contents = []
        for p in files:
            with open(p, "rb") as f:
                contents.append((os.path.basename(p), f.read()))
        got[name] = (w.rotations, contents)
    assert got["torch"] == got["jax"]


def test_metrics_writer_torn_tail_tolerated(tmp_path):
    w = tmw.MetricsWriter(str(tmp_path), rank=0, interval_s=0.0)
    w.snapshot("pass:0")
    w.snapshot("pass:1")
    with open(w.path, "a") as f:
        f.write('{"t": 1.0, "rank": 0, "seq')
    before = tmon.STAT_GET("obs.metrics_bad_lines")
    assert [r["label"] for r in tmw.read_series(str(tmp_path), rank=0)] == ["pass:0", "pass:1"]
    assert tmon.STAT_GET("obs.metrics_bad_lines") == before + 1
    # the JAX package reads the port's series alike
    assert [r["label"] for r in jmw.read_series(str(tmp_path), rank=0)] == ["pass:0", "pass:1"]


def test_chrome_trace_structure_and_ring_bound(tmp_path):
    got = {}
    for name, mod in (("torch", ttrace), ("jax", jtrace)):
        p = mod.Profiler(max_events=3)
        p.enable()
        p.set_process(1, "trainer")
        for i in range(5):
            with p.record_event(f"e{i}", "test"):
                pass
        p.instant("supervisor:test", {"k": 1}, category="marker")
        path = str(tmp_path / f"{name}.json")
        n = p.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        evs = trace["traceEvents"]
        got[name] = (
            n, p.dropped_events, sorted(trace), trace["displayTimeUnit"], trace["otherData"],
            [(e["name"], e["ph"], e.get("pid"), e.get("tid"), e.get("cat"), e.get("args")) for e in evs],
        )
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 3 and got["torch"][1] == 3


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with ttrace.device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(4).add_(1)
    assert prof is not None
    with open(tmp_path / "device_trace.json") as f:
        assert "traceEvents" in json.load(f)
    with ttrace.device_trace(None) as prof:
        assert prof is None


def _pass_spans(pkg, tmp_path, resident):
    """Span counts of one profiled pass in ``pkg`` (load, begin_pass,
    train_pass(profile=True), end_pass)."""
    from tests.test_torch_mesh_step import JTower, Tower

    rng = np.random.default_rng(0)
    path = tmp_path / "part-0.txt"
    if not path.exists():
        with open(path, "w") as f:
            for _ in range(64):
                f.write("1 1.0 " + " ".join(f"1 {k}" for k in rng.integers(1, 90, S)) + "\n")
    if pkg == "torch":
        import paddlebox_tpu_torch.data as data
        import paddlebox_tpu_torch.table as table
        import paddlebox_tpu_torch.train as train

        prof, cfg_mod = ttrace.PROFILER, tconfig
    else:
        import paddlebox_tpu.data as data
        import paddlebox_tpu.table as table
        import paddlebox_tpu.train as train

        prof, cfg_mod = jtrace.PROFILER, jconfig
    cfg_mod.set_flag("enable_resident_feed", resident)
    cfg_mod.set_flag("resident_scan_batches", 2)
    lay = table.ValueLayout(embedx_dim=4)
    tab = table.HostSparseTable(lay, table.SparseOptimizerConfig(), n_shards=2, seed=0)
    schema = data.SlotSchema(
        [data.SlotInfo("label", type="float", dense=True, dim=1)] + [data.SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label",
    )
    ds = data.BoxPSDataset(schema, tab, batch_size=B)
    cfg = train.TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
    if pkg == "torch":
        tr = train.CTRTrainer(Tower(), cfg, dense_opt=train.Adam(1e-3), device="cpu")
    else:
        import jax
        import optax

        tr = train.CTRTrainer(JTower(), cfg, dense_opt=optax.adam(1e-3))
        tr.init_params(jax.random.PRNGKey(0))
    prof.reset()
    prof.enable()
    try:
        ds.set_filelist([str(path)])
        ds.load_into_memory()
        ds.begin_pass(round_to=8)
        tr.train_pass(ds, profile=True)
        ds.end_pass(tr.trained_table())
    finally:
        prof.disable()
    return collections.Counter(e["name"] for e in prof._events)


@pytest.mark.parametrize("resident", [0, 1], ids=["packer", "resident"])
def test_profiled_pass_records_the_jax_span_names_and_counts(tmp_path, resident):
    names = ("enable_resident_feed", "resident_scan_batches")
    prev = [(m, n, m.get_flag(n)) for m in (tconfig, jconfig) for n in names]
    try:
        got = {pkg: _pass_spans(pkg, tmp_path, resident) for pkg in ("torch", "jax")}
    finally:
        for m, n, v in prev:
            m.set_flag(n, v)
    # every JAX span name, with its count, is in the port's trace
    assert {k: got["torch"][k] for k in got["jax"]} == dict(got["jax"])
    # the port's extra names are its call-edge, sync, seqpool and push-merge spans, and no others
    extra = {k: v for k, v in got["torch"].items() if k not in got["jax"]}
    steps = 64 // B
    want = {"train_pass.open": 1, "train_pass.close": 1, "auc_compute": 2, "sync.auc_tables": 4, "sync.losses": 1,
            "seqpool": steps, "seqpool.bwd": steps, "push_merge": steps}
    if resident:
        want.update(dict.fromkeys(
            ("resident.batch_indices", "resident.ensure_pads", "resident.index_partition",
             "resident.superstep_build"), 1))
    assert extra == want
    if resident:
        assert got["torch"]["superstep_dispatch"] == got["torch"]["device_superstep"] == steps
        assert got["torch"]["resident_prepare"] == 1
    else:
        assert got["torch"]["train_step_dispatch"] == got["torch"]["device_step"] == steps
        assert got["torch"]["pack+upload"] == steps and got["torch"]["feed_wait"] == steps + 1
    for span in ("boundary.dedup", "boundary.pull", "boundary.premerge", "boundary.end_pass_worker"):
        assert got["torch"][span] == 1
