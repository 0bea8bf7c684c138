"""The multi-hot cell's harness: its generator against the published
sizes and the native parser, the attribution of device time to spans,
its two readers' counts against hand-worked numbers, its files, and its
``correct`` against the reference on the CPU: sound, with each planted
fault, and the fp8 control."""

import functools
import time

import numpy as np
import pytest
import torch

from bench_port.calibrate import readings
from bench_port.core import checks, layer_counts, manifest, multihot
from bench_port.core.attribution import span_device_s
from bench_port.core.roofline import least_s
from bench_port.core.trace import WINDOW_MARK, TraceReading
from bench_port.core.runner import run_cell
from bench_port.loops.multihot import MultiHotReading
from bench_port.tests import test_bench_port_faults as faults

CELL = "dlrm-dcnv2-criteo1tb.multihot"
BENCH = manifest.load_benchmark()
CFG = manifest.config(BENCH, "dlrm-dcnv2-criteo1tb")
MIX = manifest.traffic("multihot")
SIZES = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1]
SMALL = {
    "config": {"records_per_pass": 2048, "key_space": 5000, "embedx_dim": 8, "bottom_mlp": [16, 8],
               "cross_rank": 12, "top_mlp": [32, 16]},
    "traffic": {"batch": 256, "files": 2, "hot_keys": 64},
}


def test_the_configuration_is_the_published_one():
    assert CFG["multi_hot_sizes"] == SIZES and sum(SIZES) == 214
    assert CFG["cardinalities"][:3] == [40000000, 39060, 17295] and len(CFG["cardinalities"]) == 26
    assert (CFG["embedx_dim"], CFG["bottom_mlp"], CFG["cross_layers"], CFG["cross_rank"], CFG["top_mlp"]) == (
        128, [512, 256, 128], 3, 512, [1024, 1024, 512, 256])
    assert multihot.key_space(CFG) - 1 == 25_156_108
    assert MIX["batch"] * 4 == CFG["records_per_pass"] == 262_144


def test_the_cell_resolves_with_all_its_files():
    wl = manifest.workload(BENCH, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("dlrm-dcnv2-criteo1tb", "multihot", 1)
    loop = manifest.module("loops", MIX["loop"])
    for f in ("setup", "window", "traced", "release", "check", "reference", "batch"):
        assert callable(getattr(loop, f))
    assert manifest.module("models", "dlrm").build and manifest.module("reference", "dlrm").run_multihot_reference
    assert "embed_grad1_gap" not in checks.load_limits(manifest.BENCH_DIR, CELL)
    layer = {m["name"] for m in manifest.metrics_for(BENCH, "per_layer", CELL)}
    assert {"cross_roofline", "seqpool_roofline", "train_mfu", "host_syncs_per_step"} <= layer
    for other in ("deepfm-criteo.steady", "widedeep-criteo.steady"):
        assert not {"cross_roofline", "seqpool_roofline"} & {m["name"] for m in
                                                           manifest.metrics_for(BENCH, "per_layer", other)}


def test_tower_flops_are_the_published_count():
    assert manifest.module("reference", "dlrm").tower_flops_per_sample(CFG) == 96_182_784


# ---- the generator -----------------------------------------------------------


def _pass(n, seed=2**33 + 7):
    return multihot.make_pass(np.random.default_rng(seed), n, CFG, MIX)


def test_each_slot_draws_its_published_count_from_its_own_range():
    data = _pass(500)
    assert data.keys.shape == (500, 214) and data.dense.shape == (500, 13)
    r = multihot.ranges(CFG)
    assert r.sum() == 25_156_108 and r.max() == 1 << 22 and r[5] == 3
    lo = 1 + np.concatenate([[0], np.cumsum(r)[:-1]])
    c = 0
    for s, size in enumerate(SIZES):
        k = data.keys[:, c : c + size].astype(np.int64)
        assert k.min() >= lo[s] and k.max() < lo[s] + r[s], s
        c += size
    assert 0.1 < data.labels.mean() < 0.3


def test_same_seed_same_pass():
    a, b = _pass(64), _pass(64)
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.dense, b.dense)
    assert not np.array_equal(a.keys, _pass(64, seed=3).keys)


def test_text_holds_the_published_lengths():
    data = _pass(3)
    for line, keys in zip(multihot.pass_text(data, SIZES).tobytes().decode().splitlines(), data.keys):
        tok = line.split()
        i = 3 + 13
        got = []
        for size in SIZES:
            assert int(tok[i]) == size and all(len(t) == 8 for t in tok[i + 1 : i + 1 + size])
            got += [int(t) for t in tok[i + 1 : i + 1 + size]]
            i += 1 + size
        assert i == len(tok) and got == keys.tolist()


def test_text_round_trips_through_the_native_parser(tmp_path):
    from bench_port.core import program

    data = _pass(300)
    files = multihot.write_pass(str(tmp_path), "p", data, SIZES, 3)
    keys = np.unique(data.keys)
    table = program.host_table(CFG, 1, keys, np.zeros((len(keys), CFG["embedx_dim"] + 5), np.float32))
    ds = program.dataset(CFG, {**MIX, "read_threads": 2}, table, files, 1)
    ds.load_into_memory()
    st = ds.store
    assert st is not None and len(st) == 300
    counts = np.diff(st.u64_offsets.astype(np.int64), axis=1)
    assert (counts == np.asarray(SIZES)).all()
    got = np.stack([st.u64_values[int(b) : int(b) + 214] for b in st.u64_base])
    assert np.array_equal(got, data.keys)
    schema = program.schema(CFG)
    assert np.array_equal(st.float_slot_matrix(schema.float_slot_index("dense"), 13), data.dense)
    assert np.array_equal(st.float_slot_matrix(schema.float_slot_index("label"), 1)[:, 0], data.labels)


# ---- attribution and the readers ---------------------------------------------


def _events():
    """Window [1000, 1100] us. Spans: dlrm.cross [1000, 1020], dlrm.cross.bwd
    [1050, 1060], seqpool [1030, 1040]. Kernels by launch: two under the
    cross (8 + 6 us, the second clipped at the window's end), one under its
    backward (4 us), one under the seqpool (5 us), one launched outside
    every span (7 us), one with no launch event (3 us)."""
    ev = [{"name": WINDOW_MARK, "cat": "user_annotation", "ph": "X", "ts": 1000.0, "dur": 100.0},
          {"name": "dlrm.cross", "cat": "user_annotation", "ph": "X", "ts": 1000.0, "dur": 20.0},
          {"name": "seqpool", "cat": "user_annotation", "ph": "X", "ts": 1030.0, "dur": 10.0},
          {"name": "dlrm.cross.bwd", "cat": "user_annotation", "ph": "X", "ts": 1050.0, "dur": 10.0}]
    launches = [(1, 1001.0, "cuda_runtime"), (2, 1019.0, "cuda_driver"), (3, 1055.0, "cuda_runtime"),
                (4, 1031.0, "cuda_runtime"), (5, 1025.0, "cuda_runtime")]
    ev += [{"name": "cudaLaunchKernel", "cat": cat, "ph": "X", "ts": ts, "dur": 1.0, "args": {"correlation": c}}
           for c, ts, cat in launches]
    kernels = [(1, 1010.0, 8.0), (2, 1094.0, 10.0), (3, 1070.0, 4.0), (4, 1040.0, 5.0), (5, 1080.0, 7.0),
               (6, 1060.0, 3.0)]
    ev += [{"name": f"k{c}", "cat": "kernel", "ph": "X", "ts": ts, "dur": dur, "args": {"correlation": c}}
           for c, ts, dur in kernels]
    return ev


def test_device_time_goes_to_the_span_its_launch_lies_in():
    got = span_device_s(_events(), ("dlrm.cross", "dlrm.cross.bwd", "seqpool", "seqpool.bwd"))
    assert got == pytest.approx({"dlrm.cross": 14e-6, "dlrm.cross.bwd": 4e-6, "seqpool": 5e-6, "seqpool.bwd": 0.0})


def test_cross_counts_by_hand():
    # batch 2, dim 4, rank 3, one layer: 6 * 2 * (4*3 + 3*4) FLOPs; bytes
    # 5 * 2 * 4 (x0, x_l, x_l+1 and the two gradients) + 4*3 + 3*4 + 4, fp32
    assert layer_counts.cross_flops(2, 4, 3, 1) == 288
    assert layer_counts.cross_bytes(2, 4, 3, 1) == (40 + 28) * 4
    # the cell's step: 4.17 TFLOP, 13.6 GB; the FLOPs bound it
    f, b = layer_counts.cross_flops(65536, 3456, 512, 3), layer_counts.cross_bytes(65536, 3456, 512, 3)
    assert f == pytest.approx(4.1747e12, rel=1e-4) and b == pytest.approx(1.3632e10, rel=1e-4)
    assert layer_counts.cross_least_s(65536, 3456, 512, 3) == pytest.approx(f / 989e12)


def test_seqpool_counts_by_hand():
    # 10 keys and 4 pooled rows of 3 columns, each read once and written once
    assert layer_counts.seqpool_bytes(10, 4, 3) == 2 * 14 * 3 * 4
    assert layer_counts.seqpool_least_s(10, 4, 3) == pytest.approx(336 / 3.35e12)


def _reading(**kw):
    base = dict(trace=TraceReading(window_s=1.0, busy_s=0.5), steps=2, chips=1, flops_per_step=0.0,
                peak_flops=989e12, width=133, u_distinct=[1, 1], spans=[],
                span_device_s={"dlrm.cross": 0.004, "dlrm.cross.bwd": 0.012, "seqpool": 0.003, "seqpool.bwd": 0.002},
                pooled_keys=2 * 65536 * 214, counted_keys=2 * 65536 * 214, batch=65536, num_slots=26, pull_width=131,
                cross_dim=3456, cross_rank=512, cross_layers=3)
    return MultiHotReading(**{**base, **kw})


def test_readers():
    r = _reading()
    want = 2 * layer_counts.cross_least_s(65536, 3456, 512, 3) / 0.016 * 100
    assert manifest.reader("cross_roofline").read(r) == pytest.approx(want)
    want = least_s(2 * (2 * 65536 * 214 + 2 * 65536 * 26) * 131 * 4) / 0.005 * 100
    assert manifest.reader("seqpool_roofline").read(r) == pytest.approx(want)
    # the program's count differs from the benchmark's, or is missing
    assert manifest.reader("seqpool_roofline").read(_reading(pooled_keys=5)) is None
    assert manifest.reader("seqpool_roofline").read(_reading(pooled_keys=None)) is None
    assert manifest.reader("cross_roofline").read(_reading(span_device_s={})) is None


# ---- correct, on the CPU -----------------------------------------------------


@pytest.fixture
def fp32_tower(monkeypatch):
    import paddlebox_tpu_torch.models.dlrm as dlrm
    import paddlebox_tpu_torch.models.layers as layers

    monkeypatch.setattr(dlrm, "mlp_apply", functools.partial(layers.mlp_apply, compute_dtype=torch.float32))
    monkeypatch.setattr(dlrm, "product", lambda x, w, dtype: layers.product(x, w, torch.float32))


def _run():
    return run_cell(CELL, 2**31 + 77, 0.2, False, device="cpu", overrides=SMALL, t_origin=time.perf_counter())


def test_sound_run_follows_the_reference_to_fp32_rounding(fp32_tower):
    r = _run()
    assert r["correct"], r["checks"]
    for n in set(checks.NUMBERS) & set(r["checks"]):
        assert r["checks"][n]["value"] < 1e-4, (n, r["checks"][n])
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [faults._unchanged_state, faults._half_batch, faults._auc_labels_swapped,
                                   faults._auc_one_bucket])
def test_fault_is_not_correct(fault, fp32_tower, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


def test_control_is_not_correct():
    """The fp8 control fails one of the cell's numbers at the configuration's
    widths, on the CPU at a batch of 2,048."""
    size = {"config": {"records_per_pass": 4096}, "traffic": {"batch": 2048, "files": 2}}
    line = next(iter(readings(CELL, [3], {3}, device="cpu", overrides=size)))
    lim = {n: v for n, v in checks.load_limits(manifest.BENCH_DIR, CELL).items() if n in checks.NUMBERS}
    assert not checks.judge(line["control"], lim)[0], line["control"]
