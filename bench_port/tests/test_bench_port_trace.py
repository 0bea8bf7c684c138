"""The reduction of a device trace and the per-layer readers on it."""

import pytest

from bench_port.core import manifest
from bench_port.core.roofline import gather_bytes, least_s, writeback_bytes
from bench_port.core.trace import WINDOW_MARK, reduce_events
from bench_port.loops.spans import LayerReading


def _events():
    ev = [{"name": WINDOW_MARK, "cat": "user_annotation", "ph": "X", "ts": 1000.0, "dur": 100.0}]
    # kernels (us): [990, 1010] clipped to [1000, 1010]; [1005, 1020] overlaps it;
    # a copy [1040, 1050]; a kernel past the window's end is clipped
    ev += [
        {"name": "void gather_rows_kernel<int>", "cat": "kernel", "ph": "X", "ts": 990.0, "dur": 20.0},
        {"name": "void gather_rows_kernel<int>", "cat": "kernel", "ph": "X", "ts": 1005.0, "dur": 15.0},
        {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ph": "X", "ts": 1040.0, "dur": 10.0},
        {"name": "ncclDevKernel_AllReduce", "cat": "kernel", "ph": "X", "ts": 1095.0, "dur": 20.0},
    ]
    # host operations: the gap [1050, 1095] is under aten::nonzero
    ev += [
        {"name": "train_pass", "cat": "cpu_op", "ph": "X", "ts": 1000.0, "dur": 100.0},
        {"name": "aten::nonzero", "cat": "cpu_op", "ph": "X", "ts": 1050.0, "dur": 45.0},
    ]
    return ev


def test_union_busy_and_idle_gaps():
    r = reduce_events(_events())
    assert r.window_s == pytest.approx(100e-6)
    # busy: [1000, 1020] + [1040, 1050] + [1095, 1100] = 35 us
    assert r.busy_s == pytest.approx(35e-6)
    assert r.kernel("gather_rows_kernel") == (2, pytest.approx(25e-6))
    assert r.kernel("nccl") == (1, pytest.approx(5e-6))
    gaps = dict((round(s * 1e6), n) for n, s in r.idle_gaps)
    assert set(gaps) == {20, 45}
    assert gaps[45] == "host: aten::nonzero" and gaps[20] == "host: train_pass"
    assert r.device_ops()[0][0] == "void gather_rows_kernel<int>"


def test_two_window_marks_are_refused():
    ev = _events() + [{"name": WINDOW_MARK, "cat": "user_annotation", "ph": "X", "ts": 0.0, "dur": 1.0}]
    with pytest.raises(RuntimeError):
        reduce_events(ev)


def _reading(trace, steps=2, u=(1000, 1000)):
    return LayerReading(trace=trace, steps=steps, chips=1, flops_per_step=989e12 * 1e-6,
                        peak_flops=989e12, width=15, u_distinct=list(u),
                        spans=[{"name": "superstep_dispatch", "ph": "X", "ts": 0.0, "dur": 3000.0}])


def test_readers():
    t = reduce_events(_events())
    # 2 steps, 2 gathers each: the trace holds 2 launches, so the reader finds nothing
    assert manifest.reader("pull_rows_roofline").read(_reading(t)) is None
    one = _reading(t, steps=1, u=(1000,))
    want = 2 * least_s(gather_bytes(1000, 15)) / 25e-6 * 100
    assert manifest.reader("pull_rows_roofline").read(one) == pytest.approx(want)
    assert manifest.reader("write_rows_roofline").read(one) is None  # no writeback in the trace
    assert manifest.reader("dispatch_ms_per_step").read(one) == pytest.approx(3.0)
    assert manifest.reader("device_idle_pct").read(one) == pytest.approx(65.0)
    assert manifest.reader("device_busy_ms_per_step").read(one) == pytest.approx(35e-3)
    assert manifest.reader("train_mfu").read(one) == pytest.approx(1e-6 / 100e-6 * 100)
    assert writeback_bytes(1000, 15) == 1000 * (4 + 120)
