"""The benchmark's operation and byte counts against hand-worked shapes."""

import pytest

from bench_port.core import manifest, roofline
from bench_port.reference import deepfm, widedeep

BATCH = 65536


def _cfg(name):
    return manifest.config(manifest.load_benchmark(), name)


def test_deepfm_tower_flops():
    # (507*400 + 2*400*400 + 400) multiply-adds a sample, 6 FLOPs each
    per_sample = deepfm.tower_flops_per_sample(_cfg("deepfm-criteo"))
    assert per_sample == 6 * (507 * 400 + 400 * 400 + 400 * 400 + 400 * 1)
    assert per_sample * BATCH == pytest.approx(205.73e9, rel=1e-4)


def test_widedeep_tower_flops():
    per_sample = widedeep.tower_flops_per_sample(_cfg("widedeep-criteo"))
    assert per_sample == 6 * (923 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    assert per_sample * BATCH == pytest.approx(629.45e9, rel=1e-4)


def test_param_shapes_match_tower_widths():
    names = dict(deepfm.param_shapes(_cfg("deepfm-criteo")))
    assert names["mlp.0.weight"] == (400, 39 * 13) and names["out.weight"] == (1, 400) and names["b"] == ()
    names = dict(widedeep.param_shapes(_cfg("widedeep-criteo")))
    assert names["mlp.0.weight"] == (1024, 26 * 35 + 13) and names["wide_dense.weight"] == (1, 13)


@pytest.mark.parametrize("u, width, want", [(10, 15, 10 * (4 + 60 + 60)), (1, 37, 4 + 148 + 148)])
def test_gather_bytes(u, width, want):
    assert roofline.gather_bytes(u, width) == want


@pytest.mark.parametrize("u, width, want", [(10, 15, 10 * (4 + 120)), (3, 37, 3 * (4 + 296))])
def test_writeback_bytes(u, width, want):
    assert roofline.writeback_bytes(u, width) == want


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(3.35e9, flops=989e12, peak_flops=989e12) == pytest.approx(1.0)
