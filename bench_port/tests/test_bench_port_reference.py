"""The plain reference against the port's CPU path, and the traffic's
text against the records it was made from."""

import time

import numpy as np
import pytest

from bench_port.core import checks, traffic
from bench_port.core.runner import run_cell
from bench_port.tests._small import SMALL, fp32_tower

CELLS = {"deepfm-criteo.steady": "train_samples_per_s", "widedeep-criteo.steady": "train_samples_per_s"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_follows_the_port_to_fp32_rounding(cell, monkeypatch):
    fp32_tower(monkeypatch)
    r = run_cell(cell, 2**31 + 11, 0.2, False, device="cpu", overrides=SMALL, t_origin=time.perf_counter())
    assert r["correct"], r["checks"]
    for n in set(checks.NUMBERS) & set(r["checks"]):
        assert r["checks"][n]["value"] < 1e-4, (n, r["checks"][n])
    assert r["checks"]["auc1_count_gap"]["value"] == 0.0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {CELLS[cell], "setup_s"}


@pytest.mark.parametrize("cell", ["deepfm-criteo.steady", "widedeep-criteo.steady"])
def test_bf16_tower_reads_a_gap(cell):
    r = run_cell(cell, 5, 0.2, False, device="cpu", overrides=SMALL, t_origin=time.perf_counter())
    assert r["checks"]["pred1_gap"]["value"] > 1e-6  # the port's bf16 tower is not fp32


def _parse(text: np.ndarray, n_slots: int, dense_dim: int):
    """The slot text back into (labels, dense, keys), read the simple way."""
    labels, dense, keys = [], [], []
    for line in text.tobytes().decode().splitlines():
        tok = line.split()
        labels.append(float(tok[1]))
        i = 2
        if dense_dim:
            assert int(tok[i]) == dense_dim
            dense.append([float(v) for v in tok[i + 1 : i + 1 + dense_dim]])
            i += 1 + dense_dim
        keys.append([int(tok[i + 2 * s + 1]) for s in range(n_slots)])
        assert all(tok[i + 2 * s] == "1" for s in range(n_slots)) and len(tok) == i + 2 * n_slots
    return np.array(labels, np.float32), np.array(dense, np.float32), np.array(keys, np.uint64)


@pytest.mark.parametrize("dense_dim", [0, 13])
def test_pass_text_holds_the_records(dense_dim):
    mix = {"hot_keys": 4096, "hot_frac": 0.25, "pos_frac": 0.2}
    data = traffic.make_pass(np.random.default_rng(3), 300, 5, dense_dim, 1 << 22, mix)
    labels, dense, keys = _parse(traffic.pass_text(data), 5, dense_dim)
    assert np.array_equal(labels, data.labels) and np.array_equal(keys, data.keys)
    if dense_dim:
        assert np.array_equal(dense, data.dense)


def test_same_seed_same_traffic():
    mix = {"hot_keys": 64, "hot_frac": 0.25, "pos_frac": 0.2}
    a = traffic.make_pass(np.random.default_rng(2**33 + 5), 100, 3, 2, 1000, mix)
    b = traffic.make_pass(np.random.default_rng(2**33 + 5), 100, 3, 2, 1000, mix)
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.dense, b.dense)
