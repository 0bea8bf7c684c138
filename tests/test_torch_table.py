"""The port's host store and working-set writeback against the JAX package.

The JAX package's table runs its pure-Python store (``PBOX_NATIVE_TABLE=0``),
the one the port carries over: with the same seed both draw the same
initial rows in the same order, so every comparison here is bitwise.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table.sparse_table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout

torch.set_num_threads(2)

D = 4


@pytest.fixture
def tables(monkeypatch):
    """(port table, JAX Python-store table) with one seed and config."""
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "0")
    kw = dict(show_clk_decay=0.9, shrink_threshold=1.5, initial_range=0.02)
    jt = JHostSparseTable(JValueLayout(embedx_dim=D), JSparseOptimizerConfig(**kw), n_shards=8, seed=3)
    assert jt._native is None
    t = HostSparseTable(ValueLayout(embedx_dim=D), SparseOptimizerConfig(**kw), n_shards=8, seed=3)
    return t, jt


def _sorted_contents(table, keys):
    keys = np.sort(keys)
    return keys, table.pull_or_create(keys)


def test_pull_or_create_matches_jax_bitwise(tables):
    t, jt = tables
    rng = np.random.default_rng(0)
    first = np.unique(rng.integers(1, 1 << 40, 300, dtype=np.uint64))
    second = np.unique(np.concatenate([first[::3], rng.integers(1, 1 << 40, 200, dtype=np.uint64)]))
    for keys in (first, second):
        np.testing.assert_array_equal(t.pull_or_create(keys), jt.pull_or_create(keys))
    assert len(t) == len(jt)
    np.testing.assert_array_equal(np.sort(t.keys()), np.sort(jt.keys()))


def test_push_and_decay_and_shrink_match_jax_bitwise(tables):
    t, jt = tables
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(1, 1 << 40, 400, dtype=np.uint64))
    t.pull_or_create(keys)
    jt.pull_or_create(keys)
    rows = rng.normal(size=(len(keys), t.layout.width)).astype(np.float32)
    rows[:, 0] = rng.integers(0, 4, len(keys))  # show: some fall under the shrink line
    new_keys = np.unique(rng.integers(1 << 41, 1 << 42, 30, dtype=np.uint64))
    new_rows = rng.normal(size=(len(new_keys), t.layout.width)).astype(np.float32)
    new_rows[:, 0] = 5.0
    for tab in (t, jt):
        tab.push(keys, rows)
        tab.push(new_keys, new_rows)  # absent keys are added
    assert t.decay_and_shrink() == jt.decay_and_shrink()
    assert t.decay_and_shrink() == jt.decay_and_shrink()
    assert len(t) == len(jt)
    kept, got = _sorted_contents(t, t.keys())
    jkept, want = _sorted_contents(jt, jt.keys())
    np.testing.assert_array_equal(kept, jkept)
    np.testing.assert_array_equal(got, want)


def test_working_set_writeback_matches_jax_bitwise(tables):
    t, jt = tables
    rng = np.random.default_rng(2)
    keys = rng.integers(1, 1 << 40, 500, dtype=np.uint64)
    ws, jws = PassWorkingSet(n_mesh_shards=2), JPassWorkingSet(n_mesh_shards=2)
    for w in (ws, jws):
        w.add_keys(keys[:300])
        w.add_keys(keys[200:])
    dev = ws.finalize(t, round_to=16)
    jdev = jws.finalize(jt, round_to=16)
    np.testing.assert_array_equal(dev, jdev)
    trained = dev + rng.normal(size=dev.shape).astype(np.float32)
    ws.writeback(trained)
    jws.writeback(trained.copy())
    k, got = _sorted_contents(t, t.keys())
    jk, want = _sorted_contents(jt, jt.keys())
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(got, want)
