"""The replica caches' device half against the JAX package's
(``tests/test_replica_cache.py``'s cases run through both packages).

``ReplicaCache.to_device`` and ``InputTable.to_device`` place the rows on
a device (here the CPU; with a mesh plan, the plan's device), and
``pull_cache_value`` answers as the JAX package's ``jnp.take(cache,
ids.astype(int32), axis=0)``: bitwise, including ids in [-R, 0), which
count from the end, and ids past either end, which give a NaN row. On a
CUDA cache the same wrapper launches ``pull_rows_cuda`` (``chip_smoke.py``
holds it against this plain version on the card).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.table import InputTable as JInputTable
from paddlebox_tpu.table import ReplicaCache as JReplicaCache
from paddlebox_tpu.table import pull_cache_value as jpull_cache_value
from paddlebox_tpu_torch.parallel import MeshPlan
from paddlebox_tpu_torch.table import InputTable, ReplicaCache, pull_cache_value
from paddlebox_tpu_torch.table.replica_cache import pull_cache_value_ref

torch.set_num_threads(2)


def _same(got, want) -> None:
    """Bitwise, NaNs by position (a tensor or an array against an array)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_threaded_add_to_device_and_gather_match_jax():
    """Four threads append 50 rows each; every id maps to its row on the
    device, and a gather answers as the JAX package's on the same rows."""
    cache = ReplicaCache(dim=4)
    ids = {}

    def add(tid):
        for i in range(50):
            ids[(tid, i)] = cache.add_items(np.full(4, tid * 100 + i, np.float32))

    ts = [threading.Thread(target=add, args=(t,)) for t in range(4)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert len(cache) == 200
    dev = cache.to_device(device="cpu")
    assert dev.device.type == "cpu" and dev.dtype == torch.float32 and tuple(dev.shape) == (200, 4)
    for (tid, i), rid in ids.items():
        np.testing.assert_array_equal(dev[rid].numpy(), np.full(4, tid * 100 + i, np.float32))
    jcache = JReplicaCache(dim=4)
    jcache.add_batch(cache.host_array())
    q = np.array([ids[(2, 7)], ids[(0, 0)], 199, 0], np.int32)
    got = pull_cache_value(dev, torch.from_numpy(q))
    _same(got, jpull_cache_value(jcache.to_device(), jnp.asarray(q)))
    np.testing.assert_array_equal(got[0].numpy(), np.full(4, 207.0))
    assert cache.mem_used_mb() == jcache.mem_used_mb() == 200 * 4 * 4 / 1024.0 / 1024.0
    with pytest.raises(ValueError):
        cache.add_items(np.zeros(5, np.float32))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_out_of_range_ids_follow_jnp_take(dtype):
    """``jnp.take`` on a 4-row cache: 0 and 3 are rows, -1 wraps to row 3,
    -4 to row 0, and 4, 7, -5 and -9 are NaN rows. The port gives the same
    bytes, through the wrapper and through its plain version."""
    rng = np.random.default_rng(0)
    host = rng.normal(size=(4, 3)).astype(np.float32)
    q = np.array([0, 3, 4, -1, -5, -4, 7, -9, 2], dtype)
    want = np.asarray(jnp.take(jnp.asarray(host), jnp.asarray(q).astype(jnp.int32), axis=0))
    assert np.isnan(want[[2, 4, 6, 7]]).all() and (want[3] == host[3]).all() and (want[5] == host[0]).all()
    _same(pull_cache_value(torch.from_numpy(host), torch.from_numpy(q)), want)
    _same(jpull_cache_value(jnp.asarray(host), jnp.asarray(q)), want)
    rows = torch.from_numpy(q.astype(np.int64)).to(torch.int32)
    rows = torch.where(rows < 0, rows + 4, rows)
    _same(pull_cache_value_ref(torch.from_numpy(host), rows), want)


def test_gather_keeps_the_ids_shape():
    """[B, S] ids give [B, S, dim] rows, as ``jnp.take`` does."""
    rng = np.random.default_rng(1)
    host = rng.normal(size=(50, 8)).astype(np.float32)
    q = rng.integers(-60, 60, (16, 5)).astype(np.int64)
    got = pull_cache_value(torch.from_numpy(host), torch.from_numpy(q))
    _same(got, jpull_cache_value(jnp.asarray(host), jnp.asarray(q)))
    assert tuple(got.shape) == (16, 5, 8)


def test_input_table_default_miss_and_upsert_match_jax():
    """The reserved miss row 0, the miss counter, an upsert keeping its row
    id, the host lookup and the device replica, each as the JAX
    package's."""
    t, jt = InputTable(dim=3), JInputTable(dim=3)
    assert len(t) == len(jt) == 1
    for key, vec in (("ad-1", [1, 2, 3]), ("ad-2", [4, 5, 6])):
        assert t.add_index_data(key, vec) == jt.add_index_data(key, vec)
    assert t.get_index_offset("ad-2") == jt.get_index_offset("ad-2") == 2
    assert t.get_index_offset("nope") == jt.get_index_offset("nope") == 0
    assert t.miss == jt.miss == 1
    assert t.add_index_data("ad-1", [9, 9, 9]) == jt.add_index_data("ad-1", [9, 9, 9]) == 1
    ids = np.array([0, 1, 2, -1])
    np.testing.assert_array_equal(t.lookup_input(ids), jt.lookup_input(ids))
    np.testing.assert_array_equal(t.lookup_input(ids)[0], np.zeros(3))
    dev = t.to_device(device="cpu")
    q = np.array([2, 0, 1, 3, -3], np.int32)
    got = pull_cache_value(dev, torch.from_numpy(q))
    _same(got, jpull_cache_value(jt.to_device(), jnp.asarray(q)))
    np.testing.assert_array_equal(got[0].numpy(), [4, 5, 6])
    # the device gather equals lookup_input wherever lookup_input is defined
    np.testing.assert_array_equal(got[[0, 1, 2, 4]].numpy(), t.lookup_input(q[[0, 1, 2, 4]]))
    assert t.mem_used_mb() == jt.mem_used_mb() == 3 * 3 * 4 / 1024.0 / 1024.0
    with pytest.raises(ValueError, match="dim"):
        t.add_index_data("bad", [1, 2])


def test_to_device_under_a_plan_places_a_replica_on_the_plan_device():
    """With a mesh plan the rows land on the plan's device (every rank
    holds them all); no collective runs."""
    cache = ReplicaCache(dim=2)
    cache.add_batch(np.arange(6, dtype=np.float32).reshape(3, 2))
    plan = MeshPlan(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    dev = cache.to_device(plan)
    assert dev.device == plan.device
    np.testing.assert_array_equal(dev.numpy(), cache.host_array())
    assert not np.shares_memory(dev.numpy(), cache.host_array())
    t = InputTable(dim=2)
    t.add_index_data("k", [7, 8])
    np.testing.assert_array_equal(t.to_device(plan).numpy(), [[0, 0], [7, 8]])


def test_entry_points_default_to_cuda():
    """``to_device`` asks for the card unless the caller names the CPU:
    on a host without one it raises instead of carrying on."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default places the rows on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaCache(dim=2).to_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InputTable(dim=2).to_device()
    with pytest.raises(ValueError, match="no cache gather"):
        pull_cache_value(torch.zeros((2, 2), device="meta"), torch.zeros(1, dtype=torch.int32))
