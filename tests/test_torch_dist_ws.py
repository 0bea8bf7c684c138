"""Key ownership and the multi-host pass working set: the port's
``parallel/membership.py`` and ``table/dist_ws.py`` against the JAX
package's, bitwise.

- ``OwnershipMap`` (``even``, ``even_over``, ``shrink``, ``rebalance``,
  ``grow``), its JSON and fingerprint, ``apportion``, ``owner_of_shard``,
  ``plan_rebalance``, ``plan_moves`` and the shard-row wire: the same
  values and bytes as the JAX package's.
- ``DistributedWorkingSet`` at 2 and 4 ranks, each package's world in
  threads over its own transports, on the same key chunks and host table
  contents: ``sorted_keys``, ``row_of_sorted``, ``capacity``,
  ``owned_shard_keys`` and the adaptive wire's ``hot_rows`` (its ``ws-hot``
  round engaged in both registries) bitwise, the finalized blocks and,
  after a writeback of the same trained blocks, the host tables bitwise.
  The layout equals the single-process ``PassWorkingSet``'s (rows of every
  referenced key, capacity), as ``tests/test_multihost.py`` asserts.
- ``migrate_ranges`` / ``commit_staged`` over a rebalance and
  ``hot_shard_loads``: the same moves, bytes and loads.
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest
import torch

import paddlebox_tpu.parallel.membership as jmem
import paddlebox_tpu.table as jtab
import paddlebox_tpu.table.dist_ws as jdws
import paddlebox_tpu.parallel.transport as jtp
import paddlebox_tpu_torch.parallel.membership as tmem
import paddlebox_tpu_torch.table as ttab
import paddlebox_tpu_torch.table.dist_ws as tdws
import paddlebox_tpu_torch.parallel.transport as ttp
from paddlebox_tpu import config as jconfig
from paddlebox_tpu.table.sparse_table import key_to_shard as jkey_to_shard
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table.sparse_table import key_to_shard as tkey_to_shard

torch.set_num_threads(1)

PKG = {"jax": (jmem, jdws, jtab, jtp, jkey_to_shard), "torch": (tmem, tdws, ttab, ttp, tkey_to_shard)}
D = 4
FLAGS = ("ici_wire_dtype", "transport_heartbeat_s")


@pytest.fixture(autouse=True)
def flags():
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in FLAGS]
    for m in (config, jconfig):
        m.set_flag("transport_heartbeat_s", 0.0)
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_ranks(fns, limit=60.0):
    out, errs = [None] * len(fns), []

    def body(r):
        try:
            out[r] = fns[r]()
        except BaseException as e:  # re-raised below
            errs.append(e)

    ths = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(len(fns))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(limit)
    assert not any(t.is_alive() for t in ths), "a rank did not finish"
    if errs:
        raise errs[0]
    return out


# ---- ownership maps -----------------------------------------------------------


def _maps(mem):
    m = mem.OwnershipMap.even(10, 3)
    loads = np.arange(10, dtype=np.float64) ** 2
    return [
        m, mem.OwnershipMap.even(8, 4, epoch=5), mem.OwnershipMap.even_over(9, [0, 2, 5]),
        m.shrink([1]), m.shrink([0, 2]), m.rebalance([0, 2, 7, 10]), m.shrink([1]).grow(1),
        m.shrink([1]).grow(1, shard_loads=loads), mem.OwnershipMap.even(3, 2).grow(5),
    ]


def test_ownership_maps_json_and_fingerprint_bitwise():
    for a, b in zip(_maps(tmem), _maps(jmem)):
        assert a.to_json() == b.to_json()
        assert a.fingerprint() == b.fingerprint()
        assert (a.live_ranks, a.starts, a.epoch) == (b.live_ranks, b.starts, b.epoch)
        shards = np.arange(a.n_mesh_shards)
        np.testing.assert_array_equal(a.owner_of_shard(shards), b.owner_of_shard(shards))
        assert tmem.OwnershipMap.from_json(b.to_json()) == a
        for r in a.live_ranks:
            assert a.range_of(r) == b.range_of(r) and a.n_owned(r) == b.n_owned(r)
    for n, k in ((10, 3), (7, 7), (5, 8), (0, 2)):
        assert tmem.apportion(n, k) == jmem.apportion(n, k)


def test_plans_and_shard_rows_bitwise():
    rng = np.random.default_rng(1)
    loads = rng.random(12) * 10
    loads[:3] *= 20  # skewed
    a = tmem.plan_rebalance(tmem.OwnershipMap.even(12, 3), loads, 1.2)
    b = jmem.plan_rebalance(jmem.OwnershipMap.even(12, 3), loads, 1.2)
    assert a is not None and a.to_json() == b.to_json()
    assert tmem.plan_rebalance(tmem.OwnershipMap.even(12, 3), np.ones(12), 1.2) is None
    assert tmem.plan_moves(tmem.OwnershipMap.even(12, 3), a) == jmem.plan_moves(jmem.OwnershipMap.even(12, 3), b)
    keys = np.sort(rng.integers(1, 10**9, 50).astype(np.uint64))
    rows = rng.random((50, 7)).astype(np.float32)
    wire = tmem.encode_shard_rows(keys, rows)
    assert wire == jmem.encode_shard_rows(keys, rows)
    k2, r2 = tmem.decode_shard_rows(jmem.encode_shard_rows(keys, rows))
    np.testing.assert_array_equal(k2, keys)
    np.testing.assert_array_equal(r2, rows)


# ---- the distributed working set ----------------------------------------------


def _table(tab, seed_keys):
    """A host table whose ``seed_keys`` exist with shows 0..3 (the hotness
    the adaptive wire reads)."""
    lay = tab.ValueLayout(embedx_dim=D)
    t = tab.HostSparseTable(lay, tab.SparseOptimizerConfig(), n_shards=4, seed=0)
    rows = t.pull_or_create(seed_keys)
    rows[:, lay.SHOW] = (np.arange(len(seed_keys)) % 4).astype(np.float32)
    t.push(seed_keys, rows)
    return t


def _chunks(n_ranks, seed=5):
    rng = np.random.default_rng(seed)
    return [[rng.integers(1, 3000, 400).astype(np.uint64) for _ in range(3)] for _ in range(n_ranks)]


def _world(kind, n_ranks, n_mesh, chunks, adaptive):
    """Finalize + writeback a DWS on every rank of one package's world:
    per rank (ws, block, host keys, host rows)."""
    mem, dws, tab, tp, key_to_shard = PKG[kind]
    (jconfig if kind == "jax" else config).set_flag("ici_wire_dtype", "adaptive" if adaptive else "fp32")
    eps = [f"127.0.0.1:{p}" for p in _free_ports(n_ranks)]
    ts = [tp.TcpTransport(r, eps, timeout=30.0) for r in range(n_ranks)]
    seed_keys = np.unique(np.concatenate([c[0] for c in chunks]))
    omap = mem.OwnershipMap.even(n_mesh, n_ranks)

    def rank(r):
        def body():
            lo, hi = omap.range_of(r)
            from_keys = seed_keys[np.isin(key_to_shard(seed_keys, n_mesh), np.arange(lo, hi))]
            table = _table(tab, from_keys)
            ws = dws.DistributedWorkingSet(ts[r], n_mesh, pass_id=2, epoch=0, ownership=omap)
            for c in chunks[r]:
                ws.add_keys(c)
            block = np.asarray(ws.finalize(table, round_to=16))
            trained = block + np.float32(0.5) * (1 + r)  # the same "training" in both packages
            ws.writeback(trained)
            keys = np.sort(table.keys())
            return ws, block, keys, table.pull_or_create(keys)

        return body

    try:
        return run_ranks([rank(r) for r in range(n_ranks)])
    finally:
        for t in ts:
            t.close()


@pytest.mark.parametrize("n_ranks,n_mesh,adaptive", [(2, 2, True), (2, 4, False), (4, 4, True), (4, 8, True)])
def test_dist_ws_bitwise_against_jax(n_ranks, n_mesh, adaptive):
    chunks = _chunks(n_ranks, seed=n_ranks * 10 + n_mesh)
    port = _world("torch", n_ranks, n_mesh, chunks, adaptive)
    jax_ = _world("jax", n_ranks, n_mesh, chunks, adaptive)
    for (ws, block, keys, rows), (jws, jblock, jkeys, jrows) in zip(port, jax_):
        np.testing.assert_array_equal(ws.sorted_keys, jws.sorted_keys)
        np.testing.assert_array_equal(ws.row_of_sorted, jws.row_of_sorted)
        assert ws.capacity == jws.capacity and ws.n_keys == jws.n_keys
        assert len(ws.owned_shard_keys) == len(jws.owned_shard_keys) == n_mesh // n_ranks
        for a, b in zip(ws.owned_shard_keys, jws.owned_shard_keys):
            np.testing.assert_array_equal(a, b)
        if adaptive:
            assert ws.hot_rows is not None and ws.hot_rows.any()
            np.testing.assert_array_equal(ws.hot_rows, jws.hot_rows)
        else:
            assert ws.hot_rows is None and jws.hot_rows is None
        np.testing.assert_array_equal(block, jblock)
        np.testing.assert_array_equal(keys, jkeys)
        np.testing.assert_array_equal(rows, jrows)
    # host tables disjoint, their union every referenced key
    owned = [p[2] for p in port]
    for a in range(n_ranks):
        for b in range(a + 1, n_ranks):
            assert len(np.intersect1d(owned[a], owned[b])) == 0
    referenced = np.unique(np.concatenate([c for cs in chunks for c in cs]))
    assert np.isin(referenced, np.concatenate(owned)).all()


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dist_ws_layout_equals_pass_working_set(n_ranks):
    """The layout depends only on the shard count and the keys: every
    host's rows are the single-process PassWorkingSet's."""
    chunks = _chunks(n_ranks, seed=3)
    port = _world("torch", n_ranks, n_ranks, chunks, False)
    pws = ttab.PassWorkingSet(n_mesh_shards=n_ranks)
    for cs in chunks:
        for c in cs:
            pws.add_keys(c)
    lay = ttab.ValueLayout(embedx_dim=D)
    pws.finalize(ttab.HostSparseTable(lay, ttab.SparseOptimizerConfig(), n_shards=4, seed=0), round_to=16)
    for ws, *_ in port:
        assert ws.capacity == pws.capacity
        np.testing.assert_array_equal(ws.row_of_sorted, pws.lookup(ws.sorted_keys).astype(np.int64))
        np.testing.assert_array_equal(ws.lookup(ws.sorted_keys), pws.lookup(ws.sorted_keys))


def _migrate(kind):
    mem, dws, tab, tp, key_to_shard = PKG[kind]
    n = 2
    eps = [f"127.0.0.1:{p}" for p in _free_ports(n)]
    ts = [tp.TcpTransport(r, eps, timeout=30.0) for r in range(n)]
    old = mem.OwnershipMap.even(8, n)
    new = old.rebalance([0, 3, 8])
    rng = np.random.default_rng(9)
    all_keys = np.unique(rng.integers(1, 5000, 600).astype(np.uint64))
    shard = key_to_shard(all_keys, 8)

    def rank(r):
        def body():
            lo, hi = old.range_of(r)
            table = _table(tab, all_keys[(shard >= lo) & (shard < hi)])
            loads = dws.hot_shard_loads(table, old, r)
            st = mem.migrate_ranges(ts[r], table, old, new, "m1", epoch=1)
            n_commit = mem.commit_staged(table, st["staged"])
            keys = np.sort(table.keys())
            return loads, {k: v for k, v in st.items() if k != "staged"}, n_commit, keys, table.pull_or_create(keys)

        return body

    try:
        return run_ranks([rank(r) for r in range(n)])
    finally:
        for t in ts:
            t.close()


def test_migrate_and_hot_loads_bitwise():
    port, jax_ = _migrate("torch"), _migrate("jax")
    moved = 0
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        assert a[2] == b[2]
        moved += a[2]
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[4], b[4])
    assert moved > 0


@pytest.mark.parametrize("stale", [False, True])
def test_adopt_dead_shards_bitwise(tmp_path, stale):
    """A survivor adopts the shard ranges it gained from a dead rank's
    last checkpoint (and, with a chain older than the map, the previous
    owners' pieces): the same keys and rows in both packages."""
    import paddlebox_tpu.train.checkpoint as jck
    import paddlebox_tpu_torch.train.checkpoint as tck

    out = {}
    for kind, ck in (("torch", tck), ("jax", jck)):
        mem, _, tab, _, key_to_shard = PKG[kind]
        root = str(tmp_path / kind)
        keys = np.unique(np.random.default_rng(4).integers(1, 9000, 800).astype(np.uint64))
        shard = key_to_shard(keys, 6)
        old = mem.OwnershipMap.even(6, 3)
        new = old.shrink([1])
        prev = mem.OwnershipMap.even(6, 3, epoch=0) if stale else None
        if stale:
            old = mem.OwnershipMap(6, [0, 1, 2], [0, 1, 4, 6], epoch=1)
            new = old.shrink([1])
        for r in (0, 1, 2):
            lo, hi = (prev or old).range_of(r)
            t = _table(tab, keys[(shard >= lo) & (shard < hi)])
            ck.CheckpointManager(ck.rank_root(root, r)).save_base("20260101", t)
        lo, hi = old.range_of(0)
        survivor = _table(tab, keys[(shard >= lo) & (shard < hi)])
        n = mem.adopt_dead_shards(survivor, root, 1, old, new, 0, prev_map=prev)
        k = np.sort(survivor.keys())
        out[kind] = (n, k, survivor.pull_or_create(k))
    assert out["torch"][0] == out["jax"][0] > 0
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
