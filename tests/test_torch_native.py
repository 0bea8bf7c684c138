"""The port's native host tier and columnar record store against the JAX
package's.

Both packages build the same ``csrc/*.cc`` sources, so the parser's
columns, the native store's rows (a pure function of seed and key), its
push and its decay-and-shrink must all be bitwise equal. The record
store's operations are numpy over those columns and must be bitwise
equal too. Last, the port's native tier raises when it cannot be built:
nothing falls back to the Python tier.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data.record_store import ColumnarRecords as JColumnarRecords
from paddlebox_tpu.data.record_store import _ragged_indices as j_ragged_indices
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.utils import native as jnative
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, ColumnarRecords, SlotInfo, SlotSchema, parse_line
from paddlebox_tpu_torch.data.record_store import _ragged_indices
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.utils import native

torch.set_num_threads(2)

S, D = 5, 4
COLUMNS = (
    "u64_values", "u64_offsets", "u64_base", "f_values", "f_offsets", "f_base",
    "search_ids", "cmatch", "rank", "ins_id_off",
)


def _schema(info_cls, schema_cls, ids=False):
    slots = [info_cls("label", type="float", dense=True, dim=1), info_cls("f", type="float")]
    slots += [info_cls(f"s{i}") for i in range(S)]
    return schema_cls(slots, parse_ins_id=ids, parse_logkey=ids, label_slot="label")


def _lines(seed, n=40, ids=False):
    """Slot lines: 1-3 keys a slot from a small vocabulary (cross-slot
    duplicates), a ragged float slot of 1-3 values, and every tenth record
    without feasigns (all its keys 0, so it is skipped)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = []
        if ids:
            parts.append(f"1 ins{seed}_{i}")
            parts.append("1 " + "".join(rng.choice(list("0123456789abcdef"), 32)))
        parts.append(f"1 {float(rng.integers(0, 2))}")
        nf = int(rng.integers(1, 4))
        parts.append(f"{nf} " + " ".join(f"{v:.4f}" for v in rng.uniform(0.5, 2.0, nf)))
        for _ in range(S):
            k = int(rng.integers(1, 4))
            vals = np.zeros(k, int) if i % 10 == 9 else rng.integers(1, 60, k)
            parts.append(f"{k} " + " ".join(str(int(v)) for v in vals))
        out.append(" ".join(parts))
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_store(got, want):
    for name in COLUMNS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            _same(g, w)
    assert got.ins_id_chars == want.ins_id_chars


def _stores(seed, ids=False, n=40):
    data = "\n".join(_lines(seed, n, ids)).encode()
    st, jst = {}, {}
    got = native.parse_buffer_columnar(data, _schema(SlotInfo, SlotSchema, ids), st)
    want = jnative.parse_buffer_columnar(data, _schema(JSlotInfo, JSlotSchema, ids), jst)
    assert st == jst
    return got, want


@pytest.mark.parametrize("ids", [False, True], ids=["plain", "ins_id_logkey"])
def test_parse_buffer_columnar_matches_jax_and_parse_line(ids):
    lines = _lines(1, ids=ids)
    schema = _schema(SlotInfo, SlotSchema, ids)
    st, jst = {}, {}
    got = native.parse_buffer_columnar("\n".join(lines).encode(), schema, st)
    want = jnative.parse_buffer_columnar(
        "\n".join(lines).encode(), _schema(JSlotInfo, JSlotSchema, ids), jst
    )
    _same_store(got, want)
    assert st == jst == {"skipped": 4}
    recs = [r for r in (parse_line(ln, schema) for ln in lines) if r is not None]
    assert len(recs) == len(got) == 36
    for r, c in zip(recs, got.records()):
        _same(c.u64_values, r.u64_values)
        _same(c.u64_offsets, r.u64_offsets)
        _same(c.f_values, r.f_values)
        _same(c.f_offsets, r.f_offsets)
        assert (c.ins_id, c.search_id, c.cmatch, c.rank) == (r.ins_id, r.search_id, r.cmatch, r.rank)


def test_parse_buffer_columnar_raises_on_a_bad_line_like_jax():
    lines = _lines(2, n=6)
    lines[3] = lines[3].replace("1 ", "0 ", 1)  # a zero-count slot is malformed
    data = "\n".join(lines).encode()
    with pytest.raises(ValueError):
        jnative.parse_buffer_columnar(data, _schema(JSlotInfo, JSlotSchema))
    with pytest.raises(ValueError, match="native slot parse failed"):
        native.parse_buffer_columnar(data, _schema(SlotInfo, SlotSchema))


def test_record_store_ops_match_jax_bitwise():
    (a, ja), (b, jb) = _stores(3), _stores(4, n=25)
    cat, jcat = ColumnarRecords.concat([a, b]), JColumnarRecords.concat([ja, jb])
    _same_store(cat, jcat)
    _same(cat.key_counts(), jcat.key_counts())
    assert (cat.n_sparse, cat.n_float, len(cat)) == (jcat.n_sparse, jcat.n_float, len(jcat)) == (S, 2, 59)
    sel = np.random.default_rng(5).permutation(len(cat))[:31]
    _same_store(cat.select(sel), jcat.select(sel))
    # from_records over the record views rebuilds the same columns
    schema, jschema = _schema(SlotInfo, SlotSchema), _schema(JSlotInfo, JSlotSchema)
    _same_store(ColumnarRecords.from_records(cat.records(), schema),
                JColumnarRecords.from_records(jcat.records(), jschema))
    _same_store(ColumnarRecords.empty(S, 2), JColumnarRecords.empty(S, 2))
    starts = np.array([4, 0, 9, 9, 30], np.int64)
    lens = np.array([3, 0, 2, 5, 1], np.int64)
    _same(_ragged_indices(starts, lens), j_ragged_indices(starts, lens))
    # resolve_rows against one finalize of each package's working set
    ws, jws = PassWorkingSet(n_mesh_shards=2), JPassWorkingSet(n_mesh_shards=2)
    ws.add_keys(cat.u64_values)
    jws.add_keys(jcat.u64_values)

    class Rows:
        def __init__(self, layout):
            self.layout = layout

        def pull_or_create(self, keys):
            return np.zeros((len(keys), self.layout.width), np.float32)

    ws.finalize(Rows(ValueLayout(embedx_dim=D)), round_to=8)
    jws.finalize(Rows(JValueLayout(embedx_dim=D)), round_to=8)
    _same(cat.resolve_rows(ws), jcat.resolve_rows(jws))
    assert cat.resolve_rows(ws) is cat.resolve_rows(ws)  # cached per working set
    cat.invalidate_rows()
    _same(cat.resolve_rows(ws), jcat.resolve_rows(jws))


@pytest.mark.parametrize("native_gather", [True, False], ids=["native", "python"])
def test_float_slot_matrix_matches_jax_bitwise(native_gather):
    got, want = _stores(6)
    before = config.get_flag("enable_native_parser")
    config.set_flag("enable_native_parser", native_gather)
    try:
        idx = np.arange(len(got))[::-1].copy()
        for slot, dim in ((0, 1), (1, 2), (1, 3)):  # the label, the ragged slot cut and padded
            _same(got.float_slot_matrix(slot, dim, idx), want.float_slot_matrix(slot, dim, idx))
        _same(got.float_slot_matrix(1, 2), want.float_slot_matrix(1, 2))
    finally:
        config.set_flag("enable_native_parser", before)


@pytest.fixture
def native_tables(monkeypatch):
    """(port table, JAX table), both on their native store, one seed."""
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")
    kw = dict(show_clk_decay=0.9, shrink_threshold=1.5, initial_range=0.02)
    jt = JHostSparseTable(JValueLayout(embedx_dim=D), JSparseOptimizerConfig(**kw), n_shards=8, seed=3)
    t = HostSparseTable(ValueLayout(embedx_dim=D), SparseOptimizerConfig(**kw), n_shards=8, seed=3)
    assert t.native and jt._native is not None
    return t, jt


def _contents(table):
    keys = np.sort(table.keys())
    return keys, table.pull_or_create(keys)


def test_native_store_pull_push_shrink_match_jax_bitwise(native_tables):
    t, jt = native_tables
    rng = np.random.default_rng(0)
    first = np.unique(rng.integers(1, 1 << 40, 300, dtype=np.uint64))
    second = np.unique(np.concatenate([first[::3], rng.integers(1, 1 << 40, 200, dtype=np.uint64)]))
    for keys in (first, second):
        _same(t.pull_or_create(keys), jt.pull_or_create(keys))
    assert len(t) == len(jt) == len(np.union1d(first, second))
    keys = np.union1d(first, second)
    rows = rng.normal(size=(len(keys), t.layout.width)).astype(np.float32)
    rows[:, t.layout.SHOW] = rng.integers(0, 4, len(keys))  # some fall under the shrink line
    new_keys = np.unique(rng.integers(1 << 41, 1 << 42, 30, dtype=np.uint64))
    new_rows = np.full((len(new_keys), t.layout.width), 5.0, np.float32)
    for tab in (t, jt):
        tab.push(keys, rows)
        tab.push(new_keys, new_rows)  # absent keys are added
    _same(t.pull_or_create(keys), rows)
    for _ in range(2):
        assert t.decay_and_shrink() == jt.decay_and_shrink()
    assert len(t) == len(jt)
    kept, got = _contents(t)
    jkept, want = _contents(jt)
    _same(kept, jkept)
    _same(got, want)


@pytest.mark.parametrize("threads,chunk", [(1, 2_000_000), (4, 64), (3, 1000)])
def test_native_writeback_matches_jax_bitwise(native_tables, threads, chunk):
    """The chunked writer-pool writeback gives the JAX package's table at
    every thread count and chunk size."""
    t, jt = native_tables
    rng = np.random.default_rng(2)
    keys = rng.integers(1, 1 << 40, 500, dtype=np.uint64)
    ws, jws = PassWorkingSet(n_mesh_shards=2), JPassWorkingSet(n_mesh_shards=2)
    for w in (ws, jws):
        w.add_keys(keys[:300])
        w.add_keys(keys[200:])
    dev, jdev = ws.finalize(t, round_to=16), jws.finalize(jt, round_to=16)
    _same(dev, jdev)
    trained = dev + rng.normal(size=dev.shape).astype(np.float32)
    before = config.get_flag("writeback_threads"), config.get_flag("writeback_chunk_keys")
    config.set_flag("writeback_threads", threads)
    config.set_flag("writeback_chunk_keys", chunk)
    try:
        ws.writeback(trained)
    finally:
        config.set_flag("writeback_threads", before[0])
        config.set_flag("writeback_chunk_keys", before[1])
    jws.writeback(trained.copy())
    k, got = _contents(t)
    jk, want = _contents(jt)
    _same(k, jk)
    _same(got, want)


def test_library_name_carries_the_sources_and_flags(monkeypatch):
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


@pytest.mark.parametrize("how", ["no_compiler", "compile_error"])
def test_native_tier_raises_when_it_cannot_build(tmp_path, monkeypatch, how):
    """Asked for and unbuildable, the native tier raises RuntimeError at
    every entry point; nothing falls back to the Python tier."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    if how == "no_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-include", str(tmp_path / "no-such.h")))
    with pytest.raises(RuntimeError, match="native host tier"):
        native.load()
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")
    with pytest.raises(RuntimeError, match="native host tier"):
        HostSparseTable(ValueLayout(embedx_dim=D), n_shards=2)
    path = tmp_path / "part-000.txt"
    path.write_text("\n".join(_lines(7, n=4)) + "\n")
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "0")
    before = config.get_flag("enable_native_parser")
    config.set_flag("enable_native_parser", True)
    try:
        ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), HostSparseTable(ValueLayout(embedx_dim=D), n_shards=2),
                          batch_size=2)
        ds.set_filelist([str(path)])
        with pytest.raises(RuntimeError, match="native host tier"):
            ds.load_into_memory()
        assert ds.store is None and ds.memory_data_size() == 0
    finally:
        config.set_flag("enable_native_parser", before)
    assert list((tmp_path / "build").glob("*.so")) == []  # no half-built library left behind


def test_dataset_native_tier_matches_jax_records(tmp_path, monkeypatch):
    """load_into_memory through the native parser holds the JAX package's
    store and shuffle order; records views and batch indices agree."""
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")
    files = []
    for fi in range(3):
        path = tmp_path / f"part-{fi:03d}.txt"
        path.write_text("\n".join(_lines(10 + fi)) + "\n")
        files.append(str(path))
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset

    assert jconfig.get_flag("enable_native_parser") and config.get_flag("enable_native_parser")
    lay, jlay = ValueLayout(embedx_dim=D), JValueLayout(embedx_dim=D)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), HostSparseTable(lay, n_shards=4, seed=1),
                      batch_size=16, shuffle_mode="local", seed=9, read_threads=2)
    jds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), JHostSparseTable(jlay, n_shards=4, seed=1),
                        batch_size=16, shuffle_mode="local", seed=9)
    for d in (ds, jds):
        d.set_filelist(files)
        d.load_into_memory()
    assert ds.store is not None and jds.store is not None
    _same_store(ds.store, jds.store)
    _same(ds._order, jds._order)
    assert ds.memory_data_size() == jds.memory_data_size() == 108
    for a, b in zip(ds.batch_indices(9), jds.batch_indices(9)):  # 9 > 6 batches: wraps
        _same(a, b)
    _same(ds.records[5].u64_values, jds.records[5].u64_values)
    _same(ds.begin_pass(round_to=16), np.asarray(jds.begin_pass(round_to=16)))


def test_native_snapshot_and_touched_set_match_jax(native_tables):
    """Per-shard snapshots, all rows or only those pushed since the touched
    set was cleared, give the JAX package's keys and rows."""
    t, jt = native_tables
    rng = np.random.default_rng(8)
    keys = np.unique(rng.integers(1, 1 << 40, 200, dtype=np.uint64))
    for tab in (t, jt):
        tab.pull_or_create(keys)
        tab._native.clear_touched()
        tab.push(keys[::4], np.full((len(keys[::4]), tab.layout.width), 2.0, np.float32))
    for shard in range(t.n_shards):
        _same(np.sort(t._native.shard_keys(shard)), np.sort(jt._native.shard_keys(shard)))
        for only_touched in (False, True):
            got = t._native.snapshot_shard(shard, only_touched, clear_touched=only_touched)
            want = jt._native.snapshot_shard(shard, only_touched, clear_touched=only_touched)
            for g, w in zip(got, want):
                _same(g, w)
    touched = np.concatenate([t._native.snapshot_shard(s, True, False)[0] for s in range(t.n_shards)])
    assert len(touched) == 0  # cleared by the snapshots above



@pytest.mark.parametrize(
    "base, counts",
    [([0, 3, 6], [3, 3, 5]), ([0, -1, 4], [3, 2, 2]), ([0, 3, 4], [3, -1, 2])],
    ids=["span_past_rows", "negative_base", "negative_count"],
)
def test_block_stats_raises_on_a_record_span_outside_rows(base, counts):
    """A record whose key span leaves the rows array raises before the
    native sweep reads it, with the message its own range check gives."""
    rows = np.arange(10, dtype=np.int32)
    blocks = np.array([[0, 1]], np.int64)  # the bad record need not be in a block
    with pytest.raises(ValueError, match="out of range"):
        native.block_stats(rows, np.array(base, np.int64), np.array(counts, np.int64), blocks, 16, 1)


def test_block_stats_counts_in_span_records():
    rows = np.array([0, 1, 1, 2, 17, 17], np.int32)
    L, bmax = native.block_stats(
        rows, np.array([0, 3], np.int64), np.array([3, 3], np.int64),
        np.array([[0, 1], [1, 1]], np.int64), 16, 2,
    )
    assert L.tolist() == [6, 6]
    assert bmax.tolist() == [3, 1]
