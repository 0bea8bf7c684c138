"""The port's pv merge, rank_offset and pv packing against the JAX package's.

``data/pv_instance.py`` is pure numpy in both packages, so every result is
held bitwise: the merged pvs (search ids and ad order), the flattened
order, the rank matrices, the packed batches (records, rank matrices and
ghost weights) plain, device-blocked (``n_devices=2``), with lockstep ghost
batches (``min_batches``) and ``drop_remainder``, the oversize-pv
``ValueError``, ``build_pv_plan`` and ``count_pv_batches``. Records are
made from one seed with numpy (about 60 pvs of 1-4 ads, shuffled search
ids, cmatch and rank partly invalid) and fed to both packages. Then the
dataset's ``preprocess_instance`` -> ``pv_plan`` -> ``postprocess_instance``
on the same native-parsed files: plans and the restored ``_order`` bitwise
the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data import pv_instance as jpv
from paddlebox_tpu.data.slot_record import SlotRecord as JSlotRecord
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotRecord, SlotSchema
from paddlebox_tpu_torch.data import pv_instance as pv
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout

torch.set_num_threads(2)

S, B = 3, 16


def _records(seed=0, n_pvs=60, max_ads=4):
    """(port records, JAX records) from one numpy draw: shuffled search
    ids, 1..max_ads ads a pv, cmatch from {222, 223, 999}, rank 0..5;
    ``ins_id`` numbers the records and ``_store_idx`` is set to it."""
    rng = np.random.default_rng(seed)
    sids = rng.permutation(n_pvs) + 1
    rows = []
    for sid in sids:
        for _ in range(int(rng.integers(1, max_ads + 1))):
            rows.append((int(sid), int(rng.choice([222, 222, 223, 999])), int(rng.integers(0, 6)),
                         rng.integers(1, 200, S).astype(np.uint64), float(rng.random() < 0.3)))
    order = rng.permutation(len(rows))  # a shuffled pass: one pv's ads scatter
    out = []
    for cls in (SlotRecord, JSlotRecord):
        recs = []
        for n, j in enumerate(order):
            sid, cm, rk, keys, label = rows[j]
            r = cls(
                u64_values=keys, u64_offsets=np.arange(S + 1, dtype=np.uint32),
                f_values=np.array([label], np.float32), f_offsets=np.array([0, 1], np.uint32),
                ins_id=str(n), search_id=sid, cmatch=cm, rank=rk,
            )
            r._store_idx = n
            recs.append(r)
        out.append(recs)
    return out


def _ids(recs):
    return [r.ins_id for r in recs]


def _pv_ids(pvs):
    return [(p.search_id, _ids(p.ads)) for p in pvs]


@pytest.fixture(scope="module")
def merged():
    recs, jrecs = _records()
    return pv.merge_pv_instances(recs), jpv.merge_pv_instances(jrecs)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_merge_and_flatten_round_trip_match_jax(sort):
    recs, jrecs = _records()
    pvs, jpvs = pv.merge_pv_instances(recs, sort=sort), jpv.merge_pv_instances(jrecs, sort=sort)
    assert _pv_ids(pvs) == _pv_ids(jpvs)
    assert len(pvs) == (60 if sort else len(pvs))
    flat = pv.flatten_pv_instances(pvs)
    assert _ids(flat) == _ids(jpv.flatten_pv_instances(jpvs))
    assert sorted(_ids(flat)) == sorted(_ids(recs))  # a permutation of the pass
    if sort:  # stable: ads of one pv keep the pass's order
        for p in pvs:
            assert [int(i) for i in _ids(p.ads)] == sorted(int(i) for i in _ids(p.ads))


@pytest.mark.parametrize("max_rank", [3, 4])
def test_build_rank_offset_matches_jax(merged, max_rank):
    pvs, jpvs = merged
    n = sum(len(p.ads) for p in pvs)
    for cmatch in ((222, 223), (222,)):
        ro = pv.build_rank_offset(pvs, n + 5, max_rank=max_rank, valid_cmatch=cmatch)
        want = jpv.build_rank_offset(jpvs, n + 5, max_rank=max_rank, valid_cmatch=cmatch)
        assert ro.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(ro, want)
        assert (ro[n:] == -1).all()  # ghost rows


def _same_batches(got, want):
    assert len(got) == len(want)
    for (r, ro, w), (jr, jro, jw) in zip(got, want):
        assert _ids(r) == _ids(jr)
        np.testing.assert_array_equal(ro, jro)
        np.testing.assert_array_equal(w, jw)
        assert ro.dtype == jro.dtype and w.dtype == jw.dtype


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"n_devices": 2},
        {"min_batches": 20},
        {"n_devices": 2, "min_batches": 20},
        {"drop_remainder": True},
        {"max_rank": 4, "valid_cmatch": (222,)},
    ],
    ids=["plain", "n_devices2", "min_batches", "n_devices2_min_batches", "drop_remainder", "rank4_cmatch222"],
)
def test_pack_pv_batches_matches_jax(merged, kw):
    pvs, jpvs = merged
    got = list(pv.pack_pv_batches(pvs, B, **kw))
    want = list(jpv.pack_pv_batches(jpvs, B, **kw))
    _same_batches(got, want)
    n_real = sum(len(p.ads) for p in pvs)
    if "drop_remainder" not in kw:
        assert int(sum(w.sum() for _, _, w in got)) == n_real  # ghosts weigh 0
    if "min_batches" in kw:
        assert len(got) == 20 and (got[-1][1] == -1).all() and not got[-1][2].any()


def test_pack_pv_batches_rejects_what_jax_rejects():
    big = [p for p in pv.merge_pv_instances(_records(max_ads=6)[0]) if len(p.ads) > 4]
    jbig = [p for p in jpv.merge_pv_instances(_records(max_ads=6)[1]) if len(p.ads) > 4]
    assert big
    for mod, pvs in ((pv, big), (jpv, jbig)):
        with pytest.raises(ValueError, match="exceeds join block size"):
            list(mod.pack_pv_batches(pvs, 8, n_devices=2))
        with pytest.raises(ValueError, match="not divisible"):
            list(mod.pack_pv_batches(pvs, 9, n_devices=2))
        with pytest.raises(ValueError, match="conflict"):
            list(mod.pack_pv_batches(pvs, 16, min_batches=3, drop_remainder=True))
        with pytest.raises(ValueError, match="zero page views"):
            list(mod.pack_pv_batches([], 16, min_batches=1))


@pytest.mark.parametrize("n_devices,min_batches", [(1, 0), (2, 0), (2, 20)])
def test_build_pv_plan_and_count_match_jax(merged, n_devices, min_batches):
    pvs, jpvs = merged
    plan = pv.build_pv_plan(pvs, B, max_rank=4, n_devices=n_devices, min_batches=min_batches)
    want = jpv.build_pv_plan(jpvs, B, max_rank=4, n_devices=n_devices, min_batches=min_batches)
    for k in ("idx", "rank_offset", "ins_weight"):
        a, b = getattr(plan, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert plan.n_batches == want.n_batches and plan.n_devices == want.n_devices == n_devices
    count = pv.count_pv_batches(pvs, B, n_devices=n_devices)
    assert count == jpv.count_pv_batches(jpvs, B, n_devices=n_devices)
    assert plan.n_batches == max(count, min_batches)


def test_build_pv_plan_without_store_indices_is_none_in_both(merged):
    recs, jrecs = _records()
    for r in recs + jrecs:
        del r._store_idx
    assert pv.build_pv_plan(pv.merge_pv_instances(recs), B) is None
    assert jpv.build_pv_plan(jpv.merge_pv_instances(jrecs), B) is None
    empty = pv.build_pv_plan([], B, max_rank=4)
    jempty = jpv.build_pv_plan([], B, max_rank=4)
    assert empty.idx.shape == jempty.idx.shape == (0, B)
    assert empty.rank_offset.shape == jempty.rank_offset.shape == (0, B, 9)


# ---- the dataset's join-phase surface on native-parsed files ---------------


def _logkey(sid, cmatch, rank):
    return "0" * 11 + format(cmatch, "03x") + format(rank, "02x") + format(sid, "016x")


def _write_pv_files(tmp_path, n_files=2, n_queries=30, seed=0, logkey=True):
    """Part files of ``n_queries`` pvs of 1-4 ads each, with the logkey
    column unless ``logkey`` is False."""
    rng = np.random.default_rng(seed)
    files, sid = [], 1
    for fi in range(n_files):
        lines = []
        for _ in range(n_queries):
            for r in range(1, int(rng.integers(1, 5)) + 1):
                keys = rng.integers(1, 200, S)
                head = [f"1 {_logkey(sid, int(rng.choice([222, 223])), r)}"] if logkey else []
                parts = head + [f"1 {float(rng.random() < 0.3)}"]
                lines.append(" ".join(parts + [f"1 {k}" for k in keys]))
            sid += 1
        path = os.path.join(str(tmp_path), f"pv-{fi:03d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _schema(info, schema, logkey=True):
    return schema(
        [info("label", type="float", dense=True, dim=1)] + [info(f"s{i}") for i in range(S)],
        label_slot="label", parse_logkey=logkey,
    )


def _datasets(files, logkey=True):
    jds = JBoxPSDataset(
        _schema(JSlotInfo, JSlotSchema, logkey),
        JHostSparseTable(JValueLayout(embedx_dim=4), JSparseOptimizerConfig(), n_shards=2, seed=0),
        batch_size=B, shuffle_mode="local", seed=3,
    )
    ds = BoxPSDataset(
        _schema(SlotInfo, SlotSchema, logkey),
        HostSparseTable(ValueLayout(embedx_dim=4), SparseOptimizerConfig(), n_shards=2, seed=0),
        batch_size=B, shuffle_mode="local", seed=3, read_threads=2,
    )
    for d in (jds, ds):
        d.set_filelist(files)
        d.load_into_memory()
        d.begin_pass(round_to=64)
    return ds, jds


def test_dataset_join_surface_matches_jax(tmp_path):
    assert config.get_flag("enable_native_parser") and jconfig.get_flag("enable_native_parser")
    ds, jds = _datasets(_write_pv_files(tmp_path))
    assert ds.store is not None and jds.store is not None
    np.testing.assert_array_equal(ds._order, jds._order)
    assert ds.current_phase == jds.current_phase == 1
    ds.set_current_phase(1)
    assert ds.preprocess_instance(max_rank=4) == jds.preprocess_instance(max_rank=4) == 60
    assert ds.pv_merged and jds.pv_merged
    assert [r._store_idx for r in ds.records] == [r._store_idx for r in jds.records]
    plan, jplan = ds.pv_plan(), jds.pv_plan()
    for k in ("idx", "rank_offset", "ins_weight"):
        np.testing.assert_array_equal(getattr(plan, k), getattr(jplan, k))
    assert ds.pv_plan() is plan  # cached on the pvs
    assert ds.num_pv_batches() == jds.num_pv_batches() == plan.n_batches
    assert ds.num_pv_batches(global_count=True) == plan.n_batches  # no transport: the local count
    got, want = list(ds.pv_batches()), list(jds.pv_batches())
    assert len(got) == len(want) == plan.n_batches
    for (sb, w), (jsb, jw) in zip(got, want):
        np.testing.assert_array_equal(w, jw)
        for k in ("keys", "key_offsets", "rank_offset", "cmatch", "rank", "search_ids"):
            np.testing.assert_array_equal(getattr(sb, k), getattr(jsb, k))
    assert len(list(ds.pv_batches(2))) == 2
    ds.set_current_phase(0)
    jds.set_current_phase(0)
    ds.postprocess_instance()
    jds.postprocess_instance()
    assert not ds.pv_merged and ds.store is not None  # stays columnar
    np.testing.assert_array_equal(ds._order, jds._order)
    assert ds._order.dtype == jds._order.dtype
    for a, b in zip(ds.batch_indices(), jds.batch_indices()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="preprocess_instance first"):
        ds.pv_plan()


def test_dataset_join_surface_on_records_matches_jax(tmp_path):
    """A pass held as SlotRecords: no plan, and the flattened list becomes
    the pass, in the JAX package's order."""
    files = _write_pv_files(tmp_path, n_files=1)
    before = jconfig.get_flag("enable_native_parser"), config.get_flag("enable_native_parser")
    jconfig.set_flag("enable_native_parser", False)
    config.set_flag("enable_native_parser", False)
    try:
        ds, jds = _datasets(files)
    finally:
        jconfig.set_flag("enable_native_parser", before[0])
        config.set_flag("enable_native_parser", before[1])
    assert ds.store is None and jds.store is None
    assert ds.preprocess_instance() == jds.preprocess_instance() == 30
    assert ds.pv_plan() is None and jds.pv_plan() is None
    ds.postprocess_instance()
    jds.postprocess_instance()
    assert _ids_or_sids(ds.records) == _ids_or_sids(jds.records)


def _ids_or_sids(recs):
    return [(r.search_id, r.rank, r.u64_values.tolist()) for r in recs]


def test_preprocess_instance_needs_logkeys(tmp_path):
    ds, jds = _datasets(_write_pv_files(tmp_path, n_files=1, logkey=False), logkey=False)
    for d in (ds, jds):
        with pytest.raises(RuntimeError, match="parse_logkey"):
            d.preprocess_instance()
