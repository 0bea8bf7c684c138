"""The port's AucRunner against the JAX package's: the reservoir pools,
the per-record draws and the shuffled records are bitwise the JAX
package's for the same seeds (numpy draws alike), the replace and
replace-back round trip is exact, and the dataset hook (``slots_shuffle``,
``auc_runner_phase``) shuffles a loaded pass the same way in both."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu.data as jdata
import paddlebox_tpu.metrics as jmetrics
import paddlebox_tpu.table as jtable
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.metrics as tmetrics
import paddlebox_tpu_torch.table as ttable
from paddlebox_tpu.data.slot_record import SlotRecord as JSlotRecord
from paddlebox_tpu_torch.data.slot_record import SlotRecord

torch.set_num_threads(2)

NUM_SLOTS = 4
PKGS = {"torch": (tdata, tmetrics, SlotRecord, ttable, tconfig), "jax": (jdata, jmetrics, JSlotRecord, jtable, jconfig)}


def make_schema(pkg):
    d = PKGS[pkg][0]
    return d.SlotSchema(
        [d.SlotInfo("label", type="float", dense=True, dim=1)] + [d.SlotInfo(f"s{i}") for i in range(NUM_SLOTS)],
        label_slot="label",
    )


def make_records(pkg, seed, n, max_len=3):
    rng = np.random.default_rng(seed)
    rec_cls = PKGS[pkg][2]
    recs = []
    for _ in range(n):
        lens = rng.integers(1, max_len + 1, NUM_SLOTS)
        off = np.zeros(NUM_SLOTS + 1, dtype=np.uint32)
        np.cumsum(lens, out=off[1:])
        recs.append(
            rec_cls(
                u64_values=rng.integers(1, 1000, int(off[-1])).astype(np.uint64),
                u64_offsets=off,
                f_values=np.array([1.0], np.float32),
                f_offsets=np.array([0, 1], np.uint32),
            )
        )
    return recs


def snapshot(recs):
    return [(r.u64_values.tolist(), r.u64_offsets.tolist()) for r in recs]


def test_reservoir_pool_matches_jax():
    got = {}
    for pkg in PKGS:
        pool = PKGS[pkg][1].CandidatePool(capacity=10, rng=np.random.default_rng(0))
        ids = [pool.add_and_get({0: np.array([i], np.uint64)}) for i in range(500)]
        got[pkg] = (ids, [int(c[0][0]) for c in pool.candidates])
        assert len(pool) == 10 and all(0 <= i < 10 for i in ids)
    assert got["torch"] == got["jax"]
    assert max(got["torch"][1]) >= 250


@pytest.mark.parametrize("pool_num", [1, 3])
def test_shuffles_and_roundtrip_match_jax(pool_num):
    """observe, then shuffle s1, s3 (restoring s1 first), s3 again, and
    restore: after every call the records and the counts are JAX's, and
    the final restore gives the original records back."""
    got = {}
    for pkg in PKGS:
        recs = make_records(pkg, 1, 40)
        before = snapshot(recs)
        runner = PKGS[pkg][1].AucRunner(
            make_schema(pkg), replaced_slots=["s1", "s3"], capacity=8, pool_num=pool_num, seed=0
        )
        runner.observe(recs)
        steps = [(runner._pool_id.tolist(), runner._replaced_id.tolist())]
        for slots in ({"s1"}, {"s3"}, {"s3"}, set()):
            n0 = sum(len(r.u64_values) for r in recs)
            st = runner.slots_shuffle(recs, slots)
            assert sum(len(r.u64_values) for r in recs) - n0 == st["added"] - st["deleted"]
            steps.append((st, snapshot(recs), runner.phase))
        assert snapshot(recs) == before
        got[pkg] = steps
    assert got["torch"] == got["jax"]
    assert got["torch"][1][2] == 0 and got["torch"][-1][2] == 1  # flipped 4 times from 1


def test_undeclared_slot_and_unobserved_runner_rejected():
    recs = make_records("torch", 2, 5)
    runner = tmetrics.AucRunner(make_schema("torch"), replaced_slots=["s1"], capacity=4)
    runner.observe(recs)
    with pytest.raises(ValueError):
        runner.slots_shuffle(recs, {"s0"})
    with pytest.raises(ValueError, match="changed"):
        runner.slots_shuffle(recs[:3], {"s1"})
    with pytest.raises(RuntimeError):
        tmetrics.AucRunner(make_schema("torch"), replaced_slots=["s1"], capacity=4).slots_shuffle(recs, {"s1"})


@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_dataset_slots_shuffle_matches_jax(tmp_path, native):
    """A loaded pass (local shuffle, the native store or records) shuffled
    slot by slot through the dataset hook: the same records, phases and
    batches as the JAX package's, the keys still in the working set, and
    the store rebuilt for the columnar feeds."""
    rng = np.random.default_rng(4)
    lines = []
    for _ in range(64):
        ks = rng.integers(1, 50, NUM_SLOTS)
        lines.append("1 1.0 " + " ".join(f"1 {k}" for k in ks))
    p = tmp_path / "part-000.txt"
    p.write_text("\n".join(lines) + "\n")
    got = {}
    for pkg in PKGS:
        data, _, _, table_mod, cfg = PKGS[pkg]
        prev = cfg.get_flag("enable_native_parser"), cfg.get_flag("auc_runner_pool_size")
        cfg.set_flag("enable_native_parser", native)
        cfg.set_flag("auc_runner_pool_size", 16)
        try:
            table = table_mod.HostSparseTable(
                table_mod.ValueLayout(embedx_dim=4), table_mod.SparseOptimizerConfig(), n_shards=4, seed=0
            )
            ds = data.BoxPSDataset(make_schema(pkg), table, batch_size=8, read_threads=1, shuffle_mode="local", seed=2)
            ds.set_date("20260101")
            ds.set_filelist([str(p)])
            ds.load_into_memory()
            ds.begin_pass(round_to=32)
            out = [ds.auc_runner_phase]
            for slots in (["s0"], ["s2"], []):
                st = ds.slots_shuffle(slots)
                if native:
                    assert ds.store is not None and ds._order is None
                for b in ds.batches():
                    ds.ws.lookup(b.keys)
                out.append((st, ds.auc_runner_phase, snapshot(ds.records)))
            ds.end_pass(None, shrink=False)
            assert ds._auc_runner is None
        finally:
            cfg.set_flag("enable_native_parser", prev[0])
            cfg.set_flag("auc_runner_pool_size", prev[1])
        got[pkg] = out
    assert got["torch"] == got["jax"]
    assert [o if isinstance(o, int) else o[1] for o in got["torch"]] == [1, 0, 1, 0]
