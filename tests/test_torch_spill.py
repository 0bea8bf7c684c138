"""The port's disk (spill) tier against the JAX package's.

Both packages build the unedited ``csrc/host_table.cc`` into their own
library; each table spills into its own directory. The same pushes and the
same sweep under every policy (freq, fifo, pin, admission) give equal
``tier_stats`` and bitwise-equal rows; a spilled row promotes with the
decays it missed, bitwise equal to a table that never spilled; a dataset
pass with ``mem_cap_rows`` ends, spills and promotes to the same table in
both packages. The trained table fed to ``end_pass`` is a fixed function of
the pass table, so the comparison is bitwise.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import SpillIOError as JSpillIOError
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.utils import faultinject as jfault
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, SpillIOError, ValueLayout
from paddlebox_tpu_torch.utils import faultinject as fault
from paddlebox_tpu_torch.utils.monitor import STAT_GET

torch.set_num_threads(2)

SPILL_FLAGS = ("spill_policy", "spill_pin_show", "spill_admit_show")
S, B = 3, 16


@pytest.fixture(autouse=True)
def _restore_spill_flags():
    saved = [{n: c.get_flag(n) for n in SPILL_FLAGS} for c in (config, jconfig)]
    yield
    for c, vals in zip((config, jconfig), saved):
        for n, v in vals.items():
            c.set_flag(n, v)


def set_flags(**kw):
    for c in (config, jconfig):
        for n, v in kw.items():
            c.set_flag(n, v)


def make_pair(tmp_path, n_shards=4, decay=0.9, cap=None, embedx=3, spill=True):
    """(port table, JAX table), native, each spilling into its own dir."""
    out = []
    for name, (T, L, O) in (
        ("port", (HostSparseTable, ValueLayout, SparseOptimizerConfig)),
        ("jax", (JHostSparseTable, JValueLayout, JSparseOptimizerConfig)),
    ):
        t = T(L(embedx_dim=embedx), O(show_clk_decay=decay, shrink_threshold=0.0), n_shards=n_shards, seed=0,
              spill_dir=str(tmp_path / f"spill-{name}") if spill else None, mem_cap_rows=cap)
        assert t.native
        out.append(t)
    return out


def seed_shows(tables, keys, show, seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((len(keys), tables[0].layout.width)).astype(np.float32)
    for t in tables:
        rows = t.pull_or_create(keys)
        rows += noise
        rows[:, t.layout.SHOW] = show
        t.push(keys, rows)


def assert_same_rows(t, j, keys):
    np.testing.assert_array_equal(t.pull_or_create(keys), j.pull_or_create(keys))


CASES = {
    # policy flags, hot show, cold show, cap: each JAX tiered-store case
    "freq": (dict(spill_policy="freq"), 50.0, 1.0, 200),
    "fifo": (dict(spill_policy="fifo"), 50.0, 1.0, 200),
    "pin": (dict(spill_policy="freq", spill_pin_show=10.0), 50.0, 1.0, 50),
    "admit": (dict(spill_policy="freq", spill_admit_show=5.0), 10.0, 1.0, 90),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spill_policies_match_jax(tmp_path, case):
    flags, hot_show, cold_show, cap = CASES[case]
    t, j = make_pair(tmp_path, n_shards=1 if case != "freq" else 4)
    hot = np.arange(1, 101, dtype=np.uint64)
    cold = np.arange(1001, 1101 if case in ("pin", "admit") else 1901, dtype=np.uint64)
    seed_shows((t, j), hot, hot_show, seed=1)
    seed_shows((t, j), cold, cold_show, seed=2)
    set_flags(**flags)
    assert t.spill_cold(cap) == j.spill_cold(cap) > 0
    assert t.tier_stats() == j.tier_stats()
    assert (t.mem_rows, t.disk_rows) == (j.mem_rows, j.disk_rows)
    assert t.disk_rows > 0
    np.testing.assert_array_equal(t.shows_peek(np.concatenate([hot, cold])),
                                  j.shows_peek(np.concatenate([hot, cold])))
    assert t.spill_stats() == j.spill_stats()
    # promotes: same counters, same rows
    assert_same_rows(t, j, hot)
    assert t.tier_stats() == j.tier_stats()
    assert_same_rows(t, j, cold)
    assert t.tier_stats() == j.tier_stats()
    assert t.compact_spill() == j.compact_spill()
    assert t.spill_stats() == j.spill_stats()


def test_promote_catchup_bitwise_with_thresholds(tmp_path):
    """Spill, five decays, promote: bitwise the table that never spilled,
    with pin and admission on and a rate (0.9) whose powers are not exact
    in fp32, and bitwise the JAX package's spilled table."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, 1 << 48, 3000).astype(np.uint64))
    t, j = make_pair(tmp_path)
    control = HostSparseTable(ValueLayout(embedx_dim=3), SparseOptimizerConfig(show_clk_decay=0.9,
                              shrink_threshold=0.0), n_shards=4, seed=0)
    vals = rng.normal(0, 1, (len(keys), t.layout.width)).astype(np.float32)
    vals[:, t.layout.SHOW] = rng.uniform(0.5, 60.0, len(keys)).astype(np.float32)
    for tab in (t, j, control):
        tab.pull_or_create(keys)
        tab.push(keys, vals.copy())
    set_flags(spill_policy="freq", spill_pin_show=30.0, spill_admit_show=2.0)
    assert t.spill_cold(len(keys) // 3) == j.spill_cold(len(keys) // 3)
    assert t.tier_stats()["disk_rows"] > 0
    for _ in range(5):
        for tab in (t, j, control):
            tab.decay_and_shrink()
    got = t.pull_or_create(keys)
    np.testing.assert_array_equal(got, control.pull_or_create(keys))
    np.testing.assert_array_equal(got, j.pull_or_create(keys))
    assert t.tier_stats() == j.tier_stats()


def _write_files(tmp_path, tag, seed, lo, hi, n_files=2, n_rec=96):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        keys = rng.integers(lo, hi, (n_rec, S))
        labels = (rng.random(n_rec) < 0.3).astype(int)
        path = os.path.join(str(tmp_path), f"{tag}-{fi}.txt")
        with open(path, "w") as f:
            for i in range(n_rec):
                f.write(f"1 {labels[i]}.0 " + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files


def _trained(dev_table, layout, p):
    """A fixed stand-in for a trained pass table: more shows, moved rows."""
    flat = dev_table.reshape(-1, dev_table.shape[-1]).copy()
    flat[:, layout.SHOW] += 1.0 + (np.arange(len(flat)) % 5)
    flat[:, layout.CLK] += (np.arange(len(flat)) % 2)
    flat[:, layout.embed_w_col:] += np.float32(0.01 * (p + 1))
    return flat


def test_dataset_pass_with_mem_cap_matches_jax(tmp_path):
    t, j = make_pair(tmp_path, cap=150, embedx=4)
    schemas = (
        SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
                   label_slot="label"),
        JSlotSchema([JSlotInfo("label", type="float", dense=True, dim=1)] + [JSlotInfo(f"s{i}") for i in range(S)],
                    label_slot="label"),
    )
    ds = BoxPSDataset(schemas[0], t, batch_size=B, read_threads=2)
    jds = JBoxPSDataset(schemas[1], j, batch_size=B, read_threads=2)
    passes = [_write_files(tmp_path, f"p{p}", p, lo, hi) for p, (lo, hi) in enumerate(((1, 400), (200, 700), (1, 700)))]
    for p, files in enumerate(passes):
        devs = []
        for d in (ds, jds):
            d.set_filelist(files)
            d.load_into_memory()
            devs.append(d.begin_pass(round_to=64))
        # the second and third begin_pass promote spilled rows, caught up
        np.testing.assert_array_equal(devs[0], np.asarray(devs[1]))
        outs = [d.end_pass(_trained(np.asarray(dev), d.table.layout, p)) for d, dev in zip((ds, jds), devs)]
        assert outs[0]["dropped"] == outs[1]["dropped"]
        assert t.tier_stats() == j.tier_stats()
        assert t.mem_rows <= 150 and t.disk_rows > 0
        assert STAT_GET("table.tier.disk_rows") == t.disk_rows
    keys = np.sort(t.keys())
    np.testing.assert_array_equal(keys, np.sort(j.keys()))
    assert_same_rows(t, j, keys)
    assert t.tier_stats()["promoted_total"] > 0


@pytest.mark.parametrize("site,op", [("spill.io", "spill_cold"), ("spill.stage_flush", "stage_flush")])
def test_fault_sites_raise_typed_spill_errors(tmp_path, site, op):
    t, j = make_pair(tmp_path, cap=100)
    seed_shows((t, j), np.arange(1, 501, dtype=np.uint64), 1.0)
    before = STAT_GET("table.spill_errors")
    errs = []
    for tab, mod, exc in ((t, fault, SpillIOError), (j, jfault, JSpillIOError)):
        with mod.inject(mod.fail_once(site)):
            with pytest.raises(exc) as ei:
                tab.maybe_spill()
            errs.append((ei.value.op, ei.value.rc, isinstance(ei.value, IOError)))
            assert tab.maybe_spill() == 400  # healed retry
    assert errs[0] == errs[1] == (op, -2, True)
    assert STAT_GET("table.spill_errors") == before + 1
    assert t.tier_stats() == j.tier_stats()


def test_spill_without_a_disk_tier(tmp_path, monkeypatch):
    t, j = make_pair(tmp_path, spill=False)
    seed_shows((t, j), np.arange(1, 301, dtype=np.uint64), 1.0)
    for policy in ("freq", "fifo"):
        set_flags(spill_policy=policy)
        with pytest.raises(SpillIOError) as ei:
            t.spill_cold(10)
        assert ei.value.rc == -1
    set_flags(spill_policy="lru")
    with pytest.raises(ValueError, match="spill_policy"):
        t.spill_cold(10)
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "0")
    with pytest.raises(RuntimeError, match="native table store"):
        HostSparseTable(ValueLayout(embedx_dim=3), spill_dir=str(tmp_path / "x"))
    py = HostSparseTable(ValueLayout(embedx_dim=3), n_shards=2, mem_cap_rows=10)
    py.pull_or_create(np.arange(1, 50, dtype=np.uint64))
    assert py.maybe_spill() == 0 and py.compact_spill() == 0 and py.spill_stats() == (0, 0, 0)
    assert py.tier_stats()["mem_rows"] == py.mem_rows == 49 and py.disk_rows == 0
