"""The port's data quarantine against the JAX package's: per-line and
per-file capture, dead-letter files, both parser tiers, strict mode, the
admission gate and ``drop_pass_data``.

Every scenario runs in both packages on the same files, with the same
flags set in both registries; counters, dead-letter entries (file paths
aside, where each package names its own copy) and surviving records are
compared exactly.
"""

from __future__ import annotations

import gzip
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu.data as jdata
import paddlebox_tpu.table as jtable
import paddlebox_tpu.utils.faultinject as jfault
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.table as ttable
import paddlebox_tpu_torch.utils.faultinject as tfault

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(config=jconfig, data=jdata, table=jtable, fault=jfault),
    "torch": SimpleNamespace(config=tconfig, data=tdata, table=ttable, fault=tfault),
}
FLAGS = (
    "data_quarantine", "max_bad_line_fraction", "max_bad_file_fraction",
    "data_quarantine_dir", "fs_open_backoff_s", "enable_native_parser",
)

GOOD = ["1 1.0 1 5 1 9", "1 0.5 2 6 7 1 3", "1 1.0 1 8 1 2"]
BAD = ["garbage !! not-a-line", "1 1.0 1", "1 0.0 0 1 4"]
BENIGN = "1 1.0 1 0 1 0"  # all-zero sparse keys: the parser returns None


@pytest.fixture(autouse=True)
def _flags():
    prev = {(k, n): p.config.get_flag(n) for k, p in PKGS.items() for n in FLAGS}
    set_both(fs_open_backoff_s=0.0)
    yield
    for (k, n), v in prev.items():
        PKGS[k].config.set_flag(n, v)


def set_both(**flags):
    for p in PKGS.values():
        for n, v in flags.items():
            p.config.set_flag(n, v)


def _write(path, lines):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _ds(pkg, qdir, **kw):
    p = PKGS[pkg]
    schema = p.data.SlotSchema(
        [p.data.SlotInfo("label", type="float", dense=True, dim=1), p.data.SlotInfo("s0"), p.data.SlotInfo("s1")],
        label_slot="label",
    )
    table = p.table.HostSparseTable(
        p.table.ValueLayout(embedx_dim=4), p.table.SparseOptimizerConfig(), n_shards=2, seed=0
    )
    return p.data.BoxPSDataset(schema, table, batch_size=2, quarantine_dir=str(qdir), **kw)


def _load(pkg, tmp_path, files, plan=None, **kw):
    ds = _ds(pkg, tmp_path / f"q-{pkg}", read_threads=1, **kw)
    ds.set_date("20260101")
    ds.set_filelist(files)
    if plan is None:
        ds.load_into_memory()
    else:
        with PKGS[pkg].fault.inject(plan(PKGS[pkg].fault)):
            ds.load_into_memory()
    return ds


def _stats(ds):
    st = ds.stats
    return (st.files, st.lines, st.records, st.parsed, st.skipped_benign, st.bad_lines, st.bad_files, st.bad_by_file)


def _dead_letter(pkg, path):
    dl = PKGS[pkg].data.read_dead_letter(path)
    summary = {k: v for k, v in dl["summary"].items()}
    return summary, dl["entries"]


def _strip(rep):
    """An admission report without the fields that name a package's own
    dead-letter path."""
    return {k: v for k, v in rep.items() if k not in ("detail", "dead_letter")}


def _records(ds):
    return [(r.u64_values.tolist(), r.u64_offsets.tolist(), r.f_values.tolist()) for r in ds.records]


@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_counters_and_dead_letter_match_jax(tmp_path, native):
    """Two files, one with bad, benign and blank lines: the counts, the
    dead-letter file (summary and entries) and the records are JAX's."""
    set_both(enable_native_parser=native)
    f0 = _write(tmp_path / "part-0.txt", [GOOD[0], BAD[0], GOOD[1], BENIGN, BAD[1], "", GOOD[2]])
    f1 = _write(tmp_path / "part-1.txt", GOOD)
    got = {pkg: _load(pkg, tmp_path, [f0, f1]) for pkg in PKGS}
    t, j = got["torch"], got["jax"]
    assert _stats(t) == _stats(j) == (2, 9, 6, 6, 1, 2, 0, {f0: 2})
    assert _records(t) == _records(j)
    ts, te = _dead_letter("torch", t.stats.dead_letter)
    js, je = _dead_letter("jax", j.stats.dead_letter)
    assert ts == js and te == je
    assert [e["line"] for e in te] == [BAD[0], BAD[1]] and [e["line_no"] for e in te] == [2, 5]
    assert os.path.basename(t.stats.dead_letter) == os.path.basename(j.stats.dead_letter)
    assert _strip(t.admission_report()) == _strip(j.admission_report())


def test_native_and_python_tiers_report_identically(tmp_path):
    """One corrupt file through both of the port's tiers: the same counts
    and records (the native tier re-parses its corrupt buffer line by line
    and stays columnar), and the same as the JAX package's native tier."""
    f = _write(tmp_path / "part-0.txt", [GOOD[0], BAD[0], GOOD[1], BENIGN, BAD[2], GOOD[2]])
    got = {}
    for native in (1, 0):
        set_both(enable_native_parser=native)
        for pkg in PKGS:
            got[pkg, native] = _load(pkg, tmp_path / f"n{native}", [f])
    for ds in got.values():
        assert (ds.stats.lines, ds.stats.parsed, ds.stats.skipped_benign, ds.stats.bad_lines) == (6, 3, 1, 2)
    assert got["torch", 1].store is not None, "a corrupt file knocked the pass off the columnar store"
    assert got["torch", 0].store is None
    assert _records(got["torch", 1]) == _records(got["torch", 0]) == _records(got["jax", 1]) == _records(got["jax", 0])


@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_strict_mode_first_bad_line_raises(tmp_path, native):
    set_both(data_quarantine=0, enable_native_parser=native)
    f = _write(tmp_path / "part-0.txt", [GOOD[0], BAD[0]])
    for pkg in PKGS:
        ds = _ds(pkg, tmp_path / "q")
        ds.set_filelist([f])
        with pytest.raises(ValueError):
            ds.load_into_memory()
        assert ds.stats.bad_lines == 0


@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_unreadable_file_quarantined_but_missing_file_raises(tmp_path, native):
    """The ``data.file_read`` fault quarantines the file whole in both
    packages; a missing file raises FileNotFoundError in both."""
    set_both(enable_native_parser=native)
    f_ok = _write(tmp_path / "part-0.txt", GOOD)
    got = {pkg: _load(pkg, tmp_path, [f_ok, f_ok], plan=lambda fl: fl.fail_nth("data.file_read", 1)) for pkg in PKGS}
    assert _stats(got["torch"]) == _stats(got["jax"])
    assert got["torch"].stats.bad_files == 1 and got["torch"].stats.records == len(GOOD)
    rep = got["torch"].admission_report()
    assert rep["poisoned"] and rep["file_fraction"] == 0.5
    entry = _dead_letter("torch", got["torch"].stats.dead_letter)[1][0]
    assert entry["kind"] == "file" and "injected fault" in entry["error"]
    assert entry == _dead_letter("jax", got["jax"].stats.dead_letter)[1][0]
    for pkg in PKGS:
        ds = _ds(pkg, tmp_path / "q2")
        ds.set_filelist([str(tmp_path / "never.txt")])
        with pytest.raises(FileNotFoundError):
            ds.load_into_memory()


def test_fs_open_read_flake_heals_in_both_tiers(tmp_path):
    """One ``fs.open_read`` failure is retried by the fs tier (no
    quarantine) in both packages, on both tiers, with one retry counted."""
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    f = _write(tmp_path / "part-0.txt", GOOD)
    for native in (1, 0):
        set_both(enable_native_parser=native)
        got = {}
        for pkg in PKGS:
            before = STAT_GET("fs_open_retries_total")
            got[pkg] = _load(pkg, tmp_path / f"n{native}", [f], plan=lambda fl: fl.fail_nth("fs.open_read", 1))
            if pkg == "torch":
                assert STAT_GET("fs_open_retries_total") == before + 1
        assert _stats(got["torch"]) == _stats(got["jax"]) == (1, 3, 3, 3, 0, 0, 0, {})
        assert _records(got["torch"]) == _records(got["jax"])


def test_truncated_gz_quarantined(tmp_path):
    whole = gzip.compress(("\n".join(GOOD) + "\n").encode())
    torn = tmp_path / "part-0.txt.gz"
    torn.write_bytes(whole[: len(whole) // 2])
    ok = tmp_path / "part-1.txt.gz"
    ok.write_bytes(whole)
    got = {pkg: _load(pkg, tmp_path, [str(torn), str(ok)]) for pkg in PKGS}
    assert got["torch"].stats.bad_files == 1 and got["torch"].stats.records == len(GOOD)
    assert _stats(got["torch"]) == _stats(got["jax"])
    assert _records(got["torch"]) == _records(got["jax"])


def test_admission_gate_rejects_and_admit_poisoned_overrides(tmp_path):
    set_both(enable_native_parser=0)
    f = _write(tmp_path / "part-0.txt", GOOD + [BAD[0]])
    for pkg in PKGS:
        ds = _load(pkg, tmp_path, [f])
        with pytest.raises(PKGS[pkg].data.DataPoisonedError) as ei:
            ds.begin_pass(round_to=8)
        assert ei.value.dead_letter and os.path.exists(ei.value.dead_letter)
        assert ei.value.dead_letter in str(ei.value)
        assert ei.value.report["bad_lines"] == 1
        assert not ds._in_pass
        ds.begin_pass(round_to=8, admit_poisoned=True)
        assert ds._in_pass and ds.memory_data_size() == len(GOOD)
        ds.end_pass(None, shrink=False)


def test_admission_thresholds_bound_loss(tmp_path):
    set_both(enable_native_parser=0)
    f = _write(tmp_path / "part-0.txt", GOOD * 33 + [BAD[0]])
    reps = {}
    for pkg in PKGS:
        ds = _load(pkg, tmp_path, [f])
        rep = ds.admission_report()
        assert not rep["poisoned"] and rep["bad_lines"] == 1
        ds.begin_pass(round_to=8)
        ds.end_pass(None, shrink=False)
        PKGS[pkg].config.set_flag("max_bad_line_fraction", 0.0)
        reps[pkg] = ds.admission_report()
        assert reps[pkg]["poisoned"]
    assert _strip(reps["torch"]) == _strip(reps["jax"])


def test_drop_pass_data_clears_unbegun_pass(tmp_path):
    set_both(enable_native_parser=0)
    f = _write(tmp_path / "part-0.txt", GOOD + [BAD[0]])
    for pkg in PKGS:
        ds = _load(pkg, tmp_path, [f])
        ds.drop_pass_data()
        assert ds.memory_data_size() == 0 and ds.ws is None
        assert not ds.admission_report()["poisoned"]
        with pytest.raises(RuntimeError, match="load_into_memory"):
            ds.begin_pass()


def test_quarantine_log_and_dead_letter_roundtrip(tmp_path):
    """QuarantineLog's bounded store and its file, written by one package
    and read by the other."""
    logs = {}
    for pkg in PKGS:
        q = PKGS[pkg].data.QuarantineLog()
        q.MAX_KEPT = 3
        for i in range(5):
            q.quarantine_line("f", i + 1, f"bad {i}", ValueError(f"e{i}"))
        q.quarantine_file("g", OSError("gone"))
        logs[pkg] = q.write(str(tmp_path / pkg), "dl", meta={"pass_id": 1})
    for a, b in (("torch", "jax"), ("jax", "torch")):
        assert PKGS[a].data.read_dead_letter(logs[b]) == PKGS[b].data.read_dead_letter(logs[b])
    with open(logs["torch"]) as ft, open(logs["jax"]) as fj:
        assert ft.read() == fj.read()
    s = tdata.read_dead_letter(logs["torch"])["summary"]
    assert (s["bad_lines"], s["bad_files"], s["entries"], s["truncated"]) == (5, 1, 3, True)
    np.testing.assert_equal(len(tdata.read_dead_letter(logs["torch"])["entries"]), 3)
