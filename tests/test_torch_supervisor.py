"""The port's PassSupervisor against the JAX package's: the chaos schedules
of ``tests/test_chaos.py`` run in both packages under the same fault
plans, the ``step.device`` seam, the gates and the refusals.

Both packages train the fp32 tower of ``test_torch_mesh_step.py`` (the
same weights, the JAX package's layout; the zoo's bf16 towers round at
places that differ between XLA and torch) with Adam(1e-3), on their
native tier. Bounds: the incident lists (kind, action, attempt) equal;
host rows after the day rtol 1e-3 / atol 2e-5 (the trainer-parity bounds
of ``test_torch_trainer.py``), keys and show/clk counters exact; dense
params atol 2e-4 and Adam moments rtol 5e-2 / atol 1e-6 (the mesh step's
bounds). Within the port a chaos day is bitwise its clean day. The gates
stay far from their thresholds (the AUC floor is off, the NaN gate sees
no NaN), so fp32 noise cannot flip a verdict.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu.data as jdata
import paddlebox_tpu.table as jtable
import paddlebox_tpu.train as jtrain
import paddlebox_tpu.utils.faultinject as jfault
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.table as ttable
import paddlebox_tpu_torch.train as ttrain
import paddlebox_tpu_torch.utils.faultinject as tfault
from tests.test_torch_mesh_step import JTower, Tower

torch.set_num_threads(2)

S, B, DATE = 4, 16, "20260101"
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
PARAMS_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
PKGS = {
    "jax": SimpleNamespace(config=jconfig, data=jdata, table=jtable, train=jtrain, fault=jfault),
    "torch": SimpleNamespace(config=tconfig, data=tdata, table=ttable, train=ttrain, fault=tfault),
}
FLAGS = ("fs_open_backoff_s", "enable_native_parser", "enable_resident_feed", "resident_scan_batches")
OPT = dict(embedx_threshold=0.0, show_clk_decay=0.97, shrink_threshold=0.0)


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


def _write(path, seed, lo, hi, n=64):
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    # fixture writer: every caller passes a path under its tmp_path
    with open(path, "w") as f:  # pbox-lint: disable=IO004
        for _ in range(n):
            parts = [f"1 {float(rng.integers(0, 2))}"]
            for _s in range(S):
                k = int(rng.integers(1, 3))
                parts.append(f"{k} " + " ".join(str(v) for v in rng.integers(lo, hi, k)))
            f.write(" ".join(parts) + "\n")
    return str(path)


def _files(tmp_path, tag):
    return [_write(tmp_path / tag / f"{DATE}-{p}.txt", p, 1 + 40 * p, 161 + 40 * p) for p in range(3)]


def _sup(pkg, tmp_path, tag, gates=None, on_give_up="raise", on_poisoned=None, sleep=None):
    p = PKGS[pkg]
    layout = p.table.ValueLayout(embedx_dim=4)
    opt = p.table.SparseOptimizerConfig(**OPT)
    table = p.table.HostSparseTable(layout, opt, n_shards=2, seed=0)
    schema = p.data.SlotSchema(
        [p.data.SlotInfo("label", type="float", dense=True, dim=1)] + [p.data.SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label",
    )
    ds = p.data.BoxPSDataset(schema, table, batch_size=B, shuffle_mode="none")
    cfg = p.train.TrainStepConfig(num_slots=S, batch_size=B, layout=layout, sparse_opt=opt, auc_buckets=100)
    if pkg == "jax":
        import jax
        import optax

        tr = p.train.CTRTrainer(JTower(), cfg, dense_opt=optax.adam(1e-3))
        tr.init_params(jax.random.PRNGKey(0))
    else:
        tr = p.train.CTRTrainer(Tower(), cfg, dense_opt=ttrain.Adam(1e-3), device="cpu")
    cm = p.train.CheckpointManager(str(tmp_path / f"ckpt-{pkg}-{tag}"))
    sup = p.train.PassSupervisor(
        ds, tr, checkpoint=cm, gates=gates,
        retry=p.train.RetryPolicy(backoff_s=0.0, sleep=sleep or (lambda s: None)),
        round_to=8, on_give_up=on_give_up, on_poisoned=on_poisoned,
    )
    return SimpleNamespace(table=table, ds=ds, tr=tr, cm=cm, sup=sup)


def _incidents(sup):
    return [(i.kind, i.action, i.attempt) for i in sup.incidents]


def _rows(table):
    k = np.sort(table.keys())
    return k, table.pull_or_create(k)


def _dense(pkg, tr):
    """(params by name, Adam count, mu, nu by name) as numpy."""
    if pkg == "jax":
        st = tr.opt_state[0]
        p = {k: np.asarray(v) for k, v in tr.params.items()}
        return p, int(st.count), {k: np.asarray(v) for k, v in st.mu.items()}, {k: np.asarray(v) for k, v in st.nu.items()}
    st = tr.opt_state
    return (
        {k: v.numpy() for k, v in tr.params.items()}, int(st.count),
        {k: v.numpy() for k, v in st.mu.items()}, {k: v.numpy() for k, v in st.nu.items()},
    )


def assert_bitwise(a, b):
    """Two port stacks ended in the same bits: table, dense, Adam."""
    ka, va = _rows(a.table)
    kb, vb = _rows(b.table)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(va, vb)
    da, db = _dense("torch", a.tr), _dense("torch", b.tr)
    assert da[1] == db[1]
    for x, y in zip((da[0], da[2], da[3]), (db[0], db[2], db[3])):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def assert_close_to_jax(t, j):
    """A port stack against a JAX stack within the stated bounds."""
    kt, vt = _rows(t.table)
    kj, vj = _rows(j.table)
    np.testing.assert_array_equal(kt, kj)
    lay = ttable.ValueLayout(embedx_dim=4)
    np.testing.assert_array_equal(vt[:, [lay.SHOW, lay.CLK]], vj[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(vt, vj, rtol=ROWS_RTOL, atol=ROWS_ATOL)
    dt, dj = _dense("torch", t.tr), _dense("jax", j.tr)
    assert dt[1] == dj[1]
    for k in dj[0]:
        np.testing.assert_allclose(dt[0][k], dj[0][k], atol=PARAMS_ATOL)
        np.testing.assert_allclose(dt[2][k], dj[2][k], rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
        np.testing.assert_allclose(dt[3][k], dj[3][k], rtol=MOMENT_RTOL, atol=MOMENT_ATOL)


def _run(pkg, stack, fn, plan=None):
    """fn(stack) under the package's fault plan (rules built by
    ``plan(faultinject)``); returns (result, the FaultPlan)."""
    fault = PKGS[pkg].fault
    rules = plan(fault) if plan is not None else ()
    with fault.inject(*rules) as fp:
        return fn(stack), fp


def test_chaos_day_bitwise_equals_clean_run_and_matches_jax(tmp_path):
    """An fs flake, a ``step.device`` fault in pass 2 and a torn delta
    save: the supervised day completes in both packages with the same
    incidents; within the port it ends bitwise where the clean day ends,
    and the published chains resume to the same rows."""
    files = _files(tmp_path, "data")
    day = [[f] for f in files]
    got = {}
    for pkg in PKGS:
        clean = _sup(pkg, tmp_path, "clean")
        outs_c, probe = _run(pkg, clean, lambda s: s.sup.run_day(DATE, day), plan=lambda fl: ())
        assert clean.sup.incidents == []
        steps_per_pass = probe.hits("step.device") // 3
        fires_per_save = probe.hits("checkpoint.save") // 3
        assert steps_per_pass >= 1 and fires_per_save >= 2
        chaos = _sup(pkg, tmp_path, "inj")
        outs_i, fp = _run(
            pkg, chaos, lambda s: s.sup.run_day(DATE, day),
            plan=lambda fl: (
                fl.fail_once("fs.open_read"),
                fl.fail_nth("step.device", steps_per_pass + 1),
                fl.fail_nth("checkpoint.save", fires_per_save + 2),
            ),
        )
        assert (fp.failures("fs.open_read"), fp.failures("step.device"), fp.failures("checkpoint.save")) == (1, 1, 1)
        assert all(o is not None for o in outs_i)
        got[pkg] = (clean, chaos, outs_c, outs_i, steps_per_pass)
    tc, ti, touts_c, touts_i, tsteps = got["torch"]
    jc, ji, jouts_c, jouts_i, jsteps = got["jax"]
    assert tsteps == jsteps
    assert _incidents(ti.sup) == _incidents(ji.sup)
    assert [(k, a) for k, a, _ in _incidents(ti.sup)] == [("train_error", "revert_retry"), ("ckpt_save_error", "retry")]
    assert_bitwise(ti, tc)
    assert [o["loss"] for o in touts_i] == [o["loss"] for o in touts_c]
    assert [o["auc"] for o in touts_i] == [o["auc"] for o in touts_c]
    assert_close_to_jax(ti, ji)
    np.testing.assert_allclose([o["loss"] for o in touts_i], [o["loss"] for o in jouts_i], rtol=1e-3)
    assert ti.cm.cursor()["delta_idx"] == tc.cm.cursor()["delta_idx"] == ji.cm.cursor()["delta_idx"] == 2
    rows = []
    for cm in (tc.cm, ti.cm):
        rt = ttable.HostSparseTable(ttable.ValueLayout(embedx_dim=4), ttable.SparseOptimizerConfig(**OPT), n_shards=2, seed=0)
        cm.resume(rt)
        rows.append(_rows(rt))
    np.testing.assert_array_equal(rows[0][0], rows[1][0])
    np.testing.assert_array_equal(rows[0][1], rows[1][1])
    # the metric series and the incident plane live under the root
    series = list(__import__("paddlebox_tpu_torch.obs.metrics_writer", fromlist=["x"]).read_series(
        os.path.join(ti.cm.root, "obs")))
    assert [r["label"] for r in series if r["label"].startswith("pass:")] == ["pass:1", "pass:2", "pass:3"]


def test_step_device_seam_fails_both_packages_at_the_same_step(tmp_path):
    """``fail_nth("step.device", n)`` fails a bare train_pass of either
    package after the same n - 1 steps, on the classic stepper (one fire
    a step) and on the resident one (one fire a superstep); a supervised
    retry of that pass in the port is bitwise its clean run."""
    files = _files(tmp_path, "seam")
    for resident in (0, 1):
        set_both(enable_resident_feed=resident, resident_scan_batches=2)
        steps = {}
        for pkg in PKGS:
            st = _sup(pkg, tmp_path, f"seam{resident}")
            st.ds.set_filelist([files[0]])
            st.ds.load_into_memory()
            st.ds.begin_pass(round_to=8)
            done = []
            fault = PKGS[pkg].fault
            with fault.inject(fault.fail_nth("step.device", 2)):
                with pytest.raises(fault.InjectedFault):
                    st.tr.train_pass(st.ds, on_batch=lambda i, m: done.append(i))
            steps[pkg] = done
        # classic: step 2 fails after step 0 ran; resident: the second
        # superstep (steps 2 and 3) fails after steps 0 and 1 ran
        assert steps["torch"] == steps["jax"] == ([0] if not resident else [0, 1])
    clean = _sup("torch", tmp_path, "seamclean")
    clean.sup.run_pass([files[0]], date=DATE)
    chaos = _sup("torch", tmp_path, "seamchaos")
    with tfault.inject(tfault.fail_nth("step.device", 2)) as fp:
        chaos.sup.run_pass([files[0]], date=DATE)
    assert fp.failures("step.device") == 1
    assert _incidents(chaos.sup) == [("train_error", "revert_retry", 0)]
    assert_bitwise(chaos, clean)


def test_gate_rejection_escalates_to_resume_then_skips(tmp_path):
    files = _files(tmp_path, "edata")
    got = {}
    for pkg in PKGS:
        st = _sup(pkg, tmp_path, "esc", on_give_up="skip")
        assert st.sup.run_pass([files[0]], date=DATE, save="base") is not None
        base_keys = np.sort(st.table.keys()).copy()
        base_vals = st.table.pull_or_create(base_keys).copy()
        st.sup.gates.auc_absolute_floor = 2.0  # unsatisfiable
        assert st.sup.run_pass([files[1]], date=DATE) is None
        np.testing.assert_array_equal(st.table.pull_or_create(base_keys), base_vals)
        st.sup.gates.auc_absolute_floor = None
        assert st.sup.run_pass([files[2]], date=DATE, save="delta") is not None
        assert st.cm.cursor()["delta_idx"] == 1
        got[pkg] = st
    assert _incidents(got["torch"].sup) == _incidents(got["jax"].sup)
    kinds = [(k, a) for k, a, _ in _incidents(got["torch"].sup)]
    assert ("gate_auc", "revert_retry") in kinds and ("escalate_resume", "resume") in kinds
    assert ("gave_up", "skip") in kinds
    assert_close_to_jax(got["torch"], got["jax"])
    bundles = os.listdir(os.path.join(got["torch"].cm.root, "obs", "incidents"))
    assert len(bundles) == 1 and bundles[0].startswith("incident-")


def test_persistent_load_failure_surfaces_as_pass_failure(tmp_path):
    got = {}
    for pkg in PKGS:
        st = _sup(pkg, tmp_path, "load")
        with pytest.raises(PKGS[pkg].train.PassFailure, match="load failed"):
            st.sup.run_pass([str(tmp_path / "missing" / "nope.txt")], date=DATE)
        got[pkg] = _incidents(st.sup)
    assert got["torch"] == got["jax"]
    assert [(k, a) for k, a, _ in got["torch"]] == [("load_error", "retry")] * 2 + [("load_error", "raise")]


GARBAGE = ["3 zz !! this-line-is-corrupt", "1 not-a-float 1 5 1 9", "?? ?? ??", "1 1.0 one 5", "2 0.5 x"]


def _poison_insert(src, dst):
    """``src`` with garbage lines inserted at fixed offsets: the surviving
    records are the original file's."""
    lines = open(src).read().splitlines()
    out, injected = [], []
    for i, ln in enumerate(lines):
        if i in (3, 17, 29, 41, 57):
            bad = GARBAGE[len(injected) % len(GARBAGE)]
            out.append(bad)
            injected.append(bad)
        out.append(ln)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text("\n".join(out) + "\n")
    return str(dst), injected


def test_poisoned_day_degrade_equals_precleaned_run(tmp_path):
    """A corrupt middle file under ``on_poisoned="degrade"``: the day ends
    bitwise where the day over the clean files ends (in the port), with
    one degrade incident naming the dead letter under the checkpoint root;
    the same in the JAX package, and the packages agree."""
    files = _files(tmp_path, "pdata")
    poisoned, injected = _poison_insert(files[1], tmp_path / "pdata-bad" / f"{DATE}-1.txt")
    got = {}
    for pkg in PKGS:
        clean = _sup(pkg, tmp_path, "pclean")
        outs_c = clean.sup.run_day(DATE, [[f] for f in files])
        deg = _sup(pkg, tmp_path, "pdeg", on_poisoned="degrade")
        outs_d = deg.sup.run_day(DATE, [[files[0]], [poisoned], [files[2]]])
        assert outs_d[1]["quarantined_bad_lines"] == float(len(injected))
        assert "quarantined_bad_lines" not in outs_d[0]
        got[pkg] = (clean, deg, outs_c, outs_d)
    tc, td, touts_c, touts_d = got["torch"]
    assert_bitwise(td, tc)
    assert [o["auc"] for o in touts_d] == [o["auc"] for o in touts_c]
    assert _incidents(td.sup) == _incidents(got["jax"][1].sup) == [("data_poisoned", "degrade", 0)]
    detail = td.sup.incidents[0].detail
    assert "loss: 5 lines" in detail
    dl_path = detail.split("dead-letter: ")[1].split(" (loss")[0]
    assert dl_path.startswith(os.path.join(td.cm.root, "quarantine"))
    assert [e["line"] for e in tdata.read_dead_letter(dl_path)["entries"]] == injected
    assert_close_to_jax(td, got["jax"][1])


def test_poisoned_pass_strict_raises_without_burning_retries(tmp_path):
    files = _files(tmp_path, "sdata")
    poisoned, injected = _poison_insert(files[1], tmp_path / "sdata-bad" / f"{DATE}-1.txt")
    got = {}
    for pkg in PKGS:
        sleeps = []
        st = _sup(pkg, tmp_path, "strict", sleep=sleeps.append)
        assert st.sup.run_pass([files[0]], date=DATE, save="base") is not None
        fault = PKGS[pkg].fault
        with fault.inject() as probe:
            with pytest.raises(PKGS[pkg].data.DataPoisonedError) as ei:
                st.sup.run_pass([poisoned], date=DATE)
        assert probe.hits("step.device") == 0 and sleeps == []
        assert ei.value.report["bad_lines"] == len(injected)
        assert ei.value.dead_letter in st.sup.incidents[0].detail
        st.ds.drop_pass_data()
        assert st.sup.run_pass([files[2]], date=DATE) is not None
        got[pkg] = st
    assert _incidents(got["torch"].sup) == _incidents(got["jax"].sup) == [("data_poisoned", "raise", 0)]
    assert_close_to_jax(got["torch"], got["jax"])


def test_seeded_parse_fault_strict_and_degrade(tmp_path):
    """A ``parser.parse_line`` fault on line 10 of pass 0 (the Python
    tier): strict mode raises at once, degrade completes bitwise where the
    pre-cleaned day ends, in both packages alike."""
    set_both(enable_native_parser=0)
    files = _files(tmp_path, "fdata")
    raw = open(files[0]).read().splitlines()
    cleaned0 = tmp_path / "fdata-clean" / f"{DATE}-0.txt"
    cleaned0.parent.mkdir(parents=True, exist_ok=True)
    cleaned0.write_text("\n".join(raw[:9] + raw[10:]) + "\n")
    got = {}
    for pkg in PKGS:
        fault = PKGS[pkg].fault
        clean = _sup(pkg, tmp_path, "fclean")
        clean.sup.run_day(DATE, [[str(cleaned0)], [files[1]], [files[2]]])
        sleeps = []
        strict = _sup(pkg, tmp_path, "fstrict", sleep=sleeps.append)
        with fault.inject(fault.fail_nth("parser.parse_line", 10)) as fp:
            with pytest.raises(PKGS[pkg].data.DataPoisonedError):
                strict.sup.run_day(DATE, [[f] for f in files])
        assert fp.failures("parser.parse_line") == 1 and sleeps == []
        deg = _sup(pkg, tmp_path, "fdeg", on_poisoned="degrade")
        with fault.inject(fault.fail_nth("parser.parse_line", 10)):
            assert all(o is not None for o in deg.sup.run_day(DATE, [[f] for f in files]))
        (entry,) = PKGS[pkg].data.read_dead_letter(
            deg.sup.incidents[0].detail.split("dead-letter: ")[1].split(" (loss")[0]
        )["entries"]
        assert entry["line"] == raw[9] and entry["line_no"] == 10
        got[pkg] = (clean, strict, deg)
    assert _incidents(got["torch"][1].sup) == _incidents(got["jax"][1].sup) == [("data_poisoned", "raise", 0)]
    assert _incidents(got["torch"][2].sup) == _incidents(got["jax"][2].sup)
    assert_bitwise(got["torch"][2], got["torch"][0])
    assert_close_to_jax(got["torch"][2], got["jax"][2])


def _bare(pkg, gates):
    p = PKGS[pkg].train
    return p.PassSupervisor(
        SimpleNamespace(table=None), trainer=None, gates=gates,
        retry=p.RetryPolicy(max_retries=0, sleep=lambda s: None),
    )


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_gates_and_backoff_units(pkg):
    t = PKGS[pkg].train
    sup = _bare(pkg, t.HealthGates(nan_ratio_max=0.05))
    sup._gate({"batches": 100.0, "nan_batches": 1.0, "auc": 0.7})
    with pytest.raises(t.PassRejected) as ei:
        sup._gate({"batches": 100.0, "nan_batches": 10.0, "auc": 0.7})
    assert ei.value.gate == "nan"
    sup = _bare(pkg, t.HealthGates(auc_window=5, auc_min_history=3, auc_floor_margin=0.05))
    sup._gate({"batches": 1.0, "auc": 0.4})
    sup._auc_history.extend([0.80, 0.80, 0.80])
    with pytest.raises(t.PassRejected) as ei:
        sup._gate({"batches": 1.0, "auc": 0.70})
    assert ei.value.gate == "auc"
    sup._gate({"batches": 1.0, "auc": 0.76})
    rp = t.RetryPolicy(backoff_s=0.5, backoff_mult=2.0, backoff_max_s=3.0)
    assert [rp.backoff(a) for a in (1, 2, 3, 4, 10)] == [0.5, 1.0, 2.0, 3.0, 3.0]


def test_refusals_name_their_roadmap_item(tmp_path):
    """The supervisor over several ranks is ported: a transport of several
    ranks makes a coordinator, a mesh trainer needs its rank's transport
    (ValueError naming why), and ``join_day`` needs elastic mode and a
    coordinator. An explicit compile-cache directory still raises
    NotImplementedError naming ROADMAP Queue 1 item 6. A CPU trainer needs
    no backend probe."""
    st = _sup("torch", tmp_path, "ref")
    assert st.sup.backend_verdict is None
    sup_cls = ttrain.PassSupervisor
    assert sup_cls(st.ds, st.tr, transport=SimpleNamespace(n_ranks=2, rank=0)).coord is not None
    assert sup_cls(st.ds, st.tr, transport=SimpleNamespace(n_ranks=1, rank=0)).coord is None
    mesh_tr = SimpleNamespace(plan=SimpleNamespace(world=2, rank=1), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="needs transport="):
        sup_cls(st.ds, mesh_tr)
    with pytest.raises(ValueError, match="transport rank 0 of 2 != mesh rank 1 of 2"):
        sup_cls(st.ds, mesh_tr, transport=SimpleNamespace(n_ranks=2, rank=0))
    assert sup_cls(st.ds, mesh_tr, transport=SimpleNamespace(n_ranks=2, rank=1)).coord is not None
    with pytest.raises(ValueError, match="join_day requires elastic mode"):
        st.sup.join_day([])
    prev = tconfig.get_flag("compile_cache_dir")
    try:
        tconfig.set_flag("compile_cache_dir", str(tmp_path / "cc"))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
            sup_cls(st.ds, st.tr)
        tconfig.set_flag("compile_cache_dir", "off")
        sup_cls(st.ds, st.tr)
    finally:
        tconfig.set_flag("compile_cache_dir", prev)
    # the dataset over several hosts is ported: a striped dataset with
    # neither a router nor a transport, or a transport that is not its
    # rank of its nranks, is a misuse
    with pytest.raises(ValueError, match="LocalShuffleRouter"):
        tdata.BoxPSDataset(st.ds.schema, st.table, B, nranks=2)
    with pytest.raises(ValueError, match="transport must be rank 0 of 1"):
        tdata.BoxPSDataset(st.ds.schema, st.table, B, transport=object())
