"""The port's streaming plane against the JAX package's: the tailer (partial
lines held back, rewritten history refused, a failed read holding its
position), the cut crash windows, compaction, the streaming-off ablation
and the backlog stretch, the cases of ``tests/test_stream.py``.

Both packages train ``test_torch_mesh_step.py``'s fp32 tower with
Adam(1e-3) (the zoo's bf16 towers round differently in XLA and torch).
Bounds: tailer output, positions, the stream cursor's JSON and the spool
bytes equal; tables within the trainer-parity bounds (rows rtol 1e-3 /
atol 2e-5, keys and show/clk counters exact); within the port a crashed
and recovered stream, a compacted chain, a follower's catch-up and the
file-list ablation are bitwise the uninterrupted stream.
"""

from __future__ import annotations

import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu.data as jdata
import paddlebox_tpu.serve.follower as jfollower
import paddlebox_tpu.table as jtable
import paddlebox_tpu.train as jtrain
import paddlebox_tpu.utils.faultinject as jfault
import paddlebox_tpu.utils.monitor as jmonitor
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.serve.follower as tfollower
import paddlebox_tpu_torch.table as ttable
import paddlebox_tpu_torch.train as ttrain
import paddlebox_tpu_torch.utils.faultinject as tfault
import paddlebox_tpu_torch.utils.monitor as tmonitor
from tests.test_torch_mesh_step import JTower, Tower

torch.set_num_threads(2)

S, B, DATE = 4, 16, "20260807"
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
OPT = dict(embedx_threshold=0.0, show_clk_decay=0.97, shrink_threshold=0.0)
CHUNKS = [(24, 0), (24, 100), (24, 200), (24, 300)]
PKGS = {
    "jax": SimpleNamespace(data=jdata, table=jtable, train=jtrain, fault=jfault, mon=jmonitor, fol=jfollower, config=jconfig),
    "torch": SimpleNamespace(data=tdata, table=ttable, train=ttrain, fault=tfault, mon=tmonitor, fol=tfollower, config=tconfig),
}


def _table(pkg):
    p = PKGS[pkg].table
    return p.HostSparseTable(p.ValueLayout(embedx_dim=4), p.SparseOptimizerConfig(**OPT), n_shards=2, seed=0)


def _build(pkg, root):
    p = PKGS[pkg]
    table = _table(pkg)
    schema = p.data.SlotSchema(
        [p.data.SlotInfo("label", type="float", dense=True, dim=1)] + [p.data.SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label",
    )
    ds = p.data.BoxPSDataset(schema, table, batch_size=B, shuffle_mode="none")
    lay = p.table.ValueLayout(embedx_dim=4)
    cfg = p.train.TrainStepConfig(
        num_slots=S, batch_size=B, layout=lay, sparse_opt=p.table.SparseOptimizerConfig(**OPT), auc_buckets=100
    )
    if pkg == "jax":
        import jax
        import optax

        tr = p.train.CTRTrainer(JTower(), cfg, dense_opt=optax.adam(1e-3))
        tr.init_params(jax.random.PRNGKey(0))
    else:
        tr = p.train.CTRTrainer(Tower(), cfg, dense_opt=ttrain.Adam(1e-3), device="cpu")
    mgr = p.train.CheckpointManager(str(root))
    # micro-passes are tiny: the trailing-AUC gate has no signal here
    sup = p.train.PassSupervisor(ds, tr, checkpoint=mgr, gates=p.train.HealthGates(auc_min_history=99))
    return SimpleNamespace(table=table, tr=tr, mgr=mgr, sup=sup)


def _chunk_lines(rng, rows, lo):
    lines = []
    for _ in range(rows):
        keys = rng.integers(lo, lo + 200, S)
        lines.append(f"1 {float(keys[0] % 2)} " + " ".join(f"1 {k}" for k in keys))
    return lines


def _append(stream_dir, name, lines, partial=None):
    # fixture writer emulating the upstream log appender, under tmp_path
    with open(os.path.join(str(stream_dir), name), "a") as f:  # pbox-lint: disable=IO004
        f.write("\n".join(lines) + "\n")
        if partial is not None:
            f.write(partial)  # a flush mid-record: no trailing newline


def _rows(table):
    k = np.sort(table.keys())
    return k, table.pull_or_create(k)


def assert_same_rows(a, b):
    ka, va = _rows(a)
    kb, vb = _rows(b)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(va, vb)


def assert_close_rows(t, j):
    kt, vt = _rows(t)
    kj, vj = _rows(j)
    np.testing.assert_array_equal(kt, kj)
    lay = ttable.ValueLayout(embedx_dim=4)
    np.testing.assert_array_equal(vt[:, [lay.SHOW, lay.CLK]], vj[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(vt, vj, rtol=ROWS_RTOL, atol=ROWS_ATOL)


def _stream_leg(pkg, root, stream_dir, compact_every=0, seed=7):
    """An uninterrupted stream: one appended chunk a step()."""
    os.makedirs(root, exist_ok=True)
    os.makedirs(stream_dir, exist_ok=True)
    st = _build(pkg, root)
    ss = PKGS[pkg].train.StreamSupervisor(st.sup, str(stream_dir), DATE, pattern="*.txt", compact_every=compact_every)
    rng = np.random.default_rng(seed)
    for rows, lo in CHUNKS:
        _append(stream_dir, "a.txt", _chunk_lines(rng, rows, lo))
        assert ss.step() is not None
    return st, ss


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """Each package's uninterrupted stream, and its cursor and spool."""
    out = {}
    for pkg in PKGS:
        d = tmp_path_factory.mktemp(f"clean-{pkg}")
        st, ss = _stream_leg(pkg, str(d / "root"), str(d / "stream"))
        with open(os.path.join(st.mgr.root, "stream_cursor.json")) as f:
            cursor = json.load(f)
        with open(os.path.join(st.mgr.root, "stream_spool", f"cut-{len(CHUNKS):06d}.txt"), "rb") as f:
            spool = f.read()
        out[pkg] = SimpleNamespace(st=st, ss=ss, cursor=cursor, spool=spool, root=str(d / "root"))
    return out


def test_clean_streams_match_jax(clean):
    t, j = clean["torch"], clean["jax"]
    assert t.cursor == j.cursor
    assert t.spool == j.spool
    assert t.ss.cut_seq == j.ss.cut_seq == len(CHUNKS)
    assert_close_rows(t.st.table, j.st.table)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_partial_tail_line_held_back_not_quarantined(tmp_path, pkg):
    t = PKGS[pkg].train.DirectoryTailer(str(tmp_path), pattern="*.txt")
    _append(tmp_path, "a.txt", ["rec-1", "rec-2"], partial="rec-3-torn-prefi")
    assert t.poll()[0] == ["rec-1", "rec-2"]
    assert t.positions["a.txt"]["offset"] == len(b"rec-1\nrec-2\n")
    assert t.poll()[0] == []
    with open(tmp_path / "a.txt", "a") as f:
        f.write("x\nrec-4\n")
    assert t.poll()[0] == ["rec-3-torn-prefix", "rec-4"]
    # the positions (offset and CRC) are the JAX package's
    other = PKGS["jax" if pkg == "torch" else "torch"].train.DirectoryTailer(str(tmp_path), pattern="*.txt")
    other.poll()
    assert other.snapshot_positions() == t.snapshot_positions()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_tailer_resume_detects_rewritten_history(tmp_path, pkg):
    tr = PKGS[pkg].train
    t = tr.DirectoryTailer(str(tmp_path), pattern="*.txt")
    _append(tmp_path, "a.txt", ["rec-1", "rec-2"])
    t.poll()
    cursor = t.snapshot_positions()
    with open(tmp_path / "a.txt", "w") as f:
        f.write("REC-1\nREC-2\n")
    with pytest.raises(tr.StreamLineageError):
        tr.DirectoryTailer(str(tmp_path), pattern="*.txt").resume(cursor)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_tail_read_fault_holds_position_zero_loss(tmp_path, pkg):
    p = PKGS[pkg]
    t = p.train.DirectoryTailer(str(tmp_path), pattern="*.txt")
    _append(tmp_path, "a.txt", ["rec-1", "rec-2"])
    with p.fault.inject(p.fault.fail_nth("stream.tail_read", 1)) as plan:
        errs0 = p.mon.STAT_GET("stream.tail_read_errors")
        assert t.poll()[0] == []
        assert plan.failures("stream.tail_read") == 1
        assert t.positions["a.txt"]["offset"] == 0
        assert p.mon.STAT_GET("stream.tail_read_errors") == errs0 + 1
        assert t.poll()[0] == ["rec-1", "rec-2"]


@pytest.mark.parametrize("hit,stat", [(1, "stream.replays"), (2, "stream.replays_skipped")])
def test_cut_crash_window_recovers_exactly_once(tmp_path, clean, hit, stat):
    """A crash in either cut window, then a restart from disk: the port's
    recovered stream is bitwise its uninterrupted twin (and its follower
    chain too), its cursor and spool are the JAX package's recovered ones,
    and its rows are within the bounds of the JAX package's."""
    got = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        root, stream = tmp_path / f"k-{pkg}", tmp_path / f"ks-{pkg}"
        root.mkdir()
        stream.mkdir()
        st = _build(pkg, root)
        ss = p.train.StreamSupervisor(st.sup, str(stream), DATE, pattern="*.txt", compact_every=0)
        rng = np.random.default_rng(7)
        for i, (rows, lo) in enumerate(CHUNKS):
            _append(stream, "a.txt", _chunk_lines(rng, rows, lo))
            if i == 1:
                with p.fault.inject(p.fault.fail_nth("stream.cut_publish", hit)) as plan:
                    with pytest.raises(p.fault.InjectedFault):
                        ss.step()
                    assert plan.failures("stream.cut_publish") == 1
                before = p.mon.STAT_GET(stat)
                st = _build(pkg, root)  # the restart: durable state only
                st.mgr.resume(st.table, st.tr)
                ss = p.train.StreamSupervisor(st.sup, str(stream), DATE, pattern="*.txt", compact_every=0)
                assert p.mon.STAT_GET(stat) == before + 1
                continue
            ss.step()
        assert ss.cut_seq == len(CHUNKS)
        with open(root / "stream_cursor.json") as f:
            cursor = json.load(f)
        ft = _table(pkg)
        p.fol.apply_published_chain(str(root), ft)
        got[pkg] = (st, cursor, ft)
    t, tcur, tft = got["torch"]
    j, jcur, jft = got["jax"]
    assert_same_rows(t.table, clean["torch"].st.table)
    assert_same_rows(tft, clean["torch"].st.table)
    assert tcur == jcur == clean["torch"].cursor
    with open(os.path.join(str(tmp_path / "k-torch"), "stream_spool", f"cut-{len(CHUNKS):06d}.txt"), "rb") as f:
        assert f.read() == clean["jax"].spool
    assert_close_rows(t.table, j.table)


@pytest.mark.parametrize("hit", [1, 2, 3])
def test_compact_crash_leaves_old_chain_servable_bitwise(tmp_path, clean, hit):
    """A crash in any window of ``compact`` leaves the chain resumable to
    the same bits; the healed retry folds to them too (the port)."""
    import shutil

    root = str(tmp_path / "r")
    shutil.copytree(clean["torch"].root, root)
    mgr = ttrain.CheckpointManager(root)
    with tfault.inject(tfault.fail_nth("ckpt.compact", hit)) as plan:
        with pytest.raises(tfault.InjectedFault):
            mgr.compact(DATE, _table("torch"))
        assert plan.failures("ckpt.compact") == 1
    t2 = _table("torch")
    ttrain.CheckpointManager(root).resume(t2)
    assert_same_rows(t2, clean["torch"].st.table)
    assert mgr.compact(DATE, _table("torch")) is not None
    t3 = _table("torch")
    state = ttrain.CheckpointManager(root).resume(t3)
    assert int(state.get("compact") or 0) == len(CHUNKS) - 1
    assert_same_rows(t3, clean["torch"].st.table)


def test_compacted_chain_bitwise_and_catchup_bounded(tmp_path, clean):
    """Compacting every 3 deltas never perturbs training; a resume and a
    follower's catch-up through the fold are bitwise the uncompacted
    chain, and the catch-up applies the fold and the tail only, in both
    packages alike."""
    applies = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        st, ss = _stream_leg(pkg, str(tmp_path / f"c-{pkg}"), str(tmp_path / f"cs-{pkg}"), compact_every=3)
        cur = st.mgr.cursor()
        assert int(cur.get("compact") or 0) == 3 and cur["delta_idx"] == len(CHUNKS) - 1
        ff0 = p.mon.STAT_GET("serve.compact_fastforwards")
        ft = _table(pkg)
        pos = p.fol.apply_published_chain(st.mgr.root, ft)
        assert p.mon.STAT_GET("serve.compact_fastforwards") == ff0 + 1
        assert pos["delta_idx"] == cur["delta_idx"]
        fol = p.fol.Follower(st.mgr.root, p.table.ValueLayout(embedx_dim=4), p.table.SparseOptimizerConfig(**OPT), n_host_shards=2)
        a0 = p.mon.STAT_GET("serve.applies")
        assert fol.poll_once()
        applies[pkg] = p.mon.STAT_GET("serve.applies") - a0
        if pkg == "torch":
            assert_same_rows(st.table, clean["torch"].st.table)
            assert_same_rows(ft, clean["torch"].st.table)
            tr2 = _table("torch")
            assert int(ttrain.CheckpointManager(st.mgr.root).resume(tr2).get("compact")) == 3
            assert_same_rows(tr2, clean["torch"].st.table)
            hist = tmonitor.STAT_HIST("serve.freshness_s")
            assert hist is not None and hist.count > 0
    assert applies["torch"] == applies["jax"] == (len(CHUNKS) - 1 - 3) + 1


def test_streaming_off_ablation_bitwise(tmp_path, clean):
    """The same records as a file list, one pass a chunk: bitwise the
    streamed cuts in the port, within the bounds of JAX's ablation."""
    tables = {}
    for pkg in PKGS:
        root = tmp_path / f"c-{pkg}"
        root.mkdir()
        st = _build(pkg, root)
        rng = np.random.default_rng(7)
        for i, (rows, lo) in enumerate(CHUNKS):
            path = str(root / f"pass-{i}.txt")
            with open(path, "w") as f:
                f.write("\n".join(_chunk_lines(rng, rows, lo)) + "\n")
            st.sup.run_pass([path], date=DATE, save="base" if i == 0 else "delta")
        tables[pkg] = st.table
    assert_same_rows(tables["torch"], clean["torch"].st.table)
    assert_close_rows(tables["torch"], tables["jax"])


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_backlog_stretches_cadence_and_recovers(tmp_path, pkg):
    """Cuts that take 3x their window stretch the cadence (counted, capped
    at the flag); fast cuts shrink it back. The same stretches in both
    packages on a fake clock."""
    p = PKGS[pkg]
    root, stream = tmp_path / "r", tmp_path / "s"
    root.mkdir()
    stream.mkdir()
    st = _build(pkg, root)
    clk = {"t": 0.0}
    ss = p.train.StreamSupervisor(
        st.sup, str(stream), DATE, pattern="*.txt", micro_pass_s=1.0, poll_interval_s=0.25,
        compact_every=0, clock=lambda: clk["t"],
    )
    real_tp = ss._train_publish

    def slow_tp(*a, **kw):
        out = real_tp(*a, **kw)
        clk["t"] += 3.0 * ss.micro_pass_s * ss._stretch
        return out

    ss._train_publish = slow_tp
    rng = np.random.default_rng(7)
    stop = threading.Event()

    def sleep_fn(dt):
        clk["t"] += max(dt, 0.05)
        if ss.cut_seq >= 3:
            stop.set()
        else:
            _append(stream, "a.txt", _chunk_lines(rng, 16, 100 * ss.cut_seq))

    before = p.mon.STAT_GET("stream.backlog_stretches")
    ss.run(stop, sleep=sleep_fn)
    assert ss.cut_seq >= 3
    stretches = p.mon.STAT_GET("stream.backlog_stretches") - before
    assert stretches == 3  # x2, x4, x8 over three overrunning cuts
    stretched = ss._stretch
    assert 1.0 < stretched <= float(p.config.get_flag("stream_backlog_max_stretch"))
    ss._train_publish = real_tp
    stop2 = threading.Event()
    goal = ss.cut_seq + 2

    def sleep_fast(dt):
        clk["t"] += max(dt, 0.05)
        if ss.cut_seq >= goal:
            stop2.set()
        else:
            _append(stream, "a.txt", _chunk_lines(rng, 16, 900 + ss.cut_seq))

    ss.run(stop2, sleep=sleep_fast)
    assert ss._stretch < stretched


def test_coordinator_rounds_are_refused():
    from paddlebox_tpu_torch.train import stream

    for fn in (stream.stream_cut_round, stream.stream_confirm_round):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5.3"):
            fn(object(), 1)
