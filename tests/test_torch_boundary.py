"""The port's pipelined pass boundary against the sequential one and against
the JAX package's, bitwise, plus the healing of its three fault sites.

The pipeline (the load's feed stage premerging the staged keys and, at
``shrink_threshold=0``, prefetching their host rows while the current pass
trains; the asynchronous end_pass; the kicked writeback) only moves work
in time: a pipelined run equals the sequential one (``boundary_pipeline=0``)
bit for bit. Across the packages the "training" is ``fake_train`` (see
``test_torch_carrier.py``); within the port it is the real trainer on the
CPU, losses included. Fault plans are the same rule armed in each
package's own ``faultinject``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.utils import faultinject as jfault
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils import faultinject as fault
from tests.test_torch_carrier import (  # noqa: F401  (restore_flags: the autouse fixture)
    B,
    D,
    S,
    Side,
    assert_same,
    fake_train,
    restore_flags,
    set_both,
    write_pass,
)

torch.set_num_threads(2)

def _files(tmp_path, tag=""):
    # overlapping key ranges: every boundary has carried-over and new keys
    return [write_pass(str(tmp_path / f"{tag}p{p}.txt"), p, 1 + 40 * p, 161 + 40 * p, n=64) for p in range(3)]


def _staged_two_pass(side: Side, files, device: bool):
    """Pass 2 loaded while pass 1 is live (a synchronous load, so the
    feed stage's prefetch is staged deterministically), then both passes
    end. Returns (prefetch, pass-2 table, host contents)."""
    t1 = fake_train(side, side.load(files[0]))
    side.ds.set_filelist([files[1]])
    side.ds.load_into_memory()
    prefetch = side.ds._boundary_prefetch
    side.ds.end_pass(side.device(t1) if device else t1)
    t2_in = side.begin()
    t2 = fake_train(side, t2_in)
    side.ds.end_pass(side.device(t2) if device else t2)
    side.table.drain_pending()
    return prefetch, t2_in, side.contents()


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "classic"])
def test_prefetch_consumed_equals_sequential_and_jax(tmp_path, carried):
    """The staged prefetch (its rows pulled before end_pass's decay, so
    the consumer's catch-up decay runs for real) gives the sequential
    boundary's bits, in the port and in the JAX package."""
    files = _files(tmp_path)
    runs = {}
    for pkg in ("torch", "jax"):
        for pipeline in (1, 0):
            set_both(boundary_pipeline=pipeline, enable_carried_table=int(carried), wire_dtype="fp32")
            runs[pkg, pipeline] = _staged_two_pass(Side(pkg), files, device=True)
    pf = runs["torch", 1][0]
    assert pf is not None and len(pf["keys"]) > 0
    assert runs["torch", 0][0] is None
    assert_same(pf["keys"], runs["jax", 1][0]["keys"])
    assert_same(pf["rows"], runs["jax", 1][0]["rows"])
    for key in runs:
        assert_same(runs[key][1], runs["torch", 0][1])
        assert_same(runs[key][2][0], runs["torch", 0][2][0])
        assert_same(runs[key][2][1], runs["torch", 0][2][1])


def _real_two_pass(files, pipeline: int, carried: bool):
    set_both(boundary_pipeline=pipeline, enable_carried_table=int(carried), wire_dtype="fp32")
    side = Side("torch")
    lay = side.layout
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=side.opt, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, hidden=(8,), generator=torch.Generator().manual_seed(0))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")
    side.load(files[0])
    outs = [tr.train_pass(side.ds)]
    side.ds.set_filelist([files[1]])
    side.ds.preload_into_memory()  # beside pass 1's end
    side.ds.end_pass_async(tr.trained_table_device() if carried else tr.trained_table())
    side.ds.wait_preload_done()
    side.begin()
    outs.append(tr.train_pass(side.ds))
    side.ds.end_pass(tr.trained_table_device() if carried else tr.trained_table())
    side.table.drain_pending()
    dense = [v.clone() for v in tr.params.values()]
    return outs, side.contents(), dense


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "classic"])
def test_pipelined_training_equals_sequential_bitwise(tmp_path, carried):
    files = _files(tmp_path)
    o_on, (k_on, v_on), d_on = _real_two_pass(files, 1, carried)
    o_off, (k_off, v_off), d_off = _real_two_pass(files, 0, carried)
    for a, b in zip(o_on, o_off):
        assert a["loss"] == b["loss"] and a["auc"] == b["auc"]
    assert_same(k_on, k_off)
    assert_same(v_on, v_off)
    for a, b in zip(d_on, d_off):
        assert torch.equal(a, b)


def test_stage_pull_fault_heals_with_a_reload(tmp_path):
    """A failed feed-stage prefetch fails that load cleanly (the staged
    slot dropped) and a plain reload stages it again; the run ends as one
    without the fault, in both packages."""
    files = _files(tmp_path)
    set_both(boundary_pipeline=1, enable_carried_table=1, wire_dtype="fp32")
    clean = _staged_two_pass(Side("torch"), files, device=True)
    for pkg, fi in (("torch", fault), ("jax", jfault)):
        side = Side(pkg)
        t1 = fake_train(side, side.load(files[0]))
        side.ds.set_filelist([files[1]])
        with fi.inject(fi.fail_once("boundary.stage_pull")) as plan:
            with pytest.raises(fi.InjectedFault):
                side.ds.load_into_memory()
        assert plan.failures("boundary.stage_pull") == 1
        assert side.ds._staged is None and side.ds._boundary_prefetch is None
        side.ds.load_into_memory()  # the heal
        assert side.ds._boundary_prefetch is not None
        side.ds.end_pass(side.device(t1))
        t2_in = side.begin()
        side.ds.end_pass(side.device(fake_train(side, t2_in)))
        side.table.drain_pending()
        assert_same(t2_in, clean[1])
        assert_same(side.contents()[1], clean[2][1])


def test_writeback_fault_heals_on_an_end_pass_retry(tmp_path):
    """boundary.writeback fails the end_pass worker: the pass re-opens,
    the staged next pass and its prefetch survive, and the retried
    end_pass completes to the fault-free bits, in both packages."""
    files = _files(tmp_path)
    set_both(boundary_pipeline=1, enable_carried_table=0, wire_dtype="fp32")
    clean = _staged_two_pass(Side("torch"), files, device=False)
    for pkg, fi in (("torch", fault), ("jax", jfault)):
        side = Side(pkg)
        t1 = fake_train(side, side.load(files[0]))
        side.ds.set_filelist([files[1]])
        side.ds.load_into_memory()
        assert side.ds._boundary_prefetch is not None
        with fi.inject(fi.fail_once("boundary.writeback")) as plan:
            with pytest.raises(fi.InjectedFault):
                side.ds.end_pass(t1)
        assert plan.failures("boundary.writeback") == 1
        assert side.ds._in_pass and side.ds._boundary_prefetch is not None
        side.ds.end_pass(t1)  # the retry heals
        t2_in = side.begin()
        side.ds.end_pass(fake_train(side, t2_in))
        assert_same(t2_in, clean[1])
        assert_same(side.contents()[1], clean[2][1])


def test_premerge_fault_becomes_a_load_retry(tmp_path):
    """A failed premerge is a plain load failure: nothing stays staged,
    and the retried load runs the pass to the fault-free bits."""
    files = _files(tmp_path)
    set_both(boundary_pipeline=1, enable_carried_table=1, wire_dtype="bf16")
    want = {}
    for pkg, fi in (("torch", fault), ("jax", jfault)):
        side = Side(pkg)
        side.ds.set_filelist([files[0]])
        with fi.inject(fi.fail_once("boundary.premerge")) as plan:
            with pytest.raises(fi.InjectedFault):
                side.ds.load_into_memory()
            assert plan.failures("boundary.premerge") == 1
            assert side.ds._staged is None
            side.ds.load_into_memory()
        t1 = fake_train(side, side.begin())
        side.ds.end_pass(side.device(t1))
        want[pkg] = side.load(files[1])
        side.ds.end_pass(None)
    assert_same(want["torch"], want["jax"])


def test_premerge_preserves_finalize_bitwise():
    """premerge (threaded) then finalize builds the working set and the
    table a finalize over the raw chunks builds, in both packages."""
    rng = np.random.default_rng(7)
    chunks = [rng.integers(1, 50_000, 4096).astype(np.uint64) for _ in range(5)]
    opt = dict(embedx_threshold=0.0, show_clk_decay=0.97, shrink_threshold=0.0)

    def build(premerge, jax_pkg):
        if jax_pkg:
            table = JHostSparseTable(JValueLayout(embedx_dim=4), JSparseOptimizerConfig(**opt), n_shards=2, seed=0)
            ws = JPassWorkingSet(n_mesh_shards=2)
        else:
            table = HostSparseTable(ValueLayout(embedx_dim=4), SparseOptimizerConfig(**opt), n_shards=2, seed=0)
            ws = PassWorkingSet(n_mesh_shards=2)
        for c in chunks:
            ws.add_keys(c)
        if premerge:
            merged = ws.premerge(threads=4)
            assert merged is ws._key_chunks[0]
        return ws, np.asarray(ws.finalize(table, round_to=8))

    ws_a, dev_a = build(False, False)
    for premerge, jax_pkg in ((True, False), (True, True), (False, True)):
        ws_b, dev_b = build(premerge, jax_pkg)
        assert_same(ws_b.sorted_keys, ws_a.sorted_keys)
        assert_same(ws_b.row_of_sorted, ws_a.row_of_sorted)
        assert ws_b.capacity == ws_a.capacity
        assert_same(dev_b, dev_a)


def test_premerge_after_finalize_is_rejected():
    ws = PassWorkingSet(n_mesh_shards=2)
    ws.add_keys(np.arange(1, 100, dtype=np.uint64))
    table = HostSparseTable(ValueLayout(embedx_dim=4), SparseOptimizerConfig(shrink_threshold=0.0), n_shards=2, seed=0)
    ws.finalize(table, round_to=8)
    with pytest.raises(RuntimeError, match="finalized"):
        ws.premerge()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_kick_then_revert_cancels_and_restores(tmp_path, pkg):
    """A kicked writeback in flight when the pass is rejected stops at a
    chunk boundary; the revert restores every pass key's pre-pass row and
    drops the staged next pass, and the retried pass ends as one that was
    never kicked."""
    files = _files(tmp_path)
    set_both(boundary_pipeline=1, enable_carried_table=1, wire_dtype="fp32", writeback_chunk_keys=16)
    side = Side(pkg)
    side.ds.set_filelist([files[0]])
    side.ds.load_into_memory()
    t1 = fake_train(side, side.begin(enable_revert=True))
    keys = side.ds.ws.sorted_keys.copy()
    pre = side.table.pull_or_create(keys).copy()
    side.ds.set_filelist([files[1]])
    side.ds.preload_into_memory()
    side.ds.kick_writeback(t1)
    assert side.ds._wb_kick is not None
    side.ds.revert_pass()
    assert side.ds._wb_kick is None and side.ds._staged is None
    assert_same(side.table.pull_or_create(keys), pre)
    t1b = fake_train(side, side.begin(enable_revert=True))
    assert_same(t1b, t1)
    side.ds.kick_writeback(t1b)  # joined by end_pass, then confirmed
    side.ds.end_pass(side.device(t1b))
    assert side.ds._guard is None

    # the staged pass's prefetch created its rows; the pass's own keys
    # hold what a run that was never kicked nor reverted holds
    ref = Side(pkg)
    ref.ds.end_pass(fake_train(ref, ref.load(files[0])))
    assert_same(side.table.pull_or_create(keys), ref.table.pull_or_create(keys))


def test_bench_boundary_sequence_matches_jax_bitwise(tmp_path):
    """bench.py's boundary, call for call, at a small size and its flags
    (bf16 wire, bench's shrink threshold 1.0 and decay 0.98, so the staged
    prefetch stays off): pipelined and sequential, in both packages, give
    one pass-2 table and one host table."""
    p1 = [write_pass(str(tmp_path / f"part-{i}.txt"), i, 1, 400, n=64) for i in range(3)]
    p2 = [write_pass(str(tmp_path / f"p2-part-{i}.txt"), 10 + i, 1, 400, n=64) for i in range(3)]
    out = {}
    for pkg in ("torch", "jax"):
        for pipelined in (1, 0):
            set_both(wire_dtype="bf16", boundary_pipeline=pipelined)
            side = Side(pkg, shrink=1.0, decay=0.98, batch=16)
            ds, table = side.ds, side.table
            ds.set_filelist(p1)
            ds.load_into_memory()
            t1_in = np.array(ds.begin_pass(round_to=512), np.float32)
            if pipelined:
                ds.set_filelist(p2)
                ds.preload_into_memory()
            trained = side.device(fake_train(side, t1_in))
            if pipelined:
                ds.end_pass_async(trained)
                ds.wait_preload_done()
            else:
                ds.end_pass(trained)
                ds.set_filelist(p2)
                ds.load_into_memory()
            t2 = np.array(ds.begin_pass(round_to=512), np.float32)
            n2 = int(ds.ws.n_keys)
            ended = ds.end_pass(None)
            table.drain_pending()
            out[pkg, pipelined] = (t2, n2, ended["dropped"], side.contents())
    want = out["jax", 0]
    assert want[2] > 0  # the shrink dropped keys
    for key, got in out.items():
        assert_same(got[0], want[0])
        assert got[1:3] == want[1:3]
        assert_same(got[3][0], want[3][0])
        assert_same(got[3][1], want[3][1])
