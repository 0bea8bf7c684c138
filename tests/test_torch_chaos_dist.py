"""The coordinated PassSupervisor over several ranks, in both packages.

The supervisor cases of ``tests/test_chaos_dist.py:475-830``, each run
once over a world of JAX ranks with the JAX supervisor and once over a
world of port ranks with the port's, on the same inputs (made with numpy
from a seed): a peer's gate rejection reverts every rank, a peer's load
failure stops every rank before anything is armed, and the poison verdict
rides the coordinated allgather under ``fail``, ``skip_pass`` and
``degrade``. The two runs must agree on every rank's incidents (kind,
action, attempt), its pass epoch, and its counts of begin, end and revert
(or of training calls), and on the digest of the records it trained.

Datasets: the dataset double of ``tests/test_chaos_dist.py:475`` for the
verdict protocol, and real ``BoxPSDataset``s on the Python parser tier
(the flag set in both registries) for the poison verdict. Every transport
is closed in a ``finally`` and every rank thread joined with a limit.
"""

from __future__ import annotations

import os
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.data as jdata
import paddlebox_tpu.table as jtable
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.table as ttable
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_coordinator import PKG, close_all, run_ranks, set_both, world

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

N_RANKS = 3
S = 2
DATE = "20260101"
DATA = {"jax": (jdata, jtable), "torch": (tdata, ttable)}


@pytest.fixture(autouse=True)
def python_tier():
    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu_torch import config

    names = ("enable_native_parser", "fs_open_backoff_s")
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in names]
    set_both(enable_native_parser=0, fs_open_backoff_s=0.0)
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def incidents(sup):
    return [(i.kind, i.action, i.attempt) for i in sup.incidents]


class FakeDS:
    """``tests/test_chaos_dist.py:475``'s dataset double: the surface under
    test is the verdict and epoch protocol across ranks."""

    def __init__(self):
        self.table = None
        self._in_pass = False
        self.pass_epoch = 0
        self.begun = self.ended = self.reverted = 0

    def set_date(self, date):
        pass

    def set_filelist(self, files):
        pass

    def load_into_memory(self):
        pass

    def begin_pass(self, round_to=512, enable_revert=False, trainer=None):
        self._in_pass = True
        self.begun += 1

    def end_pass(self, table, shrink=True):
        self._in_pass = False
        self.ended += 1

    def revert_pass(self):
        self._in_pass = False
        self.reverted += 1
        self.pass_epoch += 1


def fake_trainer(aucs):
    it = iter(aucs)
    return SimpleNamespace(
        prepare_pass=lambda ds, n: None,
        train_pass=lambda ds, n_batches=None: {"batches": 4.0, "nan_batches": 0.0, "auc": next(it)},
        trained_table=lambda: None,
    )


def _peer_abort(kind):
    smod = PKG[kind][1]
    tps = world([kind] * 2)
    try:
        sups = [
            smod.PassSupervisor(
                FakeDS(), fake_trainer([0.1, 0.9] if r == 1 else [0.9, 0.9]),
                gates=smod.HealthGates(auc_absolute_floor=0.5, auc_min_history=99),
                retry=smod.RetryPolicy(backoff_s=0.0, sleep=lambda s: None),
                transport=tps[r],
            )
            for r in range(2)
        ]
        outs = run_ranks(lambda r: sups[r].run_pass(["f"]), 2)
    finally:
        close_all(tps)
    return [
        (o["auc"], s.ds.begun, s.ds.reverted, s.ds.ended, s.coord.epoch, incidents(s))
        for o, s in zip(outs, sups)
    ]


def test_peer_abort_reverts_every_rank():
    """Rank 1's AUC gate rejects attempt 1: rank 0, healthy, hears the no
    and reverts too; both retry in the next epoch and confirm once."""
    got = {kind: _peer_abort(kind) for kind in PKG}
    assert got["torch"] == got["jax"]
    for auc, begun, reverted, ended, epoch, _ in got["torch"]:
        assert (auc, begun, reverted, ended, epoch) == (0.9, 2, 1, 1, 1)
    assert got["torch"][0][5] == [("peer_abort", "revert_retry", 0)]
    assert got["torch"][1][5] == [("gate_auc", "revert_retry", 0)]


def _peer_load_failure(kind):
    smod = PKG[kind][1]
    tps = world([kind] * 2)
    try:
        sups = []
        for r in range(2):
            ds = FakeDS()
            if r == 1:

                def boom():
                    raise OSError("input never materialized")

                ds.load_into_memory = boom
            sups.append(smod.PassSupervisor(
                ds, fake_trainer([0.9]),
                retry=smod.RetryPolicy(max_retries=1, backoff_s=0.0, sleep=lambda s: None),
                transport=tps[r],
            ))

        def worker(r):
            with pytest.raises(smod.PassFailure) as ei:
                sups[r].run_pass(["f"])
            return str(ei.value)

        msgs = run_ranks(worker, 2)
    finally:
        close_all(tps)
    counts = [(s.ds.begun, s.ds.reverted, s.ds.ended, s.coord.epoch, incidents(s)) for s in sups]
    return msgs, counts


def test_peer_load_failure_aborts_cleanly():
    """Rank 1's load dies for good: rank 0 raises PassFailure naming the
    peer instead of waiting in the first exchange; nothing was armed, so
    nothing reverts. Rank 1 votes before it raises."""
    got = {kind: _peer_load_failure(kind) for kind in PKG}
    msgs, counts = got["torch"]
    assert "peer load failed" in msgs[0] and "input never materialized" in msgs[0]
    assert "load failed" in msgs[1]
    assert counts == got["jax"][1]
    assert counts[0] == (0, 0, 0, 0, [("peer_abort", "raise", 0)])
    assert counts[1] == (0, 0, 0, 0, [("load_error", "retry", 0), ("load_error", "raise", 1)])


# ---- the poison verdict over real datasets ----------------------------------

GARBAGE = ["3 zz !! corrupt", "?? ?? ??", "1 1.0 one 5", "2 0.5 x", "1 not-a-float 1 5"]


def write_pass_file(path, seed, poison=False):
    """64 slot lines; with ``poison`` the garbage lines are inserted, so the
    surviving records are the clean file's."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(64):
        parts = [f"1 {float(rng.integers(0, 2))}"]
        for _s in range(S):
            k = int(rng.integers(1, 3))
            parts.append(f"{k} " + " ".join(str(v) for v in rng.integers(1, 200, k)))
        lines.append(" ".join(parts))
    out, injected = [], []
    for i, ln in enumerate(lines):
        if poison and i in (3, 17, 29, 41, 57):
            bad = GARBAGE[len(injected) % len(GARBAGE)]
            out.append(bad)
            injected.append(bad)
        out.append(ln)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with fs_open_write(path) as f:
        f.write("\n".join(out) + "\n")
    return path, injected


def records_digest(records):
    h = 0
    for r in records:
        h = zlib.crc32(np.ascontiguousarray(r.u64_values).tobytes(), h)
        h = zlib.crc32(np.ascontiguousarray(r.f_values).tobytes(), h)
    return float(h)


def digest_trainer():
    """Training is a digest of the admitted records, so a difference in
    lockstep admission shows bitwise."""
    calls = []

    def train_pass(ds, n_batches=None):
        calls.append(1)
        return {"batches": 4.0, "nan_batches": 0.0, "auc": 0.5, "digest": records_digest(ds.records)}

    tr = SimpleNamespace(params=None, prepare_pass=lambda ds, n: None, train_pass=train_pass,
                         trained_table=lambda: None)
    return tr, calls


def mk_ds(kind, qdir):
    data, table = DATA[kind]
    sch = data.SlotSchema([data.SlotInfo("label", type="float", dense=True, dim=1)]
                          + [data.SlotInfo(f"s{i}") for i in range(S)], label_slot="label")
    tab = table.HostSparseTable(table.ValueLayout(embedx_dim=2), table.SparseOptimizerConfig(), n_shards=2, seed=0)
    return data.BoxPSDataset(sch, tab, batch_size=16, shuffle_mode="none", quarantine_dir=qdir)


def _poison_day(kind, d, on_poisoned):
    """Three real datasets, rank 1's file corrupted, under coordinated
    supervisors."""
    smod = PKG[kind][1]
    tps = world([kind] * N_RANKS)
    sleeps = [[] for _ in range(N_RANKS)]
    try:
        sups, callss, files = [], [], []
        injected = None
        for r in range(N_RANKS):
            f, inj = write_pass_file(os.path.join(d, f"r{r}", "part.txt"), seed=50 + r, poison=(r == 1))
            files.append(f)
            if r == 1:
                injected = inj
            tr, calls = digest_trainer()
            callss.append(calls)
            sups.append(smod.PassSupervisor(
                mk_ds(kind, os.path.join(d, f"q-{kind}-r{r}")), tr,
                retry=smod.RetryPolicy(backoff_s=0.0, sleep=sleeps[r].append),
                round_to=8, on_poisoned=on_poisoned, transport=tps[r],
            ))

        def worker(r):
            try:
                return sups[r].run_pass([files[r]], date=DATE)
            except DATA[kind][0].DataPoisonedError as e:  # the "fail" policy's, compared below
                return e

        outs = run_ranks(worker, N_RANKS)
    finally:
        close_all(tps)
    return sups, outs, callss, sleeps, injected


@pytest.mark.parametrize("policy", ["fail", "skip_pass", "degrade"])
def test_poison_verdict_in_lockstep(tmp_path, policy):
    """Rank 1's corrupt pass: under ``fail`` every rank raises
    DataPoisonedError after one attempt, under ``skip_pass`` every rank
    drops the pass, under ``degrade`` every rank trains it (rank 1 over
    exactly its surviving records). No backoff is slept anywhere, and the
    port's ranks record what the JAX package's record."""
    runs = {kind: _poison_day(kind, str(tmp_path / kind), policy) for kind in PKG}
    sups, outs, callss, sleeps, injected = runs["torch"]
    jsups, jouts, jcallss, _, _ = runs["jax"]
    assert all(s == [] for s in sleeps)
    assert [incidents(s) for s in sups] == [incidents(s) for s in jsups]
    assert callss == jcallss
    for r in (0, 2):
        assert "rank 1" in sups[r].incidents[0].detail
    if policy == "fail":
        assert all(c == [] for c in callss)
        assert all(isinstance(e, tdata.DataPoisonedError) for e in outs)
        assert "peer" not in str(outs[1]) and outs[1].report["bad_lines"] == len(injected)
        assert outs[1].dead_letter and os.path.exists(outs[1].dead_letter)
        for r in (0, 2):
            assert "peer pass data poisoned" in str(outs[r])
        assert [incidents(s) for s in sups] == [[("data_poisoned", "raise", 0)]] * N_RANKS
    elif policy == "skip_pass":
        assert outs == [None] * N_RANKS and all(c == [] for c in callss)
        assert [incidents(s) for s in sups] == [[("data_poisoned", "skip", 0)]] * N_RANKS
    else:
        assert all(c == [1] for c in callss)
        assert [incidents(s) for s in sups] == [[("data_poisoned", "degrade", 0)]] * N_RANKS
        assert outs[1]["quarantined_bad_lines"] == float(len(injected))
        assert outs[0]["quarantined_bad_lines"] == 0.0
        assert [o["digest"] for o in outs] == [o["digest"] for o in jouts]
        dl = tdata.read_dead_letter(sups[1].ds.stats.dead_letter)
        assert [e["line"] for e in dl["entries"]] == injected
        clean, _ = write_pass_file(str(tmp_path / "ref" / "part.txt"), seed=51)
        ref = mk_ds("torch", str(tmp_path / "q-ref"))
        ref.set_date(DATE)
        ref.set_filelist([clean])
        ref.load_into_memory()
        assert outs[1]["digest"] == records_digest(ref.records)
