"""The elastic day under the port's PassSupervisor: rank death, planned
migration, and the grow half (``join_day``), on the host plane.

The supervisor-level cases of ``tests/test_elastic.py:468-1383``, with the
same doubles: a dataset over a real ``HostSparseTable`` and
``DistributedWorkingSet`` (record i of a pass goes to
``sorted(live)[i % n_live]``, so the global record multiset does not
depend on the membership) and a trainer that applies one deterministic
transform a pass and records per-record preds from the global row
assignment. A survivor of a shrink owns several mesh shards, which no
trainer of either package places on a mesh, so the elastic day is a host
plane matter in both, as it is there.

Each schedule holds the port to a fresh run of its own at the final
membership: the ownership-filtered merged digest (keys and rows) and
every pass's AUC, bitwise. The rank-death and join schedules also run in
the JAX package, and the port's merged digest and incidents (kind,
action, attempt) must be the JAX run's, bitwise.

The transport knobs are the JAX fixture's (``tests/test_elastic.py:
82-97``: ``transport_peer_dead_s`` 0.6 s where a rank dies, member rounds
of 3 s), set in both registries and restored after each test; every
transport is closed in a ``finally`` and every rank thread joined with a
limit.
"""

from __future__ import annotations

import glob
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.metrics.auc as jauc
import paddlebox_tpu.parallel.membership as jmem
import paddlebox_tpu.parallel.transport as jtransport
import paddlebox_tpu.table.dist_ws as jdws
import paddlebox_tpu.table.sparse_table as jst
import paddlebox_tpu.train.checkpoint as jck
import paddlebox_tpu.train.supervisor as jsup
import paddlebox_tpu.utils.faultinject as jfault
import paddlebox_tpu.utils.monitor as jmon
import paddlebox_tpu_torch.metrics.auc as tauc
import paddlebox_tpu_torch.parallel.membership as tmem
import paddlebox_tpu_torch.parallel.transport as ttransport
import paddlebox_tpu_torch.table.dist_ws as tdws
import paddlebox_tpu_torch.table.sparse_table as tst
import paddlebox_tpu_torch.train.checkpoint as tck
import paddlebox_tpu_torch.train.supervisor as tsup
import paddlebox_tpu_torch.utils.faultinject as tfault
import paddlebox_tpu_torch.utils.monitor as tmon
from test_torch_coordinator import free_ports, run_ranks, set_both

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

N_MESH = 8
N_RECORDS = 12
DATE = "20260807"
PK = {
    "jax": SimpleNamespace(mem=jmem, tp=jtransport, dws=jdws, st=jst, ck=jck, sup=jsup, fault=jfault, mon=jmon),
    "torch": SimpleNamespace(mem=tmem, tp=ttransport, dws=tdws, st=tst, ck=tck, sup=tsup, fault=tfault, mon=tmon),
}


@pytest.fixture(autouse=True)
def fast_transport():
    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu_torch import config

    names = ("transport_heartbeat_s", "transport_backoff_s", "transport_send_retries", "transport_peer_dead_s")
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in names]
    set_both(transport_heartbeat_s=0.05, transport_backoff_s=0.005, transport_send_retries=6,
             transport_peer_dead_s=60.0)
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def mk_table(pk):
    st = PK[pk].st
    return st.HostSparseTable(st.ValueLayout(embedx_dim=2), st.SparseOptimizerConfig(embedx_threshold=0.0),
                              n_shards=2, seed=0)


class RankKilled(BaseException):
    """Escapes every ``except Exception`` of the supervisor, as a death."""


def global_records(seed, pass_idx, skewed=False):
    """The day's records of one pass, the same for every membership."""
    rng = np.random.default_rng(1000 * seed + pass_idx)
    if skewed:
        pool = rng.integers(1, 1 << 40, 4096).astype(np.uint64)
        pool = pool[tst.key_to_shard(pool, N_MESH) < 2]  # hot shards 0-1
    else:
        pool = rng.integers(1, 160, 4096).astype(np.uint64)
    recs = []
    for _ in range(N_RECORDS):
        nk = int(rng.integers(1, 4))
        recs.append((np.unique(rng.choice(pool, nk)), float(rng.integers(0, 2))))
    return recs


class ElasticDS:
    """``tests/test_elastic.py:489``'s dataset double, over either
    package's table and working set."""

    def __init__(self, pk, transport, table, seed, skewed=False, records=global_records):
        self.P = PK[pk]
        self.transport = transport
        self.table = table
        self.seed = seed
        self.skewed = skewed
        self.records_of = records
        self.n_mesh_shards = N_MESH
        self.ownership = None
        self.pass_epoch = 0
        self._in_pass = False
        self.pass_idx = -1
        self.ws = None
        self.dev = None
        self.my_records = []

    def set_date(self, date):
        pass

    def set_filelist(self, files):
        self._files = list(files)

    def load_into_memory(self):
        self.pass_idx = int(self._files[0].rsplit("-", 1)[1])

    def omap(self):
        return self.ownership or self.P.mem.OwnershipMap.even(self.n_mesh_shards, self.transport.n_ranks)

    def begin_pass(self, round_to=8, enable_revert=True, trainer=None):
        omap = self.omap()
        live = list(omap.live_ranks)
        recs = self.records_of(self.seed, self.pass_idx, skewed=self.skewed)
        me = self.transport.rank
        self.my_records = [rec for i, rec in enumerate(recs) if live[i % len(live)] == me]
        ws = self.P.dws.DistributedWorkingSet(self.transport, self.n_mesh_shards, pass_id=self.pass_idx,
                                              epoch=self.pass_epoch, ownership=omap)
        for keys, _ in self.my_records:
            ws.add_keys(keys)
        self.dev = ws.finalize(self.table, round_to=8)
        self.ws = ws
        self._in_pass = True

    def end_pass(self, table, shrink=True):
        self.ws.writeback(self.dev)
        self._in_pass = False

    def revert_pass(self):
        # host rows were only created (seeded per key), never trained
        self.ws = None
        self.dev = None
        self._in_pass = False
        self.pass_epoch += 1


def elastic_trainer(ds, recorder, kill_at=None):
    """``tests/test_elastic.py:555``'s trainer double. ``kill_at`` is a
    pass, or (pass, visit) to die on that pass's n-th attempt."""
    visits = {}

    def train_pass(_ds, n_batches=None):
        if kill_at is not None:
            k_pass, k_visit = kill_at if isinstance(kill_at, tuple) else (kill_at, 1)
            if ds.pass_idx == k_pass:
                visits[k_pass] = visits.get(k_pass, 0) + 1
                if visits[k_pass] >= k_visit:
                    ds.transport.close()
                    raise RankKilled()
        ds.dev = ds.dev * np.float32(1.01) + np.float32(0.25)
        preds, labels = [], []
        for keys, label in ds.my_records:
            rows = ds.ws.lookup(keys).astype(np.int64)
            preds.append(((int(rows.sum()) + ds.pass_idx) % 97) / 97.0)
            labels.append(label)
        recorder[(ds.transport.rank, ds.pass_idx)] = (np.array(preds, np.float32), np.array(labels, np.float32))
        return {"batches": 1.0, "nan_batches": 0.0, "auc": 0.5}

    return SimpleNamespace(
        params=None,
        prepare_pass=lambda _ds, n: None,
        train_pass=train_pass,
        trained_table=lambda: None,
        init_params=lambda *a, **k: None,
        load_dense=lambda path: None,
        save_dense=lambda path: np.savez(path, z=np.zeros(1, np.float32)),
        drop_device_state=lambda: None,
        _state=None,
        _state_ws=None,
    )


def cluster(pk, n):
    eps = [f"127.0.0.1:{p}" for p in free_ports(n)]
    return eps, [PK[pk].tp.TcpTransport(r, eps, timeout=30.0) for r in range(n)]


def mk_sup(pk, rank, tps, root, seed, recorder, kill_at=None, skewed=False, migrate_skew=0.0, initial_live=None,
           target_ranks=None, records=global_records):
    P = PK[pk]
    ds = ElasticDS(pk, tps[rank], mk_table(pk), seed, skewed=skewed, records=records)
    tr = elastic_trainer(ds, recorder, kill_at=kill_at)
    return P.sup.PassSupervisor(
        ds, tr,
        checkpoint=P.ck.CheckpointManager(P.ck.rank_root(root, rank)),
        gates=P.sup.HealthGates(auc_min_history=99),
        retry=P.sup.RetryPolicy(max_retries=2, backoff_s=0.0, sleep=lambda s: None),
        round_to=8,
        transport=tps[rank],
        elastic=P.sup.ElasticConfig(shared_root=root, migrate_skew=migrate_skew, member_timeout=3.0,
                                    initial_live=initial_live, target_ranks=target_ranks),
    )


def owned_digest(sup):
    omap = sup.ds.omap()
    lo, hi = omap.range_of(sup.coord.transport.rank)
    keys = np.sort(sup.table.keys())
    sh = tst.key_to_shard(keys, N_MESH)
    keys = keys[(sh >= lo) & (sh < hi)]
    return keys, sup.table.pull_or_create(keys)


def merged_digest(sups, ranks):
    """Every key once, under its current owner."""
    parts = [owned_digest(sups[r]) for r in ranks]
    keys = np.concatenate([k for k, _ in parts])
    rows = np.concatenate([v for _, v in parts])
    order = np.argsort(keys, kind="stable")
    assert len(keys) == len(np.unique(keys)), "ownership ranges overlap"
    return keys[order], rows[order]


def pass_auc(pk, recorder, p):
    entries = [v for (r, pp), v in sorted(recorder.items()) if pp == p]
    preds = np.concatenate([e[0] for e in entries])
    labels = np.concatenate([e[1] for e in entries])
    if pk == "jax":
        import jax.numpy as jnp

        return jauc.auc_compute(jauc.auc_update(jauc.auc_init(1000), jnp.asarray(preds), jnp.asarray(labels)))
    st = tauc.auc_update(tauc.auc_init(1000, device="cpu"), torch.from_numpy(preds), torch.from_numpy(labels))
    return tauc.auc_compute(st)


def run_day(pk, n, root, seed, recorder, kills=None, skewed=False, migrate_skew=0.0, passes=3, records=global_records):
    _, tps = cluster(pk, n)
    kills = dict(kills or {})
    sups = [mk_sup(pk, r, tps, root, seed, recorder, kill_at=kills.get(r), skewed=skewed,
                   migrate_skew=migrate_skew, records=records) for r in range(n)]
    files = [[f"pass-{p}"] for p in range(passes)]

    def worker(r):
        try:
            return sups[r].run_day(DATE, files)
        except RankKilled:
            return "killed"

    try:
        res = run_ranks(worker, n, limit=120.0)
    finally:
        for t in tps:
            t.close()
    return sups, res


def kinds_of(sup):
    return [(i.kind, i.action, i.attempt) for i in sup.incidents]


def assert_same_day(sups_a, ranks_a, rec_a, sups_b, ranks_b, rec_b, passes, pk_a="torch", pk_b="torch"):
    ak, av = merged_digest(sups_a, ranks_a)
    bk, bv = merged_digest(sups_b, ranks_b)
    np.testing.assert_array_equal(ak, bk)
    np.testing.assert_array_equal(av, bv)
    for p in range(passes):
        assert pass_auc(pk_a, rec_a, p) == pass_auc(pk_b, rec_b, p)


def with_peer_dead(fn):
    set_both(transport_peer_dead_s=0.6)
    try:
        return fn()
    finally:
        set_both(transport_peer_dead_s=60.0)


# ---- rank death ---------------------------------------------------------------


def _death_day(pk, root, seed, passes):
    rec = {}
    sups, res = with_peer_dead(lambda: run_day(pk, 4, root, seed, rec, kills={1: 1}, passes=passes))
    return sups, res, rec


def test_rank_death_mid_pass_bitwise_equals_fresh_shrunk_run(tmp_path):
    """Rank 1 of 4 dies at pass 1: the survivors agree, adopt its shards
    from its durable chain, revert and retry, and finish the day bitwise a
    fresh 3-rank run, and bitwise the JAX package's same schedule."""
    seed, passes = 7, 3
    adopts_before = tmon.STAT_GET("membership.adopts")
    sups, res, rec = _death_day("torch", str(tmp_path / "elastic"), seed, passes)
    survivors = [0, 2, 3]
    assert res[1] == "killed"
    for r in survivors:
        assert len(res[r]) == passes and all(o is not None for o in res[r])
        omap = sups[r].ds.ownership
        assert omap.epoch == 1 and list(omap.live_ranks) == survivors
        assert "rank_death" in [i.kind for i in sups[r].incidents]
    assert tmon.STAT_GET("membership.epoch") == 1
    assert tmon.STAT_GET("membership.adopts") >= adopts_before + 2
    wm = tck.read_watermark(tck.rank_root(str(tmp_path / "elastic"), 0))
    assert wm["ownership_epoch"] == 1
    tck.validate_watermark(wm)
    for r in survivors:
        paths = glob.glob(os.path.join(tck.rank_root(str(tmp_path / "elastic"), r), "obs", "incidents",
                                       "incident-*.json"))
        bundles = [json.load(open(p)) for p in paths]
        (death,) = [b for b in bundles if b.get("reason") == "rank_death"][-1:]
        detail = json.loads(death["detail"])
        assert detail["dead"] == [1] and detail["survivors"] == survivors and detail["ownership_epoch"] == 1
    rec_f = {}
    sups_f, res_f = run_day("torch", 3, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert all(len(r) == passes for r in res_f)
    assert_same_day(sups, survivors, rec, sups_f, [0, 1, 2], rec_f, passes)
    jsups, jres, jrec = _death_day("jax", str(tmp_path / "jax"), seed, passes)
    assert jres[1] == "killed"
    assert_same_day(sups, survivors, rec, jsups, survivors, jrec, passes, pk_b="jax")
    assert [kinds_of(sups[r]) for r in survivors] == [kinds_of(jsups[r]) for r in survivors]


def test_two_ranks_die_same_pass_bitwise_equals_fresh_run(tmp_path):
    """Two deaths in one pass: the membership round re-enters when the
    second surfaces mid-round, and the day is a fresh 2-rank run's."""
    seed, passes = 17, 3
    rec = {}
    sups, res = with_peer_dead(lambda: run_day("torch", 4, str(tmp_path / "double"), seed, rec,
                                                        kills={1: 1, 2: 1}, passes=passes))
    assert res[1] == "killed" and res[2] == "killed"
    survivors = [0, 3]
    for r in survivors:
        assert len(res[r]) == passes and all(o is not None for o in res[r])
        assert list(sups[r].ds.ownership.live_ranks) == survivors
    rec_f = {}
    sups_f, _ = run_day("torch", 2, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert_same_day(sups, survivors, rec, sups_f, [0, 1], rec_f, passes)


def test_death_during_retried_pass_adopts_reanchored_chain(tmp_path):
    """Rank 1 dies at pass 1; rank 2 survives that round (adopting part of
    rank 1's range and re-anchoring at epoch 1), then dies in the retried
    pass 1: the range it gained is durable only in that re-anchor base,
    and adoption from it lands bitwise."""
    seed, passes = 19, 3
    rec = {}
    sups, res = with_peer_dead(lambda: run_day("torch", 4, str(tmp_path / "stagger"), seed, rec,
                                                        kills={1: 1, 2: (1, 2)}, passes=passes))
    assert res[1] == "killed" and res[2] == "killed"
    survivors = [0, 3]
    for r in survivors:
        omap = sups[r].ds.ownership
        assert omap.epoch == 2 and list(omap.live_ranks) == survivors
    rec.pop((2, 1))  # rank 2's reverted first attempt of pass 1
    rec_f = {}
    sups_f, _ = run_day("torch", 2, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert_same_day(sups, survivors, rec, sups_f, [0, 1], rec_f, passes)


# ---- planned migration ----------------------------------------------------------


def test_planned_migration_bitwise_equals_no_migration(tmp_path):
    seed, passes = 11, 3
    before = tmon.STAT_GET("membership.migrated_keys")
    rec_m, rec_0 = {}, {}
    sups_m, res_m = run_day("torch", 3, str(tmp_path / "mig"), seed, rec_m, skewed=True, migrate_skew=1.15,
                            passes=passes)
    sups_0, res_0 = run_day("torch", 3, str(tmp_path / "none"), seed, rec_0, skewed=True, passes=passes)
    assert all(len(r) == passes for r in res_m + res_0)
    for s in sups_m:
        assert "migrate" in [i.kind for i in s.incidents] and s.ds.ownership.epoch >= 1
    assert tmon.STAT_GET("membership.migrated_keys") > before
    assert all(s.ds.ownership is None for s in sups_0)
    assert_same_day(sups_m, [0, 1, 2], rec_m, sups_0, [0, 1, 2], rec_0, passes)


def test_migrate_fault_aborts_then_next_boundary_commits(tmp_path):
    """A fault mid-transfer leaves the old epoch serving; the plan commits
    at the next boundary and the day is the no-migration run's."""
    seed, passes = 11, 3
    before = tmon.STAT_GET("membership.migrations_aborted")
    rec_f, rec_0 = {}, {}
    with tfault.inject(tfault.fail_nth("migrate.transfer", 1)) as plan:
        sups_f, res_f = run_day("torch", 3, str(tmp_path / "fault"), seed, rec_f, skewed=True,
                                migrate_skew=1.15, passes=passes)
    assert plan.failures("migrate.transfer") == 1
    assert all(len(r) == passes for r in res_f)
    assert tmon.STAT_GET("membership.migrations_aborted") > before
    kinds = [i.kind for s in sups_f for i in s.incidents]
    assert "migrate_abort" in kinds and "migrate" in kinds
    sups_0, _ = run_day("torch", 3, str(tmp_path / "none"), seed, rec_0, skewed=True, passes=passes)
    assert_same_day(sups_f, [0, 1, 2], rec_f, sups_0, [0, 1, 2], rec_0, passes)


def test_death_after_migration_commit_bitwise_equals_fresh_run(tmp_path):
    """Rank 1 gains the hot shards at the migration after pass 0 and dies
    in pass 1: adoption restores its migrated-in rows from the re-anchor
    saved at the flip."""
    seed, passes = 13, 3
    rec = {}
    sups, res = with_peer_dead(lambda: run_day("torch", 3, str(tmp_path / "mig_kill"), seed, rec,
                                                        kills={1: 1}, skewed=True, migrate_skew=1.15,
                                                        passes=passes))
    assert res[1] == "killed"
    survivors = [0, 2]
    for r in survivors:
        kinds = [i.kind for i in sups[r].incidents]
        assert "migrate" in kinds and "rank_death" in kinds
        assert sups[r].ds.ownership.epoch >= 2 and list(sups[r].ds.ownership.live_ranks) == survivors
    rec_f = {}
    sups_f, _ = run_day("torch", 2, str(tmp_path / "fresh"), seed, rec_f, skewed=True, passes=passes)
    assert_same_day(sups, survivors, rec, sups_f, [0, 1], rec_f, passes)


def test_migrate_load_view_size_mismatch_raises(tmp_path):
    rec = {}
    _, tps = cluster("torch", 2)
    try:
        sup = mk_sup("torch", 0, tps, str(tmp_path), 3, rec, migrate_skew=1.1)
        good = np.ones(4, "<i8").tobytes()
        sup.coord.transport.allgather = lambda payload, tag, timeout=None: [good, good[:-8]]
        before = tmon.STAT_GET("membership.load_view_errors")
        with pytest.raises(RuntimeError, match="load view"):
            sup._maybe_migrate()
        assert tmon.STAT_GET("membership.load_view_errors") == before + 1
    finally:
        for t in tps:
            t.close()


@pytest.mark.parametrize("pk", ["torch", "jax"])
def test_adopt_fallback_uses_previous_owners_chain(tmp_path, pk):
    """A dead chain whose epoch predates the installed map cannot cover
    the ranges gained at that flip: adoption takes exactly those pieces
    from the previous owners' chains, bitwise, in both packages alike."""
    P = PK[pk]
    root = str(tmp_path)
    m0 = P.mem.OwnershipMap.even(N_MESH, 4)
    m1 = m0.shrink([1])
    m2 = m1.shrink([2])
    src = mk_table(pk)
    keys = np.arange(1, 90, dtype=np.uint64)
    src.push(keys, src.pull_or_create(keys) * np.float32(1.01) + np.float32(0.25))
    P.ck.CheckpointManager(P.ck.rank_root(root, 1)).save_base(DATE, src)
    t2 = mk_table(pk)
    sh = tst.key_to_shard(keys, N_MESH)
    mine2 = keys[(sh >= 4) & (sh < 6)]
    t2.push(mine2, t2.pull_or_create(mine2) * np.float32(1.02))
    P.ck.CheckpointManager(P.ck.rank_root(root, 2)).save_base(DATE, t2)
    bare = mk_table(pk)
    assert P.mem.adopt_dead_shards(bare, root, 2, m1, m2, 0) == 0 and len(bare.keys()) == 0
    before = P.mon.STAT_GET("membership.adopt_fallbacks")
    t = mk_table(pk)
    want = np.sort(keys[sh == 3])
    assert P.mem.adopt_dead_shards(t, root, 2, m1, m2, 0, prev_map=m0) == len(want) > 0
    assert P.mon.STAT_GET("membership.adopt_fallbacks") == before + 1
    np.testing.assert_array_equal(np.sort(t.keys()), want)
    np.testing.assert_array_equal(t.pull_or_create(want), src.pull_or_create(want))
    t3 = mk_table(pk)
    assert P.mem.adopt_dead_shards(t3, root, 2, m1, m2, 3, prev_map=m0) == len(mine2)
    np.testing.assert_array_equal(t3.pull_or_create(mine2), t2.pull_or_create(mine2))


# ---- the grow half ----------------------------------------------------------------


def join_worker(sups, files, joiner, timeout=60.0):
    def worker(r):
        if r == joiner:
            return sups[r].join_day(files, timeout=timeout)
        return sups[r].run_day(DATE, files)

    return worker


def _join_day(pk, root, seed, passes, fault=None):
    P = PK[pk]
    _, tps = cluster(pk, 4)
    rec = {}
    sups = [mk_sup(pk, r, tps, root, seed, rec, initial_live=[0, 1, 2]) for r in range(3)]
    sups.append(mk_sup(pk, 3, tps, root, seed, rec))
    files = [[f"pass-{p}"] for p in range(passes)]
    try:
        if fault is None:
            res = run_ranks(join_worker(sups, files, joiner=3), 4, limit=120.0)
            failures = 0
        else:
            with P.fault.inject(P.fault.fail_nth(fault, 1)) as plan:
                res = run_ranks(join_worker(sups, files, joiner=3), 4, limit=120.0)
            failures = plan.failures(fault)
    finally:
        for t in tps:
            t.close()
    return sups, res, rec, failures


def test_rank_join_mid_day_bitwise_equals_fresh_grown_run(tmp_path):
    """Rank 3 joins a fleet of three at a published boundary: one flip to
    live [0, 1, 2, 3], its chain re-anchored at the join epoch, and the day
    bitwise a fresh 4-rank run, and the JAX package's same schedule."""
    seed, passes = 23, 3
    joins_before = tmon.STAT_GET("membership.joins_total")
    root = str(tmp_path / "join")
    sups, res, rec, _ = _join_day("torch", root, seed, passes)
    for r in range(4):
        omap = sups[r].ds.ownership
        assert omap.epoch == 1 and list(omap.live_ranks) == [0, 1, 2, 3]
        joins = [i for i in sups[r].incidents if i.kind == "rank_join"]
        assert joins and "joiner=3" in joins[-1].detail
    assert len(res[3]) >= 1 and all(o is not None for o in res[3])
    assert all(len(res[r]) == passes for r in range(3))
    assert tmon.STAT_GET("membership.joins_total") >= joins_before + 4
    wm = tck.read_watermark(tck.rank_root(root, 3))
    assert wm["ownership_epoch"] == 1 and wm["live_ranks"] == [0, 1, 2, 3]
    tck.validate_watermark(wm)
    rec_f = {}
    sups_f, _ = run_day("torch", 4, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert_same_day(sups, [0, 1, 2, 3], rec, sups_f, [0, 1, 2, 3], rec_f, passes)
    jsups, jres, jrec, _ = _join_day("jax", str(tmp_path / "jax"), seed, passes)
    assert_same_day(sups, [0, 1, 2, 3], rec, jsups, [0, 1, 2, 3], jrec, passes, pk_b="jax")
    assert [kinds_of(s) for s in sups] == [kinds_of(s) for s in jsups]


def _kill_rejoin(pk, root, seed, passes):
    P = PK[pk]
    eps, tps = cluster(pk, 4)
    rec = {}
    sups = [mk_sup(pk, r, tps, root, seed, rec, kill_at=1 if r == 1 else None) for r in range(4)]
    files = [[f"pass-{p}"] for p in range(passes)]

    def worker(r):
        if r != 1:
            return sups[r].run_day(DATE, files)
        try:
            sups[1].run_day(DATE, files)
            raise AssertionError("rank 1 was not killed")
        except RankKilled:
            pass
        # announce only once every survivor installed the shrink: a new
        # incarnation's heartbeats would hide the old one's silence
        deadline = time.monotonic() + 60.0
        while not all(sups[q].ds.ownership is not None and sups[q].ds.ownership.epoch >= 1 for q in (0, 2, 3)):
            if time.monotonic() >= deadline:
                raise AssertionError("survivors never installed the shrink")
            time.sleep(0.02)
        tps[1] = P.tp.TcpTransport(1, eps, timeout=30.0)
        sups[1] = mk_sup(pk, 1, tps, root, seed, rec)
        return sups[1].join_day(files, timeout=60.0)

    set_both(transport_peer_dead_s=0.6)
    try:
        res = run_ranks(worker, 4, limit=120.0)
    finally:
        set_both(transport_peer_dead_s=60.0)
        for t in tps:
            t.close()
    return sups, res, rec


def test_kill_then_rejoin_bitwise_equals_fresh_run(tmp_path):
    """Rank 1 dies at pass 1 (shrink, epoch 1) and a new incarnation
    rejoins (grow, epoch 2): the day is bitwise a fresh 4-rank run, and
    the JAX package's same schedule."""
    seed, passes = 31, 5
    root = str(tmp_path / "rejoin")
    sups, res, rec = _kill_rejoin("torch", root, seed, passes)
    for r in range(4):
        omap = sups[r].ds.ownership
        assert omap.epoch == 2 and list(omap.live_ranks) == [0, 1, 2, 3]
    for r in (0, 2, 3):
        kinds = [i.kind for i in sups[r].incidents]
        assert "rank_death" in kinds and "rank_join" in kinds
        assert len(res[r]) == passes and all(o is not None for o in res[r])
    assert "rank_join" in [i.kind for i in sups[1].incidents]
    assert len(res[1]) >= 1
    wm = tck.read_watermark(tck.rank_root(root, 1))
    assert wm["ownership_epoch"] == 2 and wm["live_ranks"] == [0, 1, 2, 3]
    rec_f = {}
    sups_f, _ = run_day("torch", 4, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert_same_day(sups, [0, 1, 2, 3], rec, sups_f, [0, 1, 2, 3], rec_f, passes)
    jsups, _, jrec = _kill_rejoin("jax", str(tmp_path / "jax"), seed, passes)
    assert_same_day(sups, [0, 1, 2, 3], rec, jsups, [0, 1, 2, 3], jrec, passes, pk_b="jax")


def test_join_catchup_fault_aborts_at_old_epoch_then_retry_commits(tmp_path):
    """A join aborted mid-catch-up leaves the fleet at the old epoch; the
    joiner knocks again and the retried join commits, bitwise a fresh
    4-rank run, with an incident bundle naming the joiner and its ranges."""
    seed, passes = 37, 3
    before = tmon.STAT_GET("membership.joins_aborted")
    root = str(tmp_path / "jfault")
    sups, res, rec, failures = _join_day("torch", root, seed, passes, fault="membership.catchup_apply")
    assert failures == 1
    assert tmon.STAT_GET("membership.joins_aborted") >= before + 4
    for r in range(4):
        kinds = [i.kind for i in sups[r].incidents]
        assert kinds.index("join_abort") < kinds.index("rank_join"), (r, kinds)
        assert sups[r].ds.ownership.epoch == 1
        paths = glob.glob(os.path.join(tck.rank_root(root, r), "obs", "incidents", "incident-*.json"))
        aborts = [b for b in (json.load(open(p)) for p in paths) if b.get("reason") == "join_abort"]
        detail = json.loads(aborts[-1]["detail"])
        assert detail["joiner"] == 3 and detail["ownership_epoch"] == 1 and detail["planned_ranges"]
    assert all(len(res[r]) == passes for r in range(3))
    rec_f = {}
    sups_f, _ = run_day("torch", 4, str(tmp_path / "fresh"), seed, rec_f, passes=passes)
    assert_same_day(sups, [0, 1, 2, 3], rec, sups_f, [0, 1, 2, 3], rec_f, passes)


def test_join_announce_fault_is_retried_and_join_lands(tmp_path):
    seed, passes = 41, 3
    sups, res, _, failures = _join_day("torch", str(tmp_path / "afault"), seed, passes,
                                       fault="membership.join_announce")
    assert failures == 1
    for r in range(4):
        assert sups[r].ds.ownership.epoch == 1 and list(sups[r].ds.ownership.live_ranks) == [0, 1, 2, 3]
    aborts = [i for i in sups[3].incidents if i.kind == "join_abort"]
    assert any("membership.join_announce" in a.detail for a in aborts)
    assert all(len(res[r]) == passes for r in range(3))


def test_autoscale_target_refuses_admission_at_target(tmp_path):
    """At ``target_ranks`` a knocking joiner is never admitted: the day
    ends at the original epoch and live set, and the joiner times out."""
    seed, passes = 43, 2
    root = str(tmp_path / "tgt")
    _, tps = cluster("torch", 3)
    rec = {}
    sups = [mk_sup("torch", r, tps, root, seed, rec, initial_live=[0, 1], target_ranks=2) for r in range(2)]
    sups.append(mk_sup("torch", 2, tps, root, seed, rec))
    files = [[f"pass-{p}"] for p in range(passes)]

    def worker(r):
        if r == 2:
            with pytest.raises(tsup.PassFailure, match="not admitted"):
                sups[2].join_day(files, timeout=2.0)
            return "refused"
        return sups[r].run_day(DATE, files)

    try:
        res = run_ranks(worker, 3, limit=60.0)
    finally:
        for t in tps:
            t.close()
    assert res[2] == "refused"
    for r in (0, 1):
        assert len(res[r]) == passes
        assert sups[r].ds.ownership.epoch == 0 and list(sups[r].ds.ownership.live_ranks) == [0, 1]
        assert "rank_join" not in [i.kind for i in sups[r].incidents]


def test_join_day_needs_elastic_and_a_coordinator(tmp_path):
    from test_torch_chaos_dist import FakeDS

    sup = tsup.PassSupervisor(FakeDS(), SimpleNamespace())
    with pytest.raises(ValueError, match="join_day requires elastic mode"):
        sup.join_day([["pass-0"]])
