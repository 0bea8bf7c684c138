"""The port's Follower against the JAX package's, on one checkpoint root.

The port trains on the CPU and publishes through its CheckpointManager; a
port Follower and a JAX Follower tail the same root. At every poll their
versions hold the same keys and bitwise-equal rows at the same chain
position, and the same dense state after the leaf map; the port's preds
from the followed version are bitwise equal to scoring directly against
the trainer's table and params (the follower's gate). The cases are those
of the JAX package's serving tests that need no fleet: tailing, a kill mid
apply, a corrupt delta, a rewind, a mixed-epoch chain, the re-anchor on an
epoch flip and the compact fast-forward.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.serve import Follower as JFollower
from paddlebox_tpu.serve.follower import apply_published_chain as japply_published_chain
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train import validate_watermark as jvalidate_watermark
from paddlebox_tpu.utils import faultinject as jfault
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.models import DeepFM, dense_to_jax_leaves
from paddlebox_tpu_torch.serve import (
    Follower,
    ScoreServer,
    Scorer,
    apply_published_chain,
    table_source,
    version_source,
)
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import (
    Adam,
    CheckpointManager,
    CTRTrainer,
    DeltaLineageError,
    MembershipEpochError,
    TrainStepConfig,
    read_watermark,
    validate_watermark,
)
from paddlebox_tpu_torch.utils import faultinject as fault
from paddlebox_tpu_torch.utils.monitor import STAT_GET

torch.set_num_threads(2)

S, B, D = 4, 16, 4
HIDDEN = (16, 8)
DATE = "20261016"
OPT_KW = dict(embedx_threshold=0.0, show_clk_decay=0.97, shrink_threshold=0.0)
LAYOUT = ValueLayout(embedx_dim=D)
SCHEMA = SlotSchema(
    [SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
    label_slot="label",
)


def _port_model(seed):
    return DeepFM(S, LAYOUT.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(seed))


class Stack:
    """The port's producer (trainer, table, CheckpointManager) and a port
    and a JAX Follower over one root. One training pass per save."""

    def __init__(self, tmp_path):
        self.tmp = str(tmp_path)
        self.root = os.path.join(self.tmp, "ckpt")
        self.rng = np.random.default_rng(0)
        opt = SparseOptimizerConfig(**OPT_KW)
        self.table = HostSparseTable(LAYOUT, opt, n_shards=4, seed=0)
        self.ds = BoxPSDataset(SCHEMA, self.table, batch_size=B, read_threads=2)
        self.cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=LAYOUT, sparse_opt=opt, auc_buckets=100)
        self.trainer = CTRTrainer(_port_model(0), self.cfg, dense_opt=Adam(1e-2), device="cpu")
        self.trainer.init_params()
        self.mgr = CheckpointManager(self.root)
        self.n_files = 0
        self.probe = None
        self.follower = self.new_follower()
        self.jfollower = self.new_jfollower()
        self.scorer = Scorer(_port_model(3), self.cfg, device="cpu")

    def new_follower(self):
        tr = CTRTrainer(_port_model(1), self.cfg, dense_opt=Adam(1e-2), device="cpu")
        return Follower(self.root, LAYOUT, SparseOptimizerConfig(**OPT_KW), n_host_shards=4, trainer=tr)

    def new_jfollower(self):
        lay = JValueLayout(embedx_dim=D)
        cfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
        tr = JCTRTrainer(JDeepFM(S, lay.pull_width, D, hidden=HIDDEN), cfg, dense_opt=optax.adam(1e-2))
        tr.init_params(jax.random.PRNGKey(0))
        return JFollower(self.root, lay, JSparseOptimizerConfig(**OPT_KW), n_host_shards=4, trainer=tr)

    def _write_file(self, lo, n=96):
        path = os.path.join(self.tmp, f"p{self.n_files}.txt")
        self.n_files += 1
        lines = []
        for _ in range(n):
            keys = self.rng.integers(lo, lo + 150, S)
            lines.append(f"1 {float(keys[0] % 2)} " + " ".join(f"1 {k}" for k in keys))
        # fixture writer: the path lies under the test's tmp dir
        # pbox-lint: disable=IO004
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        if self.probe is None:
            self.probe = [parse_line(ln, SCHEMA) for ln in lines[:24]]
        return path

    def run_pass(self, lo=1):
        self.ds.set_filelist([self._write_file(lo)])
        self.ds.load_into_memory()
        self.ds.begin_pass(round_to=8)
        self.trainer.train_pass(self.ds)
        self.ds.end_pass(self.trainer.trained_table())

    def publish_base(self):
        self.run_pass(lo=1)
        self.mgr.save_base(DATE, self.table, self.trainer)

    def publish_delta(self, lo):
        self.run_pass(lo=lo)
        self.mgr.save_delta(DATE, self.table, self.trainer)

    def poll_both(self):
        got = (self.follower.poll_once(), self.jfollower.poll_once())
        assert got[0] == got[1]
        return got[0]

    def trainer_scores(self):
        return self.scorer.score_records(
            self.probe, SCHEMA, table_source(LAYOUT, self.table), self.trainer.params, self.trainer.opt_state
        )

    def follower_scores(self, version=None):
        v = self.follower.version() if version is None else version
        return self.scorer.score_records(self.probe, SCHEMA, version_source(LAYOUT, v), v.params, v.opt_state)

    def assert_versions_alike(self):
        """The port's and the JAX package's served versions are one state."""
        v, jv = self.follower.version(), self.jfollower.version()
        assert (v.date, v.delta_idx, v.decay_epoch) == (jv.date, jv.delta_idx, jv.decay_epoch)
        np.testing.assert_array_equal(v.keys, jv.keys)
        np.testing.assert_array_equal(v.rows, jv.rows)
        got = dense_to_jax_leaves(v.params, v.opt_state)
        want = jax.tree.leaves((jv.params, jv.opt_state))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        return v


@pytest.fixture
def stack(tmp_path):
    return Stack(tmp_path)


def test_tailing_with_bitwise_parity(stack):
    st = stack
    assert st.poll_both() is False  # nothing published yet
    st.publish_base()
    assert st.poll_both() is True
    v = st.assert_versions_alike()
    assert (v.date, v.delta_idx) == (DATE, 0)
    assert v.n_rows == len(st.table.keys())
    np.testing.assert_array_equal(st.trainer_scores(), st.follower_scores())
    for i, lo in ((1, 120), (2, 260)):
        st.publish_delta(lo=lo)
        ref = st.trainer_scores()
        assert st.poll_both() is True
        assert st.assert_versions_alike().delta_idx == i
        np.testing.assert_array_equal(ref, st.follower_scores())
    assert st.follower.scoring.committed_indices() == [0, 1, 2]
    assert st.poll_both() is False  # idempotent poll
    rows, n_miss = st.follower.version().lookup_rows(np.array([2**63 + 17], dtype=np.uint64))
    assert n_miss == 1 and not rows.any()
    h = st.follower.health_snapshot()
    assert h["delta_idx"] == 2 and h["warm"] and not h["reanchoring"] and h["tier_rows"] == 0


def test_kill_mid_apply_keeps_old_version(stack):
    st = stack
    st.publish_base()
    st.publish_delta(lo=120)
    assert st.poll_both() is True
    v0 = st.follower.version()
    before = st.follower_scores(v0)
    st.publish_delta(lo=260)
    for fol, mod in ((st.follower, fault), (st.jfollower, jfault)):
        with mod.inject(mod.fail_once("serve.apply_delta")):
            with pytest.raises(mod.InjectedFault):
                fol.poll_once()
    assert st.follower.version() is v0 and st.jfollower.version().delta_idx == 1
    np.testing.assert_array_equal(before, st.follower_scores(st.follower.version()))
    assert st.poll_both() is True  # the healed retry catches up
    assert st.assert_versions_alike().delta_idx == 2
    np.testing.assert_array_equal(st.trainer_scores(), st.follower_scores())
    assert st.follower.scoring.committed_indices() == [0, 1, 2]


def test_corrupt_delta_skipped_and_counted(stack):
    st = stack
    st.publish_base()
    assert st.poll_both() is True
    good = st.follower_scores()
    st.publish_delta(lo=120)
    delta_dir = os.path.join(st.root, DATE, "delta-0001")
    victim = next(os.path.join(delta_dir, n) for n in sorted(os.listdir(delta_dir)) if n.endswith(".npz"))
    original = open(victim, "rb").read()
    # deliberate corruption of a published delta (raw bytes are the point)
    # pbox-lint: disable=IO004
    with open(victim, "wb") as f:  # flip a byte, keep the size
        f.write(original[:10] + bytes([original[10] ^ 0xFF]) + original[11:])
    skipped = STAT_GET("serve.corrupt_skipped")
    assert st.poll_both() is False
    assert STAT_GET("serve.corrupt_skipped") == skipped + 1
    assert st.assert_versions_alike().delta_idx == 0
    np.testing.assert_array_equal(good, st.follower_scores())
    # deliberate in-place repair of the corrupted delta (raw on purpose)
    # pbox-lint: disable=IO004
    with open(victim, "wb") as f:  # the publisher re-copies the delta
        f.write(original)
    assert st.poll_both() is True
    assert st.assert_versions_alike().delta_idx == 1
    np.testing.assert_array_equal(st.trainer_scores(), st.follower_scores())


def test_rewind_raises(stack):
    st = stack
    st.publish_base()
    st.publish_delta(lo=120)
    assert st.poll_both() is True
    wm = read_watermark(st.root)
    wm["delta_idx"], wm["deltas"] = 0, []
    # a hand-rolled rewound watermark: bypassing atomic_write is the point
    # pbox-lint: disable=IO004
    with open(os.path.join(st.root, "latest.json"), "w") as f:
        json.dump(wm, f)
    for fol in (st.follower, st.jfollower):
        with pytest.raises(Exception, match="rewound") as ei:
            fol.poll_once()
        assert type(ei.value).__name__ == "DeltaLineageError"
    assert st.assert_versions_alike().delta_idx == 1


@pytest.mark.parametrize("case", ["mixed_epoch", "gap", "foreign_base", "malformed", "uniform_epoch"])
def test_watermark_validation_matches_jax(case):
    wm = {
        "date": DATE, "delta_idx": 1,
        "base": {"path": f"{DATE}/base", "ownership_epoch": 0},
        "deltas": [{"path": f"{DATE}/delta-0001", "ownership_epoch": 1}],
    }
    if case == "gap":
        wm = {"date": DATE, "delta_idx": 2, "base": {"path": f"{DATE}/base"},
              "deltas": [{"path": f"{DATE}/delta-0002"}]}
    elif case == "foreign_base":
        wm = {"date": DATE, "delta_idx": 0, "base": {"path": "20200101/base"}, "deltas": []}
    elif case == "malformed":
        wm = {"date": DATE}
    elif case == "uniform_epoch":
        wm["deltas"][0]["ownership_epoch"] = 0
    out = []
    for fn in (validate_watermark, jvalidate_watermark):
        try:
            fn(wm)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — the types are compared by name
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
    assert (out[0] is None) == (case == "uniform_epoch")
    if case == "mixed_epoch":
        assert out[0][0] == "MembershipEpochError"
        assert issubclass(MembershipEpochError, DeltaLineageError)


def test_reanchor_across_epoch_flip(stack):
    st = stack
    st.publish_base()
    st.publish_delta(lo=120)
    assert st.poll_both() is True
    reanchors = STAT_GET("serve.epoch_reanchors")
    st.mgr.ownership_epoch = 1
    st.publish_base()  # the re-anchored chain under the same date
    assert read_watermark(st.root)["ownership_epoch"] == 1
    assert st.poll_both() is True
    assert STAT_GET("serve.epoch_reanchors") == reanchors + 1
    assert st.follower.epoch_reanchors == 1 and not st.follower.reanchoring
    assert st.assert_versions_alike().delta_idx == 0
    np.testing.assert_array_equal(st.trainer_scores(), st.follower_scores())
    st.publish_delta(lo=260)
    ref = st.trainer_scores()
    assert st.poll_both() is True
    assert st.assert_versions_alike().delta_idx == 1
    np.testing.assert_array_equal(ref, st.follower_scores())
    assert st.follower.health_snapshot()["ownership_epoch"] == 1


def test_compact_fast_forward(stack):
    st = stack
    st.publish_base()
    st.publish_delta(lo=120)
    st.publish_delta(lo=260)
    scratch = HostSparseTable(LAYOUT, SparseOptimizerConfig(**OPT_KW), n_shards=4, seed=0)
    assert st.mgr.compact(DATE, scratch).endswith("compact-0002")
    # a follower that starts now applies the fold, not base + 2 deltas
    st.follower, st.jfollower = st.new_follower(), st.new_jfollower()
    fastforwards = STAT_GET("serve.compact_fastforwards")
    assert st.poll_both() is True
    assert STAT_GET("serve.compact_fastforwards") == fastforwards + 1
    assert st.follower.scoring.committed_indices() == [2]
    assert st.assert_versions_alike().delta_idx == 2
    np.testing.assert_array_equal(st.trainer_scores(), st.follower_scores())
    st.publish_delta(lo=380)  # the tail after the fold
    ref = st.trainer_scores()
    assert st.poll_both() is True
    assert st.assert_versions_alike().delta_idx == 3
    np.testing.assert_array_equal(ref, st.follower_scores())


def test_score_server_over_the_follower(stack):
    """The batched front-end over the real Follower: preds equal direct
    scoring at every published version; staleness and served indices are
    monotone."""
    st = stack
    st.publish_base()
    st.follower.poll_once()
    srv = ScoreServer(st.follower, st.scorer, SCHEMA, device="cpu")
    srv.start()
    try:
        for lo in (120, 260):
            np.testing.assert_array_equal(srv.score(st.probe[:8], timeout=60), st.trainer_scores()[:8])
            st.publish_delta(lo=lo)
            st.follower.poll_once()
        np.testing.assert_array_equal(srv.score(st.probe, timeout=60), st.trainer_scores())
    finally:
        srv.stop()
    assert [i for i, _ in srv.staleness] == [0, 1, 2]
    assert all(lag >= 0 for _, lag in srv.staleness)
    assert srv.served_indices == sorted(srv.served_indices)


def test_follower_needs_the_publishers_shard_count(stack):
    st = stack
    st.publish_base()
    fol = Follower(st.root, LAYOUT, SparseOptimizerConfig(**OPT_KW), n_host_shards=8)
    with pytest.raises(ValueError, match="shard count mismatch"):
        fol.poll_once()


def test_device_scoring_tier_raises_where_the_scoring_table_does(stack, monkeypatch):
    """With the tier on and no device given, a host without a GPU raises
    in ``ScoringTable.commit``, before anything is served."""
    st = stack
    st.publish_base()
    before = config.get_flag("device_scoring_tier")
    config.set_flag("device_scoring_tier", "on")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="device scoring tier needs a GPU"):
            st.follower.poll_once()
    finally:
        config.set_flag("device_scoring_tier", before)
    assert st.follower.version().delta_idx == -1  # nothing was served
    assert st.follower.poll_once() is True


def test_apply_published_chain_matches_jax(stack):
    """The catch-up path shared with an elastic joiner: the whole verified
    chain into a table, the same in both packages; a corrupt link raises."""
    st = stack
    assert apply_published_chain(st.root, HostSparseTable(LAYOUT, SparseOptimizerConfig(**OPT_KW), n_shards=4)) is None
    st.publish_base()
    st.publish_delta(lo=120)
    t = HostSparseTable(LAYOUT, SparseOptimizerConfig(**OPT_KW), n_shards=4)
    j = JHostSparseTable(JValueLayout(embedx_dim=D), JSparseOptimizerConfig(**OPT_KW), n_shards=4)
    pos = apply_published_chain(st.root, t)
    assert pos == japply_published_chain(st.root, j)
    assert (pos["date"], pos["delta_idx"]) == (DATE, 1)
    keys = np.sort(t.keys())
    np.testing.assert_array_equal(keys, np.sort(j.keys()))
    np.testing.assert_array_equal(t.pull_or_create(keys), j.pull_or_create(keys))
    np.testing.assert_array_equal(t.pull_or_create(keys), st.table.pull_or_create(keys))
    shard = os.path.join(st.root, DATE, "delta-0001", "shard-00000.npz")
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    # deliberate corruption of a published delta (raw bytes are the point)
    # pbox-lint: disable=IO004
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(DeltaLineageError, match="CRC"):
        apply_published_chain(st.root, HostSparseTable(LAYOUT, SparseOptimizerConfig(**OPT_KW), n_shards=4))
