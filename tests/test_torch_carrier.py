"""The port's device-carried pass boundary against the JAX package's.

Both packages run the same files through their native host store and
parser. Where the two are held to each other bitwise, a "trained" table
comes from :func:`fake_train`, one numpy function of the pass table, the
same in both: training itself differs in the last bits between the two
packages (``test_torch_train_step.py``), the boundary must not. Compared
bitwise, under each ``wire_dtype``: the pass-2 table, the host table
after ``drain_pending``, saved files and the dropped counts. Within the
port, real training across a carried boundary equals the classic one
bitwise at fp32 and ``shrink_threshold=0`` (carried keys are exempt from
the boundary's shrink, so only then do the paths agree), losses included.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

S, B, D = 4, 8, 4
MODES = ("fp32", "bf16", "int8")
# every flag the boundary reads, restored in both registries after each test
FLAGS = (
    "enable_carried_table", "carried_eager_flush", "boundary_pipeline",
    "overlap_writeback", "boundary_prefetch_pull", "boundary_merge_threads", "wire_dtype",
    "writeback_chunk_keys",
)


@pytest.fixture(autouse=True)
def restore_flags():
    before = {f: (config.get_flag(f), jconfig.get_flag(f)) for f in FLAGS}
    yield
    for f, (mine, theirs) in before.items():
        config.set_flag(f, mine)
        jconfig.set_flag(f, theirs)


def set_both(**flags) -> None:
    for k, v in flags.items():
        config.set_flag(k, v)
        jconfig.set_flag(k, v)


def write_pass(path, seed, lo, hi, n=48) -> str:
    """Records whose keys come from [lo, hi): consecutive passes overlap."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # fixture writer: path derives from tmp_path (helper param hides it)
    # pbox-lint: disable=IO004
    with open(path, "w") as f:
        for _ in range(n):
            parts = [f"1 {float(rng.integers(0, 2))}"]
            for _s in range(S):
                k = int(rng.integers(1, 3))
                parts.append(f"{k} " + " ".join(str(v) for v in rng.integers(lo, hi, k)))
            f.write(" ".join(parts) + "\n")
    return str(path)


class Side:
    """One package's dataset over its native host store, driven by numpy
    tables: ``device`` wraps a numpy table as that package's device array."""

    def __init__(self, pkg: str, shrink: float = 0.0, decay: float = 0.95, batch=B):
        self.pkg = pkg
        opt = dict(embedx_threshold=0.0, show_clk_decay=decay, shrink_threshold=shrink)
        if pkg == "jax":
            self.layout = JValueLayout(embedx_dim=D)
            self.table = JHostSparseTable(self.layout, JSparseOptimizerConfig(**opt), n_shards=2, seed=0)
            schema = JSlotSchema(
                [JSlotInfo("label", type="float", dense=True, dim=1)]
                + [JSlotInfo(f"s{i}") for i in range(S)],
                label_slot="label",
            )
            self.ds = JBoxPSDataset(schema, self.table, batch_size=batch, shuffle_mode="none")
        else:
            self.layout = ValueLayout(embedx_dim=D)
            self.opt = SparseOptimizerConfig(**opt)
            self.table = HostSparseTable(self.layout, self.opt, n_shards=2, seed=0)
            schema = SlotSchema(
                [SlotInfo("label", type="float", dense=True, dim=1)]
                + [SlotInfo(f"s{i}") for i in range(S)],
                label_slot="label",
            )
            self.ds = BoxPSDataset(schema, self.table, batch_size=batch, shuffle_mode="none", read_threads=2)
        assert self.table.native

    def device(self, arr: np.ndarray):
        return jnp.asarray(arr) if self.pkg == "jax" else torch.from_numpy(arr.copy())

    def load(self, f: str, round_to: int = 8) -> np.ndarray:
        self.ds.set_filelist([f])
        self.ds.load_into_memory()
        return self.begin(round_to)

    def begin(self, round_to: int = 8, **kw) -> np.ndarray:
        """begin_pass; returns the pass table as a host array."""
        return np.array(self.ds.begin_pass(round_to=round_to, **kw), dtype=np.float32)

    def contents(self):
        keys = np.sort(self.table.keys())
        return keys, self.table.pull_or_create(keys)


def fake_train(side: Side, table: np.ndarray) -> np.ndarray:
    """A deterministic "pass" over the live working set's rows: counters
    grow by key-dependent amounts (a third of the keys gain no show, so a
    shrink threshold drops them), the embed values and g2 sums move.
    Plain fp32 numpy, so both packages see the same bits."""
    ws, lay = side.ds.ws, side.layout
    flat = table.reshape(-1, lay.width).copy()
    r = ws.row_of_sorted
    k = ws.sorted_keys.astype(np.int64)
    flat[r, lay.SHOW] += (k % 3).astype(np.float32)
    flat[r, lay.CLK] += (k % 2).astype(np.float32)
    a, b = lay.embed_w_col, lay.embed_g2_col
    flat[r, a:b] = flat[r, a:b] * np.float32(0.9) + ((k % 7) * 1e-3).astype(np.float32)[:, None]
    flat[r, b:] += np.float32(0.25)
    return flat.reshape(table.shape)


def two_passes(side: Side, files, carried: bool):
    """Pass 1 and pass 2 on fake training; returns (pass-2 table, result
    dicts of both end_passes, host contents after drain)."""
    t1 = fake_train(side, side.load(files[0]))
    e1 = side.ds.end_pass(side.device(t1) if carried else t1)
    t2_in = side.load(files[1])
    t2 = fake_train(side, t2_in)
    e2 = side.ds.end_pass(side.device(t2) if carried else t2)
    side.table.drain_pending()
    return t2_in, (e1["dropped"], e2["dropped"]), side.contents()


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                  b.view(np.uint32) if b.dtype == np.float32 else b)


def overlapping_files(tmp_path, tag=""):
    return [
        write_pass(str(tmp_path / f"{tag}p0.txt"), 0, 1, 200),
        write_pass(str(tmp_path / f"{tag}p1.txt"), 1, 100, 300),
    ]


@pytest.mark.parametrize("shrink", [0.0, 1.0], ids=["no_shrink", "shrink"])
@pytest.mark.parametrize("carried", [True, False], ids=["carried", "classic"])
@pytest.mark.parametrize("mode", MODES)
def test_boundary_matches_jax_bitwise(tmp_path, mode, carried, shrink):
    """Carried (a device table into end_pass) and classic (a device table
    with the carry off, so it crosses the wire whole) boundaries: the
    pass-2 table, both dropped counts and the drained host table equal the
    JAX package's bitwise."""
    set_both(wire_dtype=mode, enable_carried_table=int(carried), boundary_pipeline=0)
    files = overlapping_files(tmp_path)
    got = two_passes(Side("torch", shrink), files, carried=True)
    want = two_passes(Side("jax", shrink), files, carried=True)
    assert_same(got[0], want[0])
    assert got[1] == want[1]
    assert_same(got[2][0], want[2][0])
    assert_same(got[2][1], want[2][1])
    if shrink:
        assert sum(got[1]) > 0  # the threshold dropped keys


def _real_run(files, carried, tmp_path=None):
    """Two passes of real training on the port (CPU); returns losses, the
    pass-2 table and the drained host contents."""
    set_both(enable_carried_table=int(carried), boundary_pipeline=0, wire_dtype="fp32")
    side = Side("torch")
    lay = side.layout
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=side.opt, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, hidden=(8,), generator=torch.Generator().manual_seed(0))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")
    losses, tables = [], []
    for f in files:
        tables.append(side.load(f))
        losses.append(tr.train_pass(side.ds)["loss"])
        side.ds.end_pass(tr.trained_table_device() if carried else tr.trained_table())
    side.table.drain_pending()
    return losses, tables, side.contents(), tr


def test_carried_training_matches_classic_bitwise(tmp_path):
    files = overlapping_files(tmp_path)
    l_c, t_c, (k_c, v_c), _ = _real_run(files, carried=False)
    l_d, t_d, (k_d, v_d), _ = _real_run(files, carried=True)
    assert l_d == l_c
    for a, b in zip(t_d, t_c):
        assert_same(a, b)
    assert_same(k_d, k_c)
    assert_same(v_d, v_c)


def test_the_carrier_keeps_its_rows_while_the_next_pass_trains(tmp_path):
    """The carried tensor is the trainer's own table, written in place by
    the step: the next pass must train a copy, so the carrier's pass-1
    rows stay as they were through pass 2's training."""
    files = overlapping_files(tmp_path)
    set_both(enable_carried_table=1, boundary_pipeline=0, wire_dtype="fp32")
    side = Side("torch")
    lay = side.layout
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=side.opt, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, hidden=(8,), generator=torch.Generator().manual_seed(0))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")
    side.load(files[0])
    tr.train_pass(side.ds)
    live = tr.trained_table_device()
    before = live.clone()
    side.ds.end_pass(live)
    carrier = side.ds._carrier
    assert carrier.dev_flat is live
    side.load(files[1])
    tr.train_pass(side.ds)
    assert tr.trained_table_device().data_ptr() != live.data_ptr()
    assert torch.equal(carrier.dev_flat, before)  # pass 2 trained its own copy
    tr.drop_device_state()  # and dropping the trainer's state frees nothing it holds
    assert carrier.dev_flat is live and torch.equal(live, before)
    side.ds.end_pass(None)
    side.table.drain_pending()


def test_save_drains_carried_values(tmp_path):
    """A save while rows are carried holds them, decayed, in both packages:
    the two base saves are equal array for array."""
    set_both(enable_carried_table=1, boundary_pipeline=0)
    f = write_pass(str(tmp_path / "p0.txt"), 0, 1, 200)
    saved = {}
    for pkg in ("torch", "jax"):
        side = Side(pkg)
        t1 = fake_train(side, side.load(f))
        ws = side.ds.ws
        side.ds.end_pass(side.device(t1))
        assert len(side.table._pending_carriers) == 1
        side.table.save_base(str(tmp_path / pkg))
        assert not side.table._pending_carriers or side.table._pending_carriers[0].flushed
        want = t1.reshape(-1, side.layout.width)[ws.row_of_sorted]
        want[:, side.layout.SHOW] *= np.float32(0.95)
        want[:, side.layout.CLK] *= np.float32(0.95)
        assert_same(side.table.pull_or_create(ws.sorted_keys), want)
        saved[pkg] = [np.load(str(tmp_path / pkg / f"shard-{s:05d}.npz")) for s in range(2)]
    for a, b in zip(saved["torch"], saved["jax"]):
        order_a, order_b = np.argsort(a["keys"]), np.argsort(b["keys"])
        assert_same(a["keys"][order_a], b["keys"][order_b])
        assert_same(a["values"][order_a], b["values"][order_b])


def test_decay_accumulates_across_kept_boundaries(tmp_path):
    """A carrier pending across two decaying boundaries (the second pass
    is disjoint and writes nothing back) owes both decays: the first on
    its departing rows, the second the host applies to them."""
    set_both(enable_carried_table=1, boundary_pipeline=0)
    files = [write_pass(str(tmp_path / "p0.txt"), 0, 1, 200), write_pass(str(tmp_path / "p1.txt"), 1, 1000, 1200)]
    out = {}
    for pkg in ("torch", "jax"):
        side = Side(pkg)
        t1 = fake_train(side, side.load(files[0]))
        ws1 = side.ds.ws
        side.ds.end_pass(side.device(t1))
        side.load(files[1])
        side.ds.end_pass(None)
        # the disjoint splice pushed every pass-1 row as a departure
        assert side.table.drain_pending() == 0
        want = t1.reshape(-1, side.layout.width)[ws1.row_of_sorted]
        want[:, side.layout.SHOW] *= np.float32(0.95 * 0.95)
        want[:, side.layout.CLK] *= np.float32(0.95 * 0.95)
        out[pkg] = side.table.pull_or_create(ws1.sorted_keys)
        assert_same(out[pkg], want)
    assert_same(out["torch"], out["jax"])


def test_classic_writeback_supersedes_a_stale_carrier(tmp_path):
    """Pass 1 carried, pass 2 classic (a host array): the stale carrier
    goes inert, so a later drain cannot write pass-1 rows over pass 2's."""
    set_both(enable_carried_table=1, boundary_pipeline=0)
    files = overlapping_files(tmp_path)
    out = {}
    for pkg in ("torch", "jax"):
        side = Side(pkg)
        side.ds.end_pass(side.device(fake_train(side, side.load(files[0]))))
        carrier = side.ds._carrier
        t2 = fake_train(side, side.load(files[1]))
        keys2, rows2 = side.ds.ws.sorted_keys.copy(), t2.reshape(-1, side.layout.width)[side.ds.ws.row_of_sorted]
        side.ds.end_pass(t2)
        assert carrier.flushed and carrier.dev_flat is None
        assert side.table.drain_pending() == 0
        rows2[:, side.layout.SHOW] *= np.float32(0.95)
        rows2[:, side.layout.CLK] *= np.float32(0.95)
        assert_same(side.table.pull_or_create(keys2), rows2)
        out[pkg] = side.contents()
    assert_same(out["torch"][1], out["jax"][1])


def test_eager_flush_frees_the_carrier(tmp_path):
    """carried_eager_flush: the splice is followed by a full flush on a
    thread, joined at the next boundary."""
    set_both(enable_carried_table=1, boundary_pipeline=0, carried_eager_flush=1)
    files = overlapping_files(tmp_path)
    out = {}
    for pkg in ("torch", "jax"):
        side = Side(pkg)
        t1 = fake_train(side, side.load(files[0]))
        ws1 = side.ds.ws
        side.ds.end_pass(side.device(t1))
        carrier = side.ds._carrier
        side.load(files[1])  # splice + background flush
        side.ds._eager_thread.join()
        assert carrier.flushed and carrier.dev_flat is None
        want = t1.reshape(-1, side.layout.width)[ws1.row_of_sorted]
        want[:, side.layout.SHOW] *= np.float32(0.95)
        want[:, side.layout.CLK] *= np.float32(0.95)
        out[pkg] = side.table.pull_or_create(ws1.sorted_keys)
        assert_same(out[pkg], want)
        side.ds.end_pass(None)
    assert_same(out["torch"], out["jax"])


def test_failed_departure_push_is_retried_by_flush(tmp_path):
    """A failed departure push leaves its rows owed: the drain raises, keeps
    the carrier, and its retry pushes them. The same failing push in both
    packages ends in the same host table as a run without the failure."""
    set_both(enable_carried_table=1, boundary_pipeline=0)
    files = [write_pass(str(tmp_path / "p0.txt"), 0, 1, 200), write_pass(str(tmp_path / "p1.txt"), 1, 500, 700)]
    out = {}
    for pkg in ("torch", "jax", "clean"):
        side = Side("torch" if pkg == "clean" else pkg)
        side.ds.end_pass(side.device(fake_train(side, side.load(files[0]))))
        if pkg != "clean":
            orig = side.table.push
            fail = {"on": True}

            def flaky(keys, vals, orig=orig, fail=fail):
                if fail["on"]:
                    fail["on"] = False
                    raise OSError("injected departure push failure")
                return orig(keys, vals)

            side.table.push = flaky
        t2 = fake_train(side, side.load(files[1]))  # the splice starts the push
        if pkg != "clean":
            with pytest.raises(OSError, match="injected"):
                side.table.drain_pending()
            assert side.table._pending_carriers, "the failed drain dropped the carrier"
            assert side.table.drain_pending() > 0  # departed rows pushed again
            side.table.push = orig
        side.ds.end_pass(side.device(t2))
        side.table.drain_pending()
        out[pkg] = side.contents()
    for pkg in ("jax", "clean"):
        assert_same(out["torch"][0], out[pkg][0])
        assert_same(out["torch"][1], out[pkg][1])


def test_revert_after_a_carried_boundary(tmp_path):
    """begin_pass(enable_revert=True) drains the carrier first, so the
    snapshot, and the revert, hold the true pre-pass rows."""
    set_both(enable_carried_table=1, boundary_pipeline=0)
    files = overlapping_files(tmp_path)
    out = {}
    for pkg in ("torch", "jax"):
        side = Side(pkg)
        side.ds.end_pass(side.device(fake_train(side, side.load(files[0]))))
        side.ds.set_filelist([files[1]])
        side.ds.load_into_memory()
        t2 = fake_train(side, side.begin(enable_revert=True))
        assert not side.table._pending_carriers or side.table._pending_carriers[0].flushed
        keys2 = side.ds.ws.sorted_keys.copy()
        pre = side.table.pull_or_create(keys2).copy()
        side.ds.kick_writeback(t2)
        side.ds.revert_pass()
        assert_same(side.table.pull_or_create(keys2), pre)
        out[pkg] = pre
        # the reverted pass trains again and ends classic
        t2b = fake_train(side, side.begin())
        side.ds.end_pass(side.device(t2b))
        side.table.drain_pending()
        out[pkg] = side.contents()
    assert_same(out["torch"][1], out["jax"][1])


def test_handoff_table_across_two_trainers_on_one_pass(tmp_path):
    """Trainer B starts where trainer A's pass left the table: on the
    device, with no copy until B's own state; A's table stays A's. B's
    device table then carries across the boundary like any other."""
    set_both(enable_carried_table=1, boundary_pipeline=0, wire_dtype="fp32")
    files = overlapping_files(tmp_path)
    side = Side("torch")
    lay = side.layout
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=side.opt, auc_buckets=100)

    def trainer(seed):
        model = DeepFM(S, lay.pull_width, D, hidden=(8,), generator=torch.Generator().manual_seed(seed))
        return CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")

    a, b = trainer(0), trainer(1)
    side.load(files[0])
    a.train_pass(side.ds)
    a.handoff_table(side.ds)
    a_rows = a.trained_table_device().clone()
    assert side.ds.device_table.shape == (1, side.ds.ws.capacity, lay.width)
    assert side.ds.device_table.data_ptr() == a.trained_table_device().data_ptr()
    b.train_pass(side.ds)
    assert torch.equal(a.trained_table_device(), a_rows)  # B trained its copy
    shows_a = a_rows[:, lay.SHOW]
    shows_b = b.trained_table_device()[:, lay.SHOW]
    assert torch.all(shows_b >= shows_a) and torch.any(shows_b > shows_a)
    b_rows = b.trained_table_device().clone()
    side.ds.end_pass(b.trained_table_device())
    side.load(files[1])  # the splice holds B's rows, decayed
    side.ds.end_pass(None)
    side.table.drain_pending()
    ws_keys = np.sort(side.table.keys())
    assert len(ws_keys) and side.table.decay_epochs == 2
    assert not torch.equal(b_rows, a_rows)
