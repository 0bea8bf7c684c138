"""The port's saves, loads, checkpoint chain, dense files and pass rollback
against the JAX package.

Both stores run: the native one (each package builds ``csrc/host_table.cc``
itself) and the pure-Python one (``PBOX_NATIVE_TABLE=0``, read by both
packages). The same table state gives the same save dirs: the same file
list, the same ``meta.json`` and bitwise-equal ``keys`` and ``values`` in
every shard. File bytes are never compared: an npz member carries a zip
timestamp, so the bytes (and the manifest CRCs over them) differ between
any two writes of the same arrays. Chains cross both ways: a chain one
package writes resumes in the other with the table bitwise equal and the
dense state equal after the leaf map (``models/convert.py``). The pass
rollback and the delta at ``end_pass`` run one sequence on a port and a
JAX ``BoxPSDataset`` over the same files and the same stand-in for a
trained pass table. The training tests run the port alone on the CPU,
where a run is bitwise repeatable.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from paddlebox_tpu.utils import faultinject as jfault
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DeepFM, dense_from_jax_leaves, dense_leaf_names, dense_to_jax_leaves
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CheckpointManager, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils import faultinject as fault

torch.set_num_threads(2)

D = 4
HIDDEN = (16, 8)
S, B = 3, 16
# decay 0.9: its powers are not exact in fp32, so a catch-up that is not
# the same multiply would show; shrink 0.5 drops the keys that reach 0
OPT_KW = dict(show_clk_decay=0.9, shrink_threshold=0.5, initial_range=0.02)
DATE, DATE2 = "20261016", "20261017"


@pytest.fixture(params=["native", "python"])
def store(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setenv("PBOX_NATIVE_TABLE", "0")
    return request.param


def make_pair(n_shards=4, seed=3):
    """(port table, JAX table): one config, one seed, one store kind."""
    t = HostSparseTable(ValueLayout(embedx_dim=D), SparseOptimizerConfig(**OPT_KW), n_shards=n_shards, seed=seed)
    j = JHostSparseTable(JValueLayout(embedx_dim=D), JSparseOptimizerConfig(**OPT_KW), n_shards=n_shards, seed=seed)
    assert t.native == j.native
    return t, j


def mutate(tables, seed, lo=1, hi=3000, n=400):
    """The same pulls and pushes on every table: noise on the rows, shows
    in [0, 20) (some fall under the shrink line after a decay)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(lo, hi, n).astype(np.uint64))
    noise = rng.standard_normal((len(keys), tables[0].layout.width)).astype(np.float32)
    shows = rng.integers(0, 20, len(keys)).astype(np.float32)
    for t in tables:
        rows = t.pull_or_create(keys)
        rows += noise
        rows[:, t.layout.SHOW] = shows
        rows[:, t.layout.CLK] = np.floor(shows / 3)
        t.push(keys, rows)


def decay(tables):
    return [t.decay_and_shrink() for t in tables]


def contents(table):
    k = np.sort(table.keys())
    return k, table.pull_or_create(k)


def assert_same_table(a, b):
    ka, va = contents(a)
    kb, vb = contents(b)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(va, vb)
    assert a.decay_epochs == b.decay_epochs


def assert_same_dir(a, b):
    """Same files, same meta, bitwise-equal arrays (never the bytes)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            assert_same_dir(pa, pb)
        elif n == "meta.json":
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb)
        elif n.endswith(".npz") and n.startswith("shard-"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files) == ["keys", "values"]
                np.testing.assert_array_equal(za["keys"], zb["keys"])
                np.testing.assert_array_equal(za["values"], zb["values"])
                assert za["values"].dtype == zb["values"].dtype == np.float32


# ---- saves and loads -------------------------------------------------------


@pytest.mark.parametrize("kind", ["base", "delta", "cache", "whitelist"])
def test_saves_match_jax(store, tmp_path, kind):
    t, j = make_pair()
    mutate((t, j), 1)
    dropped = decay((t, j))
    assert dropped[0] == dropped[1] > 0
    mutate((t, j), 2, lo=1000, hi=4000)
    if kind == "delta":
        t.save_base(str(tmp_path / "pb"))
        j.save_base(str(tmp_path / "jb"))
        decay((t, j))
        mutate((t, j), 3, lo=2000, hi=5000, n=150)
    out = {}
    for name, tab in (("port", t), ("jax", j)):
        path = str(tmp_path / f"{name}-{kind}")
        if kind == "base":
            out[name] = tab.save_base(path)
        elif kind == "delta":
            out[name] = tab.save_delta(path)
        elif kind == "cache":
            thr = tab.cache_threshold(0.3)
            out[name] = (thr, tab.save_cache(path, thr))
        else:
            out[name] = tab.save_with_whitelist(path, np.arange(0, 5000, 7, dtype=np.uint64))
    assert out["port"] == out["jax"]
    assert_same_dir(str(tmp_path / f"port-{kind}"), str(tmp_path / f"jax-{kind}"))
    # a delta lists exactly the keys pushed since the base, and clears them
    if kind == "delta":
        assert t.save_delta(str(tmp_path / "p-empty")) == j.save_delta(str(tmp_path / "j-empty")) == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chain_loads_across_packages_with_decay_catchup(store, tmp_path, writer):
    """A base plus deltas across decay epochs, written by one package, loads
    in the other bitwise equal to the writer's own load, including the
    rate**n catch-up of rows no later delta touched."""
    t, j = make_pair()
    w = j if writer == "jax" else t
    mutate((w,), 1)
    decay((w,))
    w.save_base(str(tmp_path / "base"))
    for i, (lo, hi) in enumerate(((500, 3500), (2000, 6000)), 1):
        decay((w,))
        decay((w,))
        mutate((w,), 10 + i, lo=lo, hi=hi, n=200)
        w.save_delta(str(tmp_path / f"delta-{i}"))
    t2, j2 = make_pair()
    for tab in (t2, j2):
        tab.load(str(tmp_path / "base"))
        for i in (1, 2):
            tab.apply_delta(str(tmp_path / f"delta-{i}"))
    assert t2.decay_epochs == j2.decay_epochs == 5
    assert_same_table(t2, j2)
    # the loaded keys count as saved: a delta right after the load is empty
    assert t2.save_delta(str(tmp_path / "after")) == 0


def test_load_rejects_a_shard_count_mismatch(tmp_path):
    t, j = make_pair(n_shards=4)
    mutate((j,), 1)
    j.save_base(str(tmp_path / "b"))
    t8, _ = make_pair(n_shards=8)
    with pytest.raises(ValueError, match="shard count mismatch"):
        t8.load(str(tmp_path / "b"))


# ---- dense files -----------------------------------------------------------


def _jax_trainer(lay, dense_dim=0):
    cfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
    tr = JCTRTrainer(JDeepFM(S, lay.pull_width, D, dense_dim=dense_dim, hidden=HIDDEN), cfg,
                     dense_opt=optax.adam(1e-3))
    tr.init_params(jax.random.PRNGKey(0))
    return tr


def _port_trainer(lay, dense_dim=0, seed=0):
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, dense_dim=dense_dim, hidden=HIDDEN,
                   generator=torch.Generator().manual_seed(seed))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device="cpu")
    tr.init_params()
    return tr


def random_dense(jtr, seed):
    """Random leaves in the JAX trainer's (params, opt_state) tree, count
    included (a non-trivial Adam state)."""
    leaves, treedef = jax.tree.flatten((jtr.params, jtr.opt_state))
    rng = np.random.default_rng(seed)
    out = []
    for x in leaves:
        x = np.asarray(x)
        if x.dtype == np.int32:
            out.append(np.asarray(rng.integers(1, 50), dtype=np.int32))
        else:
            out.append(rng.standard_normal(x.shape).astype(np.float32))
    return out, treedef


def set_dense(jtr, tr, leaves, treedef):
    """Mirror one dense state into both trainers."""
    jtr.params, jtr.opt_state = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    tr.params, tr.opt_state = dense_from_jax_leaves(leaves, tr.params, tr.device)


def jax_leaves(jtr):
    return [np.asarray(x) for x in jax.tree.leaves((jtr.params, jtr.opt_state))]


def assert_same_dense(tr, jtr):
    got = dense_to_jax_leaves(tr.params, tr.opt_state)
    want = jax_leaves(jtr)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dense_dim", [0, 3])
def test_dense_leaf_order_is_jax_tree_flatten(dense_dim):
    lay = JValueLayout(embedx_dim=D)
    jtr = _jax_trainer(lay, dense_dim)
    tr = _port_trainer(ValueLayout(embedx_dim=D), dense_dim)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path((jtr.params, jtr.opt_state))[0]]
    assert dense_leaf_names(tr.params) == paths
    # and the leaves land where JAX keeps them: a round trip through the map
    leaves, treedef = random_dense(jtr, 1)
    set_dense(jtr, tr, leaves, treedef)
    assert_same_dense(tr, jtr)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dense_file_crosses_packages(tmp_path, writer):
    jtr = _jax_trainer(JValueLayout(embedx_dim=D))
    tr = _port_trainer(ValueLayout(embedx_dim=D))
    leaves, treedef = random_dense(jtr, 2)
    path = str(tmp_path / "dense-0000.npz")
    if writer == "port":
        set_dense(jtr, tr, leaves, treedef)
        tr.save_dense(path)
        fresh = _jax_trainer(JValueLayout(embedx_dim=D))
        fresh.load_dense(path)
        assert_same_dense(tr, fresh)
    else:
        set_dense(jtr, tr, leaves, treedef)
        jtr.save_dense(path)
        fresh = _port_trainer(ValueLayout(embedx_dim=D), seed=9)
        fresh.load_dense(path)
        assert_same_dense(fresh, jtr)
        assert fresh.params["out.weight"].device == fresh.device


def test_load_dense_rejects_leaf_count_and_shape(tmp_path):
    lay = ValueLayout(embedx_dim=D)
    tr = _port_trainer(lay)
    path = str(tmp_path / "d.npz")
    tr.save_dense(path)
    other = CTRTrainer(DeepFM(S, lay.pull_width, D, hidden=(16,), generator=torch.Generator().manual_seed(0)),
                       tr.cfg, device="cpu")
    other.init_params()
    with pytest.raises(ValueError, match="leaves"):
        other.load_dense(path)
    wide = CTRTrainer(DeepFM(S, lay.pull_width, D, hidden=(16, 9), generator=torch.Generator().manual_seed(0)),
                      tr.cfg, device="cpu")
    wide.init_params()
    with pytest.raises(ValueError, match="shape mismatch"):
        wide.load_dense(path)


# ---- the checkpoint chain --------------------------------------------------


def _stamp_free(wm):
    """A watermark without its publish time and its CRC fields (which
    differ between any two writes; see the module docstring)."""
    wm = json.loads(json.dumps(wm))
    wm.pop("published_unix")
    for e in [wm["base"], *wm["deltas"], wm.get("compact") or {}]:
        e.pop("manifest_crc", None)
    if "dense" in wm:
        wm["dense"].pop("crc32")
    return wm


def test_chains_cross_packages(store, tmp_path):
    """Mirrored states publish a chain in each package (base, two deltas,
    compact); the watermarks agree, and each chain resumes in the other
    package to the writer's live table and dense state."""
    t, j = make_pair()
    jtr = _jax_trainer(JValueLayout(embedx_dim=D))
    tr = _port_trainer(ValueLayout(embedx_dim=D))
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    cm, jcm = CheckpointManager(roots["port"]), JCheckpointManager(roots["jax"])
    mutate((t, j), 1)
    set_dense(jtr, tr, *random_dense(jtr, 1))
    cm.save_base(DATE, t, tr)
    jcm.save_base(DATE, j, jtr)
    for i in (1, 2):
        decay((t, j))
        mutate((t, j), 20 + i, lo=500 * i, hi=3000 + 500 * i, n=200)
        set_dense(jtr, tr, *random_dense(jtr, 10 + i))
        assert cm.save_delta(DATE, t, tr).endswith(f"delta-{i:04d}")
        jcm.save_delta(DATE, j, jtr)
    for mgr, tab in ((cm, t), (jcm, j)):
        scratch = type(tab)(tab.layout, tab.opt, n_shards=tab.n_shards, seed=0)
        assert mgr.compact(DATE, scratch).endswith("compact-0002")
    assert cm.cursor() == jcm.cursor()
    assert _stamp_free(cm.read_watermark()) == _stamp_free(jcm.read_watermark())
    for name in ("base", "delta-0001", "delta-0002", "compact-0002"):
        assert_same_dir(os.path.join(roots["port"], DATE, name), os.path.join(roots["jax"], DATE, name))
    # every reader on every root: each package resumes the other's chain
    # as it resumes its own (a resumed table keeps the keys a later shrink
    # dropped from the live one: a delta records no deletions)
    resumed = {}
    for root in ("port", "jax"):
        rt, rj = make_pair()
        rtr = _port_trainer(ValueLayout(embedx_dim=D), seed=5)
        rjtr = _jax_trainer(JValueLayout(embedx_dim=D))
        st = CheckpointManager(roots[root]).resume(rt, rtr)
        jst = JCheckpointManager(roots[root]).resume(rj, rjtr)
        assert st == jst == {"date": DATE, "delta_idx": 2, "dense": "dense-0002.npz",
                             "ownership_epoch": 0, "compact": 2}
        assert_same_table(rt, rj)
        assert_same_dense(rtr, jtr)
        assert_same_dense(tr, rjtr)
        resumed[root] = rt
    assert_same_table(resumed["port"], resumed["jax"])


class DenseStub:
    """The dense half of a checkpoint for the crash windows: the manager
    needs only params, init_params, save_dense and load_dense."""

    def __init__(self):
        self.params = None

    def init_params(self, *_):
        self.params = np.zeros(3, dtype=np.float32)

    def bump(self, v):
        if self.params is None:
            self.init_params()
        self.params = self.params + np.float32(v)

    def save_dense(self, path):
        np.savez(path, params=self.params)

    def load_dense(self, path):
        with np.load(path) as z:
            self.params = z["params"]


def _seeded_day(t, j, roots):
    """base + one delta in each package, from mirrored states."""
    mgrs, stubs = [CheckpointManager(roots[0]), JCheckpointManager(roots[1])], [DenseStub(), DenseStub()]
    for d in stubs:
        d.bump(1.0)
    mutate((t, j), 1)
    for m, tab, d in zip(mgrs, (t, j), stubs):
        m.save_base(DATE, tab, d)
    mutate((t, j), 2, lo=100, hi=500)
    for m, tab, d in zip(mgrs, (t, j), stubs):
        d.bump(1.0)
        m.save_delta(DATE, tab, d)
    return mgrs, stubs


def _resume_both(roots):
    out = []
    for root, mgr_cls in zip(roots, (CheckpointManager, JCheckpointManager)):
        t2, j2 = make_pair()
        d = DenseStub()
        tab = t2 if mgr_cls is CheckpointManager else j2
        out.append((mgr_cls(root).resume(tab, d), tab, d))
    (st, ta, da), (jst, tb, db) = out
    assert st == jst
    assert_same_table(ta, tb)
    np.testing.assert_array_equal(da.params, db.params)
    return st


@pytest.mark.parametrize("save", ["base", "delta"])
@pytest.mark.parametrize("hit", [1, 2, 3, 4])
def test_crash_windows_resume_alike(tmp_path, save, hit):
    """The crash windows of the JAX package's checkpoint crash tests, under
    the same fault plan in each package: the resumed state dicts, tables
    and dense states agree after the crash and after the retry."""
    t, j = make_pair()
    roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
    mgrs, stubs = _seeded_day(t, j, roots)
    mutate((t, j), 3, lo=200, hi=700)
    for d in stubs:
        d.bump(2.0)
    date = DATE2 if save == "base" else DATE
    for m, tab, d, mod, exc in zip(mgrs, (t, j), stubs, (fault, jfault),
                                   (fault.InjectedFault, jfault.InjectedFault)):
        with mod.inject(mod.fail_nth("checkpoint.save", hit)):
            with pytest.raises(exc):
                getattr(m, f"save_{save}")(date, tab, d)
    assert mgrs[0].cursor() == mgrs[1].cursor() == {
        "date": DATE, "delta_idx": 1, "ownership_epoch": 0, "dense": "dense-0001.npz"}
    assert _resume_both(roots)["delta_idx"] == 1
    for m, tab, d in zip(mgrs, (t, j), stubs):
        getattr(m, f"save_{save}")(date, tab, d)
    st = _resume_both(roots)
    assert (st["date"], st["delta_idx"]) == ((DATE2, 0) if save == "base" else (DATE, 2))
    for m in mgrs:
        assert not os.path.isdir(os.path.join(m.root, date, "delta-0002.tmp"))


def test_dense_name_carries_forward_and_retires_alike(tmp_path):
    """Sparse-only deltas (trainer=None) keep naming the last dense file;
    older dense files retire; a second compact is a no-op; a delta across an
    ownership-epoch flip is refused. The same in both packages."""
    t, j = make_pair()
    roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
    mgrs, stubs = _seeded_day(t, j, roots)
    for i in range(3):
        mutate((t, j), 30 + i, lo=100 * i, hi=600 + 100 * i, n=100)
        for m, tab, d in zip(mgrs, (t, j), stubs):
            m.save_delta(DATE, tab, d if i == 1 else None)
    assert mgrs[0].cursor() == mgrs[1].cursor()
    assert mgrs[0].cursor()["dense"] == "dense-0003.npz"
    assert sorted(os.listdir(os.path.join(roots[0], DATE))) == sorted(os.listdir(os.path.join(roots[1], DATE)))
    for m, tab in zip(mgrs, (t, j)):
        scratch = type(tab)(tab.layout, tab.opt, n_shards=tab.n_shards, seed=0)
        assert m.compact(DATE, scratch) is not None
        assert m.compact(DATE, scratch) is None
        m.ownership_epoch = 1
    errs = []
    for m, tab in zip(mgrs, (t, j)):
        with pytest.raises(Exception, match="ownership epoch") as ei:
            m.save_delta(DATE, tab)
        errs.append(type(ei.value).__name__)
    assert errs == ["MembershipEpochError"] * 2
    assert _resume_both(roots)["delta_idx"] == 4


def test_resume_walks_back_over_a_torn_delta(tmp_path):
    t, j = make_pair()
    roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
    mgrs, stubs = _seeded_day(t, j, roots)
    mutate((t, j), 5, lo=300, hi=900)
    for m, tab, d in zip(mgrs, (t, j), stubs):
        m.save_delta(DATE, tab, d)
        shard = os.path.join(m.root, DATE, "delta-0002", "shard-00000.npz")
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
    st = _resume_both(roots)
    assert st["delta_idx"] == 1 and st["dense"] == "dense-0001.npz"


# ---- pass rollback and the delta at end_pass, against the JAX package -----


def _trained(dev_table, layout, p):
    """A fixed stand-in for a trained pass table: more shows, moved rows."""
    flat = np.asarray(dev_table).reshape(-1, dev_table.shape[-1]).copy()
    flat[:, layout.SHOW] += 1.0 + (np.arange(len(flat)) % 5)
    flat[:, layout.CLK] += (np.arange(len(flat)) % 2)
    flat[:, layout.embed_w_col:] += np.float32(0.01 * (p + 1))
    return flat


@pytest.fixture
def parser_tier(store):
    """The Python store reads records through each package's line parser,
    as the Python-tier tests pin it."""
    before = config.get_flag("enable_native_parser"), jconfig.get_flag("enable_native_parser")
    if store == "python":
        config.set_flag("enable_native_parser", False)
        jconfig.set_flag("enable_native_parser", False)
    yield store
    config.set_flag("enable_native_parser", before[0])
    jconfig.set_flag("enable_native_parser", before[1])


def _dataset_pair(tmp_path, store):
    """(port dataset, JAX dataset) over mirrored tables; the native ones
    spill past a memory cap at each end_pass."""
    spill = store == "native"
    out = []
    for name, (T, L, O, DS, SS, SI) in (
        ("port", (HostSparseTable, ValueLayout, SparseOptimizerConfig, BoxPSDataset, SlotSchema, SlotInfo)),
        ("jax", (JHostSparseTable, JValueLayout, JSparseOptimizerConfig, JBoxPSDataset, JSlotSchema, JSlotInfo)),
    ):
        table = T(L(embedx_dim=D), O(**OPT_KW), n_shards=4, seed=3, mem_cap_rows=200,
                  spill_dir=str(tmp_path / f"spill-{name}") if spill else None)
        schema = SS([SI("label", type="float", dense=True, dim=1)] + [SI(f"s{i}") for i in range(S)],
                    label_slot="label")
        out.append(DS(schema, table, batch_size=B, read_threads=2))
    assert out[0].table.native == out[1].table.native == spill
    return out


def _begin_both(dss, files, trainers=(None, None), enable_revert=False):
    devs = []
    for d, trn in zip(dss, trainers):
        d.set_filelist(files)
        d.load_into_memory()
        devs.append(np.asarray(d.begin_pass(round_to=64, enable_revert=enable_revert, trainer=trn)))
    np.testing.assert_array_equal(devs[0], devs[1])
    return devs[0]


def _end_both(dss, dev, p, tmp_path, tag=None):
    """end_pass on both with the same trained stand-in; with a ``tag``, each
    package saves a delta of its own and the two dirs must agree."""
    outs = []
    for d, name in zip(dss, ("port", "jax")):
        extra = dict(need_save_delta=True, delta_dir=str(tmp_path / f"{name}-{tag}")) if tag else {}
        out = d.end_pass(_trained(dev, d.table.layout, p), **extra)
        out.pop("secs")
        outs.append(out)
    assert outs[0] == outs[1]
    if tag:
        assert_same_dir(str(tmp_path / f"port-{tag}"), str(tmp_path / f"jax-{tag}"))
    return outs[0]


def _same_tables_and_tiers(t, j):
    """Bitwise-equal tables (reading them promotes every spilled row, the
    same in both) and equal tier stats; returns the port's contents."""
    assert_same_table(t, j)
    assert t.tier_stats() == j.tier_stats()
    return contents(t)


def test_revert_and_end_pass_delta_match_jax(parser_tier, tmp_path):
    """One pass sequence on a port and a JAX dataset over the same files: a
    pass that saves a delta; a pass armed for revert with a trainer each
    (mirrored dense state), written back and its dense state moved, then
    reverted; the retrain with a delta, which confirms; a pass whose delta
    write fails, left open, then reverted. Tables, tier stats, delta dirs,
    end_pass results and the dense state (through the leaf map) agree at
    every step."""
    dss = _dataset_pair(tmp_path, parser_tier)
    t, j = (d.table for d in dss)
    trainers = (_port_trainer(ValueLayout(embedx_dim=D)), _jax_trainer(JValueLayout(embedx_dim=D)))
    tr, jtr = trainers
    set_dense(jtr, tr, *random_dense(jtr, 1))
    days = [_write_files(tmp_path, f"d{i}", seed=i, lo=lo, hi=hi)
            for i, (lo, hi) in enumerate(((1, 300), (150, 450), (1, 450)))]

    dev = _begin_both(dss, days[0])
    assert _end_both(dss, dev, 0, tmp_path, "delta-0")["delta_keys"] > 0
    keys0, rows0 = _same_tables_and_tiers(t, j)

    # a rejected pass: written back, its dense state moved, then reverted
    dev = _begin_both(dss, days[1], trainers, enable_revert=True)
    for d in dss:
        d.ws.writeback(_trained(dev, d.table.layout, 1))
    keys1, rows1 = _same_tables_and_tiers(t, j)
    assert not np.array_equal(rows1[np.isin(keys1, keys0)], rows0)
    set_dense(jtr, tr, *random_dense(jtr, 2))
    for d in dss:
        d.revert_pass()
    keys2, rows2 = _same_tables_and_tiers(t, j)
    # the pass's new keys stay, holding their rows from before the training
    np.testing.assert_array_equal(keys2, keys1)
    np.testing.assert_array_equal(rows2[np.isin(keys2, keys0)], rows0)
    assert_same_dense(tr, jtr)
    for got, want in zip(jax_leaves(jtr), random_dense(jtr, 1)[0]):
        np.testing.assert_array_equal(got, want)
    assert tr._state is None and tr.resident is None

    # the retrain saves its delta and confirms the guard
    dev = _begin_both(dss, days[1], trainers, enable_revert=True)
    out = _end_both(dss, dev, 1, tmp_path, "delta-1")
    assert out["delta_keys"] > 0
    if t.native:  # end_pass spilled past the cap, after the delta
        assert t.disk_rows == j.disk_rows > 0
    _same_tables_and_tiers(t, j)
    for d in dss:
        with pytest.raises(RuntimeError, match="revert"):
            d.revert_pass()

    # a pass whose delta write fails stays open; the revert undoes its
    # writeback, and the decay it ran stays on the keys outside the pass
    dev = _begin_both(dss, days[2], trainers, enable_revert=True)
    for d, name, mod in zip(dss, ("port", "jax"), (fault, jfault)):
        with mod.inject(mod.fail_once("fs.atomic_write")):
            with pytest.raises(mod.InjectedFault):
                d.end_pass(_trained(dev, d.table.layout, 2), need_save_delta=True,
                           delta_dir=str(tmp_path / f"{name}-failed"))
        assert d.ws is not None
        d.revert_pass()
    _same_tables_and_tiers(t, j)
    assert_same_dense(tr, jtr)
    dev = _begin_both(dss, days[2])
    _end_both(dss, dev, 2, tmp_path, "delta-2")
    _same_tables_and_tiers(t, j)


# ---- pass rollback and resumed training (the port alone, on the CPU) ------


def _write_files(tmp_path, tag, n_files=2, n_rec=64, seed=0, lo=1, hi=300):
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


SCHEMA = SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
                    label_slot="label")


def _stack(model_seed=0):
    """(native table, dataset, CPU trainer) over the same config."""
    lay = ValueLayout(embedx_dim=D)
    opt = SparseOptimizerConfig(embedx_threshold=0.0, show_clk_decay=0.9, shrink_threshold=0.0)
    table = HostSparseTable(lay, opt, n_shards=4, seed=0)
    ds = BoxPSDataset(SCHEMA, table, batch_size=B, read_threads=2)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=opt, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(model_seed))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")
    tr.init_params()
    return table, ds, tr


def _pass(ds, tr, files, n_batches=None):
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    tr.train_pass(ds, n_batches=n_batches)
    return ds.end_pass(tr.trained_table())


def _dense(tr):
    return [x.copy() for x in dense_to_jax_leaves(tr.params, tr.opt_state)]


def _same_dense_leaves(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_revert_restores_table_and_dense_and_retrain_equals_fresh(tmp_path):
    files = _write_files(tmp_path, "p")
    ref_table, ref_ds, ref_tr = _stack()
    _pass(ref_ds, ref_tr, files)

    table, ds, tr = _stack()
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64, enable_revert=True, trainer=tr)
    pre_keys = ds.ws.sorted_keys.copy()
    pre_rows = table.pull_or_create(pre_keys).copy()
    pre_dense = _dense(tr)
    tr.train_pass(ds, n_batches=3)
    ds.ws.writeback(tr.trained_table())  # a partial pass published, then rejected
    assert not np.array_equal(table.pull_or_create(pre_keys), pre_rows)
    assert not _same_dense_leaves(_dense(tr), pre_dense)
    ds.revert_pass()
    np.testing.assert_array_equal(table.pull_or_create(pre_keys), pre_rows)
    assert _same_dense_leaves(_dense(tr), pre_dense)
    assert tr._state is None and tr.resident is None  # nothing stale on the device
    ds.begin_pass(round_to=64)
    tr.train_pass(ds)
    ds.end_pass(tr.trained_table())
    assert_same_table(table, ref_table)
    assert _same_dense_leaves(_dense(tr), _dense(ref_tr))


def test_failed_end_pass_stays_open_for_revert(tmp_path):
    files = _write_files(tmp_path, "q")
    table, ds, tr = _stack()
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64, enable_revert=True, trainer=tr)
    keys = ds.ws.sorted_keys.copy()
    before = table.pull_or_create(keys).copy()
    tr.train_pass(ds)
    with pytest.raises(ValueError, match="delta_dir"):
        ds.end_pass(tr.trained_table(), need_save_delta=True)
    with fault.inject(fault.fail_once("fs.atomic_write")):
        with pytest.raises(fault.InjectedFault):
            ds.end_pass(tr.trained_table(), need_save_delta=True, delta_dir=str(tmp_path / "d"))
    assert ds.ws is not None  # the pass is still open
    ds.revert_pass()
    np.testing.assert_array_equal(table.pull_or_create(keys), before)
    # the retried pass publishes its delta: exactly the pass's keys
    ds.begin_pass(round_to=64, enable_revert=True, trainer=tr)
    tr.train_pass(ds)
    out = ds.end_pass(tr.trained_table(), need_save_delta=True, delta_dir=str(tmp_path / "d2"), shrink=False)
    assert out["delta_keys"] == len(keys)
    with pytest.raises(RuntimeError, match="revert"):
        ds.revert_pass()  # end_pass confirmed it


def test_resume_then_train_equals_uninterrupted(tmp_path):
    day1 = _write_files(tmp_path, "a", seed=1)
    day2 = _write_files(tmp_path, "b", seed=2, lo=150, hi=450)
    table, ds, tr = _stack()
    _pass(ds, tr, day1)
    CheckpointManager(str(tmp_path / "ckpt")).save_base(DATE, table, tr)
    _pass(ds, tr, day2)

    # a fresh process: a trainer with other initial weights that already
    # trained a pass elsewhere (its device caches would be stale), and a
    # fresh table of the same seed (new keys' rows come from the seed)
    _, ds_w, tr2 = _stack(model_seed=7)
    _pass(ds_w, tr2, day2, n_batches=2)
    table2, ds2, _ = _stack()
    st = CheckpointManager(str(tmp_path / "ckpt")).resume(table2, tr2)
    assert st == {"date": DATE, "delta_idx": 0, "dense": "dense-0000.npz", "ownership_epoch": 0}
    _pass(ds2, tr2, day2)
    assert_same_table(table2, table)
    assert _same_dense_leaves(_dense(tr2), _dense(tr))


def test_load_dense_mid_pass_drops_the_stale_state(tmp_path):
    """A dense load between two train_pass calls of one pass: the second
    call trains from the loaded params and the pass-open table, as a fresh
    trainer that loaded the same file does."""
    files = _write_files(tmp_path, "m")
    _, ds, tr = _stack()
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    dense = str(tmp_path / "dense.npz")
    tr.save_dense(dense)
    tr.train_pass(ds, n_batches=3)
    tr.load_dense(dense)
    tr.train_pass(ds, n_batches=2)
    _, _, fresh = _stack(model_seed=4)
    fresh.load_dense(dense)
    fresh.train_pass(ds, n_batches=2)
    assert _same_dense_leaves(_dense(tr), _dense(fresh))
    np.testing.assert_array_equal(tr.trained_table(), fresh.trained_table())
