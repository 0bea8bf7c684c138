"""The extended pull (``use_expand``, pull_box_extended_sparse) in the
port against the JAX package: the train step on one device, the sharded
step on a gloo mesh of 2, and ``CTRTrainer`` on every feed, alone and on
the mesh.

The model is ``tests/test_replica_cache.py``'s ``ExpandModel`` (a linear
term over the slot features plus one over the pooled expand embeddings,
fp32), with fixed weights defined here for both packages. The layout is
``ValueLayout(embedx_dim=4, expand_embed_dim=3)``: the pulled records
carry the expand block as trailing columns, the model gets it sum-pooled
by (slot, instance) as its last argument, and the push trains it with
its own AdaGrad g2 column.

Bounds, those of ``tests/test_torch_train_step.py`` and
``tests/test_torch_mesh_step.py`` (the per-row merge and the owner's
merge sum in other orders than XLA's scatter-add): table rtol 1e-3, atol
1e-5; params atol 2e-4; Adam moments rtol 5e-2, atol 1e-6; losses rtol
1e-3 on one device and 3e-4 on the mesh (``tests/test_replica_cache.py``'s
bound). The port's mesh against the port's one device on the same global
batches: ``tests/test_sharded.py``'s bounds (losses rtol 1e-5 at step 1
and 6e-3 after, table rtol 2e-3 atol 1e-3). The port's feeds against each
other: bitwise.

The mesh ranks are spawned once for the module (gloo on the CPU, one
thread a rank); the module imports no JAX at its top, since each spawned
child imports it by name.
"""

import copy
import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.device_pack import pack_batch, pack_batch_sharded
from paddlebox_tpu_torch.data.slot_record import build_batch
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.sharded_step import init_sharded_train_state, make_sharded_train_step
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_step import _records, _Rows, _schema

torch.set_num_threads(2)

S, D, E, B, N_STEPS, WORLD = 4, 4, 3, 16, 4, 2
LAY = ValueLayout(embedx_dim=D, expand_embed_dim=E)
LR, AUC_BUCKETS = 1e-2, 50
SPARSE = dict(embed_lr=0.2, embedx_lr=0.2, embedx_threshold=2.0)
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-5
PARAMS_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
LOSS_RTOL, MESH_LOSS_RTOL = 1e-3, 3e-4
ONE_LOSS_RTOL_FIRST, ONE_LOSS_RTOL = 1e-5, 6e-3
ONE_TABLE_RTOL, ONE_TABLE_ATOL = 2e-3, 1e-3
WIRES = ("fp32", "int8")
# the trainers' files: bench.py's line format, a small key space so keys repeat
TR_S, TR_B, N_REC = 4, 64, 128
TR_LAY = ValueLayout(embedx_dim=D, expand_embed_dim=E)
TR_SPARSE = dict(embed_lr=0.3, embedx_lr=0.3, embedx_threshold=1.0)
FEEDS = {  # feed -> flags in both packages
    "resident": dict(enable_native_parser=True, enable_resident_feed=1),
    "packer": dict(enable_native_parser=True, enable_resident_feed=0),
    "slow": dict(enable_native_parser=False, enable_resident_feed=1),
}


def expand_params(n_slots, pull_width, seed=1):
    """The model's weights (numpy): ``w`` over the flattened slot
    features, ``we`` over the flattened pooled expand."""
    rng = np.random.default_rng(seed)
    return {"w": (0.05 * rng.normal(size=n_slots * pull_width)).astype(np.float32),
            "we": (0.05 * rng.normal(size=n_slots * E)).astype(np.float32)}


class ExpandModel(torch.nn.Module):
    """``slot_feats . w + expand . we`` (fp32), the JAX test's model."""

    def __init__(self, n_slots=S, pull_width=LAY.pull_width):
        super().__init__()
        for k, v in expand_params(n_slots, pull_width).items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v)))

    def forward(self, slot_feats, dense=None, expand=None):
        b = slot_feats.shape[0]
        return slot_feats.reshape(b, -1) @ self.w + expand.reshape(b, -1) @ self.we


class JExpandModel:
    """The same model for the JAX package."""

    def __init__(self, n_slots=S, pull_width=LAY.pull_width):
        self.n_slots, self.pull_width = n_slots, pull_width

    def init(self, rng=None):
        import jax.numpy as jnp

        return {k: jnp.asarray(v) for k, v in expand_params(self.n_slots, self.pull_width).items()}

    def apply(self, p, slot_feats, dense=None, expand=None):
        b = slot_feats.shape[0]
        return slot_feats.reshape(b, -1) @ p["w"] + expand.reshape(b, -1) @ p["we"]


def _apply(model):
    return lambda p, x, d, e: torch.func.functional_call(model, p, (x, d, e))


def _cfg(**kw):
    return TrainStepConfig(num_slots=S, layout=LAY, sparse_opt=SparseOptimizerConfig(**SPARSE),
                           auc_buckets=AUC_BUCKETS, use_expand=True, **kw)


def _jcfg(**kw):
    from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table.value_layout import ValueLayout as JLayout
    from paddlebox_tpu.train.train_step import TrainStepConfig as JCfg

    return JCfg(num_slots=S, layout=JLayout(embedx_dim=D, expand_embed_dim=E), sparse_opt=JOpt(**SPARSE),
                auc_buckets=AUC_BUCKETS, use_expand=True, **kw)


def make_inputs():
    """(table [n, cap, W], one-device table [n*cap, W], one-device batches,
    sharded batches) over one working set of WORLD shards."""
    rng = np.random.default_rng(21)
    schema = _schema()
    recs = _records(rng, B * N_STEPS)
    ws = PassWorkingSet(n_mesh_shards=WORLD)
    for r in recs:
        ws.add_keys(r.u64_values)
    table = ws.finalize(_Rows(LAY), round_to=16)
    batches = [build_batch(recs[i * B : (i + 1) * B], schema) for i in range(N_STEPS)]
    one = [pack_batch(bt, ws, schema, bucket=8).as_dict() for bt in batches]
    pads, sharded = [-1, 0], []
    for bt in batches:
        db = pack_batch_sharded(bt, ws, schema, WORLD, bucket=8, k_floor=pads[0], l_floor=pads[1])
        pads = [db.req_ranks.shape[2], db.inverse.shape[1]]
        sharded.append(db.as_dict())
    return table, table.reshape(-1, LAY.width), one, sharded


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _port_one(table, batches, eval_mode=False):
    model = ExpandModel()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    st = TrainState(torch.from_numpy(table.copy()), params, Adam(LR).init(params), auc_init(AUC_BUCKETS, device="cpu"),
                    torch.zeros((), dtype=torch.int32))
    step = make_train_step(_apply(model), _cfg(batch_size=B), None if eval_mode else Adam(LR), eval_mode=eval_mode)
    ms = []
    for b in batches:
        st, m = step(st, _torch(b))
        ms.append(m)
    return st, ms


def _jax_one(table, batches, eval_mode=False):
    import jax
    import jax.numpy as jnp
    import optax

    from paddlebox_tpu.metrics.auc import auc_init as jauc_init
    from paddlebox_tpu.train.train_step import TrainState as JTrainState
    from paddlebox_tpu.train.train_step import make_train_step as jmake

    model, opt = JExpandModel(), optax.adam(LR)
    params = model.init()
    st = JTrainState(jnp.asarray(table), params, opt.init(params), jauc_init(AUC_BUCKETS), jnp.zeros((), jnp.int32))
    step = jax.jit(jmake(model.apply, opt, _jcfg(batch_size=B), eval_mode=eval_mode))
    ms = []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append(m)
    return jax.tree.map(np.asarray, st), ms


def _assert_state(table, params, mu, nu, jst, loss, jloss, loss_rtol):
    from paddlebox_tpu_torch.models import params_from_jax

    np.testing.assert_allclose(table, np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    jadam = jst.opt_state[0]
    for name, got, want in (("params", params, jst.params), ("mu", mu, jadam.mu), ("nu", nu, jadam.nu)):
        for k, v in params_from_jax(want).items():
            if name == "params":
                np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=PARAMS_ATOL, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v.numpy(), rtol=MOMENT_RTOL, atol=MOMENT_ATOL, err_msg=k)
    np.testing.assert_allclose(loss, jloss, rtol=loss_rtol)


def test_extended_step_matches_jax():
    """Four extended steps from one state: table, params, moments and
    losses within the bounds; the expand block and its g2 column trained
    on the touched rows, as in the JAX package."""
    _, table, one, _ = make_inputs()
    st, ms = _port_one(table, one)
    jst, jms = _jax_one(table, one)
    _assert_state(st.table.numpy(), {k: v.numpy() for k, v in st.params.items()},
                  {k: v.numpy() for k, v in st.opt_state.mu.items()}, {k: v.numpy() for k, v in st.opt_state.nu.items()},
                  jst, [float(m["loss"]) for m in ms], [float(m["loss"]) for m in jms], LOSS_RTOL)
    np.testing.assert_array_equal(st.auc.pos.numpy(), np.asarray(jst.auc.pos))
    ec = slice(LAY.expand_col, LAY.expand_col + LAY.expand_dim)
    t1 = st.table.numpy()
    moved = np.abs(t1[:, ec] - table[:, ec]).max(axis=1) > 0
    assert moved.sum() > 10
    assert (t1[moved, LAY.expand_g2_col] > table[moved, LAY.expand_g2_col]).all()
    # rows still below the activation threshold (shows only grow, so they
    # were gated at every push) keep their expand block
    cold = t1[:, LAY.SHOW] < SPARSE["embedx_threshold"]
    assert cold.sum() > 0
    np.testing.assert_array_equal(t1[cold][:, ec], table[cold][:, ec])


def test_extended_eval_step_matches_jax():
    _, table, one, _ = make_inputs()
    st, ms = _port_one(table, one[:2], eval_mode=True)
    jst, jms = _jax_one(table, one[:2], eval_mode=True)
    assert st.table.numpy().tobytes() == table.tobytes()
    for m, jm in zip(ms, jms):
        np.testing.assert_allclose(m["preds"].numpy(), np.asarray(jm["preds"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)


def test_extended_step_rejects_a_layout_without_expand():
    with pytest.raises(ValueError, match="expand block"):
        make_train_step(lambda p, x, d, e: x, TrainStepConfig(num_slots=S, batch_size=B, layout=ValueLayout(D),
                                                              use_expand=True), Adam(LR))


# ---- the mesh: the sharded step and the trainer, in spawned ranks ----------


def _write_files(d, n_files=2, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        keys = rng.integers(1, 200, (N_REC, TR_S))
        labels = (rng.random(N_REC) < 0.3).astype(int)
        path = os.path.join(d, f"part-{seed}-{fi:03d}.txt")
        with fs_open_write(path) as f:
            for i in range(N_REC):
                f.write(f"1 {labels[i]}.0 " + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files


def _tr_schema(info_cls, schema_cls):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)]
                      + [info_cls(f"s{i}") for i in range(TR_S)], label_slot="label")


def _set_flags(cfg_module, flags):
    before = {k: cfg_module.get_flag(k) for k in flags}
    for k, v in flags.items():
        cfg_module.set_flag(k, v)
    return before


def _port_trainer_pass(files, plan=None, n_batches=None, view=False):
    """One extended pass of the port's trainer (on the mesh with
    ``plan``): (trainer, dataset, host table, out, losses)."""
    table = HostSparseTable(TR_LAY, SparseOptimizerConfig(**TR_SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(_tr_schema(SlotInfo, SlotSchema), table, batch_size=TR_B, shuffle_mode="local", seed=5,
                      read_threads=2, n_mesh_shards=1 if plan is None else plan.world)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    world = 1 if plan is None else plan.world
    cfg = TrainStepConfig(num_slots=TR_S, batch_size=TR_B // world, layout=TR_LAY,
                          sparse_opt=SparseOptimizerConfig(**TR_SPARSE), auc_buckets=1000, use_expand=True)
    model = ExpandModel(TR_S, TR_LAY.pull_width)
    tr = CTRTrainer(model, cfg, dense_opt=Adam(LR), plan=plan, device=None if plan else "cpu")
    data = ds
    if view:  # the slow feed over the same pass: its records in batch order
        data = copy.copy(ds)
        idx = np.concatenate(list(ds.batch_indices(n_batches)))
        data.records = [ds.store.record(int(i)) for i in idx]
    else:
        tr.prepare_pass(ds, n_batches=n_batches)
    losses = []
    out = tr.train_pass(data, n_batches=n_batches, on_batch=lambda i, m: losses.append(float(m["loss"])))
    return tr, ds, table, out, np.array(losses)


def rank_main(plan, in_path: str, out_dir: str, files) -> None:
    r = plan.rank
    data = dict(np.load(in_path))
    table = data["table"]
    sharded = [{k.split(":")[2]: data[k] for k in data if k.startswith(f"b:{i}:")} for i in range(N_STEPS)]
    model = ExpandModel()
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    for wire in WIRES:
        before = _set_flags(config, {"ici_wire_dtype": wire})
        st = init_sharded_train_state(plan, table, params0, Adam(LR), AUC_BUCKETS)
        step = make_sharded_train_step(_apply(model), Adam(LR), _cfg(batch_size=B // WORLD), plan)
        losses = []
        for f in sharded:
            st, m = step(st, {k: torch.from_numpy(np.ascontiguousarray(v[r])) for k, v in f.items()})
            losses.append(float(m["loss"]))
        _set_flags(config, before)
        out[f"{wire}:table"] = st.table.numpy()
        out[f"{wire}:loss"] = np.array(losses)
        for k in params0:
            out[f"{wire}:p:{k}"] = st.params[k].numpy()
            out[f"{wire}:mu:{k}"] = st.opt_state.mu[k].numpy()
            out[f"{wire}:nu:{k}"] = st.opt_state.nu[k].numpy()
    # the trainer on the mesh, through each feed, 4 steps from one state
    for feed, flags in FEEDS.items():
        before = _set_flags(config, flags)
        tr, ds, _, o, losses = _port_trainer_pass(files, plan, n_batches=N_STEPS)
        _set_flags(config, before)
        out[f"tr:{feed}:last_feed"] = np.array(tr.last_feed)
        out[f"tr:{feed}:trained"] = tr.trained_table()
        out[f"tr:{feed}:loss"] = losses
        for k, v in tr.params.items():
            out[f"tr:{feed}:p:{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("expand_mesh")
    table, one_table, one, sharded = make_inputs()
    files = _write_files(str(d))  # before the ranks read them
    arrs = {"table": table}
    for i, s in enumerate(sharded):
        for k, v in s.items():
            arrs[f"b:{i}:{k}"] = v
    np.savez(d / "in.npz", **arrs)
    spawn(rank_main, WORLD, f"file://{d}/rdv", backend="gloo", device="cpu",
          args=(str(d / "in.npz"), str(d), files), threads=1, timeout_s=300)
    return (table, one_table, one, sharded, files), [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_mesh(table, sharded, wire):
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.parallel.mesh import put_sharded
    from paddlebox_tpu.train.sharded_step import init_sharded_train_state as jinit
    from paddlebox_tpu.train.sharded_step import make_sharded_train_step as jmake

    before = _set_flags(jconfig, {"ici_wire_dtype": wire})
    try:
        plan = make_mesh(WORLD)
        model, opt = JExpandModel(), optax.adam(LR)
        st = jinit(plan, table, model.init(), opt, AUC_BUCKETS)
        step = jmake(model.apply, opt, _jcfg(batch_size=B // WORLD, axis_name="dp"), plan)
        losses = []
        for f in sharded:
            st, m = step(st, {k: put_sharded(plan, v) for k, v in f.items()})
            losses.append(float(m["loss"]))
        return jax.tree.map(np.asarray, st), losses
    finally:
        _set_flags(jconfig, before)


@pytest.mark.parametrize("wire", WIRES)
def test_extended_mesh_step_matches_jax(mesh, wire):
    """The gloo mesh of 2 against the JAX mesh of 2 on the same sharded
    batches, with the value payloads on the fp32 and the int8 wire (the
    expand block is its own int8 section in both packages)."""
    (table, _, _, sharded, _), ranks = mesh
    jst, jlosses = _jax_mesh(table, sharded, wire)
    for r, res in enumerate(ranks):
        jr = jst._replace(table=jst.table[r])
        _assert_state(res[f"{wire}:table"], {k: res[f"{wire}:p:{k}"] for k in ("w", "we")},
                      {k: res[f"{wire}:mu:{k}"] for k in ("w", "we")}, {k: res[f"{wire}:nu:{k}"] for k in ("w", "we")},
                      jr, res[f"{wire}:loss"], jlosses, MESH_LOSS_RTOL)


def test_extended_mesh_step_matches_the_port_on_one_device(mesh):
    """The port's mesh (fp32 wire) against the port's one device fed the
    same global batches: the losses and every table row."""
    (table, one_table, one, _, _), ranks = mesh
    st, ms = _port_one(one_table, one)
    losses = np.array([float(m["loss"]) for m in ms])
    got = ranks[0]["fp32:loss"]
    np.testing.assert_allclose(got[0], losses[0], rtol=ONE_LOSS_RTOL_FIRST)
    np.testing.assert_allclose(got, losses, rtol=ONE_LOSS_RTOL)
    mesh_table = np.concatenate([res["fp32:table"] for res in ranks])
    np.testing.assert_allclose(mesh_table, st.table.numpy(), rtol=ONE_TABLE_RTOL, atol=ONE_TABLE_ATOL)
    ec = slice(LAY.expand_col, LAY.expand_col + E)
    assert np.abs(mesh_table[:, ec] - table.reshape(-1, LAY.width)[:, ec]).max() > 1e-5


def test_extended_mesh_trainer_feeds_are_bitwise(mesh):
    """``CTRTrainer(plan=)`` with ``use_expand``: the resident, packer and
    slow feeds give the same bits on every rank, and both ranks the same
    losses."""
    _, ranks = mesh
    for res in ranks:
        for feed in FEEDS:
            assert str(res[f"tr:{feed}:last_feed"]) == feed
        for feed in ("packer", "slow"):
            for key in ("trained", "loss", "p:w", "p:we"):
                np.testing.assert_array_equal(res[f"tr:{feed}:{key}"], res[f"tr:resident:{key}"], err_msg=f"{feed}:{key}")
    np.testing.assert_array_equal(ranks[0]["tr:resident:loss"], ranks[1]["tr:resident:loss"])


def _jax_trainer_pass(files, plan_world=None, n_batches=N_STEPS):
    """The JAX trainer's extended resident pass (on a mesh of
    ``plan_world`` devices): (trained table, params, losses)."""
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    before = _set_flags(jconfig, FEEDS["resident"])
    try:
        lay = JLayout(embedx_dim=D, expand_embed_dim=E)
        table = JHostSparseTable(lay, JOpt(**TR_SPARSE), n_shards=4, seed=0)
        world = plan_world or 1
        ds = JBoxPSDataset(_tr_schema(JSlotInfo, JSlotSchema), table, batch_size=TR_B, shuffle_mode="local", seed=5,
                           n_mesh_shards=world)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        kw = {"axis_name": "dp"} if plan_world else {}
        cfg = JCfg(num_slots=TR_S, batch_size=TR_B // world, layout=lay, sparse_opt=JOpt(**TR_SPARSE),
                   auc_buckets=1000, use_expand=True, **kw)
        tr = JCTRTrainer(JExpandModel(TR_S, lay.pull_width), cfg, dense_opt=optax.adam(LR),
                         **({"plan": make_mesh(world)} if plan_world else {}))
        tr.init_params(jax.random.PRNGKey(0))
        tr.prepare_pass(ds, n_batches=n_batches)
        losses = []
        tr.train_pass(ds, n_batches=n_batches, on_batch=lambda i, m: losses.append(float(m["loss"])))
        return np.asarray(tr.trained_table()), jax.tree.map(np.asarray, tr.params), np.array(losses)
    finally:
        _set_flags(jconfig, before)


def test_extended_mesh_trainer_matches_the_jax_mesh_trainer(mesh):
    from paddlebox_tpu_torch.models import params_from_jax

    (_, _, _, _, files), ranks = mesh
    trained, params, losses = _jax_trainer_pass(files, WORLD)
    for res in ranks:
        np.testing.assert_allclose(res["tr:resident:trained"], trained, rtol=TABLE_RTOL, atol=TABLE_ATOL)
        np.testing.assert_allclose(res["tr:resident:loss"], losses, rtol=MESH_LOSS_RTOL)
        for k, v in params_from_jax(params).items():
            np.testing.assert_allclose(res[f"tr:resident:p:{k}"], v.numpy(), rtol=0, atol=PARAMS_ATOL, err_msg=k)


# ---- CTRTrainer on one device ------------------------------------------------


@pytest.fixture
def restore_flags():
    keys = ("enable_native_parser", "enable_resident_feed", "resident_scan_batches")
    before = {k: config.get_flag(k) for k in keys}
    yield
    _set_flags(config, before)


def test_extended_trainer_feeds_are_bitwise_and_match_jax(tmp_path, restore_flags):
    """The resident feed at K = 4 and K = 1, the packer and the slow feed:
    4 steps from one state give the same bits (table, params, Adam
    moments, losses); the resident run is within the bounds of the JAX
    trainer's, and it trained the expand block."""
    files = _write_files(str(tmp_path))
    runs = {}
    for name, flags, view, want in (
        ("resident K=4", dict(enable_resident_feed=1, resident_scan_batches=4), False, "resident"),
        ("resident K=1", dict(enable_resident_feed=1, resident_scan_batches=1), False, "resident"),
        ("packer", dict(enable_resident_feed=0), False, "packer"),
        ("slow", dict(enable_resident_feed=1), True, "slow"),
    ):
        _set_flags(config, dict(enable_native_parser=True, **flags))
        tr, ds, _, _, losses = _port_trainer_pass(files, n_batches=N_STEPS, view=view)
        assert tr.last_feed == want, name
        runs[name] = (tr.trained_table(), {k: v.numpy() for k, v in tr.params.items()},
                      {k: v.numpy() for k, v in tr.opt_state.mu.items()},
                      {k: v.numpy() for k, v in tr.opt_state.nu.items()}, losses)
        if name == "resident K=4":
            t0 = ds.device_table.numpy() if isinstance(ds.device_table, torch.Tensor) else np.asarray(ds.device_table)
    ref = runs["resident K=4"]
    for name, got in runs.items():
        assert got[0].tobytes() == ref[0].tobytes(), name
        for i in (1, 2, 3):
            for k in ref[i]:
                assert got[i][k].tobytes() == ref[i][k].tobytes(), (name, i, k)
        assert got[4].tobytes() == ref[4].tobytes(), name
    ec = slice(TR_LAY.expand_col, TR_LAY.expand_col + E)
    t0 = t0.reshape(-1, TR_LAY.width)
    t1 = ref[0].reshape(-1, TR_LAY.width)
    moved = np.abs(t1[:, ec] - t0[:, ec]).max(axis=1) > 0
    assert moved.sum() > 10 and (t1[moved, TR_LAY.expand_g2_col] > t0[moved, TR_LAY.expand_g2_col]).all()
    from paddlebox_tpu_torch.models import params_from_jax

    trained, params, losses = _jax_trainer_pass(files)
    np.testing.assert_allclose(ref[0], trained, rtol=TABLE_RTOL, atol=TABLE_ATOL)
    np.testing.assert_allclose(ref[4], losses, rtol=LOSS_RTOL)
    for k, v in params_from_jax(params).items():
        np.testing.assert_allclose(ref[1][k], v.numpy(), rtol=0, atol=PARAMS_ATOL, err_msg=k)
