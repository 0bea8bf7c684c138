"""The port's sharded step against the JAX package's ``make_sharded_train_step``
at the same mesh size, step for step, and against the port's single device.

The port's ranks are spawned once per world (gloo on the CPU, a
``file://`` rendezvous, one thread a rank): world 2 runs every scenario,
world 4 the ``step`` mode. Each rank loads the inputs this module wrote
(the table [n, cap, W], the tower's weights, the packed global
batches), runs 5 steps a scenario and writes its shard,
params, moments, losses and the ``auc_psum`` tables. The JAX side runs the
same scenarios under ``shard_map`` on the suite's virtual CPU devices.

The model is a small fp32 tower defined here in both packages (the same
weights, JAX's layout): the zoo's towers run a bf16 recipe whose rounding
XLA and torch place differently, so a ReLU unit at its edge or a
near-zero gradient would be decided by that rounding (Adam then moves the
weight by +lr in one package and 0 or -lr in the other); the zoo models
against the JAX package are ``test_torch_zoo.py``'s and
``test_torch_train_step.py``'s.

Scenarios: ``step`` (world 2 and 4), ``kstep`` (``param_sync_step=2``,
with the pass-end ``kstep_sync_params``), ZeRO-1, ``ins_weight``-weighted
batches, ``check_nan`` with rank 1's labels poisoned at step 2, the same
poison under kstep (the skipped batch moves the replica averages a step
later), and eval mode. Each scenario's collectives are counted through
``MeshPlan.calls``: kstep with ``check_nan`` all-reduces the dense params
every step, where kstep alone does so every ``param_sync_step`` steps. Bounds, those of ``tests/test_torch_train_step.py`` (the bf16 MLP
rounds at other places in XLA's and torch's CPU dots, and the owner's
merge sums in another order than XLA's scatter-add):

- table: rtol 1e-3, atol 1e-5; params: atol 2e-4; Adam moments: rtol
  5e-2, atol 1e-6; losses: rtol 1e-3;
- AUC bucket tables after ``auc_psum``: exact;
- eval mode: table, params and optimizer state bitwise as they came; the
  skipped batch of ``check_nan`` leaves the step counter where it was;
- the port's world-2 mesh against the port's single device on the same
  global batches (``tests/test_sharded.py``'s bounds): loss rtol 1e-5 at
  step 1 and 6e-3 after, table rtol 2e-3 atol 1e-3, params atol 3e-2.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.data import SlotInfo, SlotSchema, parse_line
from paddlebox_tpu_torch.data.device_pack import pack_batch, pack_batch_sharded
from paddlebox_tpu_torch.data.slot_record import build_batch
from paddlebox_tpu_torch.fleet import Zero1Optimizer
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.metrics.auc import auc_init, auc_psum
from paddlebox_tpu_torch.table import PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.sharded_step import (
    init_sharded_train_state,
    kstep_sync_params,
    make_sharded_train_step,
)

torch.set_num_threads(2)

S, D, B, N_STEPS = 4, 4, 16, 5  # B: the global batch
LR, AUC_BUCKETS = 1e-3, 50
SPARSE = dict(embed_lr=0.3, embedx_lr=0.3, embedx_threshold=2.0)
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-5
PARAMS_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
LOSS_RTOL = 1e-3
SCENARIOS = {  # name -> (worlds, TrainStepConfig options, ZeRO, weighted, poison, eval)
    "step": ((2, 4), {}, False, False, False, False),
    "kstep": ((2,), dict(dense_sync_mode="kstep", param_sync_step=2), False, False, False, False),
    "zero": ((2,), {}, True, False, False, False),
    "weighted": ((2,), {}, False, True, False, False),
    "nan": ((2,), dict(check_nan=True), False, False, True, False),
    "kstep_nan": ((2,), dict(dense_sync_mode="kstep", param_sync_step=2, check_nan=True), False, False, True, False),
    "eval": ((2,), {}, False, False, False, True),
}
LAY = ValueLayout(embedx_dim=D)
TOWER = 32


def tower_params(seed: int = 0):
    """The tower's weights (numpy, JAX's layout and names)."""
    rng = np.random.default_rng(seed)
    d_in = S * LAY.pull_width
    return {
        "b1": (0.01 * rng.normal(size=TOWER)).astype(np.float32),
        "b2": np.zeros((1,), np.float32),
        "w1": (rng.normal(size=(d_in, TOWER)) * np.sqrt(2.0 / (d_in + TOWER))).astype(np.float32),
        "w2": (rng.normal(size=(TOWER, 1)) * np.sqrt(2.0 / (TOWER + 1))).astype(np.float32),
    }


class Tower(torch.nn.Module):
    """fp32 ``relu(x @ w1 + b1) @ w2 + b2`` over the flattened slot features."""

    def __init__(self):
        super().__init__()
        for k, v in tower_params().items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v)))

    def forward(self, slot_feats, dense=None):
        h = torch.relu(slot_feats.reshape(slot_feats.shape[0], -1) @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[:, 0]


class JTower:
    """The same tower for the JAX package."""

    def init(self, rng=None):
        import jax.numpy as jnp

        return {k: jnp.asarray(v) for k, v in tower_params().items()}

    def apply(self, params, slot_feats, dense=None):
        import jax.numpy as jnp

        h = jnp.maximum(slot_feats.reshape(slot_feats.shape[0], -1) @ params["w1"] + params["b1"], 0.0)
        return (h @ params["w2"] + params["b2"])[:, 0]


def _schema():
    return SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label",
    )


class _Rows:
    """Host rows as a function of the key: shows 0..6, small weights."""

    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        k = keys.astype(np.float64)[:, None]
        rows = (0.05 * np.sin(k * 0.37 + np.arange(self.layout.width)[None, :])).astype(np.float32)
        rows[:, self.layout.SHOW] = (keys % 7).astype(np.float32)
        rows[:, self.layout.CLK] = (keys % 2).astype(np.float32)
        rows[:, self.layout.embed_g2_col :] = 0.0
        return rows


def _records(rng, n):
    schema = _schema()
    out = []
    for _ in range(n):
        parts = [f"1 {float(rng.random() < 0.35)}"]
        for _ in range(S):
            k = int(rng.integers(1, 4))
            parts.append(f"{k} " + " ".join(str(int(v)) for v in rng.integers(1, 80, k)))
        out.append(parse_line(" ".join(parts), schema))
    return out


def make_inputs(n: int):
    """(table [n, cap, W], ws, global batches, per-step sharded arrays,
    weights [steps, B], JAX params) for world n."""
    rng = np.random.default_rng(11)
    schema = _schema()
    recs = _records(rng, B * N_STEPS)
    ws = PassWorkingSet(n_mesh_shards=n)
    for r in recs:
        ws.add_keys(r.u64_values)
    table = ws.finalize(_Rows(LAY), round_to=16)
    batches = [build_batch(recs[i * B : (i + 1) * B], schema) for i in range(N_STEPS)]
    pads, sharded = [-1, 0], []
    for bt in batches:
        db = pack_batch_sharded(bt, ws, schema, n, bucket=8, k_floor=pads[0], l_floor=pads[1])
        pads = [db.req_ranks.shape[2], db.inverse.shape[1]]
        sharded.append(db.as_dict())
    weights = rng.choice(np.array([0.0, 1.0, 2.0], np.float32), size=(N_STEPS, B), p=[0.2, 0.5, 0.3])
    return table, ws, batches, sharded, weights, tower_params()


def _cfg_kw(name, n):
    return dict(num_slots=S, batch_size=B // n, auc_buckets=AUC_BUCKETS, **SCENARIOS[name][1])


def _feeds(sharded, weights, name, n):
    """Per-step global feeds of a scenario: the sharded arrays, weights
    [n, b] when weighted, labels poisoned at step 2 on rank 1."""
    _, _, _, weighted, poison, _ = SCENARIOS[name]
    out = []
    for i, arrs in enumerate(sharded):
        f = {k: v.copy() for k, v in arrs.items()}
        if weighted:
            f["ins_weight"] = weights[i].reshape(n, -1)
        if poison and i == 2:
            f["labels"][1, 0] = np.nan
        out.append(f)
    return out


def rank_main(plan, in_path: str, out_dir: str) -> None:
    n, r = plan.world, plan.rank
    data = dict(np.load(in_path))
    table = data["table"]
    params0 = {k[2:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("p:")}
    sharded = [{k.split(":")[2]: data[k] for k in data if k.startswith(f"b:{i}:")} for i in range(N_STEPS)]
    model = Tower()

    def apply(p, x, dd):
        return torch.func.functional_call(model, p, (x, dd))

    out = {}
    for name, (worlds, _, zero, _, _, ev) in SCENARIOS.items():
        if n not in worlds:
            continue
        cfg = TrainStepConfig(layout=LAY, sparse_opt=SparseOptimizerConfig(**SPARSE), **_cfg_kw(name, n))
        opt = Zero1Optimizer(Adam(LR), n_dev=n) if zero else Adam(LR)
        st = init_sharded_train_state(
            plan, table, params0, opt, AUC_BUCKETS, local_dense=cfg.dense_sync_mode == "kstep"
        )
        step = make_sharded_train_step(apply, opt, cfg, plan, eval_mode=ev)
        losses, steps = [], []
        plan.reset_calls()
        for f in _feeds(sharded, data["weights"], name, n):
            st, m = step(st, {k: torch.from_numpy(np.ascontiguousarray(v[r])) for k, v in f.items()})
            losses.append(float(m["loss"]))
            steps.append(int(m["step"]))
        out[f"{name}:calls"] = np.array([plan.calls[k] for k in ("all_to_all", "all_reduce", "all_gather")])
        if cfg.dense_sync_mode == "kstep":
            st = kstep_sync_params(st, plan)
        auc = auc_psum(st.auc, plan)
        out[f"{name}:table"] = st.table.numpy()
        out[f"{name}:loss"] = np.array(losses)
        out[f"{name}:step"] = np.array(steps)
        out[f"{name}:pos"], out[f"{name}:neg"] = auc.pos.numpy(), auc.neg.numpy()
        for k, v in st.params.items():
            out[f"{name}:p:{k}"] = v.numpy()
        for k, v in st.opt_state.mu.items():
            out[f"{name}:mu:{k}"] = v.numpy()
            out[f"{name}:nu:{k}"] = st.opt_state.nu[k].numpy()
        out[f"{name}:count"] = st.opt_state.count.numpy()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def _spawn_run(n, tmp_path_factory):
    """(n, inputs, the ranks' results)."""
    d = tmp_path_factory.mktemp(f"mesh_step_{n}")
    inputs = make_inputs(n)
    table, _, _, sharded, weights, jparams = inputs
    arrs = {"table": table, "weights": weights}
    for k, v in jparams.items():
        arrs[f"p:{k}"] = v
    for i, s in enumerate(sharded):
        for k, v in s.items():
            arrs[f"b:{i}:{k}"] = v
    np.savez(d / "in.npz", **arrs)
    spawn(rank_main, n, f"file://{d}/rdv", backend="gloo", device="cpu",
          args=(str(d / "in.npz"), str(d)), threads=1, timeout_s=300)
    return n, inputs, [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _spawn_run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _spawn_run(4, tmp_path_factory)


_JAX_RUNS: dict = {}  # (name, n) -> the JAX run: the convert test reuses the step tests'


def _jax_scenario(name, n, inputs):
    """The JAX package's run of a scenario: (state, losses, steps)."""
    if (name, n) not in _JAX_RUNS:
        _JAX_RUNS[name, n] = _jax_run(name, n, inputs)
    return _JAX_RUNS[name, n]


def _jax_run(name, n, inputs):
    import jax
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.parallel.mesh import put_sharded
    from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table.value_layout import ValueLayout as JLayout
    from paddlebox_tpu.train.sharded_step import init_sharded_train_state as jinit
    from paddlebox_tpu.train.sharded_step import kstep_sync_params as jsync
    from paddlebox_tpu.train.sharded_step import make_sharded_train_step as jmake
    from paddlebox_tpu.train.train_step import TrainStepConfig as JCfg

    table, _, _, sharded, weights, jparams = inputs
    _, _, zero, _, _, ev = SCENARIOS[name]
    plan = make_mesh(n)
    cfg = JCfg(layout=JLayout(embedx_dim=D), sparse_opt=JOpt(**SPARSE), axis_name="dp", **_cfg_kw(name, n))
    opt = JZero(optax.adam(LR), axis_name="dp", n_dev=n) if zero else optax.adam(LR)
    model = JTower()
    st = jinit(plan, table, model.init(), opt, AUC_BUCKETS, local_dense=cfg.dense_sync_mode == "kstep")
    step = jmake(model.apply, opt, cfg, plan, eval_mode=ev)
    losses, steps = [], []
    for f in _feeds(sharded, weights, name, n):
        st, m = step(st, {k: put_sharded(plan, v) for k, v in f.items()})
        losses.append(float(m["loss"]))
        steps.append(int(m["step"]))
    if cfg.dense_sync_mode == "kstep":
        st = jsync(st, plan)
    return jax.tree.map(np.asarray, st), losses, steps


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_step_matches_jax(run2, name):
    _check_scenario(run2, name)


def test_mesh_step_world4_matches_jax(run4):
    _check_scenario(run4, "step")


def _check_scenario(run, name):
    from paddlebox_tpu_torch.models import adam_state_from_optax, params_from_jax

    n, inputs, ranks = run
    jst, jlosses, jsteps = _jax_scenario(name, n, inputs)
    zero, ev, kstep = SCENARIOS[name][2], SCENARIOS[name][5], SCENARIOS[name][1].get("dense_sync_mode") == "kstep"
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{name}:loss"], jlosses, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(res[f"{name}:step"], jsteps)
        np.testing.assert_allclose(res[f"{name}:table"], jst.table[r], rtol=TABLE_RTOL, atol=TABLE_ATOL)
        np.testing.assert_array_equal(res[f"{name}:pos"], jst.auc.pos.sum(axis=0))
        np.testing.assert_array_equal(res[f"{name}:neg"], jst.auc.neg.sum(axis=0))
        jp = jax_tree_rank(jst.params, r) if kstep else jst.params
        for k, v in params_from_jax(jp).items():
            np.testing.assert_allclose(res[f"{name}:p:{k}"], v.numpy(), atol=PARAMS_ATOL, err_msg=k)
        adam = jst.opt_state[0]
        if zero:
            np.testing.assert_allclose(res[f"{name}:mu:flat"], adam.mu[r], rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
            np.testing.assert_allclose(res[f"{name}:nu:flat"], adam.nu[r], rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
            assert int(res[f"{name}:count"]) == int(adam.count[r])
        else:
            pick = (lambda t: jax_tree_rank(t, r)) if kstep else (lambda t: t)
            want = adam_state_from_optax(pick(adam.count) if kstep else adam.count, pick(adam.mu), pick(adam.nu))
            for k, v in want.mu.items():
                np.testing.assert_allclose(res[f"{name}:mu:{k}"], v.numpy(), rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
                np.testing.assert_allclose(res[f"{name}:nu:{k}"], want.nu[k].numpy(), rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
            assert int(res[f"{name}:count"]) == int(want.count)
    if ev:  # eval leaves the table and the dense side bitwise
        table0 = inputs[0]
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["eval:table"], table0[r])
            assert int(res["eval:count"]) == 0
            assert not any(res[k].any() for k in res if k.startswith("eval:mu:"))
    if SCENARIOS[name][4]:
        assert jsteps[2] == jsteps[1]  # the skipped batch does not count


def test_mesh_step_collective_counts(run2):
    """The collectives a scenario's 5 steps issue on each rank (all_to_all,
    all_reduce, all_gather). Every mode routes the same all_to_alls. The
    all_reduces: ``step`` one a step (the grads and the loss in one);
    ``nan`` adds the finiteness flag; kstep reduces the loss a step and
    averages the params on host steps 2 and 4; kstep with ``check_nan``
    reduces the flag, the loss and the params every step, since the
    cadence follows the card's step counter, which a host counter cannot
    follow without a read back."""
    _, _, ranks = run2
    for res in ranks:
        a2a = int(res["step:calls"][0])
        want = {"step": N_STEPS, "nan": 2 * N_STEPS, "kstep": N_STEPS + 2, "kstep_nan": 3 * N_STEPS}
        for name, n_reduce in want.items():
            np.testing.assert_array_equal(res[f"{name}:calls"], [a2a, n_reduce, 0], err_msg=name)
        assert int(res["zero:calls"][2]) == N_STEPS  # ZeRO-1 gathers its chunk updates


def jax_tree_rank(tree, r):
    """Replica ``r`` of a tree whose leaves carry a leading replica axis."""
    import jax

    return jax.tree.map(lambda x: np.asarray(x)[r], tree)


def test_mesh_eval_params_bitwise(run2):
    _, inputs, ranks = run2
    from paddlebox_tpu_torch.models import params_from_jax

    jparams = inputs[5]
    for k, v in params_from_jax(jparams).items():
        for res in ranks:
            np.testing.assert_array_equal(res[f"eval:p:{k}"], v.numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_matches_port_single_device(world, request):
    """The port's world-n mesh against the port's single device on the same
    global batches (the flattened table, ``pack_batch``)."""
    n, inputs, ranks = request.getfixturevalue(f"run{world}")
    table, ws, batches, _, _, jparams = inputs
    from paddlebox_tpu_torch.models import params_from_jax

    model = Tower()
    params = params_from_jax(jparams)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=LAY, sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=AUC_BUCKETS)
    step = make_train_step(lambda p, x, dd: torch.func.functional_call(model, p, (x, dd)), cfg, Adam(LR))
    st = TrainState(
        torch.from_numpy(table.reshape(-1, LAY.width).copy()), params, Adam(LR).init(params),
        auc_init(AUC_BUCKETS, device="cpu"), torch.zeros((), dtype=torch.int32),
    )
    losses = []
    schema = _schema()
    for bt in batches:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in pack_batch(bt, ws, schema, bucket=8).as_dict().items()})
        losses.append(float(m["loss"]))
    mesh_losses = ranks[0]["step:loss"]
    np.testing.assert_allclose(mesh_losses[0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(mesh_losses, losses, rtol=6e-3)
    mesh_table = np.concatenate([res["step:table"] for res in ranks])
    np.testing.assert_allclose(mesh_table, st.table.numpy(), rtol=2e-3, atol=1e-3)
    for k, v in st.params.items():
        np.testing.assert_allclose(ranks[0][f"step:p:{k}"], v.numpy(), atol=3e-2)
    assert int(ranks[0]["step:pos"].sum() + ranks[0]["step:neg"].sum()) == N_STEPS * B
    assert int((st.auc.pos + st.auc.neg).sum()) == N_STEPS * B


def test_convert_carries_jax_mesh_states(run2):
    """``models/convert.py`` carries a JAX mesh state to a rank: the table
    block, kstep's replica (params and moments) and ZeRO-1's chunk, each
    held to the step bounds against the rank's own run; and a ZeRO dense
    file's leaves (JAX's tree-flatten order) round-trip bitwise."""
    import jax

    from paddlebox_tpu_torch.models.convert import (
        dense_from_jax_leaves,
        dense_to_jax_leaves,
        mesh_kstep_replica,
        mesh_table_block,
        mesh_zero_chunk,
        params_from_jax,
    )

    n, inputs, ranks = run2
    kst, _, _ = _jax_scenario("kstep", n, inputs)
    zst, _, _ = _jax_scenario("zero", n, inputs)
    kadam, zadam = kst.opt_state[0], zst.opt_state[0]
    leaves = [np.asarray(x) for x in jax.tree.flatten((zst.params, zst.opt_state))[0]]
    like = params_from_jax(inputs[5])
    params, stacked = dense_from_jax_leaves(leaves, like, torch.device("cpu"))
    assert [a.tobytes() for a in dense_to_jax_leaves(params, stacked)] == [a.tobytes() for a in leaves]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(mesh_table_block(kst.table, r).numpy(), kst.table[r])
        p, adam = mesh_kstep_replica(kst.params, kadam.count, kadam.mu, kadam.nu, r)
        for k, v in p.items():
            np.testing.assert_allclose(res[f"kstep:p:{k}"], v.numpy(), atol=PARAMS_ATOL)
            np.testing.assert_allclose(res[f"kstep:mu:{k}"], adam.mu[k].numpy(), rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
        chunk = mesh_zero_chunk(zadam.count, zadam.mu, zadam.nu, r)
        assert torch.equal(chunk.mu["flat"], Zero1Optimizer.local_state(stacked, r).mu["flat"])
        np.testing.assert_allclose(res["zero:nu:flat"], chunk.nu["flat"].numpy(), rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
        assert int(chunk.count) == int(res["zero:count"])
