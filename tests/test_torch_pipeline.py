"""The port's pipeline (``parallel/pipeline.py``, ``MeshPlan.shift``,
``make_mesh_2d``) against the JAX package's ``parallel/pipeline.py``.

The JAX side runs on the suite's 8 virtual CPU devices, the port's in two
gloo worlds of 4 ranks on the CPU, each spawned once for the module: a
1-D ``pp = 4`` world and a ``2 x 2`` (pp x dp) world. The stages are the
JAX functions' (``mlp_stage_init``, ``hetero_mlp_stage_init`` from a
``PRNGKey``) and reach the ranks through ``models/convert.py``'s
``pipeline_stage_from_jax`` with the JAX initial optimizer state, plain
Adam or ZeRO-1's chunks; the ranks write their results to ``.npz`` files.
Every case of ``tests/test_pipeline.py`` and ``tests/test_pipeline_hetero.py``
is held here with their bounds:

- forward: rtol / atol 2e-5, and ``broadcast=True`` bitwise equal on
  every rank;
- one train step: loss rtol 2e-5, params rtol 5e-4 / atol 5e-5, then the
  loss falls over 50 more steps; the heterogeneous stages: 5 steps, loss
  rtol 5e-5, the padding exactly 0 and the gates untouched;
- the stage-count, ZeRO-without-dp and chain-mismatch guards;
- ``pp x dp`` against the 1-D pipeline on the same global data;
- ZeRO-1 against plain Adam over 3 steps, rtol 1e-6 (atol 1e-7 on the
  params).

Besides: a step's collectives on every rank (``MeshPlan.calls``),
``make_mesh_2d``'s placement and refusals, and a broadcast on a dp row
that does not hold global rank 0.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.fleet import Zero1Optimizer
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.models.convert import pipeline_stage_from_jax, pipeline_state_to_jax
from paddlebox_tpu_torch.parallel import (
    MeshPlan,
    PipelineSpec,
    hetero_mlp_stage_apply,
    hetero_mlp_stage_init,
    init_pipeline_state,
    make_mesh,
    make_mesh_2d,
    make_pipeline_train_step,
    pipeline_forward,
)
from paddlebox_tpu_torch.parallel.pipeline import mlp_stage_apply
from paddlebox_tpu_torch.train import Adam

torch.set_num_threads(2)

# tests/test_pipeline.py's shapes
N_STAGES, HID, MB, M = 4, 16, 8, 6
# tests/test_pipeline_hetero.py's: 4 stages of other widths and depths, H = 16, L = 3
WIDTHS = [[6, 10, 16], [16, 12], [12, 9, 14, 12], [12, 8]]
WIDTHS2 = [[6, 10, 16], [16, 12, 8]]
D_IN, D_OUT, H = 6, 8, 16
HMB, HM = 4, 6
LR = 1e-2
MORE_STEPS, DP_MORE_STEPS, HETERO_STEPS, ZERO_STEPS = 50, 20, 5, 3
FWD_TOL = 2e-5
LOSS_RTOL, HETERO_LOSS_RTOL = 2e-5, 5e-5
PARAMS_RTOL, PARAMS_ATOL = 5e-4, 5e-5
ZERO_RTOL, ZERO_ATOL = 1e-6, 1e-7


def mse(y, tgt):
    return ((y - tgt) ** 2).mean()


def mse_out(y, tgt):
    return ((y[..., :D_OUT] - tgt) ** 2).mean()


def _spec(m=M):
    return PipelineSpec(n_micro=m, axis_name="pp")


# ---- the numpy inputs ---------------------------------------------------------


def _put(out, tag, params, count, mu, nu):
    """A JAX pipeline state (stacked, numpy) into ``out`` under ``tag``."""
    for k in params:
        out[f"{tag}:p:{k}"] = params[k]
    out[f"{tag}:count"] = count
    if isinstance(mu, dict):
        for k in mu:
            out[f"{tag}:mu:{k}"], out[f"{tag}:nu:{k}"] = mu[k], nu[k]
    else:
        out[f"{tag}:mu"], out[f"{tag}:nu"] = mu, nu


def _get(data, tag):
    """(params, count, mu, nu) under ``tag``, as :func:`_put` wrote them."""
    params = {k.split(":")[2]: data[k] for k in data if k.startswith(f"{tag}:p:")}
    if f"{tag}:mu" in data:
        return params, data[f"{tag}:count"], data[f"{tag}:mu"], data[f"{tag}:nu"]
    mu = {k.split(":")[2]: data[k] for k in data if k.startswith(f"{tag}:mu:")}
    nu = {k.split(":")[2]: data[k] for k in data if k.startswith(f"{tag}:nu:")}
    return params, data[f"{tag}:count"], mu, nu


def _jax_state(stages, opt, n_pp, n_dp=None):
    """The JAX package's ``init_pipeline_state`` of ``stages`` as numpy
    (params, count, mu, nu)."""
    import jax

    from paddlebox_tpu.parallel import init_pipeline_state as jinit
    from paddlebox_tpu.parallel.mesh import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import make_mesh_2d as jmesh2

    if n_dp is None:
        st = jinit(jmesh(n_pp, axis="pp"), stages, opt)
    else:
        st = jinit(jmesh2(n_pp, n_dp), stages, opt, axis="pp", dp_axis="dp" if n_dp and _is_jzero(opt) else None)
    params, adam = jax.tree.map(np.asarray, st[0]), jax.tree.map(np.asarray, st[1][0])
    return params, adam.count, adam.mu, adam.nu


def _is_jzero(opt):
    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero

    return isinstance(opt, JZero)


def make_inputs():
    """Every case's stages, initial state and data, from the JAX
    functions and numpy seeds: (the arrays for the ranks, the JAX stages)."""
    import jax
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel.pipeline import hetero_mlp_stage_init as jhetero
    from paddlebox_tpu.parallel.pipeline import mlp_stage_init as jmlp

    adam = optax.adam(LR)
    out, jstages = {}, {}
    jstages["u4"] = jmlp(jax.random.PRNGKey(0), HID, layers_per_stage=2, n_stages=N_STAGES)
    jstages["z2"] = jmlp(jax.random.PRNGKey(5), HID, layers_per_stage=2, n_stages=2)
    jstages["d2"] = jmlp(jax.random.PRNGKey(3), HID, layers_per_stage=2, n_stages=2)
    jstages["h4"], raw = jhetero(jax.random.PRNGKey(7), WIDTHS)
    jstages["hd2"], _ = jhetero(jax.random.PRNGKey(9), WIDTHS2)
    for tag, n in (("u4", N_STAGES), ("d2", 2), ("h4", N_STAGES), ("hd2", 2)):
        _put(out, tag, *_jax_state(jstages[tag], adam, n))
    _put(out, "z2", *_jax_state(jstages["z2"], adam, 2))
    _put(out, "z2zero", *_jax_state(jstages["z2"], JZero(optax.adam(LR), axis_name="dp", n_dev=2), 2, 2))
    for s, layers in enumerate(raw):
        for l, (w, b) in enumerate(layers):
            out[f"raw:{s}:{l}:w"], out[f"raw:{s}:{l}:b"] = w, b
    rng = np.random.default_rng(0)
    out["fwd:x"] = rng.normal(size=(M, MB, HID)).astype(np.float32)
    rng = np.random.default_rng(1)
    out["train:x"] = rng.normal(size=(M, MB, HID)).astype(np.float32)
    out["train:t"] = np.tanh(rng.normal(size=(M, MB, HID))).astype(np.float32)
    rng = np.random.default_rng(4)
    out["zero:x"] = rng.normal(size=(M, MB, HID)).astype(np.float32)
    out["zero:t"] = np.tanh(rng.normal(size=(M, MB, HID))).astype(np.float32)
    rng = np.random.default_rng(2)
    out["dp:x"] = rng.normal(size=(M, MB, HID)).astype(np.float32)
    out["dp:t"] = np.tanh(rng.normal(size=(M, MB, HID))).astype(np.float32)
    rng = np.random.default_rng(0)
    out["hfwd:x"] = _pad(rng.normal(size=(HM, HMB, D_IN)).astype(np.float32))
    rng = np.random.default_rng(1)
    out["htrain:x"] = _pad(rng.normal(size=(HM, HMB, D_IN)).astype(np.float32))
    out["htrain:t"] = np.tanh(rng.normal(size=(HM, HMB, D_OUT))).astype(np.float32)
    rng = np.random.default_rng(2)
    out["hdp:x"] = _pad(rng.normal(size=(HM, HMB, D_IN)).astype(np.float32))
    out["hdp:t"] = np.tanh(rng.normal(size=(HM, HMB, D_OUT))).astype(np.float32)
    return out, jstages


def _pad(x):
    return np.pad(x, ((0, 0), (0, 0), (0, H - x.shape[-1])))


# ---- the ranks ------------------------------------------------------------------


def _stage(data, tag, pp_rank, dp_rank=None):
    """This rank's (params, state), carried from the JAX state."""
    return pipeline_stage_from_jax(*_get(data, tag), pp_rank, chunk=dp_rank)


def _save_state(out, tag, state):
    params, opt = state
    for k, v in params.items():
        out[f"{tag}:p:{k}"] = v.numpy()
    out[f"{tag}:count"] = opt.count.numpy()
    for k in opt.mu:
        out[f"{tag}:mu:{k}"], out[f"{tag}:nu:{k}"] = opt.mu[k].numpy(), opt.nu[k].numpy()


def _t(data, key):
    return torch.from_numpy(data[key])


def _calls(plan):
    return np.array([plan.calls[k] for k in ("shift", "all_reduce", "all_gather", "all_to_all", "broadcast")])


def _run(step, state, x, t, n, plans, out=None, tag=None):
    """``n`` steps; the losses, and a step's collectives on ``plans``."""
    losses = []
    for i in range(n):
        for p in plans:
            p.reset_calls()
        state, loss = step(state, x, t)
        losses.append(float(loss))
        if i == 0 and out is not None:
            out[f"{tag}:calls"] = np.stack([_calls(p) for p in plans])
            out[f"{tag}:loss_0d"] = np.array(loss.dim() == 0)
    return state, np.array(losses)


def rank_pp4(plan, in_path, out_dir):
    """The 1-D world: pp = 4 over the whole group."""
    data = dict(np.load(in_path))
    pp = make_mesh(plan.backend, device=plan.device, axis="pp")
    r, out = pp.rank, {}
    # forward, broadcast to every rank
    params, _ = _stage(data, "u4", r)
    out["fwd"] = pipeline_forward(mlp_stage_apply, _spec())(pp, params, _t(data, "fwd:x")).numpy()
    # one step, then MORE_STEPS more
    st = (params, _stage(data, "u4", r)[1])
    step = make_pipeline_train_step(mlp_stage_apply, mse, Adam(LR), _spec(), pp)
    st, l1 = _run(step, st, _t(data, "train:x"), _t(data, "train:t"), 1, [pp], out, "train")
    _save_state(out, "train1", st)
    _, more = _run(step, st, _t(data, "train:x"), _t(data, "train:t"), MORE_STEPS, [pp])
    out["train:losses"] = np.concatenate([l1, more])
    # the heterogeneous stages: forward, and HETERO_STEPS steps
    hp, hopt = _stage(data, "h4", r)
    out["hfwd"] = pipeline_forward(hetero_mlp_stage_apply, _spec(HM))(pp, hp, _t(data, "hfwd:x")).numpy()
    hstep = make_pipeline_train_step(hetero_mlp_stage_apply, mse_out, Adam(LR), _spec(HM), pp)
    st, out["htrain:losses"] = _run(hstep, (hp, hopt), _t(data, "htrain:x"), _t(data, "htrain:t"), HETERO_STEPS,
                                    [pp], out, "htrain")
    _save_state(out, "htrain", st)
    np.savez(os.path.join(out_dir, f"pp4_rank{r}.npz"), **out)


def rank_2x2(plan, in_path, out_dir):
    """The 2-D world: pp = 2 x dp = 2."""
    data = dict(np.load(in_path))
    mesh = make_mesh_2d(2, 2, backend=plan.backend, device=plan.device)
    pp, dp = mesh.along("pp"), mesh.along("dp")
    r, out = mesh.rank, {}
    out["place"] = np.array([pp.rank, pp.world, dp.rank, dp.world])
    out["axes"] = np.array([mesh.axis, *mesh.axis_names])
    # a broadcast on each dp row, from each position of the row
    out["bcast"] = np.array([float(dp.broadcast(torch.tensor([float(r)]), src=s)) for s in range(2)])
    for tag, apply, loss_fn, m in (("d2", mlp_stage_apply, mse, M), ("hd2", hetero_mlp_stage_apply, mse_out, HM)):
        key = "dp" if tag == "d2" else "hdp"
        x, t = _t(data, f"{key}:x"), _t(data, f"{key}:t")
        # the 1-D pipeline on this rank's column, every column alike
        step1 = make_pipeline_train_step(apply, loss_fn, Adam(LR), _spec(m), mesh)
        st1, _ = _run(step1, _stage(data, tag, pp.rank), x, t, 1, [pp, dp])
        _save_state(out, f"{tag}:1d", st1)
        step2 = make_pipeline_train_step(apply, loss_fn, Adam(LR), _spec(m), mesh, dp_axis="dp")
        st2, l2 = _run(step2, _stage(data, tag, pp.rank), x, t, 1, [pp, dp], out, f"{tag}:2d")
        _save_state(out, f"{tag}:2d", st2)
        out[f"{tag}:2d:loss"] = l2
        if tag == "d2":
            _, out["d2:2d:more"] = _run(step2, st2, x, t, DP_MORE_STEPS, [pp, dp])
    # ZeRO-1 over dp against plain Adam, ZERO_STEPS steps each
    x, t = _t(data, "zero:x"), _t(data, "zero:t")
    plain = make_pipeline_train_step(mlp_stage_apply, mse, Adam(LR), _spec(), mesh, dp_axis="dp")
    st, out["zero:plain:losses"] = _run(plain, _stage(data, "z2", pp.rank), x, t, ZERO_STEPS, [pp, dp])
    _save_state(out, "zero:plain", st)
    zopt = Zero1Optimizer(Adam(LR), axis_name="dp", n_dev=2)
    zstep = make_pipeline_train_step(mlp_stage_apply, mse, zopt, _spec(), mesh, dp_axis="dp")
    zst = _stage(data, "z2zero", pp.rank, dp.rank)
    ref = init_pipeline_state(mesh, [_stage(data, "z2", p)[0] for p in range(2)], zopt, axis="pp", dp_axis="dp")
    out["zero:init_same"] = np.array(torch.equal(ref[1].mu["flat"], zst[1].mu["flat"])
                                     and torch.equal(ref[1].count, zst[1].count))
    st, out["zero:zero:losses"] = _run(zstep, zst, x, t, ZERO_STEPS, [pp, dp], out, "zero:zero")
    _save_state(out, "zero:zero", st)
    np.savez(os.path.join(out_dir, f"2x2_rank{r}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs, the JAX stages, the pp4 ranks' results, the 2x2 ranks')."""
    d = tmp_path_factory.mktemp("pipeline")
    data, jstages = make_inputs()
    np.savez(d / "in.npz", **data)
    for name, fn in (("pp4", rank_pp4), ("2x2", rank_2x2)):
        spawn(fn, 4, f"file://{d}/rdv-{name}", backend="gloo", device="cpu",
              args=(str(d / "in.npz"), str(d)), threads=1, timeout_s=120)
    load = lambda name: [dict(np.load(d / f"{name}_rank{r}.npz")) for r in range(4)]
    return data, jstages, load("pp4"), load("2x2")


# ---- the JAX side -----------------------------------------------------------------


_JAX: dict = {}


def _jax_steps(tag, stages, apply, loss_fn, x, t, m, n_steps, mesh="1d", zero=False):
    """The JAX package's step over ``n_steps``: (stacked params, losses, optax Adam state)."""
    key = (tag, mesh, zero, n_steps)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import PipelineSpec as JSpec
    from paddlebox_tpu.parallel import init_pipeline_state as jinit
    from paddlebox_tpu.parallel import make_pipeline_train_step as jmake
    from paddlebox_tpu.parallel.mesh import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import make_mesh_2d as jmesh2

    n = len(stages)
    opt = JZero(optax.adam(LR), axis_name="dp", n_dev=2) if zero else optax.adam(LR)
    spec = JSpec(n_micro=m, axis_name="pp")
    if mesh == "1d":
        plan = jmesh(n, axis="pp")
        step, st = jmake(apply, loss_fn, opt, spec, plan), jinit(plan, stages, opt)
    else:
        plan = jmesh2(n, 2)
        step = jmake(apply, loss_fn, opt, spec, plan, dp_axis="dp")
        st = jinit(plan, stages, opt, axis="pp", dp_axis="dp" if zero else None)
    losses = []
    for _ in range(n_steps):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(t))
        losses.append(float(loss))
    _JAX[key] = (jax.tree.map(np.asarray, st[0]), np.array(losses), jax.tree.map(np.asarray, st[1][0]))
    return _JAX[key]


def _jfns():
    import jax.numpy as jnp

    from paddlebox_tpu.parallel import hetero_mlp_stage_apply as jhapply
    from paddlebox_tpu.parallel.pipeline import mlp_stage_apply as japply

    return {
        "mlp": japply,
        "hetero": jhapply,
        "mse": lambda y, t: jnp.mean((y - t) ** 2),
        "mse_out": lambda y, t: jnp.mean((y[..., :D_OUT] - t) ** 2),
    }


def _jax_forward(stages, apply, x, m):
    import jax
    from jax.sharding import PartitionSpec as P

    from paddlebox_tpu.parallel import PipelineSpec as JSpec
    from paddlebox_tpu.parallel import pipeline_forward as jfwd
    from paddlebox_tpu.parallel.mesh import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import shard_map

    plan = jmesh(len(stages), axis="pp")
    fwd = jfwd(apply, JSpec(n_micro=m, axis_name="pp"))
    stacked = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *stages)
    mapped = jax.jit(shard_map(
        lambda p, xm: fwd(jax.tree.map(lambda a: a[0], p), xm), mesh=plan.mesh,
        in_specs=(jax.tree.map(lambda _: P("pp"), stacked), P()), out_specs=P(), check_vma=False,
    ))
    return np.asarray(mapped(jax.device_put(stacked, plan.batch_sharding), x))


def _stage_params(res, tag):
    return {k.split(":")[-1]: res[k] for k in res if k.startswith(f"{tag}:p:")}


def _assert_stages_close(ranks, tag, stacked, rtol=PARAMS_RTOL, atol=PARAMS_ATOL, stage_of=lambda r: r):
    for r, res in enumerate(ranks):
        got = _stage_params(res, tag)
        assert set(got) == set(stacked)
        for k, v in got.items():
            np.testing.assert_allclose(v, stacked[k][stage_of(r)], rtol=rtol, atol=atol, err_msg=f"rank {r} {k}")


# ---- tests/test_pipeline.py ---------------------------------------------------------


def test_pipeline_forward_matches_jax(runs):
    """The forward against the JAX pipeline and the sequential stages; the
    broadcast output bitwise on every rank."""
    import jax

    data, jstages, pp4, _ = runs
    f = _jfns()
    want = _jax_forward(jstages["u4"], f["mlp"], data["fwd:x"], M)
    seq = np.asarray(jax.vmap(lambda xx: _jseq(jstages["u4"], f["mlp"], xx))(data["fwd:x"]))
    for res in pp4:
        assert res["fwd"].tobytes() == pp4[0]["fwd"].tobytes()
    np.testing.assert_allclose(pp4[0]["fwd"], want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pp4[0]["fwd"], seq, rtol=FWD_TOL, atol=FWD_TOL)


def _jseq(stages, apply, x):
    for sp in stages:
        x = apply(sp, x)
    return x


def test_pipeline_train_matches_jax(runs):
    """One step: the loss and each stage's params against the JAX step;
    then the loss falls over 50 more steps, as the JAX test asks."""
    data, jstages, pp4, _ = runs
    f = _jfns()
    jparams, jl, _ = _jax_steps("u4", jstages["u4"], f["mlp"], f["mse"], data["train:x"], data["train:t"], M, 1)
    for res in pp4:
        np.testing.assert_allclose(res["train:losses"][0], jl[0], rtol=LOSS_RTOL)
        assert res["train:losses"].tobytes() == pp4[0]["train:losses"].tobytes()
    _assert_stages_close(pp4, "train1", jparams)
    losses = pp4[0]["train:losses"]
    assert len(losses) == 1 + MORE_STEPS
    assert losses[-1] < 0.85 * losses[0]
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_pipeline_stage_count_mismatch():
    """``init_pipeline_state`` refuses a stage list of the wrong length in
    both packages."""
    import jax
    import optax

    from paddlebox_tpu.parallel import init_pipeline_state as jinit
    from paddlebox_tpu.parallel.mesh import make_mesh as jmesh
    from paddlebox_tpu.parallel.pipeline import mlp_stage_init as jmlp
    from paddlebox_tpu_torch.parallel.pipeline import mlp_stage_init

    jst = jmlp(jax.random.PRNGKey(0), HID, layers_per_stage=2, n_stages=N_STAGES)
    with pytest.raises(ValueError, match="stages"):
        jinit(jmesh(N_STAGES, axis="pp"), jst[:2], optax.sgd(0.1))
    st = mlp_stage_init(torch.Generator().manual_seed(0), HID, 2, N_STAGES)
    plan = MeshPlan(rank=0, world=N_STAGES, device=torch.device("cpu"), backend="gloo", axis="pp")
    with pytest.raises(ValueError, match="2 stages for a 4-stage 'pp' axis"):
        init_pipeline_state(plan, st[:2], Adam(0.1))


def test_pipeline_composes_with_zero1_sharding(runs):
    """pp x dp + ZeRO-1 over dp: each rank holds its (stage, chunk)'s
    moments, and 3 steps stay within rtol 1e-6 of plain Adam; both against
    the JAX runs; ZeRO without a dp axis is refused in both packages."""
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import PipelineSpec as JSpec
    from paddlebox_tpu.parallel import make_pipeline_train_step as jmake
    from paddlebox_tpu.parallel.mesh import make_mesh as jmesh

    data, jstages, _, r2 = runs
    f = _jfns()
    for r, res in enumerate(r2):
        assert bool(res["zero:init_same"])
        np.testing.assert_allclose(res["zero:zero:losses"], res["zero:plain:losses"], rtol=ZERO_RTOL, atol=0)
        for k, v in _stage_params(res, "zero:zero").items():
            np.testing.assert_allclose(v, res[f"zero:plain:p:{k}"], rtol=ZERO_RTOL, atol=ZERO_ATOL)
        # the chunk's moments: half of the stage's raveled params, padded
        n = sum(v.size for v in _stage_params(res, "zero:plain").values())
        assert res["zero:zero:mu:flat"].shape == (-(-n // 2),)
    jz = _jax_steps("z2", jstages["z2"], f["mlp"], f["mse"], data["zero:x"], data["zero:t"], M, ZERO_STEPS, "2d", True)
    jp = _jax_steps("z2", jstages["z2"], f["mlp"], f["mse"], data["zero:x"], data["zero:t"], M, ZERO_STEPS, "2d")
    np.testing.assert_allclose(jz[1], jp[1], rtol=ZERO_RTOL)
    np.testing.assert_allclose(r2[0]["zero:zero:losses"], jz[1], rtol=LOSS_RTOL)
    _assert_stages_close(r2, "zero:zero", jz[0], stage_of=lambda r: r // 2)
    # the port's chunk states, stacked back, are the JAX ZeRO state
    back = pipeline_state_to_jax([
        ({k: torch.from_numpy(v) for k, v in _stage_params(r2[2 * p], "zero:zero").items()},
         [_chunk(r2[2 * p + d], "zero:zero") for d in range(2)])
        for p in range(2)
    ])
    np.testing.assert_array_equal(back[1], jz[2].count)
    np.testing.assert_allclose(back[2], jz[2].mu, rtol=5e-2, atol=1e-6)
    spec = _spec()
    with pytest.raises(ValueError, match="dp axis|dp_axis"):
        jmake(f["mlp"], f["mse"], JZero(optax.adam(LR), axis_name="dp", n_dev=2), JSpec(n_micro=M), jmesh(2, axis="pp"))
    plan1 = MeshPlan(rank=0, world=2, device=torch.device("cpu"), backend="gloo", axis="pp")
    with pytest.raises(ValueError, match="dp axis|dp_axis"):
        make_pipeline_train_step(mlp_stage_apply, mse, Zero1Optimizer(Adam(LR), n_dev=2), spec, plan1)


def _chunk(res, tag):
    from paddlebox_tpu_torch.train.dense_opt import AdamState

    return AdamState(count=torch.from_numpy(res[f"{tag}:count"]), mu={"flat": torch.from_numpy(res[f"{tag}:mu:flat"])},
                     nu={"flat": torch.from_numpy(res[f"{tag}:nu:flat"])})


def test_pipeline_composes_with_dp(runs):
    """pp x dp: one step equals the 1-D pipeline over the same global data
    (the port's column run and the JAX 1-D run), the JAX 2-D run too; and it
    trains."""
    data, jstages, _, r2 = runs
    f = _jfns()
    j1 = _jax_steps("d2", jstages["d2"], f["mlp"], f["mse"], data["dp:x"], data["dp:t"], M, 1)
    j2 = _jax_steps("d2", jstages["d2"], f["mlp"], f["mse"], data["dp:x"], data["dp:t"], M, 1, "2d")
    for res in r2:
        np.testing.assert_allclose(res["d2:2d:loss"][0], j1[1][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["d2:2d:loss"][0], j2[1][0], rtol=LOSS_RTOL)
        for k, v in _stage_params(res, "d2:2d").items():
            np.testing.assert_allclose(v, res[f"d2:1d:p:{k}"], rtol=PARAMS_RTOL, atol=PARAMS_ATOL)
        assert res["d2:2d:more"][-1] < res["d2:2d:loss"][0]
    _assert_stages_close(r2, "d2:2d", j1[0], stage_of=lambda r: r // 2)
    _assert_stages_close(r2, "d2:1d", j1[0], stage_of=lambda r: r // 2)


# ---- tests/test_pipeline_hetero.py ---------------------------------------------------


def test_chain_mismatch_rejected():
    import jax

    from paddlebox_tpu.parallel import hetero_mlp_stage_init as jhetero

    with pytest.raises(ValueError, match="emits width"):
        jhetero(jax.random.PRNGKey(0), [[4, 8], [6, 4]])
    with pytest.raises(ValueError, match="stage 0 emits width 8 but stage 1 consumes 6"):
        hetero_mlp_stage_init(torch.Generator().manual_seed(0), [[4, 8], [6, 4]])


def test_hetero_init_pads_as_jax():
    """The port's padded stages have the JAX functions' shapes, gates and
    zero padding; one seed gives the same layers however the net is cut."""
    stages, raw = hetero_mlp_stage_init(torch.Generator().manual_seed(3), WIDTHS)
    for s, ws in enumerate(WIDTHS):
        assert stages[s]["w"].shape == (3, H, H) and stages[s]["b"].shape == (3, H)
        assert stages[s]["g"].tolist() == [1.0] * (len(ws) - 1) + [0.0] * (4 - len(ws))
        for l, (w, b) in enumerate(raw[s]):
            pad = stages[s]["w"][l].clone()
            assert torch.equal(pad[: w.shape[0], : w.shape[1]], torch.from_numpy(w))
            pad[: w.shape[0], : w.shape[1]] = 0.0
            assert not pad.any() and not stages[s]["b"][l].any()
    whole = [[6, 10, 16, 12, 9, 14, 12, 8]]
    _, raw1 = hetero_mlp_stage_init(torch.Generator().manual_seed(3), whole)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(raw1[0], [lw for ls in raw for lw in ls]))


def test_hetero_forward_matches_jax(runs):
    data, jstages, pp4, _ = runs
    f = _jfns()
    want = _jax_forward(jstages["h4"], f["hetero"], data["hfwd:x"], HM)
    got = pp4[0]["hfwd"]
    for res in pp4:
        assert res["hfwd"].tobytes() == got.tobytes()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # real lanes match the unpadded net; padded lanes are exactly zero
    np.testing.assert_allclose(got[..., :D_OUT], _unpadded(data, data["hfwd:x"][..., :D_IN]), rtol=FWD_TOL, atol=FWD_TOL)
    assert np.all(got[..., D_OUT:] == 0.0)


def _raw(data):
    return [[(torch.tensor(data[f"raw:{s}:{l}:w"]), torch.tensor(data[f"raw:{s}:{l}:b"]))
             for l in range(len(ws) - 1)] for s, ws in enumerate(WIDTHS)]


def _seq(layers, x):
    for ls in layers:
        for w, b in ls:
            x = torch.relu(x @ w + b)
    return x


def _unpadded(data, x):
    with torch.no_grad():
        return _seq(_raw(data), torch.tensor(x)).numpy()


def test_hetero_training_matches_jax(runs):
    """5 Adam steps: each step's loss against the JAX pipeline's and the
    unpadded network's (the port's Adam on the unpadded layers), the params
    against both, the padding exactly 0 and the gates untouched."""
    data, jstages, pp4, _ = runs
    f = _jfns()
    x, t = data["htrain:x"], data["htrain:t"]
    jparams, jl, _ = _jax_steps("h4", jstages["h4"], f["hetero"], f["mse_out"], x, t, HM, HETERO_STEPS)
    ref = [[(w.clone().requires_grad_(True), b.clone().requires_grad_(True)) for w, b in ls] for ls in _raw(data)]
    flat = {f"{s}:{l}:{i}": v for s, ls in enumerate(ref) for l, wb in enumerate(ls) for i, v in enumerate(wb)}
    opt = Adam(LR)
    ost = opt.init({k: v.detach() for k, v in flat.items()})
    xt, tt = torch.tensor(x[..., :D_IN]), torch.tensor(t)
    ref_losses = []
    for _ in range(HETERO_STEPS):
        loss = torch.stack([mse(_seq(ref, xt[i]), tt[i]) for i in range(HM)]).mean()
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        upd, ost = opt.update(grads, ost)
        with torch.no_grad():
            for k, v in flat.items():
                v += upd[k]
        ref_losses.append(float(loss.detach()))
    for res in pp4:
        np.testing.assert_allclose(res["htrain:losses"], jl, rtol=HETERO_LOSS_RTOL)
        np.testing.assert_allclose(res["htrain:losses"], ref_losses, rtol=HETERO_LOSS_RTOL)
    _assert_stages_close(pp4, "htrain", jparams)
    for s, ws in enumerate(WIDTHS):
        got = _stage_params(pp4[s], "htrain")
        for l in range(len(ws) - 1):
            d_in, d_out = ws[l], ws[l + 1]
            w, b = ref[s][l]
            np.testing.assert_allclose(got["w"][l, :d_in, :d_out], w.detach().numpy(), rtol=PARAMS_RTOL,
                                       atol=PARAMS_ATOL)
            np.testing.assert_allclose(got["b"][l, :d_out], b.detach().numpy(), rtol=PARAMS_RTOL, atol=PARAMS_ATOL)
            assert np.all(got["w"][l, d_in:, :] == 0.0) and np.all(got["w"][l, :, d_out:] == 0.0)
            assert np.all(got["b"][l, d_out:] == 0.0)
        assert got["g"].tolist() == [1.0] * (len(ws) - 1) + [0.0] * (4 - len(ws))
        assert np.all(pp4[s]["htrain:mu:g"] == 0.0)


def test_hetero_composes_with_dp(runs):
    """pp x dp with heterogeneous stages: one step equals the 1-D runs."""
    data, jstages, _, r2 = runs
    f = _jfns()
    x, t = data["hdp:x"], data["hdp:t"]
    j1 = _jax_steps("hd2", jstages["hd2"], f["hetero"], f["mse_out"], x, t, HM, 1)
    for res in r2:
        np.testing.assert_allclose(res["hd2:2d:loss"][0], j1[1][0], rtol=LOSS_RTOL)
        for k, v in _stage_params(res, "hd2:2d").items():
            np.testing.assert_allclose(v, res[f"hd2:1d:p:{k}"], rtol=PARAMS_RTOL, atol=PARAMS_ATOL)
    _assert_stages_close(r2, "hd2:2d", j1[0], stage_of=lambda r: r // 2)


# ---- the port's own: collectives, the 2-D mesh, the subgroup broadcast ----------------


def test_step_collectives_are_the_same_on_every_rank(runs):
    """A step runs ``M + n - 2`` shifts forward and as many backward (the
    last tick's hop is dropped), one all-reduce of the loss over pp, one of
    the grads and the loss over dp on a 2-D mesh, and ZeRO's all-gather:
    the same on every rank, so no rank waits on a collective its peers
    skip."""
    _, _, pp4, r2 = runs
    cols = ("shift", "all_reduce", "all_gather", "all_to_all", "broadcast")
    want = {
        ("pp4", "train"): [[2 * (M + N_STAGES - 2), 1, 0, 0, 0]],
        ("pp4", "htrain"): [[2 * (HM + N_STAGES - 2), 1, 0, 0, 0]],
        ("2x2", "d2:2d"): [[2 * (M + 2 - 2), 1, 0, 0, 0], [0, 1, 0, 0, 0]],
        ("2x2", "hd2:2d"): [[2 * (HM + 2 - 2), 1, 0, 0, 0], [0, 1, 0, 0, 0]],
        ("2x2", "zero:zero"): [[2 * (M + 2 - 2), 1, 0, 0, 0], [0, 1, 1, 0, 0]],
    }
    for (world, tag), rows in want.items():
        for r, res in enumerate(pp4 if world == "pp4" else r2):
            assert res[f"{tag}:calls"].tolist() == rows, (world, tag, r, cols)
            assert bool(res[f"{tag}:loss_0d"])


def test_make_mesh_2d_places_and_refuses(runs):
    """Rank r sits at (r // n_dp, r % n_dp), the plan's axis is dp; a world
    of the wrong size, or an axis under 1, is refused before any group."""
    _, _, _, r2 = runs
    for r, res in enumerate(r2):
        assert res["place"].tolist() == [r // 2, 2, r % 2, 2]
        assert res["axes"].tolist() == ["dp", "pp", "dp"]
    with pytest.raises(ValueError, match="asked for 6 ranks"):
        make_mesh_2d(3, 2, backend="gloo", device="cpu", rank=0, world=4, init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="n_pp >= 1 and n_dp >= 1"):
        make_mesh_2d(0, 4, backend="gloo", device="cpu", rank=0, world=4)
    plan = MeshPlan(rank=0, world=2, device=torch.device("cpu"), backend="gloo", axis="pp")
    assert plan.axis_names == ("pp",) and plan.along("pp") is plan
    with pytest.raises(ValueError, match="not an axis"):
        plan.along("dp")
    with pytest.raises(ValueError, match="not a mesh axis"):
        make_pipeline_train_step(mlp_stage_apply, mse, Adam(LR), PipelineSpec(n_micro=M, axis_name="stage"), plan)


def test_subgroup_broadcast_maps_its_source(runs):
    """A dp row's broadcast from its position ``src`` gives that rank's
    tensor: on the row of global ranks 2 and 3 too, which holds no global
    rank 0."""
    _, _, _, r2 = runs
    for r, res in enumerate(r2):
        row = r // 2
        assert res["bcast"].tolist() == [2.0 * row, 2.0 * row + 1]
