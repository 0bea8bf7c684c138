"""The port's fleet tier against the JAX package's: the role maker over the
environment dialects of ``tests/test_fleet.py`` (its ``JAX_*`` names mapped
to torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` + ``MASTER_PORT``),
each malformed variable named in its error; ``DistributedStrategy``'s
translation and its pipeline flag; ``models/convert.py``'s pipeline state
both ways; the ZeRO-1 chunks of a params tree bitwise the JAX package's
``_chunks`` (the same ravel order and padding), and ``make_mesh``'s
refusals. No ranks are spawned: nothing here runs a collective.
"""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.fleet import DistributedStrategy, RoleMaker, Zero1Optimizer, init_distributed
from paddlebox_tpu_torch.fleet.zero import jax_order, ravel, unravel
from paddlebox_tpu_torch.parallel import make_mesh
from paddlebox_tpu_torch.table import ValueLayout
from paddlebox_tpu_torch.train import Adam, TrainStepConfig

torch.set_num_threads(2)


def test_role_maker_env_dialects():
    r = RoleMaker.from_env({})
    assert r.rank == 0 and r.world == 1 and r.is_first_worker and r.coordinator is None
    r = RoleMaker.from_env({"RANK": "2", "WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"})
    assert (r.rank, r.world, r.coordinator) == (2, 4, "10.0.0.1:1234")
    assert (r.worker_index(), r.worker_num()) == (2, 4)
    r = RoleMaker.from_env({"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
                            "POD_IP": "10.0.0.2", "PADDLE_PORT": "6170"})
    assert (r.rank, r.world, r.coordinator) == (1, 2, "10.0.0.2:6170")
    # torchrun's names come first, as the JAX package's JAX_* names do
    r = RoleMaker.from_env({"RANK": "0", "WORLD_SIZE": "2", "PADDLE_TRAINER_ID": "1",
                            "PADDLE_TRAINERS_NUM": "3", "MASTER_ADDR": "h", "MASTER_PORT": "9"})
    assert (r.rank, r.world, r.coordinator) == (0, 2, "h:9")
    with pytest.raises(ValueError, match="coordinator"):
        RoleMaker.from_env({"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2"})
    with pytest.raises(ValueError, match="range"):
        RoleMaker.from_env({"RANK": "5", "WORLD_SIZE": "2", "MASTER_ADDR": "x", "MASTER_PORT": "1"})


@pytest.mark.parametrize(
    "env,match",
    [
        ({"RANK": "two", "WORLD_SIZE": "4", "MASTER_ADDR": "x", "MASTER_PORT": "1"}, "RANK='two'"),
        ({"PADDLE_TRAINER_ID": "abc", "PADDLE_TRAINERS_NUM": "2", "POD_IP": "10.0.0.2", "PADDLE_PORT": "6170"},
         "PADDLE_TRAINER_ID='abc'"),
        ({"RANK": "0", "WORLD_SIZE": "many", "MASTER_ADDR": "x", "MASTER_PORT": "1"}, "WORLD_SIZE='many'"),
        ({"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": " "}, "PADDLE_TRAINERS_NUM=' '"),
        ({"RANK": "0", "WORLD_SIZE": "0"}, "WORLD_SIZE='0'"),
        ({"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "2", "POD_IP": "h", "PADDLE_PORT": "1"},
         "PADDLE_TRAINER_ID='3'.*world 2"),
        ({"RANK": "0", "WORLD_SIZE": "2"}, "WORLD_SIZE='2'"),
        ({"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "2", "POD_IP": "10.0.0.2"}, "coordinator"),
        ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "http"}, "MASTER_PORT='http'"),
        ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "70000"}, "MASTER_PORT='70000'"),
    ],
    ids=["rank_nan", "paddle_rank_nan", "world_nan", "world_blank", "world_zero", "rank_ge_world",
         "no_coordinator", "pod_ip_without_port", "port_nan", "port_range"],
)
def test_role_maker_names_the_offending_variable(env, match):
    with pytest.raises(ValueError, match=match):
        RoleMaker.from_env(env)


def test_init_distributed_single_process_is_a_no_op():
    role = init_distributed(RoleMaker(rank=0, world=1))
    assert role.world == 1
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_make_mesh_refusals():
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="visible cards"):
            make_mesh("nccl", rank=0, world=1, init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="explicit device"):
        make_mesh("gloo", rank=0, world=1, init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="backend"):
        make_mesh("mpi", rank=0, world=1)


def _cfg(**kw):
    return TrainStepConfig(num_slots=2, batch_size=4, layout=ValueLayout(embedx_dim=4), **kw)


def test_strategy_translation_matches_jax():
    import optax

    from paddlebox_tpu.fleet import DistributedStrategy as JStrategy
    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    jcfg = JCfg(num_slots=2, batch_size=4, layout=JLayout(embedx_dim=4))
    for kw in [{}, {"a_sync": True}, {"a_sync": True, "a_sync_configs": {"k_steps": 8}}, {"localsgd": True},
               {"localsgd": True, "localsgd_configs": {"k_steps": 3}}, {"sharding": True},
               {"sharding": True, "localsgd": True}]:
        cfg, opt, _ = DistributedStrategy(**kw).apply(_cfg(), Adam(1e-3), n_dev=4)
        jc, jopt, _ = JStrategy(**kw).apply(jcfg, optax.adam(1e-3), n_dev=4)
        assert (cfg.dense_sync_mode, cfg.param_sync_step) == (jc.dense_sync_mode, jc.param_sync_step), kw
        assert isinstance(opt, Zero1Optimizer) == isinstance(jopt, JZero)
        if isinstance(opt, Zero1Optimizer):
            assert (opt.n_dev, opt.axis_name) == (jopt.n_dev, jopt.axis_name) == (4, "dp")
    with pytest.raises(ValueError, match="mutually exclusive"):
        DistributedStrategy(a_sync=True, localsgd=True)


@pytest.mark.parametrize("flag", ["pipeline", "pipeline_spec", "pipeline_dp_sharding"])
def test_strategy_flags_not_ported_raise(flag):
    """The pipeline flag as both packages take it: ``apply()`` refuses it
    with the same ``ValueError`` (pipeline training is another step
    builder), ``pipeline_spec()`` gives equal specs, and the dp degree and
    the ``pipeline + sharding`` guard agree."""
    import optax

    from paddlebox_tpu.fleet import DistributedStrategy as JStrategy
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    if flag == "pipeline":
        jcfg = JCfg(num_slots=2, batch_size=4, layout=JLayout(embedx_dim=4))
        for strat, cfg, opt in ((JStrategy, jcfg, optax.adam(1e-3)), (DistributedStrategy, _cfg(), Adam(1e-3))):
            with pytest.raises(ValueError, match="pipeline=True selects a different step builder.*pipeline_spec"):
                strat(pipeline=True).apply(cfg, opt)
    elif flag == "pipeline_spec":
        for kw in [{}, {"pipeline_configs": {"micro_batch": 6}}]:
            for axis in ("pp", "stage"):
                spec = DistributedStrategy(pipeline=True, **kw).pipeline_spec(axis)
                jspec = JStrategy(pipeline=True, **kw).pipeline_spec(axis)
                assert (spec.n_micro, spec.axis_name, spec.remat) == (jspec.n_micro, jspec.axis_name, jspec.remat)
        for strat in (JStrategy, DistributedStrategy):
            with pytest.raises(ValueError, match="strategy.pipeline is False"):
                strat().pipeline_spec()
    else:
        for dp in (None, 1, 2, 4):
            kw = {"pipeline": True, "pipeline_configs": {"micro_batch": 4, **({"dp_degree": dp} if dp else {})}}
            assert DistributedStrategy(**kw).pipeline_dp_degree == JStrategy(**kw).pipeline_dp_degree
            for strat in (JStrategy, DistributedStrategy):
                if (dp or 1) < 2:
                    with pytest.raises(ValueError, match="pipeline \\+ sharding needs a dp axis"):
                        strat(sharding=True, **kw)
                else:
                    assert strat(sharding=True, **kw).pipeline_dp_degree == dp
        for strat in (JStrategy, DistributedStrategy):
            with pytest.raises(ValueError, match="pipeline composes with neither a_sync nor localsgd"):
                strat(pipeline=True, localsgd=True)


@pytest.mark.parametrize("zero", [False, True], ids=["adam", "zero1"])
def test_convert_pipeline_state_round_trip(zero):
    """A JAX pipeline state (stacked stages; ZeRO-1's [n_pp, n_dp] chunks)
    carried to every rank's port state and stacked back equals the JAX
    arrays, leaf for leaf."""
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import hetero_mlp_stage_init as jhetero
    from paddlebox_tpu.parallel import init_pipeline_state as jinit
    from paddlebox_tpu.parallel.mesh import make_mesh_2d as jmesh2
    from paddlebox_tpu_torch.models.convert import pipeline_stage_from_jax, pipeline_state_to_jax

    n_pp, n_dp = 2, 2
    stages, _ = jhetero(jax.random.PRNGKey(1), [[5, 7, 9], [9, 3]])
    opt = JZero(optax.adam(1e-2), axis_name="dp", n_dev=n_dp) if zero else optax.adam(1e-2)
    st = jinit(jmesh2(n_pp, n_dp), stages, opt, axis="pp", dp_axis="dp" if zero else None)
    # random leaves in the JAX state's shapes, so no zero moment hides a swap
    rng = np.random.default_rng(7)
    fill = lambda a: (rng.integers(1, 9, size=np.shape(a)).astype(np.int32) if np.asarray(a).dtype == np.int32
                      else rng.normal(size=np.shape(a)).astype(np.float32))
    params = jax.tree.map(fill, jax.tree.map(np.asarray, st[0]))
    adam = jax.tree.map(fill, jax.tree.map(np.asarray, st[1][0]))
    ranks = [[pipeline_stage_from_jax(params, adam.count, adam.mu, adam.nu, p, chunk=d if zero else None)
              for d in range(n_dp)] for p in range(n_pp)]
    for p in range(n_pp):
        for d in range(n_dp):
            got, state = ranks[p][d]
            assert sorted(got) == ["b", "g", "w"]
            np.testing.assert_array_equal(got["w"].numpy(), params["w"][p])
            if zero:
                np.testing.assert_array_equal(state.nu["flat"].numpy(), adam.nu[p, d])
                assert int(state.count) == int(adam.count[p, d])
            else:
                np.testing.assert_array_equal(state.mu["g"].numpy(), adam.mu["g"][p])
    back = pipeline_state_to_jax([(ranks[p][0][0], [ranks[p][d][1] for d in range(n_dp)] if zero else ranks[p][0][1])
                                  for p in range(n_pp)])
    want = (params, adam.count, adam.mu, adam.nu)
    for b, w in zip(back, want):
        bl, wl = jax.tree.leaves(b), jax.tree.leaves(w)
        assert len(bl) == len(wl)
        for x, y in zip(bl, wl):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _zoo_params():
    """A DeepFM's and an MMoE's port params and the JAX trees they come from."""
    from paddlebox_tpu.models import MMoE as JMMoE
    from paddlebox_tpu.models import DeepFM as JDeepFM
    from paddlebox_tpu_torch.models import params_from_jax

    out = []
    for jm in (JDeepFM(3, 7, 4, hidden=(8, 5)), JMMoE(3, 7, n_experts=2, n_tasks=2, expert_hidden=(6,), tower_hidden=(4,))):
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
        out.append((params_from_jax(jp), jp))
    return out


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_zero_chunks_match_jax(n_dev):
    import optax

    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero

    for params, jp in _zoo_params():
        z, jz = Zero1Optimizer(Adam(1e-2), n_dev=n_dev), JZero(optax.adam(1e-2), n_dev=n_dev)
        chunks, n = z._chunks(params)
        jchunks, _, jn = jz._chunks(jp)
        assert n == jn
        np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
        back = unravel(ravel(params), params)
        assert list(back) == list(params)
        for k in params:
            assert torch.equal(back[k], params[k]), k
        st, jst = z.init_stacked(params), jz.init_stacked(jp)
        assert tuple(st.mu["flat"].shape) == tuple(jst[0].mu.shape) == (n_dev, chunks.shape[1])
        assert tuple(st.count.shape) == tuple(jst[0].count.shape) == (n_dev,)
    assert jax_order({"mlp.10.weight": 0, "mlp.2.weight": 0, "b": 0, "mlp.2.bias": 0}) == [
        "b", "mlp.2.bias", "mlp.2.weight", "mlp.10.weight"
    ]


def test_zero_update_local_matches_the_unchunked_adam():
    """One rank's view of ZeRO-1 on a fake mesh of two whose all_gather
    returns both chunks' updates: the whole update equals plain Adam's."""
    params, _ = _zoo_params()[0]
    g = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(3)) for k, v in params.items()}
    z = Zero1Optimizer(Adam(1e-2), n_dev=2)
    stacked = z.init_stacked(params)

    class FakePlan:
        rank = 0

        def all_gather(self, x):  # both ranks' chunk updates
            gch, _ = z._chunks(g)
            return torch.stack([
                z.inner.update({"flat": gch[r]}, Zero1Optimizer.local_state(stacked, r))[0]["flat"] for r in range(2)
            ])

    upd, st = z.update_local(FakePlan(), g, Zero1Optimizer.local_state(stacked, 0))
    want, _ = Adam(1e-2).update(g, Adam(1e-2).init(params))
    for k in params:
        torch.testing.assert_close(upd[k], want[k], rtol=0, atol=0)
    assert int(st.count) == 1

