"""The fleet strategy's ``recompute``, ``amp`` and ``gradient_merge`` in the
port, against the JAX package's ``DistributedStrategy.apply`` and
``optax.MultiSteps``.

- ``MultiSteps(Adam(lr), k)`` against ``optax.MultiSteps(optax.adam(lr),
  k)`` over 3k mini-steps of the same gradients, k = 1, 2 and 4: the
  counters exactly, and the updates and float state leaves (Adam's
  moments, ``acc_grads``) within MS_RTOL. optax compiles its update
  inside a ``lax.cond``, where XLA contracts Adam's moment updates into
  fused multiply-adds and rearranges its final scale and division, which
  moves elements by an ulp or two; the port's Adam alone is bitwise
  optax's eager ``adam`` (checked below). On the mini-steps that do not
  emit, both updates are exactly zero.
- ``recompute``: four training steps with the recomputing model apply are
  bitwise the plain port's (table, params, moments, losses).
- ``amp``: the port's bf16 forward against the JAX package's
  ``bf16_apply`` on the same weights and inputs (bitwise on this CPU,
  held to AMP_LOGIT_ATOL), and three training steps within the bounds
  below: an ulp of difference in the fp32 seqpool can flip a bf16
  rounding, the backward's bf16 sums may round at other places in XLA and
  torch, and Adam's first steps move a weight by about lr whatever the
  gradient's size, so an element whose bf16 gradient sign the rounding
  decides can part by 2 lr a step (AMP_PARAMS_ATOL).
- the train step with ``gradient_merge`` (k = 2) against the JAX step over
  six steps, within ``tests/test_torch_train_step.py``'s bounds, with the
  params bitwise unchanged on the mini-steps that do not emit;
- a dense checkpoint of a ``MultiSteps`` trainer written by either
  package loads into the other bitwise, and training from the loaded
  state goes on as in the writer (those bounds again);
- ZeRO-1 over ``MultiSteps``: the stacked state has JAX's leaves, and a
  rank's chunked update is the unchunked one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.fleet import DistributedStrategy as JStrategy
from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
from paddlebox_tpu.metrics.auc import auc_init as jauc_init
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train.train_step import TrainState as JTrainState
from paddlebox_tpu.train.train_step import make_train_step as jmake_train_step
from paddlebox_tpu_torch.fleet import DistributedStrategy, Zero1Optimizer
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.models import (
    dense_from_jax_leaves,
    dense_leaf_names,
    dense_to_jax_leaves,
    params_from_jax,
    params_to_jax,
)
from paddlebox_tpu_torch.train import Adam, CTRTrainer, MultiSteps, MultiStepsState, TrainState, make_train_step
from test_torch_train_step import (
    AUC_BUCKETS,
    HIDDEN,
    LOSS_RTOL,
    LR,
    MOMENT_ATOL,
    MOMENT_RTOL,
    PARAMS_ATOL,
    TABLE_ATOL,
    TABLE_RTOL,
    Both,
    D,
    S,
)

torch.set_num_threads(2)

AMP_LOGIT_ATOL = 1e-2  # a bf16 ulp at the logits' magnitude (~10) is 6e-2/8; measured 0
AMP_PARAMS_ATOL = 6 * LR  # 2 lr a step over three steps
AMP_LOSS_RTOL = 1e-2  # measured 2.8e-4
# the table's gradients come out of the bf16 backward: measured max |diff|
# 1.3e-4 after three steps (an embed_g2 sum), 4.2e-5 on a weight
AMP_TABLE_RTOL, AMP_TABLE_ATOL = 5e-2, 5e-4
MS_RTOL, MS_ATOL = 1e-5, 1e-10  # measured max relative difference 1.2e-6


def _grads(rng, like):
    return {k: rng.normal(size=v.shape).astype(np.float32) for k, v in like.items()}


def _jax_state_leaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st)]


def _port_state_leaves(st, params):
    """The port's MultiStepsState in optax's leaf order (params' order)."""
    return dense_to_jax_leaves(params, st)[len(jax.tree.leaves(params_to_jax(params))):]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_multi_steps_matches_optax_bitwise(k):
    rng = np.random.default_rng(k)
    jp = {"b": np.zeros((), np.float32), "mlp": [{"w": rng.normal(size=(6, 4)).astype(np.float32),
                                                   "b": np.zeros(4, np.float32)}]}
    params = params_from_jax(jp)
    opt, jopt = MultiSteps(Adam(1e-2), k), optax.MultiSteps(optax.adam(1e-2), k)
    st, jst = opt.init(params), jopt.init(jax.tree.map(jnp.asarray, jp))
    assert [a.tobytes() for a in _port_state_leaves(st, params)] == [a.tobytes() for a in _jax_state_leaves(jst)]
    for i in range(3 * k):
        jg = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32), jp)
        upd, st = opt.update(params_from_jax(jg), st)
        jupd, jst = jopt.update(jax.tree.map(jnp.asarray, jg), jst)
        got_u = [np.asarray(x) for x in jax.tree.leaves(params_to_jax(upd))]
        for g, w in zip(got_u, jax.tree.leaves(jupd)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=MS_RTOL, atol=MS_ATOL, err_msg=str(i))
        for g, w in zip(_port_state_leaves(st, params), _jax_state_leaves(jst)):
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == np.int32:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=MS_RTOL, atol=MS_ATOL, err_msg=str(i))
        emit = (i + 1) % k == 0
        assert int(st.mini_step) == (i + 1) % k and int(st.gradient_step) == (i + 1) // k
        if not emit:
            assert all(not np.any(u) for u in got_u)
            assert all(not np.any(np.asarray(u)) for u in jax.tree.leaves(jupd))


def test_port_adam_is_bitwise_optax_eager():
    rng = np.random.default_rng(0)
    jp = {"w": rng.normal(size=(6, 4)).astype(np.float32), "b": np.zeros(4, np.float32)}
    opt, jopt = Adam(1e-2), optax.adam(1e-2)
    st, jst = opt.init(params_from_jax(jp)), jopt.init(jax.tree.map(jnp.asarray, jp))
    for i in range(4):
        jg = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32), jp)
        upd, st = opt.update(params_from_jax(jg), st)
        jupd, jst = jopt.update(jax.tree.map(jnp.asarray, jg), jst)
        assert [np.asarray(x).tobytes() for x in jax.tree.leaves(params_to_jax(upd))] == [
            np.asarray(x).tobytes() for x in jax.tree.leaves(jupd)], i


def test_multi_steps_rejects_a_bad_schedule():
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="every_k_schedule"):
            MultiSteps(Adam(1e-3), bad)


def test_strategy_folds_like_jax():
    """gradient_merge wraps the optimizer (inside ZeRO-1 with sharding);
    recompute and amp wrap the model apply only when one is given."""
    from test_torch_fleet import _cfg

    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    jcfg = JCfg(num_slots=2, batch_size=4, layout=JLayout(embedx_dim=4))
    for kw in ({"gradient_merge": True}, {"gradient_merge": True, "gradient_merge_configs": {"k_steps": 3}},
               {"gradient_merge": True, "sharding": True}, {"recompute": True, "amp": True}):
        cfg, opt, apply = DistributedStrategy(**kw).apply(_cfg(), Adam(1e-3), n_dev=2)
        jc, jopt, japply = JStrategy(**kw).apply(jcfg, optax.adam(1e-3), n_dev=2)
        assert apply is None and japply is None
        inner, jinner = (opt.inner, jopt.inner) if kw.get("sharding") else (opt, jopt)
        assert isinstance(opt, Zero1Optimizer) == isinstance(jopt, JZero)
        assert isinstance(inner, MultiSteps) == isinstance(jinner, optax.MultiSteps)
        if isinstance(inner, MultiSteps):
            assert inner.every_k_schedule == kw.get("gradient_merge_configs", {}).get("k_steps", 4)
            assert isinstance(inner.opt, Adam)
    f = lambda p, x, d: x
    _, _, g = DistributedStrategy(recompute=True, amp=True).apply(_cfg(), Adam(1e-3), model_apply=f)
    assert g is not f and callable(g)
    _, _, same = DistributedStrategy().apply(_cfg(), Adam(1e-3), model_apply=f)
    assert same is f


def _port_apply(both, strategy=None):
    apply = lambda p, x, d: torch.func.functional_call(both.model, p, (x, d))
    if strategy is None:
        return apply
    return strategy.apply(both.cfg, Adam(LR), model_apply=apply)[2]


def _run(step, both, state, batches):
    ms = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ms.append(m)
    return state, ms


def test_recompute_is_bitwise_the_plain_step():
    both = Both(n_steps=4)
    plain = make_train_step(_port_apply(both), both.cfg, Adam(LR))
    rec = make_train_step(_port_apply(both, DistributedStrategy(recompute=True)), both.cfg, Adam(LR))
    a, ma = _run(plain, both, both.port_state(), both.batches)
    b, mb = _run(rec, both, both.port_state(), both.batches)
    assert torch.equal(a.table, b.table)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]) and torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])
    assert [m["loss"].item() for m in ma] == [m["loss"].item() for m in mb]


def test_amp_forward_is_within_bf16_of_jax():
    both = Both(n_steps=1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, S, both.lay.pull_width)).astype(np.float32)
    papply = _port_apply(both, DistributedStrategy(amp=True))
    japply = JStrategy(amp=True).apply(both.jcfg, optax.adam(LR), model_apply=JDeepFM(
        S, both.lay.pull_width, D, hidden=HIDDEN).apply)[2]
    params = {k: v.detach().clone() for k, v in both.model.state_dict().items()}
    got = papply(params, torch.from_numpy(x), None)
    want = np.asarray(japply(both.jparams, jnp.asarray(x), None))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AMP_LOGIT_ATOL)
    # the bf16 forward is not the fp32 one: the cast happened
    fp32 = _port_apply(both)(params, torch.from_numpy(x), None)
    assert not torch.equal(got, fp32)


def test_amp_training_is_within_bounds_of_jax():
    both = Both(n_steps=3)
    japply = JStrategy(amp=True).apply(both.jcfg, optax.adam(LR), model_apply=JDeepFM(
        S, both.lay.pull_width, D, hidden=HIDDEN).apply)[2]
    jst, jms = _jax_run(both, both.batches, optax.adam(LR), japply)
    step = make_train_step(_port_apply(both, DistributedStrategy(amp=True)), both.cfg, Adam(LR))
    st, ms = _run(step, both, both.port_state(), both.batches)
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=AMP_TABLE_RTOL, atol=AMP_TABLE_ATOL)
    for g, w in zip(jax.tree.leaves(params_to_jax(st.params)), jax.tree.leaves(jax.tree.map(np.asarray, jst.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=AMP_PARAMS_ATOL)
    for m, j in zip(ms, jms):
        np.testing.assert_allclose(float(m["loss"]), float(j["loss"]), rtol=AMP_LOSS_RTOL)


# ---- gradient merge through the train step and the dense file --------------


K = 2


def _jax_run(both, batches, jopt, apply=None, state=None):
    """The JAX train step (jitted) over ``batches`` from ``state``, or from
    ``both``'s table and weights with a fresh ``jopt`` state."""
    apply = apply or JDeepFM(S, both.lay.pull_width, D, hidden=HIDDEN).apply
    jstep = jax.jit(jmake_train_step(apply, jopt, both.jcfg))
    st = state or JTrainState(jnp.asarray(both.table0), both.jparams, jopt.init(both.jparams),
                              jauc_init(AUC_BUCKETS), jnp.zeros((), jnp.int32))
    ms = []
    for b in batches:
        st, m = jstep(st, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append(m)
    return st, ms


def _jax_ms_run(both, batches, state=None):
    return _jax_run(both, batches, optax.MultiSteps(optax.adam(LR), K), state=state)


def _port_ms_run(both, batches, state=None):
    opt = MultiSteps(Adam(LR), K)
    step = make_train_step(_port_apply(both), both.cfg, opt)
    if state is None:
        st0 = both.port_state()
        state = st0._replace(opt_state=opt.init(st0.params))
    return _run(step, both, state, batches)


def _assert_ms_close(st, jst, ms, jms):
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    for g, w in zip(jax.tree.leaves(params_to_jax(st.params)), jax.tree.leaves(jax.tree.map(np.asarray, jst.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL)
    got = _port_state_leaves(st.opt_state, st.params)
    want = _jax_state_leaves(jst.opt_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=MOMENT_RTOL, atol=max(MOMENT_ATOL, PARAMS_ATOL))
    for m, j in zip(ms, jms):
        np.testing.assert_allclose(float(m["loss"]), float(j["loss"]), rtol=LOSS_RTOL)


def test_gradient_merge_step_matches_jax():
    both = Both(n_steps=6)
    jst, jms = _jax_ms_run(both, both.batches)
    st, ms = _port_ms_run(both, both.batches)
    _assert_ms_close(st, jst, ms, jms)
    assert int(st.opt_state.gradient_step) == 3 and int(st.opt_state.inner_opt_state.count) == 3
    # a mini-step that does not emit leaves the params bitwise as they were
    prev = both.port_state()
    for i in range(len(both.batches)):
        cur, _ = _port_ms_run(both, both.batches[: i + 1])
        if (i + 1) % K:
            assert all(torch.equal(cur.params[k], prev.params[k]) for k in cur.params), i
        else:
            assert not all(torch.equal(cur.params[k], prev.params[k]) for k in cur.params), i
        prev = cur


def _trainers(both):
    jtr = JCTRTrainer(JDeepFM(S, both.lay.pull_width, D, hidden=HIDDEN), both.jcfg,
                      dense_opt=optax.MultiSteps(optax.adam(LR), K))
    jtr.init_params(jax.random.PRNGKey(0))
    tr = CTRTrainer(both.model, both.cfg, dense_opt=MultiSteps(Adam(LR), K), device="cpu")
    tr.init_params()
    return jtr, tr


def test_multi_steps_dense_leaf_order_is_jax_tree_flatten():
    both = Both(n_steps=1)
    jtr, tr = _trainers(both)
    assert isinstance(tr.opt_state, MultiStepsState)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path((jtr.params, jtr.opt_state))[0]]
    assert dense_leaf_names(tr.params, multi_steps=True) == paths
    assert len(dense_to_jax_leaves(tr.params, tr.opt_state)) == len(paths)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_multi_steps_dense_file_crosses_packages_and_training_goes_on(tmp_path, writer):
    """Three steps (an odd count: the file holds a half-merged round), a
    dense file, three more steps from the loaded state in the reader."""
    both = Both(n_steps=6)
    first, rest = both.batches[:3], both.batches[3:]
    jst, _ = _jax_ms_run(both, first)
    st, _ = _port_ms_run(both, first)
    jtr, tr = _trainers(both)
    path = str(tmp_path / "dense-0000.npz")
    if writer == "port":
        tr.params, tr.opt_state = st.params, st.opt_state
        tr.save_dense(path)
        jtr.load_dense(path)
        assert [a.tobytes() for a in dense_to_jax_leaves(tr.params, tr.opt_state)] == [
            np.asarray(x).tobytes() for x in jax.tree.leaves((jtr.params, jtr.opt_state))]
        # the reader (JAX) goes on from the loaded state; the writer from its
        # own (a copy of the table: the port's push writes it in place)
        jst = jst._replace(params=jtr.params, opt_state=jtr.opt_state, table=jnp.asarray(st.table.numpy().copy()))
        st2, ms = _port_ms_run(both, rest, st)
        jst2, jms = _jax_ms_run(both, rest, jst)
    else:
        jtr.params, jtr.opt_state = jst.params, jst.opt_state
        jtr.save_dense(path)
        tr.load_dense(path)
        assert [a.tobytes() for a in dense_to_jax_leaves(tr.params, tr.opt_state)] == [
            np.asarray(x).tobytes() for x in jax.tree.leaves((jtr.params, jtr.opt_state))]
        assert int(tr.opt_state.mini_step) == 1
        st = st._replace(params=tr.params, opt_state=tr.opt_state, table=torch.from_numpy(np.array(jst.table)))
        st2, ms = _port_ms_run(both, rest, st)
        jst2, jms = _jax_ms_run(both, rest, jst)
    _assert_ms_close(st2, jst2, ms, jms)


def test_load_dense_refuses_another_optimizer_kind(tmp_path):
    both = Both(n_steps=1)
    _, tr = _trainers(both)
    path = str(tmp_path / "ms.npz")
    tr.save_dense(path)
    plain = CTRTrainer(both.model, both.cfg, dense_opt=Adam(LR), device="cpu")
    plain.init_params()
    with pytest.raises(ValueError, match="MultiStepsState"):
        plain.load_dense(path)
    plain.save_dense(str(tmp_path / "adam.npz"))
    with pytest.raises(ValueError, match="AdamState"):
        tr.load_dense(str(tmp_path / "adam.npz"))


def test_zero_over_multi_steps_matches_jax_and_the_unchunked_update():
    both = Both(n_steps=1)
    params = {k: v.detach().clone() for k, v in both.model.state_dict().items()}
    z = Zero1Optimizer(MultiSteps(Adam(1e-2), 2), n_dev=2)
    jz = JZero(optax.MultiSteps(optax.adam(1e-2), 2), n_dev=2)
    st, jst = z.init_stacked(params), jz.init_stacked(both.jparams)
    assert Zero1Optimizer.is_stacked(st)
    got = [a.tobytes() for a in dense_to_jax_leaves(params, st)[len(params):]]
    assert got == [np.asarray(x).tobytes() for x in jax.tree.leaves(jst)]
    names = dense_leaf_names(params, zero=True, multi_steps=True)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path((both.jparams, jst))[0]]
    assert names == paths
    p2, st2 = dense_from_jax_leaves(dense_to_jax_leaves(params, st), params, torch.device("cpu"))
    assert isinstance(st2, MultiStepsState) and Zero1Optimizer.is_stacked(st2)
    rng = np.random.default_rng(4)
    grads = [{k: torch.from_numpy(v) for k, v in _grads(rng, params).items()} for _ in range(4)]
    locals_ = [Zero1Optimizer.local_state(st, r) for r in range(2)]
    whole = MultiSteps(Adam(1e-2), 2)
    wst = whole.init(params)
    for g in grads:
        gch, _ = z._chunks(g)

        class FakePlan:
            rank = 0

            def all_gather(self, x, _gch=gch, _locals=tuple(locals_)):
                return torch.stack([z.inner.update({"flat": _gch[r]}, _locals[r])[0]["flat"] for r in range(2)])

        upd, locals_[0] = z.update_local(FakePlan(), g, locals_[0])
        locals_[1] = z.inner.update({"flat": gch[1]}, locals_[1])[1]
        want, wst = whole.update(g, wst)
        for k in params:
            torch.testing.assert_close(upd[k], want[k], rtol=0, atol=0)
    assert int(locals_[0].gradient_step) == 2 == int(wst.gradient_step)
