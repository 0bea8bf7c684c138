"""The port's rank_attention, RankDeepFM and join training step against the
JAX package's.

Inputs are made from one seed with numpy: rank matrices from
``build_rank_offset`` over pvs of 1-4 ads (cmatch 222 or an invalid 999,
a few ranks past ``max_rank``) with ghost rows, so invalid entries are -1
as the builder writes them. Tolerances:

- ``rank_attention`` forward: rtol 1e-5, atol 1e-6 (float32; the port
  sums over features in a matmul, then over peers);
- gradients with respect to ``x`` and ``rank_param`` against
  ``jax.grad``: rtol 1e-4, atol 1e-6; a pair block no instance uses gets
  exactly zero;
- RankDeepFM logits with the JAX weights carried across: rtol 1e-5
  (atol 1e-6 for logits near zero);
- three join training steps (``model_takes_rank_offset``, ghost weights):
  ``test_torch_train_step.py``'s tolerances (table rtol 1e-3 / atol 1e-5,
  params atol 2e-4, Adam moments rtol 5e-2 / atol 1e-6, loss rtol 1e-3,
  AUC tables exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.metrics.auc import auc_init as jauc_init
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
from paddlebox_tpu.ops import rank_attention as jrank_attention
from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.train.train_step import TrainState as JTrainState
from paddlebox_tpu.train.train_step import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.train_step import make_train_step as jmake_train_step
from paddlebox_tpu_torch.data import SlotRecord, build_rank_offset, merge_pv_instances
from paddlebox_tpu_torch.metrics import auc_init
from paddlebox_tpu_torch.models import (
    DeepFM,
    RankDeepFM,
    adam_state_from_optax,
    adam_state_to_optax,
    dense_from_jax_leaves,
    dense_leaf_names,
    dense_to_jax_leaves,
    rank_deepfm_params_from_jax,
    rank_deepfm_params_to_jax,
)
from paddlebox_tpu_torch.ops import rank_attention
from paddlebox_tpu_torch.table import SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, TrainState, TrainStepConfig, make_train_step

torch.set_num_threads(2)

S, B, D = 3, 16, 4
HIDDEN = (32, 16)
MAX_RANK = 4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
R = 96  # table rows; the last is the padding row
LR = 1e-3
AUC_BUCKETS = 50
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-5
PARAMS_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
LOSS_RTOL = 1e-3


def _rank_offset(rng, n_ghost=2):
    """[B, 2*MAX_RANK+1] int32 and ins_weight [B]: pvs of 1-4 ads laid out
    in order, ranks 1..n (some past MAX_RANK), cmatch partly invalid, the
    last ``n_ghost`` rows ghosts (all -1, weight 0)."""
    recs, sid, n = [], 1, 0
    while True:
        k = int(rng.integers(1, 5))
        if n + k > B - n_ghost:
            break
        for r in range(1, k + 1):
            rank = r if rng.random() > 0.1 else MAX_RANK + 1
            cm = 222 if rng.random() > 0.15 else 999
            recs.append(SlotRecord(np.zeros(0, np.uint64), np.zeros(1, np.uint32), np.zeros(0, np.float32),
                                   np.zeros(1, np.uint32), search_id=sid, cmatch=cm, rank=rank))
        sid += 1
        n += k
    ro = build_rank_offset(merge_pv_instances(recs, sort=False), B, max_rank=MAX_RANK, valid_cmatch=(222,))
    w = np.zeros(B, np.float32)
    w[:n] = 1.0
    return ro, w


@pytest.fixture(scope="module", params=[1, 3], ids=["C1", "C3"])
def attention_case(request):
    """x, rank_offset, rank_param and an output cotangent; the JAX
    package's forward and its gradients, computed once."""
    C = request.param
    rng = np.random.default_rng(C)
    F = S * 7
    x = rng.normal(size=(B, F)).astype(np.float32)
    ro, _ = _rank_offset(rng)
    param = rng.normal(size=(MAX_RANK * MAX_RANK * F, C)).astype(np.float32)
    cot = rng.normal(size=(B, C)).astype(np.float32)

    def f(xx, pp):
        return jnp.sum(jrank_attention(xx, jnp.asarray(ro), pp, MAX_RANK) * cot)

    out = np.asarray(jrank_attention(jnp.asarray(x), jnp.asarray(ro), jnp.asarray(param), MAX_RANK))
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(param))
    return x, ro, param, cot, out, np.asarray(gx), np.asarray(gp)


def test_rank_attention_forward_matches_jax(attention_case):
    x, ro, param, _, want, _, _ = attention_case
    got = rank_attention(torch.from_numpy(x), torch.from_numpy(ro), torch.from_numpy(param), MAX_RANK)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)
    rankless = ro[:, 0] < 1
    assert rankless.any() and (got.numpy()[rankless] == 0).all()


def test_rank_attention_grads_match_jax(attention_case):
    x, ro, param, cot, _, gx_want, gp_want = attention_case
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(param).requires_grad_(True)
    out = rank_attention(xt, torch.from_numpy(ro), pt, MAX_RANK)
    gx, gp = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt, pt])
    np.testing.assert_allclose(gx.numpy(), gx_want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gp.numpy(), gp_want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_unused_pair_blocks_get_exactly_zero_gradient(attention_case):
    """With every rank past 3 made invalid (-1 in rank and row columns),
    the blocks of own or peer rank 4 serve nobody: their gradient is
    exactly zero in the port, as in the JAX package; every used block's
    is not."""
    x, ro, param, cot, _, _, _ = attention_case
    ro = ro.copy()
    ro[ro[:, 0] > 3, 0] = -1
    for k in range(MAX_RANK):
        gone = ro[:, 2 * k + 1] > 3
        ro[gone, 2 * k + 1] = -1
        ro[gone, 2 * k + 2] = -1
    pt = torch.from_numpy(param).requires_grad_(True)
    out = rank_attention(torch.from_numpy(x), torch.from_numpy(ro), pt, MAX_RANK)
    (gp,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [pt])
    jgp = jax.grad(lambda pp: jnp.sum(jrank_attention(jnp.asarray(x), jnp.asarray(ro), pp, MAX_RANK) * cot))(
        jnp.asarray(param)
    )
    used = np.zeros((MAX_RANK, MAX_RANK), bool)
    for i in range(B):
        for k in range(MAX_RANK):
            p = ro[i, 2 * k + 1] - 1
            if ro[i, 0] >= 1 and p >= 0:
                used[ro[i, 0] - 1, p] = True
    assert used[:3, :3].any() and not used[3].any() and not used[:, 3].any()
    blocks = gp.numpy().reshape(MAX_RANK, MAX_RANK, -1)
    assert (blocks[~used] == 0).all() and (np.abs(blocks[used]).sum(axis=-1) > 0).all()
    assert (np.asarray(jgp).reshape(MAX_RANK, MAX_RANK, -1)[~used] == 0).all()


def test_rank_attention_grad_flows_only_to_used_blocks():
    """``tests/test_ctr_ops.py``'s case: both own-rank rows get gradient."""
    Bs, F, C, Rr = 2, 3, 2, 2
    ro = torch.tensor([[1, 1, 0, 2, 1], [2, 1, 0, 2, 1]], dtype=torch.int32)
    p = torch.zeros((Rr * Rr * F, C), requires_grad=True)
    (g,) = torch.autograd.grad(rank_attention(torch.ones((Bs, F)), ro, p, Rr).sum(), [p])
    g = g.reshape(Rr, Rr, F, C)
    assert g[0].abs().sum() > 0 and g[1].abs().sum() > 0


def _rank_models(seed=0):
    lay = ValueLayout(embedx_dim=D)
    jbase = JDeepFM(S, lay.pull_width, D, hidden=HIDDEN)
    jmodel = JRankDeepFM(jbase, S * lay.pull_width, max_rank=MAX_RANK)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(seed)))
    g = torch.Generator().manual_seed(seed)
    model = RankDeepFM(DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=g), S * lay.pull_width,
                       max_rank=MAX_RANK, generator=g)
    model.load_state_dict(rank_deepfm_params_from_jax(jax.tree.map(np.asarray, jparams)))
    return lay, jmodel, jparams, model


def test_rank_deepfm_logits_match_jax():
    lay, jmodel, jparams, model = _rank_models()
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(B, S, lay.pull_width)).astype(np.float32)
    ro, _ = _rank_offset(rng)
    for r in (ro, None):
        want = np.asarray(jmodel.apply(jparams, jnp.asarray(feats), None, None if r is None else jnp.asarray(r)))
        got = model(torch.from_numpy(feats), None, None if r is None else torch.from_numpy(r))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_rankless_row_is_unchanged_by_the_tower():
    """``tests/test_pv_phase.py``'s case: a row with no rank gets the base
    logit bitwise; a ranked one moves."""
    lay, _, _, model = _rank_models()
    with torch.no_grad():
        model.rank_param += 1.0
    feats = torch.ones((4, S, lay.pull_width))
    ro = torch.full((4, 2 * MAX_RANK + 1), -1, dtype=torch.int32)
    ro[0, :5] = torch.tensor([1, 1, 0, 2, 1])
    ro[1, :5] = torch.tensor([2, 1, 0, 2, 1])
    with torch.no_grad():
        with_ro, without = model(feats, None, ro), model(feats, None, None)
    assert abs(float(with_ro[0] - without[0])) > 1e-3
    assert torch.equal(with_ro[3], without[3])


def test_rank_deepfm_weights_and_adam_state_round_trip():
    """JAX tree -> state_dict -> JAX tree is the identity; so are Adam's
    moments and the dense-file leaves (JAX's flatten order: the base's
    leaves, then ``rank_param``)."""
    _, jmodel, jparams, model = _rank_models()
    npp = jax.tree.map(np.asarray, jparams)
    back = rank_deepfm_params_to_jax(rank_deepfm_params_from_jax(npp))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(npp)):
        np.testing.assert_array_equal(g, w)
    jopt = optax.adam(LR)
    jst = jopt.init(jparams)
    jst = jax.tree.map(lambda a: a + 0.5 if a.dtype == jnp.float32 else a + 3, jst)
    adam = jst[0]
    st = adam_state_from_optax(np.asarray(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu))
    count, mu, nu = adam_state_to_optax(st)
    assert int(count) == int(adam.count)
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    params = dict(model.state_dict())
    jleaves = [np.asarray(a) for a in jax.tree.leaves((jparams, jst))]
    leaves = dense_to_jax_leaves(params, st)
    assert len(leaves) == len(jleaves) == len(dense_leaf_names(params))
    for g, w in zip(leaves, jleaves):
        np.testing.assert_array_equal(g, w)
    assert dense_leaf_names(params)[-1] == "[1][0].nu['rank_param']"
    p2, st2 = dense_from_jax_leaves(jleaves, params, torch.device("cpu"))
    assert all(torch.equal(p2[k], params[k]) for k in params)
    assert all(torch.equal(st2.mu[k], st.mu[k]) and torch.equal(st2.nu[k], st.nu[k]) for k in params)


def _batch(rng, n_uniq=40):
    """A packed join batch: unique rows + padding-row tail, slot-major
    segments, the inverse map, a rank matrix and ghost weights."""
    uniq = rng.permutation(R - 1)[:n_uniq].astype(np.int32)
    lens = rng.integers(1, 3, S * B)
    segments = np.repeat(np.arange(S * B, dtype=np.int32), lens)
    L = len(segments)
    U_pad, L_pad = n_uniq + 8, L + 6
    ro, w = _rank_offset(rng)
    return {
        "uniq_rows": np.concatenate([uniq, np.full(U_pad - n_uniq, R - 1, np.int32)]),
        "inverse": np.concatenate([rng.integers(0, n_uniq, L), np.full(L_pad - L, U_pad - 1)]).astype(np.int32),
        "segments": np.concatenate([segments, np.full(L_pad - L, S * B)]).astype(np.int32),
        "labels": (rng.random(B) < 0.4).astype(np.float32),
        "rank_offset": ro,
        "ins_weight": w,
    }


def test_join_training_steps_match_jax():
    lay, jmodel, jparams, model = _rank_models(seed=1)
    rng = np.random.default_rng(1)
    table0 = (0.1 * rng.normal(size=(R, lay.width))).astype(np.float32)
    table0[:, 0] = rng.integers(0, 30, R)
    table0[:, 1] = np.floor(table0[:, 0] * rng.random(R))
    table0[:, lay.embed_g2_col :] = 0.0
    table0[R - 1] = 0.0
    batches = [_batch(rng) for _ in range(3)]
    sp = dict(embedx_threshold=5.0)
    jcfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=JValueLayout(embedx_dim=D),
                            sparse_opt=JSparseOptimizerConfig(**sp), auc_buckets=AUC_BUCKETS,
                            model_takes_rank_offset=True)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**sp),
                          auc_buckets=AUC_BUCKETS, model_takes_rank_offset=True)
    jopt = optax.adam(LR)
    jstep = jax.jit(jmake_train_step(jmodel.apply, jopt, jcfg))
    jst = JTrainState(jnp.asarray(table0), jparams, jopt.init(jparams), jauc_init(AUC_BUCKETS), jnp.zeros((), jnp.int32))
    step = make_train_step(lambda p, x, d, ro: torch.func.functional_call(model, p, (x, d, ro)), cfg, Adam(LR))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    st = TrainState(torch.from_numpy(table0.copy()), params, Adam(LR).init(params),
                    auc_init(AUC_BUCKETS, device="cpu"), torch.zeros((), dtype=torch.int32))
    for b in batches:
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    got_p, want_p = rank_deepfm_params_to_jax(st.params), jax.tree.map(np.asarray, jst.params)
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL)
    # the rank tower trained: its parameter moved in both packages alike
    assert not np.array_equal(got_p["rank_param"], np.asarray(jparams["rank_param"]))
    count, mu, nu = adam_state_to_optax(st.opt_state)
    jadam = jst.opt_state[0]
    assert int(count) == int(jadam.count) == 3
    for got, want in ((mu, jadam.mu), (nu, jadam.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    np.testing.assert_array_equal(st.auc.pos.numpy(), np.asarray(jst.auc.pos))
    np.testing.assert_array_equal(st.auc.neg.numpy(), np.asarray(jst.auc.neg))
    # ghosts are masked out of the AUC: the real instances of three batches
    assert int(st.auc.pos.sum() + st.auc.neg.sum()) == int(sum(b["ins_weight"].sum() for b in batches))
