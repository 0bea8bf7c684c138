"""The port's model zoo (LR, Wide&Deep, DCN, MMoE and its task head)
against the JAX package's, on the same numpy inputs.

Weights cross with the zoo's converters (``models/convert.py``), which
round-trip bitwise. Each model's logits agree within LOGIT_ATOL at these
small widths, their bf16 towers included (the JAX package's precision
recipe in both). Four training steps of each from one state, dense
features on: the table within rtol 1e-3 / atol 1e-5 and the loss within
rtol 1e-3, as ``test_torch_train_step.py`` states them for DeepFM. Before
each step both packages' dense gradients are taken by their async-mode
step (``metrics["gparams"]``) on the same state: they agree within atol
2e-3 (the bf16 towers' rounding; measured 9.8e-4 at most, on MMoE's tower,
gradients of up to 0.34).
The params agree within atol 2e-4, but for an element whose gradient has
opposite signs in the two packages at some step: Adam divides each
gradient element by its own magnitude, so a near-zero gradient (measured
2e-6 against a leaf scale of 4e-2, in MMoE's first expert layer) moves its
weight by +lr in one package and -lr in the other; such an element is
held to 2 lr a step. Dense checkpoint files cross packages both ways for
every model.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.metrics.auc import auc_init as jauc_init
from paddlebox_tpu.models import DCN as JDCN
from paddlebox_tpu.models import MMoE as JMMoE
from paddlebox_tpu.models import LogisticRegression as JLR
from paddlebox_tpu.models import WideDeep as JWideDeep
from paddlebox_tpu.models import task_head as jtask_head
from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.train.train_step import TrainState as JTrainState
from paddlebox_tpu.train.train_step import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.train_step import make_train_step as jmake_train_step
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.models import (
    DCN,
    MMoE,
    LogisticRegression,
    WideDeep,
    dcn_params_from_jax,
    dcn_params_to_jax,
    dense_from_jax_leaves,
    dense_leaf_names,
    dense_to_jax_leaves,
    lr_params_from_jax,
    lr_params_to_jax,
    mmoe_params_from_jax,
    mmoe_params_to_jax,
    params_from_jax,
    params_to_jax,
    task_head,
    wide_deep_params_from_jax,
    wide_deep_params_to_jax,
)
from paddlebox_tpu_torch.table import SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, TrainState, TrainStepConfig, make_train_step

torch.set_num_threads(2)

S, B, D, DD = 5, 16, 4, 3  # slots, batch, embedx, dense features
F = ValueLayout(embedx_dim=D).pull_width
R = 96  # table rows; the last is the padding row
LR_ = 1e-3
AUC_BUCKETS = 50
LOGIT_ATOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-5
PARAMS_ATOL = 2e-4
GRAD_ATOL = 2e-3
LOSS_RTOL = 1e-3

# name -> (JAX model, port model from a generator, converters)
ZOO = {
    "lr": (
        lambda dd: JLR(S, F, dense_dim=dd),
        lambda dd, g: LogisticRegression(S, F, dense_dim=dd, generator=g),
        (lr_params_from_jax, lr_params_to_jax),
    ),
    "wide_deep": (
        lambda dd: JWideDeep(S, F, dense_dim=dd, hidden=(32, 16)),
        lambda dd, g: WideDeep(S, F, dense_dim=dd, hidden=(32, 16), generator=g),
        (wide_deep_params_from_jax, wide_deep_params_to_jax),
    ),
    "dcn": (
        lambda dd: JDCN(S, F, dense_dim=dd, n_cross=2, hidden=(32, 16)),
        lambda dd, g: DCN(S, F, dense_dim=dd, n_cross=2, hidden=(32, 16), generator=g),
        (dcn_params_from_jax, dcn_params_to_jax),
    ),
    "mmoe_task0": (
        lambda dd: jtask_head(JMMoE(S, F, dense_dim=dd, n_experts=3, expert_hidden=(16, 8), tower_hidden=(8,)), 0),
        lambda dd, g: task_head(
            MMoE(S, F, dense_dim=dd, n_experts=3, expert_hidden=(16, 8), tower_hidden=(8,), generator=g), 0
        ),
        (mmoe_params_from_jax, mmoe_params_to_jax),
    ),
}


def _models(name, dense_dim, seed=1):
    jmake, make, (from_jax, _) = ZOO[name]
    jmodel = jmake(dense_dim)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(seed)))
    model = make(dense_dim, torch.Generator().manual_seed(seed))
    model.load_state_dict(from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dense_dim", [0, DD])
@pytest.mark.parametrize("name", list(ZOO))
def test_logits_match_jax(name, dense_dim):
    jmodel, jparams, model = _models(name, dense_dim)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(B, S, F)).astype(np.float32)
    dense = rng.normal(size=(B, dense_dim)).astype(np.float32) if dense_dim else None
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(feats), None if dense is None else jnp.asarray(dense)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), None if dense is None else torch.from_numpy(dense)).numpy()
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_mmoe_both_tasks_match_jax():
    jmodel = JMMoE(S, F, dense_dim=DD, n_experts=3, n_tasks=2, expert_hidden=(16, 8), tower_hidden=(8,))
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(4)))
    model = MMoE(S, F, dense_dim=DD, n_experts=3, n_tasks=2, expert_hidden=(16, 8), tower_hidden=(8,),
                 generator=torch.Generator().manual_seed(4))
    model.load_state_dict(mmoe_params_from_jax(_np(jparams)))
    assert model.experts[0].w.shape == (3, S * F + DD, 16)  # stacked [E, in, h], JAX's layout
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, S, F)).astype(np.float32)
    dense = rng.normal(size=(B, DD)).astype(np.float32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(feats), jnp.asarray(dense)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(dense)).numpy()
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    head = task_head(model, 1)
    assert list(head.state_dict()) == list(model.state_dict())  # the MMoE's own names
    with torch.no_grad():
        np.testing.assert_array_equal(head(torch.from_numpy(feats), torch.from_numpy(dense)).numpy(), got[:, 1])


@pytest.mark.parametrize("name", list(ZOO))
def test_converters_round_trip_bitwise(name):
    _, jparams, model = _models(name, DD)
    _, to_jax = ZOO[name][2]
    back = to_jax(model.state_dict())
    jl, jt = jax.tree.flatten(_np(jparams))
    bl, bt = jax.tree.flatten(back)
    assert bt == jt
    for a, b in zip(bl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sd2 = params_from_jax(back)
    assert set(sd2) == set(model.state_dict())
    assert all(torch.equal(sd2[k], v) for k, v in model.state_dict().items())
    assert params_to_jax(sd2).keys() == back.keys()


def _batch(rng, n_uniq=40):
    uniq = rng.permutation(R - 1)[:n_uniq].astype(np.int32)
    lens = rng.integers(1, 3, S * B)
    segments = np.repeat(np.arange(S * B, dtype=np.int32), lens)
    L = len(segments)
    U_pad, L_pad = n_uniq + 8, L + 6
    return {
        "uniq_rows": np.concatenate([uniq, np.full(U_pad - n_uniq, R - 1, np.int32)]),
        "inverse": np.concatenate([rng.integers(0, n_uniq, L), np.full(L_pad - L, U_pad - 1)]).astype(np.int32),
        "segments": np.concatenate([segments, np.full(L_pad - L, S * B)]).astype(np.int32),
        "labels": (rng.random(B) < 0.4).astype(np.float32),
        "dense": rng.normal(size=(B, DD)).astype(np.float32),
    }


def _table(rng, lay):
    table = (0.1 * rng.normal(size=(R, lay.width))).astype(np.float32)
    table[:, 0] = rng.integers(0, 30, R)
    table[:, 1] = np.floor(table[:, 0] * rng.random(R))
    table[:, lay.embed_g2_col :] = 0.0
    table[R - 1] = 0.0
    return table


@pytest.mark.parametrize("name", list(ZOO))
def test_four_train_steps_match_jax(name):
    lay, jlay = ValueLayout(embedx_dim=D), JValueLayout(embedx_dim=D)
    rng = np.random.default_rng(7)
    table0 = _table(rng, lay)
    batches = [_batch(rng) for _ in range(4)]
    jmodel, jparams, model = _models(name, DD, seed=3)
    sp = dict(embedx_threshold=5.0)
    jcfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay, sparse_opt=JSparseOptimizerConfig(**sp),
                            auc_buckets=AUC_BUCKETS)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**sp),
                          auc_buckets=AUC_BUCKETS)
    jopt = optax.adam(LR_)
    jstep = jax.jit(jmake_train_step(jmodel.apply, jopt, jcfg))
    jgrad = jax.jit(jmake_train_step(jmodel.apply, jopt, dataclasses.replace(jcfg, dense_sync_mode="async")))
    jst = JTrainState(jnp.asarray(table0), jparams, jopt.init(jparams), jauc_init(AUC_BUCKETS),
                      jnp.zeros((), jnp.int32))

    def apply(p, x, d):
        return torch.func.functional_call(model, p, (x, d))

    step = make_train_step(apply, cfg, Adam(LR_))
    grad = make_train_step(apply, dataclasses.replace(cfg, dense_sync_mode="async"))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    st = TrainState(torch.from_numpy(table0.copy()), params, Adam(LR_).init(params),
                    auc_init(AUC_BUCKETS, device="cpu"), torch.zeros((), dtype=torch.int32))
    flipped = None  # per leaf, JAX layout: the gradient's sign differed at some step
    for b in batches:
        jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}
        jg = jax.tree.leaves(_np(jgrad(jst, jb)[1]["gparams"]))
        g = jax.tree.leaves(params_to_jax(grad(st._replace(table=st.table.clone()), tb)[1]["gparams"]))
        for a, w in zip(g, jg):
            np.testing.assert_allclose(a, w, rtol=0, atol=GRAD_ATOL)
        flips = [np.sign(a) != np.sign(w) for a, w in zip(g, jg)]
        flipped = flips if flipped is None else [f | n for f, n in zip(flipped, flips)]
        jst, jm = jstep(jst, jb)
        st, m = step(st, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    got, want = params_to_jax(st.params), _np(jst.params)
    for g, w, f in zip(jax.tree.leaves(got), jax.tree.leaves(want), flipped):
        assert f.sum() <= max(1, f.size // 100)  # sign flips are rare near-zero gradients
        np.testing.assert_array_less(np.abs(g - w), np.where(f, 2 * LR_ * len(batches), PARAMS_ATOL))
    # the task head's other tower and gate get zero gradients, as jax.grad
    # gives them, and Adam's count still advances for every leaf
    assert int(st.opt_state.count) == int(jst.opt_state[0].count) == 4
    np.testing.assert_array_equal(st.auc.pos.numpy(), np.asarray(jst.auc.pos))


@pytest.mark.parametrize("name", list(ZOO))
def test_dense_files_cross_packages(name, tmp_path):
    """Each model's dense file: its leaf names as JAX flattens the
    ``(params, optax.adam state)`` tree, and ``save_dense`` of either
    package loads into the other's trainer bitwise."""
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
    from paddlebox_tpu_torch.train import CTRTrainer

    jmodel, jparams, model = _models(name, DD, seed=6)
    lay, jlay = ValueLayout(embedx_dim=D), JValueLayout(embedx_dim=D)
    jopt = optax.adam(LR_)
    jtr = JCTRTrainer(jmodel, JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay), dense_opt=jopt)
    jtr.init_params(jax.random.PRNGKey(0))
    tr = CTRTrainer(model, TrainStepConfig(num_slots=S, batch_size=B, layout=lay), dense_opt=Adam(LR_),
                    device="cpu")
    tr.init_params()
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path((jtr.params, jtr.opt_state))[0]]
    assert dense_leaf_names(tr.params) == paths
    # a state with every leaf distinct: random leaves, Adam's count 5
    rng = np.random.default_rng(8)
    leaves = [rng.standard_normal(np.shape(x)).astype(np.float32) for x in jax.tree.leaves((jparams, jopt.init(jparams)))]
    k = len(jax.tree.leaves(jparams))
    leaves[k] = np.asarray(5, np.int32)
    jtr.params, jtr.opt_state = jax.tree.unflatten(jax.tree.structure((jtr.params, jtr.opt_state)),
                                                   [jnp.asarray(x) for x in leaves])
    jtr.save_dense(os.path.join(str(tmp_path), "jax"))
    tr.load_dense(os.path.join(str(tmp_path), "jax"))
    for a, b in zip(dense_to_jax_leaves(tr.params, tr.opt_state), leaves):
        assert a.shape == np.shape(b) and a.tobytes() == np.asarray(b).tobytes()
    # and back: the port's file into a fresh JAX trainer
    tr.save_dense(os.path.join(str(tmp_path), "port"))
    jtr2 = JCTRTrainer(jmodel, JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay), dense_opt=jopt)
    jtr2.init_params(jax.random.PRNGKey(1))
    jtr2.load_dense(os.path.join(str(tmp_path), "port"))
    for a, b in zip(jax.tree.leaves((jtr2.params, jtr2.opt_state)), leaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    p2, st2 = dense_from_jax_leaves(leaves, tr.params, torch.device("cpu"))
    assert all(torch.equal(p2[n], tr.params[n]) for n in tr.params)
