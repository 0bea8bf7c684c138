"""The port's DeepFM and eval step against the JAX package.

Weights are carried across with ``deepfm_params_from_jax``. In fp32 the
MLPs agree to 1e-5 (a check on the weight transpose). With the bf16
activation recipe both packages round each layer's matmul and bias add to
bf16, at places that differ between XLA's and torch's CPU dots: the
logits then agree within LOGIT_ATOL (the measured max |diff| was 9.5e-7
on logits of magnitude ~11 at these sizes; the bound leaves room for a
bf16 ulp flip in a hidden unit, which moves a logit by up to ~1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.metrics.auc import auc_init as jauc_init
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.models.layers import mlp_apply as jmlp_apply
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.train.train_step import TrainState as JTrainState
from paddlebox_tpu.train.train_step import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.train_step import make_train_step as jmake_train_step
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.models import DeepFM, deepfm_params_from_jax
from paddlebox_tpu_torch.models.layers import mlp_apply
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.train.dense_opt import Adam
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step

torch.set_num_threads(2)

S, B, D = 5, 8, 4
HIDDEN = (32, 16)
LOGIT_ATOL = 1e-2


def _models(dense_dim=0):
    lay = ValueLayout(embedx_dim=D)
    jmodel = JDeepFM(S, lay.pull_width, D, dense_dim=dense_dim, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: a + 0.03, jmodel.init(jax.random.PRNGKey(1)))
    model = DeepFM(
        S, lay.pull_width, D, dense_dim=dense_dim, hidden=HIDDEN,
        generator=torch.Generator().manual_seed(1),
    )
    model.load_state_dict(deepfm_params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


def test_mlp_fp32_matches_jax():
    _, jparams, model = _models()
    x = np.random.default_rng(0).normal(size=(B, S * 7)).astype(np.float32)
    want = np.asarray(jmlp_apply(jparams["mlp"], jnp.asarray(x), True, jnp.float32))
    got = mlp_apply(model.mlp, torch.from_numpy(x), True, torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dense_dim", [0, 3])
def test_deepfm_logits_match_jax(dense_dim):
    jmodel, jparams, model = _models(dense_dim)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(B, S, 7)).astype(np.float32)
    dense = rng.normal(size=(B, dense_dim)).astype(np.float32) if dense_dim else None
    want = np.asarray(
        jmodel.apply(jparams, jnp.asarray(feats), None if dense is None else jnp.asarray(dense))
    )
    with torch.no_grad():
        got = model(
            torch.from_numpy(feats), None if dense is None else torch.from_numpy(dense)
        ).numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def _eval_both(ins_weight=None, adjust=None):
    """One eval step of each package on the same table and batch."""
    jmodel, jparams, model = _models()
    lay, jlay = ValueLayout(embedx_dim=D), JValueLayout(embedx_dim=D)
    rng = np.random.default_rng(4)
    table = (0.3 * rng.normal(size=(64, lay.width))).astype(np.float32)
    table[:, 0] = rng.integers(0, 30, 64)
    table[:, 1] = np.floor(table[:, 0] * 0.5)
    lens = rng.integers(1, 3, S * B)
    segments = np.repeat(np.arange(S * B, dtype=np.int32), lens)
    L = len(segments)
    batch = {
        "uniq_rows": np.concatenate([rng.permutation(63)[:30], [63, 63]]).astype(np.int32),
        "inverse": np.concatenate([rng.integers(0, 30, L), [31, 31]]).astype(np.int32),
        "segments": np.concatenate([segments, [S * B, S * B]]).astype(np.int32),
        "labels": (rng.random(B) < 0.5).astype(np.float32),
    }
    if ins_weight is not None:
        batch["ins_weight"] = np.asarray(ins_weight, np.float32)
    kw = {} if adjust is None else {"adjust_ins_weight": adjust}
    jcfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay, auc_buckets=200, **kw)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=200, **kw)
    jstep = jax.jit(jmake_train_step(jmodel.apply, None, jcfg, eval_mode=True))
    jstate = JTrainState(
        jnp.asarray(table), jparams, None, jauc_init(200), jnp.zeros((), jnp.int32)
    )
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    step = make_train_step(
        lambda p, x, d: torch.func.functional_call(model, p, (x, d)), cfg, eval_mode=True
    )
    state = TrainState(
        torch.from_numpy(table), dict(model.state_dict()), None,
        auc_init(200, device="cpu"), torch.zeros((), dtype=torch.int32),
    )
    new, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["preds"].numpy(), np.asarray(jm["preds"]), rtol=0, atol=LOGIT_ATOL / 4)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(m["labels"].numpy(), np.asarray(jm["labels"]))
    assert int(m["step"]) == int(jm["step"]) == 1
    np.testing.assert_array_equal(new.auc.pos.numpy(), np.asarray(jnew.auc.pos))
    np.testing.assert_array_equal(new.auc.neg.numpy(), np.asarray(jnew.auc.neg))
    assert new.table is state.table and new.params is state.params
    return new, m, step, state, batch


def test_eval_step_matches_jax():
    _eval_both()


@pytest.mark.parametrize("adjust", [None, (1, 20.0, 2.0)], ids=["plain", "adjust_ins_weight"])
def test_eval_step_with_ins_weight_matches_jax(adjust):
    """The eval step weighs the loss by ``ins_weight`` and counts only the
    weighted instances in its AUC tables, as the JAX step does; the
    AdjustInsWeight rule stays out of eval. Loss within rtol 1e-5, AUC
    tables exact."""
    w = np.array([1, 0, 2, 0, 1, 0.5, 0, 1], np.float32)
    new, m, step, state, batch = _eval_both(ins_weight=w, adjust=adjust)
    counted = int(new.auc.pos.sum() + new.auc.neg.sum())
    assert counted == int((w > 0).sum()) == 5
    # a rank matrix reaches the model only under model_takes_rank_offset,
    # as in the JAX step: without it the batch's rank_offset changes nothing
    _, m_ro = step(state, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                           "rank_offset": torch.zeros((B, 3), dtype=torch.int32)})
    assert torch.equal(m_ro["preds"], m["preds"]) and torch.equal(m_ro["loss"], m["loss"])


def test_train_mode_is_not_ported_yet():
    """Training is ported, its async dense mode and the extended pull too:
    ``use_expand`` builds a step on a layout with an expand block and
    raises ``ValueError`` on one without; a mesh axis (``axis_name``) is a
    misuse, a ``ValueError`` naming the mesh's step builder."""
    lay = ValueLayout(embedx_dim=D)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, dense_sync_mode="async")
    assert callable(make_train_step(lambda p, x, d: x, cfg, None, eval_mode=False))
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=ValueLayout(embedx_dim=D, expand_embed_dim=2),
                          use_expand=True)
    assert callable(make_train_step(lambda p, x, d, e: x, cfg, Adam(1e-3), eval_mode=False))
    with pytest.raises(ValueError, match="expand block"):
        make_train_step(lambda p, x, d, e: x, TrainStepConfig(num_slots=S, batch_size=B, layout=lay, use_expand=True),
                        Adam(1e-3))
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, axis_name="dp")
    with pytest.raises(ValueError, match="make_sharded_train_step"):
        make_train_step(lambda p, x, d: x, cfg, Adam(1e-3), eval_mode=False)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay)
    with pytest.raises(ValueError, match="dense optimizer"):
        make_train_step(lambda p, x, d: x, cfg, eval_mode=False)
